"""MeshArrays: the functional mesh container of the port (counterpart of
mesh_tpu/core.py).

A frozen dataclass of tensors on one explicit device.  Vertices may carry
leading batch axes ``[..., V, 3]`` over a shared topology ``f [F, 3]``.  The
mutable ``Mesh`` facade (mesh.py) wraps host numpy arrays for
reference-API parity and converts at the kernel boundary; ``Mesh.arrays()``
exports one of these on the mesh's device for pipelines that stay there.
Faces are int64, torch's index dtype (the reference holds int32).
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

from .utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshArrays:
    """Device-resident triangle mesh.

    v: [..., V, 3] float vertices (leading batch axes allowed)
    f: [F, 3] int64 faces, shared across the batch
    vn/vc: optional per-vertex arrays batched like v
    vt/ft: optional texture coords / texture faces (unbatched topology)
    """

    v: torch.Tensor
    f: torch.Tensor
    vn: Optional[torch.Tensor] = None
    vc: Optional[torch.Tensor] = None
    vt: Optional[torch.Tensor] = None
    ft: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, v, f, vn=None, vc=None, vt=None, ft=None,
               dtype=torch.float32, *, device="cuda"):
        """From numpy arrays (or tensors): floats as ``dtype``, indices as
        int64, all on ``device``."""
        dev = resolve_device(device)

        def as_f(x):
            if x is None:
                return None
            if torch.is_tensor(x):
                return x.to(device=dev, dtype=dtype)
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        def as_i(x):
            if x is None:
                return None
            if torch.is_tensor(x):
                return x.to(device=dev, dtype=torch.int64)
            return torch.as_tensor(np.asarray(x).astype(np.int64),
                                   device=dev)

        return cls(v=as_f(v), f=as_i(f), vn=as_f(vn), vc=as_f(vc),
                   vt=as_f(vt), ft=as_i(ft))

    @property
    def device(self):
        return self.v.device

    @property
    def num_vertices(self):
        return self.v.shape[-2]

    @property
    def num_faces(self):
        return self.f.shape[0]

    @property
    def batch_shape(self):
        return tuple(self.v.shape[:-2])

    def with_vertices(self, v):
        return dataclasses.replace(self, v=v)

    def tri(self):
        """Triangle corner coordinates [..., F, 3, 3]."""
        return self.v[..., self.f, :]
