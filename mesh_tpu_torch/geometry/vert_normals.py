"""Per-vertex normals (counterpart of mesh_tpu/geometry/vert_normals.py).

Area-scaled face normals are added onto their three corner vertices and the
rows normalized.  The reference's ``.at[].add`` scatter becomes
``index_add_``.  On the CPU the additions run in face order.  On CUDA
``index_add_`` adds with atomics, in an order that changes from run to
run: a vertex sums at most its handful of incident faces, so two runs
differ by a few float32 ulps of that sum, about 1e-6 after normalization.
"""

import torch

from ..utils.device import as_tensor
from .tri_normals import normalize_rows, tri_normals_scaled_t


def vert_normals_scaled_t(v, f):
    """Sum of incident scaled face normals per vertex -> [..., V, 3]."""
    fn = tri_normals_scaled_t(v, f)                        # [..., F, 3]
    batch = v.shape[:-2]
    contrib = fn[..., None, :].expand(batch + (fn.shape[-2], 3, 3))
    contrib = contrib.reshape(batch + (-1, 3))             # [..., F*3, 3]
    out = torch.zeros(batch + (v.shape[-2], 3), dtype=v.dtype,
                      device=v.device)
    return out.index_add_(-2, f.reshape(-1).long(), contrib)


def vert_normals_t(v, f):
    """Unit vertex normals of tensors on their own device; vertices that
    touch no face get the zero vector."""
    return normalize_rows(vert_normals_scaled_t(v, f))


def vert_normals(v, f, device="cuda"):
    """Unit vertex normals -> [..., V, 3] (reference VertNormals ==
    Mesh.estimate_vertex_normals)."""
    return vert_normals_t(as_tensor(v, device), as_tensor(f, device))
