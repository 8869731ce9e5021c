"""Exact closest point with automatic strategy choice (counterpart of
``closest_faces_and_points_auto`` in mesh_tpu/query/culled.py).

The reference's ladder runs its brute-force kernel up to
``DEFAULT_CROSSOVER`` (32768) faces, its sphere-culled kernel above, and its BVH
from 131072 faces.  The port has the brute-force rung only: every face
count goes to the ``closest_faces`` kernel, whose results are exact; above
the crossover it is only slower than the reference's culled path would be.
"""

import logging

import numpy as np
import torch

from ..utils.device import DEFAULT_CROSSOVER, as_tensor, tile_variant
from .closest_kernel import closest_point_kernel, mesh_is_nondegenerate

log = logging.getLogger(__name__)


def _host(x, dtype):
    return (x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)).astype(
        dtype, copy=False)


def closest_faces_and_points_auto(v, f, points, device="cuda"):
    """Exact closest face, part, point and squared distance per query.

    ``v`` [V, 3], ``f`` [F, 3] and ``points`` [Q, 3] may be numpy arrays
    or tensors (a facade's cached device copies are used as they are);
    returns a dict of numpy arrays: ``face`` [Q] int32, ``part`` [Q]
    int32, ``point`` [Q, 3] and ``sqdist`` [Q] float32.

    The nondegeneracy flag is asserted from the host copy of the mesh
    (``mesh_is_nondegenerate``) and ``MESH_TPU_SAFE_TILES`` selects the
    sliver-safe tile, as in the reference."""
    n_faces = f.shape[0]
    if n_faces > DEFAULT_CROSSOVER:
        log.debug("%d faces is above the brute crossover; the culled kernel "
                  "is not ported, so the brute kernel runs", n_faces)
    nondegen = mesh_is_nondegenerate(_host(v, np.float32), _host(f, np.int64))
    res = closest_point_kernel(
        as_tensor(v, device, torch.float32),
        as_tensor(_host(f, np.int64) if not torch.is_tensor(f) else f, device),
        as_tensor(points, device, torch.float32).reshape(-1, 3),
        assume_nondegenerate=nondegen, tile_variant=tile_variant())
    return {key: val.cpu().numpy() for key, val in res.items()}
