"""Ray queries: constants, the divided Moller-Trumbore form, and the
along-normal search (counterpart of mesh_tpu/query/ray.py, its ray half).

``nearest_alongnormal`` is the reference's ``AabbTree.nearest_alongnormal``
(spatialsearchmodule.cpp:222-323): per query, the nearest mesh hit on the
line through the point along +/- its normal, +inf when nothing is hit (the
search facade maps that to the reference's 1e100).  It runs the
``alongnormal_faces`` kernel on the card and its plain version on the CPU
(``ray_kernel.py``), in the kernel's division-free form.
``ray_triangle_hits`` keeps the divided form as an independent oracle.
"""

import math

import torch

from ..geometry.cross_product import cross3
from ..utils.device import as_tensor

_EPS = 1e-9
# Barycentric inclusion tolerance for ray hits: much wider than float32
# rounding, so a ray crossing exactly on the shared edge of two triangles
# registers on at least one of them.
_BARY_EPS = 1e-6
# The reference's no-hit sentinel is 1e100, which overflows float32; device
# code uses +inf and the search facade converts at the numpy boundary.
NO_HIT = math.inf


def _dot(x, y):
    return (x * y).sum(dim=-1)


def ray_triangle_hits(o, d, a, b, c, eps=_EPS, bary_eps=_BARY_EPS):
    """Moller-Trumbore with one division per pair: the signed ray parameter
    t per (ray, triangle) pair and whether the line meets the triangle.

    All inputs broadcast to [..., 3]; returns (t, hit), the hit at o + t d
    (t unrestricted in sign: callers clamp)."""
    e1 = b - a
    e2 = c - a
    pvec = cross3(d, e2)
    det = _dot(e1, pvec)
    parallel = det.abs() < eps
    inv_det = 1.0 / torch.where(parallel, torch.ones_like(det), det)
    tvec = o - a
    u = _dot(tvec, pvec) * inv_det
    qvec = cross3(tvec, e1)
    v = _dot(d, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    hit = (~parallel) & (u >= -bary_eps) & (v >= -bary_eps) & (
        u + v <= 1 + bary_eps)
    return t, hit


def nearest_alongnormal(v, f, points, normals, device="cuda"):
    """Nearest mesh hit along the line through each point in +/- normal.

    ``v`` [V, 3], ``f`` [F, 3], ``points`` and ``normals`` [Q, 3] (numpy
    arrays or tensors).  Returns tensors (distance [Q], face [Q] int32,
    point [Q, 3]); the distance is |t| |n|, +inf where no triangle is hit
    in either direction, and the point 0 there."""
    from .ray_kernel import nearest_alongnormal_kernel

    return nearest_alongnormal_kernel(
        as_tensor(v, device, torch.float32), as_tensor(f, device),
        as_tensor(points, device, torch.float32).reshape(-1, 3),
        as_tensor(normals, device, torch.float32).reshape(-1, 3))
