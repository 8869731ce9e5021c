"""Projected barycentric coordinates (counterpart of
mesh_tpu/geometry/barycentric.py; Heidrich, JGT'05).

Everything is (..., N, 3), with the reference's guard for degenerate
(collinear-edge) triangles: a zero |u x v|^2 is replaced by the dtype's
machine epsilon.
"""

import torch

from ..utils.device import as_tensor
from .cross_product import cross3


def barycentric_coordinates_of_projection(p, q, u, v, *, device="cuda"):
    """Barycentric coords of p's projection onto triangle (q, q+u, q+v).

    :param p: points to project, [..., N, 3]
    :param q: a triangle vertex per point, [..., N, 3]
    :param u, v: triangle edge vectors per point, [..., N, 3]
    :returns: [..., N, 3] barycentric coords (b0, b1, b2), b0 = 1 - b1 - b2
    """
    p = as_tensor(p, device)
    q, u, v = (as_tensor(x, p.device, p.dtype) for x in (q, u, v))
    n = cross3(u, v)
    s = (n * n).sum(dim=-1, keepdim=True)
    s = torch.where(s == 0, torch.finfo(p.dtype).eps, s)
    one_over_4a_sq = 1.0 / s
    w = p - q
    b2 = (cross3(u, w) * n).sum(dim=-1, keepdim=True) * one_over_4a_sq
    b1 = (cross3(w, v) * n).sum(dim=-1, keepdim=True) * one_over_4a_sq
    b0 = 1.0 - b1 - b2
    return torch.cat([b0, b1, b2], dim=-1)
