"""Branch-free exact closest point on a triangle with CGAL part codes
(counterpart of mesh_tpu/query/point_triangle.py).

Every Voronoi region's candidate is computed and the winner selected with
``torch.where`` in the textbook priority order, then a degenerate-face
override replaces the cancellation-prone edge/interior choice on
(near-)zero-area triangles with the best clamped segment projection.

Part codes (spatialsearchmodule.cpp:129-140): 0 = interior, 1 = edge ab,
2 = edge bc, 3 = edge ca, 4 = vertex a, 5 = vertex b, 6 = vertex c.
All functions work on tensors on their own device.
"""

import torch

from ..geometry.cross_product import cross3

PART_INTERIOR = 0
PART_EDGE_AB = 1
PART_EDGE_BC = 2
PART_EDGE_CA = 3
PART_VERT_A = 4
PART_VERT_B = 5
PART_VERT_C = 6


def _dot(x, y):
    return (x * y).sum(dim=-1)


def _safe_div(num, den):
    return num / torch.where(den == 0, torch.ones_like(den), den)


def _bary(b0, b1, b2):
    return torch.stack(torch.broadcast_tensors(b0, b1, b2), dim=-1)


def closest_point_barycentric(p, a, b, c):
    """Barycentric coords + part code of the point on triangle abc closest
    to p.  Inputs broadcast to [..., 3]; returns (bary [..., 3], part [...]
    int32)."""
    p, a, b, c = torch.broadcast_tensors(p, a, b, c)
    ab = b - a
    ac = c - a
    ap = p - a
    d1 = _dot(ab, ap)
    d2 = _dot(ac, ap)
    bp = p - b
    d3 = _dot(ab, bp)
    d4 = _dot(ac, bp)
    cp = p - c
    d5 = _dot(ab, cp)
    d6 = _dot(ac, cp)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2

    # region conditions, in priority order
    in_a = (d1 <= 0) & (d2 <= 0)
    in_b = (d3 >= 0) & (d4 <= d3)
    in_c = (d6 >= 0) & (d5 <= d6)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    on_ca = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    on_bc = (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0)

    # candidate barycentric coordinates per region
    t_ab = _safe_div(d1, d1 - d3)
    t_ca = _safe_div(d2, d2 - d6)
    t_bc = _safe_div(d4 - d3, (d4 - d3) + (d5 - d6))
    denom = _safe_div(torch.ones_like(va), va + vb + vc)
    v_int = vb * denom
    w_int = vc * denom

    one = torch.ones_like(d1)
    zero = torch.zeros_like(d1)
    cand = [
        (in_a, _bary(one, zero, zero), PART_VERT_A),
        (in_b, _bary(zero, one, zero), PART_VERT_B),
        (in_c, _bary(zero, zero, one), PART_VERT_C),
        (on_ab, _bary(1.0 - t_ab, t_ab, zero), PART_EDGE_AB),
        (on_ca, _bary(1.0 - t_ca, zero, t_ca), PART_EDGE_CA),
        (on_bc, _bary(zero, 1.0 - t_bc, t_bc), PART_EDGE_BC),
    ]

    out_bary = _bary(1.0 - v_int - w_int, v_int, w_int)
    out_part = torch.full(va.shape, PART_INTERIOR, dtype=torch.int32,
                          device=va.device)
    # walk the priority list backwards: the highest-priority match wins
    for cond, bxyz, code in reversed(cand):
        out_bary = torch.where(cond[..., None], bxyz, out_bary)
        out_part = torch.where(cond, code, out_part)

    # degenerate-face override: the region tests above ride on va/vb/vc,
    # exact zeros cancelling in float32 on (near-)zero-area faces; such a
    # face IS its edge segments.  The vertex regions stay exact and keep
    # their classification.
    ab2 = _dot(ab, ab)
    ac2 = _dot(ac, ac)
    n = cross3(ab, ac)
    degen = (_dot(n, n) <= 1e-10 * ab2 * ac2) & ~(in_a | in_b | in_c)

    def on_segment(p0, s0, s1):
        d = s1 - s0
        t = torch.clamp(_safe_div(_dot(p0 - s0, d), _dot(d, d)), 0.0, 1.0)
        diff = p0 - (s0 + t[..., None] * d)
        return t, _dot(diff, diff)

    t_e_ab, d_e_ab = on_segment(p, a, b)
    t_e_bc, d_e_bc = on_segment(p, b, c)
    t_e_ca, d_e_ca = on_segment(p, c, a)
    seg_cands = [
        (d_e_bc, _bary(zero, 1.0 - t_e_bc, t_e_bc), PART_EDGE_BC),
        (d_e_ca, _bary(t_e_ca, zero, 1.0 - t_e_ca), PART_EDGE_CA),
    ]
    seg_d = d_e_ab
    seg_bary = _bary(1.0 - t_e_ab, t_e_ab, zero)
    seg_part = torch.full(va.shape, PART_EDGE_AB, dtype=torch.int32,
                          device=va.device)
    for d_e, b_e, code in seg_cands:
        closer = d_e < seg_d
        seg_bary = torch.where(closer[..., None], b_e, seg_bary)
        seg_part = torch.where(closer, code, seg_part)
        seg_d = torch.minimum(seg_d, d_e)
    out_bary = torch.where(degen[..., None], seg_bary, out_bary)
    out_part = torch.where(degen, seg_part, out_part)
    return out_bary, out_part


def closest_point_on_triangle(p, a, b, c):
    """Closest point, squared distance and part code:
    (point [..., 3], sqdist [...], part [...] int32)."""
    bary, part = closest_point_barycentric(p, a, b, c)
    point = bary[..., 0:1] * a + bary[..., 1:2] * b + bary[..., 2:3] * c
    diff = p - point
    return point, _dot(diff, diff), part
