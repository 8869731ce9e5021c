"""Ray, segment and triangle-triangle queries: constants, the divided
forms, the along-normal search, and mesh-vs-mesh and self-intersection
(counterpart of mesh_tpu/query/ray.py).

- ``nearest_alongnormal`` is the reference's
  ``AabbTree.nearest_alongnormal`` (spatialsearchmodule.cpp:222-323): per
  query, the nearest mesh hit on the line through the point along +/- its
  normal, +inf when nothing is hit (the search facade maps that to the
  reference's 1e100).  It runs the ``alongnormal_faces`` kernel
  (``ray_kernel.py``), in the kernel's division-free form.
- ``intersections_mask`` (spatialsearchmodule.cpp:326-417): which query
  triangles intersect the mesh, a fixed-shape boolean mask.
- ``self_intersection_count`` (aabb_normals.cpp:192-207 /
  AABB_n_tree.h:95-117): the number of faces that intersect at least one
  face they share no vertex index with.

Both run a ``tri_tri_kernel.py`` kernel, in the Moller interval tile when
every face of the meshes passes ``mesh_is_nondegenerate`` and in the
segment tile otherwise (``_tri_tri_algorithm``; ``MESH_TPU_SAFE_TILES=1``
forces the segment tile).  Exactly coplanar overlapping pairs are not
counted by either tile.  Every kernel runs on the card, its plain version
on the CPU.  ``ray_triangle_hits``, ``tri_tri_intersects`` and
``tri_tri_intersects_moller`` keep the divided and the batched forms as
independent oracles.
"""

import math

import numpy as np
import torch

from ..geometry.cross_product import cross3
from ..utils.device import as_tensor, resolve_device

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


def _segment_hits_triangles(s0, s1, a, b, c, eps=_EPS):
    """True where the segment s0 -> s1 crosses the triangle abc (all
    broadcast to [..., 3]), with the tight barycentric tolerance of an
    intersection predicate."""
    d = s1 - s0
    t, hit = ray_triangle_hits(s0, d, a, b, c, eps, bary_eps=eps)
    return hit & (t >= -eps) & (t <= 1 + eps)


def tri_tri_intersects(p, q, eps=_EPS):
    """Pairwise triangle-triangle intersection in the divided segment form:
    each edge of one triangle against the other, both ways.  ``p``, ``q``
    [..., 3, 3] broadcastable; returns bool [...]."""
    out = torch.zeros(torch.broadcast_shapes(p.shape[:-2], q.shape[:-2]),
                      dtype=torch.bool, device=p.device)
    for src, dst in ((p, q), (q, p)):
        a, b, c = dst[..., 0, :], dst[..., 1, :], dst[..., 2, :]
        for i in range(3):
            out = out | _segment_hits_triangles(
                src[..., i, :], src[..., (i + 1) % 3, :], a, b, c, eps)
    return out


def tri_tri_intersects_moller(p, q, eps=None):
    """Pairwise triangle intersection by Moller's interval test, after the
    joint unit-box prescale: the same decisions as ``tri_tri_intersects``
    on nondegenerate, non-coplanar pairs away from the boundary.  A
    degenerate triangle is blind here.  ``eps`` is the plane thickening in
    input units (None: 1e-9 in prescaled units)."""
    from .tri_tri_kernel import moller_hit, moller_prescale, tri_planes

    q = q.to(p.dtype)
    (p, q), scale = moller_prescale(p, q, with_scale=True)
    eps = _EPS if eps is None else eps * scale
    pa, pb, pc, pn, pd = tri_planes(p)
    qa, qb, qc, qn, qd = tri_planes(q)

    def comps(x):
        return tuple(x[..., k] for k in range(3))

    return moller_hit(comps(pa), comps(pb), comps(pc), comps(pn), pd,
                      comps(qa), comps(qb), comps(qc), comps(qn), qd, eps)


def _host(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _tri_tri_algorithm(v, f, q_v, q_f):
    """The tile for a pair grid: Moller when every triangle of both meshes
    is nondegenerate, else the segment tile, whose edge tests stay
    meaningful on zero-area faces."""
    from .closest_kernel import mesh_is_nondegenerate

    return ("moller" if mesh_is_nondegenerate(_host(v), _host(f))
            and mesh_is_nondegenerate(_host(q_v), _host(q_f)) else "segment")


def _triangles(v, f, dev):
    """float32 [F, 3, 3] corners of (v, f) on ``dev``."""
    v = as_tensor(v, dev, torch.float32)
    f = f.long() if torch.is_tensor(f) else np.asarray(f).astype(np.int64)
    return v[as_tensor(f, dev)]


def intersections_mask(v, f, q_v, q_f, device="cuda"):
    """Boolean mask [QF] over the query faces: does ``q_f[i]`` (on ``q_v``)
    intersect the mesh (``v``, ``f``)?  ``np.nonzero`` of it is the
    reference's index list (search.py:39-49)."""
    from .tri_tri_kernel import tri_tri_any_hit_kernel

    dev = resolve_device(device)
    algorithm = _tri_tri_algorithm(v, f, q_v, q_f)
    return tri_tri_any_hit_kernel(_triangles(q_v, q_f, dev),
                                  _triangles(v, f, dev), algorithm)[0]


def self_intersection_count(v, f, device="cuda"):
    """The number of faces that intersect at least one other face of the
    mesh sharing no vertex index with them, a 0-d int32 tensor: each
    involved face counts once, however many partners it has (reference
    aabb_normals.cpp:193-207; AABB_n_tree.h:95-117 excludes the
    vertex-sharing pairs)."""
    from .closest_kernel import mesh_is_nondegenerate
    from .tri_tri_kernel import self_intersection_counts_kernel

    dev = resolve_device(device)
    algorithm = ("moller" if mesh_is_nondegenerate(_host(v), _host(f))
                 else "segment")
    faces = f.long() if torch.is_tensor(f) else np.asarray(f).astype(np.int64)
    counts = self_intersection_counts_kernel(
        as_tensor(v, dev, torch.float32), as_tensor(faces, dev), algorithm)
    return (counts > 0).sum().to(torch.int32)
