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
on the CPU.  Under ``MESH_TPU_FORCE_XLA`` the three facades take the
reference's XLA forms instead (``_nearest_alongnormal_xla``,
``_intersections_mask_xla``, ``_self_intersection_count_xla``): chunked
scans over the divided forms ``ray_triangle_hits`` and
``tri_tri_intersects``, which also stay the kernels' independent oracles
beside ``tri_tri_intersects_moller``.
"""

import math

import numpy as np
import torch

from ..geometry.cross_product import cross3
from ..utils.device import as_tensor, resolve_device
from ..utils.dispatch import pallas_default

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


def nearest_alongnormal(v, f, points, normals, chunk=512, *, device="cuda"):
    """Nearest mesh hit along the line through each point in +/- normal.

    ``v`` [V, 3], ``f`` [F, 3], ``points`` and ``normals`` [Q, 3] (numpy
    arrays or tensors).  Returns tensors (distance [Q], face [Q] int32,
    point [Q, 3]); the distance is |t| |n|, +inf where no triangle is hit
    in either direction, and the point 0 there.  The kernel route, or
    under ``MESH_TPU_FORCE_XLA`` the XLA scan of ``chunk`` queries a
    step."""
    from .ray_kernel import nearest_alongnormal_kernel

    args = (as_tensor(v, device, torch.float32), as_tensor(f, device),
            as_tensor(points, device, torch.float32).reshape(-1, 3),
            as_tensor(normals, device, torch.float32).reshape(-1, 3))
    if not pallas_default(device):
        return _nearest_alongnormal_xla(*args, chunk=chunk)
    return nearest_alongnormal_kernel(*args)


def _nearest_alongnormal_xla(v, f, points, normals, chunk=512):
    """The reference's XLA form on tensors on their own device: for each
    chunk of queries, Moller-Trumbore against every face ([chunk, F]) and
    the hit of least |t| |n| (the lowest face at a tie)."""
    points = points.to(v.dtype)
    normals = normals.to(v.dtype)
    tri = v[f.long()]
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    dists, faces, pts_out = [], [], []
    for q0 in range(0, max(points.shape[0], 1), chunk):
        pts = points[q0:q0 + chunk]
        nrm = normals[q0:q0 + chunk]
        t, hit = ray_triangle_hits(pts[:, None, :], nrm[:, None, :], a[None],
                                   b[None], c[None])          # [chunk, F]
        dist = t.abs() * (nrm * nrm).sum(dim=-1, keepdim=True).sqrt()
        dist = torch.where(hit, dist, torch.full_like(dist, NO_HIT))
        best = torch.argmin(dist, dim=-1)[:, None]
        best_t = t.gather(1, best)
        best_d = dist.gather(1, best)[:, 0]
        pt = pts + best_t * nrm
        pt = torch.where(torch.isfinite(best_d)[:, None], pt,
                         torch.zeros_like(pt))
        dists.append(best_d)
        faces.append(best[:, 0].to(torch.int32))
        pts_out.append(pt)
    return torch.cat(dists), torch.cat(faces), torch.cat(pts_out)


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


def intersections_mask(v, f, q_v, q_f, chunk=128, *, device="cuda"):
    """Boolean mask [QF] over the query faces: does ``q_f[i]`` (on ``q_v``)
    intersect the mesh (``v``, ``f``)?  ``np.nonzero`` of it is the
    reference's index list (search.py:39-49).  The kernel route, or under
    ``MESH_TPU_FORCE_XLA`` the XLA segment form over ``chunk`` query faces
    a step."""
    from .tri_tri_kernel import tri_tri_any_hit_kernel

    dev = resolve_device(device)
    if not pallas_default(dev):
        return _intersections_mask_xla(_triangles(v, f, dev),
                                       _triangles(q_v, q_f, dev), chunk)
    algorithm = _tri_tri_algorithm(v, f, q_v, q_f)
    return tri_tri_any_hit_kernel(_triangles(q_v, q_f, dev),
                                  _triangles(v, f, dev), algorithm)[0]


def _intersections_mask_xla(tri_mesh, q_tri, chunk=128):
    """The reference's XLA form on the corners ``tri_mesh`` [F, 3, 3] and
    ``q_tri`` [QF, 3, 3]: the segment form against every face, ``chunk``
    query faces a step."""
    return torch.cat([
        tri_tri_intersects(q_tri[q0:q0 + chunk, None], tri_mesh[None]).any(
            dim=-1)
        for q0 in range(0, max(q_tri.shape[0], 1), chunk)])


def self_intersection_count(v, f, chunk=128, *, device="cuda"):
    """The number of faces that intersect at least one other face of the
    mesh sharing no vertex index with them, a 0-d int32 tensor: each
    involved face counts once, however many partners it has (reference
    aabb_normals.cpp:193-207; AABB_n_tree.h:95-117 excludes the
    vertex-sharing pairs).  The kernel route, or under
    ``MESH_TPU_FORCE_XLA`` the XLA segment form over ``chunk`` faces a
    step."""
    from .closest_kernel import mesh_is_nondegenerate
    from .tri_tri_kernel import self_intersection_counts_kernel

    dev = resolve_device(device)
    faces = f.long() if torch.is_tensor(f) else np.asarray(f).astype(np.int64)
    if not pallas_default(dev):
        return _self_intersection_count_xla(as_tensor(v, dev, torch.float32),
                                            as_tensor(faces, dev), chunk)
    algorithm = ("moller" if mesh_is_nondegenerate(_host(v), _host(f))
                 else "segment")
    counts = self_intersection_counts_kernel(
        as_tensor(v, dev, torch.float32), as_tensor(faces, dev), algorithm)
    return (counts > 0).sum().to(torch.int32)


def _self_intersection_count_xla(v, f, chunk=128):
    """The reference's XLA form on tensors ``v`` [V, 3] and ``f`` [F, 3]:
    each chunk of faces against every face in the segment form, pairs that
    share a vertex index or are one face excluded."""
    f = f.long()
    tri = v[f]
    n_f = tri.shape[0]
    ids = torch.arange(n_f, device=v.device)
    involved = torch.zeros((), dtype=torch.int32, device=v.device)
    for q0 in range(0, n_f, chunk):
        qt, qf, qi = tri[q0:q0 + chunk], f[q0:q0 + chunk], ids[q0:q0 + chunk]
        inter = tri_tri_intersects(qt[:, None], tri[None])      # [chunk, F]
        shares = (qf[:, None, :, None] == f[None, :, None, :]).any(
            dim=-1).any(dim=-1)
        not_self = qi[:, None] != ids[None]
        involved = involved + (inter & ~shares & not_self).any(dim=1).sum(
            dtype=torch.int32)
    return involved
