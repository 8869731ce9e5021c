"""Ray kernels: the any-hit test and the along-normal argmin, their CUDA
wrappers and plain PyTorch versions (counterpart of the ray half of
mesh_tpu/query/pallas_ray.py).

Two kernels over one per-pair predicate (``csrc/ray_cost.cuh``, here
``mt_line_hit``): the division-free, sign-carried Moller-Trumbore test of
the line o + t d against a triangle given by its corner a and edges e1, e2.

- ``ray_any_hit`` (``csrc/ray_any_hit.cu``): per ray, whether it meets any
  face of its own mesh with t in [t_lo, t_hi] (``None``: unbounded), and
  how many faces it tested: faces are tested in increasing order and a ray
  stops at its first hit, so that count is the first hit's index plus one,
  or every face when the ray is free.
- ``alongnormal_faces`` (``csrc/alongnormal_faces.cu``): per query, the
  face with the least |t| on the line p + t n, misses costing ``_BIG``; a
  query that hits nothing gets face 0.  ``nearest_alongnormal_kernel``
  re-tests the winner with the same predicate, so a face accepted by the
  kernel never comes back as a miss.

The wrappers take the kernel's path for CUDA tensors and the plain version
for CPU tensors; any other device raises.  ``LAUNCHES`` counts each
kernel's launches.  Neither centers: the rays and faces are used as given,
as the reference's kernels use them.
"""

import torch

from .closest_kernel import _batched, _check_operands, _chunks, _grid
from .ray import _BARY_EPS, _EPS, NO_HIT

#: per-face planes of the ray kernels: a, e1, e2
N_RAY_ROWS = 9

#: the reference's argmin sentinel: the along-normal cost of a miss
_BIG = 1e30

#: launches of each CUDA kernel since the counts were last set to 0
LAUNCHES = {"ray_any_hit": 0, "alongnormal_faces": 0}


# ---------------------------------------------------------------------------
# The per-pair predicate: csrc/ray_cost.cuh line_hit, op for op.  Each of
# o, d, a, e1, e2 is an (x, y, z) tuple of broadcastable tensors.

def mt_terms(o, d, a, e1, e2):
    """(|det|, sign(det), un, vn, tn): the sign-carried numerators of the
    barycentric u, v and the ray parameter t (reference _mt_terms)."""
    ox, oy, oz = o
    dx, dy, dz = d
    ax, ay, az = a
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    sd = torch.sign(det)
    ad = det.abs()
    sx, sy, sz = ox - ax, oy - ay, oz - az
    un = (sx * px + sy * py + sz * pz) * sd
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    vn = (dx * qx + dy * qy + dz * qz) * sd
    tn = (e2x * qx + e2y * qy + e2z * qz) * sd
    return ad, sd, un, vn, tn


def mt_line_hit(o, d, a, e1, e2, eps=_EPS, beps=_BARY_EPS):
    """(hit, |det|, tn): whether the line meets the triangle, t of either
    sign (reference _mt_line_hit)."""
    ad, _, un, vn, tn = mt_terms(o, d, a, e1, e2)
    tol = beps * ad
    hit = (ad >= eps) & (un >= -tol) & (vn >= -tol) & (un + vn <= ad + tol)
    return hit, ad, tn


def mt_hit(o, d, a, e1, e2, t_lo=0.0, t_hi=None):
    """``mt_line_hit`` with t in [t_lo, t_hi]; ``None`` leaves a side
    unbounded (reference _mt_hit)."""
    hit, ad, tn = mt_line_hit(o, d, a, e1, e2)
    if t_lo is not None:
        hit = hit & (tn >= t_lo * ad)
    if t_hi is not None:
        hit = hit & (tn <= t_hi * ad)
    return hit


def ray_planes(tri):
    """[B, 9, F] contiguous float32 planes (a, e1, e2) of ``tri``
    [B, F, 3, 3]: the ray kernels' face operand."""
    tri = tri.to(torch.float32)
    a = tri[..., 0, :]
    e1 = tri[..., 1, :] - a
    e2 = tri[..., 2, :] - a
    return torch.cat([a, e1, e2], dim=-1).transpose(-1, -2).contiguous()


def _rows(planes, b0, b1):
    """The nine plane rows of meshes b0:b1 as [b, 1, F] tensors, grouped
    (a, e1, e2)."""
    rows = [planes[b0:b1, k, None, :] for k in range(N_RAY_ROWS)]
    return tuple(rows[0:3]), tuple(rows[3:6]), tuple(rows[6:9])


def _xyz(x):
    """[..., N, 3] -> three [..., N, 1] columns, against [..., 1, F] rows."""
    return x[..., 0:1], x[..., 1:2], x[..., 2:3]


def check_with_vectors(pts, vecs, planes, n_rows, name):
    """``_check_operands`` for kernels that also read a per-query vector
    (a ray direction, a query normal) shaped like ``pts``."""
    _check_operands(pts, planes, n_rows, name)
    if (vecs.device != pts.device or vecs.dtype != torch.float32
            or not vecs.is_contiguous() or vecs.shape != pts.shape):
        raise ValueError("%s: want the per-query vectors like the points, "
                         "contiguous float32 %r on %s"
                         % (name, tuple(pts.shape), pts.device))


# ---------------------------------------------------------------------------
# ray_any_hit

def ray_any_hit_plain(origins, dirs, planes, t_lo=0.0, t_hi=None):
    """Plain PyTorch version of the ``ray_any_hit`` kernel: (blocked [B, R]
    bool, tested [B, R] int32 faces tested).  ``origins``, ``dirs``
    [B, R, 3] and ``planes`` [B, 9, F] float32."""
    n_b, n_r = origins.shape[:2]
    n_f = planes.shape[-1]
    blocked = torch.zeros((n_b, n_r), dtype=torch.bool, device=origins.device)
    tested = torch.full((n_b, n_r), n_f, dtype=torch.int32,
                        device=origins.device)
    for b0, b1, r0, r1 in _chunks(n_b, n_r, n_f, origins.device):
        a, e1, e2 = _rows(planes, b0, b1)
        hit = mt_hit(_xyz(origins[b0:b1, r0:r1]), _xyz(dirs[b0:b1, r0:r1]),
                     a, e1, e2, t_lo, t_hi)
        any_hit = hit.any(dim=-1)
        blocked[b0:b1, r0:r1] = any_hit
        first = torch.argmax(hit.to(torch.uint8), dim=-1).to(torch.int32)
        tested[b0:b1, r0:r1] = torch.where(any_hit, first + 1,
                                           tested[b0:b1, r0:r1])
    return blocked, tested


def ray_any_hit(origins, dirs, planes, t_lo=0.0, t_hi=None):
    """Whether each ray meets a face of its mesh with t in [t_lo, t_hi], and
    the faces it tested: the ``ray_any_hit`` CUDA kernel for CUDA tensors,
    its plain version for CPU tensors.  Shapes as ``ray_any_hit_plain``."""
    t_lo = None if t_lo is None else float(t_lo)
    t_hi = None if t_hi is None else float(t_hi)
    check_with_vectors(origins, dirs, planes, N_RAY_ROWS, "ray_any_hit")
    if origins.device.type == "cpu":
        return ray_any_hit_plain(origins, dirs, planes, t_lo, t_hi)
    from .. import _build

    n_b, n_r, n_f = _grid(origins, planes, "ray_any_hit")
    blocked = torch.empty((n_b, n_r), dtype=torch.int32, device=origins.device)
    tested = torch.empty_like(blocked)
    _build.launch("ray_any_hit", origins.device, origins, dirs, planes,
                  blocked, tested, n_b, n_r, n_f,
                  int(t_lo is not None), 0.0 if t_lo is None else t_lo,
                  int(t_hi is not None), 0.0 if t_hi is None else t_hi)
    LAUNCHES["ray_any_hit"] += 1
    return blocked.bool(), tested


# ---------------------------------------------------------------------------
# alongnormal_faces

def _alongnormal_cost_tile(p, n, a, e1, e2):
    """|t| where the line p + t n meets the face, else _BIG (reference
    _alongnormal_cost_tile)."""
    hit, ad, tn = mt_line_hit(p, n, a, e1, e2)
    t_abs = tn.abs() / torch.where(ad == 0, torch.ones_like(ad), ad)
    return torch.where(hit, t_abs, torch.full_like(t_abs, _BIG))


def argmin_alongnormal_plain(pts, normals, planes):
    """Plain PyTorch version of the ``alongnormal_faces`` kernel: the face
    with the least |t| per query, [B, Q] int32, lowest index on exact ties
    (face 0 when nothing is hit).  ``pts``, ``normals`` [B, Q, 3] and
    ``planes`` [B, 9, F] float32."""
    n_b, n_q = pts.shape[:2]
    out = torch.empty((n_b, n_q), dtype=torch.int32, device=pts.device)
    for b0, b1, q0, q1 in _chunks(n_b, n_q, planes.shape[-1], pts.device):
        cost = _alongnormal_cost_tile(
            _xyz(pts[b0:b1, q0:q1]), _xyz(normals[b0:b1, q0:q1]),
            *_rows(planes, b0, b1))
        out[b0:b1, q0:q1] = torch.argmin(cost, dim=-1).to(torch.int32)
    return out


def argmin_alongnormal(pts, normals, planes):
    """The face with the least |t| per query: the ``alongnormal_faces`` CUDA
    kernel for CUDA tensors, its plain version for CPU tensors."""
    check_with_vectors(pts, normals, planes, N_RAY_ROWS, "alongnormal_faces")
    if pts.device.type == "cpu":
        return argmin_alongnormal_plain(pts, normals, planes)
    from .. import _build

    out = torch.empty(pts.shape[:2], dtype=torch.int32, device=pts.device)
    _build.launch("alongnormal_faces", pts.device, pts, normals, planes, out,
                  *_grid(pts, planes, "alongnormal_faces"))
    LAUNCHES["alongnormal_faces"] += 1
    return out


def alongnormal_epilogue(best, tri, pts, normals):
    """Re-test each winner with the kernel's own predicate: (distance
    |t| |n| or +inf, face, hit point or 0) (reference
    nearest_alongnormal_pallas, after the kernel)."""
    rows = torch.arange(best.shape[0], device=best.device)[:, None]
    win = tri[rows, best.long()]                         # [B, Q, 3, 3]
    wa = win[..., 0, :]
    comps = [tuple(x[..., k] for k in range(3)) for x in (
        pts, normals, wa, win[..., 1, :] - wa, win[..., 2, :] - wa)]
    hit, ad, tn = mt_line_hit(*comps)
    t = tn / torch.where(ad == 0, torch.ones_like(ad), ad)
    norm = (normals * normals).sum(dim=-1).sqrt()
    dist = torch.where(hit, t.abs() * norm, torch.full_like(t, NO_HIT))
    point = torch.where(hit[..., None], pts + t[..., None] * normals,
                        torch.zeros_like(pts))
    return dist, best, point


def _nearest_alongnormal(v, f, points, normals, argmin):
    vb, pb, unbatch = _batched(v, points)
    tri = vb.to(torch.float32)[..., f.long(), :]
    pts = pb.to(torch.float32).contiguous()
    nrm = normals.to(torch.float32).reshape(pts.shape).contiguous()
    best = argmin(pts, nrm, ray_planes(tri))
    out = alongnormal_epilogue(best, tri, pts, nrm)
    if unbatch:
        return tuple(x[0] for x in out)
    return out


def nearest_alongnormal_kernel(v, f, points, normals):
    """Nearest hit along +/- normal per query -> (distance [..., Q], face
    [..., Q] int32, point [..., Q, 3]); ``v`` [V, 3] with ``points`` and
    ``normals`` [Q, 3], or a batch ``v`` [B, V, 3] with [B, Q, 3] (one
    launch).  The CUDA kernel on the card, its plain version on the CPU."""
    return _nearest_alongnormal(v, f, points, normals, argmin_alongnormal)


def nearest_alongnormal_plain(v, f, points, normals):
    """``nearest_alongnormal_kernel`` with the plain argmin on any device."""
    return _nearest_alongnormal(v, f, points, normals,
                                argmin_alongnormal_plain)
