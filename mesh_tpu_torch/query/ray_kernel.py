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
  or every face when the ray is free.  The every-face design: the flag
  oracle of the culled kernel.
- ``ray_any_hit_culled`` (``csrc/ray_any_hit_culled.cu``): the same flags,
  on the operands of ``any_hit_operands`` (faces Morton-sorted into chunks
  of ``ANY_HIT_CHUNK``, a box, a normal cone and margin terms per chunk);
  a lane tests a chunk's faces only when its ray, slab-tested against the
  chunk's box grown by a float32 margin, may hit one of them
  (``chunk_needs``; the margin argument is the kernel's source note).
  Visibility runs it.
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

from .closest_kernel import (
    _PLAIN_PAIRS,
    _batched,
    _check_operands,
    _chunks,
    _grid,
)
from .culled_kernel import (
    WARP,
    _pad_rows_edge,
    _sorted_rows,
    _warp_any,
    morton_face_order,
)
from .ray import _BARY_EPS, _EPS, NO_HIT

#: per-face planes of the ray kernels: a, e1, e2
N_RAY_ROWS = 9

#: the reference's argmin sentinel: the along-normal cost of a miss
_BIG = 1e30

#: launches of each CUDA kernel since the counts were last set to 0
LAUNCHES = {"ray_any_hit": 0, "ray_any_hit_culled": 0,
            "alongnormal_faces": 0}

#: faces per chunk of the culled any-hit kernel: one warp's worth, so a
#: staged chunk is at most one 16-byte copy per thread of a 128-ray block
ANY_HIT_CHUNK = 32
#: floats of a face record (a, e1, e2, unit normal / rho) and of a chunk
#: record (csrc/ray_any_hit_culled.cu chunk_needed)
FACE_WORDS = 12
CHUNK_WORDS = 20
#: the cull's constants, each a power of two with its argument in
#: csrc/ray_any_hit_culled.cu: the cone's pads, the guard, the margin's
#: two terms and the slab test's pad
CONE_PAD = 2.0 ** -19
SINE_PAD = 2.0 ** -17
GUARD = 2.0 ** -18
MARGIN_REL = 2.0 ** -17
MARGIN_EDGE = 2.0 ** -16
SLAB_PAD = 2.0 ** -20
#: taken off each chunk's cone cosine for its float64 normals' rounding
CONE_SLACK = 1e-6


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
# ray_any_hit_culled: the prologue, the chunk test, the plain version and the
# wrapper

def _f32_up(x):
    """Float64 ``x`` as float32, rounded up (NaN stays)."""
    y = x.to(torch.float32)
    return torch.where(y.double() < x, torch.nextafter(
        y, torch.full_like(y, float("inf"))), y)


def any_hit_sorted_faces(tri):
    """(order [B, F], sorted faces): each mesh's faces ``tri``
    [B, F, 3, 3] in the Morton order of their centroids
    (``morton_face_order``), edge-padded to whole chunks of ANY_HIT_CHUNK
    faces (a padded face repeats the last real one)."""
    if not tri.shape[1]:
        return torch.zeros(tri.shape[:2], dtype=torch.int64,
                           device=tri.device), tri
    order = morton_face_order(tri)
    return order, _pad_rows_edge(_sorted_rows(tri, order), ANY_HIT_CHUNK,
                                 dim=1)


def any_hit_records(tri_s):
    """(face records [B, Fp, FACE_WORDS], chunk records [B, C,
    CHUNK_WORDS]) float32 of sorted, padded faces ``tri_s``
    [B, C * ANY_HIT_CHUNK, 3, 3], in a few batched ops.

    A face record holds a, e1 = b - a, e2 = c - a (the values
    ``ray_planes`` gives) and the unit normal divided by the face's shape
    factor rho_f (from float64 terms of the float32 edges, rounded; NaN
    for a face without area), as the kernel's shared-memory tile (3
    float4: ``RayFace::hit`` reads the first 9 words, the chunk test the
    last 3).  A chunk record holds [lo, rho, hi,
    E, axis, ct, cen, st, W, Bm, 0, 0]: its corners' box lo, hi, centre
    cen = (lo + hi) / 2 and largest |coordinate| Bm; from float64 terms,
    rounded up, the largest shape factor rho = E^2 / |e1 x e2| (E =
    max(|e1|, |e2|)), the largest E and W = E + the largest distance of a
    corner from cen; a normal cone: the float32 axis of the summed unit
    normals, the cosine ct of its half-angle less CONE_SLACK, rounded
    down, and its sine st, rounded up (a cone of 90 degrees or more, or
    without an axis: ct = 0, st = 1).  A chunk with a non-finite box, axis,
    rho or W gets rho = +inf, which the guard never culls
    (csrc/ray_any_hit_culled.cu)."""
    n_b, n_fp = tri_s.shape[:2]
    per = (n_b, n_fp // ANY_HIT_CHUNK, ANY_HIT_CHUNK)
    a = tri_s[..., 0, :]
    edges = tri_s[..., 1:, :] - a[..., None, :]              # [B, Fp, 2, 3]
    e64 = edges.double()
    normal = torch.linalg.cross(e64[..., 0, :], e64[..., 1, :])
    area2 = normal.norm(dim=-1)
    unit = normal / area2[..., None]
    elen = e64.norm(dim=-1).amax(dim=-1)                      # [B, Fp]
    rho = elen * elen / area2
    faces = torch.cat([a, edges.flatten(-2),
                       (unit / rho[..., None]).to(torch.float32)], dim=-1)
    rho = rho.view(per).amax(dim=-1)
    edge = elen.view(per).amax(dim=-1)
    unit = unit.view(per + (3,))
    axis = unit.sum(dim=2)
    axis = (axis / axis.norm(dim=-1, keepdim=True)).to(torch.float32)
    ax = axis.double()
    ct = ((unit * ax[:, :, None]).sum(dim=-1).amin(dim=-1)
          / ax.norm(dim=-1) - CONE_SLACK)
    corners = tri_s.reshape(per[:2] + (ANY_HIT_CHUNK * 3, 3))
    lo, hi = torch.aminmax(corners, dim=2)
    cen = (lo + hi) * 0.5
    box = torch.cat([lo, hi, axis], dim=-1)
    bm = box[..., :6].abs().amax(dim=-1, keepdim=True)
    w = edge + (corners.double() - cen.double()[:, :, None]).norm(
        dim=-1).amax(dim=-1)
    wide = ~(ct > 0)
    st = torch.where(wide, 1.0, torch.sqrt(torch.clamp_min(1.0 - ct * ct,
                                                           0.0)))
    finite = torch.isfinite(box).all(dim=-1) & torch.isfinite(rho + w)
    up = _f32_up(torch.stack([torch.where(finite, rho, float("inf")), edge,
                              torch.where(wide, 0.0, -ct), st, w], dim=-1))
    chunks = torch.cat([lo, up[..., 0:1], hi, up[..., 1:2], axis,
                        -up[..., 2:3], cen, up[..., 3:5], bm,
                        torch.zeros_like(up[..., :2])], dim=-1)
    return faces.contiguous(), chunks.contiguous()


def any_hit_operands(origins, dirs, tri):
    """The culled any-hit kernel's operands: the rays ``origins``, ``dirs``
    [B, R, 3] (contiguous float32, in any order) and, from each mesh's
    faces ``tri`` [B, F, 3, 3], the faces in the Morton order of their
    centroids, edge-padded to whole chunks of ANY_HIT_CHUNK
    (``any_hit_sorted_faces``), their records
    and the chunk records (``any_hit_records``: ``faces`` [B, Fp,
    FACE_WORDS], ``chunks`` [B, Fp / ANY_HIT_CHUNK, CHUNK_WORDS]); ``face_ids`` [B, F] int32 maps a
    sorted position to its face, ``n_faces`` is F.  Batched tensor ops
    only, no loop over meshes."""
    tri = tri.to(torch.float32)
    if (tri.ndim != 4 or tri.shape[-2:] != (3, 3) or origins.ndim != 3
            or tri.shape[0] != origins.shape[0]):
        raise ValueError("any_hit_operands: want rays [B, R, 3] and faces "
                         "[B, F, 3, 3], got %r and %r"
                         % (tuple(origins.shape), tuple(tri.shape)))
    order, tri_s = any_hit_sorted_faces(tri)
    faces, chunks = any_hit_records(tri_s)
    return {"origins": origins, "dirs": dirs, "faces": faces,
            "chunks": chunks, "n_faces": tri.shape[1],
            "face_ids": order.to(torch.int32)}


def _check_any_hit_ops(ops):
    origins, dirs, faces, chunks = (ops[k] for k in (
        "origins", "dirs", "faces", "chunks"))
    if any(t.device != origins.device or t.dtype != torch.float32
           or not t.is_contiguous() for t in (origins, dirs, faces, chunks)):
        raise ValueError("ray_any_hit_culled wants contiguous float32 "
                         "operands on one device")
    if origins.device.type not in ("cpu", "cuda"):
        raise ValueError("ray_any_hit_culled: no kernel for device %s"
                         % origins.device)
    n_b = origins.shape[0]
    n_c = chunks.shape[1] if chunks.ndim == 3 else -1
    n_f = ops["n_faces"]
    if (origins.ndim != 3 or origins.shape[-1] != 3
            or dirs.shape != origins.shape
            or faces.shape != (n_b, n_c * ANY_HIT_CHUNK, FACE_WORDS)
            or chunks.shape != (n_b, n_c, CHUNK_WORDS)
            or not ((n_c - 1) * ANY_HIT_CHUNK < n_f <= n_c * ANY_HIT_CHUNK
                    or n_f == n_c == 0)):
        raise ValueError("ray_any_hit_culled: want rays [B, R, 3] and %d "
                         "faces in chunks of %d, got %r, %r, %r, %r"
                         % (n_f, ANY_HIT_CHUNK, tuple(origins.shape),
                            tuple(dirs.shape), tuple(faces.shape),
                            tuple(chunks.shape)))
    _grid(origins, faces, "ray_any_hit_culled")


def _ray_terms(origins, dirs, t_lo):
    """Each ray's terms of the chunk test (csrc/ray_any_hit_culled.cu
    CullRay::init), operation for operation: o, d / |d|, 1 / d, |o|_inf,
    |t_lo| |d| and whether a component is not finite."""
    o = [origins[..., k] for k in range(3)]
    d = [dirs[..., k] for k in range(3)]
    dn = torch.sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
    inv = torch.ones_like(dn) / dn
    return {
        "o": o, "h": [x * inv for x in d],
        "inv": [torch.ones_like(x) / x for x in d],
        "onorm": torch.fmax(torch.fmax(o[0].abs(), o[1].abs()), o[2].abs()),
        "tlod": (abs(t_lo) * dn if t_lo is not None
                 else torch.zeros_like(dn)),
        "wild": ~(torch.isfinite(origins).all(dim=-1)
                  & torch.isfinite(dirs).all(dim=-1)),
    }


def _chunk_keep(ray, q, normals, t_lo):
    """([B, R] bool, [B, R] bool): whether each ray may hit a face of the
    chunk whose record is ``q`` [B, 1, CHUNK_WORDS] and whose faces'
    normals over their shape factors are ``normals`` [B, ANY_HIT_CHUNK, 3]
    (csrc/ray_any_hit_culled.cu chunk_needed, operation for operation),
    and whether its test fell back to the faces' normals."""
    lo, rho, hi, edge = q[..., 0:3], q[..., 3], q[..., 4:7], q[..., 7]
    finite = rho <= torch.finfo(torch.float32).max
    axis, ct, cen, st = q[..., 8:11], q[..., 11], q[..., 12:15], q[..., 15]
    w, bm = q[..., 16], q[..., 17]
    o, h, inv = ray["o"], ray["h"], ray["inv"]
    ca = (h[0] * axis[..., 0] + h[1] * axis[..., 1]
          + h[2] * axis[..., 2]).abs()
    sa = torch.sqrt((1.0 - ca * ca) + SINE_PAD)
    c = (ca - CONE_PAD) * ct - sa * st
    # where the cone fails the guard, the least |cos| / rho over the faces
    n = normals[:, None]                                    # [B, 1, 32, 3]
    c_face = (h[0][..., None] * n[..., 0] + h[1][..., None] * n[..., 1]
              + h[2][..., None] * n[..., 2]).abs().amin(dim=-1) - CONE_PAD
    by_face = ~(c > GUARD * rho)
    c = torch.where(by_face, c_face, c)
    rho = torch.where(by_face, 1.0, rho)
    guard = finite & (c > GUARD * rho)
    sb = ((o[0] - cen[..., 0]).abs() + (o[1] - cen[..., 1]).abs()
          + (o[2] - cen[..., 2]).abs())
    m = (MARGIN_REL * rho) * ((w + sb) + ray["tlod"]) / c + MARGIN_EDGE * edge
    mt = m + SLAB_PAD * ((bm + ray["onorm"]) + m)
    t_in, t_out = [], []
    for k in range(3):
        t0 = ((lo[..., k] - mt) - o[k]) * inv[k]
        t1 = ((hi[..., k] + mt) - o[k]) * inv[k]
        t_in.append(torch.fmin(t0, t1))
        t_out.append(torch.fmax(t0, t1))
    t_near = torch.fmax(torch.fmax(t_in[0], t_in[1]), t_in[2])
    t_far = torch.fmin(torch.fmin(t_out[0], t_out[1]), t_out[2])
    miss = t_near > t_far
    if t_lo is not None:
        miss = miss | (t_far < t_lo)
    return ray["wild"] | ~guard | ~miss, by_face & finite & ~ray["wild"]


def _chunk_normals(ops, k):
    """The unit normals over their shape factors [B, ANY_HIT_CHUNK, 3] of
    chunk k's faces."""
    return ops["faces"][:, k * ANY_HIT_CHUNK:(k + 1) * ANY_HIT_CHUNK, 9:12]


def chunk_needs(ops, t_lo=0.0):
    """[B, R, C] bool: whether each ray's chunk test keeps each chunk,
    whatever the ray's hits (``_chunk_keep`` on every chunk)."""
    ray = _ray_terms(ops["origins"], ops["dirs"], t_lo)
    chunks = ops["chunks"]
    out = [_chunk_keep(ray, chunks[:, k:k + 1], _chunk_normals(ops, k),
                       t_lo)[0] for k in range(chunks.shape[1])]
    if not out:
        return torch.zeros(ops["origins"].shape[:2] + (0,), dtype=torch.bool,
                           device=chunks.device)
    return torch.stack(out, dim=-1)


def ray_any_hit_culled_plain(ops, t_lo=0.0, t_hi=None, with_tests=False):
    """Plain PyTorch version of the ``ray_any_hit_culled`` kernel on the
    operands of ``any_hit_operands`` -> (blocked [B, R] bool, pairs each
    ray's lane evaluated [B, R] int32, chunks each warp of 32 rays tested
    [B, ceil(R / 32)] int32, sorted position of the face that blocked each
    ray [B, R] int32, -1 for none).

    The chunks in increasing order; a ray needs a chunk while it is
    unblocked and ``_chunk_keep`` keeps it; a warp counts a chunk one of its
    rays needs; a ray that needs a chunk tests its real faces in order with
    ``mt_hit`` and stops at the first hit.  ``with_tests`` also returns per
    ray the chunk tests its lane ran (one per chunk while it is unblocked)
    and how many of them fell back to the faces' normals: the work the
    kernel's bound counts."""
    origins, dirs, faces, chunks = (ops[k] for k in (
        "origins", "dirs", "faces", "chunks"))
    n_b, n_r = origins.shape[:2]
    n_f = ops["n_faces"]
    dev = origins.device
    ray = _ray_terms(origins, dirs, t_lo)
    blocked = torch.zeros((n_b, n_r), dtype=torch.bool, device=dev)
    pairs = torch.zeros((n_b, n_r), dtype=torch.int32, device=dev)
    first = torch.full((n_b, n_r), -1, dtype=torch.int32, device=dev)
    warp = torch.zeros((n_b, -(-n_r // WARP)), dtype=torch.int32, device=dev)
    work = [torch.zeros_like(pairs) for _ in range(2)] if with_tests else []
    step = max(1, _PLAIN_PAIRS[dev.type] // ANY_HIT_CHUNK)
    for k in range(chunks.shape[1]):
        keep, *fell = _chunk_keep(ray, chunks[:, k:k + 1],
                                  _chunk_normals(ops, k), t_lo)
        need = keep & ~blocked
        for count, did in zip(work, (torch.ones_like(keep), *fell)):
            count += did & ~blocked
        warp += _warp_any(need, 1).to(torch.int32)
        rows_b, rows_r = need.nonzero(as_tuple=True)
        c0 = k * ANY_HIT_CHUNK
        n_real = min(ANY_HIT_CHUNK, n_f - c0)
        for s0 in range(0, rows_b.numel(), step):
            bi, ri = rows_b[s0:s0 + step], rows_r[s0:s0 + step]
            rec = faces[bi, c0:c0 + n_real]                # [n, real, 12]
            hit = mt_hit(_xyz(origins[bi, ri]), _xyz(dirs[bi, ri]),
                         *[tuple(rec[..., 3 * g + j] for j in range(3))
                           for g in range(3)], t_lo, t_hi)
            any_hit = hit.any(dim=-1)
            pos = torch.argmax(hit.to(torch.uint8), dim=-1).to(torch.int32)
            pairs[bi, ri] += torch.where(any_hit, pos + 1,
                                         torch.full_like(pos, n_real))
            first[bi, ri] = torch.where(any_hit, pos + c0, first[bi, ri])
            blocked[bi, ri] = any_hit
    return (blocked, pairs, warp, first, *work)


def ray_any_hit_culled(ops, t_lo=0.0, t_hi=None, with_stats=False):
    """Whether each ray meets a face of its mesh with t in [t_lo, t_hi]
    (``None``: unbounded), and the pairs each ray's lane evaluated: the
    ``ray_any_hit_culled`` CUDA kernel for CUDA operands, its plain version
    for CPU operands.  The flags are ``ray_any_hit``'s on the same rays and
    faces.  ``with_stats`` also returns the chunks each warp tested and the
    sorted position of each ray's blocking face, as
    ``ray_any_hit_culled_plain`` does."""
    t_lo = None if t_lo is None else float(t_lo)
    t_hi = None if t_hi is None else float(t_hi)
    _check_any_hit_ops(ops)
    origins = ops["origins"]
    if origins.device.type == "cpu":
        out = ray_any_hit_culled_plain(ops, t_lo, t_hi)
        return out if with_stats else out[:2]
    from .. import _build

    n_b, n_r = origins.shape[:2]
    dev = origins.device
    blocked = torch.empty((n_b, n_r), dtype=torch.int32, device=dev)
    pairs = torch.empty_like(blocked)
    stats = ((torch.empty((n_b, -(-n_r // WARP)), dtype=torch.int32,
                          device=dev), torch.empty_like(blocked))
             if with_stats else (None, None))
    _build.launch("ray_any_hit_culled", dev, origins, ops["dirs"],
                  ops["faces"], ops["chunks"], blocked, pairs, *stats, n_b,
                  n_r, ops["n_faces"], ops["chunks"].shape[1],
                  int(t_lo is not None), 0.0 if t_lo is None else t_lo,
                  int(t_hi is not None), 0.0 if t_hi is None else t_hi)
    LAUNCHES["ray_any_hit_culled"] += 1
    out = (blocked.bool(), pairs)
    return out + stats if with_stats else out


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
