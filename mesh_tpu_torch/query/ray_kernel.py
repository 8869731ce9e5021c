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
  query that hits nothing gets face 0, and the lowest face index wins an
  exact tie.  An exact per-warp chunk cull on row 8's operands
  (``alongnormal_cull_operands``: the faces Morton-sorted into chunks,
  their records, each sorted face's original index): each mesh's queries
  in Morton order, a lane folds one candidate (_BIG, the chunk's least
  index) for a chunk its line misses (``_chunk_keep``), skips a chunk
  whose bound on its hits' |t| (``along_bound``) exceeds its best so far,
  and its warp folds the chunks a lane needs, lexicographically on (cost,
  index), so that the walk's order does not matter; each warp's chunks
  may be split over ``split`` warps.  The registration path runs it.
- ``alongnormal_faces_every`` (``csrc/alongnormal_faces_every.cu``): every
  face, the oracle that ``chip_smoke.py`` holds the cull to; no path
  launches it.  ``nearest_alongnormal_kernel`` re-tests the winner with
  the same predicate, so a face accepted by the kernel never comes back
  as a miss.

The wrappers take the kernel's path for CUDA tensors and the plain version
for CPU tensors (``alongnormal_faces``: the every-face plain version, or
with its counts the plain version of the cull); any other device raises.
``LAUNCHES`` counts each kernel's launches.  Neither centers: the rays and
faces are used as given, as the reference's kernels use them.
"""

import torch

from .closest_kernel import (
    _PLAIN_PAIRS,
    _batched,
    _check_operands,
    _chunks,
    _grid,
    _warp_vote,
    no_queries,
)
from .culled_kernel import (
    WARP,
    _morton_codes,
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
            "alongnormal_faces": 0, "alongnormal_faces_every": 0}

#: faces per chunk of the culled any-hit kernel: one warp's worth, so a
#: staged chunk is at most one 16-byte copy per thread of a 128-ray block
ANY_HIT_CHUNK = 32
#: floats of a face record (a, e1, e2, unit normal / rho) and of a chunk
#: record (csrc/ray_cull.cuh chunk_needed)
FACE_WORDS = 12
CHUNK_WORDS = 20
#: the cull's constants, each a power of two with its argument in
#: csrc/ray_cull.cuh: the cone's pads, the guard, the margin's
#: two terms and the slab test's pad
CONE_PAD = 2.0 ** -19
SINE_PAD = 2.0 ** -17
GUARD = 2.0 ** -18
MARGIN_REL = 2.0 ** -17
MARGIN_EDGE = 2.0 ** -16
SLAB_PAD = 2.0 ** -20
#: taken off each chunk's cone cosine for its float64 normals' rounding
CONE_SLACK = 1e-6

#: the along-normal cull's bound (csrc/alongnormal_faces.cu, item 3): its
#: relative and absolute terms, and the range of |n|^2 outside which a
#: lane keeps every chunk (item 5)
BOUND_REL = 2.0 ** -19
BOUND_TINY = 2.0 ** -100
LOOSE_LO = 2.0 ** -100
LOOSE_HI = 2.0 ** 100
#: the most warps that share one warp's chunks
#: (csrc/alongnormal_faces.cu kAlongMaxSplit)
ALONG_MAX_SPLIT = 64
#: the split the registration path launches: on an H100 (PERF.md, row 9;
#: tools/ab_along.py) 16 and 32 beat 1, 2, 4 and 8 at phase 8's 65,536
#: queries (1.02-1.03 ms against 1.53 at split 1), within 1% of each other
ALONG_SPLIT = 16
#: chunks whose faces a lane's seed folds (csrc/alongnormal_faces.cu
#: kSeedChunks): on phase 8's scan points a seed over 1 / 2 / 4 / 8 chunks
#: is the lane's best cost for 46% / 70% / 93% / 99.5% of the lanes, and
#: the warps fold 18.9% / 16.5% / 13.0% / 11.2% of the chunks at split 16
#: (tools/cull_counts.py --along --seed-chunks 1,2,8); past 4 the seed's
#: own pairs cost about what the folds save
SEED_CHUNKS = 4
#: lane-chunk elements of the plain cull's seed search at once
_PLAIN_SEED_ELEMS = 1 << 20

INF = float("inf")


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
    (csrc/ray_cull.cuh)."""
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
    """Each ray's terms of the chunk test (csrc/ray_cull.cuh
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


def _chunk_keep(ray, q, normals, t_lo, span=False):
    """([B, R] bool, [B, R] bool): whether each ray may hit a face of the
    chunk whose record is ``q`` [B, 1, CHUNK_WORDS] and whose faces'
    normals over their shape factors are ``normals`` [B, ANY_HIT_CHUNK, 3]
    (csrc/ray_cull.cuh chunk_needed, operation for operation), and whether
    its test fell back to the faces' normals.  ``span`` adds what
    chunk_needed's ChunkSpan holds, as [B, R] tensors: ``decided`` (the
    guard held), ``t_near`` and ``t_far`` (the slab interval), ``rho`` and
    ``c`` (the guard's pair) and ``s`` (W + |o - cen|_1)."""
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
    keep = ray["wild"] | ~guard | ~miss
    fell = by_face & finite & ~ray["wild"]
    if not span:
        return keep, fell
    return keep, fell, {"decided": guard & ~ray["wild"], "t_near": t_near,
                        "t_far": t_far, "rho": rho, "c": c, "s": w + sb}


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
# alongnormal_faces: the every-face plain version and kernel, the chunk
# cull's operands, its plain version and the wrapper

def _alongnormal_cost_tile(p, n, a, e1, e2):
    """|t| where the line p + t n meets the face, else _BIG (reference
    _alongnormal_cost_tile)."""
    hit, ad, tn = mt_line_hit(p, n, a, e1, e2)
    t_abs = tn.abs() / torch.where(ad == 0, torch.ones_like(ad), ad)
    return torch.where(hit, t_abs, torch.full_like(t_abs, _BIG))


def _never_nan(cost):
    """``cost`` with NaN as +inf: the kernels' folds never take a NaN cost,
    and a +inf one only where nothing is below it, as for NaN."""
    return torch.where(torch.isnan(cost), torch.full_like(cost, INF), cost)


def argmin_alongnormal_plain(pts, normals, planes):
    """Plain PyTorch version of the every-face ``alongnormal_faces_every``
    kernel: the face with the least |t| per query, [B, Q] int32, lowest
    index on exact ties (face 0 when nothing is hit; a NaN cost never
    wins, as in the kernel's fold).  ``pts``, ``normals`` [B, Q, 3] and
    ``planes`` [B, 9, F] float32."""
    n_b, n_q = pts.shape[:2]
    out = torch.empty((n_b, n_q), dtype=torch.int32, device=pts.device)
    for b0, b1, q0, q1 in _chunks(n_b, n_q, planes.shape[-1], pts.device):
        cost = _alongnormal_cost_tile(
            _xyz(pts[b0:b1, q0:q1]), _xyz(normals[b0:b1, q0:q1]),
            *_rows(planes, b0, b1))
        out[b0:b1, q0:q1] = torch.argmin(_never_nan(cost),
                                         dim=-1).to(torch.int32)
    return out


def alongnormal_cull_operands(tri):
    """The face side of the ``alongnormal_faces`` chunk cull, from each
    mesh's faces ``tri`` [B, F, 3, 3] (F > 0): row 8's operands
    (``any_hit_sorted_faces``, ``any_hit_records``: ``faces`` [B, Fp,
    FACE_WORDS], ``chunks`` [B, C, CHUNK_WORDS], Fp = C ANY_HIT_CHUNK),
    ``ids`` [B, Fp] int32, the original index of each sorted position
    (padding repeats the last), ``min_ids`` [B, C] int32, the least
    original index of each chunk's faces, and ``n_faces`` F.  It depends
    on the mesh only: a tree makes it once."""
    tri = tri.to(torch.float32)
    if tri.ndim != 4 or tri.shape[-2:] != (3, 3) or not tri.shape[1]:
        raise ValueError("alongnormal_cull_operands: want faces [B, F, 3, 3]"
                         " with F > 0, got %r" % (tuple(tri.shape),))
    order, tri_s = any_hit_sorted_faces(tri)
    faces, chunks = any_hit_records(tri_s)
    ids = _pad_rows_edge(order.to(torch.int32), ANY_HIT_CHUNK, dim=1)
    min_ids = ids.view(ids.shape[0], -1, ANY_HIT_CHUNK).amin(dim=-1)
    return {"faces": faces, "chunks": chunks, "ids": ids.contiguous(),
            "min_ids": min_ids.contiguous(), "n_faces": tri.shape[1],
            "box": (chunks[..., 0:3].amin(dim=1, keepdim=True),
                    chunks[..., 4:7].amax(dim=1, keepdim=True))}


def along_query_order(pts, cull):
    """[B, Q] int32: each mesh's queries ``pts`` [B, Q, 3] in the Morton
    order of their positions within the mesh's box (``cull["box"]``; a
    query outside it takes the code of the nearest point of the box), a
    stable sort: the kernel's lane order.  Normalizing to the queries' own
    box instead lets one far query (registration's planted miss) squeeze
    the others' codes into a corner of the grid, and warps lose their
    compactness."""
    if pts.shape[1] == 0:
        return torch.empty(pts.shape[:2], dtype=torch.int32,
                           device=pts.device)
    return torch.argsort(_morton_codes(pts, cull["box"]), dim=1,
                         stable=True).to(torch.int32)


def _check_along_cull(pts, cull, qorder):
    n_b, n_q = pts.shape[:2]
    n_c = cull["chunks"].shape[1] if cull["chunks"].ndim == 3 else -1
    n_f, n_p = cull["n_faces"], n_c * ANY_HIT_CHUNK
    want = (("faces", torch.float32, (n_b, n_p, FACE_WORDS)),
            ("chunks", torch.float32, (n_b, n_c, CHUNK_WORDS)),
            ("ids", torch.int32, (n_b, n_p)),
            ("min_ids", torch.int32, (n_b, n_c)),
            ("qorder", torch.int32, (n_b, n_q)))
    for key, dtype, shape in want:
        t = qorder if key == "qorder" else cull[key]
        if (t.dtype != dtype or not t.is_contiguous()
                or t.device != pts.device or tuple(t.shape) != shape
                or (t.device.type == "cuda" and t.data_ptr() % 16)):
            raise ValueError("alongnormal_faces: want %s %s %s, contiguous "
                             "and 16-byte aligned, on %s; got %s %s on %s"
                             % (key, shape, dtype, pts.device,
                                tuple(t.shape), t.dtype, t.device))
    if not (n_c - 1) * ANY_HIT_CHUNK < n_f <= n_p:
        raise ValueError("alongnormal_faces: %d faces do not fill %d chunks "
                         "of %d" % (n_f, n_c, ANY_HIT_CHUNK))


def _check_split(split):
    if not 1 <= int(split) <= ALONG_MAX_SPLIT:
        raise ValueError("alongnormal_faces: split %r not in [1, %d]"
                         % (split, ALONG_MAX_SPLIT))
    return int(split)


def _face_cost(p, n, rec):
    """The along-normal cost of lanes ``p``, ``n`` [N, 1] (tuples of three)
    against face records ``rec`` [N, K, FACE_WORDS] -> [N, K]."""
    return _alongnormal_cost_tile(
        p, n, *[tuple(rec[..., 3 * g + j] for j in range(3))
                for g in range(3)])


def _seed_keys(ps, chunks):
    """([B, L, C] float32, same): the distance squared of each lane's point
    to each chunk's box (0 inside) and to its centre, NaN read as +inf
    (csrc/alongnormal_faces.cu along_seed_kernel)."""
    p = [ps[..., k, None] for k in range(3)]
    lo, hi, cen = chunks[..., 0:3], chunks[..., 4:7], chunks[..., 12:15]
    e = [torch.fmax(torch.fmax(lo[:, None, :, k] - p[k],
                               p[k] - hi[:, None, :, k]),
                    torch.zeros_like(p[k])) for k in range(3)]
    dc = [p[k] - cen[:, None, :, k] for k in range(3)]
    return (_never_nan(e[0] * e[0] + e[1] * e[1] + e[2] * e[2]),
            _never_nan(dc[0] * dc[0] + dc[1] * dc[1] + dc[2] * dc[2]))


def along_seeds_plain(ps, ns, cull):
    """[B, L] float32: per lane (``ps``, ``ns`` [B, L, 3], lanes in any
    order), the least cost over the real faces of its SEED_CHUNKS nearest
    chunks, nearest by the distance to the chunk's box, then to its
    centre, then the lower chunk; a NaN cost is never taken
    (csrc/alongnormal_faces.cu along_seed_kernel)."""
    faces, chunks = cull["faces"], cull["chunks"]
    n_b, n_l = ps.shape[:2]
    n_c = chunks.shape[1]
    m = min(SEED_CHUNKS, n_c)
    seed = torch.empty((n_b, n_l), dtype=torch.float32, device=ps.device)
    step = max(1, _PLAIN_SEED_ELEMS // max(1, n_b * n_c))
    ramp = torch.arange(ANY_HIT_CHUNK, device=ps.device)
    for l0 in range(0, n_l, step):
        l1 = min(n_l, l0 + step)
        db, dc = _seed_keys(ps[:, l0:l1], chunks)
        order = torch.argsort(dc, dim=-1, stable=True)
        order = torch.gather(order, -1, torch.argsort(
            torch.gather(db, -1, order), dim=-1, stable=True))[..., :m]
        pos = (order[..., None] * ANY_HIT_CHUNK + ramp).flatten(-2)
        n = l1 - l0
        rec = torch.gather(faces, 1, pos.reshape(n_b, -1, 1).expand(
            n_b, n * m * ANY_HIT_CHUNK, FACE_WORDS)).view(n_b * n, -1,
                                                         FACE_WORDS)
        cost = _never_nan(_face_cost(_xyz(ps[:, l0:l1].reshape(-1, 3)),
                                     _xyz(ns[:, l0:l1].reshape(-1, 3)), rec))
        real = pos.reshape(n_b * n, -1) < cull["n_faces"]
        seed[:, l0:l1] = torch.where(real, cost, INF).amin(dim=-1).view(
            n_b, n)
    return seed


def _lane_terms(pts, normals, qo, q_pad):
    """The lanes' points and normals [B, q_pad, 3] in sorted order (zero
    padded), their chunk-test terms (``_ray_terms``, the whole line), 1 /
    |n| and whether they keep every chunk (``loose``: a non-finite
    component or |n|^2 outside [LOOSE_LO, LOOSE_HI])."""
    n_b, n_q = pts.shape[:2]

    def lanes(x):
        out = torch.zeros((n_b, q_pad, 3), dtype=x.dtype, device=x.device)
        out[:, :n_q] = torch.gather(x, 1, qo[..., None].expand(n_b, n_q, 3))
        return out

    ps, ns = lanes(pts), lanes(normals)
    ray = _ray_terms(ps, ns, None)
    nx, ny, nz = ns.unbind(-1)
    dn2 = nx * nx + ny * ny + nz * nz
    inv_dn = torch.ones_like(dn2) / torch.sqrt(dn2)
    loose = ray["wild"] | ~((dn2 >= LOOSE_LO) & (dn2 <= LOOSE_HI))
    return ps, ns, ray, inv_dn, loose


def along_bound(span, inv_dn):
    """[B, L] float32: the lane's lower bound LB on the cost of every face
    of a chunk that its line hits (csrc/alongnormal_faces.cu, item 3), from
    ``_chunk_keep``'s span, clamped to _BIG (a NaN stays)."""
    t_near, t_far = span["t_near"], span["t_far"]
    tau0 = torch.where(t_near > 0, t_near,
                       torch.where(t_far < 0, -t_far,
                                   torch.zeros_like(t_far)))
    tau = torch.clamp_max(tau0, torch.finfo(torch.float32).max)
    kr = BOUND_REL * (span["rho"] / span["c"])
    lb = (tau - kr * (span["s"] * inv_dn + tau)) - BOUND_TINY
    return torch.where(lb > _BIG, torch.full_like(lb, _BIG), lb)


def _lex_take(d, i, best, best_i):
    """Where the pair (d, i) is below (best, best_i) lexicographically."""
    return (d < best) | ((d == best) & (i < best_i))


def _fold_misses(miss, min_id, best, best_i):
    """(best, best_i) after each lane where ``miss`` folds its chunk's one
    candidate (_BIG, ``min_id``) (csrc/alongnormal_faces.cu, item 2)."""
    take = miss & _lex_take(_BIG, min_id, best, best_i)
    return (torch.where(take, torch.full_like(best, _BIG), best),
            torch.where(take, min_id, best_i))


def argmin_alongnormal_culled_plain(pts, normals, cull, qorder=None,
                                    split=1, seed=True, with_tests=False):
    """Plain PyTorch version of the ``alongnormal_faces`` kernel's chunk
    cull: (face with the least |t| per query [B, Q] int32, chunks each warp
    folded [B, ceil(Q / 32)], real faces of the chunks each query's own
    lane needed [B, Q] at its sorted position, chunks each warp staged
    [B, ceil(Q / 32)], chunks each lane folded as one miss candidate
    [B, Q] at its sorted position), int32, the counts summed over the
    splits.  The faces are ``argmin_alongnormal_plain``'s.

    Queries run in ``qorder`` (``along_query_order`` when None),
    32 to a warp.  Each lane is seeded by ``along_seeds_plain`` (+inf
    without ``seed``).  The chunks are cut into ``split`` ranges
    [C s / split, C (s + 1) / split), each folded from (+inf, 0): per
    chunk a lane runs ``_chunk_keep`` on its whole line; where the line
    misses the grown box it folds (_BIG, the chunk's least index), else it
    needs the chunk unless ``along_bound`` exceeds min(best, seed, _BIG)
    (always where the guard failed or the lane is loose).  A warp stages
    chunk k when one of its lanes needs it against the state before the
    last chunk it staged (the kernel votes one chunk ahead), and folds a
    staged chunk, every lane of it, when one of its lanes needs it against
    the state now.  Every fold is lexicographic on (cost, original index),
    a NaN cost never taken, and the ranges merge the same way.
    ``with_tests`` also returns, per query at its sorted position, the
    chunk tests its lane ran, how many of them fell back to the faces'
    normals and how many found the line meeting the grown box with the
    guard held (each then computes the bound): the work the kernel's bound
    counts."""
    split = _check_split(split)
    n_b, n_q = pts.shape[:2]
    faces, chunks, ids = cull["faces"], cull["chunks"], cull["ids"]
    n_f, n_c = cull["n_faces"], chunks.shape[1]
    dev = pts.device
    qo = (along_query_order(pts, cull) if qorder is None
          else qorder).long()
    q_pad = -(-n_q // WARP) * WARP
    n_w = q_pad // WARP
    warp = torch.zeros((n_b, n_w), dtype=torch.int32, device=dev)
    lane = torch.zeros((n_b, q_pad), dtype=torch.int32, device=dev)
    stage = torch.zeros_like(warp)
    misses = torch.zeros_like(lane)
    tests = [torch.zeros_like(lane) for _ in range(3)] if with_tests else []
    valid = (torch.arange(q_pad, device=dev) < n_q).expand(n_b, q_pad)
    ps, ns, ray, inv_dn, loose = _lane_terms(pts, normals, qo, q_pad)
    seeds = (along_seeds_plain(ps, ns, cull) if seed
             else torch.full((n_b, q_pad), INF, device=dev))
    inf = torch.full((n_b, q_pad), INF, device=dev)
    parts = []
    for s in range(split):
        best = inf.clone()
        best_i = torch.zeros((n_b, q_pad), dtype=torch.int32, device=dev)
        snap = best.clone()
        for k in range(n_c * s // split, n_c * (s + 1) // split):
            keep, fell, span = _chunk_keep(ray, chunks[:, k:k + 1],
                                           _chunk_normals(cull, k), None,
                                           span=True)
            decided = span["decided"] & ~loose
            miss = valid & decided & ~keep
            misses += miss.to(torch.int32)
            ran = valid & ~loose
            for count, did in zip(tests, (ran, ran & fell,
                                          ran & decided & keep)):
                count += did.to(torch.int32)
            best, best_i = _fold_misses(
                miss, cull["min_ids"][:, k:k + 1].expand(n_b, q_pad), best,
                best_i)
            lb = torch.where(decided, along_bound(span, inv_dn), -inf)
            lb = torch.where(miss | ~valid, inf, lb)

            def needed(b_):
                thr = torch.clamp_max(torch.fmin(b_, seeds), _BIG)
                return ~(lb > thr) & valid

            vote = _warp_vote(needed(snap))
            if not bool(vote.any()):
                continue
            stage += vote.to(torch.int32)
            snap = torch.where(vote.repeat_interleave(WARP, -1), best, snap)
            need = needed(best)
            folds = _warp_vote(need)
            c0 = k * ANY_HIT_CHUNK
            nf = min(ANY_HIT_CHUNK, n_f - c0)
            warp += folds.to(torch.int32)
            lane += need.to(torch.int32) * nf
            if not bool(folds.any()):
                continue
            bi, li = torch.nonzero(folds.repeat_interleave(WARP, -1),
                                   as_tuple=True)
            cost = _never_nan(_face_cost(_xyz(ps[bi, li]), _xyz(ns[bi, li]),
                                         faces[bi, c0:c0 + nf]))
            low = cost.amin(dim=-1)
            cand = torch.where(cost == low[:, None], ids[bi, c0:c0 + nf],
                               torch.iinfo(torch.int32).max).amin(dim=-1)
            take = _lex_take(low, cand, best[bi, li], best_i[bi, li])
            best[bi, li] = torch.where(take, low, best[bi, li])
            best_i[bi, li] = torch.where(take, cand, best_i[bi, li])
        parts.append((best, best_i))
    best, best_i = parts[0]
    for d, i in parts[1:]:
        take = _lex_take(d, i, best, best_i)
        best = torch.where(take, d, best)
        best_i = torch.where(take, i, best_i)
    out = torch.zeros((n_b, n_q), dtype=torch.int32, device=dev)
    out.scatter_(1, qo, best_i[:, :n_q])
    return (out, warp, lane[:, :n_q], stage, misses[:, :n_q],
            *(t[:, :n_q] for t in tests))


def argmin_alongnormal(pts, normals, planes=None, cull=None,
                       with_stats=False, split=None, qorder=None):
    """The face with the least |t| per query: the ``alongnormal_faces``
    CUDA kernel, the exact chunk cull, for CUDA tensors;
    ``argmin_alongnormal_plain`` on ``planes`` [B, 9, F] for CPU tensors.
    ``cull``: the face side of ``alongnormal_cull_operands`` (which the
    kernel needs: it reads no planes); ``qorder``: the lanes' order
    (``along_query_order`` when None); ``split``:
    warps sharing one warp's chunks (``ALONG_SPLIT`` when None);
    ``with_stats`` returns the five outputs of
    ``argmin_alongnormal_culled_plain`` (which a CPU call runs then).  A
    failed build or launch raises: no other version stands in."""
    name = "alongnormal_faces"
    if planes is None:
        planes_like = torch.empty((pts.shape[0], N_RAY_ROWS, 0),
                                  device=pts.device)
        check_with_vectors(pts, normals, planes_like, N_RAY_ROWS, name)
    else:
        check_with_vectors(pts, normals, planes, N_RAY_ROWS, name)
    split = _check_split(ALONG_SPLIT if split is None else split)
    if pts.device.type == "cpu" and not with_stats:
        if planes is None:
            raise ValueError("alongnormal_faces: a CPU call takes the "
                             "every-face plain version, which needs planes")
        return argmin_alongnormal_plain(pts, normals, planes)
    if not pts.shape[1]:
        return no_queries(pts.shape[0], pts.device, 5 if with_stats else 1)
    if cull is None:
        raise ValueError("alongnormal_faces: the chunk cull needs its face "
                         "operands, alongnormal_cull_operands(tri)")
    if qorder is None:
        qorder = along_query_order(pts, cull)
    _check_along_cull(pts, cull, qorder)
    if pts.device.type == "cpu":
        return argmin_alongnormal_culled_plain(pts, normals, cull, qorder,
                                               split)
    from .. import _build

    n_b, n_q = pts.shape[:2]
    if n_b > 65535:
        raise ValueError("%s: batch of %d meshes exceeds the grid's 65535"
                         % (name, n_b))
    dev = pts.device
    out = torch.empty((n_b, n_q), dtype=torch.int32, device=dev)
    seeds = torch.empty((n_b, n_q), dtype=torch.float32, device=dev)
    part_d = part_i = None
    if split > 1:
        part_d = torch.empty((split, n_b, n_q), dtype=torch.float32,
                             device=dev)
        part_i = torch.empty((split, n_b, n_q), dtype=torch.int32,
                             device=dev)
    stats = tuple(
        torch.zeros((split, n_b, -(-n_q // size)), dtype=torch.int32,
                    device=dev) for size in (WARP, 1, WARP, 1)
    ) if with_stats else (None,) * 4
    _build.launch(name, dev, pts, normals, qorder, cull["faces"],
                  cull["chunks"], cull["ids"], cull["min_ids"], seeds, part_d,
                  part_i, out, *stats, n_b, n_q, cull["n_faces"],
                  cull["chunks"].shape[1], split)
    LAUNCHES[name] += 1
    if not with_stats:
        return out
    return (out,) + tuple(t.sum(dim=0, dtype=torch.int32) for t in stats)


def argmin_alongnormal_every(pts, normals, planes):
    """The face with the least |t| per query over every face: the
    ``alongnormal_faces_every`` CUDA kernel (the cull's oracle; no path
    launches it) for CUDA tensors, ``argmin_alongnormal_plain`` for CPU
    tensors."""
    check_with_vectors(pts, normals, planes, N_RAY_ROWS,
                       "alongnormal_faces_every")
    if pts.device.type == "cpu":
        return argmin_alongnormal_plain(pts, normals, planes)
    from .. import _build

    out = torch.empty(pts.shape[:2], dtype=torch.int32, device=pts.device)
    _build.launch("alongnormal_faces_every", pts.device, pts, normals, planes,
                  out, *_grid(pts, planes, "alongnormal_faces_every"))
    LAUNCHES["alongnormal_faces_every"] += 1
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


def alongnormal_operands(v, f):
    """What an along-normal search needs of a mesh, made once per mesh:
    ``tri`` [B, F, 3, 3] float32 of ``v`` [B, V, 3] and ``f`` [F, 3] (the
    epilogue's), and for CUDA tensors the chunk cull's face side
    (``cull``: ``alongnormal_cull_operands``), for CPU tensors the
    every-face plain version's ``planes``."""
    tri = v.to(torch.float32)[..., f.long(), :]
    if tri.device.type == "cpu" or not tri.shape[1]:
        return {"tri": tri, "planes": ray_planes(tri)}
    return {"tri": tri, "cull": alongnormal_cull_operands(tri)}


def _nearest_alongnormal(v, f, points, normals, argmin, ops):
    vb, pb, unbatch = _batched(v, points)
    if ops is None:
        ops = alongnormal_operands(vb, f)
    pts = pb.to(torch.float32).contiguous()
    nrm = normals.to(torch.float32).reshape(pts.shape).contiguous()
    best = argmin(pts, nrm, ops)
    out = alongnormal_epilogue(best, ops["tri"], pts, nrm)
    if unbatch:
        return tuple(x[0] for x in out)
    return out


def _argmin_kernel(pts, nrm, ops):
    if "cull" in ops:
        return argmin_alongnormal(pts, nrm, cull=ops["cull"])
    if pts.device.type == "cpu":
        return argmin_alongnormal(pts, nrm, ops["planes"])
    # a mesh without faces: every query gets face 0, as every fold gives it
    return torch.zeros(pts.shape[:2], dtype=torch.int32, device=pts.device)



def nearest_alongnormal_kernel(v, f, points, normals, ops=None):
    """Nearest hit along +/- normal per query -> (distance [..., Q], face
    [..., Q] int32, point [..., Q, 3]); ``v`` [V, 3] with ``points`` and
    ``normals`` [Q, 3], or a batch ``v`` [B, V, 3] with [B, Q, 3] (one
    launch).  The chunk-cull kernel on the card, its every-face plain
    version on the CPU.  ``ops``: ``alongnormal_operands`` of the batched
    ``v`` and ``f``, made here when None (a tree keeps them)."""
    return _nearest_alongnormal(v, f, points, normals, _argmin_kernel, ops)


def nearest_alongnormal_plain(v, f, points, normals):
    """``nearest_alongnormal_kernel`` with the every-face plain argmin on
    any device."""
    tri = _batched(v, points)[0].to(torch.float32)[..., f.long(), :]
    return _nearest_alongnormal(
        v, f, points, normals,
        lambda pts, nrm, ops: argmin_alongnormal_plain(pts, nrm,
                                                       ops["planes"]),
        {"tri": tri, "planes": ray_planes(tri)})
