"""Triangle-triangle kernels: the any-hit test of query triangles against a
mesh and the per-face self-intersection counts, their CUDA wrappers, plain
PyTorch versions and prologues (counterpart of the triangle half of
mesh_tpu/query/pallas_ray.py).

Two kernels over two pair tests (``csrc/tri_tri_cost.cuh``, here
``segment_hit_tile`` and ``moller_hit_tile``):

- the **segment** tile: the three edges of each triangle against the other
  triangle, each the division-free line test of ``ray_kernel.mt_line_hit``
  with eps = beps = 1e-9 and t in [T_LO, T_HI].  Query operand: the raw
  corners (``segment_planes``, 9 rows); face operand: (a, e1, e2), the ray
  kernels' planes.  Valid on any mesh: a zero-area face still has edges.
- the **Moller** tile: Moller's interval test without division on 13 rows
  per triangle (corners, unit normal, plane offset) of triangles jointly
  prescaled into the unit box (``moller_planes``).  About half the
  arithmetic, but blind to degenerate triangles, so the facades take it
  only when every face of both meshes passes ``mesh_is_nondegenerate``.

- ``tri_tri_any_hit`` (``csrc/tri_tri_any_hit.cu``): per query triangle,
  whether it meets any face, and the pairs a scan in face order tests for
  it: the first hit's index plus one, or every face.  In the Moller tile
  it is an exact cull on ``tri_any_hit_operands``: a face is a candidate
  unless its plane clears the box of every query corner by a margin
  (``tri_records``, one kernel), and a query skips a chunk of 32 faces
  whose candidates' box its own plane clears, each warp of 32 consecutive
  queries staging the chunks one of its lanes needs; ``TRI_SPLIT`` warps
  share a warp's chunks and keep each query's first hit with an atomic
  minimum, so the index is the same whatever order they run in.  The
  segment tile tests every pair.  ``tri_tri_any_hit_culled_plain`` is the
  plain version of the cull, ``tri_tri_any_hit_plain`` tests every pair, and
  ``tri_tri_any_hit_every`` (``csrc/tri_tri_any_hit_every.cu``) is the
  every-pair kernel, the cull's oracle, which no path launches.
- ``self_intersect_counts`` (``csrc/self_intersect.cu``): per face of a
  query range, the number of other faces sharing no vertex index with it
  that it meets, the partial counts of the face ranges summed with integer
  atomics.  The faces are staged in tiles of ``SELF_TILE``; in the Moller
  tile a query skips a tile whose corner box lies beyond a margin on one
  side of its plane (``moller_tile_needs``), which the pair test would
  reject pair by pair, and a pair on one side of either plane skips the
  interval part.  ``self_intersection_counts_kernel`` sorts the faces by
  the Morton code of their centroid first, so tiles are compact patches.
  The plain version of this design is ``self_intersect_culled_plain``;
  ``self_intersect_counts_plain`` tests every pair.

The wrappers take the kernel's path for CUDA tensors and the plain version
for CPU tensors; any other device raises.  ``LAUNCHES`` counts each
kernel's launches and ``TILE_LAUNCHES`` each kernel's launches per tile.
The prologues run in PyTorch on the operands' device, so a kernel and its
plain version read the same planes.
"""

import numpy as np
import torch

from ..geometry.cross_product import cross3
from .culled_kernel import (
    WARP,
    _pad_rows_edge,
    _warp_any,
    morton_face_order,
)
from .ray import _EPS
from .ray_kernel import mt_line_hit, ray_planes

ALGORITHMS = ("segment", "moller")

#: rows of each tile's operands: segment (query corners; face a, e1, e2)
#: and Moller (corners, unit normal, plane offset)
N_ROWS = {"segment": 9, "moller": 13}

#: the segment tile's bounds on t, as Python floats: both packages and the
#: kernel's C arguments round them to float32 (-1e-9, and exactly 1.0)
T_LO = -_EPS
T_HI = 1.0 + _EPS

#: launches of each CUDA kernel since the counts were last set to 0
LAUNCHES = {"tri_tri_any_hit": 0, "tri_tri_any_hit_every": 0,
            "tri_records": 0, "self_intersect": 0}
#: the launches of the kernels that run a pair tile, per tile
TILE_LAUNCHES = {"%s[%s]" % (k, a): 0 for k in LAUNCHES if k != "tri_records"
                 for a in ALGORITHMS}

#: faces per chunk of the tri_tri_any_hit cull (csrc/tri_tri_any_hit.cu
#: kTriChunk), words of its face record (the 13 Moller rows, zero-padded)
#: and of its chunk record (the candidates' box: lo, hi, P; the mask's bits)
TRI_CHUNK = 32
TRI_FACE_WORDS = 16
TRI_CHUNK_WORDS = 8
#: warps sharing one warp's chunks in the tri_tri_any_hit cull, and the
#: most the kernel takes
TRI_SPLIT = 64
TRI_MAX_SPLIT = 64

#: faces per staged tile of the self_intersect kernel
#: (csrc/self_intersect.cu kSelfTile)
SELF_TILE = 128

#: the Moller tile cull's margin M = MARGIN_FLOOR + MARGIN_REL * X, with
#: X = |n|_1 P + |d|, taken only where X < MARGIN_CAP; powers of two, so
#: float32 holds them exactly (derivation: csrc/self_intersect.cu)
MARGIN_FLOOR = 2.0 ** -28
MARGIN_REL = 2.0 ** -20
MARGIN_CAP = 2.0 ** 100

#: query-face pairs one plain-version chunk evaluates at once, per device
#: type: each of the Moller tile's live temporaries is this many values
_PLAIN_PAIRS = {"cpu": 1 << 18, "cuda": 1 << 24}


def _check_algorithm(algorithm):
    if algorithm not in ALGORITHMS:
        raise ValueError("algorithm must be 'segment' or 'moller', got %r"
                         % (algorithm,))


def _sum3(x):
    """Sum over a last axis of 3, left to right (the reference's order)."""
    return x[..., 0] + x[..., 1] + x[..., 2]


# ---------------------------------------------------------------------------
# The pair tests.  ``q`` is a tuple of the query operand's rows as [TQ, 1]
# columns, ``m`` of the face operand's rows as [1, TF]; each tile returns a
# [TQ, TF] bool.  csrc/tri_tri_cost.cuh does the same operations in the same
# order.

def _seg_hit(o, d, a, e1, e2, t_lo, t_hi):
    """The segment o -> o + d against the triangle (a, e1, e2): the line
    test with the tight tolerances and t_lo <= t <= t_hi (reference
    _mt_hit with eps = beps = 1e-9)."""
    hit, ad, tn = mt_line_hit(o, d, a, e1, e2, eps=_EPS, beps=_EPS)
    hit = hit & (tn >= t_lo * ad)
    return hit & (tn <= t_hi * ad)


def _sub(u, w):
    return tuple(ui - wi for ui, wi in zip(u, w))


def segment_hit_tile(q, m, t_lo=T_LO, t_hi=T_HI):
    """The three query edges against the mesh face and the three mesh
    edges against the query triangle (reference _tri_tri_hit_tile): the
    face corners b, c are rebuilt as a + e1, a + e2 and the query edges
    taken from the raw corners."""
    qa, qb, qc = q[0:3], q[3:6], q[6:9]
    ma, me1, me2 = m[0:3], m[3:6], m[6:9]
    mb = tuple(a + e for a, e in zip(ma, me1))
    mc = tuple(a + e for a, e in zip(ma, me2))
    hit = None
    for s0, s1 in ((qa, qb), (qb, qc), (qc, qa)):
        h = _seg_hit(s0, _sub(s1, s0), ma, me1, me2, t_lo, t_hi)
        hit = h if hit is None else hit | h
    qe1 = _sub(qb, qa)
    qe2 = _sub(qc, qa)
    for s0, s1 in ((ma, mb), (mb, mc), (mc, ma)):
        hit = hit | _seg_hit(s0, _sub(s1, s0), qa, qe1, qe2, t_lo, t_hi)
    return hit


def _plane_dist(n, d, p, eps):
    """n.p + d, zeroed where below eps in magnitude (the published plane
    thickening)."""
    val = n[0] * p[0] + n[1] * p[1] + n[2] * p[2] + d
    return torch.where(val.abs() < eps, torch.zeros_like(val), val)


def _moller_intervals(vp0, vp1, vp2, dv0, dv1, dv2, dv0dv1, dv0dv2):
    """(A, B, C, X0, X1, coplanar) of one triangle's interval: the five-way
    case chain as selects (reference _moller_intervals)."""
    case1 = dv0dv1 > 0                      # dv2 is alone
    case2 = dv0dv2 > 0                      # dv1 is alone
    case3 = (dv1 * dv2 > 0) | (dv0 != 0)    # dv0 is alone
    case4 = dv1 != 0
    case5 = dv2 != 0
    sel_d1 = (~case1 & case2) | (~case1 & ~case2 & ~case3 & case4)
    sel_d2 = case1 | (~case1 & ~case2 & ~case3 & ~case4 & case5)
    coplanar = ~case1 & ~case2 & ~case3 & ~case4 & ~case5

    def pick(f2, f1, f0):
        return torch.where(sel_d2, f2, torch.where(sel_d1, f1, f0))

    return (pick(vp2, vp1, vp0),
            pick((vp0 - vp2) * dv2, (vp0 - vp1) * dv1, (vp1 - vp0) * dv0),
            pick((vp1 - vp2) * dv2, (vp2 - vp1) * dv1, (vp2 - vp0) * dv0),
            pick(dv2 - dv0, dv1 - dv0, dv0 - dv1),
            pick(dv2 - dv1, dv1 - dv2, dv0 - dv2),
            coplanar)


def moller_sides(q0, q1, q2, n1, d1, m0, m1, m2, n2, d2, eps=_EPS):
    """The plane sides of Moller's test: ((dv0, dv1, dv2, dv0dv1, dv0dv2),
    (du0, du1, du2, du0du1, du0du2), reject), the query's corners against
    the mesh face's plane and the other way round; ``reject`` where either
    triangle lies strictly on one side of the other's plane, a pair the
    test cannot count."""
    dv0 = _plane_dist(n2, d2, q0, eps)
    dv1 = _plane_dist(n2, d2, q1, eps)
    dv2 = _plane_dist(n2, d2, q2, eps)
    dv0dv1 = dv0 * dv1
    dv0dv2 = dv0 * dv2
    reject_q = (dv0dv1 > 0) & (dv0dv2 > 0)  # query strictly on one side

    du0 = _plane_dist(n1, d1, m0, eps)
    du1 = _plane_dist(n1, d1, m1, eps)
    du2 = _plane_dist(n1, d1, m2, eps)
    du0du1 = du0 * du1
    du0du2 = du0 * du2
    reject_m = (du0du1 > 0) & (du0du2 > 0)
    return ((dv0, dv1, dv2, dv0dv1, dv0dv2), (du0, du1, du2, du0du1, du0du2),
            reject_q | reject_m)


def moller_intervals(q0, q1, q2, n1, m0, m1, m2, n2, sides):
    """The interval part of Moller's test (MollerTile::intervals): whether
    the two triangles' intervals on their planes' intersection line
    overlap, neither being coplanar, given the plane sides ``sides`` of
    ``moller_sides`` (its first two entries)."""
    (dv0, dv1, dv2, dv0dv1, dv0dv2), (du0, du1, du2, du0du1, du0du2) = sides
    # the intersection line's direction and its dominant axis
    dx = n1[1] * n2[2] - n1[2] * n2[1]
    dy = n1[2] * n2[0] - n1[0] * n2[2]
    dz = n1[0] * n2[1] - n1[1] * n2[0]
    ax, ay, az = dx.abs(), dy.abs(), dz.abs()
    use_y = ay > ax
    use_z = az > torch.maximum(ax, ay)

    def proj(p):
        return torch.where(use_z, p[2], torch.where(use_y, p[1], p[0]))

    a1_, b1_, c1_, x0, x1, cop1 = _moller_intervals(
        proj(q0), proj(q1), proj(q2), dv0, dv1, dv2, dv0dv1, dv0dv2)
    a2_, b2_, c2_, y0, y1, cop2 = _moller_intervals(
        proj(m0), proj(m1), proj(m2), du0, du1, du2, du0du1, du0du2)

    xx = x0 * x1
    yy = y0 * y1
    xxyy = xx * yy
    t1 = a1_ * xxyy
    i1a = t1 + b1_ * x1 * yy
    i1b = t1 + c1_ * x0 * yy
    t2 = a2_ * xxyy
    i2a = t2 + b2_ * xx * y1
    i2b = t2 + c2_ * xx * y0
    lo1 = torch.minimum(i1a, i1b)
    hi1 = torch.maximum(i1a, i1b)
    lo2 = torch.minimum(i2a, i2b)
    hi2 = torch.maximum(i2a, i2b)
    overlap = ~((hi1 < lo2) | (hi2 < lo1))
    return overlap & ~cop1 & ~cop2


def moller_hit(q0, q1, q2, n1, d1, m0, m1, m2, n2, d2, eps=_EPS):
    """Moller's interval test on broadcastable (x, y, z) corner triples,
    unit normals and plane offsets of the query (q*, n1, d1) and mesh (m*,
    n2, d2) triangles (reference _moller_hit): the interval part where
    neither plane side rejects."""
    sides = moller_sides(q0, q1, q2, n1, d1, m0, m1, m2, n2, d2, eps)
    return (moller_intervals(q0, q1, q2, n1, m0, m1, m2, n2, sides[:2])
            & ~sides[2])


def moller_hit_tile(q, m, t_lo=None, t_hi=None):
    """``moller_hit`` on the 13-row operands (t bounds unused)."""
    return moller_hit(q[0:3], q[3:6], q[6:9], q[9:12], q[12],
                      m[0:3], m[3:6], m[6:9], m[9:12], m[12])


_TILES = {"segment": segment_hit_tile, "moller": moller_hit_tile}


# ---------------------------------------------------------------------------
# Prologues: the kernels' operands, [K, N] contiguous float32 planes.

def segment_planes(q_tri, tri):
    """The segment tile's operands: (query corners a, b, c [9, Q], face
    (a, e1, e2) [9, F]) of ``q_tri`` [Q, 3, 3] and ``tri`` [F, 3, 3]."""
    q = q_tri.to(torch.float32).reshape(-1, 9).t().contiguous()
    return q, ray_planes(tri.reshape(-1, 3, 3))


def moller_prescale(*tris, with_scale=False):
    """Jointly center and scale triangle arrays into the unit box, one
    (center, scale) for all of them (reference moller_prescale): the
    interval terms multiply tolerances through, and the unit box keeps
    them finite at any input extent.  ``with_scale`` also returns the
    scale s (scaled = (t - center) * s)."""
    flats = [t.reshape(-1, 3) for t in tris if t.numel()]
    if not flats:
        return (tris, 1.0) if with_scale else tris
    lo = flats[0].amin(dim=0)
    hi = flats[0].amax(dim=0)
    for c in flats[1:]:
        lo = torch.minimum(lo, c.amin(dim=0))
        hi = torch.maximum(hi, c.amax(dim=0))
    center = (lo + hi) * 0.5
    m = (hi - lo).max() * 0.5
    s = torch.where(m > 0, 1.0 / torch.maximum(m, torch.full_like(m, 1e-30)),
                    torch.ones_like(m))
    scaled = tuple((t - center) * s for t in tris)
    return (scaled, s) if with_scale else scaled


def _degenerate_cut(dtype):
    """1e2 eps(dtype)^2, rounded in ``dtype`` as the reference's
    ``1e2 * jnp.finfo(dtype).eps ** 2`` is."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    eps = np.finfo(np_dtype).eps
    return float(np.asarray(1e2, np_dtype) * eps * eps)


def tri_planes(tri):
    """Per-triangle Moller quantities of ``tri`` [..., 3, 3]: (a, b, c, unit
    normal n, offset d = -n.a) (reference _tri_planes).  A triangle whose
    n2 is below the relative cut 1e2 eps^2 |e1|^2 |e2|^2 keeps n = 0: every
    plane distance to it is 0, the coplanar reject."""
    a = tri[..., 0, :]
    e1 = tri[..., 1, :] - a
    e2 = tri[..., 2, :] - a
    n = cross3(e1, e2)
    n2 = _sum3(n * n)[..., None]
    e12 = _sum3(e1 * e1)[..., None]
    e22 = _sum3(e2 * e2)[..., None]
    degenerate = n2 <= _degenerate_cut(tri.dtype) * e12 * e22
    n = n * torch.where(degenerate, torch.zeros_like(n2),
                        torch.rsqrt(torch.where(degenerate,
                                                torch.ones_like(n2), n2)))
    d = -_sum3(n * a)
    return a, tri[..., 1, :], tri[..., 2, :], n, d


def moller_planes(*tris):
    """The Moller tile's operand [13, N] of each of ``tris`` ([N, 3, 3]),
    all prescaled together: corners, unit normal, offset."""
    out = []
    for t in moller_prescale(*(t.to(torch.float32) for t in tris)):
        a, b, c, n, d = tri_planes(t)
        out.append(torch.cat([a, b, c, n, d[..., None]], dim=-1)
                   .reshape(-1, 13).t().contiguous())
    return tuple(out)


def tri_tri_planes(q_tri, tri, algorithm):
    """(query operand, face operand) of ``algorithm`` for query triangles
    ``q_tri`` [Q, 3, 3] against ``tri`` [F, 3, 3]."""
    _check_algorithm(algorithm)
    if algorithm == "moller":
        return moller_planes(q_tri, tri)
    return segment_planes(q_tri, tri)


def self_planes(tri, algorithm):
    """(query operand, face operand) of ``algorithm`` for a mesh's own
    triangles ``tri`` [F, 3, 3] against themselves; the Moller tile is
    prescaled over this one mesh."""
    _check_algorithm(algorithm)
    if algorithm == "moller":
        (planes,) = moller_planes(tri)
        return planes, planes
    return segment_planes(tri, tri)


# ---------------------------------------------------------------------------
# Plain versions and wrappers.

def _chunks(n_q, n_f, device):
    """(q0, q1) blocks of queries of at most _PLAIN_PAIRS pairs each."""
    rows = max(1, _PLAIN_PAIRS[device.type] // max(1, n_f))
    for q0 in range(0, n_q, rows):
        yield q0, min(n_q, q0 + rows)


def _cols(planes, q0, q1):
    return tuple(planes[k, q0:q1, None] for k in range(planes.shape[0]))


def _rows(planes):
    return tuple(planes[k, None, :] for k in range(planes.shape[0]))


def _check_planes(qplanes, fplanes, algorithm, name):
    _check_algorithm(algorithm)
    k = N_ROWS[algorithm]
    for t in (qplanes, fplanes):
        if (t.dtype != torch.float32 or not t.is_contiguous() or t.ndim != 2
                or t.shape[0] != k or t.device != qplanes.device):
            raise ValueError("%s[%s] wants contiguous float32 planes [%d, N] "
                             "on one device, got %s %r on %s"
                             % (name, algorithm, k, t.dtype, tuple(t.shape),
                                t.device))
    if qplanes.device.type not in ("cpu", "cuda"):
        raise ValueError("%s: no kernel for device %s"
                         % (name, qplanes.device))


def tri_tri_any_hit_plain(qplanes, fplanes, algorithm):
    """The every-pair plain version of the ``tri_tri_any_hit`` kernels: (hit
    [Q] bool, tested [Q] int32: the first hit's index plus one, else F).
    ``qplanes`` [K, Q] and ``fplanes`` [K, F] are ``algorithm``'s
    operands."""
    tile = _TILES[algorithm]
    n_q, n_f = qplanes.shape[-1], fplanes.shape[-1]
    dev = qplanes.device
    hit = torch.zeros(n_q, dtype=torch.bool, device=dev)
    tested = torch.full((n_q,), n_f, dtype=torch.int32, device=dev)
    if n_q == 0 or n_f == 0:
        return hit, tested
    rows = _rows(fplanes)
    for q0, q1 in _chunks(n_q, n_f, dev):
        h = tile(_cols(qplanes, q0, q1), rows)
        any_hit = h.any(dim=-1)
        hit[q0:q1] = any_hit
        first = torch.argmax(h.to(torch.uint8), dim=-1).to(torch.int32)
        tested[q0:q1] = torch.where(any_hit, first + 1, tested[q0:q1])
    return hit, tested


def tri_tri_any_hit_every(qplanes, fplanes, algorithm):
    """Whether each query triangle meets any face, and the pairs a scan in
    face order tests for it, over every pair: the ``tri_tri_any_hit_every``
    CUDA kernel (the cull's oracle; no path launches it) for CUDA tensors,
    ``tri_tri_any_hit_plain`` for CPU tensors."""
    _check_planes(qplanes, fplanes, algorithm, "tri_tri_any_hit_every")
    n_q, n_f = qplanes.shape[-1], fplanes.shape[-1]
    if qplanes.device.type == "cpu" or n_q == 0 or n_f == 0:
        return tri_tri_any_hit_plain(qplanes, fplanes, algorithm)
    from .. import _build

    first = torch.full((n_q,), n_f, dtype=torch.int32, device=qplanes.device)
    _build.launch("tri_tri_any_hit_every", qplanes.device, qplanes, fplanes,
                  first, n_q, n_f, ALGORITHMS.index(algorithm), T_LO, T_HI)
    LAUNCHES["tri_tri_any_hit_every"] += 1
    TILE_LAUNCHES["tri_tri_any_hit_every[%s]" % algorithm] += 1
    hit = first < n_f
    return hit, first + hit


# ---------------------------------------------------------------------------
# The tri_tri_any_hit cull (Moller tile): its operands, its plain version.

def tri_query_box(qplanes):
    """(lo [3], hi [3]): the least and the largest coordinate, per axis, of
    every query corner (rows 0-8 of the Moller query operand [13, Q],
    Q > 0); ``amin`` / ``amax`` keep NaN, so a NaN corner makes the box
    NaN, which no face clears."""
    corners = qplanes[0:9].view(3, 3, -1)      # corner, axis, query
    return corners.amin(dim=(0, 2)), corners.amax(dim=(0, 2))


def _box_magnitude(lo, hi):
    """The largest magnitude of boxes [..., 3] (NaN kept)."""
    return torch.maximum(lo.abs(), hi.abs()).amax(dim=-1)


def _mask_words(cand):
    """[C] int32 of a [32 C] bool: bit j of word k is candidate 32 k + j."""
    bits = cand.view(-1, TRI_CHUNK).to(torch.int64) << torch.arange(
        TRI_CHUNK, device=cand.device)
    word = bits.sum(dim=1)
    return torch.where(word >= 2 ** 31, word - 2 ** 32, word).to(torch.int32)


def _mask_bits(chunks):
    """[32 C] bool: the candidate flags held in chunk records [C, 8]."""
    words = chunks.view(torch.int32)[:, 7].to(torch.int64)
    shift = torch.arange(TRI_CHUNK, device=chunks.device)
    return ((words[:, None] >> shift) & 1).bool().reshape(-1)


def tri_records_plain(qlo, qhi, fplanes):
    """Plain PyTorch version of the ``tri_records`` kernel: (faces [32 C,
    16], chunks [C, 8]) float32, C = ceil(F / 32), of the Moller face
    operand ``fplanes`` [13, F] against the query box [qlo, qhi]
    (``tri_query_box``).

    A face is a candidate unless its own plane (rows 9-12) clears the
    query box by the margin (``moller_tile_needs`` on the box with its
    largest magnitude P): then every query corner lies strictly on one side
    of it, and the Moller tile rejects every pair it makes.  ``faces``: per
    face its 13 rows, zero-padded, the last face repeated to a whole chunk.
    ``chunks``: per chunk of 32 faces the least and the largest
    coordinates of its candidates' corners and their largest magnitude
    (+inf, -inf and +inf when it has none; NaN where a candidate has a NaN
    corner), then the bits of the candidate mask (bit j: face 32 k + j;
    padding faces are never candidates)."""
    n_f = fplanes.shape[1]
    qbox = torch.cat([qlo, qhi, _box_magnitude(qlo, qhi)[None],
                      qlo.new_zeros(1)])[None]
    cand = moller_tile_needs(fplanes, qbox, 0, n_f)[:, 0]
    cand = torch.cat([cand, cand.new_zeros((-n_f) % TRI_CHUNK)])
    rows = _pad_rows_edge(fplanes.t(), TRI_CHUNK)           # [32 C, 13]
    corners = rows[:, 0:9].reshape(-1, TRI_CHUNK * 3, 3)
    keep = cand.view(-1, TRI_CHUNK).repeat_interleave(3, dim=1)[..., None]
    inf = torch.tensor(float("inf"), device=fplanes.device)
    lo = torch.where(keep, corners, inf).amin(dim=1)
    hi = torch.where(keep, corners, -inf).amax(dim=1)
    box = torch.cat([lo, hi, _box_magnitude(lo, hi)[:, None]], dim=1)
    chunks = torch.cat([box.view(torch.int32), _mask_words(cand)[:, None]],
                       dim=1).view(torch.float32)
    faces = torch.zeros((rows.shape[0], TRI_FACE_WORDS), dtype=torch.float32,
                        device=fplanes.device)
    faces[:, :13] = rows
    return faces, chunks


def tri_records(qlo, qhi, fplanes):
    """The cull's face and chunk records (``tri_records_plain``): the
    ``tri_records`` CUDA kernel for CUDA tensors, its plain version for
    CPU tensors."""
    _check_planes(fplanes, fplanes, "moller", "tri_records")
    n_f = fplanes.shape[1]
    for t in (qlo, qhi):
        if (t.dtype != torch.float32 or tuple(t.shape) != (3,)
                or not t.is_contiguous() or t.device != fplanes.device):
            raise ValueError("tri_records wants the query box as contiguous "
                             "float32 [3] on %s, got %s %r on %s"
                             % (fplanes.device, t.dtype, tuple(t.shape),
                                t.device))
    if fplanes.device.type == "cpu" or n_f == 0:
        return tri_records_plain(qlo, qhi, fplanes)
    from .. import _build

    n_c = -(-n_f // TRI_CHUNK)
    faces = torch.empty((n_c * TRI_CHUNK, TRI_FACE_WORDS),
                        dtype=torch.float32, device=fplanes.device)
    chunks = torch.empty((n_c, TRI_CHUNK_WORDS), dtype=torch.float32,
                         device=fplanes.device)
    _build.launch("tri_records", fplanes.device, qlo, qhi, fplanes, faces,
                  chunks, n_f, n_c)
    LAUNCHES["tri_records"] += 1
    return faces, chunks


def tri_any_hit_operands(qplanes, fplanes):
    """The cull's operands for the Moller query operand ``qplanes`` [13, Q]
    against the face operand ``fplanes`` [13, F] (Q, F > 0): a dict of
    ``qlo`` / ``qhi`` (``tri_query_box``), ``faces`` / ``chunks``
    (``tri_records``) and ``n_faces`` F; three launches on the card.  The
    queries stay in their own order: a mesh's index order keeps the
    neighbours on one side of its surface together, where a Morton order
    would mix the two sides of a thin part."""
    _check_planes(qplanes, fplanes, "moller", "tri_any_hit_operands")
    if not (qplanes.shape[1] and fplanes.shape[1]):
        raise ValueError("tri_any_hit_operands: no query or no face")
    qlo, qhi = tri_query_box(qplanes)
    faces, chunks = tri_records(qlo, qhi, fplanes)
    return {"qlo": qlo, "qhi": qhi, "faces": faces, "chunks": chunks,
            "n_faces": fplanes.shape[1]}


def _check_tri_split(split):
    split = TRI_SPLIT if split is None else split
    if not 1 <= int(split) <= TRI_MAX_SPLIT:
        raise ValueError("tri_tri_any_hit: split %r not in [1, %d]"
                         % (split, TRI_MAX_SPLIT))
    return int(split)


def _check_tri_ops(qplanes, fplanes, ops):
    n_f = fplanes.shape[1]
    n_c = -(-n_f // TRI_CHUNK)
    if ops.get("n_faces") != n_f:
        raise ValueError("tri_tri_any_hit: operands of %r faces for %d"
                         % (ops.get("n_faces"), n_f))
    for key, shape in (("faces", (n_c * TRI_CHUNK, TRI_FACE_WORDS)),
                       ("chunks", (n_c, TRI_CHUNK_WORDS))):
        t = ops[key]
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != qplanes.device
                or (t.device.type == "cuda" and t.data_ptr() % 16)):
            raise ValueError("tri_tri_any_hit: want %s %s float32, "
                             "contiguous and 16-byte aligned, on %s; got %s "
                             "%s on %s" % (key, shape, qplanes.device,
                                tuple(t.shape), t.dtype, t.device))


def tri_tri_any_hit_culled_plain(qplanes, ops, split=None):
    """Plain PyTorch version of the ``tri_tri_any_hit`` kernel's cull (the
    Moller tile): (hit [Q] bool, tested [Q] int32: the first hit's index
    plus one, else F, as ``tri_tri_any_hit_plain`` gives them; warp [ceil(Q
    / 32), 2] int32: per warp of 32 queries the chunks it took and their
    candidate slots; lane [Q, 2] int32: per query the pairs its lane ran
    through the plane sides and those that reached the interval part), the
    counts summed over the splits, on ``tri_any_hit_operands``' ``ops``.

    Lane q takes query q, 32 lanes to a warp.  The chunks
    are cut into ``split`` ranges [C s / split, C (s + 1) / split), each
    walked from no hit.  In a range, a lane needs a chunk with a candidate
    unless its plane clears the chunk's box (``moller_tile_needs``) or it
    has hit in an earlier chunk of the range; a warp takes a chunk when one
    of its lanes needs it, and each lane that needs it runs its candidates
    in increasing index through the plane sides, and through the interval
    part where neither side rejects, up to its first hit.  A query's first
    hit is the least over the ranges."""
    split = _check_tri_split(split)
    faces, chunks = ops["faces"], ops["chunks"]
    n_f, n_c = ops["n_faces"], chunks.shape[0]
    n_q = qplanes.shape[1]
    dev = qplanes.device
    q_pad = -(-n_q // WARP) * WARP
    first = torch.full((q_pad,), n_f, dtype=torch.int64, device=dev)
    warp = torch.zeros((q_pad // WARP, 2), dtype=torch.int32, device=dev)
    lane = torch.zeros((q_pad, 2), dtype=torch.int32, device=dev)
    bits = _mask_bits(chunks)
    cf = bits.nonzero()[:, 0]                    # candidate faces, in order
    ck = cf // TRI_CHUNK
    slots = bits.view(n_c, TRI_CHUNK).sum(dim=1, dtype=torch.int32)
    nonempty = slots > 0
    ranges = [n_c * s // split for s in range(split + 1)]
    rows = tuple(faces[cf, r][None] for r in range(13))
    step = max(WARP, _PLAIN_PAIRS[dev.type] // max(1, cf.numel())
               // WARP * WARP)
    for a in range(0, q_pad, step):
        b = min(q_pad, a + step)
        live = min(b, n_q) - a
        need = torch.zeros((b - a, n_c), dtype=torch.bool, device=dev)
        need[:live] = moller_tile_needs(qplanes, chunks, a,
                                        a + live) & nonempty
        hit = torch.zeros((b - a, cf.numel()), dtype=torch.bool, device=dev)
        reject = torch.ones_like(hit)
        if cf.numel():
            q = _cols(qplanes, a, a + live)
            hit[:live] = moller_hit_tile(q, rows)
            reject[:live] = moller_sides(q[0:3], q[3:6], q[6:9], q[9:12],
                                         q[12], rows[0:3], rows[3:6],
                                         rows[6:9], rows[9:12], rows[12])[2]
        need_f = need[:, ck]
        for s in range(split):
            k0, k1 = ranges[s], ranges[s + 1]
            if k0 == k1:
                continue                    # a range without a chunk
            run = need_f & ((ck >= k0) & (ck < k1))[None]
            first_s = torch.where(run & hit, cf[None], n_f).amin(
                dim=1) if cf.numel() else first[a:b].new_full((b - a,), n_f)
            tested = run & (cf[None] <= first_s[:, None])
            lane[a:b, 0] += tested.sum(dim=1, dtype=torch.int32)
            lane[a:b, 1] += (tested & ~reject).sum(dim=1, dtype=torch.int32)
            # a lane that hit in an earlier chunk of the range needs no more
            starts = TRI_CHUNK * torch.arange(k0, k1, device=dev)
            cur = need[:, k0:k1] & ~(first_s[:, None] < starts)
            taken = _warp_any(cur, 0)
            warp[a // WARP:b // WARP, 0] += taken.sum(dim=1, dtype=torch.int32)
            warp[a // WARP:b // WARP, 1] += (taken * slots[k0:k1]).sum(
                dim=1, dtype=torch.int32)
            first[a:b] = torch.minimum(first[a:b], first_s)
    at = first[:n_q]
    hit = at < n_f
    tested = torch.where(hit, at + 1, at).to(torch.int32)
    return hit, tested, warp, lane[:n_q]


def tri_tri_any_hit(qplanes, fplanes, algorithm, ops=None, split=None,
                    with_stats=False):
    """Whether each query triangle meets any face, and the pairs a scan in
    face order tests for it: (hit [Q] bool, tested [Q] int32).  For CUDA
    tensors the ``tri_tri_any_hit`` kernel: in the Moller tile its cull on
    ``ops`` (``tri_any_hit_operands``, made here when None) with ``split``
    warps to a warp's chunks (``TRI_SPLIT`` when None), in the segment
    tile every pair.  For CPU tensors ``tri_tri_any_hit_plain``.
    ``with_stats`` (Moller only) adds the cull's warp and lane counts, as
    ``tri_tri_any_hit_culled_plain`` returns them (which a CPU call runs
    then).  No query or no face: all False, no launch.  A failed build or
    launch raises: no other version stands in."""
    _check_planes(qplanes, fplanes, algorithm, "tri_tri_any_hit")
    split = _check_tri_split(split)
    if with_stats and algorithm != "moller":
        raise ValueError("tri_tri_any_hit: the segment tile has no cull "
                         "and no statistics")
    n_q, n_f = qplanes.shape[-1], fplanes.shape[-1]
    dev = qplanes.device
    if dev.type == "cpu" and not with_stats:
        return tri_tri_any_hit_plain(qplanes, fplanes, algorithm)
    stats = ((torch.zeros((-(-n_q // WARP), 2), dtype=torch.int32,
                          device=dev),
              torch.zeros((n_q, 2), dtype=torch.int32, device=dev))
             if with_stats else ())
    if n_q == 0 or n_f == 0:
        return (torch.zeros(n_q, dtype=torch.bool, device=dev),
                torch.full((n_q,), n_f, dtype=torch.int32, device=dev),
                *stats)
    if algorithm == "moller":
        if ops is None:
            ops = tri_any_hit_operands(qplanes, fplanes)
        _check_tri_ops(qplanes, fplanes, ops)
        if dev.type == "cpu":
            return tri_tri_any_hit_culled_plain(qplanes, ops, split)
    from .. import _build

    # the kernel folds each query's first hit into ``first`` (F: none)
    first = torch.full((n_q,), n_f, dtype=torch.int32, device=dev)
    if algorithm == "moller":
        _build.launch("tri_tri_any_hit", dev, qplanes, ops["faces"],
                      ops["chunks"], first,
                      *(stats or (None, None)), n_q, n_f,
                      ops["chunks"].shape[0], split, 1, T_LO, T_HI)
    else:
        _build.launch("tri_tri_any_hit", dev, qplanes, fplanes, None, first,
                      None, None, n_q, n_f, 0, 1, 0, T_LO, T_HI)
    LAUNCHES["tri_tri_any_hit"] += 1
    TILE_LAUNCHES["tri_tri_any_hit[%s]" % algorithm] += 1
    hit = first < n_f
    return (hit, first + hit, *stats)


def _query_range(n_f, q0, q1):
    q1 = n_f if q1 is None else q1
    if not 0 <= q0 <= q1 <= n_f:
        raise ValueError("query range [%d, %d) outside the %d faces"
                         % (q0, q1, n_f))
    return q1


def _check_ids(ids, fplanes):
    if (ids.dtype != torch.int32 or not ids.is_contiguous()
            or tuple(ids.shape) != (fplanes.shape[-1], 3)
            or ids.device != fplanes.device):
        raise ValueError("self_intersect wants contiguous int32 vertex ids "
                         "[%d, 3] on %s, got %s %r on %s"
                         % (fplanes.shape[-1], fplanes.device, ids.dtype,
                            tuple(ids.shape), ids.device))


def _excluded(ids, q0, q1, dev):
    """[q1 - q0, F] bool: the pairs the count leaves out, the query face
    itself and the faces sharing a vertex index with it."""
    qi = ids[q0:q1]
    mi = ids.t()
    shares = None
    for r in range(3):
        for c in range(3):
            eq = qi[:, r:r + 1] == mi[c:c + 1, :]
            shares = eq if shares is None else shares | eq
    row_id = torch.arange(q0, q1, device=dev)[:, None]
    return shares | (row_id == torch.arange(ids.shape[0], device=dev)[None])


def self_intersect_counts_plain(qplanes, fplanes, ids, algorithm, q0=0,
                                q1=None):
    """The every-pair count: for the query faces q0 .. q1 - 1 (all by
    default), the number of faces j != i sharing no vertex index with face
    i that it meets, [q1 - q0] int32, testing every pair (the reference's
    design).  ``qplanes`` and ``fplanes`` [K, F] are ``algorithm``'s
    operands over the mesh's own faces, ``ids`` [F, 3] int32 its faces."""
    tile = _TILES[algorithm]
    n_f = fplanes.shape[-1]
    q1 = _query_range(n_f, q0, q1)
    dev = qplanes.device
    out = torch.zeros(q1 - q0, dtype=torch.int32, device=dev)
    rows = _rows(fplanes)
    for a, b in _chunks(q1 - q0, n_f, dev):
        hit = tile(_cols(qplanes, q0 + a, q0 + b), rows)
        counted = hit & ~_excluded(ids, q0 + a, q0 + b, dev)
        out[a:b] = counted.sum(dim=-1, dtype=torch.int32)
    return out


def moller_tile_boxes(fplanes):
    """The Moller cull's tile boxes [ceil(F / SELF_TILE), 8] float32 of the
    face operand [13, F]: per tile of SELF_TILE faces (the last one padded
    with its last face) the least and the largest corner coordinates, the
    largest corner magnitude P and a pad.  ``amin`` / ``amax`` propagate
    NaN, so a tile holding a NaN corner gets a NaN box, which no query
    skips."""
    corners = _pad_rows_edge(fplanes[0:9].t().reshape(-1, 3, 3), SELF_TILE)
    tiles = corners.reshape(-1, SELF_TILE * 3, 3)
    lo, hi = tiles.amin(dim=1), tiles.amax(dim=1)
    p = torch.maximum(lo.abs(), hi.abs()).amax(dim=1, keepdim=True)
    return torch.cat([lo, hi, p, torch.zeros_like(p)], dim=1).contiguous()


def moller_tile_needs(qplanes, boxes, q0, q1):
    """[q1 - q0, T] bool: whether each query face's plane (n, d) passes
    within the margin of each tile box, the negation of the cull's skip
    (csrc/self_intersect.cu plane_needs_box, the same float32 operations).
    A tile is skipped where its box's corner nearest the plane's positive
    side is above M, or its farthest corner below -M, with
    M = MARGIN_FLOOR + MARGIN_REL * (|n|_1 P + |d|)."""
    n = [qplanes[9 + a, q0:q1, None] for a in range(3)]
    d = qplanes[12, q0:q1, None]
    lo = [boxes[None, :, a] for a in range(3)]
    hi = [boxes[None, :, 3 + a] for a in range(3)]
    pos = [x >= 0 for x in n]
    near = [torch.where(pos[a], lo[a], hi[a]) for a in range(3)]
    far = [torch.where(pos[a], hi[a], lo[a]) for a in range(3)]
    s_min = n[0] * near[0] + n[1] * near[1] + n[2] * near[2] + d
    s_max = n[0] * far[0] + n[1] * far[1] + n[2] * far[2] + d
    x = (n[0].abs() + n[1].abs() + n[2].abs()) * boxes[None, :, 6] + d.abs()
    margin = MARGIN_FLOOR + MARGIN_REL * x
    skip = (x < MARGIN_CAP) & ((s_min > margin) | (s_max < -margin))
    return ~skip


def self_intersect_culled_plain(qplanes, fplanes, ids, algorithm, q0=0,
                                q1=None):
    """Plain PyTorch version of the ``self_intersect`` kernel's design:
    (counts [Q] int32, tiles [ceil(Q / WARP)] int32, work [Q, 3] int32)
    for the query faces q0 .. q1 - 1 (Q of them, all by default).

    A query face counts the pairs of the tiles its own cull keeps (the
    Moller tile: ``moller_tile_needs``; the segment tile: every tile);
    ``tiles`` is the face tiles each warp of WARP query faces (from q0)
    tested, those some lane of it kept; ``work`` per query face the pairs
    of the tiles it kept (each through the vertex-id test), those of them
    not left out (each through the Moller plane sides or the whole segment
    test), and those that reached the Moller interval part, on neither
    side of the other's plane (the segment tile: 0).  The counts equal
    ``self_intersect_counts_plain``'s, since a skipped pair is one the
    test rejects."""
    tile = _TILES[algorithm]
    n_f = fplanes.shape[-1]
    q1 = _query_range(n_f, q0, q1)
    dev = qplanes.device
    n_q, n_t = q1 - q0, -(-n_f // SELF_TILE)
    counts = torch.zeros(n_q, dtype=torch.int32, device=dev)
    work = torch.zeros((n_q, 3), dtype=torch.int32, device=dev)
    tiles = torch.zeros(-(-n_q // WARP), dtype=torch.int32, device=dev)
    rows = _rows(fplanes)
    moller = algorithm == "moller"
    boxes = moller_tile_boxes(fplanes) if moller else None
    tile_faces = torch.clamp(
        n_f - SELF_TILE * torch.arange(n_t, device=dev), max=SELF_TILE)
    step = max(WARP, _PLAIN_PAIRS[dev.type] // max(1, n_f) // WARP * WARP)
    for a in range(0, n_q, step):
        b = min(n_q, a + step)
        if moller:
            need = moller_tile_needs(qplanes, boxes, q0 + a, q0 + b)
        else:
            need = torch.ones((b - a, n_t), dtype=torch.bool, device=dev)
        tiles[a // WARP:-(-b // WARP)] = _warp_any(need, 0).sum(
            dim=-1, dtype=torch.int32)
        kept = (need.repeat_interleave(SELF_TILE, dim=1)[:, :n_f]
                & ~_excluded(ids, q0 + a, q0 + b, dev))
        q = _cols(qplanes, q0 + a, q0 + b)
        hit = tile(q, rows)
        counts[a:b] = (hit & kept).sum(dim=-1, dtype=torch.int32)
        work[a:b, 0] = (need * tile_faces).sum(dim=-1, dtype=torch.int32)
        work[a:b, 1] = kept.sum(dim=-1, dtype=torch.int32)
        if moller:
            work[a:b, 2] = (kept & ~moller_sides(
                q[0:3], q[3:6], q[6:9], q[9:12], q[12], rows[0:3],
                rows[3:6], rows[6:9], rows[9:12], rows[12])[2]).sum(
                    dim=-1, dtype=torch.int32)
    return counts, tiles, work


def self_face_records(fplanes, ids):
    """The kernel's face operand [F, W] float32: each face's rows of
    ``fplanes`` [K, F] then the bits of its three vertex ids, zero-padded
    to W = a multiple of 4 words (built as int32, so the ids' bits are
    copied, never rounded)."""
    k, n_f = fplanes.shape
    rec = torch.zeros((n_f, (k + 3 + 3) // 4 * 4), dtype=torch.int32,
                      device=fplanes.device)
    rec[:, :k] = fplanes.t().view(torch.int32)
    rec[:, k:k + 3] = ids
    return rec.view(torch.float32)


def self_kernel_operands(fplanes, ids, algorithm):
    """The kernel's face records (``self_face_records``) and its tile
    boxes (``moller_tile_boxes``; the segment tile: None)."""
    return (self_face_records(fplanes, ids),
            moller_tile_boxes(fplanes) if algorithm == "moller" else None)


def self_intersect_counts(qplanes, fplanes, ids, algorithm, q0=0, q1=None,
                          with_stats=False):
    """Per-face counts of intersecting faces that share no vertex, for the
    query faces q0 .. q1 - 1: the ``self_intersect`` CUDA kernel for CUDA
    tensors, its plain version (``self_intersect_culled_plain``) for CPU
    tensors.  The operands may come in any face order.  ``with_stats``
    returns (counts, tiles per warp, work per query face) as
    ``self_intersect_culled_plain`` does."""
    _check_planes(qplanes, fplanes, algorithm, "self_intersect")
    if qplanes.shape[-1] != fplanes.shape[-1]:
        raise ValueError("self_intersect: query and face operands cover "
                         "%d and %d faces" % (qplanes.shape[-1],
                                              fplanes.shape[-1]))
    _check_ids(ids, fplanes)
    n_f = fplanes.shape[-1]
    q1 = _query_range(n_f, q0, q1)
    dev = qplanes.device
    if dev.type == "cpu":
        out = self_intersect_culled_plain(qplanes, fplanes, ids, algorithm,
                                          q0, q1)
        return out if with_stats else out[0]
    n_q = q1 - q0
    counts = torch.zeros(n_q, dtype=torch.int32, device=dev)
    stats = ((torch.zeros(-(-n_q // WARP), dtype=torch.int32, device=dev),
              torch.zeros((n_q, 3), dtype=torch.int32, device=dev))
             if with_stats else (None, None))
    if n_q:
        from .. import _build

        _build.launch("self_intersect", dev, qplanes,
                      *self_kernel_operands(fplanes, ids, algorithm), counts,
                      *stats, n_f, q0, n_q, ALGORITHMS.index(algorithm),
                      T_LO, T_HI)
        LAUNCHES["self_intersect"] += 1
        TILE_LAUNCHES["self_intersect[%s]" % algorithm] += 1
    return (counts,) + stats if with_stats else counts


# ---------------------------------------------------------------------------
# Whole queries: prologue and kernel.

def tri_tri_any_hit_kernel(q_tri, tri, algorithm="segment"):
    """Whether each query triangle of ``q_tri`` [Q, 3, 3] meets a triangle
    of ``tri`` [F, 3, 3]: (hit [Q] bool, tested [Q] int32).  The CUDA
    kernel on the card, its plain version on the CPU."""
    qp, fp = tri_tri_planes(q_tri.to(torch.float32), tri.to(torch.float32),
                            algorithm)
    return tri_tri_any_hit(qp, fp, algorithm)


def self_sorted_operands(tri, f, order, algorithm):
    """``algorithm``'s operands (query and face planes) and the vertex ids
    [F, 3] int32 of the triangles ``tri`` [F, 3, 3] of faces ``f``, in
    ``order``."""
    qp, fp = self_planes(tri[order], algorithm)
    return qp, fp, f.to(torch.int32)[order].contiguous()


def self_intersection_counts_kernel(v, f, algorithm="segment"):
    """Per face of the mesh (``v`` [V, 3], ``f`` [F, 3]), the number of
    faces sharing no vertex with it that it meets, [F] int32.  The faces go
    to the kernel in the Morton order of their centroids, and the counts
    come back in the mesh's order."""
    tri = v.to(torch.float32)[f.long()]
    if not tri.shape[0]:
        return torch.zeros(0, dtype=torch.int32, device=tri.device)
    order = morton_face_order(tri)
    sorted_counts = self_intersect_counts(
        *self_sorted_operands(tri, f, order, algorithm), algorithm)
    counts = torch.empty_like(sorted_counts)
    counts[order] = sorted_counts
    return counts
