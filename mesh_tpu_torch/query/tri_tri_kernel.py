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
  it: the first hit's index plus one, or every face.  The kernel splits
  the faces across blocks and keeps each query's first hit with an atomic
  minimum, so the index is the same whatever order the blocks run in.
- ``self_intersect_counts`` (``csrc/self_intersect.cu``): per face of a
  query range, the number of other faces sharing no vertex index with it
  that it meets; every pair is tested, the partial counts of the face
  ranges summed with integer atomics.

The wrappers take the kernel's path for CUDA tensors and the plain version
for CPU tensors; any other device raises.  ``LAUNCHES`` counts each
kernel's launches and ``TILE_LAUNCHES`` each kernel's launches per tile.
The prologues run in PyTorch on the operands' device, so a kernel and its
plain version read the same planes.
"""

import numpy as np
import torch

from ..geometry.cross_product import cross3
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
LAUNCHES = {"tri_tri_any_hit": 0, "self_intersect": 0}
#: the same launches, per tile
TILE_LAUNCHES = {"%s[%s]" % (k, a): 0 for k in LAUNCHES for a in ALGORITHMS}

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


def moller_hit(q0, q1, q2, n1, d1, m0, m1, m2, n2, d2, eps=_EPS):
    """Moller's interval test on broadcastable (x, y, z) corner triples,
    unit normals and plane offsets of the query (q*, n1, d1) and mesh (m*,
    n2, d2) triangles (reference _moller_hit)."""
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
    return overlap & ~reject_q & ~reject_m & ~cop1 & ~cop2


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
    """Plain PyTorch version of the ``tri_tri_any_hit`` kernel: (hit [Q]
    bool, tested [Q] int32: the first hit's index plus one, else F).  ``qplanes`` [K, Q] and
    ``fplanes`` [K, F] are ``algorithm``'s operands."""
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


def tri_tri_any_hit(qplanes, fplanes, algorithm):
    """Whether each query triangle meets any face, and the pairs a scan in
    face order tests for it: the ``tri_tri_any_hit`` CUDA kernel for CUDA
    tensors, its plain version for CPU tensors.  No query or no face: all
    False, no launch."""
    _check_planes(qplanes, fplanes, algorithm, "tri_tri_any_hit")
    n_q, n_f = qplanes.shape[-1], fplanes.shape[-1]
    if qplanes.device.type == "cpu":
        return tri_tri_any_hit_plain(qplanes, fplanes, algorithm)
    if n_q == 0 or n_f == 0:
        return (torch.zeros(n_q, dtype=torch.bool, device=qplanes.device),
                torch.full((n_q,), n_f, dtype=torch.int32,
                           device=qplanes.device))
    from .. import _build

    # the kernel folds each query's first hit into ``first`` (F: none)
    first = torch.full((n_q,), n_f, dtype=torch.int32, device=qplanes.device)
    _build.launch("tri_tri_any_hit", qplanes.device, qplanes, fplanes, first,
                  n_q, n_f, ALGORITHMS.index(algorithm), T_LO, T_HI)
    LAUNCHES["tri_tri_any_hit"] += 1
    TILE_LAUNCHES["tri_tri_any_hit[%s]" % algorithm] += 1
    hit = first < n_f
    return hit, first + hit.to(torch.int32)


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


def self_intersect_counts_plain(qplanes, fplanes, ids, algorithm, q0=0,
                                q1=None):
    """Plain PyTorch version of the ``self_intersect`` kernel: for the
    query faces q0 .. q1 - 1 (all by default), the number of faces j != i
    sharing no vertex index with face i that it meets, [q1 - q0] int32.
    ``qplanes`` and ``fplanes`` [K, F] are ``algorithm``'s operands over
    the mesh's own faces, ``ids`` [F, 3] int32 its faces."""
    tile = _TILES[algorithm]
    n_f = fplanes.shape[-1]
    q1 = _query_range(n_f, q0, q1)
    dev = qplanes.device
    out = torch.zeros(q1 - q0, dtype=torch.int32, device=dev)
    rows = _rows(fplanes)
    mi = ids.t()
    col_id = torch.arange(n_f, device=dev)[None, :]
    for a, b in _chunks(q1 - q0, n_f, dev):
        hit = tile(_cols(qplanes, q0 + a, q0 + b), rows)
        qi = ids[q0 + a:q0 + b]
        shares = None
        for r in range(3):
            for c in range(3):
                eq = qi[:, r:r + 1] == mi[c:c + 1, :]
                shares = eq if shares is None else shares | eq
        row_id = torch.arange(q0 + a, q0 + b, device=dev)[:, None]
        counted = hit & ~shares & (row_id != col_id)
        out[a:b] = counted.sum(dim=-1, dtype=torch.int32)
    return out


def self_intersect_counts(qplanes, fplanes, ids, algorithm, q0=0, q1=None):
    """Per-face counts of intersecting faces that share no vertex, for the
    query faces q0 .. q1 - 1: the ``self_intersect`` CUDA kernel for CUDA
    tensors, its plain version for CPU tensors."""
    _check_planes(qplanes, fplanes, algorithm, "self_intersect")
    if qplanes.shape[-1] != fplanes.shape[-1]:
        raise ValueError("self_intersect: query and face operands cover "
                         "%d and %d faces" % (qplanes.shape[-1],
                                              fplanes.shape[-1]))
    _check_ids(ids, fplanes)
    n_f = fplanes.shape[-1]
    q1 = _query_range(n_f, q0, q1)
    if qplanes.device.type == "cpu":
        return self_intersect_counts_plain(qplanes, fplanes, ids, algorithm,
                                           q0, q1)
    if q1 == q0:
        return torch.zeros(0, dtype=torch.int32, device=qplanes.device)
    from .. import _build

    counts = torch.zeros(q1 - q0, dtype=torch.int32, device=qplanes.device)
    _build.launch("self_intersect", qplanes.device, qplanes, fplanes, ids,
                  counts, n_f, q0, q1 - q0, ALGORITHMS.index(algorithm),
                  T_LO, T_HI)
    LAUNCHES["self_intersect"] += 1
    TILE_LAUNCHES["self_intersect[%s]" % algorithm] += 1
    return counts


# ---------------------------------------------------------------------------
# Whole queries: prologue and kernel.

def tri_tri_any_hit_kernel(q_tri, tri, algorithm="segment"):
    """Whether each query triangle of ``q_tri`` [Q, 3, 3] meets a triangle
    of ``tri`` [F, 3, 3]: (hit [Q] bool, tested [Q] int32).  The CUDA
    kernel on the card, its plain version on the CPU."""
    qp, fp = tri_tri_planes(q_tri.to(torch.float32), tri.to(torch.float32),
                            algorithm)
    return tri_tri_any_hit(qp, fp, algorithm)


def self_intersection_counts_kernel(v, f, algorithm="segment"):
    """Per face of the mesh (``v`` [V, 3], ``f`` [F, 3]), the number of
    faces sharing no vertex with it that it meets, [F] int32."""
    tri = v.to(torch.float32)[f.long()]
    qp, fp = self_planes(tri, algorithm)
    return self_intersect_counts(qp, fp, f.to(torch.int32).contiguous(),
                                 algorithm)
