"""Brute-force closest face and nearest vertex: the CUDA kernels' wrappers,
their plain PyTorch versions, and the prologue and epilogue around them
(counterpart of mesh_tpu/query/pallas_closest.py).

Five kernels:

- ``closest_faces`` (``csrc/closest_faces.cu`` over ``csrc/closest_cull.cuh``):
  for each query, the face with the least Ericson squared distance,
  computed from 19 per-face planes hoisted out of the scan
  (``fast_tile_rows`` / ``safe_tile_rows``).  Four instantiations: the fast
  or the sliver-safe tile, with or without the degenerate-face tail.  It
  walks the faces in chunks of ``CULL_CHUNK`` and skips, per warp of 32
  queries, every chunk that no lane needs: an exact cull, whose answers
  are the every-face kernel's bit for bit (``cull_operands`` and the
  source note of ``csrc/closest_cull.cuh``).
- ``closest_faces_every`` (``csrc/closest_faces_every.cu`` over
  ``csrc/argmin.cuh``): the same function on every face, the oracle that
  ``chip_smoke.py`` holds ``closest_faces`` to; no path launches it.
- ``cull_records`` (``csrc/cull_records.cu``): the chunk records of
  ``closest_faces``' cull, one warp per chunk (``cull_records_plain`` is
  its plain version).
- ``nearest_vertices`` (``csrc/nearest_vertices.cu``): for each query, the
  nearest mesh vertex.  The vertex axis is split over the blocks of a
  thread-block cluster, each folding a contiguous range, and the splits
  merge by the least packed (distance, index) key (``vertex_plan``,
  ``vertex_keys``; ``argmin_vertices_split_plain`` is the split and the
  merge in plain PyTorch).
- ``nearest_vertices_every`` (``csrc/nearest_vertices_every.cu`` over
  ``csrc/argmin.cuh``): one query a thread over every vertex, the oracle
  that ``chip_smoke.py`` holds ``nearest_vertices`` to; no path launches
  it.

The argmin kernels keep a running (distance, index) pair per query and
take a face only when it is strictly closer, walking faces in increasing
order, so the lowest index wins an exact tie, as the reference's argmin
does.

``closest_faces`` also has the reference's fused reduction
(``reduction="fused"``, counted apart as ``closest_faces_fused``): one
int32 min over packed keys, the cost's float32 bits with the low
log2(``tile_f``) bits replaced by the column within its face tile
(``tile_f`` a power of two).  Its tie group is "lowest column within its
tile, then earliest tile", with a relative tie radius of
2^-(23 - log2(tile_f)), about 2.4e-4 at the default 2048; the epilogue
still recomputes the winner exactly.  A NaN cost keeps its bits, so it
compares alike only on one device: on the card a NaN key (0x7fffffff)
loses to every finite cost, on x86 the NaN of 0 * inf has its sign set and
its key wins.

The wrappers ``closest_point_kernel`` and ``nearest_vertices_kernel`` take
the kernel's path for CUDA tensors and the plain version
(``closest_point_plain`` / ``nearest_vertices_plain``, same signatures) for
CPU tensors; any other device raises.  ``LAUNCHES`` counts each kernel's
launches.  The plain versions repeat the kernels' float32 arithmetic op for
op, so with the kernels built without FMA contraction (``--fmad=false``)
both pick the same faces on the card.  ``argmin_faces_plain`` is the
every-face argmin; ``argmin_faces_culled_plain`` repeats the chunk cull's
decisions and counts too.
"""

import functools
import hashlib
import math

import numpy as np
import torch

from ..geometry.cross_product import cross3
from ..utils.knobs import safe_tiles
from .point_triangle import closest_point_on_triangle

#: number of per-face planes of either tile
N_FACE_ROWS = 19

#: launches of each CUDA kernel since the counts were last set to 0
LAUNCHES = {"closest_faces": 0, "closest_faces_fused": 0,
            "closest_faces_every": 0, "cull_records": 0,
            "nearest_vertices": 0, "nearest_vertices_every": 0}

TILE_VARIANTS = ("fast", "safe")
REDUCTIONS = ("exact", "fused")

#: the fused reduction's default face tile (the reference's tile_f)
FUSED_TILE_F = 2048

#: query-face pairs one plain-version chunk evaluates at once, per device
#: type: each of the tile's ~40 live temporaries is this many floats
_PLAIN_PAIRS = {"cpu": 1 << 20, "cuda": 1 << 26}


# ---------------------------------------------------------------------------
# Per-pair cost functions: the plain versions' tiles.  px/py/pz are
# [..., TQ, 1] and every face plane [..., 1, TF]; each returns [..., TQ, TF].
# The CUDA functors in csrc/face_cost.cuh do the same operations in the
# same order.

def _sqdist_tile_fast(px, py, pz,
                      ax, ay, az, abx, aby, abz, acx, acy, acz, nx, ny, nz,
                      ab2, ac2, abac, inv_ab2, inv_ac2, inv_bc2, inv_n2,
                      degenerate_tail=True):
    """Division-free Ericson squared distance from corner-a dot products;
    the b/c-corner terms are derived from them and the hoisted per-face
    dot products (reference _sqdist_tile_fast)."""
    apx, apy, apz = px - ax, py - ay, pz - az
    d1 = abx * apx + aby * apy + abz * apz
    d2 = acx * apx + acy * apy + acz * apz
    ap2 = apx * apx + apy * apy + apz * apz
    n_ap = nx * apx + ny * apy + nz * apz
    return _ericson_tail(d1, d2, ap2, n_ap, ab2, ac2, abac,
                         inv_ab2, inv_ac2, inv_bc2, inv_n2,
                         degenerate_tail=degenerate_tail)


def _ericson_tail(d1, d2, ap2, n_ap, ab2, ac2, abac,
                  inv_ab2, inv_ac2, inv_bc2, inv_n2, degenerate_tail=True):
    """Region selection and distance from the four query-dependent scalars
    and the hoisted per-face constants."""
    d3 = d1 - ab2
    d4 = d2 - abac
    d5 = d1 - abac
    d6 = d2 - ac2
    bp2 = ap2 - (d1 + d1) + ab2
    cp2 = ap2 - (d2 + d2) + ac2
    return _region_select(d1, d2, d3, d4, d5, d6, ap2, bp2, cp2, n_ap,
                          ab2, ac2, abac, inv_ab2, inv_ac2, inv_bc2,
                          inv_n2, degenerate_tail=degenerate_tail)


def _region_select(d1, d2, d3, d4, d5, d6, ap2, bp2, cp2, n_ap,
                   ab2, ac2, abac, inv_ab2, inv_ac2, inv_bc2, inv_n2,
                   degenerate_tail=True):
    """Ericson region classification + squared distance: interior first,
    then edges and vertices override in priority order; degenerate faces
    (inv_n2 == 0) take their best clamped segment when the tail is on."""
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    d_bc = d4 - d3                     # (c-b).(p-b), since ac - ab = bc

    d = n_ap * n_ap * inv_n2
    on_bc = (va <= 0) & (d_bc >= 0) & (d5 - d6 >= 0)
    d = torch.where(on_bc, bp2 - d_bc * d_bc * inv_bc2, d)
    on_ca = (vb <= 0) & (d2 >= 0) & (d6 <= 0)
    d = torch.where(on_ca, ap2 - d2 * d2 * inv_ac2, d)
    on_ab = (vc <= 0) & (d1 >= 0) & (d3 <= 0)
    d = torch.where(on_ab, ap2 - d1 * d1 * inv_ab2, d)
    in_c = (d6 >= 0) & (d5 <= d6)
    d = torch.where(in_c, cp2, d)
    in_b = (d3 >= 0) & (d4 <= d3)
    d = torch.where(in_b, bp2, d)
    in_a = (d1 <= 0) & (d2 <= 0)
    d = torch.where(in_a, ap2, d)

    if degenerate_tail:
        t_ab = torch.clamp(d1 * inv_ab2, 0.0, 1.0)
        e_ab = ap2 - t_ab * (d1 + d1 - t_ab * ab2)
        t_ca = torch.clamp(d2 * inv_ac2, 0.0, 1.0)
        e_ca = ap2 - t_ca * (d2 + d2 - t_ca * ac2)
        bc2 = ab2 + ac2 - (abac + abac)
        t_bc = torch.clamp(d_bc * inv_bc2, 0.0, 1.0)
        e_bc = bp2 - t_bc * (d_bc + d_bc - t_bc * bc2)
        d = torch.where(inv_n2 > 0, d,
                        torch.minimum(e_ab, torch.minimum(e_ca, e_bc)))
    # the edge forms subtract two nearly-equal squares; clamp the rounding
    return torch.clamp_min(d, 0.0)


def _sqdist_tile_safe(px, py, pz,
                      ax, ay, az, bx, by, bz, cx, cy, cz, nx, ny, nz,
                      ab2, ac2, abac, inv_ab2, inv_ac2, inv_bc2, inv_n2,
                      degenerate_tail=True):
    """Direct-corner, residual-vector Ericson squared distance: every dot
    product from its own corner difference, every clamped edge distance
    from the residual vector, so long-edged slivers keep their
    conditioning (reference _sqdist_tile_safe)."""
    abx, aby, abz = bx - ax, by - ay, bz - az
    acx, acy, acz = cx - ax, cy - ay, cz - az
    bcx, bcy, bcz = cx - bx, cy - by, cz - bz
    apx, apy, apz = px - ax, py - ay, pz - az
    bpx, bpy, bpz = px - bx, py - by, pz - bz
    cpx, cpy, cpz = px - cx, py - cy, pz - cz
    d1 = abx * apx + aby * apy + abz * apz
    d2 = acx * apx + acy * apy + acz * apz
    d3 = abx * bpx + aby * bpy + abz * bpz
    d4 = acx * bpx + acy * bpy + acz * bpz
    d5 = abx * cpx + aby * cpy + abz * cpz
    d6 = acx * cpx + acy * cpy + acz * cpz
    ap2 = apx * apx + apy * apy + apz * apz
    bp2 = bpx * bpx + bpy * bpy + bpz * bpz
    cp2 = cpx * cpx + cpy * cpy + cpz * cpz
    n_ap = nx * apx + ny * apy + nz * apz

    def seg_sqdist(t, ox_, oy_, oz_, ex_, ey_, ez_):
        rx = ox_ - t * ex_
        ry = oy_ - t * ey_
        rz = oz_ - t * ez_
        return rx * rx + ry * ry + rz * rz

    e_ab = seg_sqdist(torch.clamp(d1 * inv_ab2, 0.0, 1.0),
                      apx, apy, apz, abx, aby, abz)
    e_ca = seg_sqdist(torch.clamp(d2 * inv_ac2, 0.0, 1.0),
                      apx, apy, apz, acx, acy, acz)
    d_bc = d4 - d3
    e_bc = seg_sqdist(torch.clamp(d_bc * inv_bc2, 0.0, 1.0),
                      bpx, bpy, bpz, bcx, bcy, bcz)

    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    d = n_ap * n_ap * inv_n2
    d = torch.where((va <= 0) & (d_bc >= 0) & (d5 - d6 >= 0), e_bc, d)
    d = torch.where((vb <= 0) & (d2 >= 0) & (d6 <= 0), e_ca, d)
    d = torch.where((vc <= 0) & (d1 >= 0) & (d3 <= 0), e_ab, d)
    d = torch.where((d6 >= 0) & (d5 <= d6), cp2, d)
    d = torch.where((d3 >= 0) & (d4 <= d3), bp2, d)
    d = torch.where((d1 <= 0) & (d2 <= 0), ap2, d)
    if degenerate_tail:
        d = torch.where(inv_n2 > 0, d,
                        torch.minimum(e_ab, torch.minimum(e_ca, e_bc)))
    return torch.clamp_min(d, 0.0)


def _vertex_sqdist_tile(px, py, pz, vx, vy, vz):
    """Point-to-vertex squared distance."""
    dx, dy, dz = px - vx, py - vy, pz - vz
    return dx * dx + dy * dy + dz * dz


# ---------------------------------------------------------------------------
# Prologue: per-face planes, centering; epilogue: exact winner recompute.

def _safe_recip(x):
    # below-threshold (near-degenerate) faces get 0, which routes them to
    # the vertex/edge fallbacks instead of a clamped reciprocal
    return torch.where(x < 1e-30, torch.zeros_like(x), 1.0 / x)


def fast_tile_rows(tri):
    """The 19 per-face quantities ``_sqdist_tile_fast`` consumes, in its
    face-parameter order: corner a, edges ab/ac, the unnormalized normal,
    ab2/ac2/abac and the reciprocals inv_ab2/inv_ac2/inv_bc2/inv_n2.
    ``tri`` is [..., F, 3 corners, 3 xyz]; returns 19 [..., F] tensors."""
    a = tri[..., 0, :]
    ab = tri[..., 1, :] - a
    ac = tri[..., 2, :] - a
    bc = tri[..., 2, :] - tri[..., 1, :]
    n = cross3(ab, ac)
    ab2 = (ab * ab).sum(dim=-1)
    ac2 = (ac * ac).sum(dim=-1)
    n2 = (n * n).sum(dim=-1)
    rows = [
        a[..., 0], a[..., 1], a[..., 2],
        ab[..., 0], ab[..., 1], ab[..., 2],
        ac[..., 0], ac[..., 1], ac[..., 2],
        n[..., 0], n[..., 1], n[..., 2],
        ab2, ac2, (ab * ac).sum(dim=-1),
        _safe_recip(ab2),
        _safe_recip(ac2),
        _safe_recip((bc * bc).sum(dim=-1)),
        # the degeneracy cut is RELATIVE: a collinear face at unit scale
        # has n2 ~ rounding noise, far above any absolute epsilon
        torch.where(n2 <= 1e-10 * ab2 * ac2, torch.zeros_like(n2),
                    _safe_recip(n2)),
    ]
    assert len(rows) == N_FACE_ROWS
    return rows


def safe_tile_rows(tri):
    """The 19 per-face quantities ``_sqdist_tile_safe`` consumes: the three
    corners, the unnormalized normal and the seven scalars of
    ``fast_tile_rows`` (its rows 12-18)."""
    a = tri[..., 0, :]
    b = tri[..., 1, :]
    c = tri[..., 2, :]
    n = cross3(b - a, c - a)
    rows = [
        a[..., 0], a[..., 1], a[..., 2],
        b[..., 0], b[..., 1], b[..., 2],
        c[..., 0], c[..., 1], c[..., 2],
        n[..., 0], n[..., 1], n[..., 2],
        *fast_tile_rows(tri)[12:],
    ]
    assert len(rows) == N_FACE_ROWS
    return rows


def face_planes(tri, tile_variant):
    """[B, 19, F] contiguous float32 planes of the chosen tile for
    ``tri`` [B, F, 3, 3]: the kernel's face operand."""
    rows = {"fast": fast_tile_rows, "safe": safe_tile_rows}[tile_variant](tri)
    return torch.stack(rows, dim=-2).contiguous()


#: content-keyed results of mesh_is_nondegenerate (bounded FIFO): repeated
#: facade calls on an unchanged mesh skip the float64 pass
_NONDEGEN_CACHE = {}
_NONDEGEN_CACHE_MAX = 64


def mesh_is_nondegenerate(v, f, margin=100.0):
    """Host-side check backing ``assume_nondegenerate``: True when EVERY
    face clears the fast tile's relative area cut
    (``n2 > 1e-10 * ab2 * ac2``) with ``margin`` to spare, the margin
    absorbing the float32 centering and rounding between this float64
    check and the planes the kernel sees.

    ``v`` may carry leading batch axes ([..., V, 3]); the answer covers
    every mesh.  Results are cached by a 128-bit blake2b digest of the raw
    bytes: the flag selects a kernel that is wrong on degenerate data.
    ``MESH_TPU_SAFE_TILES=1`` makes this always return False.
    """
    if safe_tiles():
        return False

    v = np.ascontiguousarray(np.asarray(v))
    f = np.ascontiguousarray(np.asarray(f))
    digest = hashlib.blake2b(digest_size=16)
    digest.update(v.tobytes())
    digest.update(b"\0")
    digest.update(f.tobytes())
    key = (v.shape, f.shape, float(margin), str(v.dtype), str(f.dtype),
           digest.digest())
    hit = _NONDEGEN_CACHE.get(key)
    if hit is not None:
        return hit
    v64 = v.astype(np.float64)
    tri = v64[..., f, :]
    ab = tri[..., 1, :] - tri[..., 0, :]
    ac = tri[..., 2, :] - tri[..., 0, :]
    n = np.cross(ab, ac)
    n2 = np.sum(n * n, axis=-1)
    ab2 = np.sum(ab * ab, axis=-1)
    ac2 = np.sum(ac * ac, axis=-1)
    result = bool(np.all(n2 > margin * 1e-10 * ab2 * ac2))
    if len(_NONDEGEN_CACHE) >= _NONDEGEN_CACHE_MAX:
        _NONDEGEN_CACHE.pop(next(iter(_NONDEGEN_CACHE)))
    _NONDEGEN_CACHE[key] = result
    return result


#: (V, device) -> the two passes' segment offsets of ``vertex_mean``;
#: never dropped, since a CUDA graph captured on them reads them on every
#: replay (a few hundred bytes a topology size)
_MEAN_OFFSETS = {}


def _mean_offsets(n, device):
    """``vertex_mean``'s segment offsets over V = ``n`` rows: runs of
    ``isqrt(n)`` rows ([runs + 1]), then one segment of every run ([2]).
    Kept per V and device, except when made inside a CUDA graph capture,
    whose tensors hold nothing until the graph is replayed."""
    key = (n, str(device))
    hit = _MEAN_OFFSETS.get(key)
    if hit is not None:
        return hit
    run = math.isqrt(n)
    n_runs = -(-n // run)
    both = ((torch.arange(n_runs + 1, dtype=torch.int64, device=device)
             * run).clamp_(max=n),
            torch.arange(2, dtype=torch.int64, device=device) * n_runs)
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        return both
    return _MEAN_OFFSETS.setdefault(key, both)


def vertex_mean(v):
    """Per-mesh vertex mean of ``v`` [..., V, 3] -> [..., 1, 3], summed in
    an order that V alone fixes, so a mesh's mean has the same bits alone
    or in any batch (a ``torch.mean`` over V splits its sum by the batch's
    size on the card).  ``torch.segment_reduce`` adds a segment's rows one
    after the other (one thread per output on the card): first runs of
    ``isqrt(V)`` rows, then the runs' sums, so no thread adds more than
    about 2 sqrt(V) rows in a chain.  Its offsets are cached
    (``_mean_offsets``), and ``unsafe=True`` skips their checks, which
    read them on the host."""
    n = v.shape[-2]
    if not n:
        return v.mean(dim=-2, keepdim=True)
    rows = v.reshape((-1,) + v.shape[-2:])
    runs, total = _mean_offsets(n, v.device)
    sums = torch.segment_reduce(rows, "sum",
                                offsets=runs.expand(rows.shape[0],
                                                    -1).contiguous(),
                                axis=1, unsafe=True)
    sums = torch.segment_reduce(sums, "sum",
                                offsets=total.expand(rows.shape[0],
                                                     -1).contiguous(),
                                axis=1, unsafe=True)
    return (sums / n).reshape(v.shape[:-2] + (1, v.shape[-1]))


def _center_inputs(v, f, points):
    """Shared query prologue: float32 cast, centering on the per-mesh
    vertex mean (``vertex_mean``; the float32 conditioning every kernel
    relies on), face corner gather.  ``v`` [B, V, 3], ``points`` [B, Q, 3]
    -> (points, center, tri), centered."""
    v = v.to(torch.float32)
    center = vertex_mean(v)
    return (points.to(torch.float32) - center, center,
            (v - center)[..., f.long(), :])


def winner_epilogue(best, tri, pts, center):
    """Exact recompute on the winning faces (also yields the CGAL part
    code) -> the closest_faces_and_points result dict."""
    rows = torch.arange(best.shape[0], device=best.device)[:, None]
    win = tri[rows, best.long()]                     # [B, Q, 3, 3]
    point, sqd, part = closest_point_on_triangle(
        pts, win[..., 0, :], win[..., 1, :], win[..., 2, :])
    return {"face": best, "part": part, "point": point + center,
            "sqdist": sqd}


def _batched(v, points):
    """(v [B, V, 3], points [B, Q, 3], unbatch) for one mesh or a batch."""
    if v.ndim == 2:
        return v[None], points.reshape(1, -1, 3), True
    if v.ndim != 3 or points.ndim != 3 or points.shape[0] != v.shape[0]:
        raise ValueError("want v [V, 3] with points [Q, 3], or v [B, V, 3] "
                         "with points [B, Q, 3]; got %r and %r"
                         % (tuple(v.shape), tuple(points.shape)))
    return v, points, False


def _check_variant(tile_variant):
    if tile_variant not in TILE_VARIANTS:
        raise ValueError("tile_variant must be 'fast' or 'safe', got %r"
                         % (tile_variant,))


def _check_reduction(reduction, tile_f):
    """The reference's checks (mesh_tpu/query/pallas_closest.py:675-682):
    the fused key masks the low log2(tile_f) bits, so a tile that is not a
    power of two would corrupt the cost bits with the column."""
    if reduction not in REDUCTIONS:
        raise ValueError("reduction must be 'exact' or 'fused', got %r"
                         % (reduction,))
    if reduction == "fused" and (tile_f <= 0 or tile_f & (tile_f - 1)):
        raise ValueError("reduction='fused' requires a power-of-two tile_f, "
                         "got %d" % tile_f)


# ---------------------------------------------------------------------------
# The chunk cull of ``closest_faces``: its operands and its plain version.
# csrc/closest_cull.cuh makes the same float32 operations in the same order.

#: faces per chunk of the cull: a warp of 32 queries folds a chunk or skips it
CULL_CHUNK = 32

#: queries per warp: the unit of the chunk culls (here and culled_kernel)
WARP = 32

#: float32's unit roundoff, 2^-24
_U = 2.0 ** -24

#: the box bound's relative shrink of the squared distance, (1 - 1e-3)^2
#: as culled_kernel's _MARGIN shrinks a distance
_CULL_SHRINK2 = 0.998

#: a chunk whose center lies this far from a query, plus three radii, is
#: always tested: below it no product of the cost tile can overflow
CULL_FAR = 1e9

#: a chunk holding a face whose conditioning number (S or G in
#: ``cull_records``) exceeds this is always tested
CULL_MAX_COND = 1e4


def query_order(pts):
    """[B, Q] int32: each mesh's queries ``pts`` [B, Q, 3] in the Morton
    order of their positions (stable sort), the kernel's lane order."""
    from .culled_kernel import _morton_codes

    if pts.shape[1] == 0:
        return torch.empty(pts.shape[:2], dtype=torch.int32,
                           device=pts.device)
    return torch.argsort(_morton_codes(pts), dim=1,
                         stable=True).to(torch.int32)


def cull_records_plain(planes, tile_variant="fast", degenerate_tail=True):
    """Plain PyTorch version of the ``cull_records`` kernel: [B, C, 12]
    float32 records of the chunks of ``CULL_CHUNK``
    consecutive faces (in index order) of ``planes`` [B, R, F] (R >= 19:
    rows 0-18 are the tile's planes, any further rows are not read), C =
    ceil(F / 32), as three float4: the center of the box around the
    chunk's corners and its half diagonal; the box's half extents and the
    rounding term e1; corner a of the chunk's first face (the seed's
    representative) and the rounding term e2.

    The corners are those the tile's cost sees: a, a + ab and a + ac for the
    fast tile (the box widened for the float32 rounding of those sums),
    rows 0-8 for the sliver-safe one.  The rounding terms come from each
    face's conditioning (csrc/closest_cull.cuh derives them): S = |ab| |ac|
    / |n|, Lambda = L^2 / (|n| e_min) over its longest and shortest edges,
    and for the fast tile G = L / |bc| (``inv_bc2`` is the reciprocal of
    the corners' own |c - b|^2, not of |ac - ab|^2); over the chunk's faces
    that run the region chain (every face without the degenerate tail,
    those with inv_n2 > 0 with it),
    e1 = u (64 + 40 max S + 96 max G) and e2 = 128 u max Lambda, u = 2^-24.
    A chunk is always tested (e1 = +inf) when a face has a non-finite plane,
    an S or G above ``CULL_MAX_COND``, or, without the tail, inv_n2 <= 0
    (its interior cost is 0 wherever it lies)."""
    _check_variant(tile_variant)
    planes = planes[:, :N_FACE_ROWS]
    n_b, n_rows, n_f = planes.shape
    pad = -n_f % CULL_CHUNK
    if pad:      # repeat the last face: no new corner, no new face
        planes = torch.cat(
            [planes, planes[..., -1:].expand(n_b, n_rows, pad)], dim=-1)
    rows = planes.reshape(n_b, n_rows, -1, CULL_CHUNK).unbind(1)
    ax, ay, az = rows[0:3]                                # [B, C, 32] each
    if tile_variant == "fast":
        abx, aby, abz, acx, acy, acz = rows[3:9]
        corners = ((ax, ax + abx, ax + acx), (ay, ay + aby, ay + acy),
                   (az, az + abz, az + acz))
    else:
        bx, by, bz, cx, cy, cz = rows[3:9]
        abx, aby, abz = bx - ax, by - ay, bz - az
        acx, acy, acz = cx - ax, cy - ay, cz - az
        corners = ((ax, bx, cx), (ay, by, cy), (az, bz, cz))
    box = []
    for xyz in corners:
        lo = torch.minimum(torch.minimum(xyz[0], xyz[1]), xyz[2]).amin(-1)
        hi = torch.maximum(torch.maximum(xyz[0], xyz[1]), xyz[2]).amax(-1)
        cen = (lo + hi) * 0.5
        # fl(a + ab) lies within u |fl(a + ab)| of a + ab, and each
        # computed extent within u of its own value: widen generously
        half = (torch.maximum(hi - cen, cen - lo) * (1.0 + 8 * _U)
                + torch.maximum(lo.abs(), hi.abs()) * (4 * _U))
        box.append((cen, half))
    (cx_, hx), (cy_, hy), (cz_, hz) = box
    diag = torch.sqrt(hx * hx + hy * hy + hz * hz) * (1.0 + 8 * _U)

    ab2 = abx * abx + aby * aby + abz * abz               # [B, C, 32]
    ac2 = acx * acx + acy * acy + acz * acz
    bcx, bcy, bcz = acx - abx, acy - aby, acz - abz
    bc2 = bcx * bcx + bcy * bcy + bcz * bcz
    long2 = torch.maximum(torch.maximum(ab2, ac2), bc2)
    short = torch.sqrt(torch.minimum(torch.minimum(ab2, ac2), bc2))
    span = torch.sqrt(ab2 * ac2)
    nx, ny, nz = rows[9:12]
    # |n| less the float32 rounding of the cross product
    n_low = torch.sqrt(nx * nx + ny * ny + nz * nz) - span * (16 * _U)
    inf = torch.full_like(n_low, float("inf"))
    pos = n_low > 0
    cond_s = torch.where(pos, span / n_low, inf)
    cond_l = torch.where(pos & (short > 0), long2 / (n_low * short), inf)
    cond_g = (torch.sqrt(long2 * rows[17]) if tile_variant == "fast"
              else torch.zeros_like(cond_s))
    chain = rows[18] > 0
    always = ~torch.isfinite(planes).all(1).reshape(chain.shape)
    if degenerate_tail:
        zero = torch.zeros_like(cond_s)
        cond_s = torch.where(chain, cond_s, zero)
        cond_l = torch.where(chain, cond_l, zero)
        cond_g = torch.where(chain, cond_g, zero)
    else:
        always |= ~chain
    always = (always | ~(cond_s <= CULL_MAX_COND)
              | ~(cond_g <= CULL_MAX_COND)).any(-1)
    e1 = (cond_s.amax(-1) * 40.0 + 64.0 + cond_g.amax(-1) * 96.0) * _U
    e1 = torch.where(always, inf[..., 0], e1)
    e2 = cond_l.amax(-1) * (128.0 * _U)
    return torch.stack([cx_, cy_, cz_, diag, hx, hy, hz, e1,
                        ax[..., 0], ay[..., 0], az[..., 0], e2],
                       dim=-1).contiguous()


def cull_records(planes, tile_variant="fast", degenerate_tail=True):
    """The chunk records of ``cull_records_plain`` for ``planes`` [B, R,
    F], R >= 19 (the normal-weighted kernel's 22 rows are read in place):
    the ``cull_records`` CUDA kernel (csrc/cull_records.cu, one pass over
    the planes) for a CUDA tensor, the plain version for a CPU one."""
    _check_variant(tile_variant)
    if (planes.dtype != torch.float32 or not planes.is_contiguous()
            or planes.ndim != 3 or planes.shape[1] < N_FACE_ROWS):
        raise ValueError("cull_records wants contiguous float32 planes "
                         "[B, R >= 19, F], got %s %s" % (
                             tuple(planes.shape), planes.dtype))
    if planes.device.type == "cpu":
        return cull_records_plain(planes, tile_variant, degenerate_tail)
    if planes.device.type != "cuda":
        raise ValueError("cull_records: no kernel for device %s"
                         % planes.device)
    from .. import _build

    n_b, n_rows, n_f = planes.shape
    recs = torch.empty((n_b, -(-n_f // CULL_CHUNK), 12), dtype=torch.float32,
                       device=planes.device)
    _build.launch("cull_records", planes.device, planes, recs, n_b, n_f,
                  n_rows, TILE_VARIANTS.index(tile_variant),
                  int(bool(degenerate_tail)))
    LAUNCHES["cull_records"] += 1
    return recs


def cull_operands(pts, planes, tile_variant="fast", degenerate_tail=True):
    """The cull's operands for the kernel's ``pts`` [B, Q, 3] and ``planes``
    [B, 19, F]: ``qorder`` (``query_order``) and ``records``
    (``cull_records``), with the tile and tail they were made for."""
    return {"qorder": query_order(pts),
            "records": cull_records(planes, tile_variant, degenerate_tail),
            "tile_variant": tile_variant,
            "degenerate_tail": bool(degenerate_tail)}


def _check_cull(pts, planes, cull, tile_variant, degenerate_tail):
    qorder, recs = cull["qorder"], cull["records"]
    n_b, n_q = pts.shape[:2]
    n_c = -(-planes.shape[-1] // CULL_CHUNK)
    if (cull["tile_variant"] != tile_variant
            or cull["degenerate_tail"] != bool(degenerate_tail)):
        raise ValueError("closest_faces: cull operands made for the %s tile "
                         "(tail %s), not the %s tile (tail %s)" % (
                             cull["tile_variant"], cull["degenerate_tail"],
                             tile_variant, bool(degenerate_tail)))
    if (qorder.dtype != torch.int32 or recs.dtype != torch.float32
            or not qorder.is_contiguous() or not recs.is_contiguous()
            or qorder.device != pts.device or recs.device != pts.device
            or tuple(qorder.shape) != (n_b, n_q)
            or tuple(recs.shape) != (n_b, n_c, 12)):
        raise ValueError("closest_faces: want qorder [%d, %d] int32 and "
                         "records [%d, %d, 12] float32, contiguous, on %s; "
                         "got %s %s and %s %s" % (
                             n_b, n_q, n_b, n_c, pts.device,
                             tuple(qorder.shape), qorder.dtype,
                             tuple(recs.shape), recs.dtype))


def _cull_lb2(px, py, pz, rec):
    """The kernel's squared lower bound (``cull_lb2``) from queries to the
    chunk records ``rec`` [..., 12] (broadcast): the squared distance to
    the chunk's box, shrunk by (1 - 1e-3)^2, less E = R^2 e1 + (R^2 e2)^2,
    R the distance to the box's center plus three half diagonals; -inf
    past ``CULL_FAR``.  NaN stays NaN (abs, clamp_min), so a NaN query or
    box is always needed."""
    dx, dy, dz = px - rec[..., 0], py - rec[..., 1], pz - rec[..., 2]
    big = torch.sqrt(dx * dx + dy * dy + dz * dz) + 3.0 * rec[..., 3]
    ox = torch.clamp_min(dx.abs() - rec[..., 4], 0.0)
    oy = torch.clamp_min(dy.abs() - rec[..., 5], 0.0)
    oz = torch.clamp_min(dz.abs() - rec[..., 6], 0.0)
    big2 = big * big
    t = big2 * rec[..., 11]
    lb2 = ((ox * ox + oy * oy + oz * oz) * _CULL_SHRINK2
           - (big2 * rec[..., 7] + t * t))
    return torch.where(big <= CULL_FAR, lb2,
                       torch.full_like(lb2, float("-inf")))


def _warp_vote(x):
    """[..., N / 32] bool: whether any lane of each warp of bool ``x``
    [..., N] (N a multiple of 32) holds, as __any_sync gives it."""
    return x.reshape(x.shape[:-1] + (-1, WARP)).any(dim=-1)


def argmin_faces_culled_plain(pts, planes, cull, tile_variant="fast",
                              degenerate_tail=True, reduction="exact",
                              tile_f=FUSED_TILE_F):
    """Plain PyTorch version of the ``closest_faces`` kernel's chunk cull:
    (closest face per query [B, Q] int32, chunks each warp folded
    [B, ceil(Q / 32)] int32, real faces of the chunks each query's own
    lane needed [B, Q] int32 at its sorted position, chunks each warp
    staged [B, ceil(Q / 32)] int32).  The faces are ``argmin_faces_plain``'s.

    Queries run in ``cull["qorder"]``, 32 to a warp.
    Each lane is seeded with the cost of the first face of the chunk whose
    corner a is nearest (``records[..., 8:11]``; a NaN distance counts as
    +inf).  The chunks come in index order; a lane needs chunk k unless its
    bound (``_cull_lb2``) exceeds the threshold: min(best, seed) for the
    exact reduction, the float whose bits are min(best key, seed key) with
    the tile's low bits set for the fused one.  A warp stages chunk k when
    one of its lanes needs it against the state before the last chunk it
    staged (the kernel votes one chunk ahead), and folds a staged chunk,
    every lane of it, when one of its lanes needs it against the state
    now.  The fold is torch.argmin's: strict < in increasing face order, a
    NaN cost (keys for the fused reduction) winning as torch.argmin has it."""
    _check_variant(tile_variant)
    _check_reduction(reduction, tile_f)
    tile = {"fast": _sqdist_tile_fast, "safe": _sqdist_tile_safe}[
        tile_variant]
    fused = reduction == "fused"
    mask, shift = tile_f - 1, int(tile_f).bit_length() - 1
    n_b, n_q = pts.shape[:2]
    n_f = planes.shape[-1]
    n_c = -(-n_f // CULL_CHUNK)
    dev = pts.device
    q_pad = -(-n_q // WARP) * WARP
    out = torch.zeros((n_b, n_q), dtype=torch.int32, device=dev)
    warp = torch.zeros((n_b, q_pad // WARP), dtype=torch.int32, device=dev)
    lane = torch.zeros((n_b, q_pad), dtype=torch.int32, device=dev)
    stage = torch.zeros_like(warp)
    valid = torch.arange(q_pad, device=dev) < n_q
    per = max(1, _PLAIN_PAIRS[dev.type] // (q_pad * max(n_c, CULL_CHUNK)))
    for b0 in range(0, n_b, per):
        b1 = min(n_b, b0 + per)
        nb = b1 - b0
        qo = cull["qorder"][b0:b1].long()
        ps = torch.zeros((nb, q_pad, 3), dtype=pts.dtype, device=dev)
        ps[:, :n_q] = torch.gather(pts[b0:b1], 1, qo[..., None].expand(
            nb, n_q, 3))
        px, py, pz = ps[..., 0], ps[..., 1], ps[..., 2]
        rec = cull["records"][b0:b1]                          # [nb, C, 12]
        pl = planes[b0:b1]
        # the seed: the cost of the nearest representative's face
        dx = px[..., None] - rec[:, None, :, 8]
        dy = py[..., None] - rec[:, None, :, 9]
        dz = pz[..., None] - rec[:, None, :, 10]
        rep = torch.nan_to_num(dx * dx + dy * dy + dz * dz,
                               nan=float("inf"))
        fs = torch.argmin(rep, dim=-1) * CULL_CHUNK           # [nb, Qp]
        del dx, dy, dz, rep
        face = torch.gather(pl, 2, fs[:, None, :].expand(nb, N_FACE_ROWS,
                                                          q_pad))
        seed = tile(px, py, pz, *face.unbind(1),
                    degenerate_tail=degenerate_tail)
        if fused:
            best = torch.full((nb, q_pad), 2 ** 31 - 1, dtype=torch.int32,
                              device=dev)
            seed = ((seed.view(torch.int32) & ~mask)
                    | (fs.to(torch.int32) & mask))

            def thr(state):
                return (torch.minimum(state, seed) | mask).view(
                    torch.float32)
        else:
            best = torch.full((nb, q_pad), float("inf"), device=dev)

            def thr(state):
                return torch.fmin(state, seed)
        best_i = torch.zeros((nb, q_pad), dtype=torch.int32, device=dev)
        snap = best.clone()
        for k in range(n_c):
            lb2 = _cull_lb2(px, py, pz, rec[:, None, k])
            vote = _warp_vote(~(lb2 > thr(snap)) & valid)
            if not bool(vote.any()):
                continue
            stage[b0:b1] += vote.to(torch.int32)
            snap = torch.where(vote.repeat_interleave(WARP, -1), best, snap)
            need = ~(lb2 > thr(best)) & valid
            folds = _warp_vote(need)
            c0 = k * CULL_CHUNK
            nf = min(CULL_CHUNK, n_f - c0)
            warp[b0:b1] += folds.to(torch.int32)
            lane[b0:b1] += need.to(torch.int32) * nf
            if not bool(folds.any()):
                continue
            cost = tile(px[..., None], py[..., None], pz[..., None],
                        *pl[:, :, None, c0:c0 + nf].unbind(1),
                        degenerate_tail=degenerate_tail)      # [nb, Qp, nf]
            if fused:
                col = torch.arange(c0, c0 + nf, dtype=torch.int32,
                                   device=dev)
                cost = (cost.view(torch.int32) & ~mask) | (col & mask)
            arg = torch.argmin(cost, dim=-1)
            low = torch.gather(cost, -1, arg[..., None])[..., 0]
            take = low < best
            if not fused:
                take |= torch.isnan(low) & ~torch.isnan(best)
            take &= folds.repeat_interleave(WARP, -1)
            best = torch.where(take, low, best)
            best_i = torch.where(take, (arg + c0).to(torch.int32), best_i)
        if fused:
            best_i = ((best_i >> shift) << shift) + (best & mask)
        out[b0:b1].scatter_(1, qo, best_i[:, :n_q])
    return out, warp, lane[:, :n_q], stage


# ---------------------------------------------------------------------------
# The argmin steps: plain version, and the wrapper that launches the kernel.

def _chunks(n_b, n_q, n_cols, device):
    """(b0, b1, q0, q1) blocks of at most _PLAIN_PAIRS pairs each; none
    when there are no queries."""
    budget = _PLAIN_PAIRS[device.type]
    if n_q * n_cols <= budget:
        nb, nq = max(1, budget // max(1, n_q * n_cols)), max(1, n_q)
    else:
        nb, nq = 1, max(1, budget // max(1, n_cols))
    for b0 in range(0, n_b, nb):
        for q0 in range(0, n_q, nq):
            yield b0, min(n_b, b0 + nb), q0, min(n_q, q0 + nq)


def fused_keys(cost, tile_f):
    """The fused reduction's packed keys of ``cost`` [..., F] float32:
    ``(bits & ~(tile_f - 1)) | (col & (tile_f - 1))`` as int32."""
    mask = tile_f - 1
    col = torch.arange(cost.shape[-1], dtype=torch.int32, device=cost.device)
    return (cost.contiguous().view(torch.int32) & ~mask) | (col & mask)


def argmin_faces_plain(pts, planes, tile_variant="fast",
                       degenerate_tail=True, reduction="exact",
                       tile_f=FUSED_TILE_F):
    """Plain PyTorch version of the ``closest_faces`` kernel: index of the
    closest face per query, [B, Q] int32, lowest index on exact ties.
    ``pts`` [B, Q, 3] and ``planes`` [B, 19, F] float32, centered.

    ``reduction="fused"``: the first least packed key (``fused_keys``)
    over the whole face axis, which the chunks never cut.  The first least
    key is the kernel's fold: keys within a tile differ, and among equal
    keys the earliest tile wins."""
    _check_variant(tile_variant)
    _check_reduction(reduction, tile_f)
    tile = {"fast": _sqdist_tile_fast, "safe": _sqdist_tile_safe}[
        tile_variant]
    n_b, n_q = pts.shape[:2]
    out = torch.empty((n_b, n_q), dtype=torch.int32, device=pts.device)
    for b0, b1, q0, q1 in _chunks(n_b, n_q, planes.shape[-1], pts.device):
        p = pts[b0:b1, q0:q1]
        rows = [planes[b0:b1, k, None, :] for k in range(N_FACE_ROWS)]
        cost = tile(p[..., 0:1], p[..., 1:2], p[..., 2:3], *rows,
                    degenerate_tail=degenerate_tail)
        if reduction == "fused":
            cost = fused_keys(cost, tile_f)
        out[b0:b1, q0:q1] = torch.argmin(cost, dim=-1).to(torch.int32)
    return out


def _check_operands(pts, cols, n_rows, name):
    if pts.device != cols.device:
        raise ValueError("%s: operands on %s and %s"
                         % (name, pts.device, cols.device))
    for t in (pts, cols):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("%s wants contiguous float32 operands, got %s"
                             % (name, t.dtype))
    if (pts.ndim != 3 or pts.shape[-1] != 3 or cols.ndim != 3
            or cols.shape[:2] != (pts.shape[0], n_rows)):
        raise ValueError("%s: want pts [B, Q, 3] and planes [B, %d, N], got "
                         "%r and %r" % (name, n_rows, tuple(pts.shape),
                                        tuple(cols.shape)))
    if pts.device.type not in ("cpu", "cuda"):
        raise ValueError("%s: no kernel for device %s" % (name, pts.device))


def _grid(pts, cols, name):
    """(meshes, queries, columns) of an argmin launch, whose grid takes at
    most 65535 meshes."""
    n_b, n_q = pts.shape[:2]
    if n_b > 65535:
        raise ValueError("%s: batch of %d meshes exceeds the grid's 65535"
                         % (name, n_b))
    return n_b, n_q, cols.shape[-1]


def no_queries(n_b, device, n_out=1):
    """``n_out`` empty [B, 0] int32 outputs of a call with no queries.  A
    kernel's grid is sized by its queries and an empty grid is a launch
    error, so each wrapper returns these before it launches, and counts no
    launch."""
    out = tuple(torch.empty((n_b, 0), dtype=torch.int32, device=device)
                for _ in range(n_out))
    return out if n_out > 1 else out[0]


def argmin_faces(pts, planes, tile_variant="fast", degenerate_tail=True,
                 reduction="exact", tile_f=FUSED_TILE_F, cull=None,
                 with_stats=False):
    """Index of the closest face per query: the ``closest_faces`` CUDA
    kernel, the exact chunk cull, for CUDA tensors; ``argmin_faces_plain``
    for CPU tensors.  ``cull``: the operands of ``cull_operands`` (made here
    when None).  ``with_stats`` returns the four outputs of
    ``argmin_faces_culled_plain`` (which a CPU call runs then)."""
    _check_variant(tile_variant)
    _check_reduction(reduction, tile_f)
    _check_operands(pts, planes, N_FACE_ROWS, "closest_faces")
    if pts.device.type == "cpu" and not with_stats:
        return argmin_faces_plain(pts, planes, tile_variant, degenerate_tail,
                                  reduction, tile_f)
    if not pts.shape[1]:
        return no_queries(pts.shape[0], pts.device, 4 if with_stats else 1)
    if cull is None:
        cull = cull_operands(pts, planes, tile_variant, degenerate_tail)
    _check_cull(pts, planes, cull, tile_variant, degenerate_tail)
    if pts.device.type == "cpu":
        return argmin_faces_culled_plain(pts, planes, cull, tile_variant,
                                         degenerate_tail, reduction, tile_f)
    from .. import _build

    fused = reduction == "fused"
    n_b, n_q, n_f = _grid(pts, planes, "closest_faces")
    out = torch.empty((n_b, n_q), dtype=torch.int32, device=pts.device)
    stats = tuple(
        torch.empty((n_b, -(-n_q // size)), dtype=torch.int32,
                    device=pts.device) for size in (WARP, 1, WARP)
    ) if with_stats else (None, None, None)
    _build.launch("closest_faces", pts.device, pts, cull["qorder"], planes,
                  cull["records"], out, *stats, n_b, n_q, n_f,
                  TILE_VARIANTS.index(tile_variant),
                  int(bool(degenerate_tail)),
                  int(tile_f) if fused else 0)
    LAUNCHES["closest_faces_fused" if fused else "closest_faces"] += 1
    return (out,) + stats if with_stats else out


def argmin_faces_every(pts, planes, tile_variant="fast", degenerate_tail=True,
                       reduction="exact", tile_f=FUSED_TILE_F):
    """Index of the closest face per query over every face: the
    ``closest_faces_every`` CUDA kernel (``closest_faces``' oracle; no path
    launches it) for CUDA tensors, ``argmin_faces_plain`` for CPU tensors."""
    _check_variant(tile_variant)
    _check_reduction(reduction, tile_f)
    _check_operands(pts, planes, N_FACE_ROWS, "closest_faces_every")
    if pts.device.type == "cpu":
        return argmin_faces_plain(pts, planes, tile_variant, degenerate_tail,
                                  reduction, tile_f)
    from .. import _build

    out = torch.empty(pts.shape[:2], dtype=torch.int32, device=pts.device)
    _build.launch("closest_faces_every", pts.device, pts, planes, out,
                  *_grid(pts, planes, "closest_faces_every"),
                  TILE_VARIANTS.index(tile_variant),
                  int(bool(degenerate_tail)),
                  int(tile_f) if reduction == "fused" else 0)
    LAUNCHES["closest_faces_every"] += 1
    return out


def argmin_vertices_plain(pts, vplanes):
    """Plain PyTorch version of the ``nearest_vertices`` kernel: index of
    the nearest vertex per query, [B, Q] int32, lowest index on exact ties.
    ``pts`` [B, Q, 3] and ``vplanes`` [B, 3, V] float32, centered."""
    n_b, n_q = pts.shape[:2]
    out = torch.empty((n_b, n_q), dtype=torch.int32, device=pts.device)
    for b0, b1, q0, q1 in _chunks(n_b, n_q, vplanes.shape[-1], pts.device):
        p = pts[b0:b1, q0:q1]
        rows = [vplanes[b0:b1, k, None, :] for k in range(3)]
        cost = _vertex_sqdist_tile(p[..., 0:1], p[..., 1:2], p[..., 2:3],
                                   *rows)
        out[b0:b1, q0:q1] = torch.argmin(cost, dim=-1).to(torch.int32)
    return out


#: threads of a ``nearest_vertices`` block (csrc/nearest_vertices.cu
#: kThreads)
VERTEX_THREADS = 128

#: vertices of one shared-memory tile (kTile): a split gets at least one
VERTEX_TILE = 256

#: the most splits of the vertex axis, the blocks of one cluster
#: (kMaxSplit: above 8, a cluster size the H100 allows but does not
#: promise to other cards)
VERTEX_MAX_SPLIT = 16

#: the queries a thread that the kernel is built for (kPer)
VERTEX_PER_THREAD = (2, 4)


def vertex_plan(n_b, n_q, n_v, sms):
    """(queries a thread, splits of the vertex axis) of a
    ``nearest_vertices`` launch over ``n_b`` meshes x ``n_q`` queries x
    ``n_v`` vertices on a card of ``sms`` SMs.  The plans are the fastest
    of ``tools/vertex_plan_sweep.py`` on an H100 (PERF.md, row 2), by the
    query blocks of 2 queries a thread, ``n_b * ceil(n_q / 256)``: up to an
    eighth of the SMs (1 x 4096 x 6,890) 2 a thread and 12 splits; below
    one and a half times the SMs (8 to 48 x 1024) 2 a thread and 7
    splits; from there on, where the blocks fill the card (64 to 256 x
    1024), 4 a thread and 2 splits.  A split keeps at least
    ``VERTEX_TILE`` vertices."""
    blocks = n_b * -(-n_q // (2 * VERTEX_THREADS))
    if blocks <= sms // 8:
        per, split = 2, 12
    elif 2 * blocks < 3 * sms:
        per, split = 2, 7
    else:
        per, split = 4, 2
    return per, min(split, max(1, n_v // VERTEX_TILE))


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    """The SMs of the CUDA ``device``, which ``vertex_plan`` fills: read
    once a device, so that a call does not pay the lookup's host time
    (``tools/vertex_plan_sweep.py`` times both, ``host_us``)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def vertex_split_bounds(n_v, split):
    """The contiguous vertex range [v0, v1) of each of ``split`` splits, as
    the kernel cuts them: ``chunk = ceil(n_v / split)``, split s from
    ``min(n_v, s * chunk)``."""
    chunk = -(-n_v // split)
    out = []
    for s in range(split):
        v0 = min(n_v, s * chunk)
        out.append((v0, min(n_v, v0 + chunk)))
    return out


def vertex_keys(d, i):
    """The ``nearest_vertices`` merge's keys of distances ``d`` (float32)
    and indices ``i`` (int, 0 <= i < 2^31), as int64 that order as the
    kernel's unsigned 64-bit ``(bits(d) << 32) | i``: the top bit flipped,
    ``(int32(bits(d) ^ 0x80000000) << 32) + i``.  As unsigned integers,
    finite non-negative distances order as their values, below +inf,
    below every NaN; at an equal distance the lower index is the lower
    key."""
    bits = d.contiguous().view(torch.int32) ^ torch.tensor(
        -2 ** 31, dtype=torch.int32)
    return bits.to(torch.int64) * (1 << 32) + i.to(torch.int64)


def argmin_vertices_split_plain(pts, vplanes, split):
    """The ``nearest_vertices`` kernel's split and merge in plain PyTorch:
    each of ``split`` contiguous ranges (``vertex_split_bounds``) folded
    as the kernel's strict < from (+inf, 0) folds it (a NaN cost never
    taken; a range with no finite cost keeps (+inf, 0)), and the least of
    the ranges' ``vertex_keys``.  [B, Q] int32."""
    best = None
    for v0, v1 in vertex_split_bounds(vplanes.shape[-1], split):
        if v1 > v0:
            cost = _vertex_sqdist_tile(
                pts[..., 0:1], pts[..., 1:2], pts[..., 2:3],
                *[vplanes[:, k, None, v0:v1] for k in range(3)])
            cost = torch.where(torch.isnan(cost), float("inf"), cost)
            d, i = cost.min(dim=-1)
            i = torch.where(d < float("inf"), i + v0, torch.zeros_like(i))
        else:
            d = pts.new_full(pts.shape[:2], float("inf"))
            i = torch.zeros(pts.shape[:2], dtype=torch.int64,
                            device=pts.device)
        key = vertex_keys(d, i)
        best = key if best is None else torch.minimum(best, key)
    return (best & 0xffffffff).to(torch.int32)


def argmin_vertices(pts, vplanes, _plan=None):
    """Index of the nearest vertex per query: the ``nearest_vertices``
    CUDA kernel for CUDA tensors, its plain version for CPU tensors.
    ``_plan``, (queries a thread, splits), replaces ``vertex_plan``'s: a
    hook for the checks and the sweep that hold the kernel at each plan."""
    _check_operands(pts, vplanes, 3, "nearest_vertices")
    n_b, n_q, n_v = _grid(pts, vplanes, "nearest_vertices")
    if _plan is not None:
        per, split = (int(x) for x in _plan)
        if per not in VERTEX_PER_THREAD or not 1 <= split <= VERTEX_MAX_SPLIT:
            raise ValueError(
                "nearest_vertices: plan (%d, %d), not %s queries a thread "
                "and a split of 1 to %d" % (per, split, VERTEX_PER_THREAD,
                                            VERTEX_MAX_SPLIT))
    if pts.device.type == "cpu":
        return argmin_vertices_plain(pts, vplanes)
    if not n_q:
        return no_queries(n_b, pts.device)
    if _plan is None:
        per, split = vertex_plan(n_b, n_q, n_v, _sm_count(pts.device))
    from .. import _build

    out = torch.empty((n_b, n_q), dtype=torch.int32, device=pts.device)
    _build.launch("nearest_vertices", pts.device, pts, vplanes, out, n_b,
                  n_q, n_v, per, split)
    LAUNCHES["nearest_vertices"] += 1
    return out


def argmin_vertices_every(pts, vplanes):
    """``argmin_vertices`` through the ``nearest_vertices_every`` CUDA
    kernel, one query a thread over every vertex (the oracle; no path
    launches it), for CUDA tensors; the plain version for CPU tensors."""
    _check_operands(pts, vplanes, 3, "nearest_vertices_every")
    if pts.device.type == "cpu":
        return argmin_vertices_plain(pts, vplanes)
    from .. import _build

    out = torch.empty(pts.shape[:2], dtype=torch.int32, device=pts.device)
    _build.launch("nearest_vertices_every", pts.device, pts, vplanes, out,
                  *_grid(pts, vplanes, "nearest_vertices_every"))
    LAUNCHES["nearest_vertices_every"] += 1
    return out


# ---------------------------------------------------------------------------
# Whole queries: prologue, argmin, epilogue.

def closest_point_operands(v, f, points, tile_variant="fast"):
    """The prologue of a batched query: (pts [B, Q, 3], planes [B, 19, F],
    tri [B, F, 3, 3], center [B, 1, 3]), all float32 and centered on each
    mesh's vertex mean; ``pts`` and ``planes`` are the kernel's operands."""
    _check_variant(tile_variant)
    pts, center, tri = _center_inputs(v, f, points)
    return pts.contiguous(), face_planes(tri, tile_variant), tri, center


def _closest_point(v, f, points, assume_nondegenerate, tile_variant,
                   reduction, tile_f, argmin):
    _check_reduction(reduction, tile_f)
    vb, pb, unbatch = _batched(v, points)
    pts, planes, tri, center = closest_point_operands(vb, f, pb, tile_variant)
    best = argmin(pts, planes, tile_variant, not assume_nondegenerate,
                  reduction, tile_f)
    res = winner_epilogue(best, tri, pts, center)
    if unbatch:
        res = {key: val[0] for key, val in res.items()}
    return res


def closest_point_kernel(v, f, points, *, assume_nondegenerate=False,
                         tile_variant="fast", reduction="exact",
                         tile_f=FUSED_TILE_F):
    """Closest face, part code, point and squared distance per query.

    ``v`` [V, 3] with ``points`` [Q, 3], or a batch ``v`` [B, V, 3] with
    ``points`` [B, Q, 3] (one kernel launch for the whole batch); ``f``
    [F, 3] shared.  Returns a dict of ``face`` [..., Q] int32, ``part``
    [..., Q] int32, ``point`` [..., Q, 3] and ``sqdist`` [..., Q].

    ``assume_nondegenerate=True`` drops the degenerate-face tail; it is
    valid only when ``mesh_is_nondegenerate`` says so.
    ``tile_variant="safe"`` selects the sliver-safe tile.
    ``reduction="fused"`` selects the fused packed-key reduction over face
    tiles of ``tile_f`` (a power of two; module docstring), as the
    reference's ``closest_point_pallas(reduction="fused")``.  The tensors'
    device chooses: the CUDA kernel on the card, its plain version on the
    CPU.
    """
    return _closest_point(v, f, points, assume_nondegenerate, tile_variant,
                          reduction, tile_f, argmin_faces)


def closest_point_plain(v, f, points, *, assume_nondegenerate=False,
                        tile_variant="fast", reduction="exact",
                        tile_f=FUSED_TILE_F):
    """``closest_point_kernel`` with the plain argmin on any device."""
    return _closest_point(v, f, points, assume_nondegenerate, tile_variant,
                          reduction, tile_f, argmin_faces_plain)


def _nearest_vertices(v, points, argmin):
    vb, pb, unbatch = _batched(v, points)
    vb = vb.to(torch.float32)
    center = vb.mean(dim=-2, keepdim=True)
    vc = vb - center
    pts = (pb.to(torch.float32) - center).contiguous()
    best = argmin(pts, vc.transpose(-1, -2).contiguous())
    rows = torch.arange(best.shape[0], device=best.device)[:, None]
    diff = pts - vc[rows, best.long()]
    dist = (diff * diff).sum(dim=-1).sqrt()
    if unbatch:
        return best[0], dist[0]
    return best, dist


def nearest_vertices_kernel(v, points):
    """Nearest mesh vertex per query -> (index [..., Q] int32, distance
    [..., Q]); shapes as ``closest_point_kernel``.  The CUDA kernel on the
    card, its plain version on the CPU."""
    return _nearest_vertices(v, points, argmin_vertices)


def nearest_vertices_plain(v, points):
    """``nearest_vertices_kernel`` with the plain argmin on any device."""
    return _nearest_vertices(v, points, argmin_vertices_plain)
