"""Brute-force closest face and nearest vertex: the CUDA kernels' wrappers,
their plain PyTorch versions, and the prologue and epilogue around them
(counterpart of mesh_tpu/query/pallas_closest.py).

Two kernels, one argmin scaffold (``csrc/argmin.cuh``):

- ``closest_faces`` (``csrc/closest_faces.cu``): for each query, the face
  with the least Ericson squared distance, computed from 19 per-face
  planes hoisted out of the scan (``fast_tile_rows`` / ``safe_tile_rows``).
  Four instantiations: the fast or the sliver-safe tile, with or without
  the degenerate-face tail.
- ``nearest_vertices`` (``csrc/nearest_vertices.cu``): for each query, the
  nearest mesh vertex.

Both keep a running (distance, index) pair per query and take a face only
when it is strictly closer, walking faces in increasing order, so the
lowest index wins an exact tie, as the reference's argmin does.

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
both pick the same faces on the card.
"""

import hashlib

import numpy as np
import torch

from ..geometry.cross_product import cross3
from ..utils.knobs import safe_tiles
from .point_triangle import closest_point_on_triangle

#: number of per-face planes of either tile
N_FACE_ROWS = 19

#: launches of each CUDA kernel since the counts were last set to 0
LAUNCHES = {"closest_faces": 0, "closest_faces_fused": 0,
            "nearest_vertices": 0}

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


def _center_inputs(v, f, points):
    """Shared query prologue: float32 cast, centering on the per-mesh
    vertex mean (the float32 conditioning every kernel relies on), face
    corner gather.  ``v`` [B, V, 3], ``points`` [B, Q, 3] ->
    (points, center, tri), centered."""
    v = v.to(torch.float32)
    center = v.mean(dim=-2, keepdim=True)
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
# The argmin steps: plain version, and the wrapper that launches the kernel.

def _chunks(n_b, n_q, n_cols, device):
    """(b0, b1, q0, q1) blocks of at most _PLAIN_PAIRS pairs each."""
    budget = _PLAIN_PAIRS[device.type]
    if n_q * n_cols <= budget:
        nb, nq = max(1, budget // max(1, n_q * n_cols)), n_q
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


def argmin_faces(pts, planes, tile_variant="fast", degenerate_tail=True,
                 reduction="exact", tile_f=FUSED_TILE_F):
    """Index of the closest face per query: the ``closest_faces`` CUDA
    kernel for CUDA tensors, its plain version for CPU tensors."""
    _check_variant(tile_variant)
    _check_reduction(reduction, tile_f)
    _check_operands(pts, planes, N_FACE_ROWS, "closest_faces")
    if pts.device.type == "cpu":
        return argmin_faces_plain(pts, planes, tile_variant, degenerate_tail,
                                  reduction, tile_f)
    from .. import _build

    fused = reduction == "fused"
    out = torch.empty(pts.shape[:2], dtype=torch.int32, device=pts.device)
    _build.launch("closest_faces", pts.device, pts, planes, out,
                  *_grid(pts, planes, "closest_faces"),
                  TILE_VARIANTS.index(tile_variant), int(bool(degenerate_tail)),
                  int(tile_f) if fused else 0)
    LAUNCHES["closest_faces_fused" if fused else "closest_faces"] += 1
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


def argmin_vertices(pts, vplanes):
    """Index of the nearest vertex per query: the ``nearest_vertices``
    CUDA kernel for CUDA tensors, its plain version for CPU tensors."""
    _check_operands(pts, vplanes, 3, "nearest_vertices")
    if pts.device.type == "cpu":
        return argmin_vertices_plain(pts, vplanes)
    from .. import _build

    out = torch.empty(pts.shape[:2], dtype=torch.int32, device=pts.device)
    _build.launch("nearest_vertices", pts.device, pts, vplanes, out,
                  *_grid(pts, vplanes, "nearest_vertices"))
    LAUNCHES["nearest_vertices"] += 1
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
