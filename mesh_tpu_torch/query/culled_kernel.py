"""Sphere-culled closest face: the ``culled_faces`` CUDA kernel's wrapper,
its plain PyTorch version, and the prologue and epilogue around them
(counterpart of mesh_tpu/query/pallas_culled.py).

Prologue, per mesh of a batch (``culled_operands``): faces Morton-sorted by
centroid and queries by position, both edge-padded (repeated real rows,
no sentinels) to whole tiles, so that each tile of ``tile_q`` queries and
``tile_f`` faces is spatially compact; a bounding sphere per tile; and a
per-query seed, the least over 128-face sub-tiles of (distance to the
sub-tile's sphere + its radius) squared and inflated by ``_MARGIN``, an
upper bound on the query's closest squared distance.

Kernel (``csrc/culled_faces.cu``): per query tile, the face tiles in
order; a face tile is skipped when the sphere-to-sphere lower bound,
shrunk by ``_MARGIN`` and squared, exceeds the tile's worst running best.
Inside a tested tile each query culls per chunk of ``_SUB`` faces (the
seeds' sub-tiles; the whole tile when ``tile_f`` is not a multiple of
``_SUB``) by the same bound with a query radius of 0 against its own
running best, and a warp of 32 queries tests a chunk when one of them
needs it; a tested chunk runs the fast or sliver-safe 19-plane Ericson
tile of ``closest_kernel`` and merges with a strict ``<``.  The answer is a
position in the sorted face order; ties go to the lowest sorted position,
which ``face_ids`` maps back to an original face id (not always the lowest
one).  The kernel also returns the face tiles each query tile tested
and, on request, the chunks each of its warps tested and the real faces
each query folded in (its own lane's work).

Epilogue: the winner's sorted position -> original face, sorted query
order -> the caller's, and the exact point, squared distance and part code
recomputed on the winner (``closest_kernel.winner_epilogue``).

``argmin_culled`` launches the kernel for CUDA tensors and takes its plain
version (``argmin_culled_plain``) for CPU tensors; ``LAUNCHES`` counts the
kernel's launches.  The plain version walks the same face tiles and chunks
with the same bounds in float32, op for op, so on the card both pick the
same faces.  ``argmin_culled_tile_plain`` is the reference's design, every
face of each tested tile; the chunk cull changes no face (the margin
argument of ``csrc/culled_faces.cu``).
"""

import torch

from .closest_kernel import (
    N_FACE_ROWS,
    WARP,
    _PLAIN_PAIRS,
    _batched,
    _center_inputs,
    _check_variant,
    _sqdist_tile_fast,
    _sqdist_tile_safe,
    face_planes,
    no_queries,
    winner_epilogue,
)

#: launches of the culled CUDA kernel since the count was last set to 0
LAUNCHES = {"culled_faces": 0}

_SUB = 128          # sub-tile size for the seed upper bound
_MARGIN = 1e-3      # relative safety margin on seeds / lower bounds

#: the reference's float32 factors (1 - _MARGIN) and (1 + _MARGIN)
_SHRINK = 1.0 - _MARGIN
_GROW = 1.0 + _MARGIN

#: seed-matrix entries (queries x sub-tiles) one prologue chunk computes
_SEED_ELEMS = 1 << 24

_TILES = {"fast": _sqdist_tile_fast, "safe": _sqdist_tile_safe}


def _warp_any(x, dim):
    """Whether any of each WARP consecutive entries of bool ``x`` along
    ``dim`` holds (the last group padded with False): the vote of each
    warp of 32 lanes."""
    x = x.movedim(dim, -1)
    pad = (-x.shape[-1]) % WARP
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
    return x.reshape(x.shape[:-1] + (-1, WARP)).any(dim=-1).movedim(-1, dim)


# ---------------------------------------------------------------------------
# Prologue pieces (the numpy builder in accel/build.py has its own twins).

def _part1by2(x):
    """Spread the low 10 bits of x two apart (int64 tensors)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


#: per device, ``_part1by2`` of 0 .. 1023 shifted for x, y and z: [1024, 3]
_SPREAD = {}


def _morton_codes(xyz, box=None):
    """30-bit Morton code per row of xyz [..., N, 3], each set normalized
    to its own bounding box (or to ``box`` = (lo, hi) [..., 1, 3], rows
    outside it clamped to its faces), in float32 as the reference computes
    it; int64 codes.  The bit spreading is a lookup in ``_SPREAD``, so a
    call is a handful of launches; the low 10 bits index it, as
    ``_part1by2`` reads them (a NaN coordinate casts to some integer)."""
    spread = _SPREAD.get(xyz.device)
    if spread is None:
        ramp = torch.arange(1024, dtype=torch.int64, device=xyz.device)
        spread = _SPREAD[xyz.device] = torch.stack(
            [_part1by2(ramp) << 2, _part1by2(ramp) << 1, _part1by2(ramp)], 1)
    if not xyz.shape[-2]:
        return torch.zeros(xyz.shape[:-1], dtype=torch.int64,
                           device=xyz.device)
    if box is None:
        box = (xyz.amin(dim=-2, keepdim=True), xyz.amax(dim=-2, keepdim=True))
    lo = box[0]
    span = torch.clamp_min(box[1] - lo, 1e-30)
    q = torch.clamp((xyz - lo) / span * 1023.0, 0.0, 1023.0).to(torch.int64)
    return torch.gather(spread.expand(q.shape[:-2] + spread.shape), -2,
                        q & 0x3FF).sum(dim=-1)


def morton_face_order(tri):
    """The order of triangles ``tri`` [..., F, 3, 3] (F > 0) by the Morton
    code of their centroids (stable), per mesh of a batch: the face order
    of the culled, self-intersection and culled any-hit kernels."""
    return torch.argsort(_morton_codes(tri.mean(dim=-2)), dim=-1, stable=True)


def _pad_rows_edge(x, multiple, dim=0):
    """Pad ``x`` along ``dim`` to a multiple of ``multiple`` by repeating
    its last row."""
    pad = (-x.shape[dim]) % multiple
    if not pad:
        return x
    last = x.narrow(dim, x.shape[dim] - 1, 1)
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, last.expand(shape)], dim=dim)


def _tile_spheres(pts, tile):
    """Bounding sphere (center [..., G, 3], radius [..., G]) of each
    contiguous tile of ``tile`` rows of pts [..., N, 3]."""
    t = pts.reshape(*pts.shape[:-2], pts.shape[-2] // tile, tile,
                    pts.shape[-1])
    cen = t.mean(dim=-2)
    diff = t - cen[..., None, :]
    rad = torch.sqrt((diff * diff).sum(dim=-1).amax(dim=-1))
    return cen, rad


def _sorted_rows(x, order):
    """x [B, N, ...] gathered along dim 1 by order [B, N]."""
    idx = order.reshape(order.shape + (1,) * (x.ndim - 2))
    return torch.gather(x, 1, idx.expand(order.shape + x.shape[2:]))


def _seeds(pts_s, sc, sr):
    """Prologue step 4, the per-query seed [B, Qp]: the least over chunks
    (centers ``sc`` [B, C, 3], radii ``sr`` [B, C]) of (distance to the
    chunk's center + its radius), squared and inflated, computed in chunks
    of queries (each chunk gives the same values)."""
    n_b, n_q = pts_s.shape[:2]
    step = max(1, _SEED_ELEMS // max(1, sc.shape[1]))
    seed = torch.empty((n_b, n_q), dtype=torch.float32, device=pts_s.device)
    for b in range(n_b):
        for q0 in range(0, n_q, step):
            diff = pts_s[b, q0:q0 + step, None, :] - sc[b][None]
            d = torch.sqrt((diff * diff).sum(dim=-1)) + sr[b][None]
            m = d.amin(dim=1)
            seed[b, q0:q0 + step] = m * m * _GROW + 1e-12
    return seed


def prologue_orders(tri, pts):
    """Prologue step 1: the Morton orders [B, F] of the faces ``tri``
    [B, F, 3, 3] (by centroid) and [B, Q] of the queries ``pts``
    [B, Q, 3]."""
    return (morton_face_order(tri),
            torch.argsort(_morton_codes(pts), dim=1, stable=True))


def prologue_gathers(tri, pts, forder, qorder, tile_q, tile_f):
    """Prologue step 2: faces, their ids and queries in those orders,
    edge-padded to whole tiles: (tri_s [B, Fp, 3, 3], face_ids [B, Fp]
    int32, pts_s [B, Qp, 3])."""
    return (_pad_rows_edge(_sorted_rows(tri, forder), tile_f, dim=1),
            _pad_rows_edge(forder.to(torch.int32), tile_f, dim=1),
            _pad_rows_edge(_sorted_rows(pts, qorder), tile_q, dim=1)
            .contiguous())


def prologue_spheres(tri_s, pts_s, tile_q, tile_f):
    """Prologue step 3: the bounding spheres (center [B, G, 3], radius
    [B, G]) of the face tiles, of the chunks (``chunk_faces``) and of the
    query tiles."""
    corners = tri_s.reshape(tri_s.shape[0], -1, 3)
    return (_tile_spheres(corners, tile_f * 3),
            _tile_spheres(corners, chunk_faces(tile_f) * 3),
            _tile_spheres(pts_s, tile_q))


def _prologue(vc, f, pts, tile_q, tile_f):
    """Morton sort, edge padding, tile spheres and seeds for a batch of
    centered meshes ``vc`` [B, V, 3] sharing faces ``f`` [F, 3], with
    centered queries ``pts`` [B, Q, 3]: the corner gather, then
    ``prologue_orders``, ``prologue_gathers``, ``prologue_spheres`` and
    ``_seeds``."""
    tri = vc[:, f.long()]                                     # [B, F, 3, 3]
    forder, qorder = prologue_orders(tri, pts)
    tri_s, face_ids, pts_s = prologue_gathers(tri, pts, forder, qorder,
                                              tile_q, tile_f)
    (fc, fr), (sc, sr), (qc, qr) = prologue_spheres(tri_s, pts_s, tile_q,
                                                    tile_f)
    return {
        "tri_s": tri_s, "face_ids": face_ids, "fc": fc, "fr": fr,
        "qorder": qorder, "pts_s": pts_s, "qc": qc, "qr": qr,
        "sc": sc, "sr": sr, "seed": _seeds(pts_s, sc, sr),
    }


def chunk_faces(tile_f):
    """Faces per chunk of the kernel's cull and of the seeds' sub-tile
    spheres: ``_SUB``, or the whole face tile when ``tile_f`` is not a
    multiple of it."""
    return _SUB if tile_f % _SUB == 0 else tile_f


def culled_operands(v, f, points, tile_variant="fast", tile_q=256,
                    tile_f=1024):
    """The prologue of a batched culled query: ``v`` [B, V, 3], shared
    ``f`` [F, 3], ``points`` [B, Q, 3] -> dict of the kernel's operands
    (``pts_s`` [B, Qp, 3], ``seed`` [B, Qp], ``qsph`` [B, Qp/tile_q, 4],
    ``fsph`` [B, Fp/tile_f, 4], ``csph`` [B, Fp/chunk, 4] the chunk
    spheres, ``planes`` [B, 19, Fp], ``n_faces`` F) and what the epilogue
    needs (``face_ids``, ``qorder``, ``tri``, ``pts``, ``center``), all
    centered on each mesh's vertex mean: ``_center_inputs``, ``_prologue``
    and ``face_planes``."""
    _check_variant(tile_variant)
    pts, center, tri = _center_inputs(v, f, points)
    pro = _prologue(v.to(torch.float32) - center, f, pts, tile_q, tile_f)
    return {
        "pts_s": pro["pts_s"],
        "seed": pro["seed"],
        "qsph": torch.cat([pro["qc"], pro["qr"][..., None]], -1).contiguous(),
        "fsph": torch.cat([pro["fc"], pro["fr"][..., None]], -1).contiguous(),
        "csph": torch.cat([pro["sc"], pro["sr"][..., None]], -1).contiguous(),
        "planes": face_planes(pro["tri_s"], tile_variant),
        "n_faces": f.shape[0], "face_ids": pro["face_ids"],
        "qorder": pro["qorder"], "tri": tri, "pts": pts, "center": center,
        "tile_q": tile_q, "tile_f": tile_f,
    }


# ---------------------------------------------------------------------------
# The culled argmin: plain version, and the wrapper that launches the kernel.

def _check_culled(ops):
    pts_s, seed, qsph, fsph, csph, planes = (ops[k] for k in (
        "pts_s", "seed", "qsph", "fsph", "csph", "planes"))
    tile_q, tile_f = ops["tile_q"], ops["tile_f"]
    tensors = (pts_s, seed, qsph, fsph, csph, planes)
    if any(t.device != pts_s.device for t in tensors):
        raise ValueError("culled_faces: operands on several devices")
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           for t in tensors):
        raise ValueError("culled_faces wants contiguous float32 operands")
    n_b, q_pad = seed.shape
    f_pad = planes.shape[-1]
    if (pts_s.shape != (n_b, q_pad, 3) or q_pad % tile_q or f_pad % tile_f
            or not 0 < ops["n_faces"] <= f_pad
            or qsph.shape != (n_b, q_pad // tile_q, 4)
            or fsph.shape != (n_b, f_pad // tile_f, 4)
            or csph.shape != (n_b, f_pad // chunk_faces(tile_f), 4)
            or planes.shape[:2] != (n_b, N_FACE_ROWS)):
        raise ValueError("culled_faces: operand shapes %s do not fit tiles "
                         "(%d, %d)" % ([tuple(t.shape) for t in tensors],
                                       tile_q, tile_f))
    if pts_s.device.type not in ("cpu", "cuda"):
        raise ValueError("culled_faces: no kernel for device %s"
                         % pts_s.device)
    if pts_s.device.type == "cuda" and chunk_faces(tile_f) > _SUB:
        raise ValueError("culled_faces: the kernel stages chunks of at most "
                         "%d faces; tile_f %d is neither a multiple of %d "
                         "nor at most it" % (_SUB, tile_f, _SUB))


def _tile_take(qsph, fsph, j, worst):
    """[B, n_qt] bool: the query tiles whose block test takes face tile j
    (the sphere-to-sphere bound, shrunk and squared, against the tile's
    worst running best)."""
    fs = fsph[:, j, None, :]                                  # [B, 1, 4]
    dx = qsph[..., 0] - fs[..., 0]
    dy = qsph[..., 1] - fs[..., 1]
    dz = qsph[..., 2] - fs[..., 2]
    dist = torch.sqrt(dx * dx + dy * dy + dz * dz)
    lb = torch.clamp_min(dist - qsph[..., 3] - fs[..., 3], 0.0) * _SHRINK
    return lb * lb <= worst


def _tile_cost(tile, p, planes, rows_b, rows_t, j, tile_f, degenerate_tail):
    """Costs [n, TQ, TF] of the query tiles (rows_b, rows_t) against face
    tile j."""
    q = p[rows_b, rows_t]                                     # [n, TQ, 3]
    rows = planes[rows_b, :, j * tile_f:(j + 1) * tile_f]     # [n, 19, TF]
    return tile(q[..., 0:1], q[..., 1:2], q[..., 2:3],
                *[rows[:, k, None, :] for k in range(N_FACE_ROWS)],
                degenerate_tail=degenerate_tail)


def _merge(acc_d, acc_i, bi, ti, cost, offset, take=None):
    """Fold costs [n, TQ, C] (faces offset .. offset + C - 1) into the
    running (acc_d, acc_i) of query tiles (bi, ti): the first minimum,
    merged with a strict < (only where ``take``)."""
    arg = torch.argmin(cost, dim=-1)
    c_min = torch.gather(cost, -1, arg[..., None])[..., 0]
    cur_d, cur_i = acc_d[bi, ti], acc_i[bi, ti]
    better = c_min < cur_d
    if take is not None:
        better &= take
    acc_d[bi, ti] = torch.where(better, c_min, cur_d)
    acc_i[bi, ti] = torch.where(better, (arg + offset).to(torch.int32),
                                cur_i)


def _culled_state(ops):
    seed = ops["seed"]
    tile_q, tile_f = ops["tile_q"], ops["tile_f"]
    n_b, q_pad = seed.shape
    n_qt, n_ft = q_pad // tile_q, ops["planes"].shape[-1] // tile_f
    acc_d = seed.view(n_b, n_qt, tile_q).clone()
    return (ops["pts_s"].view(n_b, n_qt, tile_q, 3), acc_d,
            torch.zeros_like(acc_d, dtype=torch.int32),
            torch.zeros((n_b, n_qt), dtype=torch.int32, device=seed.device),
            n_ft, max(1, _PLAIN_PAIRS[seed.device.type] // (tile_q * tile_f)))


def argmin_culled_tile_plain(ops, tile_variant="fast", degenerate_tail=True):
    """The reference's design in plain PyTorch, every face of each tested
    face tile: (sorted face position per query [B, Qp] int32, face tiles
    tested per query tile [B, Qp/tile_q] int32).  The kernel's design
    (``argmin_culled_plain``) gives the same faces and tile counts."""
    _check_variant(tile_variant)
    tile = _TILES[tile_variant]
    p, acc_d, acc_i, visits, n_ft, per = _culled_state(ops)
    tile_f = ops["tile_f"]
    worst = acc_d.amax(dim=-1)
    for j in range(n_ft):
        take = _tile_take(ops["qsph"], ops["fsph"], j, worst)
        rows_b, rows_t = take.nonzero(as_tuple=True)
        if not rows_b.numel():
            continue
        visits += take.to(torch.int32)
        for c0 in range(0, rows_b.numel(), per):
            bi, ti = rows_b[c0:c0 + per], rows_t[c0:c0 + per]
            _merge(acc_d, acc_i, bi, ti, _tile_cost(
                tile, p, ops["planes"], bi, ti, j, tile_f, degenerate_tail),
                j * tile_f)
        worst = acc_d.amax(dim=-1)
    return acc_i.view(acc_i.shape[0], -1), visits


def chunk_lb2(pts, csph):
    """Squared lower bounds [..., Q, C] from queries [..., Q, 3] to chunk
    spheres [..., C, 4] (csrc/culled_faces.cu chunk_lb2): the reference's
    sphere bound with a query radius of 0, max(|p - c| - r, 0) shrunk by
    ``_MARGIN``; ``fmax`` maps a NaN distance to 0, as the kernel's fmaxf
    does."""
    dx = pts[..., :, None, 0] - csph[..., None, :, 0]
    dy = pts[..., :, None, 1] - csph[..., None, :, 1]
    dz = pts[..., :, None, 2] - csph[..., None, :, 2]
    dist = torch.sqrt(dx * dx + dy * dy + dz * dz)
    lb = torch.fmax(dist - csph[..., None, :, 3],
                    torch.zeros((), dtype=dist.dtype, device=dist.device))
    lb = lb * _SHRINK
    return lb * lb


def argmin_culled_plain(ops, tile_variant="fast", degenerate_tail=True):
    """Plain PyTorch version of the ``culled_faces`` kernel on the operand
    dict of ``culled_operands`` -> (sorted face position per query
    [B, Qp] int32, face tiles tested per query tile [B, Qp/tile_q] int32,
    chunks tested per warp [B, Qp/tile_q, tile_q/32] int32, real faces
    folded per query [B, Qp] int32).

    The block test of each face tile as in ``argmin_culled_tile_plain``;
    inside a taken tile the chunks in order, each folded into the queries
    whose bound ``chunk_lb2`` is at most their running best, counted for
    each warp holding such a query and, by its real (unpadded) faces, for
    each such query."""
    _check_variant(tile_variant)
    tile = _TILES[tile_variant]
    p, acc_d, acc_i, visits, n_ft, per = _culled_state(ops)
    tile_q, tile_f = ops["tile_q"], ops["tile_f"]
    chunk = chunk_faces(tile_f)
    n_b, n_qt = visits.shape
    dev = visits.device
    chunks = torch.zeros((n_b, n_qt, -(-tile_q // WARP)), dtype=torch.int32,
                         device=dev)
    pairs = torch.zeros_like(acc_i)
    real = torch.clamp(ops["n_faces"] - chunk * torch.arange(
        ops["csph"].shape[1], device=dev), 0, chunk).to(torch.int32)
    worst = acc_d.amax(dim=-1)
    for j in range(n_ft):
        take = _tile_take(ops["qsph"], ops["fsph"], j, worst)
        rows_b, rows_t = take.nonzero(as_tuple=True)
        if not rows_b.numel():
            continue
        visits += take.to(torch.int32)
        k0 = j * (tile_f // chunk)
        for c0 in range(0, rows_b.numel(), per):
            bi, ti = rows_b[c0:c0 + per], rows_t[c0:c0 + per]
            cost = _tile_cost(tile, p, ops["planes"], bi, ti, j, tile_f,
                              degenerate_tail)
            lb2 = chunk_lb2(p[bi, ti], ops["csph"][
                bi, k0:k0 + tile_f // chunk])                 # [n, TQ, C]
            for k in range(tile_f // chunk):
                need = lb2[..., k] <= acc_d[bi, ti]
                chunks[bi, ti] += _warp_any(need, -1).to(torch.int32)
                pairs[bi, ti] += need * real[k0 + k]
                _merge(acc_d, acc_i, bi, ti,
                       cost[..., k * chunk:(k + 1) * chunk],
                       j * tile_f + k * chunk, take=need)
        worst = acc_d.amax(dim=-1)
    return acc_i.view(n_b, -1), visits, chunks, pairs.view(n_b, -1)


def argmin_culled(ops, tile_variant="fast", degenerate_tail=True,
                  with_stats=False):
    """(sorted face position per query, face tiles tested per query tile):
    the ``culled_faces`` CUDA kernel for CUDA operands, its plain version
    for CPU operands.  ``with_stats`` also returns the chunks tested per
    warp and the real faces folded per query, as ``argmin_culled_plain``
    does."""
    _check_variant(tile_variant)
    _check_culled(ops)
    if ops["seed"].device.type == "cpu":
        out = argmin_culled_plain(ops, tile_variant, degenerate_tail)
        return out if with_stats else out[:2]
    from .. import _build

    n_b, q_pad = ops["seed"].shape
    tile_q, tile_f = ops["tile_q"], ops["tile_f"]
    dev = ops["seed"].device
    if not q_pad:
        out = no_queries(n_b, dev, 2)
        if with_stats:
            out += (torch.empty((n_b, 0, tile_q // WARP), dtype=torch.int32,
                                device=dev), no_queries(n_b, dev))
        return out
    out = torch.empty((n_b, q_pad), dtype=torch.int32, device=dev)
    visits = torch.empty((n_b, q_pad // tile_q), dtype=torch.int32,
                         device=dev)
    stats = ((torch.empty((n_b, q_pad // tile_q, tile_q // WARP),
                          dtype=torch.int32, device=dev),
              torch.empty((n_b, q_pad), dtype=torch.int32, device=dev))
             if with_stats else (None, None))
    _build.launch("culled_faces", dev, ops["pts_s"], ops["seed"],
                  ops["qsph"], ops["fsph"], ops["csph"], ops["planes"], out,
                  visits, *stats, n_b, ops["n_faces"], q_pad,
                  ops["planes"].shape[-1], tile_q, tile_f,
                  chunk_faces(tile_f), ("fast", "safe").index(tile_variant),
                  int(bool(degenerate_tail)))
    LAUNCHES["culled_faces"] += 1
    return (out, visits) + stats if with_stats else (out, visits)


def culled_epilogue(ops, best_sorted):
    """Sorted face positions [B, Qp] -> the closest_faces_and_points
    result dict of the batch, in the caller's query order."""
    ids = torch.gather(ops["face_ids"], 1, best_sorted.long())
    n_q = ops["qorder"].shape[1]
    best = torch.empty_like(ops["qorder"])
    best.scatter_(1, ops["qorder"], ids[:, :n_q].long())
    return winner_epilogue(best.to(torch.int32), ops["tri"], ops["pts"],
                           ops["center"])


# ---------------------------------------------------------------------------
# Whole queries.

def _closest_point_culled(v, f, points, assume_nondegenerate, tile_variant,
                          tile_q, tile_f, argmin):
    vb, pb, unbatch = _batched(v, points)
    ops = culled_operands(vb, f, pb, tile_variant, tile_q, tile_f)
    best = argmin(ops, tile_variant, not assume_nondegenerate)[0]
    res = culled_epilogue(ops, best)
    if unbatch:
        res = {key: val[0] for key, val in res.items()}
    return res


def closest_point_culled_kernel(v, f, points, *, assume_nondegenerate=False,
                                tile_variant="fast", tile_q=256,
                                tile_f=1024):
    """Closest face, part code, point and squared distance per query,
    through the sphere-culled kernel; exact up to distance ties.

    ``v`` [V, 3] with ``points`` [Q, 3], or a batch ``v`` [B, V, 3] with
    ``points`` [B, Q, 3] (one launch for the whole batch); ``f`` [F, 3]
    shared.  Returns the dict of ``closest_kernel.closest_point_kernel``.
    ``assume_nondegenerate=True`` drops the degenerate-face tail (valid
    only when ``mesh_is_nondegenerate`` says so); ``tile_variant="safe"``
    selects the sliver-safe tile.  ``tile_q`` (a multiple of 32, at most
    1024, on the card) and ``tile_f`` decide which tiles are skipped, not
    the answer.  The tensors' device chooses: the CUDA kernel on the card,
    its plain version on the CPU."""
    return _closest_point_culled(v, f, points, assume_nondegenerate,
                                 tile_variant, tile_q, tile_f, argmin_culled)


def closest_point_culled_plain(v, f, points, *, assume_nondegenerate=False,
                               tile_variant="fast", tile_q=256, tile_f=1024):
    """``closest_point_culled_kernel`` with the plain argmin on any
    device."""
    return _closest_point_culled(v, f, points, assume_nondegenerate,
                                 tile_variant, tile_q, tile_f,
                                 argmin_culled_plain)
