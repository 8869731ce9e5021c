"""Sphere-culled closest face: the ``culled_faces`` CUDA kernel's wrapper,
its plain PyTorch version, and the prologue and epilogue around them
(counterpart of mesh_tpu/query/pallas_culled.py).

Prologue, per mesh of a batch (``_prologue``): faces Morton-sorted by
centroid and queries by position, both edge-padded (repeated real rows,
no sentinels) to whole tiles, so that each tile of ``tile_q`` queries and
``tile_f`` faces is spatially compact; a bounding sphere per tile; and a
per-query seed, the least over 128-face sub-tiles of (distance to the
sub-tile's sphere + its radius) squared and inflated by ``_MARGIN``, an
upper bound on the query's closest squared distance.

Kernel (``csrc/culled_faces.cu``): per query tile, the face tiles in
order; a face tile is skipped when the sphere-to-sphere lower bound,
shrunk by ``_MARGIN`` and squared, exceeds the tile's worst running best;
a tested tile runs the fast or sliver-safe 19-plane Ericson tile of
``closest_kernel`` and merges with a strict ``<``.  The answer is a
position in the sorted face order; ties go to the lowest sorted position,
which ``face_ids`` maps back to an original face id (not always the lowest
one).  The kernel also returns the face tiles each query tile tested.

Epilogue: the winner's sorted position -> original face, sorted query
order -> the caller's, and the exact point, squared distance and part code
recomputed on the winner (``closest_kernel.winner_epilogue``).

``argmin_culled`` launches the kernel for CUDA tensors and takes its plain
version (``argmin_culled_plain``) for CPU tensors; ``LAUNCHES`` counts the
kernel's launches.  The plain version walks the same face tiles with the
same bounds in float32, op for op, so on the card both pick the same faces.
"""

import torch

from .closest_kernel import (
    N_FACE_ROWS,
    _PLAIN_PAIRS,
    _batched,
    _center_inputs,
    _check_variant,
    _sqdist_tile_fast,
    _sqdist_tile_safe,
    face_planes,
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


def _morton_codes(xyz):
    """30-bit Morton code per row of xyz [..., N, 3], each set normalized
    to its own bounding box, in float32 as the reference computes it;
    int64 codes."""
    lo = xyz.amin(dim=-2, keepdim=True)
    span = torch.clamp_min(xyz.amax(dim=-2, keepdim=True) - lo, 1e-30)
    q = torch.clamp((xyz - lo) / span * 1023.0, 0.0, 1023.0).to(torch.int64)
    return ((_part1by2(q[..., 0]) << 2) | (_part1by2(q[..., 1]) << 1)
            | _part1by2(q[..., 2]))


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
    t = pts.reshape(*pts.shape[:-2], -1, tile, pts.shape[-1])
    cen = t.mean(dim=-2)
    diff = t - cen[..., None, :]
    rad = torch.sqrt((diff * diff).sum(dim=-1).amax(dim=-1))
    return cen, rad


def _sorted_rows(x, order):
    """x [B, N, ...] gathered along dim 1 by order [B, N]."""
    idx = order.reshape(order.shape + (1,) * (x.ndim - 2))
    return torch.gather(x, 1, idx.expand(order.shape + x.shape[2:]))


def _seeds(pts_s, sc, sr):
    """Per-query seed [B, Qp]: the least over sub-tiles of (distance to
    the sub-tile center + its radius), squared and inflated, computed in
    chunks of queries (each chunk gives the same values)."""
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


def _prologue(vc, f, pts, tile_q, tile_f):
    """Morton sort, edge padding, tile spheres and seeds for a batch of
    centered meshes ``vc`` [B, V, 3] sharing faces ``f`` [F, 3], with
    centered queries ``pts`` [B, Q, 3]."""
    tri = vc[:, f.long()]                                     # [B, F, 3, 3]
    forder = torch.argsort(_morton_codes(tri.mean(dim=2)), dim=1, stable=True)
    tri_s = _pad_rows_edge(_sorted_rows(tri, forder), tile_f, dim=1)
    face_ids = _pad_rows_edge(forder.to(torch.int32), tile_f, dim=1)

    corners = tri_s.reshape(tri_s.shape[0], -1, 3)
    fc, fr = _tile_spheres(corners, tile_f * 3)
    sub = _SUB if tile_f % _SUB == 0 else tile_f
    sc, sr = _tile_spheres(corners, sub * 3)

    qorder = torch.argsort(_morton_codes(pts), dim=1, stable=True)
    pts_s = _pad_rows_edge(_sorted_rows(pts, qorder), tile_q, dim=1)
    qc, qr = _tile_spheres(pts_s, tile_q)
    return {
        "tri_s": tri_s, "face_ids": face_ids, "fc": fc, "fr": fr,
        "qorder": qorder, "pts_s": pts_s.contiguous(), "qc": qc, "qr": qr,
        "seed": _seeds(pts_s, sc, sr),
    }


def culled_operands(v, f, points, tile_variant="fast", tile_q=256,
                    tile_f=1024):
    """The prologue of a batched culled query: ``v`` [B, V, 3], shared
    ``f`` [F, 3], ``points`` [B, Q, 3] -> dict of the kernel's operands
    (``pts_s`` [B, Qp, 3], ``seed`` [B, Qp], ``qsph`` [B, Qp/tile_q, 4],
    ``fsph`` [B, Fp/tile_f, 4], ``planes`` [B, 19, Fp]) and what the
    epilogue needs (``face_ids``, ``qorder``, ``tri``, ``pts``,
    ``center``), all centered on each mesh's vertex mean."""
    _check_variant(tile_variant)
    pts, center, tri = _center_inputs(v, f, points)
    pro = _prologue(v.to(torch.float32) - center, f, pts, tile_q, tile_f)
    return {
        "pts_s": pro["pts_s"],
        "seed": pro["seed"],
        "qsph": torch.cat([pro["qc"], pro["qr"][..., None]], -1).contiguous(),
        "fsph": torch.cat([pro["fc"], pro["fr"][..., None]], -1).contiguous(),
        "planes": face_planes(pro["tri_s"], tile_variant),
        "face_ids": pro["face_ids"], "qorder": pro["qorder"],
        "tri": tri, "pts": pts, "center": center,
        "tile_q": tile_q, "tile_f": tile_f,
    }


# ---------------------------------------------------------------------------
# The culled argmin: plain version, and the wrapper that launches the kernel.

def _check_culled(ops):
    pts_s, seed, qsph, fsph, planes = (ops[k] for k in (
        "pts_s", "seed", "qsph", "fsph", "planes"))
    tile_q, tile_f = ops["tile_q"], ops["tile_f"]
    tensors = (pts_s, seed, qsph, fsph, planes)
    if any(t.device != pts_s.device for t in tensors):
        raise ValueError("culled_faces: operands on several devices")
    if any(t.dtype != torch.float32 or not t.is_contiguous()
           for t in tensors):
        raise ValueError("culled_faces wants contiguous float32 operands")
    n_b, q_pad = seed.shape
    f_pad = planes.shape[-1]
    if (pts_s.shape != (n_b, q_pad, 3) or q_pad % tile_q or f_pad % tile_f
            or qsph.shape != (n_b, q_pad // tile_q, 4)
            or fsph.shape != (n_b, f_pad // tile_f, 4)
            or planes.shape[:2] != (n_b, N_FACE_ROWS)):
        raise ValueError("culled_faces: operand shapes %s do not fit tiles "
                         "(%d, %d)" % ([tuple(t.shape) for t in tensors],
                                       tile_q, tile_f))
    if pts_s.device.type not in ("cpu", "cuda"):
        raise ValueError("culled_faces: no kernel for device %s"
                         % pts_s.device)


def argmin_culled_plain(ops, tile_variant="fast", degenerate_tail=True):
    """Plain PyTorch version of the ``culled_faces`` kernel on the operand
    dict of ``culled_operands`` -> (sorted face position per query
    [B, Qp] int32, face tiles tested per query tile [B, Qp/tile_q]
    int32)."""
    _check_variant(tile_variant)
    tile = _TILES[tile_variant]
    pts_s, seed, qsph, fsph, planes = (ops[k] for k in (
        "pts_s", "seed", "qsph", "fsph", "planes"))
    tile_q, tile_f = ops["tile_q"], ops["tile_f"]
    n_b, q_pad = seed.shape
    n_qt, n_ft = q_pad // tile_q, planes.shape[-1] // tile_f
    p = pts_s.view(n_b, n_qt, tile_q, 3)
    acc_d = seed.view(n_b, n_qt, tile_q).clone()
    acc_i = torch.zeros_like(acc_d, dtype=torch.int32)
    worst = acc_d.amax(dim=-1)
    visits = torch.zeros((n_b, n_qt), dtype=torch.int32, device=seed.device)
    per = max(1, _PLAIN_PAIRS[seed.device.type] // (tile_q * tile_f))
    for j in range(n_ft):
        fs = fsph[:, j, None, :]                              # [B, 1, 4]
        dx = qsph[..., 0] - fs[..., 0]
        dy = qsph[..., 1] - fs[..., 1]
        dz = qsph[..., 2] - fs[..., 2]
        dist = torch.sqrt(dx * dx + dy * dy + dz * dz)
        lb = torch.clamp_min(dist - qsph[..., 3] - fs[..., 3], 0.0) * _SHRINK
        take = lb * lb <= worst
        rows_b, rows_t = take.nonzero(as_tuple=True)
        if not rows_b.numel():
            continue
        visits += take.to(torch.int32)
        for c0 in range(0, rows_b.numel(), per):
            bi, ti = rows_b[c0:c0 + per], rows_t[c0:c0 + per]
            q = p[bi, ti]                                     # [n, TQ, 3]
            rows = planes[bi, :, j * tile_f:(j + 1) * tile_f]  # [n, 19, TF]
            cost = tile(q[..., 0:1], q[..., 1:2], q[..., 2:3],
                        *[rows[:, k, None, :] for k in range(N_FACE_ROWS)],
                        degenerate_tail=degenerate_tail)
            arg = torch.argmin(cost, dim=-1)
            tile_min = torch.gather(cost, -1, arg[..., None])[..., 0]
            cur_d, cur_i = acc_d[bi, ti], acc_i[bi, ti]
            better = tile_min < cur_d
            acc_d[bi, ti] = torch.where(better, tile_min, cur_d)
            acc_i[bi, ti] = torch.where(
                better, (arg + j * tile_f).to(torch.int32), cur_i)
        worst = acc_d.amax(dim=-1)
    return acc_i.view(n_b, q_pad), visits


def argmin_culled(ops, tile_variant="fast", degenerate_tail=True):
    """(sorted face position per query, face tiles tested per query tile):
    the ``culled_faces`` CUDA kernel for CUDA operands, its plain version
    for CPU operands."""
    _check_variant(tile_variant)
    _check_culled(ops)
    if ops["seed"].device.type == "cpu":
        return argmin_culled_plain(ops, tile_variant, degenerate_tail)
    from .. import _build

    n_b, q_pad = ops["seed"].shape
    out = torch.empty((n_b, q_pad), dtype=torch.int32,
                      device=ops["seed"].device)
    visits = torch.empty((n_b, q_pad // ops["tile_q"]), dtype=torch.int32,
                         device=out.device)
    _build.launch("culled_faces", out.device, ops["pts_s"], ops["seed"],
                  ops["qsph"], ops["fsph"], ops["planes"], out, visits,
                  n_b, q_pad, ops["planes"].shape[-1], ops["tile_q"],
                  ops["tile_f"], ("fast", "safe").index(tile_variant),
                  int(bool(degenerate_tail)))
    LAUNCHES["culled_faces"] += 1
    return out, visits


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
    best, _ = argmin(ops, tile_variant, not assume_nondegenerate)
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
