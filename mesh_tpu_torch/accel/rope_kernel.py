"""BVH rope walk per query tile: the ``rope_faces`` CUDA kernel's resident
and streamed wrappers, their plain PyTorch versions, and the prologue and
epilogue around them (counterpart of mesh_tpu/accel/pallas_bvh.py and
mesh_tpu/accel/pallas_stream.py).

The walk uses a coarse BVH whose leaves are ``tile_f`` contiguous Morton
faces (``build.get_index(..., leaf_size=tile_f)``), in the builder's
centered frame (its numpy float32 mean, ``arrays["center"]``).  Prologue
(``_rope_operands``): queries Morton-sorted and edge-padded to whole tiles
of ``tile_q``, a per-query seed from 128-face sub-block spheres, node boxes
and topology, and the fast tile's 19 planes of the Morton-ordered faces.
A query tile walks the rope: a node is pruned when the tile's least
squared distance to its box, shrunk by ``_MARGIN``, exceeds the tile's
worst running best; a visited leaf runs the fast tile with its degenerate
tail and merges with a strict ``<``, so ties go to the lowest Morton-sorted
position.  The resident entry visits each surviving leaf at once; the
streamed one prefetches up to ``n_buffers`` leaves under the bound frozen
when it refilled its ring, which visits a superset of the resident walk's
leaves, in the same order, with bit-identical faces and distances
(``csrc/rope_faces.cu``).  Epilogue (``_rope_epilogue``): sorted position
-> original face id, sorted query order -> the caller's, the exact point
recomputed on the winner, and the pair tests each query's tile ran.

``rope_argmin`` launches the kernel for CUDA operands and takes its plain
version (``rope_argmin_plain``, which replays the streamed ring's refill
exactly) for CPU operands; ``LAUNCHES`` counts each entry's launches.
"""

import torch

from ..query.closest_kernel import (
    N_FACE_ROWS,
    _PLAIN_PAIRS,
    _sqdist_tile_fast,
    fast_tile_rows,
    winner_epilogue,
)
from ..query.culled_kernel import (
    _SHRINK,
    _morton_codes,
    _pad_rows_edge,
    _seeds,
    _tile_spheres,
)
from ..utils.device import as_tensor, host_array, resolve_device
from .build import get_index

#: launches of each rope entry since the counts were last set to 0
LAUNCHES = {"rope_faces_resident": 0, "rope_faces_stream": 0}

_SEED_SUB = 128     # sub-block size for the seed upper bound

#: ring slots the streamed CUDA entry allows
MAX_BUFFERS = 16


def _coarse_index(v, f, tile_f, index, rebuild_mismatched):
    """The coarse (``leaf_size == tile_f``) BVH the rope kernels walk:
    ``index`` when its leaf size is ``tile_f``; from the cache when
    ``index`` is None or (with ``rebuild_mismatched``) built at another
    leaf size; a passed index of another leaf size raises otherwise.  Only
    a cache lookup copies ``v`` and ``f`` to the host."""
    if index is not None and int(index.meta["leaf_size"]) == int(tile_f):
        return index
    if index is not None and not rebuild_mismatched:
        raise ValueError(
            "rope kernel needs leaf_size == tile_f (index has %s, "
            "tile_f=%s)" % (index.meta["leaf_size"], tile_f))
    return get_index(host_array(v, "float32"), host_array(f, "int32"),
                     kind="bvh", leaf_size=int(tile_f))


def _rope_operands(v32, f, pts32, order_p, center_b, node_lo, node_hi,
                   node_skip, node_leaf, tile_q, tile_f):
    """Shared prologue of the resident and streamed walks (tensors on one
    device) -> dict of the kernel's operands (``pts_s`` [Qp, 3], ``seed``
    [Qp], ``boxes`` [N, 6], ``topo`` [N, 2] int32, ``rows`` [19, Fp]) and
    what the epilogue needs (faces ``f`` among them)."""
    vc = v32 - center_b                        # the builder's frame
    pts = pts32 - center_b
    tri_s = vc[f.long()][order_p.long()]       # [Fp, 3, 3], Morton order
    f_pad = tri_s.shape[0]
    qorder = torch.argsort(_morton_codes(pts), stable=True)
    pts_s = _pad_rows_edge(pts[qorder], tile_q).contiguous()
    sub = _SEED_SUB if f_pad % _SEED_SUB == 0 else tile_f
    sc, sr = _tile_spheres(tri_s.reshape(-1, 3), sub * 3)
    topo = torch.stack(
        [node_skip, torch.where(node_leaf >= 0, node_leaf * tile_f, -1)],
        dim=1).to(torch.int32).contiguous()
    return {
        "pts_s": pts_s,
        "seed": _seeds(pts_s[None], sc[None], sr[None])[0],
        "boxes": torch.cat([node_lo, node_hi], dim=1).contiguous(),
        "topo": topo,
        "rows": torch.stack(fast_tile_rows(tri_s), dim=0).contiguous(),
        "vc": vc, "f": f, "pts": pts, "qorder": qorder, "order_p": order_p,
        "center": center_b, "tile_q": tile_q, "tile_f": tile_f,
    }


def _rope_epilogue(ops, out_i, out_lv):
    """Sorted face position per query -> the result dict in the caller's
    query order: ``face``, ``part``, ``point``, ``sqdist``, ``tight`` (all
    True: the bounds are conservative) and ``pair_tests`` (tile_f per leaf
    the query's tile tested)."""
    qorder = ops["qorder"]
    n_q = qorder.shape[0]
    ids = ops["order_p"].long()[out_i.long()]
    best = torch.empty_like(qorder)
    best[qorder] = ids[:n_q]
    pairs_s = torch.repeat_interleave(out_lv * ops["tile_f"], ops["tile_q"])
    pairs = torch.empty_like(qorder, dtype=torch.int32)
    pairs[qorder] = pairs_s[:n_q].to(torch.int32)
    res = winner_epilogue(best.to(torch.int32)[None],
                          ops["vc"][ops["f"].long()][None], ops["pts"][None],
                          ops["center"])
    res = {key: val[0] for key, val in res.items()}
    res["tight"] = torch.ones(n_q, dtype=torch.bool, device=best.device)
    res["pair_tests"] = pairs
    return res


# ---------------------------------------------------------------------------
# The walk: plain version, and the wrapper that launches the kernel.

def _check_rope(ops, n_buffers):
    names = ("pts_s", "seed", "boxes", "topo", "rows")
    tensors = [ops[k] for k in names]
    dev = ops["seed"].device
    if any(t.device != dev for t in tensors):
        raise ValueError("rope_faces: operands on several devices")
    if any(not t.is_contiguous() for t in tensors) or any(
            ops[k].dtype != torch.float32 for k in names if k != "topo") \
            or ops["topo"].dtype != torch.int32:
        raise ValueError("rope_faces wants contiguous float32 operands and "
                         "int32 topology")
    tile_q, tile_f = ops["tile_q"], ops["tile_f"]
    q_pad, f_pad = ops["seed"].shape[0], ops["rows"].shape[-1]
    if (ops["pts_s"].shape != (q_pad, 3) or q_pad % tile_q or f_pad % tile_f
            or ops["rows"].shape[0] != N_FACE_ROWS
            or ops["boxes"].shape != (ops["topo"].shape[0], 6)):
        raise ValueError("rope_faces: operand shapes do not fit tiles "
                         "(%d, %d)" % (tile_q, tile_f))
    if n_buffers is not None and not 2 <= n_buffers <= MAX_BUFFERS:
        raise ValueError("streamed rope kernel needs 2 <= n_buffers <= %d "
                         "(got %d)" % (MAX_BUFFERS, n_buffers))
    if dev.type not in ("cpu", "cuda"):
        raise ValueError("rope_faces: no kernel for device %s" % dev)


def rope_argmin_plain(ops, n_buffers=None):
    """Plain PyTorch version of the ``rope_faces`` kernel on the operand
    dict of ``_rope_operands``: the resident walk for ``n_buffers=None``,
    else the streamed one with a ring of ``n_buffers``.  Returns (best
    squared distance [Qp] float32, sorted face position [Qp] int32, leaves
    tested per query tile [Qp/tile_q] int32).  All tiles advance together,
    each through its own walk."""
    tile_q, tile_f = ops["tile_q"], ops["tile_f"]
    boxes, topo, rows = ops["boxes"], ops["topo"].long(), ops["rows"]
    n_nodes = boxes.shape[0]
    dev = boxes.device
    p = ops["pts_s"].view(-1, tile_q, 3)
    n_t = p.shape[0]
    acc_d = ops["seed"].view(n_t, tile_q).clone()
    acc_i = torch.zeros_like(acc_d, dtype=torch.int32)
    leaves = torch.zeros(n_t, dtype=torch.int32, device=dev)
    node = torch.zeros(n_t, dtype=torch.int64, device=dev)
    per = max(1, _PLAIN_PAIRS[dev.type] // (tile_q * tile_f))
    span = torch.arange(tile_f, device=dev)

    def lower_bound(t, nd):
        b = boxes[nd][:, None, :]                         # [n, 1, 6]
        q = p[t]                                          # [n, TQ, 3]
        dd = [torch.clamp_min(torch.maximum(b[..., k] - q[..., k],
                                            q[..., k] - b[..., 3 + k]), 0.0)
              for k in range(3)]
        return (dd[0] * dd[0] + dd[1] * dd[1] + dd[2] * dd[2]).amin(dim=-1)

    def step(t, bound):
        """One rope step of tiles ``t`` against ``bound`` -> the leaf
        starts they take (-1 where none)."""
        nd = node[t]
        prune = lower_bound(t, nd) * _SHRINK > bound
        skip, leaf = topo[nd, 0], topo[nd, 1]
        is_leaf = leaf >= 0
        node[t] = torch.where(prune | is_leaf, skip, nd + 1)
        return torch.where(is_leaf & ~prune, leaf, -1)

    def visit(t, leaf_start):
        leaves[t] += 1
        for c0 in range(0, t.numel(), per):
            ti, ls = t[c0:c0 + per], leaf_start[c0:c0 + per]
            q = p[ti]
            planes = rows[:, ls[:, None] + span]          # [19, n, TF]
            cost = _sqdist_tile_fast(
                q[..., 0:1], q[..., 1:2], q[..., 2:3],
                *[planes[k][:, None, :] for k in range(N_FACE_ROWS)])
            arg = torch.argmin(cost, dim=-1)
            tile_min = torch.gather(cost, -1, arg[..., None])[..., 0]
            cur_d, cur_i = acc_d[ti], acc_i[ti]
            better = tile_min < cur_d
            acc_d[ti] = torch.where(better, tile_min, cur_d)
            acc_i[ti] = torch.where(better, (arg + ls[:, None]).to(torch.int32),
                                    cur_i)

    if n_buffers is None:
        while True:
            live = (node < n_nodes).nonzero()[:, 0]
            if not live.numel():
                break
            take = step(live, acc_d[live].amax(dim=-1))
            hit = take >= 0
            visit(live[hit], take[hit])
    else:
        ring = torch.zeros((n_t, n_buffers), dtype=torch.int64, device=dev)
        head = torch.zeros(n_t, dtype=torch.int64, device=dev)
        count = torch.zeros(n_t, dtype=torch.int64, device=dev)

        def refill(t, bound):
            while True:
                keep = (node[t] < n_nodes) & (count[t] < n_buffers)
                t, bound = t[keep], bound[keep]
                if not t.numel():
                    return
                take = step(t, bound)
                hit = take >= 0
                th = t[hit]
                ring[th, (head[th] + count[th]) % n_buffers] = take[hit]
                count[th] += 1

        all_tiles = torch.arange(n_t, device=dev)
        refill(all_tiles, acc_d.amax(dim=-1))
        while True:
            act = (count > 0).nonzero()[:, 0]
            if not act.numel():
                break
            visit(act, ring[act, head[act]])
            head[act] = (head[act] + 1) % n_buffers
            count[act] -= 1
            refill(act, acc_d[act].amax(dim=-1))
    return acc_d.view(-1), acc_i.view(-1), leaves


def rope_argmin(ops, n_buffers=None):
    """(best squared distance, sorted face position, leaves per query
    tile): the ``rope_faces`` CUDA kernel for CUDA operands (the resident
    entry for ``n_buffers=None``, else the streamed one), its plain
    version for CPU operands."""
    _check_rope(ops, n_buffers)
    dev = ops["seed"].device
    if dev.type == "cpu":
        return rope_argmin_plain(ops, n_buffers)
    from .. import _build

    q_pad = ops["seed"].shape[0]
    out_d = torch.empty(q_pad, dtype=torch.float32, device=dev)
    out_i = torch.empty(q_pad, dtype=torch.int32, device=dev)
    out_lv = torch.empty(q_pad // ops["tile_q"], dtype=torch.int32,
                         device=dev)
    _build.launch("rope_faces", dev, ops["pts_s"], ops["seed"], ops["boxes"],
                  ops["topo"], ops["rows"], out_d, out_i, out_lv, q_pad,
                  ops["boxes"].shape[0], ops["rows"].shape[-1], ops["tile_q"],
                  ops["tile_f"], n_buffers or 0)
    LAUNCHES["rope_faces_stream" if n_buffers else "rope_faces_resident"] += 1
    return out_d, out_i, out_lv


# ---------------------------------------------------------------------------
# Whole queries.

def rope_operands(v, f, points, tile_q=128, tile_f=256, index=None,
                  rebuild_mismatched=False, device="cuda"):
    """The operand dict of a rope query on ``device``: the coarse index
    from the cache (or ``index``), its arrays uploaded once per device,
    and the shared prologue."""
    dev = resolve_device(device)
    index = _coarse_index(v, f, tile_f, index, rebuild_mismatched)
    arr = index.on(dev)
    return _rope_operands(
        as_tensor(v, dev, torch.float32), as_tensor(f, dev),
        as_tensor(points, dev, torch.float32).reshape(-1, 3),
        arr["order"], arr["center"], arr["node_lo"], arr["node_hi"],
        arr["node_skip"], arr["node_leaf"], int(tile_q), int(tile_f))


def _closest_point_rope(v, f, points, tile_q, tile_f, n_buffers, index,
                        rebuild_mismatched, device, argmin):
    ops = rope_operands(v, f, points, tile_q, tile_f, index,
                        rebuild_mismatched, device)
    _, out_i, out_lv = argmin(ops, n_buffers)
    return _rope_epilogue(ops, out_i, out_lv)


def _check_stream(tile_f):
    if int(tile_f) % 128:
        raise ValueError("streamed kernel needs tile_f %% 128 == 0 "
                         "(got %d)" % tile_f)


def closest_point_bvh_kernel(v, f, points, tile_q=128, tile_f=256,
                             index=None, rebuild_mismatched=False,
                             device="cuda"):
    """Closest point through the resident rope walk: a dict of ``face``,
    ``part``, ``point``, ``sqdist`` (exact up to distance ties), ``tight``
    (all True) and ``pair_tests``, as tensors on ``device``.

    ``v`` [V, 3], ``f`` [F, 3] and ``points`` [Q, 3] are arrays or
    tensors.  The coarse BVH (``leaf_size = tile_f``) comes from the
    digest cache; a passed ``index`` of another leaf size raises unless
    ``rebuild_mismatched`` asks for a (cached) rebuild.  On the card the
    CUDA kernel runs, on the CPU its plain version."""
    return _closest_point_rope(v, f, points, tile_q, tile_f, None, index,
                               rebuild_mismatched, device, rope_argmin)


def closest_point_bvh_plain(v, f, points, tile_q=128, tile_f=256,
                            index=None, rebuild_mismatched=False,
                            device="cuda"):
    """``closest_point_bvh_kernel`` with the plain walk on any device."""
    return _closest_point_rope(v, f, points, tile_q, tile_f, None, index,
                               rebuild_mismatched, device, rope_argmin_plain)


def closest_point_bvh_stream_kernel(v, f, points, tile_q=128, tile_f=256,
                                    n_buffers=2, index=None,
                                    rebuild_mismatched=False, device="cuda"):
    """Closest point through the streamed rope walk: the result of
    ``closest_point_bvh_kernel`` bit for bit, with ``pair_tests`` at least
    as large.  ``tile_f`` must be a multiple of 128 and ``n_buffers`` at
    least 2 (at most ``MAX_BUFFERS``)."""
    _check_stream(tile_f)
    return _closest_point_rope(v, f, points, tile_q, tile_f, int(n_buffers),
                               index, rebuild_mismatched, device, rope_argmin)


def closest_point_bvh_stream_plain(v, f, points, tile_q=128, tile_f=256,
                                   n_buffers=2, index=None,
                                   rebuild_mismatched=False, device="cuda"):
    """``closest_point_bvh_stream_kernel`` with the plain walk on any
    device."""
    _check_stream(tile_f)
    return _closest_point_rope(v, f, points, tile_q, tile_f, int(n_buffers),
                               index, rebuild_mismatched, device,
                               rope_argmin_plain)
