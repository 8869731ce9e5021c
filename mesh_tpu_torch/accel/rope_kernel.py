"""BVH rope walk per query tile: the ``rope_faces`` and ``rope_mxu_faces``
CUDA kernels' resident and streamed wrappers, their plain PyTorch versions,
and the prologue and epilogue around them (counterpart of
mesh_tpu/accel/pallas_bvh.py and mesh_tpu/accel/pallas_stream.py).

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

The MXU walk (``rope_mxu_faces``, ``csrc/rope_mxu_faces.cu``; the
reference's ``closest_point_pallas_bvh_mxu`` and
``closest_point_pallas_bvh_stream_mxu``) keeps the walk and visits a leaf
with the MXU tile (``mxu_kernel._sqdist_tile_mxu``, tail on) over the face
record of ``mxu_kernel._mxu_face_inputs``, built in the same centered frame
as the boxes and the queries, with ``p2`` per sorted query.  Under
``use_bf16`` a leaf's full visit runs only when some query of the tile
survives the bf16 screen against its running best (``_screen``); the
screen skips only visits that cannot change a face, so its answers are the
f32 walk's bit for bit, and it counts leaves taken ("screened") and full
visits ("repaired") per query tile.

Every entry of both kernels splits each query's leaf visit over
``lanes`` threads (S in ``LANES``): each folds a contiguous run of
``tile_f / S`` faces to a (minimum, lowest position) pair, the S pairs
merge by (distance, position), and one strict ``<`` applies the result,
which gives the faces, distances, leaf counts and full visits of the
whole-leaf fold bit for bit; under the bf16 screen each sub-lane screens
its own run and the block ORs the verdicts, which skips the same visits.
The plain versions take ``lanes`` too (``_leaf_min``); ``picked_lanes``
picks S from the tile shape.  The streamed ``rope_faces`` kernel copies
its leaves with ``cp.async``, which moves contiguous 16-byte pieces only,
so it reads the faces as one record per face (``recs`` [Fp, 20]: the 19
planes and a pad), built by the prologue under ``records=True``.

``rope_argmin`` / ``rope_mxu_argmin`` launch the kernel for CUDA operands
and take their plain versions (``rope_argmin_plain`` /
``rope_mxu_argmin_plain``, which replay the streamed ring's refill exactly)
for CPU operands; ``LAUNCHES`` counts each entry's launches.
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
from ..query.mxu_kernel import (
    MXU_RECORD,
    _mxu_ap2_env,
    _mxu_face_inputs,
    _sqdist_tile_mxu,
)
from ..utils.device import as_tensor, host_array, resolve_device
from .build import get_index

#: launches of each rope entry since the counts were last set to 0
LAUNCHES = {"rope_faces_resident": 0, "rope_faces_stream": 0,
            "rope_mxu_resident": 0, "rope_mxu_stream": 0}

_SEED_SUB = 128     # sub-block size for the seed upper bound

#: ring slots the streamed CUDA entries allow
MAX_BUFFERS = 16

#: shared memory the CUDA walks may stage leaves in (csrc/rope_walk.cuh):
#: the staged leaves (one, or a ring of n_buffers) and the sub-lanes'
#: partials (8 bytes a thread) must fit it
MAX_RING_BYTES = 226 * 1024

#: sub-lanes per query every rope entry takes, and the threads (tile_q x
#: lanes) its block may have (csrc/rope_walk.cuh rope_lanes_kernel,
#: rope_stream_kernel)
LANES = (1, 2, 4, 8)
MAX_LANE_THREADS = 1024

#: the most sub-lanes ``picked_lanes`` picks: S = 4 was the fastest on
#: every grid the resident walk was measured on on the H100, from 32 query
#: tiles to 1088 (PERF.md section 6); S = 8 adds merge work and ran slower
PICKED_LANES_MAX = 4

#: floats of the streamed rope_faces entry's face record: the fast tile's
#: 19 planes and a pad (csrc/rope_faces.cu FastLanes::kRecord)
FAST_RECORD = 20

#: a sub-lane's face position when its run beat nothing (kNoFace)
_NO_FACE = 2 ** 31 - 1


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


def _face_records(rows):
    """The fast tile's planes [19, Fp] as one record per face [Fp, 20]:
    the 19 planes and a zero pad, contiguous."""
    pad = rows.new_zeros((FAST_RECORD - N_FACE_ROWS, rows.shape[1]))
    return torch.cat([rows, pad], dim=0).t().contiguous()


def _rope_operands(v32, f, pts32, order_p, center_b, node_lo, node_hi,
                   node_skip, node_leaf, tile_q, tile_f, mxu=False,
                   records=False):
    """Shared prologue of the resident and streamed walks (tensors on one
    device) -> dict of the kernel's operands (``pts_s`` [Qp, 3], ``seed``
    [Qp], ``boxes`` [N, 6], ``topo`` [N, 2] int32, and the leaves' faces:
    ``rows`` [19, Fp] for the fast tile, with ``records`` also ``recs``
    [Fp, 20] for its streamed kernel, or with ``mxu`` the face record
    ``rec`` [Fp, 24] and ``p2`` [Qp]) and what the epilogue needs (faces
    ``f`` among them)."""
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
    ops = {
        "pts_s": pts_s,
        "seed": _seeds(pts_s[None], sc[None], sr[None])[0],
        "boxes": torch.cat([node_lo, node_hi], dim=1).contiguous(),
        "topo": topo,
        "vc": vc, "f": f, "pts": pts, "qorder": qorder, "order_p": order_p,
        "center": center_b, "tile_q": tile_q, "tile_f": tile_f,
    }
    if mxu:
        px, py, pz = pts_s[:, 0], pts_s[:, 1], pts_s[:, 2]
        ops["rec"] = _mxu_face_inputs(tri_s)
        ops["p2"] = (px * px + py * py + pz * pz).contiguous()
    else:
        ops["rows"] = torch.stack(fast_tile_rows(tri_s), dim=0).contiguous()
        if records:
            ops["recs"] = _face_records(ops["rows"])
    return ops


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
# The walks: plain versions, and the wrappers that launch the kernels.

def _check_rope(ops, n_buffers, lanes, mxu=False):
    """Raises unless the kernel can launch on ``ops`` with a ring of
    ``n_buffers`` (None: the resident entry) and ``lanes`` sub-lanes."""
    name = "rope_mxu_faces" if mxu else "rope_faces"
    faces = ("rec", "p2") if mxu else ("rows",)
    names = ("pts_s", "seed", "boxes", "topo") + faces
    tensors = [ops[k] for k in names]
    dev = ops["seed"].device
    if any(t.device != dev for t in tensors):
        raise ValueError("%s: operands on several devices" % name)
    if any(not t.is_contiguous() for t in tensors) or any(
            ops[k].dtype != torch.float32 for k in names if k != "topo") \
            or ops["topo"].dtype != torch.int32:
        raise ValueError("%s wants contiguous float32 operands and int32 "
                         "topology" % name)
    tile_q, tile_f = ops["tile_q"], ops["tile_f"]
    q_pad = ops["seed"].shape[0]
    if mxu:
        f_pad = ops["rec"].shape[0]
        faces_ok = (ops["rec"].shape[1] == MXU_RECORD
                    and ops["p2"].shape == (q_pad,))
    else:
        f_pad = ops["rows"].shape[-1]
        faces_ok = ops["rows"].shape[0] == N_FACE_ROWS
    if (ops["pts_s"].shape != (q_pad, 3) or q_pad % tile_q or f_pad % tile_f
            or not faces_ok
            or ops["boxes"].shape != (ops["topo"].shape[0], 6)):
        raise ValueError("%s: operand shapes do not fit tiles (%d, %d)"
                         % (name, tile_q, tile_f))
    if n_buffers is not None and not 2 <= n_buffers <= MAX_BUFFERS:
        raise ValueError("streamed rope kernel needs 2 <= n_buffers <= %d "
                         "(got %d)" % (MAX_BUFFERS, n_buffers))
    _check_lanes(ops, lanes, mxu)
    # the staged leaves, then the sub-lanes' partials (a distance and a
    # position a thread)
    slot = (MXU_RECORD if mxu else FAST_RECORD) * tile_f * 4
    staged = ((n_buffers or 1) * slot
              + (tile_q * lanes * 8 if lanes > 1 else 0))
    if staged > MAX_RING_BYTES:
        raise ValueError("%s: %d staged leaves of %d faces and %d lanes' "
                         "partials take %d bytes of shared memory, above the "
                         "%d a walk may use" % (name, n_buffers or 1, tile_f,
                                                lanes, staged,
                                                MAX_RING_BYTES))
    if dev.type not in ("cpu", "cuda"):
        raise ValueError("%s: no kernel for device %s" % (name, dev))


def _leaf_min(cost, lanes):
    """(minimum, position) of each query's leaf costs [n, TQ, TF]: the
    first argmin for ``lanes=None``; else the sub-lane fold, ``lanes``
    contiguous runs each reduced to (minimum, lowest position, or
    ``_NO_FACE`` where the run holds only +inf), merged by (distance,
    position)."""
    if lanes is None:
        arg = torch.argmin(cost, dim=-1)
        return torch.gather(cost, -1, arg[..., None])[..., 0], arg
    runs = cost.unflatten(-1, (lanes, -1))                # [n, TQ, S, R]
    r_arg = torch.argmin(runs, dim=-1)
    r_min = torch.gather(runs, -1, r_arg[..., None])[..., 0]
    first = torch.arange(lanes, device=cost.device) * runs.shape[-1]
    r_pos = torch.where(r_min < float("inf"), r_arg + first, _NO_FACE)
    md, mi = r_min[..., 0], r_pos[..., 0]
    for s in range(1, lanes):
        d, i = r_min[..., s], r_pos[..., s]
        take = (d < md) | ((d == md) & (i < mi))
        md, mi = torch.where(take, d, md), torch.where(take, i, mi)
    return md, mi


def _walk_plain(ops, n_buffers, leaf_cost, screen=None, lanes=None):
    """The rope walk of ``ops`` in plain PyTorch: the resident walk for
    ``n_buffers=None``, else the streamed one with a ring of ``n_buffers``.
    All tiles advance together, each through its own walk; ``lanes``
    reduces each leaf as the sub-lane fold (``_leaf_min``).

    ``leaf_cost(q [n, TQ, 3], leaf_start [n])`` -> [n, TQ, TF] costs of
    each tile's queries against its leaf; ``screen(q, leaf_start, best
    [n, TQ])`` -> [n] bool, the tiles whose full visit runs (None: all).
    Returns (best squared distance [Qp], sorted face position [Qp] int32,
    leaves taken and full visits per query tile [Qp/tile_q] int32)."""
    tile_q, tile_f = ops["tile_q"], ops["tile_f"]
    boxes, topo = ops["boxes"], ops["topo"].long()
    n_nodes = boxes.shape[0]
    dev = boxes.device
    p = ops["pts_s"].view(-1, tile_q, 3)
    n_t = p.shape[0]
    acc_d = ops["seed"].view(n_t, tile_q).clone()
    acc_i = torch.zeros_like(acc_d, dtype=torch.int32)
    leaves = torch.zeros(n_t, dtype=torch.int32, device=dev)
    full = torch.zeros(n_t, dtype=torch.int32, device=dev)
    node = torch.zeros(n_t, dtype=torch.int64, device=dev)
    per = max(1, _PLAIN_PAIRS[dev.type] // (tile_q * tile_f))

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
            if screen is not None:
                keep = screen(q, ls, acc_d[ti])
                ti, ls, q = ti[keep], ls[keep], q[keep]
            full[ti] += 1
            tile_min, arg = _leaf_min(leaf_cost(q, ls), lanes)
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
    return acc_d.view(-1), acc_i.view(-1), leaves, full


def _fast_leaf_cost(ops):
    rows = ops["rows"]
    span = torch.arange(ops["tile_f"], device=rows.device)

    def leaf_cost(q, ls):
        planes = rows[:, ls[:, None] + span]          # [19, n, TF]
        return _sqdist_tile_fast(
            q[..., 0:1], q[..., 1:2], q[..., 2:3],
            *[planes[k][:, None, :] for k in range(N_FACE_ROWS)])

    return leaf_cost


def rope_argmin_plain(ops, n_buffers=None, lanes=None):
    """Plain PyTorch version of the ``rope_faces`` kernel on the operand
    dict of ``_rope_operands``: the resident walk for ``n_buffers=None``,
    else the streamed one with a ring of ``n_buffers``; with ``lanes``,
    each leaf folded as ``lanes`` sub-lanes (bit-identical to the
    whole-leaf fold).  Returns (best squared distance [Qp] float32, sorted
    face position [Qp] int32, leaves tested per query tile [Qp/tile_q]
    int32)."""
    if lanes is not None:
        _check_lanes(ops, lanes)
    d, i, leaves, _ = _walk_plain(ops, n_buffers, _fast_leaf_cost(ops),
                                  lanes=lanes)
    return d, i, leaves


def rope_lanes_plain(ops, lanes):
    """Plain PyTorch version of the resident ``rope_faces`` entry's design
    at ``lanes`` sub-lanes per query: the resident walk with each leaf's
    costs split into ``lanes`` runs, a (minimum, first argmin) per run and
    a merge by (distance, position).  Returns what ``rope_argmin_plain``
    returns, and equals it bit for bit."""
    return rope_argmin_plain(ops, None, lanes)


def _check_lanes(ops, lanes, mxu=False):
    tile_q, tile_f = ops["tile_q"], ops["tile_f"]
    if lanes not in LANES or tile_f % lanes or \
            tile_q * lanes > MAX_LANE_THREADS:
        raise ValueError(
            "%s: lanes must be one of %s, divide tile_f (%d) and keep "
            "tile_q x lanes (%d x %s) within %d threads"
            % ("rope_mxu_faces" if mxu else "rope_faces", LANES, tile_f,
               tile_q, lanes, MAX_LANE_THREADS))


def picked_lanes(tile_q, tile_f):
    """Sub-lanes per query of a rope launch (every entry of both
    kernels) when the caller names none: the most of ``LANES`` up to
    ``PICKED_LANES_MAX`` that divide ``tile_f`` and keep ``tile_q x S``
    within ``MAX_LANE_THREADS``."""
    return max(s for s in LANES if s <= PICKED_LANES_MAX and tile_f % s == 0
               and tile_q * s <= MAX_LANE_THREADS)


def stream_fits(tile_q, tile_f, n_buffers):
    """Whether the streamed ``rope_faces`` entry launches at these tiles
    (at its picked sub-lanes): ``tile_f`` a multiple of 128, a ring of 2
    to ``MAX_BUFFERS`` slots, and the ring and the partials within
    ``MAX_RING_BYTES`` of shared memory."""
    if int(tile_f) % 128 or not 2 <= int(n_buffers) <= MAX_BUFFERS:
        return False
    fits = [s for s in LANES if s <= PICKED_LANES_MAX and tile_f % s == 0
            and tile_q * s <= MAX_LANE_THREADS]
    if not fits:
        return False
    lanes = max(fits)
    staged = (int(n_buffers) * FAST_RECORD * int(tile_f) * 4
              + (int(tile_q) * lanes * 8 if lanes > 1 else 0))
    return staged <= MAX_RING_BYTES


def _no_walk(dev, n_out):
    """The outputs of a walk with no queries, made without a launch (an
    empty grid is a launch error): best distances [0] float32, then
    ``n_out - 1`` int32 outputs [0]."""
    return (torch.empty(0, dtype=torch.float32, device=dev),) + tuple(
        torch.empty(0, dtype=torch.int32, device=dev)
        for _ in range(n_out - 1))


def rope_argmin(ops, n_buffers=None, lanes=None):
    """(best squared distance, sorted face position, leaves per query
    tile): the ``rope_faces`` CUDA kernel for CUDA operands (the resident
    entry for ``n_buffers=None``, else the streamed one, which reads
    ``ops["recs"]``), at ``lanes`` sub-lanes per query, by default
    ``picked_lanes``; the plain walk (``rope_argmin_plain``) for CPU
    operands."""
    if lanes is None:
        lanes = picked_lanes(ops["tile_q"], ops["tile_f"])
    _check_rope(ops, n_buffers, lanes)
    dev = ops["seed"].device
    if dev.type == "cpu":
        return rope_argmin_plain(ops, n_buffers, lanes)
    faces = ops["rows"]
    if n_buffers:
        faces = ops.get("recs")
        want = (ops["rows"].shape[1], FAST_RECORD)
        if faces is None or faces.shape != want or faces.device != dev or \
                faces.dtype != torch.float32 or not faces.is_contiguous():
            raise ValueError("rope_faces: the streamed entry reads the face "
                             "records [Fp, %d] float32 of rope_operands(..., "
                             "records=True)" % FAST_RECORD)
    q_pad = ops["seed"].shape[0]
    if not q_pad:
        return _no_walk(dev, 3)
    from .. import _build

    n_tiles = q_pad // ops["tile_q"]
    out_d = torch.empty(q_pad, dtype=torch.float32, device=dev)
    out_i = torch.empty(q_pad, dtype=torch.int32, device=dev)
    out_lv = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    _build.launch("rope_faces", dev, ops["pts_s"], ops["seed"], ops["boxes"],
                  ops["topo"], faces, out_d, out_i, out_lv, q_pad,
                  ops["boxes"].shape[0], ops["rows"].shape[-1], ops["tile_q"],
                  ops["tile_f"], n_buffers or 0, lanes)
    LAUNCHES["rope_faces_stream" if n_buffers else "rope_faces_resident"] += 1
    return out_d, out_i, out_lv


def _leaf_cols(rec, ls, span):
    """The face record's columns over the leaves starting at ``ls`` [n],
    each [n, 1, TF]."""
    recs = rec[ls[:, None] + span]                    # [n, TF, 24]
    return [recs[:, None, :, k] for k in range(MXU_RECORD)]


def _screen(cols, q, best):
    """[n, TQ, TF] survivors of the bf16 screen: the pairs whose face may
    still hold a point within sqrt(best) of the query (the reference's
    _mxu_screen_tile with ``ub`` the running best [n, TQ])."""
    ap2t, env = _mxu_ap2_env(q, cols)
    ub = best[..., None]
    su = torch.sqrt(torch.clamp_min(ub, 0.0))
    reach = cols[23]
    return ap2t - env <= ub + (su + su) * reach + reach * reach


def rope_mxu_argmin_plain(ops, n_buffers=None, use_bf16=False, counts=None,
                          lanes=None):
    """Plain PyTorch version of the ``rope_mxu_faces`` kernel on the
    operand dict of ``_rope_operands(..., mxu=True)``: the resident walk
    for ``n_buffers=None``, else the streamed one; with ``lanes``, each
    leaf folded as ``lanes`` sub-lanes (bit-identical to the whole-leaf
    fold).  Returns (best squared distance [Qp] float32, sorted face
    position [Qp] int32, leaves taken and full visits per query tile
    [Qp/tile_q] int32).

    Under ``use_bf16`` both walks screen alike: a tile's full visit runs
    when any (query, run) pair survives, the OR over the tile of each
    run's test up to its first survivor, which is the whole-leaf screen's
    verdict at every ``lanes``.  ``counts``, a dict, gains
    ``screen_pairs``: the query-face pairs the one-lane screen evaluates,
    each query up to its first survivor; with ``lanes`` also
    ``screen_lane_pairs``, those the sub-lanes evaluate, each run up to its
    own first survivor."""
    if lanes is not None:
        _check_lanes(ops, lanes, mxu=True)
    rec = ops["rec"]
    tile_f = ops["tile_f"]
    span = torch.arange(tile_f, device=rec.device)

    def leaf_cost(q, ls):
        return _sqdist_tile_mxu(q, _leaf_cols(rec, ls, span))

    def tested(surv):
        """Pairs a screen tests over the last dim of ``surv``, up to the
        first survivor."""
        hit = surv.any(dim=-1)
        return int(torch.where(hit, surv.int().argmax(dim=-1) + 1,
                               surv.shape[-1]).sum())

    def screen(q, ls, best):
        surv = _screen(_leaf_cols(rec, ls, span), q, best)
        if counts is not None:
            counts["screen_pairs"] = (counts.get("screen_pairs", 0)
                                      + tested(surv))
            if lanes is not None:
                counts["screen_lane_pairs"] = (
                    counts.get("screen_lane_pairs", 0)
                    + tested(surv.unflatten(-1, (lanes, -1))))
        return surv.any(dim=-1).any(dim=-1)

    return _walk_plain(ops, n_buffers, leaf_cost,
                       screen if use_bf16 else None, lanes)


def rope_mxu_argmin(ops, n_buffers=None, use_bf16=False, lanes=None):
    """(best squared distance, sorted face position, leaves taken and full
    visits per query tile) of the MXU walk: the ``rope_mxu_faces`` CUDA
    kernel for CUDA operands (the resident entry for ``n_buffers=None``,
    else the streamed one), at ``lanes`` sub-lanes per query, by default
    ``picked_lanes``; its plain version for CPU operands."""
    if lanes is None:
        lanes = picked_lanes(ops["tile_q"], ops["tile_f"])
    _check_rope(ops, n_buffers, lanes, mxu=True)
    dev = ops["seed"].device
    if dev.type == "cpu":
        return rope_mxu_argmin_plain(ops, n_buffers, use_bf16, lanes=lanes)
    q_pad = ops["seed"].shape[0]
    if not q_pad:
        return _no_walk(dev, 4)
    from .. import _build

    n_t = q_pad // ops["tile_q"]
    out_d = torch.empty(q_pad, dtype=torch.float32, device=dev)
    out_i = torch.empty(q_pad, dtype=torch.int32, device=dev)
    out_lv = torch.empty(n_t, dtype=torch.int32, device=dev)
    out_rep = torch.empty(n_t, dtype=torch.int32, device=dev)
    _build.launch("rope_mxu_faces", dev, ops["pts_s"], ops["p2"],
                  ops["seed"], ops["boxes"], ops["topo"], ops["rec"], out_d,
                  out_i, out_lv, out_rep, q_pad, ops["boxes"].shape[0],
                  ops["rec"].shape[0], ops["tile_q"], ops["tile_f"],
                  n_buffers or 0, int(bool(use_bf16)), lanes)
    LAUNCHES["rope_mxu_stream" if n_buffers else "rope_mxu_resident"] += 1
    return out_d, out_i, out_lv, out_rep


# ---------------------------------------------------------------------------
# Whole queries.

def rope_operands(v, f, points, tile_q=128, tile_f=256, index=None,
                  rebuild_mismatched=False, device="cuda", mxu=False,
                  records=False):
    """The operand dict of a rope query on ``device``: the coarse index
    from the cache (or ``index``), its arrays uploaded once per device,
    and the shared prologue (with ``mxu``, the MXU walk's; with
    ``records``, also the face records the streamed ``rope_faces`` kernel
    reads)."""
    dev = resolve_device(device)
    index = _coarse_index(v, f, tile_f, index, rebuild_mismatched)
    arr = index.on(dev)
    return _rope_operands(
        as_tensor(v, dev, torch.float32), as_tensor(f, dev),
        as_tensor(points, dev, torch.float32).reshape(-1, 3),
        arr["order"], arr["center"], arr["node_lo"], arr["node_hi"],
        arr["node_skip"], arr["node_leaf"], int(tile_q), int(tile_f), mxu,
        records)


def _closest_point_rope(v, f, points, tile_q, tile_f, n_buffers, index,
                        rebuild_mismatched, device, argmin, records=False):
    ops = rope_operands(v, f, points, tile_q, tile_f, index,
                        rebuild_mismatched, device, records=records)
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
                               index, rebuild_mismatched, device, rope_argmin,
                               records=True)


def closest_point_bvh_stream_plain(v, f, points, tile_q=128, tile_f=256,
                                   n_buffers=2, index=None,
                                   rebuild_mismatched=False, device="cuda"):
    """``closest_point_bvh_stream_kernel`` with the plain walk on any
    device."""
    _check_stream(tile_f)
    return _closest_point_rope(v, f, points, tile_q, tile_f, int(n_buffers),
                               index, rebuild_mismatched, device,
                               rope_argmin_plain)


def _closest_point_rope_mxu(v, f, points, tile_q, tile_f, n_buffers, index,
                            rebuild_mismatched, use_bf16, with_stats, device,
                            argmin):
    ops = rope_operands(v, f, points, tile_q, tile_f, index,
                        rebuild_mismatched, device, mxu=True)
    _, out_i, out_lv, out_rep = argmin(ops, n_buffers, use_bf16)
    res = _rope_epilogue(ops, out_i, out_lv)
    if not with_stats:
        return res
    return res, {"screened": int(out_lv.sum()), "repaired": int(out_rep.sum())}


def closest_point_bvh_mxu_kernel(v, f, points, tile_q=128, tile_f=256,
                                 index=None, rebuild_mismatched=False,
                                 use_bf16=False, with_stats=False,
                                 device="cuda"):
    """Closest point through the resident rope walk with the MXU leaf
    visit: the result dict of ``closest_point_bvh_kernel`` (faces equal
    to it up to distance ties).  ``use_bf16`` puts the bf16 screen before
    each leaf's full visit, which changes no answer.  ``with_stats=True``
    also returns ``{"screened": leaves taken, "repaired": full visits}``
    (equal without the screen), summed over query tiles."""
    return _closest_point_rope_mxu(v, f, points, tile_q, tile_f, None, index,
                                   rebuild_mismatched, use_bf16, with_stats,
                                   device, rope_mxu_argmin)


def closest_point_bvh_mxu_plain(v, f, points, tile_q=128, tile_f=256,
                                index=None, rebuild_mismatched=False,
                                use_bf16=False, with_stats=False,
                                device="cuda"):
    """``closest_point_bvh_mxu_kernel`` with the plain walk on any
    device."""
    return _closest_point_rope_mxu(v, f, points, tile_q, tile_f, None, index,
                                   rebuild_mismatched, use_bf16, with_stats,
                                   device, rope_mxu_argmin_plain)


def closest_point_bvh_stream_mxu_kernel(v, f, points, tile_q=128, tile_f=256,
                                        n_buffers=2, index=None,
                                        rebuild_mismatched=False,
                                        use_bf16=False, with_stats=False,
                                        device="cuda"):
    """Closest point through the streamed rope walk with the MXU leaf
    visit: the result of ``closest_point_bvh_mxu_kernel`` bit for bit,
    with ``pair_tests`` at least as large.  ``tile_f`` must be a multiple
    of 128 and ``n_buffers`` at least 2, and the ring must fit
    ``MAX_RING_BYTES``."""
    _check_stream(tile_f)
    return _closest_point_rope_mxu(v, f, points, tile_q, tile_f,
                                   int(n_buffers), index, rebuild_mismatched,
                                   use_bf16, with_stats, device,
                                   rope_mxu_argmin)


def closest_point_bvh_stream_mxu_plain(v, f, points, tile_q=128, tile_f=256,
                                       n_buffers=2, index=None,
                                       rebuild_mismatched=False,
                                       use_bf16=False, with_stats=False,
                                       device="cuda"):
    """``closest_point_bvh_stream_mxu_kernel`` with the plain walk on any
    device."""
    _check_stream(tile_f)
    return _closest_point_rope_mxu(v, f, points, tile_q, tile_f,
                                   int(n_buffers), index, rebuild_mismatched,
                                   use_bf16, with_stats, device,
                                   rope_mxu_argmin_plain)
