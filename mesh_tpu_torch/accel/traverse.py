"""The accel rung of the auto ladder: which rope walk serves a mesh, the
reference's plain BVH walk and grid probe, and
``closest_faces_and_points_accel`` (counterpart of
mesh_tpu/accel/traverse.py).

``pallas_bvh_variant`` keeps the reference's name and routing: the
resident walk when the fast tile's face planes (19 float32 rows over the
padded face count) fit the ``MESH_TPU_BVH_STREAM_VMEM_MB`` budget, the
streamed walk above it or under ``MESH_TPU_BVH_STREAM_FORCE``, and with
``MESH_TPU_BVH_STREAM=0`` the resident walk up to ``PALLAS_BVH_MAX_FACES``
and nothing (``None``) above.  Both walks are exact and bit-identical to
each other, so the budget only decides how leaves reach the kernel.
Under ``MESH_TPU_MXU`` from ``mxu_crossover_faces()`` faces on, the chosen
walk visits its leaves with the MXU tile (``rope_mxu_faces``), behind the
bf16 screen under ``MESH_TPU_MXU_BF16``, whose outcomes feed
``mesh_tpu_query_mxu_repair_total{kind="bvh"|"stream"}``, as in the
reference (mesh_tpu/accel/traverse.py:383-470).

The reference's XLA traversal is here in plain PyTorch, on the tensors'
device: ``_bvh_query`` walks the stackless rope as a frontier loop (every
query holds its ``node``; all advance together, descending into a
surviving node by ``node + 1`` and pruning or finishing a leaf by
``node = skip[node]``, until every query reaches the sentinel), carrying
its running best so deeper subtrees are pruned against a tightening bound;
``_grid_query`` probes the 3x3x3 cell neighbourhood of each query through
the grid's dense capacity table.  Box and block bounds are shrunk by the
index's ``prune_slack``, so float32 rounding never prunes a winner or a
tie, and every pair and the winner's recompute use the plain scan's own
arithmetic and frame (``query/closest_point.py``) with ties to the lowest
face id: a tight answer is the plain scan's bit for bit.  Each query
carries a certificate: ``tight`` is False where the grid's best reaches
its searched block's boundary or a touched cell overflowed, or where the
walk hit its step cap (``steps <= n_nodes``, which a well-formed index
never reaches).  This route serves a grid index, a BVH above
``PALLAS_BVH_MAX_FACES`` under ``MESH_TPU_BVH_STREAM=0``, and every mesh
under ``MESH_TPU_FORCE_XLA`` (``backend="xla"``); its loose queries re-run
through the plain scan, so it equals the plain scan bit for bit.

As in the reference, a traversal runs inside an ``accel.traverse`` span,
counts its pair tests in ``mesh_tpu_accel_pair_tests_total{kind}`` and,
given a ledger record, stamps its ``device`` stage and ``backend``.
"""

import numpy as np
import torch

from ..obs.metrics import REGISTRY
from ..obs.trace import span as obs_span
from ..utils import knobs
from ..utils.device import as_tensor, host_array, resolve_device
from ..utils.dispatch import pallas_default
from ..query.autotune import mxu_crossover_faces, stream_tile_params
from ..query.closest_kernel import N_FACE_ROWS, closest_point_kernel
from ..query.closest_point import closest_faces_and_points_t, replace_rows
from ..query.point_triangle import (
    closest_point_barycentric,
    closest_point_on_triangle,
)
from .build import get_index
from .rope_kernel import (
    closest_point_bvh_kernel,
    closest_point_bvh_mxu_kernel,
    closest_point_bvh_stream_kernel,
    closest_point_bvh_stream_mxu_kernel,
)

__all__ = [
    "bvh_closest_point", "grid_closest_point", "bvh_search_faces",
    "closest_faces_and_points_accel", "PALLAS_BVH_MAX_FACES",
    "pallas_bvh_max_faces", "pallas_bvh_variant", "resident_rows_bytes",
]

#: the resident walk's face ceiling when the streamed walk is switched off
PALLAS_BVH_MAX_FACES = 65536

#: tile_f of the resident walk (the reference's default)
RESIDENT_TILE_F = 256


def _rope_fp(n_faces, tile_f):
    """Padded face count of the coarse rope index: ``tile_f`` times the
    next power-of-two leaf count (build_bvh's complete-tree padding)."""
    n_leaves = max(1, -(-int(n_faces) // int(tile_f)))
    depth = int(np.ceil(np.log2(n_leaves))) if n_leaves > 1 else 0
    return (1 << depth) * int(tile_f)


def resident_rows_bytes(n_faces, tile_f=RESIDENT_TILE_F):
    """Bytes of the resident walk's face planes for ``n_faces``: 19
    float32 rows over the padded face count."""
    return N_FACE_ROWS * _rope_fp(n_faces, tile_f) * 4


def pallas_bvh_variant(n_faces, tile_f=RESIDENT_TILE_F):
    """``"resident"``, ``"stream"`` or ``None`` for ``n_faces`` under the
    current knobs (module docstring)."""
    if not knobs.bvh_stream_enabled():
        return "resident" if n_faces <= PALLAS_BVH_MAX_FACES else None
    if knobs.bvh_stream_force():
        return "stream"
    if resident_rows_bytes(n_faces, tile_f) <= knobs.bvh_stream_vmem_budget():
        return "resident"
    return "stream"


def pallas_bvh_max_faces(tile_f=RESIDENT_TILE_F):
    """Largest face count the resident walk serves under the current
    budget: a power of two times ``tile_f``, or 0."""
    n_leaves = knobs.bvh_stream_vmem_budget() // (N_FACE_ROWS * 4
                                                  * int(tile_f))
    if n_leaves < 1:
        return 0
    pow2 = 1
    while pow2 * 2 <= n_leaves:
        pow2 *= 2
    return pow2 * int(tile_f)


def _record_pair_tests(n, kind):
    """Count the exact point-triangle pair tests the accel path ran."""
    REGISTRY.counter(
        "mesh_tpu_accel_pair_tests_total",
        "exact pair tests run by the accel traversal (label: kind)",
    ).inc(int(n), kind=kind)


# ---------------------------------------------------------------------------
# The reference's XLA traversal, in plain PyTorch

#: the "no face yet" id of a walk (int32's largest, as the reference's)
_BIG = 2 ** 31 - 1

#: frontier steps a block of the walk runs between two reads of its live
#: count (each read waits for the device)
WALK_SYNC_STEPS = 16

#: the fewest rows a block of the walk runs on: the active queries are
#: compacted into the next power of two of rows, down to this
WALK_MIN_ROWS = 64

#: the walk's per-query state
_WALK_STATE = ("node", "best_sq", "best_fid", "steps", "pairs")

#: queries a step of the grid probe (each takes 27 x cap pairs)
GRID_CHUNK = 2048


def _dense_frame(v, f, points):
    """The plain scan's conditioning (``closest_faces_and_points_t``):
    the caller's dtype, centered on the vertex mean; the same ops, so the
    walks' arithmetic is the scan's bit for bit."""
    points = points.to(v.dtype)
    center = v.mean(dim=0)
    vc = v - center
    pts = points - center
    tri = vc[f.long()]
    return vc, pts, center, tri[:, 0], tri[:, 1], tri[:, 2]


def _pair_sq(p, ag, bg, cg):
    """Reconstruction-form squared distances of queries ``p`` [N, 3] to
    their gathered faces [N, M, 3]: the plain scan's selection arithmetic,
    op for op."""
    bary, _ = closest_point_barycentric(p[:, None, :], ag, bg, cg)
    cp = bary[..., 0:1] * ag + bary[..., 1:2] * bg + bary[..., 2:3] * cg
    diff = p[:, None, :] - cp
    return (diff * diff).sum(dim=-1)


def _scalar(x, like):
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _walk_block(s, tree, n_steps):
    """``n_steps`` frontier steps of the rows of ``s`` (the walk's state
    and each row's query ``p`` in the plain scan's frame and ``pb`` in the
    index's), in place.  Every op has a fixed shape and no host read, so
    a block can be captured as a CUDA graph; a row whose walk has ended
    keeps its state."""
    order_p, node_lo, node_hi, node_skip, node_leaf, a, b, c, slack, lanes = tree
    leaf_size, n_nodes = lanes.numel(), node_skip.numel()
    nd, bs, bf, st, pr = (s[name] for name in _WALK_STATE)
    p, pb = s["p"], s["pb"]
    for _ in range(n_steps):
        live = (nd < n_nodes) & (st <= n_nodes)
        at = nd.clamp(max=n_nodes - 1)
        gap = torch.clamp(torch.maximum(node_lo[at] - pb, pb - node_hi[at]),
                          min=0.0)
        lb = torch.clamp((gap * gap).sum(dim=-1).sqrt() - slack, min=0.0)
        prune = (lb * lb).to(bs.dtype) > bs
        leaf = node_leaf[at]
        is_leaf = leaf >= 0
        test = live & is_leaf & ~prune
        ids = order_p[(leaf.clamp(min=0) * leaf_size)[:, None] + lanes]
        sq = _pair_sq(p, a[ids], b[ids], c[ids])
        dmin = sq.amin(dim=-1)
        fmin = torch.where(sq == dmin[:, None], ids,
                           torch.full_like(ids, _BIG)).amin(dim=-1)
        better = test & ((dmin < bs) | ((dmin == bs) & (fmin < bf)))
        step = torch.where(prune | is_leaf, node_skip[at].long(), nd + 1)
        bs.copy_(torch.where(better, dmin, bs))
        bf.copy_(torch.where(better, fmin, bf))
        pr.add_(test.to(torch.int32) * leaf_size)
        nd.copy_(torch.where(live, step, nd))
        st.add_(live.to(torch.int32))


def _block_runner(s, tree):
    """One block of WALK_SYNC_STEPS steps on ``s``: on the card a CUDA
    graph of it (captured here, after a warm-up on a copy of ``s``, which a
    capture does not step), eager on the CPU."""
    if not s["p"].is_cuda:
        return lambda: _walk_block(s, tree, WALK_SYNC_STEPS)
    side = torch.cuda.Stream(device=s["p"].device)
    side.wait_stream(torch.cuda.current_stream(s["p"].device))
    with torch.cuda.stream(side):
        _walk_block({k: x.clone() for k, x in s.items()}, tree, 1)
    torch.cuda.current_stream(s["p"].device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _walk_block(s, tree, WALK_SYNC_STEPS)
    return graph.replay


def _rows(x, n_rows, fill):
    """``x`` padded along dim 0 to ``n_rows`` with ``fill``."""
    pad = x.new_full((n_rows - x.shape[0],) + tuple(x.shape[1:]), fill)
    return torch.cat([x, pad])


def _bvh_query(v, f, points, order_p, node_lo, node_hi, node_skip,
               node_leaf, center_b, slack, leaf_size):
    """The stackless rope walk of every query as one frontier loop.

    Pruning runs in the index's float32 frame (``center_b``); leaf tests
    run in the plain scan's frame with ties to the lowest face id.  The
    active queries run in blocks of WALK_SYNC_STEPS steps (on the card a
    CUDA graph per block shape) on a power of two of rows; once three in
    four rows have ended, the rest are compacted onto fewer.  Returns a
    dict of ``face`` [Q] int32, ``tight`` [Q] bool (the walk reached the
    sentinel within its cap of ``n_nodes`` steps), ``pair_tests`` [Q]
    int32 and ``steps`` [Q] int32."""
    _, pts, _, a, b, c = _dense_frame(v, f, points)
    dev = pts.device
    q32 = points.to(torch.float32) - center_b
    n_nodes = node_skip.shape[0]
    n_q = pts.shape[0]
    tree = (order_p, node_lo, node_hi, node_skip, node_leaf, a, b, c,
            _scalar(slack, pts), torch.arange(leaf_size, device=dev))
    state = {
        "node": torch.zeros(n_q, dtype=torch.int64, device=dev),
        "best_sq": torch.full((n_q,), float("inf"), dtype=pts.dtype,
                              device=dev),
        "best_fid": torch.full((n_q,), _BIG, dtype=torch.int64, device=dev),
        "steps": torch.zeros(n_q, dtype=torch.int32, device=dev),
        "pairs": torch.zeros(n_q, dtype=torch.int32, device=dev)}
    # a padding row's walk has ended before it starts
    ended = {"node": n_nodes, "best_sq": float("inf"), "best_fid": _BIG,
             "steps": 0, "pairs": 0, "p": 0.0, "pb": 0.0}
    active = torch.arange(n_q, device=dev)
    while active.numel():
        n_act = active.numel()
        n_rows = max(WALK_MIN_ROWS, 1 << (n_act - 1).bit_length())
        s = {name: _rows(x[active], n_rows, ended[name]) for name, x in
             dict(state, p=pts, pb=q32).items()}
        run = _block_runner(s, tree)
        while True:
            run()
            live = int(((s["node"] < n_nodes)
                        & (s["steps"] <= n_nodes)).sum())
            if not live or (live <= n_rows // 4 and n_rows > WALK_MIN_ROWS):
                break
        for name in _WALK_STATE:
            state[name][active] = s[name][:n_act]
        active = active[(s["node"][:n_act] < n_nodes)
                        & (s["steps"][:n_act] <= n_nodes)]
    face = torch.where(state["best_fid"] == _BIG,
                       torch.zeros_like(state["best_fid"]),
                       state["best_fid"]).to(torch.int32)
    # the rope visits each node at most once, so the walk reaches the
    # sentinel within n_nodes steps; the cap is a safety valve against a
    # corrupted index, surfaced as a loose certificate
    return {"face": face, "tight": state["node"] >= n_nodes,
            "pair_tests": state["pairs"], "steps": state["steps"]}


def _grid_query(v, f, points, cell_table, cell_count, grid_lo, width,
                center_b, slack, res, cap, chunk=GRID_CHUNK):
    """The 27-cell neighbourhood probe through the dense capacity table,
    ``chunk`` queries a step.  ``tight`` iff a candidate was found, no
    touched cell overflowed its capacity, and the best distance stays
    ``slack`` short of the searched block's boundary (block sides on the
    grid's hull count as open: no face lies beyond it)."""
    _, pts, _, a, b, c = _dense_frame(v, f, points)
    dev = pts.device
    q32 = points.to(torch.float32) - center_b
    slack = _scalar(slack, pts)
    offs = torch.tensor([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                         for k in (-1, 0, 1)], dtype=torch.int64, device=dev)
    cell_table = cell_table.long()
    inf = torch.tensor(float("inf"), device=dev)
    out = {"face": [], "tight": [], "pair_tests": []}
    for q0 in range(0, max(pts.shape[0], 1), chunk):
        p, pb = pts[q0:q0 + chunk], q32[q0:q0 + chunk]
        cell = torch.floor((pb - grid_lo) / width).clamp(0, res - 1).long()
        cells = cell[:, None, :] + offs                       # [C, 27, 3]
        valid = ((cells >= 0) & (cells < res)).all(dim=-1)
        cl = cells.clamp(0, res - 1)
        cid = (cl[..., 0] * res + cl[..., 1]) * res + cl[..., 2]
        ids = torch.where(valid[..., None], cell_table[cid],
                          torch.full_like(cell_table[cid], -1)).reshape(
                              p.shape[0], 27 * cap)          # [C, 27 cap]
        found_mask = ids >= 0
        safe_ids = torch.where(found_mask, ids, torch.zeros_like(ids))
        sq = _pair_sq(p, a[safe_ids], b[safe_ids], c[safe_ids])
        sq = torch.where(found_mask, sq, inf.to(sq.dtype))
        dmin = sq.amin(dim=-1)
        found = torch.isfinite(dmin)
        fmin = torch.where(sq == dmin[:, None], ids,
                           torch.full_like(ids, _BIG)).amin(dim=-1)
        overflow = (valid & (cell_count[cid] > cap)).any(dim=-1)
        # the searched block's boundary, in the build frame
        blo = grid_lo + (cell - 1).clamp(min=0).to(width.dtype) * width
        bhi = grid_lo + ((cell + 1).clamp(max=res - 1) + 1).to(
            width.dtype) * width
        gap_lo = torch.where(cell - 1 <= 0, inf, pb - blo)
        gap_hi = torch.where(cell + 1 >= res - 1, inf, bhi - pb)
        bdist = torch.minimum(gap_lo.amin(dim=-1), gap_hi.amin(dim=-1))
        out["tight"].append(found & ~overflow & (
            dmin.sqrt().to(torch.float32) <= bdist - slack))
        out["face"].append(torch.where(found & (fmin != _BIG), fmin,
                                       torch.zeros_like(fmin)).to(
                                           torch.int32))
        out["pair_tests"].append(found_mask.sum(dim=-1).to(torch.int32))
    return {key: torch.cat(val) for key, val in out.items()}


def _winner_eval(pts, a, b, c, center):
    """The winner's exact point, squared distance and part, with the
    plain scan's ops (its epilogue), un-centered."""
    pt, sq, part = closest_point_on_triangle(pts, a, b, c)
    return pt + center, sq, part


def _core_search(index, v, f, points):
    """The walk (or probe) of ``index`` -> face / tight / pair_tests."""
    arr, meta = index.on(v.device), index.meta
    slack = float(np.float32(meta["prune_slack"]))
    if index.kind == "bvh":
        return _bvh_query(
            v, f, points, arr["order"].long(), arr["node_lo"],
            arr["node_hi"], arr["node_skip"], arr["node_leaf"],
            arr["center"], slack, int(meta["leaf_size"]))
    return _grid_query(
        v, f, points, arr["cell_table"], arr["cell_count"], arr["grid_lo"],
        arr["width"], arr["center"], slack, int(meta["res"]),
        int(meta["cap"]))


def _run_index(index, v, f, points):
    """The walk and the winner's recompute: the full result dict with
    ``tight`` and ``pair_tests`` (and a BVH's ``steps``)."""
    out = dict(_core_search(index, v, f, points))
    _, pts, center, a, b, c = _dense_frame(v, f, points)
    best = out["face"].long()
    out["point"], out["sqdist"], out["part"] = _winner_eval(
        pts, a[best], b[best], c[best], center)
    return out


def _walk_inputs(v, f, points, device):
    dev = resolve_device(device)
    return (as_tensor(v, dev, torch.float32),
            as_tensor(f if torch.is_tensor(f) else host_array(f, np.int64),
                      dev).long(),
            as_tensor(points, dev, torch.float32).reshape(-1, 3))


def bvh_closest_point(v, f, points, index=None, leaf_size=None, *,
                      device="cuda"):
    """The plain BVH walk over ``index`` (default: the digest cache's, at
    ``leaf_size``): the full result dict, tensors on ``device``, with
    ``tight``, ``pair_tests`` and ``steps``; loose queries are not re-run
    (``closest_faces_and_points_accel`` does that)."""
    v, f, points = _walk_inputs(v, f, points, device)
    if index is None:
        params = {} if leaf_size is None else {"leaf_size": int(leaf_size)}
        index = get_index(host_array(v, np.float32), host_array(f, np.int32),
                          kind="bvh", **params)
    return _run_index(index, v, f, points)


def grid_closest_point(v, f, points, index=None, *, device="cuda"):
    """The plain grid probe; the contract of ``bvh_closest_point``."""
    v, f, points = _walk_inputs(v, f, points, device)
    if index is None:
        index = get_index(host_array(v, np.float32), host_array(f, np.int32),
                          kind="grid")
    return _run_index(index, v, f, points)


def bvh_search_faces(index, v, f, points):
    """The winning faces [Q] int32 of the plain BVH walk over ``index``,
    on tensors on their own device: the search ``diff.closest_point``
    takes for an ``accel_index`` under ``MESH_TPU_FORCE_XLA`` (the walk is
    exact whenever it completes, and the step cap never trips on a
    well-formed index)."""
    if index.kind != "bvh":
        raise ValueError(
            "bvh_search_faces wants a 'bvh' index, got %r" % index.kind)
    return _core_search(index, v, f.long(), points)["face"]


def closest_faces_and_points_accel(v, f, points, kind=None, index=None,
                                   with_stats=False, record=None,
                                   device="cuda"):
    """Index-accelerated exact closest point, the accel rung of
    ``closest_faces_and_points_auto``: numpy in and out (``face``,
    ``part``, ``point``, ``sqdist``), exact up to distance ties.

    On the kernel route a BVH is served by the resident or the streamed
    rope walk, as ``pallas_bvh_variant`` says, over the coarse BVH at its
    ``tile_f`` from the digest cache (or ``index``, rebuilt at that leaf
    size if it differs); queries whose certificate is loose (none, with
    these conservative bounds) re-run through the brute-force kernel.  A
    grid, a BVH that no rope walk takes (``MESH_TPU_BVH_STREAM=0`` above
    ``PALLAS_BVH_MAX_FACES``) and every mesh under ``MESH_TPU_FORCE_XLA``
    take the plain walk (``_run_index``) over ``index`` or the digest
    cache's default index, its loose queries re-run through the plain
    scan: the plain scan's answer bit for bit.

    :param kind: ``"bvh"`` or ``"grid"``; default ``MESH_TPU_ACCEL_KIND``.
    :param with_stats: also return ``{"pair_tests", "fallback",
        "tight_frac", "kind", "backend"}`` with ``backend``
        ``"rope_resident"`` or ``"rope_stream"``, their MXU leaf-visit
        forms ``"rope_resident_mxu"`` / ``"rope_stream_mxu"``, or
        ``"xla"`` for the plain walk.
    :param record: optional ``obs.ledger.RequestRecord``; the traversal
        stamps its ``device`` stage and sets its ``backend``.
    """
    if kind is None:
        kind = index.kind if index is not None else knobs.accel_kind()
    dev = resolve_device(device)
    n_faces = int(f.shape[0])
    variant = (pallas_bvh_variant(n_faces)
               if kind == "bvh" and pallas_default(dev) else None)
    if variant is None:
        return _accel_xla(v, f, points, kind, index, with_stats, record,
                          dev)
    use_mxu = knobs.mxu_enabled() and n_faces >= mxu_crossover_faces()
    use_bf16 = use_mxu and knobs.mxu_bf16_enabled()
    v_t = as_tensor(v, dev)
    f_t = as_tensor(f if torch.is_tensor(f) else host_array(f, np.int64), dev)
    pts = as_tensor(points, dev).reshape(-1, 3)
    with obs_span("accel.traverse", kind=kind, faces=n_faces,
                  queries=int(pts.shape[0])) as sp:
        if variant == "resident" and use_mxu:
            backend = "rope_resident_mxu"
            res, mxu_stats = closest_point_bvh_mxu_kernel(
                v_t, f_t, pts, tile_f=RESIDENT_TILE_F, index=index,
                rebuild_mismatched=True, use_bf16=use_bf16, with_stats=True,
                device=dev)
        elif variant == "resident":
            backend = "rope_resident"
            res = closest_point_bvh_kernel(
                v_t, f_t, pts, tile_f=RESIDENT_TILE_F, index=index,
                rebuild_mismatched=True, device=dev)
        else:
            backend = "rope_stream_mxu" if use_mxu else "rope_stream"
            tile_q, tile_f, n_buffers = stream_tile_params()
            if use_mxu:
                res, mxu_stats = closest_point_bvh_stream_mxu_kernel(
                    v_t, f_t, pts, tile_q=tile_q, tile_f=tile_f,
                    n_buffers=n_buffers, index=index,
                    rebuild_mismatched=True, use_bf16=use_bf16,
                    with_stats=True, device=dev)
            else:
                res = closest_point_bvh_stream_kernel(
                    v_t, f_t, pts, tile_q=tile_q, tile_f=tile_f,
                    n_buffers=n_buffers, index=index,
                    rebuild_mismatched=True, device=dev)
        out = {key: val.cpu().numpy() for key, val in res.items()}
        tight = out.pop("tight")
        pairs = int(out.pop("pair_tests").astype(np.int64).sum())
        loose = np.nonzero(~tight)[0]
        sp.set(backend=backend, pair_tests=pairs, fallback=int(loose.size))
    if record is not None:
        record.stamp("device")
        record.set(backend=backend)
    _record_pair_tests(pairs, kind)
    if use_bf16:
        from ..query.culled import _record_mxu_repair

        _record_mxu_repair(mxu_stats["screened"], mxu_stats["repaired"],
                           "stream" if variant == "stream" else "bvh")
    if loose.size:
        from ..query.culled import _record_fallback

        _record_fallback(loose.size)
        fix = closest_point_kernel(
            v_t.float(), f_t, pts.float()[torch.as_tensor(loose, device=dev)])
        replace_rows(out, loose, fix)
    if with_stats:
        return out, {
            "pair_tests": pairs,
            "fallback": int(loose.size),
            "tight_frac": float(tight.mean()) if tight.size else 1.0,
            "kind": kind,
            "backend": backend,
        }
    return out


def _accel_xla(v, f, points, kind, index, with_stats, record, dev):
    """The plain-walk route of ``closest_faces_and_points_accel``."""
    v_t, f_t, pts = _walk_inputs(v, f, points, dev)
    if index is None:
        index = get_index(host_array(v_t, np.float32),
                          host_array(f_t, np.int32), kind=kind)
    with obs_span("accel.traverse", kind=kind, faces=int(f_t.shape[0]),
                  queries=int(pts.shape[0])) as sp:
        res = _run_index(index, v_t, f_t, pts)
        steps = res.pop("steps", None)
        out = {key: val.cpu().numpy() for key, val in res.items()}
        tight = out.pop("tight")
        pairs = int(out.pop("pair_tests").astype(np.int64).sum())
        loose = np.nonzero(~tight)[0]
        sp.set(backend="xla", pair_tests=pairs, fallback=int(loose.size))
    if record is not None:
        record.stamp("device")
        record.set(backend="xla")
    _record_pair_tests(pairs, kind)
    if loose.size:
        from ..query.culled import _record_fallback

        _record_fallback(loose.size)
        fix = closest_faces_and_points_t(
            v_t, f_t, pts[torch.as_tensor(loose, device=dev)])
        replace_rows(out, loose, fix)
    if with_stats:
        stats = {
            "pair_tests": pairs,
            "fallback": int(loose.size),
            "tight_frac": float(tight.mean()) if tight.size else 1.0,
            "kind": kind,
            "backend": "xla",
        }
        if steps is not None and steps.numel():
            stats.update(steps_max=int(steps.max()),
                         steps_mean=float(steps.float().mean()))
        return out, stats
    return out
