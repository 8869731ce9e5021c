"""Shape-bucketed plan cache (counterpart of mesh_tpu/engine/planner.py).

A caller that shows up with a new query count Q (or batch size B) would
otherwise pay the host's whole chain of launches for that exact shape.
The planner collapses the shapes and replays a recorded plan:

1. **Bucketing**: Q and B (and the camera count C) pad up a small
   geometric ladder by replicating the edge row.  Every per-query, per-mesh
   and per-camera result is independent of the others, so the real rows
   are the direct path's bits and the padded rows are sliced off.
2. **Plan cache**: one plan per ``(op, B-bucket, Q-bucket, V, F, dtype,
   strategy, ..., device)`` key, kept in an LRU of ``max_plans``.
   - On the card a plan is a CUDA graph (``torch.cuda.CUDAGraph``) of
     ``batch.batch_step`` or ``batch.visibility_step``, captured at the
     bucket's shapes with static input and output tensors.  A dispatch
     copies the padded inputs into the input tensors (the faces and their
     vertex CSR too: the graph never keeps a stale topology), replays the
     graph and copies the real rows out, all on the planner's stream and
     under its lock; events order that stream after the caller's pending
     work and the caller's reads after it (no device-wide sync).  Every
     plan allocates from one graph memory pool.  A miss runs the step
     once eagerly on the padded inputs (the warm-up a capture wants) and
     then captures it; its answer, like every later one, is a replay.
   - On the CPU a plan is the same step called eagerly at the bucket's
     shapes, so the keys, the LRU, the padding, the slicing and the
     stats run there too.
   Nothing that the captured step decides on the host may depend on more
   than the key: the brute/culled switch is F's, the degenerate-face tail
   is ``nondegen``'s, the tile is ``variant``'s, and every shape check
   reads the bucket's shapes.  A capture or replay that fails raises; the
   request's future carries the error, and nothing reruns it eagerly or
   on the direct path.
3. **Launch counts**: each kernel wrapper's launch count (and the
   closest-point route count ``query.culled.STRATEGY``) is a Python side
   effect that a capture runs and a replay does not.  A plan keeps what
   its capture added, takes it back (a capture executes nothing) and adds
   it again on each replay, so every count is the number of executions
   on the card; the warm-up run counts as the launches it is.
4. **Warm-up**: ``warmup()`` makes the plans of the SMPL- and
   FLAME-shaped buckets on zero-filled placeholders, so the first real
   request of a process is already a replay.

``MESH_TPU_NO_ENGINE=1`` (utils/knobs.no_engine) routes every facade back
to its direct path.
"""

import threading
from collections import OrderedDict

import numpy as np
import torch

from ..geometry.vert_normals import vertex_csr
from ..obs.clock import monotonic as _now
from ..obs.recorder import get_recorder
from ..obs.trace import span as obs_span
from ..obs.trace import timed_span
from ..utils.device import resolve_device
from .stats import STATS

__all__ = [
    "Q_LADDER", "B_LADDER", "bucket_size", "Planner", "get_planner",
    "warmup", "MODEL_SHAPES",
]

#: geometric ladder of query-count buckets.  The bottom rung keeps tiny
#: probe queries from making one plan per Q; past the top rung sizes round
#: up to the next multiple of it (pad waste <= 50% everywhere, and <=
#: top-rung / Q for the giant sizes).
Q_LADDER = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)

#: mesh-batch (and camera-count) ladder; starts at 1 so single-mesh facade
#: calls pad nothing.
B_LADDER = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)


def bucket_size(n, ladder):
    """Smallest ladder rung >= n (next multiple of the top rung beyond)."""
    n = int(n)
    if n <= 0:
        raise ValueError("bucket_size wants a positive count, got %d" % n)
    for b in ladder:
        if n <= b:
            return b
    top = ladder[-1]
    return ((n + top - 1) // top) * top


def _pad_edge(x, target, axis):
    """Pad ``x`` up to ``target`` along ``axis`` by replicating its edge
    row (numpy in -> numpy out, tensor in -> tensor out on its device: the
    single-mesh facades hand the planner their cached device arrays, which
    must not take a host round trip)."""
    n = x.shape[axis]
    if n == target:
        return x
    if torch.is_tensor(x):
        edge = x.narrow(axis, n - 1, 1)
        shape = list(x.shape)
        shape[axis] = target - n
        return torch.cat([x, edge.expand(shape)], dim=axis)
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, target - n)
    return np.pad(x, widths, mode="edge")


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "") if torch.is_tensor(x) \
        else np.dtype(x.dtype).name


def _tensor(x):
    """A plan input as a tensor: tensors as they are, numpy arrays as CPU
    tensors on their memory (a copy where the array is not writable, as a
    broadcast view is not)."""
    if x is None or torch.is_tensor(x):
        return x
    return torch.from_numpy(np.require(x, requirements=["C", "W"]))


def _plan_device(device):
    """``device`` with its index: ``cuda`` and ``cuda:0`` are one card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _tree_map(fn, out):
    """``fn`` on every tensor of ``out`` (a tensor, None, or a tuple, list
    or dict of them)."""
    if out is None:
        return None
    if isinstance(out, dict):
        return {k: _tree_map(fn, v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_tree_map(fn, v) for v in out)
    return fn(out)


def _launch_counts():
    """The launch-count dicts of every kernel wrapper and the
    closest-point route counts: the Python side effects of a step."""
    from ..accel import refit_kernel, rope_kernel
    from ..query import (
        closest_kernel,
        culled,
        culled_kernel,
        mxu_kernel,
        normal_weighted,
        ray_kernel,
        tri_tri_kernel,
    )

    return (closest_kernel.LAUNCHES, culled_kernel.LAUNCHES,
            ray_kernel.LAUNCHES, rope_kernel.LAUNCHES,
            normal_weighted.LAUNCHES, tri_tri_kernel.LAUNCHES,
            tri_tri_kernel.TILE_LAUNCHES, refit_kernel.LAUNCHES,
            mxu_kernel.LAUNCHES, culled.STRATEGY)


def _counts_snapshot():
    return [dict(counts) for counts in _launch_counts()]


def _counts_added(before):
    """Per count dict, what was added since the snapshot ``before``."""
    return [{k: n - old.get(k, 0) for k, n in counts.items()
             if n != old.get(k, 0)}
            for old, counts in zip(before, _launch_counts())]


def _counts_apply(added, sign, before=None):
    """Add ``sign`` times ``added`` to the live counts; a key that falls
    back to 0 and was not in the snapshot ``before`` is removed."""
    for counts, delta, old in zip(_launch_counts(), added,
                                  before or [{}] * len(added)):
        for k, n in delta.items():
            counts[k] = counts.get(k, 0) + sign * n
            if before is not None and not counts[k] and k not in old:
                del counts[k]


class EagerPlan(object):
    """A plan on the CPU: the step called eagerly at the bucket's shapes."""

    backend = "cpu"
    replay_counts = ()

    def __init__(self, fn, device):
        self.fn = fn
        self.device = device
        self.runs = 0

    def run(self, inputs, extract):
        self.runs += 1
        return extract(self.fn(*[None if x is None else
                                 _tensor(x).to(self.device)
                                 for x in inputs]))


class GraphPlan(object):
    """A plan on the card: a CUDA graph of the step captured at the
    bucket's shapes on ``stream``, allocating from ``pool``.  ``inputs``
    (bucket-shaped, placeholders or a real request's) are copied into the
    static input tensors; the step runs once on them eagerly (the warm-up)
    and is then captured.  ``runs`` counts the graph's replays."""

    backend = "cuda"

    def __init__(self, fn, inputs, device, stream, pool):
        self.device = device
        self.stream = stream
        self.runs = 0
        inputs = [_tensor(x) for x in inputs]
        caller = torch.cuda.current_stream(device)
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            self.static_in = [
                None if x is None else torch.empty(
                    tuple(x.shape), dtype=x.dtype, device=device)
                for x in inputs]
            self._copy_in(inputs)
            fn(*self.static_in)
            before = _counts_snapshot()
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                self.static_out = fn(*self.static_in)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass                # the capture's own error is raised
                raise
            finally:
                self.replay_counts = _counts_added(before)
                _counts_apply(self.replay_counts, -1, before)
            graph.capture_end()
        self.graph = graph
        caller.wait_stream(stream)

    def _copy_in(self, inputs):
        """Copy ``inputs`` into the static inputs on the planner's stream;
        a caller's card tensor is marked as used there, so the allocator
        does not hand its memory to another stream before the copy ran."""
        for static, x in zip(self.static_in, inputs):
            if static is not None:
                x = _tensor(x)
                if x.is_cuda:
                    x.record_stream(self.stream)
                static.copy_(x)

    def run(self, inputs, extract):
        """Copy ``inputs`` in, replay, and return ``extract`` of the static
        outputs, copied out (the next replay overwrites them)."""
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            self._copy_in(inputs)
            self.graph.replay()
            out = _tree_map(torch.clone, extract(self.static_out))
        self.runs += 1
        _counts_apply(self.replay_counts, 1)
        caller.wait_stream(self.stream)
        return _tree_map(lambda t: _handed_over(t, caller), out)


def _handed_over(t, stream):
    """``t``, made on the planner's stream, marked as used on ``stream`` so
    the allocator does not reuse it before that stream's work on it."""
    t.record_stream(stream)
    return t


class Planner(object):
    """LRU of plans keyed on (op, buckets, topology shape, dtype, strategy,
    device).  Thread-safe: the coalescing executor's worker and direct
    facade callers share one planner, and every dispatch runs under its
    lock."""

    def __init__(self, q_ladder=Q_LADDER, b_ladder=B_LADDER, max_plans=64):
        self.q_ladder = tuple(q_ladder)
        self.b_ladder = tuple(b_ladder)
        self.max_plans = int(max_plans)
        self._plans = OrderedDict()
        self._lock = threading.RLock()
        self._graph_ctx = {}        # device -> (stream, graph pool handle)

    # ------------------------------------------------------------------
    # cache core

    def _get_or_compile(self, key, make):
        """The plan for ``key``, made by ``make()`` on a miss (inside the
        lock: two threads racing on one cold key make one plan)."""
        with obs_span("engine.plan", op=str(key[0])) as sp:
            with self._lock:
                plan = self._plans.get(key)
                if plan is not None:
                    self._plans.move_to_end(key)
                    STATS.record_plan_hit()
                    sp.set(outcome="hit")
                    return plan
                t0 = _now()
                plan = make()
                compile_seconds = plan.make_s = _now() - t0
                STATS.record_plan_miss(compile_seconds)
                sp.set(outcome="compile",
                       compile_seconds=round(compile_seconds, 3))
                self._plans[key] = plan
                while len(self._plans) > self.max_plans:
                    self._plans.popitem(last=False)
                    STATS.record_plan_eviction()
                self._release_idle_pools()
                return plan

    def _make_plan(self, fn, inputs, device):
        """The plan of ``fn`` on the bucket-shaped ``inputs``."""
        if device.type != "cuda":
            return EagerPlan(fn, device)
        ctx = self._graph_ctx.get(device)
        if ctx is None:
            with torch.cuda.device(device):
                ctx = self._graph_ctx[device] = (
                    torch.cuda.Stream(device), torch.cuda.graph_pool_handle())
        return GraphPlan(fn, inputs, device, *ctx)

    def _dispatch(self, key, fn, inputs, device, extract, op):
        """Plan, then dispatch and slice under the lock -> (output,
        seconds, backend).  Every answer is the plan's run, a miss's too.
        The seconds cover the dispatch and its device work, waited for on
        the caller's stream after the lock is released."""
        plan = self._get_or_compile(
            key, lambda: self._make_plan(fn, inputs, device))
        with timed_span("engine.dispatch", op=op) as disp:
            with self._lock:
                out = plan.run(inputs, extract)
            disp.watch(out)
        return out, disp.elapsed, plan.backend

    def cached_keys(self):
        with self._lock:
            return list(self._plans.keys())

    def plan_info(self):
        """Per cached plan, least recently used first: its key, backend,
        the seconds it took to make, the answers it gave (``runs``: on the
        card, replays) and the launch counts each replay adds (none for a
        CPU plan)."""
        with self._lock:
            out = []
            for key, plan in self._plans.items():
                per_replay = {}
                for counts in plan.replay_counts:
                    per_replay.update(counts)
                out.append({"key": [str(k) for k in key],
                            "backend": plan.backend, "make_s": plan.make_s,
                            "runs": plan.runs,
                            "replay_launches": per_replay})
            return out

    def clear(self):
        with self._lock:
            self._plans.clear()
            self._release_idle_pools()

    def _release_idle_pools(self):
        """Forget the graph pool of a card once no cached plan captures
        into it: the allocator frees a pool whose last graph is gone, and
        a capture into that freed pool's handle fails, so the next plan
        there starts a new pool."""
        live = {plan.device for plan in self._plans.values()
                if plan.backend == "cuda"}
        for device in list(self._graph_ctx):
            if device not in live:
                del self._graph_ctx[device]

    def pool_bytes(self, device="cuda"):
        """Bytes of the segments the card's allocator holds in the plans'
        graph memory pool (0 before the first capture)."""
        ctx = self._graph_ctx.get(_plan_device(device))
        if ctx is None:
            return 0
        pool = tuple(ctx[1])
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    # ------------------------------------------------------------------
    # closest-point / normals plans (batch.batch_step)

    @staticmethod
    def _batch_step_key(op, bb, qb, n_verts, n_faces, dtype, use_pallas,
                        use_culled, chunk, with_normals, nondegen, variant,
                        device):
        return (op, bb, qb, n_verts, n_faces, np.dtype(dtype).name,
                use_pallas, use_culled, chunk, with_normals, nondegen,
                variant, str(device))

    @staticmethod
    def _batch_step_fn(with_normals, nondegen, variant, use_pallas=True,
                       chunk=512):
        from ..batch import batch_step

        def step(vs, f, pts, offsets, slot_faces):
            return batch_step(
                vs, f, pts, with_normals=with_normals,
                assume_nondegenerate=nondegen, tile_variant=variant,
                csr=None if offsets is None else (offsets, slot_faces),
                use_pallas=use_pallas, chunk=chunk)
        return step

    def run_batch_step(self, v, f, pts, *, use_pallas, use_culled, chunk,
                       with_normals, nondegen, variant, op, records=None,
                       device="cuda"):
        """Bucket-pad -> plan -> dispatch -> slice for ``batch.batch_step``.

        :param v: [B, V, 3] float32 vertices (numpy or tensor)
        :param f: [F, 3] int faces (numpy or tensor)
        :param pts: [B, Q, 3] float32 queries, or None (normals only)
        :param records: optional list of ``obs.ledger.RequestRecord`` to
            stamp at the plan, dispatch and device boundaries (the
            executor passes the coalesced group's records through).
        :param device: where numpy inputs run (a tensor ``v`` runs on its
            own device).
        :returns: ``(normals, res)`` as ``batch_step``'s, on the device,
            sliced back to the caller's B and Q.
        """
        dev = _plan_device(v.device if torch.is_tensor(v) else device)
        n_batch, n_verts = v.shape[0], v.shape[1]
        bb = bucket_size(n_batch, self.b_ladder)
        with obs_span("engine.submit", op=op, b=n_batch, bucket_b=bb) as sub:
            vs = _pad_edge(v, bb, axis=0)
            if pts is None:
                qb = n_queries = None
                pts_p = None
            else:
                n_queries = pts.shape[1]
                qb = bucket_size(n_queries, self.q_ladder)
                pts_p = _pad_edge(_pad_edge(pts, qb, axis=1), bb, axis=0)
                sub.set(q=n_queries, bucket_q=qb)
            csr = (vertex_csr(f, n_verts, dev) if with_normals
                   else (None, None))
            key = self._batch_step_key(
                op, bb, qb, n_verts, f.shape[0], _dtype_name(vs), use_pallas,
                use_culled, chunk, with_normals, nondegen, variant, dev)

            def extract(out):
                normals, res = out
                return (None if normals is None else normals[:n_batch],
                        None if res is None else {
                            k: val[:n_batch, :n_queries] for k, val
                            in res.items()})

            for rec in records or ():
                rec.stamp("compile")
            (normals, res), seconds, backend = self._dispatch(
                key, self._batch_step_fn(with_normals, nondegen, variant,
                                         use_pallas, chunk),
                (vs, f, pts_p) + tuple(csr), dev, extract, op)
            for rec in records or ():
                rec.stamp("device")
                rec.set(backend=backend)
            STATS.record_dispatch(op, seconds, backend=backend)
            STATS.record_padding(n_batch * (n_queries or 1), bb * (qb or 1))
            get_recorder().record(
                "engine.dispatch", op=op, b=n_batch, q=n_queries or 0,
                bucket_b=bb, bucket_q=qb or 0,
                elapsed_ms=round(1e3 * (seconds or 0.0), 3))
        return normals, res

    # ------------------------------------------------------------------
    # visibility plans (batch.visibility_step)

    def run_visibility_step(self, v, f, cams, normals, min_dist, *,
                            use_pallas, chunk, with_normals, device="cuda"):
        """Bucket-pad -> plan -> dispatch -> slice for
        ``batch.visibility_step``: B and the camera count C are both
        bucketed (per-mesh and per-camera results are independent).
        ``normals`` [B, V, 3] is read unless ``with_normals`` computes the
        vertex normals in the step (then it may be None).  ``min_dist``
        is part of the key: the step folds it into its rays as a
        constant."""
        dev = _plan_device(v.device if torch.is_tensor(v) else device)
        n_batch, n_verts = v.shape[0], v.shape[1]
        n_cams = cams.shape[0]
        bb = bucket_size(n_batch, self.b_ladder)
        cb = bucket_size(n_cams, self.b_ladder)
        min_dist = float(min_dist)
        key = ("visibility", bb, cb, n_verts, f.shape[0], _dtype_name(v),
               use_pallas, chunk, with_normals, min_dist, str(dev))
        inputs = (_pad_edge(v, bb, axis=0), f, _pad_edge(cams, cb, axis=0),
                  None if with_normals else _pad_edge(normals, bb, axis=0))
        inputs += (tuple(vertex_csr(f, n_verts, dev)) if with_normals
                   else (None, None))

        from ..batch import visibility_step

        def step(vs, f, cams, nrm, offsets, slot_faces):
            return visibility_step(
                vs, f, cams, nrm, min_dist,
                csr=None if offsets is None else (offsets, slot_faces),
                use_pallas=use_pallas, chunk=chunk)

        def extract(out):
            return out[0][:n_batch, :n_cams], out[1][:n_batch, :n_cams]

        with obs_span("engine.submit", op="visibility", b=n_batch,
                      bucket_b=bb, cams=n_cams, bucket_c=cb):
            (vis, ndc), seconds, backend = self._dispatch(
                key, step, inputs, dev, extract, "visibility")
            STATS.record_dispatch("visibility", seconds, backend=backend)
            STATS.record_padding(n_batch * n_cams, bb * cb)
            get_recorder().record(
                "engine.dispatch", op="visibility", b=n_batch, q=n_cams,
                bucket_b=bb, bucket_q=cb,
                elapsed_ms=round(1e3 * (seconds or 0.0), 3))
        return vis, ndc

    # ------------------------------------------------------------------
    # spatial-index companions (accel)

    def accel_companion(self, v, f, kind="bvh", **params):
        """The spatial index of this topology, the engine-routed door to
        ``accel.build.get_index``.  The index is not a plan, so it does not
        live in the plan LRU: accel keeps its own digest-keyed cache, and
        this method only puts its lookups under an engine span."""
        from ..accel.build import get_index

        with obs_span("engine.accel_index", kind=str(kind)) as sp:
            index = get_index(v, f, kind=kind, **params)
            sp.set(digest=index.digest, faces=int(index.meta["n_faces"]))
        return index


_PLANNER = None
_PLANNER_LOCK = threading.Lock()


def get_planner():
    """The process-wide planner (one plan cache per process)."""
    global _PLANNER
    with _PLANNER_LOCK:
        if _PLANNER is None:
            _PLANNER = Planner()
        return _PLANNER


#: (V, F) of the body and face model topologies traffic sees most;
#: ``warmup()`` makes their buckets' plans
MODEL_SHAPES = {
    "smpl": (6890, 13776),
    "flame": (5023, 9976),
}


def warmup(mesh_shapes=None, q_buckets=(512, 1024), b_buckets=(1,),
           ops=("closest_point", "fused"), chunk=512, device="cuda"):
    """Make the plans steady-state traffic will hit, on zero-filled
    placeholders of their shapes: no model files or mesh data are needed,
    only topology shapes.

    :param mesh_shapes: iterable of (V, F) pairs; default SMPL + FLAME.
    :param q_buckets: query-count rungs to plan per shape.
    :param b_buckets: mesh-batch rungs to plan per shape.
    :param ops: any of "closest_point" (queries only) and "fused"
        (normals + queries in one dispatch).
    :param chunk: the plan key's chunk (the facades' default 512).
    :param device: the card (default) or the CPU the plans are for.
    :returns: number of NEW plans made (0 when already warm).
    """
    from ..batch import _strategy
    from ..utils.knobs import safe_tiles, tile_variant

    dev = _plan_device(device)
    planner = get_planner()
    # traffic arrives with the data-derived nondegeneracy flag either way
    nondegens = (False,) if safe_tiles() else (False, True)
    variant = tile_variant()
    if mesh_shapes is None:
        mesh_shapes = MODEL_SHAPES.values()

    made = 0
    for n_verts, n_faces in mesh_shapes:
        f0 = torch.zeros((n_faces, 3), dtype=torch.int64, device=dev)
        use_pallas, use_culled = _strategy(f0, dev)
        for op in ops:
            with_normals = op == "fused"
            for bb in b_buckets:
                for qb in q_buckets:
                    zeros = (torch.zeros((bb, n_verts, 3), device=dev), f0,
                             torch.zeros((bb, qb, 3), device=dev))
                    zeros += ((torch.zeros(n_verts + 1, dtype=torch.int64,
                                           device=dev),
                               torch.zeros(3 * n_faces, dtype=torch.int64,
                                           device=dev))
                              if with_normals else (None, None))
                    for nondegen in nondegens:
                        key = planner._batch_step_key(
                            op, bb, qb, n_verts, n_faces, np.float32,
                            use_pallas, use_culled, chunk, with_normals,
                            nondegen, variant, dev)
                        before = STATS.snapshot()["plan_cache"]["misses"]
                        fn = planner._batch_step_fn(with_normals, nondegen,
                                                    variant, use_pallas,
                                                    chunk)
                        planner._get_or_compile(
                            key, lambda fn=fn, zeros=zeros:
                            planner._make_plan(fn, zeros, dev))
                        after = STATS.snapshot()["plan_cache"]["misses"]
                        made += after - before
    return made
