"""Coalescing async dispatch: many pending requests, one stacked launch
(counterpart of mesh_tpu/engine/executor.py).

The facades are synchronous: every caller pays its own host round trip
even when ten same-topology requests are in flight at once.  The executor
turns the facade into a submit/future API:

- ``submit(op, mesh, points)`` enqueues a request and returns a
  ``concurrent.futures.Future`` immediately;
- a worker thread drains everything pending, groups requests by (op,
  chunk, topology, vertex shape, device), stacks each group with
  ``batch.stack_mesh_batch`` (which re-validates the topology exactly),
  pads every request's queries to the group's common bucket, and
  dispatches the whole group through the planner as ONE stacked
  ``batch_step``;
- results are split back per request, bit-identical to what a sequential
  facade call would have returned (per-mesh rows and per-query columns
  are independent).

``hold()`` / ``release()`` (or the ``coalesce()`` context manager) fence
the worker so a burst of submits is sure to ride one dispatch; without
the fence, coalescing is opportunistic (the ``coalesce_window_ms``
tunable lets the worker linger for one).

The sharded big-batch lane (``_shard_eligible``) is off unless the
``shard_min_q`` tunable is set and ``MESH_TPU_FLEET_SHARD`` is on; a
request it admits runs the query-sharded plan's shard body on its own
card, with no device mesh or process group (``_dispatch_sharded``).
"""

import threading
from concurrent.futures import Future
from contextlib import contextmanager

import numpy as np

from ..errors import DeadlineExceeded, EngineShutdown
from ..obs.clock import monotonic as _now
from ..obs.context import bind_context
from ..obs.trace import span as obs_span
from ..utils import tuning
from ..utils.device import resolve_device
from .stats import STATS

__all__ = ["EngineExecutor", "EngineShutdown", "get_executor", "submit"]

#: ops the executor understands and the facade result shape it returns
#: per request
_OPS = ("closest_point", "fused")


class _Request(object):
    __slots__ = ("op", "mesh", "points", "chunk", "future", "key",
                 "t_submit", "deadline", "record")

    def __init__(self, op, mesh, points, chunk, key, deadline=None,
                 record=None):
        self.op = op
        self.mesh = mesh
        self.points = points
        self.chunk = chunk
        self.key = key
        self.future = Future()
        self.t_submit = _now()
        self.deadline = deadline    # absolute obs.clock.monotonic, or None
        self.record = record        # obs.ledger.RequestRecord, or None


class EngineExecutor(object):
    """One worker thread draining a pending queue into stacked dispatches."""

    def __init__(self):
        self._cond = threading.Condition()
        self._pending = []
        self._held = 0
        self._busy = False
        self._shutdown = False
        self._thread = threading.Thread(
            target=self._loop, name="mesh-tpu-engine", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------------
    # submission API

    def submit(self, op, mesh, points, chunk=512, deadline=None,
               record=None):
        """Enqueue one (mesh, query set) request; returns a Future.  The
        request runs on the mesh's own ``device`` (the card when it has
        none).

        Future results match the sequential facade conventions:

        - ``"closest_point"`` -> ``(faces [1, Q] uint32, points [Q, 3]
          f64)`` (AabbTree.nearest / Mesh.closest_faces_and_points);
        - ``"fused"`` -> ``(normals [V, 3] f64, faces [1, Q] uint32,
          points [Q, 3] f64)`` (Mesh.normals_and_closest_points).

        ``deadline`` is an absolute ``obs.clock.monotonic`` time: a
        request still queued when it passes is dropped by the worker with
        ``DeadlineExceeded`` on its future instead of riding a dispatch
        whose result nobody will wait for.  ``future.cancel()`` before
        dispatch likewise skips the request.

        ``record`` is an optional ``obs.ledger.RequestRecord`` that rides
        the request through the worker, so its coalesce / pad / compile /
        device stages are stamped on the latency ledger.
        """
        if op not in _OPS:
            raise ValueError("unknown engine op %r (have %s)" % (op, _OPS))
        import zlib

        pts = np.ascontiguousarray(
            np.asarray(points, np.float32).reshape(-1, 3)
        )
        if not pts.shape[0]:
            raise ValueError("empty query set")
        f = np.asarray(mesh.f)
        # topology digest groups compatible requests cheaply; the stacked
        # build re-validates exactly (stack_mesh_batch), so a crc
        # collision costs an error, never a wrong answer.  A mesh that
        # carries a content digest (``topology_key``) skips the hashing.
        topo = getattr(mesh, "topology_key", None)
        if topo is None:
            topo = zlib.crc32(np.ascontiguousarray(f).tobytes())
        device = resolve_device(getattr(mesh, "device", None) or "cuda")
        key = (op, chunk, f.shape, topo, np.asarray(mesh.v).shape,
               str(device))
        req = _Request(op, mesh, pts, chunk, key,
                       deadline=None if deadline is None else float(deadline),
                       record=record)
        with obs_span("engine.enqueue", op=op, q=pts.shape[0]):
            with self._cond:
                if self._shutdown or not self._thread.is_alive():
                    raise EngineShutdown(
                        "engine executor is shut down; submits would hang "
                        "on a dead worker loop"
                    )
                self._pending.append(req)
                self._cond.notify_all()
        return req.future

    def hold(self):
        """Fence the worker: submits accumulate until release()."""
        with self._cond:
            self._held += 1

    def release(self):
        with self._cond:
            self._held = max(0, self._held - 1)
            self._cond.notify_all()

    @contextmanager
    def coalesce(self):
        """``with executor.coalesce(): submit(...); submit(...)``:
        everything submitted inside the block rides one dispatch per
        (op, topology) group."""
        self.hold()
        try:
            yield self
        finally:
            self.release()

    def drain(self):
        """Block until every submitted request has completed.  Returns
        immediately after shutdown(): the worker loop is (or is about to
        be) gone, so there is nothing left to wait on."""
        with self._cond:
            while (self._pending or self._busy) and not self._shutdown:
                self._cond.wait(timeout=0.1)

    def shutdown(self):
        """Stop the worker (completing anything already queued first).
        Idempotent; afterwards ``submit`` raises ``EngineShutdown`` and
        ``drain`` returns immediately."""
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()
        self._thread.join(timeout=5)

    # ------------------------------------------------------------------
    # worker

    def _loop(self):
        # a worker death strands every future behind it (submit() then
        # raises EngineShutdown): freeze the black box before dying
        try:
            self._drain_loop()
        except BaseException as e:      # noqa: BLE001 - forensics, then die
            from ..obs.recorder import get_recorder

            recorder = get_recorder()
            recorder.record("engine.worker_crash",
                            error=type(e).__name__, detail=str(e))
            recorder.trigger(
                "executor_exception",
                context={"error": type(e).__name__, "detail": str(e)})
            raise

    def _drain_loop(self):
        while True:
            with self._cond:
                while True:
                    while (self._held or not self._pending) \
                            and not self._shutdown:
                        self._cond.wait()
                    if self._shutdown:
                        break
                    # tuned coalescing window (utils/tuning.py; 0, the
                    # static default, drains immediately): linger
                    # until the OLDEST pending request has aged
                    # window_s, so an un-fenced burst rides one
                    # dispatch.  hold()/shutdown during the linger loop
                    # back into the predicates above.
                    window_s = tuning.get("coalesce_window_ms") / 1000.0
                    if window_s <= 0:
                        break
                    wait_s = self._pending[0].t_submit + window_s - _now()
                    if wait_s <= 0:
                        break
                    self._cond.wait(timeout=wait_s)
                if self._shutdown:
                    # complete what's queued, then exit
                    batch, self._pending = self._pending, []
                    if not batch:
                        return
                else:
                    batch, self._pending = self._pending, []
                self._busy = True
            try:
                self._process(batch)
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    def _process(self, batch):
        groups = OrderedGroups()
        for req in batch:
            groups.add(req.key, req)
        for group in groups.values():
            try:
                self._dispatch_group(group)
            except BaseException as e:  # noqa: BLE001 - futures carry it
                from ..obs.recorder import get_recorder

                get_recorder().record(
                    "engine.error", error=type(e).__name__,
                    detail=str(e), requests=len(group))
                for req in group:
                    if not req.future.done():
                        req.future.set_exception(e)

    def _admit(self, group):
        """Drop requests that no longer want a dispatch: futures the
        caller cancelled, and deadlines that passed while queued (those
        fail with DeadlineExceeded).  Survivors are marked RUNNING so a
        late ``cancel()`` can no longer race the result."""
        now = _now()
        live = []
        for req in group:
            if req.deadline is not None and now > req.deadline:
                STATS.record_deadline_drop()
                req.future.set_exception(DeadlineExceeded(
                    "request deadline passed %.3fs before dispatch"
                    % (now - req.deadline)
                ))
                continue
            if not req.future.set_running_or_notify_cancel():
                STATS.record_cancelled()
                continue
            live.append(req)
        return live

    def _dispatch_group(self, group):
        from ..batch import _batch_nondegen, _strategy, stack_mesh_batch
        from ..utils.knobs import tile_variant
        from .planner import bucket_size, get_planner

        group = self._admit(group)
        if not group:
            return
        op = group[0].op
        # the request identity crosses the submit->drain thread hop on
        # the ledger record: binding the group's first context here makes
        # every worker-side span parent under that request's root span
        # (one connected tree) instead of rooting a per-thread forest
        ctx = next((req.record.ctx for req in group
                    if req.record is not None
                    and req.record.ctx is not None), None)
        with bind_context(ctx), \
                obs_span("engine.coalesce", op=op, requests=len(group)):
            drained = _now()
            for req in group:
                # submit-to-dispatch wait: the queue-time half of the
                # queue-vs-device latency split (device time is the
                # engine.dispatch histogram)
                STATS.record_queue_wait(drained - req.t_submit)
                if req.record is not None:
                    # the batching window just closed for this group
                    req.record.stamp("coalesce", drained)
            if self._shard_eligible(group, op):
                self._dispatch_sharded(group[0])
                STATS.record_coalesced(len(group))
                return
            planner = get_planner()
            with obs_span("engine.stack", meshes=len(group)):
                v, f = stack_mesh_batch([req.mesh for req in group])
                q_max = max(req.points.shape[0] for req in group)
                qb = bucket_size(q_max, planner.q_ladder)
                pts = np.stack([
                    np.pad(req.points,
                           ((0, qb - req.points.shape[0]), (0, 0)),
                           mode="edge")
                    for req in group
                ])
            records = [req.record for req in group
                       if req.record is not None]
            for record in records:
                record.stamp("pad")
                record.set(op=op, bucket=qb)
            chunk = group[0].chunk
            device = resolve_device(getattr(group[0].mesh, "device", None)
                                    or "cuda")
            use_pallas, use_culled = _strategy(f, device)
            normals, res = planner.run_batch_step(
                v, f, pts,
                use_pallas=use_pallas, use_culled=use_culled, chunk=chunk,
                with_normals=(op == "fused"),
                nondegen=_batch_nondegen(v, f),
                variant=tile_variant(), op=op,
                records=records, device=device,
            )
            STATS.record_coalesced(len(group))
        faces_all = res["face"].cpu().numpy().astype(np.uint32)
        points_all = res["point"].cpu().numpy().astype(np.float64)
        normals_all = (
            None if normals is None
            else normals.cpu().numpy().astype(np.float64))
        for i, req in enumerate(group):
            n_q = req.points.shape[0]
            faces = faces_all[i, None, :n_q]
            pts_out = points_all[i, :n_q]
            if op == "fused":
                req.future.set_result((normals_all[i], faces, pts_out))
            else:
                req.future.set_result((faces, pts_out))


    @staticmethod
    def _shard_eligible(group, op):
        """The sharded big-batch lane's gate: a single oversized
        closest-point request, when the ``shard_min_q`` tunable is set (env
        pin MESH_TPU_FLEET_SHARD_MIN_Q) AND the MESH_TPU_FLEET_SHARD kill
        switch is on.  Off by default: the single-device path."""
        if op != "closest_point" or len(group) != 1:
            return False
        min_q = tuning.get("shard_min_q")
        if min_q is None or group[0].points.shape[0] < min_q:
            return False
        from ..utils import knobs

        return knobs.flag("MESH_TPU_FLEET_SHARD")

    def _dispatch_sharded(self, req):
        """One big request through the query-sharded plan's shard body
        (``parallel.sharding._closest_local``: the row-1 kernel with the
        data-derived ``assume_nondegenerate`` flag and the tile variant) on
        the request's device, the whole request as one shard.  A process
        drives one card, so the plan has one shard here: no device mesh,
        no process group and no collective, and inside a multi-rank world
        the lane stays on the submitting rank (the executor is one thread,
        and a collective the other ranks do not join would hang).  Spreading
        one request over several cards waits for a process that drives
        more than one.  Per-query independence makes the answer
        bit-identical to the single-device path; the ledger record skips
        the pad/compile stamps (no bucket padding here) and carries
        ``backend="xla_sharded"`` so the stage histogram splits the
        lanes."""
        from ..batch import _batch_nondegen, _strategy
        from ..parallel.sharding import _closest_local
        from ..utils.device import as_tensor
        from ..utils.knobs import tile_variant

        q = req.points.shape[0]
        device = resolve_device(getattr(req.mesh, "device", None) or "cuda")
        with obs_span("engine.shard_dispatch", op=req.op, q=q):
            if req.record is not None:
                req.record.set(op=req.op, bucket=q, backend="xla_sharded")
            v = np.asarray(req.mesh.v, np.float32)
            f = np.asarray(req.mesh.f, np.int64)
            use_pallas, _ = _strategy(f, device)
            res = _closest_local(
                as_tensor(v, device), as_tensor(f, device),
                as_tensor(np.asarray(req.points, np.float32), device),
                req.chunk, use_pallas, _batch_nondegen(v, f), tile_variant())
            faces = res["face"].cpu().numpy().astype(np.uint32)[None, :]
            points = res["point"].cpu().numpy().astype(np.float64)
            if req.record is not None:
                req.record.stamp("device")
        from ..obs.metrics import REGISTRY

        REGISTRY.counter(
            "mesh_tpu_fleet_shard_dispatches_total",
            "Coalesced closest-point batches routed through the "
            "dp-sharded big-batch lane (parallel/sharding.py).",
        ).inc()
        req.future.set_result((faces, points))


class OrderedGroups(object):
    """dict of key -> list preserving first-seen key order (the executor
    must complete requests in rough submission order)."""

    def __init__(self):
        self._d = {}

    def add(self, key, item):
        self._d.setdefault(key, []).append(item)

    def values(self):
        return self._d.values()


_EXECUTOR = None
_EXECUTOR_LOCK = threading.Lock()


def get_executor():
    """The process-wide executor (started lazily on first submit)."""
    global _EXECUTOR
    with _EXECUTOR_LOCK:
        if _EXECUTOR is None:
            _EXECUTOR = EngineExecutor()
        return _EXECUTOR


def submit(op, mesh, points, chunk=512, deadline=None, record=None):
    """Module-level shortcut: ``engine.submit("closest_point", m, pts)``."""
    return get_executor().submit(op, mesh, points, chunk=chunk,
                                 deadline=deadline, record=record)
