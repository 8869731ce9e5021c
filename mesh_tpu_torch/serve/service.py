"""QueryService: the deadline-aware multi-tenant front door (a copy of
mesh_tpu/serve/service.py).

Layering: callers submit (tenant, priority, deadline)-tagged requests;
admission control keeps per-tenant queues bounded (reject-with-
retry-after, never unbounded growth); worker threads drain the queues
weighted-fair (deficit round-robin, so one chatty tenant cannot starve
the rest) and execute each request down the degradation ladder
(serve/deadline.py) under the health monitor's load-shed state
(serve/health.py).

Everything is a ``concurrent.futures.Future`` of a ``ServeResponse``:
the caller picks sync (``query``) or async (``submit``) and the service
never blocks an admission on device work.

Instrumentation (always-on registry series, ``serve.*`` span names under
``MESH_TPU_OBS``): per-tenant request/outcome counters, queue-depth
gauges, latency histograms, shed/deadline-miss counters — written as
JSON to the stats sink (``write_stats``; ``MESH_TPU_SERVE_STATS``).

Knobs (all overridable per-constructor): ``MESH_TPU_SERVE_QUEUE``
(per-tenant queue bound, default 64), ``MESH_TPU_SERVE_DEADLINE_S``
(default deadline, 1.0), ``MESH_TPU_SERVE_WORKERS`` (drain threads, 1),
``MESH_TPU_SERVE_STATS`` (stats sink path).

A request names its mesh by a live mesh object (a port ``Mesh``, on the
card or built with ``device="cpu"``) or by a *store key* (a topology
digest string), which resolves through the mesh store's page cache
(``store/pages.py``) when a worker takes the request: the ledger records
the ``page_in`` stage, the ``store_key`` and the ``mesh_source`` (``paged``
off disk or ``resident`` in the cache), and a key that does not resolve
fails that request alone.  A paged mesh runs on the current card, or
where the service's ``device`` says (``QueryService(device="cpu")``).
"""

import itertools
import json
import os
import threading
from collections import OrderedDict, deque
from concurrent.futures import Future

from ..errors import DeadlineExceeded, EngineShutdown, ServeRejected
from ..utils import knobs
from ..obs.clock import monotonic, wall
from ..obs.context import bind_context, mint as mint_context
from ..obs.ledger import bind_current, get_ledger
from ..obs.recorder import get_recorder
from ..obs.trace import span as obs_span
from .deadline import (Deadline, default_ladder, effective_start_rung,
                       run_with_ladder)
from .health import DEGRADED, DRAINING, HealthMonitor

__all__ = [
    "QueryService", "ServeResponse", "WeightedFairQueue",
    "default_stats_path",
]


def default_stats_path():
    """The serve-stats sink: ``MESH_TPU_SERVE_STATS`` or
    ``~/.mesh_tpu_torch/serve_stats.json`` (the reference's path shape
    under the port's own name, so the two packages never write one
    file)."""
    return knobs.get_str("MESH_TPU_SERVE_STATS", None) or (
        os.path.expanduser(os.path.join("~", ".mesh_tpu_torch",
                                        "serve_stats.json")))


class WeightedFairQueue(object):
    """Deficit round-robin over per-tenant FIFO queues.

    Each tenant earns ``weight`` credits when the drain pointer visits
    it and spends one credit per popped request; a tenant with twice the
    weight drains twice the requests per cycle.  Pop order is
    deterministic (tenants in first-push order), which the fairness
    tests pin."""

    def __init__(self, weights=None, default_weight=1.0):
        self._weights = dict(weights or {})
        self._default_weight = float(default_weight)
        self._queues = OrderedDict()        # tenant -> deque
        self._credit = 0.0
        self._current = None

    def weight(self, tenant):
        return float(self._weights.get(tenant, self._default_weight))

    def push(self, tenant, item):
        self._queues.setdefault(tenant, deque()).append(item)

    def depth(self, tenant):
        q = self._queues.get(tenant)
        return len(q) if q else 0

    def depths(self):
        return {t: len(q) for t, q in self._queues.items()}

    def __len__(self):
        return sum(len(q) for q in self._queues.values())

    def _advance(self):
        """Move the drain pointer to the next non-empty tenant and top
        its credit up by one quantum (= its weight)."""
        tenants = [t for t, q in self._queues.items() if q]
        if not tenants:
            self._current, self._credit = None, 0.0
            return
        if self._current in tenants:
            start = (tenants.index(self._current) + 1) % len(tenants)
        else:
            start = 0
        self._current = tenants[start]
        self._credit = self.weight(self._current)

    def pop(self):
        """Next (tenant, item) under DRR, or None when empty."""
        if not len(self):
            self._current, self._credit = None, 0.0
            return None
        queue = self._queues.get(self._current)
        if not queue or self._credit < 1.0:
            self._advance()
            queue = self._queues[self._current]
            # a weight < 1 tenant still makes progress: accumulate quanta
            # until one credit exists (bounded: weights are > 0)
            while self._credit < 1.0:
                self._credit += self.weight(self._current)
        self._credit -= 1.0
        return self._current, queue.popleft()


class ServeResponse(object):
    """One answered request: facade-convention arrays + provenance."""

    __slots__ = ("faces", "points", "tenant", "rung", "certified",
                 "approximate", "retries", "latency_s", "deadline_s",
                 "deadline_missed")

    def __init__(self, result, tenant, retries, latency_s, deadline):
        self.faces = result.faces
        self.points = result.points
        self.tenant = tenant
        self.rung = result.rung
        self.certified = result.certified
        self.approximate = result.approximate
        self.retries = retries
        self.latency_s = latency_s
        self.deadline_s = deadline.seconds
        self.deadline_missed = latency_s > deadline.seconds

    def to_dict(self):
        return {
            "tenant": self.tenant, "rung": self.rung,
            "certified": self.certified, "approximate": self.approximate,
            "retries": self.retries,
            "latency_ms": round(1e3 * self.latency_s, 3),
            "deadline_ms": round(1e3 * self.deadline_s, 3),
            "deadline_missed": self.deadline_missed,
        }


class _ServeRequest(object):
    __slots__ = ("mesh", "points", "tenant", "priority", "deadline",
                 "future", "t_admit", "record", "ctx")

    def __init__(self, mesh, points, tenant, priority, deadline):
        self.mesh = mesh
        self.points = points
        self.tenant = tenant
        self.priority = int(priority)
        self.deadline = deadline
        self.future = Future()
        self.t_admit = monotonic()
        self.record = None      # obs.ledger.RequestRecord, or None
        self.ctx = None         # obs.context.RequestContext, or None


class QueryService(object):
    """Async multi-tenant closest-point service over the engine."""

    def __init__(self, max_queue_per_tenant=None, weights=None, workers=None,
                 ladder=None, default_deadline_s=None, health=None,
                 chunk=512, stats_path=None, recorder=None, device=None):
        self.max_queue_per_tenant = (
            knobs.get_int("MESH_TPU_SERVE_QUEUE")
            if max_queue_per_tenant is None else int(max_queue_per_tenant))
        self.default_deadline_s = (
            knobs.get_float("MESH_TPU_SERVE_DEADLINE_S")
            if default_deadline_s is None else float(default_deadline_s))
        self.chunk = int(chunk)
        self.ladder = list(ladder) if ladder is not None else default_ladder()
        self.health = health if health is not None else HealthMonitor()
        self.stats_path = stats_path
        # where store-keyed requests run (a live mesh runs on its own
        # device): None is the card, "cpu" the CPU
        self.device = device
        self._recorder = recorder if recorder is not None else get_recorder()
        # incidents triggered away from the serve layer (executor faults,
        # SLO breaches) still capture this service's health snapshot
        self._recorder.attach_health(self.health)
        self._wfq = WeightedFairQueue(weights)
        self._cond = threading.Condition()
        self._held = 0
        self._stopping = False
        self._inflight = 0
        n_workers = (knobs.get_int("MESH_TPU_SERVE_WORKERS")
                     if workers is None else int(workers))
        self._workers = [
            threading.Thread(target=self._work,
                             name="mesh-tpu-serve-%d" % i, daemon=True)
            for i in range(max(n_workers, 1))
        ]
        for worker in self._workers:
            worker.start()
        self._admit_seq = itertools.count(1)
        self._init_metrics()

    # ------------------------------------------------------------------
    # metrics

    def _init_metrics(self):
        from ..obs.metrics import REGISTRY

        self._m_requests = REGISTRY.counter(
            "mesh_tpu_serve_requests_total",
            "Requests by tenant and outcome (ok / rejected / shed / "
            "deadline / error).",
        )
        self._m_depth = REGISTRY.gauge(
            "mesh_tpu_serve_queue_depth",
            "Admitted-but-undrained requests per tenant.",
        )
        self._m_latency = REGISTRY.histogram(
            "mesh_tpu_serve_latency_seconds",
            "Admission-to-response latency per tenant.",
        )
        self._m_shed = REGISTRY.counter(
            "mesh_tpu_serve_shed_total",
            "Load shed by reason (queue_full / draining / low_priority / "
            "expired_in_queue).",
        )
        self._m_miss = REGISTRY.counter(
            "mesh_tpu_serve_deadline_miss_total",
            "Responses (or failures) that landed after the deadline.",
        )
        self._m_rung = REGISTRY.counter(
            "mesh_tpu_serve_rung_total",
            "Answered requests by degradation rung and certification.",
        )
        self._m_good = REGISTRY.counter(
            "mesh_tpu_serve_good_total",
            "Requests answered ok AND on time, per tenant (the SLO "
            "availability numerator; see obs/slo.py).",
        )

    def _update_depth_gauges(self):
        for tenant, depth in self._wfq.depths().items():
            self._m_depth.set(depth, tenant=tenant)

    # ------------------------------------------------------------------
    # admission

    def submit(self, mesh, points, tenant="default", priority=0,
               deadline_s=None, ctx=None):
        """Admit one closest-point request; returns a Future of
        ServeResponse.  ``mesh`` may be a live mesh object or a *store
        key* (topology digest string): keyed requests are resolved
        through the in-process page cache at execution time, with the
        paged/resident provenance recorded on the request's ledger
        record.  ``ctx`` carries a request identity minted upstream (a
        fleet router); standalone admissions mint their own
        (obs/context.py — None with MESH_TPU_TRACE_CONTEXT off).
        Raises ServeRejected (with ``retry_after``) when backpressure
        applies — callers back off, the queue never grows unbounded."""
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        state = self.health.state
        with self._cond:
            if self._stopping or state == DRAINING:
                self._m_requests.inc(tenant=tenant, outcome="rejected")
                self._m_shed.inc(reason="draining")
                self._recorder.record("serve.reject", tenant=tenant,
                                      reason="draining")
                raise ServeRejected(
                    "service is draining", retry_after=5.0,
                    reason="draining")
            if state == DEGRADED and priority < 0:
                self._m_requests.inc(tenant=tenant, outcome="rejected")
                self._m_shed.inc(reason="low_priority")
                self._recorder.record("serve.reject", tenant=tenant,
                                      reason="low_priority",
                                      priority=priority)
                raise ServeRejected(
                    "degraded: shedding low-priority traffic",
                    retry_after=1.0, reason="low_priority")
            depth = self._wfq.depth(tenant)
            if depth >= self.max_queue_per_tenant:
                self._m_requests.inc(tenant=tenant, outcome="rejected")
                self._m_shed.inc(reason="queue_full")
                self._recorder.record("serve.reject", tenant=tenant,
                                      reason="queue_full", depth=depth)
                # backpressure hint: the queue ahead of the caller at the
                # deadline pace (coarse, but monotone in depth)
                raise ServeRejected(
                    "tenant %r queue full (%d)" % (tenant, depth),
                    retry_after=min(depth * 0.25 * deadline_s, 10.0),
                    reason="queue_full")
            req = _ServeRequest(mesh, points, tenant, priority,
                                Deadline(deadline_s))
            if ctx is None:
                ctx = mint_context(tenant, next(self._admit_seq),
                                   req.t_admit)
            req.ctx = ctx
            # admission IS the ledger's t_admit: every stamped stage
            # downstream is measured from here (obs/ledger.py); the
            # context's identity fields land in the record's meta so
            # every dumped row joins by request_id
            req.record = get_ledger().open(
                tenant=tenant, priority=priority,
                deadline_s=float(deadline_s),
                **(ctx.to_meta() if ctx is not None else {}))
            if req.record is not None:
                req.record.ctx = ctx
            self._wfq.push(tenant, req)
            depth = self._wfq.depth(tenant)
            self._m_depth.set(depth, tenant=tenant)
            self._recorder.record("serve.admit", tenant=tenant, depth=depth,
                                  priority=priority,
                                  deadline_s=float(deadline_s))
            self._cond.notify()
        return req.future

    def query(self, mesh, points, tenant="default", priority=0,
              deadline_s=None):
        """Synchronous submit: blocks for the response (bounded by the
        2x-deadline hard budget plus queue wait)."""
        fut = self.submit(mesh, points, tenant=tenant, priority=priority,
                          deadline_s=deadline_s)
        return fut.result()

    # ------------------------------------------------------------------
    # test/fence hooks (mirrors the executor's hold/release)

    def hold(self):
        """Fence the drain workers: admitted requests accumulate until
        release() (deterministic queue states for tests and fairness
        measurements)."""
        with self._cond:
            self._held += 1

    def release(self):
        with self._cond:
            self._held = max(0, self._held - 1)
            self._cond.notify_all()

    # ------------------------------------------------------------------
    # drain workers

    def _work(self):
        # an uncaught exception here means a drain worker silently dying
        # mid-serve — exactly what the flight recorder exists to capture
        try:
            self._drain_loop()
        except BaseException as e:      # noqa: BLE001 — forensics, then die
            self._recorder.record("serve.worker_crash",
                                  error=type(e).__name__, detail=str(e))
            self._recorder.trigger(
                "serve_worker_exception",
                context={"error": type(e).__name__, "detail": str(e),
                         "thread": threading.current_thread().name},
                health=self.health, force=True)
            raise

    def _drain_loop(self):
        while True:
            with self._cond:
                while ((self._held or not len(self._wfq))
                        and not self._stopping):
                    self._cond.wait()
                if self._stopping and not len(self._wfq):
                    return
                popped = self._wfq.pop()
                if popped is None:
                    continue
                tenant, req = popped
                self._m_depth.set(self._wfq.depth(tenant), tenant=tenant)
                self._inflight += 1
            try:
                self._execute(req)
            finally:
                with self._cond:
                    self._inflight -= 1
                    self._cond.notify_all()

    def _execute(self, req):
        if not req.future.set_running_or_notify_cancel():
            if req.record is not None:
                get_ledger().close(req.record, outcome="cancelled")
            return
        tenant = req.tenant
        if req.record is not None:
            # queue stage ends the moment a drain worker owns the request
            req.record.stamp("queue")
        if req.deadline.expired():
            # it died waiting in the queue: shed, do not burn device time
            self._m_shed.inc(reason="expired_in_queue")
            self._m_miss.inc(tenant=tenant)
            self._m_requests.inc(tenant=tenant, outcome="deadline")
            self._recorder.record("serve.deadline", tenant=tenant,
                                  where="expired_in_queue",
                                  queued_s=round(req.deadline.elapsed(), 6))
            if req.record is not None:
                get_ledger().close(req.record, outcome="deadline")
            req.future.set_exception(DeadlineExceeded(
                "deadline (%.3fs) expired after %.3fs in the %r queue"
                % (req.deadline.seconds, req.deadline.elapsed(), tenant)))
            return
        # store-keyed request: resolve the digest through the page
        # cache before the ladder.  Provenance ("paged" off disk vs
        # "resident" in the cache) rides the ledger; resolution failure
        # (unknown key, corrupt object) is a request error, same path
        # as a ladder failure — admission already charged the tenant.
        mesh_source = "inline"
        if isinstance(req.mesh, str):
            store_key = req.mesh
            try:
                from ..store import get_page_cache

                req.mesh, mesh_source = get_page_cache().resolve(store_key)
            except Exception as e:  # noqa: BLE001 — futures carry it
                latency = req.deadline.elapsed()
                self._m_requests.inc(tenant=tenant, outcome="error")
                self._m_latency.observe(
                    latency, exemplar=(req.ctx.request_id
                                       if req.ctx is not None else None),
                    tenant=tenant, backend="none")
                self._recorder.record(
                    "serve.error", tenant=tenant, outcome="error",
                    error=type(e).__name__, store_key=store_key,
                    latency_ms=round(1e3 * latency, 3))
                if req.record is not None:
                    req.record.set(store_key=store_key)
                    get_ledger().close(req.record, outcome="error")
                req.future.set_exception(e)
                return
            if self.device is not None:
                req.mesh = req.mesh.on(self.device)
            if req.record is not None:
                req.record.stamp("page_in")
                req.record.set(store_key=store_key)
        if req.record is not None:
            req.record.set(mesh_source=mesh_source)
        # degraded (the top rung is the one the watchdog saw wedge) or
        # tuner pre-trip: skip the top rung so this traffic stops
        # feeding the slow path (serve/deadline.py effective_start_rung)
        start_rung = effective_start_rung(
            self.health.state == DEGRADED, self.ladder)
        rid = req.ctx.request_id if req.ctx is not None else None
        with bind_context(req.ctx), \
                obs_span("serve.request", tenant=tenant,
                         mesh_source=mesh_source,
                         q=int(req.points.shape[0] if hasattr(
                             req.points, "shape") else len(req.points)),
                         priority=req.priority) as sp:
            # this span is the request's tree root: spans opened on
            # OTHER threads (executor drain/dispatch) parent under it
            # through the context instead of rooting their own forest
            if req.ctx is not None:
                req.ctx.root_span_id = getattr(sp, "span_id", None)
            try:
                # the thread-local binding lets rungs downstream (engine
                # submit, accel facade) stamp stages without widening the
                # Rung.fn signature
                with bind_current(req.record):
                    result, retries = run_with_ladder(
                        req.mesh, req.points, req.deadline,
                        ladder=self.ladder, chunk=self.chunk,
                        start_rung=start_rung, health=self.health)
            except Exception as e:      # noqa: BLE001 — futures carry it
                # held until AFTER the span exits: the root span must
                # reach the tail-sampling buffer before the ledger close
                # decides this request's trace retention
                error = e
                sp.set(error=type(e).__name__)
                if hasattr(sp, "status"):
                    sp.status = "error"
            else:
                error = None
        if error is not None:
            latency = req.deadline.elapsed()
            missed = latency > req.deadline.seconds
            if missed:
                self._m_miss.inc(tenant=tenant)
            outcome = ("deadline" if isinstance(error, DeadlineExceeded)
                       else "error")
            self._m_requests.inc(tenant=tenant, outcome=outcome)
            self._m_latency.observe(latency, exemplar=rid,
                                    tenant=tenant, backend="none")
            self._recorder.record(
                "serve.error", tenant=tenant, outcome=outcome,
                error=type(error).__name__,
                latency_ms=round(1e3 * latency, 3))
            if req.record is not None:
                get_ledger().close(req.record, outcome=outcome)
            req.future.set_exception(error)
            return
        latency = req.deadline.elapsed()
        response = ServeResponse(result, tenant, retries, latency,
                                 req.deadline)
        backend = result.backend or (
            req.record.meta.get("backend") if req.record is not None
            else None) or "none"
        self._m_requests.inc(tenant=tenant, outcome="ok")
        self._m_latency.observe(latency, exemplar=rid,
                                tenant=tenant, backend=backend)
        self._m_rung.inc(rung=response.rung,
                         certified=str(response.certified).lower())
        if response.deadline_missed:
            self._m_miss.inc(tenant=tenant)
        else:
            self._m_good.inc(tenant=tenant)
        self._recorder.record(
            "serve.response", tenant=tenant, rung=response.rung,
            retries=retries, latency_ms=round(1e3 * latency, 3),
            deadline_missed=response.deadline_missed)
        if req.record is not None:
            get_ledger().close(
                req.record, outcome="ok", rung=response.rung,
                certified=response.certified, backend=backend)
        req.future.set_result(response)

    # ------------------------------------------------------------------
    # lifecycle

    def warmup(self, mesh, queries=256):
        """Run every ladder rung once outside any deadline, so first real
        traffic pays no one-time costs (engine plans and their CUDA
        graphs, kernel builds, anchored tables, BVH indexes).  Returns the
        rung names warmed."""
        import numpy as np

        pts = np.zeros((int(queries), 3), np.float32)
        warmed = []
        for rung in self.ladder:
            try:
                rung.run(mesh, pts, self.chunk, timeout=600.0)
                warmed.append(rung.name)
            except Exception:           # noqa: BLE001 — warmup is best-effort
                pass
        return warmed

    def drain(self, timeout=None):
        """Block until the queues are empty and no request is in flight."""
        t0 = monotonic()
        with self._cond:
            while len(self._wfq) or self._inflight:
                if timeout is not None and monotonic() - t0 > timeout:
                    return False
                self._cond.wait(timeout=0.1)
        return True

    def stop(self, drain=True, write_stats=True):
        """Graceful shutdown: health enters DRAINING (admission rejects),
        queued work finishes (when ``drain``), workers exit, and the
        serve.* series are flushed to the stats sink."""
        self.health.begin_drain()
        with self._cond:
            self._stopping = True
            if not drain:
                while True:
                    popped = self._wfq.pop()
                    if popped is None:
                        break
                    _tenant, req = popped
                    cancelled = req.future.cancel()
                    if not cancelled:
                        req.future.set_exception(EngineShutdown(
                            "serving tier stopped before dispatch"))
                    if req.record is not None:
                        get_ledger().close(
                            req.record,
                            outcome="cancelled" if cancelled else "shutdown")
            self._cond.notify_all()
        for worker in self._workers:
            worker.join(timeout=10)
        self.health.stop()
        if write_stats:
            try:
                self.write_stats()
            except OSError:
                pass

    # ------------------------------------------------------------------
    # stats sink

    def stats(self):
        """JSON-able snapshot of every serve.* registry series plus the
        health state."""
        from ..obs.metrics import REGISTRY

        # a fleet's status reads cache effectiveness off this sink too,
        # so the page-cache and engine plan series ride along with serve.*
        series = {
            name: REGISTRY.get(name).snapshot()
            for name in REGISTRY.names()
            if name.startswith("mesh_tpu_serve")
            or name.startswith("mesh_tpu_store_page_cache")
            or name.startswith("mesh_tpu_engine_plan")
            or name == "mesh_tpu_request_stage_seconds"
        }
        return {
            "written_utc": wall(),
            "health": self.health.snapshot(),
            "queues": self._wfq.depths(),
            "metrics": series,
        }

    def write_stats(self, path=None):
        """Atomically write ``stats()`` to the sink path; returns it."""
        path = path or self.stats_path or default_stats_path()
        parent = os.path.dirname(os.path.abspath(path))
        if parent:
            os.makedirs(parent, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(self.stats(), fh, indent=1, sort_keys=True)
            fh.write("\n")
        os.replace(tmp, path)
        return path
