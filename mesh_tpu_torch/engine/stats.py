"""Engine observability: a view over the metrics registry (a copy of
mesh_tpu/engine/stats.py, with the same metric names).

The engine's value is *negative* work: plans that were not captured again,
dispatches that were coalesced away, padding that stayed small.  The
counters live in the port's ``obs.metrics.REGISTRY``, and
``mesh_tpu_torch.engine.stats()`` returns the reference's snapshot dict:

- ``plan_cache``: hits / misses / evictions plus ``compile_seconds``, the
  wall seconds spent making plans (on the card, capturing CUDA graphs);
- ``retraces``: alias of plan-cache misses (each miss is exactly one plan
  made), so "the retrace counter stays flat" is the reuse proof the tests
  pin;
- ``pad_waste``: fraction of dispatched (batch x query) elements that
  were bucket padding, cumulative over all engine dispatches;
- ``coalesced``: how many submit/future requests rode in how many
  stacked dispatches (mean/max batch size);
- ``dispatch_latency``: per-op wall-clock of the engine's device
  dispatches (count / total / max seconds), from the
  ``mesh_tpu_engine_dispatch_seconds`` histogram, whose ``backend`` label
  says ``cuda`` (a CUDA-graph replay on the card) or ``cpu`` (the step
  called eagerly on the CPU).

Thread-safe: the coalescing executor's worker thread and facade callers
record concurrently (the registry serializes every update; ``reset()``
takes its own lock so the multi-instrument zeroing is atomic too).
"""

import threading

__all__ = ["EngineStats", "STATS", "stats", "reset_stats"]


class EngineStats(object):
    """The engine's recording facade over the metrics registry, shared by
    planner and executor."""

    def __init__(self, registry=None):
        self._lock = threading.Lock()
        if registry is None:
            from ..obs.metrics import REGISTRY as registry
        self.registry = registry
        self._plan_hits = registry.counter(
            "mesh_tpu_engine_plan_hits_total",
            "Plan-cache hits (dispatches with zero retracing).",
        )
        self._plan_misses = registry.counter(
            "mesh_tpu_engine_plan_misses_total",
            "Plan-cache misses; each one is exactly one plan made.",
        )
        self._plan_evictions = registry.counter(
            "mesh_tpu_engine_plan_evictions_total",
            "Plans dropped from the LRU.",
        )
        self._compile_seconds = registry.counter(
            "mesh_tpu_engine_compile_seconds_total",
            "Wall seconds paid making plans on cache misses.",
        )
        self._useful_elements = registry.counter(
            "mesh_tpu_engine_useful_elements_total",
            "Real (batch x query) elements moved by engine dispatches.",
        )
        self._dispatched_elements = registry.counter(
            "mesh_tpu_engine_dispatched_elements_total",
            "Total bucket elements moved, padding included.",
        )
        self._coalesced_dispatches = registry.counter(
            "mesh_tpu_engine_coalesced_dispatches_total",
            "Stacked dispatches launched by the coalescing executor.",
        )
        self._coalesced_requests = registry.counter(
            "mesh_tpu_engine_coalesced_requests_total",
            "Submit/future requests that rode stacked dispatches.",
        )
        self._coalesced_max_batch = registry.gauge(
            "mesh_tpu_engine_coalesced_max_batch",
            "Largest request count coalesced into one dispatch.",
        )
        self._dispatch_seconds = registry.histogram(
            "mesh_tpu_engine_dispatch_seconds",
            "Per-op wall-clock of engine device dispatches.",
        )
        self._queue_wait_seconds = registry.histogram(
            "mesh_tpu_engine_queue_wait_seconds",
            "Submit-to-dispatch wait of coalesced executor requests.",
        )
        self._cancelled = registry.counter(
            "mesh_tpu_engine_cancelled_total",
            "Requests whose future was cancelled before dispatch.",
        )
        self._deadline_drops = registry.counter(
            "mesh_tpu_engine_deadline_drop_total",
            "Queued requests dropped because their deadline passed "
            "before dispatch.",
        )
        self.reset()

    def reset(self):
        with self._lock:
            for metric in (
                self._plan_hits, self._plan_misses, self._plan_evictions,
                self._compile_seconds, self._useful_elements,
                self._dispatched_elements, self._coalesced_dispatches,
                self._coalesced_requests, self._coalesced_max_batch,
                self._dispatch_seconds, self._queue_wait_seconds,
                self._cancelled, self._deadline_drops,
            ):
                metric.reset()

    # ------------------------------------------------------------------
    # recording

    def record_plan_hit(self):
        self._plan_hits.inc()

    def record_plan_miss(self, compile_seconds):
        self._plan_misses.inc()
        self._compile_seconds.inc(float(compile_seconds))

    def record_plan_eviction(self):
        self._plan_evictions.inc()

    def record_padding(self, useful, padded):
        """One dispatch moved ``padded`` bucket elements of which
        ``useful`` were real (batch x query granularity)."""
        self._useful_elements.inc(int(useful))
        self._dispatched_elements.inc(int(padded))

    def record_coalesced(self, batch_size):
        self._coalesced_dispatches.inc()
        self._coalesced_requests.inc(int(batch_size))
        self._coalesced_max_batch.set_max(int(batch_size))

    def record_dispatch(self, op, seconds, backend="cuda"):
        """One engine dispatch: ``backend`` is ``cuda`` (a graph replay on
        the card) or ``cpu`` (the step called eagerly on the CPU)."""
        self._dispatch_seconds.observe(float(seconds), op=op,
                                       backend=backend)

    def record_queue_wait(self, seconds):
        """Executor-only: submit-to-dispatch latency of one request
        (registry series, intentionally NOT in the compat snapshot)."""
        self._queue_wait_seconds.observe(float(seconds))

    def record_cancelled(self):
        """A future was cancelled before its dispatch (registry series,
        not in the compat snapshot)."""
        self._cancelled.inc()

    def record_deadline_drop(self):
        """A queued request's deadline passed before dispatch (registry
        series, not in the compat snapshot)."""
        self._deadline_drops.inc()

    # ------------------------------------------------------------------
    # reporting

    def snapshot(self):
        """One JSON-able dict of everything above, with derived rates: the
        reference's ``engine.stats()`` shape."""
        with self._lock:
            hits = self._plan_hits.value()
            misses = self._plan_misses.value()
            evictions = self._plan_evictions.value()
            compile_seconds = self._compile_seconds.value()
            useful = self._useful_elements.value()
            dispatched = self._dispatched_elements.value()
            co_dispatches = self._coalesced_dispatches.value()
            co_requests = self._coalesced_requests.value()
            co_max = self._coalesced_max_batch.value()
            # aggregate across the backend label so the compat snapshot
            # stays keyed by op alone (one op can now carry several
            # backend-labeled series)
            agg = {}
            for labels in self._dispatch_seconds.label_sets():
                op = labels.get("op", "")
                stat = self._dispatch_seconds.stat(**labels)
                row = agg.get(op)
                if row is None:
                    agg[op] = {"count": stat["count"], "sum": stat["sum"],
                               "max": stat["max"]}
                else:
                    row["count"] += stat["count"]
                    row["sum"] += stat["sum"]
                    row["max"] = max(row["max"], stat["max"])
            latency = {}
            for op, row in agg.items():
                latency[op] = {
                    "count": row["count"],
                    "total_s": row["sum"],
                    "max_s": row["max"],
                    "mean_ms": round(1e3 * row["sum"] / row["count"], 3)
                    if row["count"] else 0.0,
                }
            pad_waste = 1.0 - useful / dispatched if dispatched else 0.0
            return {
                "plan_cache": {
                    "hits": hits,
                    "misses": misses,
                    "evictions": evictions,
                    "compile_seconds": round(compile_seconds, 3),
                },
                "retraces": misses,
                "pad_waste": round(pad_waste, 4),
                "coalesced": {
                    "dispatches": co_dispatches,
                    "requests": co_requests,
                    "max_batch": co_max,
                    "mean_batch": round(co_requests / co_dispatches, 2)
                    if co_dispatches else 0.0,
                },
                "dispatch_latency": latency,
            }


#: process-wide stats block (the engine is one planner + one executor)
STATS = EngineStats()


def stats():
    """Snapshot of the engine counters (``engine.stats()``)."""
    return STATS.snapshot()


def reset_stats():
    STATS.reset()
