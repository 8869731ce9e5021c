"""Fleet SLO coordinator: fleet-level burn rate over per-replica
serve-stats sinks, plus arbitration so per-replica tuners don't fight
(a copy of mesh_tpu/fleet/coordinator.py).

Each replica already writes a serve-stats sink (``QueryService.
write_stats()``: health snapshot + queue depths + a metrics-registry
snapshot) — that JSON file is the fleet's wire format; no new
instrumentation, no RPC.  The coordinator:

1. reads every replica's sink (a path, or any callable returning a
   sink-shaped dict — in-process fleets pass ``service.stats``),
2. **aggregates** the snapshot-shaped metrics across replicas
   (counters/gauges sum per label set, histograms merge bucket-wise),
3. feeds the merged snapshot to one fleet-scoped ``SLOMonitor`` via
   ``tick(metrics=...)`` — ``obs/slo.py`` computes burn exactly as it
   would for one replica, so the fleet burn rate is the burn rate of
   the fleet-as-one-service,
4. actuates the shared latency levers through ``utils/tuning.py`` when
   fleet fast-burn pressure crosses the high-water mark (shrink
   coalescing, pre-trip the degradation ladder) and releases them when
   it falls below the low-water mark — every decision lands in the
   flight recorder and knob history like any other actuation.

**Arbitration** (``grant_widen``): per-replica ``TunerController``\\ s
in throughput mode all want to widen coalescing at once, and N widens
into the same fleet-wide fast burn is exactly the fight a fleet must
avoid.  A controller constructed with ``coordinator=``
(obs/controller.py) asks for a grant before widening; the coordinator
hands out at most one grant per cooldown window and none at all while
fleet pressure is above the release threshold — so at most one replica
runs a widen hold-out at a time, and its shadow A/B verdict lands before
the next replica may try.

Deterministic by construction: every clock read goes through the
injected ``clock`` and sinks are plain dicts, so tests drive the whole
loop under a fake clock.  ``FleetCoordinator._lock`` guards only cached
decision state and takes no other lock; SLO sampling and actuations run
outside it.
"""

import json
import os
import threading

from ..utils import tuning
from ..obs.clock import monotonic
from ..obs.slo import SLOMonitor

__all__ = ["FleetCoordinator", "aggregate_sinks", "read_sink"]


def read_sink(source):
    """One replica's serve-stats sink as a dict: ``source`` is a path
    to a ``write_stats`` JSON file or a callable returning the same
    shape (in-process fleets pass ``service.stats``).  Unreadable
    sinks read as None — a replica that cannot report is missing, not
    fatal."""
    if callable(source):
        try:
            return source()
        except Exception:
            return None
    try:
        with open(os.fspath(source), "r", encoding="utf-8") as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def _labels_key(labels):
    return tuple(sorted((labels or {}).items()))


def _merge_histogram(into, series):
    into["count"] += series.get("count", 0)
    into["sum"] += series.get("sum", 0.0)
    lo, hi = series.get("min"), series.get("max")
    if lo is not None:
        into["min"] = lo if into["min"] is None else min(into["min"], lo)
    if hi is not None:
        into["max"] = hi if into["max"] is None else max(into["max"], hi)
    buckets = into.setdefault("_buckets", {})
    for bound, cum in series.get("buckets", []):
        key = "+Inf" if bound == "+Inf" else float(bound)
        buckets[key] = buckets.get(key, 0) + cum


def aggregate_sinks(sinks):
    """Merge the ``metrics`` snapshots of N sink dicts into one
    registry-snapshot-shaped dict the SLO readers (``good_total``,
    ``tenants``) consume: counter/gauge series sum value per label set,
    histogram series sum count/sum and cumulative bucket counts
    bound-wise (min of mins, max of maxes).  Sinks that are None or
    carry no metrics are skipped."""
    merged = {}
    for sink in sinks:
        metrics = (sink or {}).get("metrics") or {}
        for name, entry in metrics.items():
            kind = entry.get("type")
            out = merged.setdefault(
                name, {"type": kind, "help": entry.get("help", ""),
                       "_series": {}})
            for series in entry.get("series", []):
                key = _labels_key(series.get("labels"))
                slot = out["_series"].get(key)
                if kind == "histogram":
                    if slot is None:
                        slot = out["_series"][key] = {
                            "labels": dict(series.get("labels") or {}),
                            "count": 0, "sum": 0.0,
                            "min": None, "max": None, "_buckets": {}}
                    _merge_histogram(slot, series)
                else:
                    if slot is None:
                        slot = out["_series"][key] = {
                            "labels": dict(series.get("labels") or {}),
                            "value": 0}
                    slot["value"] += series.get("value", 0)
    snapshot = {}
    for name, entry in merged.items():
        rows = []
        for _, slot in sorted(entry["_series"].items()):
            buckets = slot.pop("_buckets", None)
            if buckets is not None:
                finite = sorted(b for b in buckets if b != "+Inf")
                slot["buckets"] = [[b, buckets[b]] for b in finite]
                if "+Inf" in buckets:
                    slot["buckets"].append(["+Inf", buckets["+Inf"]])
            rows.append(slot)
        snapshot[name] = {"type": entry["type"], "help": entry["help"],
                          "series": rows}
    return snapshot


class FleetCoordinator(object):
    """Fleet-scoped burn-rate evaluation + tuner arbitration.

    ``sources`` maps replica name -> sink source (path or callable, see
    ``read_sink``).  ``step()`` is one deterministic evaluation; no
    background thread of its own — run it from a cron/driver loop or a
    test's fake clock.
    """

    def __init__(self, sources, objectives=None, rules=None,
                 clock=monotonic, recorder=None, registry=None,
                 pressure_high=0.5, pressure_low=0.1,
                 widen_cooldown_s=30.0):
        self._sources = dict(sources)
        self._clock = clock
        self._recorder = recorder
        if registry is None:
            from ..obs.metrics import REGISTRY as registry
        self._registry = registry
        self.pressure_high = float(pressure_high)
        self.pressure_low = float(pressure_low)
        self.widen_cooldown_s = float(widen_cooldown_s)
        self.monitor = SLOMonitor(objectives=objectives, rules=rules,
                                  registry=registry, clock=clock)
        # _lock guards only the cached arbitration state below and
        # takes no other lock; sampling/actuation run outside it
        self._lock = threading.Lock()
        self._pressure = 0.0          # last fleet fast-burn pressure
        self._pre_tripped = False     # coordinator-owned pre-trip latch
        self._last_grant_t = None     # last widen grant (fake-clock time)
        self._m_decisions = registry.counter(
            "mesh_tpu_fleet_coordinator_decisions_total",
            "Fleet coordinator step() decisions (shrink / release / "
            "hold).",
        )
        self._m_grants = registry.counter(
            "mesh_tpu_fleet_widen_grants_total",
            "Tuner widen-arbitration outcomes (granted / denied).",
        )
        self._m_pressure = registry.gauge(
            "mesh_tpu_fleet_pressure",
            "Worst fleet-level fast-burn pressure over the aggregated "
            "replica sinks (1.0 = breaching).",
        )
        self._m_sinks = registry.gauge(
            "mesh_tpu_fleet_sinks_readable",
            "Replica serve-stats sinks readable at the last "
            "coordinator step.",
        )

    def _record(self, kind, **fields):
        recorder = self._recorder
        if recorder is None:
            from ..obs.recorder import get_recorder

            recorder = get_recorder()
        recorder.record(kind, **fields)

    # -- evaluation ----------------------------------------------------

    def sample(self):
        """Read every sink, aggregate, feed the fleet monitor one tick.
        Returns (aggregated snapshot, readable-sink count)."""
        sinks = {name: read_sink(src)
                 for name, src in self._sources.items()}
        readable = sum(1 for s in sinks.values() if s is not None)
        agg = aggregate_sinks(sinks.values())
        self.monitor.tick(metrics=agg)
        self._m_sinks.set(readable)
        return agg, readable

    def pressure(self, now=None):
        """Worst fleet fast-burn pressure (read-only, like the
        controller's per-replica twin)."""
        rows = self.monitor.burn_rates(now=now)
        fast = [r["pressure"] for r in rows if r["rule"] == "fast_burn"]
        if not fast:
            fast = [r["pressure"] for r in rows]
        return max(fast) if fast else 0.0

    def step(self, now=None):
        """One coordinator evaluation: sample sinks, compute fleet
        pressure, actuate the shared latency levers through the audited
        knob path.  Deterministic under an injected clock."""
        if not tuning.enabled():
            return {"decision": "disabled", "actions": []}
        now = self._clock() if now is None else float(now)
        _, readable = self.sample()
        pressure = self.pressure(now=now)
        self._m_pressure.set(round(pressure, 6))
        with self._lock:
            self._pressure = pressure
            pre_tripped = self._pre_tripped
            if pressure >= self.pressure_high:
                decision = "shrink"
                self._pre_tripped = True
            elif pressure <= self.pressure_low and pre_tripped:
                decision = "release"
                self._pre_tripped = False
            else:
                decision = "hold"
        actions = []
        if decision == "shrink":
            tun = tuning.lookup("coalesce_window_ms")
            cur = tuning.get("coalesce_window_ms")
            if cur > tun.lo:
                event = tuning.actuate(
                    "coalesce_window_ms", cur - tun.step,
                    reason="fleet: fast-burn pressure %.2f across %d "
                           "replica sinks" % (pressure, readable),
                    evidence={"pressure": pressure, "sinks": readable},
                    now=now)
                if event:
                    actions.append(event)
            if tuning.get("serve_pre_trip") != 1:
                event = tuning.actuate(
                    "serve_pre_trip", 1,
                    reason="fleet: pre-trip degradation ladder",
                    evidence={"pressure": pressure}, now=now)
                if event:
                    actions.append(event)
        elif decision == "release":
            if tuning.get("serve_pre_trip") != 0:
                event = tuning.actuate(
                    "serve_pre_trip", 0,
                    reason="fleet: pressure %.2f back under release "
                           "threshold" % pressure,
                    evidence={"pressure": pressure}, now=now)
                if event:
                    actions.append(event)
        self._m_decisions.inc(decision=decision)
        self._record("fleet_decision", decision=decision,
                     pressure=round(pressure, 6), sinks=readable,
                     actions=len(actions), t=now)
        return {"decision": decision, "pressure": pressure,
                "sinks": readable, "actions": actions, "t": now}

    # -- arbitration ---------------------------------------------------

    def grant_widen(self, replica=None, now=None):
        """May one replica's tuner widen coalescing right now?  At most
        one grant per ``widen_cooldown_s`` (so one shadow A/B hold-out
        settles before the next replica tries) and none while the last
        observed fleet pressure is above the release threshold — the
        anti-fight rule.  Every verdict is audited."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            if self._pressure > self.pressure_low:
                verdict, why = False, "fleet_pressure"
            elif (self._last_grant_t is not None
                    and now - self._last_grant_t < self.widen_cooldown_s):
                verdict, why = False, "cooldown"
            else:
                verdict, why = True, "granted"
                self._last_grant_t = now
        self._m_grants.inc(outcome="granted" if verdict else "denied")
        self._record("fleet_widen", replica=replica, granted=verdict,
                     reason=why, t=now)
        return verdict

    def status(self):
        """JSON-able coordinator view for debugging."""
        with self._lock:
            return {
                "pressure": self._pressure,
                "pre_tripped": self._pre_tripped,
                "last_grant_t": self._last_grant_t,
                "sources": sorted(self._sources),
            }
