"""SLO objectives and multi-window, multi-burn-rate evaluation (a copy
of mesh_tpu/obs/slo.py).

An ``SLO`` declares what "good" means for a tenant — the fraction of
requests answered under a latency threshold, or availability (the
fraction neither shed nor past deadline) — and a target like 0.99.
Compliance is computed from the existing metrics registry (or a
serve-stats sink written by ``QueryService.write_stats()``): latency
objectives read the cumulative buckets of
``mesh_tpu_serve_latency_seconds``, availability objectives the
``mesh_tpu_serve_good_total`` / ``mesh_tpu_serve_requests_total``
counter pair, so evaluation needs no new instrumentation on the hot
path.

Alerting follows the Google-SRE multi-window multi-burn-rate recipe:
the burn rate is ``bad_fraction / error_budget`` (budget = 1 − target;
burn 1.0 spends the budget exactly over the SLO period), and a rule
fires only when the burn exceeds its factor over BOTH a long window
(sustained damage) and a short window (still happening now).  The
defaults are the classic pair — fast burn 1h/5m at 14.4×, slow burn
6h/30m at 6× — scaled down freely in tests via a fake clock, which is
all the ``SLOMonitor`` reads time from.

A confirmed fast-burn breach is the detect→capture→degrade hinge:
``bind_incident_response`` dumps a flight-recorder incident
(obs/recorder.py) and, under ``MESH_TPU_SLO_DRIVES_HEALTH=1``, trips
the serving health state machine into ``degraded`` so load shedding
starts before the error budget is gone.
"""

import threading

from .clock import env_flag, monotonic
from .metrics import REGISTRY
from .series import SampleRing, get_series

__all__ = [
    "SLO", "BurnRateRule", "SLOMonitor", "default_rules", "default_slos",
    "good_total", "compliance", "tenants", "bind_incident_response",
    "SLO_DRIVES_HEALTH_ENV",
]

#: opt-in: a confirmed fast-burn breach trips HealthMonitor -> degraded
SLO_DRIVES_HEALTH_ENV = "MESH_TPU_SLO_DRIVES_HEALTH"

_LATENCY_SERIES = "mesh_tpu_serve_latency_seconds"
_GOOD_SERIES = "mesh_tpu_serve_good_total"
_REQUESTS_SERIES = "mesh_tpu_serve_requests_total"


class SLO(object):
    """One declarative objective.

    ``kind="latency"`` — fraction of requests completing under
    ``threshold_s`` must be ≥ ``target``; ``kind="availability"`` —
    fraction of admitted+rejected requests answered good (ok and on
    time: not shed, not past deadline, no error) must be ≥ ``target``.
    ``tenant=None`` evaluates every tenant present in the metrics.
    """

    def __init__(self, name, kind, target, threshold_s=None, tenant=None):
        if kind not in ("latency", "availability"):
            raise ValueError("unknown SLO kind %r" % (kind,))
        if not 0.0 < target < 1.0:
            raise ValueError("target must be in (0, 1), got %r" % (target,))
        if kind == "latency" and not threshold_s:
            raise ValueError("latency SLOs need threshold_s")
        self.name = name
        self.kind = kind
        self.target = float(target)
        self.threshold_s = float(threshold_s) if threshold_s else None
        self.tenant = tenant

    def __repr__(self):
        return "SLO(%r, %s, target=%g%s)" % (
            self.name, self.kind, self.target,
            ", threshold_s=%g" % self.threshold_s if self.threshold_s else "",
        )


def default_slos(latency_threshold_s=0.25, latency_target=0.99,
                 availability_target=0.999):
    """The serving tier's stock objective pair."""
    return [
        SLO("latency_p99", "latency", latency_target,
            threshold_s=latency_threshold_s),
        SLO("availability", "availability", availability_target),
    ]


# -- snapshot readers (work offline on the serve-stats sink too) -------

def _series_list(metrics, name):
    entry = metrics.get(name) if metrics else None
    if not entry:
        return []
    return entry.get("series", [])


def tenants(metrics):
    """Sorted tenant names present in the serve series of a
    registry-snapshot-shaped dict."""
    seen = set()
    for name in (_REQUESTS_SERIES, _LATENCY_SERIES, _GOOD_SERIES):
        for series in _series_list(metrics, name):
            tenant = series.get("labels", {}).get("tenant")
            if tenant is not None:
                seen.add(tenant)
    return sorted(seen)


def good_total(metrics, slo, tenant):
    """(good, total) event counts for one objective+tenant from a
    registry-snapshot-shaped dict (cumulative since process start)."""
    if slo.kind == "latency":
        good = total = 0
        for series in _series_list(metrics, _LATENCY_SERIES):
            if series.get("labels", {}).get("tenant") != tenant:
                continue
            total += series.get("count", 0)
            # largest bucket bound <= threshold (bounds are sorted; a
            # tiny epsilon forgives float rendering of e.g. 0.1)
            best = 0
            for bound, cum in series.get("buckets", []):
                if bound == "+Inf":
                    continue
                if float(bound) <= slo.threshold_s * (1 + 1e-9):
                    best = cum
            good += best
        return good, total
    good = 0
    for series in _series_list(metrics, _GOOD_SERIES):
        if series.get("labels", {}).get("tenant") == tenant:
            good += series.get("value", 0)
    total = 0
    for series in _series_list(metrics, _REQUESTS_SERIES):
        if series.get("labels", {}).get("tenant") == tenant:
            total += series.get("value", 0)
    return good, total


def compliance(metrics, slo, tenant):
    """One evaluation row: counts, achieved fraction, and met/missed."""
    good, total = good_total(metrics, slo, tenant)
    achieved = (good / total) if total else 1.0
    return {
        "objective": slo.name,
        "kind": slo.kind,
        "tenant": tenant,
        "target": slo.target,
        "threshold_s": slo.threshold_s,
        "good": good,
        "total": total,
        "compliance": achieved,
        "met": achieved >= slo.target,
    }


# -- burn-rate rules ---------------------------------------------------

class BurnRateRule(object):
    """Fire when burn ≥ factor over BOTH the long and short window."""

    def __init__(self, name, long_s, short_s, factor):
        self.name = name
        self.long_s = float(long_s)
        self.short_s = float(short_s)
        self.factor = float(factor)

    def __repr__(self):
        return "BurnRateRule(%r, %gs/%gs @%g)" % (
            self.name, self.long_s, self.short_s, self.factor)


def default_rules():
    """The Google-SRE page/ticket pair for a 30-day SLO period."""
    return [
        BurnRateRule("fast_burn", long_s=3600.0, short_s=300.0, factor=14.4),
        BurnRateRule("slow_burn", long_s=21600.0, short_s=1800.0, factor=6.0),
    ]


class SLOMonitor(object):
    """Windowed burn-rate evaluation over the live registry.

    ``tick()`` snapshots cumulative (good, total) per objective+tenant
    into a bounded history; ``evaluate()`` computes the burn rate over
    each rule's long and short window from the history (difference of
    the samples bracketing the window) and fires edge-triggered breach
    callbacks.  Every clock read goes through the injected ``clock`` so
    tests drive it deterministically.
    """

    def __init__(self, objectives=None, registry=REGISTRY, clock=monotonic,
                 rules=None, history=1024):
        self.objectives = list(objectives) if objectives else default_slos()
        self.rules = list(rules) if rules is not None else default_rules()
        self._registry = registry
        self._clock = clock
        self._history = history
        # (objective, tenant) -> SampleRing of cumulative (good, total):
        # the windowed-delta arithmetic lives in obs/series.py now
        self._samples = {}
        self._breached = set()    # (objective, tenant, rule) currently firing
        self._callbacks = []
        self._lock = threading.Lock()
        self._thread = None
        self._stop = threading.Event()

    # -- sampling ------------------------------------------------------

    def _tenant_list(self, metrics, slo):
        if slo.tenant is not None:
            return [slo.tenant]
        return tenants(metrics)

    def tick(self, metrics=None):
        """Append one (t, good, total) sample per objective+tenant."""
        now = self._clock()
        metrics = metrics if metrics is not None else self._registry.snapshot()
        with self._lock:
            for slo in self.objectives:
                for tenant in self._tenant_list(metrics, slo):
                    good, total = good_total(metrics, slo, tenant)
                    key = (slo.name, tenant)
                    ring = self._samples.get(key)
                    if ring is None:
                        ring = self._samples[key] = SampleRing(
                            history=self._history)
                    ring.append(now, (good, total))
        return now

    def _burn(self, ring, slo, window_s, now):
        """Burn rate over [now - window_s, now]: bad_fraction /
        error_budget from the ring's windowed deltas; 0.0 with no
        traffic in the window."""
        deltas = ring.deltas(window_s, now)
        if not deltas:
            return 0.0
        d_good, d_total = deltas
        if d_total <= 0:
            return 0.0
        d_bad = max(d_total - d_good, 0)
        return (d_bad / d_total) / (1.0 - slo.target)

    # -- evaluation ----------------------------------------------------

    def evaluate(self):
        """Burn rates + breach decisions for every objective/tenant/rule;
        fires on_breach callbacks for NEW breaches (edge-triggered) and
        updates the slo gauges/counters."""
        now = self._clock()
        burn_gauge = self._registry.gauge(
            "mesh_tpu_slo_burn_rate",
            "error-budget burn rate per objective/tenant/window")
        breach_counter = self._registry.counter(
            "mesh_tpu_slo_breach_total",
            "edge-triggered burn-rate rule breaches")
        results, fired = [], []
        with self._lock:
            slos = {s.name: s for s in self.objectives}
            items = [(key, ring.copy())
                     for key, ring in self._samples.items()]
        for (obj_name, tenant), series in items:
            slo = slos.get(obj_name)
            if slo is None or not len(series):
                continue
            row = {"objective": obj_name, "tenant": tenant, "rules": []}
            for rule in self.rules:
                long_burn = self._burn(series, slo, rule.long_s, now)
                short_burn = self._burn(series, slo, rule.short_s, now)
                breaching = (long_burn >= rule.factor
                             and short_burn >= rule.factor)
                burn_gauge.set(round(long_burn, 6), objective=obj_name,
                               tenant=tenant, window="%gs" % rule.long_s)
                burn_gauge.set(round(short_burn, 6), objective=obj_name,
                               tenant=tenant, window="%gs" % rule.short_s)
                key = (obj_name, tenant, rule.name)
                with self._lock:
                    was = key in self._breached
                    if breaching:
                        self._breached.add(key)
                    else:
                        self._breached.discard(key)
                new_breach = breaching and not was
                if new_breach:
                    breach_counter.inc(objective=obj_name, rule=rule.name)
                rule_row = {
                    "rule": rule.name,
                    "factor": rule.factor,
                    "long_window_s": rule.long_s,
                    "short_window_s": rule.short_s,
                    "long_burn": long_burn,
                    "short_burn": short_burn,
                    "breaching": breaching,
                    "new": new_breach,
                }
                row["rules"].append(rule_row)
                if new_breach:
                    fired.append({
                        "objective": obj_name, "tenant": tenant,
                        "rule": rule.name, "factor": rule.factor,
                        "long_burn": long_burn, "short_burn": short_burn,
                    })
            results.append(row)
        for event in fired:
            for callback in list(self._callbacks):
                try:
                    callback(event)
                except Exception:   # alerting must never break serving
                    pass
        return results

    def burn_rates(self, now=None):
        """Read-only burn rates per objective/tenant/rule: no gauges,
        no edge-triggered breach state, no callbacks — the poll the
        tuner controller (obs/controller.py) steers by.  Each row
        carries ``pressure`` = max(long, short burn) / rule factor, so
        1.0 means "breaching right now" and e.g. 0.5 means "fast burn
        approaching"."""
        now = self._clock() if now is None else now
        with self._lock:
            slos = {s.name: s for s in self.objectives}
            items = [(key, ring.copy())
                     for key, ring in self._samples.items()]
        rows = []
        for (obj_name, tenant), series in items:
            slo = slos.get(obj_name)
            if slo is None or not len(series):
                continue
            for rule in self.rules:
                long_burn = self._burn(series, slo, rule.long_s, now)
                short_burn = self._burn(series, slo, rule.short_s, now)
                rows.append({
                    "objective": obj_name, "tenant": tenant,
                    "rule": rule.name, "factor": rule.factor,
                    "long_burn": long_burn, "short_burn": short_burn,
                    "pressure": (max(long_burn, short_burn) / rule.factor
                                 if rule.factor else 0.0),
                })
        return rows

    def on_breach(self, callback):
        """Register ``callback(event_dict)`` for NEW breaches."""
        self._callbacks.append(callback)
        return callback

    def breaching(self):
        """Currently-firing (objective, tenant, rule) triples."""
        with self._lock:
            return set(self._breached)

    # -- background loop (production path; tests drive tick/evaluate) --

    def start(self, interval_s=15.0, recorder=None):
        """Spawn the daemon sampling loop: tick → recorder.sample() →
        evaluate, every ``interval_s``."""
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.tick()
                    get_series().tick()
                    if recorder is not None:
                        recorder.sample()
                    self.evaluate()
                except Exception:
                    pass

        self._thread = threading.Thread(
            target=loop, name="mesh-tpu-slo", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def bind_incident_response(monitor, recorder=None, health=None):
    """Wire breaches into the forensics/feedback loop: every breach is
    recorded in the flight-recorder ring; a FAST-burn breach dumps an
    incident file and — under ``MESH_TPU_SLO_DRIVES_HEALTH=1`` — trips
    the health state machine into degraded (detect → capture →
    degrade)."""
    from .recorder import get_recorder

    def respond(event):
        rec = recorder if recorder is not None else get_recorder()
        rec.record("slo.breach", **event)
        if event.get("rule") == "fast_burn":
            rec.trigger("slo_fast_burn", context=event, health=health)
            if health is not None and env_flag(SLO_DRIVES_HEALTH_ENV):
                health.trip("slo_fast_burn")

    monitor.on_breach(respond)
    return respond
