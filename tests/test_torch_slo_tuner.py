"""mesh_tpu_torch's windowed series, SLOs, tunable knobs and tuner
controller vs mesh_tpu's, on the CPU under fake clocks.

The same scripted traffic goes into both packages' registries; windowed
deltas and percentiles, SLO compliance rows, burn rates and breach
decisions, knob actuations, the change history and the controller's step
summaries must be equal.  The tunables added to the port also steer its
routing thresholds (``query/autotune.py``) like the reference's.
"""

import types

import pytest

import mesh_tpu.obs as jobs
from mesh_tpu.obs import controller as jcontroller
from mesh_tpu.obs import metrics as jmetrics
from mesh_tpu.obs import recorder as jrecorder
from mesh_tpu.obs import series as jseries
from mesh_tpu.obs import slo as jslo
from mesh_tpu.serve import health as jhealth
from mesh_tpu.utils import knobs as jknobs
from mesh_tpu.utils import tuning as jtuning

import mesh_tpu_torch.obs as tobs
from mesh_tpu_torch.obs import controller as tcontroller
from mesh_tpu_torch.obs import metrics as tmetrics
from mesh_tpu_torch.obs import recorder as trecorder
from mesh_tpu_torch.obs import series as tseries
from mesh_tpu_torch.obs import slo as tslo
from mesh_tpu_torch.query import autotune as tautotune
from mesh_tpu_torch.serve import health as thealth
from mesh_tpu_torch.utils import knobs as tknobs
from mesh_tpu_torch.utils import tuning as ttuning

PORT = types.SimpleNamespace(
    obs=tobs, controller=tcontroller, metrics=tmetrics, recorder=trecorder,
    series=tseries, slo=tslo, health=thealth, tuning=ttuning, name="port")
REF = types.SimpleNamespace(
    obs=jobs, controller=jcontroller, metrics=jmetrics, recorder=jrecorder,
    series=jseries, slo=jslo, health=jhealth, tuning=jtuning, name="ref")

_ENV = ("MESH_TPU_TUNER", "MESH_TPU_TUNER_INTERVAL", "MESH_TPU_TUNER_AB_TOL",
        "MESH_TPU_KNOB_TAIL", "MESH_TPU_COALESCE_WINDOW_MS",
        "MESH_TPU_ACCEL_MIN_FACES", "MESH_TPU_MXU_CROSSOVER_FACES",
        "MESH_TPU_BVH_STREAM_BUFFERS", "MESH_TPU_FLEET_SHARD_MIN_Q",
        "MESH_TPU_ANIM_REFIT_MAX_INFLATION", "MESH_TPU_SERVE_LADDER",
        "MESH_TPU_RECORDER", "MESH_TPU_SLO_DRIVES_HEALTH", "MESH_TPU_OBS")


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MESH_TPU_INCIDENT_DIR", str(tmp_path / "incidents"))
    tobs.reset()
    jobs.reset()
    yield
    tobs.reset()
    jobs.reset()


def both(fn):
    return fn(PORT), fn(REF)


def _same(fn):
    mine, theirs = both(fn)
    assert mine == theirs
    return mine


class _FakeClock(object):
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


# ---------------------------------------------------------------------------
# knobs


_NEW_KNOBS = (
    "MESH_TPU_OBS_JSONL", "MESH_TPU_OBS_JSONL_MAX_MB",
    "MESH_TPU_OBS_JSONL_KEEP", "MESH_TPU_INCIDENT_KEEP",
    "MESH_TPU_SLO_DRIVES_HEALTH", "MESH_TPU_LEDGER_TAIL", "MESH_TPU_TUNER",
    "MESH_TPU_TUNER_INTERVAL", "MESH_TPU_TUNER_AB_TOL", "MESH_TPU_KNOB_TAIL",
    "MESH_TPU_TRACE_RESERVOIR", "MESH_TPU_SERVE_QUEUE",
    "MESH_TPU_SERVE_DEADLINE_S", "MESH_TPU_SERVE_WORKERS",
    "MESH_TPU_SERVE_LADDER", "MESH_TPU_SERVE_WEDGE_S")


@pytest.mark.parametrize("name", _NEW_KNOBS)
def test_knob_defaults_match_reference(name):
    assert tknobs.KNOBS[name] == jknobs.lookup(name).default


def test_path_knobs_default_to_the_ports_own_files():
    # unset, the reference resolves its own ~/.mesh_tpu files; the port's
    # resolve under ~/.mesh_tpu_torch (serve/service.py, obs/recorder.py)
    for name in ("MESH_TPU_INCIDENT_DIR", "MESH_TPU_SERVE_STATS"):
        assert tknobs.KNOBS[name] is None
        assert jknobs.lookup(name).kind == "path"


# ---------------------------------------------------------------------------
# windowed series


@pytest.mark.parametrize("buckets,q", [
    ([[0.1, 8], [0.25, 9], ["+Inf", 10]], 0.5),
    ([[0.1, 8], [0.25, 9], ["+Inf", 10]], 0.99),
    ([[0.001, 0], [0.01, 0], ["+Inf", 0]], 0.5),
    ([[0.5, 1], [1.0, 1], ["+Inf", 4]], 0.9),
    ([], 0.5),
])
def test_quantile_from_cumulative_matches_reference(buckets, q):
    assert tseries.quantile_from_cumulative(buckets, q) == \
        jseries.quantile_from_cumulative(buckets, q)


def test_sample_ring_matches_reference():
    def run(pkg):
        ring = pkg.series.SampleRing(history=4)
        empty = ring.deltas(10.0, 0.0)
        for t, vals in ((0, (0, 0)), (10, (5, 8)), (20, (9, 20)),
                        (30, (12, 31)), (40, (20, 40))):
            ring.append(t, vals)
        copy = ring.copy()
        ring.append(50, (25, 55))
        return (empty, len(ring), ring.latest(), ring.boundary(25),
                ring.deltas(15, 50), ring.deltas(1000, 50),
                copy.deltas(15, 40))

    _same(run)


def test_windowed_series_matches_reference():
    def run(pkg):
        reg = pkg.metrics.Registry()
        clock = _FakeClock(0.0)
        series = pkg.series.WindowedSeries(registry=reg, resolution_s=1.0,
                                           capacity=16, clock=clock)
        hist = reg.histogram("mesh_tpu_request_stage_seconds", "s")
        count = reg.counter("mesh_tpu_serve_requests_total", "r")
        out = []
        for step in range(12):
            clock.t = float(step) + 0.5
            for i in range(step % 4 + 1):
                hist.observe(0.001 * (step + 1) * (i + 1),
                             stage="queue" if i % 2 else "device",
                             backend="xla")
                count.inc(tenant="a" if i % 2 else "b", outcome="ok")
            out.append(series.tick())
        out.append(series.tick(now=11.9))            # same window: refresh
        return (out, len(series.windows()),
                series.delta("mesh_tpu_serve_requests_total", 5.0),
                series.delta("mesh_tpu_serve_requests_total", 5.0,
                             labels={"tenant": "a"}),
                series.rate("mesh_tpu_serve_requests_total", 4.0),
                series.percentile("mesh_tpu_request_stage_seconds", 0.99,
                                  window_s=6.0),
                series.percentile("mesh_tpu_request_stage_seconds", 0.5,
                                  window_s=6.0, labels={"stage": "queue"}),
                series.window_percentile("mesh_tpu_request_stage_seconds",
                                         0.9, 3.0, 8.0),
                series.percentile("missing", 0.5),
                sorted(series.stage_breakdown(window_s=5.0).items()))

    _same(run)


# ---------------------------------------------------------------------------
# SLOs: compliance and burn decisions


def _traffic(reg, tenant, ok, late, errors, latency_s):
    """Record one burst of serve traffic into ``reg`` the way QueryService
    does: requests by outcome, good (ok and on time), latency."""
    reqs = reg.counter("mesh_tpu_serve_requests_total", "r")
    good = reg.counter("mesh_tpu_serve_good_total", "g")
    lat = reg.histogram("mesh_tpu_serve_latency_seconds", "l")
    for _ in range(ok):
        reqs.inc(tenant=tenant, outcome="ok")
        good.inc(tenant=tenant)
        lat.observe(latency_s, tenant=tenant, backend="none")
    for _ in range(late):
        reqs.inc(tenant=tenant, outcome="ok")
        lat.observe(10 * latency_s, tenant=tenant, backend="none")
    for _ in range(errors):
        reqs.inc(tenant=tenant, outcome="deadline")


@pytest.mark.parametrize("kind,target,threshold", [
    ("availability", 0.99, None), ("availability", 0.5, None),
    ("latency", 0.9, 0.05), ("latency", 0.99, 0.25)])
def test_compliance_matches_reference(kind, target, threshold):
    def run(pkg):
        reg = pkg.metrics.Registry()
        _traffic(reg, "web", ok=90, late=6, errors=4, latency_s=0.02)
        _traffic(reg, "batch", ok=10, late=0, errors=0, latency_s=0.2)
        snap = reg.snapshot()
        slo = pkg.slo.SLO("obj", kind, target, threshold_s=threshold)
        return (pkg.slo.tenants(snap),
                [pkg.slo.compliance(snap, slo, t)
                 for t in pkg.slo.tenants(snap) + ["ghost"]],
                repr(slo))

    rows = _same(run)[1]
    if kind == "availability":
        assert rows[0]["good"] == 10 and rows[1]["good"] == 90 \
            and rows[1]["total"] == 100


@pytest.mark.parametrize("drives_health", [False, True])
def test_burn_decisions_and_incident_response_match_reference(
        drives_health, monkeypatch, tmp_path):
    if drives_health:
        monkeypatch.setenv("MESH_TPU_SLO_DRIVES_HEALTH", "1")

    def run(pkg):
        monkeypatch.setenv("MESH_TPU_INCIDENT_DIR",
                           str(tmp_path / pkg.name))
        reg = pkg.metrics.Registry()
        clock = _FakeClock(0.0)
        mon = pkg.slo.SLOMonitor(
            objectives=pkg.slo.default_slos(latency_threshold_s=0.05),
            registry=reg, clock=clock,
            rules=[pkg.slo.BurnRateRule("fast_burn", 300, 60, 10.0),
                   pkg.slo.BurnRateRule("slow_burn", 900, 300, 2.0)])
        rec = pkg.recorder.FlightRecorder(capacity=64, registry=reg,
                                          clock=clock)
        health = pkg.health.HealthMonitor(watchdog=False, clock=clock,
                                          recorder=rec)
        pkg.slo.bind_incident_response(mon, recorder=rec, health=health)
        seen = []
        mon.on_breach(seen.append)
        decisions = []
        script = [(100, 0, 0), (95, 3, 2), (40, 30, 30), (100, 0, 0),
                  (100, 0, 0), (10, 10, 80), (100, 0, 0)]
        for step, (ok, late, err) in enumerate(script):
            clock.t = 30.0 * step
            _traffic(reg, "web", ok, late, err, latency_s=0.01)
            mon.tick()
            rows = mon.evaluate()
            decisions.append([
                (r["objective"], r["tenant"], rule["rule"],
                 round(rule["long_burn"], 9), round(rule["short_burn"], 9),
                 rule["breaching"], rule["new"])
                for r in rows for rule in r["rules"]])
        burns = [{k: (round(v, 9) if isinstance(v, float) else v)
                  for k, v in row.items()} for row in mon.burn_rates()]
        mon.stop()
        return (decisions, seen, sorted(mon.breaching()), burns,
                health.state_name,
                [e["kind"] for e in rec.events()
                 if e["kind"] in ("slo.breach", "health.trip")],
                len(pkg.recorder.list_incidents()))

    out = _same(run)
    assert out[1], "the script never breached"
    assert out[4] == ("degraded" if drives_health else "healthy")


def test_slo_validation_and_defaults_match_reference():
    def run(pkg):
        errors = []
        for args in (("x", "throughput", 0.9), ("x", "availability", 1.0),
                     ("x", "latency", 0.9)):
            with pytest.raises(ValueError) as err:
                pkg.slo.SLO(*args)
            errors.append(str(err.value))
        return (errors, [repr(s) for s in pkg.slo.default_slos()],
                [repr(r) for r in pkg.slo.default_rules()])

    _same(run)


# ---------------------------------------------------------------------------
# the tunable-knob layer


def test_tunables_actuate_like_reference(monkeypatch):
    def run(pkg):
        tun = pkg.tuning
        tun.reset()
        out = []
        out.append(tun.actuate("coalesce_window_ms", 50.0, reason="clamp",
                               evidence={"p": 1}, now=1.0))
        out.append(tun.actuate("coalesce_window_ms", 20.0, reason="same"))
        out.append(tun.actuate("accel_min_faces", 1, reason="low", now=2.0))
        out.append(tun.actuate("serve_pre_trip", 1, reason="trip", now=3.0))
        out.append((tun.get("coalesce_window_ms"),
                    tun.tuned_value("accel_min_faces"), tun.generation()))
        monkeypatch.setenv("MESH_TPU_SERVE_LADDER", "engine,culled")
        out.append((tun.pinned("serve_pre_trip"), tun.get("serve_pre_trip"),
                    tun.actuate("serve_pre_trip", 0, reason="x")))
        monkeypatch.setenv("MESH_TPU_COALESCE_WINDOW_MS", "7.5")
        out.append((tun.get("coalesce_window_ms"),
                    tun.tuned_value("coalesce_window_ms")))
        out.append(tun.status())
        monkeypatch.delenv("MESH_TPU_SERVE_LADDER")
        monkeypatch.delenv("MESH_TPU_COALESCE_WINDOW_MS")
        monkeypatch.setenv("MESH_TPU_TUNER", "0")
        out.append((tun.enabled(), tun.get("accel_min_faces"),
                    tun.actuate("shard_min_q", 8192, reason="off")))
        monkeypatch.delenv("MESH_TPU_TUNER")
        monkeypatch.setenv("MESH_TPU_KNOB_TAIL", "2")
        out.append(tun.history_tail())
        out.append(tun.history_tail(10))
        out.append([tun.lookup(n).clamp(v) for n, v in (
            ("coalesce_window_ms", -3), ("stream_n_buffers", 2.7),
            ("anim_refit_max_inflation", 9))])
        changes = [(e["knob"], e["after"]) for e in
                   pkg.recorder.get_recorder().events()
                   if e["kind"] == "knob_change"]
        gauge = pkg.obs.REGISTRY.get("mesh_tpu_tuner_generation").value()
        tun.reset()
        return out, changes, gauge

    out, changes, gauge = _same(run)
    assert out[0]["after"] == 20.0 and out[1] is None and gauge == 3


def test_tuned_values_steer_the_ports_routing_thresholds(monkeypatch):
    ttuning.reset()
    try:
        base = (tautotune.accel_crossover_faces(),
                tautotune.mxu_crossover_faces(),
                tautotune.stream_tile_params()[2])
        ttuning.actuate("accel_min_faces", 65536, reason="t")
        ttuning.actuate("mxu_crossover", 16384, reason="t")
        ttuning.actuate("stream_n_buffers", 4, reason="t")
        assert (tautotune.accel_crossover_faces(),
                tautotune.mxu_crossover_faces(),
                tautotune.stream_tile_params()[2]) == (65536, 16384, 4)
        monkeypatch.setenv("MESH_TPU_ACCEL_MIN_FACES", "5000")
        assert tautotune.accel_crossover_faces() == 5000   # the pin wins
        monkeypatch.delenv("MESH_TPU_ACCEL_MIN_FACES")
        monkeypatch.setenv("MESH_TPU_TUNER", "0")
        assert (tautotune.accel_crossover_faces(),
                tautotune.mxu_crossover_faces(),
                tautotune.stream_tile_params()[2]) == base
        hooks = tautotune.retune_hooks()
        assert sorted(hooks) == ["accel_min_faces", "mxu_crossover",
                                 "stream_n_buffers"]
        assert all(fn() is None for fn in hooks.values())   # no card here
    finally:
        ttuning.reset()


# ---------------------------------------------------------------------------
# the controller


class _FakeMonitor(object):
    def __init__(self):
        self.pressure = 0.0

    def burn_rates(self, now=None):
        return [{"objective": "latency_p99", "tenant": None,
                 "rule": "fast_burn", "pressure": self.pressure}]


_SCRIPTS = {
    # (t, pressure, latency_s, feed) per step
    "widen_confirmed": [(t, 0.0, 0.01, True) for t in range(0, 100, 10)],
    "widen_regressed": [(0, 0.0, 0.01, True), (10, 0.0, 0.01, True),
                        (20, 0.0, 0.5, True), (35, 0.0, 0.5, True),
                        (45, 0.0, 0.5, True)],
    "no_evidence_reverts": [(0, 0.0, 0.01, True), (10, 0.0, 0.01, True),
                            (45, 0.0, 0.01, False)],
    "latency_then_release": [(0, 0.0, 0.01, True), (10, 0.0, 0.01, True),
                             (20, 0.7, 0.01, True), (30, 0.9, 0.01, True),
                             (40, 0.3, 0.01, True), (50, 0.05, 0.01, True),
                             (60, 0.0, 0.01, True)],
    "retune": [(t, 0.2, 0.01, True) for t in range(0, 50, 10)],
}


@pytest.mark.parametrize("script", sorted(_SCRIPTS))
def test_controller_histories_match_reference(script):
    def run(pkg):
        pkg.tuning.reset()
        t = [0.0]
        clock = lambda: t[0]                          # noqa: E731
        hist = pkg.obs.REGISTRY.histogram(
            pkg.controller.LATENCY_METRIC, "serve latency (test)")
        series = pkg.series.WindowedSeries(registry=pkg.obs.REGISTRY,
                                           resolution_s=1.0, capacity=512,
                                           clock=clock)
        monitor = _FakeMonitor()
        retune = {"accel_min_faces": lambda: (200000, {"source": "test"}),
                  "stream_n_buffers": lambda: None}
        ctrl = pkg.controller.TunerController(
            series=series, monitor=monitor, clock=clock, ab_tol=0.2,
            holdout_s=30.0, retune_fns=retune, retune_every=2)
        steps = []
        for now, pressure, latency_s, feed in _SCRIPTS[script]:
            t[0] = float(now)
            monitor.pressure = pressure
            if feed:
                for _ in range(8):
                    hist.observe(latency_s, tenant="t", backend="bvh")
                series.tick(now=now)
            steps.append(ctrl.step(now=now))
        history = pkg.tuning.history_tail(64)
        status = pkg.tuning.status()
        evals = pkg.obs.REGISTRY.get(
            "mesh_tpu_tuner_evaluations_total").snapshot()
        pkg.tuning.reset()
        return steps, history, status, evals

    steps, history, _, _ = _same(run)
    assert history or script == "retune"


def test_controller_kill_switch_and_thread_match_reference(monkeypatch):
    def run(pkg):
        ctrl = pkg.controller.TunerController(
            series=pkg.series.WindowedSeries(), monitor=_FakeMonitor())
        assert ctrl.pressure() == 0.0
        monkeypatch.setenv("MESH_TPU_TUNER", "0")
        off = ctrl.step(now=1.0)
        started = ctrl.start(interval_s=0.01)._thread
        monkeypatch.delenv("MESH_TPU_TUNER")
        ctrl.start(interval_s=3600.0)
        alive = ctrl._thread.is_alive()
        ctrl.stop()
        return off, started, alive, ctrl._thread

    assert _same(run) == ({"mode": "disabled", "actions": []}, None, True,
                          None)
