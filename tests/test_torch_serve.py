"""mesh_tpu_torch.serve vs mesh_tpu.serve on the CPU.

The same scenarios run through both packages and must give the same
answers: weighted-fair pop orders, ladder walks under fault injection
(plain-Python rungs), health state machines on a fake clock, admission
and backpressure outcomes with their ``retry_after`` hints, the serve.*
counters, and load-generator reports under fake clocks.  The real
ladder runs one one-rung ladder at a time on a small mesh (the port's
``Mesh(device="cpu")``, the reference's JAX CPU engine): equal rung names
and ``certified`` flags, faces equal except at float64 ties, points within
1e-5.
"""

import json
import threading
import time
import types

import numpy as np
import pytest
import torch

import mesh_tpu
import mesh_tpu.errors as jerrors
import mesh_tpu.obs as jobs
import mesh_tpu.serve as jserve
from mesh_tpu.serve import deadline as jdeadline
from mesh_tpu.utils import tuning as jtuning

import mesh_tpu_torch
import mesh_tpu_torch.errors as terrors
import mesh_tpu_torch.obs as tobs
import mesh_tpu_torch.serve as tserve
from mesh_tpu_torch.accel import build as tbuild
from mesh_tpu_torch.query.point_triangle import closest_point_on_triangle
from mesh_tpu_torch.serve import deadline as tdeadline
from mesh_tpu_torch.utils import tuning as ttuning

from .test_torch_anim import sphere

torch.set_num_threads(2)

PORT = types.SimpleNamespace(serve=tserve, errors=terrors, obs=tobs,
                             deadline=tdeadline, name="port")
REF = types.SimpleNamespace(serve=jserve, errors=jerrors, obs=jobs,
                            deadline=jdeadline, name="ref")

#: points where the faces agree, and the float64 gap at a tie
VALUE_TOL = 1e-5
TIE_TOL = 1e-6

_ENV = ("MESH_TPU_SERVE_LADDER", "MESH_TPU_SERVE_QUEUE",
        "MESH_TPU_SERVE_DEADLINE_S", "MESH_TPU_SERVE_WORKERS",
        "MESH_TPU_SERVE_WEDGE_S", "MESH_TPU_TUNER", "MESH_TPU_OBS",
        "MESH_TPU_REPLAY_TRACE", "MESH_TPU_LEDGER", "MESH_TPU_RECORDER")


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MESH_TPU_INCIDENT_DIR", str(tmp_path / "incidents"))
    monkeypatch.setenv("MESH_TPU_SERVE_STATS", str(tmp_path / "stats.json"))
    tobs.reset()
    jobs.reset()
    yield
    tobs.reset()
    jobs.reset()


def both(fn):
    """``fn(pkg)`` on the port and on the reference -> (port's, ref's)."""
    return fn(PORT), fn(REF)


def _same(fn):
    mine, theirs = both(fn)
    assert mine == theirs
    return mine


# ---------------------------------------------------------------------------
# fake rungs: plain Python, deterministic


_MESH = object()            # fake ladders never touch the mesh
_PTS = np.zeros((4, 3), np.float32)


def _answer(pkg, rung_name, certified=True):
    return pkg.serve.ServeResult(np.zeros((1, 4), np.uint32),
                                 np.zeros((4, 3), np.float64), rung_name,
                                 certified=certified)


def _ok_rung(pkg, name="ok", certified=True):
    return pkg.serve.Rung(
        name, lambda mesh, points, chunk, timeout: _answer(pkg, name,
                                                           certified))


def _failing_rung(pkg, name="boom", error=RuntimeError):
    def fn(mesh, points, chunk, timeout):
        raise error("%s rung failed" % name)
    return pkg.serve.Rung(name, fn)


def _blocked_rung(pkg, release, name="wedged"):
    """A rung wedged until ``release`` is set, bounded by its slice the way
    the built-in rungs bound a device call."""
    def fn(mesh, points, chunk, timeout):
        return pkg.serve.call_with_timeout(
            lambda: release.wait(30.0) and _answer(pkg, name), timeout)
    return pkg.serve.Rung(name, fn)


def _counter(pkg, name, **labels):
    metric = pkg.obs.REGISTRY.get(name)
    if metric is None:
        return 0
    return metric.value(**labels) if labels else metric.total()


def _service(pkg, **kw):
    kw.setdefault("health", pkg.serve.HealthMonitor(watchdog=False))
    kw.setdefault("workers", 1)
    kw.setdefault("ladder", [_ok_rung(pkg)])
    return pkg.serve.QueryService(**kw)


# ---------------------------------------------------------------------------
# WeightedFairQueue


@pytest.mark.parametrize("weights,pushes", [
    (None, [("t", 3)]),
    ({"a": 2, "b": 1}, [("a", 6), ("b", 3)]),
    ({"a": 3, "b": 1, "c": 0.5}, [("c", 4), ("a", 7), ("b", 5)]),
    ({"slow": 0.25}, [("slow", 3), ("fast", 3)]),
    ({"x": 1.5, "y": 2.5}, [("y", 9), ("x", 9)]),
])
def test_wfq_pop_order_matches_reference(weights, pushes):
    def run(pkg):
        wfq = pkg.serve.WeightedFairQueue(weights)
        for tenant, n in pushes:
            for i in range(n):
                wfq.push(tenant, i)
        depths = wfq.depths()
        order = []
        while True:
            popped = wfq.pop()
            if popped is None:
                break
            order.append(popped)
            if len(order) % 4 == 0:             # interleave late arrivals
                wfq.push("late", len(order))
        return depths, order

    depths, order = _same(run)
    assert len(order) == sum(n for _, n in pushes) + len(order) // 4


# ---------------------------------------------------------------------------
# Deadline, call_with_timeout and the ladder under fault injection


def test_deadline_and_call_with_timeout():
    d = tserve.Deadline(10.0)
    assert 9.0 < d.remaining() <= 10.0 and 19.0 < d.hard_remaining() <= 20.0
    assert not d.expired() and tserve.Deadline(-0.001).expired()
    assert tserve.call_with_timeout(lambda: 42, timeout=5.0) == 42
    with pytest.raises(KeyError):
        tserve.call_with_timeout(lambda: {}["missing"], timeout=5.0)
    t0 = time.perf_counter()
    with pytest.raises(terrors.DeadlineExceeded):
        tserve.call_with_timeout(lambda: time.sleep(5), timeout=0.05)
    assert time.perf_counter() - t0 < 2.0
    assert tserve.call_with_timeout is tobs.call_with_timeout


class _FakeChild(object):
    """A child process that exits ``exit_after`` polls after the signal
    named ``exits_on`` (None: it never exits); ``raise_on`` names the
    signal whose call raises OSError.  Logs every call."""

    def __init__(self, exits_on, exit_after=0, raise_on=None):
        self.exits_on, self.exit_after = exits_on, exit_after
        self.raise_on = raise_on
        self.signalled = set()
        self.polls_since = 0
        self.log = []

    def poll(self):
        self.log.append("poll")
        if self.exits_on == "already":
            return 0
        if self.exits_on in self.signalled:
            self.polls_since += 1
            if self.polls_since > self.exit_after:
                return -15
        return None

    def _signal(self, name):
        self.log.append(name)
        if name == self.raise_on:
            raise OSError("no such process")
        self.signalled.add(name)

    def terminate(self):
        self._signal("terminate")

    def kill(self):
        self._signal("kill")


@pytest.mark.parametrize("exits_on,exit_after,raise_on", [
    ("already", 0, None), ("terminate", 0, None), ("terminate", 7, None),
    ("kill", 3, None), (None, 0, None), ("kill", 0, "terminate"),
    (None, 0, "kill")])
def test_reap_child_like_reference(exits_on, exit_after, raise_on):
    from mesh_tpu.obs import perf as jperf
    from mesh_tpu_torch.obs import perf as tperf

    out = []
    for reap in (tperf.reap_child, jperf.reap_child):
        child = _FakeChild(exits_on, exit_after, raise_on)
        now = [0.0]
        sleeps = []

        def sleep(s):
            sleeps.append(s)
            now[0] += s

        result = reap(child, term_grace_s=0.5, kill_grace_s=1.0,
                      clock=lambda: now[0], sleep=sleep)
        out.append((result, child.log, len(sleeps)))
    assert out[0] == out[1]
    assert out[0][0] == {"already": "terminated", "terminate": "terminated",
                         "kill": "killed", None: "abandoned"}[exits_on]


_LADDERS = {
    "happy": lambda pkg, rel: [_ok_rung(pkg, "a"), _ok_rung(pkg, "b")],
    "falls_through": lambda pkg, rel: [
        _failing_rung(pkg, "boom"), _ok_rung(pkg, "backup", False)],
    "wedged_top": lambda pkg, rel: [
        _blocked_rung(pkg, rel), _ok_rung(pkg, "backup")],
    "two_wedged": lambda pkg, rel: [
        _blocked_rung(pkg, rel, "w1"), _blocked_rung(pkg, rel, "w2"),
        _ok_rung(pkg, "last")],
    "all_fail": lambda pkg, rel: [
        _failing_rung(pkg, "a"), _failing_rung(pkg, "b", ValueError)],
}


@pytest.mark.parametrize("scenario", sorted(_LADDERS))
def test_ladder_walk_matches_reference(scenario):
    deadline_s = 0.2

    def run(pkg):
        release = threading.Event()
        health = pkg.serve.HealthMonitor(watchdog=False, wedge_after_s=60.0)
        t0 = time.perf_counter()
        try:
            result, retries = pkg.serve.run_with_ladder(
                _MESH, _PTS, pkg.serve.Deadline(deadline_s),
                ladder=_LADDERS[scenario](pkg, release), health=health)
            out = (result.rung, retries, result.certified,
                   result.approximate)
        except pkg.errors.DeadlineExceeded as e:
            out = ("raised", type(e.__cause__).__name__, e.rung)
        finally:
            release.set()
        assert time.perf_counter() - t0 < 2.0 * deadline_s + 0.15
        retried = _counter(pkg, "mesh_tpu_serve_retries_total")
        return out, retried, health.state_name, \
            health.snapshot()["inflight"]

    _same(run)


def test_ladder_base_exception_closes_health_token():
    def run(pkg):
        health = pkg.serve.HealthMonitor(watchdog=False)

        def fn(mesh, points, chunk, timeout):
            raise KeyboardInterrupt()

        with pytest.raises(KeyboardInterrupt):
            pkg.serve.run_with_ladder(
                _MESH, _PTS, pkg.serve.Deadline(0.5),
                ladder=[pkg.serve.Rung("intr", fn)], health=health)
        return health.snapshot()["inflight"], health.state_name

    assert _same(run) == (0, "degraded")


@pytest.mark.parametrize("spec", [None, "anchored,engine", "accel",
                                  "engine, culled ,anchored,accel", "bogus",
                                  ","])
def test_default_ladder_env_matches_reference(spec, monkeypatch):
    if spec is not None:
        monkeypatch.setenv("MESH_TPU_SERVE_LADDER", spec)

    def run(pkg):
        try:
            return [r.name for r in pkg.serve.default_ladder()]
        except ValueError as e:
            return "ValueError: %s" % e

    _same(run)


@pytest.mark.parametrize("degraded,pre_trip,rungs", [
    (False, False, 3), (True, False, 3), (False, True, 3), (True, True, 1)])
def test_effective_start_rung_matches_reference(degraded, pre_trip, rungs):
    def run(pkg):
        tuning = ttuning if pkg is PORT else jtuning
        tuning.reset()
        if pre_trip:
            tuning.actuate("serve_pre_trip", 1, reason="test")
        try:
            return pkg.deadline.effective_start_rung(
                degraded, [None] * rungs)
        finally:
            tuning.reset()

    _same(run)


# ---------------------------------------------------------------------------
# HealthMonitor on a fake clock


class _FakeClock(object):
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


_HEALTH = {
    "fast_success": [("ok", 0.1)],
    "slow_then_recover": [("ok", 5.0), ("ok", 0.1), ("ok", 0.1)],
    "failed_then_drain": [("fail", 0.1)] * 3 + [("ok", 0.1)],
    "inflight_wedge": [("begin", 0.0), ("check", 2.0), ("check", 0.0),
                       ("ok", 0.1), ("ok", 0.1), ("ok", 0.1)],
    "begin_drain_reset": [("ok", 0.1), ("drain", 0.0), ("ok", 0.1),
                          ("reset", 0.0), ("trip", 0.0)],
}


@pytest.mark.parametrize("script", sorted(_HEALTH))
def test_health_state_machine_matches_reference(script):
    def run(pkg):
        clock = _FakeClock()
        mon = pkg.serve.HealthMonitor(
            wedge_after_s=1.0, recover_after=2, drain_after=3,
            watchdog=False, clock=clock,
            recorder=pkg.obs.FlightRecorder(capacity=64))
        seen = []
        for action, dt in _HEALTH[script]:
            if action in ("ok", "fail"):
                token = mon.dispatch_began("engine")
                clock.t += dt
                mon.dispatch_finished(token, ok=(action == "ok"))
            elif action == "begin":
                mon.dispatch_began("engine")
            elif action == "check":
                clock.t += dt
                seen.append(len(mon.check_now()))
            elif action == "drain":
                mon.begin_drain()
            elif action == "reset":
                mon.reset()
            else:
                mon.trip("manual")
            seen.append((mon.state_name, mon.ready(), mon.live(),
                         mon.snapshot()))
        gauge = pkg.obs.REGISTRY.get("mesh_tpu_serve_health_state").value()
        return seen, gauge, _counter(pkg,
                                     "mesh_tpu_serve_watchdog_trips_total")

    _same(run)


def test_health_watchdog_thread_trips_a_real_wedge():
    """The watchdog thread itself (real clock, 0.2 s threshold): an
    in-flight dispatch that never finishes degrades health within about
    a second."""
    mon = tserve.HealthMonitor(wedge_after_s=0.2,
                               recorder=tobs.FlightRecorder(capacity=64))
    try:
        mon.dispatch_began("engine")
        for _ in range(200):
            if mon.state == tserve.DEGRADED:
                break
            time.sleep(0.01)
        assert mon.state == tserve.DEGRADED and mon.live()
        assert mon.snapshot()["inflight"] == 0
    finally:
        mon.stop()


# ---------------------------------------------------------------------------
# QueryService admission, backpressure and execution


def test_service_answers_with_metadata():
    def run(pkg):
        svc = _service(pkg, default_deadline_s=5.0)
        try:
            resp = svc.query(_MESH, _PTS, tenant="t1")
        finally:
            svc.stop(write_stats=False)
        d = resp.to_dict()
        assert 0 <= d.pop("latency_ms") < 5e3
        return d, _counter(pkg, "mesh_tpu_serve_good_total", tenant="t1")

    assert _same(run)[0]["rung"] == "ok"


def test_service_queue_full_rejects_with_retry_after():
    def run(pkg):
        svc = _service(pkg, max_queue_per_tenant=2, default_deadline_s=2.0)
        try:
            svc.hold()
            futs = [svc.submit(_MESH, _PTS) for _ in range(2)]
            with pytest.raises(pkg.errors.ServeRejected) as err:
                svc.submit(_MESH, _PTS)
            other = svc.submit(_MESH, _PTS, tenant="other")
            depths = svc.stats()["queues"]
            svc.release()
            rungs = [f.result(timeout=30).rung for f in futs + [other]]
        finally:
            svc.stop(write_stats=False)
        return (err.value.reason, err.value.retry_after, depths, rungs,
                _counter(pkg, "mesh_tpu_serve_shed_total",
                         reason="queue_full"))

    assert _same(run)[:2] == ("queue_full", 1.0)


def test_service_draining_and_degraded_shedding():
    def run(pkg):
        svc = _service(pkg, ladder=[_ok_rung(pkg, "a"), _ok_rung(pkg, "b")])
        try:
            svc.health.trip("dispatch_slow")
            with pytest.raises(pkg.errors.ServeRejected) as low:
                svc.submit(_MESH, _PTS, priority=-1)
            rung = svc.query(_MESH, _PTS).rung      # one rung down
            svc.health.begin_drain()
            with pytest.raises(pkg.errors.ServeRejected) as drain:
                svc.submit(_MESH, _PTS)
        finally:
            svc.stop(write_stats=False)
        return (low.value.reason, low.value.retry_after, rung,
                drain.value.reason, drain.value.retry_after,
                [e["kind"] for e in pkg.obs.get_recorder().events()
                 if e["kind"].startswith("serve.")])

    assert _same(run)[2] == "b"


def test_service_expired_in_queue_and_outcome_counters():
    def run(pkg):
        svc = _service(pkg, ladder=[_failing_rung(pkg, "only")])
        try:
            svc.hold()
            fut = svc.submit(_MESH, _PTS, tenant="q", deadline_s=0.05)
            time.sleep(0.15)
            svc.release()
            with pytest.raises(pkg.errors.DeadlineExceeded):
                fut.result(timeout=30)
            with pytest.raises(pkg.errors.DeadlineExceeded):
                svc.query(_MESH, _PTS, tenant="e", deadline_s=0.1)
        finally:
            svc.stop(write_stats=False)
        outcomes = sorted(
            (s["labels"]["tenant"], s["labels"]["outcome"], s["value"])
            for s in pkg.obs.REGISTRY.get(
                "mesh_tpu_serve_requests_total").snapshot()["series"])
        rows = sorted((r["tenant"], r["outcome"], sorted(r["stages"]))
                      for r in pkg.obs.get_ledger().records())
        return (outcomes, rows,
                _counter(pkg, "mesh_tpu_serve_shed_total",
                         reason="expired_in_queue"),
                _counter(pkg, "mesh_tpu_serve_deadline_miss_total"))

    _same(run)


def test_service_stop_without_drain_closes_records():
    def run(pkg):
        svc = _service(pkg)
        svc.hold()
        futs = [svc.submit(_MESH, _PTS, tenant="stop") for _ in range(3)]
        svc.stop(drain=False, write_stats=False)
        assert all(f.cancelled() or f.done() for f in futs)
        return sorted(r["outcome"] for r in pkg.obs.get_ledger().records())

    assert _same(run) == ["cancelled"] * 3


def test_service_stats_sink_and_ledger_stamps(tmp_path):
    def run(pkg):
        sink = str(tmp_path / ("%s.json" % pkg.name))
        svc = _service(pkg, stats_path=sink)
        try:
            svc.query(_MESH, _PTS, tenant="sink")
            svc.query(_MESH, _PTS, tenant="sink", priority=2)
        finally:
            svc.stop()
        with open(sink) as fh:
            data = json.load(fh)
        rows = pkg.obs.get_ledger().records()
        return (data["health"]["state"], sorted(data["metrics"]),
                data["metrics"]["mesh_tpu_serve_requests_total"]["series"],
                [(r["tenant"], r["priority"], r["outcome"], r["rung"],
                  r["certified"], sorted(r["stages"]), r["seq"])
                 for r in rows])

    _same(run)


def test_default_stats_path_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("MESH_TPU_SERVE_STATS")
    mine, theirs = tserve.default_stats_path(), jserve.default_stats_path()
    assert mine != theirs
    assert mine.endswith(".mesh_tpu_torch/serve_stats.json")
    assert theirs.endswith(".mesh_tpu/serve_stats.json")


# ---------------------------------------------------------------------------
# the wedge: degraded, one rung down, recovered


def test_wedge_degrades_then_recovers():
    """A top rung blocked on an Event with a 0.2 s wedge threshold: the
    request answers from the engine-like rung with one retry within 2x
    its deadline; health goes DEGRADED and the next request starts at
    rung 1; once the rung is released, ``recover_after`` successes bring
    health back to HEALTHY."""
    release = threading.Event()
    health = tserve.HealthMonitor(wedge_after_s=0.2, recover_after=2,
                                  watchdog=False)
    svc = _service(PORT, health=health, default_deadline_s=0.3,
                   ladder=[_blocked_rung(PORT, release),
                           _ok_rung(PORT, "engine")])
    try:
        t0 = time.perf_counter()
        resp = svc.query(_MESH, _PTS)
        assert time.perf_counter() - t0 < 0.6 + 0.15
        assert (resp.rung, resp.retries) == ("engine", 1)
        assert health.state == tserve.DEGRADED
        resp = svc.query(_MESH, _PTS)
        assert (resp.rung, resp.retries) == ("engine", 0)
        release.set()
        resp = svc.query(_MESH, _PTS)
        assert health.state == tserve.HEALTHY
    finally:
        release.set()
        svc.stop(write_stats=False)


# ---------------------------------------------------------------------------
# the real ladder on a small mesh, one rung at a time


@pytest.fixture(scope="module")
def small_mesh():
    v, f = sphere(2)                         # 320 faces
    pts = np.asarray(np.random.RandomState(0).randn(96, 3) * 0.8,
                     np.float32)
    return v, f, pts


def _serve_answer(pkg, ladder_names, v, f, pts):
    rungs = {"engine": pkg.deadline._rung_engine,
             "culled": pkg.deadline._rung_culled,
             "anchored": pkg.deadline._rung_anchored,
             "accel": pkg.deadline._rung_accel}
    ladder = [pkg.serve.Rung(n, rungs[n]) for n in ladder_names]
    mesh = (mesh_tpu_torch.Mesh(v, f, device="cpu") if pkg is PORT
            else mesh_tpu.Mesh(v=v, f=f))
    svc = pkg.serve.QueryService(workers=1, ladder=ladder,
                                 default_deadline_s=60.0,
                                 health=pkg.serve.HealthMonitor(
                                     watchdog=False))
    try:
        warmed = svc.warmup(mesh, queries=32)
        resp = svc.query(mesh, pts, tenant="real")
    finally:
        svc.stop(write_stats=False)
    return warmed, resp


def _assert_serve_answers(ref, out, v, f, q):
    """Faces equal except at float64 ties, points within VALUE_TOL where
    the faces agree, distances within VALUE_TOL everywhere."""
    face_r, face_o = ref.faces[0].astype(np.int64), out.faces[0].astype(
        np.int64)
    q64 = q.astype(np.float64)
    sq_r = ((q64 - ref.points) ** 2).sum(-1)
    sq_o = ((q64 - out.points) ** 2).sum(-1)
    np.testing.assert_allclose(sq_o, sq_r, atol=VALUE_TOL)
    same = face_r == face_o
    np.testing.assert_allclose(out.points[same], ref.points[same],
                               atol=VALUE_TOL)
    if not same.all():
        tri = torch.from_numpy(v.astype(np.float64))[torch.from_numpy(
            f.astype(np.int64))]
        qd = torch.from_numpy(q64[~same])

        def sqd(face):
            t = tri[torch.from_numpy(face[~same])]
            return closest_point_on_triangle(qd, t[:, 0], t[:, 1], t[:, 2])[1]

        assert float((sqd(face_o) - sqd(face_r)).abs().max()) <= TIE_TOL


@pytest.mark.parametrize("rung", ["engine", "culled", "anchored", "accel"])
def test_one_rung_ladder_matches_reference(rung, small_mesh):
    v, f, pts = small_mesh
    tbuild.clear_index_cache()
    (warmed, out), (jwarmed, ref) = both(
        lambda pkg: _serve_answer(pkg, [rung], v, f, pts))
    assert warmed == jwarmed == [rung]
    assert (out.rung, out.certified, out.retries) == \
        (ref.rung, ref.certified, ref.retries) == (rung, ref.certified, 0)
    assert out.faces.shape == (1, len(pts)) and out.faces.dtype == np.uint32
    assert out.points.dtype == np.float64
    _assert_serve_answers(ref, out, v, f, pts)
    if rung in ("engine", "accel"):
        assert out.certified
    row = tobs.get_ledger().records()[-1]
    assert row["rung"] == rung and row["outcome"] == "ok"
    if rung != "engine":
        assert "device" in row["stages"]


def test_engine_fault_falls_through_to_culled(small_mesh):
    v, f, pts = small_mesh

    def run(pkg):
        def broken(mesh, points, chunk, timeout):
            raise RuntimeError("injected engine fault")

        mesh = (mesh_tpu_torch.Mesh(v, f, device="cpu") if pkg is PORT
                else mesh_tpu.Mesh(v=v, f=f))
        svc = pkg.serve.QueryService(
            workers=1, default_deadline_s=60.0,
            ladder=[pkg.serve.Rung("engine", broken),
                    pkg.serve.Rung("culled", pkg.deadline._rung_culled)],
            health=pkg.serve.HealthMonitor(watchdog=False))
        try:
            warmed = svc.warmup(mesh, queries=32)
            resp = svc.query(mesh, pts)
        finally:
            svc.stop(write_stats=False)
        return warmed, resp.rung, resp.retries, resp.certified, \
            _counter(pkg, "mesh_tpu_serve_retries_total", rung="engine",
                     error="RuntimeError")

    assert _same(run)[:3] == (["culled"], "culled", 1)


def test_rungs_run_on_the_meshs_device(small_mesh, monkeypatch):
    """A rung's helper thread computes on ``mesh.device``: the culled and
    anchored searches see tensors on the mesh's device."""
    from mesh_tpu_torch.query import anchored, culled

    v, f, pts = small_mesh
    mesh = mesh_tpu_torch.Mesh(v, f, device="cpu")
    seen = []
    real_culled = culled.closest_faces_and_points_culled
    real_anchored = anchored.closest_point_anchored

    def spy_culled(vt, ft, q, **kw):
        seen.append(("culled", vt.device.type, q.device.type))
        return real_culled(vt, ft, q, **kw)

    def spy_anchored(vt, ft, q, table, safe, **kw):
        seen.append(("anchored", vt.device.type, str(kw["device"])))
        return real_anchored(vt, ft, q, table, safe, **kw)

    monkeypatch.setattr(culled, "closest_faces_and_points_culled",
                        spy_culled)
    monkeypatch.setattr(anchored, "closest_point_anchored", spy_anchored)
    tdeadline._rung_culled(mesh, pts, 512, 60.0)
    tdeadline._rung_anchored(mesh, pts, 512, 60.0)
    assert seen == [("culled", "cpu", "cpu"), ("anchored", "cpu", "cpu")]


# ---------------------------------------------------------------------------
# load generation


def test_percentile_matches_reference():
    rng = np.random.RandomState(3)
    for values in ([], [7.0], [0.0, 1.0], list(range(1, 101)),
                   [1.0] * 9 + [100.0], rng.rand(37).tolist()):
        for q in (0, 25, 50, 95, 99, 100):
            assert tserve.percentile(values, q) == \
                jserve.percentile(values, q)


def test_closed_loop_report_matches_reference():
    def run(pkg):
        svc = _service(pkg, workers=2, default_deadline_s=5.0)
        try:
            report = pkg.serve.run_closed_loop(svc, _MESH, _PTS, clients=3,
                                               requests_per_client=5)
        finally:
            svc.stop(write_stats=False)
        for key in ("paced_s", "wall_s", "goodput_qps", "p50_ms", "p95_ms",
                    "p99_ms"):
            assert report.pop(key) >= 0
        return report

    assert _same(run)["rungs"] == {"ok": 15}


class _Clock(object):
    """A fake clock/sleep pair."""

    def __init__(self):
        self.t = 0.0

    def clock(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


def _stub_service(pkg, clock, plan):
    """A duck-typed service whose futures answer per ``plan(i)``: "ok",
    "late", "shed" (raised at submit) or "deadline"."""
    seen = []

    class _Future(object):
        def __init__(self, kind):
            self.kind = kind

        def result(self, timeout=None):
            clock.t += 0.5                          # a straggler's collect
            if self.kind == "deadline":
                err = pkg.errors.DeadlineExceeded("late")
                err.rung = "engine"
                raise err
            return types.SimpleNamespace(
                latency_s=0.02 if self.kind == "ok" else 0.4, rung="engine",
                retries=0, deadline_missed=self.kind == "late",
                approximate=False)

    class _Service(object):
        def submit(self, mesh, points, tenant=None, priority=0,
                   deadline_s=None):
            kind = plan(len(seen))
            seen.append((round(clock.t, 6), tenant, priority, deadline_s,
                         kind))
            if kind == "shed":
                raise pkg.errors.ServeRejected("full", retry_after=0.1)
            return _Future(kind)

    return _Service(), seen


_PLAN = lambda i: ("ok", "late", "ok", "shed", "deadline")[i % 5]  # noqa


@pytest.mark.parametrize("loop", ["open", "periodic", "replay"])
def test_paced_loop_reports_match_reference(loop):
    def run(pkg):
        clock = _Clock()
        svc, seen = _stub_service(pkg, clock, _PLAN)
        kw = dict(clock=clock.clock, sleep=clock.sleep)
        if loop == "open":
            report = pkg.serve.run_open_loop(svc, _MESH, _PTS, rate_qps=20.0,
                                             duration_s=0.98, **kw)
        elif loop == "periodic":
            report = pkg.serve.run_periodic(svc, _MESH, _PTS, sessions=3,
                                            hz=30.0, frames_per_session=4,
                                            **kw)
        else:
            trace = pkg.obs.replay.synth_stampede(tenants=3, duration_s=0.5)
            report = pkg.serve.run_trace_replay(svc, _MESH, _PTS, trace,
                                                speed=2.0, **kw)
        return report, seen

    report, seen = _same(run)
    assert report["requests"] == len(seen)


def test_trace_replay_against_a_service_matches_null_replay():
    def run(pkg):
        trace = pkg.obs.replay.synth_bucket_ladder(duration_s=0.3)
        svc = _service(pkg, workers=2, default_deadline_s=5.0)
        try:
            report = pkg.serve.run_trace_replay(svc, _MESH, _PTS, trace,
                                                speed=4.0)
        finally:
            svc.stop(write_stats=False)
        null = pkg.obs.null_replay(trace, speed=4.0)
        assert report["checksum"] == null["checksum"]
        return (report["checksum"], report["admissions"], report["ok"],
                _counter(pkg, "mesh_tpu_replay_requests_total"))

    _same(run)
