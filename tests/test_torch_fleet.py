"""mesh_tpu_torch.fleet vs mesh_tpu.fleet on the CPU.

Every scenario of the reference's fleet tests (tests/test_fleet.py, less
the AOT tier, the sharded lane and the CLI, which the port does not have
yet) runs through both packages with the same inputs and must give the
same answers: ring owners and walks, routing keys and digests, replica
placement, spill and kill-switch behaviour over plain-Python replicas,
admission logs and checksums of a replayed trace, and the coordinator's
decisions, actuations and grants under a fake clock.
"""

import types

import numpy as np
import pytest

import mesh_tpu.errors as jerrors
import mesh_tpu.fleet as jfleet
import mesh_tpu.obs as jobs
import mesh_tpu.serve as jserve
from mesh_tpu.obs import replay as jreplay
from mesh_tpu.obs.slo import SLO as JSLO
from mesh_tpu.utils import tuning as jtuning

import mesh_tpu_torch.errors as terrors
import mesh_tpu_torch.fleet as tfleet
import mesh_tpu_torch.obs as tobs
import mesh_tpu_torch.serve as tserve
from mesh_tpu_torch.obs import replay as treplay
from mesh_tpu_torch.obs.slo import SLO as TSLO
from mesh_tpu_torch.utils import tuning as ttuning

PORT = types.SimpleNamespace(fleet=tfleet, serve=tserve, errors=terrors,
                             obs=tobs, replay=treplay, tuning=ttuning,
                             SLO=TSLO, name="port")
REF = types.SimpleNamespace(fleet=jfleet, serve=jserve, errors=jerrors,
                            obs=jobs, replay=jreplay, tuning=jtuning,
                            SLO=JSLO, name="ref")

_PTS = np.zeros((4, 3), np.float32)
_FACES = np.zeros((1, 4), np.uint32)
_ANSWER = np.zeros((4, 3), np.float64)

_ENV = ("MESH_TPU_FLEET", "MESH_TPU_FLEET_SPILL", "MESH_TPU_FLEET_VNODES",
        "MESH_TPU_FLEET_SHARD", "MESH_TPU_FLEET_SHARD_MIN_Q",
        "MESH_TPU_TUNER", "MESH_TPU_SERVE_LADDER",
        "MESH_TPU_COALESCE_WINDOW_MS", "MESH_TPU_TRACE_CONTEXT")


@pytest.fixture(autouse=True)
def fleet_env(monkeypatch, tmp_path):
    """Clean fleet/tuner env, tuned state and registries around a test."""
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MESH_TPU_INCIDENT_DIR", str(tmp_path / "incidents"))
    monkeypatch.setenv("MESH_TPU_SERVE_STATS", str(tmp_path / "stats.json"))
    for pkg in (PORT, REF):
        pkg.obs.reset()
    yield monkeypatch
    for pkg in (PORT, REF):
        pkg.obs.reset()


def both(fn):
    """``fn(pkg)`` on the port and on the reference -> (port's, ref's)."""
    return fn(PORT), fn(REF)


def _same(fn):
    mine, theirs = both(fn)
    assert mine == theirs
    return mine


class FakeClock(object):
    def __init__(self, t=100.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)
        return self.t


class FakeRecorder(object):
    def __init__(self):
        self.events = []

    def record(self, kind, **fields):
        self.events.append((kind, fields))

    def trigger(self, *args, **kwargs):
        return None


class _Digest(object):
    """A mesh stand-in that is nothing but its routing identity."""

    def __init__(self, key):
        self.topology_key = key


def _replica(pkg, name, served=None, **kw):
    """A real QueryService on a plain-Python ladder that tallies which
    digest each replica answered."""

    def _ok(mesh, points, chunk, timeout):
        if served is not None:
            digest = getattr(mesh, "topology_key", str(mesh))
            counts = served.setdefault(name, {})
            counts[digest] = counts.get(digest, 0) + 1
        return pkg.serve.ServeResult(_FACES, _ANSWER, "fleet-ok",
                                     certified=True)

    kw.setdefault("workers", 2)
    kw.setdefault("max_queue_per_tenant", 1024)
    return pkg.serve.QueryService(
        ladder=[pkg.serve.Rung("fleet-ok", _ok)],
        health=pkg.serve.HealthMonitor(watchdog=False),
        default_deadline_s=30.0, **kw)


def _router(pkg, names, served=None, **kw):
    router = pkg.fleet.FleetRouter(recorder=FakeRecorder())
    for name in names:
        router.add_replica(name, _replica(pkg, name, served, **kw))
    return router


def _primary(router, digest):
    return router.plan("closest_point", _Digest(digest), _PTS)[1][0]


# ---------------------------------------------------------------------------
# hash ring


def test_ring_owners_equal_for_1000_keys():
    members = ["r0", "r1", "r2", "r3", "r4"]
    keys = ["closest_point|digest-%04d|%d" % (i, 32 << (i % 6))
            for i in range(1000)]

    def run(pkg):
        ring = pkg.fleet.HashRing(members)
        return ([ring.lookup(k) for k in keys],
                [ring.choices(k) for k in keys[:50]],
                pkg.fleet.DEFAULT_VNODES)

    owners, walks, vnodes = _same(run)
    assert vnodes == 64 and set(owners) == set(members)
    for k, walk in zip(keys, walks):
        assert sorted(walk) == sorted(members)      # full dedup'd walk


def test_ring_removal_remaps_only_victims_keys():
    members = ["r0", "r1", "r2", "r3"]
    keys = ["digest-%04d" % i for i in range(200)]

    def run(pkg):
        ring = pkg.fleet.HashRing(members)
        before = {k: ring.lookup(k) for k in keys}
        ring.remove("r2")
        return before, {k: ring.lookup(k) for k in keys}

    before, after = _same(run)
    for k in keys:
        if before[k] == "r2":
            assert after[k] != "r2"
        else:
            assert after[k] == before[k]
    assert set(after.values()) == {"r0", "r1", "r3"}


def test_ring_add_idempotent_and_remove_unknown():
    def run(pkg):
        ring = pkg.fleet.HashRing(["a", "b"], vnodes=0)
        ring.add("a")
        out = [len(ring), ring.members(), ring.vnodes]
        ring.remove("nope")
        out += ["a" in ring, "nope" in ring]
        ring.remove("a")
        ring.remove("b")
        return out + [ring.lookup("anything"), ring.choices("anything")]

    assert _same(run) == [2, ["a", "b"], 1, True, False, None, []]


# ---------------------------------------------------------------------------
# routing key family


def test_shape_bucket_and_ladder_equal():
    qs = (1, 31, 32, 33, 500, 1024, 16384, 16385, 40000)

    def run(pkg):
        errors = []
        for bad in (0, -3):
            with pytest.raises(ValueError) as err:
                pkg.fleet.shape_bucket(bad)
            errors.append(str(err.value))
        return ([pkg.fleet.shape_bucket(q) for q in qs], errors,
                pkg.fleet.router.ROUTER_Q_LADDER)

    _same(run)


def test_router_ladder_pinned_to_port_engine():
    from mesh_tpu_torch import engine

    assert tuple(tfleet.router.ROUTER_Q_LADDER) == tuple(engine.Q_LADDER)


def test_topology_digest_and_routing_key_equal():
    class _Raw(object):
        f = np.asarray([[0, 1, 2], [2, 1, 3]], np.uint32)

    def run(pkg):
        return [pkg.fleet.topology_digest("9ad31c55-v10-f20"),
                pkg.fleet.topology_digest(_Digest("my-key")),
                pkg.fleet.topology_digest(_Raw()),
                pkg.fleet.routing_key("closest_point", _Digest("dg"),
                                      np.zeros((100, 3))),
                pkg.fleet.routing_key("closest_point", "store-key",
                                      [[0.0, 0.0, 0.0]] * 5000),
                pkg.fleet.routing_key("closest_point", _Raw(),
                                      np.zeros((40000, 3)))]

    out = _same(run)
    assert out[3] == "closest_point|dg|128"
    assert out[2].startswith("crc32:")


def test_topology_digest_of_port_and_reference_meshes():
    """A port Mesh and a reference Mesh of the same faces digest alike."""
    import mesh_tpu
    import mesh_tpu_torch

    from .test_torch_anim import sphere

    v, f = sphere(1)
    port = tfleet.topology_digest(mesh_tpu_torch.Mesh(v, f, device="cpu"))
    assert port == jfleet.topology_digest(mesh_tpu.Mesh(v=v, f=f))


# ---------------------------------------------------------------------------
# router: affinity, determinism, kill switch, spill, ejection


def test_affinity_and_checksum_determinism():
    digests = ["aff-digest-%02d" % i for i in range(8)]

    def run(pkg):
        served = {}
        router = _router(pkg, ["aff-0", "aff-1", "aff-2"], served)
        try:
            primaries = {d: _primary(router, d) for d in digests}
            futures = [router.submit(_Digest(d), _PTS, tenant="t")
                       for _ in range(4) for d in digests]
            for fut in futures:
                fut.result(timeout=60.0)
            status = router.status()
            return (served, primaries, router.admission_checksums(),
                    status["members"],
                    [(r["replica"], r["admitted"], r["eligible"])
                     for r in status["replicas"]])
        finally:
            router.stop(write_stats=False)

    served, primaries, sums, _, rows = _same(run)
    for d in digests:
        owners = [n for n, counts in served.items() if d in counts]
        assert owners == [primaries[d]] and served[primaries[d]][d] == 4
    assert set(sums) == {"aff-0", "aff-1", "aff-2"}
    assert sum(n for _, n, _ in rows) == 32
    # same membership + same submit sequence => same checksums
    assert run(PORT)[2] == sums


def test_kill_switch_is_direct_passthrough(fleet_env):
    def run(pkg):
        served = {}
        router = _router(pkg, ["ks-first", "ks-second"], served)
        try:
            digest = next(d for d in ("ks-d%02d" % i for i in range(64))
                          if _primary(router, d) != "ks-first")
            fleet_env.setenv("MESH_TPU_FLEET", "0")
            try:
                router.submit(_Digest(digest), _PTS).result(timeout=60.0)
            finally:
                fleet_env.delenv("MESH_TPU_FLEET")
            rows = {r["replica"]: r["admitted"]
                    for r in router.status()["replicas"]}
            fleet = pkg.obs.REGISTRY.get("mesh_tpu_fleet_requests_total")
            return digest, served, rows, fleet.total()
        finally:
            router.stop(write_stats=False)

    digest, served, rows, fleet_total = _same(run)
    assert served == {"ks-first": {digest: 1}}
    assert rows == {"ks-first": 0, "ks-second": 0} and fleet_total == 0


def test_spill_one_hop_on_queue_full():
    def run(pkg):
        served = {}
        router = _router(pkg, ["sp-a", "sp-b"], served, workers=1,
                         max_queue_per_tenant=1)
        try:
            mesh = _Digest("spill-digest")
            _key, order = router.plan("closest_point", mesh, _PTS)
            primary = order[0]
            services = router.replicas()
            services[primary].hold()
            try:
                queued = router.submit(mesh, _PTS, tenant="st")
                spilled = router.submit(mesh, _PTS, tenant="st")
            finally:
                services[primary].release()
            queued.result(timeout=60.0)
            spilled.result(timeout=60.0)
            reg = pkg.obs.REGISTRY
            return (order, served,
                    reg.counter("mesh_tpu_fleet_spill_total").value(
                        replica=primary),
                    sorted(reg.get("mesh_tpu_fleet_requests_total")
                           ._labelled(), key=repr),
                    router.admission_checksums())
        finally:
            router.stop(write_stats=False)

    order, served, spills, requests, _ = _same(run)
    primary, sibling = order
    assert served == {primary: {"spill-digest": 1},
                      sibling: {"spill-digest": 1}}
    assert spills == 1
    assert dict((lb["outcome"], n) for lb, n in requests) == {
        "routed": 1, "spilled": 1}


def test_spill_disabled_propagates_queue_full(fleet_env):
    fleet_env.setenv("MESH_TPU_FLEET_SPILL", "0")

    def run(pkg):
        router = _router(pkg, ["nsp-a", "nsp-b"], workers=1,
                         max_queue_per_tenant=1)
        try:
            mesh = _Digest("nospill-digest")
            primary = _primary(router, mesh.topology_key)
            services = router.replicas()
            services[primary].hold()
            try:
                router.submit(mesh, _PTS, tenant="st")
                with pytest.raises(pkg.errors.ServeRejected) as exc:
                    router.submit(mesh, _PTS, tenant="st")
            finally:
                services[primary].release()
            return primary, exc.value.reason, exc.value.retry_after
        finally:
            router.stop(write_stats=False)

    assert _same(run)[1] == "queue_full"


def test_non_queue_full_rejection_never_spills():
    def run(pkg):
        class _Rejecting(object):
            health = None

            def submit(self, *a, **kw):
                raise pkg.errors.ServeRejected("shed", retry_after=1.0,
                                               reason="low_priority")

            def stop(self, drain=True, write_stats=True):
                return None

        served = {}
        router = pkg.fleet.FleetRouter(recorder=FakeRecorder())
        router.add_replica("rej-a", _Rejecting())
        router.add_replica("rej-b", _replica(pkg, "rej-b", served))
        try:
            digest = next(d for d in ("rej-d%02d" % i for i in range(64))
                          if _primary(router, d) == "rej-a")
            with pytest.raises(pkg.errors.ServeRejected) as exc:
                router.submit(_Digest(digest), _PTS)
            return digest, exc.value.reason, served
        finally:
            router.stop(write_stats=False)

    _, reason, served = _same(run)
    assert reason == "low_priority" and served == {}


def test_drain_ejects_without_moving_survivor_keys():
    digests = ["ej-digest-%02d" % i for i in range(30)]

    def run(pkg):
        names = ["ej-0", "ej-1", "ej-2"]
        router = _router(pkg, names)
        try:
            before = {d: _primary(router, d) for d in digests}
            victim = before[digests[0]]
            router.replicas()[victim].health.begin_drain()
            after = {d: _primary(router, d) for d in digests}
            rows = {r["replica"]: (r["in_ring"], r["eligible"])
                    for r in router.status()["replicas"]}
            eligible = pkg.obs.REGISTRY.gauge(
                "mesh_tpu_fleet_ring_eligible").value()
            return victim, before, after, rows, eligible
        finally:
            router.stop(write_stats=False)

    victim, before, after, rows, eligible = _same(run)
    for d in digests:
        if before[d] == victim:
            assert after[d] != victim
        else:
            assert after[d] == before[d]
    assert rows[victim] == (True, False) and eligible == 2


def test_remove_replica_and_empty_fleet():
    def run(pkg):
        served = {}
        router = _router(pkg, ["rm-a", "rm-b"], served)
        service = router.remove_replica("rm-a")
        try:
            service.submit(_Digest("direct"), _PTS).result(timeout=60.0)
            with pytest.raises(ValueError) as dup:
                router.add_replica("rm-b", service)
            members = pkg.obs.REGISTRY.gauge(
                "mesh_tpu_fleet_ring_members").value()
            out = (served, list(router.replicas()), str(dup.value), members,
                   router.remove_replica("nope"))
        finally:
            service.stop(write_stats=False)
            router.stop(write_stats=False)
        empty = pkg.fleet.FleetRouter(recorder=FakeRecorder())
        with pytest.raises(pkg.errors.ServeRejected) as exc:
            empty.submit(_Digest("dg"), _PTS)
        return out + (exc.value.reason, exc.value.retry_after)

    out = _same(run)
    assert out[0] == {"rm-a": {"direct": 1}} and out[1] == ["rm-b"]
    assert out[3] == 1 and out[5] == "draining"


def test_router_paths_are_ledger_clean():
    """A router rejection leaves no ledger rows; a served request closes
    exactly one (opened by the replica)."""
    def run(pkg):
        from_ledger = pkg.obs.get_ledger
        router = pkg.fleet.FleetRouter(recorder=FakeRecorder())
        replica = _replica(pkg, "led-a")
        router.add_replica("led-a", replica)
        try:
            replica.health.begin_drain()
            with pytest.raises(pkg.errors.ServeRejected):
                router.submit(_Digest("led-dg"), _PTS, tenant="led-reject")
            rejected = [r for r in from_ledger().records()
                        if r.get("tenant") == "led-reject"]
            router.remove_replica("led-a")
            router.add_replica("led-b", _replica(pkg, "led-b"))
            for fut in [router.submit(_Digest("led-dg"), _PTS,
                                      tenant="led-serve") for _ in range(4)]:
                fut.result(timeout=60.0)
            closed = [r for r in from_ledger().records()
                      if r.get("tenant") == "led-serve"]
            return (len(rejected), len(closed),
                    sorted({r.get("replica") for r in closed}),
                    sorted({r.get("routing_key") for r in closed}))
        finally:
            replica.stop(write_stats=False)
            router.stop(write_stats=False)

    assert _same(run) == (0, 4, ["led-b"], ["closest_point|led-dg|32"])


# ---------------------------------------------------------------------------
# trace replay through the router


def test_trace_replay_through_router_equal_in_both_packages():
    def run(pkg):
        trace = pkg.replay.synth_stampede(seed=11)
        reports = []
        for _ in range(2):
            t = [0.0]

            def sleep(dt):
                t[0] += max(dt, 0.0)

            router = _router(pkg, ["rp-0", "rp-1", "rp-2"],
                             max_queue_per_tenant=8192)
            try:
                report = pkg.serve.run_trace_replay(
                    router, _Digest("replay-digest"), _PTS, trace,
                    deadline_s=30.0, clock=lambda: t[0], sleep=sleep)
            finally:
                router.stop(write_stats=False)
            reports.append((report["checksum"], report["admissions"],
                            report["replica_checksums"]))
        return reports

    first, second = _same(run)
    assert first == second
    assert set(first[2]) == {"rp-0", "rp-1", "rp-2"}


# ---------------------------------------------------------------------------
# coordinator: sink aggregation


def test_aggregate_sinks_equal():
    sink_a = {"metrics": {
        "mesh_tpu_serve_requests_total": {"type": "counter", "help": "h",
            "series": [
                {"labels": {"tenant": "t", "outcome": "ok"}, "value": 10},
                {"labels": {"tenant": "u", "outcome": "ok"}, "value": 1}]},
        "mesh_tpu_serve_latency_seconds": {
            "type": "histogram", "help": "h", "series": [{
                "labels": {"tenant": "t"}, "count": 4, "sum": 1.0,
                "min": 0.01, "max": 0.9,
                "buckets": [[0.1, 3], ["+Inf", 4]]}]}}}
    sink_b = {"metrics": {
        "mesh_tpu_serve_requests_total": {"type": "counter", "help": "h",
            "series": [
                {"labels": {"outcome": "ok", "tenant": "t"}, "value": 5}]},
        "mesh_tpu_serve_latency_seconds": {
            "type": "histogram", "help": "h", "series": [{
                "labels": {"tenant": "t"}, "count": 6, "sum": 2.0,
                "min": 0.005, "max": 0.5,
                "buckets": [[0.1, 5], ["+Inf", 6]]}]}}}
    agg = _same(lambda pkg: pkg.fleet.aggregate_sinks(
        [sink_a, None, sink_b, {}]))
    by_tenant = {s["labels"]["tenant"]: s["value"] for s in
                 agg["mesh_tpu_serve_requests_total"]["series"]}
    assert by_tenant == {"t": 15, "u": 1}
    row = agg["mesh_tpu_serve_latency_seconds"]["series"][0]
    assert row["buckets"] == [[0.1, 8], ["+Inf", 10]]


def test_read_sink_paths_and_callables(tmp_path):
    path = tmp_path / "sink.json"
    path.write_text('{"health": {"state": "HEALTHY"}}')
    (tmp_path / "garbage.json").write_text("{nope")

    def _boom():
        raise RuntimeError("replica gone")

    _same(lambda pkg: [
        pkg.fleet.read_sink(str(path)),
        pkg.fleet.read_sink(str(tmp_path / "absent.json")),
        pkg.fleet.read_sink(str(tmp_path / "garbage.json")),
        pkg.fleet.read_sink(lambda: {"queues": {}}),
        pkg.fleet.read_sink(_boom)])


def test_read_sink_of_a_port_replica(tmp_path):
    """A port replica's stats sink aggregates like a reference one."""
    served = {}
    sinks = {}
    for pkg in (PORT, REF):
        svc = _replica(pkg, "sink-" + pkg.name, served)
        try:
            svc.submit(_Digest("s-dg"), _PTS, tenant="t").result(timeout=60)
            path = str(tmp_path / ("%s.json" % pkg.name))
            svc.write_stats(path)
        finally:
            svc.stop(write_stats=False)
        agg = pkg.fleet.aggregate_sinks([pkg.fleet.read_sink(path)])
        sinks[pkg.name] = agg["mesh_tpu_serve_requests_total"]["series"]
    assert sinks["port"] == sinks["ref"]


# ---------------------------------------------------------------------------
# coordinator: fake-clock decisions, audit, arbitration


def _sink_state(good, total):
    return {"metrics": {
        "mesh_tpu_serve_requests_total": {
            "type": "counter", "help": "",
            "series": [{"labels": {"tenant": "t"}, "value": total}]},
        "mesh_tpu_serve_good_total": {
            "type": "counter", "help": "",
            "series": [{"labels": {"tenant": "t"}, "value": good}]},
    }}


def _drive_coordinator(pkg):
    """One deterministic shrink->release episode: (step results,
    recorder events, decision counts, sinks gauge, status, knob history
    reasons)."""
    clock = FakeClock(100.0)
    state = {"good": 0, "total": 0}
    registry = pkg.obs.Registry()
    recorder = FakeRecorder()
    coord = pkg.fleet.FleetCoordinator(
        {"replica-a": lambda: _sink_state(state["good"], state["total"]),
         "replica-b": lambda: _sink_state(0, 0)},
        objectives=[pkg.SLO("availability", "availability", 0.999)],
        clock=clock, recorder=recorder, registry=registry)
    steps = [coord.step()]
    clock.advance(60.0)
    state.update(good=50, total=100)
    steps.append(coord.step())
    clock.advance(10.0)
    steps.append(coord.step())
    clock.advance(3640.0)
    state.update(good=1050, total=1100)
    steps.append(coord.step())
    decisions = registry.counter(
        "mesh_tpu_fleet_coordinator_decisions_total")
    reasons = [e["reason"] for e in pkg.tuning.history_tail()
               if e.get("knob") == "serve_pre_trip"]
    return ([(s["decision"], round(s["pressure"], 9), s["sinks"],
              [(a["knob"], a["before"], a["after"]) for a in s["actions"]],
              s["t"])
             for s in steps],
            recorder.events,
            {d: decisions.value(decision=d)
             for d in ("hold", "shrink", "release")},
            registry.gauge("mesh_tpu_fleet_sinks_readable").value(),
            coord.status(), reasons, pkg.tuning.get("serve_pre_trip"))


def test_coordinator_decisions_equal(fleet_env):
    fleet_env.setenv("MESH_TPU_TUNER", "1")

    def run(pkg):
        pkg.tuning.reset()
        try:
            return _drive_coordinator(pkg)
        finally:
            pkg.tuning.reset()

    steps, events, counts, sinks, status, reasons, pre_trip = _same(run)
    assert [s[0] for s in steps] == ["hold", "shrink", "shrink", "release"]
    assert counts == {"hold": 1, "shrink": 2, "release": 1} and sinks == 2
    assert any("fleet" in r for r in reasons) and pre_trip == 0
    assert [k for k, _ in events].count("fleet_decision") == 4
    assert status["pre_tripped"] is False


def test_coordinator_disabled_without_tuner(fleet_env):
    fleet_env.setenv("MESH_TPU_TUNER", "0")
    _same(lambda pkg: pkg.fleet.FleetCoordinator(
        {}, clock=FakeClock(), recorder=FakeRecorder(),
        registry=pkg.obs.Registry()).step())


def test_grant_widen_cooldown_and_pressure(fleet_env):
    fleet_env.setenv("MESH_TPU_TUNER", "1")

    def cooldown(pkg):
        clock = FakeClock(0.0)
        recorder = FakeRecorder()
        registry = pkg.obs.Registry()
        coord = pkg.fleet.FleetCoordinator(
            {}, clock=clock, recorder=recorder, registry=registry,
            widen_cooldown_s=30.0)
        verdicts = [coord.grant_widen(replica="r0")]
        clock.advance(10.0)
        verdicts.append(coord.grant_widen(replica="r1"))
        clock.advance(25.0)
        verdicts.append(coord.grant_widen(replica="r1"))
        grants = registry.counter("mesh_tpu_fleet_widen_grants_total")
        return (verdicts, recorder.events,
                grants.value(outcome="granted"),
                grants.value(outcome="denied"))

    verdicts, events, granted, denied = _same(cooldown)
    assert verdicts == [True, False, True] and (granted, denied) == (2, 1)
    assert [f["reason"] for _, f in events] == ["granted", "cooldown",
                                                "granted"]

    def pressure(pkg):
        pkg.tuning.reset()
        clock = FakeClock(100.0)
        state = {"good": 0, "total": 0}
        recorder = FakeRecorder()
        coord = pkg.fleet.FleetCoordinator(
            {"replica-a": lambda: _sink_state(state["good"],
                                              state["total"])},
            objectives=[pkg.SLO("availability", "availability", 0.999)],
            clock=clock, recorder=recorder, registry=pkg.obs.Registry())
        coord.step()
        clock.advance(60.0)
        state.update(good=50, total=100)
        decision = coord.step()["decision"]
        clock.advance(100.0)
        try:
            return (decision, coord.grant_widen(replica="r0"),
                    [f["reason"] for k, f in recorder.events
                     if k == "fleet_widen"])
        finally:
            pkg.tuning.reset()

    assert _same(pressure) == ("shrink", False, ["fleet_pressure"])
