"""The staged bench harness and ``perfcheck`` of mesh_tpu_torch.obs.perf
against mesh_tpu.obs.perf on the CPU.

``run_stages`` runs the same scripted pipelines under a fake popen and a
fake clock in both packages: equal statuses, elapsed times, records,
errors, partial files (less their wall-clock stamp), incident triggers,
recorder events and stage counters.  ``perfcheck`` grades the same
synthetic docs to the same rc and lines in both, band for band.  One
end-to-end run drives real children of the port through a hang under
the harness's knobs, and ``reap_child`` is proven on a real
SIGTERM-ignoring child.
"""

import json
import os
import subprocess
import sys
import time
import types

import pytest

import mesh_tpu.obs as jobs
from mesh_tpu.obs import perf as jperf

import mesh_tpu_torch.obs as tobs
from mesh_tpu_torch.obs import perf as tperf

PORT = types.SimpleNamespace(perf=tperf, obs=tobs, name="port")
REF = types.SimpleNamespace(perf=jperf, obs=jobs, name="ref")

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    for var in ("MESH_TPU_BENCH_FAULT", "MESH_TPU_BENCH_PARTIAL"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MESH_TPU_INCIDENT_DIR", str(tmp_path / "incidents"))
    for pkg in (PORT, REF):
        pkg.obs.reset()
    yield
    for pkg in (PORT, REF):
        pkg.obs.reset()


def both(fn):
    return fn(PORT), fn(REF)


def _same(fn):
    mine, theirs = both(fn)
    assert mine == theirs
    return mine


class _FakeRecorder(object):
    def __init__(self):
        self.records = []
        self.triggers = []

    def record(self, kind, **fields):
        self.records.append((kind, fields))

    def trigger(self, reason, context=None, health=None, force=False):
        self.triggers.append({"reason": reason, "context": context,
                              "force": force})
        return "/fake/incident.json"


class _FakeClock(object):
    """Advances 0.25 s a read, so elapsed times are exact and equal."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.25
        return self.t


class _FakeProc(object):
    """``ok`` prints a JSON record, ``hang`` times out and dies to the first
    SIGTERM, ``crash`` exits 41, ``silent`` exits 0 without a record."""

    def __init__(self, mode, record=None):
        self.mode = mode
        self.record = record or {}
        self.returncode = None

    def communicate(self, timeout=None):
        if self.mode == "hang":
            raise subprocess.TimeoutExpired(cmd="stage", timeout=timeout)
        if self.mode == "crash":
            self.returncode = 41
            return ("", "boom\n")
        self.returncode = 0
        if self.mode == "silent":
            return ("no json here\n", "")
        return ("log line\n" + json.dumps(self.record) + "\n", "")

    def poll(self):
        return self.returncode

    def terminate(self):
        self.returncode = -15

    def kill(self):
        self.returncode = -9


_PIPELINE = (
    ("probe", 3.0, False, True),
    ("warmup", 3.0, True, False),
    ("closest_point", 3.0, True, False),
    ("pallas_proxy", 3.0, False, False),
)


def _ok_proc(name):
    rec = {"metric": name, "value": 1.0}
    if name == "probe":
        rec["backend_ok"] = True
    return lambda: _FakeProc("ok", rec)


def _run_pipeline(pkg, tmp_path, faults):
    script = {name: _ok_proc(name) for name, _, _, _ in _PIPELINE}
    script.update(faults)
    specs = [pkg.perf.StageSpec(name, ["py", "stage", name], timeout_s,
                                requires_backend=rb, gate=gate)
             for name, timeout_s, rb, gate in _PIPELINE]
    rec = _FakeRecorder()
    os.makedirs(str(tmp_path / pkg.name), exist_ok=True)
    partial = str(tmp_path / pkg.name / "bench_partial.json")
    results = pkg.perf.run_stages(
        specs, partial, clock=_FakeClock(), sleep=lambda dt: None,
        popen=lambda argv, **kw: script[argv[-1]](), recorder=rec)
    with open(partial) as fh:
        state = json.load(fh)
    state.pop("started_utc")
    for trig in rec.triggers:
        trig["context"]["partial_path"] = os.path.relpath(
            trig["context"]["partial_path"], str(tmp_path / pkg.name))
    reg = pkg.obs.REGISTRY
    counters = {status: sorted(reg.get(
        "mesh_tpu_bench_stage_%s_total" % status)._labelled(), key=repr)
        for status in ("ok", "hung", "crashed", "skipped")}
    hist = reg.get("mesh_tpu_bench_stage_seconds").snapshot()
    return ({n: r.to_json() for n, r in results.items()},
            {n: (r.ok, r.status) for n, r in results.items()},
            state, rec.triggers, rec.records, counters, hist)


@pytest.mark.parametrize("faults", [
    {}, {"probe": "hang"}, {"warmup": "hang"}, {"closest_point": "hang"},
    {"closest_point": "crash"}, {"warmup": "silent"},
    {"pallas_proxy": "crash", "warmup": "hang"}])
def test_run_stages_equal(tmp_path, faults):
    procs = {name: (lambda mode=mode: _FakeProc(mode))
             for name, mode in faults.items()}
    out = _same(lambda pkg: _run_pipeline(pkg, tmp_path, procs))
    _, statuses, state, triggers, _, _, _ = out
    assert state["kind"] == "bench_partial"
    failed = [n for n, (_, s) in statuses.items() if s in ("hung",
                                                            "crashed")]
    assert len(triggers) == (1 if failed else 0)
    if failed:
        assert triggers[0]["reason"] == "bench_stage_hang"
        assert triggers[0]["context"]["stage"] == failed[0]


def test_probe_reporting_unhealthy_gates_backend_stages(tmp_path):
    unhealthy = {"probe": lambda: _FakeProc(
        "ok", {"metric": "probe", "backend_ok": False})}
    out = _same(lambda pkg: _run_pipeline(pkg, tmp_path, unhealthy))
    assert [s for _, s in out[1].values()] == ["ok", "skipped", "skipped",
                                               "ok"]
    assert out[3] == []


def test_write_partial_and_read_bench_json(tmp_path):
    state = {"kind": "bench_partial", "stages": {"a": {"status": "ok"}},
             "when": object()}

    def run(pkg):
        path = str(tmp_path / ("%s.json" % pkg.name))
        pkg.perf.write_partial(path, state)
        partial = pkg.perf.read_bench_json(path)
        final = tmp_path / ("%s-final.txt" % pkg.name)
        final.write_text("noise\n{\"metric\": \"m\", \"value\": 2.0}\n")
        missing = pkg.perf.write_partial(
            str(tmp_path / "no" / "dir.json"), state)
        return (partial["stages"], pkg.perf.read_bench_json(str(final)),
                missing, os.path.exists(path + ".tmp"))

    assert _same(run)[1] == {"metric": "m", "value": 2.0}


def test_reap_child_escalates_past_sigterm_ignorer():
    proc = subprocess.Popen(
        [sys.executable, "-u", "-c",
         "import signal, time\n"
         "signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
         "print('armed', flush=True)\n"
         "time.sleep(600)\n"],
        stdout=subprocess.PIPE, text=True)
    try:
        assert proc.stdout.readline().strip() == "armed"
        t0 = time.monotonic()
        how = tperf.reap_child(proc, term_grace_s=0.5, kill_grace_s=10.0)
        assert how == "killed" and time.monotonic() - t0 < 10.0
        assert proc.poll() is not None
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.stdout.close()


def test_knob_helpers(monkeypatch):
    monkeypatch.setenv("MESH_TPU_BENCH_TIMEOUT_SERVE", "7.5")
    monkeypatch.setenv("MESH_TPU_BENCH_TIMEOUT_PROBE", "soon")
    assert tperf.stage_timeout("serve", 60.0) == 7.5
    assert tperf.stage_timeout("probe", 60.0) == 60.0
    assert tperf.stage_timeout("other", 60.0) == 60.0
    assert tperf.partial_path("/d/bench_partial.json") == \
        "/d/bench_partial.json"
    monkeypatch.setenv("MESH_TPU_BENCH_PARTIAL", "/x/p.json")
    assert tperf.partial_path("/d/bench_partial.json") == "/x/p.json"
    tperf.inject_fault("serve")                  # no fault: returns
    monkeypatch.setenv("MESH_TPU_BENCH_FAULT", "serve:crash")
    tperf.inject_fault("probe")                  # another stage's fault
    with pytest.raises(SystemExit) as exc:
        tperf.inject_fault("serve")
    assert exc.value.code == 41
    monkeypatch.setenv("MESH_TPU_BENCH_FAULT", "serve:error")
    with pytest.raises(RuntimeError, match="fault injection"):
        tperf.inject_fault("serve")
    monkeypatch.setenv("MESH_TPU_BENCH_FAULT", "serve:hang")

    class Woken(Exception):
        pass

    def sleep(dt):
        raise Woken()

    with pytest.raises(Woken):
        tperf.inject_fault("serve", sleep=sleep)


_CHILD = (
    "import json, sys\n"
    "from mesh_tpu_torch.obs import perf\n"
    "perf.inject_fault(sys.argv[1])\n"
    "print(json.dumps({'metric': sys.argv[1], 'value': 1.0,"
    " 'backend_ok': True}))\n")


def test_staged_run_with_hung_stage_end_to_end(tmp_path, monkeypatch):
    """Real children of the port: the gate answers, a fault-injected stage
    hangs past the budget its knob sets and is reaped, a later backend
    stage is skipped, a backend-free stage still runs; the partial file,
    the one incident and the counters say so."""
    monkeypatch.setenv("MESH_TPU_BENCH_FAULT", "wedged:hang")
    monkeypatch.setenv("MESH_TPU_BENCH_TIMEOUT_WEDGED", "2")
    env = {"PYTHONPATH": _REPO, "JAX_PLATFORMS": "cpu"}
    specs = [tperf.StageSpec(
        name, [sys.executable, "-c", _CHILD, name],
        tperf.stage_timeout(name, 60.0), requires_backend=rb, gate=gate,
        env=env)
        for name, rb, gate in (("probe", False, True),
                               ("wedged", True, False),
                               ("after", True, False),
                               ("free", False, False))]
    partial = tperf.partial_path(str(tmp_path / "bench_partial.json"))
    t0 = time.monotonic()
    results = tperf.run_stages(specs, partial)
    assert time.monotonic() - t0 < 60.0
    assert [r.status for r in results.values()] == [
        "ok", "hung", "skipped", "ok"]
    assert "budget" in results["wedged"].error
    state = tperf.read_bench_json(partial)
    assert state["stages"]["free"]["record"]["metric"] == "free"
    assert state["stages"]["wedged"]["timeout_s"] == 2.0
    dumps = [f for f in os.listdir(str(tmp_path / "incidents"))
             if "bench_stage_hang" in f]
    assert len(dumps) == 1
    assert tobs.REGISTRY.get("mesh_tpu_bench_stage_hung_total").value(
        stage="wedged") == 1


# ---------------------------------------------------------------------------
# perfcheck


_PROXY_GOLDEN = {"metric": "pallas_proxy_pair_tests", "value": 1000.0,
                 "unit": "pair_tests/sec", "hlo_cost": {"flops": 1000.0}}


def _proxy_doc(value, flops=1000.0, stale=False, headline=None):
    doc = {"metric": "batch256_smpl_normals_plus_closest_point",
           "value": headline, "unit": "queries/sec", "vs_baseline": None,
           "proxy": {"metric": "pallas_proxy_pair_tests", "value": value,
                     "unit": "pair_tests/sec",
                     "hlo_cost": {"flops": flops}}}
    if stale:
        doc.update(stale=True, stale_age_hours=12.0)
    return doc


_GOLDENS = {
    "accel": {"value": 0.8, "checksum": 12.5},
    "stream": {"value": 0.7, "checksum": 3.25},
    "mxu": {"value": 2.0, "checksum": 587.1954, "repair_rate": 0.2344},
    "store": {"value": 4.0, "checksum": 9.0},
    "tuner": {"value": 40, "checksum": 123.5},
    "replay": {"value": 120, "checksum": 31337.0},
    "fleet": {"value": 1.0, "warm_hit_rate": 0.875, "spills": 1,
              "checksum": 123456.0, "aot": {"warm_hits": 2, "speedup": 3.0}},
    "anim": {"value": 3.0, "checksum": 77.0},
    "trace": {"value": 24, "tail_retained": 4, "checksum": 4242.0},
}


def _band_cases():
    cases = []
    for slot, gold in _GOLDENS.items():
        cases.append((slot, dict(gold)))                 # in band
        cases.append((slot, None))                       # missing record
        low = dict(gold, value=gold["value"] * 0.3)
        cases.append((slot, low))                        # below the floor
        high = dict(gold, value=gold["value"] * 3)
        cases.append((slot, high))
        drift = dict(gold, checksum=gold["checksum"] + 1.0)
        cases.append((slot, drift))                      # checksum drift
        no_sum = {k: v for k, v in gold.items() if k != "checksum"}
        cases.append((slot, no_sum))
    cases.append(("mxu", dict(_GOLDENS["mxu"], repair_rate=0.5)))
    cases.append(("fleet", dict(_GOLDENS["fleet"], spills=2)))
    cases.append(("fleet", dict(_GOLDENS["fleet"], warm_hit_rate=0.5)))
    cases.append(("fleet", dict(_GOLDENS["fleet"],
                                aot={"warm_hits": 0, "speedup": 0.5})))
    cases.append(("trace", dict(_GOLDENS["trace"], tail_retained=3)))
    return cases


@pytest.mark.parametrize("slot,cand", _band_cases())
def test_perfcheck_bands_equal(slot, cand):
    doc = {"metric": "m", "value": None}
    if cand is not None:
        doc[slot] = dict(cand, metric=slot)
    kwargs = {"%s_golden" % slot: {slot: dict(_GOLDENS[slot], metric=slot)}}
    rc, lines = _same(lambda pkg: pkg.perf.perfcheck(doc, **kwargs))
    if cand is None:
        assert rc == 1
    # a record with no golden: informational note, rc 0
    if cand is not None:
        assert _same(lambda pkg: pkg.perf.perfcheck(doc))[0] == 0


@pytest.mark.parametrize("case", [
    "ok", "regressed", "missing", "flops_up", "flops_down", "stale",
    "fresh_headline", "partial", "partial_hung"])
def test_perfcheck_proxy_and_headline_equal(case):
    baseline = None
    golden = _PROXY_GOLDEN
    if case == "ok":
        doc = _proxy_doc(900.0)
    elif case == "regressed":
        doc = _proxy_doc(400.0)
    elif case == "missing":
        doc = {"metric": "m", "value": None}
    elif case == "flops_up":
        doc = _proxy_doc(1000.0, flops=1500.0)
    elif case == "flops_down":
        doc = _proxy_doc(1000.0, flops=500.0)
    elif case == "stale":
        doc, baseline = _proxy_doc(1000.0, stale=True, headline=50.0), {
            "value": 10000.0}
    elif case == "fresh_headline":
        doc, baseline = _proxy_doc(1000.0, headline=50.0), {"value": 10000.0}
    else:
        doc = {"kind": "bench_partial", "schema_version": 1, "stages": {
            "probe": {"status": "hung"},
            "pallas_proxy": {"status": "ok" if case == "partial" else "hung",
                             "record": dict(_PROXY_GOLDEN)}}}
    rc, lines = _same(lambda pkg: pkg.perf.perfcheck(
        doc, baseline=baseline, proxy_golden=golden))
    assert rc == (0 if case in ("ok", "flops_down", "stale", "partial")
                  else 1)


def test_perfcheck_stage_attribution_equal():
    def block(dispatch):
        return {"queue": {"count": 24, "p50_s": 0.001, "p99_s": 0.002,
                          "mean_s": 0.001},
                "dispatch": {"count": 24, "p50_s": dispatch,
                             "p99_s": 2 * dispatch, "mean_s": dispatch}}

    base = {"metric": "m", "value": 100.0, "stage_stats": block(0.002),
            "stage_total": {"count": 24, "p50_s": 0.003, "p99_s": 0.004}}
    cand = {"records": [{"metric": "serve", "stage_stats": block(0.05),
                         "stage_total": {"count": 24, "p50_s": 0.051,
                                         "p99_s": 0.102}}]}
    rc, lines = _same(lambda pkg: pkg.perf.perfcheck(cand, baseline=base))
    assert "stage attribution vs last-good (prof diff):" in lines
    assert any("stage 'dispatch'" in ln for ln in lines)
    _same(lambda pkg: pkg.perf.perfcheck(cand))
    _same(lambda pkg: pkg.perf.extract_records(cand))
