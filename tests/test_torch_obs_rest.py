"""The rest of mesh_tpu_torch.obs vs mesh_tpu.obs on the CPU: the ledger's
close listeners, tail, JSON-lines dump, thread-bound current record and
trace capture (``MESH_TPU_REPLAY_TRACE``); the flight recorder's incident
files; ``traced`` and the JSON-lines span sink; the trace tail's
``lookup`` and slow-ok reservoir; histogram exemplars.

Scenarios run through both packages with the same inputs and fake clocks,
and their outputs (rows, dumps, trace files, checksums, retained sets,
snapshots) must be equal.
"""

import json
import os
import threading
import types

import pytest

import mesh_tpu.obs as jobs
from mesh_tpu.obs import context as jcontext
from mesh_tpu.obs import ledger as jledger
from mesh_tpu.obs import metrics as jmetrics
from mesh_tpu.obs import recorder as jrecorder
from mesh_tpu.obs import replay as jreplay
from mesh_tpu.obs import trace as jtrace

import mesh_tpu_torch.obs as tobs
from mesh_tpu_torch.obs import context as tcontext
from mesh_tpu_torch.obs import ledger as tledger
from mesh_tpu_torch.obs import metrics as tmetrics
from mesh_tpu_torch.obs import recorder as trecorder
from mesh_tpu_torch.obs import replay as treplay
from mesh_tpu_torch.obs import trace as ttrace

PORT = types.SimpleNamespace(
    obs=tobs, context=tcontext, ledger=tledger, metrics=tmetrics,
    recorder=trecorder, replay=treplay, trace=ttrace, name="port")
REF = types.SimpleNamespace(
    obs=jobs, context=jcontext, ledger=jledger, metrics=jmetrics,
    recorder=jrecorder, replay=jreplay, trace=jtrace, name="ref")

_ENV = ("MESH_TPU_OBS", "MESH_TPU_OBS_JSONL", "MESH_TPU_OBS_JSONL_MAX_MB",
        "MESH_TPU_OBS_JSONL_KEEP", "MESH_TPU_RECORDER",
        "MESH_TPU_INCIDENT_KEEP", "MESH_TPU_LEDGER", "MESH_TPU_LEDGER_TAIL",
        "MESH_TPU_REPLAY_TRACE", "MESH_TPU_TRACE_RESERVOIR",
        "MESH_TPU_TRACE_TAIL", "MESH_TPU_TRACE_CONTEXT")


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("MESH_TPU_INCIDENT_DIR", str(tmp_path / "incidents"))
    tobs.reset()
    jobs.reset()
    yield
    treplay.reset_capture()
    jreplay.reset_capture()
    tobs.reset()
    jobs.reset()


def both(fn):
    return fn(PORT), fn(REF)


def _same(fn):
    mine, theirs = both(fn)
    assert mine == theirs
    return mine


class _Clock(object):
    def __init__(self, t=100.0, step=0.25):
        self.t, self.step = t, step

    def __call__(self):
        self.t += self.step
        return self.t


def _close_rows(pkg, led, n=4):
    """``n`` records through ``led`` with seeded provenance and stamps."""
    rows = []
    for i in range(n):
        rec = led.open(tenant="t%d" % (i % 2), op="closest_point",
                       bucket=64 << i, q=50 + i, deadline_s=0.5,
                       priority=i % 3 - 1, request_id="rid-%d" % i)
        rec.stamp("queue")
        rec.stamp("coalesce")
        rec.stamp("device")
        rec.set(backend="pallas" if i % 2 else "xla")
        rows.append(led.close(rec, outcome="ok" if i != 2 else "deadline",
                              rung="engine"))
    return rows


# ---------------------------------------------------------------------------
# metrics: exemplars, total, names


@pytest.mark.parametrize("values", [
    [0.001, 0.002, 0.5, 0.4],
    [3.0, 100.0, 0.0001, 100.0, 7.5],
    [0.01] * 6,
])
def test_exemplars_match_reference(values):
    def run(pkg):
        reg = pkg.metrics.Registry()
        hist = reg.histogram("h", "x")
        for i, v in enumerate(values):
            hist.observe(v, exemplar="req-%d" % i, tenant="a")
            hist.observe(v, tenant="b")
        counter = reg.counter("c", "y")
        counter.inc(2, tenant="a")
        counter.inc(3, tenant="b")
        return reg.snapshot(), counter.total(), reg.names()

    snap, total, names = _same(run)
    assert total == 5 and names == ["h", "c"]
    assert "exemplars" in snap["h"]["series"][0]
    assert "exemplars" not in snap["h"]["series"][1]


# ---------------------------------------------------------------------------
# context: lookup and the slow-ok reservoir


@pytest.mark.parametrize("slots", ["0", "2", "8"])
def test_trace_tail_reservoir_matches_reference(slots, monkeypatch):
    monkeypatch.setenv("MESH_TPU_TRACE_RESERVOIR", slots)
    rows = [{"request_id": "r%d" % i,
             "outcome": "ok" if i % 4 else "deadline",
             "total_s": [0.5, 0.1, 0.9, 0.3, 0.2, 0.7, 0.05, 0.95,
                         0.4][i]} for i in range(9)]

    def run(pkg):
        tail = pkg.context.TraceTail()
        tail.record_span({"name": "s", "attrs": {"request_id": "r1"}})
        for row in rows:
            tail.observe_close(dict(row))
        kept = [(e["request_id"], e["retained"], len(e["spans"]))
                for e in tail.retained()]
        return kept, tail.lookup("r1"), tail.lookup("nope")

    kept, _, missing = _same(run)
    assert missing is None
    assert sum(1 for _, why, _ in kept if why == "reservoir") == min(
        int(slots), 6)
    assert tcontext.get_trace_tail() is tcontext.TRACE_TAIL


# ---------------------------------------------------------------------------
# trace: traced, jsonl_sink with rotation, configure / remove_sink


def test_traced_decorator_matches_reference(monkeypatch):
    def run(pkg):
        @pkg.trace.traced
        def bare(x):
            return x + 1

        @pkg.trace.traced("custom.name", k="v")
        def named(x):
            return x * 2

        pkg.trace.TRACER.clear()
        off = (bare(1), named(2), len(pkg.trace.TRACER.events()))
        monkeypatch.setenv("MESH_TPU_OBS", "1")
        try:
            on = (bare(1), named(2))
        finally:
            monkeypatch.delenv("MESH_TPU_OBS")
        events = [(e["name"], e["attrs"]) for e in pkg.trace.TRACER.events()]
        return off, on, events

    off, on, events = _same(run)
    assert off == (2, 4, 0) and on == (2, 4)
    assert events[1] == ("custom.name", {"k": "v"})


def test_jsonl_sink_rotates_like_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("MESH_TPU_OBS", "1")

    def run(pkg):
        path = str(tmp_path / ("%s.jsonl" % pkg.name))
        sink = pkg.trace.jsonl_sink(path, max_mb=600 / (1024 * 1024.0),
                                    keep=2)
        handle = pkg.trace.TRACER.add_sink(sink)
        try:
            for i in range(12):
                with pkg.trace.span("serve.attempt", i=i):
                    pass
        finally:
            pkg.trace.TRACER.remove_sink(handle)
        with pkg.trace.span("after.remove"):
            pass
        files = sorted(os.listdir(str(tmp_path)))
        names = []
        for name in files:
            if name.startswith(pkg.name):
                with open(str(tmp_path / name)) as fh:
                    names.append((name[len(pkg.name):],
                                  [json.loads(ln)["attrs"]["i"]
                                   for ln in fh]))
        return names

    names = _same(run)
    assert [n for n, _ in names] == [".jsonl", ".jsonl.1", ".jsonl.2"]
    assert names[0][1][-1] == 11


def test_configure_and_env_sink_match_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("MESH_TPU_OBS", "1")

    def run(pkg):
        path = str(tmp_path / ("%s-conf.jsonl" % pkg.name))
        assert pkg.trace.configure() is None
        handle = pkg.trace.configure(jsonl=path)
        with pkg.trace.span("configured"):
            pass
        pkg.trace.TRACER.remove_sink(handle)
        env_path = str(tmp_path / ("%s-env.jsonl" % pkg.name))
        monkeypatch.setenv("MESH_TPU_OBS_JSONL", env_path)
        tracer = pkg.trace.Tracer()              # installs on first span
        with tracer.span("from.env"):
            pass
        monkeypatch.delenv("MESH_TPU_OBS_JSONL")
        out = []
        for p in (path, env_path):
            with open(p) as fh:
                out.append([json.loads(ln)["name"] for ln in fh])
        return out

    assert _same(run) == [["configured"], ["from.env"]]


# ---------------------------------------------------------------------------
# ledger: listeners, tail, dump, bind_current, capture


def test_ledger_listeners_and_tail_match_reference(monkeypatch):
    monkeypatch.setenv("MESH_TPU_LEDGER_TAIL", "3")

    def run(pkg):
        led = pkg.ledger.LatencyLedger(capacity=16, clock=_Clock(),
                                       registry=pkg.metrics.Registry())
        seen = []
        led.add_listener(seen.append)

        def broken(row):
            raise RuntimeError("observer fault")

        led.add_listener(broken)
        rows = _close_rows(pkg, led, n=5)
        led.remove_listener(broken)
        led.remove_listener(seen.append)
        _close_rows(pkg, led, n=1)
        errors = led._registry.get(
            "mesh_tpu_ledger_observer_errors_total").value(where="listener")
        return (rows, len(seen), errors, led.tail(), led.tail(2),
                pkg.ledger.tail_length(), len(led))

    rows, seen, errors, tail, tail2, n_tail, n = _same(run)
    assert (seen, errors, n_tail, n, len(tail), len(tail2)) == \
        (5, 5, 3, 6, 3, 2)


def test_dump_jsonl_matches_reference(tmp_path):
    def run(pkg):
        led = pkg.ledger.LatencyLedger(capacity=16, clock=_Clock(),
                                       registry=pkg.metrics.Registry())
        _close_rows(pkg, led, n=4)
        path = str(tmp_path / ("%s.jsonl" % pkg.name))
        n_all = led.dump_jsonl(path)
        with open(path) as fh:
            text = fh.read()
        n_two = led.dump_jsonl(path, n=2)
        return n_all, text, n_two

    n_all, text, n_two = _same(run)
    assert (n_all, n_two) == (4, 2)
    assert all(json.loads(ln)["schema"] == tledger.LEDGER_SCHEMA
               for ln in text.splitlines())


def test_bind_current_is_thread_local():
    led = tledger.LatencyLedger(capacity=16)
    outer, inner = led.open(tenant="a"), led.open(tenant="b")
    assert tledger.current_record() is None
    seen = []
    with tledger.bind_current(outer):
        with tledger.bind_current(inner):
            assert tledger.current_record() is inner
            t = threading.Thread(
                target=lambda: seen.append(tledger.current_record()))
            t.start()
            t.join()
        assert tledger.current_record() is outer
    assert tledger.current_record() is None and seen == [None]
    assert tobs.bind_current is tledger.bind_current


def test_capture_replays_to_the_same_checksum_in_both(tmp_path, monkeypatch):
    """MESH_TPU_REPLAY_TRACE streams every close into a trace file; the
    two packages write the same file for the same rows, and the captured
    trace replays to the same checksum through either package."""
    def run(pkg):
        path = str(tmp_path / ("%s-trace.jsonl" % pkg.name))
        monkeypatch.setenv("MESH_TPU_REPLAY_TRACE", path)
        led = pkg.ledger.LatencyLedger(capacity=16, clock=_Clock(),
                                       registry=pkg.metrics.Registry())
        try:
            _close_rows(pkg, led, n=5)
        finally:
            monkeypatch.delenv("MESH_TPU_REPLAY_TRACE")
            pkg.replay.reset_capture()
        with open(path) as fh:
            text = fh.read()
        return text, pkg.replay.load_trace(path)

    (text, trace), (jtext, jtrace_) = both(run)
    assert text == jtext
    assert trace == jtrace_ and len(trace["records"]) == 5
    sums = {treplay.null_replay(trace)["checksum"],
            jreplay.null_replay(trace)["checksum"],
            treplay.null_replay(jtrace_)["checksum"],
            treplay.sequence_checksum(treplay.admission_events(trace))}
    assert len(sums) == 1


# ---------------------------------------------------------------------------
# recorder: incident files, rate limit, samples, span sink


def test_incident_files_match_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("MESH_TPU_INCIDENT_KEEP", "3")

    class _Health(object):
        def snapshot(self):
            return {"state": "degraded", "trips": 2}

    def run(pkg):
        directory = str(tmp_path / pkg.name)
        monkeypatch.setenv("MESH_TPU_INCIDENT_DIR", directory)
        reg = pkg.metrics.Registry()
        rec = pkg.recorder.FlightRecorder(capacity=32, registry=reg,
                                          clock=_Clock(),
                                          min_dump_interval_s=30.0)
        rec.record("serve.admit", tenant="a", depth=1)
        rec.attach_health(_Health())
        first = rec.trigger("watchdog_trip", context={"reason": "x"})
        with open(first) as fh:
            doc = json.load(fh)
        limited = rec.trigger("watchdog_trip")
        forced = [rec.trigger("manual/%d" % i, force=True)
                  for i in range(4)]
        kept = [os.path.basename(p)[27:]
                for p in pkg.recorder.list_incidents(directory)]
        dumps = reg.get("mesh_tpu_incident_dumps_total").total()
        return (sorted(doc), doc["schema_version"], doc["reason"],
                doc["context"], doc["health"], [e["kind"] for e in
                                                doc["ring"]],
                limited, len([p for p in forced if p]), kept, dumps,
                pkg.recorder.default_incident_dir() == directory)

    out = _same(run)
    assert out[6] is None and out[7] == 4 and len(out[8]) == 3
    monkeypatch.delenv("MESH_TPU_INCIDENT_DIR")
    assert trecorder.default_incident_dir().endswith(
        os.path.join(".mesh_tpu_torch", "incidents"))


def test_recorder_off_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("MESH_TPU_RECORDER", "0")
    rec = trecorder.FlightRecorder(capacity=16)
    rec.record("x")
    assert rec.events() == [] and rec.trigger("y", force=True) is None
    assert trecorder.list_incidents(str(tmp_path / "incidents")) == []


def test_sample_and_span_sink_match_reference(monkeypatch):
    def run(pkg):
        reg = pkg.metrics.Registry()
        rec = pkg.recorder.FlightRecorder(capacity=32, registry=reg,
                                          clock=_Clock())
        reqs = reg.counter("mesh_tpu_serve_requests_total", "r")
        depth = reg.gauge("mesh_tpu_serve_queue_depth", "d")
        reqs.inc(3, tenant="a", outcome="ok")
        depth.set(2, tenant="a")
        rec.sample()
        reqs.inc(1, tenant="b", outcome="shed")
        rec.sample()
        rec.sample()
        rec.record_span({"t_mono": 1.0, "name": "serve.request",
                         "elapsed_s": 0.5, "status": "ok", "thread": "w",
                         "attrs": {"tenant": "a"}})
        return [{k: v for k, v in e.items() if k != "t"}
                for e in rec.events()]

    events = _same(run)
    assert [e.get("deltas") for e in events[:3]] == [
        {"mesh_tpu_serve_requests_total": 3},
        {"mesh_tpu_serve_requests_total": 1}, {}]
    # finished spans reach the process recorder's ring under MESH_TPU_OBS
    monkeypatch.setenv("MESH_TPU_OBS", "1")
    with ttrace.span("serve.request"):
        pass
    assert tobs.get_recorder().events()[-1]["name"] == "serve.request"
