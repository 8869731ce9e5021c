"""mesh_tpu_torch.obs.prof and .export vs mesh_tpu's on the CPU.

The same ledger traffic, made under fake clocks in each package's own
``LatencyLedger`` and dumped by each, goes through both packages' ``prof``
readers: ``load`` over the four evidence formats (ledger JSONL, serve-stats
sink, incident, bench doc), ``top_lines``, ``attribution``, ``diff``,
``load_rows``, ``load_request_tails``, ``request_trace`` /
``render_request_trace`` and ``fleet_attribution`` must give equal
results, files and errors.  The exporters (``prometheus_text``,
``render_tree``, ``write_jsonl``) must write equal text from equal
registries and span lists.
"""

import json
import types

import pytest

from mesh_tpu.obs import export as jexport
from mesh_tpu.obs import ledger as jledger
from mesh_tpu.obs import metrics as jmetrics
from mesh_tpu.obs import prof as jprof

import mesh_tpu_torch.obs as tobs
from mesh_tpu_torch.obs import export as texport
from mesh_tpu_torch.obs import ledger as tledger
from mesh_tpu_torch.obs import metrics as tmetrics
from mesh_tpu_torch.obs import prof as tprof

PORT = types.SimpleNamespace(prof=tprof, export=texport, ledger=tledger,
                             metrics=tmetrics, name="port")
REF = types.SimpleNamespace(prof=jprof, export=jexport, ledger=jledger,
                            metrics=jmetrics, name="ref")


def both(fn):
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


def _ledger(pkg, capacity=64):
    clk = FakeClock()
    registry = pkg.metrics.Registry()
    return (pkg.ledger.LatencyLedger(capacity=capacity, registry=registry,
                                     clock=clk), clk, registry)


def _workload(led, clk, n=24, tenant="t1", backend="xla", queue_s=0.001,
              dispatch_s=0.002, device_s=0.003, rid=None, **meta):
    """n synthetic requests, each stage's cost injected by the fake clock
    where the real stamp sites sit."""
    for i in range(n):
        extra = dict(meta)
        if rid is not None:
            extra["request_id"] = "%s-%03d" % (rid, i)
        rec = led.open(tenant=tenant, **extra)
        clk.advance(queue_s * (1 + i % 3))
        rec.stamp("queue")
        clk.advance(dispatch_s)
        rec.stamp("dispatch")
        clk.advance(device_s * (1 + (i % 5) / 10.0))
        rec.stamp("device")
        clk.advance(0.0005)
        led.close(rec, backend=backend)


def _dump(pkg, tmp_path, label, **kw):
    led, clk, registry = _ledger(pkg)
    _workload(led, clk, **kw)
    path = str(tmp_path / ("%s-%s.jsonl" % (pkg.name, label)))
    assert led.dump_jsonl(path) == kw.get("n", 24)
    return path, led, registry


# ---------------------------------------------------------------------------
# prof: the four formats


def test_load_ledger_dump_and_top_lines(tmp_path):
    def run(pkg):
        path, _, _ = _dump(pkg, tmp_path, "base")
        stats = pkg.prof.load(path)
        return stats, pkg.prof.top_lines(stats)

    stats, lines = _same(run)
    assert stats["total"]["count"] == 24
    assert set(stats["stages"]) == {"queue", "dispatch", "device", "respond"}
    assert lines[-1] == "backends: xla=24"


def test_load_sink_incident_and_bench_doc(tmp_path):
    def run(pkg):
        path, led, registry = _dump(pkg, tmp_path, "src")
        rows = led.records()
        out = {}
        sink = tmp_path / ("%s-sink.json" % pkg.name)
        sink.write_text(json.dumps({"metrics": registry.snapshot()}))
        out["sink"] = pkg.prof.load(str(sink))
        inc = tmp_path / ("%s-incident.json" % pkg.name)
        inc.write_text(json.dumps({"kind": "incident", "ledger": rows}))
        out["incident"] = pkg.prof.load(str(inc))
        block = pkg.prof.stats_from_records(rows)
        record = {"metric": "serve", "value": 1.0,
                  "stage_stats": block["stages"],
                  "stage_total": block["total"],
                  "stage_backends": block["backends"]}
        final = tmp_path / ("%s-final.json" % pkg.name)
        final.write_text(json.dumps({"records": [record]}))
        out["final"] = pkg.prof.load(str(final))
        partial = tmp_path / ("%s-partial.json" % pkg.name)
        partial.write_text(json.dumps({"kind": "bench_partial", "stages": {
            "serve": {"status": "ok", "record": record}}}))
        out["partial"] = pkg.prof.load(str(partial))
        flat = tmp_path / ("%s-flat.json" % pkg.name)
        flat.write_text(json.dumps(record))
        out["flat"] = pkg.prof.load(str(flat))
        listing = tmp_path / ("%s-list.json" % pkg.name)
        listing.write_text(json.dumps(rows))
        out["list"] = pkg.prof.load(str(listing))
        return out

    out = _same(run)
    assert out["sink"]["total"] is None
    assert out["incident"] == out["list"] == out["final"]


def test_load_errors_are_equal(tmp_path):
    (tmp_path / "garbage.txt").write_text("this is not a profile {\n")
    (tmp_path / "nostages.json").write_text(json.dumps({"metrics": {}}))
    (tmp_path / "future.jsonl").write_text(2 * (json.dumps(
        {"schema": 99, "stages": {"queue": 0.1}}) + "\n"))
    (tmp_path / "empty.jsonl").write_text(2 * (json.dumps(
        {"tenant": "t"}) + "\n"))

    def run(pkg):
        errors = []
        for name in ("garbage.txt", "nostages.json", "future.jsonl",
                     "empty.jsonl", "never_written.jsonl"):
            with pytest.raises(pkg.prof.ProfError) as err:
                pkg.prof.load(str(tmp_path / name))
            errors.append(str(err.value))
        return errors

    _same(run)


# ---------------------------------------------------------------------------
# prof: attribution


@pytest.mark.parametrize("slow", [
    {}, {"queue_s": 0.050}, {"dispatch_s": 0.050}, {"device_s": 0.020},
    {"dispatch_s": 0.0021}])
def test_diff_and_attribution_equal(tmp_path, slow):
    def run(pkg):
        a = pkg.prof.load(_dump(pkg, tmp_path, "a")[0])
        b = pkg.prof.load(_dump(pkg, tmp_path, "b", **slow)[0])
        return (pkg.prof.diff(a, b), pkg.prof.diff(a, b, tol=1000.0),
                pkg.prof.attribution(a, b),
                pkg.prof.attribution(a, b, "p50_s"))

    (rc, lines), (loose_rc, _), top, _ = _same(run)
    assert loose_rc == 0
    if "queue_s" in slow or "dispatch_s" in slow and slow["dispatch_s"] > 0.01:
        stage = "queue" if "queue_s" in slow else "dispatch"
        assert rc == 1 and top[0][0] == stage
        assert all("stage '%s'" % stage in ln for ln in lines
                   if ln.startswith("FAIL"))


def test_fleet_attribution_equal(tmp_path):
    def run(pkg):
        named = [("replica-%d" % i, pkg.prof.load(_dump(
            pkg, tmp_path, "r%d" % i, dispatch_s=0.002 * (1 + 3 * i))[0]))
            for i in range(3)]
        out = [pkg.prof.fleet_attribution(named),
               pkg.prof.fleet_attribution(named, "p50_s"),
               pkg.prof.fleet_attribution(named[:1])]
        with pytest.raises(pkg.prof.ProfError) as err:
            pkg.prof.fleet_attribution([])
        return out, str(err.value)

    (tail, _, single), _ = _same(run)
    assert "replica 'replica-2'" in tail[1][-1]
    assert "stage 'dispatch'" in tail[1][-1]
    assert single[1][-1].startswith("fleet p99: single replica")


# ---------------------------------------------------------------------------
# prof: request identity


def test_request_trace_equal(tmp_path):
    spans = [{"span_id": 1, "parent_id": None, "name": "serve.request",
              "t_mono": 1.0, "elapsed_s": 0.004, "thread": "w0",
              "attrs": {"tenant": "t1"}},
             {"span_id": 2, "parent_id": 1, "name": "engine.dispatch",
              "t_mono": 1.001, "elapsed_s": 0.002, "sync_elapsed_s": 0.001,
              "thread": "w0", "attrs": {}, "status": "error"}]

    def run(pkg):
        path, led, _ = _dump(pkg, tmp_path, "ids", rid="req",
                             routing_key="closest_point|dg|1024",
                             replica="replica-1")
        rows = led.records()
        inc = tmp_path / ("%s-incident.json" % pkg.name)
        inc.write_text(json.dumps({
            "kind": "incident", "ledger": rows[-4:],
            "requests": [{"request_id": "req-023", "row": rows[-1],
                          "spans": spans, "retained": "deadline_miss"}]}))
        out = [pkg.prof.load_rows(path) == [dict(r, schema=1) for r in rows],
               pkg.prof.load_rows(str(inc)),
               pkg.prof.load_request_tails(str(inc)),
               pkg.prof.load_request_tails(path)]
        for rid in ("req-023", "req-005"):
            trace = pkg.prof.request_trace(rid, paths=[path, str(inc)])
            trace["sources"] = [s.replace(pkg.name, "pkg")
                                for s in trace["sources"]]
            out.append((trace, pkg.prof.render_request_trace(trace)))
        with pytest.raises(pkg.prof.ProfError) as err:
            pkg.prof.request_trace("nope", paths=[path])
        return out, str(err.value)

    out, _ = _same(run)
    assert out[0] is True
    trace, lines = out[4]
    assert len(trace["rows"]) == 1 and trace["retained"] == "deadline_miss"
    assert lines[0] == "request req-023"
    assert any("routing_key=closest_point|dg|1024" in ln for ln in lines)


# ---------------------------------------------------------------------------
# export


def _fill(pkg):
    reg = pkg.metrics.Registry()
    c = reg.counter("mesh_tpu_test_total", 'help with "quotes"\nand \\ too')
    c.inc(3, tenant='a"b', route="x\ny")
    c.inc(tenant="plain")
    reg.gauge("mesh_tpu_test_gauge", "").set(2.5)
    h = reg.histogram("mesh_tpu_test_seconds", "latency",
                      buckets=(0.001, 0.01, 0.1))
    for value in (0.0005, 0.004, 0.05, 3.0):
        h.observe(value, stage="queue")
    h.observe(float("inf"), stage="device")
    return reg


def test_prometheus_text_equal():
    text = _same(lambda pkg: pkg.export.prometheus_text(_fill(pkg)))
    assert 'le="+Inf"' in text and '\\"' in text
    for line in text.splitlines():
        assert line.startswith("#") or line.rsplit(" ", 1)[1]


_EVENTS = [
    {"span_id": 3, "parent_id": 1, "name": "child", "t_mono": 2.0,
     "elapsed_s": 0.001, "thread": "main", "attrs": {"b": 2, "a": 1}},
    {"span_id": 1, "parent_id": None, "name": "root", "t_mono": 1.0,
     "elapsed_s": 0.005, "sync_elapsed_s": 0.002, "thread": "main",
     "attrs": {}},
    {"span_id": 7, "parent_id": 99, "name": "orphan", "t_mono": 1.5,
     "elapsed_s": None, "thread": "worker", "attrs": {},
     "status": "error"},
    {"span_id": 8, "parent_id": None, "name": "nothread", "t_mono": None,
     "elapsed_s": 0.0, "attrs": {}},
]


def test_render_tree_equal():
    out = _same(lambda pkg: [pkg.export.render_tree(_EVENTS),
                             pkg.export.render_tree([])])
    assert "(parent span evicted from buffer)" in out[0]
    assert "!error" in out[0]


def test_write_jsonl_equal(tmp_path):
    def run(pkg):
        path = str(tmp_path / ("%s.jsonl" % pkg.name))
        n = pkg.export.write_jsonl(path, events=_EVENTS, registry=_fill(pkg))
        with open(path) as fh:
            return n, fh.read()

    n, text = _same(run)
    assert n == len(_EVENTS) + 1
    assert json.loads(text.splitlines()[-1])["kind"] == "metrics"


def test_package_exports_bind_the_exporters(tmp_path):
    assert tobs.export_jsonl is tobs.write_jsonl
    tobs.reset()
    try:
        tobs.counter("mesh_tpu_export_probe_total").inc()
        assert "mesh_tpu_export_probe_total 1.0" in tobs.prometheus_text()
        assert tobs.render_tree().startswith("(no spans recorded")
        assert tobs.export_jsonl(str(tmp_path / "all.jsonl")) >= 1
    finally:
        tobs.reset()
