"""mesh_tpu_torch.obs.replay vs mesh_tpu.obs.replay on the CPU.

Every synthesizer, trace writer and reader, the admission-event
canonicalization and its checksum, the null replay, shadow rows and the
ledger / incident converters take the same inputs in both packages and
must give equal traces, files, checksums and errors.  A trace captured
through the port's ledger replays to the reference's checksum.
"""

import json
import types

import pytest

from mesh_tpu.obs import ledger as jledger
from mesh_tpu.obs import metrics as jmetrics
from mesh_tpu.obs import replay as jreplay

from mesh_tpu_torch.obs import ledger as tledger
from mesh_tpu_torch.obs import metrics as tmetrics
from mesh_tpu_torch.obs import replay as treplay

PORT = types.SimpleNamespace(replay=treplay, ledger=tledger,
                             metrics=tmetrics, name="port")
REF = types.SimpleNamespace(replay=jreplay, ledger=jledger,
                            metrics=jmetrics, name="ref")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("MESH_TPU_REPLAY_TRACE", raising=False)
    yield
    treplay.reset_capture()
    jreplay.reset_capture()


def both(fn):
    return fn(PORT), fn(REF)


def _same(fn):
    mine, theirs = both(fn)
    assert mine == theirs
    return mine


def _rows(n=6, t0=500.0):
    """Ledger-shaped rows with admit stamps out of order and provenance."""
    rows = []
    for i in range(n):
        rows.append({"t_admit": t0 + [0.3, 0.0, 0.7, 0.1, 1.5, 0.9][i % 6]
                     + 2.0 * (i // 6),
                     "tenant": "t%d" % (i % 3), "op": "closest_point",
                     "bucket": 256, "q": 200 + i, "deadline_s": 0.25,
                     "priority": i % 2, "outcome": "ok",
                     "stages": {"queue": 0.001, "device": 0.002},
                     "total_s": 0.003})
    rows.append({"tenant": "no-admit"})
    return rows


@pytest.mark.parametrize("kind,kw", [
    ("steady", {}), ("steady", {"rate_qps": 55.0, "tenants": ("a", "b"),
                                "seed": 9}),
    ("stampede", {}), ("bucket_ladder", {}), ("prune_defeat", {}),
    ("degenerate", {}), ("anim", {"sessions": 3, "frames": 20}),
    ("mix", {}), ("mix", {"seed": 11}),
])
def test_synthesizers_match_reference(kind, kw):
    def run(pkg):
        trace = pkg.replay.synthesize(kind, **kw)
        events = pkg.replay.admission_events(trace)
        return trace, pkg.replay.sequence_checksum(events)

    trace, _ = _same(run)
    offsets = [r["t"] for r in trace["records"]]
    assert offsets == sorted(offsets) and offsets
    assert sorted(treplay.SYNTH_KINDS) == sorted(jreplay.SYNTH_KINDS)


def test_unknown_synth_kind_matches_reference():
    def run(pkg):
        with pytest.raises(pkg.replay.ReplayError) as err:
            pkg.replay.synthesize("nope")
        return str(err.value)

    assert "stampede" in _same(run)


def test_trace_files_round_trip_like_reference(tmp_path):
    def run(pkg):
        trace = pkg.replay.synth_stampede(tenants=3, duration_s=0.5)
        path = str(tmp_path / ("%s.jsonl" % pkg.name))
        n = pkg.replay.write_trace(trace, path)
        with open(path) as fh:
            text = fh.read()
        return n, text, pkg.replay.load_trace(path), \
            pkg.replay.trace_lines(trace)

    n, text, loaded, lines = _same(run)
    assert text == "\n".join(lines) + "\n" and n == len(loaded["records"])


@pytest.mark.parametrize("content", [
    "",
    "not json\n",
    json.dumps({"kind": "other", "schema": 1}) + "\n",
    json.dumps({"kind": "mesh_tpu_trace"}) + "\n",
    json.dumps({"kind": "mesh_tpu_trace", "schema": 99}) + "\n",
    json.dumps({"kind": "mesh_tpu_trace", "schema": 1}) + "\n{bad\n",
    json.dumps({"kind": "mesh_tpu_trace", "schema": 1}) + "\n"
    + json.dumps({"tenant": "x"}) + "\n",
    None,
])
def test_load_trace_refusals_match_reference(content, tmp_path):
    path = str(tmp_path / "trace.jsonl")
    if content is not None:
        with open(path, "w") as fh:
            fh.write(content)

    def run(pkg):
        with pytest.raises(pkg.replay.ReplayError) as err:
            pkg.replay.load_trace(path)
        return str(err.value)

    _same(run)


def test_trace_from_ledger_and_incident_match_reference(tmp_path):
    rows = _rows(8)
    path = str(tmp_path / "ledger.jsonl")
    with open(path, "w") as fh:
        for row in rows:
            fh.write(json.dumps(row) + "\n")

    def run(pkg):
        class _Live(object):
            def records(self):
                return list(rows)

        out = [pkg.replay.trace_from_ledger(rows),
               pkg.replay.trace_from_ledger(path),
               pkg.replay.trace_from_ledger(_Live()),
               pkg.replay.trace_from_incident(
                   {"kind": "incident", "schema_version": 4,
                    "reason": "watchdog_trip", "ledger": rows})]
        errors = []
        for bad in ([{"tenant": "x"}], str(tmp_path / "missing.jsonl"),
                    {"kind": "incident", "schema_version": 1},
                    {"kind": "other"}):
            fn = (pkg.replay.trace_from_incident if isinstance(bad, dict)
                  else pkg.replay.trace_from_ledger)
            with pytest.raises(pkg.replay.ReplayError) as err:
                fn(bad)
            errors.append(str(err.value).replace(str(tmp_path), "<tmp>"))
        return out, errors

    out, _ = _same(run)
    assert out[0]["records"][0]["t"] == 0.0 and len(out[0]["records"]) == 8


@pytest.mark.parametrize("speed,deadline_s", [(1.0, None), (4.0, None),
                                              (0.5, 0.1)])
def test_checksums_and_null_replay_match_reference(speed, deadline_s):
    def run(pkg):
        trace = pkg.replay.synth_mix(seed=7)
        events = pkg.replay.admission_events(trace, deadline_s=deadline_s)
        report = pkg.replay.null_replay(trace, speed=speed,
                                        deadline_s=deadline_s)
        assert report["checksum"] == pkg.replay.sequence_checksum(events)
        return report, events[:5]

    report, _ = _same(run)
    base = treplay.null_replay(treplay.synth_mix(seed=7))
    # speed repaces, it never changes the sequence; a deadline override does
    assert (report["checksum"] == base["checksum"]) == (deadline_s is None)


def test_null_replay_refuses_bad_speed_like_reference():
    def run(pkg):
        with pytest.raises(pkg.replay.ReplayError) as err:
            pkg.replay.null_replay(pkg.replay.synth_steady(), speed=0)
        return str(err.value)

    _same(run)


def test_shadow_rows_and_concat_match_reference():
    def run(pkg):
        trace = pkg.replay.concat_traces(
            [pkg.replay.synth_steady(duration_s=0.5),
             pkg.replay.synth_degenerate(duration_s=0.5)], gap_s=0.25)
        rows = pkg.replay.shadow_rows(
            trace, lambda rec: {"device": 1e-4 * rec["q"],
                                "queue": 0.002, "respond": 1e-5},
            deadline_s=0.3)
        with pytest.raises(pkg.replay.ReplayError) as err:
            pkg.replay.shadow_rows(trace, lambda rec: {"warp": 1.0})
        return trace, rows, str(err.value)

    trace, rows, _ = _same(run)
    assert trace["source"] == "synth:steady+synth:degenerate"
    assert list(rows[0]["stages"]) == ["queue", "device", "respond"]


def test_attach_stage_stats_waits_for_prof():
    # obs/prof.py is ported: the report carries the reference's stage stats
    def run(pkg):
        report = pkg.replay.attach_stage_stats({"checksum": 1.0}, _rows())
        with pytest.raises(Exception) as err:
            pkg.replay.attach_stage_stats({}, [{"tenant": "t"}])
        return report, type(err.value).__name__, str(err.value)

    report, name, _ = _same(run)
    assert name == "ProfError"
    assert report["stage_total"]["count"] == 6
    assert list(report["stage_stats"]) == ["queue", "device"]


def test_trace_writer_listener_matches_reference(tmp_path):
    def run(pkg):
        path = str(tmp_path / ("%s-writer.jsonl" % pkg.name))
        t = [10.0]

        def clock():
            t[0] += 0.125
            return t[0]

        led = pkg.ledger.LatencyLedger(capacity=16, clock=clock,
                                       registry=pkg.metrics.Registry())
        with pkg.replay.TraceWriter(path, source="test") as writer:
            led.add_listener(writer.observe)
            for i in range(4):
                rec = led.open(tenant="w%d" % (i % 2), q=10 * i,
                               deadline_s=0.1, priority=i)
                rec.stamp("device")
                led.close(rec)
            assert writer.observe({"no": "admit"}) is None
            written = writer.written
        with open(path) as fh:
            return written, fh.read()

    written, text = _same(run)
    assert written == 4 and text.count("\n") == 5


def test_port_capture_replays_to_the_reference_checksum(tmp_path,
                                                        monkeypatch):
    """Traffic captured by the port's process ledger under
    MESH_TPU_REPLAY_TRACE, loaded by the reference, gives the checksum of
    the same rows captured by the reference."""
    def run(pkg):
        path = str(tmp_path / ("%s-cap.jsonl" % pkg.name))
        monkeypatch.setenv("MESH_TPU_REPLAY_TRACE", path)
        t = [0.0]

        def clock():
            t[0] += 0.05
            return t[0]

        led = pkg.ledger.LatencyLedger(capacity=32, clock=clock,
                                       registry=pkg.metrics.Registry())
        try:
            for row in _rows(6):
                if "t_admit" not in row:
                    continue
                rec = led.open(**{k: v for k, v in row.items()
                                  if k not in ("t_admit", "stages",
                                               "total_s", "outcome")})
                led.close(rec)
        finally:
            monkeypatch.delenv("MESH_TPU_REPLAY_TRACE")
            pkg.replay.reset_capture()
        return path

    port_path, ref_path = both(run)
    mine = jreplay.null_replay(jreplay.load_trace(port_path))
    theirs = jreplay.null_replay(jreplay.load_trace(ref_path))
    assert mine == theirs and mine["admissions"] == 6
