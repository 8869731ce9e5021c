"""Record/replay: ledger-derived traces, shadow replay, synthesis (a copy
of mesh_tpu/obs/replay.py).

The per-request ledger (obs/ledger.py) captures full provenance for every
served request; this module turns that evidence into a *workload corpus*:

- **capture** — :class:`TraceWriter` streams versioned trace records
  (relative admit timestamps + tenant/op/bucket/deadline/priority/
  store-key provenance) to JSONL as ledger records close;
  :func:`trace_from_ledger` / :func:`trace_from_incident` convert any
  existing ledger dump or schema->=2 flight-recorder incident into a
  replayable trace after the fact.  Setting ``MESH_TPU_REPLAY_TRACE``
  streams every close of the process-wide ledger into a trace file with
  no code changes (the ledger consults the knob per close).
- **replay** — ``serve/loadgen.py``'s ``run_trace_replay`` reproduces a
  trace's exact admission sequence against a live ``QueryService``
  (inter-arrival gaps, tenant mix, deadline spread, optional ``speed``
  time-warp); :func:`null_replay` is the service-less twin that validates
  traces and their checksums.
- **determinism** — :func:`admission_events` canonicalizes the admission
  sequence and :func:`sequence_checksum` hashes it, so "same trace twice
  => same sequence" is machine-checkable (the checksum is invariant to
  ``speed``: a time-warp changes pacing, never the sequence).
- **shadow rows** — :func:`shadow_rows` pushes a trace through a
  synthetic stage model and emits ledger-shaped rows, so two builds'
  stage models compare on one trace; ``attach_stage_stats`` embeds their
  stage statistics in a report, which ``obs/prof.py``'s ``load`` and
  ``diff`` then read and attribute.
- **synthesis** — composable adversarial generators (tenant stampede,
  bucket-ladder boundary shapes, volume-filling prune-defeating queries
  from the accel hard case, degenerate meshes, avatar streams) emit the
  same trace schema, so synthetic and captured traffic ride one replay
  path.

Stdlib-only: every clock read goes through an injected clock, and the
synthesizers draw from ``random.Random(seed)``, so a trace is the same in
both packages.
"""

import json
import random
import threading
import zlib

__all__ = [
    "TRACE_SCHEMA", "TRACE_KIND", "REPLAY_TRACE_ENV", "ReplayError",
    "TraceWriter", "trace_from_ledger", "trace_from_incident",
    "load_trace", "write_trace", "trace_lines",
    "admission_events", "sequence_checksum", "null_replay",
    "shadow_rows", "attach_stage_stats",
    "synthesize", "SYNTH_KINDS", "synth_anim", "synth_steady",
    "synth_stampede",
    "synth_bucket_ladder", "synth_prune_defeat", "synth_degenerate",
    "synth_mix", "concat_traces", "capture_row", "reset_capture",
]

#: trace file schema version: bump when the record shape changes in a
#: way old readers must refuse (readers accept any schema <= current)
TRACE_SCHEMA = 1

#: the header line's ``kind`` tag — what makes a JSONL file a trace
TRACE_KIND = "mesh_tpu_trace"

#: knob: stream every process-wide ledger close into a trace at this
#: path (declared in utils/knobs.py; consulted by LatencyLedger.close)
REPLAY_TRACE_ENV = "MESH_TPU_REPLAY_TRACE"

#: provenance fields a trace record may carry beyond the admit offset
_RECORD_FIELDS = ("tenant", "op", "bucket", "q", "deadline_s", "priority",
                  "store_key", "shape")


class ReplayError(ValueError):
    """Unreadable/unrecognized trace input."""


# ---------------------------------------------------------------------------
# trace records and files


def _trace_record(row, t0):
    """One trace record from a ledger row: relative admit offset plus
    the provenance fields replay needs to reproduce the admission."""
    rec = {"t": round(max(float(row.get("t_admit", t0)) - t0, 0.0), 6)}
    for key in _RECORD_FIELDS:
        value = row.get(key)
        if value is not None:
            rec[key] = value
    rec.setdefault("tenant", "default")
    return rec


def _header(source, extra=None):
    head = {"kind": TRACE_KIND, "schema": TRACE_SCHEMA, "source": source}
    if extra:
        head.update(extra)
    return head


def trace_lines(trace):
    """The JSONL serialization of a trace dict: header line first, one
    record per line after it."""
    lines = [json.dumps(_header(trace.get("source", "unknown"),
                                {"records": len(trace["records"])}),
                        sort_keys=True)]
    for rec in trace["records"]:
        lines.append(json.dumps(rec, sort_keys=True))
    return lines


def write_trace(trace, path):
    """Write a trace dict as JSONL; returns the record count."""
    with open(path, "w") as fh:
        for line in trace_lines(trace):
            fh.write(line)
            fh.write("\n")
    return len(trace["records"])


def load_trace(path):
    """Read a trace file into ``{"schema", "source", "records": [...]}``.

    Raises :class:`ReplayError` on a missing header, a schema newer than
    this reader supports, or malformed records — a trace that cannot be
    validated must fail loudly before replay starts admitting from it.
    Records are returned sorted by admit offset (ties keep file order).
    """
    try:
        with open(path) as fh:
            lines = [ln.strip() for ln in fh if ln.strip()]
    except OSError as e:
        raise ReplayError("cannot read trace %s: %s" % (path, e))
    if not lines:
        raise ReplayError("%s: empty trace file" % path)
    try:
        head = json.loads(lines[0])
    except ValueError:
        raise ReplayError("%s: first line is not JSON (expected the "
                          "trace header)" % path)
    if not isinstance(head, dict) or head.get("kind") != TRACE_KIND:
        raise ReplayError(
            "%s: not a trace file (header kind %r, expected %r)"
            % (path, head.get("kind") if isinstance(head, dict) else None,
               TRACE_KIND))
    schema = head.get("schema")
    if not isinstance(schema, int) or schema < 1:
        raise ReplayError("%s: trace header carries no schema version"
                          % path)
    if schema > TRACE_SCHEMA:
        raise ReplayError(
            "%s: trace schema %d is newer than supported %d — upgrade "
            "before replaying" % (path, schema, TRACE_SCHEMA))
    records = []
    for i, line in enumerate(lines[1:], 2):
        try:
            rec = json.loads(line)
        except ValueError:
            raise ReplayError("%s:%d: malformed trace record" % (path, i))
        if not isinstance(rec, dict) or "t" not in rec:
            raise ReplayError("%s:%d: trace record carries no admit "
                              "offset 't'" % (path, i))
        rec["t"] = float(rec["t"])
        rec.setdefault("tenant", "default")
        records.append(rec)
    records.sort(key=lambda r: r["t"])
    return {"schema": schema, "source": head.get("source", "unknown"),
            "records": records}


def trace_from_ledger(source, name=None):
    """A trace from ledger evidence: a ``dump_jsonl`` path, a list of
    ledger rows, or anything with a ``records()`` method (a live
    :class:`~mesh_tpu_torch.obs.ledger.LatencyLedger`).  Admit offsets are
    rebased to the earliest row, so monotonic-clock origins never leak
    into the trace."""
    if hasattr(source, "records"):
        rows, name = source.records(), name or "ledger"
    elif isinstance(source, (list, tuple)):
        rows, name = list(source), name or "ledger"
    else:
        name = name or str(source)
        rows = []
        try:
            with open(source) as fh:
                for line in fh:
                    line = line.strip()
                    if line:
                        rows.append(json.loads(line))
        except (OSError, ValueError) as e:
            raise ReplayError("cannot read ledger %s: %s" % (source, e))
    rows = [r for r in rows if isinstance(r, dict) and "t_admit" in r]
    if not rows:
        raise ReplayError("no ledger rows with a t_admit stamp in %s"
                          % name)
    t0 = min(float(r["t_admit"]) for r in rows)
    records = sorted((_trace_record(r, t0) for r in rows),
                     key=lambda rec: rec["t"])
    return {"schema": TRACE_SCHEMA, "source": name, "records": records}


def trace_from_incident(source):
    """A trace from a flight-recorder incident dump (path or already-
    parsed dict): the ledger tail the recorder froze at trigger time
    becomes the replayable last-moments workload.  Requires incident
    ``schema_version >= 2`` (the version that added the ledger key)."""
    doc = source
    if not isinstance(doc, dict):
        try:
            with open(source) as fh:
                doc = json.load(fh)
        except (OSError, ValueError) as e:
            raise ReplayError("cannot read incident %s: %s" % (source, e))
    if doc.get("kind") != "incident":
        raise ReplayError("not an incident dump (kind %r)"
                          % (doc.get("kind"),))
    if int(doc.get("schema_version") or 0) < 2:
        raise ReplayError(
            "incident schema_version %s predates the ledger tail "
            "(need >= 2) — nothing to replay" % doc.get("schema_version"))
    name = "incident:%s" % (doc.get("reason") or "unknown")
    return trace_from_ledger(doc.get("ledger") or [], name=name)


# ---------------------------------------------------------------------------
# streaming capture


class TraceWriter(object):
    """Streams ledger close rows to a trace file as they happen.

    The first observed row pins the trace origin (its ``t_admit``
    becomes offset 0) and writes the header; each subsequent row appends
    one record line.  Attach it to a ledger with
    ``ledger.add_listener(writer.observe)``, or let the
    ``MESH_TPU_REPLAY_TRACE`` knob install one on the process-wide
    ledger.  Thread-safe; rows are flushed per record so a crash loses
    at most the in-flight line."""

    def __init__(self, path, source="live"):
        self.path = path
        self.source = source
        self._lock = threading.Lock()
        self._fh = None
        self._t0 = None
        self.written = 0

    def observe(self, row):
        """Append one ledger row as a trace record; returns the record
        (or None for a row with no admit stamp)."""
        if not isinstance(row, dict) or "t_admit" not in row:
            return None
        with self._lock:
            if self._fh is None:
                self._fh = open(self.path, "w")
                self._t0 = float(row["t_admit"])
                self._fh.write(json.dumps(_header(self.source),
                                          sort_keys=True))
                self._fh.write("\n")
            rec = _trace_record(row, self._t0)
            self._fh.write(json.dumps(rec, sort_keys=True))
            self._fh.write("\n")
            self._fh.flush()
            self.written += 1
        return rec

    def close(self):
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_CAPTURE_LOCK = threading.Lock()
_CAPTURE = {}                       # path -> TraceWriter


def capture_row(row, path):
    """The ``MESH_TPU_REPLAY_TRACE`` hook: stream ``row`` into the
    TraceWriter for ``path`` (created on first use).  Called by
    ``LatencyLedger.close`` with the knob's per-call value, so toggling
    the knob at runtime starts/stops capture without restarts."""
    with _CAPTURE_LOCK:
        writer = _CAPTURE.get(path)
        if writer is None:
            writer = _CAPTURE[path] = TraceWriter(path, source="capture")
    writer.observe(row)


def reset_capture():
    """Close every knob-installed capture writer (tests; atexit-free)."""
    with _CAPTURE_LOCK:
        writers = list(_CAPTURE.values())
        _CAPTURE.clear()
    for writer in writers:
        writer.close()


# ---------------------------------------------------------------------------
# admission sequence identity


def admission_events(trace, deadline_s=None):
    """The canonical admission sequence of a trace: one compact event
    per record, in admit order.  This is the list both the live replay
    and the null replay hash, so a report checksum is comparable with
    ``sequence_checksum(admission_events(trace))`` directly.  The
    optional ``deadline_s`` override is part of the sequence (replaying
    with a different deadline spread IS a different workload); ``speed``
    deliberately is not (a time-warp repaces the same sequence)."""
    events = []
    for i, rec in enumerate(trace["records"]):
        deadline = deadline_s if deadline_s is not None \
            else rec.get("deadline_s")
        events.append([
            i,
            round(float(rec["t"]), 6),
            rec.get("tenant", "default"),
            int(rec.get("priority") or 0),
            round(float(deadline), 6) if deadline is not None else None,
            rec.get("op") or "",
            int(rec.get("bucket") or -1),
            rec.get("store_key") or "",
            int(rec.get("q") or -1),
        ])
    return events


def sequence_checksum(events):
    """Deterministic checksum of an admission-event list (a float; equal
    sequences give equal checksums, in either package)."""
    payload = json.dumps(events, sort_keys=True, separators=(",", ":"))
    return float(zlib.crc32(payload.encode("utf-8")))


def null_replay(trace, speed=1.0, deadline_s=None, clock=None, sleep=None):
    """Replay the admission *pacing* of a trace with no service behind
    it: walks every record at its (time-warped) offset and reports the
    paced duration plus the sequence checksum.  Default clocks are fake
    (virtual time — instant), so a trace and its checksum validate
    without sleeping through it; pass real
    ``clock``/``sleep`` to rehearse wall-clock pacing."""
    if speed <= 0:
        raise ReplayError("replay speed must be > 0 (got %s)" % speed)
    if clock is None or sleep is None:
        t = [0.0]

        def clock():                # noqa: F811 — fake pair, by design
            return t[0]

        def sleep(dt):              # noqa: F811
            t[0] += max(dt, 0.0)
    events = admission_events(trace, deadline_s=deadline_s)
    t0 = clock()
    for rec in trace["records"]:
        target = t0 + float(rec["t"]) / speed
        wait = target - clock()
        if wait > 0:
            sleep(wait)
    paced_s = clock() - t0
    return {
        "loop": "replay",
        "mode": "null",
        "source": trace.get("source", "unknown"),
        "speed": float(speed),
        "admissions": len(events),
        "paced_s": round(paced_s, 4),
        "wall_s": round(paced_s, 4),
        "checksum": sequence_checksum(events),
    }


# ---------------------------------------------------------------------------
# shadow replay: trace -> synthetic ledger rows for stage attribution


def shadow_rows(trace, stage_model, deadline_s=None):
    """Push a trace through a synthetic stage model and return
    ledger-shaped rows (``t_admit``/``stages``/``total_s`` + trace
    provenance).  ``stage_model(record) -> {stage: seconds}`` plays the
    build under test: two models for the same trace yield two evidence
    sets whose ``prof.diff`` names the stage that moved — the
    "would the fix have held?" shadow experiment without a chip."""
    from .ledger import LEDGER_STAGES

    rows = []
    for rec in trace["records"]:
        stages = stage_model(rec)
        unknown = [s for s in stages if s not in LEDGER_STAGES]
        if unknown:
            raise ReplayError("stage model produced unknown stage(s) %s "
                              "(have %s)" % (unknown, list(LEDGER_STAGES)))
        ordered = {s: round(float(stages[s]), 9)
                   for s in LEDGER_STAGES if s in stages}
        row = {k: v for k, v in rec.items() if k != "t"}
        deadline = deadline_s if deadline_s is not None \
            else rec.get("deadline_s")
        if deadline is not None:
            row["deadline_s"] = float(deadline)
        row["t_admit"] = round(float(rec["t"]), 6)
        row["stages"] = ordered
        row["total_s"] = round(sum(ordered.values()), 9)
        row["outcome"] = "ok"
        rows.append(row)
    return rows


def attach_stage_stats(report, rows):
    """Embed prof-shaped stage evidence into a replay report so the
    report file itself is a ``prof.load`` source (the same
    ``stage_stats`` contract a bench record uses).  Returns the report."""
    from . import prof

    stats = prof.stats_from_records(rows)
    report["stage_stats"] = stats["stages"]
    report["stage_total"] = stats["total"]
    report["stage_backends"] = stats["backends"]
    return report


# ---------------------------------------------------------------------------
# adversarial workload synthesis


def _mk_trace(records, source):
    records.sort(key=lambda r: r["t"])
    for rec in records:
        rec["t"] = round(rec["t"], 6)
    return {"schema": TRACE_SCHEMA, "source": source, "records": records}


def synth_steady(rate_qps=20.0, duration_s=5.0, tenants=("steady",),
                 deadline_s=0.5, q=256, op="closest_point", seed=0):
    """Baseline: Poisson-free uniform arrivals round-robined across
    tenants — the calm traffic every adversarial mix is measured
    against (and the tuner_replay scenario's recovery phase)."""
    rng = random.Random(seed)
    interval = 1.0 / float(rate_qps)
    records, t, i = [], 0.0, 0
    while t < duration_s:
        records.append({
            "t": t + rng.uniform(0, 0.2 * interval),
            "tenant": tenants[i % len(tenants)],
            "op": op, "q": int(q), "deadline_s": float(deadline_s),
            "priority": 0,
        })
        t += interval
        i += 1
    return _mk_trace(records, "synth:steady")


def synth_stampede(tenants=6, burst_every_s=0.25, duration_s=2.0,
                   deadline_s=0.25, q=256, seed=1):
    """Tenant stampede: every tenant admits in the same instant, burst
    after burst — the shape that makes weighted-fair queueing and
    per-tenant bounds earn their keep (near-zero inter-arrival gaps
    inside a burst, deadline pressure across it)."""
    rng = random.Random(seed)
    records, t = [], 0.0
    while t < duration_s:
        for k in range(int(tenants)):
            records.append({
                "t": t + rng.uniform(0, 1e-3),
                "tenant": "stampede-%d" % k,
                "op": "closest_point", "q": int(q),
                "deadline_s": float(deadline_s),
                "priority": -1 if k == tenants - 1 else 0,
            })
        t += burst_every_s
    return _mk_trace(records, "synth:stampede")


def synth_bucket_ladder(buckets=(64, 128, 256, 512, 1024), rate_qps=40.0,
                        duration_s=3.0, deadline_s=0.5, seed=2):
    """Bucket-ladder boundary shapes: query counts walk each padding
    bucket's boundary (bucket-1, bucket, bucket+1), so every admission
    lands maximally awkwardly for the shape-bucketed plan cache — the
    pad-waste and retrace worst case."""
    rng = random.Random(seed)
    interval = 1.0 / float(rate_qps)
    records, t, i = [], 0.0, 0
    while t < duration_s:
        bucket = buckets[(i // 3) % len(buckets)]
        qn = max(1, bucket + (i % 3) - 1)        # bucket-1, bucket, bucket+1
        records.append({
            "t": t + rng.uniform(0, 0.1 * interval),
            "tenant": "ladder",
            "op": "closest_point", "q": int(qn), "bucket": int(bucket),
            "deadline_s": float(deadline_s), "priority": 0,
        })
        t += interval
        i += 1
    return _mk_trace(records, "synth:bucket_ladder")


def synth_prune_defeat(rate_qps=20.0, duration_s=3.0, q=1024,
                       deadline_s=0.5, seed=3):
    """Volume-filling prune-defeating queries: the accel tier's
    documented hard case — queries spread through the mesh bounding
    volume instead of hugging the surface, so BVH/grid traversal
    cannot cull and pair tests degrade toward brute force.  The
    ``shape`` tag rides the trace so replay harnesses can regenerate
    matching query clouds."""
    rng = random.Random(seed)
    interval = 1.0 / float(rate_qps)
    records, t = [], 0.0
    while t < duration_s:
        records.append({
            "t": t + rng.uniform(0, 0.1 * interval),
            "tenant": "prune-defeat",
            "op": "closest_point", "q": int(q),
            "deadline_s": float(deadline_s), "priority": 0,
            "shape": "volume_fill",
        })
        t += interval
    return _mk_trace(records, "synth:prune_defeat")


def synth_degenerate(rate_qps=10.0, duration_s=2.0, q=256,
                     deadline_s=0.5, seed=4):
    """Degenerate-mesh traffic: requests tagged as targeting
    sliver/zero-area-tail topology, the inputs that force the safe tile
    variants and the certificate-fallback path — replay them against a
    candidate build to prove the robustness ladder still holds."""
    rng = random.Random(seed)
    interval = 1.0 / float(rate_qps)
    records, t = [], 0.0
    while t < duration_s:
        records.append({
            "t": t + rng.uniform(0, 0.1 * interval),
            "tenant": "degenerate",
            "op": "closest_point", "q": int(q),
            "deadline_s": float(deadline_s), "priority": 0,
            "shape": "degenerate_mesh",
        })
        t += interval
    return _mk_trace(records, "synth:degenerate")


def synth_anim(sessions=6, hz=30.0, frames=90, q=128, seed=5):
    """Avatar-stream traffic: ``sessions`` fixed-topology streams each
    admitting one frame per ``1/hz`` with a hard per-frame deadline of
    exactly the frame budget — the periodic deadline-hard arrival
    process animated meshes present (serve/loadgen.run_periodic is the
    live twin of this trace).  Streams are phase-offset within one
    frame interval, so ticks interleave instead of stampeding; the
    ``anim_periodic`` shape tag tells replay harnesses to regenerate
    per-frame vertex deltas to match."""
    rng = random.Random(seed)
    interval = 1.0 / float(hz)
    records = []
    for s in range(int(sessions)):
        phase = rng.random() * interval
        for k in range(int(frames)):
            records.append({
                "t": phase + k * interval,
                "tenant": "avatar-%d" % s,
                "op": "anim_frame", "q": int(q),
                "deadline_s": float(interval), "priority": 0,
                "shape": "anim_periodic", "frame": k,
            })
    return _mk_trace(records, "synth:anim")


def concat_traces(traces, gap_s=0.5, source=None):
    """Compose traces end to end (each shifted past the previous one's
    last admission plus ``gap_s``) — how adversarial mixes are built
    from the single-shape generators."""
    records, offset = [], 0.0
    names = []
    for trace in traces:
        names.append(trace.get("source", "?"))
        last = 0.0
        for rec in trace["records"]:
            moved = dict(rec)
            moved["t"] = rec["t"] + offset
            last = max(last, moved["t"])
            records.append(moved)
        offset = last + gap_s
    return _mk_trace(records, source or "+".join(names))


def synth_mix(seed=7):
    """The default adversarial mix: stampede -> bucket ladder ->
    prune-defeat -> degenerate, composed on one timeline (what the
    reference's replay_proxy bench stage replays)."""
    return concat_traces([
        synth_stampede(seed=seed),
        synth_bucket_ladder(seed=seed + 1),
        synth_prune_defeat(seed=seed + 2),
        synth_degenerate(seed=seed + 3),
    ], gap_s=0.5, source="synth:mix")


SYNTH_KINDS = {
    "steady": synth_steady,
    "stampede": synth_stampede,
    "bucket_ladder": synth_bucket_ladder,
    "prune_defeat": synth_prune_defeat,
    "degenerate": synth_degenerate,
    "anim": synth_anim,
    "mix": synth_mix,
}


def synthesize(kind, **kw):
    """Dispatch to one generator by name.
    Unknown kinds raise :class:`ReplayError` with the menu."""
    fn = SYNTH_KINDS.get(kind)
    if fn is None:
        raise ReplayError("unknown synth kind %r (have %s)"
                          % (kind, ", ".join(sorted(SYNTH_KINDS))))
    return fn(**kw)
