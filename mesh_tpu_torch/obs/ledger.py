"""Per-request latency ledger: where inside each request the time went (a
copy of mesh_tpu/obs/ledger.py).  Its callers in the port: the serving
tier (``QueryService`` opens a record per admission and the ladder's rungs
stamp it through ``bind_current``), the query engine's executor
(``coalesce`` / ``pad`` / ``compile`` / ``device``) and the avatar session
(``op="anim_frame"``: ``queue``, ``refit`` and, in the accel traversal,
``device``).

The SLO engine says latency is bad; the flight recorder says what events
surrounded it; neither says WHICH STAGE of a request ate the budget.
The ledger closes that gap: every served request carries one
:class:`RequestRecord` from admission to response, stamped as each stage
finishes —

    admit -> queue -> page_in -> coalesce -> pad -> compile
          -> dispatch -> device -> respond

(``queue`` = serve-queue wait, ``page_in`` = store-key resolution
(store-keyed requests only), ``coalesce`` =
the engine executor's batching window, ``pad`` = stack/bucket-pad cost,
``compile`` = plan-cache lookup or capture, ``dispatch`` = host-side
launch, ``device`` = on-device wall time, ``respond`` = split + response
build).  Stages a request never visits (cache hits, non-engine ladder
rungs) are simply absent; durations chain across the gap, so the
per-record stage seconds always sum to the full admit-to-respond latency.

Records carry provenance — tenant, op, query-shape bucket, accel
backend, degradation-ladder rung, certified/approximate.  Closing a record
feeds each stage duration into the
``mesh_tpu_request_stage_seconds{stage,backend}`` histogram (windowed
percentiles via obs/series.py), appends one JSON-able row to a bounded
ring and to the trace tail (obs/context.py), calls every close listener,
and under ``MESH_TPU_REPLAY_TRACE=path`` streams the row into a replayable
trace (obs/replay.py ``capture_row``); the flight recorder copies the ring
tail into incident dumps, ``dump_jsonl()`` saves it as JSON lines.

Always on; kill switch ``MESH_TPU_LEDGER=0``; ring capacity
``MESH_TPU_LEDGER_CAPACITY`` (default 512); incident tail length
``MESH_TPU_LEDGER_TAIL`` (default 32).  Hot-path cost is one knob read at
open, one perf_counter read per stamp, and one locked append plus a
handful of histogram observes at close.  Stdlib-only; every clock read
goes through the injected ``clock`` for fake-clock tests.
"""

import json
import threading
from collections import deque
from contextlib import contextmanager

from ..utils import knobs
from .clock import monotonic
from .context import TRACE_TAIL
from .metrics import REGISTRY

__all__ = [
    "LEDGER_STAGES", "LEDGER_OUTCOMES", "LEDGER_SCHEMA",
    "RequestRecord", "LatencyLedger", "LEDGER",
    "get_ledger", "ledger_enabled", "bind_current", "current_record",
    "LEDGER_ENV", "LEDGER_CAPACITY_ENV", "LEDGER_TAIL_ENV",
    "REPLAY_TRACE_ENV",
]

#: kill switch: set to 0/false/no/off to disable record creation
LEDGER_ENV = "MESH_TPU_LEDGER"

#: bounded-ring capacity in request records (default 512)
LEDGER_CAPACITY_ENV = "MESH_TPU_LEDGER_CAPACITY"

#: how many ring-tail records ride along in flight-recorder incidents
LEDGER_TAIL_ENV = "MESH_TPU_LEDGER_TAIL"

#: stream every close into a replayable trace at this path (obs/replay)
REPLAY_TRACE_ENV = "MESH_TPU_REPLAY_TRACE"

#: dumped-row schema version, stamped into every ``dump_jsonl`` line so
#: readers (obs/prof.py, obs/replay.py) can refuse rows from a future
#: shape instead of misparsing them; bump on incompatible row changes
LEDGER_SCHEMA = 1

#: stage names in request order; each is stamped when that stage ENDS
#: (the record's open time is the admit stamp).  The meshlint OBS rule
#: checks every name here is documented in doc/observability.md.
LEDGER_STAGES = (
    "queue", "page_in", "refit", "coalesce", "pad", "compile", "dispatch",
    "device", "respond",
)

_STAGE_INDEX = {name: i for i, name in enumerate(LEDGER_STAGES)}

#: the outcome-label contract: every ``close()`` must carry one of
#: these (``ok`` = served, ``cancelled`` = caller cancelled before
#: dispatch, ``deadline`` = deadline expired, ``error`` = rung/store
#: failure, ``shutdown`` = request dropped by a non-draining stop).
#: The meshlint LED rule verifies close sites use only these labels
#: and that each is documented in doc/observability.md.
LEDGER_OUTCOMES = ("ok", "cancelled", "deadline", "error", "shutdown")


def ledger_enabled():
    """True unless MESH_TPU_LEDGER explicitly turns the ledger off
    (unset means ON — attribution must be there when latency goes bad,
    like the flight recorder)."""
    return knobs.flag(LEDGER_ENV)


def _ring_capacity():
    return max(16, knobs.get_int(LEDGER_CAPACITY_ENV))


def tail_length():
    """How many ring-tail records incident dumps carry (min 1)."""
    return max(1, knobs.get_int(LEDGER_TAIL_ENV))


class RequestRecord(object):
    """One request's stage stamps + provenance.

    Mutable and intentionally unlocked: each stamp is written by exactly
    one thread at a time (the request moves serve worker -> executor
    worker with happens-before edges at the queue handoffs), and the
    ledger only reads it at ``close()``.
    """

    __slots__ = ("t_admit", "stamps", "meta", "ctx", "_clock")

    def __init__(self, t_admit, meta, clock):
        self.t_admit = float(t_admit)
        self.stamps = {}
        self.meta = meta
        #: the live RequestContext riding this record across the engine's
        #: coalesce/drain thread hop (obs/context.py); never serialized —
        #: the JSON-able identity lives in ``meta`` (request_id/seq/...)
        self.ctx = None
        self._clock = clock

    def stamp(self, stage, t=None):
        """Mark ``stage`` as finished at ``t`` (now by default).  Unknown
        stage names raise — a typo'd stamp site must fail tests, not
        silently vanish from every breakdown."""
        if stage not in _STAGE_INDEX:
            raise ValueError("unknown ledger stage %r (have %s)"
                             % (stage, LEDGER_STAGES))
        self.stamps[stage] = self._clock() if t is None else float(t)

    def set(self, **meta):
        """Attach/overwrite provenance fields (tenant, op, bucket,
        backend, rung, certified, ...)."""
        self.meta.update(meta)

    def stage_seconds(self):
        """{stage: seconds} for every stamped stage, in stage order.
        Each duration runs from the previous PRESENT stamp (or admit),
        so missing stages are skipped, never double-counted, and the
        values sum to the last stamp minus admit.  Out-of-order stamps
        clamp to 0 rather than going negative."""
        out = {}
        prev = self.t_admit
        for stage in LEDGER_STAGES:
            t = self.stamps.get(stage)
            if t is None:
                continue
            out[stage] = max(t - prev, 0.0)
            prev = t
        return out

    def to_dict(self):
        """One JSON-able row: provenance + per-stage seconds + total."""
        stages = self.stage_seconds()
        row = dict(self.meta)
        row["t_admit"] = round(self.t_admit, 6)
        row["stages"] = {k: round(v, 9) for k, v in stages.items()}
        row["total_s"] = round(sum(stages.values()), 9)
        return row


class LatencyLedger(object):
    """Bounded ring of closed request records + the stage histogram.

    ``open()`` returns a record (or None with the ledger off — every
    stamp site is None-guarded, so the kill switch removes all cost but
    the one knob read).  ``close()`` stamps ``respond``, feeds the
    ``mesh_tpu_request_stage_seconds`` histogram, and appends the row to
    the ring.  Thread-safe: concurrent closes serialize on one lock.
    """

    def __init__(self, capacity=None, registry=None, clock=monotonic):
        self._registry = registry if registry is not None else REGISTRY
        self._clock = clock
        self._capacity = capacity
        self._lock = threading.Lock()
        self._ring = deque(maxlen=capacity or _ring_capacity())
        self._listeners = []

    # -- close listeners -----------------------------------------------

    def add_listener(self, fn):
        """Register ``fn(row)`` to observe every closed row (trace
        capture, tests).  Listener failures are swallowed: observers
        must never be able to fail a request that already served."""
        with self._lock:
            self._listeners.append(fn)
        return fn

    def remove_listener(self, fn):
        with self._lock:
            if fn in self._listeners:
                self._listeners.remove(fn)

    # -- lifecycle of one record ---------------------------------------

    def open(self, **meta):
        """Start a record at admit time; None when the ledger is off."""
        if not ledger_enabled():
            return None
        return RequestRecord(self._clock(), meta, self._clock)

    def close(self, record, outcome="ok", **meta):
        """Finish ``record``: stamp ``respond`` (unless already
        stamped), observe every stage duration into the stage histogram
        labeled with this record's backend, and ring-append the row.
        Returns the row dict (None for a None record)."""
        if record is None:
            return None
        if meta:
            record.meta.update(meta)
        record.meta.setdefault("outcome", outcome)
        if "respond" not in record.stamps:
            record.stamp("respond")
        stages = record.stage_seconds()
        backend = record.meta.get("backend") or "none"
        hist = self._registry.histogram(
            "mesh_tpu_request_stage_seconds",
            "Per-request wall seconds by ledger stage and accel backend.",
        )
        exemplar = record.meta.get("request_id")
        for stage, seconds in stages.items():
            hist.observe(seconds, exemplar=exemplar,
                         stage=stage, backend=backend)
        row = record.to_dict()
        with self._lock:
            self._ring.append(row)
            listeners = tuple(self._listeners)
        try:
            TRACE_TAIL.observe_close(row)
        except Exception:               # noqa: BLE001 — retention can't fail serving
            self._observer_error("tail")
        for fn in listeners:
            try:
                fn(row)
            except Exception:           # noqa: BLE001 — observers can't fail serving
                self._observer_error("listener")
        trace_path = knobs.get_str(REPLAY_TRACE_ENV)
        if trace_path:
            from .replay import capture_row
            try:
                capture_row(row, trace_path)
            except Exception:           # noqa: BLE001 — capture can't fail serving
                self._observer_error("capture")
        return row

    def _observer_error(self, where):
        """A swallowed observer/capture failure is still counted — a
        broken trace writer must be visible, never silent."""
        try:
            self._registry.counter(
                "mesh_tpu_ledger_observer_errors_total",
                "Ledger close-path observer failures swallowed to protect "
                "serving (label `where`: listener / capture / tail).",
            ).inc(where=where)
        except Exception:               # noqa: BLE001 — last-resort guard
            pass

    # -- consumption ---------------------------------------------------

    def tail(self, n=None):
        """The newest ``n`` closed rows (default: the incident tail
        length), oldest first."""
        n = tail_length() if n is None else int(n)
        with self._lock:
            rows = list(self._ring)
        return rows[-n:] if n < len(rows) else rows

    def records(self):
        """Every retained row, oldest first."""
        with self._lock:
            return list(self._ring)

    def __len__(self):
        with self._lock:
            return len(self._ring)

    def clear(self):
        """Empty the ring and re-read the capacity knob (tests resize
        via env + obs.reset())."""
        with self._lock:
            self._ring = deque(maxlen=self._capacity or _ring_capacity())

    def dump_jsonl(self, path, n=None):
        """Write the newest ``n`` rows (default: everything retained) as
        JSON lines (the reference's ``mesh-tpu prof diff`` input format).  Each line
        is stamped with ``schema`` = :data:`LEDGER_SCHEMA` (the in-ring
        rows stay unstamped; the version belongs to the file format).
        Returns the row count written."""
        rows = self.records() if n is None else self.tail(n)
        with open(path, "w") as fh:
            for row in rows:
                fh.write(json.dumps(dict(row, schema=LEDGER_SCHEMA),
                                    sort_keys=True))
                fh.write("\n")
        return len(rows)


# -- current-record binding -------------------------------------------------

_TLS = threading.local()


@contextmanager
def bind_current(record):
    """Bind ``record`` as this thread's in-flight request for the block.

    The degradation ladder (serve/deadline.py) keeps its
    ``fn(mesh, points, chunk, timeout)`` rung signature — custom rungs
    stay source-compatible — so built-in rungs reach the record through
    this binding instead of a threaded parameter.  Nesting restores the
    previous binding on exit; binding None is a no-op-shaped guard."""
    prev = getattr(_TLS, "record", None)
    _TLS.record = record
    try:
        yield record
    finally:
        _TLS.record = prev


def current_record():
    """The record bound on THIS thread, or None."""
    return getattr(_TLS, "record", None)


#: the process-wide ledger every serve/engine stamp site feeds
LEDGER = LatencyLedger()


def get_ledger():
    """The process-wide LatencyLedger (hot paths call this instead of
    importing LEDGER directly so tests can monkeypatch one place)."""
    return LEDGER
