"""Always-on flight recorder: a bounded ring of recent events plus
self-contained JSON incident dumps (a copy of mesh_tpu/obs/recorder.py).

The recorder is the black box for the serving tier: it keeps the last
few thousand interesting events (engine dispatches, serve admissions /
rejections / deadline outcomes, health trips, avatar sessions, periodic
metric deltas) in a fixed-size in-memory ring, always on — one env read
plus one locked deque append per event, cheap enough that it runs with
``MESH_TPU_OBS`` off.

When something goes wrong — a watchdog trip, an SLO fast-burn breach
(obs/slo.py), an uncaught executor or serve-worker exception, or an
explicit ``trigger()`` call — the recorder dumps one self-contained
JSON incident file: the ring contents, a full registry snapshot, the
``HealthMonitor.snapshot()``, an engine plan-cache summary, the ledger
and knob-change tails, the retained request traces, and the relevant
environment, so the *why* behind a deadline-miss storm survives the
process.  ``list_incidents`` lists the dumps.

Env gates (read per call): ``MESH_TPU_RECORDER=0`` disables recording
entirely; ``MESH_TPU_RECORDER_EVENTS`` sizes the ring (default 2048);
``MESH_TPU_INCIDENT_DIR`` relocates the dump directory (default
``~/.mesh_tpu_torch/incidents``: the reference's path shape under the
port's own name, so the two packages never share a dump directory);
``MESH_TPU_INCIDENT_KEEP`` bounds how many dumps are retained (default
32, oldest pruned).
"""

import json
import os
import sys
import threading
from collections import deque

from ..utils import knobs
from .clock import monotonic, wall
from .metrics import REGISTRY
from .trace import TRACER

__all__ = [
    "FlightRecorder", "RECORDER", "get_recorder", "recorder_enabled",
    "default_incident_dir", "list_incidents", "RECORDER_ENV",
    "INCIDENT_DIR_ENV", "KEEP_ENV", "EVENTS_ENV", "SCHEMA_VERSION",
]

#: kill switch: set to 0/false/no/off to disable all recording
RECORDER_ENV = "MESH_TPU_RECORDER"

#: where incident dumps land (default ~/.mesh_tpu_torch/incidents)
INCIDENT_DIR_ENV = "MESH_TPU_INCIDENT_DIR"

#: how many incident files to retain (oldest pruned; default 32)
KEEP_ENV = "MESH_TPU_INCIDENT_KEEP"

#: ring capacity for the process-wide recorder (default 2048 events)
EVENTS_ENV = "MESH_TPU_RECORDER_EVENTS"

#: incident-file schema version, the reference's (bump on breaking shape
#: changes): v2 added the ``"ledger"`` tail (the newest
#: MESH_TPU_LEDGER_TAIL request records), v3 the ``"knob_history"`` tail
#: (the tuning layer's newest MESH_TPU_KNOB_TAIL ``knob_change`` events),
#: v4 the ``"requests"`` tail (the tail-sampling ring's retained request
#: traces, ledger row + span tree joined by request_id, obs/context.py).
SCHEMA_VERSION = 4

#: env prefixes captured into each incident (config forensics)
_ENV_PREFIXES = ("MESH_TPU_", "CUDA_", "TORCH_")

#: counters sampled as deltas by sample() — the cheap "what moved since
#: the last sample" view that makes ring timelines readable
_SAMPLED_TOTALS = (
    "mesh_tpu_serve_requests_total",
    "mesh_tpu_serve_shed_total",
    "mesh_tpu_serve_deadline_miss_total",
    "mesh_tpu_serve_retries_total",
    "mesh_tpu_engine_plan_misses_total",
    "mesh_tpu_engine_coalesced_dispatches_total",
)


def recorder_enabled():
    """True unless MESH_TPU_RECORDER explicitly turns recording off
    (unset means ON — the recorder is the always-on black box; the knob
    is declared with default=on)."""
    return knobs.flag(RECORDER_ENV)


def default_incident_dir():
    """MESH_TPU_INCIDENT_DIR, or ~/.mesh_tpu_torch/incidents."""
    path = knobs.get_str(INCIDENT_DIR_ENV, None)
    if path:
        return path
    return os.path.join(os.path.expanduser("~"), ".mesh_tpu_torch",
                        "incidents")


def _keep_limit():
    return max(1, knobs.get_int(KEEP_ENV))


def _ring_capacity():
    return max(16, knobs.get_int(EVENTS_ENV))


def list_incidents(directory=None):
    """Sorted (oldest first) incident file paths in ``directory``
    (stdlib-only)."""
    directory = directory or default_incident_dir()
    try:
        names = sorted(
            n for n in os.listdir(directory)
            if n.startswith("incident-") and n.endswith(".json")
        )
    except OSError:
        return []
    return [os.path.join(directory, n) for n in names]


class FlightRecorder(object):
    """Bounded ring of recent events + triggered incident dumps.

    ``record()`` is the hot-path entry: one enabled() env read, one
    dict build, one locked deque append.  ``trigger()`` freezes the
    ring plus every diagnostic snapshot we can reach into one JSON
    file; dumps are rate-limited (``min_dump_interval_s``) so a trip
    storm produces one incident, not a disk full of them —
    ``force=True`` (the explicit-API path) bypasses the limit.
    """

    def __init__(self, capacity=None, registry=REGISTRY, clock=monotonic,
                 min_dump_interval_s=30.0):
        self._ring = deque(maxlen=capacity or _ring_capacity())
        self._lock = threading.Lock()
        self._registry = registry
        self._clock = clock
        self._min_dump_interval_s = min_dump_interval_s
        self._last_dump_t = None
        self._dump_seq = 0
        self._health = None
        self._sample_prev = {}

    # -- recording (hot path) ------------------------------------------

    def record(self, kind, **fields):
        """Append one event to the ring; a no-op when
        MESH_TPU_RECORDER is off."""
        if not recorder_enabled():
            return
        fields["kind"] = kind
        fields["t"] = self._clock()
        with self._lock:
            self._ring.append(fields)

    def record_span(self, event):
        """TRACER sink: finished spans land in the ring too (only fires
        while MESH_TPU_OBS is on, so this adds nothing to the gated-off
        cost)."""
        if not recorder_enabled():
            return
        slim = {
            "kind": "span",
            "t": event.get("t_mono"),
            "name": event.get("name"),
            "elapsed_s": event.get("elapsed_s"),
            "status": event.get("status"),
            "thread": event.get("thread"),
        }
        attrs = event.get("attrs")
        if attrs:
            slim["attrs"] = attrs
        with self._lock:
            self._ring.append(slim)

    def sample(self):
        """Record one ``metrics.sample`` event holding the deltas of the
        serve/engine totals since the previous sample plus current queue
        depths — the periodic heartbeat an SLOMonitor loop drives."""
        if not recorder_enabled():
            return
        deltas = {}
        for name in _SAMPLED_TOTALS:
            metric = self._registry.get(name)
            if metric is None:
                continue
            try:
                total = metric.total()
            except AttributeError:
                continue
            prev = self._sample_prev.get(name, 0)
            self._sample_prev[name] = total
            if total != prev:
                deltas[name] = total - prev
        depths = {}
        depth_gauge = self._registry.get("mesh_tpu_serve_queue_depth")
        if depth_gauge is not None:
            for labels, value in depth_gauge._labelled():
                depths[labels.get("tenant", "?")] = value
        self.record("metrics.sample", deltas=deltas, queue_depths=depths)

    # -- consumption ---------------------------------------------------

    def events(self):
        """Ring contents, oldest first."""
        with self._lock:
            return list(self._ring)

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._sample_prev.clear()
            self._last_dump_t = None

    def attach_health(self, monitor):
        """Remember the HealthMonitor whose snapshot() belongs in dumps
        triggered away from the serve layer (executor exceptions, SLO
        breaches without an explicit health= argument)."""
        self._health = monitor

    # -- incident dumps ------------------------------------------------

    def trigger(self, reason, context=None, health=None, force=False):
        """Dump a self-contained incident file; returns its path, or
        None when recording is off, the rate limit holds it back, or the
        dump directory is unwritable (forensics never take serving
        down)."""
        if not recorder_enabled():
            return None
        now = self._clock()
        with self._lock:
            if (not force and self._last_dump_t is not None
                    and now - self._last_dump_t < self._min_dump_interval_s):
                return None
            self._last_dump_t = now
            self._dump_seq += 1
            seq = self._dump_seq
            ring = list(self._ring)
        health = health if health is not None else self._health
        incident = {
            "schema_version": SCHEMA_VERSION,
            "kind": "incident",
            "reason": reason,
            "written_utc": wall(),
            "mono_at_dump": now,
            "context": context or {},
            "ring": ring,
            "metrics": self._registry.snapshot(),
            "health": self._health_snapshot(health),
            "engine": self._engine_summary(),
            "ledger": self._ledger_tail(),
            "knob_history": self._knob_history(),
            "requests": self._requests_tail(),
            "env": {
                k: v for k, v in sorted(os.environ.items())
                if k.startswith(_ENV_PREFIXES)
            },
        }
        return self._write(incident, reason, seq)

    @staticmethod
    def _ledger_tail():
        """The latency ledger's newest request records (schema v2) —
        imported lazily so recorder stays importable standalone (ledger
        never imports recorder back, so no cycle either way)."""
        try:
            from .ledger import get_ledger

            return get_ledger().tail()
        except Exception:
            return []

    @staticmethod
    def _requests_tail():
        """The tail-sampling ring's retained request traces (schema v4)
        — imported lazily like the ledger tail (context never imports
        recorder, so no cycle either way)."""
        try:
            from .context import get_trace_tail

            return get_trace_tail().retained()
        except Exception:
            return []

    @staticmethod
    def _knob_history():
        """The tuning layer's newest knob_change events (schema v3) —
        imported lazily like the ledger tail (tuning never imports
        recorder at module scope, so no cycle either way)."""
        try:
            from ..utils import tuning

            return tuning.history_tail()
        except Exception:
            return []

    @staticmethod
    def _health_snapshot(health):
        if health is None:
            return None
        try:
            return health.snapshot()
        except Exception:
            return None

    @staticmethod
    def _engine_summary():
        """Plan-cache/coalescing summary — only if the engine is already
        imported (an incident dump must never pull in torch)."""
        engine = sys.modules.get("mesh_tpu_torch.engine")
        if engine is None:
            return None
        try:
            return engine.stats()
        except Exception:
            return None

    def _write(self, incident, reason, seq):
        directory = default_incident_dir()
        stamp = "%013d" % int(incident["written_utc"] * 1000)
        safe_reason = "".join(
            c if c.isalnum() or c in "-_" else "_" for c in str(reason)
        )[:48] or "manual"
        name = "incident-%s-%s-%03d.json" % (stamp, safe_reason, seq)
        path = os.path.join(directory, name)
        tmp = path + ".tmp"
        try:
            os.makedirs(directory, exist_ok=True)
            with open(tmp, "w") as fh:
                json.dump(incident, fh, indent=1, default=str)
            os.replace(tmp, path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return None
        self._prune(directory)
        self._registry.counter(
            "mesh_tpu_incident_dumps_total",
            "incident files written by the flight recorder",
        ).inc(reason=reason)
        return path

    @staticmethod
    def _prune(directory):
        keep = _keep_limit()
        paths = list_incidents(directory)
        for stale in paths[:-keep] if len(paths) > keep else []:
            try:
                os.unlink(stale)
            except OSError:
                pass


#: the process-wide recorder every subsystem feeds
RECORDER = FlightRecorder()

# finished spans flow into the ring as soon as obs is imported (the sink
# only fires while MESH_TPU_OBS is on — see Tracer._finish)
TRACER.add_sink(RECORDER.record_span)


def get_recorder():
    """The process-wide FlightRecorder (hot paths call this instead of
    importing RECORDER directly so tests can monkeypatch one place)."""
    return RECORDER
