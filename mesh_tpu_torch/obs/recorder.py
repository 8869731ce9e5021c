"""Always-on flight recorder: a bounded ring of recent events (the
recording half of mesh_tpu/obs/recorder.py).

The recorder keeps the last few thousand interesting events (the avatar
sessions' open and close, the query engine's dispatches and errors) in a
fixed-size in-memory ring, always on: one env read plus one locked deque
append per event.  ``MESH_TPU_RECORDER=0`` disables recording;
``MESH_TPU_RECORDER_EVENTS`` sizes the ring (default 2048).

``trigger`` freezes an incident (its reason and context, the ring, and a
metrics-registry snapshot) into a bounded in-memory list (``incidents()``,
the newest ``INCIDENTS_KEPT``); the query engine's executor calls it when
its worker dies.  The reference writes each incident as a JSON file under
``MESH_TPU_INCIDENT_DIR`` with the ledger tail and the environment, at
most one a rate-limit interval; the files, the rate limit, its periodic
metric samples and its span sink are not ported (ROADMAP.md, Queue 1).
"""

import threading
from collections import deque

from ..utils import knobs
from .clock import monotonic

__all__ = [
    "FlightRecorder", "RECORDER", "get_recorder", "recorder_enabled",
    "RECORDER_ENV", "EVENTS_ENV", "INCIDENTS_KEPT",
]

#: kill switch: set to 0/false/no/off to disable all recording
RECORDER_ENV = "MESH_TPU_RECORDER"

#: ring capacity for the process-wide recorder (default 2048 events)
EVENTS_ENV = "MESH_TPU_RECORDER_EVENTS"

#: incidents ``trigger`` keeps in memory (oldest dropped first)
INCIDENTS_KEPT = 16


def recorder_enabled():
    """True unless MESH_TPU_RECORDER explicitly turns recording off
    (unset means ON — the recorder is the always-on black box)."""
    return knobs.flag(RECORDER_ENV)


def _ring_capacity():
    return max(16, knobs.get_int(EVENTS_ENV))


class FlightRecorder(object):
    """Bounded ring of recent events.  ``record()`` is the hot-path entry:
    one enabled() env read, one dict build, one locked deque append."""

    def __init__(self, capacity=None, clock=monotonic):
        self._ring = deque(maxlen=capacity or _ring_capacity())
        self._incidents = deque(maxlen=INCIDENTS_KEPT)
        self._lock = threading.Lock()
        self._clock = clock

    def record(self, kind, **fields):
        """Append one event to the ring; a no-op when
        MESH_TPU_RECORDER is off."""
        if not recorder_enabled():
            return
        fields["kind"] = kind
        fields["t"] = self._clock()
        with self._lock:
            self._ring.append(fields)

    def events(self):
        """Ring contents, oldest first."""
        with self._lock:
            return list(self._ring)

    def clear(self):
        with self._lock:
            self._ring.clear()
            self._incidents.clear()

    def trigger(self, reason, context=None):
        """Freeze an incident: ``reason``, ``context``, the ring and a
        metrics snapshot, kept in ``incidents()``.  Returns the incident,
        or None when recording is off."""
        if not recorder_enabled():
            return None
        from .metrics import REGISTRY

        with self._lock:
            incident = {"kind": "incident", "reason": reason,
                        "t": self._clock(), "context": dict(context or {}),
                        "ring": list(self._ring),
                        "metrics": REGISTRY.snapshot()}
            self._incidents.append(incident)
        return incident

    def incidents(self):
        """Incidents frozen by ``trigger``, oldest first."""
        with self._lock:
            return list(self._incidents)


#: the process-wide recorder every subsystem feeds
RECORDER = FlightRecorder()


def get_recorder():
    """The process-wide FlightRecorder (hot paths call this instead of
    importing RECORDER directly so tests can monkeypatch one place)."""
    return RECORDER
