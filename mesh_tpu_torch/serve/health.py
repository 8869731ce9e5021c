"""Serving-tier health: a non-blocking, in-process wedged-device watchdog
(a copy of mesh_tpu/serve/health.py).

A serving loop cannot afford to fork a probe and wait on every request, so
this module gets the wedge signal from data the service already produces:
every rung attempt registers with ``dispatch_began``/``dispatch_finished``,
and a daemon watchdog thread checks whether any in-flight dispatch has
been running longer than the wedge threshold — WITHOUT ever touching the
device itself, so the check can never hang.

State machine (the load-shed ladder the service keys off):

    HEALTHY  --[wedge trip / slow or failed dispatch]-->  DEGRADED
    DEGRADED --[``recover_after`` consecutive fast successes]--> HEALTHY
    DEGRADED --[``drain_after`` consecutive trips]-->  DRAINING
    any      --[begin_drain()]-->  DRAINING (graceful shutdown)

- HEALTHY: requests start at the top ladder rung.
- DEGRADED: the service skips the wedged top rung (requests start one
  rung down) and sheds negative-priority traffic.
- DRAINING: admission rejects everything with retry-after; queued work
  finishes.  Terminal until ``reset()``.

``live()`` is process liveness (the watchdog itself is running);
``ready()`` is "admission is open" (not DRAINING).  Both are cheap
enough for a kubelet-style poll loop.

Knobs: ``MESH_TPU_SERVE_WEDGE_S`` (in-flight seconds before a dispatch
counts as wedged, default 5.0).
"""

import itertools
import threading

from ..obs.clock import monotonic
from ..utils import knobs

__all__ = ["HEALTHY", "DEGRADED", "DRAINING", "STATE_NAMES", "HealthMonitor"]

HEALTHY, DEGRADED, DRAINING = 0, 1, 2
STATE_NAMES = {HEALTHY: "healthy", DEGRADED: "degraded",
               DRAINING: "draining"}

_DEFAULT_WEDGE_S = 5.0


def _wedge_threshold():
    return knobs.get_float("MESH_TPU_SERVE_WEDGE_S", _DEFAULT_WEDGE_S)


class HealthMonitor(object):
    """Dispatch-latency watchdog driving the load-shed state machine."""

    def __init__(self, wedge_after_s=None, recover_after=2, drain_after=5,
                 watchdog=True, clock=monotonic, recorder=None):
        self.wedge_after_s = (
            _wedge_threshold() if wedge_after_s is None
            else float(wedge_after_s))
        self.recover_after = int(recover_after)
        self.drain_after = int(drain_after)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = HEALTHY
        self._inflight = {}             # token -> (rung name, t_start)
        self._tokens = itertools.count(1)
        self._success_streak = 0
        self._trip_streak = 0
        self._trips_total = 0
        self._recorder = recorder
        self._stop = threading.Event()
        self._gauge().set(HEALTHY)
        self._watchdog = None
        if watchdog:
            self._watchdog = threading.Thread(
                target=self._watch, name="mesh-tpu-serve-watchdog",
                daemon=True)
            self._watchdog.start()

    # ------------------------------------------------------------------
    # metrics

    def _gauge(self):
        from ..obs.metrics import REGISTRY

        return REGISTRY.gauge(
            "mesh_tpu_serve_health_state",
            "Load-shed state: 0 healthy, 1 degraded, 2 draining.",
        )

    def _trips(self):
        from ..obs.metrics import REGISTRY

        return REGISTRY.counter(
            "mesh_tpu_serve_watchdog_trips_total",
            "Watchdog wedge detections (in-flight dispatch past the "
            "threshold, or a failed/slow rung attempt).",
        )

    # ------------------------------------------------------------------
    # dispatch bookkeeping (called by the service / run_with_ladder)

    def dispatch_began(self, name):
        token = next(self._tokens)
        with self._lock:
            self._inflight[token] = (name, self._clock())
        return token

    def dispatch_finished(self, token, ok=True):
        now = self._clock()
        with self._lock:
            entry = self._inflight.pop(token, None)
        elapsed = None if entry is None else now - entry[1]
        if not ok or (elapsed is not None
                      and elapsed >= self.wedge_after_s):
            self.trip("dispatch_failed" if not ok else "dispatch_slow")
            return
        with self._lock:
            self._success_streak += 1
            self._trip_streak = 0
            if (self._state == DEGRADED
                    and self._success_streak >= self.recover_after):
                self._set_state_locked(HEALTHY)

    def trip(self, reason):
        """One wedge signal: HEALTHY -> DEGRADED, and persistent trips
        escalate DEGRADED -> DRAINING."""
        self._trips().inc(reason=reason)
        with self._lock:
            self._success_streak = 0
            self._trip_streak += 1
            self._trips_total += 1
            if self._state != DRAINING:
                if self._trip_streak >= self.drain_after:
                    self._set_state_locked(DRAINING)
                elif self._state == HEALTHY:
                    self._set_state_locked(DEGRADED)
        # forensics OUTSIDE the lock: trigger() calls snapshot(), which
        # takes it again
        recorder = self._recorder
        if recorder is None:
            from ..obs.recorder import get_recorder

            recorder = get_recorder()
        recorder.record("health.trip", reason=reason,
                        state=STATE_NAMES[self.state])
        recorder.trigger("watchdog_trip", context={"reason": reason},
                         health=self)

    # ------------------------------------------------------------------
    # watchdog

    def check_now(self):
        """One watchdog pass (the thread calls this; tests can too).
        Returns the tokens that look wedged right now."""
        now = self._clock()
        with self._lock:
            wedged = [
                token for token, (_name, t0) in self._inflight.items()
                if now - t0 >= self.wedge_after_s
            ]
            # forget them so one stuck dispatch trips once, not once per
            # watchdog tick forever
            for token in wedged:
                self._inflight.pop(token, None)
        for _ in wedged:
            self.trip("dispatch_wedged")
        return wedged

    def _watch(self):
        interval = max(min(0.25, self.wedge_after_s / 4.0), 0.01)
        while not self._stop.wait(timeout=interval):
            self.check_now()

    def stop(self):
        self._stop.set()

    # ------------------------------------------------------------------
    # state surface

    def _set_state_locked(self, state):
        self._state = state
        self._gauge().set(state)

    @property
    def state(self):
        with self._lock:
            return self._state

    @property
    def state_name(self):
        return STATE_NAMES[self.state]

    def live(self):
        """Process-liveness: the watchdog (when enabled) is still
        running.  A poll-style monitor (watchdog=False) is always live."""
        if self._watchdog is None:
            return not self._stop.is_set()
        return self._watchdog.is_alive()

    def ready(self):
        """Admission is open: anything but DRAINING (degraded service
        still answers, just one rung down)."""
        return self.state != DRAINING

    def begin_drain(self):
        with self._lock:
            self._set_state_locked(DRAINING)

    def reset(self):
        with self._lock:
            self._success_streak = 0
            self._trip_streak = 0
            self._inflight.clear()
            self._set_state_locked(HEALTHY)

    def snapshot(self):
        with self._lock:
            return {
                "state": STATE_NAMES[self._state],
                "inflight": len(self._inflight),
                "success_streak": self._success_streak,
                "trip_streak": self._trip_streak,
                "trips": self._trips_total,
                "wedge_after_s": self.wedge_after_s,
            }
