"""Closed-loop tuner controller: windowed series + burn rates in,
gated, audited knob actuation out (a copy of mesh_tpu/obs/controller.py).

``TunerController.step()`` is one deterministic evaluation of the
feedback loop — every clock read goes through the injected ``clock``,
so tests drive the whole policy under a fake clock with no sleeps
(``start()`` wraps step() in the same daemon-loop idiom as
``SLOMonitor.start``).  Inputs: the windowed registry view
(obs/series.py percentiles / stage breakdowns) and the SLO monitor's
read-only ``burn_rates()`` poll (obs/slo.py).  Output: exclusively
``utils/tuning.py`` actuations, so every change is bounds-clamped,
generation-stamped, flight-recorded, and countable.

Policies:

- **throughput mode** (fast-burn pressure ≤ ``pressure_low``): widen
  the executor's coalescing window one step at a time, each widen
  opened under a **shadow A/B guard** — the p99 of the hold-out window
  after the change must not regress past ``before * (1 +
  MESH_TPU_TUNER_AB_TOL)`` or the change auto-reverts.  Missing or
  unreadable evidence is never an improvement, so a hold-out with no
  traffic reverts too.
- **latency mode** (pressure ≥ ``pressure_high``): shrink the
  coalescing window and pre-trip the degradation ladder
  (``serve_pre_trip`` → QueryService starts one rung down) before the
  fast-burn rule actually breaches; the pre-trip releases once
  pressure falls back below ``pressure_low``.
- **background retune**: every ``retune_every`` steps, re-publish
  query/autotune.py's persisted calibrations (``retune_hooks()``) into
  the tunable layer so ``accel_min_faces`` / stream buffer counts track
  the live measurement without a process restart.

``MESH_TPU_TUNER=0`` makes step() a no-op and start() refuse to spawn;
a controller that is never started leaves behavior bit-identical to
the static code path.  Stdlib-only.
"""

import threading

from ..utils import knobs, tuning
from .clock import monotonic
from .metrics import REGISTRY
from .recorder import get_recorder
from .series import get_series

__all__ = ["TunerController"]

#: histogram the shadow A/B guard judges hold-out windows on
LATENCY_METRIC = "mesh_tpu_serve_latency_seconds"


class TunerController(object):
    """The feedback loop. Construct with the live series/monitor (or
    fakes), call ``step()`` per evaluation (tests) or ``start()`` for
    the production daemon."""

    def __init__(self, series=None, monitor=None, registry=None,
                 recorder=None, clock=monotonic, ab_tol=None,
                 holdout_s=30.0, pressure_high=0.5, pressure_low=0.1,
                 latency_metric=LATENCY_METRIC, retune_fns=None,
                 retune_every=8, coordinator=None):
        self._series = series if series is not None else get_series()
        self._monitor = monitor
        # optional fleet arbitration (the reference's fleet coordinator,
        # or any object with grant_widen()): widens ask grant_widen()
        # first so N replicas don't all widen into the same fast burn
        self._coordinator = coordinator
        self._registry = registry if registry is not None else REGISTRY
        self._recorder = recorder
        self._clock = clock
        self._ab_tol = ab_tol          # None: re-read the knob per step
        self.holdout_s = float(holdout_s)
        self.pressure_high = float(pressure_high)
        self.pressure_low = float(pressure_low)
        self.latency_metric = latency_metric
        self._retune_fns = dict(retune_fns) if retune_fns else {}
        self.retune_every = int(retune_every)
        self._guard = None             # pending shadow A/B hold-out
        self._steps = 0
        self._lock = threading.Lock()  # guards _guard/_steps (step vs CLI)
        self._thread = None
        self._stop = threading.Event()

    # -- inputs --------------------------------------------------------

    def _tol(self):
        if self._ab_tol is not None:
            return float(self._ab_tol)
        return knobs.get_float("MESH_TPU_TUNER_AB_TOL")

    def _recorder_ref(self):
        return self._recorder if self._recorder is not None \
            else get_recorder()

    def pressure(self, now=None):
        """Worst fast-burn pressure (burn / rule factor) across every
        objective+tenant: 1.0 means breaching right now, 0.0 means idle
        or no monitor wired."""
        if self._monitor is None:
            return 0.0
        rows = self._monitor.burn_rates(now=now)
        fast = [r["pressure"] for r in rows if r["rule"] == "fast_burn"]
        if not fast:
            fast = [r["pressure"] for r in rows]
        return max(fast) if fast else 0.0

    # -- the loop ------------------------------------------------------

    def step(self, now=None):
        """One evaluation: settle any due A/B guard, pick the mode from
        fast-burn pressure, actuate, maybe retune.  Returns a summary
        dict ({"mode": "disabled"} when MESH_TPU_TUNER=0 — nothing is
        read, nothing moves)."""
        if not tuning.enabled():
            return {"mode": "disabled", "actions": []}
        now = self._clock() if now is None else float(now)
        actions = []
        with self._lock:
            guard = self._guard
            if guard is not None and now >= guard["deadline_t"]:
                self._guard = None
            else:
                guard = None
            self._steps += 1
            steps = self._steps
        if guard is not None:
            self._settle_guard(guard, now, actions)
        pressure = self.pressure(now)
        if pressure >= self.pressure_high:
            mode = "latency"
            self._latency_mode(now, pressure, actions)
        else:
            mode = "throughput"
            self._throughput_mode(now, pressure, actions)
        if self._retune_fns and steps % self.retune_every == 0:
            self._retune(now, actions)
        self._registry.counter(
            "mesh_tpu_tuner_evaluations_total",
            "controller step() evaluations by mode",
        ).inc(mode=mode)
        return {"mode": mode, "pressure": pressure, "t": now,
                "actions": actions}

    # -- policies ------------------------------------------------------

    def _latency_mode(self, now, pressure, actions):
        """Fast burn approaching: claw back coalescing latency and start
        requests one rung down the ladder before health degrades."""
        tun = tuning.lookup("coalesce_window_ms")
        cur = tuning.get("coalesce_window_ms")
        if cur > tun.lo:
            event = tuning.actuate(
                "coalesce_window_ms", cur - tun.step,
                reason="latency_mode: fast-burn pressure %.2f" % pressure,
                evidence={"pressure": pressure}, now=now)
            if event:
                actions.append(event)
                with self._lock:
                    # a shrink supersedes any pending widen hold-out
                    if (self._guard is not None and
                            self._guard["knob"] == "coalesce_window_ms"):
                        self._guard = None
        if tuning.get("serve_pre_trip") != 1:
            event = tuning.actuate(
                "serve_pre_trip", 1,
                reason="latency_mode: pre-trip degradation ladder",
                evidence={"pressure": pressure}, now=now)
            if event:
                actions.append(event)

    def _throughput_mode(self, now, pressure, actions):
        """Burn is low: release any pre-trip, then trade a step of
        latency for batching — under a shadow A/B hold-out."""
        if pressure <= self.pressure_low and \
                tuning.get("serve_pre_trip") == 1:
            event = tuning.actuate(
                "serve_pre_trip", 0,
                reason="throughput_mode: release pre-trip",
                evidence={"pressure": pressure}, now=now)
            if event:
                actions.append(event)
        with self._lock:
            guard_open = self._guard is not None
        if guard_open or pressure > self.pressure_low:
            return
        tun = tuning.lookup("coalesce_window_ms")
        cur = tuning.get("coalesce_window_ms")
        if cur >= tun.hi or tuning.pinned("coalesce_window_ms"):
            return
        before_p99 = self._series.percentile(
            self.latency_metric, 0.99, window_s=self.holdout_s, now=now)
        if before_p99 is None:
            return     # no traffic: nothing to optimize, don't churn
        if self._coordinator is not None and \
                not self._coordinator.grant_widen(now=now):
            return     # fleet arbitration: another replica holds the slot
        event = tuning.actuate(
            "coalesce_window_ms", cur + tun.step,
            reason="throughput_mode: widen coalescing "
                   "(pressure %.2f)" % pressure,
            evidence={"pressure": pressure, "before_p99_s": before_p99},
            now=now)
        if event:
            actions.append(event)
            with self._lock:
                self._guard = {
                    "knob": "coalesce_window_ms",
                    "revert_to": cur, "applied": event["after"],
                    "pivot_t": now, "deadline_t": now + self.holdout_s,
                    "before_p99_s": before_p99,
                }

    def _settle_guard(self, guard, now, actions):
        """Judge a due hold-out window: stale/missing evidence must never
        read as an improvement, so an unreadable after-window reverts.

        The caller has already popped the guard, so this is the only
        chance to revert: the actuation sits in a ``finally`` so a
        recorder or registry that raises mid-verdict can never leave an
        unconfirmed knob value applied with no hold-out watching it.
        """
        after_p99 = self._series.window_percentile(
            self.latency_metric, 0.99, guard["pivot_t"], now)
        before_p99 = guard["before_p99_s"]
        tol = self._tol()
        confirmed = (after_p99 is not None and before_p99 is not None
                     and after_p99 <= before_p99 * (1.0 + tol))
        verdict = "confirmed" if confirmed else "reverted"
        evidence = {
            "before_p99_s": before_p99, "after_p99_s": after_p99,
            "tol": tol, "holdout_s": now - guard["pivot_t"],
        }
        try:
            self._recorder_ref().record(
                "knob_ab", knob=guard["knob"], verdict=verdict,
                **evidence)
            self._registry.counter(
                "mesh_tpu_tuner_ab_total",
                "shadow A/B hold-out verdicts",
            ).inc(knob=guard["knob"], verdict=verdict)
        finally:
            if not confirmed:
                event = tuning.actuate(
                    guard["knob"], guard["revert_to"],
                    reason="ab_guard: hold-out %s" % (
                        "regressed past tolerance"
                        if after_p99 is not None
                        and before_p99 is not None
                        else "evidence missing"),
                    evidence=evidence, action="revert", now=now)
                if event:
                    actions.append(event)

    def _retune(self, now, actions):
        """Re-publish autotune's persisted calibrations into the
        tunable layer (query/autotune.py retune_hooks)."""
        for name, fn in self._retune_fns.items():
            try:
                result = fn()
            except Exception:
                continue       # retune must never break the loop
            if result is None:
                continue
            value, evidence = result
            event = tuning.actuate(
                name, value, reason="retune: autotune calibration",
                evidence=evidence, now=now)
            if event:
                actions.append(event)

    # -- background loop (tests drive step() directly) -----------------

    def start(self, interval_s=None):
        """Spawn the daemon evaluation loop (interval defaults to
        ``MESH_TPU_TUNER_INTERVAL``); no-op with the tuner killed."""
        if not tuning.enabled() or self._thread is not None:
            return self
        if interval_s is None:
            interval_s = knobs.get_float("MESH_TPU_TUNER_INTERVAL")
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.step()
                except Exception:
                    pass       # tuning must never break serving

        self._thread = threading.Thread(
            target=loop, name="mesh-tpu-tuner", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
