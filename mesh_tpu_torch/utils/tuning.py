"""Mutable tunable-knob layer (a copy of mesh_tpu/utils/tuning.py): the
ONLY write path the closed-loop controller (obs/controller.py) is allowed
to use.

``utils/knobs.py`` declares the static environment registry; this module
layers a small set of *tunables* on top of it — knobs the controller may
move at runtime, each declared once with bounds, a step size, and the
environment variable that hard-pins it.  The contract:

- **env pins win.**  A tunable whose pin variable is set in the
  environment always reads the pinned value and silently refuses
  actuation — the operator's explicit choice beats the controller.
- **defaults are today's behavior.**  Every tunable's default equals the
  static pre-tuner behavior, and ``MESH_TPU_TUNER=0`` freezes every
  tunable at that default, so the kill switch (and an untouched layer)
  is bit-identical to the static code path.
- **one write path.**  :func:`actuate` clamps to bounds, bumps the
  process-wide generation counter, appends to the bounded knob-change
  history (the flight recorder's incident ``knob_history`` tail), emits
  a ``knob_change`` flight-recorder event with before/after/evidence,
  and moves the ``mesh_tpu_tuner_*`` series.

Readers: the engine executor (``coalesce_window_ms``, ``shard_min_q``),
the routing thresholds of query/autotune.py (``accel_min_faces``,
``mxu_crossover``, ``stream_n_buffers``, between the env pin and the
saved calibration), the animated-mesh refit (``anim_refit_max_inflation``)
and the serving ladder (``serve_pre_trip``, serve/deadline.py).

Stdlib-only; obs is imported lazily inside the actuation path only.
"""

import threading
from collections import OrderedDict, deque

from . import knobs

__all__ = [
    "TunableKnob", "tunables", "lookup", "enabled", "pinned", "get",
    "tuned_value", "generation", "actuate", "history_tail", "status",
    "reset",
]


class TunableKnob(object):
    """One declared runtime-tunable knob."""

    __slots__ = ("name", "kind", "default", "lo", "hi", "step",
                 "pin_env", "pin_means_default", "doc")

    def __init__(self, name, kind, default, lo, hi, step, pin_env, doc,
                 pin_means_default=False):
        self.name = name
        self.kind = kind              # "int" | "float"
        self.default = default
        self.lo = lo
        self.hi = hi
        self.step = step
        self.pin_env = pin_env        # env knob that hard-pins this tunable
        #: True: the pin env var configures something else explicitly
        #: (e.g. a hand-picked serve ladder) — its presence pins the
        #: tunable at the default rather than supplying a value.
        self.pin_means_default = pin_means_default
        self.doc = doc

    def clamp(self, value):
        value = max(self.lo, min(self.hi, value))
        return int(value) if self.kind == "int" else float(value)


#: declaration order is ``status()`` order
_TUNABLES = OrderedDict()

#: guards every piece of mutable tuner state below (declarations run at
#: import, but redeclaration from a reloading test is possible too)
_LOCK = threading.Lock()


def _declare_tunable(name, kind, default, lo, hi, step, pin_env, doc,
                     pin_means_default=False):
    with _LOCK:
        _TUNABLES[name] = TunableKnob(
            name, kind, default, lo, hi, step, pin_env, doc,
            pin_means_default=pin_means_default)
    return name


COALESCE_WINDOW_MS = _declare_tunable(
    "coalesce_window_ms", "float", 0.0, 0.0, 20.0, 1.0,
    "MESH_TPU_COALESCE_WINDOW_MS",
    "Executor drain-loop coalescing window (ms): how long the drain "
    "thread lingers after the first pending request to let a batch "
    "accumulate.  0 (default) drains immediately — the static "
    "behavior.")
ACCEL_MIN_FACES = _declare_tunable(
    "accel_min_faces", "int", None, 4096, 4194304, 32768,
    "MESH_TPU_ACCEL_MIN_FACES",
    "Tuned override for the accel crossover face count "
    "(query/autotune.py consults it between the env pin and the "
    "measured cache); None falls through to the calibrated chain.")
MXU_CROSSOVER = _declare_tunable(
    "mxu_crossover", "int", None, 1024, 4194304, 8192,
    "MESH_TPU_MXU_CROSSOVER_FACES",
    "Tuned override for the MXU dot-product crossover face count "
    "(query/autotune.py consults it between the env pin and the "
    "measured cache; only routes when MESH_TPU_MXU is on); None falls "
    "through to the calibrated chain.")
STREAM_N_BUFFERS = _declare_tunable(
    "stream_n_buffers", "int", None, 2, 8, 1,
    "MESH_TPU_BVH_STREAM_BUFFERS",
    "Tuned override for the streamed-BVH leaf-ring buffer count; None "
    "falls through to the calibrated chain.")
SHARD_MIN_Q = _declare_tunable(
    "shard_min_q", "int", None, 1024, 1048576, 4096,
    "MESH_TPU_FLEET_SHARD_MIN_Q",
    "Query count at which the engine routes a single-mesh closest-point "
    "dispatch through the sharded big-batch lane (also gated by "
    "MESH_TPU_FLEET_SHARD); None (default) keeps the lane off — the "
    "static single-device path.")
ANIM_REFIT_MAX_INFLATION = _declare_tunable(
    "anim_refit_max_inflation", "float", 1.5, 1.05, 4.0, 0.05,
    "MESH_TPU_ANIM_REFIT_MAX_INFLATION",
    "Refit/rebuild crossover for avatar sessions (anim/): the "
    "box-inflation ratio (refit boxes vs the fresh boxes captured at "
    "the last rebuild) past which a frame pays a full host rebuild "
    "through the digest cache.  1.5 (default) tolerates moderate "
    "deformation; lower rebuilds more eagerly (better pruning, more "
    "host work), higher stretches the frozen Morton order further.")
SERVE_PRE_TRIP = _declare_tunable(
    "serve_pre_trip", "int", 0, 0, 1, 1,
    "MESH_TPU_SERVE_LADDER",
    "Latency-mode pre-trip: 1 makes QueryService start requests one "
    "rung down the degradation ladder before health actually degrades "
    "(fast-burn approaching).  Pinned to 0 whenever the operator set "
    "an explicit ladder.", pin_means_default=True)


# -- mutable state (guarded by _LOCK; actuate() is the only writer) --------

_values = {}                  # name -> tuned value
_generation = 0
#: bounded knob-change audit trail; history_tail() slices the incident
#: tail (MESH_TPU_KNOB_TAIL) off the newest end
_HISTORY_CAP = 64
_history = deque(maxlen=_HISTORY_CAP)


def tunables():
    """All declared tunables, in declaration order."""
    return list(_TUNABLES.values())


def lookup(name):
    """The :class:`TunableKnob` for ``name`` (KeyError on undeclared)."""
    try:
        return _TUNABLES[name]
    except KeyError:
        raise KeyError("undeclared tunable %r (declare it in "
                       "mesh_tpu_torch/utils/tuning.py)" % (name,))


def enabled():
    """Tuner kill switch: ``MESH_TPU_TUNER=0`` freezes every tunable at
    its static default."""
    return knobs.flag("MESH_TPU_TUNER")


def pinned(name):
    """True when the tunable's environment pin is set — the operator's
    explicit value beats the controller, which must not actuate it."""
    tun = lookup(name)
    raw = knobs.raw(tun.pin_env)
    return raw is not None and bool(raw.strip())


def _pin_value(tun):
    if tun.pin_means_default:
        return tun.default
    if tun.kind == "int":
        value = knobs.get_int(tun.pin_env)
    else:
        value = knobs.get_float(tun.pin_env)
    return tun.default if value is None else value


def get(name):
    """The effective value: env pin > tuned value (tuner on) > default."""
    tun = lookup(name)
    if pinned(name):
        return _pin_value(tun)
    if not enabled():
        return tun.default
    with _LOCK:
        return _values.get(name, tun.default)


def tuned_value(name):
    """The actuated value only — None when the tuner is off, the knob is
    pinned, or nothing has been actuated (callers fall through to their
    static chain, e.g. autotune's measured cache)."""
    if not enabled() or pinned(name):
        return None
    with _LOCK:
        return _values.get(name)


def generation():
    """Process-wide actuation generation counter (0 = never actuated)."""
    with _LOCK:
        return _generation


def actuate(name, value, reason, evidence=None, action="set", now=None):
    """THE write path for tunable knobs.

    Clamps ``value`` to the declared bounds, bumps the generation
    counter, appends to the bounded history, emits a ``knob_change``
    flight-recorder event, and moves the ``mesh_tpu_tuner_*`` series.
    Returns the event dict, or None when the write was refused (tuner
    off / knob pinned) or a no-op (value unchanged).
    """
    tun = lookup(name)
    if not enabled() or pinned(name):
        return None
    value = tun.clamp(value)
    with _LOCK:
        before = _values.get(name, tun.default)
        if value == before:
            return None
        _values[name] = value
        global _generation
        _generation += 1
        event = {
            "knob": name, "action": action,
            "before": before, "after": value,
            "reason": reason, "generation": _generation,
            "evidence": dict(evidence or {}),
        }
        if now is not None:
            event["t"] = now
        _history.append(dict(event))
        gen = _generation
    _emit(event, gen)
    return event


def _emit(event, gen):
    # recorder + registry moves happen OUTSIDE _LOCK: the tuning lock
    # takes no other lock, so it adds no lock-ordering edges (events carry
    # the generation, so the audit trail stays reconstructible under
    # concurrent actuation)
    from ..obs.recorder import get_recorder
    from ..obs.metrics import REGISTRY

    get_recorder().record("knob_change", **event)
    REGISTRY.counter(
        "mesh_tpu_tuner_changes_total",
        "knob_change actuations by the tuning layer",
    ).inc(knob=event["knob"], action=event["action"])
    REGISTRY.gauge(
        "mesh_tpu_tuner_generation",
        "process-wide tunable-knob actuation generation",
    ).set(gen)
    REGISTRY.gauge(
        "mesh_tpu_tuner_knob_value",
        "current tuned value per tunable knob",
    ).set(event["after"], knob=event["knob"])


def history_tail(k=None):
    """The newest ``k`` knob-change events (incident ``knob_history``
    tail; default ``MESH_TPU_KNOB_TAIL``), oldest first."""
    if k is None:
        k = max(1, knobs.get_int("MESH_TPU_KNOB_TAIL"))
    with _LOCK:
        events = list(_history)
    return [dict(e) for e in events[-k:]]


def status():
    """Per-tunable state (the reference's `mesh-tpu tune status`)."""
    with _LOCK:
        values = dict(_values)
        gen = _generation
    live = enabled()
    rows = []
    for tun in tunables():
        is_pinned = pinned(tun.name)
        if is_pinned:
            value = _pin_value(tun)
        elif live:
            value = values.get(tun.name, tun.default)
        else:
            value = tun.default
        rows.append({
            "knob": tun.name, "value": value, "default": tun.default,
            "lo": tun.lo, "hi": tun.hi, "step": tun.step,
            "pinned": is_pinned, "pin_env": tun.pin_env,
            "tuned": (not is_pinned and live
                      and tun.name in values),
        })
    return {"enabled": live, "generation": gen, "knobs": rows}


def reset():
    """Drop every tuned value and the history (tests, obs.reset())."""
    global _generation
    with _LOCK:
        _values.clear()
        _history.clear()
        _generation = 0
