"""Runtime-tunable knobs, the subset of mesh_tpu/utils/tuning.py that the
port reads: the query engine's coalescing window and sharded-lane
threshold (``coalesce_window_ms``, ``shard_min_q``) and the animated-mesh
refit's crossover (``anim_refit_max_inflation``).

A tunable is declared once with its default, bounds, step and the
environment variable that hard-pins it.  ``get`` reads the pin when it is
set and the default otherwise.  The reference's closed-loop controller,
which may move a tunable at run time (``actuate``, the change history and
``MESH_TPU_TUNER``), is not ported (ROADMAP.md, Queue 1), so
nothing here changes a value.
"""

from collections import OrderedDict

from . import knobs

__all__ = ["TunableKnob", "tunables", "lookup", "pinned", "get"]


class TunableKnob(object):
    """One declared runtime-tunable knob."""

    __slots__ = ("name", "kind", "default", "lo", "hi", "step", "pin_env",
                 "doc")

    def __init__(self, name, kind, default, lo, hi, step, pin_env, doc):
        self.name = name
        self.kind = kind              # "int" | "float"
        self.default = default
        self.lo = lo
        self.hi = hi
        self.step = step
        self.pin_env = pin_env        # env knob that hard-pins this tunable
        self.doc = doc


_TUNABLES = OrderedDict()


def _declare_tunable(name, kind, default, lo, hi, step, pin_env, doc):
    _TUNABLES[name] = TunableKnob(name, kind, default, lo, hi, step, pin_env,
                                  doc)
    return name


COALESCE_WINDOW_MS = _declare_tunable(
    "coalesce_window_ms", "float", 0.0, 0.0, 20.0, 1.0,
    "MESH_TPU_COALESCE_WINDOW_MS",
    "Executor drain-loop coalescing window (ms): how long the drain "
    "thread lingers after the first pending request to let a batch "
    "accumulate.  0 (default) drains immediately.")
SHARD_MIN_Q = _declare_tunable(
    "shard_min_q", "int", None, 1024, 1048576, 4096,
    "MESH_TPU_FLEET_SHARD_MIN_Q",
    "Query count at which the engine routes a single-mesh closest-point "
    "dispatch through the sharded big-batch lane (also gated by "
    "MESH_TPU_FLEET_SHARD); None (default) keeps the lane off.")
ANIM_REFIT_MAX_INFLATION = _declare_tunable(
    "anim_refit_max_inflation", "float", 1.5, 1.05, 4.0, 0.05,
    "MESH_TPU_ANIM_REFIT_MAX_INFLATION",
    "Refit/rebuild crossover for avatar sessions (anim/): the "
    "box-inflation ratio (refit boxes vs the fresh boxes captured at "
    "the last rebuild) past which a frame pays a full host rebuild "
    "through the digest cache.  1.5 (default) tolerates moderate "
    "deformation; lower rebuilds more eagerly (better pruning, more "
    "host work), higher stretches the frozen Morton order further.")


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


def pinned(name):
    """True when the tunable's environment pin is set."""
    raw = knobs.raw(lookup(name).pin_env)
    return raw is not None and bool(raw.strip())


def get(name):
    """The effective value: the env pin when set (a malformed pin reads
    as the default, as in the reference), else the default."""
    tun = lookup(name)
    if not pinned(name):
        return tun.default
    if tun.kind == "int":
        value = knobs.get_int(tun.pin_env)
    else:
        value = knobs.get_float(tun.pin_env)
    return tun.default if value is None else value
