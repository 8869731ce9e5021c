"""The observability subsystem's clocks and its env gate (a copy of
mesh_tpu/obs/clock.py).

Every span, ledger stamp, session latency and pacing sleep goes through
these aliases, so a swap to a different clock (or a test fake) is a
one-line change.

``enabled()`` is the master gate: ``MESH_TPU_OBS`` unset/''/'0'/'false'
/'no'/'off' means OFF (the knob registry's truthiness, re-read per call so
tests can toggle it), and OFF means spans are no-ops.
"""

import time

from ..utils.knobs import flag as _knob_flag

__all__ = ["monotonic", "wall", "sleep", "enabled", "env_flag", "OBS_ENV"]

#: the observability master gate (spans; metrics counters stay always-on
#: because the engine's pre-existing stats contract depends on them)
OBS_ENV = "MESH_TPU_OBS"

#: monotonic high-resolution clock for durations
monotonic = time.perf_counter

#: wall clock for event timestamps (exporters)
wall = time.time

#: pacing sleep (loadgen/replay); aliased here so fake-clock tests swap
#: clock and sleep as one pair instead of patching ``time`` piecemeal
sleep = time.sleep


def env_flag(name):
    """The knob registry's flag truthiness (utils/knobs.py)."""
    return _knob_flag(name)


def enabled():
    """True when MESH_TPU_OBS turns span tracing on (read per call)."""
    return env_flag(OBS_ENV)
