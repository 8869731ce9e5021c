"""mesh_tpu_torch.obs: the observability modules the animated-mesh session
reaches, copied from mesh_tpu/obs with the same metric, span and record
names.

- ``clock``: the clocks and the ``MESH_TPU_OBS`` span gate;
- ``metrics``: the always-on labeled counter/gauge/histogram ``REGISTRY``;
- ``context``: request identity (``mint``, ``bind_context``) and the
  tail-sampling ring ``TRACE_TAIL``;
- ``trace``: spans (``span``), with ``torch.profiler.record_function``
  and ``torch.cuda.synchronize`` where the reference calls into JAX;
- ``ledger``: the per-request latency ledger (``get_ledger``);
- ``recorder``: the flight recorder's event ring (``get_recorder``).

The rest of the reference's obs (exporters, perf harness, profiler
CLI, replay, windowed series, SLOs, the controller, the JAX bridge) is not
ported (ROADMAP.md, Queue 1).
"""

from .clock import enabled, monotonic, wall  # noqa: F401
from .context import TRACE_TAIL, bind_context, mint  # noqa: F401
from .ledger import LEDGER, get_ledger  # noqa: F401
from .metrics import REGISTRY  # noqa: F401
from .recorder import RECORDER, get_recorder  # noqa: F401
from .trace import TRACER, span  # noqa: F401

__all__ = [
    "enabled", "monotonic", "wall", "TRACE_TAIL", "bind_context", "mint",
    "LEDGER", "get_ledger", "REGISTRY", "RECORDER", "get_recorder", "TRACER",
    "span", "reset",
]


def reset():
    """Zero every metric series and empty the span, flight-recorder,
    latency-ledger and trace-tail rings (tests)."""
    REGISTRY.reset()
    TRACER.clear()
    RECORDER.clear()
    LEDGER.clear()
    TRACE_TAIL.clear()
