"""mesh_tpu_torch.obs: the observability modules, copied from mesh_tpu/obs
with the same metric, span, record and file names.

- ``clock``: the clocks, the pacing ``sleep`` and the ``MESH_TPU_OBS``
  span gate;
- ``metrics``: the always-on labeled counter/gauge/histogram ``REGISTRY``
  (histogram exemplars carry request ids);
- ``context``: request identity (``mint``, ``bind_context``) and the
  tail-sampling ring ``TRACE_TAIL`` with its slow-ok reservoir;
- ``trace``: spans (``span``, ``traced``), with
  ``torch.profiler.record_function`` and CUDA events where the reference
  calls into JAX, and the JSON-lines sink (``configure``, ``jsonl_sink``);
- ``ledger``: the per-request latency ledger (``get_ledger``), its close
  listeners, its tail and dumps, and the thread-bound current record
  (``bind_current``);
- ``recorder``: the flight recorder's event ring and its incident files
  (``get_recorder``, ``list_incidents``);
- ``perf``: the wedge-proof ``call_with_timeout`` and ``reap_child``;
- ``series``: windowed views over the registry (``get_series``);
- ``slo``: objectives, compliance and multi-window burn-rate alerting;
- ``controller``: the closed-loop ``TunerController`` over
  ``utils/tuning.py``;
- ``replay``: trace capture, readers and writers, the admission checksum
  and the adversarial synthesizers.

The rest of the reference's obs (the exporters, the profiler and its CLI,
the staged bench harness and ``perfcheck``, the JAX bridge) is not ported
(ROADMAP.md, Queue 1).
"""

from .clock import enabled, monotonic, wall  # noqa: F401
from .context import (  # noqa: F401
    TRACE_TAIL,
    RequestContext,
    TraceTail,
    bind_context,
    current_context,
    get_trace_tail,
    mint,
    trace_context_enabled,
)
from .ledger import (  # noqa: F401
    LEDGER,
    LEDGER_STAGES,
    LatencyLedger,
    RequestRecord,
    bind_current,
    current_record,
    get_ledger,
    ledger_enabled,
)
from .metrics import (  # noqa: F401
    LATENCY_BUCKETS_S,
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    Registry,
)
from .perf import call_with_timeout, reap_child  # noqa: F401
from .recorder import (  # noqa: F401
    RECORDER,
    FlightRecorder,
    default_incident_dir,
    get_recorder,
    list_incidents,
    recorder_enabled,
)
from .replay import (  # noqa: F401
    TRACE_SCHEMA,
    ReplayError,
    TraceWriter,
    admission_events,
    load_trace,
    null_replay,
    sequence_checksum,
    synthesize,
    trace_from_incident,
    trace_from_ledger,
    write_trace,
)
from .series import (  # noqa: F401
    SERIES,
    SampleRing,
    WindowedSeries,
    get_series,
    quantile_from_cumulative,
)
from .slo import (  # noqa: F401
    SLO,
    BurnRateRule,
    SLOMonitor,
    bind_incident_response,
    compliance,
    default_rules,
    default_slos,
)
from .trace import (  # noqa: F401
    TRACER,
    Tracer,
    configure,
    jsonl_sink,
    span,
    timed_span,
    traced,
)

__all__ = [
    "enabled", "span", "timed_span", "traced", "configure", "jsonl_sink",
    "TRACER", "Tracer",
    "REGISTRY", "Registry", "Counter", "Gauge", "Histogram",
    "LATENCY_BUCKETS_S",
    "counter", "gauge", "histogram", "metrics_snapshot", "reset",
    "RECORDER", "FlightRecorder", "get_recorder", "recorder_enabled",
    "default_incident_dir", "list_incidents",
    "LEDGER", "LEDGER_STAGES", "LatencyLedger", "RequestRecord",
    "get_ledger", "ledger_enabled", "bind_current", "current_record",
    "TRACE_TAIL", "RequestContext", "TraceTail", "bind_context",
    "current_context", "get_trace_tail", "mint", "trace_context_enabled",
    "SERIES", "SampleRing", "WindowedSeries", "get_series",
    "quantile_from_cumulative",
    "SLO", "BurnRateRule", "SLOMonitor", "default_slos", "default_rules",
    "compliance", "bind_incident_response",
    "monotonic", "wall",
    "call_with_timeout", "reap_child",
    "TRACE_SCHEMA", "ReplayError", "TraceWriter", "load_trace",
    "write_trace", "trace_from_ledger", "trace_from_incident",
    "admission_events", "sequence_checksum", "null_replay", "synthesize",
]


def counter(name, help=""):
    """Get-or-create a counter in the process registry."""
    return REGISTRY.counter(name, help)


def gauge(name, help=""):
    return REGISTRY.gauge(name, help)


def histogram(name, help="", buckets=LATENCY_BUCKETS_S):
    return REGISTRY.histogram(name, help, buckets=buckets)


def metrics_snapshot():
    """JSON-able snapshot of every registered metric."""
    return REGISTRY.snapshot()


def reset():
    """Zero every metric series, drop buffered spans, and empty the
    flight-recorder ring, latency-ledger ring, trace tail, windowed-series
    ring and the tuned-knob layer (tests)."""
    from ..utils import tuning

    REGISTRY.reset()
    TRACER.clear()
    RECORDER.clear()
    LEDGER.clear()
    TRACE_TAIL.clear()
    SERIES.clear()
    tuning.reset()
