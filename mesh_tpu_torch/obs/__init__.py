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
- ``export``: JSON-lines dumps (``write_jsonl``, ``export_jsonl``),
  Prometheus text (``prometheus_text``) and the ascii span tree
  (``render_tree``);
- ``prof``: stage breakdowns and regression attribution over ledger
  dumps, serve-stats sinks, incidents and bench records;
- ``perf``: the wedge-proof ``call_with_timeout`` and ``reap_child``, the
  staged bench harness (``StageSpec``, ``run_stages``,
  ``bench_partial.json``) and the ``perfcheck`` regression gate;
- ``torch_bridge``: ``torch.monitor`` events (the kernel build cache's
  hits and misses) folded into the registry; bound here under the
  reference's name ``install_jax_monitoring_bridge``;
- ``series``: windowed views over the registry (``get_series``);
- ``slo``: objectives, compliance and multi-window burn-rate alerting;
- ``controller``: the closed-loop ``TunerController`` over
  ``utils/tuning.py``;
- ``replay``: trace capture, readers and writers, the admission checksum
  and the adversarial synthesizers.

The reference's CLI over these modules is not ported (ROADMAP.md,
Queue 1).
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
from .export import prometheus_text, render_tree, write_jsonl  # noqa: F401
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
from .perf import (  # noqa: F401
    StageResult,
    StageSpec,
    call_with_timeout,
    perfcheck,
    reap_child,
    run_stages,
)
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
from .torch_bridge import install_torch_monitoring_bridge  # noqa: F401
from .trace import (  # noqa: F401
    TRACER,
    Tracer,
    configure,
    jsonl_sink,
    span,
    timed_span,
    traced,
)

#: the reference's name for its monitoring bridge: the port's counts the
#: kernel build cache's hits and misses where the reference counts XLA's
#: compilation cache (obs/torch_bridge.py)
install_jax_monitoring_bridge = install_torch_monitoring_bridge

__all__ = [
    "enabled", "span", "timed_span", "traced", "configure", "jsonl_sink",
    "TRACER", "Tracer",
    "REGISTRY", "Registry", "Counter", "Gauge", "Histogram",
    "LATENCY_BUCKETS_S",
    "counter", "gauge", "histogram", "metrics_snapshot", "reset",
    "prometheus_text", "render_tree", "write_jsonl", "export_jsonl",
    "install_jax_monitoring_bridge", "install_torch_monitoring_bridge",
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
    "StageSpec", "StageResult", "call_with_timeout", "reap_child",
    "run_stages", "perfcheck",
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


#: pull-mode JSON-lines export (spans + final metrics snapshot)
export_jsonl = write_jsonl


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
