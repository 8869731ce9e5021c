"""mesh_tpu_torch.serve: async, multi-tenant, deadline-aware query serving
(counterpart of mesh_tpu/serve).

The engine (mesh_tpu/engine/) makes one stream of queries fast; this
package makes MANY streams safe to run against it:

- **service** — ``QueryService``: tenant/priority/deadline-tagged
  admission with bounded per-tenant queues (reject-with-retry-after, no
  unbounded growth), weighted-fair (deficit round-robin) draining into
  the engine;
- **deadline** — ``Deadline`` propagation and the degradation ladder:
  engine -> top-k culled -> anchored-K (and the opt-in accel rung),
  retry with exponential backoff,
  every answer certified exact or stamped ``approximate=True``, hard
  2x-deadline budget, wedge-proof attempt threads;
- **health** — ``HealthMonitor``: a non-blocking dispatch-latency
  watchdog driving the load-shed state machine
  healthy -> degraded -> draining (liveness/readiness for probes);
- **loadgen** — closed-, open-, periodic-, and replay-loop load
  generation reporting p50/p95/p99, goodput, shed rate, deadline-miss
  rate, and (periodic) the deadline-hard frame-miss rate.

Everything records into the obs registry (``serve.*`` span names,
``mesh_tpu_serve_*`` series, the reference's names) and the latency
ledger; ``QueryService.write_stats()`` leaves a JSON sink behind.

Start a service over a port ``Mesh`` on the card (or one built with
``device="cpu"``; the mesh's device is where every rung runs)::

    from mesh_tpu_torch import Mesh
    from mesh_tpu_torch.serve import QueryService

    service = QueryService(workers=2)
    service.warmup(mesh)
    response = service.query(mesh, points, tenant="a", deadline_s=0.5)
    service.stop(write_stats=False)
"""

from ..errors import (  # noqa: F401 — the serve-boundary exception surface
    DeadlineExceeded,
    EngineShutdown,
    ServeRejected,
)
from .deadline import (  # noqa: F401
    Deadline,
    Rung,
    ServeResult,
    call_with_timeout,
    default_ladder,
    run_with_ladder,
)
from .health import (  # noqa: F401
    DEGRADED,
    DRAINING,
    HEALTHY,
    STATE_NAMES,
    HealthMonitor,
)
from .loadgen import (  # noqa: F401
    percentile,
    run_closed_loop,
    run_open_loop,
    run_periodic,
    run_trace_replay,
)
from .service import (  # noqa: F401
    QueryService,
    ServeResponse,
    WeightedFairQueue,
    default_stats_path,
)

__all__ = [
    "QueryService", "ServeResponse", "WeightedFairQueue",
    "default_stats_path",
    "Deadline", "Rung", "ServeResult", "call_with_timeout",
    "default_ladder", "run_with_ladder",
    "HealthMonitor", "HEALTHY", "DEGRADED", "DRAINING", "STATE_NAMES",
    "percentile", "run_closed_loop", "run_open_loop", "run_periodic",
    "run_trace_replay",
    "ServeRejected", "DeadlineExceeded", "EngineShutdown",
]
