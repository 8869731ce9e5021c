"""Load generation for the serving tier (a copy of
mesh_tpu/serve/loadgen.py; the reference's bench.py --serve-load drives it).

Four generator shapes, because they answer different questions:

- **closed loop** (``run_closed_loop``): N client threads, each issuing
  the next request the moment the previous one answers.  Concurrency is
  fixed, arrival rate adapts to service speed — this measures the
  service's best sustainable latency under a known load.
- **open loop** (``run_open_loop``): submissions paced at a target rate
  regardless of completions (async submit, collect at the end).  Arrival
  rate is fixed, concurrency floats — this exposes queueing collapse and
  shed behavior that a closed loop structurally cannot (a closed loop
  slows its own arrivals when the service slows; real traffic does not).
- **trace replay** (``run_trace_replay``): submissions paced by a
  recorded trace (obs/replay.py) — the exact admission sequence of a
  captured incident or a synthesized adversarial mix, inter-arrival gaps
  and tenant/deadline/priority spread included, optionally time-warped
  by ``speed``.  The report carries a deterministic admission-sequence
  checksum, so "same trace twice ⇒ same sequence" is machine-checkable.
- **periodic** (``run_periodic``): N avatar-stream sessions each
  submitting at a fixed frame rate (30–60 Hz) with a hard per-frame
  deadline (default: the frame budget, ``1/hz``).  Arrivals are
  phase-staggered and deadline-hard — a frame that misses its budget is
  *lost*, not late — so the headline number is ``frame_miss_rate``, the
  animation-serving acceptance metric.

All three return one JSON-able report: latency percentiles over
*successful* responses, goodput (ok responses per *paced* second — the
window requests were issued in; future-collection wait is reported
separately as ``wall_s``), shed rate (rejected + shed / issued),
deadline-miss rate, and per-rung answer counts — the serving acceptance
numbers, straight off the wire.

Pacing loops take an injectable ``clock``/``sleep`` pair (defaulting to
the obs/clock aliases) so open-loop and replay runs are fake-clock
deterministic in tests, the same discipline the SLO and tuner tests use.
"""

import threading

from ..errors import DeadlineExceeded, ServeRejected
from ..obs.clock import monotonic, sleep as _sleep

__all__ = ["percentile", "run_closed_loop", "run_open_loop",
           "run_periodic", "run_trace_replay"]


def percentile(values, q):
    """Linearly-interpolated percentile (q in [0, 100]); 0.0 on empty
    input.  Matches numpy's default ("linear") method: rank
    (n-1)·q/100 interpolated between the bracketing order statistics —
    nearest-rank would make p99 of fewer than 100 samples degenerate to
    the max, overstating tail latency on short load runs."""
    import math

    if not values:
        return 0.0
    ordered = sorted(values)
    if len(ordered) == 1:
        return ordered[0]
    rank = (len(ordered) - 1) * q / 100.0
    lo = int(math.floor(rank))
    hi = min(lo + 1, len(ordered) - 1)
    frac = rank - lo
    return ordered[lo] + (ordered[hi] - ordered[lo]) * frac


class _Tally(object):
    """Thread-shared outcome accumulator for one load run."""

    def __init__(self):
        self.lock = threading.Lock()
        self.latencies_s = []           # successful responses only
        self.ok = 0
        self.shed = 0                   # ServeRejected at admission
        self.deadline = 0               # DeadlineExceeded end to end
        self.errors = 0
        self.misses = 0                 # ok but past the deadline
        self.approximate = 0
        self.retries = 0
        self.rungs = {}
        self.failed_rungs = {}          # last rung attempted on deadline

    def record_response(self, response):
        with self.lock:
            self.ok += 1
            self.latencies_s.append(response.latency_s)
            self.rungs[response.rung] = self.rungs.get(response.rung, 0) + 1
            self.retries += response.retries
            if response.deadline_missed:
                self.misses += 1
            if response.approximate:
                self.approximate += 1

    def record_error(self, error):
        with self.lock:
            if isinstance(error, ServeRejected):
                self.shed += 1
            elif isinstance(error, DeadlineExceeded):
                self.deadline += 1
                rung = getattr(error, "rung", None)
                if rung:
                    self.failed_rungs[rung] = \
                        self.failed_rungs.get(rung, 0) + 1
            else:
                self.errors += 1

    def report(self, paced_s, wall_s=None):
        """``paced_s`` is the submission window (arrivals were paced over
        it — the goodput denominator); ``wall_s`` additionally includes
        the post-pacing future-collection wait.  Folding collection wait
        into the goodput denominator deflated open-loop goodput_qps by
        however long the slowest straggler took to answer."""
        if wall_s is None:
            wall_s = paced_s
        with self.lock:
            issued = (self.ok + self.shed + self.deadline + self.errors)
            lat = list(self.latencies_s)
            report = {
                "requests": issued,
                "ok": self.ok,
                "shed": self.shed,
                "deadline_failures": self.deadline,
                "errors": self.errors,
                "paced_s": round(paced_s, 4),
                "wall_s": round(wall_s, 4),
                "goodput_qps": round(self.ok / paced_s, 2)
                if paced_s else 0.0,
                "shed_rate": round(self.shed / issued, 4) if issued else 0.0,
                "deadline_miss_rate": round(
                    (self.misses + self.deadline) / issued, 4)
                if issued else 0.0,
                "approximate": self.approximate,
                "retries": self.retries,
                "rungs": dict(self.rungs),
                "failed_rungs": dict(self.failed_rungs),
                "p50_ms": round(1e3 * percentile(lat, 50), 3),
                "p95_ms": round(1e3 * percentile(lat, 95), 3),
                "p99_ms": round(1e3 * percentile(lat, 99), 3),
            }
            return report


def run_closed_loop(service, mesh, points, clients=4, requests_per_client=32,
                    tenant_fn=None, deadline_s=None):
    """``clients`` threads, each issuing ``requests_per_client``
    back-to-back sync queries.  ``tenant_fn(client_idx)`` names the
    tenant (default: one tenant per client)."""
    if tenant_fn is None:
        def tenant_fn(i):
            return "client-%d" % i
    tally = _Tally()

    def _client(idx):
        tenant = tenant_fn(idx)
        for _ in range(requests_per_client):
            try:
                response = service.query(mesh, points, tenant=tenant,
                                         deadline_s=deadline_s)
                tally.record_response(response)
            except Exception as e:      # noqa: BLE001 — tallied, not raised
                tally.record_error(e)

    t0 = monotonic()
    threads = [
        threading.Thread(target=_client, args=(i,),
                         name="mesh-tpu-loadgen-%d" % i, daemon=True)
        for i in range(clients)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    report = tally.report(monotonic() - t0)
    report["loop"] = "closed"
    report["clients"] = clients
    return report


def run_open_loop(service, mesh, points, rate_qps=50.0, duration_s=2.0,
                  tenant="open-loop", deadline_s=None, collect_timeout_s=30.0,
                  clock=None, sleep=None):
    """Paced async submissions at ``rate_qps`` for ``duration_s``; futures
    are collected afterwards so slow service never slows arrivals.  Pass
    a fake ``clock``/``sleep`` pair for deterministic pacing in tests."""
    clock = monotonic if clock is None else clock
    sleep = _sleep if sleep is None else sleep
    interval = 1.0 / float(rate_qps)
    tally = _Tally()
    futures = []
    t0 = clock()
    t_next = t0
    while t_next - t0 < duration_s:
        wait = t_next - clock()
        if wait > 0:
            sleep(wait)
        try:
            futures.append(service.submit(mesh, points, tenant=tenant,
                                          deadline_s=deadline_s))
        except Exception as e:          # noqa: BLE001 — tallied, not raised
            tally.record_error(e)
        t_next += interval
    paced_s = clock() - t0
    for fut in futures:
        try:
            tally.record_response(fut.result(timeout=collect_timeout_s))
        except Exception as e:          # noqa: BLE001 — tallied, not raised
            tally.record_error(e)
    report = tally.report(paced_s, wall_s=clock() - t0)
    report["loop"] = "open"
    report["rate_qps"] = float(rate_qps)
    return report


def run_periodic(service, mesh, points, sessions=4, hz=30.0,
                 frames_per_session=30, deadline_s=None, tenant_fn=None,
                 priority=0, collect_timeout_s=30.0, clock=None,
                 sleep=None):
    """Deadline-hard periodic arrivals: ``sessions`` avatar streams,
    each submitting one frame every ``1/hz`` seconds with a hard
    per-frame deadline (default: exactly the frame budget ``1/hz``).

    Sessions are phase-staggered across one frame interval (session
    ``i`` starts at ``i/(sessions*hz)``), so a frame tick never lands
    every stream on the queue at once — the arrival process real
    multi-avatar traffic presents.  Arrivals are open-loop: a slow
    service cannot slow the frame clock, it can only miss deadlines.
    The report adds ``frame_miss_rate`` (deadline failures + late
    responses, over frames issued) — the animation acceptance number —
    plus the pacing parameters.  Fake ``clock``/``sleep`` make it
    deterministic in tests, like the other paced loops."""
    clock = monotonic if clock is None else clock
    sleep = _sleep if sleep is None else sleep
    hz = float(hz)
    if hz <= 0:
        raise ValueError("hz must be > 0 (got %s)" % hz)
    interval = 1.0 / hz
    if deadline_s is None:
        deadline_s = interval
    if tenant_fn is None:
        def tenant_fn(i):
            return "avatar-%d" % i
    # merged (offset, tenant) schedule, one entry per frame
    schedule = sorted(
        (s * interval / max(sessions, 1) + k * interval, tenant_fn(s))
        for s in range(sessions) for k in range(frames_per_session))
    tally = _Tally()
    futures = []
    t0 = clock()
    for offset, tenant in schedule:
        wait = t0 + offset - clock()
        if wait > 0:
            sleep(wait)
        try:
            futures.append(service.submit(mesh, points, tenant=tenant,
                                          priority=priority,
                                          deadline_s=deadline_s))
        except Exception as e:          # noqa: BLE001 — tallied, not raised
            tally.record_error(e)
    paced_s = clock() - t0
    for fut in futures:
        try:
            tally.record_response(fut.result(timeout=collect_timeout_s))
        except Exception as e:          # noqa: BLE001 — tallied, not raised
            tally.record_error(e)
    report = tally.report(paced_s, wall_s=clock() - t0)
    report["loop"] = "periodic"
    report["sessions"] = int(sessions)
    report["hz"] = hz
    report["frames_per_session"] = int(frames_per_session)
    # deadline-hard framing: a shed, errored, expired, or late frame is
    # a LOST frame — only on-time ok responses render
    with tally.lock:
        lost = tally.shed + tally.errors + tally.deadline + tally.misses
    issued = report["requests"]
    report["frame_miss_rate"] = round(lost / issued, 4) if issued else 0.0
    return report


def run_trace_replay(service, mesh, points, trace, speed=1.0,
                     deadline_s=None, collect_timeout_s=30.0,
                     clock=None, sleep=None):
    """Open-loop replay of a recorded trace: every record is submitted at
    its captured admit offset (divided by ``speed``) with its captured
    tenant/priority/deadline, so the admission sequence — inter-arrival
    gaps, tenant mix, deadline spread — is the trace's, not a synthetic
    rate's.

    ``trace`` is a dict from ``obs.replay.load_trace`` (or any
    synthesizer).  ``mesh`` is the target for every request; a record's
    captured ``store_key`` takes precedence when ``mesh`` is None, so an
    incident trace replays against the store artifacts it named.
    ``deadline_s`` overrides every record's captured deadline (that IS a
    different workload, and the checksum says so); ``speed`` repaces the
    same sequence and leaves the checksum unchanged.

    The report is the standard loadgen report plus ``admissions`` and
    ``checksum`` — the canonical admission-sequence hash from
    ``obs.replay.sequence_checksum``, equal across runs of the same
    trace (and equal to the null replay's, service or no service).
    """
    from ..obs.metrics import REGISTRY
    from ..obs.replay import ReplayError, admission_events, \
        sequence_checksum

    if speed <= 0:
        raise ReplayError("replay speed must be > 0 (got %s)" % speed)
    clock = monotonic if clock is None else clock
    sleep = _sleep if sleep is None else sleep
    m_requests = REGISTRY.counter(
        "mesh_tpu_replay_requests_total",
        "trace-replay admissions by tenant and trace source")
    m_lag = REGISTRY.histogram(
        "mesh_tpu_replay_lag_seconds",
        "how far behind its trace offset each replayed admission ran")
    events = admission_events(trace, deadline_s=deadline_s)
    source = trace.get("source", "unknown")
    tally = _Tally()
    futures = []
    t0 = clock()
    for rec in trace["records"]:
        target = t0 + float(rec["t"]) / speed
        wait = target - clock()
        if wait > 0:
            sleep(wait)
        m_requests.inc(tenant=rec.get("tenant", "default"), source=source)
        m_lag.observe(max(clock() - target, 0.0))
        target_mesh = mesh if mesh is not None else rec.get("store_key")
        deadline = deadline_s if deadline_s is not None \
            else rec.get("deadline_s")
        try:
            futures.append(service.submit(
                target_mesh, points,
                tenant=rec.get("tenant", "default"),
                priority=int(rec.get("priority") or 0),
                deadline_s=deadline))
        except Exception as e:          # noqa: BLE001 — tallied, not raised
            tally.record_error(e)
    paced_s = clock() - t0
    for fut in futures:
        try:
            tally.record_response(fut.result(timeout=collect_timeout_s))
        except Exception as e:          # noqa: BLE001 — tallied, not raised
            tally.record_error(e)
    report = tally.report(paced_s, wall_s=clock() - t0)
    report["loop"] = "replay"
    report["source"] = source
    report["speed"] = float(speed)
    report["admissions"] = len(events)
    report["checksum"] = sequence_checksum(events)
    # fleet target (duck-typed): a FleetRouter also reports which
    # replica each admission landed on, as per-replica checksums — same
    # trace + same membership must reproduce them (the fleet golden
    # pins this)
    if hasattr(service, "admission_checksums"):
        report["replica_checksums"] = service.admission_checksums()
    return report
