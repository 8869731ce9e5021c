"""Deadline propagation and the degradation ladder (a copy of
mesh_tpu/serve/deadline.py, with the rungs on the port's routes).

A request enters the serving tier with a deadline.  The ladder is the
set of execution strategies the stack already has, ordered from best to
cheapest:

1. ``engine``   — the coalescing executor + bucketed plan cache
                  (engine.submit): exact, amortized, the steady-state
                  path.  On the card a CUDA-graph plan of the brute-force
                  ``closest_faces`` kernel up to ``crossover_faces()``
                  faces and of the sphere-culled ``culled_faces`` kernel
                  above it; on the CPU their plain versions.
2. ``culled``   — the top-k culled search (query/culled.py
                  ``closest_faces_and_points_culled``, the reference's XLA
                  form in plain PyTorch) called directly, WITHOUT the
                  exact re-run of loose-certificate queries: one bounded
                  dispatch, and the per-query ``tight`` mask tells us
                  whether the answer is still provably exact.
3. ``anchored`` — the vertex-anchored candidate tables
                  (query/anchored.py) with a small K: O(K) per query,
                  the cheapest exact-shaped work we can do.

``run_with_ladder`` walks the rungs with retry + exponential backoff:
each attempt gets a bounded slice of the request's time budget, a
failed or timed-out rung falls through to the next, and the response is
stamped with the rung that answered plus ``certified`` /
``approximate`` flags (a rung whose certificate is not tight for every
query is approximate — under degradation we trade the re-run for
latency, we do not hide it).

The hard budget is ``2 x deadline``: the acceptance bar is a
degraded-but-valid response within twice the deadline, never a hang.
Every in-process rung runs on a watchdog-bounded helper thread, so even
a wedged device dispatch cannot block the serving worker past its budget
— the stuck thread is abandoned (daemonic) and the next rung runs.

Every rung runs on the mesh's own device (``mesh.device``: the card
unless the mesh was built with ``device="cpu"``), resolved to an explicit
card index on the serving worker's thread before the helper thread
starts, so a helper never falls back to its own current device.
"""

import threading

from ..errors import DeadlineExceeded
from ..obs.clock import monotonic
from ..obs.context import bind_context, current_context
from ..obs.ledger import current_record
from ..obs.perf import call_with_timeout
from ..obs.recorder import get_recorder
from ..obs.trace import span as obs_span

__all__ = [
    "Deadline", "Rung", "ServeResult", "default_ladder",
    "effective_start_rung", "run_with_ladder", "call_with_timeout",
]

#: smallest per-attempt time slice: below this a rung cannot even launch
_MIN_SLICE_S = 0.01

#: retry backoff: base * 2^attempt, capped (and clipped to the budget)
_BACKOFF_BASE_S = 0.01
_BACKOFF_CAP_S = 0.25


class Deadline(object):
    """One request's time budget, fixed at admission.

    ``seconds`` is the caller-facing deadline; ``hard_remaining`` tracks
    the 2x envelope inside which a degraded response must still land.
    """

    __slots__ = ("seconds", "t_start", "t_deadline", "t_hard")

    def __init__(self, seconds, hard_factor=2.0):
        self.seconds = float(seconds)
        self.t_start = monotonic()
        self.t_deadline = self.t_start + self.seconds
        self.t_hard = self.t_start + hard_factor * self.seconds

    def remaining(self):
        return self.t_deadline - monotonic()

    def hard_remaining(self):
        return self.t_hard - monotonic()

    def expired(self):
        return self.remaining() <= 0.0

    def elapsed(self):
        return monotonic() - self.t_start


class ServeResult(object):
    """What a rung hands back: facade-convention arrays plus provenance.

    ``backend`` is extra provenance for rungs that dispatch through a
    multi-backend facade (the accel rung reports the traversal's backend,
    ``"rope_resident"`` / ``"rope_stream"`` / their ``_mxu`` forms or
    ``"xla"``); None for single-backend rungs.
    """

    __slots__ = ("faces", "points", "rung", "certified", "backend")

    def __init__(self, faces, points, rung, certified, backend=None):
        self.faces = faces              # [1, Q] uint32
        self.points = points            # [Q, 3] f64
        self.rung = rung
        self.certified = bool(certified)
        self.backend = backend

    @property
    def approximate(self):
        return not self.certified


class Rung(object):
    """One degradation strategy: a name and a callable
    ``fn(mesh, points, chunk, timeout) -> ServeResult`` that must respect
    ``timeout`` (every built-in rung does, via futures or
    call_with_timeout)."""

    __slots__ = ("name", "fn")

    def __init__(self, name, fn):
        self.name = name
        self.fn = fn

    def run(self, mesh, points, chunk, timeout):
        return self.fn(mesh, points, chunk, timeout)


# ---------------------------------------------------------------------------
# built-in rungs


def _mesh_device(mesh):
    """The mesh's device as a ``torch.device`` with an explicit card index
    (the current card of THIS thread where the mesh names none), so a rung's
    helper thread computes where the mesh lives."""
    import torch

    from ..utils.device import resolve_device

    dev = resolve_device(getattr(mesh, "device", None) or "cuda")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _mesh_tensors(mesh, dev):
    """(v float32 [V, 3], f int64 [F, 3]) on ``dev``: the mesh's cached
    device copies where it keeps them on ``dev``, else fresh ones."""
    import numpy as np

    from ..utils.device import as_tensor

    if hasattr(mesh, "device_arrays"):
        vt, ft = mesh.device_arrays()
        if vt.device == dev:
            return vt, ft
    return (as_tensor(np.asarray(mesh.v, np.float32), dev),
            as_tensor(np.asarray(mesh.f, np.int64), dev))


def _on_device(dev):
    """The context that makes ``dev`` current on the calling thread (a
    no-op for the CPU)."""
    import contextlib

    import torch

    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _host_result(res, n_q):
    """The first ``n_q`` rows of each answer tensor, as numpy."""
    return {key: val[:n_q].cpu().numpy() for key, val in res.items()}


def _rung_engine(mesh, points, chunk, timeout):
    """Rung 1: the coalescing executor.  The absolute deadline rides into
    the queue (the worker drops it if it expires pre-dispatch) and a
    timed-out wait cancels the future so a wedged dispatch is not also
    paid for by the next request."""
    import concurrent.futures

    from .. import engine

    fut = engine.submit("closest_point", mesh, points, chunk=chunk,
                        deadline=monotonic() + timeout,
                        record=current_record())
    try:
        faces, pts = fut.result(timeout=timeout)
    except concurrent.futures.TimeoutError:
        fut.cancel()
        raise DeadlineExceeded(
            "engine dispatch exceeded its %.3fs slice" % timeout)
    return ServeResult(faces, pts, "engine", certified=True)


def _rung_culled(mesh, points, chunk, timeout, k=64):
    """Rung 2: one bounded top-k culled dispatch, certificate reported
    instead of repaired."""
    import numpy as np

    from ..utils.device import as_tensor

    dev = _mesh_device(mesh)

    def _call():
        from ..query.culled import closest_faces_and_points_culled

        with _on_device(dev):
            v, f = _mesh_tensors(mesh, dev)
            pts = as_tensor(np.asarray(points, np.float32).reshape(-1, 3),
                            dev)
            res = closest_faces_and_points_culled(
                v, f, pts, k=k, chunk=min(int(chunk), 256))
            return _host_result(res, pts.shape[0])

    out = call_with_timeout(_call, timeout)
    rec = current_record()
    if rec is not None:
        rec.stamp("device")
        rec.set(backend="xla")
    faces = out["face"].astype("uint32")[None, :]
    return ServeResult(faces, out["point"].astype("float64"), "culled",
                       certified=bool(out["tight"].all()))


#: anchored-rung table cache: (v crc, f crc, k, device) -> (table, safe).
#: Tables depend on the posed vertices, so the key hashes both arrays;
#: bounded because degraded traffic should not grow memory without limit.
_ANCHOR_TABLES = {}
_ANCHOR_TABLES_LOCK = threading.Lock()
_ANCHOR_TABLES_MAX = 8


def _anchor_tables(mesh, v, f, k, dev):
    import zlib

    import numpy as np

    v_np = np.ascontiguousarray(np.asarray(mesh.v, np.float32))
    f_np = np.ascontiguousarray(np.asarray(mesh.f, np.int64))
    key = (zlib.crc32(v_np.tobytes()), zlib.crc32(f_np.tobytes()),
           v_np.shape[0], f_np.shape[0], k, str(dev))
    with _ANCHOR_TABLES_LOCK:
        if key in _ANCHOR_TABLES:
            return _ANCHOR_TABLES[key]
    from ..query.anchored import build_anchor_tables

    tables = build_anchor_tables(v, f, k=k, device=dev)
    with _ANCHOR_TABLES_LOCK:
        if len(_ANCHOR_TABLES) >= _ANCHOR_TABLES_MAX:
            _ANCHOR_TABLES.pop(next(iter(_ANCHOR_TABLES)))
        _ANCHOR_TABLES[key] = tables
    return tables


def _rung_anchored(mesh, points, chunk, timeout, k=16):
    """Rung 3: small-K anchored tables — O(K) per query, no certificate
    repair.  The cheapest shaped answer the stack can produce."""
    import numpy as np

    dev = _mesh_device(mesh)

    def _call():
        from ..query.anchored import closest_point_anchored

        with _on_device(dev):
            v, f = _mesh_tensors(mesh, dev)
            table, safe = _anchor_tables(mesh, v, f, min(k, f.shape[0]),
                                         dev)
            pts = np.asarray(points, np.float32).reshape(-1, 3)
            res = closest_point_anchored(v, f, pts, table, safe,
                                         chunk=max(int(chunk), 256),
                                         device=dev)
            return _host_result(res, pts.shape[0])

    out = call_with_timeout(_call, timeout)
    rec = current_record()
    if rec is not None:
        rec.stamp("device")
        rec.set(backend="xla")
    faces = out["face"].astype("uint32")[None, :]
    return ServeResult(faces, out["point"].astype("float64"), "anchored",
                       certified=bool(out["tight"].all()))


def _rung_accel(mesh, points, chunk, timeout):
    """Opt-in rung: one bounded spatial-index dispatch (accel/traverse.py
    ``closest_faces_and_points_accel``: the rope walks on the card), exact
    by its fallback like the engine's full path — pair tests sub-linear in
    F, so it's the rung of choice for scan-scale target meshes.  Not in
    the default ladder (the first request against a new topology pays the
    host-side index build inside its time slice); select it with
    MESH_TPU_SERVE_LADDER, e.g. ``accel,culled,anchored``."""
    import numpy as np

    # captured here because _call runs on the watchdog helper thread,
    # where the serving worker's thread-local bindings (ledger record
    # AND request context) and its current card are invisible
    rec = current_record()
    ctx = current_context()
    dev = _mesh_device(mesh)

    def _call():
        from ..accel.traverse import closest_faces_and_points_accel

        v = np.asarray(mesh.v, np.float32)
        f = np.asarray(mesh.f, np.int64)
        pts = np.asarray(points, np.float32).reshape(-1, 3)
        with _on_device(dev), bind_context(ctx):
            res, stats = closest_faces_and_points_accel(
                v, f, pts, with_stats=True, record=rec, device=dev)
        out = {key: np.asarray(val) for key, val in res.items()}
        out["__backend__"] = stats["backend"]
        return out

    out = call_with_timeout(_call, timeout)
    faces = out["face"].astype("uint32")[None, :]
    # the facade already repaired loose queries through the exact scan, so
    # the answer is exact regardless of how many certificates missed;
    # surface which traversal backend actually served it as provenance
    return ServeResult(faces, out["point"].astype("float64"), "accel",
                       certified=True, backend=out["__backend__"])


def default_ladder():
    """The standard three-rung ladder, optionally filtered/reordered by
    ``MESH_TPU_SERVE_LADDER`` (comma-separated rung names; the opt-in
    ``accel`` rung is selectable here too)."""
    from ..utils import knobs

    rungs = {
        "engine": Rung("engine", _rung_engine),
        "culled": Rung("culled", _rung_culled),
        "anchored": Rung("anchored", _rung_anchored),
        "accel": Rung("accel", _rung_accel),
    }
    spec = knobs.get_str("MESH_TPU_SERVE_LADDER", None) or ""
    if not spec:
        return [rungs["engine"], rungs["culled"], rungs["anchored"]]
    chosen = []
    for name in spec.split(","):
        name = name.strip()
        if not name:
            continue
        if name not in rungs:
            raise ValueError(
                "MESH_TPU_SERVE_LADDER rung %r unknown (have %s)"
                % (name, sorted(rungs)))
        chosen.append(rungs[name])
    if not chosen:
        raise ValueError("MESH_TPU_SERVE_LADDER selected no rungs")
    return chosen


def effective_start_rung(degraded, ladder):
    """Which rung a request starts on: one rung down when serving health
    is degraded — the top rung is the one the watchdog saw wedge — OR
    when the tuner pre-tripped the ladder (utils/tuning.py
    ``serve_pre_trip``: latency mode trading the top rung away while
    fast burn is still only *approaching*); 0 otherwise, and always 0
    on a single-rung ladder."""
    from ..utils import tuning

    if len(ladder) <= 1:
        return 0
    if degraded or tuning.get("serve_pre_trip"):
        return 1
    return 0


# ---------------------------------------------------------------------------
# the retry loop


def _retry_counter():
    from ..obs.metrics import REGISTRY

    return REGISTRY.counter(
        "mesh_tpu_serve_retries_total",
        "Rung attempts that failed or timed out and fell through to the "
        "next degradation rung.",
    )


def run_with_ladder(mesh, points, deadline, ladder=None, chunk=512,
                    start_rung=0, health=None):
    """Walk the degradation ladder under ``deadline``.

    Returns ``(ServeResult, retries)``; raises DeadlineExceeded (carrying
    the last rung error as ``__cause__``) when the hard 2x budget runs
    out or every rung failed.

    Slice policy: while the caller deadline is live each attempt may use
    everything left of it; once past the deadline (degraded territory)
    the remaining hard budget is split evenly across the remaining rungs
    so the LAST rung is never starved by an earlier wedge.
    """
    import time

    if ladder is None:
        ladder = default_ladder()
    rungs = ladder[start_rung:]
    if not rungs:
        raise ValueError("start_rung %d leaves an empty ladder" % start_rung)
    last_error = None
    retries = 0
    for i, rung in enumerate(rungs):
        rungs_left = len(rungs) - i
        hard_left = deadline.hard_remaining()
        if hard_left <= _MIN_SLICE_S and last_error is not None:
            break
        slice_s = max(deadline.remaining(), hard_left / rungs_left)
        slice_s = max(min(slice_s, hard_left), _MIN_SLICE_S)
        # the token MUST close exactly once however the attempt ends —
        # a BaseException (interrupt, watchdog SystemExit) that skipped
        # an ``except Exception`` pairing would leak an in-flight
        # dispatch in the health tracker forever
        token = health.dispatch_began(rung.name) if health else None
        ok = False
        try:
            with obs_span("serve.attempt", rung=rung.name,
                          slice_ms=round(1e3 * slice_s, 1)):
                result = rung.run(mesh, points, chunk, slice_s)
            ok = True
            return result, retries
        except Exception as e:      # noqa: BLE001 — every rung failure falls through
            last_error = e
            retries += 1
            _retry_counter().inc(rung=rung.name,
                                 error=type(e).__name__)
            get_recorder().record("serve.retry", rung=rung.name,
                                  error=type(e).__name__)
        finally:
            if health:
                health.dispatch_finished(token, ok=ok)
        if i + 1 < len(rungs):
            backoff = min(_BACKOFF_BASE_S * (2 ** i), _BACKOFF_CAP_S,
                          max(deadline.hard_remaining(), 0.0) * 0.1)
            if backoff > 0:
                time.sleep(backoff)
    exc = DeadlineExceeded(
        "no rung answered within the hard budget (deadline %.3fs, "
        "elapsed %.3fs, retries %d)"
        % (deadline.seconds, deadline.elapsed(), retries))
    exc.__cause__ = last_error
    exc.rung = rung.name if retries else rungs[0].name
    raise exc
