"""Avatar stream sessions: per-client dynamic-mesh serving state
(counterpart of mesh_tpu/anim/session.py).

A session pins everything that is invariant across an avatar's frames:
topology digest, faces (on the device once), keyframe vertices, the base
BVH, the :class:`~mesh_tpu_torch.anim.refit.RefitState` and, on its first
queried frame, the fleet routing key.  The per-frame work is exactly:
apply the vertex update, refit the frozen-layout BVH (or trip a rebuild
past the inflation bound), and run the exact rope walk.  Vertices may be
numpy arrays or tensors: a body posed on the card stays there through the
refit and the walk.

Each frame carries one ledger record (``op="anim_frame"``, tenant =
session id) stamped ``queue`` -> ``refit`` -> ``device``.  Deadline-missed
frames close ``deadline`` and count
``mesh_tpu_anim_frame_deadline_miss_total``; a non-draining ``stop()``
closes in-flight frames ``cancelled``, so the ledger leaks nothing.

Kill switch: ``MESH_TPU_ANIM=0`` makes every frame rebuild cold through
the digest-keyed ``get_index`` (no refit stage, no refit arrays).

A session can also start from a store key (``AvatarSession(digest=...)``):
the keyframe opens through the mesh store at its exact tier, and the
frames of a stored sequence come back through ``store.deltas``
(``resolve_frame``) as absolute vertices.
"""

import itertools
import threading

import numpy as np
import torch

from ..accel.build import get_index, topology_digest
from ..accel.traverse import closest_faces_and_points_accel
from ..errors import MeshError
from ..fleet.router import routing_key
from ..obs.clock import monotonic
from ..obs.context import bind_context, mint as mint_context
from ..obs.ledger import get_ledger
from ..obs.metrics import REGISTRY
from ..obs.recorder import get_recorder
from ..obs.trace import span as obs_span
from ..utils import knobs
from ..utils.device import as_tensor, host_array, resolve_device
from .refit import RefitState

__all__ = ["AvatarSession", "SessionClosed"]

_SESSION_SEQ = itertools.count(1)


class SessionClosed(MeshError):
    """The avatar session was stopped; frames are no longer accepted."""


def _metrics():
    return {
        "sessions": REGISTRY.gauge(
            "mesh_tpu_anim_sessions",
            "Open avatar stream sessions."),
        "frames": REGISTRY.counter(
            "mesh_tpu_anim_frames_total",
            "Session frames served (label: action — refit / "
            "rebuild / cold)."),
        "miss": REGISTRY.counter(
            "mesh_tpu_anim_frame_deadline_miss_total",
            "Session frames that finished after their per-frame "
            "deadline (label: tenant)."),
    }


class AvatarSession(object):
    """One client's animated-mesh stream over a fixed topology.

    Construct from a keyframe mesh (``AvatarSession(mesh)``, anything with
    ``v`` [V, 3] and ``f`` [F, 3]) or a store key
    (``AvatarSession(digest=...)``: the keyframe opens through ``store``,
    default ``get_store()``, at its exact tier).  Per frame,
    :meth:`frame` accepts a vertex *delta* against the keyframe or
    absolute vertices, plus an optional query batch, and returns the
    result dict with ``action`` (``refit`` / ``rebuild`` / ``cold``) and
    timing.  Thread-safe; frames of one session serialize on the session
    lock (streams are ordered).

    :param leaf_size: the BVH's faces per leaf (default ``build_bvh``'s 8).
        The rope walk needs leaves of its ``tile_f`` (256 resident), so an
        index of another leaf size is rebuilt at ``tile_f`` on every
        queried frame, as in the reference; pass ``leaf_size=256`` to walk
        the refit index itself.
    :param kernel: the refit's leaf-box route, ``"pallas"`` (default: the
        ``leaf_boxes`` kernel on ``device``) or ``"host"`` (refit.py).
    :param device: where the refit and the walk run (default the card).
    """

    def __init__(self, mesh=None, digest=None, store=None, session_id=None,
                 leaf_size=None, kernel="pallas", device="cuda"):
        if mesh is None and digest is None:
            raise ValueError("AvatarSession needs a keyframe mesh "
                             "or a store digest")
        self.device = resolve_device(device)
        if mesh is None:
            from ..store import get_store

            stored = (store or get_store()).open(digest, tier="exact")
            # copies: the exact tier comes back as read-only store blocks
            v_key = np.array(stored.v, np.float32)
            faces = np.array(stored.f, np.int32)
        else:
            v_key = np.asarray(mesh.v, np.float32)
            faces = np.asarray(mesh.f, np.int32)
            digest = topology_digest(v_key, faces)
        self.digest = digest
        self.v_key = v_key
        self.f = faces
        self._f_dev = as_tensor(faces.astype(np.int64), self.device)
        self._v_key_dev = None        # the keyframe on the device, on demand
        self.session_id = session_id or ("avatar-%d" % next(_SESSION_SEQ))
        self.leaf_size = leaf_size
        base = get_index(v_key, faces, kind="bvh", **self._params())
        self.refit_state = RefitState(base, faces, kernel=kernel,
                                      device=self.device)
        self.routing_key = None       # pinned on the first queried frame
        self._cond = threading.Condition()
        self._closed = False
        self._held = 0
        self._frame_seq = itertools.count()
        self._inflight = {}           # frame no -> RequestRecord
        self.frames = 0
        self.deadline_misses = 0
        _metrics()["sessions"].inc(1)
        get_recorder().record("anim.session_open", session=self.session_id,
                              digest=self.digest,
                              n_faces=int(faces.shape[0]))

    def _params(self):
        return ({} if self.leaf_size is None
                else {"leaf_size": int(self.leaf_size)})

    # -- per-frame ----------------------------------------------------

    def _vertices(self, delta, vertices):
        """The frame's vertices: numpy for numpy input, a float32 tensor
        on the session's device for tensor input."""
        if (delta is None) == (vertices is None):
            raise ValueError("frame() wants exactly one of delta= / "
                             "vertices=")
        given = delta if delta is not None else vertices
        if tuple(given.shape) != self.v_key.shape:
            raise ValueError("%s shape %s != keyframe %s" % (
                "delta" if delta is not None else "vertices",
                tuple(given.shape), self.v_key.shape))
        if torch.is_tensor(given):
            given = as_tensor(given, self.device, torch.float32)
            if delta is None:
                return given
            if self._v_key_dev is None:
                self._v_key_dev = as_tensor(self.v_key, self.device)
            return self._v_key_dev + given
        given = np.asarray(given, np.float32)
        return given if delta is None else self.v_key + given

    def frame(self, delta=None, vertices=None, points=None,
              deadline_s=None):
        """Serve one animation frame: apply the vertex update, refit
        (or rebuild, or, with the anim kill switch, cold-build) the index,
        and answer the optional query batch exactly.

        Returns a dict: ``frame``, ``action``, ``index``, ``inflation``,
        ``latency_s``, ``deadline_missed`` and, when ``points`` (array or
        tensor [Q, 3]) were given, the facade-convention ``faces`` /
        ``points`` / ``sqdist`` numpy arrays."""
        with self._cond:
            if self._closed:
                raise SessionClosed("session %s is stopped"
                                    % self.session_id)
            frame_no = next(self._frame_seq)
            ctx = mint_context(self.session_id, frame_no, monotonic(),
                               routing_key=self.routing_key,
                               session_id=self.session_id)
            rec = get_ledger().open(
                tenant=self.session_id, op="anim_frame", frame=frame_no,
                digest=self.digest,
                deadline_s=(None if deadline_s is None
                            else float(deadline_s)),
                **(ctx.to_meta() if ctx is not None else {}))
            if rec is not None:
                rec.ctx = ctx
                self._inflight[frame_no] = rec
        t0 = monotonic()
        out = {"frame": frame_no, "action": None, "inflation": None}
        try:
            with bind_context(ctx), \
                    obs_span("anim.frame", session=self.session_id,
                             frame=frame_no) as sp:
                if ctx is not None:
                    ctx.root_span_id = getattr(sp, "span_id", None)
                v_new = self._vertices(delta, vertices)
                if rec is not None:
                    rec.stamp("queue")
                if not knobs.flag("MESH_TPU_ANIM"):
                    # kill switch: a cold digest-keyed build, no refit
                    # arrays, no refit ledger stage
                    index = get_index(host_array(v_new, np.float32), self.f,
                                      kind="bvh", **self._params())
                    action = "cold"
                else:
                    index, action = self.refit_state.advance(v_new)
                    if rec is not None:
                        rec.stamp("refit")
                    out["inflation"] = self.refit_state.inflation
                out["action"] = action
                out["index"] = index
                _metrics()["frames"].inc(action=action)
                if points is not None:
                    res = closest_faces_and_points_accel(
                        v_new, self._f_dev, points, index=index, record=rec,
                        device=self.device)
                    out.update(faces=res["face"], points=res["point"],
                               sqdist=res["sqdist"])
                    if self.routing_key is None:
                        self.routing_key = routing_key(
                            "anim_frame", self.digest, points)
        except SessionClosed:
            raise
        except Exception as e:          # noqa: BLE001 — outcome must close
            self._finish(frame_no, rec, "error", error=type(e).__name__)
            raise
        latency = monotonic() - t0
        out["latency_s"] = latency
        missed = deadline_s is not None and latency > float(deadline_s)
        out["deadline_missed"] = missed
        if missed:
            self.deadline_misses += 1
            _metrics()["miss"].inc(tenant=self.session_id)
        self._finish(frame_no, rec, "deadline" if missed else "ok")
        self.frames += 1
        return out

    def _finish(self, frame_no, rec, outcome, **meta):
        # the in-flight entry is popped by whoever closes the record —
        # this frame on the serve path, stop(drain=False) on teardown —
        # so a record is closed exactly once
        with self._cond:
            while self._held and not self._closed:
                self._cond.wait()
            if rec is not None:
                rec = self._inflight.pop(frame_no, None)
            if rec is None:
                return
        get_ledger().close(rec, outcome=outcome, **meta)

    # -- fences (tests) ------------------------------------------------

    def hold(self):
        """Fence frame finalization: frames compute but park before
        closing their ledger record until :meth:`release` (lets tests
        stop() a session with a deterministically in-flight frame)."""
        with self._cond:
            self._held += 1

    def release(self):
        with self._cond:
            self._held = max(0, self._held - 1)
            self._cond.notify_all()

    # -- lifecycle -----------------------------------------------------

    def stats(self):
        s = self.refit_state.stats()
        s.update(session=self.session_id, digest=self.digest,
                 frames=self.frames,
                 deadline_misses=self.deadline_misses,
                 routing_key=self.routing_key)
        return s

    def stop(self, drain=True):
        """End the session.  ``drain=True`` waits for in-flight frames
        to finish; ``drain=False`` (client gone) closes any in-flight
        frame's ledger record with outcome ``cancelled`` immediately —
        nothing leaks open."""
        with self._cond:
            if self._closed:
                return
            self._closed = True
            if drain:
                while self._inflight and not self._held:
                    self._cond.wait(timeout=0.1)
            pending = list(self._inflight.items())
            self._inflight.clear()
            self._cond.notify_all()
        ledger = get_ledger()
        for _frame_no, rec in pending:
            ledger.close(rec, outcome="cancelled")
        _metrics()["sessions"].inc(-1)
        get_recorder().record("anim.session_close", session=self.session_id,
                              frames=self.frames,
                              cancelled=len(pending))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False
