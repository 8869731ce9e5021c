"""mesh_tpu_torch's avatar sessions and the obs / fleet / tuning pieces they
reach, vs mesh_tpu's, on the CPU.

The session behaviours of tests/test_anim.py (refit and exact answers,
exclusive vertex inputs, the kill switch, teardown without drain, deadline
misses) run on ``device="cpu"``; frames fed to both packages give the same
refit/rebuild actions and inflations (to 1e-12 relative) and answers with
sqdist within 1e-5 and faces equal except at ties (test_torch_anim).  The
copied obs modules keep the reference's metric names and help strings, and
the routing key is the reference's for the same inputs.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import mesh_tpu
from mesh_tpu import errors as jerrors
from mesh_tpu.anim import AvatarSession as JaxSession
from mesh_tpu.fleet import router as jrouter
from mesh_tpu.obs.metrics import REGISTRY as JREGISTRY
from mesh_tpu.utils import tuning as jtuning

import mesh_tpu_torch
from mesh_tpu_torch import errors as terrors
from mesh_tpu_torch import obs
from mesh_tpu_torch.accel import build as tbuild
from mesh_tpu_torch.accel.traverse import closest_faces_and_points_accel
from mesh_tpu_torch.anim import AvatarSession, SessionClosed
from mesh_tpu_torch.fleet import router as trouter
from mesh_tpu_torch.obs import context, ledger, recorder, trace
from mesh_tpu_torch.obs.metrics import REGISTRY
from mesh_tpu_torch.utils import tuning

from .test_torch_anim import assert_tie_answers, deform, sphere
from .test_torch_culled import surface_queries

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_state():
    tbuild.clear_index_cache()
    obs.reset()
    yield
    tbuild.clear_index_cache()


def _mesh(v, f):
    return mesh_tpu_torch.Mesh(v, f, device="cpu")


def _rows(session_id):
    return [r for r in obs.get_ledger().records()
            if r.get("tenant") == session_id]


# -- sessions ----------------------------------------------------------------

@pytest.mark.parametrize("leaf_size", [None, 256])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_frame_refits_and_answers_like_the_reference(leaf_size, as_tensor):
    """Frames through both packages' sessions: same actions and
    inflations, answers under the tie contract, one ledger row per frame
    stamped queue -> refit -> device."""
    v, f = sphere()
    frames = [deform(v, 11), deform(v, 12, amp=0.08),
              np.asarray(v * 20.0, np.float32)]
    mine = AvatarSession(_mesh(v, f), leaf_size=leaf_size, kernel="pallas",
                         device="cpu")
    ref = JaxSession(mesh_tpu.Mesh(v=v, f=f), leaf_size=leaf_size)
    with mine, ref:
        for k, frame in enumerate(frames):
            pts = surface_queries(frame, f, 200, seed=13 + k)
            out = mine.frame(vertices=torch.from_numpy(frame)
                             if as_tensor else frame,
                             points=torch.from_numpy(pts)
                             if as_tensor else pts)
            want = ref.frame(vertices=frame, points=pts)
            assert out["action"] == want["action"]
            assert out["inflation"] == pytest.approx(want["inflation"],
                                                     rel=1e-12)
            assert_tie_answers(
                {"face": want["faces"], "point": want["points"],
                 "sqdist": want["sqdist"], "part": np.zeros(len(pts))},
                {"face": out["faces"], "point": out["points"],
                 "sqdist": out["sqdist"], "part": np.zeros(len(pts))},
                frame, f, pts)
            assert out["frame"] == k and not out["deadline_missed"]
        assert [mine.stats()[k] for k in ("refits", "rebuilds", "frames")] \
            == [ref.stats()[k] for k in ("refits", "rebuilds", "frames")]
        assert mine.stats()["rebuilds"] == 1
        assert mine.digest == ref.digest
        assert mine.routing_key == ref.routing_key == (
            "anim_frame|%s|256" % mine.digest)
    rows = _rows(mine.session_id)
    assert len(rows) == len(frames)
    for row in rows:
        assert row["outcome"] == "ok" and row["op"] == "anim_frame"
        assert list(row["stages"]) == ["queue", "refit", "device", "respond"]
        assert row["backend"] == "rope_resident"
        assert row["request_id"].startswith("req-")


def test_delta_and_vertices_are_exclusive():
    v, f = sphere(1)
    with AvatarSession(_mesh(v, f), device="cpu") as sess:
        with pytest.raises(ValueError, match="exactly one"):
            sess.frame()
        with pytest.raises(ValueError, match="exactly one"):
            sess.frame(delta=np.zeros_like(v), vertices=v)
        with pytest.raises(ValueError, match="shape"):
            sess.frame(delta=np.zeros((3, 3), np.float32))
        with pytest.raises(ValueError, match="shape"):
            sess.frame(vertices=torch.zeros((3, 3)))
        d = deform(v, 3) - v
        pts = surface_queries(v, f, 64, seed=3)
        outs = [sess.frame(delta=d, points=pts),
                sess.frame(delta=torch.from_numpy(d), points=pts),
                sess.frame(vertices=v + d, points=pts)]
        for out in outs[1:]:
            assert out["action"] == outs[0]["action"] == "refit"
            np.testing.assert_array_equal(out["faces"], outs[0]["faces"])
            np.testing.assert_array_equal(out["sqdist"], outs[0]["sqdist"])
    rows = _rows(sess.session_id)
    assert [r["outcome"] for r in rows] == ["error"] * 4 + ["ok"] * 3


def test_kill_switch_serves_cold_frames(monkeypatch):
    monkeypatch.setenv("MESH_TPU_ANIM", "0")
    v, f = sphere()
    pts = surface_queries(v, f, 100, seed=14)
    with AvatarSession(_mesh(v, f), leaf_size=256, device="cpu") as sess:
        v2 = deform(v, 13)
        out = sess.frame(vertices=v2, points=pts)
        assert out["action"] == "cold" and out["inflation"] is None
        fresh = tbuild.get_index(v2, f, kind="bvh", leaf_size=256)
        assert out["index"] is fresh
        ref = closest_faces_and_points_accel(v2, f, pts, index=fresh,
                                             device="cpu")
        np.testing.assert_array_equal(out["sqdist"], ref["sqdist"])
        np.testing.assert_array_equal(out["faces"], ref["face"])
        assert sess.refit_state.refits == sess.refit_state.rebuilds == 0
    row = _rows(sess.session_id)[-1]
    assert "refit" not in row["stages"]
    assert REGISTRY.get("mesh_tpu_anim_frames_total").value(
        action="cold") == 1


def test_stop_without_drain_closes_ledger_record_cancelled():
    v, f = sphere(1)
    sess = AvatarSession(_mesh(v, f), session_id="anim-stop-no-drain",
                         device="cpu")
    sess.hold()             # park the frame before its record closes
    done = threading.Event()

    def run():
        sess.frame(vertices=deform(v, 17),
                   points=surface_queries(v, f, 8, seed=17))
        done.set()

    t = threading.Thread(target=run)
    t.start()
    for _ in range(2000):
        if sess._inflight:
            break
        t.join(0.005)
    assert sess._inflight, "frame never reached the hold fence"
    sess.stop(drain=False)
    t.join(10.0)
    assert not t.is_alive() and done.is_set()
    rows = _rows("anim-stop-no-drain")
    assert len(rows) == 1 and rows[0]["outcome"] == "cancelled"
    with pytest.raises(SessionClosed):
        sess.frame(vertices=v)
    assert REGISTRY.get("mesh_tpu_anim_sessions").value() == 0
    kinds = [e["kind"] for e in obs.get_recorder().events()]
    assert kinds == ["anim.session_open", "anim.session_close"]


def test_deadline_miss_counts_and_closes_deadline():
    v, f = sphere(1)
    with AvatarSession(_mesh(v, f), device="cpu") as sess:
        out = sess.frame(vertices=deform(v, 19),
                         points=surface_queries(v, f, 8, seed=19),
                         deadline_s=1e-9)
        assert out["deadline_missed"] and sess.deadline_misses == 1
        row = _rows(sess.session_id)[-1]
        assert row["outcome"] == "deadline" and row["deadline_s"] == 1e-9
    assert REGISTRY.get("mesh_tpu_anim_frame_deadline_miss_total").value(
        tenant=sess.session_id) == 1


def test_trace_tail_keeps_the_missed_frame_with_its_spans(monkeypatch):
    """Under MESH_TPU_OBS the tail keeps a deadline-missed frame's ledger
    row with its span tree (the frame's root span, the traversal under it
    and, under the traversal, the ``accel.build`` of the leaf-256 index the
    rope walk rebuilds for a leaf-8 session, as the reference's get_index
    spans it) and, with the slow-ok reservoir off, drops an on-time
    frame's spans."""
    monkeypatch.setenv("MESH_TPU_OBS", "1")
    monkeypatch.setenv("MESH_TPU_TRACE_RESERVOIR", "0")
    v, f = sphere(1)
    pts = surface_queries(v, f, 8, seed=24)
    with AvatarSession(_mesh(v, f), device="cpu") as sess:
        sess.frame(vertices=deform(v, 24), points=pts)
        sess.frame(vertices=deform(v, 25), points=pts, deadline_s=1e-9)
    kept = obs.TRACE_TAIL.retained()
    rows = _rows(sess.session_id)
    assert [e["request_id"] for e in kept] == [rows[1]["request_id"]]
    assert kept[0]["outcome"] == "deadline" and kept[0]["row"] == rows[1]
    spans = {e["name"]: e for e in kept[0]["spans"]}
    assert set(spans) == {"anim.frame", "accel.traverse", "accel.build"}
    assert spans["accel.traverse"]["parent_id"] == \
        spans["anim.frame"]["span_id"]
    assert spans["accel.build"]["parent_id"] == \
        spans["accel.traverse"]["span_id"]


def test_default_session_refits_through_the_leaf_box_wrapper(monkeypatch):
    """A session built with no ``kernel=`` takes the leaf-box wrapper's
    route (the CUDA kernel for a tensor on the card, its plain version
    here); ``kernel="host"`` is the numpy twin, asked for by name."""
    from mesh_tpu_torch.anim import refit as trefit

    calls = []

    def spy(tri_s, n_leaves, leaf_size):
        calls.append((tri_s.device.type, int(n_leaves), int(leaf_size)))
        return real(tri_s, n_leaves, leaf_size)

    real = trefit.leaf_boxes_kernel
    monkeypatch.setattr(trefit, "leaf_boxes_kernel", spy)
    v, f = sphere(1)
    with AvatarSession(_mesh(v, f), device="cpu") as sess:
        assert sess.refit_state.kernel == "pallas"
        out = sess.frame(vertices=deform(v, 23))
        assert out["action"] == "refit"
        n_leaves = int(sess.refit_state.index.meta["n_leaves"])
    assert calls == [("cpu", n_leaves, 8)]
    with AvatarSession(_mesh(v, f), kernel="host", device="cpu") as sess:
        assert sess.frame(vertices=deform(v, 23))["action"] == "refit"
    assert len(calls) == 1


# -- the accel traversal's record, span and counter --------------------------

def test_accel_traversal_stamps_record_span_and_pair_tests(monkeypatch):
    monkeypatch.setenv("MESH_TPU_OBS", "1")
    v, f = sphere()
    pts = surface_queries(v, f, 100, seed=20)
    rec = obs.get_ledger().open(tenant="t", op="closest")
    out, stats = closest_faces_and_points_accel(v, f, pts, with_stats=True,
                                                record=rec, device="cpu")
    assert "device" in rec.stamps and rec.meta["backend"] == "rope_resident"
    assert REGISTRY.get("mesh_tpu_accel_pair_tests_total").value(
        kind="bvh") == stats["pair_tests"] > 0
    spans = [e for e in obs.TRACER.events() if e["name"] == "accel.traverse"]
    assert len(spans) == 1
    assert spans[0]["attrs"] == {"kind": "bvh", "faces": f.shape[0],
                                 "queries": 100, "backend": "rope_resident",
                                 "pair_tests": stats["pair_tests"],
                                 "fallback": 0}


# -- obs ---------------------------------------------------------------------

def test_metric_names_and_help_match_reference():
    """Every series the port's session path registers exists in
    mesh_tpu's registry, after the same frame there, with the same type
    and help.  An instrument an earlier test of the process registered,
    and this test's frames left without a series (the fixture emptied
    them all), is not the session path's."""
    earlier = set(REGISTRY.snapshot())
    v, f = sphere(1)
    pts = surface_queries(v, f, 32, seed=21)
    stretched = np.asarray(v * 20.0, np.float32)
    for session in (AvatarSession(_mesh(v, f), device="cpu"),
                    JaxSession(mesh_tpu.Mesh(v=v, f=f))):
        with session:
            session.frame(vertices=deform(v, 21), points=pts)
            session.frame(vertices=stretched, points=pts, deadline_s=1e-9)
    mine = REGISTRY.snapshot()
    theirs = JREGISTRY.snapshot()
    assert {"mesh_tpu_anim_refits_total", "mesh_tpu_anim_rebuilds_total",
            "mesh_tpu_anim_inflation_ratio", "mesh_tpu_anim_sessions",
            "mesh_tpu_anim_frames_total",
            "mesh_tpu_anim_frame_deadline_miss_total",
            "mesh_tpu_accel_pair_tests_total",
            "mesh_tpu_request_stage_seconds"} <= set(mine)
    for name, snap in mine.items():
        if name in earlier and not snap["series"]:
            continue
        assert name in theirs, name
        assert (snap["type"], snap["help"]) == (theirs[name]["type"],
                                                theirs[name]["help"]), name


def test_ledger_stages_outcomes_and_kill_switch(monkeypatch, tmp_path):
    clock = iter([10.0, 10.5, 11.0, 11.25, 12.0, 13.0, 14.0]).__next__
    led = ledger.LatencyLedger(capacity=16, clock=clock)
    rec = led.open(tenant="t", op="anim_frame")
    rec.stamp("queue")
    rec.stamp("refit")
    rec.stamp("device")
    with pytest.raises(ValueError, match="unknown ledger stage"):
        rec.stamp("nope")
    row = led.close(rec, outcome="deadline")
    assert row["stages"] == {"queue": 0.5, "refit": 0.5, "device": 0.25,
                             "respond": 0.75}
    assert row["total_s"] == 2.0 and row["outcome"] == "deadline"
    assert ledger.LEDGER_STAGES == mesh_tpu.obs.ledger.LEDGER_STAGES
    assert ledger.LEDGER_OUTCOMES == mesh_tpu.obs.ledger.LEDGER_OUTCOMES
    monkeypatch.setenv("MESH_TPU_LEDGER", "0")
    assert led.open(tenant="t") is None and led.close(None) is None
    monkeypatch.setenv("MESH_TPU_LEDGER", "1")
    # MESH_TPU_REPLAY_TRACE streams each close into a replayable trace
    from mesh_tpu_torch.obs import replay

    path = str(tmp_path / "trace.jsonl")
    monkeypatch.setenv("MESH_TPU_REPLAY_TRACE", path)
    try:
        led.close(led.open(tenant="t"))
    finally:
        replay.reset_capture()
    trace = replay.load_trace(path)
    assert trace["source"] == "capture"
    assert trace["records"] == [{"t": 0.0, "tenant": "t"}]


def test_spans_nest_and_carry_the_request_context(monkeypatch):
    assert trace.span("x") is trace._NOOP          # MESH_TPU_OBS unset
    monkeypatch.setenv("MESH_TPU_OBS", "1")
    ctx = context.mint("tenant", 3, 1.5)
    jctx = mesh_tpu.obs.context.mint("tenant", 3, 1.5)
    assert ctx.request_id == jctx.request_id and ctx.to_meta() == \
        jctx.to_meta()
    with context.bind_context(ctx):
        with trace.span("outer", a=1) as outer:
            with trace.span("inner") as inner:
                inner.watch({"x": torch.ones(3)})  # CPU: nothing to sync
    events = {e["name"]: e for e in obs.TRACER.events()}
    assert events["inner"]["parent_id"] == outer.span_id
    assert events["inner"]["attrs"]["request_id"] == ctx.request_id
    assert events["inner"]["sync_elapsed_s"] >= 0.0
    assert events["outer"]["attrs"] == {"a": 1,
                                        "request_id": ctx.request_id}
    monkeypatch.setenv("MESH_TPU_TRACE_CONTEXT", "0")
    assert context.mint("tenant", 4, 2.0) is None


def test_recorder_ring_and_kill_switch(monkeypatch):
    rec = recorder.FlightRecorder(capacity=16, clock=lambda: 7.0)
    for k in range(20):
        rec.record("e", k=k)
    events = rec.events()
    assert len(events) == 16 and events[-1] == {"kind": "e", "k": 19,
                                                "t": 7.0}
    monkeypatch.setenv("MESH_TPU_RECORDER", "0")
    rec.record("dropped")
    assert len(rec.events()) == 16


# -- fleet, tuning, errors, imports ------------------------------------------

class _Topo(object):
    topology_key = "topo-7"


class _Faces(object):
    f = np.arange(30, dtype=np.int64).reshape(10, 3)


@pytest.mark.parametrize("q", [1, 32, 33, 4096, 16384, 16385, 40000])
def test_routing_key_matches_reference(q):
    assert trouter.ROUTER_Q_LADDER == jrouter.ROUTER_Q_LADDER
    assert trouter.shape_bucket(q) == jrouter.shape_bucket(q)
    pts = np.zeros((q, 3), np.float32)
    for mesh in ("abc-123", _Topo(), _Faces()):
        assert trouter.routing_key("anim_frame", mesh, pts) == \
            jrouter.routing_key("anim_frame", mesh, pts)
    assert trouter.routing_key("op", "d", torch.zeros((q, 3))) == \
        jrouter.routing_key("op", "d", pts)


def test_shape_bucket_rejects_empty_batches():
    for mod in (trouter, jrouter):
        with pytest.raises(ValueError):
            mod.shape_bucket(0)


def test_tunable_declaration_matches_reference():
    names = [t.name for t in tuning.tunables()]
    assert names == [t.name for t in jtuning.tunables()]
    for name in names:
        mine, theirs = tuning.lookup(name), jtuning.lookup(name)
        for key in ("kind", "default", "lo", "hi", "step", "pin_env",
                    "pin_means_default"):
            assert getattr(mine, key) == getattr(theirs, key), (name, key)
    with pytest.raises(KeyError):
        tuning.lookup("nope")


def test_errors_match_reference():
    for name in ("MeshError", "SerializationError", "SpatialSearchError",
                 "VisibilityError", "TopologyError", "EngineShutdown",
                 "DeadlineExceeded", "StoreError", "StoreCorrupt",
                 "ServeRejected"):
        mine, theirs = getattr(terrors, name), getattr(jerrors, name)
        assert [c.__name__ for c in mine.__mro__] == \
            [c.__name__ for c in theirs.__mro__], name
    assert issubclass(SessionClosed, terrors.MeshError)
    err = terrors.ServeRejected("full", retry_after=0.5, reason="queue_full")
    assert (err.retry_after, err.reason) == (0.5, "queue_full")


def test_importing_the_session_path_loads_neither_jax_nor_mesh_tpu():
    code = ("import sys; import mesh_tpu_torch.anim, mesh_tpu_torch.obs; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'mesh_tpu' or "
            "m.startswith('mesh_tpu.')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"
