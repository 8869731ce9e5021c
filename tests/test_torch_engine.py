"""The port's query engine (mesh_tpu_torch.engine) on the CPU.

On the CPU a plan is the batched step called eagerly at its bucket's
shapes, so the keys, the LRU, the padding and slicing, the stats and the
executor run here; the CUDA graphs themselves are checked on the card
(``chip_smoke.py`` phase 15).  The engine is held bit for bit to the
port's own direct path (MESH_TPU_NO_ENGINE=1), and to mesh_tpu's engine
route under the tie contract, on a small icosphere and three noisy copies
as tests/test_engine.py uses.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import mesh_tpu
from mesh_tpu import engine as jengine
from mesh_tpu.batch import (
    batched_closest_faces_and_points as jax_batched_closest,
    batched_vertex_visibility as jax_batched_vis,
    fused_normals_and_closest_points as jax_fused,
)
from mesh_tpu.sphere import _icosphere

import mesh_tpu_torch as T
from mesh_tpu_torch import engine, errors
from mesh_tpu_torch.batch import (
    batched_closest_faces_and_points,
    batched_vertex_normals,
    batched_vertex_visibility,
    fused_normals_and_closest_points,
)
from mesh_tpu_torch.engine import planner as planner_mod
from mesh_tpu_torch.obs.clock import monotonic
from mesh_tpu_torch.obs.metrics import REGISTRY

from .test_torch_closest import assert_tie_contract
from .test_torch_ray import borderline_rays

torch.set_num_threads(2)

REPO = __import__("os").path.dirname(__import__("os").path.dirname(
    __import__("os").path.abspath(__file__)))

CAMS = np.asarray([[0.0, 0.0, 3.0], [3.0, 0.0, 0.0]], np.float32)


@pytest.fixture(autouse=True)
def fresh_engine(monkeypatch):
    """A new process-wide planner and zeroed stats for every test; the
    engine on unless a test turns it off."""
    monkeypatch.delenv("MESH_TPU_NO_ENGINE", raising=False)
    monkeypatch.setattr(planner_mod, "_PLANNER", planner_mod.Planner())
    engine.reset_stats()
    yield


@pytest.fixture
def mesh():
    v, f = _icosphere(2)                    # 162 verts / 320 faces
    return T.Mesh(v=v, f=f, device="cpu")


@pytest.fixture
def meshes():
    rng = np.random.RandomState(3)
    v, f = _icosphere(2)
    return [T.Mesh(v=v + 0.01 * rng.randn(*v.shape), f=f, device="cpu")
            for _ in range(3)]


def _queries(q, seed=0):
    return np.asarray(np.random.RandomState(seed).randn(q, 3), np.float32)


def _direct(call, monkeypatch):
    """``call()`` with the engine bypassed (the direct paths)."""
    monkeypatch.setenv("MESH_TPU_NO_ENGINE", "1")
    try:
        return call()
    finally:
        monkeypatch.delenv("MESH_TPU_NO_ENGINE")


def _same(a, b):
    """Bit-identical arrays (or tuples of them): shapes, dtypes, values."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# planner: bucketing and plan reuse


def test_ladders_and_buckets_match_reference():
    assert engine.Q_LADDER == jengine.Q_LADDER
    assert engine.B_LADDER == jengine.B_LADDER
    n = np.arange(1, 40001)
    for ladder in (engine.Q_LADDER, engine.B_LADDER):
        mine = [engine.bucket_size(int(k), ladder) for k in n]
        theirs = [jengine.bucket_size(int(k), ladder) for k in n]
        assert mine == theirs


@pytest.mark.parametrize("bad", [0, -4])
def test_bucket_size_rejects_non_positive(bad):
    with pytest.raises(ValueError):
        engine.bucket_size(bad, engine.Q_LADDER)


def test_pad_edge_tensor_and_numpy():
    x = np.arange(12, dtype=np.float32).reshape(2, 2, 3)
    for arr in (x, torch.from_numpy(x)):
        out = planner_mod._pad_edge(arr, 5, axis=1)
        assert type(out) is type(arr) and tuple(out.shape) == (2, 5, 3)
        out = np.asarray(out)
        assert np.array_equal(out[:, :2], x)
        assert np.array_equal(out[:, 2:], np.repeat(x[:, 1:], 3, axis=1))
    assert planner_mod._pad_edge(x, 2, axis=1) is x


def test_plan_reuse_within_bucket_flat_misses(mesh, monkeypatch):
    """Ten Mesh calls with distinct Q inside one bucket make no new plan
    and match the direct route bit for bit."""
    mesh.closest_faces_and_points(_queries(300))    # the 512 bucket
    engine.reset_stats()
    for q in range(260, 510, 25):
        pts = _queries(q, seed=q)
        got = mesh.closest_faces_and_points(pts)
        want = _direct(lambda: mesh.closest_faces_and_points(pts),
                       monkeypatch)
        assert _same(got, want)
    snap = engine.stats()
    assert snap["retraces"] == 0 and snap["plan_cache"]["misses"] == 0
    assert snap["plan_cache"]["hits"] == 10
    assert 0.0 <= snap["pad_waste"] < 1.0


def test_crossing_a_bucket_boundary_makes_one_plan(mesh):
    mesh.closest_faces_and_points(_queries(40))     # the 64 bucket
    engine.reset_stats()
    mesh.closest_faces_and_points(_queries(50))     # same bucket: hit
    assert engine.stats()["plan_cache"]["misses"] == 0
    mesh.closest_faces_and_points(_queries(65))     # the 128 bucket
    mesh.closest_faces_and_points(_queries(100))    # 128 again: hit
    snap = engine.stats()["plan_cache"]
    assert snap["misses"] == 1 and snap["hits"] == 2


def test_lru_evicts_beyond_max_plans(mesh, monkeypatch):
    small = planner_mod.Planner(max_plans=2)
    monkeypatch.setattr(planner_mod, "_PLANNER", small)
    for q in (20, 40, 100):                         # 32, 64, 128 buckets
        mesh.closest_faces_and_points(_queries(q))
    assert len(small.cached_keys()) == 2
    assert engine.stats()["plan_cache"]["evictions"] == 1
    assert [k[2] for k in small.cached_keys()] == [64, 128]


def test_no_engine_bypass(mesh, monkeypatch):
    monkeypatch.setenv("MESH_TPU_NO_ENGINE", "1")
    assert not engine.engine_enabled()
    faces, points = mesh.closest_faces_and_points(_queries(120))
    snap = engine.stats()["plan_cache"]
    assert snap["hits"] == 0 and snap["misses"] == 0
    assert faces.shape == (1, 120) and points.shape == (120, 3)
    monkeypatch.delenv("MESH_TPU_NO_ENGINE")
    assert engine.engine_enabled()


def test_facade_above_crossover_on_cpu_takes_direct_route(mesh, monkeypatch):
    """Without kernels (the CPU), F above crossover_faces() returns None
    from the engine facade: the Mesh call takes the auto ladder."""
    monkeypatch.setenv("MESH_TPU_BRUTE_MAX_FACES", "100")
    assert engine.facade_closest_faces_and_points(mesh, _queries(10)) is None
    assert engine.facade_closest_faces_and_points(
        mesh, np.zeros((0, 3))) is None
    faces, _ = mesh.closest_faces_and_points(_queries(10))
    assert faces.shape == (1, 10)
    assert engine.stats()["plan_cache"]["misses"] == 0


# ---------------------------------------------------------------------------
# every engine op against the port's direct path, bit for bit


def test_batched_closest_matches_direct(meshes, monkeypatch):
    pts = np.asarray(np.random.RandomState(5).randn(3, 77, 3), np.float32)
    call = lambda: batched_closest_faces_and_points(meshes, pts,  # noqa
                                                    device="cpu")
    assert _same(call(), _direct(call, monkeypatch))
    assert engine.stats()["plan_cache"]["misses"] == 1


def test_batched_closest_shared_queries_matches_direct(meshes, monkeypatch):
    call = lambda: batched_closest_faces_and_points(  # noqa: E731
        meshes, _queries(64, seed=9), device="cpu")
    assert _same(call(), _direct(call, monkeypatch))


def test_batched_normals_match_direct(meshes, monkeypatch):
    call = lambda: batched_vertex_normals(meshes, device="cpu")  # noqa
    got = call()
    assert _same(got, _direct(call, monkeypatch))
    assert got.dtype == np.float64 and got.shape == (3, 162, 3)


@pytest.mark.parametrize("single", [False, True])
def test_fused_matches_direct(meshes, monkeypatch, single):
    pts = np.asarray(np.random.RandomState(7).randn(3, 55, 3), np.float32)
    arg, q = (meshes[0], pts[0]) if single else (meshes, pts)
    call = lambda: fused_normals_and_closest_points(arg, q,  # noqa: E731
                                                    device="cpu")
    assert _same(call(), _direct(call, monkeypatch))


@pytest.mark.parametrize("stored_vn", [False, True])
def test_visibility_matches_direct(meshes, monkeypatch, stored_vn):
    if stored_vn:
        for m in meshes:
            m.vn = m.estimate_vertex_normals()
    call = lambda: batched_vertex_visibility(meshes, CAMS,  # noqa: E731
                                             device="cpu")
    got = call()
    assert _same(got, _direct(call, monkeypatch))
    assert got[0].shape == (3, 2, 162)
    key = planner_mod.get_planner().cached_keys()[0]
    assert key[0] == "visibility" and key[8] == (not stored_vn)


def test_padded_batch_rows_match_each_mesh_alone(meshes):
    """B = 3 pads to the 4 bucket; every real row is the mesh's own
    single-mesh answer."""
    pts = np.asarray(np.random.RandomState(8).randn(3, 40, 3), np.float32)
    faces, points = batched_closest_faces_and_points(meshes, pts,
                                                     device="cpu")
    for b, m in enumerate(meshes):
        assert _same((faces[b], points[b]),
                     m.closest_faces_and_points(pts[b]))


@pytest.mark.parametrize("n_verts", [1, 2, 7, 162, 6890])
def test_vertex_mean_same_bits_alone_and_in_a_batch(n_verts):
    """The centering's mean: each mesh's bits alone equal its row of a
    batch, and within float32 rounding of a float64 mean."""
    from mesh_tpu_torch.query.closest_kernel import vertex_mean

    v = torch.as_tensor(np.random.RandomState(n_verts).randn(5, n_verts, 3)
                        * 0.3 + 1.0, dtype=torch.float32)
    got = vertex_mean(v)
    assert got.shape == (5, 1, 3)
    for b in range(5):
        assert torch.equal(vertex_mean(v[b]), got[b])
        assert torch.equal(vertex_mean(v[b:b + 2]), got[b:b + 2])
    want = v.double().mean(dim=1, keepdim=True)
    assert float((got.double() - want).abs().max()) <= 4e-7


def test_every_dispatch_is_its_plan_run(meshes, mesh):
    """A miss answers through its plan's run, as a hit does: each plan
    counts one run a dispatch."""
    pts = np.asarray(np.random.RandomState(9).randn(3, 40, 3), np.float32)
    batched_closest_faces_and_points(meshes, pts, device="cpu")
    mesh.closest_faces_and_points(_queries(30))
    mesh.closest_faces_and_points(_queries(31))
    info = engine.get_planner().plan_info()
    assert [p["runs"] for p in info] == [1, 2]
    lat = engine.stats()["dispatch_latency"]
    assert sum(row["count"] for row in lat.values()) == 3


# ---------------------------------------------------------------------------
# against mesh_tpu's engine route


def test_mesh_facade_matches_reference_engine(mesh):
    v, f = _icosphere(2)
    q = _queries(300, seed=2)
    faces, points = mesh.closest_faces_and_points(q)
    ref_f, ref_p = mesh_tpu.Mesh(v=v, f=f).closest_faces_and_points(q)
    ref = {"face": ref_f[0].astype(np.int32), "point": ref_p,
           "sqdist": ((q - ref_p) ** 2).sum(-1), "part": np.zeros(300)}
    out = {"face": faces[0].astype(np.int32), "point": points,
           "sqdist": ((q - points) ** 2).sum(-1), "part": np.zeros(300)}
    assert_tie_contract(ref, out, np.asarray(v), np.asarray(f), q)


def test_batched_facades_match_reference_engine(meshes):
    pts = np.asarray(np.random.RandomState(5).randn(3, 77, 3), np.float32)
    jm = [mesh_tpu.Mesh(v=m.v, f=m.f) for m in meshes]
    ref_f, ref_p = jax_batched_closest(jm, pts)
    out_n, out_f, out_p = fused_normals_and_closest_points(meshes, pts,
                                                           device="cpu")
    ref_n, _, _ = jax_fused(jm, pts)
    np.testing.assert_allclose(out_n, np.asarray(ref_n), atol=2e-6)
    for b, m in enumerate(meshes):
        q = pts[b]
        ref = {"face": np.asarray(ref_f)[b, 0].astype(np.int32),
               "point": np.asarray(ref_p)[b],
               "sqdist": ((q - np.asarray(ref_p)[b]) ** 2).sum(-1),
               "part": np.zeros(77)}
        out = {"face": out_f[b, 0].astype(np.int32), "point": out_p[b],
               "sqdist": ((q - out_p[b]) ** 2).sum(-1), "part": np.zeros(77)}
        assert_tie_contract(ref, out, m.v, m.f.astype(np.int64), q)


def test_visibility_matches_reference_engine(meshes):
    from mesh_tpu_torch.query.visibility import visibility_rays

    jm = [mesh_tpu.Mesh(v=m.v, f=m.f) for m in meshes]
    ref_vis, ref_ndc = jax_batched_vis(jm, CAMS)
    out_vis, out_ndc = batched_vertex_visibility(meshes, CAMS, device="cpu")
    np.testing.assert_allclose(out_ndc, np.asarray(ref_ndc), atol=1e-6)
    for b, m in enumerate(meshes):
        v = m.v.astype(np.float32)
        differ = out_vis[b] != np.asarray(ref_vis)[b]
        if differ.any():
            origins, dirs = visibility_rays(torch.from_numpy(v)[None],
                                            torch.from_numpy(CAMS))
            border = borderline_rays(origins[0].numpy(),
                                     dirs[0].reshape(-1, 3).numpy(),
                                     v[m.f.astype(np.int64)])
            assert not (differ.reshape(-1) & ~border).any()


# ---------------------------------------------------------------------------
# executor


def test_executor_coalesces_same_topology(meshes):
    rng = np.random.RandomState(11)
    ptss = [np.asarray(rng.randn(q, 3), np.float32) for q in (150, 200, 90)]
    ex = engine.get_executor()
    with ex.coalesce():
        futs = [ex.submit("closest_point", m, p)
                for m, p in zip(meshes, ptss)]
    ex.drain()
    snap = engine.stats()["coalesced"]
    assert snap["dispatches"] == 1
    assert snap["requests"] == 3 and snap["max_batch"] == 3
    for m, p, fut in zip(meshes, ptss, futs):
        assert _same(fut.result(timeout=60), m.closest_faces_and_points(p))


def test_executor_fused_future(meshes, monkeypatch):
    pts = _queries(130, seed=13)
    normals, faces, points = engine.submit("fused", meshes[0], pts).result(
        timeout=60)
    want = _direct(lambda: fused_normals_and_closest_points(
        [meshes[0]], pts[None], device="cpu"), monkeypatch)
    assert _same((normals, faces, points), tuple(x[0] for x in want))


def test_executor_splits_mixed_topologies(mesh):
    small_v, small_f = _icosphere(1)
    other = T.Mesh(v=small_v, f=small_f, device="cpu")
    ex = engine.get_executor()
    with ex.coalesce():
        f1 = ex.submit("closest_point", mesh, _queries(60, seed=1))
        f2 = ex.submit("closest_point", other, _queries(60, seed=2))
    ex.drain()
    assert engine.stats()["coalesced"]["dispatches"] == 2
    assert f1.result(timeout=60)[0].shape == (1, 60)
    assert f2.result(timeout=60)[0].shape == (1, 60)


@pytest.mark.parametrize("op, n_q", [("no_such_op", 10),
                                     ("closest_point", 0)])
def test_executor_rejects_bad_requests(mesh, op, n_q):
    with pytest.raises(ValueError):
        engine.get_executor().submit(op, mesh, np.zeros((n_q, 3)))


def test_shutdown_submit_raises(mesh):
    ex = engine.EngineExecutor()
    ex.shutdown()
    with pytest.raises(errors.EngineShutdown):
        ex.submit("closest_point", mesh, _queries(10))


def test_shutdown_completes_queued_work(mesh):
    ex = engine.EngineExecutor()
    ex.hold()
    fut = ex.submit("closest_point", mesh, _queries(20, seed=21))
    ex.release()
    ex.shutdown()
    faces, points = fut.result(timeout=60)
    assert faces.shape == (1, 20) and points.shape == (20, 3)


def test_drain_after_shutdown_returns_immediately(mesh):
    ex = engine.EngineExecutor()
    ex.shutdown()
    t0 = monotonic()
    ex.drain()
    ex.shutdown()
    ex.drain()
    assert monotonic() - t0 < 1.0


def test_queued_deadline_expiry_drops_request(mesh):
    ex = engine.EngineExecutor()
    try:
        ex.hold()
        dead = ex.submit("closest_point", mesh, _queries(15, seed=31),
                         deadline=monotonic() - 0.001)
        live = ex.submit("closest_point", mesh, _queries(15, seed=32),
                         deadline=monotonic() + 60.0)
        ex.release()
        with pytest.raises(errors.DeadlineExceeded):
            dead.result(timeout=60)
        assert live.result(timeout=60)[0].shape == (1, 15)
    finally:
        ex.shutdown()
    drops = REGISTRY.counter("mesh_tpu_engine_deadline_drop_total")
    assert drops.value() == 1


def test_cancel_before_dispatch_skips_request(mesh):
    cancelled = REGISTRY.counter("mesh_tpu_engine_cancelled_total")
    ex = engine.EngineExecutor()
    try:
        ex.hold()
        fut = ex.submit("closest_point", mesh, _queries(15, seed=41))
        assert fut.cancel()
        ex.release()
        ex.drain()
        assert fut.cancelled()
        assert cancelled.value() == 1
        assert engine.stats()["coalesced"]["dispatches"] == 0
    finally:
        ex.shutdown()


@pytest.mark.parametrize("shard_knob, lane", [("1", True), ("0", False)])
def test_sharded_lane_raises_once_turned_on(mesh, monkeypatch, shard_knob,
                                            lane):
    """The lane's gate: shard_min_q set and MESH_TPU_FLEET_SHARD on send a
    big single request to the sharded lane (counted once, the same answer
    as the single-device path); the kill switch off keeps the
    single-device path; a small request never takes the lane.  (The name
    is kept from when the admitted request raised.)"""
    counter = REGISTRY.counter("mesh_tpu_fleet_shard_dispatches_total")
    pts = _queries(2000, seed=3)
    ex = engine.EngineExecutor()
    try:
        faces_off, points_off = ex.submit("closest_point", mesh,
                                          pts).result(timeout=60)
        monkeypatch.setenv("MESH_TPU_FLEET_SHARD_MIN_Q", "1024")
        monkeypatch.setenv("MESH_TPU_FLEET_SHARD", shard_knob)
        n0 = counter.value()
        faces, points = ex.submit("closest_point", mesh,
                                  pts).result(timeout=60)
        assert counter.value() == n0 + int(lane)
        np.testing.assert_array_equal(faces, faces_off)
        np.testing.assert_array_equal(points, points_off)
        small = ex.submit("closest_point", mesh, _queries(100, seed=4))
        assert small.result(timeout=60)[0].shape == (1, 100)
        assert counter.value() == n0 + int(lane)
    finally:
        ex.shutdown()


def test_shard_lane_bit_identical_and_counted(mesh, monkeypatch):
    """The reference's lane case (tests/test_fleet.py): off by default,
    the kill switch beats the pin, the lane on is counted and bit-identical
    to the single-device path, below the threshold it never engages; the
    lane's ledger record carries backend "xla_sharded" under the
    engine.shard_dispatch span."""
    from mesh_tpu_torch.obs.ledger import RequestRecord
    from mesh_tpu_torch.obs.trace import TRACER

    pts = _queries(1500, seed=9)
    counter = REGISTRY.counter("mesh_tpu_fleet_shard_dispatches_total")

    def run(record=None):
        return engine.submit("closest_point", mesh, pts,
                             record=record).result(timeout=120)

    n0 = counter.value()
    faces_off, points_off = run()
    assert counter.value() == n0
    monkeypatch.setenv("MESH_TPU_FLEET_SHARD_MIN_Q", "1024")
    monkeypatch.setenv("MESH_TPU_FLEET_SHARD", "0")
    faces_kill, points_kill = run()
    assert counter.value() == n0
    assert np.array_equal(faces_kill, faces_off)
    assert np.array_equal(points_kill, points_off)
    monkeypatch.delenv("MESH_TPU_FLEET_SHARD")
    record = RequestRecord(monotonic(), {}, monotonic)
    monkeypatch.setenv("MESH_TPU_OBS", "1")
    spans = []
    sink = TRACER.add_sink(spans.append)
    try:
        faces_on, points_on = run(record)
    finally:
        TRACER.remove_sink(sink)
    assert counter.value() == n0 + 1
    assert np.array_equal(faces_on, faces_off)
    assert np.array_equal(points_on, points_off)
    assert record.meta["backend"] == "xla_sharded"
    assert "pad" not in record.stamps and "device" in record.stamps
    assert any(event["name"] == "engine.shard_dispatch" for event in spans)
    base = counter.value()
    engine.submit("closest_point", mesh, pts[:600]).result(timeout=120)
    assert counter.value() == base


def test_failed_plan_reaches_the_future_without_fallback(mesh, monkeypatch):
    """A plan that cannot be made raises through the request's future and
    through the facade; nothing reruns the step eagerly or on the direct
    route."""
    from mesh_tpu_torch import batch as tbatch
    from mesh_tpu_torch.query import culled

    def broken(self, fn, inputs, device):
        raise RuntimeError("capture failed")

    calls = []
    monkeypatch.setattr(planner_mod.Planner, "_make_plan", broken)
    monkeypatch.setattr(tbatch, "batch_step",
                        lambda *a, **k: calls.append("step"))
    monkeypatch.setattr(culled, "closest_faces_and_points_auto",
                        lambda *a, **k: calls.append("auto"))
    fut = engine.submit("closest_point", mesh, _queries(30))
    with pytest.raises(RuntimeError, match="capture failed"):
        fut.result(timeout=60)
    with pytest.raises(RuntimeError, match="capture failed"):
        mesh.closest_faces_and_points(_queries(30))
    assert calls == []
    assert engine.stats()["plan_cache"]["misses"] == 0


def test_concurrent_callers_share_one_planner(meshes, monkeypatch):
    """Eight threads (more than the cores these tests get) call the facade
    at once with a short switch interval: each answer is its sequential
    one, every dispatch is counted once, and a cold key racing in several
    threads still makes one plan."""
    import threading

    calls = [(i % 3, q) for i, q in enumerate((40, 50, 100, 120) * 12)]
    want = {c: _direct(lambda: meshes[c[0]].closest_faces_and_points(
        _queries(c[1], c[0])), monkeypatch) for c in set(calls)}
    got, errors_seen = [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker(chunk):
            try:
                for c in chunk:
                    got.append((c, meshes[c[0]].closest_faces_and_points(
                        _queries(c[1], c[0]))))
            except Exception as e:     # the assertion below reports it
                errors_seen.append(e)

        threads = [threading.Thread(target=worker, args=(calls[i::8],))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors_seen == []
    assert len(got) == len(calls)
    assert all(_same(out, want[c]) for c, out in got)
    snap = engine.stats()["plan_cache"]
    assert snap["misses"] == 2                   # the 64 and 128 buckets
    assert snap["hits"] + snap["misses"] == len(calls)


# ---------------------------------------------------------------------------
# warmup, stats, ICP, signatures, imports


def test_warmup_makes_plans_then_hits(mesh):
    shapes = ((162, 320),)
    made = engine.warmup(mesh_shapes=shapes, q_buckets=(256,),
                         b_buckets=(1,), ops=("closest_point",),
                         device="cpu")
    assert made == 2                       # both nondegeneracy flags
    assert engine.warmup(mesh_shapes=shapes, q_buckets=(256,),
                         b_buckets=(1,), ops=("closest_point",),
                         device="cpu") == 0
    engine.reset_stats()
    mesh.closest_faces_and_points(_queries(250))
    snap = engine.stats()["plan_cache"]
    assert snap["misses"] == 0 and snap["hits"] == 1


def test_warmup_fused_plan_serves_real_bodies(meshes, monkeypatch):
    engine.warmup(mesh_shapes=((162, 320),), q_buckets=(128,),
                  device="cpu")
    engine.reset_stats()
    pts = _queries(100, seed=6)
    got = fused_normals_and_closest_points(meshes[1], pts, device="cpu")
    assert engine.stats()["plan_cache"]["misses"] == 0
    assert _same(got, _direct(lambda: fused_normals_and_closest_points(
        meshes[1], pts, device="cpu"), monkeypatch))


def test_stats_keys_match_reference(mesh):
    mesh.closest_faces_and_points(_queries(33))
    snap, ref = engine.stats(), jengine.stats()
    assert set(snap) == set(ref)
    for key in ("plan_cache", "coalesced"):
        assert set(snap[key]) == set(ref[key])
    assert snap["retraces"] == snap["plan_cache"]["misses"] == 1
    lat = snap["dispatch_latency"]["closest_point"]
    assert lat["count"] == 1 and lat["mean_ms"] > 0
    series = REGISTRY.get("mesh_tpu_engine_dispatch_seconds").label_sets()
    assert series == [{"op": "closest_point", "backend": "cpu"}]
    engine.reset_stats()
    assert engine.stats()["plan_cache"]["hits"] == 0


def test_icp_through_engine_matches_direct(monkeypatch):
    from mesh_tpu_torch import diff

    v, f = _icosphere(2)
    rng = np.random.RandomState(14)
    scan = (np.asarray(v) * 1.1 + rng.randn(*v.shape) * 0.01).astype(
        np.float32)
    call = lambda: diff.register_vertices(  # noqa: E731
        np.asarray(v, np.float32), f, scan, steps=6, recorrespond_every=2,
        device="cpu")
    got = call()
    assert engine.stats()["plan_cache"]["misses"] == 1
    assert engine.stats()["plan_cache"]["hits"] == 2
    want = _direct(call, monkeypatch)
    assert got.losses == want.losses
    assert torch.equal(got.verts, want.verts)


def test_chunk_positional_and_device_keyword_only(meshes):
    pts = np.asarray(np.random.RandomState(5).randn(3, 40, 3), np.float32)
    batched_closest_faces_and_points(meshes, pts, 256, device="cpu")
    fused_normals_and_closest_points(meshes, pts, 128, device="cpu")
    batched_vertex_visibility(meshes, CAMS, 1e-3, 512, device="cpu")
    chunks = sorted(k[7] if k[0] == "visibility" else k[8]
                    for k in planner_mod.get_planner().cached_keys())
    assert chunks == [128, 256, 512]
    for call in (
            lambda: batched_closest_faces_and_points(meshes, pts, 512, "cpu"),
            lambda: fused_normals_and_closest_points(meshes, pts, 512, "cpu"),
            lambda: batched_vertex_visibility(meshes, CAMS, 1e-3, 1024,
                                              "cpu"),
            lambda: batched_vertex_normals(meshes, "cpu")):
        with pytest.raises(TypeError):
            call()


def test_timed_span_and_incidents(tmp_path, monkeypatch):
    import json

    from mesh_tpu_torch.obs import recorder, trace

    with trace.timed_span("engine.dispatch", op="x") as sp:
        sp.watch(torch.zeros(3))
    assert sp.elapsed is not None and sp.elapsed >= 0.0
    monkeypatch.setenv("MESH_TPU_INCIDENT_DIR", str(tmp_path))
    monkeypatch.setenv("MESH_TPU_INCIDENT_KEEP", "4")
    rec = recorder.FlightRecorder()
    rec.record("engine.worker_crash", error="E")
    with open(rec.trigger("executor_exception",
                          context={"error": "E"})) as fh:
        first = json.load(fh)
    assert first["reason"] == "executor_exception"
    assert first["context"] == {"error": "E"}
    assert first["ring"][0]["kind"] == "engine.worker_crash"
    # rate-limited unless forced; the directory keeps the newest KEEP
    assert rec.trigger("again") is None
    for i in range(5):
        assert rec.trigger("again", context={"i": i}, force=True)
    kept = recorder.list_incidents()
    assert len(kept) == 4
    contexts = []
    for path in kept:
        with open(path) as fh:
            contexts.append(json.load(fh)["context"])
    assert {"i": 4} in contexts


def test_ab_engine_tool_checks_each_side_against_itself(tmp_path,
                                                       monkeypatch, capsys):
    """tools/ab_engine.py: this checkout's answers must equal its own
    first process's; the other checkout's differences (normals added with
    atomics) are printed, not failed; the side program parses and the
    tool imports neither jax nor mesh_tpu."""
    import ast
    import os

    tools = os.path.join(REPO, "tools")
    monkeypatch.syspath_prepend(tools)
    import ab_engine

    order = ab_engine.side_order(2)             # other, this, this, other
    answers = [{"normals": torch.tensor([1.0]), "faces": torch.tensor([2])},
               {"normals": torch.tensor([3.0]), "faces": torch.tensor([4])},
               {"normals": torch.tensor([3.0]), "faces": torch.tensor([4])},
               {"normals": torch.tensor([1.5]), "faces": torch.tensor([2])}]
    paths = []
    for k, got in enumerate(answers):
        paths.append(str(tmp_path / ("a%d.pt" % k)))
        torch.save(got, paths[-1])
    check = ab_engine.same_within_side(order)
    assert check(paths) == []
    assert "['normals']" in capsys.readouterr().out
    answers[2]["faces"] = torch.tensor([5])
    torch.save(answers[2], paths[2])
    assert check(paths) == ["faces"]
    ast.parse(ab_engine.SIDE)
    tree = ast.parse(open(os.path.join(tools, "ab_engine.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ""])
            assert not any(n.split(".")[0] in ("jax", "mesh_tpu")
                           for n in names)


def test_importing_the_engine_loads_neither_jax_nor_mesh_tpu():
    code = ("import sys; import mesh_tpu_torch.engine; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'mesh_tpu' or "
            "m.startswith('mesh_tpu.')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"
