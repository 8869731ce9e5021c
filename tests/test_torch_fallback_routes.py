"""mesh_tpu_torch's fallback routes against mesh_tpu, on the CPU.

Under ``MESH_TPU_FORCE_XLA=1`` every entry point of the port takes the
reference's XLA form in plain PyTorch; mesh_tpu runs the same forms as XLA
on the CPU.  Inputs come from numpy RandomState seeds at a few hundred
faces.  The contracts: ``build_grid`` arrays bit-equal; anchor tables
equal except where two bounds lie within 1e-6 relative, ``safe`` within
1e-6 relative; every closest-point route (anchored, top-k culled, grid,
BVH walk, the plain batch step) under the tie contract of
test_torch_closest, ``tight`` equal except at ties; ``_bvh_query``'s
``steps`` and ``pair_tests`` equal; the ray, intersection and visibility
forms flag for flag except on borderline rays or faces (test_torch_ray,
test_torch_tri_tri); the normal-weighted form faces except ties.  Within
the port, the plain walks equal the plain scan bit for bit, and every
tight anchored answer equals the brute-force answer up to ties.
"""

import inspect

import numpy as np
import pytest
import torch

import mesh_tpu
from mesh_tpu import batch as jbatch
from mesh_tpu.accel import build as jbuild
from mesh_tpu.accel import traverse as jtraverse
from mesh_tpu.query import anchored as janchored
from mesh_tpu.query import closest_point as jclosest
from mesh_tpu.query import culled as jculled
from mesh_tpu.query import ray as jray
from mesh_tpu.query import visibility as jvis
from mesh_tpu.query.normal_weighted import (
    nearest_normal_weighted as jax_nearest_nw,
)
from mesh_tpu.search import AabbTree as JaxAabbTree

import mesh_tpu_torch
from mesh_tpu_torch import batch as tbatch
from mesh_tpu_torch import convert, diff
from mesh_tpu_torch.accel import build as tbuild
from mesh_tpu_torch.accel import rope_kernel as rk
from mesh_tpu_torch.accel import traverse as ttraverse
from mesh_tpu_torch.obs.metrics import REGISTRY
from mesh_tpu_torch.query import anchored as tanchored
from mesh_tpu_torch.query import closest_kernel as ck
from mesh_tpu_torch.query import closest_point as tclosest
from mesh_tpu_torch.query import culled as tculled
from mesh_tpu_torch.query import ray as tray
from mesh_tpu_torch.query import visibility as tvis
from mesh_tpu_torch.query.normal_weighted import nearest_normal_weighted_xla
from mesh_tpu_torch.utils import dispatch

from .test_torch_closest import assert_tie_contract, small_body
from .test_torch_culled import sphere, surface_queries
from .test_torch_normal_weighted import assert_nw_tie_contract
from .test_torch_ray import borderline_rays
from .test_torch_search import _M
from .test_torch_tri_tri import borderline_queries

torch.set_num_threads(2)

REL = 1e-6
KEYS = ("face", "part", "point", "sqdist")


@pytest.fixture
def force_xla(monkeypatch):
    monkeypatch.setenv("MESH_TPU_FORCE_XLA", "1")
    return monkeypatch


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _np(res):
    return {k: np.asarray(v) for k, v in res.items()}


def _case(sub=3, seed=0, n=300, noise=0.02):
    v, f = sphere(sub, seed=seed)
    return v, f, surface_queries(v, f, n, seed=seed + 7, noise=noise)


def _scan(v, f, q):
    return _np(tclosest.closest_faces_and_points_t(
        *_t(v, f.astype(np.int64), q)))


# -- the dispatch policy ------------------------------------------------------

def test_pallas_default_and_its_counter(monkeypatch):
    series = REGISTRY.counter("mesh_tpu_dispatch_backend_total")
    before = {k: series.value(backend=k[0], reason=k[1])
              for k in (("pallas", "platform"), ("xla", "forced"))}
    monkeypatch.delenv("MESH_TPU_FORCE_XLA", raising=False)
    assert dispatch.pallas_default("cpu") is True
    monkeypatch.setenv("MESH_TPU_FORCE_XLA", "1")
    assert dispatch.force_xla() and dispatch.pallas_default("cpu") is False
    monkeypatch.setenv("MESH_TPU_FORCE_XLA", "off")
    assert not dispatch.force_xla() and dispatch.pallas_default() is True
    assert series.value(backend="pallas", reason="platform") == \
        before["pallas", "platform"] + 2
    assert series.value(backend="xla", reason="forced") == \
        before["xla", "forced"] + 1
    # the reference's labels for the same decision
    from mesh_tpu.obs.metrics import REGISTRY as JREG
    from mesh_tpu.utils import dispatch as jdispatch

    monkeypatch.setenv("MESH_TPU_FORCE_XLA", "1")
    assert jdispatch.pallas_default() is False
    labels = {tuple(sorted(s["labels"].items())) for s in JREG.get(
        "mesh_tpu_dispatch_backend_total").snapshot()["series"]}
    assert (("backend", "xla"), ("reason", "forced")) in labels


# -- the uniform grid ---------------------------------------------------------

@pytest.mark.parametrize("case,params", [
    ("sphere", {}), ("body", {}), ("body", {"cap": 2}),
    ("sphere", {"faces_per_cell": 1.0, "max_res": 8})])
def test_build_grid_bit_equal(case, params):
    if case == "sphere":
        v, f = sphere(3, seed=2)
    else:
        v, f = small_body(seed=3)
    ref = jbuild.build_grid(v, f, **params)
    out = tbuild.build_grid(v, f, **params)
    assert out.kind == ref.kind == "grid" and out.digest == ref.digest
    assert out.meta == ref.meta
    assert sorted(out.arrays) == sorted(ref.arrays)
    for name, arr in ref.arrays.items():
        assert out.arrays[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(out.arrays[name], arr, err_msg=name)
    if params.get("cap") == 2:
        assert out.meta["overflow_cells"] > 0
    assert tbuild.get_index(v, f, kind="grid", **params).digest == out.digest


# -- anchored tables and queries ----------------------------------------------

def _bounds64(v, f):
    v = v.astype(np.float64) - v.astype(np.float64).mean(0)
    tri = v[f]
    cen = tri.mean(1)
    rad = np.sqrt(((tri - cen[:, None]) ** 2).sum(-1).max(1))
    return v, cen, rad


@pytest.mark.parametrize("k", [16, 128, 4000])
def test_anchor_tables_match_reference(k):
    v, f = small_body(seed=4)
    jt, js = (np.asarray(x) for x in janchored.build_anchor_tables(v, f, k=k))
    tt, ts = tanchored.build_anchor_tables(v, f, k=k, device="cpu")
    tt, ts = tt.numpy(), ts.numpy()
    assert tt.dtype == np.int32 and ts.dtype == np.float32
    assert tt.shape == jt.shape == (v.shape[0], min(k, f.shape[0]))
    if k >= f.shape[0]:
        assert np.isinf(ts).all() and np.isinf(js).all()
    else:
        np.testing.assert_allclose(ts, js, rtol=REL, atol=REL)
    vc, cen, rad = _bounds64(v, f)
    rows, cols = np.nonzero(tt != jt)
    lb_t = np.linalg.norm(vc[rows] - cen[tt[rows, cols]], axis=1) \
        - rad[tt[rows, cols]]
    lb_j = np.linalg.norm(vc[rows] - cen[jt[rows, cols]], axis=1) \
        - rad[jt[rows, cols]]
    assert np.all(np.abs(lb_t - lb_j) <= REL * np.maximum(1.0, np.abs(lb_j)))


def _anchor_margin64(v, q, safe, slack):
    """Per query: how far 2 dhat sits from safe - slack at every vertex
    within rounding of the nearest (float64); the certificate may go either
    way where this is small."""
    vc = v.astype(np.float64) - v.astype(np.float64).mean(0)
    qc = q.astype(np.float64) - v.astype(np.float64).mean(0)
    d2 = ((qc[:, None] - vc[None]) ** 2).sum(-1)
    near = d2 <= d2.min(1, keepdims=True) + 1e-5
    margin = np.abs(2 * np.sqrt(d2) - (safe.astype(np.float64)[None]
                                       - slack))
    return np.where(near, margin, np.inf).min(1)


def _assert_scaled(ref, out, scale):
    """At millimetre scale (coordinates ~1000) float32 cancellation in the
    projection grows with the scene: the reference's own tolerance on the
    distance (tests/test_anchored.py:110-129)."""
    np.testing.assert_allclose(np.sqrt(out["sqdist"]), np.sqrt(ref["sqdist"]),
                               atol=1e-3 * scale, rtol=1e-4)


@pytest.mark.parametrize("scale", [1.0, 1000.0])
def test_anchored_matches_reference_on_shared_tables(scale):
    v, f, q = _case(sub=3, seed=5, n=400, noise=0.05)
    v, q = (v * scale).astype(np.float32), (q * scale).astype(np.float32)
    jt, js = janchored.build_anchor_tables(v, f, k=32)
    table, safe = convert.anchor_tables_from_arrays(
        np.asarray(jt), np.asarray(js), device="cpu")
    assert table.dtype == torch.int32 and safe.dtype == torch.float32
    ref = _np(janchored.closest_point_anchored(v, f, q, jt, js))
    out = _np(tanchored.closest_point_anchored(v, f, q, table, safe,
                                               device="cpu"))
    if scale == 1.0:
        assert_tie_contract(ref, out, v, f, q)
    else:
        _assert_scaled(ref, out, scale)
    slack = 1e-5 * max(np.abs(v - v.mean(0)).max(), 1.0)
    differ = out["tight"] != ref["tight"]
    if differ.any():
        margin = _anchor_margin64(v, q[differ], np.asarray(js), slack)
        assert margin.max() <= 1e-4 * scale, margin.max()
    assert 0.5 < out["tight"].mean()


@pytest.mark.parametrize("scale", [1.0, 1000.0])
def test_tight_anchored_answers_equal_brute(scale):
    """Every tight anchored answer is the plain scan's up to ties, at unit
    and at millimetre scale (tests/test_anchored.py:70-130)."""
    v, f, q = _case(sub=3, seed=6, n=400, noise=0.03)
    v, q = (v * scale).astype(np.float32), (q * scale).astype(np.float32)
    tables = tanchored.build_anchor_tables(v, f, k=24, device="cpu")
    res = _np(tanchored.closest_point_anchored(v, f, q, *tables,
                                               device="cpu"))
    tight = res["tight"]
    assert tight.mean() > 0.5
    scan = {k: x[tight] for k, x in _scan(v, f, q).items()}
    res = {k: res[k][tight] for k in KEYS}
    if scale != 1.0:
        _assert_scaled(scan, res, scale)
        return
    np.testing.assert_allclose(res["sqdist"], scan["sqdist"], atol=1e-6,
                               rtol=1e-5)
    same = res["face"] == scan["face"]
    assert same.mean() > 0.9
    np.testing.assert_allclose(res["point"][same], scan["point"][same],
                               atol=1e-5)
    np.testing.assert_array_equal(res["part"][same], scan["part"][same])


@pytest.mark.parametrize("knob", [False, True])
def test_anchored_tree_matches_reference(monkeypatch, knob):
    if knob:
        monkeypatch.setenv("MESH_TPU_FORCE_XLA", "1")
    v, f, q = _case(sub=3, seed=8, n=256, noise=0.3)
    ref_f, ref_p = JaxAabbTree(_M(v, f), strategy="anchored").nearest(q)
    tree = mesh_tpu_torch.Mesh(v, f, device="cpu").compute_aabb_tree(
        strategy="anchored")
    brute = []

    def counted(*args, **kw):
        brute.append(1)
        return kernel(*args, **kw)
    kernel = ck.closest_point_kernel
    monkeypatch.setattr(ck, "closest_point_kernel", counted)
    out_f, out_p = tree.nearest(q)
    assert tree._tables is not None
    assert out_f.dtype == np.uint32 and out_f.shape == ref_f.shape
    assert_tie_contract(
        {"face": ref_f[0], "part": np.zeros(q.shape[0], np.int32),
         "point": ref_p, "sqdist": ((ref_p - q) ** 2).sum(-1)},
        {"face": out_f[0], "part": np.zeros(q.shape[0], np.int32),
         "point": out_p, "sqdist": ((out_p - q) ** 2).sum(-1)}, v, f, q)
    tables = tree._tables
    again_f, again_p = tree.nearest(q)
    assert tree._tables is tables
    np.testing.assert_array_equal(again_f, out_f)
    np.testing.assert_array_equal(again_p, out_p)
    # the loose queries re-run through the brute-force kernel's route
    # without the knob (once a call), through the plain scan with it
    assert len(brute) == (0 if knob else 2)


# -- the top-k culled rung ----------------------------------------------------

def test_topk_culled_matches_reference():
    v, f, q = _case(sub=3, seed=9, n=300, noise=0.05)
    ref = _np(jculled.closest_faces_and_points_culled(v, f, q, k=16))
    out = _np(tculled.closest_faces_and_points_culled(
        *_t(v, f.astype(np.int64), q), k=16))
    assert_tie_contract(ref, out, v, f, q)
    differ = out["tight"] != ref["tight"]
    assert differ.mean() < 0.02
    assert 0.0 < out["tight"].mean() < 1.0


@pytest.mark.parametrize("rung,brute_max", [("xla_brute", 5000),
                                            ("xla_culled", 100)])
def test_auto_xla_rungs_match_reference(force_xla, rung, brute_max):
    v, f, q = _case(sub=3, seed=10, n=300, noise=0.05)
    ref = jculled.closest_faces_and_points_auto(v, f, q, brute_max, 8)
    tculled.STRATEGY.clear()
    fallback = REGISTRY.counter("mesh_tpu_query_certificate_fallback_total")
    before = fallback.value()
    out = tculled.closest_faces_and_points_auto(v, f, q, brute_max, 8,
                                                device="cpu")
    assert tculled.STRATEGY == {rung: 1}
    assert_tie_contract(ref, out, v, f, q)
    # exact by its fallback: the plain scan's answer bit for bit
    if rung == "xla_brute":
        scan = _scan(v, f, q)
        for key in KEYS:
            np.testing.assert_array_equal(out[key], scan[key])
    else:
        assert fallback.value() > before


# -- the plain walks ----------------------------------------------------------

def _index_pair(kind, v, f):
    ref = (jbuild.build_bvh(v, f) if kind == "bvh"
           else jbuild.build_grid(v, f))
    return ref, convert.accel_index_from_arrays(
        ref.kind, ref.digest, {k: np.asarray(a) for k, a in ref.arrays.items()},
        ref.meta)


@pytest.mark.parametrize("kind", ["bvh", "grid"])
def test_walk_matches_reference_on_its_index(kind):
    v, f, q = _case(sub=3, seed=11, n=300, noise=0.02)
    ref_idx, idx = _index_pair(kind, v, f)
    walk = (ttraverse.bvh_closest_point if kind == "bvh"
            else ttraverse.grid_closest_point)
    jwalk = (jtraverse.bvh_closest_point if kind == "bvh"
             else jtraverse.grid_closest_point)
    ref = _np(jwalk(v, f, q, index=ref_idx))
    out = _np(walk(v, f, q, index=idx, device="cpu"))
    np.testing.assert_array_equal(out["pair_tests"], ref["pair_tests"])
    if kind == "bvh":
        np.testing.assert_array_equal(out["steps"], ref["steps"])
        assert out["tight"].all()
    np.testing.assert_array_equal(out["tight"], ref["tight"])
    assert_tie_contract(ref, out, v, f, q)


@pytest.mark.parametrize("route", ["grid", "bvh_forced", "bvh_stream_off"])
def test_accel_plain_route_equals_plain_scan(monkeypatch, route):
    """The accel facade's plain walks equal the plain scan bit for bit,
    and the reference's facade under the tie contract."""
    v, f, q = _case(sub=3, seed=12, n=300, noise=0.1)
    kind = "grid" if route == "grid" else "bvh"
    if route == "bvh_forced":
        monkeypatch.setenv("MESH_TPU_FORCE_XLA", "1")
    if route == "bvh_stream_off":
        monkeypatch.setenv("MESH_TPU_BVH_STREAM", "0")
        monkeypatch.setattr(ttraverse, "PALLAS_BVH_MAX_FACES", 100)
    launches = dict(rk.LAUNCHES)
    out, stats = ttraverse.closest_faces_and_points_accel(
        v, f, q, kind=kind, with_stats=True, device="cpu")
    assert stats["backend"] == "xla" and stats["kind"] == kind
    assert dict(rk.LAUNCHES) == launches
    scan = _scan(v, f, q)
    for key in KEYS:
        np.testing.assert_array_equal(out[key], scan[key], err_msg=key)
    ref = jtraverse.closest_faces_and_points_accel(v, f, q, kind=kind)
    assert_tie_contract(ref, out, v, f, q)
    if kind == "grid":
        assert stats["fallback"] > 0 and stats["tight_frac"] < 1.0


def test_walk_step_cap_makes_loose_certificates(monkeypatch):
    v, f, q = _case(sub=2, seed=13, n=64)
    monkeypatch.setattr(ttraverse, "WALK_SYNC_STEPS", 3)
    idx = tbuild.build_bvh(v, f)
    arr = idx.on(torch.device("cpu"))
    skip = arr["node_skip"].clone()
    skip[:] = 0                      # a corrupted rope: every node loops
    out = ttraverse._bvh_query(
        *_t(v, f.astype(np.int64), q), arr["order"].long(), arr["node_lo"],
        arr["node_hi"], skip, arr["node_leaf"], arr["center"],
        float(idx.meta["prune_slack"]), idx.meta["leaf_size"])
    assert not out["tight"].any()
    assert (out["steps"] == idx.meta["n_nodes"] + 1).all()


# -- rays, intersections, visibility, normal-weighted -------------------------

def test_alongnormal_xla_matches_reference(force_xla):
    v, f = small_body(seed=14)
    rng = np.random.RandomState(14)
    q = (rng.randn(200, 3) * 0.3).astype(np.float32)
    n = rng.randn(200, 3).astype(np.float32)
    jd, jf, jp = (np.asarray(x) for x in
                  jray._nearest_alongnormal_xla(v, f, q, n))
    td, tf_, tp = (x.numpy() for x in
                   tray.nearest_alongnormal(v, f, q, n, 64, device="cpu"))
    tri = v[f]
    border = borderline_rays(q, n, tri, t_lo=None) | borderline_rays(
        q, -n, tri, t_lo=None)
    hit_j, hit_t = np.isfinite(jd), np.isfinite(td)
    assert (hit_j != hit_t)[~border].sum() == 0
    both = hit_j & hit_t & ~border
    np.testing.assert_allclose(td[both], jd[both], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tp[both], jp[both], atol=1e-5)
    assert (tf_ == jf)[both].mean() > 0.99
    tree = mesh_tpu_torch.Mesh(v, f, device="cpu").compute_aabb_tree()
    dist, faces, _ = tree.nearest_alongnormal(q, n)
    assert dist.dtype == np.float64 and faces.dtype == np.uint32
    np.testing.assert_array_equal(np.isfinite(td), dist < 1e100)


@pytest.mark.parametrize("shift", [0.05, 0.3])
def test_intersections_mask_xla_matches_reference(force_xla, shift):
    v, f = small_body(seed=15)
    qv, qf = small_body(seed=16)
    qv = (qv + np.array([shift, 0.0, 0.0])).astype(np.float32)
    ref = np.asarray(jray._intersections_mask_xla(v, f, qv, qf))
    launches = dict(ck.LAUNCHES)
    out = tray.intersections_mask(v, f, qv, qf, 32, device="cpu").numpy()
    border = borderline_queries(qv[qf], v[f])
    assert (out != ref)[~border].sum() == 0
    assert out.any()
    tree = mesh_tpu_torch.Mesh(v, f, device="cpu").compute_aabb_tree()
    np.testing.assert_array_equal(
        tree.intersections_indices(qv, qf.astype(np.uint32)),
        np.nonzero(out)[0])
    assert dict(ck.LAUNCHES) == launches


def test_self_intersection_xla_matches_reference(force_xla):
    v, f = small_body(seed=17)
    v2 = v.copy()
    v2[:, 0] += 0.25                 # a second shell through the first
    vv = np.vstack([v, v2]).astype(np.float32)
    ff = np.vstack([f, f + v.shape[0]]).astype(np.int32)
    ref = int(jray._self_intersection_count_xla(vv, ff))
    out = int(tray.self_intersection_count(vv, ff, 48, device="cpu"))
    border = borderline_queries(vv[ff], vv[ff]).sum()
    assert abs(out - ref) <= border
    assert out > 0
    assert int(tray.self_intersection_count(v, f, device="cpu")) == 0


def test_visibility_xla_matches_reference(force_xla):
    v, f = small_body(seed=18)
    cams = np.array([[2.0, 0, 0], [0, 2.0, 0.5]], np.float32)
    sensors = np.tile(np.eye(3, dtype=np.float32).reshape(1, 9) * 2.0,
                      (2, 1))
    rng = np.random.RandomState(18)
    n = rng.randn(*v.shape).astype(np.float32)
    shares = []
    for sens in (None, sensors):
        jv, jn = jvis.visibility_compute(v, f, cams, n=n, sensors=sens)
        tv, tn = tvis.visibility_compute(v, f, cams, n=n, sensors=sens,
                                         device="cpu")
        np.testing.assert_allclose(tn, jn, atol=1e-6)
        for c in range(cams.shape[0]):
            d = cams[c] - v
            d = d / np.linalg.norm(d, axis=1, keepdims=True)
            border = borderline_rays(v + 1e-3 * d, d, v[f])
            assert (tv[c] != jv[c])[~border].sum() == 0
        shares.append(tv.mean())
    assert 0 < shares[0] < 1


def test_normal_weighted_xla_matches_reference(force_xla):
    v, f = small_body(seed=19)
    rng = np.random.RandomState(19)
    q = (rng.randn(200, 3) * 0.4).astype(np.float32)
    n = rng.randn(200, 3).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    jf, jp = (np.asarray(x) for x in jax_nearest_nw(v, f, q, n, eps=0.1))
    tf_, tp = nearest_normal_weighted_xla(*_t(v, f.astype(np.int64), q, n))
    assert_nw_tie_contract(jf, jp, tf_.numpy(), tp.numpy(), v, f, q, n, 0.1)
    tree = mesh_tpu_torch.Mesh(v, f, device="cpu").compute_aabb_normals_tree()
    face, point = tree.nearest(q, n)
    np.testing.assert_array_equal(face[:, 0], tf_.numpy().astype(np.uint32))
    np.testing.assert_array_equal(point, tp.numpy().astype(np.float64))


# -- the batched facades, the engine and diff ---------------------------------

def test_batched_facades_take_the_plain_step(force_xla):
    vs, qs = [], []
    for b in range(3):
        v, f = sphere(2, seed=20 + b)
        vs.append(v)
        qs.append(surface_queries(v, f, 96, seed=30 + b))
    vs, qs = np.stack(vs), np.stack(qs)
    launches = [dict(c) for c in (ck.LAUNCHES, rk.LAUNCHES)]
    ref_f, ref_p = jbatch.batched_closest_faces_and_points((vs, f), qs)
    out_f, out_p = tbatch.batched_closest_faces_and_points((vs, f), qs,
                                                           device="cpu")
    assert out_f.dtype == np.uint32 and out_f.shape == ref_f.shape
    for b in range(3):
        scan = _scan(vs[b], f, qs[b])
        np.testing.assert_array_equal(out_f[b, 0], scan["face"])
        np.testing.assert_array_equal(out_p[b], scan["point"])
        sq = ((ref_p[b] - qs[b]) ** 2).sum(-1)
        assert_tie_contract(
            {"face": ref_f[b, 0], "part": scan["part"], "point": ref_p[b],
             "sqdist": sq},
            {"face": out_f[b, 0], "part": scan["part"], "point": out_p[b],
             "sqdist": ((out_p[b] - qs[b]) ** 2).sum(-1)}, vs[b], f, qs[b])
    normals, res = tbatch.batch_step(*_t(vs, f.astype(np.int64), qs),
                                     use_pallas=False)
    np.testing.assert_array_equal(res["face"].numpy()[:, None], out_f)
    m = mesh_tpu_torch.Mesh(vs[0], f, device="cpu")
    faces, points = m.closest_faces_and_points(qs[0])
    np.testing.assert_array_equal(faces[0], out_f[0, 0])
    np.testing.assert_array_equal(points, out_p[0])
    idx, dist = m.closest_vertices(qs[0])
    jidx, jdist = mesh_tpu.Mesh(v=vs[0], f=f).closest_vertices(qs[0])
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_allclose(dist, jdist, atol=1e-6)
    cams = np.array([[3.0, 0, 0], [0, 3.0, 0]], np.float32)
    jv, jn = jbatch.batched_vertex_visibility((vs, f), cams)
    tv, tn = tbatch.batched_vertex_visibility((vs, f), cams, device="cpu")
    assert tv.shape == jv.shape and (tv != jv).mean() < 0.01
    np.testing.assert_allclose(tn, jn, atol=1e-5)
    assert [dict(c) for c in (ck.LAUNCHES, rk.LAUNCHES)] == launches


def test_diff_closest_point_walks_the_plain_bvh(force_xla):
    v, f, q = _case(sub=3, seed=21, n=200)
    idx = tbuild.get_index(v, f, kind="bvh")
    walk = ttraverse.bvh_search_faces(idx, *_t(v, f.astype(np.int64), q))
    res = diff.closest_point(v, f, q, accel_index=idx, device="cpu")
    np.testing.assert_array_equal(res["face"].numpy(), walk.numpy())
    np.testing.assert_array_equal(walk.numpy(), _scan(v, f, q)["face"])
    plain = diff.closest_point(v, f, q, device="cpu")
    np.testing.assert_array_equal(plain["face"].numpy(), walk.numpy())


# -- signatures and counters --------------------------------------------------

SIGNATURES = [
    (jculled.closest_faces_and_points_auto,
     tculled.closest_faces_and_points_auto),
    (jclosest.closest_vertices, tclosest.closest_vertices),
    (jclosest.closest_vertices_with_distance,
     tclosest.closest_vertices_with_distance),
    (jray.nearest_alongnormal, tray.nearest_alongnormal),
    (jray.intersections_mask, tray.intersections_mask),
    (jray.self_intersection_count, tray.self_intersection_count),
    (jclosest.closest_point_dispatch, tclosest.closest_point_dispatch),
]


@pytest.mark.parametrize("ref,port", SIGNATURES,
                         ids=[r.__name__ for r, _ in SIGNATURES])
def test_signature_matches_reference(ref, port):
    ref_sig = inspect.signature(ref)
    params = list(inspect.signature(port).parameters.values())
    positional = [p for p in params if p.kind != p.KEYWORD_ONLY]
    assert [(p.name, p.default) for p in positional] == [
        (p.name, p.default) for p in ref_sig.parameters.values()]
    assert all(p.name == "device" for p in params
               if p.kind == p.KEYWORD_ONLY)


def test_positional_chunk_keeps_its_meaning(force_xla):
    v, f, q = _case(sub=2, seed=22, n=200)
    ref_i, ref_d = (np.asarray(x) for x in
                    jclosest.closest_vertices_with_distance(v, q, 512))
    out_i, out_d = tclosest.closest_vertices_with_distance(v, q, 512,
                                                           device="cpu")
    np.testing.assert_array_equal(out_i.numpy(), ref_i)
    np.testing.assert_allclose(out_d.numpy(), ref_d, atol=1e-6)
    np.testing.assert_array_equal(
        tclosest.closest_vertices(v, q, 512, device="cpu").numpy(), ref_i)
    out = tculled.closest_faces_and_points_auto(v, f, q, None, 64, 512,
                                                device="cpu")
    assert_tie_contract(jculled.closest_faces_and_points_auto(
        v, f, q, None, 64, 512), out, v, f, q)


def _labels(registry, name):
    metric = registry.get(name)
    return {} if metric is None else {
        tuple(sorted(s["labels"].items())): s["value"]
        for s in metric.snapshot()["series"]}


@pytest.mark.parametrize("rung,knobs_set", [
    ("xla_brute", {}), ("xla_culled", {"MESH_TPU_BRUTE_MAX_FACES": "100"}),
    ("accel_bvh", {"MESH_TPU_ACCEL_MIN_FACES": "100"}),
    ("accel_grid", {"MESH_TPU_ACCEL_MIN_FACES": "100",
                    "MESH_TPU_ACCEL_KIND": "grid"})])
def test_strategy_labels_match_reference(force_xla, rung, knobs_set):
    from mesh_tpu.obs.metrics import REGISTRY as JREG

    for name, value in knobs_set.items():
        force_xla.setenv(name, value)
    v, f, q = _case(sub=2, seed=23, n=64)
    name = "mesh_tpu_query_strategy_total"
    jbefore, tbefore = _labels(JREG, name), _labels(REGISTRY, name)
    jculled.closest_faces_and_points_auto(v, f, q)
    tculled.STRATEGY.clear()
    tculled.closest_faces_and_points_auto(v, f, q, device="cpu")
    assert tculled.STRATEGY == {rung: 1}

    def added(after, before):
        return {k: n - before.get(k, 0) for k, n in after.items()
                if n != before.get(k, 0)}
    assert added(_labels(REGISTRY, name), tbefore) == \
        added(_labels(JREG, name), jbefore) == {(("path", rung),): 1}
