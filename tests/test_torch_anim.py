"""mesh_tpu_torch's animated-mesh refit (leaf-box kernel, refit_bvh,
RefitState) vs mesh_tpu's, on the CPU.

min and max round nothing, so leaf boxes, node boxes and the f64 box
measure are held to equality (the measure also to 1e-12 relative, the
contract when the summation order differs), and refit/rebuild action
sequences to identity.  mesh_tpu's leaf-box kernel runs in interpret mode,
as its bench stage runs it.  Answers through a refit index are held to
sqdist within 1e-5 and faces equal except at ties: the refit keeps the
base's frozen center and Morton order, a fresh build has its own, so the
walk and the epilogue round in another frame and near-ties may resolve to
other faces (whose closest points may then differ).
"""

import numpy as np
import pytest
import torch

from mesh_tpu.accel import build as jbuild
from mesh_tpu.accel import traverse as jtraverse
from mesh_tpu.accel.pallas_refit import leaf_boxes_pallas
from mesh_tpu.anim import refit as jrefit
from mesh_tpu.sphere import _icosphere

from mesh_tpu_torch.accel import build as tbuild
from mesh_tpu_torch.accel import refit_kernel as rk
from mesh_tpu_torch.accel.traverse import closest_faces_and_points_accel
from mesh_tpu_torch.anim import refit as trefit
from mesh_tpu_torch.query.point_triangle import closest_point_on_triangle

from .test_torch_closest import TIE_TOL, VALUE_TOL
from .test_torch_culled import surface_queries

torch.set_num_threads(2)

CPU = torch.device("cpu")

#: relative bound on the f64 box measure when two sums run in other orders
MEASURE_RTOL = 1e-12


def sphere(subdiv=3):
    v, f = _icosphere(subdiv)
    return np.asarray(v, np.float32), np.asarray(f, np.int32)


def deform(v, seed, amp=0.05):
    rng = np.random.RandomState(seed)
    return np.asarray(v + amp * rng.randn(*v.shape), np.float32)


@pytest.fixture(autouse=True)
def _fresh_caches():
    tbuild.clear_index_cache()
    jbuild.clear_index_cache()
    yield
    tbuild.clear_index_cache()
    jbuild.clear_index_cache()


def assert_tie_answers(ref, out, v, f, q):
    """``out`` against ``ref`` (numpy dicts): sqdist within VALUE_TOL, and
    faces equal except at ties, where the two faces' float64 distances to
    the query are within TIE_TOL; points and parts equal to VALUE_TOL where
    the faces are the same (at a tie the two faces' points may differ).
    Returns the share of equal faces."""
    ref = {k: np.asarray(x) for k, x in ref.items()}
    np.testing.assert_allclose(out["sqdist"], ref["sqdist"], atol=VALUE_TOL)
    same = ref["face"] == out["face"]
    np.testing.assert_allclose(out["point"][same], ref["point"][same],
                               atol=VALUE_TOL)
    np.testing.assert_array_equal(out["part"][same], ref["part"][same])
    if not same.all():
        tri = torch.from_numpy(v.astype(np.float64))[torch.from_numpy(
            f.astype(np.int64))]
        qd = torch.from_numpy(q.astype(np.float64))[torch.from_numpy(~same)]

        def sqd(face):
            t = tri[torch.from_numpy(face[~same].astype(np.int64))]
            return closest_point_on_triangle(qd, t[:, 0], t[:, 1], t[:, 2])[1]

        gap = (sqd(out["face"]) - sqd(ref["face"])).abs().max()
        assert float(gap) <= TIE_TOL, float(gap)
    return same.mean()


def _tri_s(index, v, f):
    vc = v - index.arrays["center"]
    return np.ascontiguousarray(vc[f][index.arrays["order"]])


# -- the leaf-box kernel -----------------------------------------------------

@pytest.mark.parametrize("case", ["deformed", "nan", "signed_zero"])
@pytest.mark.parametrize("leaf_size", [8, 64, 256])
def test_leaf_boxes_match_reference(leaf_size, case):
    """Plain version and wrapper (CPU) equal mesh_tpu's numpy twin and its
    Pallas kernel in interpret mode on every leaf, NaN leaves included."""
    v, f = sphere()
    index = tbuild.build_bvh(v, f, leaf_size=leaf_size)
    n_leaves = index.meta["n_leaves"]
    tri_s = _tri_s(index, deform(v, leaf_size), f)
    nan_leaves = np.zeros(n_leaves, bool)
    if case == "nan":
        for leaf, corner in ((0, 5), (n_leaves - 1, 0), (n_leaves // 2, 2)):
            face = leaf * leaf_size + corner // 3
            tri_s[face, corner % 3, 1] = np.nan
            nan_leaves[leaf] = True
    elif case == "signed_zero":
        # whole leaves whose x is all zeros of both signs, and a leaf
        # whose z straddles them
        tri_s[:leaf_size, :, 0] = -0.0
        tri_s[:leaf_size // 2, :, 0] = 0.0
        tri_s[leaf_size:2 * leaf_size, :, 2] = np.where(
            tri_s[leaf_size:2 * leaf_size, :, 2] > 0, 0.0, -0.0)
    ref = jrefit.refit_leaf_boxes(tri_s, n_leaves, leaf_size)
    pallas = leaf_boxes_pallas(tri_s, n_leaves, leaf_size, interpret=True)
    t = torch.from_numpy(tri_s)
    before = dict(rk.LAUNCHES)
    outs = {"plain": rk.leaf_boxes_plain(t, n_leaves, leaf_size),
            "wrapper": rk.leaf_boxes_kernel(t, n_leaves, leaf_size),
            "numpy": trefit.refit_leaf_boxes(tri_s, n_leaves, leaf_size)}
    assert rk.LAUNCHES == before       # the CPU takes the plain version
    for name, (lo, hi) in outs.items():
        lo, hi = np.asarray(lo), np.asarray(hi)
        assert lo.dtype == hi.dtype == np.float32
        for got, want, ker in ((lo, ref[0], pallas[0]),
                               (hi, ref[1], pallas[1])):
            # array_equal semantics: NaN equals NaN, -0.0 equals 0.0
            np.testing.assert_array_equal(got, want, err_msg=name)
            np.testing.assert_array_equal(got, np.asarray(ker), err_msg=name)
            np.testing.assert_array_equal(np.isnan(got).any(axis=1),
                                          nan_leaves, err_msg=name)


def test_leaf_boxes_rejects_a_layout_that_does_not_fit():
    t = torch.zeros((24, 3, 3))
    with pytest.raises(ValueError, match="layout says 4 leaves x 8"):
        rk.leaf_boxes_kernel(t, 4, 8)
    with pytest.raises(ValueError, match="float32"):
        rk.leaf_boxes_kernel(t.double(), 3, 8)
    with pytest.raises(ValueError):
        leaf_boxes_pallas(t.numpy(), 4, 8, interpret=True)


# -- refit_bvh ---------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["host", "pallas"])
@pytest.mark.parametrize("seed,leaf_size", [(1, 8), (2, 8), (3, 256)])
def test_refit_bvh_matches_reference(seed, leaf_size, kernel):
    v, f = sphere()
    jbase = jbuild.build_bvh(v, f, leaf_size=leaf_size)
    tbase = tbuild.build_bvh(v, f, leaf_size=leaf_size)
    base_t = tbase.on(CPU)
    v2 = deform(v, seed)
    jref, jinfo = jrefit.refit_bvh(jbase, v2, f)
    out, info = trefit.refit_bvh(tbase, torch.from_numpy(v2)
                                 if kernel == "pallas" else v2, f,
                                 kernel=kernel, device="cpu")
    for name in ("node_lo", "node_hi"):
        np.testing.assert_array_equal(out.arrays[name],
                                      np.asarray(jref.arrays[name]))
    assert info["box_measure"] == pytest.approx(jinfo["box_measure"],
                                                rel=MEASURE_RTOL)
    assert out.digest == tbase.digest == jref.digest
    assert out.meta == tbase.meta == jref.meta
    shared = out.on(CPU)
    for name in ("order", "node_skip", "node_leaf", "center"):
        assert out.arrays[name] is tbase.arrays[name]
        assert shared[name] is base_t[name]      # not uploaded again
    np.testing.assert_array_equal(shared["node_lo"].numpy(),
                                  out.arrays["node_lo"])


@pytest.mark.parametrize("leaf_size", [8, 256])
def test_keyframe_refit_reproduces_build_boxes(leaf_size):
    v, f = sphere()
    base = tbuild.build_bvh(v, f, leaf_size=leaf_size)
    for kernel in ("host", "pallas"):
        out, info = trefit.refit_bvh(base, v, f, kernel=kernel, device="cpu")
        for name in ("node_lo", "node_hi"):
            np.testing.assert_array_equal(out.arrays[name],
                                          base.arrays[name])
        assert info["box_measure"] == trefit.box_measure(
            base.arrays["node_lo"], base.arrays["node_hi"])


@pytest.mark.parametrize("depth", [0, 1, 4, 9])
def test_level_boxes_and_preorder_positions_match_reference(depth):
    for a, b in zip(trefit._preorder_positions(depth),
                    jrefit._preorder_positions(depth)):
        np.testing.assert_array_equal(a, b)
    rng = np.random.RandomState(depth)
    lo = rng.randn(1 << depth, 3).astype(np.float32)
    hi = lo + rng.rand(1 << depth, 3).astype(np.float32)
    for mine, theirs in zip(trefit._level_boxes(lo, hi),
                            jrefit._level_boxes(lo, hi)):
        assert len(mine) == len(theirs) == depth + 1
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a, b)
    assert trefit.box_measure(lo, hi) == pytest.approx(
        jrefit.box_measure(lo, hi), rel=MEASURE_RTOL)


def test_refit_rejects_a_bad_index_or_kernel():
    v, f = sphere(1)
    base = tbuild.build_bvh(v, f)
    with pytest.raises(ValueError, match="unknown refit kernel"):
        trefit.refit_bvh(base, v, f, kernel="xla", device="cpu")
    grid = tbuild.AccelIndex("grid", base.digest, base.arrays, base.meta)
    with pytest.raises(ValueError, match="bvh"):
        trefit.refit_bvh(grid, v, f, device="cpu")


# -- RefitState --------------------------------------------------------------

def _frames(v):
    """A gentle deform, a growing scale, the 20x stretch of
    tests/test_anim.py, then refits from the re-anchored reference."""
    out = [deform(v, 7, amp=0.01)]
    out += [np.asarray(v * s, np.float32) for s in (1.1, 1.2, 1.3)]
    stretched = np.asarray(v * 20.0, np.float32)
    out += [stretched, np.asarray(stretched * 1.001, np.float32),
            deform(stretched, 8, amp=0.5)]
    return out


@pytest.mark.parametrize("kernel", ["host", "pallas"])
def test_refit_state_action_sequence_matches_reference(kernel):
    v, f = sphere()
    jstate = jrefit.RefitState(jbuild.build_bvh(v, f), f)
    tstate = trefit.RefitState(tbuild.build_bvh(v, f), f, kernel=kernel,
                               device="cpu")
    actions = []
    for frame in _frames(v):
        _, ja = jstate.advance(frame)
        idx, ta = tstate.advance(torch.from_numpy(frame)
                                 if kernel == "pallas" else frame)
        assert ta == ja
        assert tstate.inflation == pytest.approx(jstate.inflation,
                                                 rel=MEASURE_RTOL)
        actions.append(ta)
    assert "refit" in actions and "rebuild" in actions
    assert tstate.stats()["refits"] == jstate.refits
    assert tstate.stats()["rebuilds"] == jstate.rebuilds
    assert tstate.ref_measure == pytest.approx(jstate.ref_measure,
                                               rel=MEASURE_RTOL)


def test_adversarial_stretch_trips_rebuild_deterministically():
    from mesh_tpu_torch import obs
    from mesh_tpu_torch.obs.metrics import REGISTRY

    v, f = sphere()
    state = trefit.RefitState(tbuild.build_bvh(v, f), f, device="cpu")
    obs.reset()
    _idx, action = state.advance(deform(v, 7, amp=0.01))
    assert action == "refit" and state.inflation >= 1.0
    stretched = np.asarray(v * 20.0, np.float32)
    idx, action = state.advance(stretched, max_inflation=1.5)
    assert action == "rebuild" and state.inflation == 1.0
    assert state.rebuilds == 1 and state.refits == 1
    assert REGISTRY.get("mesh_tpu_anim_rebuilds_total").value(
        reason="inflation") == 1
    assert REGISTRY.get("mesh_tpu_anim_refits_total").value() == 1
    # the rebuilt index IS the digest-cache entry of the stretched mesh
    assert idx is tbuild.get_index(stretched, f, kind="bvh",
                                   leaf_size=state.leaf_size)
    _idx, action = state.advance(np.asarray(stretched * 1.001, np.float32),
                                 max_inflation=1.5)
    assert action == "refit"


def test_env_pin_moves_the_crossover(monkeypatch):
    assert trefit.refit_max_inflation() == jrefit.refit_max_inflation() == 1.5
    for pin, want in (("3.5", 3.5), ("not-a-number", 1.5)):
        monkeypatch.setenv("MESH_TPU_ANIM_REFIT_MAX_INFLATION", pin)
        assert trefit.refit_max_inflation() == pytest.approx(want)
        assert trefit.refit_max_inflation() == jrefit.refit_max_inflation()
    v, f = sphere(1)
    state = trefit.RefitState(tbuild.build_bvh(v, f), f, device="cpu")
    big = np.asarray(v * 1.5, np.float32)
    monkeypatch.setenv("MESH_TPU_ANIM_REFIT_MAX_INFLATION", "4.0")
    assert state.advance(big)[1] == "refit"
    monkeypatch.setenv("MESH_TPU_ANIM_REFIT_MAX_INFLATION", "1.05")
    state = trefit.RefitState(tbuild.build_bvh(v, f), f, device="cpu")
    assert state.advance(big)[1] == "rebuild"


# -- answers through a refit index -------------------------------------------

@pytest.mark.parametrize("seed", [4, 5, 6])
def test_refit_index_answers_match_fresh_build_and_reference(seed):
    """The plain rope walk over a refit index (leaves of the walk's 256)
    against a fresh build's walk and mesh_tpu's CPU accel route over its
    own refit index: sqdist to 1e-5, faces equal except at ties."""
    v, f = sphere()
    v2 = deform(v, seed)
    q = surface_queries(v2, f, 400, seed=seed + 10)
    tbase = tbuild.get_index(v, f, kind="bvh", leaf_size=256)
    refit, _ = trefit.refit_bvh(tbase, torch.from_numpy(v2), f,
                                kernel="pallas", device="cpu")
    out, stats = closest_faces_and_points_accel(v2, f, q, index=refit,
                                                with_stats=True, device="cpu")
    assert stats["backend"] == "rope_resident" and stats["fallback"] == 0
    # the walk used the refit index itself: no build of the deformed mesh
    assert tbuild.index_cache_info()["entries"] == 1
    fresh = closest_faces_and_points_accel(v2, f, q, device="cpu")
    assert tbuild.index_cache_info()["entries"] == 2
    # (an icosphere's queries near shared vertices and edges tie often)
    assert assert_tie_answers(fresh, out, v2, f, q) > 0.9
    jref, _ = jrefit.refit_bvh(jbuild.build_bvh(v, f), v2, f)
    ref = jtraverse.closest_faces_and_points_accel(v2, f, q, index=jref)
    assert assert_tie_answers(ref, out, v2, f, q) > 0.9
    # sqdist of the port's refit and fresh walks: the same faces except at
    # ties, each recomputed exactly in its own centered frame
    np.testing.assert_allclose(out["sqdist"], fresh["sqdist"], atol=TIE_TOL)
