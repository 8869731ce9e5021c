"""mesh_tpu_torch.parallel's sharded queries and sharded fit, on the CPU.

One world of 4 gloo ranks (``_torch_world``) runs every multi-rank case
once (``_torch_parallel_cases.parallel_world``); the tests hold its
results against the reference's SINGLE-DEVICE functions (its own sharded
tests need the 8-device simulator and are slow), under the port's parity
contract: faces equal except at exact ties, points and sqdist within
1e-5, visibility flag for flag except on rounding-borderline rays, the
sharded fit's first step within 1e-5 of the unsharded one.  Against the
port's own single-device functions the sharded results are bit-equal, the
two face-sharded merges equal each other, and every rank holds the same
answer.  The single-device landmark fit (TestLandmarkFit) runs here too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mesh_tpu.geometry import vert_normals as jax_vert_normals
from mesh_tpu.models import body_model as jbm
from mesh_tpu.parallel import fit as jfit
from mesh_tpu.query import closest_faces_and_points as jax_closest
from mesh_tpu.query import visibility_compute as jax_visibility

from mesh_tpu_torch import parallel as par
from mesh_tpu_torch.convert import FIT_PARAMS
from mesh_tpu_torch.geometry.vert_normals import vert_normals_t
from mesh_tpu_torch.models import body_model as tbm
from mesh_tpu_torch.parallel import fit
from mesh_tpu_torch.query import closest_kernel as ck
from mesh_tpu_torch.query.visibility import visibility_compute

from ._torch_world import run_world
from .fixtures import icosphere
from .test_torch_closest import TIE_TOL, VALUE_TOL
from .test_torch_ray import borderline_rays

torch.set_num_threads(2)

RANKS = 4
FIT_TOL = 1e-5
CAMS = np.array([[0, 0, 3.0], [3.0, 0, 0]], np.float32)


def _ico(level):
    v, f = icosphere(level)
    return v.astype(np.float32), f.astype(np.int32)


def _queries():
    return {name: (np.random.RandomState(seed).randn(n, 3)).astype(
        np.float32) for name, (seed, n) in {
            "q1000": (0, 1000), "q200": (3, 200), "q300": (5, 300),
            "q40": (6, 40), "q13": (5, 13), "q50": (4, 50),
            "q37": (1, 37)}.items()}


def _few_faces():
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
                  [2, 0, 0], [2, 1, 0], [0, 2, 0]], np.float32)
    f = np.array([[0, 1, 2], [1, 3, 2], [1, 4, 3]], np.int32)
    return v, f


def _template():
    v, f = _ico(1)
    return (v * np.array([0.3, 0.2, 0.9], np.float32)).astype(
        np.float32), f


def _jax_model():
    return jbm.synthetic_body_model(seed=0, n_betas=4, n_joints=6,
                                    template=_template())


def _fit_inputs():
    """A JAX state two steps in (moments and a count to carry), its arrays,
    and the reference's next step from it, unsharded."""
    jm = _jax_model()
    target = (np.random.RandomState(0).randn(8, 32, 3) * 0.5).astype(
        np.float32)
    jstate, jopt = jfit.init_fit_state(jm, 8)
    jstep = jfit.make_fit_step(jm, jopt)
    for _ in range(2):
        jstate, _ = jstep(jstate, jnp.asarray(target))
    adam = jstate.opt_state[0]
    arrays = {"params": {k: np.asarray(getattr(jstate, k))
                         for k in FIT_PARAMS},
              "count": np.asarray(adam.count),
              "mu": {k: np.asarray(adam.mu[k]) for k in FIT_PARAMS},
              "nu": {k: np.asarray(adam.nu[k]) for k in FIT_PARAMS}}
    jnext, jloss = jstep(jstate, jnp.asarray(target))
    return arrays, target, {"loss": float(jloss),
                            **{k: np.asarray(getattr(jnext, k))
                               for k in FIT_PARAMS}}


def _landmarks():
    regs = {"l%d" % i: (np.array([i * 7]), np.array([1.0]))
            for i in range(5)}
    idx, bary, _ = par.landmark_arrays(regs, device="cpu")
    target = (np.random.RandomState(2).randn(8, 5, 3) * 0.3).astype(
        np.float32)
    return idx.numpy(), bary.numpy(), target


@pytest.fixture(scope="module")
def world():
    """Every multi-rank case, run once: (inputs, per-rank results,
    the reference's fit step)."""
    v2, f2 = _ico(2)
    v1, f1 = _ico(1)
    rng = np.random.RandomState(2)
    v_nan = v2.copy()
    v_nan[f2[200][0]] = np.nan
    fit_state, target, jnext = _fit_inputs()
    inputs = {
        "ico2": (v2, f2), "ico1": (v1, f1), "queries": _queries(),
        "v_nan": v_nan, "few": _few_faces(), "cams": CAMS,
        "n2": np.asarray(jax_vert_normals(v2, f2)),
        "bodies_16": (v1[None] + 0.01 * rng.randn(16, *v1.shape)).astype(
            np.float32),
        "bodies_10": (v1[None] + 0.01 * rng.randn(10, *v1.shape)).astype(
            np.float32),
        "model_template": _template(), "fit_state": fit_state,
        "fit_target": target, "landmarks": _landmarks()}
    for nb in (8, 5):
        inputs["vis_bodies_%d" % nb] = (
            v2[None] * (1 + 0.1 * np.random.RandomState(3).rand(
                nb, 1, 1))).astype(np.float32)
    results = run_world(RANKS, "tests._torch_parallel_cases:parallel_world",
                        inputs, timeout=240)
    return inputs, results, jnext


def assert_tie_contract(ref, out, v, f, q):
    """The port's ``out`` against the reference's ``ref``: sqdist within
    VALUE_TOL; where the faces agree, parts equal and points within
    VALUE_TOL; where they differ, the reference's own distance to the
    port's face within TIE_TOL of its answer (an exact tie, whose points
    may lie apart, as for a query near the middle of a sphere)."""
    from mesh_tpu.query import point_triangle as jpt

    ref = {k: np.asarray(x) for k, x in ref.items()}
    face_o = np.asarray(out["face"])
    np.testing.assert_allclose(out["sqdist"], ref["sqdist"], atol=VALUE_TOL)
    same = ref["face"] == face_o
    np.testing.assert_array_equal(np.asarray(out["part"])[same],
                                  ref["part"][same])
    np.testing.assert_allclose(np.asarray(out["point"])[same],
                               ref["point"][same], atol=VALUE_TOL)
    if not same.all():
        center = v.astype(np.float32).mean(0)
        tri = (v.astype(np.float32) - center)[f[face_o[~same]]]
        _, sq_o, _ = jpt.closest_point_on_triangle(
            q[~same] - center, tri[:, 0], tri[:, 1], tri[:, 2])
        gap = np.abs(np.asarray(sq_o) - ref["sqdist"][~same])
        assert gap.max() <= TIE_TOL, gap.max()


def _same_on_every_rank(results, key):
    first = results[0][key]
    for other in results[1:]:
        a, b = first, other[key]
        if isinstance(a, dict):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        elif isinstance(a, tuple):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a, b)
    return first


def _port_single(v, f, q, **kw):
    res = ck.closest_point_kernel(torch.from_numpy(v),
                                  torch.from_numpy(f.astype(np.int64)),
                                  torch.from_numpy(q), **kw)
    return {k: val.numpy() for k, val in res.items()}


def _bits_equal(a, b):
    for key in ("face", "part", "sqdist", "point"):
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]))


def test_ranks_import_neither_jax_nor_the_reference(world):
    assert not any(r["jax_imported"] for r in world[1])


class TestShardedQueries:
    def test_closest_point_matches_single_device(self, world):
        inp, res, _ = world
        v, f = inp["ico2"]
        q = inp["queries"]["q1000"]
        out = _same_on_every_rank(res, "query_sharded")
        assert_tie_contract(jax_closest(v, f, q, chunk=128), out, v, f, q)
        _bits_equal(out, _port_single(
            v, f, q, assume_nondegenerate=ck.mesh_is_nondegenerate(v, f)))

    def test_xla_route_matches_single_device(self, world):
        """Under MESH_TPU_FORCE_XLA each shard takes the plain scan."""
        inp, res, _ = world
        v, f = inp["ico2"]
        q = inp["queries"]
        assert_tie_contract(jax_closest(v, f, q["q1000"], chunk=128),
                            _same_on_every_rank(res, "query_sharded_xla"),
                            v, f, q["q1000"])
        assert_tie_contract(jax_closest(v, f, q["q200"], chunk=64),
                            _same_on_every_rank(res, "face_sharded_xla"),
                            v, f, q["q200"])

    def test_face_sharded_matches_single_device(self, world):
        inp, res, _ = world
        v, f = inp["ico2"]
        q = inp["queries"]["q200"]
        out = _same_on_every_rank(res, "face_sharded")
        assert_tie_contract(jax_closest(v, f, q, chunk=64), out, v, f, q)
        _bits_equal(out, _port_single(v, f, q))

    def test_face_sharded_ring_merge_matches_gather(self, world):
        """Every face twice, so every query's best face sits in two
        shards: both merges keep the lowest global id, bit for bit, and
        equal the single-device kernel's answer."""
        inp, res, _ = world
        v, f = inp["ico2"]
        f2 = np.concatenate([f, f])
        q = inp["queries"]["q300"]
        ring = _same_on_every_rank(res, "dup_ring")
        gather = _same_on_every_rank(res, "dup_gather")
        _bits_equal(ring, gather)
        _bits_equal(ring, _port_single(v, f2, q))
        assert ring["face"].max() < len(f)
        assert_tie_contract(jax_closest(v, f2, q, chunk=64), ring, v, f2, q)

    def test_face_sharded_ring_nan_propagates_like_gather(self, world):
        inp, res, _ = world
        ring = _same_on_every_rank(res, "nan_ring")
        gather = _same_on_every_rank(res, "nan_gather")
        np.testing.assert_array_equal(np.isnan(ring["sqdist"]),
                                      np.isnan(gather["sqdist"]))
        np.testing.assert_array_equal(ring["face"], gather["face"])
        assert np.isnan(ring["sqdist"]).any()

    def test_face_sharded_merge_rejects_unknown(self):
        v, f = _ico(1)
        with pytest.raises(ValueError, match="gather.*ring"):
            par.sharded_closest_faces_sharded_topology(
                v, f, np.zeros((4, 3), np.float32), object(), merge="tree")

    def test_face_sharded_non_divisible_face_count(self, world):
        inp, res, _ = world
        v, f = inp["ico1"]
        q = inp["queries"]["q50"]
        out = _same_on_every_rank(res, "odd_faces")
        assert_tie_contract(jax_closest(v, f[:77], q, chunk=16), out, v,
                            f[:77], q)
        assert out["face"].max() < 77

    def test_face_sharded_fewer_faces_than_shards(self, world):
        inp, res, _ = world
        v, f = inp["few"]
        q = inp["queries"]["q13"]
        for merge in ("gather", "ring"):
            out = _same_on_every_rank(res, "few_" + merge)
            assert_tie_contract(jax_closest(v, f, q, chunk=8), out, v, f, q)
            assert 0 <= out["face"].min() and out["face"].max() < len(f)

    def test_non_divisible_query_count(self, world):
        inp, res, _ = world
        v, f = inp["ico1"]
        q = inp["queries"]["q37"]
        out = _same_on_every_rank(res, "odd_queries")
        assert out["face"].shape == (37,)
        assert_tie_contract(jax_closest(v, f, q, chunk=16), out, v, f, q)

    def test_shard_queries_keeps_each_ranks_rows(self, world):
        inp, res, _ = world
        q = inp["queries"]["q37"]
        got = np.concatenate([r["shard_queries"] for r in res])
        np.testing.assert_array_equal(got, q)
        assert [len(r["shard_queries"]) for r in res] == [10, 10, 10, 7]

    @pytest.mark.parametrize("n_bodies", [16, 10])
    def test_batched_normals_sharded(self, world, n_bodies):
        inp, res, _ = world
        _, f = inp["ico1"]
        batch = inp["bodies_%d" % n_bodies]
        out = _same_on_every_rank(res, "normals_%d" % n_bodies)
        np.testing.assert_allclose(
            out, np.asarray(jax_vert_normals(jnp.asarray(batch),
                                             jnp.asarray(f))), atol=1e-6)
        np.testing.assert_array_equal(out, vert_normals_t(
            torch.from_numpy(batch), torch.from_numpy(f)).numpy())

    @pytest.mark.parametrize("n_meshes", [8, 5])
    def test_batched_visibility_sharded(self, world, n_meshes):
        inp, res, _ = world
        v2, f = inp["ico2"]
        batch = inp["vis_bodies_%d" % n_meshes]
        vis, ndc = _same_on_every_rank(res, "batch_vis_%d" % n_meshes)
        assert vis.shape == (n_meshes, 2, len(v2))
        for b in range(n_meshes):
            n = vert_normals_t(torch.from_numpy(batch[b]),
                               torch.from_numpy(f)).numpy()
            pv, pn = visibility_compute(batch[b], f, CAMS, n=n, device="cpu")
            np.testing.assert_array_equal(vis[b], pv)
            np.testing.assert_array_equal(ndc[b], pn)
            jv, jn = jax_visibility(batch[b], f, CAMS, n=n)
            _flags_or_borderline(vis[b], jv, batch[b], f)
            np.testing.assert_allclose(ndc[b], jn, atol=1e-5)


def _flags_or_borderline(out, ref, v, f):
    """Flags [C, V] equal but on rays borderline at rounding level."""
    for c in range(len(out)):
        d = CAMS[c] - v
        d = d / np.linalg.norm(d, axis=1, keepdims=True)
        border = borderline_rays(v + 1e-3 * d, d, v[f])
        assert (out[c] != ref[c])[~border].sum() == 0


class TestShardedVisibility:
    def test_matches_single_device(self, world):
        inp, res, _ = world
        v, f = inp["ico2"]
        vis, ndc = _same_on_every_rank(res, "vis")
        jv, jn = jax_visibility(v, f, CAMS, n=inp["n2"])
        _flags_or_borderline(vis, jv, v, f)
        np.testing.assert_allclose(ndc, jn, atol=1e-6)
        pv, pn = visibility_compute(v, f, CAMS, n=inp["n2"], device="cpu")
        np.testing.assert_array_equal(vis, pv)
        np.testing.assert_array_equal(ndc, pn)

    def test_non_divisible_vertex_count(self, world):
        inp, res, _ = world
        v, f = inp["ico1"]
        vis, _ = _same_on_every_rank(res, "vis_odd")
        jv, _ = jax_visibility(v, f, CAMS[:1])
        assert vis.shape == jv.shape == (1, 42)
        _flags_or_borderline(vis, jv, v, f)

    def test_requires_a_mesh(self):
        v, f = _ico(1)
        with pytest.raises(ValueError, match="DeviceMesh"):
            par.sharded_visibility(v, f, CAMS)


def _whole_rows(res, key, name):
    """A fit result's rows of ``name``, gathered from the dp ranks (the sp
    ranks of a dp block hold the same rows, which must agree)."""
    by_rows = {}
    for r in res:
        start = r["fit_rows"][0]
        got = r[key][name]
        if start in by_rows:
            np.testing.assert_array_equal(by_rows[start], got)
        by_rows[start] = got
    return np.concatenate([by_rows[k] for k in sorted(by_rows)])


class TestDistributedFit:
    def test_fit_step_runs_on_2d_mesh(self, world):
        _, res, _ = world
        losses = _same_on_every_rank(res, "fit_losses")
        assert np.all(np.isfinite(losses))
        assert losses[-1] < losses[0]

    def test_first_step_matches_unsharded(self, world):
        """From one converted state (the reference's state two steps in):
        the sharded step's loss and parameters within 1e-5 of the
        reference's unsharded step and of the port's."""
        inp, res, jnext = world
        loss = _same_on_every_rank(res, "fit_losses")[0]
        np.testing.assert_allclose(loss, jnext["loss"], atol=FIT_TOL)
        tm = tbm.synthetic_body_model(seed=0, n_betas=4, n_joints=6,
                                      template=_template(), device="cpu")
        s = inp["fit_state"]
        from mesh_tpu_torch.convert import fit_state_from_arrays

        state = fit_state_from_arrays(s["params"], s["count"], s["mu"],
                                      s["nu"], device="cpu")
        state, ploss = fit.make_fit_step(tm, fit.adam, device="cpu")(
            state, inp["fit_target"])
        np.testing.assert_allclose(loss, float(ploss), atol=FIT_TOL)
        for name in FIT_PARAMS:
            got = _whole_rows(res, "fit_step1", name)
            np.testing.assert_allclose(got, jnext[name], atol=FIT_TOL)
            np.testing.assert_allclose(
                got, getattr(state, name).detach().numpy(), atol=FIT_TOL)
        assert _same_on_every_rank(res, "fit_whole_loss") == pytest.approx(
            loss, abs=0)

    def test_fit_scan_on_a_mesh_matches_unsharded(self, world):
        inp, res, _ = world
        tm = tbm.synthetic_body_model(seed=0, n_betas=4, n_joints=6,
                                      template=_template(), device="cpu")
        _, loss = fit.fit_scan(tm, inp["fit_target"], steps=3, device="cpu")
        np.testing.assert_allclose(
            _same_on_every_rank(res, "fit_scan_loss"), loss, atol=FIT_TOL)

    def test_landmark_step_matches_unsharded(self, world):
        inp, res, _ = world
        tm = tbm.synthetic_body_model(seed=0, n_betas=4, n_joints=6,
                                      template=_template(), device="cpu")
        s = inp["fit_state"]
        from mesh_tpu_torch.convert import fit_state_from_arrays

        state = fit_state_from_arrays(s["params"], s["count"], s["mu"],
                                      s["nu"], device="cpu")
        step = fit.make_fit_step(tm, fit.adam, landmarks=inp["landmarks"],
                                 landmark_weight=10.0, device="cpu")
        state, loss = step(state, inp["fit_target"])
        losses = {r["fit_landmark_step1"]["loss"] for r in res}
        assert len(losses) == 1
        np.testing.assert_allclose(losses.pop(), float(loss), atol=FIT_TOL)
        np.testing.assert_allclose(_whole_rows(res, "fit_landmark_step1",
                                               "betas"),
                                   state.betas.detach().numpy(),
                                   atol=FIT_TOL)

    def test_uneven_split_is_refused(self):
        with pytest.raises(ValueError, match="does not split"):
            class Mesh:
                mesh_dim_names = ("dp",)

                def size(self, dim):
                    return 3

                def get_local_rank(self, dim):
                    return 0

            fit.BatchShard(Mesh(), "dp", 8).rows


class TestLandmarkFit:
    """Landmark-anchored registration, single device."""

    def _tiny_model(self):
        v, f = _ico(1)
        return tbm.synthetic_body_model(seed=0, n_betas=4, n_joints=6,
                                        template=(v, f), device="cpu")

    def test_landmark_arrays_pack_regressors(self):
        regs = {
            "nose": (np.array([3, 7, 9]), np.array([0.2, 0.5, 0.3])),
            "chin": (np.array([1]), np.array([1.0])),
        }
        idx, bary, names = par.landmark_arrays(regs, device="cpu")
        assert idx.shape == (2, 3) and bary.shape == (2, 3)
        assert names == ["chin", "nose"]
        np.testing.assert_array_equal(idx[0].numpy(), [1, 0, 0])
        np.testing.assert_allclose(bary[0].numpy(), [1.0, 0, 0])
        np.testing.assert_allclose(bary[1].numpy(), [0.2, 0.5, 0.3])

    def test_landmark_loss_zero_at_truth(self):
        model = self._tiny_model()
        verts, _ = tbm.lbs(model, torch.zeros((1, model.num_betas)),
                           torch.zeros((1, model.num_joints, 3)),
                           device="cpu")
        regs = {"a": (np.array([0, 1, 2]), np.array([0.3, 0.3, 0.4])),
                "b": (np.array([10]), np.array([1.0]))}
        idx, bary, _ = par.landmark_arrays(regs, device="cpu")
        ring = verts[0].numpy()[idx.numpy()]
        target = (ring * bary.numpy()[..., None]).sum(1)[None]
        loss = par.landmark_loss(verts, idx, bary, target, device="cpu")
        assert float(loss) < 1e-10

    def test_landmarks_pull_fit_toward_targets(self):
        model = self._tiny_model()
        rng = np.random.RandomState(1)
        true_betas = torch.tensor(rng.randn(1, model.num_betas) * 0.5,
                                  dtype=torch.float32)
        target_verts, _ = tbm.lbs(model, true_betas,
                                  torch.zeros((1, model.num_joints, 3)),
                                  device="cpu")
        scan = target_verts[:, ::3]
        picks = [i * 7 for i in range(5)]
        regs = {"l%d" % i: (np.array([i * 7]), np.array([1.0]))
                for i in range(5)}
        idx, bary, _ = par.landmark_arrays(regs, device="cpu")
        lm_target = target_verts[:, picks]
        state, optimizer = par.init_fit_state(model, 1, device="cpu")
        step = par.make_fit_step(model, optimizer,
                                 landmarks=(idx, bary, lm_target),
                                 landmark_weight=10.0, device="cpu")
        losses = [float(step(state, scan)[1]) for _ in range(60)]
        assert losses[-1] < losses[0] * 0.5
        verts, _ = tbm.lbs(model, state.betas, state.pose, state.trans,
                           device="cpu")
        err = np.linalg.norm(verts[0].detach().numpy()[picks]
                             - lm_target[0].numpy(), axis=1)
        assert err.max() < 0.15
