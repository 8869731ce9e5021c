"""mesh_tpu_torch.diff vs mesh_tpu.diff, on the CPU.

Float32 against the JAX package, the same numpy inputs to both (the JAX
side on its own CPU route, the port on its kernels' plain versions):
faces equal except at exact-distance ties, point and sqdist within 1e-5,
losses and gradients within rtol 1e-4 / atol 1e-5, the gradients taken
over the queries whose faces agree.  Float64 against a dense
min-over-faces formula written here (no argmin freezing anywhere) within
1e-8, and against central finite differences within 1e-4 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mesh_tpu import diff as jdiff

from mesh_tpu_torch import diff
from mesh_tpu_torch import obs
from mesh_tpu_torch.accel.build import AccelIndex, get_index
from mesh_tpu_torch.query.point_triangle import closest_point_barycentric

from .fixtures import icosphere, separated_sphere_queries

torch.set_num_threads(2)

VALUE_TOL = 1e-5
RTOL, ATOL = 1e-4, 1e-5


def _case(subdiv=2, n_q=64, seed=0, near=16):
    """An icosphere, separated queries and ``near`` queries close to the
    surface (where faces may tie), float32."""
    v, f = icosphere(subdiv)
    rng = np.random.RandomState(seed + 100)
    u = rng.randn(near, 3)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts = np.vstack([separated_sphere_queries(n_q - near, seed),
                     u * rng.uniform(0.95, 1.05, (near, 1))])
    return (v.astype(np.float32), f.astype(np.int32),
            pts.astype(np.float32))


def _inside_queries(n, seed):
    """Queries inside the unit sphere (r in [0.3, 0.7]): the closest face
    of the icosphere is unique there."""
    rng = np.random.RandomState(seed)
    u = rng.randn(n, 3)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    return (u * rng.uniform(0.3, 0.7, (n, 1))).astype(np.float32)


def _grads_np(fn, *arrays):
    """(value, grads) of a scalar torch function of float tensors made
    from ``arrays``."""
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts)
    return float(out), [g.numpy() for g in grads]


def _jit(fn, *arrays):
    """``fn`` of the JAX package, jitted: one compile in place of one a
    primitive."""
    return jax.jit(fn)(*[jnp.asarray(a) for a in arrays])


def _jax_grads(fn, *arrays):
    val, grads = jax.jit(jax.value_and_grad(
        fn, argnums=tuple(range(len(arrays)))))(
        *[jnp.asarray(a) for a in arrays])
    return float(val), [np.asarray(g) for g in grads]


def _check_result(out, ref):
    """Port result (tensors) vs the reference's (arrays): sqdist within
    VALUE_TOL everywhere, so a face that differs is an exact-distance tie;
    points, parts and barycentrics where the faces agree (two tied faces
    have two closest points).  Queries outside the sphere often project
    onto a vertex or an edge, which several faces share.  Returns the mask
    of agreeing faces."""
    ref = {k: np.asarray(x) for k, x in ref.items()}
    out = {k: x.detach().numpy() for k, x in out.items()}
    assert out["face"].dtype == np.int32 and out["part"].dtype == np.int32
    np.testing.assert_allclose(out["sqdist"], ref["sqdist"], atol=VALUE_TOL)
    same = out["face"] == ref["face"]
    assert same.mean() >= 0.5
    np.testing.assert_allclose(out["point"][same], ref["point"][same],
                               atol=VALUE_TOL)
    np.testing.assert_array_equal(out["part"][same], ref["part"][same])
    np.testing.assert_allclose(out["bary"][same], ref["bary"][same],
                               atol=1e-4)
    return same


@pytest.mark.parametrize("mode", ["frozen", "recompute"])
@pytest.mark.parametrize("use_pallas", [None, False])
def test_closest_point_matches_reference(mode, use_pallas):
    v, f, pts = _case()
    out = diff.closest_point(v, f, pts, mode=mode, use_pallas=use_pallas,
                             device="cpu")
    same = _check_result(out, _jit(lambda v_, p_: jdiff.closest_point(
        v_, f, p_, mode=mode), v, pts))
    w = np.random.RandomState(1).rand(len(pts)).astype(np.float32) * same
    lp, gp = _grads_np(lambda v_, p_: (torch.as_tensor(w) * diff.closest_point(
        v_, f, p_, mode=mode, use_pallas=use_pallas,
        device="cpu")["sqdist"]).sum(), v, pts)
    lj, gj = _jax_grads(lambda v_, p_: jnp.sum(w * jdiff.closest_point(
        v_, f, p_, mode=mode)["sqdist"]), v, pts)
    np.testing.assert_allclose(lp, lj, rtol=RTOL, atol=ATOL)
    for a, b in zip(gp, gj):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_point_gradient_matches_reference():
    """The ``point`` output's cotangent (frozen: through cp only)."""
    v, f, pts = _case(seed=2)
    same = _check_result(diff.closest_point(v, f, pts, device="cpu"),
                         _jit(lambda v_, p_: jdiff.closest_point(v_, f, p_),
                              v, pts))
    c = np.random.RandomState(3).randn(*pts.shape).astype(np.float32)
    c *= same[:, None]
    _, gp = _grads_np(lambda v_, p_: (torch.as_tensor(c) * diff.closest_point(
        v_, f, p_, device="cpu")["point"]).sum(), v, pts)
    _, gj = _jax_grads(lambda v_, p_: jnp.sum(c * jdiff.closest_point(
        v_, f, p_)["point"]), v, pts)
    for a, b in zip(gp, gj):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["frozen", "recompute"])
def test_point_to_triangle_matches_reference(mode):
    rng = np.random.RandomState(7)
    p, a, b, c = rng.randn(4, 12, 3).astype(np.float32)
    out = diff.point_to_triangle(p, a, b, c, mode=mode, device="cpu")
    ref = _jit(lambda *t: jdiff.point_to_triangle(*t, mode=mode),
               p, a, b, c)
    for key in ("point", "sqdist", "bary"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=VALUE_TOL)
    np.testing.assert_array_equal(out["part"].numpy(), np.asarray(ref["part"]))
    lp, gp = _grads_np(lambda *t: diff.point_to_triangle(
        *t, mode=mode, device="cpu")["sqdist"].sum(), p, a, b, c)
    lj, gj = _jax_grads(lambda *t: jnp.sum(jdiff.point_to_triangle(
        *t, mode=mode)["sqdist"]), p, a, b, c)
    np.testing.assert_allclose(lp, lj, rtol=RTOL, atol=ATOL)
    for x, y in zip(gp, gj):
        np.testing.assert_allclose(x, y, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", ["frozen", "recompute"])
def test_nearest_normal_weighted_matches_reference(mode):
    v, f, pts = _case(seed=4)
    rng = np.random.RandomState(5)
    nrm = pts / np.linalg.norm(pts, axis=1, keepdims=True)
    nrm = (nrm + rng.randn(*nrm.shape) * 0.1).astype(np.float32)
    out = diff.nearest_normal_weighted(v, f, pts, nrm, mode=mode,
                                       device="cpu")
    ref = _jit(lambda v_, p_, n_: jdiff.nearest_normal_weighted(
        v_, f, p_, n_, mode=mode), v, pts, nrm)
    same = _check_result(out, ref)
    w = same.astype(np.float32)
    _, gp = _grads_np(lambda v_, p_: (torch.as_tensor(w) * (
        diff.nearest_normal_weighted(v_, f, p_, nrm, mode=mode,
                                     device="cpu")["sqdist"])).sum(), v, pts)
    _, gj = _jax_grads(lambda v_, p_: jnp.sum(w * jdiff.nearest_normal_weighted(
        v_, f, p_, nrm, mode=mode)["sqdist"]), v, pts)
    for a, b in zip(gp, gj):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_closest_point_batched_matches_reference():
    v, f, pts = _case(n_q=32, near=8, seed=6)
    vb = np.stack([v, v * 1.1]).astype(np.float32)
    pb = np.stack([pts, pts + 0.05]).astype(np.float32)
    out = diff.closest_point_batched(vb, f, pb, device="cpu")
    ref = _jit(lambda v_, p_: jdiff.closest_point_batched(v_, f, p_), vb, pb)
    assert out["face"].shape == (2, 32) and out["point"].shape == (2, 32, 3)
    same = np.stack([_check_result({k: x[b] for k, x in out.items()},
                                   {k: np.asarray(x)[b]
                                    for k, x in ref.items()})
                     for b in range(2)])
    w = same.astype(np.float32)
    _, gp = _grads_np(lambda v_: (torch.as_tensor(w) * diff.closest_point_batched(
        v_, f, pb, device="cpu")["sqdist"]).sum(), vb)
    _, gj = _jax_grads(lambda v_: jnp.sum(w * jdiff.closest_point_batched(
        v_, f, pb)["sqdist"]), vb)
    np.testing.assert_allclose(gp[0], gj[0], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,robust", [
    ("point_to_point", None), ("point_to_point", ("huber", 0.1)),
    ("point_to_point", ("geman_mcclure", 0.1)), ("point_to_plane", None),
    ("symmetric_chamfer", None)])
def test_energies_match_reference(name, robust):
    """On queries whose closest face is unique (a tied face has another
    normal, so point-to-plane would differ there by design)."""
    v, f, _ = _case()
    pts = _inside_queries(64, 8)
    assert _check_result(diff.closest_point(v, f, pts, device="cpu"),
                         _jit(lambda v_, p_: jdiff.closest_point(v_, f, p_),
                              v, pts)).all()
    lp, gp = _grads_np(lambda v_: getattr(diff, name)(
        v_, f, pts, robust=robust, device="cpu"), v)
    lj, gj = _jax_grads(lambda v_: getattr(jdiff, name)(
        v_, f, pts, robust=robust), v)
    np.testing.assert_allclose(lp, lj, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(gp[0], gj[0], rtol=RTOL, atol=ATOL)
    assert np.all(np.isfinite(gp[0]))


def test_robust_kernels_match_reference():
    sq = np.array([0.0, 1e-8, 1e-6, 0.005, 0.01, 0.5, 4.0], np.float32)
    for port, ref, scale in ((diff.huber, jdiff.huber, 0.1),
                             (diff.geman_mcclure, jdiff.geman_mcclure, 0.1)):
        np.testing.assert_allclose(port(sq, scale, device="cpu").numpy(),
                                   np.asarray(ref(sq, scale)), rtol=1e-6)


def test_landmark_term_matches_reference():
    from mesh_tpu.parallel.fit import landmark_arrays as jla

    from mesh_tpu_torch.parallel.fit import landmark_arrays

    v, _, _ = _case()
    regs = {"a": ([0, 5, 9], [0.2, 0.3, 0.5]), "b": ([1, 2], [0.5, 0.5])}
    target = np.random.RandomState(9).randn(2, 3).astype(np.float32)
    idx, bary, names = landmark_arrays(regs, device="cpu")
    jidx, jbary, jnames = jla(regs)
    assert names == jnames and idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    lp = diff.landmark_term(torch.as_tensor(v), (idx, bary, target), 2.0,
                            device="cpu")
    lj = jdiff.landmark_term(v, (jidx, jbary, target), 2.0)
    np.testing.assert_allclose(float(lp), float(lj), rtol=RTOL)


# -- float64: the dense formula and finite differences -----------------------

def _f64_case(subdiv=1, n_q=24, seed=0):
    v, f = icosphere(subdiv)
    return (torch.tensor(v, dtype=torch.float64), f.astype(np.int32),
            torch.tensor(separated_sphere_queries(n_q, seed),
                         dtype=torch.float64))


def _dense_min_sqdist(v, f, pts):
    """The exact point-triangle squared distance to EVERY face, min over
    faces: differentiable as plain autograd, no argmin frozen."""
    tri = v[torch.as_tensor(f, dtype=torch.int64)]           # [F, 3, 3]
    bary, _ = closest_point_barycentric(
        pts[:, None, :], tri[None, :, 0], tri[None, :, 1], tri[None, :, 2])
    cp = torch.einsum("qfk,fkd->qfd", bary, tri)
    return ((pts[:, None, :] - cp) ** 2).sum(dim=-1).amin(dim=-1)


@pytest.mark.parametrize("mode", ["frozen", "recompute"])
def test_f64_gradient_matches_dense_formula(mode):
    v, f, pts = _f64_case()

    def loss(v_, p_):
        res = diff.closest_point(v_, f, p_, mode=mode, device="cpu")
        assert res["sqdist"].dtype == torch.float64
        return res["sqdist"].sum()

    gv, gp = torch.func.grad(loss, argnums=(0, 1))(v, pts)
    rv, rp = torch.func.grad(
        lambda v_, p_: _dense_min_sqdist(v_, f, p_).sum(),
        argnums=(0, 1))(v, pts)
    assert gv.dtype == torch.float64
    torch.testing.assert_close(gv, rv, rtol=0, atol=1e-8)
    torch.testing.assert_close(gp, rp, rtol=0, atol=1e-8)


def test_f64_finite_differences():
    v, f, pts = _f64_case(n_q=8, seed=1)
    rng = np.random.RandomState(2)
    dv = torch.tensor(rng.randn(*v.shape))
    dp = torch.tensor(rng.randn(*pts.shape))

    def loss(v_, p_):
        return diff.closest_point(v_, f, p_, device="cpu")["sqdist"].sum()

    gv, gp = torch.func.grad(loss, argnums=(0, 1))(v, pts)
    analytic = float((gv * dv).sum() + (gp * dp).sum())
    eps = 1e-6
    fd = (float(loss(v + eps * dv, pts + eps * dp))
          - float(loss(v - eps * dv, pts - eps * dp))) / (2 * eps)
    assert abs(analytic - fd) <= 1e-4 * max(1.0, abs(fd))


def test_frozen_equals_recompute_away_from_ties():
    v, f, pts = _f64_case(n_q=16, seed=3)
    w = torch.tensor(np.random.RandomState(30).rand(16))

    def loss(mode):
        return lambda v_, p_: (w * diff.closest_point(
            v_, f, p_, mode=mode, device="cpu")["sqdist"]).sum()

    gf = torch.func.grad(loss("frozen"), argnums=(0, 1))(v, pts)
    gr = torch.func.grad(loss("recompute"), argnums=(0, 1))(v, pts)
    for a, b in zip(gf, gr):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-8)


def test_jvp_through_recompute():
    """torch.func.jvp composes with recompute mode: the search is opaque,
    the barycentric re-derivation differentiable; second order too."""
    v, f, pts = _f64_case(n_q=6, seed=4)
    dv = torch.tensor(np.random.RandomState(5).randn(*v.shape))

    def prim(v_):
        return diff.closest_point(v_, f, pts, mode="recompute",
                                  device="cpu")["sqdist"]

    _, tangent = torch.func.jvp(prim, (v,), (dv,))
    gv = torch.func.grad(lambda v_: prim(v_).sum())(v)
    torch.testing.assert_close(tangent.sum(), (gv * dv).sum(), rtol=1e-9,
                               atol=0)
    hess = torch.func.hessian(lambda v_: prim(v_).sum())(v)
    assert hess.shape == v.shape + v.shape and bool(hess.isfinite().all())
    with pytest.raises(RuntimeError):
        torch.func.jvp(lambda v_: diff.closest_point(
            v_, f, pts, device="cpu")["sqdist"], (v,), (dv,))


def test_accel_index_route_matches_default():
    """The rope walks' faces (their plain version here) and so the
    gradients equal the default route's; a grid index is rejected.  The
    queries lie inside the sphere, where the closest face is unique."""
    v, f, _ = _case()
    pts = _inside_queries(64, 10)
    index = get_index(v, f, "bvh")
    gd, ga = [
        _grads_np(lambda v_: diff.closest_point(
            v_, f, pts, accel_index=idx, device="cpu")["sqdist"].sum(), v)
        for idx in (None, index)]
    np.testing.assert_allclose(ga[0], gd[0], rtol=0, atol=0)
    np.testing.assert_array_equal(
        diff.closest_point(v, f, pts, accel_index=index,
                           device="cpu")["face"].numpy(),
        diff.closest_point(v, f, pts, device="cpu")["face"].numpy())
    grid = AccelIndex("grid", index.digest, {}, {})
    with pytest.raises(ValueError, match="bvh"):
        diff.closest_point(v, f, pts, accel_index=grid, device="cpu")


def test_bad_mode_raises():
    v, f, pts = _case(n_q=4, near=0)
    with pytest.raises(ValueError, match="mode"):
        diff.closest_point(v, f, pts, mode="exact", device="cpu")


# -- ICP --------------------------------------------------------------------

def test_register_vertices_descends_and_records_obs(monkeypatch):
    monkeypatch.setenv("MESH_TPU_OBS", "1")
    obs.reset()
    v, f = icosphere(2)
    rng = np.random.RandomState(13)
    scan = (np.asarray(v) * 1.15 + rng.randn(*v.shape) * 0.01).astype(
        np.float32)[:120]
    res = diff.register_vertices(v.astype(np.float32), f, scan, steps=6,
                                 recorrespond_every=2, device="cpu")
    assert res.losses[-1] < res.losses[0]
    assert res.recorrespondences == 3 and len(res.losses) == 6
    assert res.verts.shape == v.shape and np.isfinite(res.residual_rms)
    snap = obs.REGISTRY.snapshot()
    assert snap["mesh_tpu_diff_recorrespond_total"]["series"][0]["value"] == 3
    assert snap["mesh_tpu_diff_inner_steps_total"]["series"][0]["value"] == 6
    hist = snap["mesh_tpu_diff_residual_meters"]["series"][0]
    assert hist["count"] == 6
    names = [e["name"] for e in obs.TRACER.events()]
    assert names.count("diff.recorrespond") == 3
    assert names.count("diff.energy") == 6


def test_icp_matches_reference_losses():
    """The same free-vertex run in both packages: the first burst's
    correspondence and loss agree, and both descend alike (point to
    point: a tied face gives the same frozen closest point)."""
    v, f = icosphere(1)
    rng = np.random.RandomState(14)
    scan = (np.asarray(v) * 1.1 + rng.randn(*v.shape) * 0.01).astype(
        np.float32)
    res = diff.register_vertices(v.astype(np.float32), f, scan, steps=4,
                                 recorrespond_every=2, device="cpu")
    ref = jdiff.register_vertices(v.astype(np.float32), f, scan, steps=4,
                                  recorrespond_every=2)
    np.testing.assert_allclose(res.losses, ref.losses, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(res.verts.numpy(), np.asarray(ref.verts),
                               atol=1e-5)
