"""mesh_tpu_torch.parallel.fit vs mesh_tpu.parallel.fit, on the CPU.

A synthetic model on a small template (an icosphere, 6 joints, 4 betas)
from the same seed in both packages, the same numpy scans: losses and
gradients within rtol 1e-4 / atol 1e-5, and Adam against optax over a few
steps, from zero and from a carried JAX state.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mesh_tpu.models import body_model as jbm
from mesh_tpu.parallel import fit as jfit

from mesh_tpu_torch.convert import FIT_PARAMS, fit_state_from_arrays
from mesh_tpu_torch.models import body_model as tbm
from mesh_tpu_torch.parallel import fit

from .fixtures import icosphere

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-5


def _models(template=None):
    if template is None:
        v, f = icosphere(1)
        template = (v * np.array([0.3, 0.2, 0.9]), f.astype(np.int32))
    kw = dict(seed=0, n_betas=4, n_joints=6, template=template)
    return (jbm.synthetic_body_model(**kw),
            tbm.synthetic_body_model(**kw, device="cpu"))


def _scan(batch=1, n=48, seed=0):
    return (np.random.RandomState(seed).randn(batch, n, 3) * 0.4).astype(
        np.float32)


def _params(batch=1, seed=1, scale=0.1):
    rng = np.random.RandomState(seed)
    return ((rng.randn(batch, 4) * scale).astype(np.float32),
            (rng.randn(batch, 6, 3) * scale).astype(np.float32),
            (rng.randn(batch, 3) * scale).astype(np.float32))


def _port_value_and_grad(model, params, scan, **kw):
    ts = [torch.tensor(p, requires_grad=True) for p in params]
    loss = fit.scan_to_model_loss(model, *ts, scan, device="cpu", **kw)
    return float(loss), [g.numpy() for g in torch.autograd.grad(loss, ts)]


def _jax_value_and_grad(model, params, scan, **kw):
    loss, grads = jax.jit(jax.value_and_grad(
        lambda b, p, t: jfit.scan_to_model_loss(model, b, p, t, scan, **kw),
        argnums=(0, 1, 2)))(*[jnp.asarray(p) for p in params])
    return float(loss), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("data_term", ["surface", "vertex"])
@pytest.mark.parametrize("scale", [0.0, 0.1])
def test_scan_to_model_loss_matches_reference(data_term, scale):
    """At the rest pose (the fit's start: the Taylor branch of Rodrigues)
    and at a random one."""
    jm, tm = _models()
    params, scan = _params(scale=scale), _scan()
    lp, gp = _port_value_and_grad(tm, params, scan, data_term=data_term)
    lj, gj = _jax_value_and_grad(jm, params, scan, data_term=data_term)
    np.testing.assert_allclose(lp, lj, rtol=RTOL, atol=ATOL)
    for a, b in zip(gp, gj):
        assert np.all(np.isfinite(a))
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_landmarks_match_reference():
    jm, tm = _models()
    regs = {"a": ([0, 5, 9], [0.2, 0.3, 0.5]), "b": ([1, 2], [0.5, 0.5])}
    target = np.random.RandomState(4).randn(1, 2, 3).astype(np.float32)
    idx, bary, _ = fit.landmark_arrays(regs, device="cpu")
    jidx, jbary, _ = jfit.landmark_arrays(regs)
    params, scan = _params(), _scan()
    lp, gp = _port_value_and_grad(tm, params, scan,
                                  landmarks=(idx, bary, target),
                                  landmark_weight=2.0)
    lj, gj = _jax_value_and_grad(jm, params, scan,
                                 landmarks=(jidx, jbary, target),
                                 landmark_weight=2.0)
    np.testing.assert_allclose(lp, lj, rtol=RTOL, atol=ATOL)
    for a, b in zip(gp, gj):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def _state_arrays(state):
    return [np.asarray(getattr(state, k).detach() if torch.is_tensor(
        getattr(state, k)) else getattr(state, k)) for k in FIT_PARAMS]


def test_fit_scan_matches_reference():
    """5 steps from zero: Adam against optax.adam(1e-2)."""
    jm, tm = _models()
    scan = _scan(batch=2, seed=2)
    ts, tl = fit.fit_scan(tm, scan, steps=5, device="cpu")
    js, jl = jfit.fit_scan(jm, scan, steps=5)
    np.testing.assert_allclose(tl, jl, rtol=RTOL, atol=ATOL)
    for a, b in zip(_state_arrays(ts), _state_arrays(js)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_resume_from_reference_state():
    """A JAX state after 3 steps, carried across, then 2 more steps in
    each package."""
    jm, tm = _models()
    scan = _scan(batch=2, seed=3)
    jstate, jopt = jfit.init_fit_state(jm, 2)
    jstep = jfit.make_fit_step(jm, jopt)
    for _ in range(3):
        jstate, _ = jstep(jstate, jnp.asarray(scan))
    adam_state = jstate.opt_state[0]
    params = {k: np.asarray(getattr(jstate, k)) for k in FIT_PARAMS}
    tstate = fit_state_from_arrays(
        params, np.asarray(adam_state.count),
        {k: np.asarray(adam_state.mu[k]) for k in FIT_PARAMS},
        {k: np.asarray(adam_state.nu[k]) for k in FIT_PARAMS}, device="cpu")
    tstep = fit.make_fit_step(tm, fit.adam, device="cpu")
    for _ in range(2):
        jstate, jloss = jstep(jstate, jnp.asarray(scan))
        tstate, tloss = tstep(tstate, scan)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=RTOL,
                                   atol=ATOL)
    for a, b in zip(_state_arrays(tstate), _state_arrays(jstate)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


def test_fit_gradients_finite_on_sliver_template():
    """A point-triangle and a collinear sliver grafted onto the template:
    a query that does not win a degenerate face gets nothing from it."""
    v, f = icosphere(1)
    n0 = len(v)
    v = np.vstack([v, [[0.0, 0.0, 1.5], [-0.5, 0.0, 1.5], [0.5, 0.0, 1.5]]])
    f = np.vstack([f, [[n0, n0, n0], [n0, n0 + 1, n0 + 2]]]).astype(np.int32)
    _, tm = _models((v.astype(np.float32), f))
    scan = (np.random.RandomState(11).randn(1, 40, 3) * 0.3).astype(
        np.float32)
    _, grads = _port_value_and_grad(tm, _params(scale=0.0), scan)
    for g in grads:
        assert np.all(np.isfinite(g))


def test_surface_term_is_below_vertex_term(monkeypatch):
    _, tm = _models()
    params, scan = _params(), _scan(seed=12)
    surface = _port_value_and_grad(tm, params, scan, data_term="surface")[0]
    vertex = _port_value_and_grad(tm, params, scan, data_term="vertex")[0]
    assert np.isfinite(surface) and surface <= vertex + 1e-6
    monkeypatch.setenv("MESH_TPU_VERTEX_CHAMFER", "1")
    assert fit._resolve_data_term(None) == "vertex"
    monkeypatch.setenv("MESH_TPU_VERTEX_CHAMFER", "0")
    assert fit._resolve_data_term(None) == "surface"
    with pytest.raises(ValueError):
        fit._resolve_data_term("edges")


def test_step_runs_backward_without_tf32():
    """The flags are off in the backward too, not only in lbs's forward."""
    _, tm = _models()
    state, opt = fit.init_fit_state(tm, 1, device="cpu")
    seen = []
    state.pose.register_hook(lambda g: seen.append(
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32)))
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        step = fit.make_fit_step(tm, opt, device="cpu")
        step(state, _scan())
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    assert seen == [(False, False)]


def test_step_holes_and_checks():
    _, tm = _models()
    state, opt = fit.init_fit_state(tm, 2, device="cpu")
    assert state.betas.shape == (2, 4) and state.pose.shape == (2, 6, 3)
    assert isinstance(state.opt_state, torch.optim.Adam)
    # the sharded step builds on a one-rank ("dp", "sp") mesh and takes
    # the unsharded step's loss (its own share normalised by the global
    # counts: the same sum up to rounding)
    from mesh_tpu_torch.parallel import make_device_mesh

    mesh = make_device_mesh(axis_names=("dp", "sp"), device="cpu")
    sharded, _ = fit.init_fit_state(tm, 2, device="cpu")
    sharded, loss_s = fit.make_fit_step(tm, opt, mesh=mesh)(sharded,
                                                            _scan(2))
    assert sharded.shard is not None and sharded.shard.rows == (0, 2)
    whole, _ = fit.init_fit_state(tm, 2, device="cpu")
    _, loss_u = fit.make_fit_step(tm, opt, device="cpu")(whole, _scan(2))
    np.testing.assert_allclose(float(loss_s), float(loss_u), rtol=1e-6)
    with pytest.raises(ValueError, match="precision"):
        fit.make_fit_step(tm, opt, precision="tf32", device="cpu")
    # a state without an optimizer gets one at its first step
    state.opt_state = None
    state, loss = fit.make_fit_step(tm, opt, device="cpu")(state, _scan(2))
    assert isinstance(state.opt_state, torch.optim.Adam)
    assert np.isfinite(float(loss))


@pytest.mark.parametrize("call", [
    "closest_point", "point_to_triangle", "scan_to_model_loss",
    "init_fit_state", "register_vertices", "triangle_area", "rodrigues"])
def test_default_device_is_the_card(call):
    """Without device= the training and geometry entry points ask for
    CUDA, and on a host without it they raise instead of running on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device runs")
    from mesh_tpu_torch import diff
    from mesh_tpu_torch import geometry

    v, f = icosphere(1)
    pts = np.zeros((4, 3), np.float32)
    _, tm = _models()
    calls = {
        "closest_point": lambda: diff.closest_point(v, f, pts),
        "point_to_triangle": lambda: diff.point_to_triangle(pts, pts, pts,
                                                            pts),
        "scan_to_model_loss": lambda: fit.scan_to_model_loss(
            tm, *_params(), _scan()),
        "init_fit_state": lambda: fit.init_fit_state(tm, 1),
        "register_vertices": lambda: diff.register_vertices(v, f, pts),
        "triangle_area": lambda: geometry.triangle_area(v, f),
        "rodrigues": lambda: geometry.rodrigues(np.zeros(3)),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[call]()
