"""mesh_tpu_torch.diff under ``torch.func.vmap``, and the envelope
backward's fixed-order sum, on the CPU.

The reference maps its queries over meshes with ``jax.vmap`` through the
custom VJPs (``closest_point_batched``).  The port's ``torch.func.vmap``
over ``diff.closest_point`` folds the mapped axis into the search's batch
axis: it must answer as the reference's ``jax.vmap`` does (faces equal
except at exact-distance ties, points and sqdist within 1e-5, gradients
within rtol 1e-4 / atol 1e-5 over the agreeing faces), equal the port's
own ``closest_point_batched`` bit for bit (outputs and gradients, through
``vmap`` then backward and through ``vmap(grad)``), and run one search for
the whole map.  ``_Frozen``'s backward sums the corner cotangents into the
vertices in slot order with no ``index_add_``; in float64 its gradients
under ``vmap`` match a dense min-over-faces formula within 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from mesh_tpu import diff as jdiff

from mesh_tpu_torch import diff
from mesh_tpu_torch.diff import queries as dq

from .test_torch_diff import (
    ATOL,
    RTOL,
    _case,
    _check_result,
    _dense_min_sqdist,
    _f64_case,
)

torch.set_num_threads(2)

N_MAP = 4
KEYS = ("face", "part", "bary", "point", "sqdist")


def _mapped_case(seed=0, n_q=32, near=8):
    """N_MAP scaled copies of an icosphere and N_MAP query sets, float32."""
    v, f, pts = _case(n_q=n_q, near=near, seed=seed)
    vb = np.stack([v * (1.0 + 0.05 * i) for i in range(N_MAP)])
    pb = np.stack([pts + 0.02 * i for i in range(N_MAP)])
    return vb.astype(np.float32), f, pb.astype(np.float32)


def _port_vmap(f, mode, mapped, use_pallas=None):
    """``diff.closest_point`` under ``torch.func.vmap``: over vertices and
    points (``mapped="both"``) or over the points of one mesh."""
    ft = torch.as_tensor(f)
    if mapped == "both":
        return vmap(lambda v_, p_: diff.closest_point(
            v_, ft, p_, mode=mode, use_pallas=use_pallas, device="cpu"))
    return lambda v_, p_: vmap(lambda q_: diff.closest_point(
        v_[0], ft, q_, mode=mode, use_pallas=use_pallas,
        device="cpu"))(p_)


def _ref_vmap(f, mode, mapped):
    """The reference's ``jax.vmap`` of the same map (jit it outermost: a
    jit inside its custom VJP's grad leaks a tracer)."""
    if mapped == "both":
        return jax.vmap(lambda v_, p_: jdiff.closest_point(
            v_, f, p_, mode=mode))
    return lambda v_, p_: jax.vmap(lambda q_: jdiff.closest_point(
        v_[0], f, q_, mode=mode))(p_)


def _batched_v(vb, mapped):
    """The vertices ``closest_point_batched`` takes for a map."""
    return vb if mapped == "both" else np.broadcast_to(vb[:1], vb.shape)


@pytest.mark.parametrize("mode", ["frozen", "recompute"])
@pytest.mark.parametrize("mapped", ["both", "points"])
def test_vmap_closest_point_matches_reference_vmap(mode, mapped):
    vb, f, pb = _mapped_case()
    out = _port_vmap(f, mode, mapped)(torch.as_tensor(vb), torch.as_tensor(pb))
    ref = jax.jit(_ref_vmap(f, mode, mapped))(jnp.asarray(vb),
                                              jnp.asarray(pb))
    assert out["face"].shape == (N_MAP, pb.shape[1])
    same = np.stack([_check_result({k: x[b] for k, x in out.items()},
                                   {k: np.asarray(x)[b]
                                    for k, x in ref.items()})
                     for b in range(N_MAP)])
    w = same.astype(np.float32)

    def port_loss(v_, p_):
        return (torch.as_tensor(w) * _port_vmap(f, mode, mapped)(
            v_, p_)["sqdist"]).sum()

    ts = [torch.tensor(a, requires_grad=True) for a in (vb, pb)]
    gp = torch.autograd.grad(port_loss(*ts), ts)
    gj = jax.jit(jax.grad(lambda v_, p_: jnp.sum(w * _ref_vmap(
        f, mode, mapped)(v_, p_)["sqdist"]), argnums=(0, 1)))(
        jnp.asarray(vb), jnp.asarray(pb))
    for a, b in zip(gp, gj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("mode", ["frozen", "recompute"])
@pytest.mark.parametrize("use_pallas", [None, False])
@pytest.mark.parametrize("mapped", ["both", "points"])
def test_vmap_equals_batched_bit_for_bit(mode, use_pallas, mapped):
    vb, f, pb = _mapped_case(seed=3)
    ft = torch.as_tensor(f)
    vmapped = _port_vmap(f, mode, mapped, use_pallas)
    batched_v = torch.as_tensor(np.ascontiguousarray(_batched_v(vb, mapped)))
    out = vmapped(torch.as_tensor(vb), torch.as_tensor(pb))
    ref = diff.closest_point_batched(batched_v, ft, torch.as_tensor(pb),
                                     mode=mode, use_pallas=use_pallas,
                                     device="cpu")
    for key in KEYS:
        assert torch.equal(out[key], ref[key]), key

    # vmap, then an ordinary backward
    ts = [torch.tensor(a, requires_grad=True) for a in (vb, pb)]
    g_map = torch.autograd.grad(vmapped(*ts)["sqdist"].sum(), ts)
    tb = [batched_v.clone().requires_grad_(),
          torch.tensor(pb, requires_grad=True)]
    g_bat = torch.autograd.grad(diff.closest_point_batched(
        tb[0], ft, tb[1], mode=mode, use_pallas=use_pallas,
        device="cpu")["sqdist"].sum(), tb)
    assert torch.equal(g_map[1], g_bat[1])
    if mapped == "both":
        assert torch.equal(g_map[0], g_bat[0])
    else:
        # the one mesh's gradient is the sum of the map's
        torch.testing.assert_close(g_map[0][0], g_bat[0].sum(dim=0),
                                   rtol=1e-6, atol=1e-6)

    if mapped == "both":
        # grad inside the map: each mesh's own gradient
        g_in = vmap(grad(lambda v_, p_: diff.closest_point(
            v_, ft, p_, mode=mode, use_pallas=use_pallas,
            device="cpu")["sqdist"].sum(), argnums=(0, 1)))(
            torch.as_tensor(vb), torch.as_tensor(pb))
        assert torch.equal(g_in[0], g_bat[0])
        assert torch.equal(g_in[1], g_bat[1])


def test_vmap_closest_point_is_one_search(monkeypatch):
    """The mapped axis folds into the batch axis: one
    ``closest_point_dispatch`` call (one kernel launch on the card) for the
    whole map, with all N_MAP meshes in it."""
    calls = []
    real = dq.closest_point_dispatch

    def counted(v, *args):
        calls.append(tuple(v.shape))
        return real(v, *args)

    monkeypatch.setattr(dq, "closest_point_dispatch", counted)
    vb, f, pb = _mapped_case(seed=5)
    _port_vmap(f, "frozen", "both")(torch.as_tensor(vb), torch.as_tensor(pb))
    assert calls == [(N_MAP,) + vb.shape[1:]]
    calls.clear()
    # jacfwd batches only the tangents: still one search, of one mesh
    torch.func.jacfwd(lambda v_: diff.closest_point(
        v_, f, pb[0], mode="recompute", device="cpu")["sqdist"])(
        torch.as_tensor(vb[0]))
    assert calls == [(1,) + vb.shape[1:]]


@pytest.mark.parametrize("mode", ["frozen", "recompute"])
def test_vmap_point_to_triangle_matches_reference_vmap(mode):
    rng = np.random.RandomState(11)
    p, a, b, c = rng.randn(4, N_MAP, 8, 3).astype(np.float32)
    out = vmap(lambda *t: diff.point_to_triangle(
        *t, mode=mode, device="cpu"))(*map(torch.as_tensor, (p, a, b, c)))
    ref = jax.jit(jax.vmap(lambda *t: jdiff.point_to_triangle(
        *t, mode=mode)))(p, a, b, c)
    plain = diff.point_to_triangle(p, a, b, c, mode=mode, device="cpu")
    for key in ("point", "sqdist", "bary", "part"):
        assert torch.equal(out[key], plain[key]), key
    for key in ("point", "sqdist", "bary"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-5)
    np.testing.assert_array_equal(out["part"].numpy(),
                                  np.asarray(ref["part"]))
    ts = [torch.tensor(x, requires_grad=True) for x in (p, a, b, c)]
    gp = torch.autograd.grad(vmap(lambda *t: diff.point_to_triangle(
        *t, mode=mode, device="cpu"))(*ts)["sqdist"].sum(), ts)
    gj = jax.jit(jax.grad(lambda *t: jnp.sum(jax.vmap(
        lambda *u: jdiff.point_to_triangle(*u, mode=mode))(*t)["sqdist"]),
        argnums=(0, 1, 2, 3)))(p, a, b, c)
    for x, y in zip(gp, gj):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_out", [1, 7, 500])
def test_corner_sums_equal_index_add(dtype, n_out):
    """The fixed-order sum against ``index_add_``: both add each output's
    rows in slot order on the CPU, so equal to the bit; empty outputs
    stay zero."""
    rng = np.random.RandomState(n_out)
    slots = torch.as_tensor(rng.randint(0, n_out, 3 * 257))
    rows = torch.as_tensor(rng.randn(3 * 257, 3), dtype=dtype)
    got = dq.corner_sums(slots, rows, n_out)
    want = torch.zeros(n_out, 3, dtype=dtype).index_add_(0, slots, rows)
    assert got.dtype == dtype and torch.equal(got, want)


def test_frozen_backward_makes_no_scatter(monkeypatch):
    """No ``index_add_`` anywhere in the envelope backward (CUDA atomics
    add in a run-dependent order)."""
    def refuse(*args, **kwargs):
        raise AssertionError("index_add_ in the envelope backward")

    monkeypatch.setattr(torch.Tensor, "index_add_", refuse)
    v, f, pts = _case(seed=8)
    vt = torch.tensor(v, requires_grad=True)
    diff.closest_point(vt, f, pts, device="cpu")["sqdist"].sum().backward()
    assert bool(vt.grad.abs().sum() > 0)


def test_f64_vmapped_gradient_matches_dense_formula():
    v, f, pts = _f64_case(n_q=16, seed=7)
    vb = torch.stack([v * (1.0 + 0.1 * i) for i in range(3)])
    pb = torch.stack([pts * (1.0 - 0.05 * i) for i in range(3)])
    gv, gp = vmap(grad(lambda v_, p_: diff.closest_point(
        v_, f, p_, device="cpu")["sqdist"].sum(), argnums=(0, 1)))(vb, pb)
    assert gv.dtype == torch.float64
    for i in range(3):
        rv, rp = grad(lambda v_, p_: _dense_min_sqdist(v_, f, p_).sum(),
                      argnums=(0, 1))(vb[i], pb[i])
        torch.testing.assert_close(gv[i], rv, rtol=0, atol=1e-8)
        torch.testing.assert_close(gp[i], rp, rtol=0, atol=1e-8)
