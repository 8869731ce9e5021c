"""mesh_tpu_torch SMPL-family synthetic models vs mesh_tpu, on the CPU, and
the hand-body contact pipeline of examples/hand_body_contact.py through both
packages.

``synthetic_family_model`` draws its weights with the reference's numpy
code, so (V, F, J, B) and the faces are held to equality and the weights
to 1e-6.  The contact pipeline is the slice as a whole: two family models,
``lbs``, ``AabbTree.intersections_indices`` (the triangle-triangle
kernel's plain version on the port's side, the XLA form on the
reference's), ``tree.nearest`` and the signed gap; intersecting faces are
held to equality and gaps to 1e-5.
"""

import numpy as np
import pytest
import torch

import mesh_tpu
from mesh_tpu.geometry import tri_normals as jax_tri_normals
from mesh_tpu.models import body_model as jbm
from mesh_tpu.query.ray import _intersections_mask_xla

import mesh_tpu_torch
from mesh_tpu_torch.geometry import tri_normals
from mesh_tpu_torch.models import (
    MODEL_FAMILIES,
    lbs,
    synthetic_family_model,
)
from mesh_tpu_torch.models import body_model as tbm

torch.set_num_threads(2)


@pytest.mark.parametrize("family", sorted(MODEL_FAMILIES))
def test_family_model_matches_reference(family):
    ref = jbm.synthetic_family_model(family)
    mine = synthetic_family_model(family, device="cpu")
    n_v, n_j, n_b = MODEL_FAMILIES[family]
    assert (mine.num_vertices, mine.num_joints, mine.num_betas) == (
        n_v, n_j, n_b) == tuple(jbm.MODEL_FAMILIES[family])
    assert mine.parents == tuple(ref.parents)
    np.testing.assert_array_equal(mine.faces.numpy(), np.asarray(ref.faces))
    assert mine.faces.dtype == torch.int32
    for name in tbm.WEIGHT_NAMES[:-1]:
        got = getattr(mine, name)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_v", [100, 778, 5023, 10475])
def test_parametric_sphere_matches_reference(n_v):
    v, f = tbm._parametric_sphere(n_v)
    rv, rf = jbm._parametric_sphere(n_v)
    assert v.shape == (n_v, 3)
    np.testing.assert_array_equal(v, rv)
    np.testing.assert_array_equal(f, rf)
    assert f.dtype == np.int32


def test_unknown_family_raises():
    with pytest.raises(ValueError, match="unknown family"):
        synthetic_family_model("star", device="cpu")
    with pytest.raises(ValueError):
        tbm._parametric_sphere(4)


def _contact_meshes():
    """examples/hand_body_contact.py's posed body and hand from both
    packages: ((body_v, hand_v) JAX, (body_v, hand_v) port, body_f,
    hand_f)."""
    import jax.numpy as jnp

    out = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            body_m = jbm.synthetic_family_model("smpl")
            hand_m = jbm.synthetic_family_model("mano")

            def pose(m, betas, p):
                return np.asarray(jbm.lbs(m, jnp.asarray(betas),
                                          jnp.asarray(p))[0][0])
        else:
            body_m = synthetic_family_model("smpl", device="cpu")
            hand_m = synthetic_family_model("mano", device="cpu")

            def pose(m, betas, p):
                return lbs(m, betas, p, device="cpu")[0][0].numpy()
        rng = np.random.RandomState(0)
        body_v = pose(body_m, (rng.randn(1, 10) * 0.3).astype(np.float32),
                      np.zeros((1, 24, 3), np.float32))
        hand_v = pose(hand_m, np.zeros((1, 10), np.float32),
                      (rng.randn(1, 16, 3) * 0.05).astype(np.float32))
        out.append((body_v, hand_v + np.array([0.26, 0.0, 0.1])))
    return (out[0], out[1], np.asarray(body_m.faces).astype(np.uint32),
            np.asarray(hand_m.faces).astype(np.uint32))


def test_hand_body_contact_pipeline_matches_reference():
    """The contact example through both packages, each on its own posed
    vertices: 64 of 1,552 hand faces intersect the body (mesh_tpu's count
    on the CPU), the tiles agree, the gaps agree to 1e-5."""
    (jb, jh), (tb, th), body_f, hand_f = _contact_meshes()
    np.testing.assert_allclose(tb, jb, atol=1e-5)
    np.testing.assert_allclose(th, jh, atol=1e-5)

    body = mesh_tpu_torch.Mesh(tb, body_f, device="cpu")
    hand = mesh_tpu_torch.Mesh(th, hand_f, device="cpu")
    tree = body.compute_aabb_tree()
    hit = tree.intersections_indices(hand.v, hand.f)
    assert hit.dtype == np.int64 and hit.size == 64
    # the reference's XLA form on the hit faces and as many free ones, on
    # the port's own vertices
    free = np.setdiff1d(np.arange(len(hand_f)), hit)[::10][:64]
    pick = np.concatenate([hit, free])
    ref = np.asarray(_intersections_mask_xla(
        tb.astype(np.float32), body_f.astype(np.int32),
        np.asarray(hand.v, np.float32), hand_f[pick].astype(np.int32)))
    np.testing.assert_array_equal(ref, np.arange(pick.size) < hit.size)
    # on the reference's vertices through its own facade, the same faces
    jtree = mesh_tpu.Mesh(v=jb, f=body_f).compute_aabb_tree()
    jref = np.asarray(_intersections_mask_xla(
        jtree.v, np.asarray(jtree.f, np.int32),
        np.asarray(jh, np.float32), hand_f[pick].astype(np.int32)))
    np.testing.assert_array_equal(jref, ref)

    # the signed gap: closest point, signed by the closest face's normal
    f_idx, points = tree.nearest(hand.v)
    gap = np.linalg.norm(hand.v - points, axis=1)
    normals = tri_normals(body.v, body.f.astype(np.int32),
                          device="cpu").numpy()
    signed = np.where(np.sum((hand.v - points) * normals[f_idx.ravel()],
                             axis=1) < 0, -gap, gap)
    jf_idx, jpoints = jtree.nearest(np.asarray(jh))
    jgap = np.linalg.norm(jh - jpoints, axis=1)
    jnormals = np.asarray(jax_tri_normals(jb, body_f.astype(np.int32)))
    jsigned = np.where(np.sum((jh - jpoints) * jnormals[jf_idx.ravel()],
                              axis=1) < 0, -jgap, jgap)
    np.testing.assert_allclose(signed, jsigned, atol=1e-5)
    assert (np.abs(signed) < 0.01).any() and (signed < 0).any()
