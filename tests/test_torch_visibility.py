"""mesh_tpu_torch visibility vs mesh_tpu, on the CPU.

Per body, the port's visibility (the any-hit kernel's plain version under
the PyTorch direction, sensor and n.dir math) is held against mesh_tpu's
accelerator path, ``_visibility_kernel_pallas(..., interpret=True)``: the
same division-free predicate on the same float32 rays, so the flags are
held to equality and n.dir to 1e-6.  mesh_tpu's CPU facades
(``Mesh.vertex_visibility``, ``batch.batched_vertex_visibility``) take its
XLA path, the divided Moller-Trumbore form: there a flag may differ only on
a ray that is borderline at rounding level (``test_torch_ray``'s
``borderline_rays``).  The reference's own visibility cases
(tests/test_visibility.py) are replayed through the port with the same
expected values.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mesh_tpu
from mesh_tpu.batch import batched_vertex_visibility as jax_batched_vis
from mesh_tpu.geometry.vert_normals import vert_normals as jax_vert_normals
from mesh_tpu.models import body_model as jbm
from mesh_tpu.query.visibility import _visibility_kernel_pallas

import mesh_tpu_torch
from mesh_tpu_torch.batch import visibility_step
from mesh_tpu_torch.geometry.vert_normals import vert_normals
from mesh_tpu_torch.query.visibility import (
    visibility_compute,
    visibility_local,
    visibility_rays,
)

from .fixtures import box
from .test_torch_ray import borderline_rays

torch.set_num_threads(2)

NDC_TOL = 1e-6

#: two cameras around the bodies, off every axis of the template
CAMS = np.array([[3.0, 0.4, 0.2], [-0.5, -3.0, 0.6]], np.float32)


def _bodies(batch=3, seed=0):
    """(posed vertices [B, V, 3] float32, faces [F, 3] int32): synthetic
    bodies on a _uv_sphere(16, 12) template, posed by mesh_tpu's lbs."""
    v, f = jbm._uv_sphere(16, 12)
    model = jbm.synthetic_body_model(
        seed=seed, template=(v * np.array([0.3, 0.2, 0.9]), f))
    rng = np.random.RandomState(seed)
    betas = (rng.randn(batch, 10) * 0.3).astype(np.float32)
    pose = (rng.randn(batch, 24, 3) * 0.1).astype(np.float32)
    return (np.array(jbm.lbs(model, betas, pose)[0], np.float32),
            f.astype(np.int32))


def _sensors(seed):
    """A sensor per camera: x and y axes of about 0.6, z towards the body."""
    rng = np.random.RandomState(seed)
    z = -CAMS / np.linalg.norm(CAMS, axis=1, keepdims=True) * 0.5
    xy = rng.randn(2, 6) * 0.35
    return np.hstack([xy, z]).astype(np.float32)


def _jax_pallas(v, tri, n, sensors=None):
    vis, ndc = _visibility_kernel_pallas(
        jnp.asarray(v), jnp.asarray(tri), jnp.asarray(CAMS), jnp.asarray(n),
        None if sensors is None else jnp.asarray(sensors),
        jnp.float32(1e-3), interpret=True)
    return np.asarray(vis), np.asarray(ndc)


def _port(v, tri, n, sensors=None):
    vis, ndc = visibility_local(
        torch.from_numpy(v)[None], torch.from_numpy(tri)[None],
        torch.from_numpy(CAMS), torch.from_numpy(n)[None],
        None if sensors is None else torch.from_numpy(sensors))
    return vis[0].numpy(), ndc[0].numpy()


def _assert_flags_or_borderline(out, ref, v, tri):
    """Flags [C, V] equal, except on rays borderline at rounding level."""
    differ = out != ref
    if differ.any():
        origins, dirs = visibility_rays(torch.from_numpy(v)[None],
                                        torch.from_numpy(CAMS))
        border = borderline_rays(origins[0].numpy(),
                                 dirs[0].reshape(-1, 3).numpy(), tri)
        assert not (differ.reshape(-1) & ~border).any()


@pytest.mark.parametrize("with_sensors", [False, True])
def test_visibility_matches_pallas_per_body(with_sensors):
    vs, f = _bodies()
    sensors = _sensors(1) if with_sensors else None
    for b in range(vs.shape[0]):
        n = np.array(jax_vert_normals(vs[b], f), np.float32)
        ref_vis, ref_ndc = _jax_pallas(vs[b], vs[b][f], n, sensors)
        vis, ndc = _port(vs[b], vs[b][f], n, sensors)
        np.testing.assert_array_equal(vis, ref_vis)
        np.testing.assert_allclose(ndc, ref_ndc, atol=NDC_TOL)
        assert 0.2 < vis.mean() < 0.8


def test_visibility_extra_occluder_matches_pallas():
    vs, f = _bodies(batch=1, seed=1)
    v = vs[0]
    # a wall across camera 0's line of sight, half as wide as the body
    wall_v = np.array([[1.5, -0.05, -0.5], [1.5, 0.6, -0.5], [1.5, 0.6, 0.5],
                       [1.5, -0.05, 0.5]], np.float32)
    wall_f = np.array([[0, 1, 2], [0, 2, 3]])
    n = np.array(jax_vert_normals(v, f), np.float32)
    occ = np.concatenate([v[f], wall_v[wall_f]]).astype(np.float32)
    ref_vis, ref_ndc = _jax_pallas(v, occ, n)
    vis, ndc = visibility_compute(v, f, CAMS, n=n, extra_v=wall_v,
                                  extra_f=wall_f, device="cpu")
    assert vis.dtype == np.uint32 and ndc.dtype == np.float64
    np.testing.assert_array_equal(vis.astype(bool), ref_vis)
    np.testing.assert_allclose(ndc, ref_ndc, atol=NDC_TOL)
    # the wall hides some vertices camera 0 sees without it
    alone, _ = visibility_compute(v, f, CAMS, n=n, device="cpu")
    assert (alone[0] & ~vis[0]).any() and (vis[1] == alone[1]).all()


def test_visibility_step_batches_bodies():
    """One step over the batch equals the per-body results, normals
    computed in the step or given."""
    vs, f = _bodies(batch=3, seed=2)
    vt, ft = torch.from_numpy(vs), torch.from_numpy(f)
    vis, ndc = visibility_step(vt, ft, torch.from_numpy(CAMS))
    assert vis.dtype == torch.bool and tuple(vis.shape) == (3, 2, vs.shape[1])
    n = vert_normals(vt, ft, device="cpu")
    vis2, ndc2 = visibility_step(vt, ft, torch.from_numpy(CAMS), normals=n)
    assert torch.equal(vis, vis2) and torch.equal(ndc, ndc2)
    for b in range(3):
        one, one_ndc = _port(vs[b], vs[b][f], n[b].numpy())
        np.testing.assert_array_equal(vis[b].numpy(), one)
        np.testing.assert_array_equal(ndc[b].numpy(), one_ndc)


def test_batched_vertex_visibility_matches_reference_facade():
    vs, f = _bodies(batch=3, seed=3)
    ref_vis, ref_ndc = jax_batched_vis((vs, f), CAMS)
    out_vis, out_ndc = mesh_tpu_torch.batched_vertex_visibility(
        (vs, f), CAMS, device="cpu")
    assert out_vis.dtype == np.uint32 and out_vis.shape == ref_vis.shape
    assert out_ndc.dtype == np.float64 and out_ndc.shape == ref_ndc.shape
    np.testing.assert_allclose(out_ndc, ref_ndc, atol=NDC_TOL)
    for b in range(3):
        _assert_flags_or_borderline(out_vis[b], ref_vis[b], vs[b], vs[b][f])


def test_batched_vertex_visibility_uses_stored_normals():
    """Every mesh carrying ``vn``: n.dir comes from it (the reference's
    stored-normal rule), here against flipped normals."""
    vs, f = _bodies(batch=2, seed=4)
    meshes = []
    for v in vs:
        m = mesh_tpu_torch.Mesh(v, f, device="cpu")
        m.vn = -np.asarray(jax_vert_normals(v, f), np.float64)
        meshes.append(m)
    out_vis, out_ndc = mesh_tpu_torch.batched_vertex_visibility(
        meshes, CAMS, device="cpu")
    _, plain_ndc = mesh_tpu_torch.batched_vertex_visibility(
        (vs, f), CAMS, device="cpu")
    np.testing.assert_allclose(out_ndc, -plain_ndc, atol=NDC_TOL)
    jax_meshes = [mesh_tpu.Mesh(v=v, f=f) for v in vs]
    for jm, m in zip(jax_meshes, meshes):
        jm.vn = m.vn
    ref_vis, ref_ndc = jax_batched_vis(jax_meshes, CAMS)
    np.testing.assert_allclose(out_ndc, ref_ndc, atol=NDC_TOL)


class _Camera(object):
    def __init__(self, origin, sensor_axis):
        self.origin = np.asarray(origin)
        self.sensor_axis = np.asarray(sensor_axis)


def test_mesh_vertex_visibility_matches_reference_facade():
    vs, f = _bodies(batch=1, seed=5)
    ref = mesh_tpu.Mesh(v=vs[0], f=f)
    out = mesh_tpu_torch.Mesh(v=vs[0], f=f, device="cpu")
    cam = _Camera(CAMS[0], _sensors(6)[0])
    for camera in (CAMS[1], cam):
        ref_vis, ref_ndc = ref.vertex_visibility_and_normals(camera)
        vis, ndc = out.vertex_visibility_and_normals(camera)
        assert vis.dtype == ref_vis.dtype and vis.shape == ref_vis.shape
        np.testing.assert_allclose(ndc, ref_ndc, atol=NDC_TOL)
        origin = getattr(camera, "origin", camera)
        cams = np.asarray(origin, np.float32)[None]
        o, d = visibility_rays(torch.from_numpy(vs[0].astype(np.float32))[None],
                               torch.from_numpy(cams))
        differ = (vis != ref_vis).reshape(-1)
        assert not (differ & ~borderline_rays(
            o[0].numpy(), d[0].reshape(-1, 3).numpy(), vs[0][f])).any()
        out_v = out.vertex_visibility(camera, normal_threshold=0.1)
        ref_v = ref.vertex_visibility(camera, normal_threshold=0.1)
        assert out_v.shape == ref_v.shape and out_v.dtype == ref_v.dtype
        weighted = out.vertex_visibility(camera, binary_visiblity=False)
        np.testing.assert_allclose(weighted, np.squeeze(vis * ndc))
    sub = out.visible_mesh(CAMS[1])
    ref_sub = ref.visible_mesh(CAMS[1])
    assert isinstance(sub, mesh_tpu_torch.Mesh) and sub.device == out.device
    np.testing.assert_array_equal(sub.f, ref_sub.f)
    np.testing.assert_array_equal(sub.v, ref_sub.v)
    assert out.visibile_mesh(CAMS[1]).f.shape == sub.f.shape


# -- the reference's visibility cases (tests/test_visibility.py) ---------------

def _box():
    v, f = box(2.0)
    return v, f, vert_normals(v, f, device="cpu").numpy()


WALL_V = np.array([[-10, -10, 2.5], [10, -10, 2.5], [10, 10, 2.5],
                   [-10, 10, 2.5]])
WALL_F = np.array([[0, 1, 2], [0, 2, 3]])


@pytest.mark.parametrize("axis,sign", [(a, s) for a in range(3)
                                       for s in (1, -1)])
def test_box_each_side(axis, sign):
    v, f, n = _box()
    cam = np.zeros((1, 3))
    cam[0, axis] = sign * 10.0
    vis, _ = visibility_compute(v, f, cam, n=n, device="cpu")
    assert vis.shape == (1, 8) and vis.dtype == np.uint32
    np.testing.assert_array_equal(vis[0].astype(bool), sign * v[:, axis] > 0)


def test_box_several_cameras_and_axis_camera():
    v, f, n = _box()
    cams = np.array([[0, 0, 5.0], [0, 0, -5.0], [5.0, 0, 0]])
    vis, _ = visibility_compute(v, f, cams, n=n, device="cpu")
    assert vis.shape == (3, 8)
    np.testing.assert_array_equal(vis[0].astype(bool), v[:, 2] > 0)
    np.testing.assert_array_equal(vis[1].astype(bool), v[:, 2] < 0)
    np.testing.assert_array_equal(vis[2].astype(bool), v[:, 0] > 0)


def test_box_extra_occluder_and_min_dist():
    v, f, n = _box()
    cam = np.array([[0.0, 0.0, 5.0]])
    vis, _ = visibility_compute(v, f, cam, n=n, extra_v=WALL_V,
                                extra_f=WALL_F, device="cpu")
    assert not vis.any()
    # the wall is 1.5 in front of the +z face: rays starting 2.0 along
    # their direction begin beyond it
    vis, _ = visibility_compute(v, f, cam, n=n, extra_v=WALL_V,
                                extra_f=WALL_F, min_dist=2.0, device="cpu")
    np.testing.assert_array_equal(vis[0].astype(bool), v[:, 2] > 0)


def test_box_n_dot_cam():
    v, f, n = _box()
    _, ndc = visibility_compute(v, f, np.array([[0.0, 0.0, 100.0]]), n=n,
                                device="cpu")
    assert ndc.dtype == np.float64
    assert np.all(ndc[0][v[:, 2] > 0] > 0.3)
    assert np.all(ndc[0][v[:, 2] < 0] < 0.0)


def test_default_device_visibility_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device runs")
    v, f, n = _box()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        visibility_compute(v, f, [[0.0, 0.0, 5.0]])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh_tpu_torch.batched_vertex_visibility(
            (v[None].astype(np.float32), f), [[0.0, 0.0, 5.0]])
