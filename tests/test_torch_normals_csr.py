"""Vertex normals over the vertex-to-face CSR (geometry/vert_normals.py)
against mesh_tpu's ``vert_normals`` on the CPU: posed bodies, a UV sphere
with its high-valence poles, isolated vertices and zero-area faces; the
CSR's layout and cache; and the normals' bits for a mesh alone and inside
a batch.
"""

import importlib

import numpy as np
import pytest
import torch

import mesh_tpu.models.body_model as jbm

import mesh_tpu_torch.models.body_model as tbm

from .fixtures import icosphere

# the geometry packages re-export functions under their module names
jax_vert_normals = importlib.import_module(
    "mesh_tpu.geometry.vert_normals").vert_normals
tvn = importlib.import_module("mesh_tpu_torch.geometry.vert_normals")

torch.set_num_threads(2)

#: float32 rounding and summation order only, the bar of
#: tests/test_torch_geometry.py
ATOL = 2e-6


def _bodies(batch=3, seed=0):
    """(posed vertices [B, V, 3] float32, faces [F, 3] int32) from
    mesh_tpu's lbs on a small synthetic body model."""
    v, f = jbm._uv_sphere(16, 12)
    model = jbm.synthetic_body_model(
        seed=seed, template=(v * np.array([0.3, 0.2, 0.9]), f))
    rng = np.random.RandomState(seed)
    betas = (rng.randn(batch, 10) * 0.3).astype(np.float32)
    pose = (rng.randn(batch, 24, 3) * 0.1).astype(np.float32)
    return np.array(jbm.lbs(model, betas, pose)[0]), f.astype(np.int32)


def _port(v, f):
    return tvn.vert_normals(v, f, device="cpu").numpy()


def _float64(v, f):
    """Area-weighted unit normals recomputed in float64 with numpy."""
    v = np.asarray(v, np.float64)
    flat = v.reshape((-1,) + v.shape[-2:])
    acc = np.zeros_like(flat)
    for b, vb in enumerate(flat):
        tri = vb[f]
        fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        for k in range(3):
            np.add.at(acc[b], f[:, k], fn)
    norm = np.linalg.norm(acc, axis=-1, keepdims=True)
    out = np.where(norm > 0, acc / np.where(norm > 0, norm, 1.0), 0.0)
    return out.reshape(v.shape)


def test_posed_bodies_match_reference():
    v, f = _bodies()
    out = _port(v, f)
    np.testing.assert_allclose(out, np.asarray(jax_vert_normals(v, f)),
                               atol=ATOL)
    np.testing.assert_allclose(out, _float64(v, f), atol=1e-6)


@pytest.mark.parametrize("n_lon, n_lat", [(16, 12), (256, 8)])
def test_uv_sphere_poles_match_reference(n_lon, n_lat):
    """A UV sphere's two poles have valence ``n_lon`` (256 as the
    large-batch template's): one segment each, no padded table."""
    v, f = jbm._uv_sphere(n_lon, n_lat)
    v = np.asarray(v, np.float32)
    offsets, _ = tvn.vertex_csr(f, v.shape[0])
    valence = np.diff(offsets.numpy())
    assert valence.max() == n_lon
    out = _port(v, f)
    np.testing.assert_allclose(out, np.asarray(jax_vert_normals(v, f)),
                               atol=ATOL)
    np.testing.assert_allclose(out, _float64(v, f), atol=1e-6)


def test_isolated_vertices_and_zero_area_faces():
    v, f = icosphere(1)
    v = np.vstack([v, [[5.0, 5.0, 5.0], [6.0, 6.0, 6.0]]]).astype(np.float32)
    # zero-area faces: a repeated corner, and three collinear corners
    v = np.vstack([v, [[0.0, 0.0, 2.0], [0.0, 0.0, 3.0], [0.0, 0.0, 4.0]]])
    n = v.shape[0]
    f = np.vstack([f, [[0, 0, 1], [n - 3, n - 2, n - 1]]]).astype(np.int32)
    out = _port(v.astype(np.float32), f)
    ref = np.asarray(jax_vert_normals(v.astype(np.float32), f))
    np.testing.assert_allclose(out, ref, atol=ATOL)
    # isolated vertices and the collinear face's corners: zero
    for idx in (n - 5, n - 4, n - 3, n - 2, n - 1):
        assert np.all(out[idx] == 0)
    unit = np.linalg.norm(out[:n - 5], axis=-1)
    np.testing.assert_allclose(unit, 1.0, atol=1e-6)


@pytest.mark.parametrize("shape", [(), (3,), (2, 3)])
def test_batch_shapes(shape):
    v, f = _bodies(batch=int(np.prod(shape)) or 1, seed=4)
    v = v.reshape(shape + v.shape[-2:])
    out = _port(v, f)
    assert out.shape == v.shape and out.dtype == np.float32
    flat = out.reshape((-1,) + v.shape[-2:])
    for b, vb in enumerate(v.reshape((-1,) + v.shape[-2:])):
        # each mesh's normals alone: the same bits as inside the batch
        assert np.array_equal(_port(vb, f), flat[b])


def test_float64_vertices_keep_their_dtype():
    v, f = _bodies(batch=1)
    out = tvn.vert_normals(v.astype(np.float64), f, device="cpu")
    assert out.dtype == torch.float64
    scaled = tvn.vert_normals_scaled_t(torch.from_numpy(v),
                                       torch.from_numpy(f))
    assert scaled.dtype == torch.float32 and scaled.shape == v.shape


def test_csr_layout_is_face_order_per_vertex():
    v, f = icosphere(2)
    offsets, slot_faces = (x.numpy() for x in tvn.vertex_csr(f, v.shape[0]))
    assert offsets.shape == (v.shape[0] + 1,) and offsets[0] == 0
    assert slot_faces.shape == (3 * f.shape[0],)
    for vert in range(v.shape[0]):
        faces = slot_faces[offsets[vert]:offsets[vert + 1]]
        want = np.nonzero((f == vert).any(axis=1))[0]
        assert np.array_equal(faces, want)


def test_csr_cache_follows_the_faces():
    v, f = icosphere(2)
    ft = torch.from_numpy(np.asarray(f, np.int64)).clone()
    first = tvn.vertex_csr(ft, v.shape[0])
    assert tvn.vertex_csr(ft, v.shape[0]) is first        # unchanged tensor
    assert tvn.vertex_csr(np.asarray(f), v.shape[0]) is first   # same bytes
    # an in-place edit (a new version of the tensor) and a new face array
    ft[0] = ft[1]
    edited = tvn.vertex_csr(ft, v.shape[0])
    want = tvn._host_csr(ft.numpy(), v.shape[0])
    assert edited is not first
    assert all(np.array_equal(x.numpy(), y) for x, y in zip(edited, want))
    f2 = np.asarray(f)[::-1].copy()
    other = tvn.vertex_csr(f2, v.shape[0])
    assert not torch.equal(other[1], first[1])
    vt = torch.from_numpy(np.asarray(v, np.float32))
    np.testing.assert_allclose(
        tvn.vert_normals_t(vt, torch.from_numpy(f2)).numpy(),
        np.asarray(jax_vert_normals(np.asarray(v, np.float32), f2)),
        atol=ATOL)


def test_csr_rejects_faces_outside_the_vertices():
    v, f = icosphere(1)
    with pytest.raises(ValueError, match="outside"):
        tvn.vertex_csr(np.asarray(f), int(f.max()))


def test_explicit_csr_equals_the_cached_one():
    v, f = _bodies(batch=2, seed=6)
    vt, ft = torch.from_numpy(v), torch.from_numpy(f)
    csr = tvn.vertex_csr(f, v.shape[1])
    assert torch.equal(tvn.vert_normals_t(vt, ft, csr),
                       tvn.vert_normals_t(vt, ft))


def test_runs_are_bit_identical():
    v, f = _bodies(batch=4, seed=7)
    runs = [_port(v, f) for _ in range(3)]
    assert all(np.array_equal(r, runs[0]) for r in runs)


def test_port_body_model_normals():
    """The port's own synthetic body model, posed by the port's lbs."""
    model = tbm.synthetic_body_model(seed=1, device="cpu")
    rng = np.random.RandomState(1)
    betas = torch.as_tensor(rng.randn(2, model.num_betas) * 0.3,
                            dtype=torch.float32)
    pose = torch.as_tensor(rng.randn(2, model.num_joints, 3) * 0.1,
                           dtype=torch.float32)
    verts, _ = tbm.lbs(model, betas, pose, device="cpu")
    out = tvn.vert_normals_t(verts, model.faces).numpy()
    np.testing.assert_allclose(out, _float64(verts.numpy(),
                                             model.faces.numpy()), atol=1e-6)
