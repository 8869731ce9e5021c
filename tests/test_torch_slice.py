"""The whole slice, mesh_tpu_torch vs mesh_tpu on the CPU: posed bodies ->
vertex normals -> closest points, through the batched and Mesh facades.
Tolerances and the tie contract are those of test_torch_closest."""

import numpy as np
import pytest
import torch

import mesh_tpu
from mesh_tpu.batch import (
    batched_closest_faces_and_points as jax_batched_closest,
    fused_normals_and_closest_points as jax_fused,
)
from mesh_tpu.geometry.vert_normals import vert_normals as jax_vert_normals
from mesh_tpu.models import body_model as jbm
from mesh_tpu.query.pallas_closest import closest_point_pallas

import mesh_tpu_torch
from mesh_tpu_torch.batch import batch_step
from mesh_tpu_torch.models import body_model as tbm
from mesh_tpu_torch.query.closest_kernel import mesh_is_nondegenerate

from .test_torch_closest import assert_tie_contract

torch.set_num_threads(2)


def _posed(batch=2, seed=0):
    """The same small posed batch from both packages: (model template
    faces, JAX vertices, port vertices, queries)."""
    v, f = jbm._uv_sphere(12, 10)
    template = (v * np.array([0.3, 0.2, 0.9]), f)
    jm = jbm.synthetic_body_model(seed=seed, template=template)
    tm = tbm.synthetic_body_model(seed=seed, template=template, device="cpu")
    rng = np.random.RandomState(seed)
    betas = (rng.randn(batch, 10) * 0.3).astype(np.float32)
    pose = (rng.randn(batch, 24, 3) * 0.1).astype(np.float32)
    queries = (rng.randn(batch, 64, 3) * 0.4).astype(np.float32)
    jv = np.array(jbm.lbs(jm, betas, pose)[0])
    tv = tbm.lbs(tm, betas, pose, device="cpu")[0]
    return f.astype(np.int32), jv, tv, queries


def test_slice_lbs_normals_closest_matches_reference():
    """bench.py's north-star step at a small size: lbs -> vert_normals ->
    the batched closest-point kernel, against the JAX package's own."""
    f, jv, tv, queries = _posed()
    # lbs: metre-scale vertices, float32 summation order only
    np.testing.assert_allclose(tv.numpy(), jv, atol=1e-5)
    nondegen = mesh_is_nondegenerate(tv.numpy(), f)
    assert nondegen
    normals, res = batch_step(tv, torch.from_numpy(f),
                              torch.from_numpy(queries),
                              assume_nondegenerate=nondegen)
    # unit normals from slightly different (1e-7) positions on ~0.1 faces
    np.testing.assert_allclose(normals.numpy(),
                               np.asarray(jax_vert_normals(jv, f)), atol=2e-5)
    for b in range(jv.shape[0]):
        ref = closest_point_pallas(jv[b], f, queries[b], tile_q=32,
                                   tile_f=128, interpret=True,
                                   assume_nondegenerate=nondegen)
        assert_tie_contract(ref, {k: x[b].numpy() for k, x in res.items()},
                            jv[b], f, queries[b])


def test_fused_normals_and_closest_points_matches_reference():
    f, jv, _, queries = _posed(batch=3, seed=1)
    ref_n, ref_f, ref_p = jax_fused((jv, f), queries)
    out_n, out_f, out_p = mesh_tpu_torch.fused_normals_and_closest_points(
        (jv, f), queries, device="cpu")
    assert out_n.dtype == np.float64 and out_n.shape == ref_n.shape
    assert out_f.dtype == np.uint32 and out_f.shape == ref_f.shape
    assert out_p.dtype == np.float64 and out_p.shape == ref_p.shape
    np.testing.assert_allclose(out_n, ref_n, atol=2e-6)
    for b in range(3):
        # the reference's own answer on this mesh, with sqdist and parts
        ref = closest_point_pallas(jv[b], f, queries[b], tile_q=32,
                                   tile_f=128, interpret=True)
        np.testing.assert_allclose(ref_p[b], np.asarray(ref["point"]),
                                   atol=1e-5)
        sq = ((out_p[b] - queries[b]) ** 2).sum(-1)
        assert_tie_contract(ref, {"face": out_f[b, 0], "point": out_p[b],
                                  "sqdist": sq,
                                  "part": np.asarray(ref["part"])},
                            jv[b], f, queries[b])


def test_batched_closest_faces_and_points_matches_reference():
    f, jv, _, queries = _posed(batch=2, seed=2)
    shared = queries[0]                            # [Q, 3] against every mesh
    ref_f, ref_p = jax_batched_closest((jv, f), shared)
    out_f, out_p = mesh_tpu_torch.batched_closest_faces_and_points(
        (jv, f), shared, device="cpu")
    assert out_f.dtype == np.uint32 and out_f.shape == ref_f.shape
    np.testing.assert_allclose(out_p, ref_p, atol=1e-5)
    ref_n = mesh_tpu.batched_vertex_normals((jv, f))
    out_n = mesh_tpu_torch.batched_vertex_normals((jv, f), device="cpu")
    np.testing.assert_allclose(out_n, ref_n, atol=2e-6)


def test_mesh_facade_matches_reference():
    f, jv, _, queries = _posed(batch=1, seed=3)
    q = queries[0]
    ref = mesh_tpu.Mesh(v=jv[0], f=f)
    out = mesh_tpu_torch.Mesh(v=jv[0], f=f, device="cpu")
    assert out.v.dtype == np.float64 and out.f.dtype == np.uint32

    ref_f, ref_p = ref.closest_faces_and_points(q)
    out_f, out_p = out.closest_faces_and_points(q)
    assert out_f.dtype == ref_f.dtype == np.uint32
    assert out_f.shape == ref_f.shape == (1, q.shape[0])
    assert out_p.dtype == np.float64 and out_p.shape == ref_p.shape
    np.testing.assert_allclose(out_p, ref_p, atol=1e-5)
    np.testing.assert_allclose(out.closest_points(q), out_p)

    ref_n = ref.estimate_vertex_normals()
    out_n = out.estimate_vertex_normals()
    assert out_n.dtype == np.float64
    np.testing.assert_allclose(out_n, ref_n, atol=2e-6)

    n2, f2, p2 = out.normals_and_closest_points(q)
    np.testing.assert_array_equal(f2, out_f)
    np.testing.assert_allclose(n2, out_n)
    np.testing.assert_allclose(p2, out_p)

    ref_i, ref_d = ref.closest_vertices(q)
    out_i, out_d = out.closest_vertices(q)
    assert out_d.dtype == np.float64 and out_i.shape == np.asarray(ref_i).shape
    np.testing.assert_allclose(out_d, ref_d, atol=1e-6)


def test_mesh_device_cache_follows_edits():
    f, jv, _, _ = _posed(batch=1, seed=4)
    m = mesh_tpu_torch.Mesh(v=jv[0], f=f, device="cpu")
    first = m.device_arrays()[0]
    assert m.device_arrays()[0] is first
    m.v *= 2.0
    second = m.device_arrays()[0]
    assert second is not first
    np.testing.assert_allclose(second.numpy(), (jv[0] * 2.0), rtol=1e-6)


def test_default_device_entry_points_raise_without_cuda():
    """On a host without CUDA the facades' default device raises instead
    of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device runs")
    f, jv, _, queries = _posed(batch=1, seed=5)
    calls = [
        lambda: mesh_tpu_torch.Mesh(v=jv[0], f=f),
        lambda: mesh_tpu_torch.fused_normals_and_closest_points(
            (jv, f), queries),
        lambda: mesh_tpu_torch.batched_closest_faces_and_points(
            (jv, f), queries),
        lambda: mesh_tpu_torch.batched_vertex_normals((jv, f)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
