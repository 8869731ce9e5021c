"""mesh_tpu_torch search trees and Mesh tree facades vs mesh_tpu, on the
CPU: ``AabbTree`` (nearest, nearest_alongnormal), ``ClosestPointTree``,
``CGALClosestPointTree`` and ``AabbNormalsTree``, with the reference's
dtypes and shapes.  mesh_tpu's CPU facades take its XLA paths; tolerances
and tie contracts are those of test_torch_closest, test_torch_ray and
test_torch_normal_weighted."""

import numpy as np
import pytest
import torch

import mesh_tpu
from mesh_tpu.search import (
    AabbNormalsTree as JaxAabbNormalsTree,
    AabbTree as JaxAabbTree,
    CGALClosestPointTree as JaxCGALTree,
    ClosestPointTree as JaxClosestPointTree,
)

import mesh_tpu_torch
from mesh_tpu_torch import search

from .test_torch_closest import assert_tie_contract, small_body
from .test_torch_normal_weighted import assert_nw_tie_contract

torch.set_num_threads(2)


class _M(object):
    def __init__(self, v, f):
        self.v, self.f = v, f


def _mesh(seed=0):
    v, f = small_body(seed=seed, n_seg=16, n_ring=12)
    rng = np.random.RandomState(seed)
    q = (rng.randn(64, 3) * 0.4).astype(np.float32)
    n = rng.randn(64, 3)
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    return v, f, q, n


def test_aabb_tree_nearest_matches_reference():
    v, f, q, _ = _mesh(seed=1)
    ref_f, ref_part, ref_p = JaxAabbTree(_M(v, f)).nearest(q, True)
    tree = mesh_tpu_torch.Mesh(v, f, device="cpu").compute_aabb_tree()
    assert isinstance(tree, search.AabbTree)
    out_f, out_part, out_p = tree.nearest(q, nearest_part=True)
    assert out_f.dtype == out_part.dtype == np.uint32
    assert out_f.shape == out_part.shape == ref_f.shape == (1, q.shape[0])
    assert out_p.dtype == np.float64 and out_p.shape == ref_p.shape
    ref = {"face": ref_f[0], "part": ref_part[0], "point": ref_p,
           "sqdist": ((ref_p - q) ** 2).sum(-1)}
    out = {"face": out_f[0], "part": out_part[0], "point": out_p,
           "sqdist": ((out_p - q) ** 2).sum(-1)}
    assert_tie_contract(ref, out, v, f, q)
    f2, p2 = tree.nearest(q)
    np.testing.assert_array_equal(f2, out_f)
    np.testing.assert_array_equal(p2, out_p)


def test_aabb_tree_nearest_alongnormal_matches_reference():
    v, f, q, n = _mesh(seed=2)
    q = np.vstack([q, [[50.0, 0.0, 0.0]]]).astype(np.float32)   # a miss
    n = np.vstack([n, [[0.0, 1.0, 0.0]]]).astype(np.float32)
    ref_d, ref_f, ref_p = JaxAabbTree(_M(v, f)).nearest_alongnormal(q, n)
    out_d, out_f, out_p = mesh_tpu_torch.Mesh(
        v, f, device="cpu").compute_aabb_tree().nearest_alongnormal(q, n)
    assert out_d.dtype == np.float64 and out_d.shape == ref_d.shape
    assert out_f.dtype == np.uint32 and out_f.shape == ref_f.shape
    assert out_d[-1] == ref_d[-1] == 1e100
    hit = out_d < 1e100
    np.testing.assert_array_equal(hit, ref_d < 1e100)
    np.testing.assert_allclose(out_d[hit], ref_d[hit], atol=1e-5)
    same = out_f == ref_f
    assert same.mean() > 0.9
    np.testing.assert_allclose(out_p[same], ref_p[same], atol=1e-5)


@pytest.mark.parametrize("use_cgal", [False, True])
def test_closest_point_trees_match_reference(use_cgal):
    v, f, q, _ = _mesh(seed=3)
    jax_cls = JaxCGALTree if use_cgal else JaxClosestPointTree
    ref_i, ref_d = jax_cls(_M(v, f)).nearest(q)
    tree = mesh_tpu_torch.Mesh(v, f, device="cpu").compute_closest_point_tree(
        use_cgal=use_cgal)
    assert isinstance(tree, search.CGALClosestPointTree if use_cgal
                      else search.ClosestPointTree)
    out_i, out_d = tree.nearest(q)
    assert out_i.shape == np.asarray(ref_i).shape
    assert out_d.dtype == np.float64 and out_d.shape == ref_d.shape
    np.testing.assert_allclose(out_d, ref_d, atol=1e-6)
    assert (out_i == np.asarray(ref_i)).mean() > 0.9
    np.testing.assert_allclose(
        tree.nearest_vertices(q), np.asarray(v, np.float64)[out_i])


def test_aabb_normals_tree_matches_reference():
    v, f, q, n = _mesh(seed=4)
    ref_f, ref_p = JaxAabbNormalsTree(_M(v, f)).nearest(q, n)
    tree = mesh_tpu_torch.Mesh(v, f, device="cpu").compute_aabb_normals_tree()
    assert isinstance(tree, search.AabbNormalsTree) and tree.eps == 0.1
    out_f, out_p = tree.nearest(q, n)
    assert out_f.dtype == np.uint32 and out_f.shape == ref_f.shape
    assert out_f.shape == (q.shape[0], 1)
    assert out_p.dtype == np.float64 and out_p.shape == ref_p.shape
    assert assert_nw_tie_contract(ref_f[:, 0], ref_p, out_f[:, 0], out_p, v,
                                  f, q, n, 0.1) > 0.9


def test_trees_take_a_mesh_device_or_their_own():
    v, f, _, _ = _mesh()
    m = mesh_tpu_torch.Mesh(v, f, device="cpu")
    assert m.compute_aabb_normals_tree().device == torch.device("cpu")
    assert search.AabbTree(_M(v, f), device="cpu").v.dtype == torch.float32
    if not torch.cuda.is_available():
        for cls in (search.AabbTree, search.AabbNormalsTree,
                    search.ClosestPointTree):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                cls(_M(v, f))


def test_unported_queries_raise():
    v, f, _, _ = _mesh()
    m = mesh_tpu_torch.Mesh(v, f, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        m.compute_aabb_tree(strategy="anchored")
    with pytest.raises(ValueError):
        m.compute_aabb_tree(strategy="exact")
    # the reference's surface exists on the JAX side too
    assert hasattr(mesh_tpu.Mesh, "compute_aabb_tree")


@pytest.mark.parametrize("shift", [0.05, 0.3, 5.0])
def test_aabb_tree_intersections_indices_matches_reference(shift):
    """Indices of the query faces intersecting the mesh, through the Mesh
    facade's tree, against mesh_tpu's: a second posed body, shifted so the
    two overlap partly (0.05, 0.3) or not at all (5.0)."""
    v, f, _, _ = _mesh(seed=5)
    qv, qf, _, _ = _mesh(seed=6)
    qv = (qv + np.array([shift, 0.0, 0.0])).astype(np.float32)
    ref = JaxAabbTree(_M(v, f)).intersections_indices(qv, qf)
    out = mesh_tpu_torch.Mesh(v, f, device="cpu").compute_aabb_tree(
        ).intersections_indices(qv, qf.astype(np.uint32))
    assert out.dtype == ref.dtype == np.int64
    np.testing.assert_array_equal(out, ref)
    assert (out.size > 0) == (shift < 1.0)
    assert out.size < len(qf)
