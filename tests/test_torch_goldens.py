"""The port against the reference stack's own golden values, and the rest
of its geometry (triangle areas, projected barycentrics, the chumpy-era
names, Rodrigues both ways with Jacobians) against mesh_tpu, on the CPU.

The goldens are those of tests/test_reference_goldens.py: CGAL AABB-tree
outputs (faces exact, points within 1e-4 in float32) and the legacy
MATLAB barycentric outputs (within 1e-3), with that file's bars.
"""

import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import mesh_tpu.geometry as jgeo

import mesh_tpu_torch as T
import mesh_tpu_torch.geometry as tgeo

from .fixtures import icosphere
from .test_reference_goldens import (
    AABB_F_SRC,
    AABB_FACES_EXPECTED,
    AABB_POINTS_EXPECTED,
    AABB_QUERIES,
    AABB_V_SRC,
    BARY_EXPECTED,
    BARY_P,
    BARY_Q,
    BARY_U,
    BARY_V,
)

jrod = importlib.import_module("mesh_tpu.geometry.rodrigues")

torch.set_num_threads(2)

COMPAT = ("TriNormals", "TriNormalsScaled", "TriToScaledNormal",
          "VertNormals", "VertNormalsScaled")


def test_aabb_tree_nearest_matches_cgal_goldens():
    tree = T.Mesh(v=AABB_V_SRC, f=AABB_F_SRC,
                  device="cpu").compute_aabb_tree()
    f_est, v_est = tree.nearest(AABB_QUERIES)
    np.testing.assert_array_equal(np.asarray(f_est).ravel(),
                                  AABB_FACES_EXPECTED)
    assert np.abs(np.asarray(v_est) - AABB_POINTS_EXPECTED).max() < 1e-4


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_barycentric_matches_matlab_goldens(dtype):
    args = [x.astype(dtype) for x in (BARY_P, BARY_Q, BARY_U, BARY_V)]
    b = tgeo.barycentric_coordinates_of_projection(*args, device="cpu")
    assert b.dtype == torch.from_numpy(args[0]).dtype
    assert np.max(np.abs(b.numpy() - BARY_EXPECTED)) < 1e-3
    # the single-row (vector) form
    b0 = tgeo.barycentric_coordinates_of_projection(
        *[x[0] for x in args], device="cpu")
    assert np.max(np.abs(b0.numpy().ravel() - BARY_EXPECTED[0])) < 1e-3


def test_barycentric_matches_reference_with_degenerate_rows():
    """Random triangles match; collinear and zero edges take the epsilon
    guard and stay finite (their values are rounding, in either package)."""
    rng = np.random.RandomState(0)
    p, q, u, v = rng.randn(4, 16, 3).astype(np.float32)
    v[3] = u[3] * 2.0                               # collinear edges
    v[5] = 0.0                                      # a zero edge
    out = tgeo.barycentric_coordinates_of_projection(p, q, u, v,
                                                     device="cpu").numpy()
    ref = np.asarray(jgeo.barycentric_coordinates_of_projection(p, q, u, v))
    good = np.ones(16, bool)
    good[[3, 5]] = False
    np.testing.assert_allclose(out[good], ref[good], rtol=1e-5, atol=1e-5)
    assert np.all(np.isfinite(out))


@pytest.mark.parametrize("batched", [False, True])
def test_triangle_area_matches_reference(batched):
    v, f = icosphere(2)
    v = v.astype(np.float32)
    if batched:
        v = np.stack([v, v * 1.5])
    np.testing.assert_allclose(
        tgeo.triangle_area(v, f.astype(np.int32), device="cpu").numpy(),
        np.asarray(jgeo.triangle_area(v, f.astype(np.int32))), rtol=1e-6,
        atol=1e-7)


@pytest.mark.parametrize("name", COMPAT)
def test_compat_matches_reference(name):
    v, f = icosphere(2)
    out = getattr(tgeo, name)(v, f, device="cpu")
    ref = np.asarray(getattr(jgeo, name)(v, f))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_compat_edges_rows_and_products_match_reference():
    v, f = icosphere(1)
    # float64 here, float32 in the reference (x64 off)
    np.testing.assert_allclose(tgeo.TriEdges(v, f, 1, 0, device="cpu"),
                               np.asarray(jgeo.TriEdges(v, f, 1, 0)),
                               atol=1e-6)
    rng = np.random.RandomState(0)
    a, b = rng.randn(2, 30)
    np.testing.assert_allclose(tgeo.CrossProduct(a, b, device="cpu"),
                               np.asarray(jgeo.CrossProduct(a, b)),
                               atol=1e-12)
    x = np.array([0.0, 0, 0, 3, 0, 0])
    np.testing.assert_array_equal(tgeo.NormalizedNx3(x, device="cpu"),
                                  [0, 0, 0, 1, 0, 0])
    rows = rng.randn(4, 3)
    np.testing.assert_allclose(tgeo.NormalizeRows(rows, device="cpu"),
                               np.asarray(jgeo.NormalizeRows(rows)),
                               atol=1e-12)
    mtx = sp.csc_matrix(np.arange(12).reshape(3, 4))
    vec = np.arange(4)
    np.testing.assert_allclose(tgeo.MatVecMult(mtx, vec, device="cpu"),
                               mtx.toarray() @ vec, atol=0)


def test_rotmat2rodrigues_matches_reference():
    rng = np.random.RandomState(6)
    r = np.vstack([rng.randn(16, 3) * 0.9, np.zeros((1, 3)),
                   [[np.pi, 0, 0], [0, -np.pi, 0]]])
    R = np.asarray(jrod.rodrigues2rotmat(r.astype(np.float32)),
                   dtype=np.float64)
    out = tgeo.rotmat2rodrigues(R, device="cpu").numpy()
    ref = np.asarray(jrod.rotmat2rodrigues(R.astype(np.float32)))
    # float64 here, float32 in the reference: its rounding
    np.testing.assert_allclose(out, ref, atol=1e-4)
    np.testing.assert_allclose(out[:16], r[:16], atol=1e-4)


@pytest.mark.parametrize("case", ["generic", "zero", "small"])
def test_rodrigues_forward_with_jacobian_matches_reference(case):
    r = {"generic": np.array([0.3, -0.5, 0.8]), "zero": np.zeros(3),
         "small": np.array([1e-5, -2e-5, 1e-5])}[case]
    R, J = tgeo.rodrigues(r, device="cpu")
    Rr, Jr = jrod.rodrigues(r)
    assert R.dtype == np.float64 and J.shape == (3, 9)
    np.testing.assert_allclose(R, Rr, atol=1e-7)
    np.testing.assert_allclose(J, Jr, atol=1e-6)
    np.testing.assert_allclose(tgeo.rodrigues(r, False, device="cpu"), Rr,
                               atol=1e-7)


def test_rodrigues_inverse_with_jacobian_matches_reference():
    rng = np.random.RandomState(5)
    for r in list(rng.randn(4, 3)) + [np.zeros(3)]:
        R = jrod.rodrigues(r, calculate_jacobian=False)
        out, J = tgeo.rodrigues(R, device="cpu")
        ref, Jr = jrod.rodrigues(R)
        assert out.shape == (3, 1) and J.shape == (9, 3)
        np.testing.assert_allclose(out, ref, atol=1e-7)
        np.testing.assert_allclose(J, Jr, atol=1e-6)
    with pytest.raises(ValueError):
        tgeo.rodrigues(np.zeros(4), device="cpu")
