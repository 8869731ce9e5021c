"""mesh_tpu_torch normal-weighted nearest face vs mesh_tpu, on the CPU.

The port's ``nearest_normal_weighted`` (the kernel's plain version on a CPU
tensor) is held against ``nearest_normal_weighted_pallas(...,
interpret=True)`` and the XLA ``normal_weighted.nearest_normal_weighted``
under the tie contract: faces agree except where the two faces' blended
costs |p - q| + eps (1 - n_p . n_tri), recomputed in float64, tie within
1e-6 (the packages center on the vertex mean with different float32
reductions, which moves exact ties); points agree to 1e-5 wherever faces
do.  The reference's aabb_normals fixtures
(tests/test_reference_fixtures.py) are replayed through the port.
"""

import numpy as np
import pytest
import torch

from mesh_tpu.geometry.compat import NormalizeRows, TriToScaledNormal
from mesh_tpu.models import body_model as jbm
from mesh_tpu.query.normal_weighted import (
    nearest_normal_weighted as jax_nw_xla,
)
from mesh_tpu.query.pallas_normal_weighted import (
    nearest_normal_weighted_pallas,
)

import mesh_tpu_torch
from mesh_tpu_torch.query import closest_kernel as ck
from mesh_tpu_torch.query import normal_weighted as nw
from mesh_tpu_torch.query.point_triangle import closest_point_on_triangle

from .test_reference_fixtures import (
    CYL_F,
    CYL_TRANS_F,
    CYL_TRANS_V,
    CYL_V,
    DOUBLEBOX_F,
    DOUBLEBOX_V,
)
from .test_torch_closest import with_degenerate_faces

torch.set_num_threads(2)

TIE_TOL = 1e-6
VALUE_TOL = 1e-5


def blended_cost64(v, f, q, n, faces, eps):
    """|q - closest point| + eps (1 - n . unit face normal) per query on
    its face, in float64."""
    tri = torch.from_numpy(np.asarray(v, np.float64)[np.asarray(f)[faces]])
    qt = torch.from_numpy(np.asarray(q, np.float64))
    _, sq, _ = closest_point_on_triangle(qt, tri[:, 0], tri[:, 1], tri[:, 2])
    fn = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    fn = fn / fn.norm(dim=-1, keepdim=True).clamp_min(1e-300)
    ndot = (torch.from_numpy(np.asarray(n, np.float64)) * fn).sum(-1)
    return (sq.sqrt() + eps * (1.0 - ndot)).numpy()


def assert_nw_tie_contract(ref_face, ref_point, face, point, v, f, q, n,
                           eps):
    ref_face, face = np.asarray(ref_face), np.asarray(face)
    same = ref_face == face
    np.testing.assert_allclose(np.asarray(point)[same],
                               np.asarray(ref_point)[same], atol=VALUE_TOL)
    if not same.all():
        gap = np.abs(blended_cost64(v, f, q[~same], n[~same], face[~same],
                                    eps)
                     - blended_cost64(v, f, q[~same], n[~same],
                                      ref_face[~same], eps))
        assert gap.max() <= TIE_TOL, gap.max()
    return same.mean()


def _body(seed=0):
    v, f = jbm._uv_sphere(16, 12)
    rng = np.random.RandomState(seed)
    v = v * np.array([0.3, 0.2, 0.9]) + rng.randn(*v.shape) * 0.005
    return v.astype(np.float32), f.astype(np.int32)


def _queries(n_q, seed, scale=0.4):
    rng = np.random.RandomState(seed)
    q = (rng.randn(n_q, 3) * scale).astype(np.float32)
    n = rng.randn(n_q, 3)
    return q, (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(
        np.float32)


def _port(v, f, q, n, eps, tail):
    face, point = nw.nearest_normal_weighted_kernel(
        *(torch.from_numpy(x) for x in (v, f.astype(np.int64), q, n)),
        eps=eps, assume_nondegenerate=not tail)
    return face.numpy(), point.numpy()


@pytest.mark.parametrize("eps", [0.1, 1.0])
@pytest.mark.parametrize("tail", [False, True])
def test_matches_pallas(tail, eps):
    v, f = _body(seed=1)
    q, n = _queries(96, seed=2)
    ref_f, ref_p = nearest_normal_weighted_pallas(
        v, f, q, n, eps=eps, tile_q=32, tile_f=128, interpret=True,
        assume_nondegenerate=not tail)
    face, point = _port(v, f, q, n, eps, tail)
    assert face.dtype == np.int32 and point.shape == q.shape
    assert assert_nw_tie_contract(ref_f, ref_p, face, point, v, f, q, n,
                                  eps) > 0.9


def test_matches_xla_path():
    v, f = _body(seed=3)
    q, n = _queries(80, seed=4)
    ref_f, ref_p = jax_nw_xla(v, f, q, n, eps=0.1, chunk=32)
    face, point = nw.nearest_normal_weighted(v, f, q, n, eps=0.1,
                                             device="cpu")
    assert assert_nw_tie_contract(ref_f, ref_p, face.numpy(), point.numpy(),
                                  v, f, q, n, 0.1) > 0.9


@pytest.mark.parametrize("eps,collinear", [(0.1, False), (0.0, True)])
def test_degenerate_tail_matches_pallas(eps, collinear):
    """Planted zero-area faces have an exact zero normal, so the blended
    metric is defined on them for any eps.  A collinear face's float32
    normal is rounding noise in either package (its cross product cancels),
    so collinear faces are held to the metric only at eps = 0, where it is
    the distance the degenerate tail computes."""
    rng = np.random.RandomState(5)
    v, f, q = with_degenerate_faces(*_body(seed=5), rng)
    if not collinear:
        f = f[:-8]                            # keep the zero-area faces
    assert not ck.mesh_is_nondegenerate(v, f)
    _, n = _queries(q.shape[0], seed=6)
    ref_f, ref_p = nearest_normal_weighted_pallas(
        v, f, q, n, eps=eps, tile_q=32, tile_f=128, interpret=True)
    face, point = _port(v, f, q, n, eps, True)
    assert_nw_tie_contract(ref_f, ref_p, face, point, v, f, q, n, eps)
    if not collinear:
        # the zero normal's flat penalty lets planted faces win
        assert (face >= f.shape[0] - 8).any()


def test_eps_zero_is_closest_point():
    v, f = _body(seed=7)
    q, n = _queries(64, seed=8)
    _, point = _port(v, f, q, n, 0.0, True)
    res = ck.closest_point_kernel(*(torch.from_numpy(x) for x in (v, f, q)))
    np.testing.assert_allclose(point, res["point"].numpy(), atol=VALUE_TOL)


def test_batch_is_per_mesh():
    vs = np.stack([_body(seed=s)[0] for s in range(3)])
    f = _body()[1]
    rng = np.random.RandomState(9)
    qs = (rng.randn(3, 40, 3) * 0.4).astype(np.float32)
    ns = rng.randn(3, 40, 3).astype(np.float32)
    args = [torch.from_numpy(x) for x in (vs, f.astype(np.int64), qs, ns)]
    face, point = nw.nearest_normal_weighted_kernel(*args)
    for b in range(3):
        one_f, one_p = nw.nearest_normal_weighted_kernel(
            args[0][b], args[1], args[2][b], args[3][b])
        np.testing.assert_array_equal(face[b].numpy(), one_f.numpy())
        np.testing.assert_array_equal(point[b].numpy(), one_p.numpy())


def test_wrapper_rejects_bad_operands_and_cpu_takes_plain(monkeypatch):
    v, f = _body()
    q, n = _queries(10, seed=10)
    pts, nrm, planes, _, _ = nw.normal_weighted_operands(
        *(torch.from_numpy(x)[None] for x in (v,)), torch.from_numpy(f),
        torch.from_numpy(q)[None], torch.from_numpy(n)[None])
    assert tuple(planes.shape) == (1, nw.N_NW_ROWS, f.shape[0])
    with pytest.raises(ValueError):
        nw.argmin_normal_weighted(pts, nrm[:, :5].contiguous(), planes)
    with pytest.raises(ValueError):
        nw.argmin_normal_weighted(pts, nrm, planes[:, :19].contiguous())
    before = dict(nw.LAUNCHES)
    whole = nw.argmin_normal_weighted(pts, nrm, planes)
    assert torch.equal(whole, nw.argmin_normal_weighted_plain(pts, nrm,
                                                              planes))
    assert nw.LAUNCHES == before
    monkeypatch.setitem(ck._PLAIN_PAIRS, "cpu", 3 * f.shape[0] + 1)
    assert torch.equal(nw.argmin_normal_weighted_plain(pts, nrm, planes),
                       whole)


# -- the reference's aabb_normals fixtures (TestAabbNormalsFixtureParity) ------

class _M:
    def __init__(self, v, f):
        self.v = np.asarray(v, np.float64)
        self.f = np.asarray(f, np.int32)


@pytest.mark.parametrize("eps,expected_tri,expected_p", [
    # eps=0 is the classic euclidean nearest face
    (0.0, [[0], [0]], [[0.5, 0.1, 0.25], [0.5, 0.1, 0.25]]),
    # eps=0.5 pulls query 0 (normal +y) to the top face
    (0.5, [[2], [0]], [[0.5, 0.5, 0.25], [0.5, 0.1, 0.25]]),
])
def test_fixture_double_box(eps, expected_tri, expected_p):
    tree = mesh_tpu_torch.AabbNormalsTree(_M(DOUBLEBOX_V, DOUBLEBOX_F),
                                          eps=eps, device="cpu")
    query_v = np.array([[0.5, 0.1, 0.25], [0.5, 0.1, 0.25]])
    query_n = np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]])
    closest_tri, closest_p = tree.nearest(query_v, query_n)
    assert closest_tri.dtype == np.uint32 and closest_tri.shape == (2, 1)
    assert (closest_tri == np.array(expected_tri)).all()
    np.testing.assert_allclose(closest_p, expected_p, atol=1e-6)


def test_fixture_cylinders_coverage():
    # facing half-cylinders: without the normal term every winner is at the
    # two extremes (<= 4 unique faces); with eps=10 nearly every face wins
    tri_n = NormalizeRows(TriToScaledNormal(CYL_TRANS_V, CYL_TRANS_F))
    query_n = np.zeros(CYL_TRANS_V.shape)
    for i_f in range(CYL_TRANS_F.shape[0]):
        query_n[CYL_TRANS_F[i_f, :], :] += tri_n[i_f, :]
    query_n = NormalizeRows(query_n)
    cyl = _M(CYL_V, CYL_F)
    closest_tri, _ = mesh_tpu_torch.AabbNormalsTree(
        cyl, eps=0, device="cpu").nearest(CYL_TRANS_V, query_n)
    assert np.unique(closest_tri).shape[0] <= 4
    closest_tri_n, _ = mesh_tpu_torch.AabbNormalsTree(
        cyl, eps=10, device="cpu").nearest(CYL_TRANS_V, query_n)
    assert np.unique(closest_tri_n).shape[0] >= CYL_F.shape[0] - 4
