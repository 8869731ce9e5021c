"""mesh_tpu_torch ray kernels vs mesh_tpu, on the CPU: the any-hit test
and the along-normal search.

Inputs come from numpy RandomState seeds and go to both packages.  The JAX
side runs its Pallas kernels in interpret mode (small tiles), as
tests/test_pallas_ray.py does; the port runs its kernels' plain versions,
which is what a CPU tensor selects.  Both evaluate the same division-free
predicate in float32 without centering, so flags and faces are held to
equality, and distances and points to 1e-5.  Against the reference's
divided form (``ray.ray_triangle_hits``, its XLA path) a flag may differ
only on a ray that is borderline at rounding level (``borderline_rays``).
"""

import numpy as np
import pytest
import torch

from mesh_tpu.query.pallas_ray import (
    nearest_alongnormal_pallas,
    ray_any_hit_pallas,
)
from mesh_tpu.query.ray import _nearest_alongnormal_xla
from mesh_tpu.query.ray import ray_triangle_hits as jax_ray_triangle_hits
from mesh_tpu.search import AabbTree as JaxAabbTree

import mesh_tpu_torch
from mesh_tpu_torch.query import ray_kernel as rk
from mesh_tpu_torch.query.ray import nearest_alongnormal, ray_triangle_hits

from .fixtures import box, icosphere

torch.set_num_threads(2)

VALUE_TOL = 1e-5
#: a flag of the divided form may differ from the division-free one only on
#: a ray whose float64 barycentric or ray-parameter slack on some face is
#: below this: rounding level for unit-scale geometry
BORDERLINE = 1e-5


def borderline_rays(o, d, tri, t_lo=0.0):
    """True per ray [R] where some face of ``tri`` [F, 3, 3] sits within
    BORDERLINE of the predicate's boundary in float64 (so float32 rounding
    may decide either way)."""
    o, d, tri = (np.asarray(x, np.float64) for x in (o, d, tri))
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    t, _ = (np.asarray(x) for x in ray_triangle_hits(
        *(torch.from_numpy(x) for x in (o[:, None], d[:, None], a[None],
                                        b[None], c[None]))))
    e1, e2 = b - a, c - a
    pvec = np.cross(d[:, None], e2[None])
    det = (e1[None] * pvec).sum(-1)
    det = np.where(det == 0, 1e-300, det)
    s = o[:, None] - a[None]
    u = (s * pvec).sum(-1) / det
    qvec = np.cross(s, e1[None])
    v = (d[:, None] * qvec).sum(-1) / det
    slack = np.stack([u + 1e-6, v + 1e-6, 1 + 1e-6 - u - v]
                     + ([t - t_lo] if t_lo is not None else []), -1)
    # a face decides the flag either way when its tightest condition is
    # within BORDERLINE of its boundary
    return (np.abs(slack.min(-1)) <= BORDERLINE).any(-1)


def _planes(tri):
    return rk.ray_planes(torch.from_numpy(np.asarray(tri, np.float32))[None])


def _any_hit(o, d, tri, **kw):
    blocked, tested = rk.ray_any_hit(
        torch.from_numpy(np.asarray(o, np.float32))[None],
        torch.from_numpy(np.asarray(d, np.float32))[None], _planes(tri), **kw)
    return blocked[0].numpy(), tested[0].numpy()


def _shell_rays(n, seed):
    """Rays from random points in a shell, random unit directions: a mix of
    hits and misses against the unit icosphere."""
    rng = np.random.RandomState(seed)
    o = (rng.randn(n, 3) * 1.5).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


# -- ray_any_hit ---------------------------------------------------------------

def test_any_hit_matches_pallas_and_counts_pairs():
    v, f = icosphere(2)
    tri = v[f].astype(np.float32)
    o, d = _shell_rays(300, 0)
    ref = np.asarray(ray_any_hit_pallas(o, d, tri, tile_q=32, tile_f=64,
                                        interpret=True))
    blocked, tested = _any_hit(o, d, tri)
    np.testing.assert_array_equal(blocked, ref)
    assert ref.any() and not ref.all()
    # the pairs a ray tests: its first hit's index plus one, else every face
    hits = rk.mt_hit(*(tuple(torch.from_numpy(x)[:, None, k] for k in range(3))
                       for x in (o, d)),
                     *(tuple(_planes(tri)[0, 3 * g + k][None] for k in range(3))
                       for g in range(3))).numpy()
    first = np.where(hits.any(1), hits.argmax(1) + 1, tri.shape[0])
    np.testing.assert_array_equal(tested, first)
    assert tested.dtype == np.int32


def test_any_hit_divided_form_differs_only_at_borderline():
    v, f = icosphere(2)
    tri = v[f].astype(np.float32)
    o, d = _shell_rays(400, 1)
    t, hit = jax_ray_triangle_hits(o[:, None], d[:, None], tri[None, :, 0],
                                   tri[None, :, 1], tri[None, :, 2])
    ref = np.asarray(hit & (t >= 0.0)).any(-1)
    blocked, _ = _any_hit(o, d, tri)
    differ = blocked != ref
    assert not (differ & ~borderline_rays(o, d, tri)).any()


@pytest.mark.parametrize("origin,direction,t_lo,t_hi,expected", [
    # a hit far along the ray (t >> 1) blocks: CGAL's Ray_3 is unbounded
    ((0.0, 0.0, -50.0), (0.0, 0.0, 1.0), 0.0, None, True),
    # and the opposite direction misses (t < 0 never blocks)
    ((0.0, 0.0, -50.0), (0.0, 0.0, -1.0), 0.0, None, False),
    # t in [0, 1]: a segment stopping short of the box does not hit
    ((0.0, 0.0, -50.0), (0.0, 0.0, 10.0), 0.0, 1.0, False),
    ((0.0, 0.0, -50.0), (0.0, 0.0, 100.0), 0.0, 1.0, True),
    # the whole line: t unbounded on both sides
    ((0.0, 0.0, -50.0), (0.0, 0.0, -1.0), None, None, True),
    # t_hi alone
    ((0.0, 0.0, -50.0), (0.0, 0.0, -1.0), None, 0.0, True),
    ((0.0, 0.0, -50.0), (0.0, 0.0, 1.0), None, 0.0, False),
])
def test_any_hit_t_bounds_match_pallas(origin, direction, t_lo, t_hi,
                                       expected):
    v, f = box(2.0)
    tri = v[f].astype(np.float32)
    o = np.array([origin], np.float32)
    d = np.array([direction], np.float32)
    ref = np.asarray(ray_any_hit_pallas(o, d, tri, t_lo=t_lo, t_hi=t_hi,
                                        tile_q=8, tile_f=16, interpret=True))
    blocked, _ = _any_hit(o, d, tri, t_lo=t_lo, t_hi=t_hi)
    assert bool(ref[0]) == expected
    np.testing.assert_array_equal(blocked, ref)


def test_any_hit_batch_is_per_mesh():
    """One launch over a batch: each mesh's rays against its own faces."""
    v, f = icosphere(1)
    rng = np.random.RandomState(2)
    tris = np.stack([(v * s)[f] for s in (0.5, 1.0, 2.0)]).astype(np.float32)
    o = (rng.randn(3, 64, 3) * 1.2).astype(np.float32)
    d = rng.randn(3, 64, 3).astype(np.float32)
    blocked, tested = rk.ray_any_hit(torch.from_numpy(o),
                                     torch.from_numpy(d),
                                     rk.ray_planes(torch.from_numpy(tris)))
    for b in range(3):
        one_b, one_t = _any_hit(o[b], d[b], tris[b])
        np.testing.assert_array_equal(blocked[b].numpy(), one_b)
        np.testing.assert_array_equal(tested[b].numpy(), one_t)
    assert blocked.any() and not blocked.all()


def test_line_hit_parallel_and_degenerate_faces_never_hit():
    """det == 0 (a ray in the triangle's plane, or a zero-area face): the
    sign is 0, the |det| guard fails, nothing hits."""
    a = (torch.zeros(1), torch.zeros(1), torch.zeros(1))
    e1 = (torch.ones(1), torch.zeros(1), torch.zeros(1))
    e2 = (torch.zeros(1), torch.ones(1), torch.zeros(1))
    o = (torch.full((1,), 0.2), torch.full((1,), 0.2), torch.zeros(1))
    d = (torch.ones(1), torch.zeros(1), torch.zeros(1))     # in-plane
    ad, sd, un, vn, tn = rk.mt_terms(o, d, a, e1, e2)
    assert float(ad) == 0.0 and float(sd) == 0.0
    assert float(un) == float(vn) == float(tn) == 0.0
    assert not bool(rk.mt_line_hit(o, d, a, e1, e2)[0])
    up = (torch.zeros(1), torch.zeros(1), torch.ones(1))
    assert bool(rk.mt_line_hit(o, up, a, e1, e2)[0])
    assert not bool(rk.mt_line_hit(o, up, a, e1, e1)[0])    # zero area


def test_ray_triangle_hits_matches_reference():
    rng = np.random.RandomState(3)
    o, d, a, b, c = (rng.randn(200, 3).astype(np.float32) for _ in range(5))
    t_ref, hit_ref = jax_ray_triangle_hits(o, d, a, b, c)
    t, hit = ray_triangle_hits(*(torch.from_numpy(x) for x in (o, d, a, b, c)))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(hit_ref))
    # one division per pair on both sides: rounding, relative to |t|
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), rtol=1e-4,
                               atol=1e-5)


# -- nearest along the normal --------------------------------------------------

def _alongnormal_queries(seed=4):
    """Points near the unit icosphere: radial normals (hits), random
    normals (hits and misses), and a planted miss far away."""
    rng = np.random.RandomState(seed)
    pts = (rng.randn(120, 3) * 1.2).astype(np.float32)
    nrm = np.vstack([pts[:60] / np.linalg.norm(pts[:60], axis=1,
                                               keepdims=True),
                     rng.randn(60, 3)]).astype(np.float32)
    pts = np.vstack([pts, [[50.0, 0.0, 0.0]]]).astype(np.float32)
    nrm = np.vstack([nrm, [[0.0, 1.0, 0.0]]]).astype(np.float32)
    return pts, nrm


def test_alongnormal_matches_pallas():
    v, f = icosphere(2)
    v32, f32 = v.astype(np.float32), f.astype(np.int32)
    pts, nrm = _alongnormal_queries()
    d_ref, f_ref, p_ref = (np.asarray(x) for x in nearest_alongnormal_pallas(
        v32, f32, pts, nrm, tile_q=32, tile_f=64, interpret=True))
    dist, face, point = nearest_alongnormal(v32, f32, pts, nrm, device="cpu")
    assert face.dtype == torch.int32 and tuple(point.shape) == pts.shape
    np.testing.assert_array_equal(face.numpy(), f_ref)
    np.testing.assert_array_equal(np.isfinite(dist.numpy()),
                                  np.isfinite(d_ref))
    hit = np.isfinite(d_ref)
    assert hit.any() and not hit[-1]                    # the planted miss
    np.testing.assert_allclose(dist.numpy()[hit], d_ref[hit], atol=VALUE_TOL)
    np.testing.assert_allclose(point.numpy(), p_ref, atol=VALUE_TOL)
    assert face[-1] == 0 and (point[-1] == 0).all()


def test_alongnormal_borderline_edge_hit_is_finite():
    """Winning hits exactly on a triangle edge: the epilogue re-tests the
    winner with the kernel's predicate, so an accepted face never comes
    back as a miss (tests/test_pallas_ray.py:103-132)."""
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
    f = np.array([[0, 1, 2], [1, 3, 2]], np.int32)
    pts = np.array([[0.5, 0.5, -1.0], [0.3, 0.0, 2.0], [0.0, 0.0, -1.0]],
                   np.float32)
    nrm = np.array([[0, 0, 1], [0, 0, -1], [0, 0, 1]], np.float32)
    d_ref, f_ref, _ = nearest_alongnormal_pallas(v, f, pts, nrm, tile_q=8,
                                                 tile_f=8, interpret=True)
    dist, face, point = nearest_alongnormal(v, f, pts, nrm, device="cpu")
    np.testing.assert_allclose(dist.numpy(), [1.0, 2.0, 1.0], atol=1e-6)
    np.testing.assert_allclose(dist.numpy(), np.asarray(d_ref), atol=1e-6)
    np.testing.assert_array_equal(face.numpy(), np.asarray(f_ref))
    np.testing.assert_allclose(point.numpy()[:, 2], 0.0, atol=1e-6)


def test_alongnormal_facade_matches_reference_and_maps_misses():
    v, f = icosphere(2)
    pts, nrm = _alongnormal_queries(seed=5)

    class _M:
        pass

    m = _M()
    m.v, m.f = v, f
    ref_d, ref_f, ref_p = JaxAabbTree(m).nearest_alongnormal(pts, nrm)
    out_d, out_f, out_p = mesh_tpu_torch.AabbTree(
        m, device="cpu").nearest_alongnormal(pts, nrm)
    assert out_d.dtype == np.float64 and out_f.dtype == np.uint32
    assert out_p.dtype == np.float64 and out_p.shape == ref_p.shape
    miss = out_d == 1e100
    assert miss[-1]
    # the reference's CPU facade takes its divided form: misses agree except
    # on borderline lines, and distances to 1e-5 where both hit
    np.testing.assert_array_equal(miss, ref_d == 1e100)
    np.testing.assert_allclose(out_d[~miss], ref_d[~miss], atol=VALUE_TOL)
    same = out_f == ref_f
    assert same.mean() > 0.9
    np.testing.assert_allclose(out_p[same], ref_p[same], atol=VALUE_TOL)
    # the XLA path itself, for the record
    d_x, _, _ = _nearest_alongnormal_xla(v.astype(np.float32),
                                         f.astype(np.int32), pts, nrm)
    assert not np.isfinite(np.asarray(d_x)[-1])


def test_alongnormal_batch_is_per_mesh():
    v, f = icosphere(1)
    rng = np.random.RandomState(6)
    vs = np.stack([v * s for s in (0.8, 1.0, 1.3)]).astype(np.float32)
    pts = (rng.randn(3, 40, 3) * 1.2).astype(np.float32)
    nrm = rng.randn(3, 40, 3).astype(np.float32)
    args = [torch.from_numpy(x) for x in (vs, f.astype(np.int64), pts, nrm)]
    dist, face, point = rk.nearest_alongnormal_kernel(*args)
    for b in range(3):
        one = rk.nearest_alongnormal_kernel(args[0][b], args[1], args[2][b],
                                            args[3][b])
        np.testing.assert_array_equal(face[b].numpy(), one[1].numpy())
        np.testing.assert_array_equal(dist[b].numpy(), one[0].numpy())
        np.testing.assert_array_equal(point[b].numpy(), one[2].numpy())


# -- wrappers ------------------------------------------------------------------

def test_ray_wrappers_reject_bad_operands_and_cpu_takes_plain():
    v, f = icosphere(1)
    planes = _planes(v[f])
    o = torch.zeros(1, 4, 3)
    with pytest.raises(ValueError):
        rk.ray_any_hit(o.double(), o.double(), planes)
    with pytest.raises(ValueError):
        rk.ray_any_hit(o, torch.zeros(1, 5, 3), planes)
    with pytest.raises(ValueError):
        rk.argmin_alongnormal(o, o, planes[:, :8])
    with pytest.raises(ValueError):
        rk.argmin_alongnormal(o.to("meta"), o.to("meta"), planes.to("meta"))
    before = dict(rk.LAUNCHES)
    d = torch.ones(1, 4, 3)
    assert torch.equal(rk.argmin_alongnormal(o, d, planes),
                       rk.argmin_alongnormal_plain(o, d, planes))
    assert torch.equal(rk.ray_any_hit(o, d, planes)[1],
                       rk.ray_any_hit_plain(o, d, planes)[1])
    assert rk.LAUNCHES == before


def test_plain_chunking_is_exact(monkeypatch):
    from mesh_tpu_torch.query import closest_kernel as ck

    v, f = icosphere(2)
    tri = v[f].astype(np.float32)
    o, d = _shell_rays(100, 7)
    whole = _any_hit(o, d, tri)
    along = rk.argmin_alongnormal_plain(torch.from_numpy(o)[None],
                                        torch.from_numpy(d)[None],
                                        _planes(tri))
    monkeypatch.setitem(ck._PLAIN_PAIRS, "cpu", 7 * tri.shape[0] + 3)
    chunked = _any_hit(o, d, tri)
    np.testing.assert_array_equal(chunked[0], whole[0])
    np.testing.assert_array_equal(chunked[1], whole[1])
    assert torch.equal(rk.argmin_alongnormal_plain(
        torch.from_numpy(o)[None], torch.from_numpy(d)[None], _planes(tri)),
        along)
