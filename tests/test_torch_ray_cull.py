"""The culled any-hit design (``ray_kernel.ray_any_hit_culled``, its plain
version and ``any_hit_operands``) on the CPU.

The culled design must give exactly the every-face ``ray_any_hit_plain``'s
blocked flags, on any ray order and face order, and mesh_tpu's
``ray_any_hit_pallas`` flags in interpret mode (as tests/test_torch_ray.py
runs it).  Its counts follow its own definition: a ray needs a chunk while
it is unblocked and the chunk test keeps it (``chunk_needs``), evaluates the
real faces of each chunk it needs in sorted order up to its first hit, and
a warp of 32 rays tests a chunk one of its rays needs.  The chunk test's
float32 margin and normal guard (csrc/ray_any_hit_culled.cu) must keep the
chunk of every face the float32 predicate accepts, including grazing rays
whose exact line passes far outside the face's box and faces with NaN or
inf corners.
"""

import ast
import os

import numpy as np
import pytest
import torch

from mesh_tpu.query.pallas_ray import ray_any_hit_pallas

from mesh_tpu_torch.batch import visibility_step
from mesh_tpu_torch.models import lbs, synthetic_body_model
from mesh_tpu_torch.models.body_model import _uv_sphere
from mesh_tpu_torch.query import ray_kernel as rk
from mesh_tpu_torch.query import visibility as vis

from .fixtures import box, icosphere
from .test_torch_ray import _shell_rays

torch.set_num_threads(2)

CHUNK = rk.ANY_HIT_CHUNK

#: the margin of a fixed-margin cull, beyond which the planted grazing rays
#: pass: a design without the normal guard would skip their chunk
FIXED_MARGIN = 1e-2

CAMS = np.array([[3.0, 0.0, 0.0], [-3.0, 0.0, 0.0], [0.0, 3.0, 0.0],
                 [0.0, -3.0, 0.0]], np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def _dense(o, d, tri, t_lo=0.0, t_hi=None):
    return rk.ray_any_hit_plain(o, d, rk.ray_planes(tri), t_lo, t_hi)


def _culled(o, d, tri, t_lo=0.0, t_hi=None):
    ops = rk.any_hit_operands(o, d, tri)
    return ops, rk.ray_any_hit_culled(ops, t_lo, t_hi, with_stats=True)


def expected_counts(ops, t_lo=0.0, t_hi=None):
    """The design's counts re-derived from ``chunk_needs`` and the
    every-face kernel's first hits on the sorted faces: (pairs [B, R],
    warp chunks [B, W], first hit [B, R])."""
    o, d = ops["origins"], ops["dirs"]
    n_f = ops["n_faces"]
    # the sorted faces' a, e1, e2 are ray_planes' values on them
    planes = ops["faces"][:, :n_f, :9].transpose(1, 2).contiguous()
    blocked, tested = rk.ray_any_hit_plain(o, d, planes, t_lo, t_hi)
    first = torch.where(blocked, tested - 1, torch.full_like(tested, -1))
    keep = rk.chunk_needs(ops, t_lo)                          # [B, R, C]
    n_c = keep.shape[-1]
    k = torch.arange(n_c)
    last = torch.where(blocked, first // CHUNK, torch.full_like(first, n_c))
    need = keep & (k <= last[..., None])
    real = torch.clamp(n_f - CHUNK * k, max=CHUNK)
    at_hit = torch.where(blocked, first - CHUNK * last + 1,
                         torch.zeros_like(first))
    before = torch.where(blocked[..., None], k < last[..., None], True)
    pairs = (need & before).to(torch.int32) @ real.to(torch.int32) + at_hit
    n_r = o.shape[1]
    pad = (-n_r) % 32
    w = torch.cat([need, need.new_zeros(need.shape[0], pad, n_c)], 1)
    warp = w.view(need.shape[0], -1, 32, n_c).any(dim=2).sum(
        dim=-1, dtype=torch.int32)
    return pairs.to(torch.int32), warp, first.to(torch.int32)


def assert_design(o, d, tri, t_lo=0.0, t_hi=None):
    """Flags equal to the every-face plain version's; counts equal to the
    design's definition.  Returns the operands and the culled outputs."""
    ops, out = _culled(o, d, tri, t_lo, t_hi)
    dense = _dense(o, d, tri, t_lo, t_hi)
    assert torch.equal(out[0], dense[0])
    pairs, warp, first = expected_counts(ops, t_lo, t_hi)
    assert torch.equal(out[1], pairs)
    assert torch.equal(out[2], warp)
    assert torch.equal(out[3], first)
    assert out[1].dtype == out[2].dtype == out[3].dtype == torch.int32
    return ops, out


def _posed_bodies(batch=2, seed=0, template=(24, 16)):
    """Posed synthetic bodies on a _uv_sphere(*template) template (the
    port's own lbs), as [B, V, 3] float32 and faces [F, 3]."""
    v, f = _uv_sphere(*template)
    model = synthetic_body_model(seed=seed, device="cpu",
                                 template=(v * np.array([0.3, 0.2, 0.9]), f))
    rng = np.random.RandomState(seed)
    betas = torch.as_tensor(rng.randn(batch, 10) * 0.3, dtype=torch.float32)
    pose = torch.as_tensor(rng.randn(batch, 24, 3) * 0.1,
                           dtype=torch.float32)
    return lbs(model, betas, pose, device="cpu")[0], model.faces.long()


def _body_rays(verts, sort=True):
    cams = _t(CAMS)
    o, d = vis.visibility_rays(verts, cams, 1e-3)
    d = d.reshape(o.shape).contiguous()
    if not sort:
        return o, d
    return vis.sort_rays(o, d, vis.vertex_order(verts))


# -- flags against the every-face version and mesh_tpu --------------------------

def test_icosphere_shell_rays_match_dense_and_pallas():
    v, f = icosphere(2)
    tri = v[f].astype(np.float32)
    o, d = _shell_rays(300, 0)
    _, out = assert_design(_t(o)[None], _t(d)[None], _t(tri)[None])
    ref = np.asarray(ray_any_hit_pallas(o, d, tri, tile_q=32, tile_f=64,
                                        interpret=True))
    np.testing.assert_array_equal(out[0][0].numpy(), ref)
    assert ref.any() and not ref.all()


def test_posed_body_from_four_cameras_culls():
    verts, f = _posed_bodies(batch=1, template=(48, 32))
    o, d = _body_rays(verts)
    ops, out = assert_design(o, d, verts[:, f])
    # a ray stops paying for faces it cannot hit, and warps skip chunks
    assert int(out[1].sum()) < int(_dense(o, d, verts[:, f])[1].sum()) // 2
    assert int(out[2].sum()) < out[2].numel() * ops["chunks"].shape[1] // 2
    assert out[0].any() and not out[0].all()


def test_face_count_not_a_multiple_of_the_chunk():
    v, f = icosphere(2)
    tri = v[f[:300]].astype(np.float32)
    assert tri.shape[0] % CHUNK
    o, d = _shell_rays(200, 3)
    ops, out = assert_design(_t(o)[None], _t(d)[None], _t(tri)[None])
    assert ops["faces"].shape[1] == -(-300 // CHUNK) * CHUNK
    # the padding repeats the last sorted face and is never evaluated
    assert torch.equal(ops["faces"][0, 300:], ops["faces"][0, 299:300]
                       .expand(ops["faces"].shape[1] - 300, -1))
    assert int(out[1].max()) <= 300


def test_batch_of_two_meshes_is_per_mesh():
    verts, f = _posed_bodies(batch=2, seed=1)
    v, fi = icosphere(1)
    tris = torch.stack([verts[0, f][:320], _t(v[fi]).repeat(16, 1, 1)[:320]])
    rng = np.random.RandomState(2)
    o = _t(rng.randn(2, 150, 3) * 0.8)
    d = _t(rng.randn(2, 150, 3))
    _, out = assert_design(o, d, tris)
    for b in range(2):
        _, one = _culled(o[b:b + 1], d[b:b + 1], tris[b:b + 1])
        for x, y in zip(out, one):
            assert torch.equal(x[b], y[0])


@pytest.mark.parametrize("origin,direction,t_lo,t_hi,expected", [
    ((0.0, 0.0, -50.0), (0.0, 0.0, 1.0), 0.0, None, True),
    ((0.0, 0.0, -50.0), (0.0, 0.0, -1.0), 0.0, None, False),
    ((0.0, 0.0, -50.0), (0.0, 0.0, 10.0), 0.0, 1.0, False),
    ((0.0, 0.0, -50.0), (0.0, 0.0, 100.0), 0.0, 1.0, True),
    ((0.0, 0.0, -50.0), (0.0, 0.0, -1.0), None, None, True),
    ((0.0, 0.0, -50.0), (0.0, 0.0, -1.0), None, 0.0, True),
    ((0.0, 0.0, -50.0), (0.0, 0.0, 1.0), None, 0.0, False),
])
def test_t_bounds_match_pallas(origin, direction, t_lo, t_hi, expected):
    v, f = box(2.0)
    tri = v[f].astype(np.float32)
    o = np.array([origin], np.float32)
    d = np.array([direction], np.float32)
    ref = np.asarray(ray_any_hit_pallas(o, d, tri, t_lo=t_lo, t_hi=t_hi,
                                        tile_q=8, tile_f=16, interpret=True))
    _, out = assert_design(_t(o)[None], _t(d)[None], _t(tri)[None], t_lo,
                           t_hi)
    assert bool(ref[0]) == expected
    np.testing.assert_array_equal(out[0][0].numpy(), ref)


@pytest.mark.parametrize("t_lo,t_hi", [(0.0, None), (None, None),
                                       (0.0, 1.0), (0.5, 3.0), (-2.0, None),
                                       (None, 0.0)])
def test_t_bounds_on_shell_rays(t_lo, t_hi):
    v, f = icosphere(2)
    tri = v[f].astype(np.float32)
    o, d = _shell_rays(250, 5)
    d = d * np.float32(1.7)
    _, out = assert_design(_t(o)[None], _t(d)[None], _t(tri)[None], t_lo,
                           t_hi)
    ref = np.asarray(ray_any_hit_pallas(o, d, tri, t_lo=t_lo, t_hi=t_hi,
                                        tile_q=32, tile_f=64,
                                        interpret=True))
    np.testing.assert_array_equal(out[0][0].numpy(), ref)


def test_chunk_tests_count_each_lanes_work():
    """``with_tests``: a lane tests one chunk for each chunk it reaches
    unblocked (up to its blocking face's chunk, else all), and falls back
    to the faces' normals on some of those tests."""
    verts, f = _posed_bodies(batch=1, seed=7)
    ops = rk.any_hit_operands(*_body_rays(verts), verts[:, f])
    out = rk.ray_any_hit_culled_plain(ops, with_tests=True)
    n_c = ops["chunks"].shape[1]
    first = out[3]
    assert torch.equal(out[4], torch.where(first >= 0, first // CHUNK + 1,
                                           n_c).to(torch.int32))
    assert (out[5] <= out[4]).all() and out[5].any()
    for x, y in zip(out[:4], rk.ray_any_hit_culled_plain(ops)):
        assert torch.equal(x, y)


def test_ray_order_changes_no_flag():
    verts, f = _posed_bodies(batch=1, seed=2)
    o, d = _body_rays(verts, sort=False)
    perm = torch.from_numpy(np.random.RandomState(0).permutation(o.shape[1]))
    _, shuffled = _culled(o[:, perm], d[:, perm], verts[:, f])
    _, plain = _culled(o, d, verts[:, f])
    assert torch.equal(shuffled[0], plain[0][:, perm])
    assert torch.equal(plain[0], _dense(o, d, verts[:, f])[0])


def test_empty_mesh_blocks_nothing():
    o = torch.zeros(1, 5, 3)
    d = torch.ones(1, 5, 3)
    ops, out = _culled(o, d, torch.zeros(1, 0, 3, 3))
    assert ops["chunks"].shape == (1, 0, rk.CHUNK_WORDS)
    assert not out[0].any() and not out[1].any() and not out[2].any()
    assert (out[3] == -1).all()


# -- the margin and the guard -------------------------------------------------------

def _grid(n=4):
    """A flat n x n grid of 2 n^2 triangles in the unit square, turned by a
    seeded rotation and moved off the origin, so that float32 rounds."""
    xs = np.linspace(0.0, 1.0, n + 1)
    v = np.array([(x, y, 0.0) for y in xs for x in xs])
    f = []
    for j in range(n):
        for i in range(n):
            a = j * (n + 1) + i
            f += [(a, a + 1, a + n + 2), (a, a + n + 2, a + n + 1)]
    rot, _ = np.linalg.qr(np.random.RandomState(0).randn(3, 3))
    shift = np.array([3.0, -2.0, 5.0])
    return (v @ rot.T + shift).astype(np.float32), np.array(f), rot, shift


def grazing_rays(n_rays=200000, seed=0):
    """A seeded search for grazing rays: in the grid's frame each starts 5
    to 60 units before the grid, nearly parallel to its plane, crossing
    the plane 1 to 40 units before or after it.  Returns the grid's
    triangles and (origins, dirs, face) of the rays that float32 ``mt_hit``
    accepts on some face although their exact half-line passes more than
    FIXED_MARGIN outside that face's box."""
    v, f, rot, shift = _grid()
    tri = v[f]
    rng = np.random.RandomState(seed)
    far = rng.uniform(5.0, 60.0, n_rays)
    oz = rng.choice([-1.0, 1.0], n_rays) * 10.0 ** rng.uniform(-4, -1, n_rays)
    cross = far + 0.5 + rng.choice([-1.0, 1.0], n_rays) * rng.uniform(
        1.0, 40.0, n_rays)
    local_o = np.stack([-far, rng.uniform(-1.0, 2.0, n_rays), oz], 1)
    local_d = np.stack([np.ones(n_rays), rng.uniform(-0.05, 0.05, n_rays),
                        -oz / cross], 1)
    local_d /= np.linalg.norm(local_d, axis=1, keepdims=True)
    o = (local_o @ rot.T + shift).astype(np.float32)
    d = (local_d @ rot.T).astype(np.float32)
    planes = rk.ray_planes(_t(tri)[None])[0]
    hit = rk.mt_hit(*(tuple(_t(x[:, k:k + 1]) for k in range(3))
                      for x in (o, d)),
                    *(tuple(planes[3 * g + k][None] for k in range(3))
                      for g in range(3)), 0.0, None).numpy()
    ri, fi = np.nonzero(hit)
    lo = tri.min(axis=1).astype(np.float64)[fi] - FIXED_MARGIN
    hi = tri.max(axis=1).astype(np.float64)[fi] + FIXED_MARGIN
    o64, d64 = o[ri].astype(np.float64), d[ri].astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        t0, t1 = (lo - o64) / d64, (hi - o64) / d64
    t_near = np.nanmax(np.minimum(t0, t1), axis=1)
    t_far = np.nanmin(np.maximum(t0, t1), axis=1)
    beyond = ~((t_near <= t_far) & (t_far >= 0.0))
    return tri, (o[ri[beyond]], d[ri[beyond]], fi[beyond])


def test_grazing_rays_beyond_a_fixed_margin_keep_their_chunk():
    tri, (o, d, face) = grazing_rays()
    # planted among ordinary rays through the grid
    rng = np.random.RandomState(1)
    n_plain = 64
    po = (tri.reshape(-1, 3).mean(0) + rng.randn(n_plain, 3)).astype(
        np.float32)
    pd = rng.randn(n_plain, 3).astype(np.float32)
    oo, dd = np.concatenate([o, po]), np.concatenate([d, pd])
    ops, out = assert_design(_t(oo)[None], _t(dd)[None], _t(tri)[None])
    if not len(face):
        return
    # every planted ray is blocked by float32, and keeps the chunk of the
    # face it was found on although its exact half-line misses the face's
    # box grown by FIXED_MARGIN
    assert out[0][0, :len(face)].all()
    pos = torch.argsort(ops["face_ids"][0].long())[torch.from_numpy(face)]
    keep = rk.chunk_needs(ops, 0.0)[0, :len(face)]
    assert keep[torch.arange(len(face)), pos // CHUNK].all()


def test_grazing_search_finds_rays():
    """The seeded search plants rays the guard must catch (a check on the
    search itself, so the test above is not empty)."""
    assert len(grazing_rays()[1][2]) > 0


def test_non_finite_corners_are_never_culled():
    v, f = icosphere(2)
    tri = v[f].astype(np.float32)
    tri[5, 1, 0] = np.nan
    tri[200, 2, 2] = np.inf
    o, d = _shell_rays(300, 4)
    ops, out = assert_design(_t(o)[None], _t(d)[None], _t(tri)[None])
    pos = torch.argsort(ops["face_ids"][0].long())
    for face in (5, 200):
        k = int(pos[face]) // CHUNK
        assert float(ops["chunks"][0, k, 3]) == float("inf")
        assert rk.chunk_needs(ops, 0.0)[0, :, k].all()
    finite = torch.isfinite(ops["chunks"][0, :, 3])
    assert int(finite.sum()) == ops["chunks"].shape[1] - 2


def test_wild_rays_keep_every_chunk():
    v, f = icosphere(1)
    tri = _t(v[f])[None]
    o = _t([[0.0, 0.0, -3.0], [np.nan, 0.0, 0.0], [0.0, 0.0, -3.0],
            [0.0, 0.0, -3.0]])[None]
    d = _t([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [np.inf, 0.0, 1.0],
            [0.0, 0.0, 0.0]])[None]
    ops, _ = assert_design(o, d, tri)
    keep = rk.chunk_needs(ops, 0.0)[0]
    assert keep[1].all() and keep[2].all()


def test_chunk_records_bound_their_faces():
    verts, f = _posed_bodies(batch=1)
    ops = rk.any_hit_operands(*_body_rays(verts), verts[:, f])
    ch = ops["chunks"][0].double()
    faces = ops["faces"][0].double()
    a, e1, e2 = faces[:, 0:3], faces[:, 3:6], faces[:, 6:9]
    corners = torch.stack([a, a + e1, a + e2], 1).view(-1, CHUNK * 3, 3)
    n = torch.linalg.cross(e1, e2)
    assert (corners >= ch[:, None, 0:3] - 1e-6).all()
    assert (corners <= ch[:, None, 4:7] + 1e-6).all()
    area2 = n.norm(dim=-1)
    edge = torch.maximum(e1.norm(dim=-1), e2.norm(dim=-1))
    assert ((edge * edge / area2).view(-1, CHUNK).amax(-1) <= ch[:, 3]).all()
    assert (edge.view(-1, CHUNK).amax(-1) <= ch[:, 7]).all()
    # every face normal lies within a cone narrower than 90 degrees: cos
    # >= ct > 0; a wider cone is stored as ct = 0, st = 1
    unit = (n / area2[:, None]).view(-1, CHUNK, 3)
    cos = (unit * ch[:, None, 8:11]).sum(-1) / ch[:, None, 8:11].norm(dim=-1)
    narrow = ch[:, 11] > 0
    assert narrow.any() and not narrow.all()
    assert (cos[narrow] >= ch[narrow, 11, None]).all()
    assert (ch[~narrow, 11] == 0).all() and (ch[~narrow, 15] == 1).all()
    assert ((ch[:, 11] ** 2 + ch[:, 15] ** 2) >= 1 - 1e-6).all()
    # the stored normals are the faces' unit normals over their rho
    rho_f = edge * edge / area2
    assert torch.allclose(faces[:, 9:12] * rho_f[:, None], n / area2[:, None],
                          atol=1e-6)


# -- visibility through the culled route -----------------------------------------

def _dense_visibility(verts, occ, cams, normals, min_dist=1e-3):
    o, d = vis.visibility_rays(verts, cams, min_dist)
    blocked, _ = rk.ray_any_hit(o, d.reshape(o.shape).contiguous(),
                                rk.ray_planes(occ), t_lo=0.0)
    return ~blocked.reshape(d.shape[:-1]), vis._dot3(normals[:, None], d)


def test_visibility_local_equals_the_dense_route():
    verts, f = _posed_bodies(batch=2, seed=3)
    normals = torch.nn.functional.normalize(torch.randn(verts.shape), dim=-1)
    got = vis.visibility_local(verts, verts[:, f], _t(CAMS), normals)
    want = _dense_visibility(verts, verts[:, f], _t(CAMS), normals)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].any() and not got[0].all()
    step = visibility_step(verts, f, _t(CAMS))
    assert torch.equal(step[0], got[0])


def test_visibility_compute_equals_the_dense_route():
    verts, f = _posed_bodies(batch=1, seed=4)
    v = verts[0].numpy()
    n = np.random.RandomState(0).randn(*v.shape).astype(np.float32)
    extra_v = (v[:40] * 1.3).astype(np.float32)
    extra_f = np.array([[0, 1, 2], [3, 4, 5], [6, 7, 8]])
    vis_c, ndc = vis.visibility_compute(v, f.numpy(), CAMS[:2], n=n,
                                        extra_v=extra_v, extra_f=extra_f,
                                        device="cpu")
    occ = torch.cat([verts[0, f], _t(extra_v)[extra_f]])[None]
    want = _dense_visibility(verts, occ, _t(CAMS[:2]), _t(n)[None])
    np.testing.assert_array_equal(vis_c, want[0][0].numpy().astype(np.uint32))
    np.testing.assert_array_equal(ndc, want[1][0].numpy().astype(np.float64))


def test_visibility_of_a_mesh_without_vertices_is_empty():
    vis_c, ndc = vis.visibility_compute(np.zeros((0, 3)), np.zeros((0, 3), int),
                                        CAMS[:2], device="cpu")
    assert vis_c.shape == ndc.shape == (2, 0)


def test_sort_and_unsort_are_inverse():
    verts, _ = _posed_bodies(batch=2, seed=5)
    order = vis.vertex_order(verts)
    o, d = vis.visibility_rays(verts, _t(CAMS), 1e-3)
    so, sd = vis.sort_rays(o, d, order)
    assert torch.equal(vis.unsort_flags(so[..., 0], order, 4).reshape(
        o.shape[:2]), o[..., 0])
    assert torch.equal(vis.unsort_flags(sd[..., 2], order, 4), d[..., 2])
    assert so.is_contiguous() and sd.shape == o.shape


# -- the wrapper -------------------------------------------------------------------

def test_wrapper_takes_the_plain_version_on_cpu_and_checks_operands():
    v, f = icosphere(1)
    tri = _t(v[f])[None]
    o, d = (_t(x)[None] for x in _shell_rays(40, 6))
    ops = rk.any_hit_operands(o, d, tri)
    before = dict(rk.LAUNCHES)
    got = rk.ray_any_hit_culled(ops)
    want = rk.ray_any_hit_culled_plain(ops, 0.0, None)
    assert len(got) == 2
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert rk.LAUNCHES == before
    with pytest.raises(ValueError):
        rk.ray_any_hit_culled(dict(ops, origins=o.double()))
    with pytest.raises(ValueError):
        rk.ray_any_hit_culled(dict(ops, dirs=d[:, :5].contiguous()))
    with pytest.raises(ValueError):
        rk.ray_any_hit_culled(dict(ops, n_faces=ops["n_faces"] + CHUNK))
    with pytest.raises(ValueError):
        rk.ray_any_hit_culled({k: x.to("meta") if torch.is_tensor(x) else x
                               for k, x in ops.items()})
    with pytest.raises(ValueError):
        rk.any_hit_operands(o, d, tri[0])


def test_plain_chunking_is_exact(monkeypatch):
    from mesh_tpu_torch.query import closest_kernel as ck

    verts, f = _posed_bodies(batch=1, seed=6)
    o, d = _body_rays(verts)
    ops = rk.any_hit_operands(o, d, verts[:, f])
    whole = rk.ray_any_hit_culled_plain(ops)
    monkeypatch.setitem(ck._PLAIN_PAIRS, "cpu", 7 * CHUNK + 3)
    for x, y in zip(rk.ray_any_hit_culled_plain(ops), whole):
        assert torch.equal(x, y)


def test_ab_ray_imports_neither_jax_nor_mesh_tpu():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "ab_ray.py")
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        assert not {m.split(".")[0] for m in mods} & {"jax", "jaxlib",
                                                      "mesh_tpu"}
    # the side script runs from source text: it imports the port only
    side = open(path).read().split('SIDE = r"""')[1].split('"""')[0]
    assert "import jax" not in side and "mesh_tpu." not in side.replace(
        "mesh_tpu_torch.", "")
