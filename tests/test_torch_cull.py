"""The culls of mesh_tpu_torch's redesigned kernels, on the CPU: the plain
versions of the new designs of ``self_intersect`` (a tile cull by the query
plane, the Moller tile's own rejection) and ``culled_faces`` (a per-warp
chunk cull by each query's own running best) against the every-pair /
every-face plain versions and mesh_tpu.

Inputs come from numpy RandomState seeds or fixed geometry.  mesh_tpu's
side: per-face self-intersection counts from its Pallas kernel's own pair
tiles (``_moller_hit``, ``_tri_tri_hit_tile`` over the same prescale and
rows, run as plain jnp), its Pallas self-intersection count in interpret
mode, and ``closest_point_pallas_culled(interpret=True)``.  Counts are held
to equality, culled faces to bit-identity with the every-face design and to
the tie contract against mesh_tpu.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mesh_tpu.query.pallas_ray import (
    _EPS as JAX_EPS,
    _moller_hit,
    _tri_planes,
    _tri_tri_hit_tile,
    moller_prescale,
    self_intersection_count_pallas,
)

from mesh_tpu_torch.query import closest_kernel as ck
from mesh_tpu_torch.query import culled_kernel as qk
from mesh_tpu_torch.query import tri_tri_kernel as tk

from .fixtures import icosphere
from .test_reference_fixtures import (
    CYL_F,
    CYL_V,
    DOUBLEBOX_F,
    DOUBLEBOX_V,
    SELF_INT_CYL_F,
    SELF_INT_CYL_V,
)
from .test_torch_closest import assert_tie_contract
from .test_torch_culled import (
    TILES,
    VARIANTS,
    _culled_case,
    _np,
    _t,
    sphere,
    surface_queries,
)
from .test_torch_self_intersect import _posed_small_body, _sphere_and_slab

torch.set_num_threads(2)


# -- self_intersect: the Moller tile cull ------------------------------------

def flat_patch(n=12, noise=1e-6, seed=0, layers=2):
    """A flat patch of separate small triangles (no shared vertices) on an
    n x n grid in z = 0, in ``layers`` copies shifted in x and y, every
    corner's z with N(0, noise): near-coplanar faces, far apart and
    interpenetrating."""
    rng = np.random.RandomState(seed)
    g = np.stack(np.meshgrid(np.arange(n), np.arange(n), indexing="ij"),
                 -1).reshape(-1, 2).astype(np.float64)
    base = np.concatenate([g, np.zeros((len(g), 1))], 1)
    corners = np.array([[0.0, 0.0, 0.0], [0.9, 0.1, 0.0], [0.1, 0.9, 0.0]])
    tri = np.concatenate([base[:, None] + corners[None]
                          + np.array([0.05 * k, 0.03 * k, 0.0])
                          for k in range(layers)])
    tri[..., 2] += rng.randn(*tri[..., 2].shape) * noise
    v = tri.reshape(-1, 3).astype(np.float32)
    return v, np.arange(len(v)).reshape(-1, 3).astype(np.int32)


def _mesh(name):
    if name == "doublebox":
        return np.asarray(DOUBLEBOX_V, np.float32), np.asarray(DOUBLEBOX_F,
                                                               np.int32)
    if name == "bent_cylinder":
        return (np.asarray(SELF_INT_CYL_V, np.float32),
                np.asarray(SELF_INT_CYL_F, np.int32))
    if name == "translated_cylinder":
        return np.asarray(CYL_V, np.float32), np.asarray(CYL_F, np.int32)
    if name == "sphere_and_slab":
        return _sphere_and_slab()
    if name == "posed_body":
        jv, _, f = _posed_small_body()
        return jv.astype(np.float32), f
    return flat_patch()


MESHES = ["doublebox", "bent_cylinder", "translated_cylinder",
          "sphere_and_slab", "posed_body", "flat_patch"]


def _operands(v, f, algorithm):
    tri = torch.from_numpy(v)[torch.from_numpy(f.astype(np.int64))]
    qp, fp = tk.self_planes(tri, algorithm)
    return qp, fp, torch.from_numpy(f.astype(np.int32))


def jax_face_counts(v, f, algorithm):
    """Per-face counts from mesh_tpu's own pair tiles on its own operands
    (moller_prescale + _tri_planes, or the corners and (a, e1, e2) rows),
    every pair with the vertex-sharing and self pairs left out, as its
    self-intersection kernel accumulates them."""
    tri = jnp.asarray(v, jnp.float32)[jnp.asarray(f, jnp.int32)]
    if algorithm == "moller":
        (tri_n,) = moller_prescale(tri)
        a, b, c, n, d = _tri_planes(tri_n)
        col = [tuple(x[:, k][:, None] for k in range(3)) for x in (a, b, c, n)]
        row = [tuple(x[:, k][None] for k in range(3)) for x in (a, b, c, n)]
        hit = _moller_hit(*col, d[:, None], *row, d[None], JAX_EPS)
    else:
        a, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
        col = [tuple(tri[:, i, k][:, None] for k in range(3))
               for i in range(3)]
        row = [tuple(x[:, k][None] for k in range(3)) for x in (a, e1, e2)]
        hit = _tri_tri_hit_tile(*col, *row, JAX_EPS)
    shares = (f[:, None, :, None] == f[None, :, None, :]).any(axis=(-1, -2))
    np.fill_diagonal(shares, True)
    return (np.asarray(hit) & ~shares).sum(axis=1).astype(np.int32)


@pytest.mark.parametrize("algorithm", tk.ALGORITHMS)
@pytest.mark.parametrize("name", MESHES)
def test_self_culled_plain_matches_every_pair_and_reference(name, algorithm):
    """The new design's plain counts equal the every-pair plain's per face,
    its involved faces mesh_tpu's per face, and its involved-face total
    mesh_tpu's Pallas kernel's; its work per face is the pairs of the tiles
    it keeps, those of them not left out, and (Moller) the pairs reaching
    the interval part, which are those of every pair.  (mesh_tpu's per-face
    counts come from
    XLA, which may contract a product and a sum into one rounding, so a
    borderline pair of an involved face may count there and not here.)"""
    v, f = _mesh(name)
    qp, fp, ids = _operands(v, f, algorithm)
    counts, tiles, work = tk.self_intersect_culled_plain(qp, fp, ids,
                                                         algorithm)
    every = tk.self_intersect_counts_plain(qp, fp, ids, algorithm)
    assert counts.dtype == torch.int32 and torch.equal(counts, every)
    np.testing.assert_array_equal(counts.numpy() > 0,
                                  jax_face_counts(v, f, algorithm) > 0)
    assert int((counts > 0).sum()) == int(self_intersection_count_pallas(
        v, f, tile_q=32, tile_f=64, interpret=True, algorithm=algorithm))
    n_tiles = -(-len(f) // tk.SELF_TILE)
    assert tiles.shape == (-(-len(f) // tk.WARP),)
    assert bool(((tiles >= 1) & (tiles <= n_tiles)).all())
    excluded = tk._excluded(ids, 0, len(f), qp.device)
    assert work.shape == (len(f), 3) and work.dtype == torch.int32
    if algorithm == "moller":
        need = tk.moller_tile_needs(qp, tk.moller_tile_boxes(fp), 0, len(f))
        kept = need.repeat_interleave(tk.SELF_TILE, dim=1)[:, :len(f)]
        q = tk._cols(qp, 0, len(f))
        m = tk._rows(fp)
        reject = tk.moller_sides(q[0:3], q[3:6], q[6:9], q[9:12], q[12],
                                 m[0:3], m[3:6], m[6:9], m[9:12], m[12])[2]
        assert torch.equal(work[:, 2], (~(excluded | reject)).sum(
            dim=1, dtype=torch.int32))
    else:
        kept = torch.ones_like(excluded)
        assert not bool(work[:, 2].any())
    assert torch.equal(work[:, 0], kept.sum(dim=1, dtype=torch.int32))
    assert torch.equal(work[:, 1], (kept & ~excluded).sum(
        dim=1, dtype=torch.int32))


def _sorted_sphere():
    """The closed icosphere (1,280 faces, 10 tiles) in Morton order of its
    centroids: (vertices, faces, order, Moller operand, ids)."""
    v, f = icosphere(3)
    v, f = v.astype(np.float32), f.astype(np.int32)
    tri = torch.from_numpy(v)[torch.from_numpy(f.astype(np.int64))]
    order = tk.morton_face_order(tri)
    (planes,) = tk.moller_planes(tri[order])
    return v, f, order, planes, torch.from_numpy(f)[order].contiguous()


def test_self_cull_skips_tiles_on_a_sphere():
    """On a closed sphere in Morton order a face's plane misses the boxes of
    the tiles across the sphere: the warps test fewer tiles than there
    are, and the counts (0) stay the every-pair plain's, in the sorted
    order and through the facade's kernel entry."""
    v, f, order, planes, ids = _sorted_sphere()
    counts, tiles, work = tk.self_intersect_culled_plain(planes, planes, ids,
                                                         "moller")
    n_tiles = -(-len(f) // tk.SELF_TILE)
    assert int(tiles.sum()) < tiles.numel() * n_tiles
    assert not bool(counts.any()) and not bool(work[:, 2].any())
    assert int(work[:, 0].sum()) < len(f) * len(f)
    assert torch.equal(counts, tk.self_intersect_counts_plain(
        planes, planes, ids, "moller"))
    full = tk.self_intersection_counts_kernel(torch.from_numpy(v),
                                              torch.from_numpy(f), "moller")
    assert torch.equal(full[order], counts)


@pytest.mark.parametrize("algorithm", tk.ALGORITHMS)
def test_self_morton_permuted_copy(algorithm):
    """A randomly permuted copy of the mesh gives the permuted counts, from
    the raw API on the permuted operands and from the facade's kernel
    entry (which sorts by Morton code and scatters back)."""
    jv, _, f = _posed_small_body()
    v = jv.astype(np.float32)
    base = tk.self_intersection_counts_kernel(
        torch.from_numpy(v), torch.from_numpy(f), algorithm)
    perm = np.random.RandomState(3).permutation(len(f))
    qp, fp, ids = _operands(v, f[perm], algorithm)
    assert torch.equal(tk.self_intersect_counts(qp, fp, ids, algorithm),
                       base[torch.from_numpy(perm)])
    assert torch.equal(tk.self_intersection_counts_kernel(
        torch.from_numpy(v), torch.from_numpy(f[perm]), algorithm),
        base[torch.from_numpy(perm)])
    every = tk.self_intersect_counts_plain(*_operands(v, f, algorithm),
                                           algorithm)
    assert torch.equal(base, every)


def test_flat_patch_cull_keeps_every_counted_pair():
    """Near-coplanar, far-apart and interpenetrating faces with corner noise
    above 1e-9: every pair the every-pair plain counts lies in a tile its
    query keeps, and the counts agree."""
    v, f = flat_patch()
    qp, fp, ids = _operands(v, f, "moller")
    hit = tk.moller_hit_tile(tk._cols(qp, 0, len(f)), tk._rows(fp))
    counted = hit & ~tk._excluded(ids, 0, len(f), qp.device)
    assert int(counted.sum()) > 0
    need = tk.moller_tile_needs(qp, tk.moller_tile_boxes(fp), 0, len(f))
    kept = need.repeat_interleave(tk.SELF_TILE, dim=1)[:, :len(f)]
    assert not bool((counted & ~kept).any())
    assert torch.equal(tk.self_intersect_culled_plain(qp, fp, ids,
                                                      "moller")[0],
                       counted.sum(dim=1, dtype=torch.int32))


def test_nan_corner_tile_is_never_culled():
    """A face with a NaN corner makes its tile's box NaN: no query skips
    that tile, while the cull skips tiles elsewhere, and the counts stay
    the every-pair plain's."""
    _, f, _, planes, ids = _sorted_sphere()
    planes = planes.clone()
    planes[1, tk.SELF_TILE + 5] = float("nan")     # corner a's y
    boxes = tk.moller_tile_boxes(planes)
    assert bool(torch.isnan(boxes[1, :7]).any())
    need = tk.moller_tile_needs(planes, boxes, 0, len(f))
    assert bool(need[:, 1].all())
    assert not bool(need.all())
    counts = tk.self_intersect_culled_plain(planes, planes, ids, "moller")[0]
    assert torch.equal(counts, tk.self_intersect_counts_plain(
        planes, planes, ids, "moller"))


@pytest.mark.parametrize("algorithm", tk.ALGORITHMS)
def test_self_culled_query_range(algorithm):
    """A query range [q0, q1) gives that slice of the counts and of the
    work per face, also where the warps start off the tile grid."""
    jv, _, f = _posed_small_body()
    qp, fp, ids = _operands(jv.astype(np.float32), f, algorithm)
    full = tk.self_intersect_culled_plain(qp, fp, ids, algorithm)
    part = tk.self_intersect_culled_plain(qp, fp, ids, algorithm, 37, 301)
    assert torch.equal(part[0], full[0][37:301])
    assert torch.equal(part[2], full[2][37:301])
    assert part[1].shape == (-(-(301 - 37) // tk.WARP),)
    assert torch.equal(tk.self_intersect_counts(qp, fp, ids, algorithm, 37,
                                                301), full[0][37:301])


def _unit_tri(z, center=(0.0, 0.0)):
    """A small triangle in the plane at height z: [3, 3] float64."""
    cx, cy = center
    return np.array([[cx - 0.1, cy - 0.1, z], [cx + 0.1, cy - 0.1, z],
                     [cx, cy + 0.1, z]])


def _planes(tris):
    """The Moller operand [13, F] of unit-box triangles, unscaled."""
    a, b, c, n, d = tk.tri_planes(torch.as_tensor(np.asarray(tris),
                                                  dtype=torch.float32))
    return torch.cat([a, b, c, n, d[..., None]], -1).t().contiguous()


@pytest.mark.parametrize("factor,skipped", [(0.5, False), (2.0, True)])
def test_margin_boundary(factor, skipped):
    """A query in z = 0 and a tile of faces all at height factor x M (M the
    query's margin against that tile's box): the tile is kept at M / 2 and
    skipped at 2 M, where the every-pair plain rejects each of its pairs;
    below the query too."""
    for sign in (1.0, -1.0):
        q = _unit_tri(0.0, (0.5, 0.5))
        far = [_unit_tri(0.0, (-0.5 + 0.001 * k, -0.5)) for k in range(127)]
        p_max = 0.6                     # the largest |coordinate| of tile 1
        m = tk.MARGIN_FLOOR + tk.MARGIN_REL * (1.0 * p_max + 0.0)
        h = np.float32(sign * factor * m)
        near = [_unit_tri(h, (0.2 + 0.001 * k, 0.2)) for k in range(128)]
        near[0][0, :2] = [-0.6, -0.6]
        planes = _planes([q] + far + near)
        boxes = tk.moller_tile_boxes(planes)
        assert float(boxes[1, 6]) == np.float32(0.6)
        need = tk.moller_tile_needs(planes, boxes, 0, 1)
        assert bool(need[0, 0]) and bool(need[0, 1]) != skipped
        ids = torch.arange(3 * planes.shape[1], dtype=torch.int32).view(-1, 3)
        c, tiles, _ = tk.self_intersect_culled_plain(planes, planes, ids,
                                                     "moller", 0, 1)
        assert torch.equal(c, tk.self_intersect_counts_plain(
            planes, planes, ids, "moller", 0, 1))
        assert int(tiles[0]) == (1 if skipped else 2)
        if skipped:
            q_cols = tk._cols(planes, 0, 1)
            m_rows = tk._rows(planes[:, 128:])
            assert bool(tk.moller_sides(
                q_cols[0:3], q_cols[3:6], q_cols[6:9], q_cols[9:12],
                q_cols[12], m_rows[0:3], m_rows[3:6], m_rows[6:9],
                m_rows[9:12], m_rows[12])[2].all())


def test_zero_normal_query_never_skips():
    """A degenerate query (zero normal, offset 0) keeps every tile."""
    q = np.array([[0.1, 0.1, 0.1], [0.2, 0.2, 0.2], [0.3, 0.3, 0.3]])
    far = [_unit_tri(0.9, (0.1 * k - 0.9, 0.0)) for k in range(200)]
    planes = _planes([q] + far)
    assert float(planes[9:13, 0].abs().sum()) == 0.0
    assert bool(tk.moller_tile_needs(planes, tk.moller_tile_boxes(planes), 0,
                                     1).all())


# -- culled_faces: the per-warp chunk cull -----------------------------------

def _every_face(ops, variant, tail):
    """The first argmin over every sorted face of each mesh: [B, Qp]."""
    pts, planes = ops["pts_s"], ops["planes"]
    cost = qk._TILES[variant](
        pts[..., 0:1], pts[..., 1:2], pts[..., 2:3],
        *[planes[:, k, None, :] for k in range(ck.N_FACE_ROWS)],
        degenerate_tail=tail)
    return torch.argmin(cost, dim=-1).to(torch.int32)


def _check_chunk_design(ops, variant, tail):
    """The new design's plain against today's every-face-of-each-tile plain
    and the every-face argmin: identical faces and tile visits, chunk
    counts within the tiles' chunks, faces folded per query within the
    chunks its warp tested.  Returns (faces, visits, chunks)."""
    best, visits, chunks, pairs = qk.argmin_culled_plain(ops, variant, tail)
    best_t, visits_t = qk.argmin_culled_tile_plain(ops, variant, tail)
    assert torch.equal(best, best_t) and torch.equal(visits, visits_t)
    assert torch.equal(best, _every_face(ops, variant, tail))
    per_tile = ops["tile_f"] // qk.chunk_faces(ops["tile_f"])
    assert chunks.shape == visits.shape + (-(-ops["tile_q"] // 32),)
    assert bool((chunks <= visits[..., None] * per_tile).all())
    chunk = qk.chunk_faces(ops["tile_f"])
    lanes = pairs.view(chunks.shape + (32,))
    assert bool((lanes <= chunks[..., None] * chunk).all())
    assert int(pairs.sum()) <= ops["n_faces"] * pairs.numel()
    return best, visits, chunks


@pytest.mark.parametrize("variant,tail", VARIANTS)
def test_chunk_cull_matches_tile_plain_and_pallas(variant, tail):
    """All four variants on test_torch_culled's batch of two meshes: the
    new plain equals today's plain and the every-face argmin bit for bit,
    and mesh_tpu's culled kernel under the tie contract."""
    vs, f, qs, ref = _culled_case(variant, tail)
    vt, ft, qt = _t(vs, f, qs)
    ops = qk.culled_operands(vt, ft, qt, variant, **TILES)
    best, _, chunks = _check_chunk_design(ops, variant, tail)
    out = _np(qk.culled_epilogue(ops, best))
    for b in range(2):
        assert assert_tie_contract({k: x[b] for k, x in ref.items()},
                                   {k: x[b] for k, x in out.items()},
                                   vs[b], f, qs[b]) > 0.5
    assert int(chunks.sum()) > 0


def test_chunk_cull_skips_chunks_near_the_surface():
    """Surface-proximal queries on a finer sphere: the warps test fewer
    chunks than their tiles hold, the answer unchanged."""
    v, f = sphere(4, seed=4)
    q = surface_queries(v, f, 1024, seed=4)
    vt, ft, qt = _t(v, f, q)
    ops = qk.culled_operands(vt[None], ft, qt[None], "fast", **TILES)
    _, visits, chunks = _check_chunk_design(ops, "fast", False)
    per_tile = TILES["tile_f"] // qk.chunk_faces(TILES["tile_f"])
    assert int(chunks.sum()) < int(visits.sum()) * per_tile * chunks.shape[-1]


def test_chunk_cull_duplicate_faces_keep_lowest_position():
    """Every face twice: face i and its copy F + i cost the same and share a
    Morton code, so the stable sort puts i first, and both designs keep
    the lowest sorted position among equal costs: an original face."""
    v, f = sphere(3, seed=11)
    f2 = np.concatenate([f, f]).astype(np.int32)
    q = surface_queries(v, f, 256, seed=12)
    vt, ft, qt = _t(v, f2, q)
    for variant, tail in (("fast", False), ("safe", True)):
        ops = qk.culled_operands(vt[None], ft, qt[None], variant, **TILES)
        best, _, _ = _check_chunk_design(ops, variant, tail)
        ids = torch.gather(ops["face_ids"], 1, best.long())[0, :len(q)]
        assert int(ids.max()) < len(f)


def test_chunk_cull_far_queries():
    """Queries far off the surface (radius 5 to 50): the same faces as the
    every-face argmin, in both tiles."""
    v, f = sphere(3, seed=13)
    rng = np.random.RandomState(14)
    d = rng.randn(300, 3)
    q = (d / np.linalg.norm(d, axis=1, keepdims=True)
         * rng.uniform(5.0, 50.0, (300, 1))).astype(np.float32)
    for variant in ("fast", "safe"):
        ops = qk.culled_operands(_t(v)[0][None], _t(f)[0], _t(q)[0][None],
                                 variant, **TILES)
        _check_chunk_design(ops, variant, variant == "safe")


def test_chunk_cull_pairs_count_only_real_faces():
    """One face tile of 128 faces holding 100 real faces and 28 copies of
    the last (edge padding): a query that folds the chunk in counts its
    100 real faces, never the copies."""
    v, f = sphere(2, seed=15)
    f = f[:100]
    q = surface_queries(v, f, 64, seed=16)
    ops = qk.culled_operands(_t(v)[0][None], _t(f)[0], _t(q)[0][None],
                             "fast", tile_q=32, tile_f=128)
    assert ops["planes"].shape[-1] == 128 and ops["n_faces"] == 100
    _, visits, chunks, pairs = qk.argmin_culled(ops, "fast", False,
                                                with_stats=True)
    assert bool((visits == 1).all()) and bool((chunks == 1).all())
    assert bool((pairs == 100).all())


@pytest.mark.parametrize("algorithm", tk.ALGORITHMS)
def test_self_stats_only_on_request(algorithm):
    """The wrapper returns the counts alone by default and, with
    ``with_stats``, the plain version's warp tiles and work per face."""
    jv, _, f = _posed_small_body()
    qp, fp, ids = _operands(jv.astype(np.float32), f, algorithm)
    counts = tk.self_intersect_counts(qp, fp, ids, algorithm)
    assert torch.is_tensor(counts)
    out = tk.self_intersect_counts(qp, fp, ids, algorithm, with_stats=True)
    plain = tk.self_intersect_culled_plain(qp, fp, ids, algorithm)
    assert len(out) == 3 and all(torch.equal(a, b) for a, b in zip(out,
                                                                     plain))
    assert torch.equal(out[0], counts)
    boxes = tk.self_kernel_operands(fp, ids, algorithm)[1]
    assert (boxes is None) == (algorithm == "segment")


def test_argmin_culled_stats_only_on_request():
    """``argmin_culled`` returns (faces, visits) by default and the plain
    version's four outputs with ``with_stats``."""
    v, f = sphere(2, seed=17)
    q = surface_queries(v, f, 96, seed=18)
    vt, ft, qt = _t(v, f, q)
    ops = qk.culled_operands(vt[None], ft, qt[None], "fast", **TILES)
    short = qk.argmin_culled(ops, "fast", True)
    full = qk.argmin_culled(ops, "fast", True, with_stats=True)
    plain = qk.argmin_culled_plain(ops, "fast", True)
    assert len(short) == 2 and len(full) == 4
    assert all(torch.equal(a, b) for a, b in zip(full, plain))
    assert all(torch.equal(a, b) for a, b in zip(short, plain))


@pytest.mark.parametrize("dim", [0, -1])
def test_warp_any_votes_per_warp(dim):
    """The warp vote over groups of 32 along either axis, the last group
    padded with False."""
    x = torch.zeros((70, 5), dtype=torch.bool)
    x[33, 1] = x[69, 4] = x[0, 0] = True
    got = qk._warp_any(x if dim == 0 else x.t(), dim)
    got = got if dim == 0 else got.t()
    want = torch.zeros((3, 5), dtype=torch.bool)
    want[1, 1] = want[2, 4] = want[0, 0] = True
    assert torch.equal(got, want)


def test_morton_table_matches_bit_spreading():
    """The table lookup gives the bit-spread codes, also for rows with NaN
    and infinite coordinates (whose low 10 bits both read)."""
    xyz = torch.from_numpy(np.random.RandomState(19).randn(3, 400, 3)
                           .astype(np.float32))
    xyz[0, 5, 1] = float("nan")
    xyz[1, 7, 2] = float("inf")
    lo = xyz.amin(dim=-2, keepdim=True)
    span = torch.clamp_min(xyz.amax(dim=-2, keepdim=True) - lo, 1e-30)
    q = torch.clamp((xyz - lo) / span * 1023.0, 0.0, 1023.0).to(torch.int64)
    want = ((qk._part1by2(q[..., 0]) << 2) | (qk._part1by2(q[..., 1]) << 1)
            | qk._part1by2(q[..., 2]))
    assert torch.equal(qk._morton_codes(xyz), want)
