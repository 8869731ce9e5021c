"""The chunk cull of ``alongnormal_faces`` (``ray_kernel.argmin_alongnormal``
on the card, its plain version ``argmin_alongnormal_culled_plain`` and the
operands of ``alongnormal_cull_operands``) on the CPU.

The culled design must give exactly the every-face
``argmin_alongnormal_plain``'s faces at every split, on scan points with
noisy normals, N(0, 0.4) points, far queries and lines that miss
everything (face 0), grazing lines on a flat grid, lines through its
shared edges and vertices (equal |t| on both faces), degenerate faces
(|det| below 1e-9), NaN, inf and zero normals, and coordinates near
float32's overflow; mesh_tpu's ``nearest_alongnormal_pallas`` (interpret
mode) on the same inputs; and counts that follow its own definition (a
numpy recount below).  The lane's bound stays at or below every computed
cost of a chunk its line meets, a chunk its line misses costs exactly
_BIG on every face, and each stated wrong copy of the design (records too
small, a wrong least index, no miss candidates) gives other faces.
"""

import ast
import os

import numpy as np
import pytest
import torch

from mesh_tpu.query.pallas_ray import nearest_alongnormal_pallas

import mesh_tpu_torch
from mesh_tpu_torch import _build
from mesh_tpu_torch.query import ray_kernel as rk

from .test_torch_closest import root_dir, with_degenerate_faces
from .test_torch_closest_cull import body

torch.set_num_threads(2)

CHUNK = rk.ANY_HIT_CHUNK
SPLITS = (1, 3)
BIG = float(np.float32(rk._BIG))


def unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def t32(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32))


def surface_set(rng, v, f, n_q=256, noise=0.1, scan=0.005):
    """Scan points on random faces with their face's unit normal perturbed
    by N(0, noise) and renormalized (chip_smoke.registration_inputs), the
    last one a planted miss: the line through (50, 0, 0) along y."""
    pick = rng.randint(0, f.shape[0], n_q)
    w = rng.dirichlet([1.0, 1.0, 1.0], n_q)
    tri = v[f[pick]].astype(np.float64)
    q = np.einsum("qk,qkd->qd", w, tri) + rng.randn(n_q, 3) * scan
    fn = unit(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]))
    n = unit(fn + rng.randn(n_q, 3) * noise)
    q[-1], n[-1] = (50.0, 0.0, 0.0), (0.0, 1.0, 0.0)
    return q, n


def grid(n=8):
    """A flat n x n grid of 2 n^2 faces in z = 0 over [0, 1]^2."""
    xs = np.linspace(0.0, 1.0, n + 1)
    v = np.array([(x, y, 0.0) for y in xs for x in xs])
    f = np.array([q for j in range(n) for i in range(n) for q in (
        (j * (n + 1) + i, j * (n + 1) + i + 1, (j + 1) * (n + 1) + i + 1),
        (j * (n + 1) + i, (j + 1) * (n + 1) + i + 1,
         (j + 1) * (n + 1) + i))])
    return v, f


def turned(v, rng):
    """``v`` turned off the axes and moved off the origin."""
    rot, _ = np.linalg.qr(rng.randn(3, 3))
    return v @ rot.T + np.array([3.0, -2.0, 5.0]), rot


def make_set(name, seed):
    """(v, f, q, n) of one named set."""
    rng = np.random.RandomState(seed)
    if name in ("grazing", "ties"):
        v, f = grid()
        v, rot = turned(v, rng)
        k = 160
        if name == "grazing":
            # lines within 1e-6 rad of the grid's plane, 5 to 60 away
            far = rng.uniform(5.0, 60.0, k)
            tilt = rng.uniform(-1e-6, 1e-6, k)
            q = np.stack([-far, rng.uniform(-0.5, 1.5, k),
                          -tilt * (far + rng.uniform(-40.0, 40.0, k))], 1)
            n = np.stack([np.cos(tilt), rng.uniform(-0.05, 0.05, k),
                          np.sin(tilt)], 1)
        else:
            # perpendicular lines through vertices and edge midpoints: both
            # faces at a shared edge meet the line at the same t
            g = grid()[0]
            ends = grid()[1][rng.randint(0, 128, k), :2]
            on = np.where(rng.rand(k, 1) < 0.5, g[rng.randint(0, 81, k)],
                          (g[ends[:, 0]] + g[ends[:, 1]]) / 2.0)
            q = on + np.array([0.0, 0.0, 1.0]) * rng.uniform(-2, 2, (k, 1))
            n = np.tile([0.0, 0.0, 1.0], (k, 1))
        return v, f, q @ rot.T + np.array([3.0, -2.0, 5.0]), n @ rot.T
    v, f = body(seed=seed, n_seg=32, n_ring=24)
    if name == "surface":
        q, n = surface_set(rng, v, f)
    elif name == "randn":
        q, n = rng.randn(256, 3) * 0.4, unit(rng.randn(256, 3))
    elif name == "far":
        # 10 to 100 radii out in random directions, and lines that miss
        # everything: each must get face 0
        mean = v.mean(0)
        radius = np.linalg.norm(v - mean, axis=1).max()
        d = unit(rng.randn(96, 3)) * rng.uniform(10, 100, (96, 1)) * radius
        miss = np.array([[50.0, 0.0, 0.0]]) + rng.randn(32, 3)
        q = np.vstack([d + mean, miss])
        n = np.vstack([unit(rng.randn(96, 3)), np.tile([0.0, 1.0, 0.0],
                                                        (32, 1))])
    elif name == "degenerate":
        v, f, q = with_degenerate_faces(v, f, rng, n=16)
        # and faces of area 5e-11: |det| < 1e-9 for a unit normal
        tiny = v[f[:40, 0]][:, None] + np.array(
            [[0.0, 0.0, 0.0], [1e-5, 0.0, 0.0], [0.0, 1e-5, 0.0]])
        f = np.vstack([f, v.shape[0] + np.arange(120).reshape(40, 3)])
        v = np.vstack([v, tiny.reshape(-1, 3)])
        q = np.vstack([q, tiny[:, 0] + np.array([0.0, 0.0, 0.01])])
        n = np.vstack([unit(rng.randn(q.shape[0] - 40, 3)),
                       np.tile([0.0, 0.0, 1.0], (40, 1))])
    elif name == "nonfinite":
        q, n = surface_set(rng, v, f, 192)
        n[0::7] = np.nan
        n[1::7, 0] = np.inf
        n[2::7] = 0.0
        n[3::7] *= 1e-30          # |n|^2 underflows: every chunk
        q[4::7, 1] = np.nan
    else:                          # "overflow"
        q, n = surface_set(rng, v, f, 192)
        scale = np.where(np.arange(q.shape[0]) % 2, 1e12, 3e18)[:, None]
        return v * 1e15, f, q * 1e15, n * scale
    return v, f, q, n


def operands(v, f, q, n):
    """(pts, normals, planes, tri) of one mesh, batched as [1, ...]."""
    tri = t32(np.asarray(v, np.float32)[np.asarray(f)])[None]
    return t32(q)[None], t32(n)[None], rk.ray_planes(tri), tri


def culled(pts, nrm, tri, split=1, cull=None, **kw):
    if cull is None:
        cull = rk.alongnormal_cull_operands(tri)
    return rk.argmin_alongnormal_culled_plain(pts, nrm, cull, split=split,
                                              **kw)


SETS = ("surface", "randn", "far", "grazing", "ties", "degenerate",
        "nonfinite", "overflow")


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("name", SETS)
def test_culled_plain_equals_every_face(name, split):
    v, f, q, n = make_set(name, seed=1)
    pts, nrm, planes, tri = operands(v, f, q, n)
    want = rk.argmin_alongnormal_plain(pts, nrm, planes)
    got, warp, lane, stage, misses = culled(pts, nrm, tri, split)
    assert torch.equal(got, want), int((got != want).sum())
    n_c = -(-f.shape[0] // CHUNK)
    assert bool((warp <= stage).all()) and int(stage.max()) <= n_c
    assert int(lane.max()) <= f.shape[0] and int(misses.max()) <= n_c
    if name == "surface":
        # the planted miss gets face 0; scan points skip most chunks
        assert int(want[0, -1]) == 0
        assert float(warp.float().mean()) < 0.6 * n_c
        assert float(lane.float().mean()) < 0.2 * f.shape[0]
    if name == "far":
        assert bool((want[0, -32:] == 0).all())
        assert float(misses[0].float().mean()) > 0.9 * n_c
    if name == "ties":
        cost = rk._alongnormal_cost_tile(
            rk._xyz(pts[0]), rk._xyz(nrm[0]), *rk._rows(planes, 0, 1))[0]
        low = cost.amin(dim=-1, keepdim=True)
        tied = (cost == low).sum(dim=-1) > 1
        assert int(tied.sum()) > 10
        first = torch.argmax((cost == low).to(torch.uint8), dim=-1)
        assert torch.equal(want[0, tied], first[tied].to(torch.int32))
    if name == "degenerate":
        # the 40 lines at the tiny faces hit nothing of them (|det| < 1e-9)
        assert not bool(torch.isin(want[0, -40:], torch.arange(
            f.shape[0] - 40, f.shape[0])).any())
    if name == "nonfinite":
        # a NaN point or normal, or a zero normal, hits nothing: face 0
        bad = (torch.isnan(nrm[0]).any(-1) | torch.isnan(pts[0]).any(-1)
               | (nrm[0] == 0).all(-1))
        assert int(bad.sum()) > 50 and bool((want[0, bad] == 0).all())


def costs_by_chunk(pts, nrm, cull):
    """[Q, C, 32] computed costs of every sorted face (padding: NaN)."""
    faces = cull["faces"][0]
    cost = rk._face_cost(rk._xyz(pts[0]), rk._xyz(nrm[0]), faces[None])
    pos = torch.arange(faces.shape[0])
    cost = torch.where(pos < cull["n_faces"], cost, float("nan"))
    return cost.view(pts.shape[1], -1, CHUNK)


@pytest.mark.parametrize("name", ["surface", "randn", "grazing",
                                  "overflow", "degenerate"])
def test_bound_stays_below_every_cost(name):
    """For every lane and chunk: where the guard holds and the line misses
    the grown box, every face costs exactly _BIG; where it meets it, the
    bound is at or below every computed cost of the faces the line hits.
    On random lines too (seeded), including ones of norm 1e-3 and 1e3."""
    v, f, q, n = make_set(name, seed=5)
    rng = np.random.RandomState(6)
    if name in ("surface", "randn"):
        q = np.vstack([q, rng.randn(64, 3) * 0.5])
        n = np.vstack([n, unit(rng.randn(64, 3))
                       * rng.choice([1e-3, 1.0, 1e3], (64, 1))])
    pts, nrm, _, tri = operands(v, f, q, n)
    cull = rk.alongnormal_cull_operands(tri)
    qo = torch.arange(pts.shape[1])[None]
    _, _, ray, inv_dn, loose = rk._lane_terms(pts, nrm, qo, pts.shape[1])
    cost = costs_by_chunk(pts, nrm, cull)
    met = 0
    for k in range(cull["chunks"].shape[1]):
        keep, _, span = rk._chunk_keep(ray, cull["chunks"][:, k:k + 1],
                                       rk._chunk_normals(cull, k), None,
                                       span=True)
        decided = (span["decided"] & ~loose)[0]
        c_k = cost[:, k]
        missed = decided & ~keep[0]
        real = ~torch.isnan(c_k)
        assert bool(((c_k == BIG) | ~real)[missed].all()), k
        lb = rk.along_bound(span, inv_dn)[0]
        hit = (c_k != BIG) & real & (decided & keep[0])[:, None]
        low = torch.where(hit, c_k, float("inf"))
        assert not bool((low < lb[:, None]).any()), k
        met += int(hit.any(dim=-1).sum())
    # grazing lines fail the guard on every chunk their line meets
    assert (met == 0) == (name == "grazing")


def test_planted_miss_and_shared_edge_ties_keep_face_order():
    """Two copies of one face across a chunk boundary, at faces 31 and 32
    and at the mesh's end: the lowest index wins whatever the sorted order
    puts first."""
    v, f = body(seed=9, n_seg=24, n_ring=16)
    f = f.copy()
    for i in (32, 63, 64, f.shape[0] - 1):
        f[i] = f[31]
    tri = v[f[31]].astype(np.float64)
    rng = np.random.RandomState(10)
    q = rng.dirichlet([1.0, 1.0, 1.0], 64) @ tri
    fn = unit(np.cross(tri[1] - tri[0], tri[2] - tri[0]))
    n = unit(fn + rng.randn(64, 3) * 0.05)
    q = q + n * rng.uniform(-0.01, 0.01, (64, 1))
    pts, nrm, planes, tri_t = operands(v, f, q, n)
    want = rk.argmin_alongnormal_plain(pts, nrm, planes)
    assert bool((want == 31).any())
    assert not bool(torch.isin(want, torch.tensor(
        [32, 63, 64, f.shape[0] - 1])).any())
    for split in (1, 2, 5):
        assert torch.equal(culled(pts, nrm, tri_t, split)[0], want)


#: each wrong copy of the design and the set on which it must fail
TRAPS = {"records_too_small": "surface", "wrong_least_index": "far",
         "no_miss_candidates": "far"}


@pytest.mark.parametrize("kind", sorted(TRAPS))
def test_planted_traps_change_an_answer(kind, monkeypatch):
    v, f, q, n = make_set(TRAPS[kind], seed=2)
    pts, nrm, planes, tri = operands(v, f, q, n)
    want = rk.argmin_alongnormal_plain(pts, nrm, planes)
    cull = rk.alongnormal_cull_operands(tri)
    assert torch.equal(culled(pts, nrm, tri, cull=cull)[0], want)
    if kind == "records_too_small":
        chunks = cull["chunks"].clone()
        span = chunks[..., 4:7] - chunks[..., 0:3]
        chunks[..., 0:3] += 0.2 * span
        chunks[..., 4:7] -= 0.2 * span
        cull = dict(cull, chunks=chunks)
    elif kind == "wrong_least_index":
        cull = dict(cull, min_ids=cull["ids"].view(1, -1, CHUNK)
                    .amax(dim=-1).contiguous())
    else:
        monkeypatch.setattr(rk, "_fold_misses",
                            lambda miss, mid, best, best_i: (best, best_i))
    got = culled(pts, nrm, tri, cull=cull)[0]
    assert not torch.equal(got, want), kind


def recount(pts, nrm, cull, split, seed=True):
    """The cull's faces and counts by a lane-by-lane numpy walk over every
    sorted face's cost (csrc/alongnormal_faces.cu): warps of 32 sorted
    queries, each split's chunks in order, a miss candidate for a chunk a
    lane's line misses, each warp's vote one chunk ahead, lexicographic
    folds, the splits merged the same way."""
    qo = rk.along_query_order(pts, cull)[0].numpy().astype(np.int64)
    n_q = pts.shape[1]
    n_c = cull["chunks"].shape[1]
    n_f = cull["n_faces"]
    ids = cull["ids"][0].numpy()
    min_ids = cull["min_ids"][0].numpy()
    lanes_p, lanes_n = pts[:, qo], nrm[:, qo]
    cost = costs_by_chunk(lanes_p, lanes_n, cull).numpy()
    _, _, ray, inv_dn, loose = rk._lane_terms(
        lanes_p, lanes_n, torch.arange(n_q)[None], n_q)
    status = np.zeros((n_q, n_c), np.float32)     # the lane's bound
    miss = np.zeros((n_q, n_c), bool)
    for k in range(n_c):
        keep, _, span = rk._chunk_keep(ray, cull["chunks"][:, k:k + 1],
                                       rk._chunk_normals(cull, k), None,
                                       span=True)
        decided = (span["decided"] & ~loose)[0].numpy()
        miss[:, k] = decided & ~keep[0].numpy()
        lb = rk.along_bound(span, inv_dn)[0].numpy()
        status[:, k] = np.where(miss[:, k], np.inf,
                                np.where(decided, lb, -np.inf))
    # the seed: the least cost over the SEED_CHUNKS chunks nearest by
    # (box distance, centre distance, chunk)
    db, dc = (x[0].numpy() for x in rk._seed_keys(lanes_p, cull["chunks"]))
    seeds = np.full(n_q, np.inf, np.float32)
    for li in range(n_q):
        near = np.lexsort((np.arange(n_c), dc[li], db[li]))
        for k in near[:rk.SEED_CHUNKS]:
            c_seed = cost[li, k][:min(CHUNK, n_f - k * CHUNK)]
            seeds[li] = min(seeds[li], np.where(np.isnan(c_seed), np.inf,
                                                c_seed).min())
    if not seed:
        seeds[:] = np.inf

    def lex(d_, i_, bd, bi):
        return d_ < bd or (d_ == bd and i_ < bi)

    out = np.zeros(n_q, np.int64)
    n_w = -(-n_q // 32)
    warp = np.zeros(n_w, np.int64)
    stage = np.zeros(n_w, np.int64)
    lane = np.zeros(n_q, np.int64)
    misses = miss.sum(1)
    for w in range(n_w):
        ls = np.arange(32 * w, min(n_q, 32 * w + 32))
        parts = []
        for s in range(split):
            best = [(np.float32(np.inf), 0) for _ in ls]
            for j, li in enumerate(ls):
                for k in range(n_c * s // split, n_c * (s + 1) // split):
                    if miss[li, k] and lex(np.float32(BIG), min_ids[k],
                                           *best[j]):
                        best[j] = (np.float32(BIG), min_ids[k])

            def needs(k, state):
                thr = np.minimum(np.fmin([b[0] for b in state], seeds[ls]),
                                 np.float32(BIG))
                return ~(status[ls, k] > thr)

            snap = list(best)
            for k in range(n_c * s // split, n_c * (s + 1) // split):
                if not needs(k, snap).any():
                    continue
                stage[w] += 1
                snap = list(best)
                need = needs(k, best)
                cols = range(min(CHUNK, n_f - k * CHUNK))
                lane[ls] += need * len(cols)
                if not need.any():
                    continue
                warp[w] += 1
                for j, li in enumerate(ls):
                    for col in cols:
                        c = cost[li, k, col]
                        if not np.isnan(c) and lex(c, ids[k * CHUNK + col],
                                                   *best[j]):
                            best[j] = (c, ids[k * CHUNK + col])
            parts.append(best)
        for j, li in enumerate(ls):
            top = parts[0][j]
            for part in parts[1:]:
                if lex(*part[j], *top):
                    top = part[j]
            out[qo[li]] = top[1]
    return out, warp, lane, stage, misses


@pytest.mark.parametrize("split", [1, 3])
def test_counts_match_a_numpy_recount(split):
    v, f = body(seed=15, n_seg=20, n_ring=14)
    rng = np.random.RandomState(15)
    q, n = surface_set(rng, v, f, 96, noise=0.3)
    q[40] = np.nan
    n[41] = 0.0
    pts, nrm, planes, tri = operands(v, f, q, n)
    cull = rk.alongnormal_cull_operands(tri)
    got = culled(pts, nrm, tri, split, cull)
    want = recount(pts, nrm, cull, split)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), w)
    assert torch.equal(got[0], rk.argmin_alongnormal_plain(pts, nrm,
                                                           planes))


def test_seed_changes_counts_not_faces():
    v, f, q, n = make_set("surface", seed=3)
    pts, nrm, planes, tri = operands(v, f, q, n)
    cull = rk.alongnormal_cull_operands(tri)
    with_seed = culled(pts, nrm, tri, cull=cull)
    without = culled(pts, nrm, tri, cull=cull, seed=False)
    assert torch.equal(with_seed[0], without[0])
    assert int(with_seed[1].sum()) <= int(without[1].sum())
    assert int(with_seed[2].sum()) < int(without[2].sum())
    for g, w in zip(without, recount(pts, nrm, cull, 1, seed=False)):
        np.testing.assert_array_equal(g[0].numpy(), w)


@pytest.mark.parametrize("seed", [4, 5])
def test_culled_matches_pallas(seed):
    """mesh_tpu's Pallas kernel in interpret mode: the same faces (both
    folds keep the lowest index at exact ties and face 0 for a miss), the
    same misses, distances and points to 1e-5."""
    v, f = body(seed=seed, n_seg=16, n_ring=12)
    rng = np.random.RandomState(seed)
    q, n = surface_set(rng, v, f, 96)
    q = np.vstack([q, rng.randn(32, 3) * 0.4]).astype(np.float32)
    n = np.vstack([n, unit(rng.randn(32, 3))]).astype(np.float32)
    v = v.astype(np.float32)
    d_ref, f_ref, p_ref = (np.asarray(x) for x in nearest_alongnormal_pallas(
        v, f.astype(np.int32), q, n, tile_q=32, tile_f=64, interpret=True))
    pts, nrm, _, tri = operands(v, f, q, n)
    best = rk.argmin_alongnormal(pts, nrm, cull=rk.alongnormal_cull_operands(
        tri), with_stats=True, split=2)[0]
    dist, face, point = (x[0].numpy() for x in rk.alongnormal_epilogue(
        best, tri, pts, nrm))
    np.testing.assert_array_equal(face, f_ref)
    hit = np.isfinite(d_ref)
    np.testing.assert_array_equal(np.isfinite(dist), hit)
    assert hit.mean() > 0.5 and not hit[95]            # the planted miss
    np.testing.assert_allclose(dist[hit], d_ref[hit], atol=1e-5)
    np.testing.assert_allclose(point, p_ref, atol=1e-5)


def test_query_order_ignores_far_queries():
    """The lanes' Morton order is taken in the mesh's box: a far query does
    not move the others, and the order is a permutation."""
    v, f, q, n = make_set("surface", seed=8)
    pts, _, _, tri = operands(v, f, q, n)
    cull = rk.alongnormal_cull_operands(tri)
    order = rk.along_query_order(pts, cull)[0]
    assert torch.equal(torch.sort(order).values,
                       torch.arange(pts.shape[1], dtype=torch.int32))
    near = rk.along_query_order(pts[:, :-1].contiguous(), cull)[0]
    assert torch.equal(order[order != pts.shape[1] - 1], near)


def test_tree_keeps_the_face_side_and_matches_plain():
    v, f, q, n = make_set("surface", seed=11)
    m = mesh_tpu_torch.Mesh(v=v, f=f, device="cpu")
    tree = m.compute_aabb_tree()
    first = tree.nearest_alongnormal(q, n)
    ops = tree._along
    again = tree.nearest_alongnormal(q, n)
    assert tree._along is ops
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    dist, face, point = rk.nearest_alongnormal_plain(
        t32(v), torch.from_numpy(f.astype(np.int64)), t32(q), t32(n))
    np.testing.assert_array_equal(first[1], face.numpy())
    assert first[0][-1] == 1e100 and first[1][-1] == 0


def test_wrappers_route_and_check_operands():
    v, f, q, n = make_set("surface", seed=17)
    pts, nrm, planes, tri = operands(v, f, q[:40], n[:40])
    before = dict(rk.LAUNCHES)
    plain = rk.argmin_alongnormal_plain(pts, nrm, planes)
    assert torch.equal(rk.argmin_alongnormal(pts, nrm, planes), plain)
    assert torch.equal(rk.argmin_alongnormal_every(pts, nrm, planes), plain)
    cull = rk.alongnormal_cull_operands(tri)
    for split in (1, 4):
        stats = rk.argmin_alongnormal(pts, nrm, cull=cull, with_stats=True,
                                      split=split)
        for g, w in zip(stats, rk.argmin_alongnormal_culled_plain(
                pts, nrm, cull, split=split)):
            assert torch.equal(g, w)
    assert rk.LAUNCHES == before
    assert {"alongnormal_faces", "alongnormal_faces_every"} <= set(
        rk.LAUNCHES)
    with pytest.raises(ValueError, match="alongnormal_cull_operands"):
        rk.argmin_alongnormal(pts, nrm, planes, with_stats=True)
    with pytest.raises(ValueError, match="needs planes"):
        rk.argmin_alongnormal(pts, nrm, cull=cull)
    with pytest.raises(ValueError, match="qorder"):
        rk.argmin_alongnormal(pts, nrm, cull=cull, with_stats=True,
                              qorder=torch.zeros((1, 40), dtype=torch.long))
    with pytest.raises(ValueError, match="min_ids"):
        rk.argmin_alongnormal(pts, nrm, cull=dict(
            cull, min_ids=cull["min_ids"][:, 1:].contiguous()),
            with_stats=True)
    for split in (0, rk.ALONG_MAX_SPLIT + 1):
        with pytest.raises(ValueError, match="split"):
            rk.argmin_alongnormal(pts, nrm, planes, split=split)
    with pytest.raises(ValueError):
        rk.alongnormal_cull_operands(tri[:, :0])
    for name, entry, n_ptr in (
            ("alongnormal_faces", "mt_alongnormal_faces", 15),
            ("alongnormal_faces_every", "mt_alongnormal_faces_every", 4)):
        source, got_entry, types = _build.KERNELS[name]
        assert source == name + ".cu" and got_entry == entry
        assert types.count(_build._PTR) == n_ptr
    # the cull runs row 8's chunk test, which row 8's kernel includes too
    text = open(os.path.join(_build._CSRC, "alongnormal_faces.cu")).read()
    assert "chunk_needed<true>" in text and '#include "ray_cull.cuh"' in text
    row8 = open(os.path.join(_build._CSRC, "ray_any_hit_culled.cu")).read()
    assert '#include "ray_cull.cuh"' in row8
    assert "bool chunk_needed" not in row8


def test_ab_harness_pairs_medians_and_checks(tmp_path):
    """tools/ab_common.py, the A/B tools' shared harness: the pairs
    alternate which side runs first, the summary is the median of each
    side's medians and its fastest round, the side program parses, and the
    answer check names what differs from the first process's."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "ab_common", os.path.join(root_dir(), "tools", "ab_common.py"))
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    assert ab.side_order(3) == ["other", "this", "this", "other", "other",
                                "this"]
    runs = [{"side": side, "readings": {"ms": {"k": ms},
                                        "rounds_ms": {"k": [ms, ms - 1]}}}
            for side, ms in (("other", 5.0), ("this", 2.0), ("this", 4.0),
                             ("other", 3.0), ("other", 9.0), ("this", 3.0))]
    summary, fastest = ab.summarize(runs)
    assert summary == {"other": {"k": 5.0}, "this": {"k": 3.0}}
    assert fastest == {"other": {"k": 2.0}, "this": {"k": 1.0}}
    program = ab.side_program("variants.append(('k', lambda: None))\n",
                              ptxas=("a",), sass=("b",))
    ast.parse(program)
    assert program.startswith("PTXAS = ('a',)\nSASS = ('b',)\n")
    paths = []
    for k, faces in enumerate(([1, 2], [1, 2], [1, 3])):
        paths.append(str(tmp_path / ("a%d.pt" % k)))
        torch.save({"kernel": torch.tensor(faces),
                    "every": torch.tensor([1, 2])}, paths[-1])
    assert ab.same_as_first("kernel")(paths[:2]) == []
    assert ab.same_as_first("kernel")(paths) == ["kernel"]


@pytest.mark.parametrize("tool", ["ab_along.py", "ab_common.py",
                                  "cull_counts.py"])
def test_tools_import_neither_jax_nor_mesh_tpu(tool):
    path = os.path.join(root_dir(), "tools", tool)
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] not in ("jax", "jaxlib", "mesh_tpu")
