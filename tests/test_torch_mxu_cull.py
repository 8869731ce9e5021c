"""The chunk cull of the MXU rung's exact scans (``mxu_kernel.mxu_faces`` and
``mxu_repair`` on the card, the plain versions of their design
``mxu_faces_culled_plain`` / ``mxu_repair_culled_plain``, and the operands
of ``mxu_cull_operands``) on the CPU.

The culled design must give exactly the every-face plain versions' faces
(``mxu_faces_plain``; ``mxu_repair_plain``, and its tiles run per query
tile), with and without the degenerate tail, at every split of a warp's
chunks, on any query order; mesh_tpu's ``closest_point_pallas_mxu`` and
``closest_point_pallas_mxu_repair`` under the tie contract (run in
interpret mode, as tests/test_torch_mxu.py runs them); and counts that
follow its own definition (a numpy recount below).  The chunk bound, whose
rounding terms scale with the distance from the origin for the MXU form,
must stay at or below every computed cost of the chunk's faces: on
slivers, degenerate faces, adversarial soups, queries at 10-100x the
mesh's radius, and a planted mesh whose corner terms cancel to 0 far from
the origin (where row 1's bound, without the MXU term, skips the winner).
A screened-out tile must not seed a lane, NaN queries and non-finite
records keep the every-face answers, and exact ties across chunk
boundaries go to the lowest index.
"""

import ast
import os

import numpy as np
import pytest
import torch

from mesh_tpu.query import pallas_closest as pc

from mesh_tpu_torch import _build
from mesh_tpu_torch.query import closest_kernel as ck
from mesh_tpu_torch.query import mxu_kernel as mk
from mesh_tpu_torch.query.autotune import _sphere_mesh

from .test_torch_closest import root_dir, small_body, with_degenerate_faces
from .test_torch_closest_cull import adversarial_soup, long_slivers
from .test_torch_mxu import assert_mxu_contract

torch.set_num_threads(2)

CHUNK = ck.CULL_CHUNK
#: small tiles, so that query tiles, face tiles and chunks interleave
TILE_Q, TILE_F = 64, 256
TAILS = (False, True)
SPLITS = (1, 3)


def sphere(n_faces=2048):
    v, f = _sphere_mesh(n_faces)
    return v.astype(np.float32), f.astype(np.int32)


def patches(n, rng, per=64):
    """Phase 12's surface-proximal queries at this size: n / per patches of
    per queries, 1.005 times a unit direction plus N(0, 0.002)."""
    d = rng.randn(n // per, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    q = np.repeat(d * 1.005, per, axis=0)
    return (q + 0.002 * rng.randn(*q.shape)).astype(np.float32)


def far(n, rng, radius=1.0):
    d = rng.randn(n, 3)
    d *= rng.uniform(10, 100, (n, 1)) * radius / np.linalg.norm(
        d, axis=1, keepdims=True)
    return d.astype(np.float32)


QUERIES = {"surface": lambda rng: patches(320, rng),
           "randn": lambda rng: (rng.randn(300, 3) * 0.4).astype(np.float32),
           "far": lambda rng: far(200, rng)}


def operands(v, f, q, tile_q=TILE_Q):
    p, rec, _, _, _ = mk.mxu_operands(v, f, q, tile_q, device="cpu")
    return p, rec


def culled(p, rec, tail, split=1, ub=None, cert=None, cull=None,
           tile_q=TILE_Q, tile_f=TILE_F):
    """The culled plain version: dense (ub None) or repair."""
    if cull is None:
        cull = mk.mxu_cull_operands(p, rec, tail)
    if ub is None:
        return mk.mxu_faces_culled_plain(p, rec, cull, tile_q, tile_f, tail,
                                         split)
    return mk.mxu_repair_culled_plain(p, rec, ub, cert, cull, tile_q, tile_f,
                                      tail, split)


def assert_same(p, rec, tail, splits=SPLITS, cull=None, tile_q=TILE_Q,
                tile_f=TILE_F):
    """Dense and repair culled faces (and tiles run) equal the every-face
    plain versions' at every split; returns the dense counts of split 1."""
    want = mk.mxu_faces_plain(p, rec, tile_q, tile_f, tail)
    ub, cert = mk.mxu_bound_plain(p, rec, tile_f)
    want_r, rep = mk.mxu_repair_plain(p, rec, ub, cert, tile_q, tile_f, tail)
    first = None
    for split in splits:
        got = culled(p, rec, tail, split, cull=cull, tile_q=tile_q,
                     tile_f=tile_f)
        assert torch.equal(got[0], want), (split, int((got[0] != want).sum()))
        got_r = culled(p, rec, tail, split, ub, cert, cull, tile_q, tile_f)
        assert torch.equal(got_r[0], want_r), (split, int(
            (got_r[0] != want_r).sum()))
        assert torch.equal(got_r[1], rep)
        first = first or got
    return first


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("tail", TAILS)
@pytest.mark.parametrize("queries", sorted(QUERIES))
def test_culled_plain_equals_every_face(queries, tail, split):
    v, f = sphere()
    q = QUERIES[queries](np.random.RandomState(1))
    p, rec = operands(v, f, q)
    want = mk.mxu_faces_plain(p, rec, TILE_Q, TILE_F, tail)
    got, warp, lane, stage = culled(p, rec, tail, split)
    assert torch.equal(got, want)
    ub, cert = mk.mxu_bound_plain(p, rec, TILE_F)
    want_r, rep = mk.mxu_repair_plain(p, rec, ub, cert, TILE_Q, TILE_F, tail)
    got_r = culled(p, rec, tail, split, ub, cert)
    assert torch.equal(got_r[0], want_r) and torch.equal(got_r[1], rep)
    assert torch.equal(got_r[0], got)           # the repair names the dense
    n_c = -(-f.shape[0] // CHUNK)
    # the counts are consistent; near queries let the cull skip chunks
    assert bool((warp <= stage).all()) and int(stage.max()) <= n_c
    assert int(lane.max()) <= f.shape[0]
    if queries == "surface":
        assert float(warp.float().mean()) < 0.3 * n_c
        # the screen prunes tiles
        assert int(rep.sum()) < rep.numel() * cert.shape[1]


def chunk_min_costs(p, rec, tail):
    """[N, C] least computed MXU cost over each chunk's faces."""
    cost = mk._sqdist_tile_mxu(p, mk._cols(rec), tail)
    pad = -cost.shape[1] % CHUNK
    cost = torch.cat([cost, cost[:, -1:].expand(-1, pad)], 1)
    return cost.reshape(cost.shape[0], -1, CHUNK).amin(dim=-1)


def chunk_bounds(p, records):
    """[N, C] the kernel's bound of each query to each chunk."""
    px, py, pz = p[:, 0, None], p[:, 1, None], p[:, 2, None]
    plen = torch.sqrt(px * px + py * py + pz * pz)
    return mk._mxu_lb2(px, py, pz, plen, records[None])


def assert_bound_holds(p, rec, cull, tail):
    low = chunk_min_costs(p, rec, tail)
    bound = chunk_bounds(p, cull["records"])
    assert not bool((low < bound).any()), float((bound - low).max())


@pytest.mark.parametrize("tail", TAILS)
def test_slivers_degenerate_faces_and_far_queries_keep_every_answer(tail):
    v, f, q = long_slivers(np.random.RandomState(2))
    v2, f2, q2 = with_degenerate_faces(v, f, np.random.RandomState(3), n=16)
    q2 = np.vstack([q, q2]).astype(np.float32)
    p, rec = operands(v2, f2, q2)
    cull = mk.mxu_cull_operands(p, rec, tail)
    assert_bound_holds(p, rec, cull, tail)
    assert_same(p, rec, tail, cull=cull)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adversarial_soups_keep_the_bound_and_every_answer(seed):
    """Soups of slivers and nearly degenerate faces at scales from 1e-3 to
    1e3 and offsets up to 100 times their scale (the MXU form's rounding
    grows with the distance from the origin), queried from 1e-8 to 1e4
    times their size."""
    rng = np.random.RandomState(200 + seed)
    for _ in range(4):
        v, f, q = adversarial_soup(rng)
        p, rec = operands(v, f, q[:96], tile_q=32)
        for tail in TAILS:
            cull = mk.mxu_cull_operands(p, rec, tail)
            assert_bound_holds(p, rec, cull, tail)
            assert_same(p, rec, tail, splits=(1, 2), cull=cull, tile_q=32,
                        tile_f=64)


def cancelling_corners(seed=0, m=4, scale=1000.0, delta=0.01, size=0.1):
    """m queries about ``scale`` from the origin, each beside two chunks:
    first 32 faces whose corner a lies ``delta`` from the query in one cone
    of directions (their edges pointing away, so the query lies in corner
    a's region), then 32 copies of a face whose corner a is the query
    itself (the nearest representative, the lane's seed); the whole
    mirrored through the origin, so the vertex mean stays near it.  The
    MXU form's ap2 = p2 - 2 p.a + a2 cancels at the scale of |p|^2
    (ulp 0.0625): the first chunk's faces compute to 0, tie with the
    seed's and win by index, though the chunk's box lies delta away."""
    rng = np.random.RandomState(seed)
    tris, qs = [], []
    for _ in range(m):
        d = rng.randn(3)
        p = d / np.linalg.norm(d) * scale * rng.uniform(0.8, 1.2)
        qs.append(p)
        w0 = rng.randn(3)
        w0 /= np.linalg.norm(w0)
        for j in range(2 * CHUNK):
            w = w0 + 0.2 * rng.randn(3) if j < CHUNK else rng.randn(3)
            w /= np.linalg.norm(w)
            t1 = np.cross(w, rng.randn(3))
            t1 /= np.linalg.norm(t1)
            t2 = np.cross(w, t1)
            if j == CHUNK:
                face = [p, p + size * (w + 0.3 * t1), p + size * (w + 0.3 * t2)]
            if j < CHUNK:
                a = p + delta * w
                face = [a, a + size * (w + 0.3 * t1), a + size * (w + 0.3 * t2)]
            tris.append(face)
    tris = np.array(tris)
    tris = np.concatenate([tris, -tris])
    v = tris.reshape(-1, 3).astype(np.float32)
    f = np.arange(v.shape[0]).reshape(-1, 3).astype(np.int32)
    return v, f, np.array(qs, np.float32)


@pytest.mark.parametrize("tail", TAILS)
def test_cancelling_corner_terms_need_the_mxu_rounding_term(tail):
    v, f, q = cancelling_corners()
    p, rec = operands(v, f, q, tile_q=32)
    cull = mk.mxu_cull_operands(p, rec, tail)
    want = mk.mxu_faces_plain(p, rec, 32, TILE_F, tail)
    assert_same(p, rec, tail, cull=cull, tile_q=32)
    assert_bound_holds(p, rec, cull, tail)
    n = q.shape[0]
    first = np.arange(n) * 2 * CHUNK           # each query's first chunk
    assert bool(((want[:n].numpy() - first) < CHUNK).all())
    low = chunk_min_costs(p, rec, tail)
    # without e1 and e2 the bound exceeds the first chunks' computed cost
    bare = dict(cull, records=cull["records"].clone())
    bare["records"][:, 7] = 0.0
    bare["records"][:, 11] = 0.0
    assert bool((low < chunk_bounds(p, bare["records"])).any())
    got = culled(p, rec, tail, cull=bare, tile_q=32)[0]
    assert not torch.equal(got, want)
    # row 1's bound, R without the MXU term |p| + reach, does too: the
    # walk under it skips the winners
    px, py, pz = p[:, 0, None], p[:, 1, None], p[:, 2, None]
    row1 = ck._cull_lb2(px, py, pz, cull["records"][None, :, :12])
    assert bool((low < row1).any())
    walked = recount(p, rec, cull, tail, bound=row1.numpy())[0]
    assert not np.array_equal(walked, want.numpy())


@pytest.mark.parametrize("tail", TAILS)
def test_ties_across_chunk_boundaries(tail):
    """Copies of one face at 31, 32, 63, 64 and 95 (across chunk and, at
    tile_f 64, face-tile boundaries), queried near it: the lowest index
    wins every fold."""
    v, f = sphere(1024)
    f = f.copy()
    for i in (32, 63, 64, 95):
        f[i] = f[31]
    rng = np.random.RandomState(8)
    w = rng.dirichlet([1.0, 1.0, 1.0], 64)
    q = (w @ v[f[31]].astype(np.float64)
         + rng.randn(64, 3) * 1e-3).astype(np.float32)
    p, rec = operands(v, f, q)
    got = assert_same(p, rec, tail, splits=(1, 2, 4), tile_f=64)[0]
    assert bool((got == 31).any())
    assert not bool(torch.isin(got, torch.tensor([32, 63, 64, 95])).any())


@pytest.mark.parametrize("tail", TAILS)
def test_nan_query_and_non_finite_records_keep_every_answer(tail):
    """NaN in one query and NaN or inf in five faces' records (a corner,
    an edge, a hoisted corner term, a2 and a normal): the chunks holding
    those faces are always needed (e1 = +inf), and the answers stay the
    every-face ones, dense and behind the screen."""
    v, f = sphere(1024)
    q = (np.random.RandomState(9).randn(128, 3) * 0.4).astype(np.float32)
    p, rec = operands(v, f, q)
    rec = rec.clone()
    planted = {(9, 5): float("nan"), (1, 300): float("inf"),
               (12, 500): float("nan"), (15, 700): float("-inf"),
               (7, 900): float("inf")}
    for (col, face), value in planted.items():
        rec[face, col] = value
    p[7, 1] = float("nan")
    cull = mk.mxu_cull_operands(p, rec, tail)
    chunks = torch.tensor(sorted({face // CHUNK for _, face in planted}))
    assert bool(torch.isinf(cull["records"][chunks, 7]).all())
    assert_same(p, rec, tail, cull=cull)


def seed_trap(tile_q=64):
    """A sphere and a patch of tile_q queries on the corner a of a chunk's
    first face (its representative, so that face's cost would seed the
    lanes near 0), with ub and a planted cert that lets that query tile
    run only the face tile farthest from the patch (cert -inf) and
    screens out the rest (cert +inf)."""
    v, f = sphere(1024)
    rec = operands(v, f, np.zeros((1, 3), np.float32))[1]
    reps = mk.mxu_chunk_records(rec)[:, 8:11]
    spot = reps[5].numpy() + v.astype(np.float64).mean(0)
    q = spot * 1.002 + np.random.RandomState(10).randn(tile_q, 3) * 0.002
    p, rec = operands(v, f, q.astype(np.float32), tile_q)
    ub, cert = mk.mxu_bound_plain(p, rec, TILE_F)
    dist = ((p[:, None] - reps[None]) ** 2).sum(-1)
    near = dist.argmin(1)
    tile = torch.arange(reps.shape[0]) // (TILE_F // CHUNK)
    per_tile = torch.full((cert.shape[1],), float("inf")).scatter_reduce(
        0, tile, dist.min(0).values, "amin")
    cert = torch.full_like(cert, float("inf"))
    cert[:, per_tile.argmax()] = float("-inf")
    return p, rec, ub, cert, near


@pytest.mark.parametrize("tail", TAILS)
def test_seed_trap_screened_out_nearest_representative(tail):
    p, rec, ub, cert, near = seed_trap()
    surv = mk.survivors(ub, cert, TILE_Q)
    assert not bool(surv[0, near // (TILE_F // CHUNK)].any())
    want, rep = mk.mxu_repair_plain(p, rec, ub, cert, TILE_Q, TILE_F, tail)
    cull = mk.mxu_cull_operands(p, rec, tail)
    for split in (1, 2):
        got = culled(p, rec, tail, split, ub, cert, cull)
        assert torch.equal(got[0], want) and torch.equal(got[1], rep)
    # the answers lie outside the screened-out tiles, farther than the
    # nearest representatives' faces: a seed taken from those would cull
    # every chunk the lanes fold
    assert not bool(torch.isin(want // TILE_F,
                               near // (TILE_F // CHUNK)).any())
    walked = recount(p, rec, cull, tail, runs=surv, seed_any_tile=True)[0]
    assert not np.array_equal(walked, want.numpy())


def recount(p, rec, cull, tail, runs=None, split=1, bound=None,
            seed_any_tile=False, tile_q=TILE_Q, tile_f=TILE_F):
    """The cull's faces and counts by a lane-by-lane numpy walk over the
    every-pair costs (csrc/mxu_cull.cuh): warps of 32 sorted queries, each
    split's chunks of 32 faces in order, each warp's vote one chunk ahead,
    lanes folding only the face tiles their query tile runs (``runs``
    [N / tile_q, n_tiles] bool, None: every tile), the splits merged in
    order.  ``bound`` [N, C] replaces the kernel's chunk bounds;
    ``seed_any_tile`` seeds from the nearest representative of any tile."""
    cost = mk._sqdist_tile_mxu(p, mk._cols(rec), tail).numpy()
    n_q, n_f = cost.shape
    crec = cull["records"]
    if bound is None:
        bound = chunk_bounds(p, crec).numpy()
    reps = crec[:, 8:11].numpy()
    n_c = reps.shape[0]
    order = cull["qorder"].numpy().astype(np.int64)
    pts = p.numpy()
    screen = runs is not None
    cpt = tile_f // CHUNK if screen else n_c
    out = np.zeros(n_q, np.int64)
    warp = np.zeros(n_q // 32, np.int64)
    stage = np.zeros_like(warp)
    lane = np.zeros(n_q, np.int64)
    for w0 in range(0, n_q, 32):
        qs = order[w0:w0 + 32]
        w = w0 // 32
        run = (runs.numpy()[qs // tile_q][:, np.arange(n_c) // cpt]
               if screen else np.ones((32, n_c), bool))
        dx = pts[qs, 0, None] - reps[None, :, 0]
        dy = pts[qs, 1, None] - reps[None, :, 1]
        dz = pts[qs, 2, None] - reps[None, :, 2]
        d = dx * dx + dy * dy + dz * dz
        d = np.where(np.isnan(d), np.float32(np.inf), d)
        if not seed_any_tile:
            d = np.where(run, d, np.float32(np.inf))
        ks = np.argmin(d, 1)
        seed = np.where(d[np.arange(32), ks] < np.inf,
                        cost[qs, ks * CHUNK], np.float32(np.inf))
        fin_d = fin_i = None
        for s in range(split):
            best = np.full(32, np.inf, np.float32)
            best_i = np.zeros(32, np.int64)
            snap = best.copy()
            for k in range(n_c * s // split, n_c * (s + 1) // split):
                r, lb2 = run[:, k], bound[qs, k]
                if not np.any(r & ~(lb2 > np.fmin(snap, seed))):
                    continue
                stage[w] += 1
                snap = best.copy()
                need = r & ~(lb2 > np.fmin(best, seed))
                cols = np.arange(k * CHUNK, min(n_f, k * CHUNK + CHUNK))
                lane[w0 + np.arange(32)] += need * len(cols)
                if not need.any():
                    continue
                warp[w] += 1
                for col in cols:
                    c = cost[qs, col]
                    take = c < best
                    if not screen:
                        take |= np.isnan(c) & ~np.isnan(best)
                    take &= r
                    best = np.where(take, c, best)
                    best_i = np.where(take, col, best_i)
            if fin_d is None:
                fin_d, fin_i = best, best_i
            else:
                take = best < fin_d
                if not screen:
                    take |= np.isnan(best) & ~np.isnan(fin_d)
                fin_d = np.where(take, best, fin_d)
                fin_i = np.where(take, best_i, fin_i)
        out[qs] = fin_i
    return out, warp, lane, stage


@pytest.mark.parametrize("split", [1, 2])
@pytest.mark.parametrize("entry", ["dense", "repair"])
def test_counts_match_a_numpy_recount(entry, split):
    v, f = sphere(1024)
    rng = np.random.RandomState(15)
    q = np.vstack([patches(128, rng),
                   rng.randn(128, 3) * 0.4]).astype(np.float32)
    p, rec = operands(v, f, q)
    tail = entry == "repair"
    cull = mk.mxu_cull_operands(p, rec, tail)
    if entry == "dense":
        got = culled(p, rec, tail, split, cull=cull)
        want = recount(p, rec, cull, tail, split=split)
    else:
        ub, cert = mk.mxu_bound_plain(p, rec, TILE_F)
        got = culled(p, rec, tail, split, ub, cert, cull)
        got = (got[0],) + got[2:]
        want = recount(p, rec, cull, tail, mk.survivors(ub, cert, TILE_Q),
                       split)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("entry", ["dense", "repair"])
@pytest.mark.parametrize("tail", TAILS)
def test_culled_matches_pallas_mxu_under_tie_contract(tail, entry):
    v, f = small_body(seed=3)
    q = (np.random.RandomState(4).randn(96, 3) * 0.4).astype(np.float32)
    if tail:
        v, f, q = with_degenerate_faces(v, f, np.random.RandomState(5))
    kw = dict(tile_q=64, tile_f=128, assume_nondegenerate=not tail)
    if entry == "dense":
        ref = pc.closest_point_pallas_mxu(v, f, q, interpret=True, **kw)
        out = mk.closest_point_mxu_kernel(v, f, q, device="cpu", **kw)
    else:
        ref, ref_stats = pc.closest_point_pallas_mxu_repair(
            v, f, q, interpret=True, with_stats=True, **kw)
        out, stats = mk.closest_point_mxu_repair_kernel(
            v, f, q, device="cpu", with_stats=True, **kw)
        assert stats["screened"] == ref_stats["screened"]
    out = {k: x.numpy() for k, x in out.items()}
    assert assert_mxu_contract(ref, out, v, f, q) > 0.8


@pytest.mark.parametrize("tail", TAILS)
def test_records_hold_every_corner_and_the_reach(tail):
    v, f, _ = with_degenerate_faces(*small_body(seed=5),
                                    np.random.RandomState(5))
    f = f[:len(f) - 7]                        # a ragged last chunk
    p, rec = operands(v, f, np.zeros((1, 3), np.float32))
    recs = mk.mxu_chunk_records(rec, tail).double()
    r = rec.double()
    a = r[:, 9:12]
    chunk = torch.arange(f.shape[0]) // CHUNK
    for corner in (a, a + r[:, 0:3], a + r[:, 3:6]):
        off = (corner - recs[chunk, 0:3]).abs()
        assert bool((off <= recs[chunk, 4:7]).all())
        assert bool((off.norm(dim=1) <= recs[chunk, 3]).all())
        assert bool((corner.norm(dim=1) <= recs[chunk, 12]).all())
    assert torch.equal(recs[:, 8:11], a[::CHUNK])
    # the first 12 fields are row 1's records of the same triangles
    planes = rec[:, list(mk._FAST_COLS)].T.contiguous()[None]
    assert torch.equal(mk.mxu_chunk_records(rec, tail)[:, :12],
                       ck.cull_records(planes, "fast", tail)[0])
    flat = ~(rec[:, 22] > 0)
    assert bool(flat.any())
    # without the tail a degenerate face makes its chunk always needed
    always = torch.isinf(recs[:, 7])
    assert bool(always[torch.unique(torch.nonzero(flat)[:, 0] // CHUNK)]
                .all()) != tail


def test_chunk_records_are_cached_with_the_face_record(monkeypatch):
    monkeypatch.setattr(mk, "_MXU_CHUNK_CACHE", {})
    v, f = sphere(1024)
    p, rec = operands(v, f, np.zeros((64, 3), np.float32))
    rec = rec.clone()                          # not the staged record
    first = mk.mxu_cull_operands(p, rec, True)["records"]
    assert mk.mxu_cull_operands(p, rec, True)["records"] is first
    assert mk.mxu_cull_operands(p, rec, False)["records"] is not first
    rec[3, 9] += 1.0                           # an in-place change
    again = mk.mxu_cull_operands(p, rec, True)["records"]
    assert again is not first and not torch.equal(again, first)
    for i in range(mk._MXU_FACE_CACHE_MAX + 2):
        mk.mxu_cull_operands(p, rec.clone(), True)
    assert len(mk._MXU_CHUNK_CACHE) == mk._MXU_FACE_CACHE_MAX


def test_query_order_is_a_permutation_and_any_order_keeps_the_faces():
    v, f = sphere(1024)
    rng = np.random.RandomState(14)
    p, rec = operands(v, f, (rng.randn(200, 3) * 0.4).astype(np.float32))
    cull = mk.mxu_cull_operands(p, rec, False)
    order = cull["qorder"]
    assert order.dtype == torch.int32 and order.shape == (p.shape[0],)
    assert torch.equal(torch.sort(order.long()).values,
                       torch.arange(p.shape[0]))
    want = mk.mxu_faces_plain(p, rec, TILE_Q, TILE_F, False)
    gen = torch.Generator().manual_seed(0)
    shuffled = dict(cull, qorder=torch.randperm(
        p.shape[0], generator=gen).to(torch.int32))
    for c in (cull, shuffled):
        assert torch.equal(culled(p, rec, False, cull=c)[0], want)


def test_split_follows_the_query_count():
    assert mk.mxu_split(65536) == mk.SPLIT_WARPS * 32 // 65536
    assert mk.mxu_split(4096) == mk.MAX_SPLIT
    assert mk.mxu_split(64) == mk.MAX_SPLIT
    for n in (32, 256, 4096, 16384, 65536):
        split = mk.mxu_split(n)
        assert 1 <= split <= mk.MAX_SPLIT and split & (split - 1) == 0
        assert split == mk.MAX_SPLIT or split * n // 32 >= mk.SPLIT_WARPS


def test_wrappers_route_and_check_operands():
    v, f = sphere(1024)
    q = (np.random.RandomState(17).randn(100, 3) * 0.4).astype(np.float32)
    p, rec = operands(v, f, q)
    before = dict(mk.LAUNCHES)
    cull = mk.mxu_cull_operands(p, rec, True)
    plain = mk.mxu_faces_plain(p, rec, TILE_Q, TILE_F)
    assert torch.equal(mk.mxu_faces(p, rec, TILE_Q, TILE_F), plain)
    assert torch.equal(mk.mxu_faces_every(p, rec, TILE_Q, TILE_F), plain)
    stats = mk.mxu_faces(p, rec, TILE_Q, TILE_F, cull=cull, split=2,
                         with_stats=True)
    want = mk.mxu_faces_culled_plain(p, rec, cull, TILE_Q, TILE_F, True, 2)
    assert all(torch.equal(g, w) for g, w in zip(stats, want))
    ub, cert = mk.mxu_bound(p, rec, TILE_F)
    every = mk.mxu_repair_every(p, rec, ub, cert, TILE_Q, TILE_F)
    got = mk.mxu_repair(p, rec, ub, cert, TILE_Q, TILE_F)
    assert len(got) == 2 and all(torch.equal(g, w)
                                 for g, w in zip(got, every))
    stats = mk.mxu_repair(p, rec, ub, cert, TILE_Q, TILE_F, cull=cull,
                          with_stats=True)
    assert len(stats) == 5 and torch.equal(stats[0], every[0])
    assert mk.LAUNCHES == before
    with pytest.raises(ValueError, match="tail"):
        mk.mxu_faces(p, rec, TILE_Q, TILE_F, False, cull=cull)
    with pytest.raises(ValueError, match="qorder"):
        mk.mxu_faces(p, rec, TILE_Q, TILE_F, cull=dict(
            cull, qorder=cull["qorder"].long()))
    with pytest.raises(ValueError, match="split"):
        mk.mxu_faces(p, rec, TILE_Q, TILE_F, cull=cull,
                     split=mk.MAX_SPLIT + 1)
    with pytest.raises(ValueError, match="multiple"):
        mk.mxu_repair(p, rec, ub, mk.mxu_bound_plain(p, rec, 100)[1],
                      TILE_Q, 100)
    for name, entry, n_ptr, n_int in (
            ("mxu_faces", "mt_mxu_faces", 11, 5),
            ("mxu_repair", "mt_mxu_repair", 12, 6),
            ("mxu_faces_every", "mt_mxu_faces_every", 3, 5),
            ("mxu_repair_every", "mt_mxu_repair_every", 6, 5)):
        _, got_entry, types = _build.KERNELS[name]
        assert got_entry == entry
        assert (types.count(_build._PTR), types.count(_build._INT)) == (
            n_ptr, n_int)
    # the warps vote, stage and wait on their own: no block barrier
    text = open(os.path.join(_build._CSRC, "mxu_cull.cuh")).read()
    code = "\n".join(line.split("//")[0] for line in text.splitlines())
    assert "__any_sync" in code and "cp_async_wait" in code
    assert "__syncthreads" not in code


@pytest.mark.parametrize("tool", ["ab_mxu.py", "mxu_cull_counts.py"])
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
