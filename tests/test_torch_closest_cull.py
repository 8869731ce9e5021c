"""The chunk cull of ``closest_faces`` (``closest_kernel.argmin_faces`` on
the card, its plain version ``argmin_faces_culled_plain`` and the operands
of ``cull_operands``) on the CPU.

The culled design must give exactly the every-face ``argmin_faces_plain``'s
faces, in both tiles, with and without the degenerate tail, for both
reductions, on any query order; mesh_tpu's ``closest_point_pallas`` under
the tie contract (as tests/test_torch_closest.py runs it); and counts that
follow its own definition (a numpy recount below).  The chunk bound with
its rounding terms must stay at or below every computed cost of the
chunk's faces, including long slivers whose fast-tile edge forms cancel
and queries at 10-100x the mesh's radius; planted NaN and inf corners,
exact ties across chunk boundaries and all-inf fused costs keep the
every-face answers.
"""

import ast
import os

import numpy as np
import pytest
import torch

from mesh_tpu.query.pallas_closest import closest_point_pallas

from mesh_tpu_torch import _build
from mesh_tpu_torch.models.body_model import _uv_sphere
from mesh_tpu_torch.query import closest_kernel as ck

from .test_torch_closest import (
    _np,
    assert_tie_contract,
    root_dir,
    small_body,
    with_degenerate_faces,
)

torch.set_num_threads(2)

VARIANTS = [("fast", False), ("fast", True), ("safe", False), ("safe", True)]
REDUCTIONS = ("exact", "fused")
CHUNK = ck.CULL_CHUNK

#: the fused reduction's face tile in these tests: small, so that chunks
#: and tiles interleave
TILE_F = 64


def body(seed=0, n_seg=48, n_ring=32):
    """A body-proportioned UV sphere of a few thousand faces, float32."""
    v, f = _uv_sphere(n_seg, n_ring)
    rng = np.random.RandomState(seed)
    v = v * np.array([0.3, 0.2, 0.9]) + rng.randn(*v.shape) * 0.005
    return v.astype(np.float32), f.astype(np.int32)


def operands(v, f, q, variant):
    """(pts, planes) of the batch ``v`` [B, V, 3] / ``q`` [B, Q, 3]."""
    pts, planes, _, _ = ck.closest_point_operands(
        torch.from_numpy(np.ascontiguousarray(v, np.float32)),
        torch.from_numpy(f),
        torch.from_numpy(np.ascontiguousarray(q, np.float32)), variant)
    return pts, planes


def posed_batch(n_b=2, n_q=300, seed=0):
    """Two jittered bodies with main-path queries (randn * 0.4)."""
    v, f = body(seed)
    rng = np.random.RandomState(seed + 1)
    vb = np.stack([v * (1.0 + 0.05 * rng.randn(3)) for _ in range(n_b)])
    return vb, f, rng.randn(n_b, n_q, 3) * 0.4


def culled(pts, planes, variant, tail, reduction, cull=None):
    if cull is None:
        cull = ck.cull_operands(pts, planes, variant, tail)
    return ck.argmin_faces_culled_plain(pts, planes, cull, variant, tail,
                                        reduction, TILE_F)


def every(pts, planes, variant, tail, reduction):
    return ck.argmin_faces_plain(pts, planes, variant, tail, reduction,
                                 TILE_F)


def assert_same_faces(pts, planes, variant, tail, cull=None):
    for reduction in REDUCTIONS:
        got = culled(pts, planes, variant, tail, reduction, cull)[0]
        want = every(pts, planes, variant, tail, reduction)
        assert torch.equal(got, want), (reduction, int((got != want).sum()))


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("variant,tail", VARIANTS)
def test_culled_plain_equals_every_face(variant, tail, reduction):
    vb, f, q = posed_batch()
    pts, planes = operands(vb, f, q, variant)
    got, warp, lane, stage = culled(pts, planes, variant, tail, reduction)
    assert torch.equal(got, every(pts, planes, variant, tail, reduction))
    n_c = -(-f.shape[0] // CHUNK)
    # the cull skips chunks, and the counts are consistent
    assert 0 < float(warp.float().mean()) < 0.6 * n_c
    assert bool((warp <= stage).all()) and int(stage.max()) <= n_c
    assert int(lane.max()) <= f.shape[0]


def chunk_min_costs(pts, planes, variant, tail):
    """[B, Q, C] least computed cost over each chunk's faces."""
    tile = {"fast": ck._sqdist_tile_fast, "safe": ck._sqdist_tile_safe}[
        variant]
    cost = tile(pts[..., 0:1], pts[..., 1:2], pts[..., 2:3],
                *[planes[:, k, None, :] for k in range(ck.N_FACE_ROWS)],
                degenerate_tail=tail)
    n_b, n_q, n_f = cost.shape
    pad = -n_f % CHUNK
    cost = torch.cat([cost, cost[..., -1:].expand(n_b, n_q, pad)], -1)
    return cost.reshape(n_b, n_q, -1, CHUNK).amin(dim=-1)


def chunk_bounds(pts, records):
    """[B, Q, C] the kernel's bound of each query to each chunk."""
    return ck._cull_lb2(pts[..., 0, None], pts[..., 1, None],
                        pts[..., 2, None], records[:, None])


def cancelling_slivers(rng, m=4, delta=1e-4, rho=1e-3):
    """A body behind chunks of 32 copies of an axis-aligned sliver (a, a +
    (2, 0, 0), that + (0, w, 0)), each followed by a chunk of 32 copies of
    a small triangle delta / 2 below the query a + (1, 0, delta).  The fast
    tile's edge form ap2 - d1^2 inv_ab2 cancels there to 0, below the
    sliver chunk's box bound (0.998 delta^2); the small triangle's corner a
    is the query's nearest representative, so its cost, delta^2 / 4, seeds
    the lane.  Without the bound's rounding terms the sliver's chunk is
    skipped and the answer changes (the m queries share one warp, whose
    other lanes need no sliver chunk either)."""
    v, f = small_body(seed=7)
    a = np.stack([rng.uniform(-0.3, 0.3, m), rng.uniform(-0.2, 0.2, m),
                  rng.uniform(-0.9, 0.9, m)], 1)
    w = 10.0 ** rng.uniform(-4, -2, m)
    b = a + np.array([2.0, 0.0, 0.0])
    c = b + w[:, None] * np.array([0.0, 1.0, 0.0])
    p = a + np.array([1.0, 0.0, delta])
    a2 = p + np.array([-rho, -rho, -delta / 2])
    corners = [a, b, c, a2, a2 + [2 * rho, 0, 0], a2 + [0, 2 * rho, 0]]
    base = v.shape[0] + m * np.arange(6)
    faces = []
    for i in range(m):
        faces += [[base[0] + i, base[1] + i, base[2] + i]] * CHUNK
        faces += [[base[3] + i, base[4] + i, base[5] + i]] * CHUNK
    v2 = np.vstack([v] + corners).astype(np.float32)
    f2 = np.vstack([np.array(faces), f]).astype(np.int32)
    return v2, f2, p.astype(np.float32), m


def long_slivers(rng, n=96):
    """A body plus n long thin slivers (an edge of 2, width 1e-5 to 1e-2,
    the short edge bc), with queries at 10-100x the body's radius and near
    the middles of the long edges."""
    v, f = body(seed=3, n_seg=24, n_ring=16)
    a = rng.randn(n, 3) * 0.3
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    e = np.cross(d, rng.randn(n, 3))
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    b = a + 2.0 * d
    c = b + 10.0 ** rng.uniform(-5, -2, n)[:, None] * e
    base = v.shape[0] + n * np.arange(3)
    f2 = np.vstack([f, np.stack([base[0] + np.arange(n),
                                 base[1] + np.arange(n),
                                 base[2] + np.arange(n)], 1)])
    far = rng.randn(192, 3)
    far *= rng.uniform(10, 100, (192, 1)) / np.linalg.norm(far, axis=1,
                                                          keepdims=True)
    near = (a + b) / 2 + rng.randn(n, 3) * 1e-4
    return (np.vstack([v, a, b, c]).astype(np.float32), f2.astype(np.int32),
            np.vstack([far, near]).astype(np.float32))


@pytest.mark.parametrize("variant,tail", VARIANTS)
def test_slivers_and_far_queries_keep_every_answer(variant, tail):
    v, f, q = long_slivers(np.random.RandomState(2))
    pts, planes = operands(v[None], f, q[None], variant)
    cull = ck.cull_operands(pts, planes, variant, tail)
    assert_same_faces(pts, planes, variant, tail, cull)
    # the bound stays at or below every computed cost of its chunk
    bound = chunk_bounds(pts, cull["records"])
    low = chunk_min_costs(pts, planes, variant, tail)
    assert not bool((low < bound).any())


def adversarial_soup(rng):
    """A soup of a few hundred faces at a random scale and offset: random
    triangles, long slivers down to 1e-7 wide, nearly collinear faces, a
    fan of thin faces around a point, or chunks of 32 near-copies of one
    axis-aligned sliver (whose box hugs it, so the fast tile's cancelling
    edge forms meet a tight bound); with queries near corners and edges, just off
    face planes, inside the bounding box and at up to 1e4 times its
    size."""
    n = rng.randint(2, 8) * CHUNK
    kind = rng.randint(5)
    a = rng.randn(n, 3)
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if kind == 0:
        b, c = rng.randn(n, 3), rng.randn(n, 3)
    elif kind == 1:
        e = np.cross(d, rng.randn(n, 3))
        e /= np.linalg.norm(e, axis=1, keepdims=True)
        length = 10.0 ** rng.uniform(-1, 1, (n, 1))
        b = a + length * d
        c = (a + rng.uniform(0, 1, (n, 1)) * length * d
             + 10.0 ** rng.uniform(-7, -1, (n, 1)) * e)
    elif kind == 2:
        b = a + d
        c = (a + rng.uniform(-1, 2, (n, 1)) * d
             + rng.randn(n, 3) * 10.0 ** rng.uniform(-9, -3))
    elif kind == 3:
        a = np.zeros((n, 3))
        ang = rng.uniform(0, 2 * np.pi, n)
        b = np.stack([np.cos(ang), np.sin(ang), rng.randn(n) * 0.01], 1)
        c = b + rng.randn(n, 3) * 10.0 ** rng.uniform(-6, 0, (n, 1))
    else:
        axes = np.array([rng.permutation(3)[:2] for _ in range(n // CHUNK)])
        d, e = (np.repeat(np.eye(3)[axes[:, i]], CHUNK, 0) for i in (0, 1))
        a = np.repeat(a[::CHUNK], CHUNK, 0)
        b = a + 2.0 * d
        c = b + np.repeat(10.0 ** rng.uniform(-4, -2, (n // CHUNK, 1)),
                          CHUNK, 0) * e
        a, b, c = (x + rng.randn(n, 3) * 1e-9 for x in (a, b, c))
    scale = 10.0 ** rng.uniform(-3, 3)
    tri = (np.stack([a, b, c], 1) * scale
           + rng.randn(3) * scale * 10.0 ** rng.uniform(-2, 2))
    v = tri.reshape(-1, 3)
    mid, size = v.mean(0), np.abs(v - v.mean(0)).max()
    i, j = rng.randint(0, v.shape[0], (2, 24))
    t = rng.uniform(0, 1, (24, 1))
    near = (v[i] * (1 - t) + v[j] * t
            + rng.randn(24, 3) * size * 10.0 ** rng.uniform(-8, -1, (24, 1)))
    far = rng.randn(24, 3)
    far *= size * 10.0 ** rng.uniform(0, 4, (24, 1)) / np.linalg.norm(
        far, axis=1, keepdims=True)
    k = rng.randint(0, n, 24)
    normal = np.cross(tri[k, 1] - tri[k, 0], tri[k, 2] - tri[k, 0])
    normal /= np.maximum(np.linalg.norm(normal, axis=1, keepdims=True),
                         1e-30)
    off = ((tri[k, 0] + tri[k, 1]) / 2 + normal
           * np.linalg.norm(tri[k, 1] - tri[k, 0], axis=1, keepdims=True)
           * 10.0 ** rng.uniform(-7, -2, (24, 1)))
    inside = mid + rng.uniform(-1, 1, (24, 3)) * size
    q = np.vstack([near, mid + far, off, inside])
    return (v.astype(np.float32), np.arange(3 * n).reshape(n, 3)
            .astype(np.int32), q.astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adversarial_soups_keep_the_bound_and_every_answer(seed):
    """Random soups of slivers and nearly degenerate faces at scales from
    1e-3 to 1e3, queried from 1e-8 to 1e4 times their size: the bound
    stays at or below every computed cost of its chunk, and the answers
    are the every-face ones, in every tile, with and without the tail."""
    rng = np.random.RandomState(100 + seed)
    for _ in range(6):
        v, f, q = adversarial_soup(rng)
        for variant, tail in VARIANTS:
            pts, planes = operands(v[None], f, q[None], variant)
            cull = ck.cull_operands(pts, planes, variant, tail)
            bound = chunk_bounds(pts, cull["records"])
            low = chunk_min_costs(pts, planes, variant, tail)
            assert not bool((low < bound).any())
            assert_same_faces(pts, planes, variant, tail, cull)


@pytest.mark.parametrize("variant,tail", VARIANTS)
def test_cancelling_edge_forms_need_the_rounding_terms(variant, tail):
    v, f, q, m = cancelling_slivers(np.random.RandomState(4))
    pts, planes = operands(v[None], f, q[None], variant)
    cull = ck.cull_operands(pts, planes, variant, tail)
    assert_same_faces(pts, planes, variant, tail, cull)
    bound = chunk_bounds(pts, cull["records"])
    low = chunk_min_costs(pts, planes, variant, tail)
    assert not bool((low < bound).any())
    if variant == "safe":
        return      # its residual forms do not cancel
    # without e1 and e2 the bound exceeds the sliver's computed cost, and
    # the cull skips the winner
    bare = dict(cull)
    bare["records"] = cull["records"].clone()
    bare["records"][..., 7] = 0.0
    bare["records"][..., 11] = 0.0
    bound = chunk_bounds(pts, bare["records"])
    assert bool((low < bound).any())
    want = every(pts, planes, variant, tail, "exact")
    assert int(want[0, 0]) < 2 * m * CHUNK
    got = culled(pts, planes, variant, tail, "exact", bare)[0]
    assert not torch.equal(got, want)


@pytest.mark.parametrize("variant", ["fast", "safe"])
def test_ties_across_chunk_boundaries(variant):
    """Copies of one face straddling chunk boundaries (faces 31, 32, 63,
    64 and 95 one triangle), queried near it: the lowest index wins the
    exact fold, the fused tie group its own rule; the culled design picks
    what the every-face one picks."""
    v, f = body(seed=5, n_seg=24, n_ring=16)
    f = f.copy()
    for i in (32, 63, 64, 95):
        f[i] = f[31]
    rng = np.random.RandomState(8)
    tri = v[f[31]].astype(np.float64)
    w = rng.dirichlet([1.0, 1.0, 1.0], 64)
    q = (w @ tri + rng.randn(64, 3) * 1e-3).astype(np.float32)
    for tail in (False, True):
        pts, planes = operands(v[None], f, q[None], variant)
        assert_same_faces(pts, planes, variant, tail)
        got = culled(pts, planes, variant, tail, "exact")[0]
        assert bool((got == 31).any())
        assert not bool(torch.isin(got, torch.tensor([32, 63, 64, 95]))
                        .any())


@pytest.mark.parametrize("variant,tail", VARIANTS)
def test_non_finite_planes_keep_every_answer(variant, tail):
    """NaN and inf planted in corner planes (corner a, and ab or b) of five
    faces and NaN in one query: the chunks holding those faces are always
    needed, and the answers stay the every-face ones."""
    v, f = body(seed=6, n_seg=24, n_ring=16)
    q = (np.random.RandomState(9).randn(1, 96, 3) * 0.4).astype(np.float32)
    pts, planes = operands(v[None], f, q, variant)
    planted = {(0, 5): float("nan"), (0, 300): float("nan"),
               (3, 50): float("inf"), (4, 600): float("-inf"),
               (7, 700): float("inf")}
    for (row, face), value in planted.items():
        planes[0, row, face] = value
    pts[0, 7, 1] = float("nan")
    cull = ck.cull_operands(pts, planes, variant, tail)
    assert_same_faces(pts, planes, variant, tail, cull)
    chunks = torch.tensor(sorted({face // CHUNK for _, face in planted}))
    assert bool(torch.isinf(cull["records"][0, chunks, 7]).all())


def test_fused_all_inf_costs_name_face_0():
    """Queries at 2e19: every cost +inf, every chunk past CULL_FAR and so
    needed; the fused fold names column 0, as the every-face one does."""
    v, f = body(seed=11, n_seg=24, n_ring=16)
    q = np.full((1, 40, 3), 2e19, np.float32)
    for variant, tail in VARIANTS:
        pts, planes = operands(v[None], f, q, variant)
        for tile_f in (32, 2048):
            got, warp, _, _ = ck.argmin_faces_culled_plain(
                pts, planes, ck.cull_operands(pts, planes, variant, tail),
                variant, tail, "fused", tile_f)
            assert got.tolist() == [[0] * 40]
            assert bool((warp == -(-f.shape[0] // CHUNK)).all())


def test_centre_queries_fold_more_chunks_than_surface_ones():
    """Queries at the body's centre lie close to no face: their warps fold
    many more chunks than warps of as many queries gathered on one spot of
    the surface, and both keep the every-face answers."""
    v, f = body(seed=12)
    rng = np.random.RandomState(13)
    centre = rng.randn(128, 3) * 0.01
    w = rng.dirichlet([1.0, 1.0, 1.0], 128)
    spot = (w @ v[f[500]].astype(np.float64)) + rng.randn(128, 3) * 0.01
    q = np.stack([centre, spot]).astype(np.float32)
    vb = np.stack([v, v])
    for variant, tail in VARIANTS:
        pts, planes = operands(vb, f, q, variant)
        assert_same_faces(pts, planes, variant, tail)
    warp = culled(pts, planes, "safe", True, "exact")[1]
    assert float(warp[0].float().mean()) > 2 * float(warp[1].float().mean())


@pytest.mark.parametrize("variant,tail", VARIANTS)
def test_culled_matches_pallas_under_tie_contract(variant, tail):
    v, f = small_body(seed=3)
    q = (np.random.RandomState(4).randn(96, 3) * 0.4).astype(np.float32)
    if tail:
        v, f, q = with_degenerate_faces(v, f, np.random.RandomState(5))
    ref = closest_point_pallas(v, f, q, tile_q=32, tile_f=128,
                               interpret=True, assume_nondegenerate=not tail,
                               tile_variant=variant)
    vt, ft = torch.from_numpy(v)[None], torch.from_numpy(f)
    pts, planes, tri, center = ck.closest_point_operands(
        vt, ft, torch.from_numpy(q)[None], variant)
    best = ck.argmin_faces(pts, planes, variant, tail, with_stats=True)[0]
    out = {k: x[0] for k, x in ck.winner_epilogue(best, tri, pts,
                                                  center).items()}
    assert assert_tie_contract(ref, _np(out), v, f, q) > 0.5


def test_query_order_is_a_permutation_and_any_order_keeps_the_faces():
    vb, f, q = posed_batch(n_q=200, seed=14)
    pts, planes = operands(vb, f, q, "fast")
    cull = ck.cull_operands(pts, planes, "fast", False)
    order = cull["qorder"]
    assert order.dtype == torch.int32
    assert torch.equal(torch.sort(order.long(), dim=1).values,
                       torch.arange(200).expand(2, 200))
    # neighbours in the order are close in space
    sorted_pts = torch.gather(pts, 1, order.long()[..., None].expand(
        2, 200, 3))
    step = (sorted_pts[:, 1:] - sorted_pts[:, :-1]).norm(dim=-1).mean()
    assert float(step) < 0.5 * float((pts[:, 1:] - pts[:, :-1]).norm(
        dim=-1).mean())
    want = every(pts, planes, "fast", False, "exact")
    gen = torch.Generator().manual_seed(0)
    shuffled = dict(cull, qorder=torch.stack([
        torch.randperm(200, generator=gen) for _ in range(2)]).to(
            torch.int32))
    for c in (cull, shuffled):
        got = culled(pts, planes, "fast", False, "exact", c)[0]
        assert torch.equal(got, want)


def recount(pts, planes, cull, variant, tail, reduction, tile_f=TILE_F):
    """The cull's faces and counts by a lane-by-lane numpy walk over the
    every-pair costs (csrc/closest_cull.cuh): warps of 32 sorted queries,
    chunks of 32 faces in order, each warp's vote one chunk ahead."""
    tile = {"fast": ck._sqdist_tile_fast, "safe": ck._sqdist_tile_safe}[
        variant]
    cost = tile(pts[..., 0:1], pts[..., 1:2], pts[..., 2:3],
                *[planes[:, k, None, :] for k in range(ck.N_FACE_ROWS)],
                degenerate_tail=tail).numpy()
    fused = reduction == "fused"
    mask = tile_f - 1
    n_b, n_q, n_f = cost.shape
    if fused:
        keys = ((cost.view(np.int32) & ~mask)
                | (np.arange(n_f, dtype=np.int32) & mask))
    bound = chunk_bounds(pts, cull["records"]).numpy()
    reps = cull["records"][..., 8:11].numpy()
    n_c = bound.shape[-1]
    out = np.zeros((n_b, n_q), np.int64)
    warp = np.zeros((n_b, -(-n_q // 32)), np.int64)
    stage = np.zeros_like(warp)
    lane = np.zeros((n_b, n_q), np.int64)
    for b in range(n_b):
        order = cull["qorder"][b].numpy().astype(np.int64)
        for w0 in range(0, n_q, 32):
            qs = order[w0:w0 + 32]
            d = ((pts[b, qs].numpy()[:, None] - reps[b][None]) ** 2).sum(-1)
            fs = np.argmin(np.where(np.isnan(d), np.inf, d), 1) * 32
            if fused:
                seed = keys[b, qs, fs].astype(np.int64)
                best = np.full(len(qs), 2 ** 31 - 1, np.int64)
            else:
                seed = cost[b, qs, fs]
                best = np.full(len(qs), np.inf, np.float32)
            best_i = np.zeros(len(qs), np.int64)

            def thr(state):
                if fused:
                    return (np.minimum(state, seed) | mask).astype(
                        np.int32).view(np.float32)
                return np.fmin(state, seed)

            snap = best.copy()
            for k in range(n_c):
                lb2 = bound[b, qs, k]
                if not np.any(~(lb2 > thr(snap))):
                    continue
                stage[b, w0 // 32] += 1
                snap = best.copy()
                need = ~(lb2 > thr(best))
                cols = np.arange(k * 32, min(n_f, k * 32 + 32))
                lane[b, w0 + np.arange(len(qs))] += need * len(cols)
                if not need.any():
                    continue
                warp[b, w0 // 32] += 1
                for j in range(len(qs)):
                    for col in cols:
                        c = (keys if fused else cost)[b, qs[j], col]
                        if c < best[j] or (not fused and np.isnan(c)
                                           and not np.isnan(best[j])):
                            best[j], best_i[j] = c, col
            if fused:
                best_i = (best_i & ~mask) + (best & mask)
            out[b, qs] = best_i
    return out, warp, lane, stage


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_counts_match_a_numpy_recount(reduction):
    vb, f, q = posed_batch(n_q=160, seed=15)
    vb, f = vb[:, :, :], f[:1000]
    pts, planes = operands(vb, f, q, "fast")
    cull = ck.cull_operands(pts, planes, "fast", True)
    got = culled(pts, planes, "fast", True, reduction, cull)
    want = recount(pts, planes, cull, "fast", True, reduction)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert torch.equal(got[0], every(pts, planes, "fast", True, reduction))


@pytest.mark.parametrize("variant", ["fast", "safe"])
def test_records_hold_every_corner(variant):
    vb, f, q = posed_batch(n_b=1, seed=16)
    f = f[:1000 - 7]                      # a ragged last chunk
    pts, planes = operands(vb, f, q, variant)
    recs = ck.cull_records(planes, variant, True)[0].double()
    rows = planes[0].double()
    a = rows[0:3]
    if variant == "fast":
        b, c = a + rows[3:6], a + rows[6:9]
    else:
        b, c = rows[3:6], rows[6:9]
    chunk = torch.arange(f.shape[0]) // CHUNK
    for corner in (a, b, c):
        off = (corner.T - recs[chunk, 0:3]).abs()
        assert bool((off <= recs[chunk, 4:7]).all())
        assert bool((off.norm(dim=1) <= recs[chunk, 3]).all())
    assert torch.equal(recs[:, 8:11], a[:, ::CHUNK].T)
    assert bool((recs[:, 7] > 0).all()) and bool((recs[:, 11] > 0).all())
    # without the tail a degenerate face makes its chunk always needed
    v2, f2, q2 = with_degenerate_faces(*small_body(seed=5),
                                       np.random.RandomState(5))
    pts2, planes2 = operands(v2[None], f2, q2[None], variant)
    flat = ~(planes2[0, 18] > 0)
    chunks = torch.unique(torch.nonzero(flat)[:, 0] // CHUNK)
    assert bool(torch.isinf(ck.cull_records(planes2, variant, False)[
        0, chunks, 7]).all())
    assert bool(torch.isfinite(ck.cull_records(planes2, variant, True)[
        0, :, 7]).all())


def test_wrappers_route_and_check_operands():
    vb, f, q = posed_batch(n_b=1, n_q=40, seed=17)
    pts, planes = operands(vb, f, q, "fast")
    before = dict(ck.LAUNCHES)
    plain = ck.argmin_faces_plain(pts, planes)
    assert torch.equal(ck.argmin_faces(pts, planes), plain)
    assert torch.equal(ck.argmin_faces_every(pts, planes), plain)
    stats = ck.argmin_faces(pts, planes, with_stats=True)
    cull = ck.cull_operands(pts, planes)
    for g, w in zip(stats, ck.argmin_faces_culled_plain(pts, planes, cull)):
        assert torch.equal(g, w)
    assert ck.LAUNCHES == before
    with pytest.raises(ValueError, match="made for"):
        ck.argmin_faces(pts, planes, "safe", cull=cull, with_stats=True)
    with pytest.raises(ValueError, match="qorder"):
        ck.argmin_faces(pts, planes, cull=dict(
            cull, qorder=cull["qorder"].long()), with_stats=True)
    for name, entry, n_ptr in (("closest_faces", "mt_closest_faces", 8),
                               ("closest_faces_every",
                                "mt_closest_faces_every", 3)):
        source, got_entry, types = _build.KERNELS[name]
        assert got_entry == entry and types.count(_build._PTR) == n_ptr
    # the warps vote, stage and wait on their own: no block barrier
    text = open(os.path.join(_build._CSRC, "closest_cull.cuh")).read()
    code = "\n".join(line.split("//")[0] for line in text.splitlines())
    assert "__any_sync" in code and "cp_async_wait" in code
    assert "__syncthreads" not in code


@pytest.mark.parametrize("tool", ["ab_closest.py", "cull_counts.py"])
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
