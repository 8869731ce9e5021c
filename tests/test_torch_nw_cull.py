"""The chunk cull of ``normal_weighted_faces`` (``normal_weighted.
argmin_normal_weighted`` on the card, its plain version
``argmin_normal_weighted_culled_plain`` and the operands of
``normal_weighted_cull_operands``) on the CPU.

The culled design must give exactly the every-face
``argmin_normal_weighted_plain``'s faces, with and without the degenerate
tail, at every split, on scan points with noisy normals, N(0, 0.4) queries,
far queries, a body with degenerate and collinear faces and ties across
chunk boundaries; mesh_tpu's ``nearest_normal_weighted_pallas`` under the
tie contract; and counts that follow its own definition (a numpy recount
below).  Planted traps (query normals of norm 3 and 0, eps below and at 0,
NaN points and normals, a face with a zero normal) keep the every-face
answers, and each makes a stated wrong copy of the bound give other faces.
The bound itself stays at or below every computed cost of its chunk.
"""

import ast
import os

import numpy as np
import pytest
import torch

from mesh_tpu.query.pallas_normal_weighted import (
    nearest_normal_weighted_pallas,
)

from mesh_tpu_torch import _build
from mesh_tpu_torch.geometry.tri_normals import normalize_rows
from mesh_tpu_torch.query import closest_kernel as ck
from mesh_tpu_torch.query import normal_weighted as nw

from .test_torch_closest import root_dir, small_body, with_degenerate_faces
from .test_torch_closest_cull import body
from .test_torch_normal_weighted import assert_nw_tie_contract

torch.set_num_threads(2)

CHUNK = ck.CULL_CHUNK
SPLITS = (1, 3)


def unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def operands(v, f, q, n):
    """(pts, normals, planes) of one mesh ``v`` with queries ``q`` and
    normals ``n`` [Q, 3], batched as [1, ...]."""
    pts, nrm, planes, _, _ = nw.normal_weighted_operands(
        torch.from_numpy(np.ascontiguousarray(v, np.float32))[None],
        torch.from_numpy(np.asarray(f, np.int64)),
        torch.from_numpy(np.ascontiguousarray(q, np.float32))[None],
        torch.from_numpy(np.ascontiguousarray(n, np.float32))[None])
    return pts, nrm, planes


def surface_set(rng, v, f, n_q=256, noise=0.1, scan=0.005):
    """Scan points on random faces with their face's unit normal perturbed
    by N(0, noise) and renormalized (chip_smoke.registration_inputs)."""
    pick = rng.randint(0, f.shape[0], n_q)
    w = rng.dirichlet([1.0, 1.0, 1.0], n_q)
    tri = v[f[pick]].astype(np.float64)
    q = np.einsum("qk,qkd->qd", w, tri) + rng.randn(n_q, 3) * scan
    fn = unit(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]))
    return q, unit(fn + rng.randn(n_q, 3) * noise)


def randn_set(rng, n_q=256):
    return rng.randn(n_q, 3) * 0.4, unit(rng.randn(n_q, 3))


def far_set(rng, v, n_q=128):
    """chip_smoke.far_queries's recipe: random directions from the vertex
    mean at 10 to 100 times the mesh's radius, random unit normals."""
    mean = v.mean(0)
    radius = np.linalg.norm(v - mean, axis=1).max()
    d = unit(rng.randn(n_q, 3)) * rng.uniform(10, 100, (n_q, 1)) * radius
    return d + mean, unit(rng.randn(n_q, 3))


def ties_set(rng):
    """Copies of one face straddling chunk boundaries (faces 31, 32, 63,
    64 and 95 one triangle), queried near it with its normal."""
    v, f = body(seed=5, n_seg=24, n_ring=16)
    f = f.copy()
    for i in (32, 63, 64, 95):
        f[i] = f[31]
    tri = v[f[31]].astype(np.float64)
    q = rng.dirichlet([1.0, 1.0, 1.0], 64) @ tri + rng.randn(64, 3) * 1e-3
    fn = unit(np.cross(tri[1] - tri[0], tri[2] - tri[0]))
    return v, f, q, unit(fn + rng.randn(64, 3) * 0.05)


def make_set(name, seed):
    rng = np.random.RandomState(seed)
    if name == "ties":
        return ties_set(rng)
    if name == "degenerate":
        v, f, q = with_degenerate_faces(*body(seed=seed, n_seg=24,
                                              n_ring=16), rng, n=32)
        return v, f, q, unit(rng.randn(q.shape[0], 3))
    v, f = body(seed=seed, n_seg=32, n_ring=24)
    if name == "surface":
        q, n = surface_set(rng, v, f, 2048)
    elif name == "randn":
        q, n = randn_set(rng)
    else:
        q, n = far_set(rng, v)
    return v, f, q, n


def culled(pts, nrm, planes, eps, tail, split=1, cull=None):
    if cull is None:
        cull = nw.normal_weighted_cull_operands(pts, planes, tail)
    return nw.argmin_normal_weighted_culled_plain(pts, nrm, planes, cull,
                                                  eps, tail, split)


def every(pts, nrm, planes, eps, tail):
    return nw.argmin_normal_weighted_plain(pts, nrm, planes, eps, tail)


def assert_same_faces(pts, nrm, planes, eps, tail, splits=SPLITS):
    want = every(pts, nrm, planes, eps, tail)
    cull = nw.normal_weighted_cull_operands(pts, planes, tail)
    for split in splits:
        got = culled(pts, nrm, planes, eps, tail, split, cull)[0]
        assert torch.equal(got, want), (split, int((got != want).sum()))
    return want


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("name", ["surface", "randn", "far", "degenerate",
                                  "ties"])
def test_culled_plain_equals_every_face(name, tail):
    v, f, q, n = make_set(name, seed=1)
    pts, nrm, planes = operands(v, f, q, n)
    for eps in (0.1, 1.0):
        assert_same_faces(pts, nrm, planes, eps, tail)
    if name == "surface":
        # the cull skips most chunks on scan points, and the counts are
        # consistent
        _, warp, lane, stage = culled(pts, nrm, planes, 0.1, tail)
        n_c = -(-f.shape[0] // CHUNK)
        assert float(warp.float().mean()) < 0.5 * n_c
        assert bool((warp <= stage).all()) and int(stage.max()) <= n_c
        assert int(lane.max()) <= f.shape[0]
    if name == "ties":
        got = every(pts, nrm, planes, 0.1, tail)
        assert bool((got == 31).any())
        assert not bool(torch.isin(got, torch.tensor([32, 63, 64, 95]))
                        .any())


def chunk_min_costs(pts, nrm, planes, eps, tail):
    """[B, Q, C] least computed cost over each chunk's faces (NaN kept)."""
    rows = [planes[:, k, None, :] for k in range(nw.N_NW_ROWS)]
    cost = nw._nw_cost_tile(pts[..., 0:1], pts[..., 1:2], pts[..., 2:3],
                            nrm[..., 0:1], nrm[..., 1:2], nrm[..., 2:3],
                            rows, eps, tail)
    n_b, n_q, n_f = cost.shape
    pad = -n_f % CHUNK
    cost = torch.cat([cost, cost[..., -1:].expand(n_b, n_q, pad)], -1)
    return cost.reshape(n_b, n_q, -1, CHUNK).amin(dim=-1)


def chunk_bounds(pts, nrm, cull, eps):
    """[B, Q, C] the kernel's bound of each query to each chunk's costs."""
    lb2 = ck._cull_lb2(pts[..., 0, None], pts[..., 1, None],
                       pts[..., 2, None], cull["records"][:, None])
    plo = nw.penalty_floor(nrm, cull["normal_bound"], eps)
    return nw._nw_bound(lb2, plo[..., None])


@pytest.mark.parametrize("eps", [0.1, -0.1, 0.0, 3.0])
def test_bound_stays_below_every_cost(eps):
    """On scan points, N(0, 0.4) and far queries, with unit normals and
    normals of norm 3, 0 and 1e-23 (whose squares underflow), the bound
    never exceeds a computed cost of its chunk."""
    rng = np.random.RandomState(7)
    v, f = body(seed=7, n_seg=24, n_ring=16)
    qs, ns = zip(surface_set(rng, v, f, 96), randn_set(rng, 96),
                 far_set(rng, v, 64))
    q, n = np.vstack(qs), np.vstack(ns)
    scale = np.repeat([1.0, 3.0, 0.0, 1e-23], -(-q.shape[0] // 4))
    n = n * scale[:q.shape[0], None]
    for tail in (False, True):
        pts, nrm, planes = operands(v, f, q, n)
        cull = nw.normal_weighted_cull_operands(pts, planes, tail)
        low = chunk_min_costs(pts, nrm, planes, eps, tail)
        assert not bool((low < chunk_bounds(pts, nrm, cull, eps)).any())
        assert_same_faces(pts, nrm, planes, eps, tail)


def test_normal_bounds_cover_underflowing_normals():
    """normalize_rows leaves |n_tri| up to about 1.58 where the cross
    product's squares underflow; the mesh's bound covers it, a zero normal
    and the ordinary ones, and keeps a NaN."""
    rng = np.random.RandomState(9)
    tiny = torch.tensor(rng.uniform(1e-23, 6e-23, (4096, 3)),
                        dtype=torch.float32)
    rows = torch.cat([normalize_rows(tiny),
                      normalize_rows(torch.randn(512, 3)),
                      torch.zeros(3, 3)])
    planes = torch.zeros(1, nw.N_NW_ROWS, rows.shape[0])
    planes[0, nw.N_FACE_ROWS:] = rows.T
    norms = rows.double().norm(dim=-1)
    assert float(norms.max()) > 1.5
    bound = nw.normal_bounds(planes)
    assert bound.dtype == torch.float32 and bound.shape == (1,)
    assert float(bound[0]) >= float(norms.max())
    assert float(bound[0]) <= float(norms.max()) * (1 + 2 ** -16)
    planes[0, nw.N_FACE_ROWS, 7] = float("nan")
    assert bool(torch.isnan(nw.normal_bounds(planes)).all())


def test_penalty_floor_is_exact_for_zero_normals():
    """n_p = 0: every computed penalty is eps, and so is the floor."""
    nrm = torch.zeros(1, 5, 3)
    bound = torch.tensor([1.0000001])
    for eps in (0.1, -0.1, 0.0, 2.5):
        plo = nw.penalty_floor(nrm, bound, eps)
        assert torch.equal(plo, torch.full_like(plo, np.float32(eps)))


def trap(kind):
    """(v, f, q, n, eps, tail) of one planted trap on a small body's scan
    points: normals of norm 3 with eps = 0.1 (the penalty reaches -2 eps),
    eps = -0.1, eps = 0 with far queries, zero normals with eps = -0.1, NaN
    points and normals among ordinary lanes, and a zero-area face (an exact
    zero normal) with the degenerate tail."""
    rng = np.random.RandomState(11)
    v, f = body(seed=11, n_seg=24, n_ring=16)
    q, n = surface_set(rng, v, f, 192, noise=0.6)
    eps, tail = 0.1, False
    if kind == "norm3":
        n = n * 3.0
    elif kind == "eps_neg":
        eps = -0.1
    elif kind == "eps_zero":
        q, n = far_set(rng, v, 192)
        eps = 0.0
    elif kind == "zero_normal":
        n = n * 0.0
        eps = -0.1
    elif kind == "nan":
        # dense scan points, so that a warp's lanes lie close together
        q, n = surface_set(rng, v, f, 1024)
        q[5::97, 1] = np.nan
        n[17::101, 2] = np.nan
    elif kind == "zero_face":
        k = f.shape[0] // 2
        v = np.vstack([v, v[f[k, 0]]])
        f = np.vstack([f, [[f[k, 0], f[k, 1], v.shape[0] - 1]]])
        tail = True
    return v, f.astype(np.int32), q, n, eps, tail


#: the wrong copy of the bound each trap defeats (named in the test id)
WRONG = {
    "norm3": "distance_only",       # P_lo = 0, as if the penalty were >= 0
    "eps_neg": "eps_pos_form",      # x = +hi whatever eps's sign
    "eps_zero": "squared",          # row 1's squared bound against the cost
    "zero_normal": "distance_only",   # every penalty is eps < 0
    "nan": "nan_skips",             # a NaN bound read as a skip
    "zero_face": "least_norm",      # the mesh's bound over the least norm
}


def wrong_copy(monkeypatch, kind):
    floor = nw.penalty_floor
    if kind == "distance_only":
        monkeypatch.setattr(nw, "penalty_floor",
                            lambda n, b, e: torch.zeros_like(n[..., 0]))
    elif kind == "eps_pos_form":
        monkeypatch.setattr(nw, "penalty_floor",
                            lambda n, b, e: floor(n, b, abs(e)) * (
                                e / abs(e) if e else 0.0))
    elif kind == "squared":
        monkeypatch.setattr(nw, "_nw_bound", lambda lb2, plo: lb2 + plo)
    elif kind == "nan_skips":
        monkeypatch.setattr(nw, "_needed", lambda lb, thr: lb <= thr)
    elif kind == "least_norm":
        def least(planes):
            tx, ty, tz = planes[:, nw.N_FACE_ROWS:nw.N_NW_ROWS].unbind(1)
            return torch.sqrt(tx * tx + ty * ty + tz * tz).amin(-1)
        monkeypatch.setattr(nw, "normal_bounds", least)


@pytest.mark.parametrize("kind", sorted(WRONG))
def test_planted_traps_keep_every_answer(kind, monkeypatch):
    v, f, q, n, eps, tail = trap(kind)
    pts, nrm, planes = operands(v, f, q, n)
    want = assert_same_faces(pts, nrm, planes, eps, tail)
    if kind == "zero_face":
        tn = planes[0, nw.N_FACE_ROWS:, -1]
        assert bool((tn == 0).all())            # normalize_rows' zero
    wrong_copy(monkeypatch, WRONG[kind])
    got = culled(pts, nrm, planes, eps, tail)[0]
    assert not torch.equal(got, want), WRONG[kind]


def test_eps_pos_form_is_the_true_floor_for_positive_eps():
    """The wrong copy of the eps < 0 traps is the right floor for eps >= 0:
    it is the same function there."""
    nrm = torch.randn(1, 40, 3)
    bound = torch.tensor([1.0000001])
    for eps in (0.1, 0.0, 2.0):
        a = nw.penalty_floor(nrm, bound, eps)
        b = nw.penalty_floor(nrm, bound, abs(eps))
        assert torch.equal(a, b)


def test_nan_lanes_need_every_chunk():
    """A NaN point or normal makes its lane's bound NaN: the lane needs
    every chunk, and the plain fold names its first NaN face, face 0."""
    v, f, q, n, eps, tail = trap("nan")
    pts, nrm, planes = operands(v, f, q, n)
    cull = nw.normal_weighted_cull_operands(pts, planes, tail)
    faces, _, lane, _ = culled(pts, nrm, planes, eps, tail, cull=cull)
    bad = torch.isnan(pts[0]).any(-1) | torch.isnan(nrm[0]).any(-1)
    assert int(bad.sum()) >= 8
    assert bool((faces[0, bad] == 0).all())
    pos = torch.argsort(cull["qorder"][0].long())      # query -> lane
    assert bool((lane[0, pos[bad]] == f.shape[0]).all())


def test_records_of_22_rows_equal_those_of_19():
    v, f, q, n = make_set("degenerate", seed=3)
    pts, nrm, planes = operands(v, f, q, n)
    for tail in (False, True):
        whole = ck.cull_records(planes, "fast", tail)
        first = ck.cull_records(planes[:, :ck.N_FACE_ROWS].contiguous(),
                                "fast", tail)
        assert torch.equal(whole, first)
        assert torch.equal(whole, nw.normal_weighted_cull_operands(
            pts, planes, tail)["records"])
    # the normal rows are not read: NaN there changes no record
    spoiled = planes.clone()
    spoiled[:, ck.N_FACE_ROWS:] = float("nan")
    assert torch.equal(ck.cull_records(spoiled, "fast", True),
                       ck.cull_records(planes, "fast", True))
    with pytest.raises(ValueError, match="R >= 19"):
        ck.cull_records(planes[:, :18].contiguous())


def recount(pts, nrm, planes, cull, eps, tail, split):
    """The cull's faces and counts by a lane-by-lane numpy walk over the
    every-pair costs (csrc/closest_cull.cuh over NormalWeightedCost): warps
    of 32 sorted queries, each split's chunks of 32 faces in order, each
    warp's vote one chunk ahead, the splits merged in order."""
    rows = [planes[:, k, None, :] for k in range(nw.N_NW_ROWS)]
    cost = nw._nw_cost_tile(pts[..., 0:1], pts[..., 1:2], pts[..., 2:3],
                            nrm[..., 0:1], nrm[..., 1:2], nrm[..., 2:3],
                            rows, eps, tail).numpy()
    bound = chunk_bounds(pts, nrm, cull, eps).numpy()
    reps = cull["records"][..., 8:11].numpy()
    n_b, n_q, n_f = cost.shape
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
            seed = cost[b, qs, fs]
            parts = []
            for s in range(split):
                best = np.full(len(qs), np.inf, np.float32)
                best_i = np.zeros(len(qs), np.int64)
                snap = best.copy()
                for k in range(n_c * s // split, n_c * (s + 1) // split):
                    lb = bound[b, qs, k]
                    if not np.any(~(lb > np.fmin(snap, seed))):
                        continue
                    stage[b, w0 // 32] += 1
                    snap = best.copy()
                    need = ~(lb > np.fmin(best, seed))
                    cols = np.arange(k * 32, min(n_f, k * 32 + 32))
                    lane[b, w0 + np.arange(len(qs))] += need * len(cols)
                    if not need.any():
                        continue
                    warp[b, w0 // 32] += 1
                    for j in range(len(qs)):
                        for col in cols:
                            c = cost[b, qs[j], col]
                            if c < best[j] or (np.isnan(c)
                                               and not np.isnan(best[j])):
                                best[j], best_i[j] = c, col
                parts.append((best, best_i))
            best, best_i = parts[0]
            for dd, ii in parts[1:]:
                take = (dd < best) | (np.isnan(dd) & ~np.isnan(best))
                best, best_i = np.where(take, dd, best), np.where(take, ii,
                                                                  best_i)
            out[b, qs] = best_i
    return out, warp, lane, stage


@pytest.mark.parametrize("split", [1, 3])
def test_counts_match_a_numpy_recount(split):
    rng = np.random.RandomState(15)
    v, f = small_body(seed=15, n_seg=24, n_ring=16)
    q, n = surface_set(rng, v, f, 96, noise=0.3)
    q[40] = np.nan
    pts, nrm, planes = operands(v, f, q, n)
    cull = nw.normal_weighted_cull_operands(pts, planes, True)
    got = culled(pts, nrm, planes, 0.1, True, split, cull)
    want = recount(pts, nrm, planes, cull, 0.1, True, split)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert torch.equal(got[0], every(pts, nrm, planes, 0.1, True))


@pytest.mark.parametrize("tail", [False, True])
def test_culled_matches_pallas_under_tie_contract(tail):
    v, f = small_body(seed=3)
    rng = np.random.RandomState(4)
    q, n = surface_set(rng, v, f, 64)
    q, n = np.vstack([q, rng.randn(32, 3) * 0.4]), np.vstack(
        [n, unit(rng.randn(32, 3))])
    q, n = q.astype(np.float32), n.astype(np.float32)
    if tail:
        # zero-area faces only: a collinear face's normal is rounding noise
        # in either package (tests/test_torch_normal_weighted.py)
        v, f, q = with_degenerate_faces(v, f, np.random.RandomState(5))
        f = f[:-8]
        n = unit(rng.randn(q.shape[0], 3)).astype(np.float32)
    ref_f, ref_p = nearest_normal_weighted_pallas(
        v, f, q, n, eps=0.1, tile_q=32, tile_f=128, interpret=True,
        assume_nondegenerate=not tail)
    pts, nrm, planes, tri, center = nw.normal_weighted_operands(
        torch.from_numpy(v)[None], torch.from_numpy(f.astype(np.int64)),
        torch.from_numpy(q)[None], torch.from_numpy(n)[None])
    best = nw.argmin_normal_weighted(pts, nrm, planes, 0.1, tail,
                                     with_stats=True, split=2)[0]
    face, point = nw.normal_weighted_epilogue(best, tri, pts, center)
    assert assert_nw_tie_contract(ref_f, ref_p, face[0].numpy(),
                                  point[0].numpy(), v, f, q, n, 0.1) > 0.5


def test_wrappers_route_and_check_operands():
    v, f, q, n = make_set("surface", seed=17)
    pts, nrm, planes = operands(v, f, q[:40], n[:40])
    before = dict(nw.LAUNCHES)
    plain = nw.argmin_normal_weighted_plain(pts, nrm, planes)
    assert torch.equal(nw.argmin_normal_weighted(pts, nrm, planes), plain)
    assert torch.equal(nw.argmin_normal_weighted_every(pts, nrm, planes),
                       plain)
    cull = nw.normal_weighted_cull_operands(pts, planes)
    for split in (1, 4):
        stats = nw.argmin_normal_weighted(pts, nrm, planes, with_stats=True,
                                          split=split)
        for g, w in zip(stats, nw.argmin_normal_weighted_culled_plain(
                pts, nrm, planes, cull, split=split)):
            assert torch.equal(g, w)
    assert nw.LAUNCHES == before
    assert set(nw.LAUNCHES) == {"normal_weighted_faces",
                                "normal_weighted_faces_every"}
    with pytest.raises(ValueError, match="tail"):
        nw.argmin_normal_weighted(pts, nrm, planes, degenerate_tail=False,
                                  cull=cull, with_stats=True)
    with pytest.raises(ValueError, match="qorder"):
        nw.argmin_normal_weighted(pts, nrm, planes, cull=dict(
            cull, qorder=cull["qorder"].long()), with_stats=True)
    with pytest.raises(ValueError, match="normal_bound"):
        nw.argmin_normal_weighted(pts, nrm, planes, cull=dict(
            cull, normal_bound=cull["normal_bound"][None]), with_stats=True)
    for split in (0, nw.NW_MAX_SPLIT + 1):
        with pytest.raises(ValueError, match="split"):
            nw.argmin_normal_weighted(pts, nrm, planes, split=split)
    with pytest.raises(ValueError):
        nw.argmin_normal_weighted_every(pts, nrm,
                                        planes[:, :19].contiguous())
    for name, entry, n_ptr in (
            ("normal_weighted_faces", "mt_normal_weighted_faces", 13),
            ("normal_weighted_faces_every",
             "mt_normal_weighted_faces_every", 4)):
        source, got_entry, types = _build.KERNELS[name]
        assert source == name + ".cu" and got_entry == entry
        assert types.count(_build._PTR) == n_ptr
    # the cull is closest_cull.cuh's loop over the shared functor
    text = open(os.path.join(_build._CSRC, "normal_weighted_faces.cu")).read()
    assert "closest_cull_kernel<Cost, mt::ExactFold>" in text
    assert '#include "nw_cost.cuh"' in text


@pytest.mark.parametrize("tool", ["ab_nw.py", "cull_counts.py"])
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
