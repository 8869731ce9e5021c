"""The chunk cull of the MXU rung's bf16 bound pass (``mxu_kernel
.mxu_bound_culled`` on the card, the plain version of its design
``mxu_bound_culled_plain``, and the bound pass's columns of
``mxu_chunk_records``) on the CPU.

The culled pass must meet its contract (csrc/mxu_bound_culled.cu) against
the every-face plain version ``mxu_bound_plain``: ub equal bit for bit,
``survivors`` equal, cert equal wherever the every-face value is <=
sqrt(max(ub, 0)) (and on every row whose ub is NaN), and above it or NaN
with it elsewhere; at every split and tile width, on any query set.
Against mesh_tpu's bound kernel (interpret mode, as tests/test_torch_mxu.py
runs it) ub agrees within that file's rounding band, cert wherever it is
<= sqrt(ub), and the repaired tiles except at borderline margins.  Planted
traps each fail a stated wrong copy of the bound: corners 1000 from the
origin (the cert bound without its envelope term), a tile certified only
outside the ub radius (a cull on the ub test alone), a NaN a2 late in the
mesh (the chunk flag without the mesh's), NaN queries (NaN bounds read as
skips) and infinite reaches (the cert bound without the reach).
"""

import os

import numpy as np
import pytest
import torch

from mesh_tpu_torch import _build
from mesh_tpu_torch.query import mxu_kernel as mk

from .test_torch_closest import small_body, with_degenerate_faces
from .test_torch_mxu import BOUND_REL, TILES, _margins, case, jax_result
from .test_torch_mxu_cull import far, patches, sphere

torch.set_num_threads(2)

CHUNK = mk.CULL_CHUNK
TILE_Q = 64


def body_case(rng):
    v, f = small_body(seed=4, n_seg=24, n_ring=20)
    v, f, q = with_degenerate_faces(v, f, rng)
    return v, f, q


#: (mesh, queries) from a seed; the query counts are not multiples of the
#: tile, so the origin padding rows run too
SETS = {
    "surface": lambda rng: (*sphere(), patches(320, rng)[:300]),
    "randn": lambda rng: (*sphere(),
                          (rng.randn(300, 3) * 0.4).astype(np.float32)),
    "far": lambda rng: (*sphere(), far(200, rng)),
    "body": body_case,
}


def operands(v, f, q, tile_q=TILE_Q):
    p, rec, _, _, _ = mk.mxu_operands(v, f, q, tile_q, device="cpu")
    return p, rec


def assert_contract(got, want, tile_q=TILE_Q):
    """``got`` (ub, cert) meets the culled pass's contract against the
    every-face ``want``."""
    ub, cert = got[:2]
    ub0, cert0 = want
    assert torch.equal(torch.isnan(ub), torch.isnan(ub0))
    assert torch.equal(ub.nan_to_num(7.0), ub0.nan_to_num(7.0))
    assert torch.equal(ub.view(torch.int32)[~torch.isnan(ub)],
                       ub0.view(torch.int32)[~torch.isnan(ub0)])
    su = torch.sqrt(torch.clamp_min(ub0, 0.0))[:, None]
    both_nan = torch.isnan(cert) & torch.isnan(cert0)
    exact = (cert0 <= su) | torch.isnan(ub0)[:, None]
    ok = torch.where(exact, (cert == cert0) | both_nan,
                     ((cert > su) & (cert0 > su)) | both_nan)
    assert bool(ok.all()), int((~ok).sum())
    assert torch.equal(mk.survivors(ub, cert, tile_q),
                       mk.survivors(ub0, cert0, tile_q))


def same(a, b):
    """Equal values, NaN where NaN (any dtype)."""
    if a.dtype.is_floating_point:
        return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
            a.nan_to_num(7.0), b.nan_to_num(7.0))
    return torch.equal(a, b)


def contract_holds(got, want, tile_q=TILE_Q):
    try:
        assert_contract(got, want, tile_q)
    except AssertionError:
        return False
    return True


@pytest.mark.parametrize("tile_f", [128, 2048])
@pytest.mark.parametrize("split", [1, 4, 64])
@pytest.mark.parametrize("name", sorted(SETS))
def test_culled_plain_meets_the_contract(name, split, tile_f):
    v, f, q = SETS[name](np.random.RandomState(21))
    p, rec = operands(v, f, q)
    want = mk.mxu_bound_plain(p, rec, tile_f)
    cull = mk.mxu_cull_operands(p, rec, name == "body")
    got = mk.mxu_bound_culled_plain(p, rec, cull, tile_f, split)
    assert_contract(got, want)
    # the wrapper on CPU tensors takes it, with or without the counts
    again = mk.mxu_bound_culled(p, rec, tile_f, cull=cull, split=split,
                                with_stats=True)
    assert all(same(a, b) for a, b in zip(again, got))
    ub, cert = mk.mxu_bound_culled(p, rec, tile_f, cull=cull, split=split)
    assert torch.equal(ub, got[0]) and torch.equal(cert, got[1])


@pytest.mark.parametrize("split", [1, 4])
@pytest.mark.parametrize("queries", ["clustered", "scattered"])
@pytest.mark.parametrize("mesh", ["degenerate", "icosphere"])
def test_matches_jax_bound_kernel(mesh, queries, split):
    v, f, q, nondegen = case(mesh, queries)
    ub_j, cert_j = jax_result(mesh, queries, "bound")
    _, ref_stats = jax_result(mesh, queries, "repair")
    p, rec = operands(v, f, q, TILES["tile_q"])
    cull = mk.mxu_cull_operands(p, rec, not nondegen)
    ub, cert = mk.mxu_bound_culled(p, rec, TILES["tile_f"], cull=cull,
                                   split=split)
    p2 = (p.double() ** 2).sum(-1).numpy()
    tol = BOUND_REL * (p2 + float(rec[:, 15].max()))
    np.testing.assert_array_less(np.abs(ub.numpy() - ub_j), tol + 1e-30)
    su = np.sqrt(np.maximum(ub.numpy(), 0.0))[:, None]
    tol_c = (BOUND_REL * (1.0 + np.sqrt(p2 + float(rec[:, 15].max()))))
    tol_c = np.broadcast_to(tol_c[:, None], cert_j.shape)
    low = cert.numpy() <= su
    np.testing.assert_array_less(np.abs(cert.numpy() - cert_j)[low],
                                 tol_c[low])
    # where the port's value is above sqrt(ub), the reference's is too,
    # up to the rounding band
    above = np.broadcast_to(su, cert_j.shape)[~low] - 2 * tol_c[~low]
    assert bool((cert_j[~low] > above).all())
    # the repaired tiles, except on borderline blocks
    m_j = _margins(ub_j, cert_j, TILES["tile_q"])
    m_p = _margins(ub, cert, TILES["tile_q"])
    surv = mk.survivors(ub, cert, TILES["tile_q"]).numpy()
    np.testing.assert_array_equal(surv, m_p <= 0)
    band = 2 * BOUND_REL * (1.0 + np.sqrt(p2.max() + float(rec[:, 15].max())))
    borderline = (np.abs(m_j) <= band) | (np.abs(m_p) <= band)
    assert borderline.mean() < 0.2
    np.testing.assert_array_equal(surv[~borderline], (m_j <= 0)[~borderline])
    assert ref_stats["screened"] == surv.size


# -- planted traps, each failing a stated wrong copy of the bound -----------

def two_clusters(scale, offset, gap=1.0, n=64, seed=0):
    """Two clusters of 32 small faces (tile_f 32 puts each in a face tile
    of its own) and n queries on the first: the first cluster at
    ``scale`` from the origin along a random direction, the second
    ``offset`` away from it, sideways; the whole mirrored through the
    origin, so the vertex mean (the staging's center) stays near it."""
    rng = np.random.RandomState(seed)
    d = rng.randn(3)
    d /= np.linalg.norm(d)
    side = np.cross(d, rng.randn(3))
    side /= np.linalg.norm(side)
    base = d * scale
    tris = []
    for c in (base, base + side * offset):
        for _ in range(CHUNK):
            a = c + rng.randn(3) * 1e-3 * gap
            tris.append([a, a + rng.randn(3) * 1e-3 * gap,
                         a + rng.randn(3) * 1e-3 * gap])
    tris = np.array(tris)
    tris = np.concatenate([tris, -tris])
    v = tris.reshape(-1, 3).astype(np.float32)
    f = np.arange(v.shape[0]).reshape(-1, 3).astype(np.int32)
    q = (base + rng.randn(n, 3) * 1e-4 * gap).astype(np.float32)
    return v, f, q


def culled_with(p, rec, tile_f, split=1, cull=None, **patch):
    """``_bound_culled`` with module names replaced (a wrong copy)."""
    saved = {k: getattr(mk, k) for k in patch}
    try:
        for k, x in patch.items():
            setattr(mk, k, x)
        cull = cull or mk.mxu_cull_operands(p, rec)
        return mk._bound_culled(p, rec, cull, tile_f, split)
    finally:
        for k, x in saved.items():
            setattr(mk, k, x)


_BOUND_LBS = mk._bound_lbs


def lbs_without_envelope(px, py, pz, p2, crec):
    lu, _ = _BOUND_LBS(px, py, pz, p2, crec)
    dx, dy, dz = px - crec[..., 0], py - crec[..., 1], pz - crec[..., 2]
    o = [torch.clamp_min(x.abs() - crec[..., 4 + i], 0.0)
         for i, x in enumerate((dx, dy, dz))]
    sd2 = (o[0] * o[0] + o[1] * o[1] + o[2] * o[2]) * mk._CULL_SHRINK2
    return lu, torch.sqrt(sd2) - crec[..., 14]


def test_corners_far_from_the_origin_need_the_envelope_term():
    """Queries and faces 1000 from the origin, the second cluster 200
    away: E = 2^-6 (p2 + a2) is about 31,250, so that cluster's cert values
    lie far below sqrt(ub) (about 177) though its box is 200 away.  A cert
    bound without the 3.01 2^-7 (p2 + A2) term skips it."""
    v, f, q = two_clusters(1000.0, 200.0, gap=10.0)
    p, rec = operands(v, f, q, 32)
    want = mk.mxu_bound_plain(p, rec, 32)
    su = torch.sqrt(torch.clamp_min(want[0], 0.0))[:q.shape[0]]
    assert bool((want[1][:q.shape[0], 1] <= su).all())
    assert_contract(mk.mxu_bound_culled_plain(
        p, rec, mk.mxu_cull_operands(p, rec), 32), want, 32)
    wrong = culled_with(p, rec, 32, _bound_lbs=lbs_without_envelope)
    assert not contract_holds(wrong, want, 32)


def test_a_tile_certified_outside_the_ub_radius_needs_the_cert_test():
    """Unit scale, the second cluster 0.2 away: no u of it is below ub
    (about 2^-5), but its cert values are below sqrt(ub).  A cull on the
    ub test alone skips it."""
    v, f, q = two_clusters(1.0, 0.2)
    p, rec = operands(v, f, q, 32)
    want = mk.mxu_bound_plain(p, rec, 32)
    n = q.shape[0]
    su = torch.sqrt(torch.clamp_min(want[0], 0.0))[:n]
    assert bool((want[1][:n, 1] <= su).all())
    ap2t, env = mk._mxu_ap2_env(p[:n], mk._cols(rec, 32, 64))
    assert bool(((ap2t + env).amin(1) > want[0][:n]).all())
    cull = mk.mxu_cull_operands(p, rec)
    got = mk.mxu_bound_culled_plain(p, rec, cull, 32)
    assert_contract(got, want, 32)
    lu, lc = mk._bound_lbs(p[:n, 0], p[:n, 1], p[:n, 2],
                           (p[:n] * p[:n]).sum(-1), cull["records"][1])
    assert bool((lu > want[0][:n]).all())       # no ub need
    ub_only = culled_with(
        p, rec, 32, _bound_needs=lambda lu, lc, ub, near: (
            ~near | ~(lu > ub), torch.zeros_like(near)))
    assert not contract_holds(ub_only, want, 32)


@pytest.mark.parametrize("face", [5, 1500])
def test_nan_a2_keeps_every_cert_row(face):
    """A NaN a2 makes ub NaN for every query and its tile NaN in cert (the
    expectations of test_torch_mxu.test_bound_minima_propagate_nan), and
    every other tile of every row the every-face value.  A late NaN face
    breaks a copy that flags only its own chunk: the chunks before it were
    skipped by then."""
    v, f = sphere()
    p, rec = operands(v, f, patches(128, np.random.RandomState(23)))
    rec = rec.clone()
    rec[face, 15] = float("nan")
    want = mk.mxu_bound_plain(p, rec, 128)
    cull = mk.mxu_cull_operands(p, rec)
    for split in (1, 4):
        ub, cert = mk.mxu_bound_culled_plain(p, rec, cull, 128, split)[:2]
        assert bool(ub.isnan().all())
        tile = face // 128
        assert bool(cert[:, tile].isnan().all())
        others = torch.ones(cert.shape[1], dtype=torch.bool)
        others[tile] = False
        assert not bool(cert[:, others].isnan().any())
        assert torch.equal(cert[:, others], want[1][:, others])
        assert_contract((ub, cert), want)
    records = cull["records"].clone()
    a2 = rec[:, 15].reshape(-1, CHUNK).amax(dim=1)
    records[:, 13] = a2            # the chunk's own flag only
    wrong = mk._bound_culled(p, rec, dict(cull, records=records), 128, 1)
    if face >= CHUNK * 8:
        assert not contract_holds(wrong, want)


def test_nan_queries_fold_every_chunk():
    """64 NaN queries among 64 near ones: their ub and cert rows are NaN,
    as the every-face pass's.  A copy that reads a NaN bound as a skip
    (lb <= threshold for a need, without the guard on p2) leaves tiles or
    whole rows of them at +inf."""
    v, f = sphere()
    q = patches(64, np.random.RandomState(24))
    q = np.vstack([q, np.full((64, 3), np.nan, np.float32)])
    p, rec = operands(v, f, q)
    want = mk.mxu_bound_plain(p, rec, 128)
    assert bool(want[0][64:128].isnan().all())
    for split in (1, 4):
        got = mk.mxu_bound_culled_plain(p, rec, mk.mxu_cull_operands(p, rec),
                                        128, split)
        assert_contract(got, want)
        assert bool(got[1][64:128].isnan().all())
    skips = culled_with(p, rec, 128, _bound_needs=lambda lu, lc, ub, near: (
        lu <= ub, lc <= torch.sqrt(torch.clamp_min(ub, 0.0))))
    assert not contract_holds(skips, want)


def test_infinite_reach_keeps_every_tile():
    """Every reach +inf: every c is -inf, and every cert tile is -inf, as
    the every-face pass's.  A copy whose cert bound ignores the reach
    (Rm = 0) skips chunks and leaves +inf."""
    v, f = sphere()
    p, rec = operands(v, f, patches(128, np.random.RandomState(25)))
    rec = rec.clone()
    rec[:, 23] = float("inf")
    want = mk.mxu_bound_plain(p, rec, 128)
    assert bool((want[1] == float("-inf")).all())
    cull = mk.mxu_cull_operands(p, rec)
    assert bool(torch.isinf(cull["records"][:, 14]).all())
    got = mk.mxu_bound_culled_plain(p, rec, cull, 128, 4)
    assert_contract(got, want)
    assert bool((got[1] == float("-inf")).all())
    records = cull["records"].clone()
    records[:, 14] = 0.0
    wrong = mk._bound_culled(p, rec, dict(cull, records=records), 128, 1)
    assert not contract_holds(wrong, want)


# -- the records, the facade, the counts -------------------------------------

def test_chunk_records_hold_the_bound_terms():
    v, f, _ = body_case(np.random.RandomState(26))
    f = f[:len(f) - 5]                        # a ragged last chunk
    p, rec = operands(v, f, np.zeros((1, 3), np.float32))
    recs = mk.mxu_chunk_records(rec)
    chunk = torch.arange(f.shape[0]) // CHUNK
    assert bool((rec[:, 15] <= recs[chunk, 13]).all())
    assert bool((rec[:, 23] * (1 + 2.0 ** -22) <= recs[chunk, 14]).all())
    h = recs[:, 3].double()
    # h^2 2^-21 rounded twice: at least the 4.001u h^2 of item B2 needs
    assert bool((recs[:, 15].double() >= h * h * 7.99 * 2.0 ** -24).all())
    assert bool((recs[:, 15] >= 2.0 ** -120).all())
    # rows 3 and 5's fields are row 1's records and the reach, as before
    for tail in (False, True):
        again = mk.mxu_chunk_records(rec, tail)
        assert torch.equal(again[:, 13:], recs[:, 13:])
    # a face whose a is not finite, or 1e9 from the origin, flags the mesh
    for col, value in ((10, float("inf")), (15, 1e19)):
        bad = rec.clone()
        bad[7, col] = value
        assert bool(torch.isinf(mk.mxu_chunk_records(bad)[:, 13]).all())
    # a NaN reach is kept in its chunk only
    bad = rec.clone()
    bad[40, 23] = float("nan")
    got = mk.mxu_chunk_records(bad)[:, 14]
    assert bool(got[1].isnan()) and int(got.isnan().sum()) == 1
    # the bound records: bf16(a), a2 and the reach
    b = mk.mxu_bound_records(rec)
    assert b.shape == (f.shape[0], mk.MXU_BOUND_RECORD)
    assert torch.equal(b[:, 0:3], mk._bf16(rec[:, 9:12]))
    assert torch.equal(b[:, 3], rec[:, 15])
    assert torch.equal(b[:, 4], rec[:, 23])
    assert not bool(b[:, 5:].any())


def test_bound_records_are_cached_with_the_face_record(monkeypatch):
    monkeypatch.setattr(mk, "_MXU_CHUNK_CACHE", {})
    v, f = sphere(1024)
    p, rec = operands(v, f, np.zeros((64, 3), np.float32))
    rec = rec.clone()
    first = mk._cached_bound_records(rec)
    assert mk._cached_bound_records(rec) is first
    chunks = mk.mxu_cull_operands(p, rec)["records"]
    assert len(mk._MXU_CHUNK_CACHE) == 1
    assert mk._cached_bound_records(rec) is first
    rec[3, 9] += 1.0                           # an in-place change
    assert mk._cached_bound_records(rec) is not first
    assert mk.mxu_cull_operands(p, rec)["records"] is not chunks


@pytest.mark.parametrize("nondegen", [True, False])
def test_facade_equals_the_every_face_bound_path(monkeypatch, nondegen):
    v, f = small_body(seed=7, n_seg=24, n_ring=20)
    q = (np.random.RandomState(27).randn(200, 3) * 0.4).astype(np.float32)
    kw = dict(tile_q=64, tile_f=256, assume_nondegenerate=nondegen)
    calls = {"cull": 0, "every": 0}
    real_cull, real_bound = mk.mxu_cull_operands, mk.mxu_bound

    def count_cull(*a, **k):
        calls["cull"] += 1
        return real_cull(*a, **k)

    def count_bound(*a, **k):
        calls["every"] += 1
        return real_bound(*a, **k)

    monkeypatch.setattr(mk, "mxu_cull_operands", count_cull)
    monkeypatch.setattr(mk, "mxu_bound", count_bound)
    out, stats = mk.closest_point_mxu_repair_kernel(
        v, f, q, device="cpu", with_stats=True, **kw)
    assert calls == {"cull": 1, "every": 0}
    p, rec, tri, pts, center = mk.mxu_operands(v, f, q, 64, device="cpu")
    ub, cert = mk.mxu_bound_plain(p, rec, 256)
    best, rep = mk.mxu_repair_plain(p, rec, ub, cert, 64, 256, not nondegen)
    want = mk.mxu_epilogue(best, tri, pts, center)
    for key in ("face", "part", "point", "sqdist"):
        assert torch.equal(out[key], want[key]), key
    assert stats == {"screened": int(rep.numel()) * int(cert.shape[1]),
                     "repaired": int(rep.sum())}


@pytest.mark.parametrize("split", [1, 4])
def test_counts_are_consistent_and_near_queries_skip(split):
    v, f = sphere(4096)
    rng = np.random.RandomState(28)
    q = np.vstack([patches(256, rng), far(64, rng, radius=10.0)])
    p, rec = operands(v, f, q)
    cull = mk.mxu_cull_operands(p, rec)
    ub, cert, warp, lane, stage, lane_ub, lane_cert = mk._bound_culled(
        p, rec, cull, 256, split, apart=True)
    got = mk.mxu_bound_culled_plain(p, rec, cull, 256, split)
    assert all(same(a, b) for a, b in zip(got, (ub, cert, warp, lane,
                                                 stage)))
    n_c = -(-f.shape[0] // CHUNK)
    assert bool((warp <= stage).all()) and int(stage.max()) <= n_c
    assert bool((lane <= f.shape[0]).all())
    # a lane needs a chunk for one of the two tests
    assert bool((lane >= torch.maximum(lane_ub, lane_cert)).all())
    assert bool((lane <= CHUNK * (lane_ub + lane_cert)).all())
    near = torch.zeros(p.shape[0], dtype=torch.bool)
    near[:256] = True
    sorted_near = near[cull["qorder"].long()]
    near_warps = sorted_near.reshape(-1, 32).all(1)
    assert float(warp[near_warps].float().mean()) < 0.5 * n_c
    # far queries (100-1000 radii) fold nearly every chunk: E grows with p2
    far_warps = (~sorted_near).reshape(-1, 32).all(1)
    assert bool(far_warps.any())
    assert float(warp[far_warps].float().mean()) > 0.9 * n_c


def test_wrappers_route_and_check_operands():
    v, f = sphere(1024)
    q = (np.random.RandomState(29).randn(100, 3) * 0.4).astype(np.float32)
    p, rec = operands(v, f, q)
    before = dict(mk.LAUNCHES)
    ub, cert = mk.mxu_bound_culled(p, rec, 256)
    assert mk.LAUNCHES == before
    assert torch.equal(ub, mk.mxu_bound_plain(p, rec, 256)[0])
    cull = mk.mxu_cull_operands(p, rec, False)
    for kwargs, match in ((dict(tile_f=100), "multiple"),
                          (dict(split=mk.MAX_SPLIT + 1), "split"),
                          (dict(cull=dict(cull, qorder=cull["qorder"].long())),
                           "qorder")):
        with pytest.raises(ValueError, match=match):
            mk.mxu_bound_culled(p, rec, **kwargs)
    with pytest.raises(ValueError, match="multiple"):
        mk.mxu_bound_culled(p[:48].contiguous(), rec)
    with pytest.raises(ValueError):
        mk.mxu_bound_culled(p.to("meta"), rec.to("meta"))
    _, entry, types = _build.KERNELS["mxu_bound_culled"]
    assert entry == "mt_mxu_bound_culled"
    assert (types.count(_build._PTR), types.count(_build._INT)) == (12, 5)
    # the warps vote, stage and wait on their own: no block barrier
    text = open(os.path.join(_build._CSRC, "mxu_bound_culled.cu")).read()
    code = "\n".join(line.split("//")[0] for line in text.splitlines())
    assert "__any_sync" in code and "cp_async_wait" in code
    assert "__syncthreads" not in code
    assert '#include "mxu_cull.cuh"' in code


def test_bound_split_follows_the_query_count():
    for n in (32, 256, 4096, 16384, 65536):
        assert mk.mxu_bound_split(n) == min(mk.mxu_split(n),
                                            mk.BOUND_MAX_SPLIT)
    assert mk.mxu_bound_split(4096) == mk.mxu_bound_split(65536) == 32


def test_slots_follow_the_split_ranges():
    for n_c, split, cpt in ((1016, 32, 64), (1016, 64, 64), (128, 4, 4),
                            (10, 64, 1), (7, 3, 8)):
        slots = mk._bound_slots(n_c, split, cpt)
        ranges = [(n_c * s // split, n_c * (s + 1) // split)
                  for s in range(split)]
        touched = [len({k // cpt for k in range(lo, hi)})
                   for lo, hi in ranges]
        assert slots == max(touched)
