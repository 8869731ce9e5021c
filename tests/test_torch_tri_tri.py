"""mesh_tpu_torch triangle-triangle any-hit vs mesh_tpu, on the CPU: the
segment and Moller tiles of ``tri_tri_any_hit``, their prologues, the
divided and batched oracles, the tile gate and ``intersections_mask``.

Inputs come from numpy RandomState seeds (or fixed geometry) and go to both
packages.  The JAX side runs ``tri_tri_any_hit_pallas`` in interpret mode
(small tiles), as tests/test_pallas_ray.py and tests/test_moller_tri_tri.py
do; the port runs its kernel's plain version, which is what a CPU tensor
selects.  The segment tile and the Moller tile fed the reference's own
planes are held flag for flag.  The port's Moller prologue takes its
reciprocal square root from PyTorch, which may round one ulp away from
XLA's, so through the port's own prologue a flag may differ only on a query
shown to be borderline: its float64 segment-form slack (the best margin of
its pairs' barycentric and segment-parameter tests) is within BORDERLINE of
zero.  The cases of tests/test_moller_tri_tri.py keep their expected
answers.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mesh_tpu.query import intersections_mask as jax_intersections_mask
from mesh_tpu.query import pallas_ray as jpr
from mesh_tpu.query.ray import (
    _intersections_mask_xla,
    _tri_tri_algorithm as jax_tri_tri_algorithm,
    tri_tri_intersects as jax_tri_tri_intersects,
    tri_tri_intersects_moller as jax_tri_tri_intersects_moller,
)

from mesh_tpu_torch.query import tri_tri_kernel as tk
from mesh_tpu_torch.query.ray import (
    _tri_tri_algorithm,
    intersections_mask,
    tri_tri_intersects,
    tri_tri_intersects_moller,
)

from .fixtures import icosphere
from .test_moller_tri_tri import CASES

torch.set_num_threads(2)

#: a flag through the port's own Moller prologue may differ from the
#: reference's only on a query whose float64 slack is below this
BORDERLINE = 1e-6


def pair_slack64(p, q):
    """Float64 slack of the divided segment form per broadcast pair of
    triangles [..., 3, 3]: the best, over the six segment tests, of the
    least of u + eps, v + eps, 1 + eps - u - v, t + eps and 1 + eps - t
    (-inf for a test whose |det| is below eps).  The pair intersects iff
    the slack is >= 0."""
    p, q = np.asarray(p, np.float64), np.asarray(q, np.float64)
    eps = 1e-9
    best = None
    for src, dst in ((p, q), (q, p)):
        a = dst[..., 0, :]
        e1, e2 = dst[..., 1, :] - a, dst[..., 2, :] - a
        for c in range(3):
            s0 = src[..., c, :]
            d = src[..., (c + 1) % 3, :] - s0
            pvec = np.cross(d, e2)
            det = (e1 * pvec).sum(-1)
            valid = np.abs(det) >= eps
            inv = 1.0 / np.where(valid, det, 1.0)
            s = s0 - a
            u = (s * pvec).sum(-1) * inv
            qvec = np.cross(s, e1)
            v = (d * qvec).sum(-1) * inv
            t = (e2 * qvec).sum(-1) * inv
            slack = np.minimum.reduce([u + eps, v + eps, 1 + eps - (u + v),
                                       t + eps, 1 + eps - t])
            slack = np.where(valid, slack, -np.inf)
            best = slack if best is None else np.maximum(best, slack)
    return best


def borderline_queries(q_tri, m_tri):
    """True per query triangle whose float64 slack over all faces is within
    BORDERLINE of zero: float32 rounding may decide it either way."""
    slack = pair_slack64(np.asarray(q_tri)[:, None], np.asarray(m_tri)[None])
    return np.abs(slack.max(-1)) < BORDERLINE


def _any_hit(q_tri, m_tri, algorithm):
    hit, tested = tk.tri_tri_any_hit_kernel(
        torch.from_numpy(np.asarray(q_tri, np.float32)),
        torch.from_numpy(np.asarray(m_tri, np.float32)), algorithm)
    return hit.numpy(), tested.numpy()


def _pallas(q_tri, m_tri, algorithm, tile_q=32, tile_f=64):
    return np.asarray(jpr.tri_tri_any_hit_pallas(
        np.asarray(q_tri, np.float32), np.asarray(m_tri, np.float32),
        tile_q=tile_q, tile_f=tile_f, interpret=True, algorithm=algorithm))


def _first_hits(q_tri, m_tri, algorithm):
    """The pairs each query tests: its first hit's index plus one, else F,
    from the port's plain tile over every pair."""
    qp, fp = tk.tri_tri_planes(torch.from_numpy(np.asarray(q_tri, np.float32)),
                               torch.from_numpy(np.asarray(m_tri, np.float32)),
                               algorithm)
    h = tk._TILES[algorithm](tk._cols(qp, 0, qp.shape[1]), tk._rows(fp))
    h = h.numpy()
    return np.where(h.any(1), h.argmax(1) + 1, h.shape[1])


def _shifted_spheres():
    """The icosphere against itself shifted so the shells interpenetrate
    on one side only (tests/test_pallas_ray.py:138-152)."""
    v, f = icosphere(2)
    qv = (v + np.array([1.2, 0.0, 0.0])).astype(np.float32)
    return v.astype(np.float32), f.astype(np.int32), qv


def _soup():
    """A random triangle soup (tests/test_pallas_ray.py:158-169)."""
    rng = np.random.RandomState(7)
    v = rng.randn(60, 3).astype(np.float32)
    f = rng.randint(0, 60, size=(120, 3)).astype(np.int32)
    qv = (rng.randn(40, 3) * 0.8).astype(np.float32)
    qf = rng.randint(0, 40, size=(70, 3)).astype(np.int32)
    return v, f, qv, qf


# -- the any-hit kernel vs tri_tri_any_hit_pallas ------------------------------

@pytest.mark.parametrize("algorithm", tk.ALGORITHMS)
def test_shifted_spheres_match_pallas(algorithm):
    v, f, qv = _shifted_spheres()
    ref = _pallas(qv[f], v[f], algorithm)
    hit, tested = _any_hit(qv[f], v[f], algorithm)
    assert ref.any() and not ref.all()
    differ = hit != ref
    if algorithm == "segment":
        assert not differ.any()
        # the reference's XLA facade path, for the record
        np.testing.assert_array_equal(
            hit, np.asarray(_intersections_mask_xla(v, f, qv, f)))
    assert not (differ & ~borderline_queries(qv[f], v[f])).any()
    np.testing.assert_array_equal(tested, _first_hits(qv[f], v[f],
                                                      algorithm))
    assert tested.dtype == np.int32


@pytest.mark.parametrize("algorithm", tk.ALGORITHMS)
def test_random_soup_matches_pallas(algorithm):
    v, f, qv, qf = _soup()
    ref = _pallas(qv[qf], v[f], algorithm, tile_q=16, tile_f=32)
    hit, _ = _any_hit(qv[qf], v[f], algorithm)
    assert ref.any() and not ref.all()
    differ = hit != ref
    assert not (differ & ~borderline_queries(qv[qf], v[f])).any()
    if algorithm == "segment":
        assert not differ.any()


def _reference_moller_planes(q_tri, m_tri):
    """The reference's own Moller operands ([13, Q], [13, F]) as float32
    tensors: its joint prescale and _tri_planes."""
    qn, mn = jpr.moller_prescale(jnp.asarray(q_tri), jnp.asarray(m_tri))
    q = np.stack([np.asarray(c)[:, 0] for c in jpr._moller_qcols(qn, 8)])
    m = np.stack([np.asarray(r)[0] for r in jpr._moller_frows(mn, 8)])
    return (torch.from_numpy(np.ascontiguousarray(q[:, :len(q_tri)])),
            torch.from_numpy(np.ascontiguousarray(m[:, :len(m_tri)])))


def test_moller_tile_on_reference_planes_is_exact():
    """Fed the reference's own planes, the plain Moller tile reproduces
    tri_tri_any_hit_pallas flag for flag, degenerate triangles (blind by
    construction) included (tests/test_moller_tri_tri.py:216-233)."""
    rng = np.random.RandomState(3)
    q_tri = rng.randn(137, 3, 3).astype(np.float32)
    m_tri = rng.randn(201, 3, 3).astype(np.float32)
    q_tri[5, 2] = q_tri[5, 1]
    m_tri[7] = 0.0
    m_tri[11, 2] = (m_tri[11, 0] + m_tri[11, 1]) / 2
    ref = _pallas(q_tri, m_tri, "moller")
    qp, fp = _reference_moller_planes(q_tri, m_tri)
    hit, _ = tk.tri_tri_any_hit(qp, fp, "moller")
    np.testing.assert_array_equal(hit.numpy(), ref)
    # and the batched oracle of the reference, pairwise
    pairwise = np.asarray(jnp.any(jax_tri_tri_intersects_moller(
        jnp.asarray(q_tri)[:, None], jnp.asarray(m_tri)[None]), axis=1))
    np.testing.assert_array_equal(hit.numpy(), pairwise)
    # through the port's own prologue: borderline queries only
    own, _ = _any_hit(q_tri, m_tri, "moller")
    assert not ((own != ref) & ~borderline_queries(q_tri, m_tri)).any()


def test_prologues_match_reference():
    """The segment operands are the reference's exactly; the Moller ones
    too, but for the unit normals and offsets, which carry the reciprocal
    square root (an ulp or two apart between the packages)."""
    v, f, qv = _shifted_spheres()
    q_tri, m_tri = qv[f], v[f]
    qp, fp = tk.segment_planes(torch.from_numpy(q_tri),
                               torch.from_numpy(m_tri))
    ref_q = np.stack([np.asarray(c)[:, 0] for c in jpr._query_cols(
        [q_tri[:, 0], q_tri[:, 1], q_tri[:, 2]], 8)])[:, :len(f)]
    ref_f = np.stack([np.asarray(r)[0] for r in jpr._tri_rows(
        jnp.asarray(m_tri), 8)])[:, :len(f)]
    np.testing.assert_array_equal(qp.numpy(), ref_q)
    np.testing.assert_array_equal(fp.numpy(), ref_f)
    mq, mf = tk.moller_planes(torch.from_numpy(q_tri),
                              torch.from_numpy(m_tri))
    rq, rf = _reference_moller_planes(q_tri, m_tri)
    for mine, ref in ((mq, rq), (mf, rf)):
        np.testing.assert_array_equal(mine[:9].numpy(), ref[:9].numpy())
        np.testing.assert_allclose(mine[9:].numpy(), ref[9:].numpy(),
                                   rtol=0, atol=1e-6)


# -- the structured and scale batteries of tests/test_moller_tri_tri.py --------

@pytest.mark.parametrize("algorithm", tk.ALGORITHMS)
@pytest.mark.parametrize("case", range(len(CASES)))
def test_structured_cases(case, algorithm):
    p, q, expect = CASES[case]
    p = np.asarray(p, np.float32)[None]
    q = np.asarray(q, np.float32)[None]
    hit, tested = _any_hit(p, q, algorithm)
    assert bool(hit[0]) is expect
    assert int(tested[0]) == 1
    # either way round, and through the oracles in float64
    assert bool(_any_hit(q, p, algorithm)[0][0]) is expect
    oracle = {"segment": tri_tri_intersects,
              "moller": tri_tri_intersects_moller}[algorithm]
    for a, b in ((p, q), (q, p)):
        got = oracle(torch.from_numpy(a.astype(np.float64)),
                     torch.from_numpy(b.astype(np.float64)))
        assert bool(got[0]) is expect


@pytest.mark.parametrize("scale,offset", [(2e3, 0.0), (1.0, 1e4),
                                          (2e3, 5e4)])
def test_large_coordinate_extents(scale, offset):
    """mm-scale and far-from-origin inputs keep every structured decision
    in float32: the joint unit-box prescale keeps the interval terms
    finite (tests/test_moller_tri_tri.py:112-127)."""
    for p, q, expect in CASES:
        pf = np.asarray(p, np.float32)[None] * scale + offset
        qf = np.asarray(q, np.float32)[None] * scale + offset
        assert bool(tri_tri_intersects_moller(
            torch.from_numpy(pf), torch.from_numpy(qf))[0]) is expect
        assert bool(_any_hit(pf, qf, "moller")[0][0]) is expect
        ref = jax_tri_tri_intersects_moller(jnp.asarray(pf), jnp.asarray(qf))
        assert bool(np.asarray(ref)[0]) is expect


def test_random_battery_at_mm_scale_matches_reference():
    """The reference's mm-scale battery (tests/test_moller_tri_tri.py:
    130-149) pair by pair: the port's Moller oracle equals the reference's
    at unit and at mm scale, but for pairs borderline in float64."""
    rng = np.random.RandomState(7)
    n = 2000
    p = rng.randn(n, 3, 3).astype(np.float32)
    q = (rng.randn(n, 3, 3) * rng.choice([0.3, 1.0, 3.0], (n, 1, 1))
         ).astype(np.float32)
    for pp, qq in ((p, q), (p * 2000.0 + 1e4, q * 2000.0 + 1e4)):
        mine = tri_tri_intersects_moller(torch.from_numpy(pp),
                                         torch.from_numpy(qq)).numpy()
        ref = np.asarray(jax_tri_tri_intersects_moller(jnp.asarray(pp),
                                                       jnp.asarray(qq)))
        border = np.abs(pair_slack64(pp, qq)) < BORDERLINE
        assert not ((mine != ref) & ~border).any()
    base = tri_tri_intersects_moller(torch.from_numpy(p),
                                     torch.from_numpy(q)).numpy()
    scaled = tri_tri_intersects_moller(torch.from_numpy(p * 2000.0 + 1e4),
                                       torch.from_numpy(q * 2000.0 + 1e4))
    assert (scaled.numpy() != base).mean() < 0.005


def test_random_battery_matches_segment_oracle_where_robust():
    """Moller decides as the float64 segment form wherever that decision
    survives 1e-6 jitters of every vertex (tests/test_moller_tri_tri.py:
    69-109), in float64 and in float32, and the port's float64 divided
    form equals the reference's there."""
    rng = np.random.RandomState(0)
    n = 1500
    p = rng.randn(n, 3, 3)
    q = rng.randn(n, 3, 3) * rng.choice([0.3, 1.0, 3.0], (n, 1, 1))
    q[:, :, 2] *= rng.choice([0.05, 1.0], (n, 1))
    pt, qt = torch.from_numpy(p), torch.from_numpy(q)
    oracle = tri_tri_intersects(pt, qt).numpy()
    robust = np.ones(n, bool)
    for k in range(5):
        jit_rng = np.random.RandomState(100 + k)
        robust &= tri_tri_intersects(
            torch.from_numpy(p + jit_rng.randn(*p.shape) * 1e-6),
            torch.from_numpy(q + jit_rng.randn(*q.shape) * 1e-6)
        ).numpy() == oracle
    assert robust.mean() > 0.97
    moller64 = tri_tri_intersects_moller(pt, qt).numpy()
    assert not ((moller64 != oracle) & robust).any()
    moller32 = tri_tri_intersects_moller(pt.float(), qt.float()).numpy()
    assert not ((moller32 != oracle) & robust).any()
    # the reference's float32 divided form, against the port's
    ref32 = np.asarray(jax_tri_tri_intersects(jnp.asarray(p, jnp.float32),
                                              jnp.asarray(q, jnp.float32)))
    mine32 = tri_tri_intersects(pt.float(), qt.float()).numpy()
    np.testing.assert_array_equal(mine32, ref32)


def test_heterogeneous_batch_no_scale_coupling():
    """A far pair in the batch does not flip a near one: the shared
    prescale shrinks plane distances linearly (unit normals)."""
    near_p, near_q, near = CASES[0]
    far_p, far_q, far = CASES[1]
    p = np.stack([np.float32(near_p), np.float32(far_p) + 1e4])
    q = np.stack([np.float32(near_q), np.float32(far_q) + 1e4])
    got = tri_tri_intersects_moller(torch.from_numpy(p), torch.from_numpy(q))
    assert bool(got[0]) is near and bool(got[1]) is far


@pytest.mark.parametrize("off", [1e4, 1e5, 3e6])
def test_outlier_does_not_blind_small_pairs(off):
    """The relative degeneracy cut keeps a unit pair live however far an
    outlier stretches the joint box (tests/test_moller_tri_tri.py:
    184-202); likewise a unit pair in a 1e3 scene."""
    near_p = np.asarray(CASES[0][0], np.float32)
    near_q = np.asarray(CASES[0][1], np.float32)
    outlier = np.float32([[off, off, off], [off * 1.001, off, off],
                          [off, off * 1.001, off]])
    p = np.stack([near_p, outlier])
    q = np.stack([near_q, outlier + np.float32([0, 0, off / 10])])
    assert bool(tri_tri_intersects_moller(torch.from_numpy(p),
                                          torch.from_numpy(q))[0])
    anchor = np.float32([[1e3, 1e3, 1e3], [1e3 + 1, 1e3, 1e3],
                         [1e3, 1e3 + 1, 1e3]])
    p = np.stack([near_p, anchor])
    q = np.stack([near_q, anchor + np.float32([0, 0, 9])])
    assert bool(tri_tri_intersects_moller(torch.from_numpy(p),
                                          torch.from_numpy(q))[0])


def test_user_eps_is_scale_invariant():
    """eps in input units rides along with the prescale
    (tests/test_moller_tri_tri.py:283-308)."""
    p = np.array([[[0, 0, 0], [2, 0, 0], [0, 2, 0]]], np.float64)
    q = np.array([[[0.5, 0.5, -0.02], [1.5, 0.5, 0.01],
                   [0.5, 1.5, 0.01]]], np.float64)

    def run(k, eps):
        return bool(tri_tri_intersects_moller(
            torch.from_numpy(p * k), torch.from_numpy(q * k), eps=eps)[0])

    for k in (1.0, 1e3):
        assert run(k, 1e-9 * k) is True
        assert run(k, 0.1 * k) is False
    assert run(1e3, 0.1) is True


def test_f64_sliver_is_not_degeneracy_rejected():
    sliver = np.array([[[0, 0, -1], [0, 0, 1], [1, 3e-7, 0]]], np.float64)
    target = np.array([[[-1, -1, 0], [1, -1, 0], [0, 1, 0]]], np.float64)
    a, b = torch.from_numpy(sliver), torch.from_numpy(target)
    assert bool(tri_tri_intersects(a, b)[0])
    assert bool(tri_tri_intersects_moller(a, b)[0])


@pytest.mark.parametrize("algorithm", tk.ALGORITHMS)
def test_empty_inputs(algorithm):
    """No query or no face: all False, nothing tested, no launch."""
    tri = np.asarray(CASES[0][0], np.float32)[None]
    empty = np.zeros((0, 3, 3), np.float32)
    before = dict(tk.LAUNCHES)
    hit, tested = _any_hit(empty, tri, algorithm)
    assert hit.shape == tested.shape == (0,)
    hit, tested = _any_hit(tri, empty, algorithm)
    assert hit.shape == (1,) and not hit.any() and tested[0] == 0
    assert tk.LAUNCHES == before
    assert tri_tri_intersects_moller(torch.from_numpy(empty),
                                     torch.from_numpy(empty)).shape == (0,)
    ref = jpr.tri_tri_any_hit_pallas(tri, tri, tile_q=8, tile_f=8,
                                     interpret=True, algorithm=algorithm)
    assert np.asarray(ref).shape == _any_hit(tri, tri, algorithm)[0].shape


# -- the gate and the facade -----------------------------------------------------

def test_moller_blindness_and_the_gate(monkeypatch):
    """A zero-area needle piercing a face: the segment tile sees it, Moller
    is blind, and the gate keeps such meshes on the segment tile, as the
    reference's does (tests/test_moller_tri_tri.py:236-258)."""
    tri = np.array([[[0, 0, 0], [2, 0, 0], [0, 2, 0]]], np.float32)
    needle = np.array([[[0.5, 0.5, -1], [0.5, 0.5, 1], [0.5, 0.5, 3]]],
                      np.float32)
    assert bool(_any_hit(needle, tri, "segment")[0][0]) is True
    assert bool(_any_hit(needle, tri, "moller")[0][0]) is False
    v = tri[0]
    f = np.array([[0, 1, 2]], np.int32)
    hv = v + np.array([0, 0, 1], np.float32)
    for args, expect in (((v, f, needle[0], f), "segment"),
                         ((v, f, hv, f), "moller")):
        assert _tri_tri_algorithm(*args) == expect
        assert jax_tri_tri_algorithm(*args) == expect
        assert _tri_tri_algorithm(torch.from_numpy(args[0]),
                                  torch.from_numpy(args[1]),
                                  *args[2:]) == expect
    monkeypatch.setenv("MESH_TPU_SAFE_TILES", "1")
    assert _tri_tri_algorithm(v, f, hv, f) == "segment"
    assert jax_tri_tri_algorithm(v, f, hv, f) == "segment"


def test_config4_geometry_parity():
    """The grazing icosphere against the SMPL-sized sphere
    (tests/test_moller_tri_tri.py:261-280): both tiles give the same mask,
    which equals the reference's XLA facade and is not empty."""
    from mesh_tpu_torch.models import smpl_sized_sphere
    from mesh_tpu.sphere import _icosphere

    body_v, body_f = smpl_sized_sphere()
    hand_v, hand_f = _icosphere(2)
    hand_v = (hand_v * 0.2 + np.array([0.9, 0, 0])).astype(np.float32)
    body_v = body_v.astype(np.float32)
    seg, _ = _any_hit(hand_v[hand_f], body_v[body_f], "segment")
    mol, _ = _any_hit(hand_v[hand_f], body_v[body_f], "moller")
    np.testing.assert_array_equal(seg, mol)
    assert seg.sum() > 0
    ref = np.asarray(jax_intersections_mask(body_v, body_f.astype(np.int32),
                                            hand_v, hand_f.astype(np.int32)))
    np.testing.assert_array_equal(seg, ref)


@pytest.mark.parametrize("case", ["spheres", "soup", "needle"])
def test_intersections_mask_matches_reference(case):
    """The facade (the gate, the prologue, the kernel's plain version) vs
    mesh_tpu's CPU facade (its XLA segment form): equal but for borderline
    queries; a mesh with a degenerate face takes the segment tile."""
    if case == "spheres":
        v, f, qv = _shifted_spheres()
        qf = f
    elif case == "soup":
        v, f, qv, qf = _soup()
    else:
        v, f, qv = _shifted_spheres()
        qf = np.vstack([f, [[0, 0, 1]]]).astype(np.int32)
    mask = intersections_mask(v, f, qv, qf, device="cpu")
    assert mask.dtype == torch.bool and tuple(mask.shape) == (len(qf),)
    ref = np.asarray(jax_intersections_mask(v, f, qv, qf))
    differ = mask.numpy() != ref
    assert not (differ & ~borderline_queries(qv[qf], v[f])).any()
    assert ref.any() and not ref.all()
    assert _tri_tri_algorithm(v, f, qv, qf) == (
        "segment" if case != "spheres" else "moller")


# -- wrappers ------------------------------------------------------------------

def test_wrappers_reject_bad_operands_and_cpu_takes_plain():
    v, f, qv = _shifted_spheres()
    qp, fp = tk.segment_planes(torch.from_numpy(qv[f]),
                               torch.from_numpy(v[f]))
    with pytest.raises(ValueError):
        tk.tri_tri_any_hit(qp.double(), fp.double(), "segment")
    with pytest.raises(ValueError):
        tk.tri_tri_any_hit(qp, fp, "moller")          # 9 rows, not 13
    with pytest.raises(ValueError):
        tk.tri_tri_any_hit(qp, fp, "exact")
    with pytest.raises(ValueError):
        tk.tri_tri_any_hit(qp.to("meta"), fp.to("meta"), "segment")
    before = dict(tk.LAUNCHES), dict(tk.TILE_LAUNCHES)
    hit, tested = tk.tri_tri_any_hit(qp, fp, "segment")
    plain = tk.tri_tri_any_hit_plain(qp, fp, "segment")
    assert torch.equal(hit, plain[0]) and torch.equal(tested, plain[1])
    assert (dict(tk.LAUNCHES), dict(tk.TILE_LAUNCHES)) == before


@pytest.mark.parametrize("algorithm", tk.ALGORITHMS)
def test_plain_chunking_is_exact(monkeypatch, algorithm):
    v, f, qv = _shifted_spheres()
    whole = _any_hit(qv[f], v[f], algorithm)
    monkeypatch.setitem(tk._PLAIN_PAIRS, "cpu", 7 * len(f) + 3)
    chunked = _any_hit(qv[f], v[f], algorithm)
    np.testing.assert_array_equal(chunked[0], whole[0])
    np.testing.assert_array_equal(chunked[1], whole[1])
