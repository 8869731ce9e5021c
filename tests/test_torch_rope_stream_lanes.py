"""The streamed rope walks' sub-lane design on the CPU: the plain versions
of the streamed ``rope_faces`` and ``rope_mxu_faces`` entries at S
sub-lanes per query against their whole-leaf streamed walks, against the
resident walks and against mesh_tpu's streamed kernels in interpret mode;
the face record operand; and what the wrappers refuse.

The CUDA kernel (``csrc/rope_walk.cuh`` rope_stream_kernel) folds each
ring slot as S contiguous runs of ``tile_f / S`` faces, merges the runs by
(distance, position) and applies the result with one strict ``<``; under
the bf16 screen each sub-lane screens its own run and the block ORs the
verdicts.  Its plain version (``_walk_plain`` with ``lanes``) must equal
the whole-leaf streamed walk bit for bit in distances, sorted face
positions, leaves per query tile and full visits, at every S and ring
depth.  The cases: the icosphere and the small posed body of
test_torch_rope_lanes, an icosphere cut to a face count that is no
multiple of ``tile_f``, a mesh whose every face appears three times
(exact ties across runs and across leaves), and test_torch_rope_mxu's
mixed-radius set, where the screen skips visits.
"""

import functools

import numpy as np
import pytest
import torch

from mesh_tpu.accel.pallas_stream import (
    closest_point_pallas_bvh_stream,
    closest_point_pallas_bvh_stream_mxu,
)

from mesh_tpu_torch.accel import rope_kernel as rk

from .test_torch_culled import sphere, surface_queries
from .test_torch_mxu import assert_mxu_contract
from .test_torch_rope_lanes import CASES as LANE_CASES
from .test_torch_rope_mxu import _mixed_case

torch.set_num_threads(2)

TILE_Q, TILE_F = 32, 64
RINGS = (2, 3)


def _odd_case():
    """An icosphere cut to 1237 faces: the last leaf is padded."""
    v, f = sphere(3, seed=65)
    f = f[:1237]
    return v, f, surface_queries(v, f, 300, seed=66)


CASES = dict(LANE_CASES, odd_faces=_odd_case, mixed=_mixed_case)


@functools.lru_cache(maxsize=None)
def _ops(name, mxu, tile_q=TILE_Q, tile_f=TILE_F):
    v, f, q = CASES[name]()
    return rk.rope_operands(v, f, q, tile_q=tile_q, tile_f=tile_f,
                            device="cpu", mxu=mxu, records=not mxu)


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


# -- the sub-lane fold of the streamed walks ---------------------------------

@pytest.mark.parametrize("n_buffers", RINGS)
@pytest.mark.parametrize("lanes", rk.LANES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_stream_lanes_equal_whole_leaf_stream(name, lanes, n_buffers):
    ops = _ops(name, False)
    whole = rk.rope_argmin_plain(ops, n_buffers)
    _equal(rk.rope_argmin_plain(ops, n_buffers, lanes), whole)
    assert int(whole[2].sum()) > whole[2].numel()      # tiles take leaves


@pytest.mark.parametrize("use_bf16", [False, True])
@pytest.mark.parametrize("lanes", rk.LANES)
@pytest.mark.parametrize("name", ["icosphere", "mixed", "odd_faces",
                                  "tied"])
def test_mxu_stream_lanes_equal_whole_leaf_stream(name, lanes, use_bf16):
    ops = _ops(name, True)
    for n_buffers in RINGS:
        whole = rk.rope_mxu_argmin_plain(ops, n_buffers, use_bf16)
        _equal(rk.rope_mxu_argmin_plain(ops, n_buffers, use_bf16,
                                        lanes=lanes), whole)


@pytest.mark.parametrize("lanes", rk.LANES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_stream_takes_at_least_the_resident_leaves(name, lanes):
    ops = _ops(name, False)
    rd, ri, rl = rk.rope_argmin_plain(ops, None, lanes)
    for n_buffers in RINGS:
        sd, si, sl = rk.rope_argmin_plain(ops, n_buffers, lanes)
        assert torch.equal(sd, rd) and torch.equal(si, ri)
        assert bool((sl >= rl).all())
    mxu = _ops(name, True)
    _, _, rl_m, _ = rk.rope_mxu_argmin_plain(mxu, None)
    _, _, sl_m, _ = rk.rope_mxu_argmin_plain(mxu, 2, lanes=lanes)
    assert bool((sl_m >= rl_m).all())


@pytest.mark.parametrize("lanes", rk.LANES)
def test_ties_across_runs_and_leaves_keep_the_lowest_position(lanes):
    v, f, q = CASES["tied"]()
    ops = _ops("tied", False)
    _, i, _ = rk.rope_argmin_plain(ops, 2, lanes)
    base = ops["order_p"].long() % (f.shape[0] // 3)
    win = i[:q.shape[0]].long()
    group = base[:, None] == base[win][None, :]              # [Fp, n_q]
    pos = torch.arange(base.shape[0])[:, None].expand_as(group)
    lo = torch.where(group, pos, base.shape[0]).amin(dim=0)
    hi = torch.where(group, pos, -1).amax(dim=0)
    assert torch.equal(win, lo)
    if lanes > 1:
        assert int((lo // (TILE_F // lanes) != hi // (TILE_F // lanes)).sum())
    assert int((lo // TILE_F != hi // TILE_F).sum()) > 0


@pytest.mark.parametrize("lanes", rk.LANES)
def test_split_screen_skips_the_visits_the_whole_leaf_screen_skips(lanes):
    ops = _ops("mixed", True)
    whole_counts, counts = {}, {}
    _, _, leaves, full = rk.rope_mxu_argmin_plain(ops, 2, True,
                                                  whole_counts)
    _, _, leaves_s, full_s = rk.rope_mxu_argmin_plain(ops, 2, True, counts,
                                                      lanes=lanes)
    assert torch.equal(leaves_s, leaves) and torch.equal(full_s, full)
    assert int(full.sum()) < int(leaves.sum())       # the screen skips
    assert counts["screen_pairs"] == whole_counts["screen_pairs"]
    # each sub-lane stops at its own run's first survivor: at least the
    # one-lane screen's pairs, at most every pair of every screened leaf
    assert counts["screen_lane_pairs"] >= counts["screen_pairs"]
    if lanes == 1:
        assert counts["screen_lane_pairs"] == counts["screen_pairs"]
    assert (counts["screen_lane_pairs"]
            <= int(leaves.sum()) * ops["tile_q"] * ops["tile_f"])


# -- against mesh_tpu's streamed kernels --------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_stream(name, mxu, use_bf16=False):
    """mesh_tpu's streamed answer on the case, with its screened and
    repaired counts for the MXU walk (None for the fast tile's)."""
    v, f, q = CASES[name]()
    stats = None
    if mxu:
        ref, stats = closest_point_pallas_bvh_stream_mxu(
            v, f, q, tile_q=64, tile_f=256, n_buffers=2, interpret=True,
            use_bf16=use_bf16, with_stats=True)
    else:
        ref = closest_point_pallas_bvh_stream(
            v, f, q, tile_q=64, tile_f=256, n_buffers=2, interpret=True)
    return {k: np.asarray(x) for k, x in ref.items()}, stats


@pytest.mark.parametrize("walk", ["vpu", "mxu_f32", "mxu_bf16"])
@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("name", ["icosphere", "posed_body"])
def test_stream_lanes_match_jax_stream(name, lanes, walk):
    v, f, q = CASES[name]()
    mxu = walk != "vpu"
    ops = _ops(name, mxu, tile_q=64, tile_f=256)
    ref, ref_stats = _jax_stream(name, mxu, walk == "mxu_bf16")
    if mxu:
        _, out_i, out_lv, full = rk.rope_mxu_argmin_plain(
            ops, 2, walk == "mxu_bf16", lanes=lanes)
        assert ref_stats == {"screened": int(out_lv.sum()),
                             "repaired": int(full.sum())}
    else:
        _, out_i, out_lv = rk.rope_argmin_plain(ops, 2, lanes)
    out = {k: x.numpy() for k, x in rk._rope_epilogue(ops, out_i,
                                                      out_lv).items()}
    assert out["tight"].all()
    assert assert_mxu_contract(ref, out, v, f, q) > 0.5
    # the same refill under the same frozen bounds: the same leaves
    np.testing.assert_array_equal(out["pair_tests"], ref["pair_tests"])


# -- operands and wrappers ----------------------------------------------------

def test_face_records_are_the_planes_transposed_and_padded():
    ops = _ops("odd_faces", False)
    rows, recs = ops["rows"], ops["recs"]
    assert recs.shape == (rows.shape[1], rk.FAST_RECORD)
    assert recs.dtype == torch.float32 and recs.is_contiguous()
    assert torch.equal(recs[:, :rows.shape[0]], rows.t())
    assert not bool(recs[:, rows.shape[0]:].any())
    assert "recs" not in _ops("odd_faces", True)
    plain = rk.rope_operands(*_odd_case(), tile_q=TILE_Q, tile_f=TILE_F,
                             device="cpu")
    assert "recs" not in plain


def test_wrappers_take_the_plain_version_on_cpu():
    ops, mxu = _ops("icosphere", False), _ops("mixed", True)
    before = dict(rk.LAUNCHES)
    for n_buffers in RINGS:
        whole = rk.rope_argmin_plain(ops, n_buffers)
        for lanes in (None, 1, 8):
            _equal(rk.rope_argmin(ops, n_buffers, lanes=lanes), whole)
        for use_bf16 in (False, True):
            whole_m = rk.rope_mxu_argmin_plain(mxu, n_buffers, use_bf16)
            for lanes in (None, 2):
                _equal(rk.rope_mxu_argmin(mxu, n_buffers, use_bf16,
                                          lanes=lanes), whole_m)
    _equal(rk.rope_mxu_argmin(mxu, None, True, lanes=1),
           rk.rope_mxu_argmin_plain(mxu, None, True))
    assert rk.LAUNCHES == before


def test_wrappers_refuse_what_the_kernel_cannot_launch():
    ops, mxu = _ops("icosphere", False), _ops("icosphere", True)
    for lanes in (3, 16):                          # not one of LANES
        with pytest.raises(ValueError, match="lanes"):
            rk.rope_argmin(ops, 2, lanes=lanes)
        with pytest.raises(ValueError, match="lanes"):
            rk.rope_mxu_argmin(mxu, 2, lanes=lanes)
        with pytest.raises(ValueError, match="lanes"):
            rk.rope_argmin_plain(ops, 2, lanes)
    v, f, q = CASES["icosphere"]()
    odd = rk.rope_operands(v, f, q, tile_q=TILE_Q, tile_f=36, device="cpu",
                           records=True)
    odd_m = rk.rope_operands(v, f, q, tile_q=TILE_Q, tile_f=36, device="cpu",
                             mxu=True)
    with pytest.raises(ValueError, match="divide tile_f"):
        rk.rope_argmin(odd, 2, lanes=8)            # 8 does not divide 36
    with pytest.raises(ValueError, match="divide tile_f"):
        rk.rope_mxu_argmin(odd_m, 2, lanes=8)
    rk.rope_argmin(odd, 2, lanes=4)
    wide = rk.rope_operands(v, f, q, tile_q=256, tile_f=TILE_F, device="cpu",
                            mxu=True)
    with pytest.raises(ValueError, match="1024"):
        rk.rope_mxu_argmin(wide, 2, lanes=8)       # 2048 threads
    rk.rope_mxu_argmin(wide, 2, lanes=4)
    # the MXU ring and the partials must fit 226 KB together: 3 slots of
    # 800 faces (230,400 bytes) fit alone, not with 4 lanes' partials
    big = rk.rope_operands(v, f, q, tile_q=64, tile_f=800, device="cpu",
                           mxu=True)
    rk.rope_mxu_argmin(big, 3, lanes=1)
    with pytest.raises(ValueError, match="shared memory"):
        rk.rope_mxu_argmin(big, 3, lanes=4)
    with pytest.raises(ValueError, match="shared memory"):
        rk.rope_mxu_argmin(big, 3)                 # the pick is 4
    # the resident MXU entry takes every S of LANES too, and both resident
    # wrappers refuse what their kernel cannot launch
    for use_bf16 in (False, True):
        whole = rk.rope_mxu_argmin_plain(mxu, None, use_bf16)
        for lanes in (2, 4, 8):
            _equal(rk.rope_mxu_argmin(mxu, None, use_bf16, lanes=lanes),
                   whole)
            _equal(rk.rope_mxu_argmin_plain(mxu, None, use_bf16,
                                            lanes=lanes), whole)
    for lanes in (3, 16):                          # not one of LANES
        with pytest.raises(ValueError, match="lanes"):
            rk.rope_argmin(ops, None, lanes=lanes)
        with pytest.raises(ValueError, match="lanes"):
            rk.rope_mxu_argmin(mxu, None, lanes=lanes)
        with pytest.raises(ValueError, match="lanes"):
            rk.rope_mxu_argmin_plain(mxu, None, lanes=lanes)
    with pytest.raises(ValueError, match="divide tile_f"):
        rk.rope_argmin(odd, None, lanes=8)
    with pytest.raises(ValueError, match="divide tile_f"):
        rk.rope_mxu_argmin(odd_m, None, lanes=8)
    rk.rope_mxu_argmin(odd_m, None, lanes=4)
    with pytest.raises(ValueError, match="1024"):
        rk.rope_mxu_argmin(wide, None, lanes=8)    # 2048 threads
    rk.rope_mxu_argmin(wide, None, lanes=4)
    # one resident MXU leaf of 2400 faces (230,400 bytes) fits the 226 KB
    # with 2 lanes' partials (1,024 bytes), not with 4 lanes'
    huge = rk.rope_operands(v, f, q, tile_q=64, tile_f=2400, device="cpu",
                            mxu=True)
    rk.rope_mxu_argmin(huge, None, lanes=2)
    with pytest.raises(ValueError, match="shared memory"):
        rk.rope_mxu_argmin(huge, None, lanes=4)
    with pytest.raises(ValueError, match="shared memory"):
        rk.rope_mxu_argmin(huge, None)             # the pick is 4


def test_stream_facade_matches_resident_facade():
    v, f, q = CASES["posed_body"]()
    res = rk.closest_point_bvh_kernel(v, f, q, tile_q=64, device="cpu")
    out = rk.closest_point_bvh_stream_kernel(v, f, q, tile_q=64,
                                             n_buffers=3, device="cpu")
    for key in ("face", "part", "point", "sqdist"):
        assert torch.equal(out[key], res[key]), key
    assert bool((out["pair_tests"] >= res["pair_tests"]).all())
