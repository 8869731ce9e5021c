"""The resident MXU rope walk's sub-lane design on the CPU: the plain
version of the resident ``rope_mxu_faces`` entry at S sub-lanes per query
against its whole-leaf walk and against mesh_tpu.

The CUDA kernel (``csrc/rope_walk.cuh`` rope_lanes_kernel with the MXU
policy) folds each staged leaf as S contiguous runs of ``tile_f / S``
faces, merges the runs by (distance, position) and applies the result with
one strict ``<``; under the bf16 screen each sub-lane screens its own run
up to its own first survivor and the block ORs the verdicts.  Its plain
version (``rope_mxu_argmin_plain(..., lanes=S)``) must equal the
whole-leaf resident walk bit for bit in distances, sorted face positions,
leaves per query tile and full visits, and its screen must skip exactly
the visits the whole-leaf screen skips.  The cases are
test_torch_rope_mxu's (a 1280-face sphere with surface queries, a
5120-face icosphere with half its queries at radius 1.6, where the screen
skips visits), at that file's tiles.

The oracle against mesh_tpu is its STREAMED MXU kernel in interpret mode
(``closest_point_pallas_bvh_stream_mxu``): its resident MXU kernel cannot
run in interpret mode on jax 0.9.0 (no ``pl.load``).  The resident walk
takes a subset of the streamed walk's leaves with the same answers, so
faces are held to the tie contract (test_torch_mxu's
``assert_mxu_contract``) and the screened and repaired counts to at most
the reference's.
"""

import functools

import numpy as np
import pytest
import torch

from mesh_tpu_torch.accel import rope_kernel as rk

from .test_torch_mxu import assert_mxu_contract
from .test_torch_rope_mxu import CASES, TILE_Q, _case

torch.set_num_threads(2)

LANES = (2, 4, 8)


@functools.lru_cache(maxsize=None)
def _ops(name):
    v, f, q = CASES[name]()
    return rk.rope_operands(v, f, q, tile_q=TILE_Q, device="cpu", mxu=True)


@functools.lru_cache(maxsize=None)
def _walk(name, use_bf16, lanes):
    """The resident plain walk of the case at ``lanes`` (None: the
    whole-leaf fold and screen) and the screen's pair counts."""
    counts = {}
    out = rk.rope_mxu_argmin_plain(_ops(name), None, use_bf16, counts,
                                   lanes=lanes)
    return out, counts


@pytest.mark.parametrize("use_bf16", [False, True])
@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_resident_lanes_equal_whole_leaf_resident(name, lanes, use_bf16):
    whole, _ = _walk(name, use_bf16, None)
    got, _ = _walk(name, use_bf16, lanes)
    assert len(got) == len(whole) == 4
    for a, b in zip(got, whole):
        assert a.dtype == b.dtype and torch.equal(a, b)
    leaves, full = whole[2], whole[3]
    assert int(leaves.sum()) > leaves.numel()           # tiles take leaves
    if not use_bf16:
        assert torch.equal(full, leaves)     # every taken leaf is visited


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_resident_split_screen_skips_the_whole_leaf_screens_visits(name,
                                                                   lanes):
    (_, _, leaves, full), whole_counts = _walk(name, True, None)
    (_, _, leaves_s, full_s), counts = _walk(name, True, lanes)
    assert torch.equal(leaves_s, leaves) and torch.equal(full_s, full)
    if name == "mixed":
        assert int(full.sum()) < int(leaves.sum())      # the screen skips
    # the same one-lane screen; each sub-lane stops at its own run's first
    # survivor: at least the one-lane screen's pairs, at most every pair of
    # every screened leaf
    assert counts["screen_pairs"] == whole_counts["screen_pairs"]
    assert "screen_lane_pairs" not in whole_counts
    assert counts["screen_lane_pairs"] >= counts["screen_pairs"]
    assert (counts["screen_lane_pairs"]
            <= int(leaves.sum()) * TILE_Q * _ops(name)["tile_f"])


@pytest.mark.parametrize("use_bf16", [False, True])
@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_resident_lanes_match_jax_stream_mxu(name, lanes, use_bf16):
    v, f, q, ref, ref_stats = _case(name, use_bf16)
    ops = _ops(name)
    (_, out_i, out_lv, full), _ = _walk(name, use_bf16, lanes)
    out = {k: x.numpy() for k, x in rk._rope_epilogue(ops, out_i,
                                                      out_lv).items()}
    assert out["tight"].all() and out["face"].dtype == np.int32
    assert assert_mxu_contract(ref, out, v, f, q) > 0.9
    # the resident walk takes a subset of the streamed walk's leaves, in
    # the same order, with the same running bests at each
    assert int(out_lv.sum()) <= ref_stats["screened"]
    assert int(full.sum()) <= ref_stats["repaired"]
    assert bool((out["pair_tests"] <= ref["pair_tests"]).all())
