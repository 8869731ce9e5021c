"""The resident rope_faces entry's sub-lane design on the CPU: its plain
version (``rope_lanes_plain``) against the whole-leaf plain walk and
against mesh_tpu.

``rope_lanes_plain(ops, S)`` splits each leaf's costs into S contiguous
runs, reduces each to (minimum, lowest position) and merges the runs by
(distance, position) before one strict ``<``, as the CUDA kernel's S
sub-lanes per query do; it must equal ``rope_argmin_plain`` (the walk the
kernel replaced, one thread folding the whole leaf) bit for bit in
distances, sorted face positions and leaves per query tile, for every S.
The tie case triplicates every face, so that equal-cost copies sit at
consecutive sorted positions and many straddle a run or a leaf boundary:
the lowest sorted position must win.  The oracle from mesh_tpu is its
STREAMED rope kernel in interpret mode, as in test_torch_accel (its
resident kernel cannot run in interpret mode on jax 0.9.0: no
``pl.load``; the reference promises the two bit-identical), held to the
tie contract with points where they are defined (test_torch_mxu's
``assert_mxu_contract``: two tied faces have different closest points).
"""

import functools

import numpy as np
import pytest
import torch

from mesh_tpu.accel.pallas_stream import closest_point_pallas_bvh_stream

from mesh_tpu_torch.accel import rope_kernel as rk

from .test_torch_culled import sphere, surface_queries
from .test_torch_mxu import assert_mxu_contract
from .test_torch_self_intersect import _posed_small_body

torch.set_num_threads(2)

TILE_Q, TILE_F = 32, 64


def _sphere_case():
    v, f = sphere(3, seed=60)
    return v, f, surface_queries(v, f, 300, seed=61)


def _body_case():
    _, tv, f = _posed_small_body()
    v = tv.numpy().astype(np.float32)
    return v, f, surface_queries(v, f, 300, seed=62, noise=0.01)


def _tied_case():
    """Every face of a small icosphere three times (the same vertex ids):
    each copy's cost is bit-identical, and the stable Morton order puts
    the copies at consecutive sorted positions."""
    v, f = sphere(2, seed=63)
    f3 = np.concatenate([f, f, f]).astype(np.int32)
    return v, f3, surface_queries(v, f, 400, seed=64)


CASES = {"icosphere": _sphere_case, "posed_body": _body_case,
         "tied": _tied_case}


@functools.lru_cache(maxsize=None)
def _case(name, tile_f=TILE_F):
    v, f, q = CASES[name]()
    ops = rk.rope_operands(v, f, q, tile_q=TILE_Q, tile_f=tile_f,
                           device="cpu")
    return v, f, q, ops, rk.rope_argmin_plain(ops)


@pytest.mark.parametrize("lanes", rk.LANES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_lanes_plain_equals_whole_leaf_walk(name, lanes):
    *_, ops, whole = _case(name)
    got = rk.rope_lanes_plain(ops, lanes)
    for a, b in zip(got, whole):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(whole[2].sum()) > whole[2].numel()      # tiles take leaves


@pytest.mark.parametrize("lanes", rk.LANES)
def test_ties_across_runs_and_leaves_go_to_the_lowest_position(lanes):
    v, f, q, ops, whole = _case("tied")
    d, i, _ = rk.rope_lanes_plain(ops, lanes)
    assert torch.equal(i, whole[1]) and torch.equal(d, whole[0])
    # the sorted positions of each face's three copies
    base = ops["order_p"].long() % (f.shape[0] // 3)
    n_q = q.shape[0]
    win = i[:n_q].long()
    group = (base[:, None] == base[win][None, :])          # [Fp, n_q]
    pos = torch.arange(base.shape[0])[:, None].expand_as(group)
    lo = torch.where(group, pos, base.shape[0]).amin(dim=0)
    hi = torch.where(group, pos, -1).amax(dim=0)
    assert torch.equal(win, lo)                  # the lowest copy wins
    run = TILE_F // lanes
    if lanes > 1:
        assert int((lo // run != hi // run).sum()) > 0
    assert int((lo // TILE_F != hi // TILE_F).sum()) > 0


@pytest.mark.parametrize("lanes", [1, 8])
@pytest.mark.parametrize("name", ["icosphere", "posed_body"])
def test_lanes_plain_matches_jax_stream(name, lanes):
    v, f, q, ops, _ = _case(name, tile_f=256)
    ref = closest_point_pallas_bvh_stream(v, f, q, tile_q=64, tile_f=256,
                                          n_buffers=2, interpret=True)
    ref = {k: np.asarray(x) for k, x in ref.items()}
    _, out_i, out_lv = rk.rope_lanes_plain(ops, lanes)
    out = {k: x.numpy() for k, x in rk._rope_epilogue(ops, out_i,
                                                      out_lv).items()}
    assert out["tight"].all()
    assert assert_mxu_contract(ref, out, v, f, q) > 0.5


def test_rope_argmin_refuses_lanes_it_cannot_launch():
    *_, ops, whole = _case("icosphere")
    with pytest.raises(ValueError, match="lanes"):
        rk.rope_argmin(ops, None, lanes=3)            # not one of LANES
    with pytest.raises(ValueError, match="lanes"):
        rk.rope_argmin(ops, None, lanes=16)
    odd = dict(ops, tile_f=36)
    with pytest.raises(ValueError, match="lanes"):
        rk._check_lanes(odd, 8)                       # 8 does not divide 36
    wide = dict(ops, tile_q=256)
    with pytest.raises(ValueError, match="1024"):
        rk._check_lanes(wide, 8)                      # 2048 threads
    for a, b in zip(rk.rope_argmin(ops, 2, lanes=2), rk.rope_argmin_plain(
            ops, 2)):                                 # streamed entry
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="lanes"):
        rk.rope_lanes_plain(ops, 5)
    # on CPU operands the wrapper keeps returning the whole-leaf plain walk
    before = dict(rk.LAUNCHES)
    for lanes in (None, 4):
        for a, b in zip(rk.rope_argmin(ops, None, lanes=lanes), whole):
            assert torch.equal(a, b)
    assert rk.LAUNCHES == before


@pytest.mark.parametrize("n_tiles,tile_q,tile_f,want", [
    (32, 128, 256, 4),      # an avatar frame: 4096 queries
    (1, 128, 256, 4),
    (512, 128, 256, 4),     # the scan: 65,536 queries
    (32, 128, 30, 2),       # 4 does not divide tile_f
    (32, 256, 256, 4),      # 1024 threads a block
    (32, 1024, 256, 1),
    (4096, 128, 256, 4),    # the pick does not depend on the grid
])
def test_resident_lanes_fill_the_card(n_tiles, tile_q, tile_f, want):
    assert rk.picked_lanes(tile_q, tile_f) == want
    _check_lanes_ok(tile_q, tile_f, want)


def _check_lanes_ok(tile_q, tile_f, lanes):
    rk._check_lanes({"tile_q": tile_q, "tile_f": tile_f}, lanes)


def test_resident_lanes_are_the_fewest_that_reach_the_target():
    """The pick is the most of LANES up to PICKED_LANES_MAX that the
    kernel can launch at these tiles: every larger one is refused or above
    the cap."""
    for tile_q in (32, 64, 128, 256, 512, 1024):
        for tile_f in (8, 30, 64, 256, 258):
            s = rk.picked_lanes(tile_q, tile_f)
            assert s in rk.LANES and s <= rk.PICKED_LANES_MAX
            _check_lanes_ok(tile_q, tile_f, s)
            for x in rk.LANES:
                if s < x <= rk.PICKED_LANES_MAX:
                    with pytest.raises(ValueError, match="lanes"):
                        _check_lanes_ok(tile_q, tile_f, x)
