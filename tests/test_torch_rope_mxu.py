"""mesh_tpu_torch's MXU rope walks (``rope_mxu_faces``) vs mesh_tpu, on the
CPU.

The oracle for both port walks, resident and streamed, with and without the
bf16 screen, is mesh_tpu's STREAMED MXU rope kernel in interpret mode
(``closest_point_pallas_bvh_stream_mxu``, tile_q 64, tile_f 256): its
resident MXU kernel cannot run in interpret mode on jax 0.9.0 (no
``pl.load``), and the reference promises the two bit-identical
(bench.py:1365-1389 raises otherwise).  Results are held to the tie
contract with points where they are defined (test_torch_mxu's
``assert_mxu_contract``); the port's four walks are held to bit-identity
with each other.  Two cases: a 1280-face sphere with 300 surface-proximal
queries, and a 5120-face icosphere with half its 512 queries near the
surface and half at radius 1.6, where the screen skips leaf visits.
"""

import functools

import numpy as np
import pytest
import torch

from mesh_tpu.accel.pallas_stream import closest_point_pallas_bvh_stream_mxu
from mesh_tpu.sphere import _icosphere

from mesh_tpu_torch import Mesh
from mesh_tpu_torch.accel import rope_kernel as rk
from mesh_tpu_torch.accel import traverse as ttraverse
from mesh_tpu_torch.accel.build import build_bvh
from mesh_tpu_torch.obs.metrics import REGISTRY
from mesh_tpu_torch.query import culled as tculled

from .test_torch_culled import sphere, surface_queries
from .test_torch_mxu import assert_mxu_contract, clean_knobs  # noqa: F401

torch.set_num_threads(2)

RESULT_KEYS = ("face", "part", "point", "sqdist")
TILE_Q = 64
WALKS = {"resident": None, "stream": 2}


def _sphere_case():
    v, f = sphere(3, seed=50)
    return v, f, surface_queries(v, f, 300, seed=51)


def _mixed_case():
    v, f = _icosphere(4)
    v, f = np.asarray(v, np.float32), np.asarray(f, np.int32)
    rng = np.random.RandomState(0)
    d = rng.randn(512, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r = np.concatenate([1.0 + 0.002 * rng.randn(256), np.full(256, 1.6)])
    return v, f, (d * r[:, None]).astype(np.float32)


CASES = {"sphere": _sphere_case, "mixed": _mixed_case}


@functools.lru_cache(maxsize=None)
def _case(name, use_bf16):
    """The case's mesh and queries, and mesh_tpu's streamed MXU answer and
    stats for them (about 2 s a call)."""
    v, f, q = CASES[name]()
    ref, stats = closest_point_pallas_bvh_stream_mxu(
        v, f, q, tile_q=TILE_Q, tile_f=256, n_buffers=2, interpret=True,
        use_bf16=use_bf16, with_stats=True)
    return v, f, q, {k: np.asarray(x) for k, x in ref.items()}, stats


@functools.lru_cache(maxsize=None)
def _port(name, walk, use_bf16, tile_q=TILE_Q):
    """The port's plain walk on the case (the accel rung's tiles are
    tile_q 128, tile_f 256 and a ring of 2)."""
    v, f, q = CASES[name]()
    if WALKS[walk] is None:
        out, stats = rk.closest_point_bvh_mxu_kernel(
            v, f, q, tile_q=tile_q, use_bf16=use_bf16, with_stats=True,
            device="cpu")
    else:
        out, stats = rk.closest_point_bvh_stream_mxu_kernel(
            v, f, q, tile_q=tile_q, n_buffers=WALKS[walk], use_bf16=use_bf16,
            with_stats=True, device="cpu")
    return {k: x.numpy() for k, x in out.items()}, stats


# -- the plain walks vs mesh_tpu ----------------------------------------------

@pytest.mark.parametrize("use_bf16", [False, True])
@pytest.mark.parametrize("walk", sorted(WALKS))
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_jax_stream_mxu(name, walk, use_bf16):
    v, f, q, ref, ref_stats = _case(name, use_bf16)
    out, stats = _port(name, walk, use_bf16)
    assert out["tight"].all() and out["face"].dtype == np.int32
    assert assert_mxu_contract(ref, out, v, f, q) > 0.9
    if walk == "stream":
        # the port replays the reference's refill and screen: the same
        # leaves per tile, and the same screening decisions
        np.testing.assert_array_equal(out["pair_tests"], ref["pair_tests"])
        assert stats == ref_stats
    else:
        # the resident walk takes a subset of the streamed walk's leaves,
        # in the same order, with the same running bests at each
        assert stats["screened"] <= ref_stats["screened"]
        assert stats["repaired"] <= ref_stats["repaired"]
    if not use_bf16:
        assert stats["repaired"] == stats["screened"]


@pytest.mark.parametrize("name", sorted(CASES))
def test_four_walks_bit_identical(name):
    runs = {(w, b): _port(name, w, b) for w in WALKS for b in (False, True)}
    base, base_stats = runs["resident", False]
    for (walk, use_bf16), (out, stats) in runs.items():
        for key in RESULT_KEYS:
            np.testing.assert_array_equal(out[key], base[key],
                                          err_msg="%s %s %s"
                                          % (walk, use_bf16, key))
        # the screen changes no leaf the walk takes, only the full visits
        assert stats["screened"] == runs[walk, False][1]["screened"]
        assert stats["repaired"] <= stats["screened"]
    assert (runs["stream", False][1]["screened"]
            >= base_stats["screened"])


def test_bf16_screen_skips_visits_on_mixed_radii():
    """Queries at radius 1.6 keep a loose running best through their
    first leaves; the screen skips the leaves that cannot hold a better
    face, and the reference skips the same ones."""
    _, _, _, _, ref_stats = _case("mixed", True)
    _, stats = _port("mixed", "stream", True)
    assert stats["repaired"] < stats["screened"]
    assert ref_stats["repaired"] < ref_stats["screened"]


def test_mxu_walk_agrees_with_vpu_walk():
    """The MXU visit and the fast tile's visit round differently, so the
    two walks agree up to ties."""
    v, f, q = _sphere_case()
    vpu = {k: x.numpy() for k, x in rk.closest_point_bvh_kernel(
        v, f, q, tile_q=TILE_Q, device="cpu").items()}
    out, _ = _port("sphere", "resident", False)
    assert assert_mxu_contract(vpu, out, v, f, q) > 0.9


def test_screen_pairs_count():
    v, f, q = _mixed_case()
    ops = rk.rope_operands(v, f, q, tile_q=TILE_Q, device="cpu", mxu=True)
    counts = {}
    d, i, leaves, full = rk.rope_mxu_argmin_plain(ops, 2, True, counts)
    screened = int(leaves.sum())
    assert screened * TILE_Q <= counts["screen_pairs"]
    assert counts["screen_pairs"] <= screened * TILE_Q * ops["tile_f"]
    d2, i2, leaves2, full2 = rk.rope_mxu_argmin_plain(ops, 2, False)
    assert torch.equal(d, d2) and torch.equal(i, i2)
    assert torch.equal(leaves, leaves2) and torch.equal(full2, leaves2)
    assert bool((full <= leaves).all())


# -- wrappers -----------------------------------------------------------------

def test_wrappers_validate_and_take_the_plain_version(monkeypatch):
    v, f, q = _sphere_case()
    before = dict(rk.LAUNCHES)
    ops = rk.rope_operands(v, f, q, tile_q=TILE_Q, device="cpu", mxu=True)
    assert ops["rec"].shape == (2048, 24)        # 8 leaves of 256 faces
    assert ops["p2"].shape == ops["seed"].shape and "rows" not in ops
    for n_buffers in (None, 3):
        for use_bf16 in (False, True):
            got = rk.rope_mxu_argmin(ops, n_buffers, use_bf16)
            want = rk.rope_mxu_argmin_plain(ops, n_buffers, use_bf16)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    plain = rk.closest_point_bvh_stream_mxu_plain(v, f, q, tile_q=TILE_Q,
                                                  device="cpu")
    out, _ = _port("sphere", "stream", False)
    assert all(np.array_equal(plain[k].numpy(), out[k]) for k in RESULT_KEYS)
    assert rk.LAUNCHES == before
    with pytest.raises(ValueError, match="128"):
        rk.closest_point_bvh_stream_mxu_kernel(v, f, q, tile_f=200,
                                               device="cpu")
    with pytest.raises(ValueError, match="n_buffers"):
        rk.closest_point_bvh_stream_mxu_kernel(v, f, q, n_buffers=1,
                                               device="cpu")
    # the ring must fit the walk's shared memory: 9 slots of 24 KB do
    rk.rope_mxu_argmin_plain(ops, 9)
    with pytest.raises(ValueError, match="shared memory"):
        rk.rope_mxu_argmin(ops, 10)
    with pytest.raises(ValueError, match="shared memory"):
        rk.closest_point_bvh_mxu_kernel(v, f, q, tile_f=4096, device="cpu")
    with pytest.raises(ValueError, match="rope_mxu_faces"):
        rk.rope_mxu_argmin(dict(ops, p2=ops["p2"][:-1]))
    fine = build_bvh(v, f, leaf_size=8)
    with pytest.raises(ValueError, match="leaf_size"):
        rk.closest_point_bvh_mxu_kernel(v, f, q, index=fine, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (rk.closest_point_bvh_mxu_kernel,
                  rk.closest_point_bvh_stream_mxu_kernel):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(v, f, q)


# -- routing: the accel rung and the Mesh facade under MESH_TPU_MXU ----------

def _repair_series(kind):
    counter = REGISTRY.counter("mesh_tpu_query_mxu_repair_total")
    return {o: counter.value(kind=kind, outcome=o)
            for o in ("repaired", "skipped")}


@pytest.mark.parametrize("use_bf16", [False, True])
@pytest.mark.parametrize("walk", sorted(WALKS))
def test_accel_rung_routes_to_mxu_rope(clean_knobs, walk, use_bf16):
    v, f, q = _mixed_case()
    clean_knobs.setenv("MESH_TPU_MXU", "1")
    clean_knobs.setenv("MESH_TPU_MXU_CROSSOVER_FACES", "1000")
    clean_knobs.setenv("MESH_TPU_BVH_STREAM_VMEM_MB",
                       "32" if walk == "resident" else "0.01")
    if use_bf16:
        clean_knobs.setenv("MESH_TPU_MXU_BF16", "1")
    kind = "bvh" if walk == "resident" else "stream"
    before = _repair_series(kind)
    out, stats = ttraverse.closest_faces_and_points_accel(
        v, f, q, with_stats=True, device="cpu")
    delta = {o: _repair_series(kind)[o] - before[o] for o in before}
    assert stats["backend"] == "rope_%s_mxu" % walk
    assert stats["fallback"] == 0
    want, want_stats = _port("mixed", walk, use_bf16, 128)
    for key in RESULT_KEYS:
        np.testing.assert_array_equal(out[key], want[key], err_msg=key)
    assert stats["pair_tests"] == int(want["pair_tests"].sum())
    if use_bf16:
        assert delta == {"repaired": want_stats["repaired"],
                         "skipped": want_stats["screened"]
                         - want_stats["repaired"]}
        assert delta["skipped"] > 0
    else:
        assert delta == {"repaired": 0, "skipped": 0}


@pytest.mark.parametrize("use_bf16", [False, True])
def test_mesh_facade_reaches_mxu_rope(clean_knobs, use_bf16):
    """``Mesh.closest_faces_and_points`` through the auto ladder's accel
    rung to the MXU rope under the knob, and to the VPU rope below the
    MXU crossover.  The auto ladder is the facade's direct route, which
    MESH_TPU_NO_ENGINE=1 selects (the query engine never takes the
    BVH)."""
    clean_knobs.setenv("MESH_TPU_NO_ENGINE", "1")
    v, f, q = _mixed_case()
    clean_knobs.setenv("MESH_TPU_ACCEL_MIN_FACES", "4096")
    clean_knobs.setenv("MESH_TPU_MXU", "1")
    clean_knobs.setenv("MESH_TPU_MXU_CROSSOVER_FACES", "1000")
    clean_knobs.setenv("MESH_TPU_BVH_STREAM_VMEM_MB", "0.01")
    if use_bf16:
        clean_knobs.setenv("MESH_TPU_MXU_BF16", "1")
    before = _repair_series("stream")
    tculled.STRATEGY.clear()
    faces, points = Mesh(v, f, device="cpu").closest_faces_and_points(q)
    assert tculled.STRATEGY == {"accel_bvh": 1}
    want, want_stats = _port("mixed", "stream", use_bf16, 128)
    assert faces.dtype == np.uint32 and faces.shape == (1, q.shape[0])
    assert np.array_equal(faces[0], want["face"].astype(np.uint32))
    assert np.array_equal(points, want["point"].astype(np.float64))
    skipped = _repair_series("stream")["skipped"] - before["skipped"]
    assert skipped == (want_stats["screened"] - want_stats["repaired"]
                       if use_bf16 else 0)
    clean_knobs.setenv("MESH_TPU_MXU_CROSSOVER_FACES", "8000")
    out, stats = ttraverse.closest_faces_and_points_accel(
        v, f, q, with_stats=True, device="cpu")
    assert stats["backend"] == "rope_stream"
