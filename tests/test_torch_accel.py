"""mesh_tpu_torch's BVH builder, rope walks and accel rung vs mesh_tpu, on
the CPU.

The builder is a numpy copy, so its arrays are held to bit-equality.  The
oracle for both rope walks is mesh_tpu's STREAMED rope kernel in interpret
mode (tile_q 64, tile_f 256): its resident kernel cannot run in interpret
mode on jax 0.9.0 (no ``pl.load``), and the two are bit-identical
by the reference's own contract.  ``bvh_closest_point`` (mesh_tpu's XLA
rope traversal) is a second, independent oracle.  Results are held to the
tie contract of test_torch_closest; the port's resident and streamed walks
are held to bit-identity with each other.
"""

import functools

import numpy as np
import pytest
import torch

from mesh_tpu.accel import build as jbuild
from mesh_tpu.accel import traverse as jtraverse
from mesh_tpu.accel.pallas_stream import closest_point_pallas_bvh_stream
from mesh_tpu.query import autotune as jautotune

from mesh_tpu_torch.accel import build as tbuild
from mesh_tpu_torch.accel import rope_kernel as rk
from mesh_tpu_torch.accel import traverse as ttraverse
from mesh_tpu_torch.query import autotune

from .test_torch_closest import assert_tie_contract
from .test_torch_culled import sphere, surface_queries

torch.set_num_threads(2)

RESULT_KEYS = ("face", "part", "point", "sqdist")


def _np(res):
    return {k: x.numpy() for k, x in res.items()}


@functools.lru_cache(maxsize=None)
def _case(n_buffers=2):
    """A 1280-face sphere, 300 surface-proximal queries, and mesh_tpu's
    streamed rope answer for them."""
    v, f = sphere(3, seed=50)
    q = surface_queries(v, f, 300, seed=51)
    ref = closest_point_pallas_bvh_stream(v, f, q, tile_q=64, tile_f=256,
                                          n_buffers=n_buffers, interpret=True)
    return v, f, q, {k: np.asarray(x) for k, x in ref.items()}


# -- the builder ------------------------------------------------------------

@pytest.mark.parametrize("leaf_size", [1, 8, 256, 5000])
def test_build_bvh_bit_equal_to_reference(leaf_size):
    v, f = sphere(3, seed=52)
    ref = jbuild.build_bvh(v, f, leaf_size=leaf_size)
    out = tbuild.build_bvh(v, f, leaf_size=leaf_size)
    assert out.kind == ref.kind == "bvh"
    assert out.digest == ref.digest == jbuild.topology_digest(v, f)
    assert out.meta == ref.meta
    assert set(out.arrays) == set(ref.arrays)
    for name, arr in ref.arrays.items():
        assert out.arrays[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(out.arrays[name], arr, err_msg=name)


def test_topology_digest_matches_reference():
    v, f = sphere(2, seed=53)
    assert tbuild.topology_digest(v, f) == jbuild.topology_digest(v, f)
    v2 = v.copy()
    v2[0, 0] += 1e-3
    assert tbuild.topology_digest(v2, f) != tbuild.topology_digest(v, f)


def test_get_index_cache_is_an_lru_of_eight():
    tbuild.clear_index_cache()
    v, f = sphere(2, seed=54)
    first = tbuild.get_index(v, f, leaf_size=16)
    assert tbuild.get_index(v, f, leaf_size=16) is first
    assert tbuild.get_index(v, f, leaf_size=32) is not first
    for k in range(8):
        tbuild.get_index(v + np.float32(k + 1), f, leaf_size=16)
    info = tbuild.index_cache_info()
    assert info["entries"] == 8 and info["bytes"] > 0
    assert tbuild.get_index(v, f, leaf_size=16) is not first   # evicted
    with pytest.raises(ValueError):
        tbuild.get_index(v, f, kind="grid")
    tbuild.clear_index_cache()
    assert tbuild.index_cache_info()["entries"] == 0


def test_index_tensors_are_uploaded_once():
    v, f = sphere(2, seed=55)
    idx = tbuild.build_bvh(v, f, leaf_size=64)
    arr = idx.on(torch.device("cpu"))
    assert idx.on(torch.device("cpu")) is arr
    np.testing.assert_array_equal(arr["order"].numpy(), idx.arrays["order"])
    with pytest.raises(AttributeError):
        idx.kind = "grid"


# -- the rope walks vs mesh_tpu --------------------------------------------

@pytest.mark.parametrize("walk", ["resident", "stream"])
def test_rope_plain_matches_jax_stream(walk):
    v, f, q, ref = _case()
    if walk == "resident":
        out = rk.closest_point_bvh_kernel(v, f, q, tile_q=64, device="cpu")
    else:
        out = rk.closest_point_bvh_stream_kernel(v, f, q, tile_q=64,
                                                 n_buffers=2, device="cpu")
    out = _np(out)
    assert out["tight"].all() and out["face"].dtype == np.int32
    assert assert_tie_contract(ref, out, v, f, q) > 0.5
    if walk == "stream":
        # the port replays the reference's refill: the same leaves per tile
        np.testing.assert_array_equal(out["pair_tests"], ref["pair_tests"])


def test_rope_matches_jax_xla_traversal():
    v, f, q, _ = _case()
    ref = jtraverse.bvh_closest_point(v, f, q)
    out = _np(rk.closest_point_bvh_kernel(v, f, q, tile_q=64, device="cpu"))
    assert_tie_contract(ref, out, v, f, q)


@pytest.mark.parametrize("n_buffers,tile_q", [(2, 64), (3, 32), (5, 64)])
def test_resident_and_stream_bit_identical(n_buffers, tile_q):
    v, f = sphere(3, seed=56)
    q = surface_queries(v, f, 400, seed=57)
    res = rk.closest_point_bvh_kernel(v, f, q, tile_q=tile_q, device="cpu")
    st = rk.closest_point_bvh_stream_kernel(v, f, q, tile_q=tile_q,
                                            n_buffers=n_buffers, device="cpu")
    for key in RESULT_KEYS:
        assert torch.equal(res[key], st[key]), key
    assert bool((st["pair_tests"] >= res["pair_tests"]).all())
    assert int(st["pair_tests"].sum()) < q.shape[0] * 2048  # leaves skipped


def test_stream_pair_tests_match_reference_ring_depths():
    v, f, q, _ = _case()
    _, _, _, ref = _case(n_buffers=5)
    out = rk.closest_point_bvh_stream_kernel(v, f, q, tile_q=64, n_buffers=5,
                                             device="cpu")
    np.testing.assert_array_equal(out["pair_tests"].numpy(),
                                  ref["pair_tests"])


def test_rope_plain_chunking_is_exact(monkeypatch):
    v, f, q, _ = _case()
    ops = rk.rope_operands(v, f, q, tile_q=64, device="cpu")
    whole = rk.rope_argmin_plain(ops, 3)
    monkeypatch.setitem(rk._PLAIN_PAIRS, "cpu", 64 * 256)
    for a, b in zip(rk.rope_argmin_plain(ops, 3), whole):
        assert torch.equal(a, b)


def test_rope_wrappers_validate_and_take_the_plain_version():
    v, f, q, _ = _case()
    before = dict(rk.LAUNCHES)
    out = rk.closest_point_bvh_kernel(v, f, q, tile_q=64, device="cpu")
    plain = rk.closest_point_bvh_plain(v, f, q, tile_q=64, device="cpu")
    assert all(torch.equal(out[k], plain[k]) for k in out)
    st = rk.closest_point_bvh_stream_plain(v, f, q, tile_q=64, device="cpu")
    assert torch.equal(st["face"], out["face"])
    assert rk.LAUNCHES == before
    with pytest.raises(ValueError, match="128"):
        rk.closest_point_bvh_stream_kernel(v, f, q, tile_f=200, device="cpu")
    with pytest.raises(ValueError, match="n_buffers"):
        rk.closest_point_bvh_stream_kernel(v, f, q, n_buffers=1, device="cpu")
    with pytest.raises(ValueError, match="n_buffers"):
        rk.closest_point_bvh_stream_kernel(v, f, q, n_buffers=17,
                                           device="cpu")
    fine = tbuild.build_bvh(v, f, leaf_size=8)
    with pytest.raises(ValueError, match="leaf_size"):
        rk.closest_point_bvh_kernel(v, f, q, index=fine, device="cpu")
    rebuilt = rk.closest_point_bvh_kernel(v, f, q, tile_q=64, index=fine,
                                          rebuild_mismatched=True,
                                          device="cpu")
    assert torch.equal(rebuilt["face"], out["face"])

def test_rope_entry_points_default_to_the_card(monkeypatch):
    v, f, q, _ = _case()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for entry in (rk.closest_point_bvh_kernel,
                  rk.closest_point_bvh_stream_kernel,
                  ttraverse.closest_faces_and_points_accel):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(v, f, q)


# -- routing and the accel rung ----------------------------------------------

@pytest.fixture
def reference_stream_defaults(monkeypatch, tmp_path):
    """The reference's stream tiles without a calibration file."""
    monkeypatch.setattr(jautotune, "_stream_measured", None)
    monkeypatch.setattr(jautotune, "_stream_cache_path",
                        lambda: str(tmp_path / "none.json"))


KNOB_SETTINGS = [
    {},
    {"MESH_TPU_BVH_STREAM_VMEM_MB": "32"},
    {"MESH_TPU_BVH_STREAM_VMEM_MB": "0.5"},
    {"MESH_TPU_BVH_STREAM_VMEM_MB": "junk"},
    {"MESH_TPU_BVH_STREAM_FORCE": "1"},
    {"MESH_TPU_BVH_STREAM_FORCE": "0", "MESH_TPU_BVH_STREAM_VMEM_MB": "64"},
    {"MESH_TPU_BVH_STREAM": "0"},
    {"MESH_TPU_BVH_STREAM": "off", "MESH_TPU_BVH_STREAM_FORCE": "1"},
    {"MESH_TPU_BVH_STREAM_BUFFERS": "5"},
    {"MESH_TPU_BVH_STREAM_BUFFERS": "1"},
]


@pytest.mark.parametrize("knobs", KNOB_SETTINGS,
                         ids=lambda k: ",".join("%s=%s" % (n[13:], v)
                                                for n, v in k.items()) or
                         "defaults")
def test_routing_matches_reference(monkeypatch, reference_stream_defaults,
                                   knobs):
    for name, value in knobs.items():
        monkeypatch.setenv(name, value)
    for n_faces in (1, 255, 256, 4096, 65536, 65537, 131072, 131073,
                    165000, 209304, 262144, 1 << 20):
        assert (ttraverse.pallas_bvh_variant(n_faces)
                == jtraverse.pallas_bvh_variant(n_faces)), n_faces
        assert (ttraverse.resident_rows_bytes(n_faces)
                == jtraverse.resident_rows_bytes(n_faces))
    assert ttraverse.pallas_bvh_max_faces() == jtraverse.pallas_bvh_max_faces()
    assert autotune.stream_tile_params() == jautotune.stream_tile_params()


def test_accel_rung_resident_and_stream_identical(monkeypatch):
    """The facade's two routes on one mesh: the budget knob picks the
    walk, and the answers are bit-identical."""
    v, f, q, ref = _case()
    monkeypatch.setenv("MESH_TPU_BVH_STREAM_VMEM_MB", "0.01")
    st, st_stats = ttraverse.closest_faces_and_points_accel(
        v, f, q, with_stats=True, device="cpu")
    monkeypatch.setenv("MESH_TPU_BVH_STREAM_VMEM_MB", "32")
    res, res_stats = ttraverse.closest_faces_and_points_accel(
        v, f, q, with_stats=True, device="cpu")
    assert st_stats["backend"] == "rope_stream"
    assert res_stats["backend"] == "rope_resident"
    assert res_stats["fallback"] == 0 and res_stats["tight_frac"] == 1.0
    assert st_stats["pair_tests"] >= res_stats["pair_tests"] > 0
    assert set(res) == set(RESULT_KEYS)
    for key in RESULT_KEYS:
        np.testing.assert_array_equal(st[key], res[key], err_msg=key)
    assert_tie_contract(ref, res, v, f, q)


def test_accel_rung_kinds(monkeypatch):
    v, f, q, _ = _case()
    with pytest.raises(NotImplementedError, match="grid"):
        ttraverse.closest_faces_and_points_accel(v, f, q, kind="grid",
                                                 device="cpu")
    idx = tbuild.build_bvh(v, f, leaf_size=8)
    out = ttraverse.closest_faces_and_points_accel(v, f, q, index=idx,
                                                   device="cpu")
    assert out["face"].shape == (q.shape[0],)
