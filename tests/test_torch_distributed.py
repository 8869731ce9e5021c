"""mesh_tpu_torch.parallel.distributed: process groups, meshes, placement
and the multi-process query, on the CPU.

The reference's tests/test_distributed.py and
tests/test_distributed_contract.py, ported: the single-process and
explicit-argument contracts of ``initialize_multihost`` and the host-side
math of ``_process_blocks`` run here (the count exchange monkeypatched);
the rest runs once in a world of 4 gloo ranks started the way ``torchrun``
starts one (its environment, joined by ``initialize_multihost()`` itself):
meshes, one-collective gathers, ``multihost_closest_faces_and_points``
with ragged counts and a zero-row rank against the reference's
single-device query (faces but at exact ties, points and sqdist within
1e-5) and bit-equal to the port's, and the engine's sharded lane on one
rank of the world.
"""

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from mesh_tpu.query import closest_faces_and_points as jax_closest

from mesh_tpu_torch.parallel import distributed
from mesh_tpu_torch.parallel import initialize_multihost
from mesh_tpu_torch.query import closest_kernel as ck

from ._torch_world import ROOT, run_world
from .fixtures import icosphere
from .test_torch_parallel import assert_tie_contract

RANKS = 4
#: each rank's row count: ragged, one rank with none
COUNTS = (37, 0, 120, 9)


def _body():
    v, f = icosphere(2)
    return (v * np.array([0.3, 0.2, 0.9])).astype(np.float32), f.astype(
        np.int32)


@pytest.fixture(scope="module")
def world():
    v, f = _body()
    rng = np.random.RandomState(7)
    inputs = {"body": (v, f),
              "multihost_points": [(rng.randn(n, 3) * 0.4).astype(np.float32)
                                   for n in COUNTS],
              "lane_points": (rng.randn(1500, 3) * 0.4).astype(np.float32)}
    results = run_world(RANKS,
                        "tests._torch_parallel_cases:distributed_world",
                        inputs, timeout=240, launcher=True)
    return inputs, results


@pytest.fixture
def no_launcher(monkeypatch):
    for name in distributed._LAUNCHER_ENV:
        monkeypatch.delenv(name, raising=False)


def test_initialize_single_host_degrades_to_false(no_launcher):
    assert initialize_multihost() is False


def test_initialize_explicit_args_propagate_errors():
    """A process_id outside the world is refused before any connection,
    in a fresh process, and also after a mesh started this process's own
    one-rank world."""
    code = (
        "from mesh_tpu_torch.parallel import initialize_multihost, "
        "make_device_mesh\n"
        "def bad():\n"
        "    try:\n"
        "        initialize_multihost(coordinator_address='127.0.0.1:1', "
        "num_processes=2, process_id=5)\n"
        "    except ValueError as err:\n"
        "        return 'ValueError' if 'outside' in str(err) else repr(err)\n"
        "    return 'no error'\n"
        "print(bad())\n"
        "make_device_mesh(device='cpu')\n"
        "print(bad())\n")
    env = {k: val for k, val in os.environ.items()
           if k not in distributed._LAUNCHER_ENV}
    out = subprocess.run([sys.executable, "-c", code], env=dict(
        env, PYTHONPATH=ROOT), cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.split() == ["ValueError", "ValueError"]


def test_launcher_group_is_live(world):
    _, res = world
    assert all(r["live"] is True for r in res)
    assert not any(r["jax_imported"] for r in res)


def test_launcher_group_replaces_a_private_world(world):
    """A mesh made before initialize_multihost() started a one-rank world;
    the launcher's world of every rank took its place."""
    _, res = world
    assert all(r["private_size"] == 1 for r in res)
    assert all(r["world"] == RANKS for r in res)


def test_global_device_mesh_1d_default(world):
    _, res = world
    assert all(r["mesh_1d"] == (("dp",), RANKS) for r in res)


def test_global_device_mesh_2d_with_shape(world):
    _, res = world
    assert all(r["mesh_2d"] == (("dp", "sp"), (RANKS // 2, 2)) for r in res)


def test_global_device_mesh_multi_axis_requires_shape(world):
    _, res = world
    assert all("shape is required" in r["needs_shape"] for r in res)


def test_gather_to_hosts_one_tree(world):
    _, res = world
    want_f = np.concatenate([np.arange(18, dtype=np.float32).reshape(6, 3)
                             + 100 * r for r in range(RANKS)])
    for r in res:
        got = r["gathered"]
        assert r["sharded_shape"] == (6 * RANKS, 3)
        np.testing.assert_array_equal(got["f"], want_f)
        assert got["f"].dtype == np.float32
        np.testing.assert_array_equal(got["i"], np.repeat(np.arange(RANKS),
                                                          2))
        np.testing.assert_array_equal(got["b"],
                                      np.arange(RANKS) % 2 == 0)
        np.testing.assert_array_equal(got["rep"], [1.0, 2.0])
        np.testing.assert_array_equal(got["np"], [7])


def test_multihost_ragged_counts_in_process_order(world):
    inp, res = world
    v, f = inp["body"]
    q = np.concatenate(inp["multihost_points"])
    out = res[0]["multihost"]
    for r in res[1:]:
        for key in out:
            np.testing.assert_array_equal(r["multihost"][key], out[key])
    assert out["face"].shape == (sum(COUNTS),)
    assert_tie_contract(jax_closest(v, f, q), out, v, f, q)
    single = ck.closest_point_kernel(
        torch.from_numpy(v), torch.from_numpy(f.astype(np.int64)),
        torch.from_numpy(q),
        assume_nondegenerate=ck.mesh_is_nondegenerate(v, f))
    for key in ("face", "part", "sqdist", "point"):
        np.testing.assert_array_equal(out[key], single[key].numpy())


def test_process_blocks_exchanged_between_processes(world):
    _, res = world
    for r in res:
        counts, blocks, rpd = r["blocks"]
        assert list(counts) == list(COUNTS)
        assert rpd == max(COUNTS) and list(blocks) == [rpd] * RANKS


def test_misordered_mesh_fails_loudly_in_a_world(world):
    _, res = world
    assert all("process order" in r["misordered"] for r in res)


def test_shard_lane_on_one_rank_of_a_world(world):
    """The lane runs on the submitting rank alone, with no collective: the
    other ranks never join, and the answer is the single-device path's,
    counted once."""
    _, res = world
    (faces_off, points_off), (faces_on, points_on) = res[0]["lane"]
    assert res[0]["lane_counted"] == 1
    np.testing.assert_array_equal(faces_on, faces_off)
    np.testing.assert_array_equal(points_on, points_off)


# -- the contract of the count exchange, without processes -------------------

def _fake_mesh(proc_order):
    return types.SimpleNamespace(mesh=torch.tensor(proc_order))


def test_misordered_mesh_fails_loudly():
    with pytest.raises(ValueError, match="process order"):
        distributed._process_blocks(_fake_mesh([0, 1, 0, 1]), 8, 2)


def test_single_process_blocks(monkeypatch):
    monkeypatch.setattr(distributed, "_process_count", lambda: 1)
    counts, blocks, rpd = distributed._process_blocks(_fake_mesh([0, 0]), 7,
                                                      2)
    assert list(counts) == [7]
    assert rpd == 4 and list(blocks) == [8]


def test_ragged_counts_across_processes(monkeypatch):
    monkeypatch.setattr(distributed, "_process_count", lambda: 2)
    monkeypatch.setattr(distributed, "_exchange_counts",
                        lambda row: np.array([[6000, 4], [4100, 4]]))
    counts, blocks, rpd = distributed._process_blocks(
        _fake_mesh([0, 0, 0, 0, 1, 1, 1, 1]), 6000, 4)
    assert list(counts) == [6000, 4100]
    assert rpd == 1500
    assert list(blocks) == [6000, 6000]
    keep = np.concatenate([np.arange(block) < n
                           for n, block in zip(counts, blocks)])
    assert keep.sum() == 10100 and keep.size == 12000


def test_zero_row_process(monkeypatch):
    monkeypatch.setattr(distributed, "_process_count", lambda: 2)
    monkeypatch.setattr(distributed, "_exchange_counts",
                        lambda row: np.array([[0, 4], [8, 4]]))
    counts, blocks, rpd = distributed._process_blocks(
        _fake_mesh([0, 0, 0, 0, 1, 1, 1, 1]), 0, 4)
    assert list(counts) == [0, 8]
    assert rpd == 2 and list(blocks) == [8, 8]
