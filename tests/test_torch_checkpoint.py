"""mesh_tpu_torch.parallel.checkpoint (the reference's TestCheckpoint), on
the CPU: checkpoint, restore, one more step equals the uninterrupted run
bit for bit, on one device here and on a (2, 2) mesh in a world of 4 gloo
ranks (``_torch_world``), where the restore lands on a whole template
(placed by the step, the reference's mixed-placement bug) and on a placed
one, which only the mesh's first rank reads from disk.  The state that
starts the single-device round trip is the reference's, carried through
the converter.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mesh_tpu.parallel import fit as jfit

from mesh_tpu_torch.convert import FIT_PARAMS, fit_state_from_arrays
from mesh_tpu_torch.parallel import (
    init_fit_state,
    make_fit_step,
    restore_fit_state,
    save_fit_state,
)
from mesh_tpu_torch.parallel import fit

from ._torch_world import run_world
from .test_torch_parallel import _jax_model, _template

RANKS = 4


def _model():
    from mesh_tpu_torch.models import body_model as tbm

    return tbm.synthetic_body_model(seed=0, n_betas=4, n_joints=6,
                                    template=_template(), device="cpu")


def _target(batch):
    return (np.random.RandomState(0).randn(batch, 20, 3) * 0.5).astype(
        np.float32)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mesh_ckpt") / "ckpt")
    results = run_world(RANKS, "tests._torch_parallel_cases:checkpoint_world",
                        {"model_template": _template(), "fit_target":
                         _target(8), "path": path}, timeout=240)
    return path, results


def _assert_rows_equal(a, b):
    for name in FIT_PARAMS:
        np.testing.assert_array_equal(a[name], b[name])


def _rows(state):
    return {name: getattr(state, name).detach().numpy() for name in
            FIT_PARAMS}


def test_save_restore_resumes_bit_identically_single_device(tmp_path):
    """From the reference's state carried across, 3 steps, a checkpoint:
    restored parameters and Adam's state equal the live ones, and one more
    step from each is the same bits."""
    jm = _jax_model()
    target = _target(2)
    jstate, jopt = jfit.init_fit_state(jm, 2)
    jstate, _ = jfit.make_fit_step(jm, jopt)(jstate, jnp.asarray(target))
    adam = jstate.opt_state[0]
    state = fit_state_from_arrays(
        {k: np.asarray(getattr(jstate, k)) for k in FIT_PARAMS},
        np.asarray(adam.count), {k: np.asarray(adam.mu[k]) for k in
                                 FIT_PARAMS},
        {k: np.asarray(adam.nu[k]) for k in FIT_PARAMS}, device="cpu")
    model = _model()
    step = make_fit_step(model, fit.adam, device="cpu")
    for _ in range(3):
        state, _ = step(state, target)
    path = save_fit_state(str(tmp_path / "ckpt"), state, step=3)
    assert os.path.isdir(path)
    template, _ = init_fit_state(model, 2, device="cpu")
    restored, at_step = restore_fit_state(path, template)
    assert at_step == 3
    _assert_rows_equal(_rows(restored), _rows(state))
    live_sd, rest_sd = (s.opt_state.state_dict() for s in (state, restored))
    assert live_sd["param_groups"] == rest_sd["param_groups"]
    for k, st in live_sd["state"].items():
        for name, val in st.items():
            assert torch.equal(val, rest_sd["state"][k][name]), name
    live_next, live_loss = step(state, target)
    rest_next, rest_loss = step(restored, target)
    _assert_rows_equal(_rows(rest_next), _rows(live_next))
    assert float(rest_loss) == float(live_loss)


def test_force_and_directory(tmp_path):
    model = _model()
    state, _ = init_fit_state(model, 1, device="cpu")
    path = save_fit_state(str(tmp_path / "ckpt"), state, step=1)
    save_fit_state(path, state, step=2)            # force=True replaces
    assert restore_fit_state(path, state)[1] == 2
    with pytest.raises(FileExistsError):
        save_fit_state(path, state, step=3, force=False)
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]


def test_save_restore_resumes_bit_identically_on_a_mesh(world):
    path, res = world
    assert all(r["path"] == path and r["is_dir"] for r in res)
    for r in res:
        rows, at, sd = r["whole_restored"]
        assert at == 3
        assert rows["betas"].shape[0] == 8           # every body's rows
        assert {k: len(st) for k, st in sd["state"].items()} == {
            0: 3, 1: 3, 2: 3}
        _assert_rows_equal(r["placed_rows"], r["live_rows"])
        for name in ("whole", "placed"):
            got, live = r[name + "_next"], r["live_next"]
            _assert_rows_equal(got, live)
            assert got["loss"] == live["loss"]
    assert not any(r["jax_imported"] for r in res)
