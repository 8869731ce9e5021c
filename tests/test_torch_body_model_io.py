"""The body model's SMPL-family .npz interchange and MANO pose PCA
(models/body_model.py) against mesh_tpu's, on the CPU: files written by
one package load in the other, ``mano_pose_from_pca`` agrees at several
component counts, and a loaded model skins like the original.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import mesh_tpu.models.body_model as jbm

from mesh_tpu_torch import convert
from mesh_tpu_torch.models import body_model as tbm

torch.set_num_threads(2)

FIELDS = tbm.WEIGHT_NAMES + tbm.PCA_NAMES


def _basis(seed=0):
    """A random orthogonal 45 x 45 pose-PCA basis and a mean, float32."""
    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.randn(45, 45))
    return q.astype(np.float32), (rng.randn(45) * 0.1).astype(np.float32)


def _jax_model(family="mano", seed=0):
    model = jbm.synthetic_family_model(family, seed=seed)
    comps, mean = _basis(seed)
    return dataclasses.replace(model, hands_components=jnp.asarray(comps),
                               hands_mean=jnp.asarray(mean))


def _fields(jax_model):
    return {name: np.asarray(getattr(jax_model, name)) for name in FIELDS
            if getattr(jax_model, name) is not None}


def _assert_same_model(port, jax_model):
    for name in FIELDS:
        mine = getattr(port, name)
        if getattr(jax_model, name) is None:
            assert mine is None, name
            continue
        theirs = np.asarray(getattr(jax_model, name))
        assert mine.dtype == torch.from_numpy(theirs).dtype, name
        assert np.array_equal(mine.numpy(), theirs), name
    assert port.parents == tuple(jax_model.parents)


def test_reference_file_loads_in_the_port(tmp_path):
    path = tmp_path / "model.npz"
    ref = _jax_model()
    jbm.save_body_model_npz(ref, str(path))
    _assert_same_model(tbm.load_body_model_npz(str(path), device="cpu"), ref)


def test_port_file_loads_in_the_reference(tmp_path):
    path = tmp_path / "model.npz"
    ref = _jax_model(seed=1)
    port = convert.body_model_from_fields(_fields(ref), ref.parents,
                                          device="cpu")
    tbm.save_body_model_npz(port, str(path))
    _assert_same_model(port, jbm.load_body_model_npz(str(path)))


def test_model_without_basis_round_trips(tmp_path):
    path = tmp_path / "model.npz"
    port = tbm.synthetic_body_model(seed=2, device="cpu")
    tbm.save_body_model_npz(port, str(path))
    assert "hands_components" not in np.load(str(path)).files
    again = tbm.load_body_model_npz(str(path), device="cpu")
    assert again.hands_components is None and again.hands_mean is None
    ref = jbm.load_body_model_npz(str(path))
    _assert_same_model(again, ref)


def test_released_file_quirks_match_reference(tmp_path):
    """Sparse J_regressor, float64 payloads, aliases, flattened blend
    shapes and a uint32 root sentinel, as released files store them."""
    ref = _jax_model(family="smpl", seed=3)
    arrays = _fields(ref)
    parents = np.asarray(ref.parents, np.int64)
    kintree = np.stack([parents, np.arange(len(parents))]).astype(np.uint32)
    kintree[0, 0] = 2 ** 32 - 1
    path = tmp_path / "released.npz"
    np.savez(
        str(path),
        v_template=arrays["v_template"].astype(np.float64),
        shapedirs=arrays["shapedirs"].reshape(-1, arrays["shapedirs"].shape[-1]),
        posedirs=arrays["posedirs"],
        J_regressor=np.array(sp.csc_matrix(arrays["joint_regressor"]),
                             dtype=object),
        lbs_weights=arrays["lbs_weights"], faces=arrays["faces"].astype(
            np.uint32),
        kintree_table=kintree, hands_components=arrays["hands_components"],
        hands_mean=arrays["hands_mean"], extra_key=np.zeros(3))
    port = tbm.load_body_model_npz(str(path), device="cpu")
    theirs = jbm.load_body_model_npz(str(path))
    _assert_same_model(port, theirs)
    assert port.shapedirs.shape == ref.shapedirs.shape


def test_missing_key_and_urls_raise(tmp_path):
    path = tmp_path / "broken.npz"
    np.savez(str(path), v_template=np.zeros((3, 3)))
    with pytest.raises(KeyError, match="kintree_table"):
        tbm.load_body_model_npz(str(path), device="cpu")
    with pytest.raises(ValueError, match="local files"):
        tbm.load_body_model_npz("https://example.invalid/m.npz",
                                device="cpu")


@pytest.mark.parametrize("n", [6, 12, 45])
@pytest.mark.parametrize("flat_hand_mean", [False, True])
def test_mano_pose_from_pca_matches_reference(n, flat_hand_mean):
    ref = _jax_model(seed=4)
    port = convert.body_model_from_fields(_fields(ref), ref.parents,
                                          device="cpu")
    coeffs = (np.random.RandomState(n).randn(2, n) * 0.5).astype(np.float32)
    want = np.asarray(jbm.mano_pose_from_pca(ref, coeffs, flat_hand_mean))
    got = tbm.mano_pose_from_pca(port, coeffs, flat_hand_mean).numpy()
    assert got.shape == want.shape == (2, 16, 3)
    assert np.all(got[:, 0] == 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_mano_pose_needs_a_basis():
    with pytest.raises(ValueError, match="pose-PCA"):
        tbm.mano_pose_from_pca(tbm.synthetic_body_model(device="cpu"),
                               np.zeros(6))


def test_loaded_model_skins_like_the_original(tmp_path):
    path = tmp_path / "model.npz"
    ref = _jax_model(seed=5)
    original = convert.body_model_from_fields(_fields(ref), ref.parents,
                                              device="cpu")
    tbm.save_body_model_npz(original, str(path))
    loaded = tbm.load_body_model_npz(str(path), device="cpu")
    rng = np.random.RandomState(5)
    betas = torch.as_tensor(rng.randn(3, original.num_betas) * 0.3,
                            dtype=torch.float32)
    pose = tbm.mano_pose_from_pca(loaded, rng.randn(3, 12) * 0.5)
    for a, b in zip(tbm.lbs(original, betas, pose, device="cpu"),
                    tbm.lbs(loaded, betas, pose, device="cpu")):
        assert torch.equal(a, b)
