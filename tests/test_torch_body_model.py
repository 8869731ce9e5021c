"""mesh_tpu_torch body model vs mesh_tpu, on the CPU: the synthetic weights
(bit-identical, directly and through convert.py) and the lbs forward pass."""

import numpy as np
import pytest
import torch

from mesh_tpu.models import body_model as jbm

from mesh_tpu_torch.convert import body_model_from_fields
from mesh_tpu_torch.models import body_model as tbm

torch.set_num_threads(2)


def _template():
    v, f = jbm._uv_sphere(12, 10)
    return v * np.array([0.3, 0.2, 0.9]), f


def _jax_fields(model):
    return {name: np.asarray(getattr(model, name))
            for name in tbm.WEIGHT_NAMES}


def _assert_bit_identical(fields, model):
    for name in tbm.WEIGHT_NAMES:
        ref = fields[name]
        got = getattr(model, name).numpy()
        assert got.dtype == ref.dtype, name
        assert got.shape == ref.shape, name
        assert got.tobytes() == ref.tobytes(), name


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_weights_bit_identical(seed):
    """Same seed, same numpy code: the full SMPL-sized weights agree bit
    for bit, both when the port draws them and when convert.py carries the
    JAX model's arrays over."""
    jm = jbm.synthetic_body_model(seed=seed)
    fields = _jax_fields(jm)
    own = tbm.synthetic_body_model(seed=seed, device="cpu")
    carried = body_model_from_fields(fields, jm.parents, device="cpu")
    for model in (own, carried):
        _assert_bit_identical(fields, model)
        assert model.parents == jm.parents
        assert (model.num_vertices, model.num_joints, model.num_betas) == (
            jm.num_vertices, jm.num_joints, jm.num_betas)
    assert own.faces.dtype == torch.int32


def test_convert_rejects_missing_fields():
    fields = _jax_fields(jbm.synthetic_body_model(seed=1,
                                                  template=_template()))
    fields.pop("posedirs")
    with pytest.raises(KeyError, match="posedirs"):
        body_model_from_fields(fields, (-1,), device="cpu")


def test_body_model_is_a_module_with_buffers():
    model = tbm.synthetic_body_model(seed=2, template=_template(),
                                     device="cpu")
    assert isinstance(model, torch.nn.Module)
    assert set(dict(model.named_buffers())) == set(tbm.WEIGHT_NAMES)
    assert list(model.parameters()) == []
    assert model.to(torch.float64).v_template.dtype == torch.float64


@pytest.mark.parametrize("with_trans", [False, True])
def test_lbs_matches_reference(with_trans):
    template = _template()
    jm = jbm.synthetic_body_model(seed=4, template=template)
    tm = tbm.synthetic_body_model(seed=4, template=template, device="cpu")
    rng = np.random.RandomState(5)
    betas = (rng.randn(3, 10) * 0.3).astype(np.float32)
    pose = (rng.randn(3, 24, 3) * 0.2).astype(np.float32)
    pose[0] = 0.0                               # rest pose: Taylor branch
    trans = (rng.randn(3, 3) * 0.1).astype(np.float32) if with_trans else None
    jv, jj = jbm.lbs(jm, betas, pose, trans)
    tv, tj = tbm.lbs(tm, betas, pose, trans, device="cpu")
    # float32 products down a 24-joint chain at HIGHEST vs full float32:
    # summation order differs, values are metre-scale
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_allclose(tj.numpy(), np.asarray(jj), atol=1e-5)
    assert tv.shape == (3, template[0].shape[0], 3)


@pytest.mark.parametrize("caller_tf32", [False, True])
def test_lbs_leaves_the_callers_tf32_settings(caller_tf32):
    """lbs runs its products with TF32 off but hands the process-wide
    flags back as the caller set them."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = matmul.allow_tf32, cudnn.allow_tf32
    model = tbm.synthetic_body_model(seed=6, template=_template(),
                                     device="cpu")
    try:
        matmul.allow_tf32 = cudnn.allow_tf32 = caller_tf32
        tbm.lbs(model, np.zeros(10), np.zeros((24, 3)), device="cpu")
        assert (matmul.allow_tf32, cudnn.allow_tf32) == (caller_tf32,
                                                         caller_tf32)
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


def test_lbs_wants_the_model_on_its_device():
    model = tbm.synthetic_body_model(seed=6, template=_template(),
                                     device="cpu")
    with pytest.raises((ValueError, RuntimeError)):
        tbm.lbs(model, np.zeros(10), np.zeros((24, 3)), device="meta")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbm.synthetic_body_model(seed=0, template=_template())
    model = tbm.synthetic_body_model(seed=0, template=_template(),
                                     device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbm.lbs(model, np.zeros(10), np.zeros((24, 3)))
