"""mesh_tpu_torch geometry vs mesh_tpu, on the CPU: cross products, face
and vertex normals, Rodrigues rotations.  Same numpy inputs to both."""

import importlib

import numpy as np
import pytest
import torch

from mesh_tpu.models.body_model import _uv_sphere

from mesh_tpu_torch.geometry import (
    cross,
    rodrigues2rotmat,
    tri_normals,
    tri_normals_scaled,
    vert_normals,
)

# the reference's geometry package re-exports functions under its module
# names, so its modules are fetched by path
jcp, jrod, jtn, jvn = (importlib.import_module("mesh_tpu.geometry." + name)
                       for name in ("cross_product", "rodrigues",
                                    "tri_normals", "vert_normals"))

torch.set_num_threads(2)


def _mesh(seed=0):
    v, f = _uv_sphere(10, 8)
    rng = np.random.RandomState(seed)
    v = (v * np.array([0.3, 0.2, 0.9]) + rng.randn(*v.shape) * 0.01)
    return v.astype(np.float32), f.astype(np.int32)


def test_cross_matches_reference():
    rng = np.random.RandomState(0)
    a, b = rng.randn(2, 5, 3).astype(np.float32)
    # the same component formula in float32: equal to rounding
    np.testing.assert_allclose(cross(a, b, device="cpu").numpy(),
                               np.asarray(jcp.cross(a, b)), atol=1e-6)
    np.testing.assert_allclose(cross(a[0], b[0], device="cpu").numpy(),
                               np.asarray(jcp.cross(a[0], b[0])), atol=1e-6)


@pytest.mark.parametrize("batched", [False, True])
def test_tri_normals_match_reference(batched):
    v, f = _mesh(1)
    if batched:
        v = np.stack([v, v * 1.1, v[:, ::-1].copy()])
    # unit and area-scaled normals of ~0.1-sized faces: rounding only
    np.testing.assert_allclose(tri_normals(v, f, device="cpu").numpy(),
                               np.asarray(jtn.tri_normals(v, f)), atol=1e-6)
    np.testing.assert_allclose(
        tri_normals_scaled(v, f, device="cpu").numpy(),
        np.asarray(jtn.tri_normals_scaled(v, f)), atol=1e-7)


@pytest.mark.parametrize("batched", [False, True])
def test_vert_normals_match_reference(batched):
    v, f = _mesh(2)
    # one vertex that touches no face: both give it the zero vector
    v = np.vstack([v, [[5.0, 5.0, 5.0]]]).astype(np.float32)
    if batched:
        v = np.stack([v, v * 0.9])
    out = vert_normals(v, f, device="cpu").numpy()
    ref = np.asarray(jvn.vert_normals(v, f))
    # sums of a few incident area-scaled normals, normalized: float32
    # rounding and summation order only
    np.testing.assert_allclose(out, ref, atol=2e-6)
    assert np.all(out[..., -1, :] == 0) and np.all(ref[..., -1, :] == 0)
    unit = np.linalg.norm(out[..., :-1, :], axis=-1)
    np.testing.assert_allclose(unit, 1.0, atol=1e-6)


def test_rodrigues_matches_reference_including_taylor_branch():
    rng = np.random.RandomState(3)
    r = np.vstack([
        rng.randn(16, 3),
        rng.randn(4, 3) * 1e-5,    # |r|^2 below the 1e-8 Taylor switch
        np.zeros((1, 3)),
        [[np.pi, 0, 0]],
    ]).astype(np.float32)
    out = rodrigues2rotmat(r, device="cpu").numpy()
    ref = np.asarray(jrod.rodrigues2rotmat(r))
    # sin/cos differ in the last ulps between XLA's and PyTorch's CPU
    # kernels; entries are O(1)
    np.testing.assert_allclose(out, ref, atol=2e-6)
    np.testing.assert_array_equal(out[20], np.eye(3, dtype=np.float32))
    eye = np.einsum("nij,nkj->nik", out, out)
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape),
                               atol=1e-5)


def test_default_device_is_the_card():
    """Without device= the geometry entry points ask for CUDA, and on a
    host without it they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device runs")
    v, f = _mesh()
    for call in (lambda: vert_normals(v, f), lambda: tri_normals(v, f),
                 lambda: rodrigues2rotmat(np.zeros((2, 3), np.float32)),
                 lambda: cross(v[:3], v[3:6])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
