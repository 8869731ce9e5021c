"""An empty query set (Q = 0, or S = 0 scan points) through every entry
point of the port, on the CPU: the reference's empty shapes and dtypes,
on every rung of the closest-point ladder (brute force, sphere-culled,
the resident and the streamed rope walk, the MXU rung), the search
trees, the batched facades and the diff wrappers.  The JAX package's
own answers on the same empty inputs are the expected ones."""

import numpy as np
import pytest
import torch

import mesh_tpu as J
from mesh_tpu import diff as jdiff

import mesh_tpu_torch as T
from mesh_tpu_torch import diff

from .fixtures import icosphere

torch.set_num_threads(2)

V, F = icosphere(2)
EMPTY = np.zeros((0, 3))

#: knobs that route the ladder to each rung on this small mesh
RUNGS = {
    "brute": {},
    "culled": {"MESH_TPU_BRUTE_MAX_FACES": "10"},
    "bvh_resident": {"MESH_TPU_ACCEL_MIN_FACES": "10"},
    "bvh_stream": {"MESH_TPU_ACCEL_MIN_FACES": "10",
                   "MESH_TPU_BVH_STREAM_FORCE": "1"},
    "mxu": {"MESH_TPU_MXU": "1", "MESH_TPU_MXU_CROSSOVER_FACES": "1"},
    "mxu_bf16": {"MESH_TPU_MXU": "1", "MESH_TPU_MXU_BF16": "1",
                 "MESH_TPU_MXU_CROSSOVER_FACES": "1"},
}

#: entry point -> (reference call, port call) on a mesh (v, f)
FACADES = {
    "Mesh.closest_faces_and_points": (
        lambda: J.Mesh(v=V, f=F).closest_faces_and_points(EMPTY),
        lambda: T.Mesh(v=V, f=F, device="cpu").closest_faces_and_points(
            EMPTY)),
    "Mesh.closest_points": (
        lambda: J.Mesh(v=V, f=F).closest_points(EMPTY),
        lambda: T.Mesh(v=V, f=F, device="cpu").closest_points(EMPTY)),
    "AabbTree.nearest": (
        lambda: J.Mesh(v=V, f=F).compute_aabb_tree().nearest(EMPTY, True),
        lambda: T.Mesh(v=V, f=F, device="cpu").compute_aabb_tree().nearest(
            EMPTY, True)),
}

#: entry points off the ladder
OTHERS = {
    "Mesh.closest_vertices": (
        lambda: J.Mesh(v=V, f=F).closest_vertices(EMPTY),
        lambda: T.Mesh(v=V, f=F, device="cpu").closest_vertices(EMPTY)),
    "AabbTree.nearest_alongnormal": (
        lambda: J.Mesh(v=V, f=F).compute_aabb_tree().nearest_alongnormal(
            EMPTY, EMPTY),
        lambda: T.Mesh(v=V, f=F, device="cpu").compute_aabb_tree()
        .nearest_alongnormal(EMPTY, EMPTY)),
    "AabbNormalsTree.nearest": (
        lambda: J.Mesh(v=V, f=F).compute_aabb_normals_tree().nearest(
            EMPTY, EMPTY),
        lambda: T.Mesh(v=V, f=F, device="cpu").compute_aabb_normals_tree()
        .nearest(EMPTY, EMPTY)),
    "batched_closest_faces_and_points": (
        lambda: J.batched_closest_faces_and_points(
            [J.Mesh(v=V, f=F)] * 2, EMPTY),
        lambda: T.batched_closest_faces_and_points(
            [T.Mesh(v=V, f=F, device="cpu")] * 2, EMPTY, device="cpu")),
    "fused_normals_and_closest_points[Mesh]": (
        lambda: J.fused_normals_and_closest_points(J.Mesh(v=V, f=F), EMPTY),
        lambda: T.fused_normals_and_closest_points(
            T.Mesh(v=V, f=F, device="cpu"), EMPTY, device="cpu")),
    "fused_normals_and_closest_points[batch]": (
        lambda: J.fused_normals_and_closest_points(
            [J.Mesh(v=V, f=F)] * 2, np.zeros((2, 0, 3))),
        lambda: T.fused_normals_and_closest_points(
            [T.Mesh(v=V, f=F, device="cpu")] * 2, np.zeros((2, 0, 3)),
            device="cpu")),
}


def _layout(x):
    """Shapes and dtypes of a result: arrays, tensors, tuples, dicts."""
    if isinstance(x, tuple):
        return tuple(_layout(y) for y in x)
    if isinstance(x, dict):
        return {k: _layout(y) for k, y in x.items()}
    if torch.is_tensor(x):
        x = x.detach().numpy()
    x = np.asarray(x)
    return (x.shape, x.dtype)


@pytest.mark.parametrize("rung", sorted(RUNGS))
@pytest.mark.parametrize("entry", sorted(FACADES))
def test_ladder_entry_points_return_empty(entry, rung, monkeypatch):
    ref_call, port_call = FACADES[entry]
    expected = _layout(ref_call())
    for key, value in RUNGS[rung].items():
        monkeypatch.setenv(key, value)
    assert _layout(port_call()) == expected


@pytest.mark.parametrize("entry", sorted(OTHERS))
def test_entry_points_return_empty(entry):
    ref_call, port_call = OTHERS[entry]
    assert _layout(port_call()) == _layout(ref_call())


V32, F32 = V.astype(np.float32), F.astype(np.int32)
E32 = np.zeros((0, 3), np.float32)

#: diff wrapper -> (reference call, port call)
DIFF = {
    "closest_point[frozen]": (
        lambda: jdiff.closest_point(V32, F32, E32),
        lambda: diff.closest_point(V32, F32, E32, device="cpu")),
    "closest_point[recompute]": (
        lambda: jdiff.closest_point(V32, F32, E32, mode="recompute"),
        lambda: diff.closest_point(V32, F32, E32, mode="recompute",
                                   device="cpu")),
    "closest_point[plain]": (
        lambda: jdiff.closest_point(V32, F32, E32, use_pallas=False),
        lambda: diff.closest_point(V32, F32, E32, use_pallas=False,
                                   device="cpu")),
    "closest_point_batched": (
        lambda: jdiff.closest_point_batched(
            np.stack([V32, V32]), F32, np.zeros((2, 0, 3), np.float32)),
        lambda: diff.closest_point_batched(
            np.stack([V32, V32]), F32, np.zeros((2, 0, 3), np.float32),
            device="cpu")),
    "nearest_normal_weighted": (
        lambda: jdiff.nearest_normal_weighted(V32, F32, E32, E32),
        lambda: diff.nearest_normal_weighted(V32, F32, E32, E32,
                                             device="cpu")),
    "point_to_triangle": (
        lambda: jdiff.point_to_triangle(E32, E32, E32, E32),
        lambda: diff.point_to_triangle(E32, E32, E32, E32, device="cpu")),
}


def _as_numpy_layout(layout):
    """A port layout with torch dtypes named as numpy's."""
    return {k: (shape, np.dtype(str(dtype).replace("torch.", "")))
            for k, (shape, dtype) in layout.items()}


@pytest.mark.parametrize("wrapper", sorted(DIFF))
def test_diff_wrappers_return_empty(wrapper):
    ref_call, port_call = DIFF[wrapper]
    out = port_call()
    assert _as_numpy_layout({k: (tuple(x.shape), x.dtype)
                             for k, x in out.items()}) == _layout(ref_call())


@pytest.mark.parametrize("name", ["point_to_point", "point_to_plane"])
def test_energies_of_an_empty_scan(name):
    """The mean over no scan points is NaN in both packages; the backward
    gives zero gradients of the mesh's shape."""
    ref = getattr(jdiff, name)(V32, F32, E32)
    v = torch.tensor(V32, requires_grad=True)
    out = getattr(diff, name)(v, F32, E32, device="cpu")
    assert out.shape == () and np.isnan(float(out)) and np.isnan(float(ref))
    (g,) = torch.autograd.grad(out, v)
    assert g.shape == V32.shape


def test_symmetric_chamfer_of_an_empty_scan_raises():
    """Its vertex -> scan min over no scan points has no identity: both
    packages raise."""
    with pytest.raises(ValueError):
        jdiff.symmetric_chamfer(V32, F32, E32)
    with pytest.raises((RuntimeError, IndexError)):
        diff.symmetric_chamfer(V32, F32, E32, device="cpu")


def test_empty_backward_is_zero():
    v = torch.tensor(V32, requires_grad=True)
    for mode in ("frozen", "recompute"):
        res = diff.closest_point(v, F32, E32, mode=mode, device="cpu")
        (g,) = torch.autograd.grad(res["sqdist"].sum(), v)
        assert g.shape == V32.shape and not bool(g.any())
