"""Batched facade entry points: many same-topology meshes in one call
(counterpart of mesh_tpu/batch.py without its engine/planner).

The batch is a leading tensor dimension: ``batch_step`` hands all B meshes
to one closest-point kernel launch (brute force up to the crossover, the
sphere-culled kernel above it) and one ``vert_normals`` pass, and
``visibility_step`` hands every (mesh, camera, vertex) ray to one
``ray_any_hit_culled`` launch, not a Python loop over meshes.  Numpy goes
in and out with the reference's dtypes and shapes.
"""

import numpy as np

from .geometry.vert_normals import vert_normals_t
from .query.closest_kernel import mesh_is_nondegenerate
from .query.closest_point import closest_point_dispatch
from .query.visibility import visibility_local
from .utils.device import as_tensor
from .utils.knobs import tile_variant

__all__ = [
    "stack_mesh_batch",
    "batched_vertex_normals",
    "batched_closest_faces_and_points",
    "batched_vertex_visibility",
    "fused_normals_and_closest_points",
    "batch_step",
    "visibility_step",
]


def stack_mesh_batch(meshes):
    """(v [B, V, 3] f32, f [F, 3] int32) from same-topology meshes.

    Accepts a list of Mesh objects / duck-typed (v, f) holders, or a ready
    [B, V, 3] array plus shared faces as ``(v_stack, f)``.
    """
    if (
        isinstance(meshes, tuple) and len(meshes) == 2
        and not hasattr(meshes[0], "v")     # a 2-tuple of meshes is a batch
    ):
        v = np.asarray(meshes[0], np.float32)
        f = np.asarray(meshes[1], np.int32)
        if v.ndim != 3:
            raise ValueError("v_stack must be [B, V, 3], got %r" % (v.shape,))
        return v, f
    if not len(meshes):
        raise ValueError("empty mesh batch")
    f0_raw = meshes[0].f
    f0 = np.asarray(f0_raw, np.int64)
    for m in meshes[1:]:
        if m.f is f0_raw:
            continue
        if not np.array_equal(np.asarray(m.f, np.int64), f0):
            raise ValueError(
                "batched facade calls need identical topology on every mesh"
            )
    v = np.stack([np.asarray(m.v, np.float32) for m in meshes])
    return v, f0.astype(np.int32)


def batch_step(vs, f, pts, with_normals=True, assume_nondegenerate=False,
               tile_variant="fast"):
    """One batched step on tensors on their own device: vertex normals of
    ``vs`` [B, V, 3] (when ``with_normals``) and, when ``pts`` [B, Q, 3] is
    given, the closest-point result dict of every (mesh, query set) pair
    from one kernel launch (``closest_point_dispatch`` picks the kernel).
    Returns (normals or None, result or None)."""
    normals = vert_normals_t(vs, f) if with_normals else None
    res = None if pts is None else closest_point_dispatch(
        vs, f, pts, assume_nondegenerate=assume_nondegenerate,
        tile_variant=tile_variant)
    return normals, res


def visibility_step(vs, f, cams, normals=None, min_dist=1e-3):
    """One batched visibility step on tensors on their own device: every
    mesh of ``vs`` [B, V, 3], self-occluded by its own faces ``f`` [F, 3],
    from every camera of ``cams`` [C, 3], in one ``ray_any_hit_culled``
    launch.  ``normals`` [B, V, 3] for n.dir; None computes vertex normals
    in the step.  Returns (visible [B, C, V] bool, n_dot_cam [B, C, V])."""
    if normals is None:
        normals = vert_normals_t(vs, f)
    return visibility_local(vs, vs[..., f.long(), :], cams, normals,
                            min_dist=min_dist)


def _broadcast_points(points, batch):
    pts = np.asarray(points, np.float32)
    if pts.ndim == 2:
        pts = np.broadcast_to(pts, (batch,) + pts.shape)
    if pts.ndim != 3 or pts.shape[0] != batch:
        raise ValueError(
            "points must be [Q, 3] or [B, Q, 3] with B=%d, got %r"
            % (batch, np.asarray(points).shape)
        )
    return pts


def batched_vertex_normals(meshes, device="cuda"):
    """Area-weighted vertex normals of every mesh, [B, V, 3] float64."""
    v, f = stack_mesh_batch(meshes)
    normals, _ = batch_step(as_tensor(v, device), as_tensor(f, device), None)
    return normals.cpu().numpy().astype(np.float64)


def batched_closest_faces_and_points(meshes, points, device="cuda"):
    """AabbTree.nearest for every (mesh, query set) pair in one launch.

    :param points: [Q, 3] (same queries against every mesh) or [B, Q, 3].
    :returns: (faces [B, 1, Q] uint32, points [B, Q, 3] f64).
    """
    v, f = stack_mesh_batch(meshes)
    pts = _broadcast_points(points, v.shape[0])
    _, res = batch_step(
        as_tensor(v, device), as_tensor(f, device),
        as_tensor(np.array(pts), device), with_normals=False,
        assume_nondegenerate=mesh_is_nondegenerate(v, f),
        tile_variant=tile_variant())
    faces = res["face"].cpu().numpy().astype(np.uint32)[:, None, :]
    return faces, res["point"].cpu().numpy().astype(np.float64)


def batched_vertex_visibility(meshes, cams, min_dist=1e-3, device="cuda"):
    """Per-vertex visibility of every mesh from the same cameras, each mesh
    self-occluded by its own faces, in one kernel launch.

    Normals for the n.dir output come from each mesh's stored ``vn`` when
    EVERY mesh has one; otherwise vertex normals are computed in the step.

    :param cams: [C, 3] camera centers shared across the batch.
    :returns: (vis [B, C, V] uint32, n_dot_cam [B, C, V] f64).
    """
    v, f = stack_mesh_batch(meshes)
    # a (v_stack, f) tuple carries no stored normals
    is_array_tuple = (isinstance(meshes, tuple) and len(meshes) == 2
                      and not hasattr(meshes[0], "v"))
    normals = None
    if not is_array_tuple and all(getattr(m, "vn", None) is not None
                                  for m in meshes):
        normals = as_tensor(np.stack([np.asarray(m.vn, np.float32)
                                      for m in meshes]), device)
    cams = as_tensor(np.atleast_2d(np.asarray(cams, np.float32)), device)
    vis, ndc = visibility_step(as_tensor(v, device), as_tensor(f, device),
                               cams, normals, min_dist)
    return (vis.cpu().numpy().astype(np.uint32),
            ndc.cpu().numpy().astype(np.float64))


def fused_normals_and_closest_points(meshes, points, device="cuda"):
    """Vertex normals AND closest-point queries for the batch in one step.

    Accepts a single Mesh, a list, or a (v_stack, f) tuple; a single Mesh
    returns unbatched arrays and uses its cached device copy.

    :returns: (normals [B, V, 3] f64, faces [B, 1, Q] uint32,
        points [B, Q, 3] f64); no leading B for a single Mesh input.
    """
    single = hasattr(meshes, "v") and hasattr(meshes, "f")
    if single:
        if hasattr(meshes, "device_arrays"):
            vt, ft = meshes.device_arrays()
        else:
            vt = as_tensor(np.asarray(meshes.v, np.float32), device)
            ft = as_tensor(np.asarray(meshes.f, np.int64), device)
        vs, batch = vt[None], 1
        v_host, f_host = np.asarray(meshes.v), np.asarray(meshes.f)
    else:
        v_host, f_host = stack_mesh_batch(meshes)
        vs, ft, batch = (as_tensor(v_host, device), as_tensor(f_host, device),
                         v_host.shape[0])
    pts = _broadcast_points(points, batch)
    normals, res = batch_step(
        vs, ft, as_tensor(np.array(pts), vs.device),
        assume_nondegenerate=mesh_is_nondegenerate(v_host, f_host),
        tile_variant=tile_variant())
    normals = normals.cpu().numpy().astype(np.float64)
    faces = res["face"].cpu().numpy().astype(np.uint32)[:, None, :]
    points_out = res["point"].cpu().numpy().astype(np.float64)
    if single:
        return normals[0], faces[0], points_out[0]
    return normals, faces, points_out

