"""Batched facade entry points: many same-topology meshes in one call
(counterpart of mesh_tpu/batch.py).

The batch is a leading tensor dimension: ``batch_step`` hands all B meshes
to one closest-point kernel launch (brute force up to the crossover, the
sphere-culled kernel above it) and one ``vert_normals`` pass, and
``visibility_step`` hands every (mesh, camera, vertex) ray to one
``ray_any_hit_culled`` launch, not a Python loop over meshes.  Numpy goes
in and out with the reference's dtypes and shapes.

The facades route each step through the query engine (``engine/``): B and
Q pad up a bucket ladder and the step runs as that bucket's plan (a CUDA
graph on the card), with results bit-identical to the direct step in
every real row.  ``MESH_TPU_NO_ENGINE=1``, an empty query set or an empty
camera set take the direct step.
"""

import numpy as np
import torch

from .geometry.vert_normals import vert_normals_t
from .obs.trace import span as obs_span
from .query.autotune import crossover_faces
from .query.closest_kernel import mesh_is_nondegenerate
from .query.closest_point import closest_point_dispatch
from .query.visibility import visibility_local
from .utils.device import as_tensor, resolve_device
from .utils.knobs import no_engine, tile_variant

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
    if _is_array_tuple(meshes):
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
               tile_variant="fast", csr=None):
    """One batched step on tensors on their own device: vertex normals of
    ``vs`` [B, V, 3] (when ``with_normals``) and, when ``pts`` [B, Q, 3] is
    given, the closest-point result dict of every (mesh, query set) pair
    from one kernel launch (``closest_point_dispatch`` picks the kernel).
    ``csr``: the faces' ``vertex_csr`` (made from ``f`` when None).
    Returns (normals or None, result or None)."""
    normals = vert_normals_t(vs, f, csr) if with_normals else None
    res = None if pts is None else closest_point_dispatch(
        vs, f, pts, assume_nondegenerate=assume_nondegenerate,
        tile_variant=tile_variant)
    return normals, res


def visibility_step(vs, f, cams, normals=None, min_dist=1e-3, csr=None):
    """One batched visibility step on tensors on their own device: every
    mesh of ``vs`` [B, V, 3], self-occluded by its own faces ``f`` [F, 3],
    from every camera of ``cams`` [C, 3], in one ``ray_any_hit_culled``
    launch.  ``normals`` [B, V, 3] for n.dir; None computes vertex normals
    in the step (over ``csr``, as ``batch_step``).  Returns (visible
    [B, C, V] bool, n_dot_cam [B, C, V])."""
    if normals is None:
        normals = vert_normals_t(vs, f, csr)
    return visibility_local(vs, vs[..., f.long(), :], cams, normals,
                            min_dist=min_dist)


def _strategy(f, device):
    """(use_pallas, use_culled) of a face array on ``device``: with kernels
    (the card) the brute-force kernel up to ``crossover_faces()`` faces and
    the sphere-culled one above it; on the CPU (plain versions) neither.
    Reads only ``f.shape[0]``, never the faces themselves."""
    if torch.device(device).type != "cuda":
        return False, False
    return True, int(f.shape[0]) > crossover_faces()


def _batch_nondegen(v_host, f_host):
    """The data-derived ``assume_nondegenerate`` flag of a batch, checked
    on its HOST copy at the numpy boundary (no device readback).  The
    port's plain versions take the flag on the CPU as the kernels do on
    the card, so the check runs on both."""
    return mesh_is_nondegenerate(v_host, f_host)


def _run_batch_step(v, f, pts, use_pallas, use_culled, chunk, with_normals,
                    nondegen=False, variant="fast", op="closest_point", *,
                    device="cuda"):
    """One batched step through the engine's plan cache
    (``engine.planner``: pad B and Q up the ladders, reuse the bucket's
    plan), or the direct ``batch_step`` under MESH_TPU_NO_ENGINE=1 or with
    nothing to bucket (no mesh, no queries).  ``v`` / ``f`` / ``pts`` are
    numpy arrays or tensors; numpy runs on ``device``, a tensor ``v`` on
    its own.  Returns ``batch_step``'s (normals, res), tensors on the
    device."""
    if not no_engine() and v.shape[0] and (pts is None or pts.shape[1]):
        from .engine.planner import get_planner

        return get_planner().run_batch_step(
            v, f, pts, use_pallas=use_pallas, use_culled=use_culled,
            chunk=chunk, with_normals=with_normals, nondegen=nondegen,
            variant=variant, op=op, device=device)
    dev = v.device if torch.is_tensor(v) else resolve_device(device)
    return batch_step(
        as_tensor(v, dev), as_tensor(f, dev),
        None if pts is None else as_tensor(
            pts if torch.is_tensor(pts) else np.array(pts), dev),
        with_normals, assume_nondegenerate=nondegen, tile_variant=variant)


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


def _is_array_tuple(meshes):
    """True for a ``(v_stack, f)`` pair (a 2-tuple of meshes is a batch)."""
    return (isinstance(meshes, tuple) and len(meshes) == 2
            and not hasattr(meshes[0], "v"))


def batched_vertex_normals(meshes, *, device="cuda"):
    """Area-weighted vertex normals of every mesh, [B, V, 3] float64."""
    with obs_span("batch.vertex_normals") as sp:
        v, f = stack_mesh_batch(meshes)
        sp.set(b=v.shape[0])
        normals, _ = _run_batch_step(v, f, None, False, False, 512, True,
                                     op="normals", device=device)
        return normals.cpu().numpy().astype(np.float64)


def batched_closest_faces_and_points(meshes, points, chunk=512, *,
                                     device="cuda"):
    """AabbTree.nearest for every (mesh, query set) pair in one dispatch.

    :param points: [Q, 3] (same queries against every mesh) or [B, Q, 3].
    :param chunk: the reference's query chunk; part of the plan key (the
        kernels take none).
    :returns: (faces [B, 1, Q] uint32, points [B, Q, 3] f64).
    """
    with obs_span("batch.closest_faces_and_points") as sp:
        v, f = stack_mesh_batch(meshes)
        pts = _broadcast_points(points, v.shape[0])
        sp.set(b=v.shape[0], q=pts.shape[1])
        use_pallas, use_culled = _strategy(f, resolve_device(device))
        _, res = _run_batch_step(
            v, f, pts, use_pallas, use_culled, chunk, False,
            nondegen=_batch_nondegen(v, f), variant=tile_variant(),
            device=device)
        faces = res["face"].cpu().numpy().astype(np.uint32)[:, None, :]
        return faces, res["point"].cpu().numpy().astype(np.float64)


def batched_vertex_visibility(meshes, cams, min_dist=1e-3, chunk=1024, *,
                              device="cuda"):
    """Per-vertex visibility of every mesh from the same cameras, each mesh
    self-occluded by its own faces, in one dispatch.

    Normals for the n.dir output come from each mesh's stored ``vn`` when
    EVERY mesh has one; otherwise vertex normals are computed in the step.

    :param cams: [C, 3] camera centers shared across the batch.
    :param chunk: the reference's ray chunk; part of the plan key.
    :returns: (vis [B, C, V] uint32, n_dot_cam [B, C, V] f64).
    """
    with obs_span("batch.vertex_visibility") as sp:
        v, f = stack_mesh_batch(meshes)
        stored_vn = None
        if not _is_array_tuple(meshes) and all(
                getattr(m, "vn", None) is not None for m in meshes):
            stored_vn = np.stack([np.asarray(m.vn, np.float32)
                                  for m in meshes])
        cams_np = np.atleast_2d(np.asarray(cams, np.float32))
        sp.set(b=v.shape[0], cams=cams_np.shape[0])
        dev = resolve_device(device)
        if not no_engine() and v.shape[0] and cams_np.shape[0]:
            from .engine.planner import get_planner

            vis, ndc = get_planner().run_visibility_step(
                v, f, cams_np, stored_vn, min_dist,
                use_pallas=dev.type == "cuda", chunk=chunk,
                with_normals=stored_vn is None, device=dev)
        else:
            vis, ndc = visibility_step(
                as_tensor(v, dev), as_tensor(f, dev), as_tensor(cams_np, dev),
                None if stored_vn is None else as_tensor(stored_vn, dev),
                min_dist)
        return (vis.cpu().numpy().astype(np.uint32),
                ndc.cpu().numpy().astype(np.float64))


def fused_normals_and_closest_points(meshes, points, chunk=512, *,
                                     device="cuda"):
    """Vertex normals AND closest-point queries for the batch in one step.

    Accepts a single Mesh, a list, or a (v_stack, f) tuple; a single Mesh
    returns unbatched arrays and uses its cached device copy (and device).

    :param chunk: the reference's query chunk; part of the plan key.
    :returns: (normals [B, V, 3] f64, faces [B, 1, Q] uint32,
        points [B, Q, 3] f64); no leading B for a single Mesh input.
    """
    with obs_span("batch.fused_normals_and_closest_points") as sp:
        single = hasattr(meshes, "v") and hasattr(meshes, "f")
        if single:
            if hasattr(meshes, "device_arrays"):
                vt, ft = meshes.device_arrays()
            else:
                vt = as_tensor(np.asarray(meshes.v, np.float32), device)
                ft = as_tensor(np.asarray(meshes.f, np.int64), device)
            vs, fs, batch, dev = vt[None], ft, 1, vt.device
            v_host, f_host = np.asarray(meshes.v), np.asarray(meshes.f)
        else:
            v_host, f_host = stack_mesh_batch(meshes)
            vs, fs, batch = v_host, f_host, v_host.shape[0]
            dev = resolve_device(device)
        pts = _broadcast_points(points, batch)
        sp.set(b=batch, q=pts.shape[1])
        use_pallas, use_culled = _strategy(fs, dev)
        normals, res = _run_batch_step(
            vs, fs, pts, use_pallas, use_culled, chunk, True,
            nondegen=_batch_nondegen(v_host, f_host), variant=tile_variant(),
            op="fused", device=dev)
        normals = normals.cpu().numpy().astype(np.float64)
        faces = res["face"].cpu().numpy().astype(np.uint32)[:, None, :]
        points_out = res["point"].cpu().numpy().astype(np.float64)
        if single:
            return normals[0], faces[0], points_out[0]
        return normals, faces, points_out
