"""Multi-device sharding for mesh queries (counterpart of
mesh_tpu/parallel/sharding.py).

The scaling axes are Q (query points), B (mesh batch) and V/F (mesh
size).  Closest point is embarrassingly parallel over queries, so:

- topology (f) and mesh vertices are replicated,
- the query axis (or the mesh batch axis) is sharded over an axis of a
  ``torch.distributed.device_mesh.DeviceMesh``,
- each rank runs the single-device kernel on its shard, and the one
  collective is the all-gather of the output along that axis.

The reference runs one program over every device (``shard_map``); here
every rank of the mesh calls the same function with the same arguments
(the whole query set, the whole batch) and gets the whole result back,
numpy in and out like the facades.  Each rank computes only its own
shard, on its own device (``comm.mesh_device``), and the collectives are
``comm``'s, so several ranks may share one card under gloo.  The kernel
route (``utils.dispatch.mesh_on_tpu``) runs the ``closest_faces`` kernel
(with its ``cull_records`` prologue) and the ``ray_any_hit_culled``
kernel on the card, their plain versions on the CPU; under
``MESH_TPU_FORCE_XLA`` the reference's XLA forms in plain PyTorch.
"""

import numpy as np
import torch

from ..geometry.vert_normals import vert_normals_t
from ..query import closest_kernel as ck
from ..query.closest_point import closest_faces_and_points_t
from ..query.visibility import visibility_local
from ..utils.device import as_tensor
from ..utils.dispatch import mesh_on_tpu
from ..utils.knobs import tile_variant
from . import comm

__all__ = ["make_device_mesh", "shard_queries",
           "sharded_closest_faces_and_points",
           "sharded_closest_faces_sharded_topology",
           "sharded_visibility", "sharded_batched_visibility",
           "sharded_batched_vert_normals"]


def make_device_mesh(n_devices=None, axis_names=("dp",), shape=None, *,
                     device="cuda"):
    """A ``DeviceMesh`` over the first ``n_devices`` ranks of the world
    (default: all of them), of ``device``'s type.

    With no process group live, the world is this process alone
    (``comm.ensure_world``), so the mesh spans the one device the process
    drives.  Every rank of the world calls this together.

    :param shape: the mesh's shape per axis name; default puts every rank
        on the first axis.
    """
    from torch.distributed.device_mesh import DeviceMesh

    dev = torch.device(device)
    comm.ensure_world()
    world = torch.distributed.get_world_size()
    n = n_devices or world
    if n > world:
        raise ValueError("a mesh of %d devices in a world of %d ranks"
                         % (n, world))
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    return DeviceMesh(dev.type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))


def shard_queries(points, mesh, axis="dp"):
    """``points`` (the same on every rank) as a DTensor sharded along its
    leading axis over ``axis``: each rank keeps its own rows."""
    from .distributed import _from_local

    pts = as_tensor(points, comm.mesh_device(mesh))
    start, stop = comm.chunk_bounds(pts.shape[0], comm.axis_size(mesh, axis),
                                    comm.axis_index(mesh, axis))
    return _from_local(pts[start:stop], mesh, axis, pts.shape[0])


def _pad_rows(arr, multiple):
    """``arr`` padded to a multiple of ``multiple`` rows with copies of its
    last row, and the pad's length."""
    pad = (-arr.shape[0]) % multiple
    if pad:
        arr = np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)], axis=0)
    return arr, pad


def _closest_local(v, f, pts, chunk, use_pallas, nondegen=False,
                   variant="fast"):
    """The per-shard closest-point body on tensors on one device: the
    brute-force ``closest_point_kernel`` (the reference's
    ``closest_point_pallas``, at every face count) on the kernel route,
    the plain reconstruction scan (``chunk`` queries a step) without."""
    if use_pallas:
        return ck.closest_point_kernel(v, f, pts,
                                       assume_nondegenerate=nondegen,
                                       tile_variant=variant)
    return closest_faces_and_points_t(v, f, pts, chunk=chunk)


def _closest_keyed(v, f, pts, chunk, use_pallas, variant="fast"):
    """``_closest_local`` of a face shard (the degenerate-face tail on) and
    each query's merge key: on the kernel route the tile cost the kernel's
    argmin compared for the winning face (``winner_costs``), on the plain
    route the recomputed sqdist, the reference's key."""
    if not use_pallas:
        res = _closest_local(v, f, pts, chunk, False)
        return res, res["sqdist"]
    p, planes, tri, center = ck.closest_point_operands(v[None], f,
                                                       pts[None], variant)
    best = ck.argmin_faces(p, planes, variant, True)
    res = ck.winner_epilogue(best, tri, p, center)
    key = ck.winner_costs(p, planes, best, variant, True)
    return {k: val[0] for k, val in res.items()}, key[0]


def _pack_closest(res):
    """(part, sqdist, point xyz as [Q, 5] float32, face [Q] int32): face
    ids travel as int32 in their own tensor, since a float32 lane would
    corrupt ids past 2^24."""
    packed = torch.cat([res["part"].to(torch.float32)[:, None],
                        res["sqdist"][:, None], res["point"]], dim=1)
    return packed, res["face"].to(torch.int32)


def _unpack_closest(out, face):
    """The result dict from ``_pack_closest``'s lanes (numpy)."""
    return {"face": np.asarray(face).astype(np.int32),
            "part": np.asarray(out[:, 0]).astype(np.int32),
            "sqdist": np.asarray(out[:, 1]),
            "point": np.asarray(out[:, 2:5])}


def _mesh_inputs(v, f, mesh):
    dev = comm.mesh_device(mesh)
    return (as_tensor(np.asarray(v, np.float32), dev),
            as_tensor(np.asarray(f, np.int64), dev), dev)


def sharded_closest_faces_and_points(v, f, points, mesh, axis="dp",
                                     chunk=512):
    """Closest point with the query axis sharded over ``axis`` (BASELINE
    config 5: a 100k-point scan against SMPL).  ``v`` / ``f`` are
    replicated; each rank runs the brute-force kernel on its shard, with
    the data-derived ``assume_nondegenerate`` flag and the tile variant as
    the reference passes them; the shards are gathered in query order.
    Every rank calls with the same arguments and gets the same dict as
    ``closest_faces_and_points``: ``face``, ``part`` (int32), ``sqdist``,
    ``point`` (float32).  Each query's answer is the single-device
    kernel's bit for bit."""
    n_shards = comm.axis_size(mesh, axis)
    points = np.asarray(points, np.float32)
    padded, pad = _pad_rows(points, n_shards)
    rows = padded.shape[0] // n_shards
    i = comm.axis_index(mesh, axis)
    v, f = np.asarray(v, np.float32), np.asarray(f, np.int64)
    v_t, f_t, dev = _mesh_inputs(v, f, mesh)
    res = _closest_local(
        v_t, f_t, as_tensor(padded[i * rows:(i + 1) * rows], dev), chunk,
        mesh_on_tpu(mesh), ck.mesh_is_nondegenerate(v, f), tile_variant())
    packed, face = _pack_closest(res)
    out = torch.cat(comm.all_gather(packed, mesh, axis)).cpu().numpy()
    face = torch.cat(comm.all_gather(face, mesh, axis)).cpu().numpy()
    if pad:
        out, face = out[:-pad], face[:-pad]
    return _unpack_closest(out, face)


def _nan_first(key):
    """Merge keys with NaN below every number, as an argmin takes it."""
    return torch.where(torch.isnan(key), torch.full_like(key, -np.inf), key)


def _gather_merge(packed, faces, mesh, axis):
    """All-gather along ``axis``, then the least key per query; a tie goes
    to the first shard, so to the lowest global face id."""
    everyone = torch.stack(comm.all_gather(packed, mesh, axis))  # [n, Q, 6]
    all_faces = torch.stack(comm.all_gather(faces, mesh, axis))   # [n, Q]
    winner = torch.argmin(_nan_first(everyone[..., 0]), dim=0)
    best = torch.gather(everyone, 0, winner[None, :, None].expand(
        1, -1, everyone.shape[-1]))[0]
    return best, torch.gather(all_faces, 0, winner[None])[0]


def _ring_merge(packed, faces, mesh, axis):
    """n - 1 hops of a ring along ``axis``, each folding the incoming
    candidate by the lexicographic (key, global face id) min; NaN keys
    sort first, so a NaN winner reaches every rank as in the gather merge.
    Holds O(Q) per rank against the gather's O(n Q)."""
    acc_p, acc_f = packed, faces
    for _ in range(comm.axis_size(mesh, axis) - 1):
        in_p, in_f = comm.ring_shift([acc_p, acc_f], mesh, axis)
        in_key, acc_key = _nan_first(in_p[:, 0]), _nan_first(acc_p[:, 0])
        better = (in_key < acc_key) | ((in_key == acc_key) & (in_f < acc_f))
        acc_p = torch.where(better[:, None], in_p, acc_p)
        acc_f = torch.where(better, in_f, acc_f)
    return acc_p, acc_f


def sharded_closest_faces_sharded_topology(v, f, points, mesh, axis="dp",
                                           chunk=512, merge="gather"):
    """Closest point with the FACE axis sharded over ``axis``: queries are
    replicated, each rank scans its block of faces (padded with copies of
    the last face, which can only tie) with the degenerate-face tail on,
    and the winners merge across ranks.  For F the large axis (landmarks
    against a 1M-face scan).  Returns the same dict as
    ``closest_faces_and_points`` on every rank.

    The merge compares each shard winner's key: the squared distance the
    route's argmin compared (the kernel's tile cost, recomputed by its
    plain form), ties to the lowest global face id.  So the merged winner
    is the single-device kernel's bit for bit, which folding the
    epilogue's recomputed sqdist (the reference's key) would not promise
    where two faces' distances agree to rounding.

    :param merge: ``"gather"`` (all-gather + argmin) or ``"ring"`` (n - 1
        point-to-point hops: the same winners, ties included).
    """
    if merge not in ("gather", "ring"):
        raise ValueError("merge must be 'gather' or 'ring', got %r"
                         % (merge,))
    n_shards = comm.axis_size(mesh, axis)
    n_faces = np.asarray(f).shape[0]
    f_np, _ = _pad_rows(np.asarray(f, np.int64), n_shards)
    shard_faces = f_np.shape[0] // n_shards
    i = comm.axis_index(mesh, axis)
    v_t, f_t, dev = _mesh_inputs(v, f_np[i * shard_faces:
                                         (i + 1) * shard_faces], mesh)
    res, key = _closest_keyed(v_t, f_t, as_tensor(np.asarray(
        points, np.float32), dev), chunk, mesh_on_tpu(mesh), tile_variant())
    packed = torch.cat([key[:, None], res["sqdist"][:, None],
                        res["part"].to(torch.float32)[:, None],
                        res["point"]], dim=1)
    faces = res["face"].to(torch.int32) + i * shard_faces
    best, face = (_ring_merge if merge == "ring" else _gather_merge)(
        packed, faces, mesh, axis)
    out = best.cpu().numpy()
    face = face.cpu().numpy().astype(np.int64)
    # a padded duplicate can win a tie against its original; map it back
    face = np.where(face >= n_faces, n_faces - 1, face)
    return {"face": face.astype(np.int32), "part": out[:, 2].astype(np.int32),
            "sqdist": out[:, 1], "point": out[:, 3:6]}


def _gather_rows(local, pad, mesh, axis, dim=0):
    """The shards ``local`` of every rank along ``axis`` joined on ``dim``,
    the last ``pad`` entries of it dropped."""
    full = torch.cat(comm.all_gather(local, mesh, axis), dim=dim)
    return full.narrow(dim, 0, full.shape[dim] - pad)


def sharded_visibility(v, f, cams, n=None, mesh=None, axis="dp",
                       min_dist=1e-3):
    """Per-(camera, vertex) visibility with the VERTEX axis sharded over
    ``axis``: occluder triangles and cameras are replicated, each rank
    casts its vertices' rays against the whole mesh (the
    ``ray_any_hit_culled`` kernel on the card).  Returns the same (vis
    [C, V] uint32, n_dot_cam [C, V] float64) as ``visibility_compute``,
    on every rank."""
    if mesh is None:
        raise ValueError(
            "sharded_visibility requires a DeviceMesh via mesh=... "
            "(keyword kept optional only for signature symmetry)")
    n_shards = comm.axis_size(mesh, axis)
    v_np = np.asarray(v, np.float32)
    n_np = (np.asarray(n, np.float32) if n is not None
            else np.zeros_like(v_np))
    v_pad, pad = _pad_rows(v_np, n_shards)
    n_pad, _ = _pad_rows(n_np, n_shards)
    rows = v_pad.shape[0] // n_shards
    i = comm.axis_index(mesh, axis)
    dev = comm.mesh_device(mesh)
    v_all = as_tensor(v_np, dev)
    occ = v_all[as_tensor(np.asarray(f, np.int64), dev)]
    cams_t = as_tensor(np.atleast_2d(np.asarray(cams, np.float32)), dev)
    vis, ndc = visibility_local(
        as_tensor(v_pad[i * rows:(i + 1) * rows], dev)[None], occ[None],
        cams_t, as_tensor(n_pad[i * rows:(i + 1) * rows], dev)[None], None,
        min_dist, chunk=min(1024, rows), use_pallas=mesh_on_tpu(mesh))
    both = _gather_rows(torch.stack([vis[0].to(torch.float32), ndc[0]]),
                        pad, mesh, axis, dim=2).cpu().numpy()
    return both[0].astype(np.uint32), both[1].astype(np.float64)


def sharded_batched_visibility(v_batch, f, cams, mesh, axis="dp",
                               min_dist=1e-3, chunk=1024):
    """Batched per-vertex visibility with the MESH BATCH sharded over
    ``axis``: each rank self-occludes its own meshes against the
    replicated topology and cameras, with their area-weighted normals for
    the n.dir output made on the same rank; no collective but the final
    gather.

    :param v_batch: [B, V, 3] stacked same-topology vertex sets
    :param f: [F, 3] shared faces
    :param cams: [C, 3] camera centers shared across the batch
    :returns: (vis [B, C, V] uint32, n_dot_cam [B, C, V] float64)
    """
    v_np, pad = _pad_rows(np.asarray(v_batch, np.float32),
                          comm.axis_size(mesh, axis))
    rows = v_np.shape[0] // comm.axis_size(mesh, axis)
    i = comm.axis_index(mesh, axis)
    dev = comm.mesh_device(mesh)
    mine = as_tensor(v_np[i * rows:(i + 1) * rows], dev)
    f_t = as_tensor(np.asarray(f, np.int64), dev)
    vis, ndc = visibility_local(
        mine, mine[:, f_t], as_tensor(np.atleast_2d(np.asarray(
            cams, np.float32)), dev), vert_normals_t(mine, f_t), None,
        min_dist, chunk=min(chunk, v_np.shape[1]),
        use_pallas=mesh_on_tpu(mesh))
    both = _gather_rows(torch.stack([vis.to(torch.float32), ndc]), pad,
                        mesh, axis, dim=1).cpu().numpy()
    return both[0].astype(np.uint32), both[1].astype(np.float64)


def sharded_batched_vert_normals(v_batch, f, mesh, axis="dp"):
    """Vertex normals of a batch of meshes with the batch axis sharded
    over ``axis`` (BASELINE config 3 over several devices): each rank sums
    its meshes' normals over the fixed-order CSR, so every mesh's normals
    are the single-device ``vert_normals``' bits.  Returns the whole
    [B, V, 3] float32 tensor on the mesh's device, on every rank."""
    v_np, pad = _pad_rows(np.asarray(v_batch, np.float32),
                          comm.axis_size(mesh, axis))
    rows = v_np.shape[0] // comm.axis_size(mesh, axis)
    i = comm.axis_index(mesh, axis)
    dev = comm.mesh_device(mesh)
    local = vert_normals_t(as_tensor(v_np[i * rows:(i + 1) * rows], dev),
                           as_tensor(np.asarray(f, np.int64), dev))
    return _gather_rows(local, pad, mesh, axis)
