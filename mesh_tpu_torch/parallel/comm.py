"""The collectives of the parallel layer, on plain ``torch.distributed``.

The reference is single-controller SPMD: ``shard_map`` over a
``jax.sharding.Mesh``, with XLA inserting the collectives.  The port is
multi-controller: one process per rank, a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks, and the
explicit collectives below, each over one axis of the mesh and each
returning its pieces in the order of the axis's coordinates (a
``DeviceMesh``'s process group numbers its members by global rank, which
a permuted mesh does not follow).

Where a group's backend is gloo, which does not take every collective on
CUDA tensors, a collective stages its tensors through host memory and
copies the result back to the caller's device: that is how several ranks
share one card.  With NCCL (a card for each rank) tensors stay on the
card.  A group of one rank exchanges nothing.
"""

import threading

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

_WORLD_LOCK = threading.Lock()
#: the default group ``ensure_world`` started (None once another is live)
_PRIVATE_WORLD = None


def ensure_world():
    """The default process group: the live one, or, when none is, a world
    of this one process on a ``HashStore`` (gloo), started once.  A process
    that joins no launcher's group still gets meshes over the devices it
    drives itself; ``leave_private_world`` ends that world so that the
    process can join a launcher's."""
    global _PRIVATE_WORLD
    with _WORLD_LOCK:
        if not dist.is_initialized():
            dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                    world_size=1)
            _PRIVATE_WORLD = dist.group.WORLD


def leave_private_world():
    """End the one-process world ``ensure_world`` started, when it is the
    live default group; True when it did.  Meshes made over it can no
    longer run a collective."""
    global _PRIVATE_WORLD
    with _WORLD_LOCK:
        live = dist.is_initialized() and dist.group.WORLD is _PRIVATE_WORLD
        _PRIVATE_WORLD = None
        if live:
            dist.destroy_process_group()
        return live


def mesh_device(mesh):
    """The torch device a mesh's rank computes on: the current card for a
    ``cuda`` mesh, the CPU for a ``cpu`` one."""
    return resolve_device(mesh.device_type)


def _dim(mesh, axis):
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError("the mesh has no axis %r (axes %s)"
                         % (axis, tuple(names)))
    return names.index(axis)


def axis_size(mesh, axis):
    """Number of ranks along ``axis``."""
    return mesh.size(_dim(mesh, axis))


def axis_index(mesh, axis):
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(_dim(mesh, axis))


def axis_members(mesh, axis):
    """Global ranks of this rank's group along ``axis``, in coordinate
    order (this rank's coordinates on the other axes held)."""
    dim = _dim(mesh, axis)
    index = [slice(None) if d == dim else c
             for d, c in enumerate(mesh.get_coordinate())]
    return [int(r) for r in mesh.mesh[tuple(index)].tolist()]


def chunk_bounds(n, n_shards, index):
    """Rows [start, stop) of shard ``index`` when ``n`` rows are split as
    ``torch.chunk`` (and a DTensor's ``Shard``) splits them."""
    size = -(-n // n_shards) if n else 0
    return min(n, index * size), min(n, (index + 1) * size)


def _staging(group, device):
    """Where a collective of ``group`` exchanges tensors of ``device``."""
    if dist.get_backend(group) == "gloo":
        return torch.device("cpu")
    return device


def all_gather(tensor, mesh, axis):
    """Every member's ``tensor`` along ``axis`` (one shape and dtype on
    each), as a list in coordinate order on ``tensor``'s device."""
    group = mesh.get_group(_dim(mesh, axis))
    n = dist.get_world_size(group)
    if n == 1:
        return [tensor]
    t = tensor.contiguous().to(_staging(group, tensor.device))
    out = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(out, t, group=group)
    by_rank = {dist.get_global_rank(group, g): piece
               for g, piece in enumerate(out)}
    return [by_rank[r].to(tensor.device) for r in axis_members(mesh, axis)]


def broadcast_bytes(data, mesh):
    """The ``data`` (bytes) of the mesh's first rank (coordinate 0 on every
    axis) on every rank of ``mesh``; the other ranks pass None.  One
    broadcast a length and one its bytes, axis by axis: after an axis, the
    ranks whose coordinates past it are 0 hold the first rank's bytes."""
    device = mesh_device(mesh)
    for dim, axis in enumerate(mesh.mesh_dim_names):
        group = mesh.get_group(dim)
        if dist.get_world_size(group) == 1:
            continue
        stage = _staging(group, device)
        src = axis_members(mesh, axis)[0]
        mine = np.frombuffer(data or b"", np.uint8)
        size = torch.tensor([mine.size], dtype=torch.int64, device=stage)
        dist.broadcast(size, src, group=group)
        buf = torch.zeros(max(int(size), 1), dtype=torch.uint8, device=stage)
        if mine.size:
            buf[:mine.size] = torch.from_numpy(mine.copy()).to(stage)
        dist.broadcast(buf, src, group=group)
        data = buf[:int(size)].cpu().numpy().tobytes()
    return data


def mesh_barrier(mesh):
    """Wait until every rank of ``mesh`` gets here (one barrier an axis)."""
    for dim in range(mesh.ndim):
        group = mesh.get_group(dim)
        if dist.get_world_size(group) > 1:
            dist.barrier(group=group)


def ring_shift(tensors, mesh, axis):
    """One hop of a ring along ``axis``: each member sends ``tensors`` to
    the next coordinate and returns what the previous one sent (the same
    shapes and dtypes), in one ``batch_isend_irecv``."""
    group = mesh.get_group(_dim(mesh, axis))
    members = axis_members(mesh, axis)
    n = len(members)
    if n == 1:
        return list(tensors)
    i = axis_index(mesh, axis)
    dev = tensors[0].device
    stage = _staging(group, dev)
    send = [t.contiguous().to(stage) for t in tensors]
    recv = [torch.empty_like(t) for t in send]
    ops = ([dist.P2POp(dist.isend, t, members[(i + 1) % n], group)
            for t in send]
           + [dist.P2POp(dist.irecv, t, members[(i - 1) % n], group)
              for t in recv])
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [t.to(dev) for t in recv]
