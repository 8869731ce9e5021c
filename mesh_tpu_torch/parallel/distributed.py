"""Multi-process initialization and data placement (counterpart of
mesh_tpu/parallel/distributed.py).

The reference bootstraps ``jax.distributed``, after which
``jax.devices()`` spans every host.  The port is one process per rank
under ``torch.distributed``: ``initialize_multihost`` starts the process
group (from ``torchrun``'s environment, or from explicit arguments), and
``global_device_mesh`` lays a ``DeviceMesh`` over the world::

    initialize_multihost(backend="nccl")   # under torchrun, a card a rank
    mesh = global_device_mesh(("dp", "sp"), (world // 2, 2))
    step = make_fit_step(model, opt, mesh=mesh)

Placement is DTensor's (``torch.distributed.tensor``): ``Shard(0)`` along
one mesh axis and ``Replicate()`` on the others are the counterparts of
``NamedSharding(mesh, P(axis))``.  A process writes only its own rows, so
a global array is assembled from per-process shards, and a result sharded
over other processes needs one gather to come home.
"""

import os
import warnings

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import as_tensor
from . import comm

__all__ = ["initialize_multihost", "global_device_mesh", "shard_from_local",
           "replicate_to_mesh", "gather_to_hosts",
           "multihost_closest_faces_and_points"]

#: the launcher variables ``init_method="env://"`` reads (torchrun sets all)
_LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None, *, backend="gloo"):
    """Start the ``torch.distributed`` process group of a multi-process
    run, with the ``backend`` the caller names (gloo by default; NCCL when
    each rank has a card of its own is the caller's choice).

    With no arguments it reads a launcher's environment (``torchrun``'s
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK); without one it starts no
    group and the process runs alone, and when that start fails it warns
    and runs alone.  With explicit arguments (``coordinator_address``
    "host:port", ``num_processes``, ``process_id``; a missing one from the
    environment) the caller intends a multi-process run, so errors
    propagate: a ``process_id`` outside the world before any connection,
    an already live group among them.  A one-process world that a mesh
    made earlier started (``comm.ensure_world``) is ended first, so the
    process joins the launcher's world; meshes made over it can no longer
    run a collective.  Returns True when a group of more than one process
    is live.
    """
    explicit = any(arg is not None for arg in (
        coordinator_address, num_processes, process_id))
    if not explicit:
        if not all(name in os.environ for name in _LAUNCHER_ENV):
            return dist.is_initialized() and dist.get_world_size() > 1
        comm.leave_private_world()
        if not dist.is_initialized():
            try:
                dist.init_process_group(backend, init_method="env://")
            except Exception as err:       # the reference degrades, too
                warnings.warn("initialize_multihost: the launcher's group "
                              "did not start (%r); running alone" % (err,))
                return False
        return dist.get_world_size() > 1
    address = coordinator_address or "%s:%s" % (
        os.environ["MASTER_ADDR"], os.environ["MASTER_PORT"])
    world = int(num_processes if num_processes is not None
                else os.environ["WORLD_SIZE"])
    rank = int(process_id if process_id is not None
               else os.environ["RANK"])
    if not 0 <= rank < world:
        raise ValueError("process_id %d outside [0, %d)" % (rank, world))
    comm.leave_private_world()
    if dist.is_initialized():
        raise RuntimeError("initialize_multihost: a process group is "
                           "already live")
    dist.init_process_group(backend, init_method="tcp://" + address,
                            world_size=world, rank=rank)
    return world > 1


def global_device_mesh(axis_names=("dp",), shape=None, *, device="cuda"):
    """A ``DeviceMesh`` over every rank of the world, of ``device``'s type,
    in rank order (each process's block contiguous and in process order).
    One axis by default; a multi-axis mesh needs ``shape``.  Across hosts
    put the data-parallel axis first, so its collectives cross hosts only
    for the final reductions."""
    from .sharding import make_device_mesh

    comm.ensure_world()
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("shape is required for a multi-axis mesh")
        shape = (dist.get_world_size(),)
    if int(np.prod(shape)) != dist.get_world_size():
        raise ValueError("a mesh of shape %s over a world of %d ranks"
                         % (tuple(shape), dist.get_world_size()))
    return make_device_mesh(axis_names=axis_names, shape=shape,
                            device=device)


def _placements(mesh, axis):
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if name == axis else Replicate()
            for name in mesh.mesh_dim_names]


def _from_local(local, mesh, axis, n_rows):
    """A DTensor of ``n_rows`` rows sharded along ``axis`` from this
    rank's ``local`` rows (``torch.chunk``'s split), with no collective."""
    from torch.distributed.tensor import DTensor

    shape = torch.Size((n_rows,) + tuple(local.shape[1:]))
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local.contiguous(), mesh,
                              _placements(mesh, axis), run_check=False,
                              shape=shape, stride=stride)


def shard_from_local(local, mesh, axis="dp"):
    """Global DTensor sharded along ``axis``, assembled from this
    process's ``local`` rows: every process passes its own rows, with the
    same shape on each."""
    local = as_tensor(local, comm.mesh_device(mesh))
    return _from_local(local, mesh, axis,
                       local.shape[0] * comm.axis_size(mesh, axis))


def replicate_to_mesh(arr, mesh):
    """Global replicated DTensor (every process passes the same value)."""
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(
        as_tensor(arr, comm.mesh_device(mesh)).contiguous(), mesh,
        [Replicate()] * mesh.ndim, run_check=False)


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in
                _tree_leaves(tree[key])]
    if isinstance(tree, (tuple, list)):
        return [leaf for item in tree for leaf in _tree_leaves(item)]
    return [tree]


def _tree_rebuild(tree, leaves):
    if isinstance(tree, dict):
        return {key: _tree_rebuild(tree[key], leaves) for key in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_rebuild(item, leaves) for item in tree)
    return next(leaves)


def _shard_axis(leaf):
    """The mesh axis a DTensor leaf is sharded along by rows, or None."""
    from torch.distributed.tensor import Replicate, Shard

    axes = []
    for name, place in zip(leaf.device_mesh.mesh_dim_names, leaf.placements):
        if isinstance(place, Shard) and place.dim == 0:
            axes.append(name)
        elif not isinstance(place, Replicate):
            raise ValueError("gather_to_hosts takes row shards and replicas, "
                             "got %s" % (leaf.placements,))
    if len(axes) > 1:
        raise ValueError("gather_to_hosts: rows sharded over several axes")
    return axes[0] if axes else None


def gather_to_hosts(garrays):
    """Fetch row-sharded global results fully onto every process, as
    numpy.  Accepts a pytree (dicts, tuples, lists) and gathers it in ONE
    collective: every DTensor leaf's local rows travel in one byte buffer
    along the axis they are sharded over (one axis for the whole tree);
    replicated leaves and plain arrays come back as they are."""
    from torch.distributed.tensor import DTensor

    leaves = _tree_leaves(garrays)
    sharded = [leaf for leaf in leaves if isinstance(leaf, DTensor)
               and _shard_axis(leaf) is not None]
    axes = {_shard_axis(leaf) for leaf in sharded}
    if len(axes) > 1:
        raise ValueError("gather_to_hosts: leaves sharded over different "
                         "axes %s" % sorted(axes))
    pieces = {}
    if sharded:
        axis, mesh = axes.pop(), sharded[0].device_mesh
        n = comm.axis_size(mesh, axis)
        # every member's byte count per leaf, from the global shapes
        sizes = []
        for leaf in sharded:
            row_bytes = (leaf.element_size()
                         * int(np.prod(leaf.shape[1:], dtype=np.int64)))
            bounds = [comm.chunk_bounds(leaf.shape[0], n, j) for j in range(n)]
            sizes.append([(b - a) * row_bytes for a, b in bounds])
        width = max(sum(col) for col in zip(*sizes)) if sizes else 0
        mine = torch.cat([leaf.to_local().contiguous().cpu().reshape(-1)
                          .view(torch.uint8) for leaf in sharded])
        buf = torch.zeros(max(width, 1), dtype=torch.uint8,
                          device=comm.mesh_device(mesh))
        buf[:mine.numel()] = mine.to(buf.device)
        rows = [piece.cpu() for piece in comm.all_gather(buf, mesh, axis)]
        offsets = [0] * n
        for leaf, col in zip(sharded, sizes):
            parts = []
            for j in range(n):
                raw = rows[j][offsets[j]:offsets[j] + col[j]]
                offsets[j] += col[j]
                parts.append(raw.clone().view(leaf.dtype).reshape(
                    (-1,) + tuple(leaf.shape[1:])))
            pieces[id(leaf)] = torch.cat(parts).numpy()

    def host(leaf):
        if id(leaf) in pieces:
            return pieces[id(leaf)]
        if isinstance(leaf, DTensor):
            leaf = leaf.to_local()
        return leaf.cpu().numpy() if torch.is_tensor(leaf) else np.asarray(
            leaf)

    return _tree_rebuild(garrays, iter([host(leaf) for leaf in leaves]))


def _process_order(mesh):
    """The process (global rank) of each device of ``mesh``, flattened."""
    return [int(r) for r in mesh.mesh.flatten().tolist()]


def _process_count():
    return dist.get_world_size() if dist.is_initialized() else 1


def _exchange_counts(row):
    """Every process's ``row`` ([2] int64: rows, local devices), [P, 2]."""
    device = (torch.device("cpu") if dist.get_backend() == "gloo"
              else torch.device("cuda", torch.cuda.current_device()))
    mine = torch.as_tensor(row, dtype=torch.int64, device=device)
    out = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(out, mine)
    return torch.stack(out).cpu().numpy()


def _process_blocks(mesh, n_local, local_devices):
    """Exchange per-process (row count, local device count) and compute the
    uniform rows-per-device the global array needs.

    Per-process counts may be RAGGED (a real scan rarely splits evenly):
    every process pads its local rows to ``rows_per_device * its local
    device count`` and the gathered result is trimmed per process block.
    Requires the mesh's devices ordered so each process's block is
    contiguous and in process order (true of ``global_device_mesh``),
    checked loudly rather than silently returning misordered rows.

    :returns: (counts [P], block_rows [P], rows_per_device)
    """
    proc_order = _process_order(mesh)
    if any(a > b for a, b in zip(proc_order, proc_order[1:])):
        raise ValueError(
            "multihost query needs a mesh whose device order keeps each "
            "process's devices contiguous and in process order (build it "
            "with global_device_mesh()); got process order %s"
            % (proc_order,))
    if _process_count() == 1:
        counts = np.array([[n_local, local_devices]])
    else:
        counts = np.asarray(_exchange_counts(
            np.array([n_local, local_devices], np.int64)))
    rows_per_device = max(
        1, int(max(-(-int(n) // int(ld)) for n, ld in counts)))
    block_rows = counts[:, 1] * rows_per_device
    return counts[:, 0], block_rows, rows_per_device


def multihost_closest_faces_and_points(v, f, points_local, mesh=None,
                                       axis="dp", chunk=512):
    """Closest-point query sharded over every process of the world.

    The multi-process form of ``sharding.sharded_closest_faces_and_points``
    (the same shard body): ``v`` / ``f`` replicated, each process
    contributing its own ``points_local`` rows, counts that may differ
    across processes (each padded to the common count, the gather trimmed
    per process block), and every process returning the FULL result dict,
    process 0's points first, then process 1's, and so on.  Numpy in and
    out.  Two collectives: the count exchange and the output gather.
    """
    from ..query.closest_kernel import mesh_is_nondegenerate
    from ..utils.dispatch import mesh_on_tpu
    from ..utils.knobs import tile_variant
    from .sharding import _closest_local, _pack_closest, _unpack_closest

    if mesh is None:
        mesh = global_device_mesh((axis,))
    if mesh.ndim != 1:
        raise ValueError("multihost query takes a one-axis mesh, got axes %s"
                         % (mesh.mesh_dim_names,))
    points_local = np.ascontiguousarray(points_local, np.float32).reshape(
        -1, 3)
    n_local = points_local.shape[0]
    counts, block_rows, rows_per_device = _process_blocks(mesh, n_local, 1)
    padded = np.zeros((rows_per_device, 3), np.float32)
    padded[:n_local] = points_local
    pts = shard_from_local(padded, mesh, axis)
    v, f = np.asarray(v, np.float32), np.asarray(f, np.int64)
    v_rep, f_rep = replicate_to_mesh(v, mesh), replicate_to_mesh(f, mesh)
    res = _closest_local(v_rep.to_local(), f_rep.to_local(), pts.to_local(),
                         chunk, mesh_on_tpu(mesh),
                         mesh_is_nondegenerate(v, f), tile_variant())
    packed, face = _pack_closest(res)
    rows = rows_per_device * comm.axis_size(mesh, axis)
    out, face = gather_to_hosts((_from_local(packed, mesh, axis, rows),
                                 _from_local(face, mesh, axis, rows)))
    if int(counts.sum()) != out.shape[0]:
        # trim each process's pad rows from the tail of its block
        keep = np.concatenate([np.arange(block) < n
                               for n, block in zip(counts, block_rows)])
        out, face = out[keep], face[keep]
    return _unpack_closest(out, face)
