"""What each rank of the parallel tests' worlds runs (``_torch_world``).

Imports torch, numpy and mesh_tpu_torch only: the ranks never load JAX.
Every function takes (rank, world size, the parent's numpy inputs) and
returns a dict of numpy results, which the test files hold against the
reference's single-device functions and the port's own.
"""

import os
from contextlib import contextmanager

import numpy as np
import torch

from mesh_tpu_torch import parallel as par
from mesh_tpu_torch.convert import fit_state_from_arrays
from mesh_tpu_torch.models import body_model as tbm
from mesh_tpu_torch.parallel import fit


@contextmanager
def _env(**values):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, val in saved.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val


def _model(inp):
    v, f = inp["model_template"]
    return tbm.synthetic_body_model(seed=0, n_betas=4, n_joints=6,
                                    template=(v, f), device="cpu")


def _rows(state):
    return {name: getattr(state, name).detach().numpy().copy()
            for name in fit.FIT_PARAMS}


def _converted(inp, mesh=None):
    s = inp["fit_state"]
    return fit_state_from_arrays(s["params"], s["count"], s["mu"], s["nu"],
                                 device="cpu", mesh=mesh)


def parallel_world(rank, n, inp):
    """Sharded closest point, visibility, normals and the sharded fit."""
    out = {}
    mesh = par.make_device_mesh(axis_names=("dp",), device="cpu")
    v2, f2 = inp["ico2"]
    v1, f1 = inp["ico1"]
    q = inp["queries"]
    out["query_sharded"] = par.sharded_closest_faces_and_points(
        v2, f2, q["q1000"], mesh, chunk=128)
    with _env(MESH_TPU_FORCE_XLA="1"):
        out["query_sharded_xla"] = par.sharded_closest_faces_and_points(
            v2, f2, q["q1000"], mesh, chunk=128)
        out["face_sharded_xla"] = par.sharded_closest_faces_sharded_topology(
            v2, f2, q["q200"], mesh, chunk=64)
    out["face_sharded"] = par.sharded_closest_faces_sharded_topology(
        v2, f2, q["q200"], mesh, chunk=64)
    dup = np.concatenate([f2, f2])
    for merge in ("gather", "ring"):
        out["dup_" + merge] = par.sharded_closest_faces_sharded_topology(
            v2, dup, q["q300"], mesh, chunk=64, merge=merge)
        out["nan_" + merge] = par.sharded_closest_faces_sharded_topology(
            inp["v_nan"], f2, q["q40"], mesh, chunk=64, merge=merge)
        out["few_" + merge] = par.sharded_closest_faces_sharded_topology(
            *inp["few"], q["q13"], mesh, chunk=8, merge=merge)
    out["odd_faces"] = par.sharded_closest_faces_sharded_topology(
        v1, f1[:77], q["q50"], mesh, chunk=16)
    out["odd_queries"] = par.sharded_closest_faces_and_points(
        v1, f1, q["q37"], mesh, chunk=16)
    for nb in (16, 10):
        out["normals_%d" % nb] = par.sharded_batched_vert_normals(
            inp["bodies_%d" % nb], f1, mesh).numpy()
    for nb in (8, 5):
        out["batch_vis_%d" % nb] = par.sharded_batched_visibility(
            inp["vis_bodies_%d" % nb], f2, inp["cams"], mesh)
    out["vis"] = par.sharded_visibility(v2, f2, inp["cams"], n=inp["n2"],
                                        mesh=mesh)
    out["vis_odd"] = par.sharded_visibility(v1, f1, inp["cams"][:1],
                                            mesh=mesh)
    local = par.shard_queries(q["q37"], mesh).to_local()
    out["shard_queries"] = local.numpy()

    # the sharded fit on a (2, 2) ("dp", "sp") mesh
    mesh2 = par.make_device_mesh(axis_names=("dp", "sp"), shape=(2, 2),
                                 device="cpu")
    model = _model(inp)
    target = inp["fit_target"]
    state = _converted(inp, mesh2)
    out["fit_rows"] = state.shard.rows
    step = par.make_fit_step(model, fit.adam, mesh=mesh2)
    state, loss = step(state, target)
    out["fit_step1"] = dict(_rows(state), loss=float(loss))
    losses = [float(loss)]
    for _ in range(5):
        state, loss = step(state, target)
        losses.append(float(loss))
    out["fit_losses"] = losses
    # a whole state meets the step: placed explicitly
    whole = _converted(inp)
    _, loss_whole = step(whole, target)
    out["fit_whole_loss"] = float(loss_whole)
    _, out["fit_scan_loss"] = par.fit_scan(model, target, steps=3,
                                           mesh=mesh2, device="cpu")
    idx, bary, lm_target = inp["landmarks"]
    lm_step = par.make_fit_step(model, fit.adam, mesh=mesh2,
                                landmarks=(idx, bary, lm_target),
                                landmark_weight=10.0)
    lm_state, lm_loss = lm_step(_converted(inp), target)
    out["fit_landmark_step1"] = dict(_rows(lm_state), loss=float(lm_loss))
    return out


def distributed_world(rank, n, inp):
    """The launcher path, meshes, placement, the multi-process query and
    the engine's lane inside a world."""
    from mesh_tpu_torch.parallel import distributed as pdist

    import torch.distributed as dist

    # a mesh made before the launcher's group is joined starts this
    # process's own one-rank world; initialize_multihost ends it and joins
    out = {"private_size": par.make_device_mesh(device="cpu").size()}
    out["live"] = par.initialize_multihost()
    out["world"] = dist.get_world_size()
    mesh = par.global_device_mesh(device="cpu")
    out["mesh_1d"] = (mesh.mesh_dim_names, mesh.size(0))
    mesh2 = par.global_device_mesh(("dp", "sp"), (n // 2, 2), device="cpu")
    out["mesh_2d"] = (mesh2.mesh_dim_names, tuple(mesh2.shape))
    try:
        par.global_device_mesh(("dp", "sp"), device="cpu")
    except ValueError as err:
        out["needs_shape"] = str(err)

    # placement: a pytree of sharded leaves of several dtypes, a replica
    # and a numpy array come home in one collective
    rows = np.arange(6 * 3, dtype=np.float32).reshape(6, 3) + 100 * rank
    tree = {"f": par.shard_from_local(rows, mesh),
            "i": par.shard_from_local(np.full((2,), rank, np.int64), mesh),
            "b": par.shard_from_local(np.array([rank % 2 == 0]), mesh),
            "rep": par.replicate_to_mesh(np.float32([1.0, 2.0]), mesh),
            "np": np.int32([7])}
    out["gathered"] = par.gather_to_hosts(tree)
    out["sharded_shape"] = tuple(tree["f"].shape)

    # the multi-process query: ragged counts, a zero-row process
    v, f = inp["body"]
    out["multihost"] = par.multihost_closest_faces_and_points(
        v, f, inp["multihost_points"][rank], mesh)
    out["blocks"] = pdist._process_blocks(
        mesh, len(inp["multihost_points"][rank]), 1)
    from torch.distributed.device_mesh import DeviceMesh

    crossed = DeviceMesh("cpu", torch.tensor([[0, 2], [1, 3]]),
                         mesh_dim_names=("dp", "sp"))
    try:
        pdist._process_blocks(crossed, 3, 1)
    except ValueError as err:
        out["misordered"] = str(err)

    # the engine's lane on rank 0 alone: no other rank joins it
    if rank == 0:
        from mesh_tpu_torch import Mesh, engine
        from mesh_tpu_torch.obs.metrics import REGISTRY

        m = Mesh(v=v, f=f, device="cpu")
        pts = inp["lane_points"]
        counter = REGISTRY.counter("mesh_tpu_fleet_shard_dispatches_total")
        off = engine.submit("closest_point", m, pts).result(timeout=60)
        with _env(MESH_TPU_FLEET_SHARD_MIN_Q="1024"):
            before = counter.value()
            on = engine.submit("closest_point", m, pts).result(timeout=60)
            out["lane_counted"] = counter.value() - before
        out["lane"] = (off, on)
    return out


def checkpoint_world(rank, n, inp):
    """Save at step 3 on a (2, 2) mesh; restore into a whole template and
    into a placed one; one more step from each against the live one."""
    mesh = par.make_device_mesh(axis_names=("dp", "sp"), shape=(2, 2),
                                device="cpu")
    model = _model(inp)
    target = inp["fit_target"]
    state, _ = fit.init_fit_state(model, target.shape[0], device="cpu")
    step = par.make_fit_step(model, fit.adam, mesh=mesh)
    for _ in range(3):
        state, _ = step(state, target)
    path = par.save_fit_state(inp["path"], state, step=3)
    out = {"path": path, "is_dir": os.path.isdir(path)}
    template, _ = fit.init_fit_state(model, target.shape[0], device="cpu")
    restored, at = par.restore_fit_state(path, template)
    out["whole_restored"] = (_rows(restored), at,
                             restored.opt_state.state_dict())
    placed_template = par.place_fit_state(template, mesh)
    # only the mesh's first rank reads the directory: the others are given
    # one that does not exist
    first = all(c == 0 for c in mesh.get_coordinate())
    restored_p, _ = par.restore_fit_state(
        path if first else path + ".not-here", placed_template)
    out["placed_rows"] = _rows(restored_p)
    out["live_rows"] = _rows(state)
    live_next, live_loss = step(state, target)
    out["live_next"] = dict(_rows(live_next), loss=float(live_loss))
    for name, st in (("whole", restored), ("placed", restored_p)):
        nxt, loss = step(st, target)
        out[name + "_next"] = dict(_rows(nxt), loss=float(loss))
    return out
