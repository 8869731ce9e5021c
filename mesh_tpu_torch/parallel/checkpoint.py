"""Checkpoint and resume of long-running fits (counterpart of
mesh_tpu/parallel/checkpoint.py).

The reference round-trips the fit state (betas, pose, trans and the
optimizer's moments) through orbax.  Here it is one ``torch.save`` of the
whole state in a directory: a sharded state (``FitState.shard``) is
gathered over its ``dp`` axis first and written by the mesh's first rank;
a restore onto a sharded template is read by that rank alone, sent to the
others over the mesh and placed back on the template's ranks, so the
other hosts of a multi-host world need no view of the directory::

    state, opt = init_fit_state(model, batch)
    save_fit_state(path, state, step=120)
    state, step = restore_fit_state(path, state)   # template gives placement

The optimizer travels as its ``state_dict`` (Adam's step and moments and
its options), so one more step from a restored state equals one more step
from the live one, bit for bit.
"""

import io
import os
import shutil

import torch

from . import comm
from .fit import FIT_PARAMS, FitState, adam, gather_fit_state, place_fit_state

__all__ = ["save_fit_state", "restore_fit_state"]

#: the file in a checkpoint directory
STATE_FILE = "fit_state.pt"


def _first_rank(mesh):
    return all(c == 0 for c in mesh.get_coordinate())


def save_fit_state(path, state, step=0, force=True):
    """Write a FitState (and the step counter) to ``path``, a directory,
    replacing one there when ``force``; every rank of a sharded state's
    mesh calls it together.  Returns the absolute path."""
    path = os.path.abspath(str(path))
    whole = gather_fit_state(state)
    mesh = None if state.shard is None else state.shard.mesh
    if mesh is None or _first_rank(mesh):
        if os.path.exists(path) and not force:
            raise FileExistsError("checkpoint %s exists (force=False)" % path)
        payload = {"step": int(step),
                   "opt": (None if whole.opt_state is None
                           else whole.opt_state.state_dict())}
        payload.update({name: getattr(whole, name).detach().cpu()
                        for name in FIT_PARAMS})
        tmp = "%s.tmp-%d" % (path, os.getpid())
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    if mesh is not None:
        comm.mesh_barrier(mesh)
    return path


def restore_fit_state(path, template_state):
    """Restore ``(FitState, step)`` from ``path``.

    ``template_state`` (a FitState of the same shapes, e.g. fresh from
    ``init_fit_state``, or placed on a mesh) gives the device, dtype,
    optimizer class and placement to restore onto: a sharded template
    gets this rank's rows back, every rank of its mesh calling together,
    and only the mesh's first rank reads ``path`` (the one that wrote it);
    a whole template reads ``path`` in this process."""
    mesh = (None if template_state.shard is None
            else template_state.shard.mesh)
    data = None
    if mesh is None or _first_rank(mesh):
        with open(os.path.join(os.path.abspath(str(path)), STATE_FILE),
                  "rb") as fh:
            data = fh.read()
    if mesh is not None:
        data = comm.broadcast_bytes(data, mesh)
    payload = torch.load(io.BytesIO(data), map_location="cpu",
                         weights_only=True)
    ref = template_state.betas
    leaves = [payload[name].to(ref.device, ref.dtype).requires_grad_(True)
              for name in FIT_PARAMS]
    opt = template_state.opt_state
    opt = (type(opt)(leaves, **opt.defaults) if opt is not None
           else adam(leaves))
    if payload["opt"] is not None:
        opt.load_state_dict(payload["opt"])
    state = FitState(*leaves, opt_state=opt)
    if mesh is not None:
        state = place_fit_state(state, mesh, template_state.shard.dp_axis)
    return state, int(payload["step"])
