"""Carry a body model's weights, a fit's state, a spatial index and anchor
tables across from the JAX package.

``mesh_tpu.models.BodyModel`` is a dataclass of device arrays plus the
static ``parents`` tree.  Hand its fields over as numpy arrays, e.g.::

    fields = {name: np.asarray(getattr(jax_model, name))
              for name in WEIGHT_NAMES}
    fields.update({name: np.asarray(getattr(jax_model, name))
                   for name in PCA_NAMES
                   if getattr(jax_model, name) is not None})
    model = body_model_from_fields(fields, jax_model.parents, device="cuda")

Every array keeps its dtype, so float32 weights arrive bit for bit; the
MANO / SMPL-H pose-PCA basis (PCA_NAMES) comes along where it is given.  A
``mesh_tpu.parallel.fit.FitState`` made with ``optax.adam`` crosses the
same way (``fit_state_from_arrays``): its parameters, and its
``ScaleByAdamState(count, mu, nu)`` as ``torch.optim.Adam``'s ``step``,
``exp_avg`` and ``exp_avg_sq``, so a fit resumes mid-run in the port.
A ``mesh_tpu.accel.AccelIndex`` (BVH or grid) crosses as its ``kind``,
``digest``, ``arrays`` and ``meta`` (``accel_index_from_arrays``), and
the anchor tables of ``mesh_tpu.query.build_anchor_tables`` as their two
arrays (``anchor_tables_from_arrays``), so both packages walk the same
state.  This module never imports JAX: the caller does the
``np.asarray``.
"""

import numpy as np

import torch

from .models.body_model import (  # noqa: F401
    PCA_NAMES,
    WEIGHT_NAMES,
    body_model_from_arrays,
)
from .parallel.fit import FIT_PARAMS  # noqa: F401
from .utils.device import as_tensor


def body_model_from_fields(fields, parents, device="cuda"):
    """The port's ``BodyModel`` from a JAX ``BodyModel``'s fields (a dict
    of numpy arrays keyed by WEIGHT_NAMES, and PCA_NAMES where the model
    has its pose-PCA basis) and its ``parents``."""
    missing = [name for name in WEIGHT_NAMES if name not in fields]
    if missing:
        raise KeyError("body model fields missing: %s" % ", ".join(missing))
    return body_model_from_arrays(fields, parents, device=device)


def fit_state_from_arrays(params, count, mu, nu, lr=1e-2, *, device="cuda",
                          mesh=None, dp_axis="dp"):
    """The port's ``FitState`` from a JAX one handed over as numpy arrays.

    ``params``, ``mu`` and ``nu`` are dicts keyed by FIT_PARAMS: the
    state's ``betas``, ``pose`` and ``trans``, and the first and second
    moments of its ``optax.adam`` state; ``count`` is that state's step
    count.  The optimizer is ``torch.optim.Adam(lr=lr)`` with those
    moments and that step, which continues optax's update (the same
    formula, up to rounding).  With ``mesh`` the state lands on it
    (``parallel.fit.place_fit_state``): each rank keeps its rows along
    ``dp_axis``, parameters and moments, on the mesh's device."""
    from .parallel.fit import FitState, adam, place_fit_state

    leaves = [as_tensor(params[name], device).detach().clone()
              .requires_grad_(True) for name in FIT_PARAMS]
    opt = adam(leaves, lr=lr)
    for name, leaf in zip(FIT_PARAMS, leaves):
        opt.state[leaf] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": as_tensor(mu[name], leaf.device, leaf.dtype).clone(),
            "exp_avg_sq": as_tensor(nu[name], leaf.device,
                                    leaf.dtype).clone()}
    state = FitState(*leaves, opt_state=opt)
    return state if mesh is None else place_fit_state(state, mesh, dp_axis)


def accel_index_from_arrays(kind, digest, arrays, meta):
    """The port's ``AccelIndex`` from a JAX one's ``kind``, ``digest``,
    ``meta`` and ``arrays`` (a dict of numpy arrays): each array keeps its
    dtype and bits."""
    from .accel.build import AccelIndex

    return AccelIndex(kind, digest,
                      {name: np.asarray(arr) for name, arr in arrays.items()},
                      meta)


def anchor_tables_from_arrays(table, safe, *, device="cuda"):
    """``(table [V, K] int32, safe [V] float32)`` on ``device``, as
    ``query.anchored.closest_point_anchored_auto`` takes them, from the
    JAX ``build_anchor_tables``' two arrays."""
    return (as_tensor(np.array(table, np.int32), device),
            as_tensor(np.array(safe, np.float32), device))
