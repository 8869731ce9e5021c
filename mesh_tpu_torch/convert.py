"""Carry a body model's weights and a fit's state across from the JAX
package.

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
This module never imports JAX: the caller does the ``np.asarray``.
"""

import torch

from .models.body_model import (  # noqa: F401
    PCA_NAMES,
    WEIGHT_NAMES,
    body_model_from_arrays,
)
from .utils.device import as_tensor

#: the parameters of a fit state, in the optimizer's order
FIT_PARAMS = ("betas", "pose", "trans")


def body_model_from_fields(fields, parents, device="cuda"):
    """The port's ``BodyModel`` from a JAX ``BodyModel``'s fields (a dict
    of numpy arrays keyed by WEIGHT_NAMES, and PCA_NAMES where the model
    has its pose-PCA basis) and its ``parents``."""
    missing = [name for name in WEIGHT_NAMES if name not in fields]
    if missing:
        raise KeyError("body model fields missing: %s" % ", ".join(missing))
    return body_model_from_arrays(fields, parents, device=device)


def fit_state_from_arrays(params, count, mu, nu, lr=1e-2, *, device="cuda"):
    """The port's ``FitState`` from a JAX one handed over as numpy arrays.

    ``params``, ``mu`` and ``nu`` are dicts keyed by FIT_PARAMS: the
    state's ``betas``, ``pose`` and ``trans``, and the first and second
    moments of its ``optax.adam`` state; ``count`` is that state's step
    count.  The optimizer is ``torch.optim.Adam(lr=lr)`` with those
    moments and that step, which continues optax's update (the same
    formula, up to rounding)."""
    from .parallel.fit import FitState, adam

    leaves = [as_tensor(params[name], device).detach().clone()
              .requires_grad_(True) for name in FIT_PARAMS]
    opt = adam(leaves, lr=lr)
    for name, leaf in zip(FIT_PARAMS, leaves):
        opt.state[leaf] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": as_tensor(mu[name], leaf.device, leaf.dtype).clone(),
            "exp_avg_sq": as_tensor(nu[name], leaf.device,
                                    leaf.dtype).clone()}
    return FitState(*leaves, opt_state=opt)
