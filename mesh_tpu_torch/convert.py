"""Carry a body model's weights across from the JAX package.

``mesh_tpu.models.BodyModel`` is a dataclass of device arrays plus the
static ``parents`` tree.  Hand its fields over as numpy arrays, e.g.::

    fields = {name: np.asarray(getattr(jax_model, name))
              for name in WEIGHT_NAMES}
    model = body_model_from_fields(fields, jax_model.parents, device="cuda")

Every array keeps its dtype, so float32 weights arrive bit for bit.  This
module never imports JAX: the caller does the ``np.asarray``.
"""

from .models.body_model import WEIGHT_NAMES, body_model_from_arrays


def body_model_from_fields(fields, parents, device="cuda"):
    """The port's ``BodyModel`` from a JAX ``BodyModel``'s fields (a dict
    of numpy arrays keyed by WEIGHT_NAMES) and its ``parents``."""
    missing = [name for name in WEIGHT_NAMES if name not in fields]
    if missing:
        raise KeyError("body model fields missing: %s" % ", ".join(missing))
    return body_model_from_arrays(fields, parents, device=device)
