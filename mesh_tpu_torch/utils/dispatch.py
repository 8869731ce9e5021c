"""The kernel-or-plain dispatch policy (counterpart of
mesh_tpu/utils/dispatch.py).

Every query of the port has two routes: the kernel route (the hand-written
CUDA kernel on the card, its plain PyTorch twin on the CPU) and the
reference's XLA form written in plain PyTorch, which runs anywhere.  The
kernel route is the default on every device; ``MESH_TPU_FORCE_XLA=1``
sends every entry point to the XLA forms instead, on any device: the
escape hatch for a kernel that misbehaves on the card, without a
downgrade or a patch.  The knob is read per call, so a caller (or a test)
can flip it between calls.

Each decision is counted in
``mesh_tpu_dispatch_backend_total{backend, reason}`` with the reference's
label values: ``backend`` is ``pallas`` (here: the hand-written kernel
route) or ``xla`` (the reference's XLA form in plain PyTorch), ``reason``
is ``forced`` (the knob) or ``platform`` (the default).
"""

from ..obs.metrics import REGISTRY
from . import knobs
from .device import resolve_device

__all__ = ["force_xla", "pallas_default"]


def force_xla():
    """True when ``MESH_TPU_FORCE_XLA`` asks for the XLA forms everywhere."""
    return knobs.flag("MESH_TPU_FORCE_XLA")


def _record_backend(use_pallas, reason):
    REGISTRY.counter(
        "mesh_tpu_dispatch_backend_total",
        "Pallas-vs-XLA dispatch decisions by backend and reason.",
    ).inc(backend="pallas" if use_pallas else "xla", reason=reason)
    return use_pallas


def pallas_default(device=None):
    """Whether an entry point on ``device`` (checked when given) takes the
    kernel route: True on the card and on the CPU, False under
    ``MESH_TPU_FORCE_XLA``.  Counts the decision."""
    if device is not None:
        resolve_device(device)
    if force_xla():
        return _record_backend(False, "forced")
    return _record_backend(True, "platform")
