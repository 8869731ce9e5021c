"""Device choice (counterpart of the device half of
``mesh_tpu/utils/dispatch.py``; the knobs live in ``utils/knobs.py``).

Every public entry point of the port takes ``device="cuda"``: the card is
the default, and only an explicit ``device="cpu"`` runs on the CPU.  Asking
for CUDA where there is none raises instead of quietly falling back.
"""

import numpy as np
import torch


def resolve_device(device="cuda"):
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    this process has none, so no caller runs on the CPU by accident."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device %r requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU" % (str(device),))
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("device must be 'cuda' or 'cpu', got %r" % (device,))
    return dev


def as_tensor(x, device, dtype=None):
    """``x`` (numpy array, tensor or sequence) as a tensor on the resolved
    ``device``; no copy when it is already there with that dtype, except
    for a read-only array (a block the mesh store mapped from disk), which
    is copied rather than aliased by a tensor that may be written."""
    return torch.as_tensor(writable(x), dtype=dtype,
                           device=resolve_device(device))


def writable(x):
    """``x``, or a copy of it where it is a read-only numpy array."""
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        return np.array(x)
    return x


def host_array(x, dtype):
    """``x`` (tensor on any device, or array-like) as a numpy array of
    ``dtype``, without a copy where none is needed."""
    return (x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)).astype(
        dtype, copy=False)
