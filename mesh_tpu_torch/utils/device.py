"""Device choice, and the knob and constant the closest-point path reads.

Counterpart of ``mesh_tpu/utils/dispatch.py``, with the one environment
knob this slice reads (``MESH_TPU_SAFE_TILES``, mesh_tpu/utils/knobs.py)
and the brute crossover constant (mesh_tpu/query/autotune.py).  Every
public entry point of the port takes ``device="cuda"``: the card is the
default, and only an explicit ``device="cpu"`` runs on the CPU.  Asking
for CUDA where there is none raises instead of quietly falling back.
"""

import os

import torch

#: flag values that mean OFF (the reference's knob truthiness)
OFF_VALUES = ("", "0", "false", "no", "off")

#: face count above which the reference's auto ladder leaves the brute
#: kernel for its culled kernel (mesh_tpu/query/autotune.py)
DEFAULT_CROSSOVER = 32768


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
    ``device``; no copy when it is already there with that dtype."""
    return torch.as_tensor(x, dtype=dtype, device=resolve_device(device))


def _flag(name):
    value = os.environ.get(name)
    return value is not None and value.strip().lower() not in OFF_VALUES


def safe_tiles():
    """True when ``MESH_TPU_SAFE_TILES`` pins the closest-point kernel to
    its sliver-safe tile and forces the nondegeneracy check to False."""
    return _flag("MESH_TPU_SAFE_TILES")


def tile_variant():
    """``"safe"`` under ``MESH_TPU_SAFE_TILES``, else ``"fast"``."""
    return "safe" if safe_tiles() else "fast"

