"""Row-wise cross product (counterpart of mesh_tpu/geometry/cross_product.py).

Written out by components, in the order ``jnp.cross`` uses, so every caller
in the port (face normals, the kernel's per-face planes, the exact winner
recompute) rounds the same way on the CPU and on the card.
"""

import torch

from ..utils.device import resolve_device


def cross3(a, b):
    """Cross product over the last axis of two broadcastable (..., 3)
    tensors, on their own device."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def cross(a, b, device="cuda"):
    """Row-wise cross product of (..., 3) arrays (reference CrossProduct);
    1-D inputs are read as one row."""
    dev = resolve_device(device)
    a = torch.as_tensor(a, device=dev)
    b = torch.as_tensor(b, device=dev)
    return cross3(a.reshape(a.shape[:-2] + (-1, 3)) if a.ndim >= 2
                  else a.reshape(-1, 3),
                  b.reshape(b.shape[:-2] + (-1, 3)) if b.ndim >= 2
                  else b.reshape(-1, 3))
