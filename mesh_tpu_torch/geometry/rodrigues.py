"""Axis-angle -> rotation matrix (counterpart of the first half of
mesh_tpu/geometry/rodrigues.py: ``_skew`` and ``rodrigues2rotmat``).

Batched ``[..., 3] -> [..., 3, 3]`` and branch-free, with the same Taylor
switch near theta = 0 as the reference, so the rest pose is exact.
"""

import torch

from ..utils.device import as_tensor

_TAYLOR_EPS = 1e-8


def _skew(r):
    """[..., 3] -> [..., 3, 3] skew-symmetric cross-product matrix."""
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def rodrigues2rotmat_t(r):
    """R = I + sinc(t) K + (1 - cos t)/t^2 K^2 with K = skew(r), on the
    tensor's own device; K^2 is written as r r^T - t^2 I."""
    t2 = (r * r).sum(dim=-1)[..., None, None]
    small = t2 < _TAYLOR_EPS
    t2_safe = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(t2_safe)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / t2_safe)
    K = _skew(r)
    rrt = r[..., :, None] * r[..., None, :]
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(K.shape)
    return eye + a * K + b * (rrt - t2 * eye)


def rodrigues2rotmat(r, device="cuda"):
    """Axis-angle [..., 3] -> rotation matrix [..., 3, 3]."""
    return rodrigues2rotmat_t(as_tensor(r, device))
