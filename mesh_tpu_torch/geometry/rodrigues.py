"""Axis-angle <-> rotation matrix (counterpart of
mesh_tpu/geometry/rodrigues.py, a cv2.Rodrigues port).

- ``rodrigues2rotmat``: batched ``[..., 3] -> [..., 3, 3]``, branch-free,
  with the reference's Taylor switch near theta = 0, so the rest pose and
  its gradient are exact;
- ``rotmat2rodrigues``: the batched, branch-free inverse (no Jacobian);
- ``rodrigues``: the reference-compatible entry point, a 3-vector or a
  3x3 matrix in, numpy float64 out, optionally with the cv2-layout
  Jacobian (3x9 forward by ``torch.func.jacfwd`` of the exact map; 9x3
  inverse by the analytic chain rule cv2 uses).
"""

import numpy as np
import torch

from ..utils.device import as_tensor, resolve_device

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


def rotmat2rodrigues_t(R):
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3], branch-free, on
    the tensor's own device: the generic case from the antisymmetric part,
    the near-pi case from the diagonal with cv2's sign conventions, the
    near-identity case 0."""
    return _rotmat2rodrigues(R)[0]


def _rotmat2rodrigues(R):
    """``rotmat2rodrigues_t`` and the quantities cv2's inverse Jacobian is
    written in: (axis-angle, ((rx, ry, rz), s, c, theta))."""
    rx = R[..., 2, 1] - R[..., 1, 2]
    ry = R[..., 0, 2] - R[..., 2, 0]
    rz = R[..., 1, 0] - R[..., 0, 1]
    rvec = torch.stack([rx, ry, rz], dim=-1)
    s = torch.sqrt((rvec * rvec).sum(dim=-1) * 0.25)
    c = torch.clamp((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) * 0.5,
                    -1.0, 1.0)
    theta = torch.arccos(c)

    # generic branch: r = theta / (2 sin theta) * rvec
    s_safe = torch.where(s < 1e-5, torch.ones_like(s), s)
    generic = rvec * (theta / (2.0 * s_safe))[..., None]

    # near-pi branch: |axis_i| from the diagonal, signs fixed as cv2 does
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp_min((diag + 1.0) * 0.5, 0.0))
    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
    ay = torch.where(R[..., 0, 1] < 0, -ay, ay)
    az = torch.where(R[..., 0, 2] < 0, -az, az)
    flip = ((ax.abs() < ay.abs()) & (ax.abs() < az.abs())
            & ((R[..., 1, 2] > 0) != (ay * az > 0)))
    az = torch.where(flip, -az, az)
    axis = torch.stack([ax, ay, az], dim=-1)
    norm = torch.sqrt((axis * axis).sum(dim=-1))
    norm_safe = torch.where(norm == 0, torch.ones_like(norm), norm)
    near_pi = axis * (theta / norm_safe)[..., None]

    small = (s < 1e-5)[..., None]
    at_zero = torch.where((c > 0)[..., None], torch.zeros_like(rvec), near_pi)
    return torch.where(small, at_zero, generic), ((rx, ry, rz), s, c, theta)


def rotmat2rodrigues(R, *, device="cuda"):
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3]."""
    return rotmat2rodrigues_t(as_tensor(R, device))


def _forward_jacobian(r, device):
    """cv2-layout forward Jacobian of the float64 3-vector ``r``: row i is
    d(R.flatten()) / d r_i, (3, 9)."""
    r = torch.as_tensor(r, dtype=torch.float64, device=device)
    jac = torch.func.jacfwd(lambda rr: rodrigues2rotmat_t(rr).reshape(9))(r)
    return jac.cpu().numpy().T.reshape(3, 9)


def _inverse_jacobian(parts):
    """cv2's analytic chain for d(axis-angle) / d(R.flatten()), (9, 3):
    R -> (rx, ry, rz, tr) -> (ux, uy, uz, theta) -> omega, at the 0-d
    tensors ``parts`` of ``_rotmat2rodrigues``."""
    (rx, ry, rz), s, c, theta = (
        tuple(float(x) for x in parts[0]), *(float(x) for x in parts[1:]))
    if s < 1e-5:
        jac = np.zeros((9, 3))
        if c > 0:
            jac[1, 2] = jac[5, 0] = jac[6, 1] = -0.5
            jac[2, 1] = jac[3, 2] = jac[7, 0] = 0.5
        return jac
    vth = 1.0 / (2.0 * s)
    dtheta_dtr = -1.0 / s
    dvth_dtheta = -vth * c / s
    d1 = 0.5 * dvth_dtheta * dtheta_dtr
    d2 = 0.5 * dtheta_dtr
    # d(rx, ry, rz, vth, theta) / dR(flat)
    dvar_dR = np.array(
        [
            [0, 0, 0, 0, 0, 1, 0, -1, 0],
            [0, 0, -1, 0, 0, 0, 1, 0, 0],
            [0, 1, 0, -1, 0, 0, 0, 0, 0],
            [d1, 0, 0, 0, d1, 0, 0, 0, d1],
            [d2, 0, 0, 0, d2, 0, 0, 0, d2],
        ],
        dtype=np.float64,
    )
    dvar2_dvar = np.array(
        [
            [vth, 0, 0, rx, 0],
            [0, vth, 0, ry, 0],
            [0, 0, vth, rz, 0],
            [0, 0, 0, 0, 1],
        ],
        dtype=np.float64,
    )
    domega_dvar2 = np.array(
        [
            [theta, 0, 0, rx * vth],
            [0, theta, 0, ry * vth],
            [0, 0, theta, rz * vth],
        ],
        dtype=np.float64,
    )
    jac = domega_dvar2 @ dvar2_dvar @ dvar_dR
    # cv2 stores d/dR with R traversed column-major per output row
    for i in range(3):
        jac[i] = jac[i].reshape(3, 3).T.flatten()
    return jac.T


def rodrigues(r, calculate_jacobian=True, *, device="cuda"):
    """Reference-compatible Rodrigues transform, in float64 on ``device``:
    a 3-vector -> (3, 3) rotation matrix [+ (3, 9) Jacobian]; a 3x3 matrix
    (projected to the nearest rotation by SVD) -> (3, 1) axis-angle
    [+ (9, 3) Jacobian].  numpy float64 out."""
    r = np.array(r, dtype=np.float64)
    if r.shape in ((3,), (3, 1), (1, 3)):
        rf = r.flatten()
        R = rodrigues2rotmat_t(as_tensor(rf, device)).cpu().numpy()
        if not calculate_jacobian:
            return R
        return R, _forward_jacobian(rf, resolve_device(device))
    if r.shape == (3, 3):
        u, _, vt = np.linalg.svd(r)
        out, parts = _rotmat2rodrigues(as_tensor(u @ vt, device))
        out = out.cpu().numpy().reshape(3, 1)
        if not calculate_jacobian:
            return out
        return out, _inverse_jacobian(parts)
    raise ValueError("rodrigues: input must be a 3-vector or 3x3 matrix.")
