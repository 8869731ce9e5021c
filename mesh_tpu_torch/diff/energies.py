"""Registration energies composed from the differentiable queries
(counterpart of mesh_tpu/diff/energies.py).

Every term is a scalar tensor function of ``(v, f, scan)`` (or of model
parameters through ``parallel/fit.py``'s LBS), built on ``diff.queries``,
so autograd sees the envelope-theorem gradients instead of a
non-differentiable argmin.  The robust kernels take SQUARED residuals
(the queries return ``sqdist``): Huber for heavy tails, Geman-McClure for
outright outliers.  The landmark term is ``parallel.fit``'s
``landmark_loss`` (imported lazily: fit.py imports this package for its
surface data term).
"""

import torch

from ..utils.device import as_tensor
from .queries import closest_point, surface_normals_frozen

__all__ = [
    "huber", "geman_mcclure", "point_to_point", "point_to_plane",
    "symmetric_chamfer", "landmark_term",
]


def _huber(sq, delta):
    d2 = delta * delta
    r = torch.sqrt(torch.clamp_min(sq, d2))   # only consumed where sq > d2
    return torch.where(sq <= d2, sq, 2.0 * delta * r - d2)


def _geman_mcclure(sq, sigma):
    s2 = sigma * sigma
    return s2 * sq / (s2 + sq)


def huber(sq, delta=1.0, *, device="cuda"):
    """Huber penalty on a SQUARED residual: ``sq`` below ``delta**2``,
    ``2 delta |r| - delta**2`` above.  Smooth at the crossover and safe at
    sq == 0 (the sqrt branch is clamped away from 0 before the select)."""
    return _huber(as_tensor(sq, device), delta)


def geman_mcclure(sq, sigma=1.0, *, device="cuda"):
    """Geman-McClure penalty on a SQUARED residual,
    ``sigma^2 sq / (sigma^2 + sq)``: quadratic near zero, saturating at
    ``sigma^2`` (far outliers stop pulling)."""
    return _geman_mcclure(as_tensor(sq, device), sigma)


def _robustify(sq, robust):
    """A robust kernel given as None, a callable on squared residuals, or
    a ("huber"|"geman_mcclure", scale) pair, applied to ``sq``."""
    if robust is None:
        return sq
    if callable(robust):
        return robust(sq)
    kind, scale = robust
    kernel = {"huber": _huber, "geman_mcclure": _geman_mcclure}[kind]
    return kernel(sq, scale)


def point_to_point(v, f, scan, *, robust=None, mode="frozen", chunk=512,
                   use_pallas=None, device="cuda"):
    """Mean (robustified) squared scan-to-surface distance: every scan
    point pulled to its closest point on the current surface, with exact
    envelope gradients into the scan and the vertices."""
    res = closest_point(v, f, scan, mode=mode, chunk=chunk,
                        use_pallas=use_pallas, device=device)
    return _robustify(res["sqdist"], robust).mean()


def point_to_plane(v, f, scan, *, robust=None, mode="frozen", chunk=512,
                   use_pallas=None, device="cuda"):
    """Mean (robustified) squared point-to-plane residual
    ``((p - cp) . n_face)^2`` with the winning face's unit normal frozen
    (``surface_normals_frozen``): scan points slide along the surface, and
    no gradient goes through the normal."""
    res = closest_point(v, f, scan, mode=mode, chunk=chunk,
                        use_pallas=use_pallas, device=device)
    n = surface_normals_frozen(v, f, res["face"], device=device)
    scan = as_tensor(scan, n.device, n.dtype)
    r = ((scan - res["point"]) * n).sum(dim=-1)
    return _robustify(r * r, robust).mean()


def symmetric_chamfer(v, f, scan, *, robust=None, mode="frozen", chunk=512,
                      use_pallas=None, device="cuda"):
    """Scan -> surface through the differentiable closest point, plus
    vertex -> scan through a dense min over the scan points (the
    completeness term that keeps the surface from collapsing onto a
    partial scan; the scan is a point cloud, so this direction is a plain
    [V, S] min, as in the reference)."""
    res = closest_point(v, f, scan, mode=mode, chunk=chunk,
                        use_pallas=use_pallas, device=device)
    fwd_term = _robustify(res["sqdist"], robust).mean()
    v = as_tensor(v, device)
    scan = as_tensor(scan, v.device, v.dtype)
    d2 = ((v[..., :, None, :] - scan[..., None, :, :]) ** 2).sum(dim=-1)
    bwd_term = _robustify(d2.amin(dim=-1), robust).mean()
    return fwd_term + bwd_term


def landmark_term(verts, landmarks, weight=1.0, *, device="cuda"):
    """``weight`` times ``parallel.fit.landmark_loss`` of ``landmarks``, the
    ``(idx, bary, target_xyz)`` triple of ``parallel.fit.landmark_arrays``."""
    from ..parallel.fit import landmark_loss

    idx, bary, target_xyz = landmarks
    return weight * landmark_loss(verts, idx, bary, target_xyz,
                                  device=device)


def energy(name):
    """A data term by name (the string-keyed form ``diff.register`` and
    sweeps use)."""
    try:
        return {"point_to_point": point_to_point,
                "point_to_plane": point_to_plane,
                "symmetric_chamfer": symmetric_chamfer}[name]
    except KeyError:
        raise ValueError("unknown energy %r (want point_to_point, "
                         "point_to_plane, or symmetric_chamfer)"
                         % (name,)) from None
