"""Scan-registration training step on one device (counterpart of
mesh_tpu/parallel/fit.py).

Registering raw scans against a body model (BASELINE config 5): LBS
forward -> scan-to-surface loss -> Adam update, batched over bodies.
Gradients flow through the Taylor-guarded Rodrigues map and the surface
distance.

The default data term is the point-to-SURFACE energy: each scan point's
squared distance to its closest point on the posed surface, through
``diff.closest_point_batched``'s envelope-theorem backward, so the search
runs once a loss evaluation (the closest-face kernel on the card, one
launch for the batch) and the backward re-runs none.  The
min-over-VERTICES chamfer stays behind ``MESH_TPU_VERTEX_CHAMFER=1``, read
when the step or loss is built.

Differences from the reference: the optimizer is ``torch.optim.Adam`` in
place of ``optax.adam`` (the same update up to rounding), bound to the
state's tensors, so a step updates ``FitState`` in place; the sharded step
over a device mesh (``make_fit_step(mesh=...)``) is not ported.
"""

import dataclasses

import numpy as np
import torch

from ..models.body_model import lbs, no_tf32
from ..utils.device import as_tensor, resolve_device

#: the one precision of the fit's products
PRECISION = "highest"


def adam(params, lr=1e-2):
    """The default optimizer, ``optax.adam(1e-2)``'s counterpart."""
    return torch.optim.Adam(params, lr=lr)


@dataclasses.dataclass
class FitState:
    betas: torch.Tensor   # (B, n_betas), a leaf that requires grad
    pose: torch.Tensor    # (B, J, 3)
    trans: torch.Tensor   # (B, 3)
    opt_state: torch.optim.Optimizer  # over [betas, pose, trans]


def landmark_arrays(regressors, names=None, pad_to=None, *, device="cuda"):
    """Pack a ``landm_regressors`` dict (name -> (vertex indices, bary
    coefficients)) into fixed-shape tensors.

    :returns: ``(idx [L, K] int32, bary [L, K] float32, names [L])``, rows
        in ``names`` order (sorted when not given), zero-padded so the
        regression ``sum_k bary[l, k] * verts[idx[l, k]]`` is exact.
    """
    names = list(names) if names is not None else sorted(regressors)
    k = pad_to or max(len(regressors[n][0]) for n in names)
    idx = np.zeros((len(names), k), np.int32)
    bary = np.zeros((len(names), k), np.float32)
    for li, name in enumerate(names):
        vi, coeff = regressors[name]
        idx[li, : len(vi)] = np.asarray(vi).ravel()
        bary[li, : len(coeff)] = np.asarray(coeff).ravel()
    return as_tensor(idx, device), as_tensor(bary, device), names


def landmark_loss(verts, landm_idx, landm_bary, target_xyz, *,
                  device="cuda"):
    """Mean squared distance between regressed and observed landmarks.

    ``verts`` (..., V, 3); ``landm_idx`` / ``landm_bary`` (L, K) packed
    regressors; ``target_xyz`` (..., L, 3)."""
    verts = as_tensor(verts, device)
    idx = as_tensor(landm_idx, verts.device).long()
    bary = as_tensor(landm_bary, verts.device, verts.dtype)
    ring = verts[..., idx, :]                            # (..., L, K, 3)
    regressed = (ring * bary[..., None]).sum(dim=-2)
    target = as_tensor(target_xyz, verts.device, verts.dtype)
    return ((regressed - target) ** 2).sum(dim=-1).mean()


def _vertex_chamfer_data(verts, target_points):
    """Mean squared scan-to-nearest-VERTEX distance: exact and
    differentiable, but above the surface distance wherever a scan point
    faces the inside of a triangle.  For MESH_TPU_VERTEX_CHAMFER=1."""
    d2 = ((target_points[..., :, None, :] - verts[..., None, :, :]) ** 2
          ).sum(dim=-1)
    return d2.amin(dim=-1).mean()


def _surface_data(verts, faces, target_points):
    """Mean squared distance from each scan point to its closest point on
    the posed surface, through ``diff.closest_point_batched``: the
    correspondence is exact at every evaluation, so this is gradient
    descent on the true surface distance (``diff/register.py`` is the
    k-step-frozen variant)."""
    from ..diff.queries import closest_point_batched

    lead = torch.broadcast_shapes(verts.shape[:-2], target_points.shape[:-2])
    verts_b = verts.expand(lead + verts.shape[-2:])
    pts_b = target_points.expand(lead + target_points.shape[-2:])
    res = closest_point_batched(verts_b, faces, pts_b, device=verts.device)
    return res["sqdist"].mean()


def _resolve_data_term(data_term):
    """``None`` -> the knob (``utils.knobs.vertex_chamfer``); else the
    explicit ``"surface"`` / ``"vertex"``."""
    if data_term is None:
        from ..utils.knobs import vertex_chamfer

        return "vertex" if vertex_chamfer() else "surface"
    if data_term not in ("surface", "vertex"):
        raise ValueError(
            "data_term must be None, 'surface' or 'vertex', got %r"
            % (data_term,))
    return data_term


def _check_precision(precision):
    """The reference runs the fit's products at ``Precision.HIGHEST``.  The
    port runs them in float32 with TF32 off (``lbs`` in its forward, the
    fit step around its backward too); TF32 keeps about three decimal
    digits, which would move the gradients of an LBS chain by about 1e-3
    relative, so no other precision is offered."""
    if precision != PRECISION:
        raise ValueError("precision must be %r (float32 products without "
                         "TF32), got %r" % (PRECISION, precision))


def scan_to_model_loss(model, betas, pose, trans, target_points,
                       pose_prior_weight=1e-3, beta_prior_weight=1e-3,
                       landmarks=None, landmark_weight=1.0,
                       precision=PRECISION, data_term=None, *,
                       device="cuda"):
    """Mean squared scan-to-SURFACE distance + L2 priors, optionally
    anchored by named landmarks.

    ``target_points`` (..., S, 3).  The default data term queries each scan
    point against the posed surface (``model.faces``) through
    ``diff.closest_point_batched``; ``data_term="vertex"`` (or
    MESH_TPU_VERTEX_CHAMFER=1) takes the min-over-vertices chamfer.
    ``landmarks``: an optional ``(idx, bary, target_xyz)`` triple
    (``landmark_arrays``) adding ``landmark_weight * landmark_loss``.
    The forward runs without TF32; run its backward inside
    ``models.body_model.no_tf32()`` too, as ``make_fit_step`` does.
    """
    _check_precision(precision)
    dev = resolve_device(device)
    dtype = model.v_template.dtype
    betas = as_tensor(betas, dev, dtype)
    pose = as_tensor(pose, dev, dtype)
    verts, _ = lbs(model, betas, pose, trans, device=dev)
    target = as_tensor(target_points, dev, verts.dtype)
    if _resolve_data_term(data_term) == "surface":
        data = _surface_data(verts, model.faces, target)
    else:
        data = _vertex_chamfer_data(verts, target)
    prior = (pose_prior_weight * (pose ** 2).mean()
             + beta_prior_weight * (betas ** 2).mean())
    total = data + prior
    if landmarks is not None:
        idx, bary, target_xyz = landmarks
        total = total + landmark_weight * landmark_loss(
            verts, idx, bary, target_xyz, device=dev)
    return total


def init_fit_state(model, batch_size, optimizer=None, dtype=torch.float32,
                   *, device="cuda"):
    """Zero betas, pose and trans for ``batch_size`` bodies and the
    optimizer over them -> ``(FitState, optimizer)``; ``optimizer`` is a
    ``params list -> torch.optim.Optimizer`` (default ``adam``)."""
    dev = resolve_device(device)
    optimizer = optimizer or adam
    betas = torch.zeros((batch_size, model.num_betas), dtype=dtype,
                        device=dev, requires_grad=True)
    pose = torch.zeros((batch_size, model.num_joints, 3), dtype=dtype,
                       device=dev, requires_grad=True)
    trans = torch.zeros((batch_size, 3), dtype=dtype, device=dev,
                        requires_grad=True)
    state = FitState(betas=betas, pose=pose, trans=trans,
                     opt_state=optimizer([betas, pose, trans]))
    return state, optimizer


def make_fit_step(model, optimizer, mesh=None, dp_axis="dp", sp_axis="sp",
                  landmarks=None, landmark_weight=1.0, precision=PRECISION,
                  data_term=None, *, device="cuda"):
    """Build the training step ``step(state, target_points) -> (state,
    loss)``: loss, gradients and one update of ``state.opt_state``, in
    place, with TF32 off through the forward and the backward.  A state
    whose ``opt_state`` is None gets ``optimizer([betas, pose, trans])``
    at its first step.  ``data_term`` is resolved now (None ->
    "surface" unless MESH_TPU_VERTEX_CHAMFER=1).  ``mesh`` (the sharded
    step) is not ported."""
    if mesh is not None:
        raise NotImplementedError(
            "make_fit_step(mesh=...): the sharded step over a device mesh "
            "(mesh_tpu.parallel.fit.make_fit_step's dp/sp branch) is not "
            "ported yet (ROADMAP.md, Queue 1)")
    _check_precision(precision)
    data_term = _resolve_data_term(data_term)
    dev = resolve_device(device)

    def step(state, target_points):
        target = as_tensor(target_points, dev, state.betas.dtype)
        if state.opt_state is None:
            state.opt_state = optimizer([state.betas, state.pose,
                                         state.trans])
        with no_tf32():
            state.opt_state.zero_grad()
            loss = scan_to_model_loss(
                model, state.betas, state.pose, state.trans, target,
                landmarks=landmarks, landmark_weight=landmark_weight,
                precision=precision, data_term=data_term, device=dev)
            loss.backward()
            state.opt_state.step()
        return state, loss.detach()

    return step


def fit_scan(model, target_points, steps=100, batch_size=None, mesh=None,
             optimizer=None, landmarks=None, landmark_weight=1.0,
             precision=PRECISION, data_term=None, *, device="cuda"):
    """Fit the model to (B, S, 3) scan batches (or one (S, 3) scan),
    optionally anchored by ``landmarks=(idx, bary, target_xyz)``
    -> ``(FitState, last loss)``."""
    target = as_tensor(target_points, device, torch.float32)
    if target.ndim == 2:
        target = target[None]
    batch_size = batch_size or target.shape[0]
    state, optimizer = init_fit_state(model, batch_size, optimizer,
                                      device=device)
    step = make_fit_step(model, optimizer, mesh=mesh, landmarks=landmarks,
                         landmark_weight=landmark_weight,
                         precision=precision, data_term=data_term,
                         device=device)
    loss = None
    for _ in range(steps):
        state, loss = step(state, target)
    return state, float(loss)
