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

With a device mesh (``make_fit_step(mesh=...)``) the step runs on every
rank of a ``("dp", "sp")`` ``DeviceMesh``: the bodies and their parameters
and Adam moments are split over ``dp`` (each rank holds its rows: a
``FitState`` with a ``BatchShard``), the scan points over ``sp``.  Each
rank's loss is its share of the global one, normalised by the global
counts (the priors and landmarks counted on the first ``sp`` rank only),
a body's gradient is summed over its ``sp`` group in coordinate order
before the update, and the returned loss is the sum over the mesh: the
unsharded loss up to rounding.

Differences from the reference: the optimizer is ``torch.optim.Adam`` in
place of ``optax.adam`` (the same update up to rounding), bound to the
state's tensors, so a step updates ``FitState`` in place; the sharded step
is multi-controller (every rank calls it with the same arguments) with
explicit collectives (``parallel.comm``) where XLA inserts them.
"""

import dataclasses

import numpy as np
import torch

from ..models.body_model import lbs, no_tf32
from ..utils.device import as_tensor, resolve_device
from . import comm

#: the one precision of the fit's products
PRECISION = "highest"

#: the default weights of the L2 priors on the pose and the betas
POSE_PRIOR_WEIGHT = 1e-3
BETA_PRIOR_WEIGHT = 1e-3


def adam(params, lr=1e-2):
    """The default optimizer, ``optax.adam(1e-2)``'s counterpart."""
    return torch.optim.Adam(params, lr=lr)


#: the parameters of a fit state, in the optimizer's order
FIT_PARAMS = ("betas", "pose", "trans")


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """The rows of a batch of ``n_batch`` bodies one rank holds: its block
    along ``dp_axis`` of ``mesh``."""
    mesh: object
    dp_axis: str
    n_batch: int

    @property
    def rows(self):
        n = comm.axis_size(self.mesh, self.dp_axis)
        if self.n_batch % n:
            raise ValueError("a batch of %d bodies does not split over %d "
                             "%r ranks" % (self.n_batch, n, self.dp_axis))
        per = self.n_batch // n
        i = comm.axis_index(self.mesh, self.dp_axis)
        return i * per, (i + 1) * per


@dataclasses.dataclass
class FitState:
    betas: torch.Tensor   # (B, n_betas), a leaf that requires grad
    pose: torch.Tensor    # (B, J, 3)
    trans: torch.Tensor   # (B, 3)
    opt_state: torch.optim.Optimizer  # over [betas, pose, trans]
    #: None: every body's rows; else the ``BatchShard`` this rank holds
    shard: BatchShard = None


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
    return _landmark_sq(as_tensor(verts, device), landm_idx, landm_bary,
                        target_xyz).mean()


def _landmark_sq(verts, landm_idx, landm_bary, target_xyz):
    """Squared distance per landmark, (..., L)."""
    idx = as_tensor(landm_idx, verts.device).long()
    bary = as_tensor(landm_bary, verts.device, verts.dtype)
    ring = verts[..., idx, :]                            # (..., L, K, 3)
    regressed = (ring * bary[..., None]).sum(dim=-2)
    target = as_tensor(target_xyz, verts.device, verts.dtype)
    return ((regressed - target) ** 2).sum(dim=-1)


def _vertex_sqdist(verts, target_points):
    """Squared scan-to-nearest-VERTEX distance per scan point: exact and
    differentiable, but above the surface distance wherever a scan point
    faces the inside of a triangle.  For MESH_TPU_VERTEX_CHAMFER=1."""
    d2 = ((target_points[..., :, None, :] - verts[..., None, :, :]) ** 2
          ).sum(dim=-1)
    return d2.amin(dim=-1)


def _surface_sqdist(verts, faces, target_points):
    """Squared distance from each scan point to its closest point on the
    posed surface, through ``diff.closest_point_batched``: the
    correspondence is exact at every evaluation, so this is gradient
    descent on the true surface distance (``diff/register.py`` is the
    k-step-frozen variant)."""
    from ..diff.queries import closest_point_batched

    lead = torch.broadcast_shapes(verts.shape[:-2], target_points.shape[:-2])
    verts_b = verts.expand(lead + verts.shape[-2:])
    pts_b = target_points.expand(lead + target_points.shape[-2:])
    res = closest_point_batched(verts_b, faces, pts_b, device=verts.device)
    return res["sqdist"]


def _data_sqdist(data_term, verts, faces, target_points):
    if data_term == "surface":
        return _surface_sqdist(verts, faces, target_points)
    return _vertex_sqdist(verts, target_points)


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
                       pose_prior_weight=POSE_PRIOR_WEIGHT,
                       beta_prior_weight=BETA_PRIOR_WEIGHT,
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
    data = _data_sqdist(_resolve_data_term(data_term), verts, model.faces,
                        target).mean()
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
    "surface" unless MESH_TPU_VERTEX_CHAMFER=1).

    With ``mesh`` (a ``DeviceMesh`` with axes ``dp_axis`` and ``sp_axis``)
    every rank calls the step with the same whole ``target_points`` [B, S,
    3] (or [1, S, 3], shared by the bodies); the bodies split over
    ``dp_axis`` and the scan points over ``sp_axis``, evenly, on the
    mesh's device (``device`` is not read).  A state that holds every
    body's rows (fresh from ``init_fit_state``, or restored from a
    checkpoint) is placed explicitly (``place_fit_state``); the step
    returns this rank's rows and the whole loss, the same on every rank.
    """
    _check_precision(precision)
    data_term = _resolve_data_term(data_term)
    if mesh is not None:
        return _sharded_step(model, optimizer, mesh, dp_axis, sp_axis,
                             landmarks, landmark_weight, data_term)
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


def _optimizer_like(opt, leaves, rows=None, n_batch=None):
    """A new optimizer of ``opt``'s class and options over ``leaves``, with
    ``opt``'s per-parameter state: each tensor shaped like its parameter
    cut to ``rows`` (a slice of the batch axis, or a callable that maps the
    tensor), the others (Adam's step) copied as they are."""
    new = type(opt)(leaves, **opt.defaults)
    sd = opt.state_dict()

    def cut(param, val):
        if not (torch.is_tensor(val) and val.ndim
                and val.shape == param.shape):
            return val.clone() if torch.is_tensor(val) else val
        return rows(val) if callable(rows) else val[rows]

    olds = opt.param_groups[0]["params"]
    sd["state"] = {k: {name: cut(olds[k], val) for name, val in st.items()}
                   for k, st in sd["state"].items()}
    new.load_state_dict(sd)
    return new


def place_fit_state(state, mesh, dp_axis="dp"):
    """``state`` as this rank of ``mesh`` holds it: the rows of its block
    along ``dp_axis``, parameters and the optimizer's per-parameter
    moments alike (scalars, Adam's step, as they are), on the mesh's
    device.  A state that arrives whole on one device, as a restored
    checkpoint does, must be placed before it meets sharded ones; one
    already placed on ``mesh`` is returned as it is."""
    if state.shard is not None:
        if state.shard.mesh == mesh and state.shard.dp_axis == dp_axis:
            return state
        raise ValueError("the fit state is sharded over another mesh or "
                         "axis")
    shard = BatchShard(mesh, dp_axis, state.betas.shape[0])
    rows = slice(*shard.rows)
    dev = comm.mesh_device(mesh)
    leaves = [getattr(state, name).detach()[rows].to(dev).clone()
              .requires_grad_(True) for name in FIT_PARAMS]
    opt = (None if state.opt_state is None
           else _optimizer_like(state.opt_state, leaves, rows))
    return FitState(*leaves, opt_state=opt, shard=shard)


def gather_fit_state(state):
    """Every body's rows of a sharded ``state`` on every rank (one
    all-gather a tensor along its ``dp`` axis); an unsharded state as it
    is.  Every rank of the mesh calls it together."""
    if state.shard is None:
        return state
    mesh, axis = state.shard.mesh, state.shard.dp_axis

    def whole(t):
        return torch.cat(comm.all_gather(t.detach(), mesh, axis))

    leaves = [whole(getattr(state, name)).requires_grad_(True)
              for name in FIT_PARAMS]
    opt = (None if state.opt_state is None
           else _optimizer_like(state.opt_state, leaves, whole))
    return FitState(*leaves, opt_state=opt)


def _ordered_sum(pieces):
    """The sum of ``pieces`` in list order: the same bits on every rank."""
    total = pieces[0]
    for piece in pieces[1:]:
        total = total + piece
    return total


def _sharded_step(model, optimizer, mesh, dp_axis, sp_axis, landmarks,
                  landmark_weight, data_term):
    """``make_fit_step``'s step over ``mesh`` (its docstring)."""
    dev = comm.mesh_device(mesh)
    n_sp, i_sp = comm.axis_size(mesh, sp_axis), comm.axis_index(mesh,
                                                                  sp_axis)

    def rows_of(t, state, n_lead):
        """``t``'s rows of this rank's bodies ([1, ...] stays shared)."""
        if t.shape[0] == 1:
            return t
        if t.shape[0] != n_lead:
            raise ValueError("want [%d or 1, ...] rows, got %r"
                             % (n_lead, tuple(t.shape)))
        return t[slice(*state.shard.rows)]

    def local_loss(state, target):
        """This rank's share of the global loss."""
        n_batch = state.shard.n_batch
        n_points = target.shape[1]
        if n_points % n_sp:
            raise ValueError("%d scan points do not split over %d %r ranks"
                             % (n_points, n_sp, sp_axis))
        per = n_points // n_sp
        mine = rows_of(target, state, n_batch)[:, i_sp * per:(i_sp + 1)
                                               * per]
        verts, _ = lbs(model, state.betas, state.pose, state.trans,
                       device=dev)
        lead = max(n_batch, target.shape[0])
        loss = _data_sqdist(data_term, verts, model.faces,
                            mine).sum() / (lead * n_points)
        if i_sp:
            return loss
        # body-only terms once per body: on the first sp rank
        loss = loss + (POSE_PRIOR_WEIGHT * (state.pose ** 2).sum()
                       / (n_batch * state.pose[0].numel())
                       + BETA_PRIOR_WEIGHT * (state.betas ** 2).sum()
                       / (n_batch * state.betas[0].numel()))
        if landmarks is not None:
            idx, bary, target_xyz = landmarks
            target_xyz = as_tensor(target_xyz, dev, verts.dtype)
            if target_xyz.ndim == 2:
                target_xyz = target_xyz[None]
            sq = _landmark_sq(verts, idx, bary,
                              rows_of(target_xyz, state, n_batch))
            lead_l = max(n_batch, target_xyz.shape[0])
            loss = loss + landmark_weight * sq.sum() / (
                lead_l * sq.shape[-1])
        return loss

    def step(state, target_points):
        state = place_fit_state(state, mesh, dp_axis)
        params = [state.betas, state.pose, state.trans]
        if state.opt_state is None:
            state.opt_state = optimizer(params)
        target = as_tensor(target_points, dev, state.betas.dtype)
        with no_tf32():
            state.opt_state.zero_grad()
            loss = local_loss(state, target)
            loss.backward()
            # a body's gradient summed over its sp group, the loss with it
            flat = torch.cat([p.grad.reshape(-1) for p in params]
                             + [loss.detach().reshape(1)])
            flat = _ordered_sum(comm.all_gather(flat, mesh, sp_axis))
            at = 0
            for p in params:
                p.grad.copy_(flat[at:at + p.numel()].view_as(p))
                at += p.numel()
            state.opt_state.step()
        total = _ordered_sum(comm.all_gather(flat[-1:], mesh, dp_axis))
        return state, total[0]

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
