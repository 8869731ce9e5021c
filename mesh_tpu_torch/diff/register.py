"""ICP-style registration loop (counterpart of mesh_tpu/diff/register.py):
periodic correspondence bursts, a torch optimizer in between, the
reference's spans and metrics.

    every ``recorrespond_every`` steps
        the scan is re-corresponded against the CURRENT surface by one
        closest-point search (``_correspond``);
    in between
        the optimizer minimizes the energy at FROZEN correspondence (face,
        bary [, normal]): a majorization of the true surface distance that
        touches it at the current iterate.

``diff.queries`` inside a loss refreshes the correspondence at every
evaluation (``parallel/fit.py`` does that); this loop refreshes it every
k steps, the textbook ICP trade for scans where the search dominates.

Instrumentation (the reference's names): spans ``diff.recorrespond`` and
``diff.energy`` (gated by MESH_TPU_OBS), always-on metrics
``mesh_tpu_diff_recorrespond_total``, ``mesh_tpu_diff_inner_steps_total``
and the per-step RMS residual histogram ``mesh_tpu_diff_residual_meters``.
"""

import dataclasses

import torch

from ..geometry.tri_normals import normalize_rows, tri_normals_scaled_t
from ..obs import counter as obs_counter
from ..obs import histogram as obs_histogram
from ..obs.trace import span as obs_span
from ..query.point_triangle import closest_point_barycentric
from ..utils.device import as_tensor, resolve_device
from ..utils.knobs import tile_variant
from .energies import _robustify, landmark_term

__all__ = ["RegisterResult", "icp_register", "register_vertices"]

#: residual histogram buckets: geometric, in scene units (meters for the
#: SMPL-family workloads), from raw-scan noise (~1e-4) to gross
#: misalignment (~1)
RESIDUAL_BUCKETS = (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1, 1.0)


@dataclasses.dataclass
class RegisterResult:
    params: object          # optimized parameters (tensor or dict of them)
    verts: torch.Tensor     # final surface vertices [V, 3]
    losses: list            # frozen-correspondence loss per inner step
    residual_rms: float     # RMS scan->surface residual at the end
    recorrespondences: int  # correspondence bursts issued


def _correspond(v, f, scan, chunk):
    """One engine-routed correspondence burst -> winning face [S] int32.

    Goes through the batched facade's route (``batch._run_batch_step``:
    strategy pick, data-derived nondegeneracy, tile variant, the bucket's
    plan), so ICP bursts share the plans of any other engine traffic."""
    from ..batch import _batch_nondegen, _run_batch_step, _strategy

    v32 = v.detach().float()
    use_pallas, use_culled = _strategy(f, v32.device)
    _, res = _run_batch_step(
        v32[None], f, scan[None], use_pallas, use_culled, chunk, False,
        nondegen=_batch_nondegen(v32.cpu().numpy(), f.cpu().numpy()),
        variant=tile_variant(), op="closest_point")
    return res["face"][0]


def _leaves(params, dev):
    """Fresh leaf tensors on ``dev`` that require grad: a tensor, or a dict
    of tensors."""
    def leaf(x):
        return as_tensor(x, dev).detach().clone().requires_grad_(True)

    if isinstance(params, dict):
        return {key: leaf(val) for key, val in params.items()}
    return leaf(params)


def _detached(params):
    if isinstance(params, dict):
        return {key: val.detach() for key, val in params.items()}
    return params.detach()


def icp_register(verts_fn, params, f, scan, *, steps=30,
                 recorrespond_every=5, optimizer=None,
                 energy="point_to_point", robust=None, landmarks=None,
                 landmark_weight=1.0, chunk=512, device="cuda"):
    """Register a parametric surface ``verts_fn(params) -> [V, 3]`` to a
    scan point cloud ``scan`` [S, 3].

    :param verts_fn: differentiable map from the parameters to vertices
        (the identity for free vertices, ``register_vertices``; an LBS
        closure for model fitting).
    :param params: a tensor or a dict of tensors; copied as leaves.
    :param f: [F, 3] int faces.
    :param steps: total inner optimizer steps.
    :param recorrespond_every: correspondence refresh period k.
    :param optimizer: ``params list -> torch.optim.Optimizer``; default
        ``torch.optim.Adam(lr=1e-2)`` (the reference's ``optax.adam(1e-2)``).
    :param energy: ``"point_to_point"`` or ``"point_to_plane"`` (the
        winning face's normal frozen at correspondence time).
    :param robust: None, a callable on squared residuals, or a
        ``("huber"|"geman_mcclure", scale)`` pair.
    :param landmarks: optional ``(idx, bary, target_xyz)`` triple from
        ``parallel.fit.landmark_arrays``.
    :param chunk: the reference's scan chunk; part of the engine's plan
        key (the kernels take none).
    :returns: :class:`RegisterResult`.
    """
    if energy not in ("point_to_point", "point_to_plane"):
        raise ValueError(
            "icp_register energy must be point_to_point or "
            "point_to_plane, got %r" % (energy,))
    dev = resolve_device(device)
    f = as_tensor(f, dev, torch.int64)
    scan = as_tensor(scan, dev, torch.float32)
    params = _leaves(params, dev)
    leaves = list(params.values()) if isinstance(params, dict) else [params]
    opt = (optimizer or (lambda p: torch.optim.Adam(p, lr=1e-2)))(leaves)

    recorrespond_total = obs_counter(
        "mesh_tpu_diff_recorrespond_total",
        "ICP correspondence bursts issued.")
    inner_total = obs_counter(
        "mesh_tpu_diff_inner_steps_total",
        "Frozen-correspondence optimizer steps taken.")
    residual_hist = obs_histogram(
        "mesh_tpu_diff_residual_meters",
        "Per-iteration RMS scan->surface residual.",
        buckets=RESIDUAL_BUCKETS)

    def loss_fn(corners, bary, normals):
        verts = verts_fn(params)
        cp = (bary[..., :, None] * verts[corners]).sum(dim=-2)
        diff = scan.to(cp.dtype) - cp
        if energy == "point_to_plane":
            r = (diff * normals).sum(dim=-1)
            sq = r * r
        else:
            sq = (diff * diff).sum(dim=-1)
        total = _robustify(sq, robust).mean()
        if landmarks is not None:
            total = total + landmark_term(verts, landmarks, landmark_weight,
                                          device=dev)
        return total, (diff * diff).sum(dim=-1).mean()

    losses = []
    corners = bary = normals = None
    mean_sq = None
    recorrespondences = 0
    for step in range(steps):
        if step % max(1, recorrespond_every) == 0:
            with torch.no_grad():
                verts = verts_fn(params)
                with obs_span("diff.recorrespond", step=step,
                              q=scan.shape[0]):
                    face = _correspond(verts, f, scan, chunk)
                corners = f[face.long()]
                tri = verts[corners]
                bary, _ = closest_point_barycentric(
                    scan.to(verts.dtype), tri[..., 0, :], tri[..., 1, :],
                    tri[..., 2, :])
                normals = normalize_rows(
                    tri_normals_scaled_t(verts, f))[face.long()]
            recorrespond_total.inc()
            recorrespondences += 1
        with obs_span("diff.energy", step=step):
            opt.zero_grad()
            loss, mean_sq = loss_fn(corners, bary, normals)
            loss.backward()
            opt.step()
        inner_total.inc()
        losses.append(float(loss))
        residual_hist.observe(float(mean_sq.sqrt()))

    params = _detached(params)
    with torch.no_grad():
        verts = verts_fn(params)
    return RegisterResult(
        params=params,
        verts=verts,
        losses=losses,
        residual_rms=float(mean_sq.sqrt()) if mean_sq is not None else 0.0,
        recorrespondences=recorrespondences,
    )


def register_vertices(v, f, scan, *, device="cuda", **kwargs):
    """Free-vertex ICP: optimize the vertex positions themselves (the
    non-parametric limit, and the smallest end-to-end run of the loop)."""
    v0 = as_tensor(v, device, torch.float32)
    return icp_register(lambda p: p, v0, f, scan, device=device, **kwargs)
