"""Exact closest point with automatic strategy choice (counterpart of
mesh_tpu/query/culled.py).

The ladder, by face count F: the spatial index at
``F >= accel_crossover_faces()`` unless ``MESH_TPU_NO_ACCEL`` is set
(``accel/traverse.py``); else, on the kernel route
(``utils.dispatch.pallas_default``), the brute-force ``closest_faces``
kernel at ``F <= crossover_faces()`` and the sphere-culled kernel above.
Under ``MESH_TPU_MXU`` with the fast tile, the brute-force rung from
``mxu_crossover_faces()`` faces is the MXU rung instead
(``query/mxu_kernel.py``): its dense scan, or under ``MESH_TPU_MXU_BF16``
the bf16 bound pass and the f32 exact repair, whose screening outcomes
feed ``mesh_tpu_query_mxu_repair_total{kind="dense", outcome}``.  Every
rung is exact up to distance ties, and the ``MESH_TPU_SAFE_TILES`` tile
variant is threaded through all of them.

Under ``MESH_TPU_FORCE_XLA`` the reference's XLA rungs run instead, in
plain PyTorch: the plain scan (``xla_brute``) up to the crossover, and
above it the top-k cull (``closest_faces_and_points_culled``): a
conservative bound ``max(0, |q - centroid| - radius)`` for every pair,
the exact test on the k smallest, and a ``tight`` certificate where the
best exact distance is provably below every other face's bound; loose
queries re-run through the plain scan and are counted in
``mesh_tpu_query_certificate_fallback_total``.

``STRATEGY`` counts the rung each call took, once per call, and the
registry's ``mesh_tpu_query_strategy_total{path}`` counts it under the
reference's label (``LABELS``).
"""

import numpy as np
import torch

from ..obs.metrics import REGISTRY
from ..utils import knobs
from ..utils.device import as_tensor, host_array, resolve_device
from ..utils.dispatch import pallas_default
from .autotune import (
    accel_crossover_faces,
    crossover_faces,
    mxu_crossover_faces,
)
from .closest_kernel import closest_point_kernel, mesh_is_nondegenerate
from .culled_kernel import closest_point_culled_kernel
from .mxu_kernel import (
    closest_point_mxu_kernel,
    closest_point_mxu_repair_kernel,
)
from .point_triangle import closest_point_on_triangle

#: calls per route since the counts were last cleared
STRATEGY = {}

#: route -> the reference's ``mesh_tpu_query_strategy_total`` path label
LABELS = {"brute": "pallas_brute", "brute_safe": "pallas_safe",
          "culled": "pallas_culled", "culled_safe": "pallas_culled_safe",
          "mxu": "mxu", "xla_brute": "xla_brute", "xla_culled": "xla_culled",
          "accel_bvh": "accel_bvh", "accel_grid": "accel_grid"}


def record_strategy(path):
    STRATEGY[path] = STRATEGY.get(path, 0) + 1


def _record_strategy(path):
    """Count one auto-facade decision: in ``STRATEGY`` and in
    ``mesh_tpu_query_strategy_total{path}`` under the reference's label."""
    record_strategy(path)
    REGISTRY.counter(
        "mesh_tpu_query_strategy_total",
        "closest_faces_and_points_auto kernel-path decisions.",
    ).inc(path=LABELS[path])


def _record_fallback(queries):
    """Count loose-certificate queries re-run through the exact scan."""
    REGISTRY.counter(
        "mesh_tpu_query_certificate_fallback_total",
        "Loose-certificate queries re-run through exact brute force.",
    ).inc(int(queries))


def _record_mxu_repair(screened, repaired, kind):
    """Count the bf16 bound pass's outcomes per face tile: ``repaired``
    tiles ran the f32 exact repair, ``skipped`` tiles were certified empty
    (``mesh_tpu_query_mxu_repair_total{kind, outcome}``)."""
    counter = REGISTRY.counter(
        "mesh_tpu_query_mxu_repair_total",
        "bf16-screened MXU face tiles by repair outcome.")
    counter.inc(int(repaired), kind=kind, outcome="repaired")
    counter.inc(int(screened) - int(repaired), kind=kind, outcome="skipped")


def triangle_bounds(v, f):
    """Per-triangle centroid [F, 3] and bounding radius [F] (the largest
    distance from the centroid to a corner) of tensors ``v``, ``f``."""
    tri = v[f.long()]
    cen = tri.mean(dim=1)
    off = tri - cen[:, None, :]
    rad = (off * off).sum(dim=-1).amax(dim=1).sqrt()
    return cen, rad


def closest_faces_and_points_culled(v, f, points, k=64, chunk=256):
    """Top-k culled closest point on tensors on their own device (the
    reference's XLA form).

    ``v`` [V, 3], ``f`` [F, 3], ``points`` [Q, 3]; each chunk of queries
    holds a [chunk, F] bound matrix and runs the exact test on the ``k``
    faces of smallest bound (``torch.topk``, whose order among equal
    bounds is within the tie contract).  Returns a dict of ``face`` [Q]
    int32, ``part`` [Q] int32, ``point`` [Q, 3], ``sqdist`` [Q] and
    ``tight`` [Q] bool: True where the answer is provably the global
    optimum (its distance below the k-th bound less a scene-relative
    tolerance)."""
    points = points.to(v.dtype)
    center = v.mean(dim=0)
    v = v - center
    points = points - center
    tri = v[f.long()]
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    cen, rad = triangle_bounds(v, f)
    # the certificate stays conservative under rounding in d_cen and rad
    cert_tol = 1e-5 * v.abs().max()
    k = min(k, f.shape[0])
    out = {key: [] for key in ("face", "part", "point", "sqdist", "tight")}
    for q0 in range(0, max(points.shape[0], 1), chunk):
        pts = points[q0:q0 + chunk]
        diff = pts[:, None, :] - cen[None]
        d_cen = (diff * diff).sum(dim=-1).sqrt()
        lb = torch.clamp(d_cen - rad[None], min=0.0)
        kth, idx = torch.topk(lb, k, dim=-1, largest=False, sorted=True)
        pt, sq, part = closest_point_on_triangle(pts[:, None, :], a[idx],
                                                 b[idx], c[idx])
        j = torch.argmin(sq, dim=-1)[:, None]
        best_sq = sq.gather(1, j)[:, 0]
        out["face"].append(idx.gather(1, j)[:, 0].to(torch.int32))
        out["part"].append(part.gather(1, j)[:, 0])
        out["point"].append(pt.gather(1, j[..., None].expand(-1, 1, 3))[:, 0])
        out["sqdist"].append(best_sq)
        out["tight"].append(best_sq.sqrt() <= kth[:, -1] - cert_tol)
    res = {key: torch.cat(val) for key, val in out.items()}
    res["point"] = res["point"] + center
    return res


def _xla_rungs(v, f, points, brute_force_max_faces, k, chunk, device):
    """The reference's XLA rungs in plain PyTorch on ``device``: the plain
    scan up to ``brute_force_max_faces``, else the top-k cull with its
    loose queries re-run through the plain scan."""
    from .closest_point import closest_faces_and_points_t, replace_rows

    dev = resolve_device(device)
    vt = as_tensor(v, dev, torch.float32)
    ft = as_tensor(f if torch.is_tensor(f) else host_array(f, np.int64), dev)
    pts = as_tensor(points, dev, torch.float32).reshape(-1, 3)
    if f.shape[0] <= brute_force_max_faces:
        _record_strategy("xla_brute")
        res = closest_faces_and_points_t(vt, ft, pts)
        return {key: val.cpu().numpy() for key, val in res.items()}
    # recorded before the certificate check: a re-run below is part of this
    # call, counted only in the fallback series
    _record_strategy("xla_culled")
    res = closest_faces_and_points_culled(vt, ft, pts, k=k, chunk=chunk)
    out = {key: val.cpu().numpy() for key, val in res.items()}
    tight = out.pop("tight")
    loose = np.nonzero(~tight)[0]
    if loose.size:
        _record_fallback(loose.size)
        fix = closest_faces_and_points_t(
            vt, ft, pts[torch.as_tensor(loose, device=dev)])
        replace_rows(out, loose, fix)
    return out


def closest_faces_and_points_auto(v, f, points, brute_force_max_faces=None,
                                  k=64, chunk=256, *, device="cuda"):
    """Exact closest face, part, point and squared distance per query.

    ``v`` [V, 3], ``f`` [F, 3] and ``points`` [Q, 3] may be numpy arrays
    or tensors (a facade's cached device copies are used as they are);
    returns a dict of numpy arrays: ``face`` [Q] int32, ``part`` [Q]
    int32, ``point`` [Q, 3] and ``sqdist`` [Q] float32.
    ``brute_force_max_faces`` pins the brute/culled switch (default
    ``crossover_faces()``); ``k`` and ``chunk`` are the top-k cull's
    candidates and query chunk (``MESH_TPU_FORCE_XLA`` only).

    The nondegeneracy flag of the brute and culled rungs is asserted from
    the host copy of the mesh (``mesh_is_nondegenerate``); the BVH rung
    skips that check, as the reference does."""
    n_faces = f.shape[0]
    if brute_force_max_faces is None:
        brute_force_max_faces = crossover_faces()
    if not knobs.no_accel() and n_faces >= accel_crossover_faces():
        from ..accel.traverse import closest_faces_and_points_accel

        kind = knobs.accel_kind()
        _record_strategy("accel_%s" % kind)
        return closest_faces_and_points_accel(v, f, points, kind=kind,
                                              device=device)
    if not pallas_default(device):
        return _xla_rungs(v, f, points, brute_force_max_faces, k, chunk,
                          device)
    f_host = host_array(f, np.int64)
    nondegen = mesh_is_nondegenerate(host_array(v, np.float32), f_host)
    variant = knobs.tile_variant()
    if (knobs.mxu_enabled() and variant == "fast"
            and mxu_crossover_faces() <= n_faces <= brute_force_max_faces):
        _record_strategy("mxu")
        if knobs.mxu_bf16_enabled():
            res, stats = closest_point_mxu_repair_kernel(
                v, f, points, assume_nondegenerate=nondegen, with_stats=True,
                device=device)
            _record_mxu_repair(stats["screened"], stats["repaired"], "dense")
        else:
            res = closest_point_mxu_kernel(
                v, f, points, assume_nondegenerate=nondegen, device=device)
        return {key: val.cpu().numpy() for key, val in res.items()}
    suffix = "_safe" if variant == "safe" else ""
    if n_faces <= brute_force_max_faces:
        _record_strategy("brute" + suffix)
        query = closest_point_kernel
    else:
        _record_strategy("culled" + suffix)
        query = closest_point_culled_kernel
    res = query(
        as_tensor(v, device, torch.float32),
        as_tensor(f if torch.is_tensor(f) else f_host, device),
        as_tensor(points, device, torch.float32).reshape(-1, 3),
        assume_nondegenerate=nondegen, tile_variant=variant)
    return {key: val.cpu().numpy() for key, val in res.items()}
