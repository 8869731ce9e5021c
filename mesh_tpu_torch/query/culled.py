"""Exact closest point with automatic strategy choice (counterpart of
``closest_faces_and_points_auto`` in mesh_tpu/query/culled.py, on the
kernel route the reference takes on its chip).

The ladder, by face count F: the BVH rope kernels at
``F >= accel_crossover_faces()`` unless ``MESH_TPU_NO_ACCEL`` is set
(``accel/traverse.py``); else the brute-force ``closest_faces`` kernel at
``F <= crossover_faces()``; else the sphere-culled kernel.  Under
``MESH_TPU_MXU`` with the fast tile, the brute-force rung from
``mxu_crossover_faces()`` faces is the MXU rung instead
(``query/mxu_kernel.py``): its dense scan, or under ``MESH_TPU_MXU_BF16``
the bf16 bound pass and the f32 exact repair, whose screening outcomes
feed ``mesh_tpu_query_mxu_repair_total{kind="dense", outcome}``.  Every
rung is exact up to distance ties, and the ``MESH_TPU_SAFE_TILES`` tile
variant is threaded through all of them.  ``STRATEGY`` counts the rung
each call took, once per call.
"""

import numpy as np
import torch

from ..obs.metrics import REGISTRY
from ..utils import knobs
from ..utils.device import as_tensor, host_array
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

#: calls per route since the counts were last cleared
STRATEGY = {}


def record_strategy(path):
    STRATEGY[path] = STRATEGY.get(path, 0) + 1


def _record_mxu_repair(screened, repaired, kind):
    """Count the bf16 bound pass's outcomes per face tile: ``repaired``
    tiles ran the f32 exact repair, ``skipped`` tiles were certified empty
    (``mesh_tpu_query_mxu_repair_total{kind, outcome}``)."""
    counter = REGISTRY.counter(
        "mesh_tpu_query_mxu_repair_total",
        "bf16-screened MXU face tiles by repair outcome.")
    counter.inc(int(repaired), kind=kind, outcome="repaired")
    counter.inc(int(screened) - int(repaired), kind=kind, outcome="skipped")


def closest_faces_and_points_auto(v, f, points, brute_force_max_faces=None,
                                  device="cuda"):
    """Exact closest face, part, point and squared distance per query.

    ``v`` [V, 3], ``f`` [F, 3] and ``points`` [Q, 3] may be numpy arrays
    or tensors (a facade's cached device copies are used as they are);
    returns a dict of numpy arrays: ``face`` [Q] int32, ``part`` [Q]
    int32, ``point`` [Q, 3] and ``sqdist`` [Q] float32.
    ``brute_force_max_faces`` pins the brute/culled switch (default
    ``crossover_faces()``).

    The nondegeneracy flag of the brute and culled rungs is asserted from
    the host copy of the mesh (``mesh_is_nondegenerate``); the BVH rung
    skips that check, as the reference does."""
    n_faces = f.shape[0]
    if brute_force_max_faces is None:
        brute_force_max_faces = crossover_faces()
    if not knobs.no_accel() and n_faces >= accel_crossover_faces():
        from ..accel.traverse import check_kind, closest_faces_and_points_accel

        kind = check_kind(knobs.accel_kind())
        record_strategy("accel_%s" % kind)
        return closest_faces_and_points_accel(v, f, points, kind=kind,
                                              device=device)
    f_host = host_array(f, np.int64)
    nondegen = mesh_is_nondegenerate(host_array(v, np.float32), f_host)
    variant = knobs.tile_variant()
    if (knobs.mxu_enabled() and variant == "fast"
            and mxu_crossover_faces() <= n_faces <= brute_force_max_faces):
        record_strategy("mxu")
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
        record_strategy("brute" + suffix)
        query = closest_point_kernel
    else:
        record_strategy("culled" + suffix)
        query = closest_point_culled_kernel
    res = query(
        as_tensor(v, device, torch.float32),
        as_tensor(f if torch.is_tensor(f) else f_host, device),
        as_tensor(points, device, torch.float32).reshape(-1, 3),
        assume_nondegenerate=nondegen, tile_variant=variant)
    return {key: val.cpu().numpy() for key, val in res.items()}
