"""The accel rung of the auto ladder: which rope walk serves a mesh, and
``closest_faces_and_points_accel`` (counterpart of the BVH half of
mesh_tpu/accel/traverse.py, on the kernel route the reference takes on
its chip).

``pallas_bvh_variant`` keeps the reference's name and routing: the
resident walk when the fast tile's face planes (19 float32 rows over the
padded face count) fit the ``MESH_TPU_BVH_STREAM_VMEM_MB`` budget, the
streamed walk above it or under ``MESH_TPU_BVH_STREAM_FORCE``, and with
``MESH_TPU_BVH_STREAM=0`` the resident walk up to ``PALLAS_BVH_MAX_FACES``
and nothing (``None``) above.  Both walks are exact and bit-identical to
each other, so the budget only decides how leaves reach the kernel.
Under ``MESH_TPU_MXU`` from ``mxu_crossover_faces()`` faces on, the chosen
walk visits its leaves with the MXU tile (``rope_mxu_faces``), behind the
bf16 screen under ``MESH_TPU_MXU_BF16``, whose outcomes feed
``mesh_tpu_query_mxu_repair_total{kind="bvh"|"stream"}``, as in the
reference (mesh_tpu/accel/traverse.py:383-470).

As in the reference, a traversal runs inside an ``accel.traverse`` span,
counts its pair tests in ``mesh_tpu_accel_pair_tests_total{kind}`` and,
given a ledger record, stamps its ``device`` stage and ``backend``.
"""

import numpy as np
import torch

from ..obs.metrics import REGISTRY
from ..obs.trace import span as obs_span
from ..utils import knobs
from ..utils.device import as_tensor, host_array, resolve_device
from ..query.autotune import mxu_crossover_faces, stream_tile_params
from ..query.closest_kernel import N_FACE_ROWS, closest_point_kernel
from .rope_kernel import (
    closest_point_bvh_kernel,
    closest_point_bvh_mxu_kernel,
    closest_point_bvh_stream_kernel,
    closest_point_bvh_stream_mxu_kernel,
)

__all__ = [
    "closest_faces_and_points_accel", "PALLAS_BVH_MAX_FACES",
    "pallas_bvh_max_faces", "pallas_bvh_variant", "resident_rows_bytes",
]

#: the resident walk's face ceiling when the streamed walk is switched off
PALLAS_BVH_MAX_FACES = 65536

#: tile_f of the resident walk (the reference's default)
RESIDENT_TILE_F = 256


def _rope_fp(n_faces, tile_f):
    """Padded face count of the coarse rope index: ``tile_f`` times the
    next power-of-two leaf count (build_bvh's complete-tree padding)."""
    n_leaves = max(1, -(-int(n_faces) // int(tile_f)))
    depth = int(np.ceil(np.log2(n_leaves))) if n_leaves > 1 else 0
    return (1 << depth) * int(tile_f)


def resident_rows_bytes(n_faces, tile_f=RESIDENT_TILE_F):
    """Bytes of the resident walk's face planes for ``n_faces``: 19
    float32 rows over the padded face count."""
    return N_FACE_ROWS * _rope_fp(n_faces, tile_f) * 4


def pallas_bvh_variant(n_faces, tile_f=RESIDENT_TILE_F):
    """``"resident"``, ``"stream"`` or ``None`` for ``n_faces`` under the
    current knobs (module docstring)."""
    if not knobs.bvh_stream_enabled():
        return "resident" if n_faces <= PALLAS_BVH_MAX_FACES else None
    if knobs.bvh_stream_force():
        return "stream"
    if resident_rows_bytes(n_faces, tile_f) <= knobs.bvh_stream_vmem_budget():
        return "resident"
    return "stream"


def pallas_bvh_max_faces(tile_f=RESIDENT_TILE_F):
    """Largest face count the resident walk serves under the current
    budget: a power of two times ``tile_f``, or 0."""
    n_leaves = knobs.bvh_stream_vmem_budget() // (N_FACE_ROWS * 4
                                                  * int(tile_f))
    if n_leaves < 1:
        return 0
    pow2 = 1
    while pow2 * 2 <= n_leaves:
        pow2 *= 2
    return pow2 * int(tile_f)


def check_kind(kind):
    """``kind`` when the port has that index, else NotImplementedError."""
    if kind != "bvh":
        raise NotImplementedError(
            "MESH_TPU_ACCEL_KIND=%s: the uniform grid index and its "
            "traversal (build_grid, grid_closest_point) are not ported "
            "(ROADMAP.md, Queue 1); unset the knob or set MESH_TPU_NO_ACCEL=1"
            % kind)
    return kind


def _record_pair_tests(n, kind):
    """Count the exact point-triangle pair tests the accel path ran."""
    REGISTRY.counter(
        "mesh_tpu_accel_pair_tests_total",
        "exact pair tests run by the accel traversal (label: kind)",
    ).inc(int(n), kind=kind)


def closest_faces_and_points_accel(v, f, points, kind=None, index=None,
                                   with_stats=False, record=None,
                                   device="cuda"):
    """Index-accelerated exact closest point, the accel rung of
    ``closest_faces_and_points_auto``: numpy in and out (``face``,
    ``part``, ``point``, ``sqdist``), exact up to distance ties.

    The resident or the streamed rope walk serves the mesh, as
    ``pallas_bvh_variant`` says, over the coarse BVH at its ``tile_f``
    from the digest cache (or ``index``, rebuilt at that leaf size if it
    differs).  Queries whose certificate is loose (none, with these
    conservative bounds) are re-run through the brute-force kernel.

    :param kind: ``"bvh"``; default ``MESH_TPU_ACCEL_KIND``, whose
        ``grid`` raises NotImplementedError.
    :param with_stats: also return ``{"pair_tests", "fallback",
        "tight_frac", "kind", "backend"}`` with ``backend``
        ``"rope_resident"`` or ``"rope_stream"``, or their MXU leaf-visit
        forms ``"rope_resident_mxu"`` / ``"rope_stream_mxu"``.
    :param record: optional ``obs.ledger.RequestRecord``; the traversal
        stamps its ``device`` stage and sets its ``backend``.
    """
    if kind is None:
        kind = index.kind if index is not None else knobs.accel_kind()
    check_kind(kind)
    dev = resolve_device(device)
    n_faces = int(f.shape[0])
    variant = pallas_bvh_variant(n_faces)
    if variant is None:
        raise NotImplementedError(
            "MESH_TPU_BVH_STREAM=0 with %d faces (above %d): the reference "
            "takes its XLA rope traversal here (bvh_closest_point), which is "
            "not ported (ROADMAP.md, Queue 1)"
            % (n_faces, PALLAS_BVH_MAX_FACES))
    use_mxu = knobs.mxu_enabled() and n_faces >= mxu_crossover_faces()
    use_bf16 = use_mxu and knobs.mxu_bf16_enabled()
    v_t = as_tensor(v, dev)
    f_t = as_tensor(f if torch.is_tensor(f) else host_array(f, np.int64), dev)
    pts = as_tensor(points, dev).reshape(-1, 3)
    with obs_span("accel.traverse", kind=kind, faces=n_faces,
                  queries=int(pts.shape[0])) as sp:
        if variant == "resident" and use_mxu:
            backend = "rope_resident_mxu"
            res, mxu_stats = closest_point_bvh_mxu_kernel(
                v_t, f_t, pts, tile_f=RESIDENT_TILE_F, index=index,
                rebuild_mismatched=True, use_bf16=use_bf16, with_stats=True,
                device=dev)
        elif variant == "resident":
            backend = "rope_resident"
            res = closest_point_bvh_kernel(
                v_t, f_t, pts, tile_f=RESIDENT_TILE_F, index=index,
                rebuild_mismatched=True, device=dev)
        else:
            backend = "rope_stream_mxu" if use_mxu else "rope_stream"
            tile_q, tile_f, n_buffers = stream_tile_params()
            if use_mxu:
                res, mxu_stats = closest_point_bvh_stream_mxu_kernel(
                    v_t, f_t, pts, tile_q=tile_q, tile_f=tile_f,
                    n_buffers=n_buffers, index=index,
                    rebuild_mismatched=True, use_bf16=use_bf16,
                    with_stats=True, device=dev)
            else:
                res = closest_point_bvh_stream_kernel(
                    v_t, f_t, pts, tile_q=tile_q, tile_f=tile_f,
                    n_buffers=n_buffers, index=index,
                    rebuild_mismatched=True, device=dev)
        out = {key: val.cpu().numpy() for key, val in res.items()}
        tight = out.pop("tight")
        pairs = int(out.pop("pair_tests").astype(np.int64).sum())
        loose = np.nonzero(~tight)[0]
        sp.set(backend=backend, pair_tests=pairs, fallback=int(loose.size))
    if record is not None:
        record.stamp("device")
        record.set(backend=backend)
    _record_pair_tests(pairs, kind)
    if use_bf16:
        from ..query.culled import _record_mxu_repair

        _record_mxu_repair(mxu_stats["screened"], mxu_stats["repaired"],
                           "stream" if variant == "stream" else "bvh")
    if loose.size:
        fix = closest_point_kernel(
            v_t.float(), f_t, pts.float()[torch.as_tensor(loose, device=dev)])
        for key in ("face", "part", "point", "sqdist"):
            out[key] = out[key].copy()
            out[key][loose] = fix[key].cpu().numpy()
    if with_stats:
        return out, {
            "pair_tests": pairs,
            "fallback": int(loose.size),
            "tight_frac": float(tight.mean()) if tight.size else 1.0,
            "kind": kind,
            "backend": backend,
        }
    return out
