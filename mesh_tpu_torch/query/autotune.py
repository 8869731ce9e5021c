"""Routing thresholds of the closest-point ladder (counterpart of
mesh_tpu/query/autotune.py; of its calibrations only the MXU rung's).

The constants are routing thresholds in face counts and tile shapes, not
times, and keep the reference's values: brute force up to
``DEFAULT_CROSSOVER`` faces, the sphere-culled kernel above it, the BVH
rope kernels from ``ACCEL_DEFAULT_CROSSOVER`` faces, and under
``MESH_TPU_MXU`` the MXU rung from ``MXU_DEFAULT_CROSSOVER`` faces up to the
brute-force ceiling.  Each accessor takes its environment override when one
parses, else the default.  The MXU crossover alone also reads a measurement:
``calibrate_mxu_crossover`` times the MXU rung against the brute-force
kernel on the card and saves the crossover under ``CACHE_DIR``, in a file
named after the card; measuring the other crossovers is still to be
ported.
"""

import json
import logging
import os
import re
import time

import numpy as np
import torch

from ..utils import knobs
from ..utils.device import resolve_device

log = logging.getLogger(__name__)

DEFAULT_CROSSOVER = 32768

ACCEL_DEFAULT_CROSSOVER = 131072

#: face count from which MESH_TPU_MXU routes the brute-force rung to the
#: MXU rung (the reference's conservative default)
MXU_DEFAULT_CROSSOVER = 8192

#: where calibrations are saved: beside the kernel builds, which
#: .gitignore lists
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "mesh_tpu_torch", "autotune")

#: the MXU crossover of this process once read from the cache or measured
_mxu_measured = None

#: the record of the last ``calibrate_mxu_crossover`` run (what it saves)
MXU_CALIBRATION = {}

#: (tile_q, tile_f, n_buffers) of the streamed rope kernel
STREAM_DEFAULT_TILES = (128, 256, 2)


def _override(name, default):
    if knobs.raw(name):
        value = knobs.get_int(name)
        if value is not None:
            return value
        log.warning("ignoring malformed %s=%r (want an integer face count)",
                    name, knobs.raw(name))
    return default


def crossover_faces():
    """The face count up to which auto uses brute force
    (``MESH_TPU_BRUTE_MAX_FACES``, else ``DEFAULT_CROSSOVER``); above it
    the culled kernel runs."""
    return _override("MESH_TPU_BRUTE_MAX_FACES", DEFAULT_CROSSOVER)


def accel_crossover_faces():
    """The face count from which auto takes the BVH rope kernels
    (``MESH_TPU_ACCEL_MIN_FACES``, else ``ACCEL_DEFAULT_CROSSOVER``)."""
    return _override("MESH_TPU_ACCEL_MIN_FACES", ACCEL_DEFAULT_CROSSOVER)


def _mxu_cache_path(device="cuda"):
    """The MXU calibration's file for ``device``: named after the card, so
    a measurement never serves another card or the CPU."""
    dev = torch.device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    return os.path.join(CACHE_DIR, "mxu_crossover_%s_%s.json" % (
        dev.type, re.sub(r"[^A-Za-z0-9._-]+", "_", kind)))


def mxu_crossover_faces():
    """The face count from which ``MESH_TPU_MXU`` routes the brute-force
    rung to the MXU rung: ``MESH_TPU_MXU_CROSSOVER_FACES`` when it parses,
    else this card's saved ``calibrate_mxu_crossover`` measurement (read
    once a process), else ``MXU_DEFAULT_CROSSOVER``."""
    value = _override("MESH_TPU_MXU_CROSSOVER_FACES", None)
    if value is not None:
        return value
    global _mxu_measured
    if _mxu_measured is None:
        _mxu_measured = MXU_DEFAULT_CROSSOVER
        if torch.cuda.is_available():
            try:
                with open(_mxu_cache_path()) as fh:
                    value = int(json.load(fh)["mxu_crossover_faces"])
                if value > 0:
                    _mxu_measured = value
            except (OSError, ValueError, KeyError, TypeError):
                pass
    return _mxu_measured


def _time_calls(fn, reps, device):
    """Mean seconds per call of ``fn`` over ``reps`` calls after one
    warm-up, synchronizing the card before and after the timed calls."""
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return (time.perf_counter() - t0) / reps


def calibrate_mxu_crossover(ladder=(2048, 8192, 32768, 131072),
                            n_queries=1024, reps=3, tile_q=256, tile_f=2048,
                            save=True, device="cuda"):
    """Measure where the MXU rung (``closest_point_mxu_kernel``) starts
    beating the brute-force kernel (``closest_point_kernel``, the fast tile)
    on ``device``, over ``_sphere_mesh`` meshes of the ``ladder``'s face
    counts and ``n_queries`` N(0, 1) queries: the smallest measured face
    count from which the MXU rung wins at every larger count, or twice the
    ladder's last when the brute-force kernel always won.  The result
    serves this process; with ``save`` it is also written to the card's
    file under ``CACHE_DIR``, unless a re-timed ladder point disagrees with
    itself by more than 2x (unstable timings).  ``MXU_CALIBRATION`` keeps
    the run's record."""
    from .closest_kernel import closest_point_kernel
    from .mxu_kernel import closest_point_mxu_kernel

    dev = resolve_device(device)
    rng = np.random.RandomState(0)
    pts = torch.as_tensor(rng.randn(n_queries, 3).astype(np.float32),
                          device=dev)

    def brute(vt, ft):
        return _time_calls(lambda: closest_point_kernel(
            vt, ft, pts, assume_nondegenerate=True), reps, dev)

    wins = []
    for n_f in ladder:
        v, f = _sphere_mesh(n_f)
        vt, ft = torch.as_tensor(v, device=dev), torch.as_tensor(f, device=dev)
        t_mxu = _time_calls(lambda: closest_point_mxu_kernel(
            vt, ft, pts, assume_nondegenerate=True, tile_q=tile_q,
            tile_f=tile_f, device=dev), reps, dev)
        wins.append((int(f.shape[0]), brute(vt, ft), t_mxu, vt, ft))
    check_f, check_t, _, vt, ft = wins[len(wins) // 2]
    recheck = brute(vt, ft)
    stable = max(check_t, recheck) <= 2.0 * min(check_t, recheck)
    crossover = 2 * wins[-1][0]
    for i, (n_f, _, _, _, _) in enumerate(wins):
        if all(tm < tb for _, tb, tm, _, _ in wins[i:]):
            crossover = n_f
            break
    global _mxu_measured
    _mxu_measured = crossover
    MXU_CALIBRATION.clear()
    MXU_CALIBRATION.update({
        "mxu_crossover_faces": crossover, "device": str(dev),
        "card": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "tile_q": tile_q, "tile_f": tile_f, "n_queries": n_queries,
        "reps": reps, "stable": stable,
        "ladder": [{"faces": n, "t_brute": tb, "t_mxu": tm}
                   for n, tb, tm, _, _ in wins],
        "measured_at": time.strftime("%Y-%m-%dT%H:%M:%S")})
    if not stable:
        log.warning("calibrate_mxu_crossover: timings unstable (%.6fs vs "
                    "%.6fs at F=%d); not saving %d", check_t, recheck,
                    check_f, crossover)
    elif save:
        os.makedirs(CACHE_DIR, exist_ok=True)
        with open(_mxu_cache_path(dev), "w") as fh:
            json.dump(MXU_CALIBRATION, fh, indent=1)
    return crossover


def stream_tile_params():
    """``(tile_q, tile_f, n_buffers)`` for the streamed rope kernel, with
    ``MESH_TPU_BVH_STREAM_BUFFERS`` applied to the ring depth."""
    tile_q, tile_f, n_buffers = STREAM_DEFAULT_TILES
    return tile_q, tile_f, knobs.bvh_stream_buffers(default=n_buffers)


def _sphere_mesh(n_faces, seed=0):
    """Synthetic parametric sphere with ~n_faces triangles, float32 and
    int32, with the reference's vertex and face order."""
    n_ring = max(3, int(np.sqrt(n_faces / 2)))
    n_seg = max(3, n_faces // (2 * n_ring))
    theta = np.pi * np.arange(1, n_ring + 1) / (n_ring + 1)
    phi = 2 * np.pi * np.arange(n_seg) / n_seg
    v = np.stack([
        np.outer(np.sin(theta), np.cos(phi)),
        np.outer(np.sin(theta), np.sin(phi)),
        np.outer(np.cos(theta), np.ones(n_seg)),
    ], axis=-1).reshape(-1, 3)
    r = np.arange(n_ring - 1)[:, None]
    s = np.arange(n_seg)[None, :]
    s1 = (s + 1) % n_seg
    b0s, b1s, b1s1, b0s1 = (
        r * n_seg + s, (r + 1) * n_seg + s,
        (r + 1) * n_seg + s1, r * n_seg + s1,
    )
    faces = np.stack(
        [np.stack([b0s, b1s, b1s1], axis=-1),
         np.stack([b0s, b1s1, b0s1], axis=-1)],
        axis=2,
    ).reshape(-1, 3)
    return v.astype(np.float32), faces.astype(np.int32)
