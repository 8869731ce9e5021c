"""Routing thresholds of the closest-point ladder (counterpart of
mesh_tpu/query/autotune.py without its calibration).

The three constants are routing thresholds in face counts and tile shapes,
not times, and keep the reference's values: brute force up to
``DEFAULT_CROSSOVER`` faces, the sphere-culled kernel above it, and the BVH
rope kernels from ``ACCEL_DEFAULT_CROSSOVER`` faces.  Each accessor takes
its environment override when one parses, else the default; measuring the
crossovers on the card and caching them on disk is still to be ported.
"""

import logging

import numpy as np

from ..utils import knobs

log = logging.getLogger(__name__)

DEFAULT_CROSSOVER = 32768

ACCEL_DEFAULT_CROSSOVER = 131072

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
