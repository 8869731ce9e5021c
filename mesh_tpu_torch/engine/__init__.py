"""mesh_tpu_torch.engine: the query-execution engine behind the facades
(counterpart of mesh_tpu/engine).

It sits between the ``Mesh`` facade / ``mesh_tpu_torch.batch`` entry points
(and the ICP correspondence bursts of ``diff.register``) and the kernels:

- **planner**: shape-bucketed plan cache.  Q and B pad up a geometric
  ladder, one plan per (op, bucket, topology shape, strategy, device) key,
  LRU-kept; on the card a plan is a CUDA graph of the batched step, on the
  CPU the step called eagerly at the bucket's shapes; ``warmup()`` makes
  the SMPL- and FLAME-shaped plans ahead of traffic;
- **executor**: coalescing submit/future dispatch: concurrently pending
  same-topology requests ride one stacked dispatch;
- **stats**: hits / misses / retraces, pad waste, coalesced batch sizes,
  per-op dispatch latency (``engine.stats()``).

With kernels on (the card), every face count goes to the brute-force or
the sphere-culled closest-point kernel, never to the BVH or MXU rungs of
the direct route.  ``MESH_TPU_NO_ENGINE=1`` bypasses everything: the
facades take their direct paths.
"""

import numpy as np

from ..errors import EngineShutdown  # noqa: F401
from .executor import (  # noqa: F401
    EngineExecutor,
    get_executor,
    submit,
)
from .planner import (  # noqa: F401
    B_LADDER,
    MODEL_SHAPES,
    Q_LADDER,
    Planner,
    bucket_size,
    get_planner,
    warmup,
)
from .stats import STATS, reset_stats, stats  # noqa: F401

__all__ = [
    "engine_enabled", "stats", "reset_stats", "warmup",
    "get_planner", "get_executor", "submit", "EngineShutdown",
    "facade_closest_faces_and_points",
    "Q_LADDER", "B_LADDER", "bucket_size", "MODEL_SHAPES",
]


def engine_enabled():
    """False when MESH_TPU_NO_ENGINE pins the direct facade paths."""
    from ..utils.knobs import no_engine

    return not no_engine()


def facade_closest_faces_and_points(mesh, points):
    """Engine route for ``Mesh.closest_faces_and_points``.

    Returns the reference AabbTree.nearest convention, ``(faces [1, Q]
    uint32, points [Q, 3] f64)``, or None where the direct path serves:
    the engine is off (MESH_TPU_NO_ENGINE=1), there are no queries, or the
    mesh is on the CPU (no kernels) with more than ``crossover_faces()``
    faces, where the direct route's auto ladder culls.
    """
    if not engine_enabled():
        return None
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    if not pts.shape[0]:
        return None
    from ..batch import _batch_nondegen, _strategy
    from ..utils.device import as_tensor, resolve_device
    from ..utils.knobs import tile_variant

    if hasattr(mesh, "device_arrays"):
        vt, ft = mesh.device_arrays()
    else:
        dev = resolve_device(getattr(mesh, "device", None) or "cuda")
        vt = as_tensor(np.asarray(mesh.v, np.float32), dev)
        ft = as_tensor(np.asarray(mesh.f, np.int64), dev)
    use_pallas, use_culled = _strategy(ft, vt.device)
    if not use_pallas:
        from ..query.autotune import crossover_faces

        if int(ft.shape[0]) > crossover_faces():
            return None
    _, res = get_planner().run_batch_step(
        vt[None], ft, pts[None],
        use_pallas=use_pallas, use_culled=use_culled, chunk=512,
        with_normals=False,
        nondegen=_batch_nondegen(np.asarray(mesh.v, np.float32),
                                 np.asarray(mesh.f, np.int64)),
        variant=tile_variant(), op="closest_point",
    )
    faces = res["face"][0].cpu().numpy().astype(np.uint32)[None, :]
    return faces, res["point"][0].cpu().numpy().astype(np.float64)
