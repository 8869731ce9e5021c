"""Spatial-index closest point of the PyTorch port (counterpart of
mesh_tpu/accel): the host-built flattened BVH (``build``), the resident
and streamed rope kernels that walk it (``rope_kernel``), and the accel
rung of the auto ladder (``traverse``)."""

from .build import (  # noqa: F401
    AccelIndex,
    build_bvh,
    clear_index_cache,
    get_index,
    index_cache_info,
    topology_digest,
)
from .traverse import closest_faces_and_points_accel  # noqa: F401
