"""Spatial-index closest point of the PyTorch port (counterpart of
mesh_tpu/accel): the host-built flattened BVH and uniform grid
(``build``), the resident and streamed rope kernels that walk the BVH
(``rope_kernel``), and the accel rung of the auto ladder with the
reference's plain BVH walk and grid probe (``traverse``)."""

from .build import (  # noqa: F401
    AccelIndex,
    build_bvh,
    build_grid,
    clear_index_cache,
    get_index,
    index_cache_info,
    topology_digest,
)
from .traverse import closest_faces_and_points_accel  # noqa: F401
