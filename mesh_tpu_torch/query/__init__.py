"""Closest-point queries of the PyTorch port."""

from .closest_kernel import (  # noqa: F401
    closest_point_kernel,
    mesh_is_nondegenerate,
    nearest_vertices_kernel,
)
from .closest_point import (  # noqa: F401
    closest_faces_and_points,
    closest_vertices,
    closest_vertices_with_distance,
)
from .culled import closest_faces_and_points_auto  # noqa: F401
from .culled_kernel import closest_point_culled_kernel  # noqa: F401
