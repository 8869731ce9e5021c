"""Closest-point, normal-weighted, ray and visibility queries of the
PyTorch port."""

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
from .normal_weighted import (  # noqa: F401
    nearest_normal_weighted,
    nearest_normal_weighted_kernel,
)
from .ray import nearest_alongnormal, ray_triangle_hits  # noqa: F401
from .ray_kernel import nearest_alongnormal_kernel, ray_any_hit  # noqa: F401
from .visibility import visibility_compute  # noqa: F401
