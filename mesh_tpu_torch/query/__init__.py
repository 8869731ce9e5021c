"""Closest-point, normal-weighted, ray, visibility and
triangle-triangle queries of the PyTorch port."""

from .autotune import calibrate_crossover, crossover_faces  # noqa: F401
from .point_triangle import closest_point_on_triangle  # noqa: F401
from .anchored import (  # noqa: F401
    build_anchor_tables,
    closest_point_anchored,
    closest_point_anchored_auto,
)
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
from .culled import (  # noqa: F401
    closest_faces_and_points_auto,
    closest_faces_and_points_culled,
    triangle_bounds,
)
from .culled_kernel import closest_point_culled_kernel  # noqa: F401
from .normal_weighted import (  # noqa: F401
    nearest_normal_weighted,
    nearest_normal_weighted_kernel,
)
from .ray import (  # noqa: F401
    intersections_mask,
    nearest_alongnormal,
    ray_triangle_hits,
    self_intersection_count,
    tri_tri_intersects,
    tri_tri_intersects_moller,
)
from .ray_kernel import (  # noqa: F401
    nearest_alongnormal_kernel,
    ray_any_hit,
    ray_any_hit_culled,
)
from .tri_tri_kernel import (  # noqa: F401
    self_intersection_counts_kernel,
    tri_tri_any_hit_kernel,
)
from .visibility import visibility_compute  # noqa: F401
