"""mesh_tpu_torch.diff: surface queries as autodiff citizens (counterpart
of mesh_tpu/diff).

The query kernels end in an argmin over faces; this package makes them
consumable by ``torch.autograd`` and ``torch.func`` through envelope-
theorem gradients (``queries``), composes them into registration energies
(``energies``) and drives an ICP outer loop (``register``).  The training
step in ``parallel/fit.py`` uses them for its default point-to-surface
data term.
"""

from .energies import (  # noqa: F401
    geman_mcclure,
    huber,
    landmark_term,
    point_to_plane,
    point_to_point,
    symmetric_chamfer,
)
from .queries import (  # noqa: F401
    closest_point,
    closest_point_batched,
    nearest_normal_weighted,
    point_to_triangle,
    surface_normals_frozen,
)
from .register import RegisterResult, icp_register, register_vertices  # noqa: F401

__all__ = [
    "closest_point", "closest_point_batched", "point_to_triangle",
    "nearest_normal_weighted", "surface_normals_frozen",
    "huber", "geman_mcclure", "point_to_point", "point_to_plane",
    "symmetric_chamfer", "landmark_term",
    "icp_register", "register_vertices", "RegisterResult",
]
