"""mesh_tpu_torch: the PyTorch/CUDA port of mesh_tpu for NVIDIA Hopper.

A second package beside ``mesh_tpu``: plain array code is PyTorch, and each
Pallas kernel of the JAX package becomes a CUDA kernel written for
``sm_90a`` (``csrc/``, built at first use by ``_build``).  Every public entry
point takes ``device=`` and defaults to the card; only an explicit
``device="cpu"`` runs on the CPU, where each kernel's plain PyTorch version
stands in.  The package imports neither JAX nor ``mesh_tpu``.

Ported so far: the posed-body -> normals -> closest-point path (the
synthetic body model and ``lbs``, vertex normals, the brute-force
closest-face and nearest-vertex kernels behind the batched and ``Mesh``
facades), and closest point on large meshes (the auto ladder's
sphere-culled kernel and BVH rope walks, ``accel``), and ray-cast vertex
visibility with the search trees (the any-hit, along-normal and
normal-weighted kernels behind ``Mesh.vertex_visibility``,
``batched_vertex_visibility`` and ``search``'s ``AabbTree`` and
``AabbNormalsTree``), and triangle-triangle intersection (the any-hit and
self-intersection kernels, each with a segment and a Moller tile, behind
``AabbTree.intersections_indices``, ``query.intersections_mask`` and
``query.self_intersection_count``, with the SMPL-family synthetic models of
``models.synthetic_family_model``).
"""

from .batch import (  # noqa: F401
    batched_closest_faces_and_points,
    batched_vertex_normals,
    batched_vertex_visibility,
    fused_normals_and_closest_points,
)
from .mesh import Mesh  # noqa: F401
from .search import (  # noqa: F401
    AabbNormalsTree,
    AabbTree,
    CGALClosestPointTree,
    ClosestPointTree,
)
