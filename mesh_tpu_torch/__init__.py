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
``models.synthetic_family_model``), and training: the envelope-theorem
gradients of those searches, registration energies and ICP (``diff``) and
the single-device scan-fit step (``parallel.fit``), and the rest of the
``Mesh`` facade with the host-side domain modules behind it: topology
(connectivity, Loop subdivision, quadric decimation), ``processing``,
``landmarks``, ``serialization`` (PLY, OBJ, JSON, with the native reader
``native/meshio.cpp``), ``texture``, ``colors``, ``lines``, ``sphere``,
``metrics`` and the ``MeshArrays`` container (``core``), and the
content-addressed mesh store (``store``: chunked CRC'd blocks, a compact
tier, BVH side-cars, delta frames and the page cache behind store-keyed
serve requests, ``Mesh.write_store`` and ``AvatarSession(digest=)``), on
the reference's on-disk layout, and the fleet tier (``fleet``: the hash
ring, ``FleetRouter`` and ``FleetCoordinator`` over serving replicas) with
the obs tooling it reads through (``obs.prof``, ``obs.export``, the staged
bench harness and ``perfcheck``, the ``torch.monitor`` bridge,
``utils.profiling``, the lock witness and the knob registry).

``texture_path`` is the folder of the shipped textured templates;
``mesh_package_cache_folder`` holds the crc32-keyed topology pickles
(``MESH_TPU_CACHE``, else ``PSBODY_MESH_CACHE``, else the port's own
``build/mesh_tpu_torch/cache`` beside the package).
"""

import os

from .utils import knobs

# The lock witness must patch the threading factories before any
# lock-creating module below is imported (utils/lockwitness.py).
if knobs.flag("MESH_TPU_LOCK_WITNESS"):
    from .utils import lockwitness as _lockwitness

    _lockwitness.install()

texture_path = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "ressources", "textures"))

mesh_package_cache_folder = knobs.cache_folder()
os.makedirs(mesh_package_cache_folder, exist_ok=True)

from .batch import (  # noqa: E402,F401
    batched_closest_faces_and_points,
    batched_vertex_normals,
    batched_vertex_visibility,
    fused_normals_and_closest_points,
)
from .core import MeshArrays  # noqa: E402,F401
from .mesh import Mesh  # noqa: E402,F401
from .search import (  # noqa: E402,F401
    AabbNormalsTree,
    AabbTree,
    CGALClosestPointTree,
    ClosestPointTree,
)
