"""Host-side mesh topology (counterpart of mesh_tpu/topology): edge and
adjacency structures, Loop subdivision and quadric decimation as sparse
``LinearMeshTransform``s.  numpy and scipy, as in the reference."""

from .connectivity import (  # noqa: F401
    get_vert_opposites_per_edge,
    get_vert_connectivity,
    get_vertices_per_edge,
    get_faces_per_edge,
    vertices_to_edges_matrix,
    vertices_in_common,
)
from .decimation import (  # noqa: F401
    qslim_decimator,
    qslim_decimator_fast,
    qslim_decimator_transformer,
    vertex_quadrics,
    remove_redundant_verts,
)
from .subdivision import loop_subdivider  # noqa: F401
from .linear_mesh_transform import LinearMeshTransform  # noqa: F401
