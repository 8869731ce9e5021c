"""Geometry of the PyTorch port: cross products, face and vertex normals,
Rodrigues rotations, triangle areas, projected barycentric coordinates and
the reference's chumpy-era names (``compat``)."""

from .barycentric import barycentric_coordinates_of_projection  # noqa: F401
from .compat import (  # noqa: F401  (reference chumpy-era names)
    CrossProduct,
    MatVecMult,
    NormalizedNx3,
    NormalizeRows,
    TriEdges,
    TriNormals,
    TriNormalsScaled,
    TriToScaledNormal,
    VertNormals,
    VertNormalsScaled,
)
from .cross_product import cross  # noqa: F401
from .rodrigues import rodrigues, rodrigues2rotmat, rotmat2rodrigues  # noqa: F401
from .triangle_area import triangle_area  # noqa: F401
from .tri_normals import tri_normals, tri_normals_scaled  # noqa: F401
from .vert_normals import vert_normals  # noqa: F401
