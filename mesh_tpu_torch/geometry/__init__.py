"""Geometry of the PyTorch port: cross products, face and vertex normals,
Rodrigues rotations."""

from .cross_product import cross  # noqa: F401
from .rodrigues import rodrigues2rotmat  # noqa: F401
from .tri_normals import tri_normals, tri_normals_scaled  # noqa: F401
from .vert_normals import vert_normals  # noqa: F401
