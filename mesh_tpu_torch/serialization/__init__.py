"""Mesh file I/O of the port (counterpart of mesh_tpu/serialization): PLY,
OBJ and JSON readers and writers, the landmark-file readers, and the
native I/O core behind them (``native``).  The content-addressed store's
codecs (``store_io``) are not ported yet (ROADMAP.md, Queue 1)."""

from . import serialization  # noqa: F401
from .ply import read_ply, write_ply_data  # noqa: F401
from .obj import load_obj, write_obj_data  # noqa: F401
