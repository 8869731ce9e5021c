"""Mesh file I/O of the port (counterpart of mesh_tpu/serialization): PLY,
OBJ and JSON readers and writers, the landmark-file readers, the native
I/O core behind them (``native``) and the bridge to the content-addressed
mesh store (``store_io``: files in as store objects, objects out as
files)."""

from . import serialization  # noqa: F401
from .ply import read_ply, write_ply_data  # noqa: F401
from .obj import load_obj, write_obj_data  # noqa: F401
from .store_io import (  # noqa: F401
    export_file, ingest_file, ingest_mesh, parse_file,
)
