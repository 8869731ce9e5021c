"""Content-addressed on-disk mesh corpus of the port (counterpart of
mesh_tpu/store, with its on-disk layout).

Objects are keyed by the same topology digest the accel index cache
uses (``accel/build.py:topology_digest``, equal to the reference's bit
for bit), so a mesh, its spatial-index side-car and its delta frames
share one identity, and a store written by either package opens in the
other.  The package is numpy and stdlib at import time; torch comes in
through ``accel.build`` only when an index object is materialized.
"""

from .blocks import quantize_rows, dequantize_rows  # noqa: F401
from .store import (  # noqa: F401
    MeshStore, StoredMesh, default_store_root, get_store,
)
from .pages import PageCache, get_page_cache, clear_page_cache  # noqa: F401

__all__ = [
    "MeshStore", "StoredMesh", "default_store_root", "get_store",
    "PageCache", "get_page_cache", "clear_page_cache",
    "quantize_rows", "dequantize_rows",
]
