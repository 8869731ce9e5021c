"""Serialization <-> store bridge: loaders as INGEST, writers as EXPORT
(a copy of mesh_tpu/serialization/store_io.py over the port's codecs).

The obj/ply/native/json codecs become the boundary of the
content-addressed store: :func:`ingest_file` parses once at the codec
level (no Mesh object, no torch) and publishes chunked blocks keyed by
topology digest; :func:`export_file` rehydrates a store object
(mmap-backed) straight into any writer format.  Provenance (source path,
format, mtime) rides in the object manifest's ``source`` field.
"""

import os
import types

import numpy as np

from ..errors import SerializationError
from . import native, serialization
from .obj import load_obj
from .ply import read_ply

__all__ = ["ingest_file", "ingest_mesh", "export_file", "parse_file"]

_EXT_FMT = {".obj": "obj", ".ply": "ply", ".json": "json", ".js": "json"}


def _detect_fmt(path, fmt=None):
    if fmt:
        return fmt
    ext = os.path.splitext(path)[1].lower()
    try:
        return _EXT_FMT[ext]
    except KeyError:
        raise SerializationError(
            "cannot infer mesh format from %r (known: %s)"
            % (path, sorted(_EXT_FMT)))


def parse_file(path, fmt=None, use_native=True):
    """Codec-level parse: ``(v, f)`` numpy arrays (``f`` may be empty)
    without constructing a Mesh: the torch-free half of ingest."""
    fmt = _detect_fmt(path, fmt)
    if fmt == "obj":
        data = serialization._load_obj_dict(path, use_native=use_native)
        v = np.asarray(data["v"])
        f = np.asarray(data.get("f", np.zeros((0, 3), np.uint32)))
    elif fmt == "ply":
        use = bool(use_native) and native.available()
        if use:
            try:
                with open(path, "rb") as fp:
                    use = b"format ascii" in fp.read(256)
            except OSError as exc:
                raise SerializationError("Failed to open PLY file: %s"
                                         % exc)
        res = native.load_ply_native(path) if use else read_ply(path)
        v = np.asarray(res["pts"])
        f = np.asarray(res["tri"])
    elif fmt == "json":
        holder = types.SimpleNamespace()
        serialization.load_from_json(holder, path)
        v = np.asarray(holder.v)
        f = np.asarray(getattr(holder, "f", np.zeros((0, 3), np.int64)))
    else:
        raise SerializationError("unknown mesh format %r" % fmt)
    return v, f.reshape(-1, 3) if f.size else f.reshape(0, 3)


def _source_record(path, fmt):
    try:
        stat = os.stat(path)
        return {"path": os.path.abspath(path), "format": fmt,
                "bytes": int(stat.st_size),
                "mtime": float(stat.st_mtime)}
    except OSError:
        return {"path": os.path.abspath(path), "format": fmt}


def ingest_file(path, store=None, fmt=None, use_native=True):
    """Parse a mesh file and publish it into the store; returns the
    store key (topology digest).  Re-ingesting identical geometry
    dedupes to the existing object."""
    from ..store import get_store

    fmt = _detect_fmt(path, fmt)
    v, f = parse_file(path, fmt=fmt, use_native=use_native)
    store = store or get_store()
    return store.ingest(v, f, source=_source_record(path, fmt))


def ingest_mesh(mesh, store=None, source=None):
    """Publish an in-memory mesh (anything with ``.v``/``.f``)."""
    from ..store import get_store

    store = store or get_store()
    f = getattr(mesh, "f", None)
    if f is None:
        f = np.zeros((0, 3), np.int64)
    return store.ingest(np.asarray(mesh.v), np.asarray(f), source=source)


def export_file(digest, path, store=None, fmt=None, tier="exact",
                **writer_kwargs):
    """Rehydrate a store object straight into a writer format.  The
    StoredMesh duck-types through the same ``write_ply``/``write_obj``/
    ``write_json`` paths a full Mesh uses, so exact-tier export of an
    ingested file round-trips the geometry bit-identically."""
    from ..store import get_store

    fmt = _detect_fmt(path, fmt)
    store = store or get_store()
    mesh = store.open(digest, tier=tier)
    if fmt == "obj":
        serialization.write_obj(mesh, path, **writer_kwargs)
    elif fmt == "ply":
        serialization.write_ply(mesh, path, **writer_kwargs)
    elif fmt == "json":
        serialization.write_json(mesh, path, **writer_kwargs)
    else:
        raise SerializationError("unknown mesh format %r" % fmt)
    return path
