"""AccelIndex side-car persistence (a copy of mesh_tpu/store/sidecar.py:
the same tags, documents and blocks, and the port's
:class:`~mesh_tpu_torch.accel.build.AccelIndex`, whose arrays equal the
reference's bit for bit, so a side-car written by either package serves
the other).

A side-car is the serialized form of one ``AccelIndex`` living inside the
store object it indexes::

    objects/<digest>/sidecar/<tag>/sidecar.json   kind/digest/params/meta
    objects/<digest>/sidecar/<tag>/<name>.npy     one CRC'd block per array

``tag`` encodes the builder kind plus a CRC of the non-default build
params, so ``get_index(v, f, "bvh")`` and ``get_index(v, f, "bvh",
leaf_size=4)`` keep distinct side-cars.  Loading mmaps every array —
a cold replica serves its first query off the page cache without a
host build.  Every load re-checks the side-car's recorded digest
against the digest the caller derived from the mesh bytes (a stale
side-car next to drifted mesh data is *corruption*, not a fallback
tier) and each array's CRC; any failure counts
``mesh_tpu_store_corrupt_total``, drops one rate-limited
flight-recorder incident, and returns ``None`` so the caller falls
back to the host build — never a crash.
"""

import json
import os
import shutil
import zlib

import numpy as np

from ..errors import StoreCorrupt
from ..obs.trace import span as obs_span
from .blocks import file_crc32, read_block, write_block

__all__ = [
    "sidecar_tag", "put_sidecar", "load_sidecar", "verify_sidecar",
    "SIDECAR_SCHEMA_VERSION",
]

SIDECAR_SCHEMA_VERSION = 1


def sidecar_tag(kind, params=None):
    """Filesystem-safe side-car directory name for a builder invocation:
    the kind alone for default params, ``kind-<crc>`` otherwise."""
    items = tuple(sorted((params or {}).items()))
    if not items:
        return str(kind)
    blob = json.dumps(items, sort_keys=True).encode()
    return "%s-%08x" % (kind, zlib.crc32(blob) & 0xFFFFFFFF)


def put_sidecar(store, index, params=None):
    """Persist ``index`` next to its store object (which must already be
    published — a side-car without its mesh is unservable).  Atomic via
    the same stage-then-rename discipline as object publish; a lost race
    keeps the winner.  Returns the tag."""
    from .store import _metrics

    digest = index.digest
    obj_dir = store.object_dir(digest)
    if not store.exists(digest):
        raise StoreCorrupt(
            "cannot attach side-car: object %s not in store" % digest,
            what="sidecar_meta", digest=digest)
    tag = sidecar_tag(index.kind, params)
    with obs_span("store.sidecar_write", digest=digest, tag=tag):
        stage = store._stage_dir(digest)
        try:
            arrays = {}
            for name in sorted(index.arrays):
                arr = np.asarray(index.arrays[name])
                rel = "%s.npy" % name
                crc, _rows, _nbytes = write_block(
                    os.path.join(stage, rel), arr)
                arrays[name] = {
                    "file": rel, "crc32": crc,
                    "dtype": str(arr.dtype),
                    "shape": [int(s) for s in arr.shape],
                }
            doc = {
                "schema_version": SIDECAR_SCHEMA_VERSION,
                "kind": index.kind,
                "digest": digest,
                "params": dict(params or {}),
                "meta": dict(index.meta),
                "arrays": arrays,
            }
            with open(os.path.join(stage, "sidecar.json"), "w") as fh:
                json.dump(doc, fh, indent=1, sort_keys=True)
                fh.write("\n")
            dest = os.path.join(obj_dir, "sidecar", tag)
            os.makedirs(os.path.dirname(dest), exist_ok=True)
            try:
                os.rename(stage, dest)
            except OSError:
                if not os.path.isfile(os.path.join(dest, "sidecar.json")):
                    raise
        finally:
            shutil.rmtree(stage, ignore_errors=True)
    _metrics()["sidecar_writes"].inc(kind=index.kind)
    return tag


def _read_doc(store, digest, tag):
    path = os.path.join(store.object_dir(digest), "sidecar", tag,
                        "sidecar.json")
    if not os.path.isfile(path):
        return None
    with open(path) as fh:
        return json.load(fh)


def load_sidecar(store, digest, kind, params=None, verify=True):
    """Rehydrate one side-car as a live :class:`AccelIndex` with
    mmap-backed arrays, or ``None`` when absent or corrupt (corruption
    is counted + flight-recorded; the caller host-builds instead)."""
    from ..accel.build import AccelIndex
    from .store import report_corrupt

    tag = sidecar_tag(kind, params)
    base = os.path.join(store.object_dir(digest), "sidecar", tag)
    with obs_span("store.sidecar_load", digest=digest, tag=tag) as sp:
        try:
            doc = _read_doc(store, digest, tag)
        except (OSError, ValueError) as exc:
            report_corrupt("sidecar_meta", digest,
                           "%s: %s" % (tag, exc))
            return None
        if doc is None:
            sp.set(outcome="absent")
            return None
        if doc.get("digest") != digest or doc.get("kind") != kind:
            report_corrupt(
                "sidecar_digest", digest,
                "side-car %s records digest=%r kind=%r (stale/drifted)"
                % (tag, doc.get("digest"), doc.get("kind")))
            sp.set(outcome="stale")
            return None
        arrays = {}
        try:
            for name, entry in doc.get("arrays", {}).items():
                arr = read_block(
                    os.path.join(base, entry["file"]),
                    entry.get("crc32"), verify=verify, mmap=True)
                if (list(arr.shape) != list(entry.get("shape", []))
                        or str(arr.dtype) != entry.get("dtype")):
                    raise StoreCorrupt(
                        "side-car array %s shape/dtype drift" % name,
                        what="sidecar_crc", digest=digest)
                arrays[name] = arr
        except StoreCorrupt as exc:
            what = "sidecar_crc" if exc.what == "block_crc" else exc.what
            report_corrupt(what, digest, "%s: %s" % (tag, exc))
            sp.set(outcome="corrupt")
            return None
        except (KeyError, OSError, ValueError) as exc:
            report_corrupt("sidecar_meta", digest, "%s: %s" % (tag, exc))
            sp.set(outcome="corrupt")
            return None
        sp.set(outcome="hit", arrays=len(arrays))
        return AccelIndex(kind, digest, arrays, doc.get("meta", {}))


def verify_sidecar(store, digest, tag):
    """Problem strings (empty = clean) for one side-car: readable json,
    digest match, per-array CRCs.  Used by ``MeshStore.verify``."""
    base = os.path.join(store.object_dir(digest), "sidecar", tag)
    try:
        doc = _read_doc(store, digest, tag)
    except (OSError, ValueError) as exc:
        return ["sidecar %s unreadable: %s" % (tag, exc)]
    if doc is None:
        return ["sidecar %s missing sidecar.json" % tag]
    problems = []
    if doc.get("digest") != digest:
        problems.append("sidecar %s digest drift (records %r)"
                        % (tag, doc.get("digest")))
    for name, entry in sorted(doc.get("arrays", {}).items()):
        path = os.path.join(base, entry.get("file", ""))
        if not os.path.isfile(path):
            problems.append("sidecar %s array %s missing" % (tag, name))
            continue
        actual = file_crc32(path)
        if actual != entry.get("crc32"):
            problems.append(
                "sidecar %s array %s CRC mismatch (%s vs %s)"
                % (tag, name, actual, entry.get("crc32")))
    return problems
