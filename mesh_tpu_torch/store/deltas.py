"""Vertex-delta store tier: keyframe + uint16-quantized frame deltas (a
copy of mesh_tpu/store/deltas.py, the same sequence manifests and blocks).

An animation sequence over a fixed topology is keyed by
``(topology_digest, sequence_id, frame)``: the keyframe is a normal
store object (exact + compact tiers), and each frame is stored as a
uint16-quantized *delta* against the keyframe's exact vertices — a
fraction of the raw frame bytes, decoded straight back into the
accel-ready f32 layout.  Layout under the store root::

    <root>/sequences/<digest>/<sequence_id>/manifest.json
    <root>/sequences/<digest>/<sequence_id>/d_00000.npy   per-frame blocks
    <root>/sequences/<digest>/<sequence_id>/last_used     LRU touch (gc)

Sequence manifests carry the bumped store schema
(``MANIFEST_SCHEMA_VERSION`` = 2: schema 2 adds the anim sequence
manifest family next to object manifests), per-block CRCs, the frame's
quantization grid (``lo`` / ``scale``), and a TRUE reconstruction
bound like the compact tier: ``tolerance`` is the stated worst-case
``max |decoded - ingested f32 frame|``, taken as the max of the
analytic quantizer bound and the measured decode error at write time
(decode is bit-deterministic, so the measured error is a true bound
for every future read).  Publishing is the store's write-then-rename
protocol — readers never see a half-written sequence.

Frames page in through the existing ``store/pages.py`` PageCache using
the tier string ``anim:<sequence_id>:<frame>`` (``MeshStore.open``
dispatches it here), so resident frames cost zero disk reads and LRU
eviction is byte-budgeted with everything else.  ``MeshStore.gc`` is
sequence-aware: a keyframe object is never evicted while dependent
delta frames remain.
"""

import json
import os

import numpy as np

from ..errors import StoreCorrupt, StoreError
from .blocks import dequantize_rows, quantize_rows, read_block, write_block

__all__ = [
    "ANIM_TIER_PREFIX", "frame_tier", "parse_tier", "read_frame",
    "resolve_frame", "sequence_tolerance", "verify_sequence",
    "write_sequence",
]

#: ``MeshStore.open`` tier prefix for delta frames
ANIM_TIER_PREFIX = "anim:"

_FRAME_FMT = "d_%05d.npy"


def frame_tier(sequence_id, frame):
    """The ``MeshStore.open`` / PageCache tier string for one frame."""
    return "%s%s:%d" % (ANIM_TIER_PREFIX, sequence_id, int(frame))


def parse_tier(tier):
    """``(sequence_id, frame)`` for an ``anim:<seq>:<frame>`` tier
    string, or ``None`` when ``tier`` is not a delta-frame tier."""
    if not isinstance(tier, str) or not tier.startswith(ANIM_TIER_PREFIX):
        return None
    body = tier[len(ANIM_TIER_PREFIX):]
    seq, sep, frame = body.rpartition(":")
    if not sep or not seq:
        raise StoreError("malformed anim tier %r "
                         "(want anim:<sequence>:<frame>)" % (tier,))
    try:
        return seq, int(frame)
    except ValueError:
        raise StoreError("malformed anim frame in tier %r" % (tier,))


def check_sequence_id(sequence_id):
    if (not sequence_id or os.path.sep in sequence_id or ":" in sequence_id
            or sequence_id != sequence_id.strip()
            or sequence_id.startswith(".")):
        raise StoreError("malformed sequence id %r" % (sequence_id,))
    return sequence_id


def write_sequence(store, digest, sequence_id, frames, source=None):
    """Publish an animation sequence of absolute per-frame vertex
    arrays as quantized deltas against the published keyframe object
    ``digest``; returns the sequence manifest.

    Dedupe by name: an already-published ``(digest, sequence_id)``
    touches its LRU stamp and returns the existing manifest.  The
    keyframe must already be ingested — deltas without their base are
    unreadable by construction."""
    from .store import MANIFEST_SCHEMA_VERSION, _metrics
    from ..obs.clock import wall
    from ..obs.trace import span as obs_span

    check_sequence_id(sequence_id)
    key = store.open(digest, tier="exact")      # raises when absent
    v_key = np.asarray(key.v, np.float32)
    existing = store.sequence_manifest(digest, sequence_id, missing_ok=True)
    if existing is not None:
        store._touch_sequence(digest, sequence_id)
        return existing

    frames = [np.asarray(fr, np.float32) for fr in frames]
    if not frames:
        raise StoreError("write_sequence needs at least one frame")
    for fr in frames:
        if fr.shape != v_key.shape:
            raise StoreError(
                "frame shape %s does not match keyframe %s"
                % (fr.shape, v_key.shape))

    with obs_span("store.ingest", digest=digest, sequence=sequence_id,
                  frames=len(frames)) as sp:
        stage = store._stage_dir("%s.%s" % (digest, sequence_id))
        blocks = []
        total = 0
        tolerance = 0.0
        try:
            for i, fr in enumerate(frames):
                delta = fr - v_key
                q, lo, scale, tol = quantize_rows(delta)
                rel = _FRAME_FMT % i
                crc, rows, nbytes = write_block(
                    os.path.join(stage, rel), q)
                # TRUE bound: analytic quantizer bound vs the measured
                # decode error of this exact frame (decode is
                # bit-deterministic, so measured is a true bound too)
                recon = v_key + dequantize_rows(q, lo, scale)
                err = float(np.max(np.abs(
                    np.asarray(recon, np.float64)
                    - np.asarray(fr, np.float64)))) if fr.size else 0.0
                f_tol = max(float(tol), err)
                blocks.append({
                    "file": rel, "frame": i, "rows": rows, "crc32": crc,
                    "lo": [float(x) for x in lo],
                    "scale": [float(x) for x in scale],
                    "tolerance": f_tol,
                })
                tolerance = max(tolerance, f_tol)
                total += nbytes
            manifest = {
                "schema_version": MANIFEST_SCHEMA_VERSION,
                "kind": "anim_sequence",
                "digest": digest,
                "sequence_id": sequence_id,
                "created_utc": wall(),
                "frames": len(frames),
                "n_vertices": int(v_key.shape[0]),
                "bytes": int(total),
                "tolerance": tolerance,
                "blocks": blocks,
            }
            if source:
                manifest["source"] = dict(source)
            with open(os.path.join(stage, "manifest.json"), "w") as fh:
                json.dump(manifest, fh, indent=1, sort_keys=True)
                fh.write("\n")
            store._publish_sequence(stage, digest, sequence_id)
        finally:
            import shutil

            shutil.rmtree(stage, ignore_errors=True)
        _metrics()["ingest"].inc(tier="anim")
        _metrics()["bytes"].set(float(store.total_bytes()))
        sp.set(bytes=total, tolerance=tolerance)
    return store.sequence_manifest(digest, sequence_id)


def _frame_entry(manifest, digest, frame):
    blocks = manifest.get("blocks") or []
    if not 0 <= int(frame) < len(blocks):
        raise StoreError(
            "sequence %s/%s has no frame %s (frames: %s)"
            % (digest, manifest.get("sequence_id"), frame,
               manifest.get("frames")))
    return blocks[int(frame)]


def read_frame(store, digest, sequence_id, frame, verify=None, mmap=True):
    """Reconstructed absolute f32 vertices of one frame: keyframe
    exact tier + dequantized delta, every block CRC-checked (unless
    ``MESH_TPU_STORE_VERIFY`` / ``verify=`` turns it off)."""
    from .store import report_corrupt
    from ..utils import knobs

    if verify is None:
        verify = knobs.flag("MESH_TPU_STORE_VERIFY")
    check_sequence_id(sequence_id)
    manifest = store.sequence_manifest(digest, sequence_id)
    entry = _frame_entry(manifest, digest, frame)
    path = os.path.join(
        store.sequence_dir(digest, sequence_id), entry["file"])
    try:
        q = read_block(path, entry.get("crc32"), verify=verify, mmap=mmap)
    except StoreCorrupt as exc:
        report_corrupt(exc.what, digest, str(exc))
        raise StoreCorrupt(str(exc), what=exc.what, digest=digest)
    if int(q.shape[0]) != int(entry["rows"]):
        detail = ("%s has %d rows, manifest says %s"
                  % (entry["file"], q.shape[0], entry["rows"]))
        report_corrupt("block_read", digest, detail)
        raise StoreCorrupt("sequence %s/%s truncated: %s"
                           % (digest, sequence_id, detail),
                           what="block_read", digest=digest)
    key = store.open(digest, tier="exact", verify=verify, mmap=mmap)
    v_key = np.asarray(key.v, np.float32)
    verts = v_key + dequantize_rows(q, entry["lo"], entry["scale"])
    store._touch_sequence(digest, sequence_id)
    return verts, np.asarray(key.f), manifest


def open_frame(store, digest, tier, verify=None, mmap=True):
    """``MeshStore.open`` dispatch target for ``anim:<seq>:<frame>``
    tiers: a :class:`StoredMesh` whose vertices are the reconstructed
    frame (within the manifest's stated ``tolerance``) over the
    keyframe's faces."""
    from .store import StoredMesh

    sequence_id, frame = parse_tier(tier)
    verts, faces, manifest = read_frame(
        store, digest, sequence_id, frame, verify=verify, mmap=mmap)
    return StoredMesh(verts, faces, digest, tier, manifest)


def resolve_frame(digest, sequence_id, frame, cache=None):
    """One frame through the serving tier's page cache:
    ``(StoredMesh, "resident" | "paged")``.  Resident frames cost no
    disk reads; misses page in under the ``store.page_in`` span like
    any other store tier."""
    from .pages import get_page_cache

    cache = cache or get_page_cache()
    return cache.resolve(digest, tier=frame_tier(sequence_id, frame))


def sequence_tolerance(manifest):
    """The sequence's TRUE worst-case reconstruction bound (meters, in
    vertex units): ``max |decoded - ingested f32 frame|`` over every
    frame."""
    return float(manifest.get("tolerance", 0.0))


def verify_sequence(store, digest, sequence_id):
    """CRC + shape audit of one sequence; returns problem strings
    (empty = clean).  Each problem is counted and flight-recorded by
    the shared corruption path."""
    problems = []
    try:
        manifest = store.sequence_manifest(digest, sequence_id)
    except (StoreError, StoreCorrupt) as exc:
        return ["%s/%s: %s" % (digest, sequence_id, exc)]
    for entry in manifest.get("blocks") or []:
        try:
            verts, _f, _m = read_frame(
                store, digest, sequence_id, entry["frame"], verify=True)
        except (StoreError, StoreCorrupt) as exc:
            problems.append("%s/%s: %s" % (digest, sequence_id, exc))
            continue
        if int(verts.shape[0]) != int(manifest["n_vertices"]):
            problems.append(
                "%s/%s: frame %s reconstructs %d vertices, manifest "
                "says %s" % (digest, sequence_id, entry["frame"],
                             verts.shape[0], manifest["n_vertices"]))
    return problems
