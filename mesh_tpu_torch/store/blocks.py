"""Chunked block codec for the mesh store (a copy of
mesh_tpu/store/blocks.py; the on-disk layout is the reference's, so a
store written by either package opens in the other).

An array tier is a list of row-contiguous ``.npy`` blocks, each with a
CRC32 over the whole file bytes recorded in the object manifest and
re-checked on read — a truncated or bit-flipped block can never be
returned as mesh data.  Two tiers share the layout:

- **exact** — the ingested array's own dtype, bit-identical round trip;
- **compact** — per-block uint16 quantization with the per-axis
  ``lo``/``scale`` recorded next to each block's CRC; the manifest
  states the worst-case per-coordinate absolute error (``scale / 2``).

Blocks are plain ``np.save`` output so a single-block tier can be
served straight off ``np.load(mmap_mode="r")`` with zero copies — the
cold-start path the side-car contract depends on.
"""

import os
import zlib

import numpy as np

from ..errors import StoreCorrupt, StoreError  # noqa: F401 — facade

__all__ = [
    "StoreError", "StoreCorrupt", "block_spans", "write_block",
    "read_block", "quantize_rows", "dequantize_rows", "file_crc32",
]

#: quantization levels per axis in the compact tier (uint16)
_Q_LEVELS = 65535


def block_spans(n_rows, block_rows):
    """Row ranges [(start, stop), ...] chunking ``n_rows`` into blocks
    of at most ``block_rows`` (empty list for an empty array)."""
    block_rows = max(1, int(block_rows))
    return [(start, min(start + block_rows, int(n_rows)))
            for start in range(0, int(n_rows), block_rows)]


def file_crc32(path):
    """CRC32 over a file's raw bytes, as the 8-hex-digit string the
    manifest records."""
    crc = 0
    with open(path, "rb") as fh:
        while True:
            chunk = fh.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return "%08x" % (crc & 0xFFFFFFFF)


def write_block(path, arr):
    """Write one ``.npy`` block and return its manifest entry fields
    ``(crc32_hex, rows, nbytes)``.  The array lands contiguous in its
    own dtype, so the exact tier is a bit-identical round trip."""
    arr = np.ascontiguousarray(arr)
    with open(path, "wb") as fh:
        np.save(fh, arr, allow_pickle=False)
    return file_crc32(path), int(arr.shape[0]), int(os.path.getsize(path))


def read_block(path, crc32_hex=None, verify=True, mmap=True):
    """Read one block back; CRC-verify the file bytes first (cheap —
    one sequential pass that also warms the page cache the subsequent
    mmap reads from).  Raises :class:`StoreCorrupt` on any mismatch or
    short/unreadable file."""
    try:
        if verify and crc32_hex is not None:
            actual = file_crc32(path)
            if actual != crc32_hex:
                raise StoreCorrupt(
                    "block %s CRC mismatch: %s on disk vs %s in manifest"
                    % (path, actual, crc32_hex), what="block_crc")
        return np.load(path, mmap_mode="r" if mmap else None,
                       allow_pickle=False)
    except StoreCorrupt:
        raise
    except (OSError, ValueError) as exc:
        raise StoreCorrupt("block %s unreadable: %s" % (path, exc),
                           what="block_read")


def quantize_rows(arr):
    """Quantize one float block to uint16: returns ``(q, lo, scale,
    tolerance)`` with ``dequant = lo + q * scale``.  ``tolerance`` is a
    TRUE worst-case per-coordinate absolute bound for the float32
    reconstruction: the quantization half-step ``max(scale) / 2`` plus
    the float32 rounding of the largest representable value.  Degenerate
    axes (zero span) get scale 0 and reconstruct exactly."""
    a = np.asarray(arr, np.float64)
    if a.size == 0:
        return (np.zeros(a.shape, np.uint16), np.zeros(a.shape[-1]),
                np.zeros(a.shape[-1]), 0.0)
    lo = a.min(axis=0)
    hi = a.max(axis=0)
    scale = (hi - lo) / float(_Q_LEVELS)
    safe = np.where(scale > 0, scale, 1.0)
    q = np.clip(np.rint((a - lo) / safe), 0, _Q_LEVELS).astype(np.uint16)
    cast_ulp = float(np.max(np.maximum(np.abs(lo), np.abs(hi)))) \
        * float(np.finfo(np.float32).eps)
    tolerance = float(scale.max() / 2.0) + cast_ulp if scale.size else 0.0
    return q, lo, scale, tolerance


def dequantize_rows(q, lo, scale, dtype=np.float32):
    """Reconstruct a quantized block (see :func:`quantize_rows`)."""
    lo = np.asarray(lo, np.float64)
    scale = np.asarray(scale, np.float64)
    return (lo + np.asarray(q, np.float64) * scale).astype(dtype)
