"""Host-side (numpy) construction of the spatial indexes: a copy of
mesh_tpu/accel/build.py's flattened BVH (which the rope kernels and the
plain walk use) and uniform grid (which the plain grid probe uses).

Faces are Morton-sorted by centroid and grouped into contiguous
``leaf_size`` blocks; a complete binary tree over the (power-of-two
padded) blocks is laid out in DFS *preorder* with a ``skip`` ("rope")
pointer per node.  Traversal is stackless: descending into a surviving
node is ``node + 1``; pruning a node, or finishing a leaf, is
``node = skip[node]``; ``skip == n_nodes`` is the exit sentinel.

The uniform grid bins faces conservatively, by triangle-box overlap, into
cells over the mesh's box: the canonical cell -> face map is CSR
(``cell_start`` / ``cell_faces``), and the probe reads its fixed-capacity
dense twin (``cell_table`` [ncells, cap], -1-padded) with the true
per-cell counts (``cell_count``), so an overflowing cell makes the
certificate loose instead of the answer wrong.

Boxes are built from float32 data in a mesh-centered frame whose center is
numpy's float32 mean (``arrays["center"]``); the walks query in that same
frame.  The arrays are bit-equal to the reference's.
``get_index`` keeps the last 8 indexes built in this process, keyed by a
digest of the vertex and face bytes and the build parameters.
"""

import threading
import zlib
from collections import OrderedDict

import numpy as np
import torch

__all__ = [
    "AccelIndex", "topology_digest", "build_bvh", "build_grid", "get_index",
    "clear_index_cache", "index_cache_info", "DEFAULT_LEAF_SIZE",
    "DEFAULT_FACES_PER_CELL",
]

#: faces per BVH leaf block (a leaf visit tests exactly this many pairs)
DEFAULT_LEAF_SIZE = 8

#: grid sizing target: mean faces per axis-uniform cell
DEFAULT_FACES_PER_CELL = 4.0

#: scene-relative pruning slack (fraction of max |v - center|)
PRUNE_SLACK_REL = 1e-4

#: keep at most this many built indexes per process
_MAX_CACHED = 8


class AccelIndex(object):
    """Frozen spatial index: numpy ``arrays`` plus ``kind``, ``digest``
    and ``meta``.  ``on(device)`` gives the arrays as tensors on a device,
    each uploaded once per device; ``tensors`` ({device string: {name:
    tensor}}) hands in tensors that are already there, such as the frozen
    arrays a refit index shares with its base."""

    __slots__ = ("kind", "digest", "arrays", "meta", "_tensors")

    def __init__(self, kind, digest, arrays, meta, tensors=None):
        object.__setattr__(self, "kind", str(kind))
        object.__setattr__(self, "digest", str(digest))
        object.__setattr__(self, "arrays", dict(arrays))
        object.__setattr__(self, "meta", dict(meta))
        object.__setattr__(self, "_tensors", {
            key: dict(named) for key, named in (tensors or {}).items()})

    def __setattr__(self, name, value):
        raise AttributeError("AccelIndex is frozen")

    def __getitem__(self, name):
        return self.arrays[name]

    def on(self, device):
        """{name: tensor} of the arrays on ``device`` (a torch.device)."""
        key = str(device)
        with _CACHE_LOCK:
            tensors = self._tensors.setdefault(key, {})
            for name, arr in self.arrays.items():
                if name not in tensors:
                    tensors[name] = torch.as_tensor(arr, device=device)
        return tensors

    def uploaded(self, names):
        """{device string: {name: tensor}} of the arrays ``names`` on every
        device they were uploaded to so far."""
        with _CACHE_LOCK:
            return {key: {n: named[n] for n in names if n in named}
                    for key, named in self._tensors.items()}

    def nbytes(self):
        return int(sum(np.asarray(a).nbytes for a in self.arrays.values()))

    def __repr__(self):
        return "AccelIndex(kind=%r, digest=%r, faces=%s, %.1f KiB)" % (
            self.kind, self.digest, self.meta.get("n_faces"),
            self.nbytes() / 1024.0)


def topology_digest(v, f):
    """Content digest of a mesh: CRCs over the float32 vertex bytes and
    int32 face bytes plus both shapes (the index cache key)."""
    v32 = np.ascontiguousarray(np.asarray(v, np.float32))
    f32 = np.ascontiguousarray(np.asarray(f, np.int32))
    return "%08x-%08x-v%d-f%d" % (
        zlib.crc32(v32.tobytes()) & 0xFFFFFFFF,
        zlib.crc32(f32.tobytes()) & 0xFFFFFFFF,
        v32.shape[0], f32.shape[0],
    )


def _part1by2(x):
    """Spread the low 10 bits of x two apart (numpy uint32)."""
    x = x & np.uint32(0x3FF)
    x = (x | (x << 16)) & np.uint32(0x030000FF)
    x = (x | (x << 8)) & np.uint32(0x0300F00F)
    x = (x | (x << 4)) & np.uint32(0x030C30C3)
    x = (x | (x << 2)) & np.uint32(0x09249249)
    return x


def _morton_codes(xyz):
    """30-bit Morton code per row of xyz [N, 3] (own-bbox normalized)."""
    lo = xyz.min(axis=0)
    span = np.maximum(xyz.max(axis=0) - lo, 1e-30)
    q = np.clip((xyz - lo) / span * 1023.0, 0.0, 1023.0).astype(np.uint32)
    return (_part1by2(q[:, 0]) << 2) | (_part1by2(q[:, 1]) << 1) \
        | _part1by2(q[:, 2])


def _centered_f32(v, f):
    v32 = np.asarray(v, np.float32)
    fi = np.asarray(f, np.int32)
    center = v32.mean(axis=0)
    vc = v32 - center
    scale = float(max(np.abs(vc).max(), 1e-30))
    return vc, fi, center, scale


def build_bvh(v, f, leaf_size=DEFAULT_LEAF_SIZE):
    """Flattened Morton LBVH over ``leaf_size``-face blocks.

    Faces are Morton-sorted (stably), padded by repeating the last face id
    to ``n_leaves * leaf_size`` with ``n_leaves`` a power of two, so every
    leaf is a contiguous aligned block of the sorted order.  Arrays:
    ``order`` [Fp] int32 sorted face ids, ``node_lo``/``node_hi`` [N, 3]
    float32 boxes in the centered frame, ``node_skip`` [N] int32 escape
    pointers (N = exit), ``node_leaf`` [N] int32 leaf block id or -1, and
    ``center`` [3] float32.  Leaf block ``b`` owns sorted faces
    ``[b * leaf_size, (b + 1) * leaf_size)``."""
    vc, fi, center, scale = _centered_f32(v, f)
    n_faces = int(fi.shape[0])
    if n_faces == 0:
        raise ValueError("build_bvh needs at least one face")
    leaf_size = max(1, int(leaf_size))
    tri = vc[fi]                                   # (F, 3, 3)
    order = np.argsort(
        _morton_codes(tri.mean(axis=1)), kind="stable").astype(np.int32)

    n_leaves = max(1, -(-n_faces // leaf_size))
    depth = int(np.ceil(np.log2(n_leaves))) if n_leaves > 1 else 0
    n_leaves = 1 << depth
    f_pad = n_leaves * leaf_size
    order_p = np.concatenate(
        [order, np.full(f_pad - n_faces, order[-1], np.int32)])
    tri_s = tri[order_p]                           # (Fp, 3, 3)

    # leaf AABBs, then internal levels bottom-up
    blocks = tri_s.reshape(n_leaves, leaf_size * 3, 3)
    lo_levels = [blocks.min(axis=1)]
    hi_levels = [blocks.max(axis=1)]
    while lo_levels[-1].shape[0] > 1:
        lo_levels.append(np.minimum(lo_levels[-1][0::2], lo_levels[-1][1::2]))
        hi_levels.append(np.maximum(hi_levels[-1][0::2], hi_levels[-1][1::2]))
    lo_levels.reverse()
    hi_levels.reverse()

    # preorder + skip, one vectorized step per level:
    #   pre(left)  = pre(parent) + 1        skip(left)  = pre(right)
    #   pre(right) = pre(left) + subtree    skip(right) = skip(parent)
    n_nodes = 2 * n_leaves - 1
    node_lo = np.empty((n_nodes, 3), np.float32)
    node_hi = np.empty((n_nodes, 3), np.float32)
    node_skip = np.empty(n_nodes, np.int32)
    node_leaf = np.full(n_nodes, -1, np.int32)
    pre = np.zeros(1, np.int64)
    skip = np.full(1, n_nodes, np.int64)
    for level in range(depth + 1):
        node_lo[pre] = lo_levels[level]
        node_hi[pre] = hi_levels[level]
        node_skip[pre] = skip
        if level == depth:
            node_leaf[pre] = np.arange(n_leaves)
            break
        subtree = (1 << (depth - level)) - 1       # nodes below each child
        pre_l = pre + 1
        pre_r = pre_l + subtree
        pre = np.stack([pre_l, pre_r], axis=1).reshape(-1)
        skip = np.stack([pre_r, skip], axis=1).reshape(-1)

    return AccelIndex(
        "bvh", topology_digest(v, f),
        arrays={
            "order": order_p,
            "node_lo": node_lo,
            "node_hi": node_hi,
            "node_skip": node_skip,
            "node_leaf": node_leaf,
            "center": center,
        },
        meta={
            "n_faces": n_faces, "leaf_size": leaf_size,
            "n_leaves": n_leaves, "n_nodes": n_nodes, "depth": depth,
            "scale": scale, "prune_slack": PRUNE_SLACK_REL * scale,
        },
    )


def build_grid(v, f, faces_per_cell=DEFAULT_FACES_PER_CELL, cap=None,
               max_res=64):
    """Uniform grid over the mesh's box with conservative box binning.

    ``cell_start`` / ``cell_faces`` is the CSR map (face ids ascending in
    each cell); ``cell_table`` [ncells, cap] its fixed-shape twin,
    -1-padded and cut at ``cap`` (default: the 98th percentile of the
    occupied cells' counts, at most 64), with the true counts in
    ``cell_count``; ``grid_lo`` and ``width`` [3] the cells' frame."""
    vc, fi, center, scale = _centered_f32(v, f)
    n_faces = int(fi.shape[0])
    if n_faces == 0:
        raise ValueError("build_grid needs at least one face")
    tri = vc[fi]
    lo = tri.min(axis=(0, 1))
    hi = tri.max(axis=(0, 1))
    res = int(np.clip(
        round((n_faces / max(float(faces_per_cell), 0.25)) ** (1.0 / 3.0)),
        1, int(max_res)))
    width = np.maximum((hi - lo) / res, 1e-30).astype(np.float32)

    flo = tri.min(axis=1)
    fhi = tri.max(axis=1)
    c0 = np.clip(((flo - lo) / width).astype(np.int64), 0, res - 1)
    c1 = np.clip(((fhi - lo) / width).astype(np.int64), 0, res - 1)
    span = c1 - c0 + 1                             # (F, 3)
    per_face = span.prod(axis=1)
    total = int(per_face.sum())
    face_rep = np.repeat(np.arange(n_faces, dtype=np.int64), per_face)
    offs = np.concatenate([[0], np.cumsum(per_face)])
    local = np.arange(total, dtype=np.int64) - np.repeat(offs[:-1], per_face)
    sp = span[face_rep]
    iz = local % sp[:, 2]
    iy = (local // sp[:, 2]) % sp[:, 1]
    ix = local // (sp[:, 2] * sp[:, 1])
    cells = c0[face_rep] + np.stack([ix, iy, iz], axis=1)
    cell_id = (cells[:, 0] * res + cells[:, 1]) * res + cells[:, 2]

    ncells = res ** 3
    sort = np.argsort(cell_id, kind="stable")      # keeps face ids ascending
    cells_sorted = cell_id[sort]
    faces_sorted = face_rep[sort].astype(np.int32)
    cell_count = np.bincount(cells_sorted, minlength=ncells).astype(np.int32)
    cell_start = np.concatenate(
        [[0], np.cumsum(cell_count)]).astype(np.int32)

    if cap is None:
        occupied = cell_count[cell_count > 0]
        cap = int(np.clip(
            np.percentile(occupied, 98.0) if occupied.size else 1, 1, 64))
    cap = max(1, int(cap))
    rank = np.arange(total, dtype=np.int64) - cell_start[cells_sorted]
    keep = rank < cap
    cell_table = np.full((ncells, cap), -1, np.int32)
    cell_table[cells_sorted[keep], rank[keep]] = faces_sorted[keep]

    return AccelIndex(
        "grid", topology_digest(v, f),
        arrays={
            "cell_table": cell_table,
            "cell_count": cell_count,
            "cell_start": cell_start,
            "cell_faces": faces_sorted,
            "grid_lo": lo.astype(np.float32),
            "width": width,
            "center": center,
        },
        meta={
            "n_faces": n_faces, "res": res, "cap": cap,
            "overflow_cells": int(np.count_nonzero(cell_count > cap)),
            "scale": scale, "prune_slack": PRUNE_SLACK_REL * scale,
        },
    )


# ---------------------------------------------------------------------------
# digest-keyed process cache: one host build per mesh and parameters

_BUILD_BY_KIND = {"bvh": build_bvh, "grid": build_grid}
_CACHE = OrderedDict()
_CACHE_LOCK = threading.RLock()


def get_index(v, f, kind="bvh", **params):
    """The :class:`AccelIndex` of ``(v, f)``: from the cache when this
    mesh was built with these parameters in this process, else built on
    the host.  Thread-safe; the build runs inside the lock, so two threads
    racing on a new mesh pay one build.  ``kind`` is ``"bvh"`` or
    ``"grid"``."""
    if kind not in _BUILD_BY_KIND:
        raise ValueError("unknown accel index kind %r (have %s)"
                         % (kind, sorted(_BUILD_BY_KIND)))
    key = (topology_digest(v, f), kind, tuple(sorted(params.items())))
    with _CACHE_LOCK:
        idx = _CACHE.get(key)
        if idx is not None:
            _CACHE.move_to_end(key)
            return idx
        idx = _BUILD_BY_KIND[kind](v, f, **params)
        _CACHE[key] = idx
        while len(_CACHE) > _MAX_CACHED:
            _CACHE.popitem(last=False)
    return idx


def clear_index_cache():
    with _CACHE_LOCK:
        _CACHE.clear()


def index_cache_info():
    with _CACHE_LOCK:
        return {
            "entries": len(_CACHE),
            "keys": [k[:2] for k in _CACHE],
            "bytes": int(sum(i.nbytes() for i in _CACHE.values())),
        }
