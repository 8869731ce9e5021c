"""Host-side (numpy) construction of the flattened BVH the rope kernels
walk: a copy of the BVH half of mesh_tpu/accel/build.py.

Faces are Morton-sorted by centroid and grouped into contiguous
``leaf_size`` blocks; a complete binary tree over the (power-of-two
padded) blocks is laid out in DFS *preorder* with a ``skip`` ("rope")
pointer per node.  Traversal is stackless: descending into a surviving
node is ``node + 1``; pruning a node, or finishing a leaf, is
``node = skip[node]``; ``skip == n_nodes`` is the exit sentinel.

Boxes are built from float32 data in a mesh-centered frame whose center is
numpy's float32 mean (``arrays["center"]``); the rope kernels query in
that same frame.  The arrays are bit-equal to the reference builder's.
``get_index`` keeps the last 8 indexes built in this process, keyed by a
digest of the vertex and face bytes and the build parameters.
"""

import threading
import zlib
from collections import OrderedDict

import numpy as np
import torch

__all__ = [
    "AccelIndex", "topology_digest", "build_bvh", "get_index",
    "clear_index_cache", "index_cache_info", "DEFAULT_LEAF_SIZE",
]

#: faces per BVH leaf block (a leaf visit tests exactly this many pairs)
DEFAULT_LEAF_SIZE = 8

#: scene-relative pruning slack (fraction of max |v - center|)
PRUNE_SLACK_REL = 1e-4

#: keep at most this many built indexes per process
_MAX_CACHED = 8


class AccelIndex(object):
    """Frozen spatial index: numpy ``arrays`` plus ``kind``, ``digest``
    and ``meta``.  ``on(device)`` gives the arrays as tensors on a device,
    uploaded once per device."""

    __slots__ = ("kind", "digest", "arrays", "meta", "_tensors")

    def __init__(self, kind, digest, arrays, meta):
        object.__setattr__(self, "kind", str(kind))
        object.__setattr__(self, "digest", str(digest))
        object.__setattr__(self, "arrays", dict(arrays))
        object.__setattr__(self, "meta", dict(meta))
        object.__setattr__(self, "_tensors", {})

    def __setattr__(self, name, value):
        raise AttributeError("AccelIndex is frozen")

    def __getitem__(self, name):
        return self.arrays[name]

    def on(self, device):
        """{name: tensor} of the arrays on ``device`` (a torch.device)."""
        key = str(device)
        with _CACHE_LOCK:
            tensors = self._tensors.get(key)
            if tensors is None:
                tensors = self._tensors[key] = {
                    name: torch.as_tensor(arr, device=device)
                    for name, arr in self.arrays.items()}
        return tensors

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


# ---------------------------------------------------------------------------
# digest-keyed process cache: one host build per mesh and parameters

_BUILDERS = {"bvh": build_bvh}
_CACHE = OrderedDict()
_CACHE_LOCK = threading.RLock()


def get_index(v, f, kind="bvh", **params):
    """The :class:`AccelIndex` of ``(v, f)``: from the cache when this
    mesh was built with these parameters in this process, else built on
    the host.  Thread-safe; the build runs inside the lock, so two threads
    racing on a new mesh pay one build.  Only ``kind="bvh"`` exists in
    the port."""
    if kind not in _BUILDERS:
        raise ValueError("unknown accel index kind %r (have %s)"
                         % (kind, sorted(_BUILDERS)))
    key = (topology_digest(v, f), kind, tuple(sorted(params.items())))
    with _CACHE_LOCK:
        idx = _CACHE.get(key)
        if idx is not None:
            _CACHE.move_to_end(key)
            return idx
        idx = _BUILDERS[kind](v, f, **params)
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
