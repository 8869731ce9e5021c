"""Per-leaf AABBs of the BVH refit: the ``leaf_boxes`` CUDA kernel's
wrapper and its plain PyTorch version (counterpart of
mesh_tpu/accel/pallas_refit.py).

The animated-mesh refit (``anim/refit.py``) recomputes node boxes each
frame over the frozen Morton order of an index.  Its one O(F) stage is the
leaf box pass: min and max of each coordinate over every leaf's
``leaf_size * 3`` corners of ``tri_s``, the ``[Fp, 3, 3]`` float32 triangle
array in the index's centered frame and Morton order (``Fp = n_leaves *
leaf_size``).  min and max round nothing, so kernel, plain version and the
numpy twin ``anim.refit.refit_leaf_boxes`` give equal boxes; a leaf with a
NaN corner gets a NaN box in all three.

``leaf_boxes_kernel`` launches the kernel for a CUDA tensor and takes the
plain version (``leaf_boxes_plain``) for a CPU tensor; ``LAUNCHES`` counts
the kernel's launches.
"""

import torch

__all__ = ["LAUNCHES", "leaf_boxes_kernel", "leaf_boxes_plain"]

#: launches of the kernel since the count was last set to 0
LAUNCHES = {"leaf_boxes": 0}


def _check(tri_s, n_leaves, leaf_size):
    """(n_leaves, leaf_size) as ints, after checking ``tri_s`` against the
    layout: the reference's face-count error, then dtype and shape."""
    n_leaves, leaf_size = int(n_leaves), int(leaf_size)
    if tri_s.shape[0] != n_leaves * leaf_size:
        raise ValueError(
            "tri_s has %d faces, layout says %d leaves x %d"
            % (tri_s.shape[0], n_leaves, leaf_size))
    if tri_s.dtype != torch.float32 or tuple(tri_s.shape[1:]) != (3, 3):
        raise ValueError("leaf_boxes wants float32 tri_s [Fp, 3, 3], got %s "
                         "%s" % (tri_s.dtype, tuple(tri_s.shape)))
    if tri_s.device.type not in ("cpu", "cuda"):
        raise ValueError("leaf_boxes: no kernel for device %s"
                         % tri_s.device)
    return n_leaves, leaf_size


def leaf_boxes_plain(tri_s, n_leaves, leaf_size):
    """Plain PyTorch version of the ``leaf_boxes`` kernel: (lo, hi), each
    [n_leaves, 3] float32, the min and max over each leaf's corners."""
    n_leaves, leaf_size = _check(tri_s, n_leaves, leaf_size)
    blocks = tri_s.reshape(n_leaves, leaf_size * 3, 3)
    return blocks.amin(dim=1), blocks.amax(dim=1)


def leaf_boxes_kernel(tri_s, n_leaves, leaf_size):
    """Leaf AABBs (lo, hi) of the Morton-ordered corner blocks of
    ``tri_s``: the ``leaf_boxes`` CUDA kernel for a CUDA tensor, its plain
    version for a CPU tensor.  ``tri_s.shape[0]`` must be ``n_leaves *
    leaf_size``."""
    n_leaves, leaf_size = _check(tri_s, n_leaves, leaf_size)
    if tri_s.device.type == "cpu":
        return leaf_boxes_plain(tri_s, n_leaves, leaf_size)
    from .. import _build

    tri_s = tri_s.contiguous()
    lo = torch.empty((n_leaves, 3), dtype=torch.float32, device=tri_s.device)
    hi = torch.empty_like(lo)
    _build.launch("leaf_boxes", tri_s.device, tri_s, lo, hi, n_leaves,
                  leaf_size)
    LAUNCHES["leaf_boxes"] += 1
    return lo, hi
