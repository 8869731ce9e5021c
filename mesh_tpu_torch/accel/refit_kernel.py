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

Two kernels:

- ``leaf_boxes`` (``csrc/leaf_boxes.cu``): a group of threads a leaf, each
  thread loading a round of items before it folds any, then a segmented
  reduction.  An item is a 48-byte unit of four corners (three float4;
  float j of a unit is coordinate j % 3) where ``leaf_size % 4 == 0`` and
  ``tri_s`` is 16-byte aligned, else one corner; ``leaf_plan`` picks the
  item and the group, and ``leaf_boxes_schedule`` is the schedule in plain
  PyTorch.
- ``leaf_boxes_warp`` (``csrc/leaf_boxes_warp.cu``): a warp a leaf, the
  oracle that ``chip_smoke.py`` holds ``leaf_boxes`` to; no path launches
  it.

``leaf_boxes_kernel`` and ``leaf_boxes_warp_kernel`` launch their kernels
for a CUDA tensor and take the plain version (``leaf_boxes_plain``) for a
CPU tensor; ``LAUNCHES`` counts each kernel's launches.
"""

import torch

__all__ = ["LAUNCHES", "leaf_boxes_kernel", "leaf_boxes_plain",
           "leaf_boxes_schedule", "leaf_boxes_warp_kernel", "leaf_plan"]

#: launches of each kernel since the counts were last set to 0
LAUNCHES = {"leaf_boxes": 0, "leaf_boxes_warp": 0}

#: threads of a ``leaf_boxes`` block, the most a leaf's group may have
#: (csrc/leaf_boxes.cu kThreads)
BLOCK_THREADS = 256

#: items a thread loads in one round before it folds any (kItems)
ROUND_ITEMS = 3

#: corners in one 48-byte unit
UNIT_CORNERS = 4


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


def leaf_plan(tri_s, leaf_size):
    """(units, items, group) of a ``leaf_boxes`` launch on ``tri_s``:
    whether an item is a 48-byte unit of four corners (``leaf_size % 4 ==
    0`` and ``tri_s`` 16-byte aligned) or one corner, the items of a leaf,
    and the threads of a leaf's group, the least power of two whose rounds
    of ``ROUND_ITEMS`` cover the leaf in one round, at most
    ``BLOCK_THREADS``."""
    units = leaf_size % UNIT_CORNERS == 0 and tri_s.data_ptr() % 16 == 0
    items = leaf_size * 3 // UNIT_CORNERS if units else leaf_size * 3
    group = 1
    while group < BLOCK_THREADS and group * ROUND_ITEMS < items:
        group *= 2
    return units, items, group


def leaf_boxes_schedule(tri_s, n_leaves, leaf_size):
    """The ``leaf_boxes`` kernel's schedule in plain PyTorch: (lo, hi) as
    the kernel folds them.  Thread r of a leaf's group takes items r, r +
    group, ... (``leaf_plan``), in rounds of ``ROUND_ITEMS``, and folds
    float j of a unit into coordinate j % 3; the group's lanes then fold by
    xor-shuffles within their warp, and the warps of a larger group in
    order.  torch.minimum and torch.maximum keep NaN, as the kernel's
    compares do; min and max round nothing, so the boxes equal
    ``leaf_boxes_plain``'s whatever the order."""
    n_leaves, leaf_size = _check(tri_s, n_leaves, leaf_size)
    units, items, group = leaf_plan(tri_s, leaf_size)
    slots = -(-items // (group * ROUND_ITEMS)) * ROUND_ITEMS
    pad = slots * group - items
    # [leaf, item, corner, coordinate]: a unit's float j is coordinate j % 3
    corners = tri_s.reshape(n_leaves, items, -1, 3)
    boxes = []
    for fold, start in ((torch.minimum, float("inf")),
                        (torch.maximum, float("-inf"))):
        x = torch.cat([corners, corners.new_full(
            (n_leaves, pad) + corners.shape[2:], start)], dim=1)
        # item k * group + r -> thread r, in rounds of ROUND_ITEMS
        x = x.view(n_leaves, slots, group, -1, 3)
        acc = x.new_full((n_leaves, group, 3), start)
        for k in range(slots):
            for j in range(x.shape[3]):
                acc = fold(acc, x[:, k, :, j])
        lane = torch.arange(group)
        off = min(group, 32) // 2
        while off:
            acc = fold(acc, acc[:, lane ^ off])
            off //= 2
        box = acc[:, 0]
        for w in range(1, group // 32):
            box = fold(box, acc[:, 32 * w])
        boxes.append(box)
    return tuple(boxes)


def _launch(name, tri_s, n_leaves, leaf_size, *plan):
    from .. import _build

    lo = torch.empty((n_leaves, 3), dtype=torch.float32, device=tri_s.device)
    hi = torch.empty_like(lo)
    _build.launch(name, tri_s.device, tri_s, lo, hi, n_leaves, leaf_size,
                  *plan)
    LAUNCHES[name] += 1
    return lo, hi


def leaf_boxes_kernel(tri_s, n_leaves, leaf_size):
    """Leaf AABBs (lo, hi) of the Morton-ordered corner blocks of
    ``tri_s``: the ``leaf_boxes`` CUDA kernel for a CUDA tensor, its plain
    version for a CPU tensor.  ``tri_s.shape[0]`` must be ``n_leaves *
    leaf_size``; any leaf size and any float alignment of ``tri_s`` run
    the kernel (``leaf_plan``)."""
    n_leaves, leaf_size = _check(tri_s, n_leaves, leaf_size)
    if tri_s.device.type == "cpu":
        return leaf_boxes_plain(tri_s, n_leaves, leaf_size)
    tri_s = tri_s.contiguous()
    units, _, group = leaf_plan(tri_s, leaf_size)
    return _launch("leaf_boxes", tri_s, n_leaves, leaf_size, int(units),
                   group)


def leaf_boxes_warp_kernel(tri_s, n_leaves, leaf_size):
    """``leaf_boxes_kernel`` through the ``leaf_boxes_warp`` CUDA kernel,
    a warp a leaf (the oracle; no path launches it), for a CUDA tensor;
    the plain version for a CPU tensor."""
    n_leaves, leaf_size = _check(tri_s, n_leaves, leaf_size)
    if tri_s.device.type == "cpu":
        return leaf_boxes_plain(tri_s, n_leaves, leaf_size)
    return _launch("leaf_boxes_warp", tri_s.contiguous(), n_leaves,
                   leaf_size)
