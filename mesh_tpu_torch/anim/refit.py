"""Animation-rate BVH refit over the frozen rope layout (counterpart of
mesh_tpu/anim/refit.py).

``build_bvh`` (accel/build.py) Morton-sorts faces once and lays the
complete tree out in preorder with skip ropes.  For a deforming
fixed-topology mesh the sort and the layout stay *valid* frame after
frame; only the boxes go stale.  ``refit_bvh`` therefore recomputes node
AABBs bottom-up from the deformed vertices over the SAME frozen order,
preorder positions and centered build frame, and returns a new
:class:`~mesh_tpu_torch.accel.build.AccelIndex` that shares every other
array (and their device tensors), the digest and the meta of the base
index: a frame pays no host sort, digest or build.

The refit boxes are true float32 min/max bounds of the deformed triangles
(exact lattice operations), so the rope walk prunes conservatively and
stays exact; what decays is pruning efficiency.  The tracked quality bound
is the **box-inflation ratio**

    inflation = box_measure(refit boxes) / box_measure(fresh boxes)

with the reference captured at the last (re)build: refitting the build
geometry reproduces the build boxes exactly, so the ratio starts at 1.0.
Past the ``anim_refit_max_inflation`` tunable (utils/tuning.py, pinned by
``MESH_TPU_ANIM_REFIT_MAX_INFLATION``), :meth:`RefitState.advance` trips a
rebuild through the digest-keyed ``get_index`` cache and re-anchors.

``kernel="pallas"`` (the reference's name for its on-device kernel, and
the port's default) gathers the frozen-order corners where the vertices
are and computes the leaf boxes with the ``leaf_boxes`` CUDA kernel
(accel/refit_kernel.py) on the card, its plain version on the CPU.
``kernel="host"`` is the numpy twin, asked for by name.  Both kernels give the host's boxes exactly;
the level reduction, the preorder scatter and ``box_measure`` then run in
numpy, as in the reference, on one host copy of the leaf boxes: the one
host sync a frame needs for its refit/rebuild decision.
"""

import threading

import numpy as np
import torch

from ..accel.build import AccelIndex, get_index
from ..accel.refit_kernel import leaf_boxes_kernel
from ..obs.metrics import REGISTRY
from ..utils.device import as_tensor, host_array, resolve_device

__all__ = [
    "RefitState", "box_measure", "refit_bvh", "refit_leaf_boxes",
    "refit_max_inflation",
]

#: the leaf-box routes of ``refit_bvh`` (the reference's names)
KERNELS = ("host", "pallas")

#: the arrays a refit index shares with its base
_FROZEN = ("order", "node_skip", "node_leaf", "center")


def _metrics():
    return {
        "refits": REGISTRY.counter(
            "mesh_tpu_anim_refits_total",
            "Frames answered by a frozen-order BVH refit (no host "
            "rebuild)."),
        "rebuilds": REGISTRY.counter(
            "mesh_tpu_anim_rebuilds_total",
            "Refit frames that tripped a full rebuild through the "
            "digest cache (label: reason — inflation)."),
        "inflation": REGISTRY.gauge(
            "mesh_tpu_anim_inflation_ratio",
            "Latest refit-vs-rebuild box-inflation ratio (1.0 = "
            "fresh-build quality)."),
    }


def refit_max_inflation():
    """The effective refit/rebuild crossover: the box-inflation ratio
    past which :meth:`RefitState.advance` trips a rebuild (the
    ``anim_refit_max_inflation`` tunable, or its env pin)."""
    from ..utils import tuning

    return float(tuning.get("anim_refit_max_inflation"))


def refit_leaf_boxes(tri_s, n_leaves, leaf_size):
    """Per-leaf AABBs of the Morton-ordered corner blocks: the numpy twin
    of the ``leaf_boxes`` kernel, and ``build_bvh``'s leaf stage over a
    frozen order."""
    blocks = np.asarray(tri_s, np.float32).reshape(
        n_leaves, leaf_size * 3, 3)
    return blocks.min(axis=1), blocks.max(axis=1)


def _level_boxes(lo_leaf, hi_leaf):
    """Internal levels bottom-up by pairwise min/max, ``build_bvh``'s
    reduction started from refit leaves."""
    lo_levels = [np.asarray(lo_leaf, np.float32)]
    hi_levels = [np.asarray(hi_leaf, np.float32)]
    while lo_levels[-1].shape[0] > 1:
        lo_levels.append(
            np.minimum(lo_levels[-1][0::2], lo_levels[-1][1::2]))
        hi_levels.append(
            np.maximum(hi_levels[-1][0::2], hi_levels[-1][1::2]))
    lo_levels.reverse()
    hi_levels.reverse()
    return lo_levels, hi_levels


def _preorder_positions(depth):
    """``build_bvh``'s level-by-level preorder scatter positions (pre(left)
    = pre(parent) + 1, pre(right) = pre(left) + subtree): layout identity
    is what lets refit boxes drop into the frozen skip/leaf arrays."""
    positions = []
    pre = np.zeros(1, np.int64)
    for level in range(depth + 1):
        positions.append(pre)
        if level == depth:
            break
        subtree = (1 << (depth - level)) - 1
        pre_l = pre + 1
        pre_r = pre_l + subtree
        pre = np.stack([pre_l, pre_r], axis=1).reshape(-1)
    return positions


def box_measure(node_lo, node_hi):
    """Summed surface area of every node box (float64): the scalar the
    inflation ratio compares (the SAH quality functional)."""
    ext = np.maximum(
        np.asarray(node_hi, np.float64) - np.asarray(node_lo, np.float64),
        0.0)
    return float(2.0 * np.sum(
        ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2]
        + ext[:, 0] * ext[:, 2]))


def _leaf_boxes(index, v, f, kernel, dev):
    """Leaf (lo, hi) numpy arrays of ``index``'s layout over vertices
    ``v``, through the route ``kernel``."""
    meta = index.meta
    n_leaves, leaf_size = int(meta["n_leaves"]), int(meta["leaf_size"])
    if kernel == "host":
        arr = index.arrays
        vc = host_array(v, np.float32) - np.asarray(arr["center"], np.float32)
        tri_s = vc[host_array(f, np.int32)][np.asarray(arr["order"])]
        return refit_leaf_boxes(tri_s, n_leaves, leaf_size)
    arr = index.on(dev)
    vc = as_tensor(v, dev, torch.float32) - arr["center"]
    f_t = as_tensor(f if torch.is_tensor(f) else host_array(f, np.int64), dev)
    tri_s = vc[f_t.long()[arr["order"].long()]]      # [Fp, 3, 3], frozen
    lo, hi = leaf_boxes_kernel(tri_s, n_leaves, leaf_size)
    return lo.cpu().numpy(), hi.cpu().numpy()


def refit_bvh(index, v, f, kernel="pallas", device="cuda"):
    """Refit ``index`` (a ``kind="bvh"`` :class:`AccelIndex`) to the
    deformed vertices ``v`` (array or tensor) over the same faces ``f``.

    Returns ``(refit_index, info)``.  The refit index shares the frozen
    ``order`` / ``node_skip`` / ``node_leaf`` / ``center`` arrays and
    their device tensors, the digest and the meta of ``index``; only
    ``node_lo`` / ``node_hi`` are fresh (and, with ``kernel="pallas"``,
    already on ``device``).  The centered frame is the FROZEN one, so
    boxes, queries and prune slack stay in one coordinate system.
    ``info["box_measure"]`` feeds the caller's inflation tracking.

    :param kernel: ``"pallas"`` (default: the ``leaf_boxes`` kernel on
        ``device``, CUDA on the card, its plain version on the CPU) or
        ``"host"`` (numpy); both give the same boxes.
    """
    if index.kind != "bvh":
        raise ValueError("refit_bvh needs a bvh index, got %r" % index.kind)
    if kernel not in KERNELS:
        raise ValueError("unknown refit kernel %r (host|pallas)" % kernel)
    dev = resolve_device(device)
    meta = index.meta
    lo_leaf, hi_leaf = _leaf_boxes(index, v, f, kernel, dev)
    lo_levels, hi_levels = _level_boxes(lo_leaf, hi_leaf)
    n_nodes = int(meta["n_nodes"])
    node_lo = np.empty((n_nodes, 3), np.float32)
    node_hi = np.empty((n_nodes, 3), np.float32)
    for level, pre in enumerate(_preorder_positions(int(meta["depth"]))):
        node_lo[pre] = lo_levels[level]
        node_hi[pre] = hi_levels[level]

    tensors = index.uploaded(_FROZEN)
    if kernel == "pallas":
        tensors.setdefault(str(dev), {}).update(
            node_lo=torch.as_tensor(node_lo, device=dev),
            node_hi=torch.as_tensor(node_hi, device=dev))
    arr = index.arrays
    refit = AccelIndex(
        index.kind, index.digest,
        arrays=dict({name: arr[name] for name in _FROZEN},
                    node_lo=node_lo, node_hi=node_hi),
        meta=dict(meta), tensors=tensors)
    return refit, {"box_measure": box_measure(node_lo, node_hi)}


class RefitState(object):
    """Per-session refit bookkeeping: the live index, the fresh-build
    reference measure, and the tracked inflation ratio.

    :meth:`advance` is the one per-frame entry point: refit to the new
    vertices, compare against the reference captured at the last
    (re)build, and, past :func:`refit_max_inflation`, trip a rebuild
    through the digest-keyed ``get_index`` cache instead.  Thread-safe
    under its own lock (a session serializes frames anyway; the lock
    covers concurrent stat readers)."""

    def __init__(self, index, f, kernel="pallas", device="cuda"):
        if kernel not in KERNELS:
            raise ValueError("unknown refit kernel %r (host|pallas)" % kernel)
        self._lock = threading.Lock()
        self.device = resolve_device(device)
        self.index = index
        self.f = host_array(f, np.int32)
        # the faces where the refit gathers: on the device for "pallas"
        # (uploaded once), numpy for "host"
        self._f_refit = (as_tensor(self.f.astype(np.int64), self.device)
                         if kernel == "pallas" else self.f)
        self.kernel = kernel
        self.leaf_size = int(index.meta["leaf_size"])
        self.ref_measure = max(
            box_measure(index.arrays["node_lo"], index.arrays["node_hi"]),
            1e-30)
        self.inflation = 1.0
        self.refits = 0
        self.rebuilds = 0

    def advance(self, v_new, max_inflation=None):
        """Move the state to the deformed vertices ``v_new`` (array or
        tensor); returns ``(index, action)`` with ``action`` in
        ``("refit", "rebuild")``.  A rebuild resets the inflation
        reference to the fresh boxes."""
        if max_inflation is None:
            max_inflation = refit_max_inflation()
        metrics = _metrics()
        with self._lock:
            base = self.index
            ref_measure = self.ref_measure
        # the refit, and on a trip the host rebuild, run OUTSIDE the lock:
        # a session serializes its frames, so `base` cannot change under
        # us, and stat readers never block behind a build
        refit, info = refit_bvh(base, v_new, self._f_refit,
                                kernel=self.kernel, device=self.device)
        inflation = info["box_measure"] / ref_measure
        if inflation > max_inflation:
            rebuilt = get_index(host_array(v_new, np.float32), self.f,
                                kind="bvh", leaf_size=self.leaf_size)
            measure = max(box_measure(
                rebuilt.arrays["node_lo"],
                rebuilt.arrays["node_hi"]), 1e-30)
            with self._lock:
                self.index = rebuilt
                self.ref_measure = measure
                self.inflation = 1.0
                self.rebuilds += 1
            metrics["rebuilds"].inc(reason="inflation")
            metrics["inflation"].set(1.0)
            return rebuilt, "rebuild"
        with self._lock:
            self.index = refit
            self.inflation = float(inflation)
            self.refits += 1
        metrics["refits"].inc()
        metrics["inflation"].set(float(inflation))
        return refit, "refit"

    def stats(self):
        with self._lock:
            return {
                "refits": self.refits,
                "rebuilds": self.rebuilds,
                "inflation": self.inflation,
                "ref_measure": self.ref_measure,
            }
