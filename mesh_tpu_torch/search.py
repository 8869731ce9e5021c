"""Search-tree facades with the reference API (counterpart of
mesh_tpu/search.py), backed by the port's kernels.

The reference wraps CGAL AABB trees (mesh/search.py:19-100).  The class
names and the ``nearest(...)`` return conventions are kept, including the
reference's (1, S) row-vector index shapes, but "building the tree" only
captures the mesh on its device: every query is one brute-force or
ladder kernel call.  A tree queries on the device of the mesh it was made
from (a ``Mesh``'s own device), else on ``device``, the card by default.
"""

import numpy as np

from .query.closest_kernel import mesh_is_nondegenerate, nearest_vertices_kernel
from .query.culled import closest_faces_and_points_auto
from .query.normal_weighted import nearest_normal_weighted_kernel
from .query.ray import intersections_mask
from .query.ray_kernel import nearest_alongnormal_kernel
from .utils.device import as_tensor, resolve_device

__all__ = ["AabbTree", "AabbNormalsTree", "ClosestPointTree",
           "CGALClosestPointTree"]

_NO_HIT_SENTINEL = 1e100  # reference spatialsearchmodule.cpp:309-311


def _mesh_device(m, device):
    return resolve_device(getattr(m, "device", None) or device)


def _mesh_vf(m, device):
    """(v float32 [V, 3], f int64 [F, 3]) on ``device``: a ``Mesh``'s cached
    device copies, or a conversion of any other (v, f) holder."""
    if hasattr(m, "device_arrays"):
        return m.device_arrays()
    return (as_tensor(np.asarray(m.v, np.float32), device),
            as_tensor(np.asarray(m.f, np.int64), device))


def _points(x, device):
    return as_tensor(np.asarray(x, np.float32).reshape(-1, 3), device)


class AabbTree(object):
    """Closest-point, along-normal and mesh-vs-mesh intersection queries
    against a mesh (reference search.py:19-49)."""

    def __init__(self, m, strategy="auto", device="cuda"):
        if strategy == "anchored":
            raise NotImplementedError(
                "strategy='anchored' (closest_point_anchored_auto, "
                "query/anchored.py) is not ported yet (ROADMAP.md, Queue 1)")
        if strategy != "auto":
            raise ValueError("strategy must be 'auto' or 'anchored', got %r"
                             % (strategy,))
        self.device = _mesh_device(m, device)
        self.v, self.f = _mesh_vf(m, self.device)

    def nearest(self, v_samples, nearest_part=False):
        """Nearest face and point per query, by the auto ladder; with
        ``nearest_part``, also the part code: interior (0), edge ab/bc/ca
        (1/2/3) or vertex a/b/c (4/5/6)."""
        res = closest_faces_and_points_auto(
            self.v, self.f, np.asarray(v_samples, np.float32).reshape(-1, 3),
            device=self.device)
        f_idxs = res["face"].astype(np.uint32).reshape(1, -1)
        f_part = res["part"].astype(np.uint32).reshape(1, -1)
        v_out = res["point"].astype(np.float64)
        return (f_idxs, f_part, v_out) if nearest_part else (f_idxs, v_out)

    def nearest_alongnormal(self, points, normals):
        """(distance [Q] f64, face [Q] uint32, point [Q, 3] f64) of the
        nearest hit along +/- each normal; 1e100 where nothing is hit."""
        dist, f_idxs, v_out = nearest_alongnormal_kernel(
            self.v, self.f, _points(points, self.device),
            _points(normals, self.device))
        dist = dist.cpu().numpy().astype(np.float64)
        dist[~np.isfinite(dist)] = _NO_HIT_SENTINEL
        return (dist, f_idxs.cpu().numpy().astype(np.uint32),
                v_out.cpu().numpy().astype(np.float64))

    def intersections_indices(self, q_v, q_f):
        """Indices into ``q_f`` of the query faces that intersect the mesh
        (reference search.py:39-49): the fixed-shape mask of
        ``intersections_mask`` and a host nonzero."""
        mask = intersections_mask(self.v, self.f, np.asarray(q_v, np.float32),
                                  np.asarray(q_f, np.int32),
                                  device=self.device)
        return np.nonzero(mask.cpu().numpy())[0]


class ClosestPointTree(object):
    """Nearest-vertex queries (reference search.py:52-65, a scipy KDTree),
    one kernel call."""

    def __init__(self, m, device="cuda"):
        self.v = np.asarray(m.v)
        self.device = _mesh_device(m, device)
        self._v32 = as_tensor(self.v.astype(np.float32), self.device)

    def nearest(self, v_samples):
        """(index [Q] int32, distance [Q] f64) of the nearest vertex."""
        idx, dist = nearest_vertices_kernel(self._v32,
                                            _points(v_samples, self.device))
        return idx.cpu().numpy(), dist.cpu().numpy().astype(np.float64)

    def nearest_vertices(self, v_samples):
        return self.v[self.nearest(v_samples)[0]]


class CGALClosestPointTree(ClosestPointTree):
    """The reference builds a degenerate-triangle CGAL tree for vertex-only
    nearest neighbours (search.py:68-86); the kernel is ClosestPointTree's,
    with flat outputs."""

    def nearest(self, v_samples):
        idx, dist = ClosestPointTree.nearest(self, v_samples)
        return idx.flatten(), dist.flatten()


class AabbNormalsTree(object):
    """Normal-weighted nearest face (reference search.py:89-100; ``eps``
    weights the normal agreement term)."""

    def __init__(self, m, eps=0.1, device="cuda"):
        self.device = _mesh_device(m, device)
        self.v, self.f = _mesh_vf(m, self.device)
        self.eps = eps
        # the fast tile may drop its degenerate-face tail on this mesh
        self._nondegen = mesh_is_nondegenerate(self.v.cpu().numpy(),
                                               self.f.cpu().numpy())

    def nearest(self, v_samples, n_samples):
        """(face [Q, 1] uint32, point [Q, 3] f64) under the blended
        metric; query normals are used as given."""
        face, point = nearest_normal_weighted_kernel(
            self.v, self.f, _points(v_samples, self.device),
            _points(n_samples, self.device), eps=float(self.eps),
            assume_nondegenerate=self._nondegen)
        return (face.cpu().numpy().astype(np.uint32).reshape(-1, 1),
                point.cpu().numpy().astype(np.float64))
