"""Triangle mesh facade, the subset on the closest-point, visibility and
search-tree paths (counterpart of mesh_tpu/mesh.py ``Mesh``).

Numpy goes in and out with ``mesh_tpu.Mesh``'s dtypes and shapes: ``v``
[V, 3] float64, ``f`` [F, 3] uint32, faces of a query [1, Q] uint32 and its
points [Q, 3] float64.  The device is chosen when the mesh is made and
defaults to the card.
"""

import zlib

import numpy as np
import torch

from .batch import fused_normals_and_closest_points
from .geometry.vert_normals import vert_normals_t
from .query.closest_kernel import nearest_vertices_kernel
from .query.culled import closest_faces_and_points_auto
from .query.visibility import visibility_compute
from .search import (
    AabbNormalsTree,
    AabbTree,
    CGALClosestPointTree,
    ClosestPointTree,
)
from .utils.device import resolve_device


class Mesh(object):
    """Triangle mesh: ``v`` ([V, 3] float64 positions) and ``f`` ([F, 3]
    uint32 triangles), queried on ``device``."""

    def __init__(self, v=None, f=None, device="cuda"):
        self.device = resolve_device(device)
        if v is not None:
            self.v = np.array(v, dtype=np.float64)  # copy: callers may mutate
        if f is not None:
            self.f = np.asarray(f, dtype=np.uint32)

    def device_arrays(self):
        """(v float32 [V, 3], f int64 [F, 3]) on the mesh's device, cached
        across facade calls and checked by a crc32 of the current v/f
        buffers, so reassignment and in-place edits both invalidate it."""
        v = np.ascontiguousarray(self.v)
        f = np.ascontiguousarray(self.f)
        key = (zlib.crc32(v.tobytes()), zlib.crc32(f.tobytes()),
               v.shape, f.shape)
        cached = getattr(self, "_device_cache", None)
        if cached is None or cached[0] != key:
            self._device_cache = (
                key,
                torch.as_tensor(v.astype(np.float32), device=self.device),
                torch.as_tensor(f.astype(np.int64), device=self.device),
            )
        return self._device_cache[1], self._device_cache[2]

    def estimate_vertex_normals(self):
        """Area-weighted unit vertex normals, [V, 3] float64."""
        vt, ft = self.device_arrays()
        return vert_normals_t(vt, ft).cpu().numpy().astype(np.float64)

    def closest_faces_and_points(self, vertices):
        """Nearest face and point per query (reference AabbTree.nearest
        convention): (faces [1, Q] uint32, points [Q, 3] float64)."""
        vt, ft = self.device_arrays()
        res = closest_faces_and_points_auto(
            vt, ft, np.asarray(vertices, np.float32).reshape(-1, 3),
            device=self.device)
        return (res["face"].astype(np.uint32).reshape(1, -1),
                res["point"].astype(np.float64))

    def closest_points(self, vertices):
        return self.closest_faces_and_points(vertices)[1]

    def closest_vertices(self, vertices):
        """Nearest vertex per query (reference ClosestPointTree.nearest):
        (indices [Q] int32, distances [Q] float64)."""
        vt, _ = self.device_arrays()
        pts = torch.as_tensor(
            np.asarray(vertices, np.float32).reshape(-1, 3),
            device=self.device)
        idx, dist = nearest_vertices_kernel(vt, pts)
        return idx.cpu().numpy(), dist.cpu().numpy().astype(np.float64)

    def normals_and_closest_points(self, vertices):
        """estimate_vertex_normals + closest_faces_and_points in one step:
        (normals [V, 3] f64, faces [1, Q] uint32, points [Q, 3] f64)."""
        return fused_normals_and_closest_points(self, vertices,
                                                device=self.device)

    # ------------------------------------------------------------------
    # Visibility

    def vertex_visibility(self, camera, normal_threshold=None,
                          omni_directional_camera=False,
                          binary_visiblity=True):
        """Per-vertex visibility from ``camera``; optionally gated on the
        normal-to-camera dot product.  ``binary_visiblity`` keeps the
        reference's spelling (mesh.py:282); when False the visibility is
        weighted by n.dir."""
        vis, n_dot_cam = self.vertex_visibility_and_normals(
            camera, omni_directional_camera)
        if normal_threshold is not None:
            vis = vis.astype(bool) & (n_dot_cam > normal_threshold)
        return np.squeeze(vis if binary_visiblity else vis * n_dot_cam)

    def vertex_visibility_and_normals(self, camera,
                                      omni_directional_camera=False):
        """(visibility [1, V] uint32, n_dot_cam [1, V] float64) from a
        camera object (``origin`` and, unless omnidirectional,
        ``sensor_axis``) or a bare position (omnidirectional)."""
        if hasattr(camera, "origin"):
            origin = np.asarray(camera.origin).flatten()
        else:
            origin = np.asarray(camera, dtype=np.float64).flatten()
            omni_directional_camera = True
        sensors = None
        if not omni_directional_camera:
            sensors = np.array([np.asarray(camera.sensor_axis).flatten()])
        n = getattr(self, "vn", None)
        if n is None:
            n = self.estimate_vertex_normals()
        return visibility_compute(self.v, self.f, np.array([origin]), n=n,
                                  sensors=sensors, device=self.device)

    def visible_mesh(self, camera=[0.0, 0.0, 0.0]):
        """Submesh of the vertices visible from ``camera``; a face survives
        only if all three corners are visible (reference mesh.py:330-342,
        spelled ``visibile_mesh`` there: kept below as an alias)."""
        vis = np.asarray(self.vertex_visibility(camera)).astype(bool).ravel()
        f = self.f.astype(np.int64)
        surviving = f[vis[f].all(axis=1)]
        renumber = np.cumsum(vis) - 1      # old id -> new id where visible
        return Mesh(v=self.v[vis], f=renumber[surviving], device=self.device)

    #: the reference's spelling
    visibile_mesh = visible_mesh

    # ------------------------------------------------------------------
    # Search trees (reference mesh.py:439-455)

    def compute_aabb_tree(self, strategy="auto"):
        return AabbTree(self, strategy=strategy)

    def compute_aabb_normals_tree(self):
        return AabbNormalsTree(self)

    def compute_closest_point_tree(self, use_cgal=False):
        return (CGALClosestPointTree(self) if use_cgal
                else ClosestPointTree(self))
