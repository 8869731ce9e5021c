"""The Mesh facade: a reference-compatible triangle mesh object
(counterpart of mesh_tpu/mesh.py ``Mesh``).

The reference's constructor keywords and methods, delegating to the port's
domain modules as the reference delegates (``processing``, ``landmarks``,
``texture``, ``serialization``, ``topology``, ``metrics``), and to the
port's kernels for the device work (closest faces and vertices, vertex
normals, visibility).  Host-side attributes (``v``, ``f``, ``vn``, ...) are
numpy arrays with the reference's dtypes and shapes, so the in-place
editing idioms of psbody users keep working: ``v`` [V, 3] float64, ``f``
[F, 3] uint32, faces of a query [1, Q] uint32 and its points [Q, 3]
float64.  The device is chosen when the mesh is made (keyword-only
``device``, the card by default), and every mesh derived from this one
(subdivided, simplified, uniquified, visible part, landmark markers,
texture templates) is made on the same device.

Not ported yet (each raises ``NotImplementedError``): ``show`` (the viewer)
and ``write_store`` / ``load_from_store`` (the content-addressed store).
"""

import os
import zlib

import numpy as np
import torch

from . import colors, landmarks, processing, texture
from .batch import fused_normals_and_closest_points
from .core import MeshArrays
from .geometry.barycentric import barycentric_coordinates_of_projection
from .geometry.vert_normals import vert_normals_t
from .obs.trace import span as obs_span
from .query.closest_point import closest_vertices_with_distance
from .query.visibility import visibility_compute
from .search import (
    AabbNormalsTree,
    AabbTree,
    CGALClosestPointTree,
    ClosestPointTree,
)
from .serialization import serialization
from .utils.device import resolve_device

__all__ = ["Mesh"]


def _not_ported(what, reference, item):
    return NotImplementedError(
        "%s: %s (%s) is not ported yet (ROADMAP.md, Queue 1)"
        % (what, reference, item))


class Mesh(object):
    """Triangle mesh with the reference package's attribute conventions.

    Core data: ``v`` ([V, 3] float64 vertex positions) and ``f`` ([F, 3]
    uint32 triangles).  Optional per-element data uses the reference's
    names: ``vn``/``fn`` normals, ``vc``/``fc`` colors, ``vt``/``ft``
    texture coordinates, ``segm`` (part name -> triangle index list) and
    ``landm``/``landm_regressors`` landmarks.  Queries run on ``device``.
    """

    def __init__(self, v=None, f=None, segm=None, filename=None,
                 ppfilename=None, lmrkfilename=None, basename=None,
                 vc=None, fc=None, vscale=None, landmarks=None, *,
                 device="cuda"):
        self.device = resolve_device(device)
        if filename is not None:
            self.load_from_file(filename)
            self.filename = filename
        if v is not None:
            self.v = np.array(v)           # copy: callers may mutate mesh.v
        if f is not None:
            self.f = f
        # whatever source supplied the geometry, coerce to the reference's
        # canonical dtypes (mesh.py:68-70): f64 positions, u32 faces
        if hasattr(self, "v"):
            self.v = np.asarray(self.v, dtype=np.float64)
            if vscale is not None:
                self.v = self.v * vscale
        if hasattr(self, "f"):
            self.f = np.asarray(self.f, dtype=np.uint32)

        if basename is not None:
            self.basename = basename
        elif getattr(self, "basename", None):
            pass                        # a loader set it (e.g. JSON 'name')
        elif filename is not None:
            base = os.path.basename(filename)
            self.basename = os.path.splitext(base)[0]
        else:
            self.basename = None

        if segm is not None:
            self.segm = segm
        for source, setter in (
            (landmarks, self.set_landmark_indices_from_any),
            (ppfilename, self.set_landmark_indices_from_ppfile),
            (lmrkfilename, self.set_landmark_indices_from_lmrkfile),
            (vc, self.set_vertex_colors),
            (fc, self.set_face_colors),
        ):
            if source is not None:
                setter(source)

    # ------------------------------------------------------------------
    # Device export

    def device_arrays(self):
        """(v float32 [V, 3], f int64 [F, 3]) on the mesh's device, cached
        across facade calls and checked by a crc32 of the current v/f
        buffers, so reassignment and in-place edits both invalidate it."""
        v = np.ascontiguousarray(self.v)
        f = np.ascontiguousarray(self.f)   # AttributeError for face-less
                                           # meshes, as in the reference
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

    def arrays(self, dtype=None):
        """Export to a ``MeshArrays`` on the mesh's device (float32 unless
        ``dtype`` says otherwise)."""
        return MeshArrays.create(
            self.v, getattr(self, "f", np.zeros((0, 3), np.int64)),
            vn=getattr(self, "vn", None), vc=getattr(self, "vc", None),
            vt=getattr(self, "vt", None), ft=getattr(self, "ft", None),
            dtype=dtype or torch.float32, device=self.device,
        )

    # ------------------------------------------------------------------
    # Visualization helpers

    def edges_as_lines(self, copy_vertices=False):
        """Wireframe Lines primitive: each face contributes its three
        directed edges (v0-v1, v1-v2, v2-v0)."""
        from .lines import Lines

        f = self.f.astype(np.int64)
        edges = np.stack([f, np.roll(f, -1, axis=1)], axis=2).reshape(-1, 2)
        return Lines(v=self.v.copy() if copy_vertices else self.v, e=edges)

    def show(self, mv=None, meshes=[], lines=[]):
        """Display this mesh in a viewer window (reference mesh.py:98-128):
        the viewer is not ported yet."""
        raise _not_ported("Mesh.show", "mesh_tpu.mesh.Mesh.show",
                          "the viewer, mesh_tpu/viewer")

    def _landmark_marker_meshes(self):
        """Small blue sphere meshes marking each raw landmark position,
        scaled to ~1% of this mesh's coordinate extent."""
        if not hasattr(self, "landm"):
            return []
        from .sphere import Sphere

        proto = Sphere(np.zeros(3), 1.0).to_mesh(device=self.device)
        radius = 0.01 * np.ptp(self.v) / np.ptp(proto.v)
        markers = []
        for name in self.landm:
            center = np.asarray(self.landm_raw_xyz[name],
                                np.float64).reshape(1, 3)
            markers.append(Mesh(v=proto.v * radius + center, f=proto.f,
                                vc="SteelBlue", device=self.device))
        return markers

    # ------------------------------------------------------------------
    # Colors

    def colors_like(self, color, arr=None):
        """Expand `color` into one rgb row per row of `arr` (default: per
        vertex).  Accepts a color name, an rgb triple, an (N,3) array, or N
        scalar weights (mapped through the jet colormap) — reference
        mesh.py:129-145 semantics."""
        reference = self.v if arr is None else np.asarray(arr)
        n_rows = (
            reference.shape[0]
            if reference.ndim == 2 and reference.shape[1] == 3
            else reference.size // 3
        )
        return colors.expand_colors(color, n_rows)

    def set_vertex_colors(self, vc, vertex_indices=None):
        if vertex_indices is None:
            self.vc = colors.expand_colors(vc, len(self.v))
        else:
            # size by the actual selection so boolean masks work too
            n_selected = len(self.v[vertex_indices])
            self.vc[vertex_indices] = colors.expand_colors(vc, n_selected)
        return self

    def set_vertex_colors_from_weights(self, weights, scale_to_range_1=True,
                                       color=True):
        """Per-vertex scalar weights -> vertex colors, through matplotlib's
        jet colormap (``colors.cm_jet``, its lookup table rebuilt without
        matplotlib) when ``color``, else as gray levels."""
        if weights is None:
            return self
        w = np.asarray(weights, dtype=np.float64)
        if scale_to_range_1:
            w = w - w.min()
            w = w / w.max()
        if color:
            self.vc = colors.cm_jet(w)[:, :3]
        else:
            self.vc = np.repeat(w[:, None], 3, axis=1)
        return self

    def scale_vertex_colors(self, weights, w_min=0.0, w_max=1.0):
        """Darken existing vertex colors by per-vertex weights rescaled into
        [w_min, w_max]."""
        if weights is None:
            return self
        w = np.asarray(weights, dtype=np.float64)
        w = w - w.min()
        w = w_min + (w_max - w_min) * (w / w.max())
        self.vc = self.vc * w[:, None]
        return self

    def set_face_colors(self, fc):
        self.fc = colors.expand_colors(fc, len(self.f))
        return self

    # ------------------------------------------------------------------
    # Geometry

    def faces_by_vertex(self, as_sparse_matrix=False):
        """Faces touching each vertex: list-of-lists, or the (V, F)
        incidence matrix in CSR form (reference mesh.py:193-206)."""
        import scipy.sparse as sp

        nv, nf = len(self.v), len(self.f)
        vert_ids = self.f.astype(np.int64).ravel()       # 3F corner vertices
        face_ids = np.repeat(np.arange(nf), 3)           # their face indices
        if as_sparse_matrix:
            return sp.csr_matrix(
                (np.ones(vert_ids.size), (vert_ids, face_ids)),
                shape=(nv, nf))
        incident = [[] for _ in range(nv)]
        for vid, fid in zip(vert_ids.tolist(), face_ids.tolist()):
            incident[vid].append(fid)
        return incident

    def estimate_vertex_normals(self, face_to_verts_sparse_matrix=None):
        """Area-weighted unit vertex normals, [V, 3] float64, on the mesh's
        device (reference mesh.py:208-216).  ``face_to_verts_sparse_matrix``
        is accepted for the reference's signature and, as there, not needed:
        the normals are summed over a vertex-to-face table built once per
        topology."""
        with obs_span("facade.estimate_vertex_normals",
                      v=int(self.v.shape[0])):
            vt, ft = self.device_arrays()
            return vert_normals_t(vt, ft).cpu().numpy().astype(np.float64)

    def barycentric_coordinates_for_points(self, points, face_indices):
        """(corner vertex ids, barycentric coeffs) of each point projected
        onto its given face (reference mesh.py:218-222); the coefficients
        are float32, computed on the mesh's device, as the reference
        computes them in float32."""
        corners = self.f[np.asarray(face_indices).ravel()]
        a, b, c = (self.v[corners[:, k].astype(np.int64)] for k in range(3))
        f32 = np.float32
        coeffs = barycentric_coordinates_of_projection(
            np.asarray(points, np.float64).astype(f32), a.astype(f32),
            (b - a).astype(f32), (c - a).astype(f32), device=self.device)
        return corners, coeffs.cpu().numpy()

    # ------------------------------------------------------------------
    # Segmentation

    def transfer_segm(self, mesh, exclude_empty_parts=True):
        """Adopt `mesh`'s segmentation: each of our faces joins the part of
        the donor face nearest its centroid (reference mesh.py:224-237)."""
        self.segm = {}
        if not hasattr(mesh, "segm"):
            return
        centroids = self.v[self.f.astype(np.int64)].mean(axis=1)
        donor_faces = np.asarray(
            mesh.closest_faces_and_points(centroids)[0]).ravel()
        donor_part_of = mesh.parts_by_face()
        grouped = {part: [] for part in mesh.segm}
        for our_face, donor_face in enumerate(donor_faces):
            part = donor_part_of[donor_face]
            if part:        # donor faces outside any part contribute nothing
                grouped[part].append(our_face)
        # enumeration order keeps each list sorted already
        self.segm = {
            part: members for part, members in grouped.items()
            if members or not exclude_empty_parts
        }

    @property
    def verts_by_segm(self):
        """Part name -> sorted unique vertex ids used by that part's faces."""
        f = self.f.astype(np.int64)
        return {
            part: np.unique(f[np.asarray(faces, np.int64)]).tolist()
            for part, faces in self.segm.items()
        }

    def parts_by_face(self):
        """Per-face part name ('' where unsegmented)."""
        names = np.full(len(self.f), "", dtype=object)
        for part, faces in self.segm.items():
            names[np.asarray(faces, np.int64)] = part
        return names.tolist()

    def verts_in_common(self, segments):
        """Vertex indices shared by every named segment."""
        by_segm = self.verts_by_segm
        return sorted(set.intersection(*(set(by_segm[s]) for s in segments)))

    # ------------------------------------------------------------------
    # Joints

    @property
    def joint_names(self):
        return self.joint_regressors.keys()

    @property
    def joint_xyz(self):
        """Regress each named joint from its vertex ring:
        offset + coeff @ v[ring] (reference mesh.py:265-271)."""
        return {
            name: np.asarray(reg["offset"], np.float64)
            + np.asarray(reg["coeff"], np.float64)
            @ self.v[np.asarray(reg["v_indices"], np.int64)]
            for name, reg in self.joint_regressors.items()
        }

    def set_joints(self, joint_names, vertex_indices):
        """Define joints as uniform averages over vertex rings
        (reference mesh.py:275-280)."""
        self.joint_regressors = {
            name: {
                "v_indices": ring,
                "coeff": np.full(len(ring), 1.0 / len(ring)),
                "offset": np.zeros(3),
            }
            for name, ring in zip(joint_names, vertex_indices)
        }

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

    def estimate_circumference(self, plane_normal, plane_distance,
                               partNamesAllowed=None, want_edges=False):
        """Length of the plane/mesh cross-section (``metrics.circumference``;
        the reference stubs this out, mesh.py:313-314)."""
        from . import metrics

        return metrics.circumference(
            self, plane_normal, plane_distance,
            part_names_allowed=partNamesAllowed, want_edges=want_edges,
        )

    # ------------------------------------------------------------------
    # Processing (delegates, reference mesh.py:318-366)

    def reset_normals(self, face_to_verts_sparse_matrix=None,
                      reset_face_normals=False):
        return processing.reset_normals(
            self, face_to_verts_sparse_matrix, reset_face_normals)

    def reset_face_normals(self):
        return processing.reset_face_normals(self)

    def uniquified_mesh(self):
        return processing.uniquified_mesh(self)

    def keep_vertices(self, keep_list):
        return processing.keep_vertices(self, keep_list)

    def remove_vertices(self, v_list):
        keep = np.ones(len(self.v), dtype=bool)
        keep[np.asarray(v_list, dtype=np.int64)] = False
        return self.keep_vertices(np.flatnonzero(keep))

    def point_cloud(self):
        return processing.point_cloud(self)

    def remove_faces(self, face_indices_to_remove):
        return processing.remove_faces(self, face_indices_to_remove)

    def scale_vertices(self, scale_factor):
        return processing.scale_vertices(self, scale_factor)

    def rotate_vertices(self, rotation):
        return processing.rotate_vertices(self, rotation)

    def translate_vertices(self, translation):
        return processing.translate_vertices(self, translation)

    def flip_faces(self):
        return processing.flip_faces(self)

    def simplified(self, factor=None, n_verts_desired=None):
        """The quadric decimation as a ``LinearMeshTransform`` (apply it to
        this mesh for the coarse mesh, on this mesh's device)."""
        from .topology import qslim_decimator

        return qslim_decimator(self, factor, n_verts_desired)

    def subdivide_triangles(self):
        return processing.subdivide_triangles(self)

    def concatenate_mesh(self, mesh):
        return processing.concatenate_mesh(self, mesh)

    def reorder_vertices(self, new_ordering, new_normal_ordering=None):
        processing.reorder_vertices(self, new_ordering, new_normal_ordering)

    # ------------------------------------------------------------------
    # Landmarks (delegates, reference mesh.py:371-404)

    @property
    def landm_names(self):
        """Landmark names, preferring the regressor table when present."""
        for table in ("landm_regressors", "landm"):
            if hasattr(self, table):
                return list(getattr(self, table).keys())
        return []

    @property
    def landm_xyz(self):
        order = self.landm_names
        if not order:
            return {}
        transform = self.landm_xyz_linear_transform(order)
        locations = (transform * self.v.flatten()).reshape(-1, 3)
        return dict(zip(order, locations))

    def set_landmarks_from_xyz(self, landm_raw_xyz):
        landmarks.set_landmarks_from_xyz(self, landm_raw_xyz)

    def landm_xyz_linear_transform(self, ordering=None):
        return landmarks.landm_xyz_linear_transform(self, ordering)

    def recompute_landmark_xyz(self):
        self.landm_raw_xyz = dict(
            (name, self.v[ind]) for name, ind in self.landm.items()
        )

    def recompute_landmark_indices(self, landmark_fname=None, safe_mode=True):
        landmarks.recompute_landmark_indices(self, landmark_fname, safe_mode)

    def set_landmarks_from_regressors(self, regressors):
        self.landm_regressors = regressors

    def set_landmark_indices_from_any(self, landmark_file_or_values):
        serialization.set_landmark_indices_from_any(self,
                                                    landmark_file_or_values)

    def set_landmarks_from_raw(self, landmark_file_or_values):
        landmarks.set_landmarks_from_raw(self, landmark_file_or_values)

    # ------------------------------------------------------------------
    # Texture (delegates, reference mesh.py:409-434)

    @property
    def texture_image(self):
        if not hasattr(self, "_texture_image") or self._texture_image is None:
            self.reload_texture_image()
        return self._texture_image

    def set_texture_image(self, path_to_texture):
        self.texture_filepath = path_to_texture

    def texture_coordinates_by_vertex(self):
        return texture.texture_coordinates_by_vertex(self)

    def reload_texture_image(self):
        texture.reload_texture_image(self)

    def transfer_texture(self, mesh_with_texture):
        texture.transfer_texture(self, mesh_with_texture)

    def load_texture(self, texture_version):
        texture.load_texture(self, texture_version)

    def texture_rgb(self, texture_coordinate):
        return texture.texture_rgb(self, texture_coordinate)

    def texture_rgb_vec(self, texture_coordinates):
        return texture.texture_rgb_vec(self, texture_coordinates)

    # ------------------------------------------------------------------
    # Search (reference mesh.py:439-455)

    def compute_aabb_tree(self, strategy="auto"):
        return AabbTree(self, strategy=strategy)

    def compute_aabb_normals_tree(self):
        return AabbNormalsTree(self)

    def compute_closest_point_tree(self, use_cgal=False):
        return (CGALClosestPointTree(self) if use_cgal
                else ClosestPointTree(self))

    def closest_vertices(self, vertices, use_cgal=False):
        """Nearest vertex per query (reference ClosestPointTree.nearest):
        (indices [Q] int32, distances [Q] float64).  ``use_cgal`` takes the
        reference's CGAL tree's flat outputs; both run the same kernel, the
        default on the cached device copy of ``v``."""
        if use_cgal:
            return self.compute_closest_point_tree(use_cgal).nearest(vertices)
        vt, _ = self.device_arrays()
        pts = torch.as_tensor(
            np.asarray(vertices, np.float32).reshape(-1, 3),
            device=self.device)
        idx, dist = closest_vertices_with_distance(vt, pts,
                                                   device=self.device)
        return idx.cpu().numpy(), dist.cpu().numpy().astype(np.float64)

    def closest_points(self, vertices):
        return self.closest_faces_and_points(vertices)[1]

    def closest_faces_and_points(self, vertices):
        """Nearest face and point per query (reference AabbTree.nearest
        convention): (faces [1, Q] uint32, points [Q, 3] float64).

        Routed through the query engine (``engine``), so repeated calls
        with varying query counts replay one plan per bucket; the direct
        route, ``compute_aabb_tree().nearest`` (the auto ladder), serves
        under MESH_TPU_NO_ENGINE=1, for no queries, and on the CPU above
        ``crossover_faces()`` faces."""
        from .engine import facade_closest_faces_and_points

        with obs_span("facade.closest_faces_and_points",
                      q=int(np.asarray(vertices).reshape(-1, 3).shape[0])
                      ) as sp:
            res = facade_closest_faces_and_points(self, vertices)
            if res is not None:
                sp.set(route="engine")
                return res
            sp.set(route="aabb_tree")
            return self.compute_aabb_tree().nearest(vertices)

    def normals_and_closest_points(self, vertices):
        """estimate_vertex_normals + closest_faces_and_points in one step:
        (normals [V, 3] f64, faces [1, Q] uint32, points [Q, 3] f64)."""
        with obs_span("facade.normals_and_closest_points"):
            return fused_normals_and_closest_points(self, vertices,
                                                    device=self.device)

    # ------------------------------------------------------------------
    # Serialization (delegates, reference mesh.py:460-492)

    def load_from_file(self, filename):
        serialization.load_from_file(self, filename)

    def load_from_ply(self, filename):
        serialization.load_from_ply(self, filename)

    def load_from_json(self, filename):
        serialization.load_from_json(self, filename)

    def load_from_obj(self, filename, use_native=False):
        serialization.load_from_obj(self, filename, use_native=use_native)

    def write_json(self, filename, header="", footer="", name="",
                   include_faces=True, texture_mode=True):
        serialization.write_json(self, filename, header, footer, name,
                                 include_faces, texture_mode)

    def write_three_json(self, filename, name=""):
        serialization.write_three_json(self, filename, name)

    def write_ply(self, filename, flip_faces=False, ascii=False,
                  little_endian=True, comments=[]):
        serialization.write_ply(self, filename, flip_faces, ascii,
                                little_endian, comments)

    def write_mtl(self, path, material_name, texture_name):
        serialization.write_mtl(self, path, material_name, texture_name)

    def write_obj(self, filename, flip_faces=False, group=False,
                  comments=None):
        serialization.write_obj(self, filename, flip_faces, group, comments)

    def load_from_obj_cpp(self, filename):
        serialization.load_from_obj_cpp(self, filename)

    def write_store(self, store=None):
        """Publish this mesh into the content-addressed store: the store is
        not ported yet."""
        raise _not_ported("Mesh.write_store",
                          "mesh_tpu.serialization.store_io.ingest_mesh",
                          "the mesh store, mesh_tpu/store")

    def load_from_store(self, digest, store=None, tier="exact"):
        """Load geometry from a store object: the store is not ported
        yet."""
        raise _not_ported("Mesh.load_from_store",
                          "mesh_tpu.store.MeshStore.open",
                          "the mesh store, mesh_tpu/store")

    def set_landmark_indices_from_ppfile(self, ppfilename):
        serialization.set_landmark_indices_from_ppfile(self, ppfilename)

    def set_landmark_indices_from_lmrkfile(self, lmrkfilename):
        serialization.set_landmark_indices_from_lmrkfile(self, lmrkfilename)
