"""In-place mesh edits (counterpart of mesh_tpu/processing.py; reference
mesh/processing.py, free functions bound as Mesh methods).

These are host-side, setup-time operations on numpy-backed attributes; the
reference's per-face Python loops (subdivide_triangles' O(F^2) vstack loop,
processing.py:125-155; flip_faces' row loop, processing.py:98-105) are
vectorized.  Rotation goes through the port's Rodrigues transform on the
mesh's device instead of cv2 (processing.py:113-117).  Every mesh built
here from another mesh takes that mesh's device.
"""

import numpy as np


def reset_normals(self, face_to_verts_sparse_matrix=None, reset_face_normals=False):
    self.vn = self.estimate_vertex_normals(face_to_verts_sparse_matrix)
    if reset_face_normals:
        self.fn = self.f.copy()
    return self


def reset_face_normals(self):
    if not hasattr(self, "vn"):
        self.reset_normals()
    self.fn = self.f
    return self


def uniquified_mesh(self):
    """A copy in which each vertex appears in exactly one face
    (reference processing.py:31-45) — needed for per-face texturing."""
    from .mesh import Mesh

    flat = np.asarray(self.f).flatten()
    new_mesh = Mesh(v=np.asarray(self.v)[flat],
                    f=np.arange(len(flat)).reshape(-1, 3), device=self.device)
    if not hasattr(self, "vn"):
        self.reset_normals()
    new_mesh.vn = np.asarray(self.vn)[flat]
    if hasattr(self, "vt"):
        new_mesh.vt = np.asarray(self.vt)[np.asarray(self.ft).flatten()]
        new_mesh.ft = new_mesh.f.copy()
    return new_mesh


def keep_vertices(self, keep_list):
    """Restrict the mesh to a vertex subset, dropping faces that reference
    removed vertices (reference processing.py:47-64)."""
    keep_list = np.asarray(keep_list, dtype=np.int64)
    v_arr = np.asarray(self.v)
    f_arr = np.asarray(self.f, dtype=np.int64)
    trans = np.full(v_arr.shape[0], -1, dtype=np.int64)
    trans[keep_list] = np.arange(len(keep_list))
    trans_f = trans[f_arr]
    if hasattr(self, "vn") and np.asarray(self.vn).shape[0] == v_arr.shape[0]:
        self.vn = np.asarray(self.vn).reshape(-1, 3)[keep_list]
    if hasattr(self, "vc") and np.asarray(self.vc).shape[0] == v_arr.shape[0]:
        self.vc = np.asarray(self.vc).reshape(-1, 3)[keep_list]
    self.v = v_arr.reshape(-1, 3)[keep_list]
    self.f = trans_f[(trans_f != -1).all(axis=1)].astype(np.uint32)
    if hasattr(self, "landm_raw_xyz"):
        self.recompute_landmark_indices()
    return self


def remove_faces(self, face_indices_to_remove):
    """Drop faces and any vertices no longer referenced
    (reference processing.py:67-95)."""
    f = np.delete(np.asarray(self.f, dtype=np.int64), face_indices_to_remove, 0)
    v2keep = np.unique(f)
    self.v = np.asarray(self.v)[v2keep]
    remap = np.zeros(0 if f.size == 0 else f.max() + 1, dtype=np.int64)
    remap[v2keep] = np.arange(len(v2keep))
    self.f = remap[f].astype(np.uint32)
    if hasattr(self, "fc"):
        self.fc = np.delete(np.asarray(self.fc), face_indices_to_remove, 0)
    if hasattr(self, "vn") and np.asarray(self.vn).shape[0] > max(v2keep, default=-1):
        self.vn = np.asarray(self.vn).reshape(-1, 3)[v2keep]
    if hasattr(self, "vc") and np.asarray(self.vc).shape[0] > max(v2keep, default=-1):
        self.vc = np.asarray(self.vc).reshape(-1, 3)[v2keep]
    if hasattr(self, "ft"):
        ft = np.delete(np.asarray(self.ft, dtype=np.int64), face_indices_to_remove, 0)
        vt2keep = np.unique(ft)
        self.vt = np.asarray(self.vt)[vt2keep]
        remap_t = np.zeros(0 if ft.size == 0 else ft.max() + 1, dtype=np.int64)
        remap_t[vt2keep] = np.arange(len(vt2keep))
        self.ft = remap_t[ft].astype(np.uint32)
    if hasattr(self, "landm_raw_xyz"):
        self.recompute_landmark_indices()
    return self


def point_cloud(self):
    """Copy with no faces, keeping vertex colors if any
    (reference processing.py:62-64)."""
    from .mesh import Mesh

    if hasattr(self, "vc"):
        return Mesh(v=self.v, f=[], vc=self.vc, device=self.device)
    return Mesh(v=self.v, f=[], device=self.device)


def flip_faces(self):
    self.f = np.asarray(self.f)[:, ::-1].copy()
    if hasattr(self, "ft"):
        self.ft = np.asarray(self.ft)[:, ::-1].copy()
    return self


def scale_vertices(self, scale_factor):
    self.v = np.asarray(self.v) * scale_factor
    return self


def rotate_vertices(self, rotation):
    from .geometry.rodrigues import rodrigues

    rotation = np.asarray(rotation)
    R = (rodrigues(rotation, calculate_jacobian=False, device=self.device)
         if rotation.shape != (3, 3) else rotation)
    self.v = np.asarray(self.v) @ np.asarray(R).T
    return self


def translate_vertices(self, translation):
    self.v = np.asarray(self.v) + translation
    return self


def subdivide_triangles(self):
    """Centroid 1->3 split of every face (reference processing.py:125-155),
    vectorized: new vertex i + V is the centroid of old face i."""
    v = np.asarray(self.v)
    f = np.asarray(self.f, dtype=np.int64)
    centroids = v[f].mean(axis=1)
    n_v, n_f = v.shape[0], f.shape[0]
    cidx = n_v + np.arange(n_f)
    new_f = np.stack(
        [
            np.stack([f[:, 0], f[:, 1], cidx], axis=1),
            np.stack([f[:, 1], f[:, 2], cidx], axis=1),
            np.stack([f[:, 2], f[:, 0], cidx], axis=1),
        ],
        axis=1,
    ).reshape(-1, 3)
    self.v = np.vstack([v, centroids])
    self.f = new_f.astype(np.uint32)
    if hasattr(self, "vt"):
        vt = np.asarray(self.vt)
        ft = np.asarray(self.ft, dtype=np.int64)
        t_centroids = vt[ft].mean(axis=1)
        tcidx = vt.shape[0] + np.arange(ft.shape[0])
        new_ft = np.stack(
            [
                np.stack([ft[:, 0], ft[:, 1], tcidx], axis=1),
                np.stack([ft[:, 1], ft[:, 2], tcidx], axis=1),
                np.stack([ft[:, 2], ft[:, 0], tcidx], axis=1),
            ],
            axis=1,
        ).reshape(-1, 3)
        self.vt = np.vstack([vt, t_centroids])
        self.ft = new_ft.astype(np.uint32)
    return self


def concatenate_mesh(self, mesh):
    if len(self.v) == 0:
        self.f = np.asarray(mesh.f).copy()
        self.v = np.asarray(mesh.v).copy()
        if hasattr(mesh, "vc"):
            self.vc = np.asarray(mesh.vc).copy()
    elif len(mesh.v):
        self.f = np.concatenate(
            [np.asarray(self.f), np.asarray(mesh.f) + len(self.v)]
        ).astype(np.uint32)
        self.v = np.concatenate([np.asarray(self.v), np.asarray(mesh.v)])
        if hasattr(mesh, "vc") and hasattr(self, "vc") and self.vc is not None:
            self.vc = np.concatenate([np.asarray(self.vc), np.asarray(mesh.vc)])
        elif hasattr(self, "vc") and self.vc is not None:
            # color info can't be kept consistent across the concat
            del self.vc
    return self


def reorder_vertices(self, new_ordering, new_normal_ordering=None):
    """new_ordering[i] = j: vertex i becomes the j-th vertex
    (reference processing.py:171-186)."""
    new_ordering = np.asarray(new_ordering, dtype=np.int64)
    if new_normal_ordering is None:
        new_normal_ordering = new_ordering
    else:
        new_normal_ordering = np.asarray(new_normal_ordering, dtype=np.int64)
    inverse = np.zeros(len(new_ordering), dtype=np.int64)
    inverse[new_ordering] = np.arange(len(new_ordering))
    inv_norm = np.zeros(len(new_normal_ordering), dtype=np.int64)
    inv_norm[new_normal_ordering] = np.arange(len(new_normal_ordering))
    self.v = np.asarray(self.v)[inverse]
    if hasattr(self, "vn"):
        self.vn = np.asarray(self.vn)[inv_norm]
    self.f = new_ordering[np.asarray(self.f, dtype=np.int64)].astype(np.uint32)
    if hasattr(self, "fn"):
        self.fn = new_normal_ordering[np.asarray(self.fn, dtype=np.int64)].astype(np.uint32)
