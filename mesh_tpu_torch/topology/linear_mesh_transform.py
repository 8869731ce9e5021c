"""Callable sparse vertex->vertex resolution transform (counterpart of
mesh_tpu/topology/linear_mesh_transform.py; reference
mesh/topology/linear_mesh_transform.py).

Wraps the sparse up/downsample matrix produced by loop_subdivider /
qslim_decimator.  Applied to a Mesh it returns the remeshed Mesh on the
source mesh's device; applied to a raw array it returns the mapped flat
coordinates; with want_edges=True it returns per-edge difference vectors.
``as_coo_arrays()`` exports the transform as tensor-ready COO triplets.
"""

import numpy as np

from ..utils import col
from .connectivity import vertices_to_edges_matrix


class LinearMeshTransform(object):
    def __init__(self, mtx, faces, vt=None, ft=None):
        from ..mesh import Mesh

        self.mtx = mtx
        self.faces = faces
        # a host-only helper mesh: the edge matrix reads its v and f alone
        self.remeshed_vtx_to_remeshed_edge_mtx = vertices_to_edges_matrix(
            Mesh(f=faces, v=np.zeros((mtx.shape[0], 3)), device="cpu"),
            want_xyz=True,
        )
        self.vtx_to_edge_mtx = self.remeshed_vtx_to_remeshed_edge_mtx.dot(self.mtx)
        if vt is not None:
            self.vt = vt
        if ft is not None:
            self.ft = ft

    def as_coo_arrays(self):
        """(rows, cols, vals) int64/int64/float32 COO triplets, ready for
        ``torch.sparse_coo_tensor`` or an ``index_add_`` of vals * x[cols]
        into rows."""
        coo = self.mtx.tocoo()
        return (
            np.asarray(coo.row, np.int64),
            np.asarray(coo.col, np.int64),
            np.asarray(coo.data, np.float32),
        )

    def _matrix_for(self, n_coords, want_edges):
        """Pick the sparse matrix mapping an input with `n_coords` flat
        coordinates to the requested output, or None for identity (input is
        already at the target resolution and vertices were asked for)."""
        at_target = n_coords == self.mtx.shape[0]
        if want_edges:
            return (
                self.remeshed_vtx_to_remeshed_edge_mtx
                if at_target
                else self.vtx_to_edge_mtx
            )
        return None if at_target else self.mtx

    def __call__(self, a, want_edges=False):
        from ..mesh import Mesh

        if not isinstance(a, Mesh):
            return self.chained_obj_for(a, want_edges)
        mtx = self._matrix_for(a.v.size, want_edges)
        if want_edges:
            return (mtx @ col(a.v)).reshape(-1, 3)
        if mtx is None:
            return a
        return self._remeshed(a, mtx)

    def _remeshed(self, source, mtx):
        """Mesh at the target resolution on the source's device, carrying
        over segmentation, landmarks (snapped to nearest new vertex), and
        texture coords."""
        from ..mesh import Mesh

        out = Mesh(v=(mtx @ col(source.v)).reshape(-1, 3),
                   f=self.faces.copy(), device=source.device)
        if hasattr(source, "segm"):
            out.transfer_segm(source)
        if hasattr(source, "landm"):
            out.landm = {
                name: int(
                    np.argmin(((out.v - source.v[idx]) ** 2).sum(axis=1))
                )
                for name, idx in source.landm.items()
            }
        for attr in ("vt", "ft"):
            if hasattr(self, attr):
                setattr(out, attr, getattr(self, attr))
        return out

    def chained_obj_for(self, a, want_edges):
        """Apply to a raw array or an autodiff-style chained object with a
        `.r` value attribute; returns flat coordinates."""
        n_coords = len(a.r) if hasattr(a, "r") else a.size
        mtx = self._matrix_for(n_coords, want_edges)
        if mtx is None:
            return a
        return np.asarray(mtx @ col(np.asarray(a))).ravel()
