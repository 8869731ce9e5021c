"""Edge / adjacency topology structures (counterpart of
mesh_tpu/topology/connectivity.py; reference mesh/topology/connectivity.py).

Host-side numpy, vectorized (the reference builds dicts in Python loops,
connectivity.py:17-34), with the same crc32-keyed disk cache so repeated runs
on a fixed topology (e.g. the SMPL template) are free
(connectivity.py:115-130; the cache folder is ``mesh_package_cache_folder``,
``MESH_TPU_CACHE``).

These structures are setup-time: their outputs (edge lists, incidence
matrices) become static operands of the device code.
"""

import os
import pickle
import zlib

import numpy as np
import scipy.sparse as sp

from .. import mesh_package_cache_folder
from ..utils import col, row


def _cached(tag, faces, builder, extra=""):
    """``builder()``'s result, pickled under the cache folder by ``tag``
    and the crc32 of ``faces`` (plus ``extra``); rebuilt when the pickle is
    missing or unreadable, and returned unsaved when the folder cannot be
    written."""
    key = str(zlib.crc32(np.ascontiguousarray(faces).flatten()))
    fname = os.path.join(
        mesh_package_cache_folder, "%s_%s%s.pkl" % (tag, key, extra)
    )
    try:
        with open(fname, "rb") as fp:
            return pickle.load(fp)
    except Exception:
        result = builder()
        try:
            with open(fname, "wb") as fp:
                pickle.dump(result, fp, -1)
        except OSError:
            pass
        return result


def get_vert_opposites_per_edge(mesh):
    """Dict from sorted vertex-index edge pairs to the list of opposite
    vertices (reference connectivity.py:17-34)."""
    f = np.asarray(mesh.f, dtype=np.int64)
    result = {}
    # vectorized edge/opposite extraction, dict assembly at the end
    edges = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    opps = np.concatenate([f[:, 2], f[:, 0], f[:, 1]], axis=0)
    edges = np.sort(edges, axis=1)
    for (e0, e1), opp in zip(edges, opps):
        result.setdefault((e0, e1), []).append(opp)
    return result


def get_vert_connectivity(mesh):
    """Sparse V x V vertex adjacency (reference connectivity.py:37-54)."""
    f = np.asarray(mesh.f, dtype=np.int64)
    n_v = len(mesh.v)
    vpv = sp.csc_matrix((n_v, n_v))
    for i in range(3):
        IS = f[:, i]
        JS = f[:, (i + 1) % 3]
        data = np.ones(len(IS))
        mtx = sp.csc_matrix((data, (IS, JS)), shape=(n_v, n_v))
        vpv = vpv + mtx + mtx.T
    return vpv


def vertices_in_common(face_1, face_2):
    """The vertices shared by two faces, sorted (reference
    connectivity.py:84-107)."""
    return sorted(set(np.asarray(face_1).tolist()) & set(np.asarray(face_2).tolist()))


def get_vertices_per_edge(mesh, faces_per_edge=None):
    """Ex2 unique vertex-index pairs, one row per edge
    (reference connectivity.py:108-130, cached)."""
    faces = np.asarray(mesh.f)
    extra = (
        "_" + str(zlib.crc32(np.ascontiguousarray(faces_per_edge).flatten()))
        if faces_per_edge is not None
        else ""
    )

    def build():
        if faces_per_edge is not None:
            return np.asarray(
                np.vstack(
                    [
                        row(np.intersect1d(faces[k[0]], faces[k[1]]))
                        for k in faces_per_edge
                    ]
                ),
                np.uint32,
            )
        vc = sp.coo_matrix(get_vert_connectivity(mesh))
        result = np.hstack((col(vc.row), col(vc.col)))
        return result[result[:, 0] < result[:, 1]]

    return _cached("verts_per_edge_cache", faces, build, extra)


def get_faces_per_edge(mesh):
    """Ex2 adjacent-face index pairs, one row per interior edge
    (reference connectivity.py:139-161, cached)."""
    faces = np.asarray(mesh.f)

    def build():
        f = np.asarray(faces, dtype=np.int64)
        IS = np.repeat(np.arange(len(f)), 3)
        JS = f.ravel()
        data = np.ones(IS.size)
        f2v = sp.csc_matrix((data, (IS, JS)), shape=(len(f), np.max(JS) + 1))
        f2f = (f2v @ f2v.T).tocoo()
        table = np.hstack((col(f2f.row), col(f2f.col), col(f2f.data)))
        which = (table[:, 0] < table[:, 1]) & (table[:, 2] >= 2)
        return np.asarray(table[which, :2], np.uint32)

    return _cached("edgecache_new", faces, build)


def get_faces_per_edge_old(mesh):
    """Legacy spelling kept for reference compat (connectivity.py:164-200).
    The reference retains two generations of this computation whose only
    contract is "one row per interior edge, the two adjacent face ids";
    both are served by the modern implementation here (row order is not part
    of the contract and differs between the reference's own two versions)."""
    return get_faces_per_edge(mesh)


def vertices_to_edges_matrix(mesh, want_xyz=True):
    """Sparse matrix M with e = M.dot(v): per-edge difference operator
    (reference connectivity.py:57-80)."""
    vpe = get_vertices_per_edge(mesh)
    IS = np.repeat(np.arange(len(vpe)), 2)
    JS = np.asarray(vpe, dtype=np.int64).flatten()
    data = np.ones_like(vpe, dtype=np.float64)
    data[:, 1] = -1
    data = data.flatten()
    if want_xyz:
        IS = np.concatenate((IS * 3, IS * 3 + 1, IS * 3 + 2))
        JS = np.concatenate((JS * 3, JS * 3 + 1, JS * 3 + 2))
        data = np.concatenate((data, data, data))
    return sp.csc_matrix((data, np.vstack((IS, JS))))


def edge_topology_arrays(f, num_vertices):
    """Device-facing static topology bundle: fixed-shape int32 arrays for
    device code (no reference analog: the padded-gather form that array
    programs consume instead of dicts and sparse matrices).

    :returns: dict with ``edges`` (E,2), ``edge_opposites`` (E,2; -1 padded
        for boundary edges), ``faces_per_edge`` (E,2; -1 padded).
    """
    f = np.asarray(f, dtype=np.int64)
    half = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    opp = np.concatenate([f[:, 2], f[:, 0], f[:, 1]], axis=0)
    face_id = np.tile(np.arange(len(f)), 3)
    key = np.sort(half, axis=1)
    uniq, inverse = np.unique(key, axis=0, return_inverse=True)
    n_e = len(uniq)
    edge_opposites = np.full((n_e, 2), -1, dtype=np.int64)
    faces_per_edge = np.full((n_e, 2), -1, dtype=np.int64)
    slot = np.zeros(n_e, dtype=np.int64)
    for e_idx, o, fi in zip(inverse, opp, face_id):
        s = slot[e_idx]
        if s < 2:
            edge_opposites[e_idx, s] = o
            faces_per_edge[e_idx, s] = fi
            slot[e_idx] = s + 1
    return {
        "edges": uniq.astype(np.int32),
        "edge_opposites": edge_opposites.astype(np.int32),
        "faces_per_edge": faces_per_edge.astype(np.int32),
    }
