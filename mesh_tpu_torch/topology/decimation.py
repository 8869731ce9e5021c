"""QSlim-style quadric edge-collapse decimation (counterpart of
mesh_tpu/topology/decimation.py; reference mesh/topology/decimation.py).

An inherently sequential greedy-heap algorithm, kept on the host, with a
vectorized setup: vertex quadrics come from closed-form plane equations
accumulated with np.add.at instead of the reference's per-face SVD loop
(decimation.py:43-68).  The output is a sparse downsample transform,
``LinearMeshTransform``.
"""

import heapq
import math

import numpy as np
import scipy.sparse as sp
import scipy.spatial

from .linear_mesh_transform import LinearMeshTransform


def remove_redundant_verts(v, f, eps=1e-10):
    """Collapse vertices closer than `eps` onto one representative and
    renumber faces compactly (reference decimation.py:15-40 behavior,
    re-derived: KD-tree near-pair graph + connected components instead of
    the reference's dense O(V^2) pdist loop).

    Vertices not referenced by any face after merging are dropped, matching
    the reference.
    """
    import scipy.sparse.csgraph as csgraph

    v = np.asarray(v)
    f = np.asarray(f, dtype=np.int64)
    n = len(v)
    near = scipy.spatial.cKDTree(v).query_pairs(eps, output_type="ndarray")
    graph = sp.coo_matrix(
        (np.ones(len(near)), (near[:, 0], near[:, 1])), shape=(n, n)
    )
    _, component = csgraph.connected_components(graph, directed=False)
    # each duplicate group collapses onto its smallest member index
    representative = np.full(component.max() + 1, n, dtype=np.int64)
    np.minimum.at(representative, component, np.arange(n))
    merged_faces = representative[component[f]]

    kept = np.unique(merged_faces)
    renumber = np.zeros(n, dtype=np.int64)
    renumber[kept] = np.arange(kept.size)
    return v[kept], renumber[merged_faces]


def vertex_quadrics(mesh):
    """(V, 4, 4) accumulated plane quadrics per vertex.

    The plane equation of each face is the unit normal plus offset
    [n, -n.v0]; its outer product accumulates onto the face's three corners
    (closed form replacing the reference's SVD per face,
    decimation.py:43-68; the SVD null-space vector equals +-[n, d]/|n| and
    the outer product is sign-invariant).
    """
    v = np.asarray(mesh.v, dtype=np.float64)
    f = np.asarray(mesh.f, dtype=np.int64)
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    n = np.cross(b - a, c - a)
    norms = np.linalg.norm(n, axis=1, keepdims=True)
    norms[norms == 0] = 1.0
    n = n / norms
    d = -np.sum(n * a, axis=1, keepdims=True)
    eq = np.concatenate([n, d], axis=1)  # (F, 4)
    quad = eq[:, :, None] * eq[:, None, :]  # (F, 4, 4)
    v_quadrics = np.zeros((len(v), 4, 4))
    for k in range(3):
        np.add.at(v_quadrics, f[:, k], quad)
    return v_quadrics


def qslim_decimator_transformer(mesh, factor=None, n_verts_desired=None):
    """Greedy quadric edge collapse until n_verts_desired vertices remain.

    :returns: (new_faces Fx3, mtx): sparse (3V' x 3V) downsample transform
        (reference decimation.py:78-190).
    """
    if factor is None and n_verts_desired is None:
        raise ValueError("Need either factor or n_verts_desired.")
    if n_verts_desired is None:
        n_verts_desired = math.ceil(len(mesh.v) * factor)

    Qv = vertex_quadrics(mesh)
    from .connectivity import get_vertices_per_edge

    vert_adj = np.asarray(get_vertices_per_edge(mesh), dtype=np.int64)
    v = np.asarray(mesh.v, dtype=np.float64)

    def collapse_cost(r, c):
        Qsum = Qv[r] + Qv[c]
        p1 = np.append(v[r], 1.0)
        p2 = np.append(v[c], 1.0)
        destroy_c_cost = float(p1 @ Qsum @ p1)
        destroy_r_cost = float(p2 @ Qsum @ p2)
        return destroy_c_cost, destroy_r_cost, Qsum

    queue = []
    for r, c in vert_adj:
        r, c = (int(r), int(c)) if r < c else (int(c), int(r))
        dc, dr, _ = collapse_cost(r, c)
        heapq.heappush(queue, (min(dc, dr), (r, c)))

    faces = np.asarray(mesh.f, dtype=np.int64)
    # merged-vertex forest: heap entries keep their original endpoint ids
    # and are canonicalized through find() on pop, so a collapse is
    # O(log E) instead of rewriting + re-heapifying the whole queue
    parent = np.arange(len(mesh.v))

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:        # path compression
            parent[x], x = root, parent[x]
        return root

    def resolve_all():
        """Vectorized find() for every vertex via pointer doubling
        (O(log depth) rounds), writing the fully-compressed forest back so
        later resyncs and scalar find() calls start from depth 1."""
        remap = parent[parent]
        while True:
            nxt = remap[remap]
            if np.array_equal(nxt, remap):
                parent[:] = remap
                return remap
            remap = nxt

    def live_vertex_count():
        """Exact count of vertices still referenced by a non-degenerate
        face under the current merges (what the pre-union-find code
        recomputed every iteration)."""
        remapped = resolve_all()[faces]
        alive = ~(
            (remapped[:, 0] == remapped[:, 1])
            | (remapped[:, 1] == remapped[:, 2])
            | (remapped[:, 2] == remapped[:, 0])
        )
        return len(np.unique(remapped[alive]))

    nverts_total = len(np.unique(faces))
    since_resync = 0
    while nverts_total > n_verts_desired and queue:
        cost0, (r0, c0) = heapq.heappop(queue)
        r, c = find(r0), find(c0)
        if r == c:
            continue
        if r > c:
            r, c = c, r
        dc, dr, Qsum = collapse_cost(r, c)
        if min(dc, dr) > cost0:
            # stale entry: re-push with the fresh cost (lazy-deletion heap)
            heapq.heappush(queue, (min(dc, dr), (r, c)))
            continue
        to_keep, to_destroy = (r, c) if dc < dr else (c, r)
        parent[to_destroy] = to_keep
        Qv[r] = Qsum
        Qv[c] = Qsum
        # a collapse merges two live face-vertices, but can also orphan
        # others by degenerating all their faces — decrement optimistically
        # and resync the exact count periodically and near the target
        nverts_total -= 1
        since_resync += 1
        if since_resync >= 64 or nverts_total <= n_verts_desired:
            nverts_total = live_vertex_count()
            since_resync = 0

    # apply all merges to the faces at once, then drop collapsed faces
    faces = resolve_all()[faces]
    degenerate = (
        (faces[:, 0] == faces[:, 1])
        | (faces[:, 1] == faces[:, 2])
        | (faces[:, 2] == faces[:, 0])
    )
    faces = faces[~degenerate]

    return _get_sparse_transform(faces, len(mesh.v))


def qslim_decimator(mesh, factor=None, n_verts_desired=None):
    """Simplified mesh as a LinearMeshTransform (reference
    decimation.py:192-202)."""
    new_faces, mtx = qslim_decimator_transformer(mesh, factor, n_verts_desired)
    return LinearMeshTransform(mtx, new_faces)


def qslim_decimator_fast(mesh, factor=None, n_verts_desired=None):
    """Decimate and return the simplified mesh directly (reference
    decimation.py:71-75).  The reference version shells out to an external
    `experiments.qslim` package that it does not ship; here the vectorized
    quadric pipeline above is already the fast path, so this simply applies
    the transform and hands back the coarse mesh."""
    xform = qslim_decimator(mesh, factor=factor, n_verts_desired=n_verts_desired)
    return xform(mesh)


def _get_sparse_transform(faces, num_original_verts):
    """Renumber `faces` onto their surviving vertices and build the sparse
    (3V' x 3V) selection matrix that picks those vertices' flattened xyz
    coordinates out of the original array (reference decimation.py:204-223).
    """
    survivors = np.unique(faces)            # sorted original vertex ids
    lookup = np.full(num_original_verts, -1, dtype=np.int64)
    lookup[survivors] = np.arange(survivors.size)
    new_faces = lookup[np.asarray(faces, dtype=np.int64)]
    # flat coordinate 3i+k of new vertex i reads 3*survivors[i]+k
    out_coords = np.arange(3 * survivors.size)
    in_coords = (3 * survivors[:, None] + np.arange(3)).ravel()
    mtx = sp.csc_matrix(
        (np.ones(out_coords.size), (out_coords, in_coords)),
        shape=(3 * survivors.size, 3 * num_original_verts),
    )
    return new_faces, mtx
