"""Mesh measurement utilities (counterpart of mesh_tpu/metrics.py).

The reference removed its circumference code from the core package and left
`Mesh.estimate_circumference` raising a pointer to an external
`body.mesh.metrics.circumferences` module (reference mesh.py:313-314).  This
module restores the capability natively: a vectorized plane/mesh section in
numpy, one gather and one arithmetic pass over all faces, no per-face
Python loop.
"""

import numpy as np


def plane_section(v, f, plane_normal, plane_distance, eps=1e-12):
    """Intersect the triangle mesh with the plane ``dot(n, x) = d``.

    Every triangle straddling the plane contributes one line segment (the
    classic marching-triangles rule: of the three edges, exactly two cross
    a plane that separates the vertices).  Degenerate on-plane vertices are
    nudged by ``eps`` so each crossing stays well-defined.

    :returns: (starts, ends) — two [S, 3] arrays of segment endpoints, one
        row per intersected triangle.
    """
    v = np.asarray(v, dtype=np.float64)
    f = np.asarray(f, dtype=np.int64)
    n = np.asarray(plane_normal, dtype=np.float64)
    scale = np.linalg.norm(n)
    # rescale BOTH so the cut stays the documented {x: dot(n, x) = d} for a
    # non-unit normal, while s keeps true euclidean-distance units
    n = n / scale
    s = v @ n - float(plane_distance) / scale  # signed vertex-plane distance
    s = np.where(np.abs(s) < eps, eps, s)      # break on-plane ties
    sf = s[f]                                  # [F, 3]

    # edge k of a face joins corners k and k+1; it crosses iff signs differ
    corner_a = sf
    corner_b = sf[:, [1, 2, 0]]
    crossing = (corner_a * corner_b) < 0       # [F, 3] bool, 0 or 2 per face
    hit = crossing.sum(axis=1) == 2
    if not hit.any():
        return np.zeros((0, 3)), np.zeros((0, 3))

    fa = f[hit]
    a_all = v[fa]                              # [S, 3corner, 3xyz]
    b_all = v[fa[:, [1, 2, 0]]]
    denom = corner_a[hit] - corner_b[hit]
    # non-crossing edges may have zero denominators; their t is never chosen
    t = corner_a[hit] / np.where(np.abs(denom) < eps, 1.0, denom)   # [S, 3]
    pts = a_all + t[:, :, None] * (b_all - a_all)         # [S, 3edge, 3xyz]

    # pick each face's two crossing edges in a fixed order
    cross_hit = crossing[hit]
    order = np.argsort(~cross_hit, axis=1, kind="stable")[:, :2]  # [S, 2]
    rows = np.arange(len(fa))[:, None]
    chosen = pts[rows, order]                  # [S, 2, 3]
    return chosen[:, 0], chosen[:, 1]


def circumference(mesh, plane_normal, plane_distance,
                  part_names_allowed=None, want_edges=False):
    """Total length of the mesh's cross-section with a plane.

    This is the body-measurement primitive (chest/waist/hip girth on SMPL
    meshes): slice the surface with ``dot(n, x) = d`` and sum the resulting
    polyline length.  If the section has several loops, their lengths are
    summed — restrict with ``part_names_allowed`` (segm part names whose
    faces participate) to isolate one.

    :param want_edges: also return the [S, 2, 3] segment array so callers
        can visualize the section (e.g. via `Lines`).
    """
    v = np.asarray(mesh.v)
    f = np.asarray(mesh.f, dtype=np.int64)
    if part_names_allowed is not None:
        segm = getattr(mesh, "segm", None) or {}
        wanted = [np.asarray(segm[name], dtype=np.int64)
                  for name in part_names_allowed if name in segm]
        if not wanted:
            return (0.0, np.zeros((0, 2, 3))) if want_edges else 0.0
        f = f[np.unique(np.concatenate(wanted))]
    starts, ends = plane_section(v, f, plane_normal, plane_distance)
    total = float(np.linalg.norm(ends - starts, axis=1).sum())
    if want_edges:
        return total, np.stack([starts, ends], axis=1)
    return total
