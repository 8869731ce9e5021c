"""Loop subdivision producing a sparse upsample transform (counterpart of
mesh_tpu/topology/subdivision.py; reference mesh/topology/subdivision.py).

Host-side setup algorithm (data-dependent dict lookups over texture seams);
the resulting LinearMeshTransform applies as a sparse matmul.
Weights follow Loop's scheme exactly as the reference implements it:
original vertices smoothed with wt = 3/16 (valence 3) or 3/(8n), edge
midpoints = 3/8 endpoints + 1/8 opposite vertices (subdivision.py:50-91),
faces split 1->4 (subdivision.py:97-128).
"""

import numpy as np
import scipy.sparse as sp

from .connectivity import (
    get_vert_connectivity,
    get_vert_opposites_per_edge,
    get_vertices_per_edge,
)
from .linear_mesh_transform import LinearMeshTransform


def loop_subdivider(mesh):
    IS, JS, data = [], [], []

    vc = get_vert_connectivity(mesh)
    ve = get_vertices_per_edge(mesh)
    vo = get_vert_opposites_per_edge(mesh)

    has_texture = hasattr(mesh, "ft") and hasattr(mesh, "vt")
    if has_texture:
        from ..mesh import Mesh

        flat_mesh = Mesh(v=np.asarray(mesh.vt), f=np.asarray(mesh.ft),
                         device=mesh.device)
        vt_start = len(flat_mesh.v)
        vt_edge_to_midpoint = {}
        vt_e = get_vertices_per_edge(flat_mesh)
        vt = flat_mesh.v[:, :2].tolist()
        for idx, vs in enumerate(np.asarray(vt_e, dtype=np.int64)):
            v0, v1 = sorted(vs.tolist())
            vt_edge_to_midpoint[(v0, v1)] = vt_start + idx
            vt_edge_to_midpoint[(v1, v0)] = vt_start + idx
            vt.append((np.array(vt[v0]) + np.array(vt[v1])) / 2.0)
        vt = np.array(vt)

    # smoothed original vertices
    for idx in range(len(mesh.v)):
        nbrs = np.nonzero(vc[:, idx])[0]
        nn = len(nbrs)
        if nn == 3:
            wt = 3.0 / 16.0
        elif nn > 3:
            wt = 3.0 / (8.0 * nn)
        else:
            raise ValueError("vertex valence should be 3 or more")
        for nbr in nbrs:
            IS.append(idx)
            JS.append(nbr)
            data.append(wt)
        IS.append(idx)
        JS.append(idx)
        data.append(1.0 - wt * nn)

    # edge midpoints
    start = len(mesh.v)
    edge_to_midpoint = {}
    for idx, vs in enumerate(np.asarray(ve, dtype=np.int64)):
        v0, v1 = sorted(vs.tolist())
        IS += [start + idx, start + idx]
        JS += [v0, v1]
        data += [3.0 / 8.0, 3.0 / 8.0]
        opposites = vo[(v0, v1)]
        IS += [start + idx, start + idx]
        JS += [int(opposites[0]), int(opposites[1])]
        data += [1.0 / 8.0, 1.0 / 8.0]
        edge_to_midpoint[(v0, v1)] = start + idx
        edge_to_midpoint[(v1, v0)] = start + idx

    # 1 -> 4 face split
    f = []
    ft = [] if has_texture else None
    for f_i, old_f in enumerate(np.asarray(mesh.f, dtype=np.int64)):
        ff = np.concatenate((old_f, old_f))
        if has_texture:
            ftft = np.concatenate(
                (np.asarray(mesh.ft)[f_i], np.asarray(mesh.ft)[f_i])
            )
            anomalous = len(np.unique(np.asarray(mesh.ft)[f_i])) != 3
        for i in range(3):
            m0 = edge_to_midpoint[(ff[i], ff[i + 1])]
            m2 = edge_to_midpoint[(ff[i + 1], ff[i + 2])]
            f.append([m0, ff[i + 1], m2])
            if has_texture:
                if anomalous:
                    ft.append([0, 0, 0])
                else:
                    ft.append([
                        vt_edge_to_midpoint[(ftft[i], ftft[i + 1])],
                        ftft[i + 1],
                        vt_edge_to_midpoint[(ftft[i + 1], ftft[i + 2])],
                    ])
        f.append([
            edge_to_midpoint[(ff[0], ff[1])],
            edge_to_midpoint[(ff[1], ff[2])],
            edge_to_midpoint[(ff[2], ff[3])],
        ])
        if has_texture:
            if anomalous:
                ft.append([0, 0, 0])
            else:
                ft.append([
                    vt_edge_to_midpoint[(ftft[0], ftft[1])],
                    vt_edge_to_midpoint[(ftft[1], ftft[2])],
                    vt_edge_to_midpoint[(ftft[2], ftft[3])],
                ])

    f = np.array(f, dtype=np.int64)
    if has_texture:
        ft = np.array(ft, dtype=np.int64)

    IS = np.array(IS, dtype=np.int64)
    JS = np.array(JS, dtype=np.int64)
    data = np.array(data, dtype=np.float64)
    # expand to xyz coordinates
    IS3 = np.concatenate((IS * 3, IS * 3 + 1, IS * 3 + 2))
    JS3 = np.concatenate((JS * 3, JS * 3 + 1, JS * 3 + 2))
    data3 = np.concatenate((data, data, data))
    mtx = sp.csc_matrix((data3, np.vstack((IS3, JS3))))

    if has_texture:
        return LinearMeshTransform(mtx, f, vt=vt, ft=ft)
    return LinearMeshTransform(mtx, f)
