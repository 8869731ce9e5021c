"""Normal-weighted nearest face: the ``normal_weighted_faces`` CUDA
kernel's wrapper, its plain PyTorch version, and the prologue and epilogue
around them (counterpart of mesh_tpu/query/pallas_normal_weighted.py and
mesh_tpu/query/normal_weighted.py).

Per query point p with normal n_p, the face minimizing
``|p - q| + eps * (1 - n_p . n_tri)``, where q is the face's closest point
and n_tri its unit normal: the registration metric of the reference's
``AabbNormalsTree`` (mesh/src/AABB_n_tree.h:40-84).  Query normals are used
as given (the reference does not normalize them); face normals are unit.

The prologue centers on the per-mesh vertex mean and stacks the fast
tile's 19 planes (``closest_kernel.fast_tile_rows``) with the three rows of
the centered faces' unit normals; the kernel keeps a running (cost, face)
pair per query with a strict ``<``, so the lowest index wins an exact tie;
the epilogue recomputes the winner's closest point exactly with
``closest_point_on_triangle`` and un-centers it.  ``LAUNCHES`` counts the
kernel's launches.
"""

import torch

from ..geometry.cross_product import cross3
from ..geometry.tri_normals import normalize_rows
from ..utils.device import as_tensor
from .closest_kernel import (
    N_FACE_ROWS,
    _batched,
    _center_inputs,
    _chunks,
    _grid,
    _sqdist_tile_fast,
    fast_tile_rows,
)
from .point_triangle import closest_point_on_triangle
from .ray_kernel import check_with_vectors

#: the fast tile's planes, then the unit face normal
N_NW_ROWS = N_FACE_ROWS + 3

#: launches of the CUDA kernel since the count was last set to 0
LAUNCHES = {"normal_weighted_faces": 0}


def _nw_cost_tile(px, py, pz, qnx, qny, qnz, rows, eps, degenerate_tail):
    """The blended cost on a [..., TQ, TF] tile (reference _nw_cost_tile);
    the kernel's functor in csrc/normal_weighted_faces.cu makes the same
    operations in the same order."""
    d2 = _sqdist_tile_fast(px, py, pz, *rows[:N_FACE_ROWS],
                           degenerate_tail=degenerate_tail)
    tnx, tny, tnz = rows[N_FACE_ROWS:]
    ndot = qnx * tnx + qny * tny + qnz * tnz
    return torch.sqrt(d2) + eps * (1.0 - ndot)


def normal_weighted_operands(v, f, points, normals):
    """The prologue: (pts [B, Q, 3], normals [B, Q, 3], planes [B, 22, F],
    tri [B, F, 3, 3], center [B, 1, 3]), float32, points and faces centered
    on each mesh's vertex mean; the first three are the kernel's
    operands."""
    pts, center, tri = _center_inputs(v, f, points)
    n_tri = normalize_rows(cross3(tri[..., 1, :] - tri[..., 0, :],
                                  tri[..., 2, :] - tri[..., 0, :]))
    rows = fast_tile_rows(tri) + [n_tri[..., k] for k in range(3)]
    planes = torch.stack(rows, dim=-2).contiguous()
    nrm = normals.to(torch.float32).reshape(pts.shape).contiguous()
    return pts.contiguous(), nrm, planes, tri, center


def argmin_normal_weighted_plain(pts, normals, planes, eps=0.1,
                                 degenerate_tail=True):
    """Plain PyTorch version of the ``normal_weighted_faces`` kernel: the
    face of least blended cost per query, [B, Q] int32, lowest index on
    exact ties.  ``pts``, ``normals`` [B, Q, 3] and ``planes`` [B, 22, F]
    float32, centered."""
    eps = float(eps)
    n_b, n_q = pts.shape[:2]
    out = torch.empty((n_b, n_q), dtype=torch.int32, device=pts.device)
    for b0, b1, q0, q1 in _chunks(n_b, n_q, planes.shape[-1], pts.device):
        p = pts[b0:b1, q0:q1]
        n = normals[b0:b1, q0:q1]
        rows = [planes[b0:b1, k, None, :] for k in range(N_NW_ROWS)]
        cost = _nw_cost_tile(p[..., 0:1], p[..., 1:2], p[..., 2:3],
                             n[..., 0:1], n[..., 1:2], n[..., 2:3], rows,
                             eps, degenerate_tail)
        out[b0:b1, q0:q1] = torch.argmin(cost, dim=-1).to(torch.int32)
    return out


def argmin_normal_weighted(pts, normals, planes, eps=0.1,
                           degenerate_tail=True):
    """The face of least blended cost per query: the
    ``normal_weighted_faces`` CUDA kernel for CUDA tensors, its plain
    version for CPU tensors.  Shapes as ``argmin_normal_weighted_plain``."""
    check_with_vectors(pts, normals, planes, N_NW_ROWS,
                       "normal_weighted_faces")
    if pts.device.type == "cpu":
        return argmin_normal_weighted_plain(pts, normals, planes, eps,
                                            degenerate_tail)
    from .. import _build

    out = torch.empty(pts.shape[:2], dtype=torch.int32, device=pts.device)
    _build.launch("normal_weighted_faces", pts.device, pts, normals, planes,
                  out, *_grid(pts, planes, "normal_weighted_faces"),
                  int(bool(degenerate_tail)), float(eps))
    LAUNCHES["normal_weighted_faces"] += 1
    return out


def normal_weighted_epilogue(best, tri, pts, center):
    """Exact closest point on each winner, un-centered -> (face, point)."""
    rows = torch.arange(best.shape[0], device=best.device)[:, None]
    win = tri[rows, best.long()]                         # [B, Q, 3, 3]
    point, _, _ = closest_point_on_triangle(
        pts, win[..., 0, :], win[..., 1, :], win[..., 2, :])
    return best, point + center


def _nearest_normal_weighted(v, f, points, normals, eps,
                             assume_nondegenerate, argmin):
    vb, pb, unbatch = _batched(v, points)
    pts, nrm, planes, tri, center = normal_weighted_operands(vb, f, pb,
                                                             normals)
    best = argmin(pts, nrm, planes, eps, not assume_nondegenerate)
    face, point = normal_weighted_epilogue(best, tri, pts, center)
    if unbatch:
        return face[0], point[0]
    return face, point


def nearest_normal_weighted_kernel(v, f, points, normals, eps=0.1,
                                   assume_nondegenerate=False):
    """(face [..., Q] int32, point [..., Q, 3]) under the blended metric.

    ``v`` [V, 3] with ``points`` and ``normals`` [Q, 3], or a batch ``v``
    [B, V, 3] with [B, Q, 3] (one launch); ``f`` [F, 3] shared.
    ``assume_nondegenerate=True`` drops the degenerate-face tail; it is
    valid only when ``mesh_is_nondegenerate`` says so.  The CUDA kernel on
    the card, its plain version on the CPU."""
    return _nearest_normal_weighted(v, f, points, normals, eps,
                                    assume_nondegenerate,
                                    argmin_normal_weighted)


def nearest_normal_weighted_plain(v, f, points, normals, eps=0.1,
                                  assume_nondegenerate=False):
    """``nearest_normal_weighted_kernel`` with the plain argmin on any
    device."""
    return _nearest_normal_weighted(v, f, points, normals, eps,
                                    assume_nondegenerate,
                                    argmin_normal_weighted_plain)


def nearest_normal_weighted(v, f, points, normals, eps=0.1,
                            assume_nondegenerate=False, device="cuda"):
    """``nearest_normal_weighted_kernel`` on ``device`` for numpy arrays or
    tensors: ``v`` [V, 3], ``f`` [F, 3], ``points`` and ``normals``
    [Q, 3] -> tensors (face [Q] int32, point [Q, 3])."""
    return nearest_normal_weighted_kernel(
        as_tensor(v, device, torch.float32), as_tensor(f, device),
        as_tensor(points, device, torch.float32).reshape(-1, 3),
        as_tensor(normals, device, torch.float32).reshape(-1, 3), eps=eps,
        assume_nondegenerate=assume_nondegenerate)
