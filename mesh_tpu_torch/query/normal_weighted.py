"""Normal-weighted nearest face: the CUDA kernels' wrappers, their plain
PyTorch versions, and the prologue and epilogue around them (counterpart of
mesh_tpu/query/pallas_normal_weighted.py and
mesh_tpu/query/normal_weighted.py).

Per query point p with normal n_p, the face minimizing
``|p - q| + eps * (1 - n_p . n_tri)``, where q is the face's closest point
and n_tri its unit normal: the registration metric of the reference's
``AabbNormalsTree`` (mesh/src/AABB_n_tree.h:40-84).  Query normals are used
as given (the reference does not normalize them); face normals are unit.

The prologue centers on the per-mesh vertex mean and stacks the fast
tile's 19 planes (``closest_kernel.fast_tile_rows``) with the three rows of
the centered faces' unit normals; the epilogue recomputes the winner's
closest point exactly with ``closest_point_on_triangle`` and un-centers it.
Two kernels:

- ``normal_weighted_faces`` (``csrc/normal_weighted_faces.cu`` over
  ``csrc/closest_cull.cuh``): the registration path's kernel, an exact
  per-warp chunk cull, row 1's design (``closest_kernel``) with the query
  normal in each lane and eps as its parameter.  Its operands
  (``normal_weighted_cull_operands``): each mesh's queries in Morton order,
  the chunk records of ``closest_kernel.cull_records`` read from the first
  19 of the 22 planes, and a bound on the face normals' norm per mesh.  A
  lane skips a chunk when the lower bound ``sqrt(max(lb2, 0)) + P_lo`` on
  its costs (``penalty_floor``, the source note of the .cu) exceeds its
  running best; each warp's chunks may be split over ``split`` warps
  whose answers a merge folds in split order.  Its faces are the
  every-face kernel's, bit for bit.
- ``normal_weighted_faces_every`` (``csrc/normal_weighted_faces_every.cu``
  over ``csrc/argmin.cuh``): every face, the oracle that ``chip_smoke.py``
  holds the culled kernel to; no path launches it.

Both keep a running (cost, face) pair per query with a strict ``<``, so the
lowest index wins an exact tie.  The wrappers launch the kernels for CUDA
tensors and take the every-face plain version for CPU tensors
(``argmin_normal_weighted_culled_plain``, the plain version of the cull
with its counts, on request).  ``LAUNCHES`` counts the kernels' launches.
"""

import torch

from ..geometry.cross_product import cross3
from ..geometry.tri_normals import normalize_rows, tri_normals_scaled_t
from ..utils.device import as_tensor
from ..utils.dispatch import pallas_default
from .closest_kernel import (
    CULL_CHUNK,
    N_FACE_ROWS,
    WARP,
    _batched,
    _center_inputs,
    _chunks,
    _cull_lb2,
    _grid,
    _sqdist_tile_fast,
    _warp_vote,
    cull_records,
    fast_tile_rows,
    no_queries,
    query_order,
)
from .point_triangle import closest_point_barycentric, closest_point_on_triangle
from .ray_kernel import check_with_vectors

#: the fast tile's planes, then the unit face normal
N_NW_ROWS = N_FACE_ROWS + 3

#: launches of each CUDA kernel since the counts were last set to 0
LAUNCHES = {"normal_weighted_faces": 0, "normal_weighted_faces_every": 0}

#: the most warps that share one warp's chunks (csrc/normal_weighted_faces.cu
#: kNwMaxSplit)
NW_MAX_SPLIT = 64

#: the split the registration path launches: on an H100 (PERF.md, row 7;
#: tools/ab_nw.py) 32 beat 1, 4 and 16 at phase 8's 65,536 queries, whose
#: planted miss's warp needs half of the chunks
NW_SPLIT = 32

#: the penalty's floor rounds the norms it multiplies up by this factor
#: (1 + 2^-18, 64 units of float32 rounding) and then by an absolute term
#: above the products' underflow (source note of
#: csrc/normal_weighted_faces.cu, item 7); all three are float32 values
_NORM_UP = 1.0 + 2.0 ** -18
_NORM_TINY = 2.0 ** -64
_DOT_TINY = 2.0 ** -100


#: query-chunk elements of the plain cull's seed search at once
_PLAIN_SEED_ELEMS = 1 << 22


def _nw_cost_tile(px, py, pz, qnx, qny, qnz, rows, eps, degenerate_tail):
    """The blended cost on a [..., TQ, TF] tile (reference _nw_cost_tile);
    the kernels' functor in csrc/nw_cost.cuh makes the same operations in
    the same order."""
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
    """Plain PyTorch version of the ``normal_weighted_faces`` kernels,
    every face: the face of least blended cost per query, [B, Q] int32,
    lowest index on exact ties.  ``pts``, ``normals`` [B, Q, 3] and
    ``planes`` [B, 22, F] float32, centered."""
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


# ---------------------------------------------------------------------------
# The chunk cull of ``normal_weighted_faces``: its operands and its plain
# version.  csrc/normal_weighted_faces.cu makes the same float32 operations
# in the same order.

def normal_bounds(planes):
    """[B] float32: per mesh, an upper bound on the norm of every face
    normal of ``planes`` [B, 22, F] (rows 19-21), the largest
    ``fl(|n_tri|) * (1 + 2^-18) + 2^-64`` (NaN when a normal is NaN)."""
    tx, ty, tz = planes[:, N_FACE_ROWS:N_NW_ROWS].unbind(1)
    norm = torch.sqrt(tx * tx + ty * ty + tz * tz)
    return (norm * _NORM_UP + _NORM_TINY).amax(dim=-1)


def normal_weighted_cull_operands(pts, planes, degenerate_tail=True):
    """The cull's operands for the kernel's ``pts`` [B, Q, 3] and ``planes``
    [B, 22, F]: ``qorder`` (``closest_kernel.query_order``), ``records``
    (``closest_kernel.cull_records`` of the first 19 rows, read in place)
    and ``normal_bound`` (``normal_bounds``), with the tail they were made
    for."""
    return {"qorder": query_order(pts),
            "records": cull_records(planes, "fast", degenerate_tail),
            "normal_bound": normal_bounds(planes),
            "degenerate_tail": bool(degenerate_tail)}


def _check_cull(pts, planes, cull, degenerate_tail):
    n_b, n_q = pts.shape[:2]
    n_c = -(-planes.shape[-1] // CULL_CHUNK)
    if cull["degenerate_tail"] != bool(degenerate_tail):
        raise ValueError("normal_weighted_faces: cull operands made for "
                         "tail %s, not %s" % (cull["degenerate_tail"],
                                              bool(degenerate_tail)))
    want = (("qorder", torch.int32, (n_b, n_q)),
            ("records", torch.float32, (n_b, n_c, 12)),
            ("normal_bound", torch.float32, (n_b,)))
    for key, dtype, shape in want:
        t = cull[key]
        if (t.dtype != dtype or not t.is_contiguous()
                or t.device != pts.device or tuple(t.shape) != shape):
            raise ValueError("normal_weighted_faces: want %s %s %s, "
                             "contiguous, on %s; got %s %s on %s" % (
                                 key, shape, dtype, pts.device,
                                 tuple(t.shape), t.dtype, t.device))


def penalty_floor(normals, normal_bound, eps):
    """[B, Q] float32: per query, P_lo = fl(eps (1 - x)), at most the
    computed penalty eps (1 - n_p . n_tri) of every face of its mesh:
    x = +hi for eps >= 0 and -hi otherwise, hi = fl(fl(fl(|n_p|_up
    normal_bound) (1 + 2^-18)) + 2^-100) an upper bound on the computed
    |n_p . n_tri|, with |n_p|_up = fl(fl(fl(|n_p|) (1 + 2^-18)) + 2^-64).
    ``normals`` [B, Q, 3]; NaN propagates.  The sign test reads eps as
    the kernel's float32 parameter."""
    eps = float(torch.tensor(float(eps), dtype=torch.float32))
    nx, ny, nz = normals.unbind(-1)
    norm = torch.sqrt(nx * nx + ny * ny + nz * nz)
    up = norm * _NORM_UP + _NORM_TINY
    hi = (up * normal_bound[:, None]) * _NORM_UP + _DOT_TINY
    return eps * (1.0 - (hi if eps >= 0 else -hi))


def _nw_bound(lb2, plo):
    """The kernel's lower bound on a lane's costs over a chunk:
    ``sqrt(max(lb2, 0)) + plo``, and -inf (always needed) where ``lb2`` is
    -inf (past ``CULL_FAR``) or NaN."""
    lb = torch.sqrt(torch.clamp_min(lb2, 0.0)) + plo
    return torch.where(lb2 > float("-inf"), lb,
                       torch.full_like(lb, float("-inf")))


def _needed(lb, thr):
    """Whether a lane needs a chunk: ``!(lb > thr)``, so that a NaN bound
    or threshold is always needed."""
    return ~(lb > thr)


def _check_split(split):
    if not 1 <= int(split) <= NW_MAX_SPLIT:
        raise ValueError("normal_weighted_faces: split %r not in [1, %d]"
                         % (split, NW_MAX_SPLIT))
    return int(split)


def argmin_normal_weighted_culled_plain(pts, normals, planes, cull, eps=0.1,
                                        degenerate_tail=True, split=1):
    """Plain PyTorch version of the ``normal_weighted_faces`` kernel's
    chunk cull: (face of least blended cost per query [B, Q] int32, chunks
    each warp folded [B, ceil(Q / 32)] int32, real faces of the chunks each
    query's own lane needed [B, Q] int32 at its sorted position, chunks
    each warp staged [B, ceil(Q / 32)] int32), the counts summed over the
    splits.  The faces are ``argmin_normal_weighted_plain``'s.

    Queries run in ``cull["qorder"]``, 32 to a warp.  Each lane is seeded
    with the cost of the first face of the chunk whose corner a is nearest
    (a NaN distance counts as +inf).  The chunks are cut into ``split``
    ranges [C s / split, C (s + 1) / split), each folded from (+inf, 0) in
    index order: a lane needs chunk k unless its bound (``_nw_bound`` of
    ``closest_kernel._cull_lb2`` and ``penalty_floor``) exceeds min(best,
    seed); a warp stages chunk k when one of its lanes needs it against the
    state before the last chunk it staged (the kernel votes one chunk
    ahead), and folds a staged chunk, every lane of it, when one of its
    lanes needs it against the state now.  The fold is torch.argmin's
    (strict < in increasing face order, a NaN cost winning as torch.argmin
    has it), and the ranges' results merge in split order by the same
    rule."""
    split = _check_split(split)
    eps = float(eps)
    n_b, n_q = pts.shape[:2]
    n_f = planes.shape[-1]
    n_c = -(-n_f // CULL_CHUNK)
    dev = pts.device
    q_pad = -(-n_q // WARP) * WARP
    warp = torch.zeros((n_b, q_pad // WARP), dtype=torch.int32, device=dev)
    lane = torch.zeros((n_b, q_pad), dtype=torch.int32, device=dev)
    stage = torch.zeros_like(warp)
    valid = torch.arange(q_pad, device=dev) < n_q
    qo = cull["qorder"].long()

    def lanes(x):           # [B, Q, 3] in lane order, zero padded
        out = torch.zeros((n_b, q_pad, 3), dtype=x.dtype, device=dev)
        out[:, :n_q] = torch.gather(x, 1, qo[..., None].expand(n_b, n_q, 3))
        return out

    ps, ns = lanes(pts), lanes(normals)
    px, py, pz = ps.unbind(-1)
    nx, ny, nz = ns.unbind(-1)
    plo = penalty_floor(ns, cull["normal_bound"], eps)
    rec = cull["records"]
    # the seed: the cost of the nearest representative's face, found in
    # blocks of lanes
    fs = torch.empty((n_b, q_pad), dtype=torch.long, device=dev)
    step = max(1, _PLAIN_SEED_ELEMS // max(1, n_b * n_c))
    for q0 in range(0, q_pad, step):
        q1 = min(q_pad, q0 + step)
        dx = px[:, q0:q1, None] - rec[:, None, :, 8]
        dy = py[:, q0:q1, None] - rec[:, None, :, 9]
        dz = pz[:, q0:q1, None] - rec[:, None, :, 10]
        rep = torch.nan_to_num(dx * dx + dy * dy + dz * dz,
                               nan=float("inf"))
        fs[:, q0:q1] = torch.argmin(rep, dim=-1) * CULL_CHUNK
    face = torch.gather(planes, 2, fs[:, None, :].expand(n_b, N_NW_ROWS,
                                                         q_pad))
    seed = _nw_cost_tile(px, py, pz, nx, ny, nz, face.unbind(1), eps,
                         degenerate_tail)
    parts = []
    for s in range(split):
        best = torch.full((n_b, q_pad), float("inf"), device=dev)
        best_i = torch.zeros((n_b, q_pad), dtype=torch.int32, device=dev)
        snap = best.clone()
        for k in range(n_c * s // split, n_c * (s + 1) // split):
            lb = _nw_bound(_cull_lb2(px, py, pz, rec[:, None, k]), plo)
            vote = _warp_vote(_needed(lb, torch.fmin(snap, seed)) & valid)
            if not bool(vote.any()):
                continue
            stage += vote.to(torch.int32)
            snap = torch.where(vote.repeat_interleave(WARP, -1), best, snap)
            need = _needed(lb, torch.fmin(best, seed)) & valid
            folds = _warp_vote(need)
            c0 = k * CULL_CHUNK
            nf = min(CULL_CHUNK, n_f - c0)
            warp += folds.to(torch.int32)
            lane += need.to(torch.int32) * nf
            if not bool(folds.any()):
                continue
            bi, qi = torch.nonzero(folds.repeat_interleave(WARP, -1),
                                   as_tuple=True)
            cost = _nw_cost_tile(
                px[bi, qi, None], py[bi, qi, None], pz[bi, qi, None],
                nx[bi, qi, None], ny[bi, qi, None], nz[bi, qi, None],
                planes[bi, :, c0:c0 + nf].unbind(1), eps, degenerate_tail)
            arg = torch.argmin(cost, dim=-1)
            low = torch.gather(cost, -1, arg[:, None])[:, 0]
            cur = best[bi, qi]
            take = (low < cur) | (torch.isnan(low) & ~torch.isnan(cur))
            best[bi, qi] = torch.where(take, low, cur)
            best_i[bi, qi] = torch.where(take, (arg + c0).to(torch.int32),
                                         best_i[bi, qi])
        parts.append((best, best_i))
    best, best_i = parts[0]
    for d, i in parts[1:]:
        take = (d < best) | (torch.isnan(d) & ~torch.isnan(best))
        best = torch.where(take, d, best)
        best_i = torch.where(take, i, best_i)
    out = torch.zeros((n_b, n_q), dtype=torch.int32, device=dev)
    out.scatter_(1, qo, best_i[:, :n_q])
    return out, warp, lane[:, :n_q], stage


def argmin_normal_weighted(pts, normals, planes, eps=0.1,
                           degenerate_tail=True, cull=None, with_stats=False,
                           split=None):
    """The face of least blended cost per query: the
    ``normal_weighted_faces`` CUDA kernel, the exact chunk cull, for CUDA
    tensors; ``argmin_normal_weighted_plain`` for CPU tensors.  Shapes as
    ``argmin_normal_weighted_plain``.  ``cull``: the operands of
    ``normal_weighted_cull_operands`` (made here when None); ``split``:
    warps sharing one warp's chunks (``NW_SPLIT`` when None);
    ``with_stats`` returns the four outputs of
    ``argmin_normal_weighted_culled_plain`` (which a CPU call runs then)."""
    check_with_vectors(pts, normals, planes, N_NW_ROWS,
                       "normal_weighted_faces")
    split = _check_split(NW_SPLIT if split is None else split)
    if pts.device.type == "cpu" and not with_stats:
        return argmin_normal_weighted_plain(pts, normals, planes, eps,
                                            degenerate_tail)
    if not pts.shape[1]:
        return no_queries(pts.shape[0], pts.device, 4 if with_stats else 1)
    if cull is None:
        cull = normal_weighted_cull_operands(pts, planes, degenerate_tail)
    _check_cull(pts, planes, cull, degenerate_tail)
    if pts.device.type == "cpu":
        return argmin_normal_weighted_culled_plain(
            pts, normals, planes, cull, eps, degenerate_tail, split)
    from .. import _build

    n_b, n_q, n_f = _grid(pts, planes, "normal_weighted_faces")
    dev = pts.device
    out = torch.empty((n_b, n_q), dtype=torch.int32, device=dev)
    seeds = torch.empty((n_b, n_q), dtype=torch.float32, device=dev)
    part_d = part_i = None
    if split > 1:
        part_d = torch.empty((split, n_b, n_q), dtype=torch.float32,
                             device=dev)
        part_i = torch.empty((split, n_b, n_q), dtype=torch.int32,
                             device=dev)
    stats = tuple(
        torch.empty((split, n_b, -(-n_q // size)), dtype=torch.int32,
                    device=dev) for size in (WARP, 1, WARP)
    ) if with_stats else (None, None, None)
    _build.launch("normal_weighted_faces", dev, pts, normals,
                  cull["qorder"], planes, cull["records"],
                  cull["normal_bound"], seeds, part_d, part_i, out, *stats,
                  n_b, n_q, n_f, int(bool(degenerate_tail)), split,
                  float(eps))
    LAUNCHES["normal_weighted_faces"] += 1
    if not with_stats:
        return out
    return (out,) + tuple(t.sum(dim=0, dtype=torch.int32) for t in stats)


def argmin_normal_weighted_every(pts, normals, planes, eps=0.1,
                                 degenerate_tail=True):
    """The face of least blended cost per query over every face: the
    ``normal_weighted_faces_every`` CUDA kernel (the cull's oracle; no
    path launches it) for CUDA tensors, ``argmin_normal_weighted_plain``
    for CPU tensors."""
    check_with_vectors(pts, normals, planes, N_NW_ROWS,
                       "normal_weighted_faces_every")
    if pts.device.type == "cpu":
        return argmin_normal_weighted_plain(pts, normals, planes, eps,
                                            degenerate_tail)
    from .. import _build

    out = torch.empty(pts.shape[:2], dtype=torch.int32, device=pts.device)
    _build.launch("normal_weighted_faces_every", pts.device, pts, normals,
                  planes, out,
                  *_grid(pts, planes, "normal_weighted_faces_every"),
                  int(bool(degenerate_tail)), float(eps))
    LAUNCHES["normal_weighted_faces_every"] += 1
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


def nearest_normal_weighted_xla(v, f, points, normals, eps=0.1, chunk=512):
    """The reference's XLA form (mesh_tpu/query/normal_weighted.py:24) on
    tensors on their own device: ``v`` [V, 3], ``f`` [F, 3], ``points``
    and ``normals`` [Q, 3] -> (face [Q] int32, point [Q, 3]).  Each chunk
    of queries materializes [chunk, F] reconstruction-form closest points
    and costs; the lowest face wins an exact tie."""
    points = points.to(v.dtype)
    normals = normals.to(v.dtype)
    f = f.long()
    tri = v[f]
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    tn = normalize_rows(tri_normals_scaled_t(v, f))            # [F, 3] unit
    faces, pts_out = [], []
    for q0 in range(0, max(points.shape[0], 1), chunk):
        pts = points[q0:q0 + chunk]
        nrm = normals[q0:q0 + chunk]
        bary, _ = closest_point_barycentric(pts[:, None, :], a[None],
                                            b[None], c[None])
        cp = (bary[..., 0:1] * a[None] + bary[..., 1:2] * b[None]
              + bary[..., 2:3] * c[None])                   # [chunk, F, 3]
        diff = pts[:, None, :] - cp
        d_euclid = (diff * diff).sum(dim=-1).sqrt()
        penalty = eps * (1.0 - (nrm[:, None, :] * tn[None]).sum(dim=-1))
        best = torch.argmin(d_euclid + penalty, dim=-1)
        faces.append(best.to(torch.int32))
        pts_out.append(cp.gather(1, best[:, None, None].expand(-1, 1, 3))[:, 0])
    return torch.cat(faces), torch.cat(pts_out)


def nearest_normal_weighted(v, f, points, normals, eps=0.1,
                            assume_nondegenerate=False, device="cuda"):
    """``nearest_normal_weighted_kernel`` on ``device`` for numpy arrays or
    tensors: ``v`` [V, 3], ``f`` [F, 3], ``points`` and ``normals``
    [Q, 3] -> tensors (face [Q] int32, point [Q, 3]); under
    ``MESH_TPU_FORCE_XLA`` the reference's XLA form."""
    args = (as_tensor(v, device, torch.float32), as_tensor(f, device),
            as_tensor(points, device, torch.float32).reshape(-1, 3),
            as_tensor(normals, device, torch.float32).reshape(-1, 3))
    if not pallas_default(device):
        return nearest_normal_weighted_xla(*args, eps=eps)
    return nearest_normal_weighted_kernel(
        *args, eps=eps, assume_nondegenerate=assume_nondegenerate)
