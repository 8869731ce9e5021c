"""The MXU rung of the closest-point ladder: the CUDA kernels' wrappers, their
plain PyTorch versions, and the staging around them (counterpart of the MXU
half of mesh_tpu/query/pallas_closest.py, :720-1186).

On the TPU this rung computes the fast tile's four query-dependent dot
products (ab.p, ac.p, n.p, a.p) by one matrix product per tile, and can put
a bf16 screen in front of the exact pass.  Three kernels:

- ``mxu_faces`` (``csrc/mxu_faces.cu``, row 3): the dense exact scan, the
  closest face per query by the MXU-form cost
  (``ap2 = max(p2 - 2 p.a + a2, 0)`` and the fast tile's Ericson tail);
- ``mxu_bound`` (``csrc/mxu_bound.cu``, row 4): the bf16 bound pass, per
  query an upper bound ``ub`` on the closest squared distance and per
  (query, face tile) a certificate ``cert``, a lower bound on the
  distance of every face of the tile, under the envelope
  ``E = 2^-6 (p2 + a2)`` (``MXU_BF16_EPS``);
- ``mxu_repair`` (``csrc/mxu_repair.cu``, row 5): the dense scan over the
  face tiles that some query of a tile_q block may still win
  (``cert <= sqrt(ub)``), bit-identical to ``mxu_faces``.

On the card the dot products are CUDA-core float32 (no tensor cores): the
kernels and the plain versions make the same operations in the same order,
each dot product written ``px*gx + py*gy + pz*gz``, never a matrix product,
whose order and TF32 use are not fixed.  Built without FMA, each kernel
equals its plain version.  The wrappers ``mxu_faces`` / ``mxu_bound`` /
``mxu_repair`` launch the kernel for CUDA tensors and take the plain
version for CPU tensors; any other device raises.  ``LAUNCHES`` counts each
kernel's launches.

The face side (centering, the face record, the reach) depends only on the
mesh and is cached by a blake2b digest of its bytes (``_MXU_FACE_CACHE``,
FIFO of 16), as the reference caches its staging.
"""

import hashlib

import numpy as np
import torch

from ..geometry.cross_product import cross3
from ..utils.device import as_tensor, host_array, resolve_device
from .closest_kernel import (
    _PLAIN_PAIRS,
    _ericson_tail,
    fast_tile_rows,
    winner_epilogue,
)

#: launches of each CUDA kernel since the counts were last set to 0
LAUNCHES = {"mxu_faces": 0, "mxu_bound": 0, "mxu_repair": 0}

#: the certified envelope of the bf16 screen (the reference's derivation,
#: mesh_tpu/query/pallas_closest.py:828-837): |ap2~ - ap2| <= 2^-6 (p2 + a2)
MXU_BF16_EPS = 2.0 ** -6

#: per-face planes beside the dot-product operand, and the floats of one
#: face record: ab ac n a (the reference's G operand), the 11 planes, reach
N_FACE_ROWS_MXU = 11
MXU_RECORD = 24

#: the reference's tile shape; tile_q is also the kernels' block size
TILE_Q = 256
TILE_F = 2048
MAX_TILE_Q = 256


# ---------------------------------------------------------------------------
# Staging: the per-face record and its digest cache.

def _mxu_plane_rows(tri):
    """The 11 per-face planes of the MXU tile for ``tri`` [F, 3, 3]: the
    corner-a projections a.ab, a.ac, a.n, a2, and the 7 Ericson constants
    that ``fast_tile_rows`` shares (its rows 12-18)."""
    a = tri[..., 0, :]
    ab = tri[..., 1, :] - a
    ac = tri[..., 2, :] - a
    n = cross3(ab, ac)
    planes = [(a * ab).sum(dim=-1), (a * ac).sum(dim=-1),
              (a * n).sum(dim=-1), (a * a).sum(dim=-1),
              *fast_tile_rows(tri)[12:]]
    assert len(planes) == N_FACE_ROWS_MXU
    return planes


def _mxu_reach_row(tri):
    """Per-face reach from corner a, ``r = sqrt(max(ab2, ac2))``: the
    farthest point of a triangle from a corner is a vertex, so
    ``d_tri >= |p - a| - r`` turns the screen's corner bound into a face
    bound."""
    ab = tri[..., 1, :] - tri[..., 0, :]
    ac = tri[..., 2, :] - tri[..., 0, :]
    return torch.maximum((ab * ab).sum(dim=-1), (ac * ac).sum(dim=-1)).sqrt()


def _mxu_face_inputs(tri):
    """The kernels' face operand for ``tri`` [F, 3, 3]: one contiguous
    float32 record of ``MXU_RECORD`` floats per face, [F, 24]: the dot
    operand ab | ac | n | a (12), the 11 planes of ``_mxu_plane_rows`` and
    the reach (the column layout of ``csrc/mxu_cost.cuh``)."""
    a = tri[..., 0, :]
    ab = tri[..., 1, :] - a
    ac = tri[..., 2, :] - a
    n = cross3(ab, ac)
    cols = [ab[..., k] for k in range(3)] + [ac[..., k] for k in range(3)]
    cols += [n[..., k] for k in range(3)] + [a[..., k] for k in range(3)]
    cols += _mxu_plane_rows(tri) + [_mxu_reach_row(tri)]
    assert len(cols) == MXU_RECORD
    return torch.stack(cols, dim=-1).to(torch.float32).contiguous()


#: digest-keyed staging: (device, shapes, blake2b of the float32 vertices
#: and int64 faces) -> (center, tri, record), device tensors; bounded FIFO
_MXU_FACE_CACHE = {}
_MXU_FACE_CACHE_MAX = 16


def _mxu_staged_inputs(v, f, device):
    """(center [1, 1, 3], tri [1, F, 3, 3], record [F, 24]) on ``device``
    for the mesh ``v`` [V, 3], ``f`` [F, 3] (numpy arrays or tensors),
    centered on the vertex mean as ``closest_point_kernel`` centers, and
    cached by a digest of the mesh's bytes: repeated queries on an
    unchanged mesh skip the face-side work."""
    v_np = np.ascontiguousarray(host_array(v, np.float32))
    f_np = np.ascontiguousarray(host_array(f, np.int64))
    digest = hashlib.blake2b(digest_size=16)
    digest.update(v_np.tobytes())
    digest.update(b"\0")
    digest.update(f_np.tobytes())
    key = (str(device), v_np.shape, f_np.shape, digest.digest())
    hit = _MXU_FACE_CACHE.get(key)
    if hit is not None:
        return hit
    if f_np.ndim != 2 or f_np.shape[0] == 0 or f_np.shape[1] != 3:
        raise ValueError("the MXU rung wants faces [F, 3] with F > 0, got %r"
                         % (f_np.shape,))
    vb = (v if torch.is_tensor(v) and v.device == device
          else torch.as_tensor(v_np, device=device)).to(torch.float32)[None]
    center = vb.mean(dim=-2, keepdim=True)
    ft = (f if torch.is_tensor(f) and f.device == device
          else torch.as_tensor(f_np, device=device)).long()
    tri = (vb - center)[..., ft, :]
    staged = (center, tri, _mxu_face_inputs(tri[0]))
    if len(_MXU_FACE_CACHE) >= _MXU_FACE_CACHE_MAX:
        _MXU_FACE_CACHE.pop(next(iter(_MXU_FACE_CACHE)))
    _MXU_FACE_CACHE[key] = staged
    return staged


# ---------------------------------------------------------------------------
# Per-pair costs: the plain versions' tiles.  p is [..., n, 3] and each
# record column [..., 1, TF]; each returns [..., n, TF].  csrc/mxu_cost.cuh
# and csrc/mxu_bound.cu do the same operations in the same order.

def _query_planes(p):
    px, py, pz = p[..., 0:1], p[..., 1:2], p[..., 2:3]
    return px, py, pz, px * px + py * py + pz * pz


def _sqdist_tile_mxu(p, cols, degenerate_tail=True):
    """The MXU tile's squared distance: the four dot products in float32,
    then the fast tile's Ericson tail (reference _sqdist_tile_mxu)."""
    (abx, aby, abz, acx, acy, acz, nx, ny, nz, ax, ay, az,
     a_ab, a_ac, a_n, a2, ab2, ac2, abac, inv_ab2, inv_ac2, inv_bc2,
     inv_n2) = cols[:23]
    px, py, pz, p2 = _query_planes(p)
    d1 = (px * abx + py * aby + pz * abz) - a_ab
    d2 = (px * acx + py * acy + pz * acz) - a_ac
    n_ap = (px * nx + py * ny + pz * nz) - a_n
    pa = px * ax + py * ay + pz * az
    ap2 = torch.clamp_min(p2 - (pa + pa) + a2, 0.0)
    return _ericson_tail(d1, d2, ap2, n_ap, ab2, ac2, abac, inv_ab2, inv_ac2,
                         inv_bc2, inv_n2, degenerate_tail=degenerate_tail)


def _bf16(x):
    """``x`` rounded to bfloat16 (to nearest even) and back to float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _mxu_ap2_env(p, cols):
    """The bf16 screen's corner distance ``ap2~`` (p and a rounded to bf16,
    their exact products summed in float32; p2 and a2 unrounded) and its
    envelope ``E`` (reference _mxu_ap2_env)."""
    px, py, pz, p2 = _query_planes(p)
    bx, by, bz = _bf16(px), _bf16(py), _bf16(pz)
    ax, ay, az = _bf16(cols[9]), _bf16(cols[10]), _bf16(cols[11])
    a2 = cols[15]
    pa = bx * ax + by * ay + bz * az
    ap2t = torch.clamp_min(p2 - (pa + pa) + a2, 0.0)
    env = MXU_BF16_EPS * (p2 + a2)
    return ap2t, env


def _cols(rec, f0=0, f1=None):
    """The record's columns over faces [f0, f1), each [1, TF]."""
    return [rec[None, f0:f1, k] for k in range(MXU_RECORD)]


def _row_chunks(n_rows, n_cols, device):
    """[r0, r1) spans of rows with at most _PLAIN_PAIRS pairs each."""
    step = max(1, _PLAIN_PAIRS[device.type] // max(1, n_cols))
    for r0 in range(0, n_rows, step):
        yield r0, min(n_rows, r0 + step)


# ---------------------------------------------------------------------------
# The three steps: plain version, and the wrapper that launches the kernel.

def _check(p, rec, tile_q, tile_f, name):
    """Raise ValueError on operands the kernel ``name`` does not take
    (``tile_q`` None: the bound pass, which has no query tiles)."""
    if p.device != rec.device:
        raise ValueError("%s: operands on %s and %s"
                         % (name, p.device, rec.device))
    for t in (p, rec):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("%s wants contiguous float32 operands, got %s"
                             % (name, t.dtype))
    if (p.ndim != 2 or p.shape[-1] != 3 or rec.ndim != 2
            or rec.shape[-1] != MXU_RECORD or rec.shape[0] == 0):
        raise ValueError("%s: want p [N, 3] and a face record [F > 0, %d], "
                         "got %r and %r" % (name, MXU_RECORD, tuple(p.shape),
                                            tuple(rec.shape)))
    if tile_f <= 0 or tile_q is not None and not (
            0 < tile_q <= MAX_TILE_Q and tile_q % 32 == 0
            and p.shape[0] % tile_q == 0):
        raise ValueError("%s: want tile_q a multiple of 32 up to %d that "
                         "divides the %d queries, and tile_f > 0; got %r, %r"
                         % (name, MAX_TILE_Q, p.shape[0], tile_q, tile_f))
    if p.device.type not in ("cpu", "cuda"):
        raise ValueError("%s: no kernel for device %s" % (name, p.device))
    if p.device.type == "cuda" and rec.data_ptr() % 16:
        raise ValueError("%s: the face record must be 16-byte aligned" % name)


def mxu_faces_plain(p, rec, tile_q=TILE_Q, tile_f=TILE_F,
                    degenerate_tail=True):
    """Plain PyTorch version of the ``mxu_faces`` kernel: index of the
    closest face per query, [N] int32, lowest index on exact ties.  ``p``
    [N, 3] and ``rec`` [F, 24] float32, centered; the tile shape does not
    change the result."""
    _check(p, rec, tile_q, tile_f, "mxu_faces")
    cols = _cols(rec)
    out = torch.empty(p.shape[0], dtype=torch.int32, device=p.device)
    for r0, r1 in _row_chunks(p.shape[0], rec.shape[0], p.device):
        cost = _sqdist_tile_mxu(p[r0:r1], cols, degenerate_tail)
        out[r0:r1] = torch.argmin(cost, dim=-1).to(torch.int32)
    return out


def mxu_faces(p, rec, tile_q=TILE_Q, tile_f=TILE_F, degenerate_tail=True):
    """Index of the closest face per query: the ``mxu_faces`` CUDA kernel
    for CUDA tensors, its plain version for CPU tensors."""
    _check(p, rec, tile_q, tile_f, "mxu_faces")
    if p.device.type == "cpu":
        return mxu_faces_plain(p, rec, tile_q, tile_f, degenerate_tail)
    from .. import _build

    out = torch.empty(p.shape[0], dtype=torch.int32, device=p.device)
    _build.launch("mxu_faces", p.device, p, rec, out, p.shape[0],
                  rec.shape[0], tile_q, tile_f, int(bool(degenerate_tail)))
    LAUNCHES["mxu_faces"] += 1
    return out


def _n_tiles(rec, tile_f):
    return -(-rec.shape[0] // tile_f)


def mxu_bound_plain(p, rec, tile_f=TILE_F):
    """Plain PyTorch version of the ``mxu_bound`` kernel: (ub [N], cert
    [N, ceil(F / tile_f)]) float32, ``ub[q] = min_f ap2~ + E`` and
    ``cert[q, t] = min over tile t of sqrt(max(ap2~ - E, 0)) - r``; both
    minima propagate NaN."""
    _check(p, rec, None, tile_f, "mxu_bound")
    n_tiles = _n_tiles(rec, tile_f)
    cols = _cols(rec)
    ub = torch.empty(p.shape[0], dtype=torch.float32, device=p.device)
    cert = torch.empty((p.shape[0], n_tiles), dtype=torch.float32,
                       device=p.device)
    for r0, r1 in _row_chunks(p.shape[0], rec.shape[0], p.device):
        ap2t, env = _mxu_ap2_env(p[r0:r1], cols)
        ub[r0:r1] = torch.amin(ap2t + env, dim=-1)
        m = torch.sqrt(torch.clamp_min(ap2t - env, 0.0)) - cols[23]
        for t in range(n_tiles):
            cert[r0:r1, t] = torch.amin(m[:, t * tile_f:(t + 1) * tile_f],
                                        dim=-1)
    return ub, cert


def mxu_bound(p, rec, tile_f=TILE_F):
    """(ub, cert) of the bound pass: the ``mxu_bound`` CUDA kernel for CUDA
    tensors, its plain version for CPU tensors."""
    _check(p, rec, None, tile_f, "mxu_bound")
    if p.device.type == "cpu":
        return mxu_bound_plain(p, rec, tile_f)
    from .. import _build

    ub = torch.empty(p.shape[0], dtype=torch.float32, device=p.device)
    cert = torch.empty((p.shape[0], _n_tiles(rec, tile_f)),
                       dtype=torch.float32, device=p.device)
    _build.launch("mxu_bound", p.device, p, rec, ub, cert, p.shape[0],
                  rec.shape[0], tile_f)
    LAUNCHES["mxu_bound"] += 1
    return ub, cert


def survivors(ub, cert, tile_q=TILE_Q):
    """[N / tile_q, n_tiles] bool: the (query tile, face tile) blocks the
    repair runs, those where some query has ``cert <= sqrt(max(ub, 0))``
    (the reference's ``jnp.any(m <= su)``)."""
    su = torch.sqrt(torch.clamp_min(ub, 0.0))
    keep = cert <= su[:, None]
    return keep.reshape(-1, tile_q, cert.shape[1]).any(dim=1)


def _check_screen(p, rec, ub, cert, tile_q, tile_f, name):
    _check(p, rec, tile_q, tile_f, name)
    n_q = p.shape[0]
    if (ub.shape != (n_q,) or cert.shape != (n_q, _n_tiles(rec, tile_f))
            or ub.dtype != torch.float32 or cert.dtype != torch.float32
            or not (ub.is_contiguous() and cert.is_contiguous())
            or ub.device != p.device or cert.device != p.device):
        raise ValueError("%s: want ub [%d] and cert [%d, %d] float32 "
                         "beside p, got %r and %r" % (
                             name, n_q, n_q, _n_tiles(rec, tile_f),
                             tuple(ub.shape), tuple(cert.shape)))


def mxu_repair_plain(p, rec, ub, cert, tile_q=TILE_Q, tile_f=TILE_F,
                     degenerate_tail=True):
    """Plain PyTorch version of the ``mxu_repair`` kernel: (index of the
    closest face per query [N] int32, face tiles run per query tile
    [N / tile_q] int32).  Face tiles are merged in increasing order with a
    strict <, each a first argmin, so the faces equal ``mxu_faces_plain``'s
    whenever the screen keeps every winner."""
    _check_screen(p, rec, ub, cert, tile_q, tile_f, "mxu_repair")
    surv = survivors(ub, cert, tile_q)
    best_d = torch.full((p.shape[0],), float("inf"), device=p.device)
    best_i = torch.zeros(p.shape[0], dtype=torch.int32, device=p.device)
    lane = torch.arange(tile_q, device=p.device)
    for t in range(surv.shape[1]):
        blocks = surv[:, t].nonzero()[:, 0]
        if blocks.numel() == 0:
            continue
        rows = (blocks[:, None] * tile_q + lane).reshape(-1)
        f0, f1 = t * tile_f, min(rec.shape[0], (t + 1) * tile_f)
        cols = _cols(rec, f0, f1)
        for r0, r1 in _row_chunks(rows.numel(), f1 - f0, p.device):
            sel = rows[r0:r1]
            tile_min, tile_arg = torch.min(
                _sqdist_tile_mxu(p[sel], cols, degenerate_tail), dim=-1)
            better = tile_min < best_d[sel]
            best_d[sel] = torch.where(better, tile_min, best_d[sel])
            best_i[sel] = torch.where(better, (tile_arg + f0).to(torch.int32),
                                      best_i[sel])
    return best_i, surv.sum(dim=1).to(torch.int32)


def mxu_repair(p, rec, ub, cert, tile_q=TILE_Q, tile_f=TILE_F,
               degenerate_tail=True):
    """(faces, tiles run per query tile) of the exact repair: the
    ``mxu_repair`` CUDA kernel for CUDA tensors, its plain version for CPU
    tensors."""
    _check_screen(p, rec, ub, cert, tile_q, tile_f, "mxu_repair")
    if p.device.type == "cpu":
        return mxu_repair_plain(p, rec, ub, cert, tile_q, tile_f,
                                degenerate_tail)
    from .. import _build

    out = torch.empty(p.shape[0], dtype=torch.int32, device=p.device)
    rep = torch.empty(p.shape[0] // tile_q, dtype=torch.int32,
                      device=p.device)
    _build.launch("mxu_repair", p.device, p, rec, ub, cert, out, rep,
                  p.shape[0], rec.shape[0], tile_q, tile_f,
                  int(bool(degenerate_tail)))
    LAUNCHES["mxu_repair"] += 1
    return out, rep


# ---------------------------------------------------------------------------
# Whole queries: staging, the query prologue, the kernels, the epilogue.

def mxu_operands(v, f, points, tile_q=TILE_Q, device="cuda"):
    """The prologue of an MXU query: (p [N, 3], record [F, 24], tri, pts,
    center) on ``device``: ``p`` is the centered queries padded with the
    origin to a multiple of ``tile_q`` (the reference's padding, which the
    repair's block vote sees), ``pts`` [1, Q, 3] the centered queries."""
    dev = resolve_device(device)
    center, tri, rec = _mxu_staged_inputs(v, f, dev)
    pts = as_tensor(points, dev, torch.float32).reshape(1, -1, 3) - center
    n_q = pts.shape[1]
    p = torch.zeros((-(-n_q // tile_q) * tile_q, 3), dtype=torch.float32,
                    device=dev)
    p[:n_q] = pts[0]
    return p, rec, tri, pts, center


def mxu_epilogue(best, tri, pts, center):
    """The winners' exact point, part and squared distance
    (``winner_epilogue``) for the first Q of the padded queries."""
    res = winner_epilogue(best[None, :pts.shape[1]], tri, pts, center)
    return {key: val[0] for key, val in res.items()}


def closest_point_mxu_kernel(v, f, points, *, assume_nondegenerate=False,
                             tile_q=TILE_Q, tile_f=TILE_F, device="cuda"):
    """Closest face, part code, point and squared distance per query on the
    MXU rung's dense scan (``mxu_faces``).

    ``v`` [V, 3], ``f`` [F, 3] and ``points`` [Q, 3] may be numpy arrays or
    tensors; returns a dict of tensors on ``device``: ``face`` [Q] int32,
    ``part`` [Q] int32, ``point`` [Q, 3], ``sqdist`` [Q].
    ``assume_nondegenerate=True`` drops the degenerate-face tail, valid
    only when ``mesh_is_nondegenerate`` says so.  The CUDA kernel runs on
    the card (the default); ``device="cpu"`` takes its plain version."""
    p, rec, tri, pts, center = mxu_operands(v, f, points, tile_q, device)
    best = mxu_faces(p, rec, tile_q, tile_f, not assume_nondegenerate)
    return mxu_epilogue(best, tri, pts, center)


def closest_point_mxu_repair_kernel(v, f, points, *,
                                    assume_nondegenerate=False,
                                    tile_q=TILE_Q, tile_f=TILE_F,
                                    with_stats=False, device="cuda"):
    """``closest_point_mxu_kernel`` behind the bf16 bound pass: the f32
    exact repair runs only the face tiles the bound pass cannot exclude,
    and its answers equal the dense scan's bit for bit.

    ``with_stats=True`` also returns ``{"screened": face tiles of all
    query tiles, "repaired": those the f32 pass ran}``."""
    p, rec, tri, pts, center = mxu_operands(v, f, points, tile_q, device)
    ub, cert = mxu_bound(p, rec, tile_f)
    best, rep = mxu_repair(p, rec, ub, cert, tile_q, tile_f,
                           not assume_nondegenerate)
    res = mxu_epilogue(best, tri, pts, center)
    if not with_stats:
        return res
    return res, {"screened": int(rep.numel()) * int(cert.shape[1]),
                 "repaired": int(rep.sum())}
