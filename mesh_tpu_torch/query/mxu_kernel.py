"""The MXU rung of the closest-point ladder: the CUDA kernels' wrappers, their
plain PyTorch versions, and the staging around them (counterpart of the MXU
half of mesh_tpu/query/pallas_closest.py, :720-1186).

On the TPU this rung computes the fast tile's four query-dependent dot
products (ab.p, ac.p, n.p, a.p) by one matrix product per tile, and can put
a bf16 screen in front of the exact pass.  Three kernels:

- ``mxu_faces`` (``csrc/mxu_faces.cu`` over ``csrc/mxu_cull.cuh``, row 3):
  the dense exact scan, the closest face per query by the MXU-form cost
  (``ap2 = max(p2 - 2 p.a + a2, 0)`` and the fast tile's Ericson tail),
  by an exact per-warp chunk cull: queries in Morton order, 32 to a warp,
  chunks of ``CULL_CHUNK`` faces skipped when no lane needs them, with
  the every-face kernel's answers bit for bit (``mxu_cull_operands`` and
  the source note of ``csrc/mxu_cull.cuh``);
- ``mxu_bound_culled`` (``csrc/mxu_bound_culled.cu``, row 4): the bf16
  bound pass, per query an upper bound ``ub`` on the closest squared
  distance and per (query, face tile) a certificate ``cert``, a lower
  bound on the distance of every face of the tile, under the envelope
  ``E = 2^-6 (p2 + a2)`` (``MXU_BF16_EPS``), by the same kind of chunk
  cull on the same cull operands;
- ``mxu_repair`` (``csrc/mxu_repair.cu``, row 5): the same chunk cull over
  the face tiles that some query of a tile_q block may still win
  (``cert <= sqrt(ub)``, the mask of ``survivors``), bit-identical to
  ``mxu_faces``.

The culled bound pass's contract, stated against the every-face pass
(``mxu_bound``, ``mxu_bound_plain``) for the same ``p`` (with the origin
padding rows of ``mxu_operands``) and face record:

- ``ub`` is equal bit for bit, NaN where it is NaN;
- ``cert[q, t]`` is equal wherever the every-face value is
  ``<= sqrt(max(ub[q], 0))``, and on every row whose ub is NaN;
  elsewhere both values are ``> sqrt(max(ub[q], 0))``, or both are NaN;
- so ``survivors(ub, cert, tile_q)`` is equal for every query tile, and
  the repair's answers and tile counts do not change on any input.

A NaN a or a2 in one face makes ub NaN for every query and that tile's
cert NaN (every chunk of such a mesh is always folded); a NaN reach makes
its tile NaN (its chunk is always folded); a NaN query makes its row NaN
(its lane folds every chunk).  ``csrc/mxu_bound_culled.cu`` proves the
bounds (items B1-B6).

``mxu_faces_every``, ``mxu_bound`` and ``mxu_repair_every``
(``csrc/mxu_faces_every.cu``, ``csrc/mxu_bound.cu``,
``csrc/mxu_repair_every.cu``) fold every face of every tile they run: the
oracles ``chip_smoke.py`` holds the culled kernels to; no path launches
them.

On the card the dot products are CUDA-core float32 (no tensor cores): the
kernels and the plain versions make the same operations in the same order,
each dot product written ``px*gx + py*gy + pz*gz``, never a matrix product,
whose order and TF32 use are not fixed.  Built without FMA, each kernel
equals its plain version.  The wrappers ``mxu_faces`` /
``mxu_bound_culled`` / ``mxu_repair`` (and the oracles') launch the kernel
for CUDA tensors and take the plain version for CPU tensors (for the
culled kernels the plain versions of their design,
``mxu_faces_culled_plain`` / ``mxu_bound_culled_plain`` /
``mxu_repair_culled_plain``); any other device raises.  ``LAUNCHES``
counts each kernel's launches.

The face side (centering, the face record, the reach) depends only on the
mesh and is cached by a blake2b digest of its bytes (``_MXU_FACE_CACHE``,
FIFO of 16), as the reference caches its staging; the cull's chunk
records and the bound pass's face records are cached beside each face
record (``_MXU_CHUNK_CACHE``).
"""

import hashlib

import numpy as np
import torch

from ..geometry.cross_product import cross3
from ..utils.device import as_tensor, host_array, resolve_device
from .closest_kernel import (
    _CULL_SHRINK2,
    _PLAIN_PAIRS,
    _U,
    CULL_CHUNK,
    CULL_FAR,
    WARP,
    _ericson_tail,
    _warp_vote,
    cull_records,
    fast_tile_rows,
    no_queries,
    query_order,
    winner_epilogue,
)

#: launches of each CUDA kernel since the counts were last set to 0
LAUNCHES = {"mxu_faces": 0, "mxu_faces_every": 0, "mxu_bound": 0,
            "mxu_bound_culled": 0, "mxu_repair": 0, "mxu_repair_every": 0}

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
# The chunk cull of ``mxu_faces`` and ``mxu_repair``: its operands and the
# plain version of its design.  csrc/mxu_cull.cuh makes the same float32
# operations in the same order.

#: floats of one chunk record: ``cull_records``' 12 (box center, half
#: diagonal, half extents, e1, corner a of the first face, e2), the reach
#: from the origin ``|center| + h`` and the bound pass's three: the largest
#: a2, the largest reach and the box's rounding term (``mxu_chunk_records``)
MXU_CHUNK_RECORD = 16

#: the record's columns in ``fast_tile_rows`` order (a, ab, ac, n, ab2,
#: ac2, abac and the four reciprocals): the planes ``cull_records`` reads
_FAST_COLS = (9, 10, 11, 0, 1, 2, 3, 4, 5, 6, 7, 8,
              16, 17, 18, 19, 20, 21, 22)

#: the most warps that share one warp's chunk range (csrc/mxu_cull.cuh)
MAX_SPLIT = 64

#: ``mxu_split`` splits a warp's chunks until the launch has this many
#: warps: on an H100 (PERF.md, rows 3 and 5; tools/ab_mxu.py) 32 splits of
#: 2048 warps beat 1, 4, 16 and 64 on N(0, 0.4) queries, whose heaviest
#: warps fold every chunk, and 64 of 128 warps beat 1, 4 and 16 on body 0;
#: on surface patches neither is 10% off the best split
SPLIT_WARPS = 65536


#: a2 past this (|a| above 1e9) flags the mesh for the bound pass's cull,
#: as p2 past it flags a query (csrc/mxu_bound_culled.cu, item B6)
_BOUND_FAR2 = 1e18

#: the bound pass's rounding term of a chunk's box: h^2 2^-21 + 2^-120
#: (csrc/mxu_bound_culled.cu, items B2, B4)
_BOUND_TINY = 2.0 ** -120


def mxu_chunk_records(rec, degenerate_tail=True):
    """[C, 16] float32 records of the chunks of ``CULL_CHUNK`` consecutive
    faces (in index order) of the face record ``rec`` [F, 24], C =
    ceil(F / 32): ``cull_records`` of the same triangles (the ``cull_records``
    kernel for a CUDA tensor), with e1 = +inf also where a face's hoisted
    corner terms a.ab, a.ac, a.n or a2 are not finite, and the reach from
    the origin ``|center| + h`` (widened for its float32 rounding), which
    the MXU tile's rounding scales with (csrc/mxu_cull.cuh, item 4').

    Columns 13-15 serve the bound pass (csrc/mxu_bound_culled.cu): the
    largest a2 of the chunk's faces (+inf in every chunk when a face of the
    mesh has a non-finite a or a2 or an a2 above 1e18, and in a chunk whose
    box is not finite: such chunks are always folded), the largest reach
    times 1 + 2^-21 (NaN or +inf kept) and h^2 2^-21 + 2^-120.  Rows 3 and
    5 read columns 0-12 only, which these leave as they were."""
    planes = rec[:, list(_FAST_COLS)].T.contiguous()[None]
    fast = cull_records(planes, "fast", degenerate_tail)[0]
    n_f = rec.shape[0]
    hoisted = rec[:, 12:16]
    pad = -n_f % CULL_CHUNK
    if pad:      # repeat the last face, as cull_records pads
        hoisted = torch.cat([hoisted, hoisted[-1:].expand(pad, 4)])
    finite = torch.isfinite(hoisted).reshape(-1, CULL_CHUNK * 4).all(dim=1)
    out = torch.zeros((fast.shape[0], MXU_CHUNK_RECORD), dtype=torch.float32,
                      device=rec.device)
    out[:, :12] = fast
    out[:, 7] = torch.where(finite, fast[:, 7],
                            torch.full_like(fast[:, 7], float("inf")))
    cen = fast[:, 0:3]
    out[:, 12] = ((torch.sqrt((cen * cen).sum(dim=-1)) + fast[:, 3])
                  * (1.0 + 8 * _U))
    a2, reach = rec[:, 15], rec[:, 23]
    if pad:
        a2 = torch.cat([a2, a2[-1:].expand(pad)])
        reach = torch.cat([reach, reach[-1:].expand(pad)])
    wild = ~(torch.isfinite(rec[:, 9:12]).all(dim=1) & (rec[:, 15]
                                                          <= _BOUND_FAR2))
    always = wild.any() | ~torch.isfinite(fast[:, :7]).all(dim=1)
    inf = torch.full_like(out[:, 13], float("inf"))
    out[:, 13] = torch.where(always, inf,
                             a2.reshape(-1, CULL_CHUNK).amax(dim=1))
    out[:, 14] = reach.reshape(-1, CULL_CHUNK).amax(dim=1) * (1.0 + 8 * _U)
    h = fast[:, 3]
    out[:, 15] = h * h * (8 * _U) + _BOUND_TINY
    return out


#: floats of one face's bound record (``mxu_bound_records``)
MXU_BOUND_RECORD = 8


def mxu_bound_records(rec):
    """[F, 8] float32 bound records of the face record ``rec`` [F, 24]: the
    five floats the bound pass reads of a face, bf16(a) (rounded to
    bfloat16 and back, as ``_mxu_ap2_env`` rounds it), a2 and the reach,
    then three zeros (csrc/mxu_bound_culled.cu stages 32 bytes a face where
    the full record is 96)."""
    out = torch.zeros((rec.shape[0], MXU_BOUND_RECORD), dtype=torch.float32,
                      device=rec.device)
    out[:, 0:3] = _bf16(rec[:, 9:12])
    out[:, 3] = rec[:, 15]
    out[:, 4] = rec[:, 23]
    return out


#: id of a face record -> (the record, its version counter, {tail: chunk
#: records, "bound": bound records}); the entry keeps the record alive, so
#: its id stays its own
_MXU_CHUNK_CACHE = {}


def _cached(rec, key, make):
    """``make()`` for the face record ``rec``, made once per record and key
    (bounded FIFO of ``_MXU_FACE_CACHE_MAX`` records; an in-place change of
    the record makes everything anew)."""
    hit = _MXU_CHUNK_CACHE.get(id(rec))
    if hit is None or hit[1] != rec._version:
        if hit is None and len(_MXU_CHUNK_CACHE) >= _MXU_FACE_CACHE_MAX:
            _MXU_CHUNK_CACHE.pop(next(iter(_MXU_CHUNK_CACHE)))
        hit = _MXU_CHUNK_CACHE[id(rec)] = (rec, rec._version, {})
    if key not in hit[2]:
        hit[2][key] = make()
    return hit[2][key]


def _cached_chunk_records(rec, degenerate_tail):
    """``mxu_chunk_records`` of ``rec``, made once per record and tail."""
    return _cached(rec, bool(degenerate_tail),
                   lambda: mxu_chunk_records(rec, degenerate_tail))


def _cached_bound_records(rec):
    """``mxu_bound_records`` of ``rec``, made once per record."""
    return _cached(rec, "bound", lambda: mxu_bound_records(rec))


def mxu_cull_operands(p, rec, degenerate_tail=True):
    """The cull's operands for the queries ``p`` [N, 3] and the face record
    ``rec`` [F, 24]: ``qorder`` [N] int32 (``query_order``: the Morton
    order of every row of p, the padding included) and ``records``
    (``mxu_chunk_records``, cached with the record), with the tail they
    were made for."""
    return {"qorder": query_order(p[None])[0].contiguous(),
            "records": _cached_chunk_records(rec, degenerate_tail),
            "degenerate_tail": bool(degenerate_tail)}


def mxu_split(n_q):
    """The number of warps that share one warp's chunks, for ``n_q``
    queries: the least power of two that gives the launch ``SPLIT_WARPS``
    warps, at most ``MAX_SPLIT``."""
    split = 1
    while split < MAX_SPLIT and split * (n_q // WARP) < SPLIT_WARPS:
        split *= 2
    return split


#: the most warps that share one warp's chunks in the bound pass: on an
#: H100 (PERF.md, row 4; tools/ab_mxu.py) 32 beat 1, 4, 16 and 64 on all
#: three of phase 12's sets, body 0's 4096 queries included
BOUND_MAX_SPLIT = 32


def mxu_bound_split(n_q):
    """The bound pass's split for ``n_q`` queries: ``mxu_split``'s, at
    most ``BOUND_MAX_SPLIT``."""
    return min(mxu_split(n_q), BOUND_MAX_SPLIT)


def _check_cull(p, rec, cull, degenerate_tail, split, name):
    n_q, n_c = p.shape[0], -(-rec.shape[0] // CULL_CHUNK)
    qorder, recs = cull["qorder"], cull["records"]
    if cull["degenerate_tail"] != bool(degenerate_tail):
        raise ValueError("%s: cull operands made for tail %s, not %s" % (
            name, cull["degenerate_tail"], bool(degenerate_tail)))
    if (qorder.dtype != torch.int32 or recs.dtype != torch.float32
            or not qorder.is_contiguous() or not recs.is_contiguous()
            or qorder.device != p.device or recs.device != p.device
            or tuple(qorder.shape) != (n_q,)
            or tuple(recs.shape) != (n_c, MXU_CHUNK_RECORD)):
        raise ValueError("%s: want qorder [%d] int32 and records [%d, %d] "
                         "float32, contiguous, on %s; got %s %s and %s %s" % (
                             name, n_q, n_c, MXU_CHUNK_RECORD, p.device,
                             tuple(qorder.shape), qorder.dtype,
                             tuple(recs.shape), recs.dtype))
    if not 1 <= split <= MAX_SPLIT:
        raise ValueError("%s: split %r not in [1, %d]" % (name, split,
                                                         MAX_SPLIT))


def _mxu_lb2(px, py, pz, plen, crec):
    """The kernel's squared lower bound (``cull_lb2``) from queries to the
    chunk records ``crec`` [..., 16] (broadcast): ``closest_kernel
    ._cull_lb2`` with R_m = |p - center| + 3h + (|p| + reach), ``plen`` =
    |p|, in place of R; -inf past ``CULL_FAR``, NaN kept."""
    dx, dy, dz = px - crec[..., 0], py - crec[..., 1], pz - crec[..., 2]
    big = (torch.sqrt(dx * dx + dy * dy + dz * dz) + 3.0 * crec[..., 3]
           + (plen + crec[..., 12]))
    ox = torch.clamp_min(dx.abs() - crec[..., 4], 0.0)
    oy = torch.clamp_min(dy.abs() - crec[..., 5], 0.0)
    oz = torch.clamp_min(dz.abs() - crec[..., 6], 0.0)
    big2 = big * big
    t = big2 * crec[..., 11]
    lb2 = ((ox * ox + oy * oy + oz * oz) * _CULL_SHRINK2
           - (big2 * crec[..., 7] + t * t))
    return torch.where(big <= CULL_FAR, lb2,
                       torch.full_like(lb2, float("-inf")))


def _mxu_culled(p, rec, cull, surv, tile_q, tile_f, degenerate_tail, split):
    """The culled walk of csrc/mxu_cull.cuh on the plain side: (faces [N]
    int32, warp chunks [N / 32], lane faces [N], warp stages [N / 32],
    each count summed over the splits).  ``surv`` None: the dense scan,
    whose fold is torch.argmin's (a NaN cost wins); else the repair's
    screen, whose fold takes a face only when strictly below (a NaN cost
    never)."""
    screen = surv is not None
    n_q, n_f = p.shape[0], rec.shape[0]
    n_c = -(-n_f // CULL_CHUNK)
    dev = p.device
    order = cull["qorder"].long()
    crec = cull["records"]
    ps = p[order]
    px, py, pz = ps[:, 0], ps[:, 1], ps[:, 2]
    p2 = px * px + py * py + pz * pz
    plen = torch.sqrt(p2)
    cpt = tile_f // CULL_CHUNK if screen else n_c
    chunk_tile = torch.arange(n_c, device=dev) // cpt
    runs = surv[order // tile_q] if screen else None     # [N, n_tiles]

    # the seed: the cost of the first face of the nearest representative
    # among the chunks of the tiles each lane folds (+inf: none)
    ks = torch.zeros(n_q, dtype=torch.long, device=dev)
    has = torch.zeros(n_q, dtype=torch.bool, device=dev)
    for r0, r1 in _row_chunks(n_q, n_c, dev):
        dx = px[r0:r1, None] - crec[None, :, 8]
        dy = py[r0:r1, None] - crec[None, :, 9]
        dz = pz[r0:r1, None] - crec[None, :, 10]
        d = torch.nan_to_num(dx * dx + dy * dy + dz * dz, nan=float("inf"))
        if screen:
            d = torch.where(runs[r0:r1][:, chunk_tile], d,
                            torch.full_like(d, float("inf")))
        low, ks[r0:r1] = torch.min(d, dim=1)
        has[r0:r1] = low < float("inf")
    face = rec[ks * CULL_CHUNK]
    seed = _sqdist_tile_mxu(ps, [face[:, k:k + 1] for k in range(MXU_RECORD)],
                            degenerate_tail)[:, 0]
    seed = torch.where(has, seed, torch.full_like(seed, float("inf")))

    warp = torch.zeros(n_q // WARP, dtype=torch.int32, device=dev)
    lane = torch.zeros(n_q, dtype=torch.int32, device=dev)
    stage = torch.zeros_like(warp)
    every = torch.ones(n_q, dtype=torch.bool, device=dev)
    fin_d = fin_i = None
    for s in range(split):
        best = torch.full((n_q,), float("inf"), device=dev)
        best_i = torch.zeros(n_q, dtype=torch.int32, device=dev)
        snap = best.clone()
        for k in range(n_c * s // split, n_c * (s + 1) // split):
            r = runs[:, int(chunk_tile[k])] if screen else every
            if screen and not bool(r.any()):
                continue
            lb2 = _mxu_lb2(px, py, pz, plen, crec[k])
            vote = _warp_vote(r & ~(lb2 > torch.fmin(snap, seed)))
            if not bool(vote.any()):
                continue
            stage += vote.to(torch.int32)
            snap = torch.where(vote.repeat_interleave(WARP), best, snap)
            need = r & ~(lb2 > torch.fmin(best, seed))
            folds = _warp_vote(need)
            c0 = k * CULL_CHUNK
            nf = min(CULL_CHUNK, n_f - c0)
            warp += folds.to(torch.int32)
            lane += need.to(torch.int32) * nf
            if not bool(folds.any()):
                continue
            cost = _sqdist_tile_mxu(ps, _cols(rec, c0, c0 + nf),
                                    degenerate_tail)          # [N, nf]
            arg = torch.argmin(cost, dim=-1)
            low = torch.gather(cost, -1, arg[:, None])[:, 0]
            take = low < best
            if not screen:
                take |= torch.isnan(low) & ~torch.isnan(best)
            take &= folds.repeat_interleave(WARP) & r
            best = torch.where(take, low, best)
            best_i = torch.where(take, (arg + c0).to(torch.int32), best_i)
        if fin_d is None:
            fin_d, fin_i = best, best_i
        else:
            take = best < fin_d
            if not screen:
                take |= torch.isnan(best) & ~torch.isnan(fin_d)
            fin_d = torch.where(take, best, fin_d)
            fin_i = torch.where(take, best_i, fin_i)
    out = torch.empty(n_q, dtype=torch.int32, device=dev)
    out[order] = fin_i
    return out, warp, lane, stage


def mxu_faces_culled_plain(p, rec, cull, tile_q=TILE_Q, tile_f=TILE_F,
                           degenerate_tail=True, split=1):
    """Plain PyTorch version of the ``mxu_faces`` kernel's chunk cull:
    (closest face per query [N] int32, chunks each warp folded [N / 32],
    real faces of the chunks each query's own lane needed [N] at its sorted
    position, chunks each warp staged [N / 32], the counts summed over the
    splits), int32.  The faces are ``mxu_faces_plain``'s.

    Queries run in ``cull["qorder"]``, 32 to a warp.  Each lane is seeded
    with the MXU cost of the first face of the chunk whose corner a is
    nearest (``records[:, 8:11]``; a NaN distance counts as +inf).  With
    ``split`` warps to a warp's queries, warp s walks chunks [s C / split,
    (s + 1) C / split) in index order; a lane needs chunk k unless its
    bound (``_mxu_lb2``) exceeds min(best, seed).  A warp stages chunk k
    when one of its lanes needs it against the state before the last chunk
    it staged (the kernel votes one chunk ahead), and folds a staged chunk,
    every lane of it, when one of its lanes needs it against the state now.
    The fold is torch.argmin's: strict < in increasing face order, a NaN
    cost winning as torch.argmin has it; the splits merge in order the
    same way."""
    _check(p, rec, tile_q, tile_f, "mxu_faces")
    _check_cull(p, rec, cull, degenerate_tail, split, "mxu_faces")
    return _mxu_culled(p, rec, cull, None, tile_q, tile_f, degenerate_tail,
                       split)


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


def _stats(n_q, split, device):
    """Empty per-split count outputs of a culled launch: warp chunks
    [split, N / 32], lane faces [split, N], warp stages [split, N / 32]."""
    return tuple(torch.empty((split, n_q // size), dtype=torch.int32,
                             device=device) for size in (WARP, 1, WARP))


def _launch_cull(name, p, rec, cull, surv, tile_q, tile_f, degenerate_tail,
                 split, with_stats):
    """Launch the culled kernel ``name`` (``surv`` None for the dense scan);
    returns the faces, then the counts summed over the splits when
    ``with_stats``."""
    n_q, n_f = p.shape[0], rec.shape[0]
    if not n_q:
        out = no_queries(1, p.device, 4 if with_stats else 1)
        return tuple(x[0] for x in out) if with_stats else out[0]
    from .. import _build

    out = torch.empty(n_q, dtype=torch.int32, device=p.device)
    seeds = torch.empty(n_q, dtype=torch.float32, device=p.device)
    part = ((torch.empty((split, n_q), dtype=torch.float32, device=p.device),
             torch.empty((split, n_q), dtype=torch.int32, device=p.device))
            if split > 1 else (None, None))
    stats = (_stats(n_q, split, p.device) if with_stats
             else (None, None, None))
    screen = () if surv is None else (surv,)
    tiles = (tile_q,) if surv is None else (tile_q, tile_f)
    _build.launch(name, p.device, p, cull["qorder"], rec, cull["records"],
                  *screen, seeds, *part, out, *stats, n_q, n_f, *tiles, split,
                  int(bool(degenerate_tail)))
    LAUNCHES[name] += 1
    if not with_stats:
        return out
    return (out,) + tuple(x.sum(dim=0, dtype=torch.int32) for x in stats)


def mxu_faces(p, rec, tile_q=TILE_Q, tile_f=TILE_F, degenerate_tail=True,
              cull=None, split=None, with_stats=False):
    """Index of the closest face per query: the ``mxu_faces`` CUDA kernel,
    the exact chunk cull, for CUDA tensors; its plain version
    ``mxu_faces_culled_plain`` for CPU tensors.  ``cull``: the operands of
    ``mxu_cull_operands`` (made here when None); ``split``: warps to a
    warp's chunks (``mxu_split`` when None).  ``with_stats`` also returns
    the three counts of ``mxu_faces_culled_plain``."""
    _check(p, rec, tile_q, tile_f, "mxu_faces")
    if cull is None:
        cull = mxu_cull_operands(p, rec, degenerate_tail)
    if split is None:
        split = mxu_split(p.shape[0])
    _check_cull(p, rec, cull, degenerate_tail, split, "mxu_faces")
    if p.device.type == "cpu":
        res = mxu_faces_culled_plain(p, rec, cull, tile_q, tile_f,
                                     degenerate_tail, split)
        return res if with_stats else res[0]
    return _launch_cull("mxu_faces", p, rec, cull, None, tile_q, tile_f,
                        degenerate_tail, split, with_stats)


def mxu_faces_every(p, rec, tile_q=TILE_Q, tile_f=TILE_F,
                    degenerate_tail=True):
    """Index of the closest face per query over every face: the
    ``mxu_faces_every`` CUDA kernel (``mxu_faces``' oracle; no path
    launches it) for CUDA tensors, ``mxu_faces_plain`` for CPU tensors."""
    _check(p, rec, tile_q, tile_f, "mxu_faces_every")
    if p.device.type == "cpu":
        return mxu_faces_plain(p, rec, tile_q, tile_f, degenerate_tail)
    from .. import _build

    out = torch.empty(p.shape[0], dtype=torch.int32, device=p.device)
    _build.launch("mxu_faces_every", p.device, p, rec, out, p.shape[0],
                  rec.shape[0], tile_q, tile_f, int(bool(degenerate_tail)))
    LAUNCHES["mxu_faces_every"] += 1
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
    """(ub, cert) of the bound pass over every face: the ``mxu_bound`` CUDA
    kernel (``mxu_bound_culled``'s oracle; no path launches it) for CUDA
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


# ---------------------------------------------------------------------------
# The chunk cull of the bound pass (row 4): the plain version of the design
# of csrc/mxu_bound_culled.cu, which makes the same float32 operations in
# the same order, and its wrapper.

#: the bound pass's lower-bound constants (csrc/mxu_bound_culled.cu, items
#: B4, B5): K1 of p2 in the ub bound, K3 of p2 + A2 off the cert bound
_BOUND_K1 = 0.99 * 2.0 ** -7
_BOUND_K3 = 3.01 * 2.0 ** -7


def _min_nan(x, acc):
    """csrc/mxu_cost.cuh min_nan: x where x < acc or x is NaN, else acc."""
    return torch.where((x < acc) | torch.isnan(x), x, acc)


def _bound_pair(bx, by, bz, p2, b):
    """(u, c) = (ap2~ + E, sqrt(max(ap2~ - E, 0)) - r) of queries (bf16
    coordinates, p2) and bound records ``b`` [..., 8] (broadcast): the
    operations of ``mxu_bound_plain`` in its order."""
    pa = bx * b[..., 0] + by * b[..., 1] + bz * b[..., 2]
    ap2t = torch.clamp_min(p2 - (pa + pa) + b[..., 3], 0.0)
    env = MXU_BF16_EPS * (p2 + b[..., 3])
    return ap2t + env, torch.sqrt(torch.clamp_min(ap2t - env, 0.0)) - b[..., 4]


def _bound_lbs(px, py, pz, p2, crec):
    """The kernel's lower bounds (Lu of every u, Lc of every c of the
    chunk) from queries to the chunk records ``crec`` [..., 16]
    (broadcast): the squared distance to the box, shrunk by
    ``_CULL_SHRINK2``, with the terms of csrc/mxu_bound_culled.cu items B4
    and B5.  NaN stays NaN."""
    dx, dy, dz = px - crec[..., 0], py - crec[..., 1], pz - crec[..., 2]
    ox = torch.clamp_min(dx.abs() - crec[..., 4], 0.0)
    oy = torch.clamp_min(dy.abs() - crec[..., 5], 0.0)
    oz = torch.clamp_min(dz.abs() - crec[..., 6], 0.0)
    sd2 = (ox * ox + oy * oy + oz * oz) * _CULL_SHRINK2
    lu = (sd2 + p2 * _BOUND_K1) - crec[..., 15]
    lc = torch.sqrt(torch.clamp_min(
        sd2 - ((p2 + crec[..., 13]) * _BOUND_K3 + crec[..., 15]), 0.0))
    return lu, lc - crec[..., 14]


def _bound_needs(lu, lc, ub, near):
    """(ub-need, cert-need) of lanes with running ``ub``; a lane that is
    not ``near`` needs every chunk."""
    su = torch.sqrt(torch.clamp_min(ub, 0.0))
    return ~near | ~(lu > ub), ~near | ~(lc > su)


def _bound_slots(n_c, split, cpt):
    """The most face tiles one split's chunk range touches (the kernel's
    ``split_slots``)."""
    slots = 0
    for s in range(split):
        k_lo, k_hi = n_c * s // split, n_c * (s + 1) // split
        if k_hi > k_lo:
            slots = max(slots, (k_hi - 1) // cpt - k_lo // cpt + 1)
    return slots


def _bound_culled(p, rec, cull, tile_f, split, apart=False):
    """The culled bound pass of csrc/mxu_bound_culled.cu on the plain side:
    (ub [N], cert [N, n_tiles], warp chunks [N / 32], lane faces [N], warp
    stages [N / 32]), the counts summed over the splits; ``apart`` adds the
    chunks each lane needed for the ub test and for the cert test, [N]
    each (at sorted positions, as the lane faces)."""
    n_q, n_f = p.shape[0], rec.shape[0]
    n_c, cpt = -(-n_f // CULL_CHUNK), tile_f // CULL_CHUNK
    dev = p.device
    order = cull["qorder"].long()
    crec = cull["records"]
    brec = _cached_bound_records(rec)
    ps = p[order]
    px, py, pz = ps[:, 0], ps[:, 1], ps[:, 2]
    p2 = px * px + py * py + pz * pz
    bx, by, bz = _bf16(px), _bf16(py), _bf16(pz)
    near = p2 <= _BOUND_FAR2

    # the seed: u of the first face of the nearest representative's chunk
    ks = torch.zeros(n_q, dtype=torch.long, device=dev)
    has = torch.zeros(n_q, dtype=torch.bool, device=dev)
    for r0, r1 in _row_chunks(n_q, n_c, dev):
        dx = px[r0:r1, None] - crec[None, :, 8]
        dy = py[r0:r1, None] - crec[None, :, 9]
        dz = pz[r0:r1, None] - crec[None, :, 10]
        d = torch.nan_to_num(dx * dx + dy * dy + dz * dz, nan=float("inf"))
        low, ks[r0:r1] = torch.min(d, dim=1)
        has[r0:r1] = low < float("inf")
    seed = _bound_pair(bx, by, bz, p2, brec[ks * CULL_CHUNK])[0]
    seed = torch.where(has, seed, torch.full_like(seed, float("inf")))

    inf = float("inf")
    n_tiles = _n_tiles(rec, tile_f)
    counts = [torch.zeros(n_q // size, dtype=torch.int32, device=dev)
              for size in (WARP, 1, WARP, 1, 1)]
    warp, lane, stage, lane_ub, lane_cert = counts
    ub = None
    cert = torch.full((n_q, n_tiles), inf, device=dev)
    for s in range(split):
        k_lo, k_hi = n_c * s // split, n_c * (s + 1) // split
        run, snap = seed.clone(), seed.clone()
        part = torch.full((n_q, n_tiles), inf, device=dev)
        for k in range(k_lo, k_hi):
            lu, lc = _bound_lbs(px, py, pz, p2, crec[k])
            vote = _warp_vote(torch.logical_or(
                *_bound_needs(lu, lc, snap, near)))
            if not bool(vote.any()):
                continue
            staged = vote.repeat_interleave(WARP)
            stage += vote.to(torch.int32)
            snap = torch.where(staged, run, snap)
            need_u, need_c = (x & staged
                              for x in _bound_needs(lu, lc, run, near))
            need = need_u | need_c
            folds = _warp_vote(need)
            c0 = k * CULL_CHUNK
            nf = min(CULL_CHUNK, n_f - c0)
            warp += folds.to(torch.int32)
            lane += need.to(torch.int32) * nf
            lane_ub += need_u.to(torch.int32)
            lane_cert += need_c.to(torch.int32)
            if not bool(folds.any()):
                continue
            u, c = _bound_pair(bx[:, None], by[:, None], bz[:, None],
                               p2[:, None], brec[None, c0:c0 + nf])
            fold = folds.repeat_interleave(WARP)
            run = torch.where(fold, _min_nan(u.amin(dim=1), run), run)
            t = k // cpt
            part[:, t] = torch.where(fold, _min_nan(c.amin(dim=1),
                                                    part[:, t]), part[:, t])
        ub = run if ub is None else _min_nan(run, ub)
        if k_hi > k_lo:
            t0, t1 = k_lo // cpt, (k_hi - 1) // cpt + 1
            cert[:, t0:t1] = _min_nan(part[:, t0:t1], cert[:, t0:t1])
    ub_out = torch.empty_like(ub)
    ub_out[order] = ub
    cert_out = torch.empty_like(cert)
    cert_out[order] = cert
    res = (ub_out, cert_out, warp, lane, stage)
    return res + (lane_ub, lane_cert) if apart else res


def _check_bound_cull(p, rec, cull, tile_f, split):
    if tile_f % CULL_CHUNK or p.shape[0] % WARP:
        raise ValueError("mxu_bound_culled: want tile_f a multiple of the "
                         "cull's %d-face chunks and a multiple of %d "
                         "queries, got %r and %d" % (CULL_CHUNK, WARP,
                                                     tile_f, p.shape[0]))
    # the bound reads no tail-dependent field: any tail's operands serve
    _check_cull(p, rec, cull, cull["degenerate_tail"], split,
                "mxu_bound_culled")


def mxu_bound_culled_plain(p, rec, cull, tile_f=TILE_F, split=1):
    """Plain PyTorch version of the ``mxu_bound_culled`` kernel's chunk
    cull: (ub [N], cert [N, ceil(F / tile_f)], chunks each warp folded
    [N / 32], real faces of the chunks each query's own lane needed [N] at
    its sorted position, chunks each warp staged [N / 32], the counts
    summed over the splits).  ``cull``: ``mxu_cull_operands``' (either
    tail); ``tile_f`` and N multiples of 32.

    Queries run in ``cull["qorder"]``, 32 to a warp, each lane's running ub
    seeded with the u of the first face of the chunk whose representative
    is nearest.  With ``split`` warps to a warp's queries, warp s walks
    chunks [s C / split, (s + 1) C / split) in index order; a lane needs
    chunk k when its ub test or its cert test (``_bound_lbs``) does not
    exclude it; a warp stages chunk k when one of its lanes needs it
    against the state before the last chunk it staged, and folds a staged
    chunk, every lane every face, when one of its lanes needs it now.  A
    lane's cert of a tile is its min over the faces it folded there (+inf
    where none); the splits merge in order by ``_min_nan``.  ub equals
    ``mxu_bound_plain``'s; cert meets the contract of the module's
    docstring."""
    _check(p, rec, None, tile_f, "mxu_bound_culled")
    _check_bound_cull(p, rec, cull, tile_f, split)
    return _bound_culled(p, rec, cull, tile_f, split)


def mxu_bound_culled(p, rec, tile_f=TILE_F, cull=None, split=None,
                     with_stats=False):
    """(ub, cert) of the bound pass by its exact chunk cull: the
    ``mxu_bound_culled`` CUDA kernel for CUDA tensors, its plain version
    ``mxu_bound_culled_plain`` for CPU tensors; any other device raises.
    ``cull``: the operands of ``mxu_cull_operands`` (made here when None);
    ``split``: warps to a warp's chunks (``mxu_bound_split`` when None).
    ``with_stats`` also returns the three counts of
    ``mxu_bound_culled_plain``."""
    _check(p, rec, None, tile_f, "mxu_bound_culled")
    if cull is None:
        cull = mxu_cull_operands(p, rec)
    if split is None:
        split = mxu_bound_split(p.shape[0])
    _check_bound_cull(p, rec, cull, tile_f, split)
    if p.device.type == "cpu":
        res = _bound_culled(p, rec, cull, tile_f, split)
        return res if with_stats else res[:2]
    n_q, n_f = p.shape[0], rec.shape[0]
    dev = p.device
    if not n_q:
        empty = torch.empty(0, dtype=torch.float32, device=dev)
        bounds = (empty, empty.reshape(0, _n_tiles(rec, tile_f)))
        return bounds + (no_queries(1, dev, 3) if with_stats else ())
    from .. import _build

    ub = torch.empty(n_q, dtype=torch.float32, device=dev)
    cert = torch.empty((n_q, _n_tiles(rec, tile_f)), dtype=torch.float32,
                       device=dev)
    seeds = torch.empty(n_q, dtype=torch.float32, device=dev)
    slots = _bound_slots(-(-n_f // CULL_CHUNK), split, tile_f // CULL_CHUNK)
    part = ((torch.empty((split, n_q), dtype=torch.float32, device=dev),
             torch.empty((split, slots, n_q), dtype=torch.float32,
                         device=dev)) if split > 1 else (None, None))
    stats = _stats(n_q, split, dev) if with_stats else (None, None, None)
    _build.launch("mxu_bound_culled", dev, p, cull["qorder"],
                  _cached_bound_records(rec), cull["records"], seeds, *part,
                  ub, cert, *stats, n_q, n_f, tile_f, split, slots)
    LAUNCHES["mxu_bound_culled"] += 1
    if not with_stats:
        return ub, cert
    return (ub, cert) + tuple(x.sum(dim=0, dtype=torch.int32) for x in stats)


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


def mxu_repair_culled_plain(p, rec, ub, cert, cull, tile_q=TILE_Q,
                            tile_f=TILE_F, degenerate_tail=True, split=1):
    """Plain PyTorch version of the ``mxu_repair`` kernel's chunk cull:
    (closest face per query [N] int32, face tiles run per query tile
    [N / tile_q] int32, and the three counts of ``mxu_faces_culled_plain``).
    A query folds only the faces of the face tiles its query tile runs
    (``survivors``); a lane needs a chunk only if its query tile runs the
    chunk's tile and its bound does not exclude it; its seed is the first
    face of its nearest representative among those tiles (+inf when its
    query tile runs none).  The fold takes a face only when strictly below
    the best, so the faces are ``mxu_repair_plain``'s wherever no tile a
    query runs holds a NaN cost for it (``mxu_repair_plain`` then drops the
    whole tile, this fold the NaN faces)."""
    _check_screen(p, rec, ub, cert, tile_q, tile_f, "mxu_repair")
    _check_cull(p, rec, cull, degenerate_tail, split, "mxu_repair")
    _check_repair_tile(tile_f)
    surv = survivors(ub, cert, tile_q)
    out, warp, lane, stage = _mxu_culled(p, rec, cull, surv, tile_q, tile_f,
                                         degenerate_tail, split)
    return out, surv.sum(dim=1, dtype=torch.int32), warp, lane, stage


def _check_repair_tile(tile_f):
    if tile_f % CULL_CHUNK:
        raise ValueError("mxu_repair: tile_f %d is not a multiple of the "
                         "cull's %d-face chunks" % (tile_f, CULL_CHUNK))


def mxu_repair(p, rec, ub, cert, tile_q=TILE_Q, tile_f=TILE_F,
               degenerate_tail=True, cull=None, split=None,
               with_stats=False):
    """(faces, tiles run per query tile) of the exact repair: the
    ``mxu_repair`` CUDA kernel, the chunk cull inside the tiles the screen
    lets each query tile run (``survivors``, made here on the card), for
    CUDA tensors; its plain version ``mxu_repair_culled_plain`` for CPU
    tensors.  ``cull``, ``split`` and ``with_stats`` as for ``mxu_faces``
    (the three counts follow the two outputs).  ``tile_f`` a multiple of
    32."""
    _check_screen(p, rec, ub, cert, tile_q, tile_f, "mxu_repair")
    _check_repair_tile(tile_f)
    if cull is None:
        cull = mxu_cull_operands(p, rec, degenerate_tail)
    if split is None:
        split = mxu_split(p.shape[0])
    _check_cull(p, rec, cull, degenerate_tail, split, "mxu_repair")
    if p.device.type == "cpu":
        res = mxu_repair_culled_plain(p, rec, ub, cert, cull, tile_q, tile_f,
                                      degenerate_tail, split)
        return res if with_stats else res[:2]
    surv = survivors(ub, cert, tile_q)
    res = _launch_cull("mxu_repair", p, rec, cull,
                       surv.to(torch.uint8).contiguous(), tile_q, tile_f,
                       degenerate_tail, split, with_stats)
    rep = surv.sum(dim=1, dtype=torch.int32)
    if not with_stats:
        return res, rep
    return (res[0], rep) + res[1:]


def mxu_repair_every(p, rec, ub, cert, tile_q=TILE_Q, tile_f=TILE_F,
                     degenerate_tail=True):
    """(faces, tiles run per query tile) of the repair over every face of
    each tile it runs: the ``mxu_repair_every`` CUDA kernel (``mxu_repair``'s
    oracle; no path launches it) for CUDA tensors, ``mxu_repair_plain`` for
    CPU tensors."""
    _check_screen(p, rec, ub, cert, tile_q, tile_f, "mxu_repair_every")
    if p.device.type == "cpu":
        return mxu_repair_plain(p, rec, ub, cert, tile_q, tile_f,
                                degenerate_tail)
    from .. import _build

    out = torch.empty(p.shape[0], dtype=torch.int32, device=p.device)
    rep = torch.empty(p.shape[0] // tile_q, dtype=torch.int32,
                      device=p.device)
    _build.launch("mxu_repair_every", p.device, p, rec, ub, cert, out, rep,
                  p.shape[0], rec.shape[0], tile_q, tile_f,
                  int(bool(degenerate_tail)))
    LAUNCHES["mxu_repair_every"] += 1
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
    and its answers equal the dense scan's bit for bit.  The bound pass
    (``mxu_bound_culled``) and the repair share one set of cull operands
    (one Morton order of the queries a call).

    ``with_stats=True`` also returns ``{"screened": face tiles of all
    query tiles, "repaired": those the f32 pass ran}``."""
    p, rec, tri, pts, center = mxu_operands(v, f, points, tile_q, device)
    tail = not assume_nondegenerate
    cull = mxu_cull_operands(p, rec, tail)
    ub, cert = mxu_bound_culled(p, rec, tile_f, cull=cull)
    best, rep = mxu_repair(p, rec, ub, cert, tile_q, tile_f, tail, cull=cull)
    res = mxu_epilogue(best, tri, pts, center)
    if not with_stats:
        return res
    return res, {"screened": int(rep.numel()) * int(cert.shape[1]),
                 "repaired": int(rep.sum())}
