"""Vertex-anchored candidate tables: exact closest point for scan-sized
query counts (counterpart of mesh_tpu/query/anchored.py), in plain
PyTorch on the tensors' device.

Set-up, once per mesh (``build_anchor_tables``, the analog of the
reference's cached CGAL tree build): for every vertex ``vi`` rank all
faces by the conservative bound

    lbv(vi, f) = |vi - centroid_f| - radius_f  <=  dist(vi, f)

and keep the K smallest as ``table[vi]``, with the (K+1)-th bound as
``safe[vi]``: no face outside the table is closer to ``vi`` than that.

Query (``closest_point_anchored``):

1. anchor: a near-nearest vertex ``vi`` per query by the matmul form of
   ``|q - v|^2`` (float32, TF32 off for the call) and a row argmin;
   ``dhat = |q - v_vi|``, recomputed exactly;
2. the exact closest-point test on the K table faces only;
3. certificate: the true closest point p* has ``|q - p*| <= dhat``, so any
   face holding it has ``dist(vi, f) <= 2 dhat``; where ``2 dhat`` is
   below ``safe[vi]`` (less a scene-relative slack) every such face is in
   the table and the answer is the global optimum (``tight``).  The
   anchor need not be the true nearest vertex for this to hold.

``closest_point_anchored_auto`` re-runs the non-tight queries through the
brute-force ``closest_faces`` kernel on the kernel route, or through the
plain scan under ``MESH_TPU_FORCE_XLA``, so its answers are exact up to
distance ties while the work per query drops from O(F) to O(K).
"""

import numpy as np
import torch

from ..models.body_model import no_tf32
from ..utils.device import as_tensor, resolve_device
from ..utils.dispatch import pallas_default
from .point_triangle import closest_point_on_triangle

__all__ = ["build_anchor_tables", "closest_point_anchored",
           "closest_point_anchored_auto"]

#: certificate slack per unit of scene scale (keeps it conservative under
#: float32 rounding in dhat and safe, at any unit)
_CERT_SLACK_REL = 1e-5


def build_anchor_tables(v, f, k=128, vchunk=512, *, device="cuda"):
    """Per-vertex tables of the ``k`` faces of smallest conservative bound.

    Each chunk of ``vchunk`` vertices ranks all faces by a stable sort of
    its [vchunk, F] bound rows, so the table is in ascending order with
    ties to the lower face id, as the reference's iterative argmin
    extraction gives it.

    :returns: ``(table, safe)``: ``table`` [V, k] int32 face ids;
        ``safe`` [V] float32, the (k+1)-th smallest bound (``+inf`` when
        k >= F: the table holds every face).
    """
    dev = resolve_device(device)
    v = as_tensor(v, dev, torch.float32)
    f = as_tensor(f, dev).long()
    n_v, n_f = v.shape[0], f.shape[0]
    k = min(k, n_f)
    # the bounds are translation-invariant; centering keeps the rounding in
    # `safe` scene-relative, as on the query side
    v = v - v.mean(dim=0)
    tri = v[f]
    cen = tri.mean(dim=1)
    off = tri - cen[:, None, :]
    rad = (off * off).sum(dim=-1).amax(dim=1).sqrt()
    tables, safes = [], []
    for v0 in range(0, n_v, vchunk):
        vc = v[v0:v0 + vchunk]
        diff = vc[:, None, :] - cen[None]
        lbv = (diff * diff).sum(dim=-1).sqrt() - rad[None]       # [C, F]
        del diff
        val, order = torch.sort(lbv, dim=-1, stable=True)
        tables.append(order[:, :k].to(torch.int32))
        safes.append(val[:, k] if n_f > k else torch.full(
            (vc.shape[0],), float("inf"), device=dev))
    if not tables:
        return (torch.zeros((0, k), dtype=torch.int32, device=dev),
                torch.zeros((0,), dtype=torch.float32, device=dev))
    return torch.cat(tables), torch.cat(safes)


def closest_point_anchored(v, f, points, table, safe, chunk=8192, *,
                           device="cuda"):
    """Anchored closest point: a dict of ``face`` [Q] int32, ``part`` [Q]
    int32, ``point`` [Q, 3], ``sqdist`` [Q] and ``tight`` [Q] bool, as
    tensors on ``device``; ``table``, ``safe`` from
    ``build_anchor_tables``."""
    dev = resolve_device(device)
    v = as_tensor(v, dev, torch.float32)
    f = as_tensor(f, dev).long()
    points = as_tensor(points, dev, torch.float32).reshape(-1, 3)
    table = as_tensor(table, dev).long()
    safe = as_tensor(safe, dev, torch.float32)
    center = v.mean(dim=0)
    vc = v - center
    pts = points - center
    tri = vc[f]
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    vn2 = (vc * vc).sum(dim=-1)
    # slack scales with the scene, so rounding in dhat and safe never
    # outgrows it (an absolute constant would break at millimetre units)
    slack = _CERT_SLACK_REL * torch.clamp(vc.abs().max(), min=1.0)
    out = {key: [] for key in ("face", "part", "point", "sqdist", "tight")}
    with no_tf32():
        for q0 in range(0, pts.shape[0], chunk):
            p = pts[q0:q0 + chunk]
            d2v = ((p * p).sum(dim=-1)[:, None] + vn2[None]
                   - 2.0 * (p @ vc.T))                          # [C, V]
            vi = torch.argmin(d2v, dim=-1)
            del d2v
            gap = p - vc[vi]
            dhat = torch.clamp((gap * gap).sum(dim=-1), min=0.0).sqrt()
            cand = table[vi]                                     # [C, K]
            pt, sq, part = closest_point_on_triangle(
                p[:, None, :], a[cand], b[cand], c[cand])
            j = torch.argmin(sq, dim=-1)[:, None]
            out["face"].append(cand.gather(1, j)[:, 0].to(torch.int32))
            out["part"].append(part.gather(1, j)[:, 0])
            out["point"].append(
                pt.gather(1, j[..., None].expand(-1, 1, 3))[:, 0])
            out["sqdist"].append(sq.gather(1, j)[:, 0])
            out["tight"].append(2.0 * dhat < safe[vi] - slack)
    if not out["face"]:
        return {"face": torch.zeros(0, dtype=torch.int32, device=dev),
                "part": torch.zeros(0, dtype=torch.int32, device=dev),
                "point": torch.zeros((0, 3), device=dev),
                "sqdist": torch.zeros(0, device=dev),
                "tight": torch.zeros(0, dtype=torch.bool, device=dev)}
    res = {key: torch.cat(val) for key, val in out.items()}
    res["point"] = res["point"] + center
    return res


def closest_point_anchored_auto(v, f, points, tables=None, k=128,
                                chunk=8192, *, use_pallas=None,
                                device="cuda"):
    """Exact anchored closest point, numpy out (``face``, ``part``,
    ``point``, ``sqdist``): the non-tight queries re-run through the
    brute-force ``closest_faces`` kernel (one launch a call that has any),
    or through the plain scan when ``use_pallas`` is False (default:
    ``pallas_default``).  Pass ``tables=build_anchor_tables(v, f, k)`` to
    pay the set-up once across calls (the reference's cached tree,
    mesh/search.py:21-24)."""
    from .closest_kernel import closest_point_kernel
    from .closest_point import closest_faces_and_points_t, replace_rows

    dev = resolve_device(device)
    v = as_tensor(v, dev, torch.float32)
    f = as_tensor(f, dev).long()
    points = as_tensor(points, dev, torch.float32).reshape(-1, 3)
    if tables is None:
        tables = build_anchor_tables(v, f, k=k, device=dev)
    res = closest_point_anchored(v, f, points, *tables, chunk=chunk,
                                 device=dev)
    out = {key: val.cpu().numpy() for key, val in res.items()}
    tight = out.pop("tight")
    loose = np.nonzero(~tight)[0]
    if loose.size:
        if use_pallas is None:
            use_pallas = pallas_default(dev)
        loose_pts = points[torch.as_tensor(loose, device=dev)]
        fix = (closest_point_kernel(v, f, loose_pts) if use_pallas
               else closest_faces_and_points_t(v, f, loose_pts))
        replace_rows(out, loose, fix)
    return out
