"""Closest-point-on-mesh and closest-vertex queries (counterpart of
mesh_tpu/query/closest_point.py).

``closest_faces_and_points`` is the plain chunked scan in the reference's
reconstruction form (barycentric point per pair, then the argmin): the
reference's XLA form, and an independent oracle of the kernel path.
``closest_vertices*`` run the ``nearest_vertices`` kernel on the card (its
plain version on the CPU) and, under ``MESH_TPU_FORCE_XLA``, the
reference's chunked XLA scan (``_closest_vertices_xla``).
``closest_point_dispatch`` is the batched facades' closest-point body: the
brute-force or the sphere-culled kernel with ``use_pallas``, the plain scan
per mesh without.
"""

import torch

from ..utils.device import as_tensor
from ..utils.dispatch import pallas_default
from .autotune import crossover_faces
from .closest_kernel import closest_point_kernel, nearest_vertices_kernel
from .culled import record_strategy
from .culled_kernel import closest_point_culled_kernel
from .point_triangle import closest_point_barycentric, closest_point_on_triangle


def closest_faces_and_points_t(v, f, points, chunk=512):
    """The plain scan on tensors on their own device: ``v`` [V, 3], ``f``
    [F, 3], ``points`` [Q, 3] -> dict of ``face``, ``part``, ``point``,
    ``sqdist``; each chunk of queries materializes a [chunk, F] matrix."""
    points = points.to(v.dtype)
    center = v.mean(dim=0)
    v = v - center
    points = points - center
    tri = v[f.long()]                                    # [F, 3, 3]
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]
    faces, parts, pts_out, sqds = [], [], [], []
    for q0 in range(0, max(points.shape[0], 1), chunk):
        pts = points[q0:q0 + chunk]
        bary, _ = closest_point_barycentric(pts[:, None, :], a[None], b[None],
                                            c[None])
        cp = (bary[..., 0:1] * a[None] + bary[..., 1:2] * b[None]
              + bary[..., 2:3] * c[None])
        diff = pts[:, None, :] - cp
        best = torch.argmin((diff * diff).sum(dim=-1), dim=-1)
        pt, sqd, part = closest_point_on_triangle(pts, a[best], b[best],
                                                  c[best])
        faces.append(best.to(torch.int32))
        parts.append(part)
        pts_out.append(pt)
        sqds.append(sqd)
    return {"face": torch.cat(faces), "part": torch.cat(parts),
            "point": torch.cat(pts_out) + center, "sqdist": torch.cat(sqds)}


def replace_rows(out, rows, fix):
    """Replace the ``rows`` of a numpy result dict ``out`` (``face``,
    ``part``, ``point``, ``sqdist``) by ``fix``'s (tensors), in copies:
    the certificate re-runs' merge."""
    for key in ("face", "part", "point", "sqdist"):
        out[key] = out[key].copy()
        out[key][rows] = fix[key].cpu().numpy()
    return out


def closest_faces_and_points(v, f, points, chunk=512, device="cuda"):
    """For each query point, the nearest face / part / point on the mesh,
    by the plain scan.

    :returns: dict with ``face`` [Q] int32, ``part`` [Q] int32 (CGAL codes
        0-6), ``point`` [Q, 3] and ``sqdist`` [Q].
    """
    v = as_tensor(v, device)
    return closest_faces_and_points_t(v, as_tensor(f, device),
                                      as_tensor(points, device), chunk=chunk)


def closest_vertices_with_distance(v, points, chunk=2048, *,
                                   device="cuda"):
    """Nearest mesh vertex per query -> (index [Q] int32, distance [Q]):
    the kernel route, or under ``MESH_TPU_FORCE_XLA`` the chunked scan of
    ``chunk`` queries a step."""
    v = as_tensor(v, device, torch.float32)
    points = as_tensor(points, device, torch.float32)
    if pallas_default(device):
        return nearest_vertices_kernel(v, points)
    return _closest_vertices_xla(v, points, chunk=chunk)


def _closest_vertices_xla(v, points, chunk=2048):
    """The reference's XLA scan on tensors: each chunk of queries
    materializes a [chunk, V] matrix; ties go to the lowest index."""
    points = points.to(v.dtype)
    center = v.mean(dim=0)
    vc = v - center
    pts = points - center
    idx, dist = [], []
    for q0 in range(0, max(pts.shape[0], 1), chunk):
        p = pts[q0:q0 + chunk]
        diff = p[:, None, :] - vc[None]
        sq = (diff * diff).sum(dim=-1)
        best = torch.argmin(sq, dim=-1)
        idx.append(best.to(torch.int32))
        dist.append(sq.gather(1, best[:, None])[:, 0].sqrt())
    return torch.cat(idx), torch.cat(dist)


def closest_vertices(v, points, chunk=2048, *, device="cuda"):
    """Nearest-vertex indices only (reference ClosestPointTree.nearest)."""
    return closest_vertices_with_distance(v, points, chunk, device=device)[0]


def closest_point_dispatch(v, f, pts, chunk=512, use_pallas=False,
                           nondegen=False, variant="fast"):
    """The closest-point body of the batched facades, on tensors on their
    own device: ``v`` [B, V, 3] with ``pts`` [B, Q, 3] and ``f`` [F, 3].

    With ``use_pallas`` the kernel route (counterpart of ``_strategy`` in
    mesh_tpu/batch.py): the sphere-culled kernel above ``crossover_faces()``
    faces, the brute-force ``closest_faces`` kernel up to it, each in one
    launch for the batch with the ``nondegen`` flag and the tile
    ``variant``, the route recorded in ``culled.STRATEGY``.  Without, the
    plain reconstruction scan (``closest_faces_and_points_t``, ``chunk``
    queries a step) per mesh, the reference's XLA form."""
    if not use_pallas:
        per_mesh = [closest_faces_and_points_t(vb, f, pb, chunk=chunk)
                    for vb, pb in zip(v, pts)]
        return {key: torch.stack([r[key] for r in per_mesh])
                for key in ("face", "part", "point", "sqdist")}
    culled = f.shape[0] > crossover_faces()
    record_strategy(("culled" if culled else "brute")
                    + ("_safe" if variant == "safe" else ""))
    query = closest_point_culled_kernel if culled else closest_point_kernel
    return query(v, f, pts, assume_nondegenerate=nondegen,
                 tile_variant=variant)
