"""Closest-point-on-mesh and closest-vertex queries (counterpart of
mesh_tpu/query/closest_point.py).

``closest_faces_and_points`` is the plain chunked scan in the reference's
reconstruction form (barycentric point per pair, then the argmin), kept as
an independent oracle of the kernel path.  ``closest_vertices*`` run the
``nearest_vertices`` kernel on the card and its plain version on the CPU;
``closest_point_dispatch`` is the batched facades' switch between the
brute-force and the sphere-culled kernel.
"""

import torch

from ..utils.device import as_tensor
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


def closest_faces_and_points(v, f, points, chunk=512, device="cuda"):
    """For each query point, the nearest face / part / point on the mesh,
    by the plain scan.

    :returns: dict with ``face`` [Q] int32, ``part`` [Q] int32 (CGAL codes
        0-6), ``point`` [Q, 3] and ``sqdist`` [Q].
    """
    v = as_tensor(v, device)
    return closest_faces_and_points_t(v, as_tensor(f, device),
                                      as_tensor(points, device), chunk=chunk)


def closest_vertices_with_distance(v, points, device="cuda"):
    """Nearest mesh vertex per query -> (index [Q] int32, distance [Q])."""
    return nearest_vertices_kernel(as_tensor(v, device, torch.float32),
                                   as_tensor(points, device, torch.float32))


def closest_vertices(v, points, device="cuda"):
    """Nearest-vertex indices only (reference ClosestPointTree.nearest)."""
    return closest_vertices_with_distance(v, points, device=device)[0]


def closest_point_dispatch(v, f, pts, *, assume_nondegenerate=False,
                           tile_variant="fast"):
    """The closest-point body of the batched facades, on tensors on their
    own device (counterpart of ``_strategy`` in mesh_tpu/batch.py): the
    sphere-culled kernel above ``crossover_faces()`` faces, the brute-force
    ``closest_faces`` kernel up to it; both take ``v`` [B, V, 3] with
    ``pts`` [B, Q, 3] in one launch.  Records the route in
    ``culled.STRATEGY``."""
    culled = f.shape[0] > crossover_faces()
    record_strategy(("culled" if culled else "brute")
                    + ("_safe" if tile_variant == "safe" else ""))
    query = closest_point_culled_kernel if culled else closest_point_kernel
    return query(v, f, pts, assume_nondegenerate=assume_nondegenerate,
                 tile_variant=tile_variant)
