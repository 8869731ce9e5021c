"""Per-(camera, vertex) ray-cast visibility (counterpart of
mesh_tpu/query/visibility.py, on the kernel route the reference takes on
its chip).

A vertex is visible from a camera iff the ray from ``vert + min_dist *
dir`` towards the camera (``dir = normalize(cam - vert)``, extended to
infinity like CGAL's Ray_3) hits no occluder triangle (reference
mesh/src/visibility.cpp:75-133).  An optional 9-float sensor per camera
(the x, y and z axes of its sensor plane) also requires the ray to land
within the sensor's extents, and an extra occluder mesh can be merged in.

The O(C V) directions, origins, n.dir and sensor tests are PyTorch; the
O(C V F) blocked test is one launch of the ``ray_any_hit`` kernel for the
whole batch of meshes and cameras (``ray_kernel.py``).
"""

import numpy as np
import torch

from ..utils.device import as_tensor
from .ray_kernel import ray_any_hit, ray_planes


def _dot3(x, y):
    return x[..., 0] * y[..., 0] + x[..., 1] * y[..., 1] + x[..., 2] * y[..., 2]


def visibility_rays(verts, cams, min_dist=1e-3):
    """(origins [B, C*V, 3], dirs [B, C, V, 3]): the unit direction from
    each vertex of ``verts`` [B, V, 3] to each camera of ``cams`` [C, 3],
    and the ray origin ``min_dist`` along it."""
    dirs = cams[None, :, None, :] - verts[:, None]
    dirs = dirs / _dot3(dirs, dirs).sqrt()[..., None]
    origins = verts[:, None] + min_dist * dirs
    return origins.reshape(verts.shape[0], -1, 3).contiguous(), dirs


def sensor_mask(verts, dirs, cams, sensors):
    """True where the ray from each vertex along ``dirs`` [B, C, V, 3] lands
    within its camera's sensor extents (reference _sensor_mask, the 9-float
    sensor model of visibility.cpp:96-113); ``sensors`` [C, 9]."""
    xoff = sensors[:, None, 0:3]                         # [C, 1, 3]
    yoff = sensors[:, None, 3:6]
    zoff = -sensors[:, None, 6:9]
    planeoff = _dot3(zoff, cams[:, None] + zoff)         # [C, 1]
    denom = _dot3(zoff, dirs)                            # [B, C, V]
    denom = torch.where(denom == 0, torch.full_like(denom, 1e-30), denom)
    tt = -(_dot3(verts[:, None], zoff) - planeoff) / denom
    p_i = (verts[:, None] + tt[..., None] * dirs) - (cams[:, None] + zoff)
    return ((_dot3(p_i, xoff).abs() < _dot3(xoff, xoff))
            & (_dot3(p_i, yoff).abs() < _dot3(yoff, yoff)))


def visibility_local(verts, occ_tri, cams, normals, sensors=None,
                     min_dist=1e-3):
    """The visibility core on tensors on their own device: ``verts``
    [B, V, 3] tested against occluders ``occ_tri`` [B, F, 3, 3] from
    ``cams`` [C, 3]; ``normals`` [B, V, 3] for n.dir; ``sensors`` [C, 9] or
    None.  Returns (visible [B, C, V] bool, n_dot_cam [B, C, V])."""
    origins, dirs = visibility_rays(verts, cams, min_dist)
    blocked, _ = ray_any_hit(origins,
                             dirs.reshape(origins.shape).contiguous(),
                             ray_planes(occ_tri), t_lo=0.0)
    reach = ~blocked.reshape(dirs.shape[:-1])
    ndc = _dot3(normals[:, None], dirs)
    if sensors is not None:
        reach = reach & sensor_mask(verts, dirs, cams, sensors)
    return reach, ndc


def visibility_compute(v, f, cams, n=None, sensors=None, extra_v=None,
                       extra_f=None, min_dist=1e-3, device="cuda"):
    """Reference-compatible entry point (py_visibility.cpp:81-213).

    :param v: [V, 3] vertices to test
    :param f: [F, 3] occluder faces over v
    :param cams: [C, 3] camera centers
    :param n: optional [V, 3] vertex normals (for the n.dir output)
    :param sensors: optional [C, 9] sensor axes (x, y, z rows flattened)
    :param extra_v / extra_f: optional additional occluder mesh
    :param min_dist: ray-origin offset (default 1e-3 as the reference)
    :returns: (visibility [C, V] uint32, n_dot_cam [C, V] float64)
    """
    v = as_tensor(np.asarray(v, np.float32), device)
    occ = v[as_tensor(np.asarray(f, np.int64), device)]
    if extra_v is not None and extra_f is not None:
        extra = as_tensor(np.asarray(extra_v, np.float32), device)[
            as_tensor(np.asarray(extra_f, np.int64), device)]
        occ = torch.cat([occ, extra], dim=0)
    cams = as_tensor(np.atleast_2d(np.asarray(cams, np.float32)), device)
    normals = (torch.zeros_like(v) if n is None
               else as_tensor(np.asarray(n, np.float32), device))
    sens = None if sensors is None else as_tensor(
        np.atleast_2d(np.asarray(sensors, np.float32)), device)
    vis, ndc = visibility_local(v[None], occ[None], cams, normals[None],
                                sens, min_dist)
    return (vis[0].cpu().numpy().astype(np.uint32),
            ndc[0].cpu().numpy().astype(np.float64))
