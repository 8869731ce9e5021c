"""Differentiable surface queries: envelope-theorem gradients (counterpart
of mesh_tpu/diff/queries.py).

For a query p against a mesh (v, f) the squared surface distance is

    d2(p, v) = min_{face, bary in simplex} |p - sum_k bary_k v[f[face, k]]|^2

and by the envelope (Danskin) theorem its gradient needs no derivative of
the argmin: it is the partial gradient at the frozen winner,

    dd2/dp = 2 (p - cp),      dd2/dv[f[face, k]] = -2 bary_k (p - cp),

with cp = sum_k bary_k v[f[face, k]] the closest point, exact wherever d2
is differentiable (ties excepted).

The search runs AD-opaquely (``_Search``) on float32 copies of the inputs,
the kernels' type: on the card the hand-written kernels (the brute-force
``closest_faces`` or the sphere-culled ``culled_faces`` through
``closest_point_dispatch``, ``normal_weighted_faces``, the rope walks for an
``accel_index``), on the CPU their plain versions; under
``MESH_TPU_FORCE_XLA`` (or ``use_pallas=False``) the plain scan, or for an
``accel_index`` the plain BVH walk (``accel.traverse.bvh_search_faces``).
Only the winning face
is taken from it: point, sqdist and bary are recomposed from (face, bary)
in the caller's dtype, so the output and the backward linearize one
expression.  (On the CPU the search's own epilogue carries an autograd
graph when ``v`` requires grad; that graph is not the envelope gradient.)

Two modes:

- ``mode="frozen"`` (default): ``_Frozen``, a ``torch.autograd.Function``
  whose backward is the closed form above, one gather and one scatter-add
  (``index_add_``, whose atomics add in a run-dependent order on the
  card).  First-order reverse only; a cotangent on ``bary`` is dropped
  (the envelope theorem says it contributes nothing to distance terms).
- ``mode="recompute"``: the barycentrics are re-derived differentiably
  from (query, winning triangle) by ``closest_point_barycentric``, so
  ``torch.func.jvp``, second order and ``bary`` cotangents work.

Every wrapper returns a dict of ``point`` [..., Q, 3], ``sqdist`` [..., Q]
(differentiable), ``bary`` [..., Q, 3] (differentiable only under
``recompute``), ``face`` [..., Q] int32 and ``part`` [..., Q] int32.
"""

import math

import torch

from ..geometry.tri_normals import normalize_rows, tri_normals_scaled_t
from ..query.closest_point import (
    closest_faces_and_points_t,
    closest_point_dispatch,
)
from ..query.point_triangle import closest_point_barycentric
from ..utils.device import as_tensor
from ..utils.dispatch import pallas_default

__all__ = ["closest_point", "point_to_triangle", "nearest_normal_weighted",
           "surface_normals_frozen", "closest_point_batched"]

MODES = ("frozen", "recompute")


def _check_mode(mode):
    if mode not in MODES:
        raise ValueError("mode must be 'frozen' or 'recompute', got %r"
                         % (mode,))


class _Search(torch.autograd.Function):
    """``search(*tensors)`` -> int32 faces, opaque to every autodiff mode.

    Under ``torch.func`` transforms the forward of an autograd Function
    receives the unwrapped tensors, so the kernel wrappers get tensors with
    storage to launch on (a ``detach()`` inside a transform keeps the
    functorch wrapper, which has none); autograd records nothing inside
    a forward.  The faces carry no derivative: jvp and backward give
    nothing."""

    @staticmethod
    def forward(search, *tensors):
        return search(*tensors)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)
        ctx.n_inputs = len(inputs)

    @staticmethod
    def jvp(ctx, *tangents):
        return None

    @staticmethod
    def backward(ctx, grad):
        return (None,) * ctx.n_inputs

    @staticmethod
    def vmap(info, in_dims, search, *tensors):
        # jacfwd and hessian batch only the tangents: the search runs once
        if any(d is not None for d in in_dims[1:]):
            raise NotImplementedError(
                "the correspondence search does not batch under vmap; pass "
                "the batch as a leading axis (closest_point_batched)")
        return _Search.apply(search, *tensors), None


def _compose(points, tri, bary):
    """cp = sum_k bary_k corner_k and its squared distance: the expression
    the envelope backward linearizes, so the outputs are recomposed from
    it rather than taken from the search's epilogue."""
    point = (bary[..., :, None] * tri).sum(dim=-2)
    diff = points - point
    return point, diff, (diff * diff).sum(dim=-1)


def _tri_outputs(points, tri):
    """(point, sqdist, bary, part) of ``points`` [..., 3] on the triangles
    ``tri`` [..., 3, 3]: the barycentric argmin, then ``_compose``."""
    bary, part = closest_point_barycentric(
        points, tri[..., 0, :], tri[..., 1, :], tri[..., 2, :])
    point, _, sqdist = _compose(points, tri, bary)
    return point, sqdist, bary, part


def _envelope_backward(points, point, bary, g_point, g_sqdist):
    """The envelope VJP of (point, sqdist) at frozen ``bary``: the
    cotangent of the queries [..., 3] and of the three corners [..., 3, 3]
    (row k the cotangent of corner k)."""
    # sqdist = |points - cp|^2: d/d points = +2 diff, d/d cp = -2 diff
    g_points = 2.0 * (points - point) * g_sqdist[..., None]
    g_cp = g_point - g_points
    # cp = sum_k bary_k corner_k
    return g_points, bary[..., :, None] * g_cp[..., None, :]


def _gather(v, corners):
    """Corners [B, Q, 3] of the meshes ``v`` [B, V, 3] -> [B, Q, 3, 3]."""
    rows = torch.arange(v.shape[0], device=v.device)[:, None, None]
    return v[rows, corners]


def _winner_outputs(v, corners, face, points):
    """The result dict from the winning faces (``corners`` = f[face]):
    differentiable barycentrics on the frozen winner, recomposed
    point/sqdist."""
    point, sqdist, bary, part = _tri_outputs(points, _gather(v, corners))
    return {"face": face, "part": part, "bary": bary, "point": point,
            "sqdist": sqdist}


class _Frozen(torch.autograd.Function):
    """(point, sqdist, bary, part) at fixed winning corners [B, Q, 3] of
    ``v`` [B, V, 3], with the envelope-theorem backward into (v, points)."""

    @staticmethod
    def forward(v, points, corners):
        res = _winner_outputs(v, corners, None, points)
        return res["point"], res["sqdist"], res["bary"], res["part"]

    @staticmethod
    def setup_context(ctx, inputs, output):
        v, points, corners = inputs
        point, _, bary, part = output
        ctx.mark_non_differentiable(bary, part)
        ctx.save_for_backward(points, point, bary, corners)
        ctx.v_shape = v.shape

    @staticmethod
    def backward(ctx, g_point, g_sqdist, g_bary, g_part):
        points, point, bary, corners = ctx.saved_tensors
        g_points, g_corners = _envelope_backward(points, point, bary,
                                                 g_point, g_sqdist)
        # cp = sum_k bary_k v[corner_k]: scatter-add each corner's cotangent
        # into the three winning corners of each query
        n_b, n_v = ctx.v_shape[:2]
        base = torch.arange(n_b, device=corners.device)[:, None, None] * n_v
        dv = torch.zeros((n_b * n_v, 3), dtype=g_corners.dtype,
                         device=g_corners.device)
        dv.index_add_(0, (base + corners).reshape(-1),
                      g_corners.reshape(-1, 3))
        return dv.view(ctx.v_shape), g_points, None


def _from_face(v, f, face, points, mode):
    """The result dict of batched ``v`` [B, V, 3] and ``points`` [B, Q, 3]
    at the winning faces ``face`` [B, Q]."""
    corners = f[face.long()]
    if mode == "frozen":
        point, sqdist, bary, part = _Frozen.apply(v, points, corners)
        return {"face": face, "part": part, "bary": bary, "point": point,
                "sqdist": sqdist}
    return _winner_outputs(v, corners, face, points)


def _face_search(f, chunk, use_pallas, nondegen, variant, accel_index):
    """The search ``(v [B, V, 3], points [B, Q, 3]) -> faces [B, Q] int32``
    in float32.  ``use_pallas`` (default ``pallas_default``) takes the
    kernel route: the rope walks over ``accel_index``, else
    ``closest_point_dispatch`` (one launch for the whole batch); without
    it, the plain BVH walk over ``accel_index``, else the plain scan."""
    if use_pallas is None:
        use_pallas = pallas_default()
    if accel_index is not None:
        from ..accel.traverse import (
            bvh_search_faces,
            closest_faces_and_points_accel,
        )

        if accel_index.kind != "bvh":
            # the reference's grid fallback is a host re-run, which an
            # opaque search inside autodiff cannot make
            raise ValueError("closest_point wants a 'bvh' accel_index, got %r"
                             % (accel_index.kind,))
        if not use_pallas:
            def search(v, pts):
                return torch.stack([
                    bvh_search_faces(accel_index, vb.float(), f, pb.float())
                    for vb, pb in zip(v, pts)])
            return search

        def search(v, pts):
            # the rope walks take one mesh a call
            return torch.stack([torch.as_tensor(
                closest_faces_and_points_accel(
                    vb.float(), f, pb.float(), kind="bvh", index=accel_index,
                    device=vb.device)["face"], device=vb.device)
                for vb, pb in zip(v, pts)])
    elif not use_pallas:
        def search(v, pts):
            return torch.stack([
                closest_faces_and_points_t(vb.float(), f, pb.float(),
                                           chunk=chunk)["face"]
                for vb, pb in zip(v, pts)])
    else:
        def search(v, pts):
            return closest_point_dispatch(v.float(), f, pts.float(), chunk,
                                          True, nondegen, variant)["face"]
    return search


def _closest_batched(v, f, points, mode, chunk, use_pallas, nondegen,
                     variant, accel_index):
    _check_mode(mode)
    search = _face_search(f, chunk, use_pallas, nondegen, variant,
                          accel_index)
    face = _Search.apply(search, v, points)
    return _from_face(v, f, face, points, mode)


def _inputs(v, f, points, device):
    """(v, f int64, points in v's dtype) as tensors on ``device``."""
    v = as_tensor(v, device)
    return (v, as_tensor(f, v.device, torch.int64),
            as_tensor(points, v.device, v.dtype))


def closest_point(v, f, points, *, mode="frozen", chunk=512,
                  use_pallas=None, nondegen=False, variant="fast",
                  accel_index=None, device="cuda"):
    """Differentiable closest point on the surface.

    :param v: [V, 3] vertices (differentiable)
    :param f: [F, 3] int faces (static topology)
    :param points: [Q, 3] queries (differentiable)
    :param mode: ``"frozen"`` (hand-written backward) or ``"recompute"``
        (differentiable re-derivation; jvp and second order)
    :param chunk: query rows a step of the plain scan
    :param use_pallas: False takes the plain scan (the reference's XLA
        scan); True takes ``closest_point_dispatch``, the kernel on the
        card; the default is ``pallas_default()``
    :param nondegen: ``assume_nondegenerate`` for the kernel tile
    :param variant: the kernel's tile variant (``"fast"`` / ``"safe"``)
    :param accel_index: a BVH ``AccelIndex`` of this topology
        (``accel.get_index(v, f, "bvh")``): the search walks it with the
        rope kernels instead of scanning every face; the gradients, which
        use only the winning face, are unchanged.  A grid index raises.
    :param device: where to run (the card unless ``"cpu"``)
    :returns: dict of ``point`` [Q, 3], ``sqdist`` [Q], ``bary`` [Q, 3],
        ``face`` [Q] int32, ``part`` [Q] int32
    """
    v, f, points = _inputs(v, f, points, device)
    res = _closest_batched(v[None], f, points[None], mode, chunk, use_pallas,
                           nondegen, variant, accel_index)
    return {key: val[0] for key, val in res.items()}


def closest_point_batched(v, f, points, *, mode="frozen", chunk=512,
                          use_pallas=None, nondegen=False, variant="fast",
                          accel_index=None, device="cuda"):
    """``closest_point`` over stacked meshes and queries, (..., V, 3) x
    (..., S, 3) with shared topology and any number of leading axes: one
    kernel launch for the whole batch (the reference lifts the query over
    the batch with ``jax.vmap``)."""
    v, f, points = _inputs(v, f, points, device)
    lead = v.shape[:-2]
    if points.shape[:-2] != lead:
        raise ValueError("closest_point_batched: v %r and points %r differ "
                         "in their leading axes"
                         % (tuple(v.shape), tuple(points.shape)))
    n_b = math.prod(lead)
    res = _closest_batched(v.reshape((n_b,) + v.shape[-2:]), f,
                           points.reshape((n_b,) + points.shape[-2:]), mode,
                           chunk, use_pallas, nondegen, variant, accel_index)
    return {key: val.reshape(lead + val.shape[1:])
            for key, val in res.items()}


class _TriFrozen(torch.autograd.Function):
    """(point, sqdist, bary, part) of p on triangles abc (all [..., 3],
    broadcast), with the envelope backward into p, a, b and c."""

    @staticmethod
    def forward(p, a, b, c):
        return _tri_outputs(p, torch.stack([a, b, c], dim=-2))

    @staticmethod
    def setup_context(ctx, inputs, output):
        point, _, bary, part = output
        ctx.mark_non_differentiable(bary, part)
        ctx.save_for_backward(inputs[0], point, bary)

    @staticmethod
    def backward(ctx, g_point, g_sqdist, g_bary, g_part):
        g_p, g_corners = _envelope_backward(*ctx.saved_tensors, g_point,
                                            g_sqdist)
        return g_p, *g_corners.unbind(dim=-2)


def point_to_triangle(p, a, b, c, *, mode="frozen", device="cuda"):
    """Differentiable point-to-triangle distance: no search, the "winning
    face" is the given triangle and only the barycentric argmin is
    enveloped.  Elementwise over matching leading axes of ``p``, ``a``,
    ``b``, ``c`` [..., 3]; returns ``point``, ``sqdist``, ``bary`` and
    ``part`` as ``closest_point`` (no ``face``)."""
    _check_mode(mode)
    p = as_tensor(p, device)
    p, a, b, c = torch.broadcast_tensors(
        p, *(as_tensor(x, p.device, p.dtype) for x in (a, b, c)))
    if mode == "frozen":
        point, sqdist, bary, part = _TriFrozen.apply(p, a, b, c)
    else:
        point, sqdist, bary, part = _tri_outputs(
            p, torch.stack([a, b, c], dim=-2))
    return {"part": part, "bary": bary, "point": point, "sqdist": sqdist}


def nearest_normal_weighted(v, f, points, normals, *, eps=0.1,
                            mode="frozen", chunk=512, device="cuda"):
    """Differentiable normal-weighted nearest query.

    The ``normal_weighted_faces`` search picks the face of least blended
    cost ``|p - q| + eps (1 - n_p . n_tri)``; the differentiable output is
    the euclidean closest point on that frozen face (the AabbNormalsTree
    contract), so gradients flow through (v, points) as in
    ``closest_point``.  ``normals`` only choose the face, a discrete
    choice: their gradient is zero and they are not differentiated.
    ``chunk`` is the reference's scan chunk, which the kernel and its
    plain version do not take."""
    from ..query.normal_weighted import nearest_normal_weighted_kernel

    _check_mode(mode)
    v, f, points = _inputs(v, f, points, device)
    normals = as_tensor(normals, v.device, v.dtype)

    def search(v_, pts, nrm):
        return nearest_normal_weighted_kernel(v_.float(), f, pts.float(),
                                              nrm.float(), eps=eps)[0]

    face = _Search.apply(search, v[None], points[None], normals[None])
    res = _from_face(v[None], f, face, points[None], mode)
    return {key: val[0] for key, val in res.items()}


def surface_normals_frozen(v, f, face, *, device="cuda"):
    """Unit normals of the winning faces, detached from autodiff: the
    point-to-plane energy freezes the normal over an inner window, so it is
    computed but never differentiated."""
    v = as_tensor(v, device).detach()
    f = as_tensor(f, v.device, torch.int64)
    n = normalize_rows(tri_normals_scaled_t(v, f))
    return n[as_tensor(face, v.device).long()]
