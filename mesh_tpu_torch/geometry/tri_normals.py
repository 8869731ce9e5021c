"""Per-face normals (counterpart of mesh_tpu/geometry/tri_normals.py).

``v`` is ``[..., V, 3]`` with any leading batch axes and ``f`` is ``[F, 3]``
shared topology.  The ``*_t`` functions work on tensors on their own device;
the public functions take ``device=`` and move their inputs there.
"""

from ..utils.device import as_tensor
from .cross_product import cross3


def tri_edges_t(v, f, cplus, cminus):
    """Edge vectors v[f[:, cplus]] - v[f[:, cminus]] -> [..., F, 3]."""
    gathered = v[..., f.long(), :]          # [..., F, 3 corner, 3 xyz]
    return gathered[..., cplus, :] - gathered[..., cminus, :]


def tri_edges(v, f, cplus, cminus, device="cuda"):
    """Edge vectors v[f[:, cplus]] - v[f[:, cminus]] -> [..., F, 3]
    (reference TriEdges)."""
    v = as_tensor(v, device)
    return tri_edges_t(v, as_tensor(f, v.device), cplus, cminus)


def tri_normals_scaled_t(v, f):
    """Unnormalized face normals cross(e10, e20) -> [..., F, 3]
    (magnitude = twice the triangle area)."""
    return cross3(tri_edges_t(v, f, 1, 0), tri_edges_t(v, f, 2, 0))


def normalize_rows(x, eps=0.0):
    """Row-normalize (..., 3); rows with zero norm stay zero (reference
    NormalizedNx3's divide-by-one guard)."""
    sqnorm = (x * x).sum(dim=-1, keepdim=True)
    sqnorm = sqnorm.masked_fill(sqnorm <= eps, 1.0)
    return x / sqnorm.sqrt()


def tri_normals_scaled(v, f, device="cuda"):
    return tri_normals_scaled_t(as_tensor(v, device), as_tensor(f, device))


def tri_normals(v, f, device="cuda"):
    """Unit face normals -> [..., F, 3] (reference TriNormals)."""
    return normalize_rows(tri_normals_scaled(v, f, device=device))
