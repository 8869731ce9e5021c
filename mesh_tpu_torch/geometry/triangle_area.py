"""Per-triangle areas (counterpart of mesh_tpu/geometry/triangle_area.py)."""

from ..utils.device import as_tensor
from .tri_normals import tri_normals_scaled_t


def triangle_area(v, f, *, device="cuda"):
    """Area of each face -> [..., F] (= |scaled normal| / 2)."""
    v = as_tensor(v, device)
    n = tri_normals_scaled_t(v, as_tensor(f, v.device))
    return (n * n).sum(dim=-1).sqrt() / 2.0
