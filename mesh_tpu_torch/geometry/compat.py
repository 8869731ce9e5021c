"""Reference-named geometry API with chumpy-era names and flattened shapes
(counterpart of mesh_tpu/geometry/compat.py).

Downstream body-model pipelines import the reference's MATLAB-style symbols
(``TriNormals``, ``VertNormals``, ...), which pass FLATTENED 1-D arrays
between steps.  This module keeps those names, argument orders and output
shapes over the natural-shape functions, with numpy outputs; the work runs
on ``device``.
"""

import numpy as np
import torch

from ..utils.device import as_tensor
from .cross_product import cross3
from .tri_normals import normalize_rows, tri_edges_t, tri_normals_scaled_t
from .vert_normals import vert_normals_t


def _rows(x, device):
    return as_tensor(np.asarray(x), device).reshape(-1, 3)


def _faces(f, device):
    return as_tensor(np.asarray(f).astype(np.int64), device)


def _host(t):
    return t.cpu().numpy()


def CrossProduct(a, b, *, device="cuda"):
    """Row-wise cross of two (N*3,)-or-(N, 3) arrays, flattened."""
    return _host(cross3(_rows(a, device), _rows(b, device))).flatten()


def TriEdges(v, f, cplus, cminus, *, device="cuda"):
    """v[f[:, cplus]] - v[f[:, cminus]], raveled."""
    return _host(tri_edges_t(_rows(v, device), _faces(f, device), cplus,
                             cminus)).ravel()


def TriNormalsScaled(v, f, *, device="cuda"):
    """Unnormalized face normals, flattened."""
    return _host(tri_normals_scaled_t(_rows(v, device),
                                      _faces(f, device))).flatten()


def TriNormals(v, f, *, device="cuda"):
    """Unit face normals, flattened."""
    return _host(normalize_rows(tri_normals_scaled_t(
        _rows(v, device), _faces(f, device)))).flatten()


def NormalizedNx3(v, *, device="cuda"):
    """Row-normalize a flattened xyz array (float64), flattened, with the
    zero-row guard."""
    return _host(normalize_rows(_rows(np.asarray(v, np.float64),
                                      device))).flatten()


def TriToScaledNormal(x, tri, *, device="cuda"):
    """Scaled face normals as (F, 3), the one 2-D output of the family."""
    return _host(tri_normals_scaled_t(_rows(x, device), _faces(tri, device)))


def NormalizeRows(x, *, device="cuda"):
    """Row-normalize a 2-D array (float64), 2-D output."""
    return _host(normalize_rows(as_tensor(np.asarray(x, np.float64),
                                          device)))


def MatVecMult(mtx, vec, *, device="cuda"):
    """Sparse matrix (scipy) times a flattened vector, flattened."""
    csr = mtx.tocsr()
    m = torch.sparse_csr_tensor(
        as_tensor(csr.indptr.astype(np.int64), device),
        as_tensor(csr.indices.astype(np.int64), device),
        as_tensor(csr.data.astype(np.float64), device), size=csr.shape)
    x = as_tensor(np.asarray(vec).reshape(-1, 1), device, m.dtype)
    return _host(m @ x).flatten()


def VertNormals(v, f, *, device="cuda"):
    """Unit vertex normals, flattened."""
    return _host(vert_normals_t(_rows(v, device), _faces(f, device))).flatten()


def VertNormalsScaled(v, f, *, device="cuda"):
    """The reference's quirk kept: despite the name it normalizes the
    accumulated normals too."""
    return VertNormals(v, f, device=device)
