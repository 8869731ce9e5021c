"""Small array helpers (counterpart of mesh_tpu/utils/arrays.py; parity
with reference mesh/utils.py:6-22).

``row`` / ``col`` / ``sparse`` keep the reference's numpy/scipy semantics
for host-side topology code; ``asarray_f32`` / ``asarray_i32`` are the
dtype-policy chokepoints for arrays bound for the device (float32 / int32
there, the reference's float64 / uint32 on the host, mesh.py:68-70).
"""

import numpy as np
import scipy.sparse as sp


def row(A):
    """Reshape to a (1, N) row vector (reference utils.py:6-7)."""
    return np.reshape(A, (1, -1))


def col(A):
    """Reshape to an (N, 1) column vector (reference utils.py:10-11)."""
    return np.reshape(A, (-1, 1))


def sparse(i, j, data, m=None, n=None):
    """Build a csc matrix from triplets (reference utils.py:14-22)."""
    ij = np.vstack((row(i), row(j)))
    if m is None:
        m = ij[0].max() + 1
    if n is None:
        n = ij[1].max() + 1
    return sp.csc_matrix((data, ij), shape=(m, n))


def asarray_f32(x):
    return np.ascontiguousarray(
        np.asarray(x, dtype=np.float64).astype(np.float32))


def asarray_i32(x):
    return np.ascontiguousarray(np.asarray(x), dtype=np.int32)
