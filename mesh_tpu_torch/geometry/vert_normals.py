"""Per-vertex normals (counterpart of mesh_tpu/geometry/vert_normals.py).

Area-scaled face normals are summed onto their three corner vertices and
the rows normalized.  The reference scatters with ``.at[].add``; on CUDA a
scatter (``index_add_``) adds with atomics, in an order that changes from
run to run.  Here the sum is a gather over a vertex-to-face CSR instead:

- ``vertex_csr`` lists each vertex's incident (face, corner) slots in face
  order (``offsets`` [V + 1], and the face of each slot, ``slot_faces``
  [3F]), built once per topology on the host and cached by a digest of
  ``f``;
- the face normals are gathered in that order and summed per vertex by
  ``torch.segment_reduce``, which adds each segment's rows one after the
  other (one thread per output on the card, a loop on the CPU).

So every vertex sums its faces in face order, with no atomics: the normals
are the same bits from run to run, on the card and on the CPU, and for a
mesh alone or inside any batch.  Face normals, sums and the normalization
run in float64 and round once to the vertices' dtype: where a vertex's
incident normals nearly cancel (a fold of a posed body), a float32 sum
loses digits, and ``chip_smoke.py`` holds the normals within 1e-5 of a
float64 recompute.  The segments take any valence (the
98,304-face UV-sphere template has two poles of valence 256) without a
table padded to the largest one.  Vertices that touch no face have an
empty segment and keep the zero vector.
"""

import hashlib
import weakref
from collections import OrderedDict

import numpy as np
import torch

from ..utils.device import as_tensor
from .tri_normals import normalize_rows

#: host CSRs by topology digest, and their device copies (bounded FIFOs)
_CSR_CACHE = OrderedDict()
#: id(f tensor) -> (weakref, version, n_verts, device CSR): a tensor that
#: comes back unchanged skips the host copy and the digest
_TENSOR_CSR = {}
_CSR_CACHE_MAX = 64


def _host_csr(f_host, n_verts):
    """(offsets [V + 1], slot_faces [3F]) int64 numpy arrays of ``f_host``
    [F, 3]: vertex v's slots are slot_faces[offsets[v]:offsets[v + 1]], its
    incident faces in face order (a face that repeats v lists it twice)."""
    flat = f_host.reshape(-1)
    if flat.size and (flat.min() < 0 or flat.max() >= n_verts):
        raise ValueError("faces index vertices outside [0, %d)" % n_verts)
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=n_verts)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    return offsets, (order // 3).astype(np.int64)


def vertex_csr(f, n_verts, device=None):
    """The vertex-to-face CSR of faces ``f`` [F, 3] (numpy array or tensor)
    over ``n_verts`` vertices: ``(offsets [V + 1], slot_faces [3F])`` int64
    tensors on ``device`` (default: ``f``'s own device, the CPU for a numpy
    array).  Cached by a blake2b digest of the faces, and, for a tensor, by
    the tensor itself while it is unchanged."""
    n_verts = int(n_verts)
    is_tensor = torch.is_tensor(f)
    dev = torch.device(device) if device is not None else (
        f.device if is_tensor else torch.device("cpu"))
    version = None
    if is_tensor:
        try:
            version = f._version
        except RuntimeError:        # inference tensors keep no version
            version = None
        hit = _TENSOR_CSR.get(id(f))
        if (hit is not None and version is not None and hit[0]() is f
                and hit[1:3] == (version, n_verts) and hit[3][0].device == dev):
            return hit[3]
        f_host = f.detach().cpu().numpy()
    else:
        f_host = np.asarray(f)
    f_host = np.ascontiguousarray(f_host, dtype=np.int64)
    digest = hashlib.blake2b(f_host.tobytes(), digest_size=16)
    digest.update(np.int64(n_verts).tobytes())
    key = digest.digest()
    entry = _CSR_CACHE.get(key)
    if entry is None:
        entry = {"host": _host_csr(f_host, n_verts)}
        if len(_CSR_CACHE) >= _CSR_CACHE_MAX:
            _CSR_CACHE.popitem(last=False)
        _CSR_CACHE[key] = entry
    csr = entry.get(dev)
    if csr is None:
        csr = entry[dev] = tuple(torch.as_tensor(x, device=dev)
                                 for x in entry["host"])
    if is_tensor and version is not None:
        if len(_TENSOR_CSR) >= _CSR_CACHE_MAX:
            for k in [k for k, v in _TENSOR_CSR.items() if v[0]() is None]:
                del _TENSOR_CSR[k]
            if len(_TENSOR_CSR) >= _CSR_CACHE_MAX:
                _TENSOR_CSR.pop(next(iter(_TENSOR_CSR)))
        _TENSOR_CSR[id(f)] = (weakref.ref(f), version, n_verts, csr)
    return csr


def _summed(v, f, csr):
    """Float64 sums of the incident scaled face normals per vertex: each
    face's cross(b - a, c - a) from its float64 corners (one gather per
    corner and one cross product, the fewest passes over the float64
    tensors), gathered in the CSR's slot order and summed per vertex."""
    batch = v.shape[:-2]
    n_verts = v.shape[-2]
    if csr is None:
        csr = vertex_csr(f, n_verts, v.device)
    offsets, slot_faces = csr
    v64 = v.to(torch.float64)
    corners = f.long()
    a, b, c = (v64[..., corners[:, k], :] for k in range(3))
    fn = torch.linalg.cross(b - a, c - a)                  # [..., F, 3]
    if not fn.numel():
        return torch.zeros(batch + (n_verts, 3), dtype=fn.dtype,
                           device=v.device)
    rows = fn.reshape((-1,) + fn.shape[-2:])[:, slot_faces]   # [N, 3F, 3]
    out = torch.segment_reduce(
        rows, "sum", offsets=offsets.expand(rows.shape[0], -1).contiguous(),
        axis=1, unsafe=True)
    return out.reshape(batch + (n_verts, 3))


def vert_normals_scaled_t(v, f, csr=None):
    """Sum of incident scaled face normals per vertex -> [..., V, 3] in
    ``v``'s dtype, each vertex's faces added in face order.  ``csr``:
    ``vertex_csr(f, V)``, made here when None (a host copy of a device
    ``f`` the first time)."""
    return _summed(v, f, csr).to(v.dtype)


def vert_normals_t(v, f, csr=None):
    """Unit vertex normals of tensors on their own device, in ``v``'s
    dtype; vertices that touch no face get the zero vector.  ``csr`` as in
    ``vert_normals_scaled_t``."""
    return normalize_rows(_summed(v, f, csr)).to(v.dtype)


def vert_normals_scaled(v, f, device="cuda"):
    """Sum of incident scaled face normals per vertex -> [..., V, 3]
    (reference VertNormalsScaled)."""
    return vert_normals_scaled_t(as_tensor(v, device), as_tensor(f, device))


def vert_normals(v, f, device="cuda"):
    """Unit vertex normals -> [..., V, 3] (reference VertNormals ==
    Mesh.estimate_vertex_normals)."""
    return vert_normals_t(as_tensor(v, device), as_tensor(f, device))
