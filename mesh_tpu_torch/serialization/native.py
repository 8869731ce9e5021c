"""ctypes binding for the port's native I/O core (``native/meshio.cpp``;
counterpart of mesh_tpu/serialization/native.py).

Compiled on first use by ``g++ -O3`` into ``build/mesh_tpu_torch/`` beside
the package, under a name keyed by the source's and flags' digest, so an
edited source never loads a stale library; the build writes a temporary
file and renames it into place, so processes building at once never load a
half-written one.  The ABI is plain C consumed through ctypes.  It is host
code, not a device kernel.  Without a compiler (or a writable build
folder) it is unavailable, silently: callers check ``available()`` and
use the pure-Python codecs, which give the same arrays and bytes (the
reference's graceful degradation for missing compiled extensions,
mesh.py:21-24)."""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_lock = threading.Lock()
_lib = None
_tried = False

# the C++ source ships inside the package (package-data in pyproject.toml)
# so installed copies can still build it
_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "native",
    "meshio.cpp",
)
_FLAGS = ["-O3", "-shared", "-fPIC"]
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "mesh_tpu_torch")


def library_path():
    """Where the library for the current source and flags lives."""
    with open(_SRC, "rb") as fp:
        digest = hashlib.sha256(fp.read() + " ".join(_FLAGS).encode())
    return os.path.join(BUILD_DIR, "meshio-%s.so" % digest.hexdigest()[:16])


def _build_and_load():
    if not os.path.exists(_SRC):
        return None
    so_path = library_path()
    if not os.path.exists(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = "%s.%d.tmp" % (so_path, os.getpid())
        cmd = ["g++"] + _FLAGS + ["-o", tmp, _SRC]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so_path)
        except Exception:
            if os.path.exists(tmp):
                os.remove(tmp)
            return None
    lib = ctypes.CDLL(so_path)
    lib.obj_load.restype = ctypes.c_void_p
    lib.obj_load.argtypes = [ctypes.c_char_p]
    lib.obj_free.argtypes = [ctypes.c_void_p]
    lib.obj_error.restype = ctypes.c_char_p
    lib.obj_error.argtypes = [ctypes.c_void_p]
    lib.obj_events.restype = ctypes.c_char_p
    lib.obj_events.argtypes = [ctypes.c_void_p]
    lib.obj_counts.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.obj_copy.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 7
    lib.ply_load.restype = ctypes.c_void_p
    lib.ply_load.argtypes = [ctypes.c_char_p]
    lib.ply_free.argtypes = [ctypes.c_void_p]
    lib.ply_error.restype = ctypes.c_char_p
    lib.ply_error.argtypes = [ctypes.c_void_p]
    lib.ply_counts.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.ply_copy.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 4
    lib.ply_write.restype = ctypes.c_char_p
    lib.ply_write.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_char_p,
    ]
    lib.obj_write.restype = ctypes.c_char_p
    lib.obj_write.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_void_p,          # v
        ctypes.c_int64, ctypes.c_void_p,          # vn
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,  # vt, vt_cols
        ctypes.c_int64, ctypes.c_void_p,          # f
        ctypes.c_void_p, ctypes.c_void_p,         # ft, fn
        ctypes.c_int,                             # flip
    ]
    return lib


def _get_lib():
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                _lib = _build_and_load()
            except Exception:
                _lib = None
    return _lib


def available():
    return _get_lib() is not None


def load_obj_native(filename):
    """Parse an OBJ with the native core; same dict contract as
    serialization.obj.load_obj.  Raises on I/O errors."""
    from ..errors import SerializationError

    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native meshio unavailable")
    handle = lib.obj_load(filename.encode())
    try:
        err = lib.obj_error(handle)
        if err:
            raise SerializationError(err.decode())
        counts = (ctypes.c_int64 * 8)()
        lib.obj_counts(handle, counts)
        nv, nvt, nvn, nf, nft, nfn, nvc, vtw = (int(c) for c in counts)

        def buf(n, width, dtype):
            return np.empty((n, width), dtype=dtype) if n else None

        v = buf(nv, 3, np.float64)
        vt = buf(nvt, vtw, np.float64)
        vn = buf(nvn, 3, np.float64)
        vc = buf(nvc, 3, np.float64)
        f = buf(nf, 3, np.int64)
        ft = buf(nft, 3, np.int64)
        fn = buf(nfn, 3, np.int64)

        def ptr(arr):
            return arr.ctypes.data_as(ctypes.c_void_p) if arr is not None else None

        lib.obj_copy(handle, ptr(v), ptr(vt), ptr(vn), ptr(vc),
                     ptr(f), ptr(ft), ptr(fn))
        events = lib.obj_events(handle).decode()
    finally:
        lib.obj_free(handle)

    out = {
        "v": v if v is not None else np.zeros((0, 3)),
        "f": f if f is not None else np.zeros((0, 3), np.int64),
    }
    for key, arr in (("vt", vt), ("vn", vn), ("vc", vc), ("ft", ft), ("fn", fn)):
        if arr is not None:
            out[key] = arr

    # decode the event log: segment starts, landmarks, mtllib
    segm = {}
    landm = {}
    seg_starts = []  # (face_idx, name) in order
    for line in events.splitlines():
        kind, _, rest = line.partition(" ")
        if kind == "g":
            name, _, idx = rest.rpartition(" ")
            seg_starts.append((int(idx), name))
            segm.setdefault(name, [])
        elif kind == "l":
            name, _, idx = rest.rpartition(" ")
            landm[name] = int(idx)
        elif kind == "m":
            out["mtl_path"] = rest
    if seg_starts:
        n_faces = out["f"].shape[0]
        for i, (start, name) in enumerate(seg_starts):
            end = seg_starts[i + 1][0] if i + 1 < len(seg_starts) else n_faces
            segm[name].extend(range(start, end))
    if segm:
        out["segm"] = segm
    if landm:
        out["landm"] = landm
    return out


def write_ply_native(filename, v, f=None, vc=None, vn=None, ascii=False,
                     little_endian=True, comments=()):
    """Write a PLY through the native core; byte-identical to
    ply.write_ply_data (which byte-matches the reference's rply output).

    Same contract as write_ply_data: ``v`` (V,3) float, ``f`` (F,3) int or
    None, ``vc`` colors in [0,1] (stored uchar), ``vn`` float normals.
    """
    from ..errors import SerializationError

    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native meshio unavailable")

    v = np.ascontiguousarray(np.asarray(v, dtype=np.float64))
    n_v = v.shape[0]
    use_color = vc is not None and np.shape(vc)[0] == n_v
    use_normals = vn is not None and np.shape(vn)[0] == n_v
    if f is None or np.size(f) == 0:
        f_arr, n_f = None, 0
    else:
        f_arr = np.ascontiguousarray(np.asarray(f, dtype=np.int32))
        n_f = f_arr.shape[0]
    vn_arr = (
        np.ascontiguousarray(np.asarray(vn, dtype=np.float64))
        if use_normals else None
    )
    vc_arr = (
        np.ascontiguousarray(
            (np.asarray(vc, dtype=np.float64) * 255).astype(int).astype(np.uint8)
        )
        if use_color else None
    )
    mode = 0 if ascii else (1 if little_endian else 2)
    # an explicit empty-string comment must still emit a "comment " line,
    # so gate on the sequence length, not the joined blob's truthiness
    comments = list(comments)
    comment_blob = "\n".join(comments) if len(comments) else None

    def ptr(arr):
        return arr.ctypes.data_as(ctypes.c_void_p) if arr is not None else None

    err = lib.ply_write(
        filename.encode(), n_v, ptr(v), ptr(vn_arr), ptr(vc_arr),
        n_f, ptr(f_arr), mode,
        comment_blob.encode() if comment_blob is not None else None,
    )
    if err:
        raise SerializationError(err.decode())


def write_obj_native(filename, v, f=None, vn=None, vt=None, ft=None,
                     fn=None, flip_faces=False, header=""):
    """Write an OBJ through the native core; byte-identical to the layout
    obj.write_obj_data emits for ungrouped faces.  ``header`` is the
    pre-rendered comment/mtllib block (it precedes the vertex lines)."""
    from ..errors import SerializationError

    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native meshio unavailable")

    # the C side assumes fixed strides and equal face-array lengths;
    # validate here so malformed inputs raise (as the Python writer would)
    # instead of reading out of bounds behind the pointer
    def coords(arr, name, cols=(3,)):
        if arr is None:
            return None
        out = np.ascontiguousarray(np.asarray(arr, dtype=np.float64))
        if out.ndim != 2 or out.shape[1] not in cols:
            raise ValueError(
                "%s must be (N, %s), got %s" % (name, cols, out.shape)
            )
        return out

    v = coords(v, "v")
    # vn only written alongside fn; vt only alongside ft (the Python
    # writer's gating — callers pass them pre-gated)
    vn_arr = coords(vn, "vn")
    vt_arr = coords(vt, "vt", cols=(2, 3))
    vt_cols = int(vt_arr.shape[1]) if vt_arr is not None else 2

    def idx(arr, name):
        if arr is None:
            return None, 0
        out = np.ascontiguousarray(np.asarray(arr, dtype=np.int64))
        if out.ndim != 2 or out.shape[1] != 3:
            raise ValueError("%s must be (F, 3), got %s" % (name, out.shape))
        return out, out.shape[0]

    f_arr, n_f = idx(f, "f")
    ft_arr, n_ft = idx(ft, "ft")
    fn_arr, n_fn = idx(fn, "fn")
    if ft_arr is not None and fn_arr is None:
        # the a/b/c face form interleaves texture AND normal indices; the
        # Python writer has the same requirement (it would raise there,
        # here it must not reach the C layer as a null deref)
        raise ValueError("ft requires fn for the v/vt/vn face form")
    for name, n in (("ft", n_ft), ("fn", n_fn)):
        if n and n != n_f:
            raise ValueError(
                "%s has %d faces but f has %d" % (name, n, n_f)
            )

    def ptr(arr):
        return arr.ctypes.data_as(ctypes.c_void_p) if arr is not None else None

    err = lib.obj_write(
        filename.encode(), header.encode(),
        v.shape[0], ptr(v),
        vn_arr.shape[0] if vn_arr is not None else 0, ptr(vn_arr),
        vt_arr.shape[0] if vt_arr is not None else 0, ptr(vt_arr), vt_cols,
        n_f, ptr(f_arr), ptr(ft_arr), ptr(fn_arr),
        1 if flip_faces else 0,
    )
    if err:
        raise SerializationError(err.decode())


def load_ply_native(filename):
    """Parse a PLY with the native core; same dict contract as ply.read_ply
    ('pts' (V,3) f64, 'tri' (F,3) u32, optional 'normals' / 'color')."""
    from ..errors import SerializationError

    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native meshio unavailable")
    handle = lib.ply_load(filename.encode())
    try:
        err = lib.ply_error(handle)
        if err:
            raise SerializationError(err.decode())
        counts = (ctypes.c_int64 * 4)()
        lib.ply_counts(handle, counts)
        npts, ntri, n_normals, n_color = (int(c) for c in counts)

        # buffers sized by the counts the parser reports (normals/color can
        # legitimately differ from npts in malformed files; ply_copy fills
        # exactly what was parsed)
        pts = np.empty((npts, 3), np.float64)
        tri = np.empty((ntri, 3), np.int64)
        normals = np.empty((n_normals, 3), np.float64) if n_normals else None
        color = np.empty((n_color, 3), np.float64) if n_color else None

        def ptr(arr):
            return arr.ctypes.data_as(ctypes.c_void_p) if arr is not None else None

        lib.ply_copy(handle, ptr(pts), ptr(tri), ptr(normals), ptr(color))
    finally:
        lib.ply_free(handle)

    out = {"pts": pts, "tri": tri.astype(np.uint32)}
    if normals is not None and len(normals) == npts:
        out["normals"] = normals
    if color is not None and len(color) == npts:
        out["color"] = color
    return out
