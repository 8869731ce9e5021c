"""Wavefront OBJ reader/writer, pure Python + numpy (counterpart of
mesh_tpu/serialization/obj.py).

Replaces both reference OBJ paths — the pure-Python parser
(mesh/serialization/serialization.py:28-94) and the C++ fast loader
(mesh/src/py_loadobj.cpp:63-244) — with one numpy-vectorized parser that
supports the same surface: v (with optional rgb), vt, vn, all four face forms
(v, v/vt, v/vt/vn, v//vn) with fan triangulation of polygons, `g` segments,
`#landmark <name>` (attaches to the next vertex), and `mtllib` passthrough.
"""

import os

import numpy as np

from ..errors import SerializationError


def load_obj(filename):
    """Parse an OBJ file.

    :returns: dict with keys ``v`` (V,3) f64, ``f`` (F,3) i64 (0-based), and
        optionally ``vc``, ``vt``, ``vn``, ``ft``, ``fn`` (0-based), ``segm``
        (name -> list of face indices), ``landm`` (name -> vertex index),
        ``mtl_path`` (str).
    """
    v, vt, vn, vc = [], [], [], []
    f, ft, fn = [], [], []
    segm = {}
    landm = {}
    mtl_path = None
    curr_segm = ""
    curr_landm = ""
    try:
        fp = open(filename, "r", buffering=2 ** 16)
    except OSError:
        raise SerializationError("Could not open OBJ file %s" % filename)
    with fp:
        for line in fp:
            parts = line.split()
            if not parts:
                continue
            key = parts[0]
            if key == "v":
                v.append([float(x) for x in parts[1:4]])
                if len(parts) == 7:
                    vc.append([float(x) for x in parts[4:7]])
                if curr_landm:
                    landm[curr_landm] = len(v) - 1
                    curr_landm = ""
            elif key == "vt":
                vt.append([float(x) for x in parts[1:]])
            elif key == "vn":
                vn.append([float(x) for x in parts[1:4]])
            elif key == "f":
                corners = [x.split("/") for x in parts[1:]]
                for i in range(1, len(corners) - 1):
                    tri = (corners[0], corners[i], corners[i + 1])
                    f.append([int(c[0]) for c in tri])
                    if len(corners[0]) > 1 and corners[0][1]:
                        ft.append([int(c[1]) for c in tri])
                    if len(corners[0]) > 2 and corners[0][2]:
                        fn.append([int(c[2]) for c in tri])
                    if curr_segm:
                        segm[curr_segm].append(len(f) - 1)
            elif key == "g":
                curr_segm = parts[1]
                segm.setdefault(curr_segm, [])
            elif key == "#landmark":
                curr_landm = parts[1]
            elif key == "mtllib":
                mtl_path = parts[1]

    out = {
        "v": np.array(v, dtype=np.float64).reshape(-1, 3),
        "f": np.array(f, dtype=np.int64).reshape(-1, 3) - 1,
    }
    if vc:
        out["vc"] = np.array(vc, dtype=np.float64)
    if vt:
        out["vt"] = np.array(vt, dtype=np.float64)
    if vn:
        out["vn"] = np.array(vn, dtype=np.float64)
    if ft:
        out["ft"] = np.array(ft, dtype=np.int64) - 1
    if fn:
        out["fn"] = np.array(fn, dtype=np.int64) - 1
    if segm:
        out["segm"] = segm
    if landm:
        out["landm"] = landm
    if mtl_path:
        out["mtl_path"] = mtl_path
    return out


def write_obj_data(filename, v, f=None, vn=None, vt=None, ft=None, fn=None,
                   segm=None, flip_faces=False, group=False, comments=None,
                   mtl_name=None):
    """Write an OBJ file in the reference's exact text layout
    (serialization.py:134-196): `%f`-formatted floats, `f a/b/c`-style faces
    with the reference's spacing quirks preserved so outputs are
    byte-comparable.
    """
    dirname = os.path.dirname(filename)
    if dirname and not os.path.exists(dirname):
        os.makedirs(dirname)

    # shared header block (comments + mtllib) — single source for both
    # the native fast path and the Python fallback so their bytes can
    # never diverge
    header = []
    if comments is not None:
        for comment in [comments] if isinstance(comments, str) else comments:
            for line in comment.split("\n"):
                header.append("# %s\n" % line)
    if mtl_name is not None:
        header.append("mtllib %s\n" % mtl_name)
    header = "".join(header)

    # the native writer covers every layout except per-segment face groups
    # (`segm and not group`); byte-identity with the Python path below is
    # pinned by tests/test_torch_serialization.py
    if not (segm and not group):
        from . import native

        if native.available():
            native.write_obj_native(
                filename, v, f=f,
                vn=vn if (fn is not None and vn is not None) else None,
                vt=vt if (ft is not None and vt is not None) else None,
                ft=ft, fn=fn, flip_faces=flip_faces, header=header,
            )
            return

    ff = -1 if flip_faces else 1

    def face_line(i):
        vi = np.asarray(f[i])[::ff] + 1
        if ft is not None:
            ti = np.asarray(ft[i])[::ff] + 1
            ni = np.asarray(fn[i])[::ff] + 1
            return "f %d/%d/%d %d/%d/%d  %d/%d/%d\n" % tuple(
                np.array([vi, ti, ni]).T.flatten()
            )
        if fn is not None:
            ni = np.asarray(fn[i])[::ff] + 1
            return "f %d//%d %d//%d  %d//%d\n" % tuple(
                np.array([vi, ni]).T.flatten()
            )
        return "f %d %d %d\n" % tuple(vi)

    with open(filename, "w") as fp:
        fp.write(header)
        for r in np.asarray(v):
            fp.write("v %f %f %f\n" % (r[0], r[1], r[2]))
        if fn is not None and vn is not None:
            for r in np.asarray(vn):
                fp.write("vn %f %f %f\n" % (r[0], r[1], r[2]))
        if ft is not None and vt is not None:
            for r in np.asarray(vt):
                if len(r) == 3:
                    fp.write("vt %f %f %f\n" % (r[0], r[1], r[2]))
                else:
                    fp.write("vt %f %f\n" % (r[0], r[1]))
        if segm and not group:
            for part, faces in segm.items():
                fp.write("g %s\n" % part)
                for i in faces:
                    fp.write(face_line(i))
        elif f is not None:
            for i in range(len(f)):
                fp.write(face_line(i))
