"""PLY reader/writer, pure Python + numpy (counterpart of
mesh_tpu/serialization/ply.py).

Replaces the reference's C `plyutils` extension (mesh/src/plyutils.c wrapping
the bundled RPly 1.01, mesh/src/rply.c).  The writer byte-matches rply's
output so the reference's golden-file tests port directly
(tests/test_mesh.py:67-87): header lines, `%g `-formatted ascii values with a
trailing space per value, float32 coordinates (+ float32 nx/ny/nz, uchar
rgb), and uchar-count / int32-index face lists in binary modes.

The reader is vectorized with numpy (np.frombuffer for binary bodies; a
single pass for ascii) rather than per-element C callbacks.
"""

import numpy as np

from ..errors import SerializationError

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def _c_g_format(x):
    """Format a float like C's printf("%g") (rply.c:1261-1263)."""
    return "%g" % x


def write_ply_data(filename, v, f=None, vc=None, vn=None, ascii=False,
                   little_endian=True, comments=()):
    """Write a PLY file in rply's exact layout.

    :param v: (V, 3) float vertices (stored as float32, plyutils.c:181-184)
    :param f: (F, 3) int faces or None
    :param vc: (V, 3) float colors in [0, 1] -> stored as uchar r/g/b
    :param vn: (V, 3) float normals -> stored as float32 nx/ny/nz
    """
    v = np.asarray(v, dtype=np.float64)
    f = None if f is None or np.size(f) == 0 else np.asarray(f, dtype=np.int32)
    use_color = vc is not None and np.shape(vc)[0] == v.shape[0]
    use_normals = vn is not None and np.shape(vn)[0] == v.shape[0]
    n_faces = 0 if f is None else f.shape[0]

    if ascii:
        fmt = "ascii"
    elif little_endian:
        fmt = "binary_little_endian"
    else:
        fmt = "binary_big_endian"

    header = ["ply", "format %s 1.0" % fmt]
    header += ["comment %s" % c for c in comments]
    header += [
        "element vertex %d" % v.shape[0],
        "property float x",
        "property float y",
        "property float z",
    ]
    if use_normals:
        header += ["property float nx", "property float ny", "property float nz"]
    if use_color:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
    header += [
        "element face %d" % n_faces,
        "property list uchar int vertex_indices",
        "end_header",
    ]

    v32 = v.astype(np.float32)
    if use_normals:
        n32 = np.asarray(vn, dtype=np.float64).astype(np.float32)
    if use_color:
        # serialization.py:225-229 passes (vc * 255).astype(int)
        c8 = np.asarray(vc, dtype=np.float64)
        c8 = (c8 * 255).astype(int).astype(np.uint8)

    with open(filename, "wb") as fp:
        fp.write(("\n".join(header) + "\n").encode("ascii"))
        if ascii:
            lines = []
            for i in range(v.shape[0]):
                vals = [_c_g_format(x) for x in v32[i]]
                if use_normals:
                    vals += [_c_g_format(x) for x in n32[i]]
                if use_color:
                    vals += ["%d" % x for x in c8[i]]
                lines.append(" ".join(vals) + " ")
            for i in range(n_faces):
                lines.append("3 " + " ".join("%d" % x for x in f[i]) + " ")
            fp.write(("\n".join(lines) + ("\n" if lines else "")).encode("ascii"))
        else:
            bo = "<" if little_endian else ">"
            vert_fields = [("x", bo + "f4"), ("y", bo + "f4"), ("z", bo + "f4")]
            if use_normals:
                vert_fields += [("nx", bo + "f4"), ("ny", bo + "f4"), ("nz", bo + "f4")]
            if use_color:
                vert_fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
            rec = np.zeros(v.shape[0], dtype=vert_fields)
            rec["x"], rec["y"], rec["z"] = v32[:, 0], v32[:, 1], v32[:, 2]
            if use_normals:
                rec["nx"], rec["ny"], rec["nz"] = n32[:, 0], n32[:, 1], n32[:, 2]
            if use_color:
                rec["red"], rec["green"], rec["blue"] = c8[:, 0], c8[:, 1], c8[:, 2]
            fp.write(rec.tobytes())
            if n_faces:
                frec = np.zeros(n_faces, dtype=[("n", "u1"), ("idx", bo + "i4", (3,))])
                frec["n"] = 3
                frec["idx"] = f
                fp.write(frec.tobytes())


def _parse_header(fp):
    magic = fp.readline().strip()
    if magic != b"ply":
        raise SerializationError("Failed to open PLY file: bad magic.")
    fmt = None
    elements = []  # (name, count, [(prop_name, kind)]) kind: dtype str or ('list', cdt, idt)
    while True:
        line = fp.readline()
        if not line:
            raise SerializationError("Failed to open PLY file: truncated header.")
        tokens = line.split()
        if not tokens:
            continue
        key = tokens[0]
        if key == b"format":
            fmt = tokens[1].decode()
        elif key == b"comment" or key == b"obj_info":
            continue
        elif key == b"element":
            elements.append((tokens[1].decode(), int(tokens[2]), []))
        elif key == b"property":
            if tokens[1] == b"list":
                kind = ("list", _PLY_DTYPES[tokens[2].decode()], _PLY_DTYPES[tokens[3].decode()])
                name = tokens[4].decode()
            else:
                kind = _PLY_DTYPES[tokens[1].decode()]
                name = tokens[2].decode()
            elements[-1][2].append((name, kind))
        elif key == b"end_header":
            break
    return fmt, elements


def read_ply(filename):
    """Read a PLY file -> dict with 'pts' (V,3) f64, 'tri' (F,3) u32 and
    optional 'color' (V,3 uchar-valued floats) / 'normals' (V,3).

    Shapes are row-major (the reference returns transposed column lists and
    immediately re-transposes at serialization.py:437-443 — we skip the dance).
    """
    try:
        fp = open(filename, "rb")
    except OSError:
        raise SerializationError("Failed to open PLY file.")
    with fp:
        fmt, elements = _parse_header(fp)
        body = fp.read()

    out = {}
    if fmt == "ascii":
        tokens = body.split()
        pos = 0
        for name, count, props in elements:
            has_list = any(isinstance(k, tuple) for _, k in props)
            if not has_list:
                width = len(props)
                block = np.array(tokens[pos:pos + count * width], dtype=np.float64)
                pos += count * width
                table = block.reshape(count, width) if count else np.zeros((0, width))
                _extract_vertex_props(out, name, props, table)
            else:
                rows = []
                for _ in range(count):
                    kept = None
                    for pname, kind in props:
                        if not isinstance(kind, tuple):
                            pos += 1
                            continue
                        n = int(tokens[pos]); pos += 1
                        vals = [int(t) for t in tokens[pos:pos + n]]
                        pos += n
                        if pname in ("vertex_indices", "vertex_index"):
                            kept = vals
                    if kept is not None:
                        rows.append(kept)
                _extract_face_rows(out, name, rows)
    else:
        bo = "<" if fmt == "binary_little_endian" else ">"
        offset = 0
        for name, count, props in elements:
            has_list = any(isinstance(k, tuple) for _, k in props)
            if not has_list:
                dt = np.dtype([(p, bo + k) for p, k in props])
                block = np.frombuffer(body, dtype=dt, count=count, offset=offset)
                offset += dt.itemsize * count
                table = np.stack(
                    [block[p].astype(np.float64) for p, _ in props], axis=1
                ) if count else np.zeros((0, len(props)))
                _extract_vertex_props(out, name, props, table)
            else:
                _, (_, cdt, idt) = next(
                    (p, k) for p, k in props if isinstance(k, tuple)
                )
                cnt_size = np.dtype(cdt).itemsize
                idx_size = np.dtype(idt).itemsize
                # Fast path: a lone list property whose every count is 3
                # (every reference-written file) reads as one record array.
                tri3 = None
                if len(props) == 1 and count:
                    stride = cnt_size + 3 * idx_size
                    if offset + stride * count <= len(body):
                        rec = np.frombuffer(
                            body,
                            dtype=[("n", bo + cdt), ("idx", bo + idt, (3,))],
                            count=count,
                            offset=offset,
                        )
                        if (rec["n"] == 3).all():
                            tri3 = rec["idx"]
                            offset += stride * count
                if tri3 is not None:
                    if name == "face":
                        out["tri"] = tri3.astype(np.uint32)
                else:
                    # General walk: every property of the row is consumed in
                    # declaration order; only the vertex-index list is kept.
                    rows = []
                    for _ in range(count):
                        kept = None
                        for pname, kind in props:
                            if not isinstance(kind, tuple):
                                offset += np.dtype(kind).itemsize
                                continue
                            _, p_cdt, p_idt = kind
                            n = int(np.frombuffer(
                                body, dtype=bo + p_cdt, count=1, offset=offset
                            )[0])
                            offset += np.dtype(p_cdt).itemsize
                            vals = np.frombuffer(
                                body, dtype=bo + p_idt, count=n, offset=offset
                            )
                            offset += np.dtype(p_idt).itemsize * n
                            if pname in ("vertex_indices", "vertex_index"):
                                kept = vals.tolist()
                        if kept is not None:
                            rows.append(kept)
                    _extract_face_rows(out, name, rows)
    return out


def _extract_vertex_props(out, element_name, props, table):
    names = [p for p, _ in props]
    if element_name != "vertex":
        return
    def cols(keys):
        idx = [names.index(k) for k in keys]
        return table[:, idx]
    if all(k in names for k in ("x", "y", "z")):
        out["pts"] = cols(["x", "y", "z"])
    if all(k in names for k in ("nx", "ny", "nz")):
        out["normals"] = cols(["nx", "ny", "nz"])
    if all(k in names for k in ("red", "green", "blue")):
        out["color"] = cols(["red", "green", "blue"])


def _extract_face_rows(out, element_name, rows):
    if element_name != "face":
        return
    tris = []
    for r in rows:
        # fan-triangulate polygons, as rply-based reader effectively only
        # sees triangles in reference data
        for i in range(1, len(r) - 1):
            tris.append([r[0], r[i], r[i + 1]])
    out["tri"] = (
        np.array(tris, dtype=np.uint32) if tris else np.zeros((0, 3), np.uint32)
    )
