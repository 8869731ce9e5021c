"""Mesh-facade serialization entry points (counterpart of
mesh_tpu/serialization/serialization.py).

Free functions taking the mesh as ``self``, bound as Mesh methods — the same
structural idiom as the reference (mesh/serialization/serialization.py), with
the C extensions replaced by the native core (``native.py``) where it built
and the pure-Python codecs in `ply.py` / `obj.py` otherwise.
Format dispatch mirrors load_from_file (serialization.py:410-423); landmark
file sniffing mirrors set_landmark_indices_from_any (serialization.py:372-407).
"""

import json
import os
import pickle
import re

import numpy as np

from ..errors import SerializationError
from . import native
from .obj import load_obj, write_obj_data
from .ply import read_ply, write_ply_data

__all__ = [
    "load_from_obj", "load_from_obj_cpp", "write_obj", "write_mtl",
    "write_json", "write_three_json",
    "set_landmark_indices_from_ppfile", "set_landmark_indices_from_lmrkfile",
    "load_from_ply", "load_from_file", "load_from_json", "write_ply",
    "set_landmark_indices_from_any",
]


def _load_obj_dict(filename, use_native=True):
    """Parse with the native C++ core when available (the reference's
    use_cpp=True default, serialization.py:414-418), else pure Python."""
    if use_native:
        if native.available():
            return native.load_obj_native(filename)
    return load_obj(filename)


def load_from_obj(self, filename, use_native=False):
    data = _load_obj_dict(filename, use_native=use_native)
    self.v = data["v"]
    self.f = data["f"]
    for key in ("vc", "vt", "vn", "ft", "fn"):
        if key in data:
            setattr(self, key, data[key])
    self.segm = data.get("segm", {})
    if "mtl_path" in data:
        self.materials_filepath = os.path.join(
            os.path.dirname(filename), data["mtl_path"].strip()
        )
        if os.path.exists(self.materials_filepath):
            with open(self.materials_filepath) as fp:
                self.materials_file = fp.readlines()
    if hasattr(self, "materials_file"):
        for line in self.materials_file:
            if line and line.split() and line.split()[0] == "map_Ka":
                self.texture_filepath = os.path.abspath(
                    os.path.join(os.path.dirname(filename), line.split()[1])
                )
    if "landm" in data:
        # the parser resolves `#landmark` to vertex indices (as the reference
        # C++ loader does, py_loadobj.cpp:97-99); recover raw xyz from them
        self.landm = data["landm"]
        self.recompute_landmark_xyz()


def load_from_obj_cpp(self, filename):
    """The fast native path (reference load_from_obj_cpp,
    serialization.py:97-131), with silent fallback to the Python parser."""
    return load_from_obj(self, filename, use_native=True)


def load_from_ply(self, filename):
    """PLY load, dispatched by format: ascii bodies go through the native C++
    reader when built (~9x the Python tokenizer — the reference's read path
    is C for the same reason, plyutils.c:64-137); binary bodies use the
    vectorized numpy reader, which beats per-value native parsing."""
    try:
        use_native = False
        if native.available():
            try:
                with open(filename, "rb") as fp:
                    use_native = b"format ascii" in fp.read(256)
            except OSError:
                raise SerializationError("Failed to open PLY file.")
        res = native.load_ply_native(filename) if use_native else read_ply(filename)
    except SerializationError:
        raise
    except Exception as e:
        raise SerializationError(str(e))
    self.v = res["pts"].copy()
    self.f = res["tri"].copy()
    if "color" in res:
        self.set_vertex_colors(res["color"].copy() / 255)
    if "normals" in res:
        self.vn = res["normals"].copy()


def load_from_file(self, filename, use_cpp=True):
    if re.search(r"\.ply$", filename):
        self.load_from_ply(filename)
    elif re.search(r"\.obj$", filename):
        load_from_obj(self, filename, use_native=use_cpp)
    elif re.search(r"\.json$", filename):
        load_from_json(self, filename)
    else:
        raise NotImplementedError("Unknown mesh file format.")


def load_from_json(self, filename):
    """Read the plain-JSON dump produced by write_json.  The reference
    treats JSON as write-only (serialization.py:282-326 has no loader);
    round-tripping it makes the format actually usable for interchange.
    """
    try:
        with open(filename, "r") as fp:
            data = json.load(fp)
    except (OSError, ValueError) as exc:
        raise SerializationError("Failed to load JSON mesh %s: %s"
                                 % (filename, exc))
    if not isinstance(data, dict) or "vertices" not in data:
        raise SerializationError(
            "JSON mesh %s has no 'vertices' key" % filename
        )
    verts = data["vertices"]
    if not isinstance(verts, list):
        raise SerializationError(
            "JSON mesh %s: 'vertices' must be a list of xyz rows" % filename
        )
    if "metadata" in data or (verts and not isinstance(verts[0], list)):
        # three.js models (write_three_json) store flat float/int streams;
        # reshaping those would build garbage geometry
        raise SerializationError(
            "%s looks like a three.js model; only plain write_json output "
            "can be loaded" % filename
        )

    def rows_of_3(value, dtype, what):
        arr = np.asarray(value, dtype)
        if arr.size == 0:
            return arr.reshape(0, 3)
        if arr.ndim != 2 or arr.shape[1] != 3:
            raise SerializationError(
                "Malformed JSON mesh %s: %s rows must have 3 entries, got "
                "shape %s" % (filename, what, arr.shape)
            )
        return arr

    try:
        self.v = rows_of_3(verts, np.float64, "vertex")
        if data.get("faces") is not None:
            faces = rows_of_3(data["faces"], np.int64, "face")
            if faces.size and (faces.min() < 0 or faces.max() >= len(self.v)):
                raise SerializationError(
                    "Malformed JSON mesh %s: face indices out of range"
                    % filename
                )
            self.f = faces.astype(np.uint32)
    except (TypeError, ValueError) as exc:
        raise SerializationError("Malformed JSON mesh %s: %s"
                                 % (filename, exc))
    if data.get("name"):
        self.basename = data["name"]


def write_ply(self, filename, flip_faces=False, ascii=False,
              little_endian=True, comments=[]):
    dirname = os.path.dirname(filename)
    if dirname and not os.path.exists(dirname):
        os.makedirs(dirname)
    ff = -1 if flip_faces else 1
    if isinstance(comments, str):
        comments = [comments]
    comments = [c for c in sum((c.split("\n") for c in comments), []) if len(c)]
    faces = np.asarray(self.f) if hasattr(self, "f") else None
    if faces is not None and faces.size:
        faces = faces.reshape(-1, 3)[:, ::ff]
    from . import native

    # native writer is byte-identical to the Python one; prefer it when the
    # toolchain built it (the reference's lazy compiled-extension seam,
    # serialization.py:213-229 -> plyutils.write)
    writer = native.write_ply_native if native.available() else write_ply_data
    writer(
        filename,
        np.asarray(self.v, dtype=np.float64),
        faces,
        vc=np.asarray(self.vc) if hasattr(self, "vc") else None,
        vn=np.asarray(self.vn) if hasattr(self, "vn") else None,
        ascii=ascii,
        little_endian=little_endian,
        comments=comments,
    )


def write_obj(self, filename, flip_faces=False, group=False, comments=None):
    mtl_name = None
    if hasattr(self, "texture_filepath"):
        outfolder = os.path.dirname(filename)
        outbase = os.path.splitext(os.path.basename(filename))[0]
        mtl_name = outbase + ".mtl"
        from shutil import copyfile

        texture_name = outbase + os.path.splitext(self.texture_filepath)[1]
        dst = os.path.join(outfolder, texture_name)
        if os.path.abspath(self.texture_filepath) != os.path.abspath(dst):
            copyfile(self.texture_filepath, dst)
        write_mtl(self, os.path.join(outfolder, mtl_name), outbase, texture_name)

    has_ft = hasattr(self, "ft")
    if has_ft and not hasattr(self, "fn"):
        self.reset_face_normals()
    write_obj_data(
        filename,
        np.asarray(self.v),
        f=np.asarray(self.f) if hasattr(self, "f") else None,
        vn=np.asarray(self.vn) if hasattr(self, "vn") else None,
        vt=np.asarray(self.vt) if hasattr(self, "vt") else None,
        ft=np.asarray(self.ft) if has_ft else None,
        fn=np.asarray(self.fn) if hasattr(self, "fn") else None,
        segm=getattr(self, "segm", None),
        flip_faces=flip_faces,
        group=group,
        comments=comments,
        mtl_name=mtl_name,
    )


def write_mtl(self, path, material_name, texture_name):
    """Material attribute file (reference serialization.py:199-210)."""
    with open(path, "w") as f:
        f.write("newmtl %s\n" % material_name)
        f.write("ka 0.329412 0.223529 0.027451\n")
        f.write("kd 0.780392 0.568627 0.113725\n")
        f.write("ks 0.992157 0.941176 0.807843\n")
        f.write("illum 0\n")
        f.write("map_Ka %s\n" % texture_name)
        f.write("map_Kd %s\n" % texture_name)
        f.write("map_Ks %s\n" % texture_name)


def write_three_json(self, filename, name=""):
    """three.js JSON model v3.1 (reference serialization.py:232-280)."""
    dirname = os.path.dirname(filename)
    if dirname and not os.path.exists(dirname):
        os.makedirs(dirname)
    name = name if name else getattr(self, "basename", "")
    name = name if name else os.path.splitext(os.path.basename(filename))[0]
    metadata = {
        "formatVersion": 3.1,
        "sourceFile": "%s.obj" % name,
        "generatedBy": "mesh_tpu",
        "vertices": len(self.v),
        "faces": len(self.f),
        "normals": len(self.vn),
        "colors": 0,
        "uvs": len(self.vt),
        "materials": 1,
    }
    materials = [{
        "DbgColor": 15658734,
        "DbgIndex": 0,
        "DbgName": "defaultMat",
        "colorAmbient": [0.0, 0.0, 0.0],
        "colorDiffuse": [0.64, 0.64, 0.64],
        "colorSpecular": [0.5, 0.5, 0.5],
        "illumination": 2,
        "opticalDensity": 1.0,
        "specularCoef": 96.078431,
        "transparency": 1.0,
    }]
    f_arr = np.asarray(self.f)
    ft_arr = np.asarray(self.ft)
    fn_arr = np.asarray(self.fn)
    faces = np.concatenate(
        [
            np.full((len(f_arr), 1), 42, dtype=np.int64),
            f_arr,
            np.zeros((len(f_arr), 1), dtype=np.int64),
            ft_arr,
            fn_arr,
        ],
        axis=1,
    )
    mesh_data = {
        "metadata": metadata,
        "scale": 0.35,
        "materials": materials,
        "morphTargets": [],
        "morphColors": [],
        "colors": [],
        "vertices": np.asarray(self.v).flatten().tolist(),
        "normals": np.asarray(self.vn).flatten().tolist(),
        "uvs": [np.asarray([[t[0], t[1]] for t in self.vt]).flatten().tolist()],
        "faces": faces.flatten().tolist(),
    }
    with open(filename, "w") as fp:
        fp.write(json.dumps(mesh_data, indent=4))


def write_json(self, filename, header="", footer="", name="",
               include_faces=True, texture_mode=False):
    """Plain JSON dump (reference serialization.py:282-326; its texture_mode
    branch is broken upstream — `.append()` with no argument — so only the
    working vertices/faces mode is provided)."""
    dirname = os.path.dirname(filename)
    if dirname and not os.path.exists(dirname):
        os.makedirs(dirname)
    name = name if name else getattr(self, "basename", "")
    name = name if name else os.path.splitext(os.path.basename(filename))[0]
    mesh_data = {
        "name": name,
        "vertices": [list(map(float, x)) for x in np.asarray(self.v)],
    }
    if include_faces:
        mesh_data["faces"] = [[int(i) for i in x] for x in np.asarray(self.f)]
    with open(filename, "w") as fp:
        if os.path.basename(filename).endswith("js"):
            fp.write(header + "\nmesh = " if header else "var mesh = ")
            fp.write(json.dumps(mesh_data, indent=4))
            fp.write(footer)
        else:
            fp.write(json.dumps(mesh_data, indent=4))


def set_landmark_indices_from_ppfile(self, ppfilename):
    """MeshLab picked-points XML (reference serialization.py:329-340)."""
    from xml.etree import ElementTree

    tree = ElementTree.parse(ppfilename)

    def get_xyz(e):
        try:
            return [float(e.attrib["x"]), float(e.attrib["y"]), float(e.attrib["z"])]
        except Exception:
            return [0, 0, 0]

    self.landm_raw_xyz = dict(
        (e.attrib["name"], get_xyz(e)) for e in tree.iter() if e.tag == "point"
    )
    self.recompute_landmark_indices(ppfilename)


def set_landmark_indices_from_lmrkfile(self, lmrkfilename):
    """CAESAR .lmrk landmark file (reference serialization.py:343-361)."""
    with open(lmrkfilename, "r") as lmrkfile:
        self.landm_raw_xyz = {}
        for line in lmrkfile.readlines():
            if not line.strip():
                continue
            command = line.split()[0]
            data = [float(x) for x in line.split()[1:]]
            if command == "_scale":
                self.caesar_scale_factor = np.array(data)
            elif command == "_translate":
                self.caesar_translation_vector = np.array(data)
            elif command == "_rotation":
                self.caesar_rotation_matrix = np.array(data).reshape(3, 3)
            else:
                self.landm_raw_xyz[command] = [data[1], data[2], data[0]]
        self.recompute_landmark_indices(lmrkfilename)


def _is_lmrkfile(filename):
    pattern = re.compile(
        r"^_scale\s[-\d\.]+\s+_translate(\s[-\d\.]+){3}\s+_rotation(\s[-\d\.]+){9}\s+"
    )
    with open(filename) as f:
        return pattern.match(f.read())


def set_landmark_indices_from_any(self, landmarks):
    """Landmark source sniffing: pp/lmrk/yaml/json/pkl files or raw dicts
    (reference serialization.py:372-407)."""
    try:
        path_exists = os.path.exists(landmarks)
    except Exception:
        path_exists = False
    if path_exists:
        if re.search(r"\.ya{0,1}ml$", landmarks):
            import yaml

            with open(landmarks) as f:
                self.set_landmarks_from_raw(yaml.load(f, Loader=yaml.FullLoader))
        elif re.search(r"\.json$", landmarks):
            with open(landmarks) as f:
                self.set_landmarks_from_raw(json.load(f))
        elif re.search(r"\.pkl$", landmarks):
            with open(landmarks, "rb") as f:
                self.set_landmarks_from_raw(pickle.load(f))
        elif _is_lmrkfile(landmarks):
            set_landmark_indices_from_lmrkfile(self, landmarks)
        else:
            try:
                set_landmark_indices_from_ppfile(self, landmarks)
            except Exception:
                raise SerializationError(
                    "Landmark file %s is of unknown format" % landmarks
                )
    else:
        self.set_landmarks_from_raw(landmarks)
