"""mesh_tpu_torch's serialization against mesh_tpu, on the CPU: the bytes
every writer produces (PLY ascii and both byte orders, OBJ in every face
form, MTL, JSON and three.js JSON; the port's native and Python writers
both), every reader on the other package's files (the port's native reader
and its Python reader), the landmark-file readers (pp, lmrk, JSON, YAML,
pickle) and each reader's ``SerializationError`` cases, message for
message.

Contract: bit for bit, bytes for writers and arrays for readers.  Inputs
are made from numpy RandomState seeds.
"""

import json
import os
import pickle

import numpy as np
import pytest

import mesh_tpu
from mesh_tpu.errors import SerializationError as JError
from mesh_tpu.serialization import native as jnative
from mesh_tpu.serialization import obj as jobj
from mesh_tpu.serialization import ply as jply

import mesh_tpu_torch
from mesh_tpu_torch.errors import SerializationError as TError
from mesh_tpu_torch.serialization import native as tnative
from mesh_tpu_torch.serialization import obj as tobj
from mesh_tpu_torch.serialization import ply as tply

from .test_torch_facade_rest import assert_landmarks_match
from .test_torch_topology import assert_meshes_equal, icosphere, mesh_pair


def _mesh_pair(seed=0, normals=False, colors=False, texture=False,
               segm=False):
    v, f = icosphere(2, seed)
    rng = np.random.RandomState(seed)
    attrs = {}
    if normals:
        attrs["vn"] = rng.randn(*v.shape)
        attrs["fn"] = f.copy()
    if colors:
        attrs["vc"] = rng.rand(*v.shape)
    if texture:
        attrs["vt"] = rng.rand(len(v), 2)
        attrs["ft"] = f.copy()
    jm, tm = mesh_pair(v, f, **attrs)
    if segm:
        jm.segm = tm.segm = {"a": list(range(0, 200)),
                             "b": list(range(200, 320))}
    return jm, tm


def _bytes(path):
    with open(path, "rb") as fp:
        return fp.read()


@pytest.fixture(params=["native", "python"])
def port_native(request, monkeypatch):
    """Run the port with its native core, then with it unavailable."""
    if request.param == "native":
        assert tnative.available()
    else:
        monkeypatch.setattr(tnative, "_get_lib", lambda: None)
    return request.param


# -- writers ---------------------------------------------------------------

PLY_MODES = {"ascii": {"ascii": True}, "le": {}, "be": {"little_endian": False}}


@pytest.mark.parametrize("mode", sorted(PLY_MODES))
@pytest.mark.parametrize("extra", ["plain", "normals", "colors", "both"])
def test_ply_bytes_match(tmp_path, port_native, mode, extra):
    jm, tm = _mesh_pair(1, normals=extra in ("normals", "both"),
                        colors=extra in ("colors", "both"))
    for kw in ({}, {"flip_faces": True, "comments": ["one", "two\nthree"]},
               {"comments": "single"}):
        kw = dict(PLY_MODES[mode], **kw)
        jm.write_ply(str(tmp_path / "j.ply"), **kw)
        tm.write_ply(str(tmp_path / "t.ply"), **kw)
        assert _bytes(tmp_path / "t.ply") == _bytes(tmp_path / "j.ply")


def test_ply_writers_agree_directly(tmp_path):
    rng = np.random.RandomState(2)
    v, f = rng.randn(30, 3) * 1e3, rng.randint(0, 30, (40, 3))
    vc, vn = rng.rand(30, 3), rng.randn(30, 3)
    for kw in ({"ascii": True}, {"little_endian": True},
               {"little_endian": False}, {"comments": ["", "x"]}):
        jply.write_ply_data(str(tmp_path / "j.ply"), v, f, vc=vc, vn=vn, **kw)
        tply.write_ply_data(str(tmp_path / "p.ply"), v, f, vc=vc, vn=vn, **kw)
        tnative.write_ply_native(str(tmp_path / "n.ply"), v, f, vc=vc, vn=vn,
                                 **kw)
        want = _bytes(tmp_path / "j.ply")
        assert _bytes(tmp_path / "p.ply") == want
        assert _bytes(tmp_path / "n.ply") == want
    tply.write_ply_data(str(tmp_path / "p.ply"), v)
    jply.write_ply_data(str(tmp_path / "j.ply"), v)
    assert _bytes(tmp_path / "p.ply") == _bytes(tmp_path / "j.ply")


OBJ_FORMS = {
    "plain": {},
    "normals": {"normals": True},
    "texture": {"normals": True, "texture": True},
    "segm": {"segm": True},
    "segm_texture": {"segm": True, "normals": True, "texture": True},
}


@pytest.mark.parametrize("form", sorted(OBJ_FORMS))
def test_obj_bytes_match(tmp_path, port_native, form):
    jm, tm = _mesh_pair(3, **OBJ_FORMS[form])
    for kw in ({}, {"flip_faces": True}, {"group": True},
               {"comments": ["made here", "two\nlines"]}, {"comments": "c"}):
        jm.write_obj(str(tmp_path / "j.obj"), **kw)
        tm.write_obj(str(tmp_path / "t.obj"), **kw)
        assert _bytes(tmp_path / "t.obj") == _bytes(tmp_path / "j.obj"), kw


def test_obj_texture_mtl_and_image_copy(tmp_path):
    jm, tm = _mesh_pair(4, normals=True, texture=True)
    image = tmp_path / "img.png"
    image.write_bytes(b"\x89PNG fake")
    for m, sub in ((jm, "j"), (tm, "t")):
        (tmp_path / sub).mkdir()
        m.texture_filepath = str(image)
        m.write_obj(str(tmp_path / sub / "out.obj"))
    for name in ("out.obj", "out.mtl", "out.png"):
        assert _bytes(tmp_path / "t" / name) == _bytes(tmp_path / "j" / name)
    jm.write_mtl(str(tmp_path / "j.mtl"), "mat", "tex.png")
    tm.write_mtl(str(tmp_path / "t.mtl"), "mat", "tex.png")
    assert _bytes(tmp_path / "t.mtl") == _bytes(tmp_path / "j.mtl")


def test_obj_writers_agree_directly(tmp_path):
    rng = np.random.RandomState(5)
    v, f = rng.randn(20, 3), rng.randint(0, 20, (25, 3))
    vt, vn = rng.rand(20, 3), rng.randn(20, 3)
    cases = ({}, {"fn": f}, {"vn": vn, "fn": f},
             {"vn": vn, "vt": vt, "ft": f, "fn": f, "flip_faces": True})
    for kw in cases:
        jobj.write_obj_data(str(tmp_path / "j.obj"), v, f=f, **kw)
        tnative.write_obj_native(str(tmp_path / "n.obj"), v, f=f, **kw)
        assert _bytes(tmp_path / "n.obj") == _bytes(tmp_path / "j.obj")
    with pytest.raises(ValueError, match="ft requires fn"):
        tnative.write_obj_native(str(tmp_path / "x.obj"), v, f=f, ft=f)
    with pytest.raises(ValueError, match="must be"):
        tnative.write_obj_native(str(tmp_path / "x.obj"), v[:, :2], f=f)


@pytest.mark.parametrize("name", ["mesh.json", "mesh.js"])
def test_json_bytes_match(tmp_path, name):
    jm, tm = _mesh_pair(6, normals=True, texture=True)
    # one file name in two folders: the name defaults to the file's
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    for kw in ({}, {"name": "body", "include_faces": False},
               {"header": "// h", "footer": "\n// f"}):
        jm.write_json(str(tmp_path / "j" / name), **kw)
        tm.write_json(str(tmp_path / "t" / name), **kw)
        assert _bytes(tmp_path / "t" / name) == _bytes(tmp_path / "j" / name)
    for three in ({"name": "three"}, {}):
        jm.write_three_json(str(tmp_path / "j" / "3.json"), **three)
        tm.write_three_json(str(tmp_path / "t" / "3.json"), **three)
        assert _bytes(tmp_path / "t" / "3.json") == \
            _bytes(tmp_path / "j" / "3.json")


# -- readers on the other package's files ---------------------------------

def _assert_dicts_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("mode", sorted(PLY_MODES))
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_ply_readers_match(tmp_path, mode, writer):
    jm, tm = _mesh_pair(7, normals=True, colors=True)
    path = str(tmp_path / "m.ply")
    (jm if writer == "reference" else tm).write_ply(path, **PLY_MODES[mode])
    want = jply.read_ply(path)
    _assert_dicts_equal(tply.read_ply(path), want)
    _assert_dicts_equal(tnative.load_ply_native(path),
                        jnative.load_ply_native(path))
    got_native = tnative.load_ply_native(path)
    for k in want:
        np.testing.assert_array_equal(got_native[k], want[k])
    assert_meshes_equal(mesh_tpu.Mesh(filename=path),
                        mesh_tpu_torch.Mesh(filename=path, device="cpu"))


@pytest.mark.parametrize("form", sorted(OBJ_FORMS))
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_obj_readers_match(tmp_path, form, writer):
    jm, tm = _mesh_pair(8, **OBJ_FORMS[form])
    path = str(tmp_path / "m.obj")
    (jm if writer == "reference" else tm).write_obj(
        path, comments=["x"], group=form == "segm")
    with open(path, "a") as fp:       # a landmark and a polygon, too
        fp.write("#landmark nose\nv 0.1 0.2 0.3\nf 1 2 3 4 5\n")
    want = jobj.load_obj(path)
    _assert_dicts_equal(tobj.load_obj(path), want)
    _assert_dicts_equal(tnative.load_obj_native(path),
                        jnative.load_obj_native(path))
    for use_cpp in (True, False):
        ja = mesh_tpu.Mesh()
        ta = mesh_tpu_torch.Mesh(device="cpu")
        ja.load_from_obj(path, use_native=use_cpp)
        ta.load_from_obj(path, use_native=use_cpp)
        assert_meshes_equal(ja, ta)
        assert ta.segm == ja.segm and ta.landm == ja.landm
    ja, ta = mesh_tpu.Mesh(), mesh_tpu_torch.Mesh(device="cpu")
    ja.load_from_obj_cpp(path)
    ta.load_from_obj_cpp(path)
    assert_meshes_equal(ja, ta)


def test_obj_mtl_texture_path_read(tmp_path):
    jm, tm = _mesh_pair(9, normals=True, texture=True)
    image = tmp_path / "skin.png"
    image.write_bytes(b"fake")
    tm.texture_filepath = str(image)
    tm.write_obj(str(tmp_path / "m.obj"))
    ja = mesh_tpu.Mesh(filename=str(tmp_path / "m.obj"))
    ta = mesh_tpu_torch.Mesh(filename=str(tmp_path / "m.obj"), device="cpu")
    assert ta.materials_file == ja.materials_file
    assert ta.texture_filepath == ja.texture_filepath
    assert ta.materials_filepath == ja.materials_filepath
    assert_meshes_equal(ja, ta)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_json_reader_matches(tmp_path, writer):
    jm, tm = _mesh_pair(10)
    path = str(tmp_path / "m.json")
    (jm if writer == "reference" else tm).write_json(path, name="body")
    ja = mesh_tpu.Mesh(filename=path)
    ta = mesh_tpu_torch.Mesh(filename=path, device="cpu")
    assert_meshes_equal(ja, ta)
    assert ta.basename == ja.basename == "body"


# -- SerializationError cases --------------------------------------------

def _write(path, data):
    with open(path, "wb" if isinstance(data, bytes) else "w") as fp:
        fp.write(data)
    return str(path)


ERROR_FILES = {
    "missing.ply": None,
    "missing.obj": None,
    "bad_magic.ply": b"plx\nformat ascii 1.0\nend_header\n",
    "truncated.ply": b"ply\nformat ascii 1.0\nelement vertex 3\n",
    "short_body.ply": (b"ply\nformat binary_little_endian 1.0\nelement "
                       b"vertex 3\nproperty float x\nproperty float y\n"
                       b"property float z\nend_header\n\x00\x00"),
    "bad.json": "{not json",
    "empty.json": "{}",
    "scalar.json": "42",
    "ragged.json": '{"vertices": [[0, 0], [1, 1, 1]]}',
    "wide.json": '{"vertices": [[0, 0, 0, 0], [1, 1, 1, 1], [2, 2, 2, 2]]}',
    "nonlist.json": '{"vertices": 5}',
    "badface.json": ('{"vertices": [[0,0,0],[1,0,0],[0,1,0]], '
                     '"faces": [[0,1,7]]}'),
    "three.json": '{"metadata": {}, "vertices": [0.0, 1.0, 2.0]}',
}


def _raised(make, path):
    try:
        make(path)
    except Exception as e:                 # noqa: BLE001 - compared below
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("name", sorted(ERROR_FILES))
def test_reader_errors_match(tmp_path, port_native, name):
    path = str(tmp_path / name)
    if ERROR_FILES[name] is not None:
        _write(path, ERROR_FILES[name])
    if port_native == "python":
        # the reference with its native core off too, for the same route
        jnative_lib = jnative._get_lib
        jnative._get_lib = lambda: None
    try:
        want = _raised(lambda p: mesh_tpu.Mesh(filename=p), path)
    finally:
        if port_native == "python":
            jnative._get_lib = jnative_lib
    got = _raised(lambda p: mesh_tpu_torch.Mesh(filename=p, device="cpu"),
                  path)
    assert want is not None and want[0] == "SerializationError", want
    assert got == want
    assert issubclass(TError, mesh_tpu_torch.errors.MeshError)


def test_native_and_direct_reader_errors_match(tmp_path):
    bad = _write(tmp_path / "bad.ply", ERROR_FILES["bad_magic.ply"])
    for fn, paths in (("load_ply_native", (bad, str(tmp_path / "no.ply"))),
                      ("load_obj_native", (str(tmp_path / "no.obj"),))):
        for path in paths:
            want = _raised(getattr(jnative, fn), path)
            got = _raised(getattr(tnative, fn), path)
            assert got == want and got[0] == "SerializationError"
    for mod_j, mod_t, fn in ((jply, tply, "read_ply"),
                             (jobj, tobj, "load_obj")):
        for path in (bad, str(tmp_path / "none")):
            assert _raised(getattr(mod_t, fn), path) == \
                _raised(getattr(mod_j, fn), path)
    v = np.zeros((3, 3))
    target = str(tmp_path / "no" / "such" / "dir" / "x.ply")
    assert _raised(lambda p: tnative.write_ply_native(p, v), target) == \
        _raised(lambda p: jnative.write_ply_native(p, v), target)
    m = mesh_tpu_torch.Mesh(*icosphere(1), device="cpu")
    with pytest.raises(NotImplementedError, match="Unknown mesh file"):
        m.load_from_file(str(tmp_path / "x.stl"))


def test_native_library_builds_in_the_build_folder():
    assert tnative.available()
    path = tnative.library_path()
    assert os.path.isfile(path)
    assert os.path.dirname(path) == tnative.BUILD_DIR
    assert tnative.BUILD_DIR.endswith(os.path.join("build", "mesh_tpu_torch"))


# -- landmark files ------------------------------------------------------

def _landmark_sources(tmp_path, v):
    rng = np.random.RandomState(11)
    picks = rng.choice(len(v), 5, replace=False)
    xyz = v[picks] + rng.randn(5, 3) * 0.01
    named = {"lm%d" % i: p.tolist() for i, p in enumerate(xyz)}
    out = {}
    out["json"] = _write(tmp_path / "l.json", json.dumps(named))
    out["json_indices"] = _write(tmp_path / "i.json",
                                 json.dumps({"a": 3, "b": 7}))
    with open(tmp_path / "l.pkl", "wb") as fp:
        pickle.dump(named, fp)
    out["pkl"] = str(tmp_path / "l.pkl")
    out["yaml"] = _write(tmp_path / "l.yaml", "".join(
        "%s: [%r, %r, %r]\n" % ((k,) + tuple(p)) for k, p in named.items()))
    out["pp"] = _write(tmp_path / "l.pp", "<!DOCTYPE PickedPoints>\n"
                       "<PickedPoints>\n" + "".join(
                           '<point x="%r" y="%r" z="%r" name="%s"/>\n'
                           % (p[0], p[1], p[2], k)
                           for k, p in named.items())
                       + '<point name="unset"/>\n</PickedPoints>\n')
    out["lmrk"] = _write(tmp_path / "l.lmrk", (
        "_scale 1.0\n_translate 0.0 0.0 0.0\n"
        "_rotation 1 0 0 0 1 0 0 0 1\n\n" + "".join(
            "%s %r %r %r\n" % (k, p[2], p[0], p[1])
            for k, p in named.items()) + "Zero 0.0 0.0 0.0\n"))
    out["lmrk_renamed"] = _write(tmp_path / "l.dat",
                                 open(out["lmrk"]).read())
    out["dict"] = named
    return out


def test_landmark_readers_match(tmp_path):
    v, f = icosphere(2, 12)
    sources = _landmark_sources(tmp_path, v)
    for kind, source in sources.items():
        jm, tm = mesh_pair(v, f)
        jm.set_landmark_indices_from_any(source)
        tm.set_landmark_indices_from_any(source)
        assert_landmarks_match(jm, tm)
        for attr in ("caesar_scale_factor", "caesar_translation_vector",
                     "caesar_rotation_matrix"):
            assert hasattr(jm, attr) == hasattr(tm, attr)
            if hasattr(jm, attr):
                np.testing.assert_array_equal(getattr(tm, attr),
                                              getattr(jm, attr))
    jm = mesh_tpu.Mesh(v=v, f=f, ppfilename=sources["pp"])
    tm = mesh_tpu_torch.Mesh(v=v, f=f, ppfilename=sources["pp"],
                             device="cpu")
    assert_landmarks_match(jm, tm)
    jm = mesh_tpu.Mesh(v=v, f=f, lmrkfilename=sources["lmrk"])
    tm = mesh_tpu_torch.Mesh(v=v, f=f, lmrkfilename=sources["lmrk"],
                             device="cpu")
    assert_landmarks_match(jm, tm)
    unknown = _write(tmp_path / "lm.bin", b"\x00\x01\x02garbage")
    want = _raised(jm.set_landmark_indices_from_any, unknown)
    assert _raised(tm.set_landmark_indices_from_any, unknown) == want
    assert want[0] == "SerializationError"
    assert isinstance(TError("x"), Exception) and JError is not TError
