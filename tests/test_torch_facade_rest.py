"""The rest of mesh_tpu_torch's ``Mesh`` facade against mesh_tpu, on the
CPU: signatures, the derived meshes' device, colours, lines, spheres,
texture, landmarks, segmentation transfer, ``MeshArrays`` and ``lbs``'s
precision, and the psbody-style workflow of ``chip_smoke.py`` phase 17 on
a small mesh.

Contracts: numpy-level outputs bit for bit; the colour table entry for
entry; closest-point-based outputs (landmark indices, ``transfer_segm``
parts) equal except at exact distance ties, which are checked in float64
(``assert_parts_match``, ``assert_landmarks_match``); landmark regressor
coefficients within 1e-5 (both packages compute them in float32); vertex
normals within 1e-6.
"""

import inspect
import os

import numpy as np
import pytest
import torch

import mesh_tpu
from mesh_tpu import colors as jcolors
from mesh_tpu.lines import Lines as JLines
from mesh_tpu.models import body_model as jbm
from mesh_tpu.sphere import Sphere as JSphere

import mesh_tpu_torch
from mesh_tpu_torch import colors as tcolors
from mesh_tpu_torch.core import MeshArrays
from mesh_tpu_torch.lines import Lines as TLines
from mesh_tpu_torch.models import body_model as tbm
from mesh_tpu_torch.query.point_triangle import closest_point_on_triangle
from mesh_tpu_torch.sphere import Sphere as TSphere
from mesh_tpu_torch.topology import loop_subdivider

from .test_torch_topology import (
    assert_meshes_equal,
    icosphere,
    mesh_pair,
    textured_pair,
)

#: the reference methods the port does not have yet, each raising
#: NotImplementedError that names ROADMAP.md, Queue 1
NOT_PORTED = ("show",)

COEFF_TOL = 1e-5
TIE_TOL = 1e-9


def segmented(f, n_parts):
    """A segmentation of ``f``'s faces into ``n_parts`` runs of indices."""
    return {"part%d" % i: block.tolist() for i, block in
            enumerate(np.array_split(np.arange(len(f)), n_parts))}


def sqdist64(points, v, f):
    """[Q, F] float64 squared distances from each point to each face."""
    p = torch.as_tensor(np.asarray(points, np.float64))[:, None, :]
    tri = torch.as_tensor(np.asarray(v, np.float64))[
        torch.as_tensor(np.asarray(f, np.int64))]
    return closest_point_on_triangle(p, tri[None, :, 0], tri[None, :, 1],
                                     tri[None, :, 2])[1].numpy()


def assert_parts_match(j_out, t_out, donor):
    """``transfer_segm``'s parts: equal face for face, except where the
    donor faces nearest a face's centroid tie in float64 and the two
    packages took different ones; there each package's part must hold a
    donor face at the least float64 distance."""
    assert sorted(j_out.segm) == sorted(t_out.segm)
    jp, tp = np.array(j_out.parts_by_face()), np.array(t_out.parts_by_face())
    differ = np.flatnonzero(jp != tp)
    if differ.size:
        cen = j_out.v[j_out.f[differ].astype(np.int64)].mean(axis=1)
        d = sqdist64(cen, donor.v, donor.f)
        best = d.min(axis=1)
        donor_parts = np.array(donor.parts_by_face())
        for k, face in enumerate(differ):
            for part in (jp[face], tp[face]):
                assert d[k][donor_parts == part].min() - best[k] <= TIE_TOL, (
                    face, part)
    return differ.size


def assert_landmarks_match(jm, tm):
    """Landmark indices equal except at float64 ties of the nearest vertex;
    regressors: the same face (or a float64 tie) and coefficients within
    COEFF_TOL."""
    assert list(jm.landm) == list(tm.landm)
    xyz = np.array([jm.landm_raw_xyz[k] for k in jm.landm], np.float64)
    d = ((xyz[:, None, :] - jm.v[None]) ** 2).sum(-1)
    for k, name in enumerate(jm.landm):
        a, b = jm.landm[name], tm.landm[name]
        assert a == b or abs(d[k, a] - d[k, b]) <= TIE_TOL, name
    assert hasattr(jm, "landm_regressors") == hasattr(tm, "landm_regressors")
    if not hasattr(jm, "landm_regressors"):     # set from vertex indices
        return
    assert list(jm.landm_regressors) == list(tm.landm_regressors)
    for k, name in enumerate(jm.landm_regressors):
        (ji, jc), (ti, tc) = jm.landm_regressors[name], \
            tm.landm_regressors[name]
        assert ti.dtype == ji.dtype and tc.dtype == jc.dtype
        if np.array_equal(ji, ti):
            np.testing.assert_allclose(tc, jc, rtol=0, atol=COEFF_TOL)
        else:
            dd = sqdist64(xyz[k:k + 1], jm.v, np.stack([ji, ti]))[0]
            assert abs(dd[0] - dd[1]) <= TIE_TOL, name


# -- signatures ----------------------------------------------------------

def _public(cls):
    return sorted(n for n in dir(cls) if not n.startswith("_"))


def _params(fn, drop_device=False):
    sig = inspect.signature(fn)
    out = []
    for p in sig.parameters.values():
        if drop_device and p.name == "device" and p.kind == p.KEYWORD_ONLY:
            continue
        out.append((p.name, p.kind, p.default))
    return out


@pytest.mark.parametrize("name", _public(mesh_tpu.Mesh))
def test_mesh_public_name_and_signature(name):
    ref = inspect.getattr_static(mesh_tpu.Mesh, name)
    port = inspect.getattr_static(mesh_tpu_torch.Mesh, name)
    assert type(ref) is type(port), name
    if callable(ref):
        assert _params(port, drop_device=True) == _params(ref), name
        source = inspect.getsource(port)
        assert ("_not_ported(" in source) == (name in NOT_PORTED), name


def test_mesh_init_takes_device_last_keyword_only():
    params = inspect.signature(mesh_tpu_torch.Mesh.__init__).parameters
    assert list(params)[-1] == "device"
    assert params["device"].kind == inspect.Parameter.KEYWORD_ONLY
    assert _params(mesh_tpu_torch.Mesh.__init__, drop_device=True) == \
        _params(mesh_tpu.Mesh.__init__)
    assert mesh_tpu_torch.Mesh.visibile_mesh is \
        mesh_tpu_torch.Mesh.visible_mesh


@pytest.mark.parametrize("name", NOT_PORTED)
def test_not_ported_methods_raise(name):
    m = mesh_tpu_torch.Mesh(*icosphere(1), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md, Queue 1"):
        getattr(m, name)()


@pytest.mark.parametrize("pair", [
    (JSphere, TSphere), (JLines, TLines),
    (mesh_tpu.MeshArrays, MeshArrays)])
def test_domain_class_signatures(pair):
    ref_cls, port_cls = pair
    assert _public(ref_cls) == [n for n in _public(port_cls)
                                if n != "device"]
    for name in _public(ref_cls):
        ref = inspect.getattr_static(ref_cls, name)
        port = inspect.getattr_static(port_cls, name)
        if isinstance(ref, classmethod):
            ref, port = ref.__func__, port.__func__
        if inspect.isfunction(ref):
            got = _params(port, drop_device=True)
            want = _params(ref)
            if name == "create":          # dtype's default is each package's
                got, want = got[:-1], want[:-1]     # float32
            assert [p[:2] for p in got] == [p[:2] for p in want], name
            if name != "to_mesh":          # the red default is an array
                assert got == want, name


def test_lbs_signature_and_positional_precision():
    ref = [p[:2] for p in _params(jbm.lbs)]
    assert [p[:2] for p in _params(tbm.lbs, drop_device=True)] == ref
    assert inspect.signature(tbm.lbs).parameters["device"].kind == \
        inspect.Parameter.KEYWORD_ONLY
    import jax

    m = tbm.synthetic_body_model(seed=0, device="cpu")
    rng = np.random.RandomState(0)
    betas = rng.randn(2, m.num_betas) * 0.3
    pose = rng.randn(2, m.num_joints, 3) * 0.1
    base = tbm.lbs(m, betas, pose, device="cpu")[0]
    for precision in (jax.lax.Precision.HIGHEST, "highest",
                      jax.lax.Precision.DEFAULT, "DEFAULT", "high"):
        got = tbm.lbs(m, betas, pose, None, precision, device="cpu")[0]
        assert torch.equal(got, base)       # no TF32 on the CPU
    for bad in ("cpu", "cuda", 3):
        with pytest.raises(ValueError):
            tbm.lbs(m, betas, pose, None, bad, device="cpu")
    assert not tbm.tf32_allowed(jax.lax.Precision.HIGHEST)
    assert tbm.tf32_allowed(jax.lax.Precision.DEFAULT)
    assert tbm.tf32_allowed("HIGH")
    saved = torch.backends.cuda.matmul.allow_tf32
    with tbm.tf32(not saved):
        assert torch.backends.cuda.matmul.allow_tf32 == (not saved)
    assert torch.backends.cuda.matmul.allow_tf32 == saved


# -- derived meshes keep the device ----------------------------------------

def _answers_on_cpu(m):
    assert m.device.type == "cpu"
    q = np.random.RandomState(0).randn(16, 3) * 0.5
    if len(m.f):
        faces, points = m.closest_faces_and_points(q)
        assert faces.shape == (1, 16) and points.shape == (16, 3)
    idx, dist = m.closest_vertices(q)
    assert idx.shape == (16,) and np.isfinite(dist).all()


DERIVED = {
    "subdivide_triangles": lambda m: m.subdivide_triangles(),
    "simplified": lambda m: m.simplified(factor=0.5)(m),
    "uniquified_mesh": lambda m: m.uniquified_mesh(),
    "point_cloud": lambda m: m.point_cloud(),
    "visible_mesh": lambda m: m.visible_mesh([3.0, 0.0, 0.0]),
    "loop_subdivider": lambda m: loop_subdivider(m)(m),
    "sphere_to_mesh": lambda m: TSphere(np.zeros(3), 2.0).to_mesh(
        device="cpu"),
    "load_texture": lambda m: (m.load_texture(0), m)[1],
    "landmark_markers": lambda m: (m.set_landmarks_from_xyz(
        [[0.0, 0.0, 1.1]]), m._landmark_marker_meshes()[0])[1],
}


@pytest.mark.parametrize("derive", sorted(DERIVED))
def test_derived_mesh_stays_on_cpu(derive):
    _, m = textured_pair()                 # 42 vertices, 80 faces
    out = DERIVED[derive](m)
    _answers_on_cpu(out)


def test_mesh_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default is allowed")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh_tpu_torch.Mesh(*icosphere(1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSphere(np.zeros(3), 1.0).to_mesh()


# -- colours, lines, spheres ---------------------------------------------

def test_color_table_entry_for_entry():
    assert list(tcolors.name_to_rgb) == list(jcolors.name_to_rgb)
    for name, rgb in jcolors.name_to_rgb.items():
        got = tcolors.name_to_rgb[name]
        assert got.dtype == rgb.dtype and got.shape == rgb.shape, name
        np.testing.assert_array_equal(got, rgb, err_msg=name)


def test_color_expansion_and_jet_match():
    rng = np.random.RandomState(3)
    for val in np.linspace(0, 1, 11):
        np.testing.assert_array_equal(tcolors.jet(val), jcolors.jet(val))
    for color, n in (("SteelBlue", 5), ("steel blue", 2), ([0.1, 0.2, 0.3], 4),
                     (rng.rand(6, 3), 6), (rng.rand(7), 7)):
        np.testing.assert_array_equal(tcolors.expand_colors(color, n),
                                      jcolors.expand_colors(color, n))
    from matplotlib import cm

    w = np.concatenate([np.linspace(0, 1, 1001), [-0.2, 1.2, np.nan]])
    np.testing.assert_array_equal(tcolors.cm_jet(w), cm.jet(w))


def test_vertex_and_face_colors_match():
    jm, tm = mesh_pair(*icosphere(2, 1))
    rng = np.random.RandomState(2)
    w = rng.rand(len(jm.v))
    steps = [
        ("set_vertex_colors", ("red",)),
        ("set_vertex_colors", ([0.2, 0.4, 0.6], np.arange(10))),
        ("set_vertex_colors", ("Blue", np.arange(len(jm.v)) % 3 == 0)),
        ("set_vertex_colors_from_weights", (w,)),
        ("scale_vertex_colors", (w, 0.2, 0.9)),
        ("set_vertex_colors_from_weights", (w, False, False)),
        ("set_vertex_colors_from_weights", (w * 3 - 1, False, True)),
        ("set_face_colors", ("green",)),
    ]
    for name, args in steps:
        getattr(jm, name)(*args)
        getattr(tm, name)(*args)
        assert_meshes_equal(jm, tm, ("vc", "fc"))
    for arr in (None, rng.rand(5, 3), rng.rand(12)):
        np.testing.assert_array_equal(tm.colors_like("red", arr),
                                      jm.colors_like("red", arr))
    jm2, tm2 = mesh_pair(*icosphere(1), vc=None)
    assert_meshes_equal(mesh_tpu.Mesh(*icosphere(1), vc="red", fc="blue"),
                        mesh_tpu_torch.Mesh(*icosphere(1), vc="red",
                                            fc="blue", device="cpu"))


def test_lines_and_edges_match(tmp_path):
    jm, tm = mesh_pair(*icosphere(1, 2))
    jl, tl = jm.edges_as_lines(), tm.edges_as_lines(copy_vertices=True)
    np.testing.assert_array_equal(tl.v, jl.v)
    np.testing.assert_array_equal(tl.e, jl.e)
    rng = np.random.RandomState(4)
    jl = JLines(jl.v, jl.e, vc="red", ec=rng.rand(len(jl.e)))
    tl = TLines(tl.v, tl.e, vc="red", ec=rng.rand(len(tl.e)) * 0 + 1)
    tl.set_edge_colors(jl.ec)
    for name in ("vc", "ec"):
        np.testing.assert_array_equal(getattr(tl, name), getattr(jl, name))
    np.testing.assert_array_equal(tl.colors_like("blue", tl.e),
                                  jl.colors_like("blue", jl.e))
    jl.write_obj(str(tmp_path / "j.obj"))
    tl.write_obj(str(tmp_path / "t.obj"))
    assert (tmp_path / "j.obj").read_bytes() == \
        (tmp_path / "t.obj").read_bytes()


def test_sphere_matches():
    js, ts = JSphere([0.1, 0.2, 0.3], 0.7), TSphere([0.1, 0.2, 0.3], 0.7)
    assert str(js) == str(ts)
    for c, r in (([0.5, 0.2, 0.3], 0.4), ([3.0, 0, 0], 0.5),
                 ([0.2, 0.2, 0.3], 0.1), ([1.0, 0.2, 0.3], 0.5)):
        assert js.intersects(JSphere(c, r)) == ts.intersects(TSphere(c, r))
        assert js.intersection_vol(JSphere(c, r)) == \
            ts.intersection_vol(TSphere(c, r))
        assert js.has_inside(np.array(c)) == ts.has_inside(np.array(c))
    assert_meshes_equal(js.to_mesh(), ts.to_mesh(device="cpu"))
    assert_meshes_equal(js.to_mesh([0.1, 0.2, 0.3]),
                        ts.to_mesh([0.1, 0.2, 0.3], device="cpu"))
    with pytest.raises(ValueError):
        TSphere([0, 0], 1.0)


# -- geometry, segmentation, joints, MeshArrays ---------------------------

def test_faces_by_vertex_and_barycentrics_match():
    jm, tm = mesh_pair(*icosphere(2, 6))
    assert tm.faces_by_vertex() == jm.faces_by_vertex()
    a = tm.faces_by_vertex(as_sparse_matrix=True)
    b = jm.faces_by_vertex(as_sparse_matrix=True)
    assert type(a) is type(b) and (a != b).nnz == 0
    rng = np.random.RandomState(7)
    faces = rng.randint(0, len(jm.f), 32)
    pts = jm.v[jm.f[faces, 0].astype(np.int64)] + rng.randn(32, 3) * 0.05
    jc, jb = jm.barycentric_coordinates_for_points(pts, faces)
    tc, tb = tm.barycentric_coordinates_for_points(pts, faces)
    np.testing.assert_array_equal(tc, jc)
    assert tb.dtype == np.asarray(jb).dtype
    np.testing.assert_allclose(tb, jb, rtol=0, atol=COEFF_TOL)
    np.testing.assert_allclose(tm.estimate_vertex_normals(),
                               jm.estimate_vertex_normals(), rtol=0,
                               atol=1e-6)


def test_segmentation_helpers_and_joints_match():
    v, f = icosphere(2, 8)
    segm = segmented(f, 5)
    jm, tm = mesh_pair(v, f)
    jm.segm, tm.segm = segm, dict(segm)
    assert tm.verts_by_segm == jm.verts_by_segm
    assert tm.parts_by_face() == jm.parts_by_face()
    assert tm.verts_in_common(["part0", "part1"]) == \
        jm.verts_in_common(["part0", "part1"])
    rings = [[0, 1, 2], [10, 11]]
    jm.set_joints(["a", "b"], rings)
    tm.set_joints(["a", "b"], rings)
    assert list(tm.joint_names) == list(jm.joint_names)
    for name, xyz in jm.joint_xyz.items():
        np.testing.assert_array_equal(tm.joint_xyz[name], xyz)


def test_transfer_segm_matches():
    v, f = icosphere(2, 10)
    jd, td = mesh_pair(v, f)
    jd.segm = td.segm = segmented(f, 6)
    tt = loop_subdivider(td)
    jo = mesh_tpu.Mesh(v=tt(td).v, f=tt.faces)
    to = mesh_tpu_torch.Mesh(v=tt(td).v, f=tt.faces, device="cpu")
    for exclude in (True, False):
        jo.transfer_segm(jd, exclude)
        to.transfer_segm(td, exclude)
        assert_parts_match(jo, to, jd)
    bare_j, bare_t = mesh_pair(v, f)
    jo.transfer_segm(bare_j)
    to.transfer_segm(bare_t)
    assert to.segm == jo.segm == {}


def test_mesh_arrays_match():
    jm, tm = mesh_pair(*icosphere(1, 3), vn=np.ones((42, 3)))
    ja, ta = jm.arrays(), tm.arrays()
    assert ta.device.type == "cpu" and ta.v.dtype == torch.float32
    assert ta.f.dtype == torch.int64
    for name in ("v", "f", "vn"):
        np.testing.assert_array_equal(getattr(ta, name).numpy(),
                                      np.asarray(getattr(ja, name)))
    assert ta.vc is None and ja.vc is None
    assert (ta.num_vertices, ta.num_faces, ta.batch_shape) == \
        (ja.num_vertices, ja.num_faces, tuple(ja.batch_shape))
    np.testing.assert_array_equal(ta.tri().numpy(), np.asarray(ja.tri()))
    batch = torch.stack([ta.v, ta.v * 2])
    tb = ta.with_vertices(batch)
    assert tb.batch_shape == (2,) and tb.tri().shape == (2, 80, 3, 3)
    assert ta.v.shape == (42, 3)                 # frozen: a new instance
    with pytest.raises(Exception):
        ta.v = batch
    t64 = tm.arrays(dtype=torch.float64)
    np.testing.assert_array_equal(t64.v.numpy(), tm.v)
    made = MeshArrays.create(tm.v, tm.f, vt=np.zeros((3, 2)),
                             ft=np.zeros((1, 3)), device="cpu")
    assert made.vt.dtype == torch.float32 and made.ft.dtype == torch.int64


# -- texture --------------------------------------------------------------

@pytest.mark.parametrize("version", [0, 1])
@pytest.mark.parametrize("order", ["same", "flipped", "permuted"])
def test_texture_transfer_matches(version, order):
    for res in ("low", "high"):
        path = os.path.join(mesh_tpu_torch.texture_path,
                            "textured_template_%s_v%d.obj" % (res, version))
        src = mesh_tpu.Mesh(filename=path)
        f = np.asarray(src.f)
        if order == "flipped":
            f = np.fliplr(f)
        elif order == "permuted":
            rng = np.random.RandomState(version)
            f = np.roll(f[rng.permutation(len(f))], 1, axis=1)
        jm, tm = mesh_pair(src.v, f)
        jm.load_texture(version)
        tm.load_texture(version)
        assert_meshes_equal(jm, tm, ("vt", "ft"))
        assert os.path.basename(tm.texture_filepath) == \
            os.path.basename(jm.texture_filepath)
        assert tm.texture_coordinates_by_vertex()[:5] is not None
        for a, b in zip(tm.texture_coordinates_by_vertex(),
                        jm.texture_coordinates_by_vertex()):
            np.testing.assert_array_equal(np.array(a), np.array(b))


def test_texture_image_lookups_match():
    pytest.importorskip("cv2")
    jm, tm = textured_pair()
    tc = np.random.RandomState(5).rand(64, 2) * 1.2 - 0.1
    np.testing.assert_array_equal(tm.texture_rgb_vec(tc),
                                  jm.texture_rgb_vec(tc))
    for t in tc[:8].clip(0, 1):
        np.testing.assert_array_equal(tm.texture_rgb(t), jm.texture_rgb(t))
    assert tm.texture_image.shape == jm.texture_image.shape
    tm.set_texture_image(jm.texture_filepath)
    assert tm.texture_filepath == jm.texture_filepath


# -- landmarks ------------------------------------------------------------

def _landmark_xyz(v, n, seed):
    rng = np.random.RandomState(seed)
    return v[rng.choice(len(v), n, replace=False)] + rng.randn(n, 3) * 0.01


def test_landmarks_from_xyz_match():
    v, f = icosphere(2, 12)
    jm, tm = mesh_pair(v, f)
    xyz = _landmark_xyz(v, 12, 0)
    named = {"lm%d" % i: p for i, p in enumerate(xyz)}
    for raw in (named, list(xyz)):
        jm.set_landmarks_from_xyz(raw)
        tm.set_landmarks_from_xyz(raw)
        assert_landmarks_match(jm, tm)
    assert tm.landm_names == jm.landm_names
    jt = jm.landm_xyz_linear_transform()
    tt = tm.landm_xyz_linear_transform()
    assert jt.shape == tt.shape
    np.testing.assert_allclose(tt.toarray(), jt.toarray(), rtol=0,
                               atol=COEFF_TOL)
    for name, p in jm.landm_xyz.items():
        np.testing.assert_allclose(tm.landm_xyz[name], p, rtol=0, atol=1e-5)
    # face-less meshes snap to the nearest vertex alone
    jp, tp = mesh_pair(v, np.zeros((0, 3), np.uint32))
    jp.set_landmarks_from_xyz(named)
    tp.set_landmarks_from_xyz(named)
    assert tp.landm == jp.landm
    for k in jp.landm_regressors:
        for a, b in zip(tp.landm_regressors[k], jp.landm_regressors[k]):
            np.testing.assert_array_equal(a, b)


def test_landmarks_from_raw_indices_and_keyword():
    v, f = icosphere(2, 14)
    jm = mesh_tpu.Mesh(v=v, f=f, landmarks={"a": 3, "b": 17})
    tm = mesh_tpu_torch.Mesh(v=v, f=f, landmarks={"a": 3, "b": 17},
                             device="cpu")
    assert tm.landm == jm.landm
    for k in jm.landm_raw_xyz:
        np.testing.assert_array_equal(tm.landm_raw_xyz[k],
                                      jm.landm_raw_xyz[k])
    jm.set_landmarks_from_raw([[0.0, 0.0, 1.0], [0.5, 0.5, 0.0]])
    tm.set_landmarks_from_raw([[0.0, 0.0, 1.0], [0.5, 0.5, 0.0]])
    assert_landmarks_match(jm, tm)
    with pytest.raises(ValueError):
        tm.set_landmarks_from_raw({"a": "x"})
    tm.set_landmarks_from_regressors({"r": (np.array([0]), np.array([1.0]))})
    assert tm.landm_names == ["r"]


def test_edits_recompute_landmarks_like_the_reference():
    v, f = icosphere(2, 16)
    jm, tm = mesh_pair(v, f)
    xyz = _landmark_xyz(v, 6, 3)
    jm.set_landmarks_from_xyz(xyz)
    tm.set_landmarks_from_xyz(xyz)
    jm.keep_vertices(np.arange(0, len(v) - 20))
    tm.keep_vertices(np.arange(0, len(v) - 20))
    assert_landmarks_match(jm, tm)
    jm.remove_faces(np.arange(10))
    tm.remove_faces(np.arange(10))
    assert_meshes_equal(jm, tm, ("v", "f"))
    assert_landmarks_match(jm, tm)


# -- the phase-17 workflow on a small mesh --------------------------------

def test_domain_workflow_matches(tmp_path):
    """chip_smoke.py phase 17's steps a-c and e on a 320-face icosphere
    body with a 6-part segmentation and 8 landmarks: each package writes,
    the other reads; then landmarks, Loop subdivision carrying segmentation
    and landmarks, decimation and the edits, each step against the
    reference."""
    v, f = icosphere(2, 21)
    segm = segmented(f, 6)
    jm, tm = mesh_pair(v, f)
    jm.segm, tm.segm = segm, dict(segm)
    # a. file round trip, crossed between the packages: each file read
    # back by both packages gives what the file holds (float32 for binary
    # PLY, %g text for ascii PLY, %f for OBJ, repr for JSON)
    written = {"ply": lambda x: x.astype(np.float32).astype(np.float64),
               "ply_ascii": lambda x: np.array(
                   [float("%g" % c) for c in x.astype(np.float32).ravel()]
               ).reshape(x.shape),
               "obj": lambda x: np.array(
                   [float("%f" % c) for c in x.ravel()]).reshape(x.shape),
               "json": lambda x: x}
    for kind, held in written.items():
        ext = kind.split("_")[0]
        kw = {"ascii": True} if kind == "ply_ascii" else {}
        for writer in (tm, jm):
            path = str(tmp_path / ("w_%s.%s" % (kind, ext)))
            getattr(writer, "write_" + ext)(path, **kw)
            for back in (mesh_tpu.Mesh(filename=path),
                         mesh_tpu_torch.Mesh(filename=path, device="cpu")):
                np.testing.assert_array_equal(back.v, held(writer.v))
                np.testing.assert_array_equal(back.f, writer.f)
    # b. landmarks
    xyz = _landmark_xyz(v, 8, 9)
    jm.set_landmarks_from_xyz(xyz)
    tm.set_landmarks_from_xyz(xyz)
    assert_landmarks_match(jm, tm)
    # c. Loop subdivision with segmentation and landmarks carried over
    from mesh_tpu.topology import loop_subdivider as jloop

    js, ts = jloop(jm)(jm), loop_subdivider(tm)(tm)
    assert ts.device.type == "cpu" and len(ts.f) == 4 * len(f)
    assert_meshes_equal(js, ts, ("v", "f"))
    assert ts.landm == js.landm
    assert_parts_match(js, ts, jm)
    # e. decimation and the edits
    jd, td = jm.simplified(factor=0.5)(jm), tm.simplified(factor=0.5)(tm)
    assert_meshes_equal(jd, td, ("v", "f"))
    assert_parts_match(jd, td, jm)
    ju, tu = jd.uniquified_mesh(), td.uniquified_mesh()
    np.testing.assert_array_equal(tu.v, ju.v)
    np.testing.assert_array_equal(tu.f, ju.f)
    for m in (js, ts):
        m.keep_vertices(np.arange(0, len(m.v), 2))
        m.remove_faces(np.arange(0, len(m.f), 7))
        m.concatenate_mesh(jd if m is js else td)
        m.reorder_vertices(np.random.RandomState(1).permutation(len(m.v)))
        m.flip_faces()
    assert_meshes_equal(js, ts, ("v", "f"))
    for z in (-0.3, 0.0, 0.4):
        assert ts.estimate_circumference([0, 0, 1], z) == \
            js.estimate_circumference([0, 0, 1], z)
    jvis, tvis = jm.visible_mesh([0.0, 0.0, 3.0]), tm.visible_mesh(
        [0.0, 0.0, 3.0])
    assert tvis.device.type == "cpu"
    assert_meshes_equal(jvis, tvis, ("v", "f"))
