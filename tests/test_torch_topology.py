"""mesh_tpu_torch's host-side domain modules against mesh_tpu, on the CPU:
topology (connectivity, Loop subdivision, quadric decimation, the
``LinearMeshTransform``), ``processing``, ``metrics`` and
``utils.arrays``.

These modules are numpy and scipy in both packages, so the contract is bit
for bit: connectivity matrices compared as sparse matrices (no entry
differs), transforms by their matrices and faces, meshes by every array
attribute.  The one device call among them, the closest-face query behind
``LinearMeshTransform``'s segmentation transfer, is held under the tie
contract (``test_torch_facade_rest.assert_parts_match``).  Inputs: the
icosphere both packages generate, a seeded noisy copy of it, and the
shipped low-resolution textured template (42 vertices, 80 faces, with
``vt`` / ``ft``).
"""

import os
import pickle

import numpy as np
import pytest
import scipy.sparse as sp

import mesh_tpu
from mesh_tpu import metrics as jmetrics
from mesh_tpu import processing as jproc
from mesh_tpu import topology as jtopo
from mesh_tpu.sphere import _icosphere as j_icosphere
from mesh_tpu.topology import connectivity as jconn
from mesh_tpu.utils import arrays as jarrays

import mesh_tpu_torch
from mesh_tpu_torch import metrics as tmetrics
from mesh_tpu_torch import processing as tproc
from mesh_tpu_torch import topology as ttopo
from mesh_tpu_torch.sphere import _icosphere as t_icosphere
from mesh_tpu_torch.topology import connectivity as tconn
from mesh_tpu_torch.utils import arrays as tarrays

ARRAY_ATTRS = ("v", "f", "vn", "fn", "vc", "fc", "vt", "ft")


def icosphere(level=2, seed=None):
    """(v, f) of the icosphere at ``level``; with ``seed``, vertices
    scaled to a body-like ellipsoid and jittered by a seeded N(0, 0.01)."""
    v, f = t_icosphere(level)
    if seed is not None:
        rng = np.random.RandomState(seed)
        v = v * np.array([0.3, 0.5, 0.9]) + rng.randn(*v.shape) * 0.01
    return v, f


def mesh_pair(v, f, **attrs):
    """The same mesh in both packages (the port's on the CPU)."""
    jm = mesh_tpu.Mesh(v=v, f=f)
    tm = mesh_tpu_torch.Mesh(v=v, f=f, device="cpu")
    for name, value in attrs.items():
        setattr(jm, name, np.array(value, copy=True))
        setattr(tm, name, np.array(value, copy=True))
    return jm, tm


def textured_pair():
    path = os.path.join(mesh_tpu_torch.texture_path,
                        "textured_template_low_v0.obj")
    return mesh_tpu.Mesh(filename=path), mesh_tpu_torch.Mesh(
        filename=path, device="cpu")


def assert_sparse_equal(a, b):
    a, b = sp.csc_matrix(a), sp.csc_matrix(b)
    assert a.shape == b.shape
    assert a.dtype == b.dtype
    assert (a != b).nnz == 0


def assert_meshes_equal(jm, tm, attrs=ARRAY_ATTRS):
    """Every array attribute either mesh has: present on both, same dtype,
    same bits."""
    for name in attrs:
        assert hasattr(jm, name) == hasattr(tm, name), name
        if hasattr(jm, name):
            a, b = np.asarray(getattr(jm, name)), np.asarray(getattr(tm, name))
            assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=name)


# -- utils.arrays and the package paths ------------------------------------

def test_arrays_helpers_match():
    rng = np.random.RandomState(0)
    a = rng.randn(4, 3)
    np.testing.assert_array_equal(tarrays.row(a), jarrays.row(a))
    np.testing.assert_array_equal(tarrays.col(a), jarrays.col(a))
    i, j = rng.randint(0, 5, 12), rng.randint(0, 7, 12)
    data = rng.randn(12)
    assert_sparse_equal(tarrays.sparse(i, j, data),
                        jarrays.sparse(i, j, data))
    assert_sparse_equal(tarrays.sparse(i, j, data, 9, 11),
                        jarrays.sparse(i, j, data, 9, 11))
    for name in ("asarray_f32", "asarray_i32"):
        x, y = getattr(tarrays, name)(a * 3), getattr(jarrays, name)(a * 3)
        assert x.dtype == y.dtype and x.flags.c_contiguous
        np.testing.assert_array_equal(x, y)


def test_utils_exports_and_package_paths():
    from mesh_tpu_torch import utils

    assert utils.col is tarrays.col and utils.row is tarrays.row
    assert utils.sparse is tarrays.sparse
    assert sorted(os.listdir(mesh_tpu_torch.texture_path)) == sorted(
        os.listdir(mesh_tpu.texture_path))
    assert os.path.isdir(mesh_tpu_torch.mesh_package_cache_folder)
    for level in (0, 1, 2):
        for a, b in zip(t_icosphere(level), j_icosphere(level)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_cache_folder_knob(monkeypatch):
    from mesh_tpu_torch.utils import knobs

    monkeypatch.setenv("MESH_TPU_CACHE", "/x/y")
    monkeypatch.setenv("PSBODY_MESH_CACHE", "/p/q")
    assert knobs.cache_folder() == "/x/y"
    monkeypatch.delenv("MESH_TPU_CACHE")
    assert knobs.cache_folder() == "/p/q"
    monkeypatch.delenv("PSBODY_MESH_CACHE")
    assert knobs.cache_folder() == knobs.DEFAULT_CACHE_FOLDER
    assert knobs.DEFAULT_CACHE_FOLDER.endswith(
        os.path.join("build", "mesh_tpu_torch", "cache"))
    assert knobs.cache_folder() != os.path.expanduser("~/.mesh_tpu/cache")


# -- connectivity ----------------------------------------------------------

@pytest.mark.parametrize("seed", [None, 3])
def test_connectivity_matches(seed):
    jm, tm = mesh_pair(*icosphere(2, seed))
    assert_sparse_equal(tconn.get_vert_connectivity(tm),
                        jconn.get_vert_connectivity(jm))
    for fn in ("get_vertices_per_edge", "get_faces_per_edge",
               "get_faces_per_edge_old"):
        a, b = getattr(tconn, fn)(tm), getattr(jconn, fn)(jm)
        assert a.dtype == b.dtype, fn
        np.testing.assert_array_equal(a, b, err_msg=fn)
    fpe = jconn.get_faces_per_edge(jm)
    np.testing.assert_array_equal(tconn.get_vertices_per_edge(tm, fpe),
                                  jconn.get_vertices_per_edge(jm, fpe))
    ja, ta = jconn.get_vert_opposites_per_edge(jm), \
        tconn.get_vert_opposites_per_edge(tm)
    assert list(ja) == list(ta)
    assert all(np.array_equal(ja[k], ta[k]) for k in ja)
    for want_xyz in (True, False):
        assert_sparse_equal(tconn.vertices_to_edges_matrix(tm, want_xyz),
                            jconn.vertices_to_edges_matrix(jm, want_xyz))
    f0, f1 = jm.f[0], jm.f[1]
    assert tconn.vertices_in_common(f0, f1) == jconn.vertices_in_common(
        f0, f1)
    je = jconn.edge_topology_arrays(jm.f, len(jm.v))
    te = tconn.edge_topology_arrays(tm.f, len(tm.v))
    assert list(je) == list(te)
    for k in je:
        assert je[k].dtype == te[k].dtype
        np.testing.assert_array_equal(je[k], te[k])


def test_connectivity_cache_pickles(tmp_path, monkeypatch):
    """The crc32-keyed cache writes one pickle per tag and key into the
    cache folder and reads it back instead of rebuilding."""
    monkeypatch.setattr(mesh_tpu_torch, "mesh_package_cache_folder",
                        str(tmp_path))
    monkeypatch.setattr(tconn, "mesh_package_cache_folder", str(tmp_path))
    _, tm = mesh_pair(*icosphere(1))
    first = tconn.get_vertices_per_edge(tm)
    names = sorted(os.listdir(tmp_path))
    assert len(names) == 1 and names[0].startswith("verts_per_edge_cache_")
    with open(tmp_path / names[0], "rb") as fp:
        np.testing.assert_array_equal(pickle.load(fp), first)
    calls = []
    assert tconn._cached("verts_per_edge_cache", tm.f,
                         lambda: calls.append(1)) is not None
    assert not calls                     # served from the pickle
    tconn.get_faces_per_edge(tm)
    assert len(os.listdir(tmp_path)) == 2


# -- subdivision, decimation and the transform -----------------------------

def _transform_equal(jt, tt):
    assert_sparse_equal(tt.mtx, jt.mtx)
    np.testing.assert_array_equal(tt.faces, jt.faces)
    assert tt.faces.dtype == jt.faces.dtype
    assert_sparse_equal(tt.vtx_to_edge_mtx, jt.vtx_to_edge_mtx)
    assert_sparse_equal(tt.remeshed_vtx_to_remeshed_edge_mtx,
                        jt.remeshed_vtx_to_remeshed_edge_mtx)
    for name in ("vt", "ft"):
        assert hasattr(jt, name) == hasattr(tt, name)
        if hasattr(jt, name):
            np.testing.assert_array_equal(getattr(tt, name),
                                          getattr(jt, name))


@pytest.mark.parametrize("textured", [False, True])
def test_loop_subdivider_matches(textured):
    jm, tm = textured_pair() if textured else mesh_pair(*icosphere(2, 5))
    jt, tt = jtopo.loop_subdivider(jm), ttopo.loop_subdivider(tm)
    _transform_equal(jt, tt)
    js, ts = jt(jm), tt(tm)
    assert ts.device.type == "cpu"
    assert_meshes_equal(js, ts, ("v", "f", "vt", "ft"))


@pytest.mark.parametrize("factor,n_verts", [(0.5, None), (None, 60)])
def test_qslim_decimator_matches(factor, n_verts):
    jm, tm = mesh_pair(*icosphere(2, 7))
    jt = jtopo.qslim_decimator(jm, factor=factor, n_verts_desired=n_verts)
    tt = ttopo.qslim_decimator(tm, factor=factor, n_verts_desired=n_verts)
    _transform_equal(jt, tt)
    assert_meshes_equal(jt(jm), tt(tm), ("v", "f"))
    jf, jmtx = jtopo.qslim_decimator_transformer(jm, factor, n_verts)
    tf, tmtx = ttopo.qslim_decimator_transformer(tm, factor, n_verts)
    np.testing.assert_array_equal(tf, jf)
    assert_sparse_equal(tmtx, jmtx)
    from mesh_tpu.topology.decimation import qslim_decimator_fast as jfast

    assert_meshes_equal(jfast(jm, factor, n_verts),
                        ttopo.qslim_decimator_fast(tm, factor, n_verts),
                        ("v", "f"))
    with pytest.raises(ValueError):
        ttopo.qslim_decimator(tm)


def test_vertex_quadrics_and_redundant_verts_match():
    jm, tm = mesh_pair(*icosphere(2, 9))
    np.testing.assert_array_equal(ttopo.vertex_quadrics(tm),
                                  jtopo.vertex_quadrics(jm))
    # duplicate a third of the vertices (exactly and within eps) and point
    # the faces at the copies
    v, f = icosphere(2, 9)
    rng = np.random.RandomState(1)
    dup = rng.choice(len(v), len(v) // 3, replace=False)
    v2 = np.vstack([v, v[dup] + rng.choice([0.0, 1e-12], (len(dup), 1))])
    f2 = f.copy()
    remap = dict(zip(dup.tolist(), range(len(v), len(v2))))
    for r in range(0, len(f2), 2):
        f2[r] = [remap.get(int(i), int(i)) for i in f2[r]]
    for eps in (1e-10, 1e-14):
        jv, jf = jtopo.remove_redundant_verts(v2, f2, eps=eps)
        tv, tf = ttopo.remove_redundant_verts(v2, f2, eps=eps)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tf, jf)


def test_linear_mesh_transform_applications():
    jm, tm = mesh_pair(*icosphere(2, 11))
    jt, tt = jtopo.loop_subdivider(jm), ttopo.loop_subdivider(tm)
    flat = np.random.RandomState(2).randn(jm.v.size)
    np.testing.assert_array_equal(tt(flat), jt(flat))
    np.testing.assert_array_equal(tt(flat, want_edges=True),
                                  jt(flat, want_edges=True))
    np.testing.assert_array_equal(tt(tm, want_edges=True),
                                  jt(jm, want_edges=True))
    fine = tt(tm)
    assert tt(fine) is fine                      # already at the target
    np.testing.assert_array_equal(tt(fine, want_edges=True),
                                  jt(jt(jm), want_edges=True))
    rows, cols, vals = tt.as_coo_arrays()
    jr, jc, jv = jt.as_coo_arrays()
    assert (rows.dtype, cols.dtype, vals.dtype) == (np.int64, np.int64,
                                                    np.float32)
    np.testing.assert_array_equal(rows, jr)
    np.testing.assert_array_equal(cols, jc)
    np.testing.assert_array_equal(vals, jv)
    # the triplets rebuild the matrix as a torch sparse tensor
    import torch

    mtx = torch.sparse_coo_tensor(np.stack([rows, cols]), vals,
                                  tt.mtx.shape).to_dense().numpy()
    np.testing.assert_array_equal(mtx, tt.mtx.toarray().astype(np.float32))


def test_remeshed_carries_segm_and_landmarks():
    from .test_torch_facade_rest import assert_parts_match, segmented

    v, f = icosphere(2, 13)
    segm = segmented(f, 4)
    jm, tm = mesh_pair(v, f)
    jm.segm, tm.segm = segm, dict(segm)
    jm.landm, tm.landm = {"a": 3, "b": 40}, {"a": 3, "b": 40}
    for build in ("loop_subdivider", "qslim_decimator"):
        kw = {} if build == "loop_subdivider" else {"factor": 0.5}
        jo = getattr(jtopo, build)(jm, **kw)(jm)
        to = getattr(ttopo, build)(tm, **kw)(tm)
        assert to.device.type == "cpu"
        assert to.landm == jo.landm
        assert_parts_match(jo, to, jm)


# -- processing --------------------------------------------------------------

def _processing_pair(seed=17, **extra):
    v, f = icosphere(2, seed)
    rng = np.random.RandomState(seed)
    attrs = dict(vn=rng.randn(*v.shape), vc=rng.rand(*v.shape),
                 fc=rng.rand(*f.shape), fn=f.copy())
    attrs.update(extra)
    return mesh_pair(v, f, **attrs)


EDITS = {
    "keep_vertices": lambda m: m.keep_vertices(np.arange(0, 162, 2)),
    "remove_vertices": lambda m: m.remove_vertices([0, 5, 77]),
    "remove_faces": lambda m: m.remove_faces([0, 3, 100, 319]),
    "scale_vertices": lambda m: m.scale_vertices(1.7),
    "rotate_vertices_matrix": lambda m: m.rotate_vertices(
        np.array([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]])),
    "translate_vertices": lambda m: m.translate_vertices([0.1, -2, 3]),
    "flip_faces": lambda m: m.flip_faces(),
    "subdivide_triangles": lambda m: m.subdivide_triangles(),
    "reorder_vertices": lambda m: m.reorder_vertices(
        np.random.RandomState(4).permutation(len(m.v))),
    "reorder_vertices_normals": lambda m: m.reorder_vertices(
        np.random.RandomState(4).permutation(len(m.v)),
        np.random.RandomState(5).permutation(len(m.v))),
    "reset_face_normals": lambda m: m.reset_face_normals(),
}


@pytest.mark.parametrize("edit", sorted(EDITS))
def test_processing_edit_matches(edit):
    jm, tm = _processing_pair()
    if edit == "subdivide_triangles":
        tex = textured_pair()
        jm.vt, jm.ft = tex[0].vt, np.tile(tex[0].ft, (4, 1))
        tm.vt, tm.ft = tex[1].vt, np.tile(tex[1].ft, (4, 1))
    if edit in ("remove_faces",):
        tex = textured_pair()
        jm.vt, jm.ft = tex[0].vt, np.tile(tex[0].ft, (4, 1))
        tm.vt, tm.ft = tex[1].vt, np.tile(tex[1].ft, (4, 1))
    out_j, out_t = EDITS[edit](jm), EDITS[edit](tm)
    if out_j is None:
        assert out_t is None
    else:
        assert out_j is jm and out_t is tm
    assert_meshes_equal(jm, tm)


def test_processing_rotation_vector_and_normals():
    """Rodrigues rotations and the normal resets run on the port's device
    code: held to 1e-12 (rotation) and 1e-6 (normals, float32 kernels in
    both packages)."""
    jm, tm = _processing_pair()
    jproc.rotate_vertices(jm, np.array([0.3, -0.2, 0.5]))
    tproc.rotate_vertices(tm, np.array([0.3, -0.2, 0.5]))
    np.testing.assert_allclose(tm.v, jm.v, rtol=0, atol=1e-12)
    jm, tm = _processing_pair()
    jm.reset_normals(reset_face_normals=True)
    tm.reset_normals(reset_face_normals=True)
    np.testing.assert_allclose(tm.vn, jm.vn, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tm.fn, jm.fn)


def test_processing_derived_meshes_match():
    jm, tm = _processing_pair()
    tex = textured_pair()
    jm.vt, jm.ft = tex[0].vt, np.tile(tex[0].ft, (4, 1))
    tm.vt, tm.ft = tex[1].vt, np.tile(tex[1].ft, (4, 1))
    ju, tu = jm.uniquified_mesh(), tm.uniquified_mesh()
    assert tu.device.type == "cpu"
    assert_meshes_equal(ju, tu)
    jp, tp = jm.point_cloud(), tm.point_cloud()
    assert tp.device.type == "cpu"
    assert_meshes_equal(jp, tp)
    # no vn yet: uniquified_mesh resets the normals first
    jm2, tm2 = mesh_pair(*icosphere(1, 2))
    ju2, tu2 = jm2.uniquified_mesh(), tm2.uniquified_mesh()
    np.testing.assert_array_equal(tu2.f, ju2.f)
    np.testing.assert_allclose(tu2.vn, ju2.vn, rtol=0, atol=1e-6)


@pytest.mark.parametrize("colored", [(True, True), (True, False),
                                     (False, True), (False, False)])
def test_concatenate_mesh_matches(colored):
    rng = np.random.RandomState(8)
    pairs = []
    for has_vc, seed in zip(colored, (1, 2)):
        v, f = icosphere(1, seed)
        extra = {"vc": rng.rand(*v.shape)} if has_vc else {}
        pairs.append(mesh_pair(v, f, **extra))
    (ja, ta), (jb, tb) = pairs
    ja.concatenate_mesh(jb)
    ta.concatenate_mesh(tb)
    assert_meshes_equal(ja, ta)
    # an empty mesh adopts the other's arrays
    je, te = mesh_pair(np.zeros((0, 3)), np.zeros((0, 3), np.uint32))
    je.concatenate_mesh(jb)
    te.concatenate_mesh(tb)
    assert_meshes_equal(je, te)


# -- metrics -------------------------------------------------------------

@pytest.mark.parametrize("normal,dist", [([0, 0, 1], 0.0), ([0, 0, 2], 0.3),
                                         ([1, 1, 0], -0.05)])
def test_circumference_matches(normal, dist):
    from .test_torch_facade_rest import segmented

    v, f = icosphere(3, 19)
    jm, tm = mesh_pair(v, f)
    jm.segm = tm.segm = segmented(f, 4)
    for parts in (None, ["part0", "part2"], ["missing"]):
        a = jm.estimate_circumference(normal, dist, parts, want_edges=True)
        b = tm.estimate_circumference(normal, dist, parts, want_edges=True)
        assert a[0] == b[0]
        np.testing.assert_array_equal(a[1], b[1])
        assert tm.estimate_circumference(normal, dist, parts) == \
            jm.estimate_circumference(normal, dist, parts)
    js, je = jmetrics.plane_section(v, f, normal, dist)
    ts, te = tmetrics.plane_section(v, f, normal, dist)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(te, je)
