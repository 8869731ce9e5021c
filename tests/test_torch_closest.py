"""mesh_tpu_torch closest-point module vs mesh_tpu, on the CPU.

Inputs come from numpy RandomState seeds and go to both packages.  The JAX
side runs its Pallas kernels in interpret mode (small tiles), as
tests/test_pallas.py does; the port runs its kernels' plain versions,
which is what a CPU tensor selects.

The tie contract: face indices agree except where the two faces are
equidistant, |sqdist_ref(face_ref) - sqdist_ref(face_port)| <= 1e-6 by the
reference's own distances (the two packages center on the vertex mean
with different float32 reductions, which moves exact-distance ties);
points and sqdist agree to 1e-5 absolute; part codes agree wherever faces
do.
"""

import ast
import os

import numpy as np
import pytest
import torch

from mesh_tpu.models.body_model import _uv_sphere
from mesh_tpu.query import point_triangle as jpt
from mesh_tpu.query.closest_point import closest_faces_and_points as jax_scan
from mesh_tpu.query.pallas_closest import (
    closest_point_pallas,
    mesh_is_nondegenerate as jax_nondegenerate,
    nearest_vertices_pallas,
)

from mesh_tpu_torch import _build
from mesh_tpu_torch.query import closest_kernel as ck
from mesh_tpu_torch.query import point_triangle as tpt
from mesh_tpu_torch.query.closest_point import (
    closest_faces_and_points,
    closest_vertices,
    closest_vertices_with_distance,
)
from mesh_tpu_torch.query.culled import closest_faces_and_points_auto

torch.set_num_threads(2)

#: the tie contract's bounds (module docstring)
TIE_TOL = 1e-6
VALUE_TOL = 1e-5

VARIANTS = [("fast", False), ("fast", True), ("safe", False), ("safe", True)]


def small_body(seed=0, n_seg=12, n_ring=10):
    """A body-proportioned UV sphere (a few hundred faces), float32."""
    v, f = _uv_sphere(n_seg, n_ring)
    rng = np.random.RandomState(seed)
    v = v * np.array([0.3, 0.2, 0.9]) + rng.randn(*v.shape) * 0.005
    return v.astype(np.float32), f.astype(np.int32)


def with_degenerate_faces(v, f, rng, n=8):
    """``v``/``f`` plus n zero-area faces (two equal corners) and n
    collinear faces (a vertex at an edge's midpoint); queries near them."""
    picks = rng.choice(f.shape[0], n, replace=False)
    i, j = f[picks, 0], f[picks, 1]
    mids = (v[i].astype(np.float64) + v[j]) / 2.0
    new = v.shape[0] + np.arange(n)
    v2 = np.vstack([v, mids]).astype(np.float32)
    f2 = np.vstack([f, np.stack([i, i, j], 1), np.stack([i, j, new], 1)])
    q = np.vstack([mids + rng.randn(n, 3) * 0.01, rng.randn(48, 3) * 0.4])
    return v2, f2.astype(np.int32), q.astype(np.float32)


def assert_tie_contract(ref, out, v, f, q):
    """Hold the port's result ``out`` (numpy dict) against the reference's
    ``ref`` for one mesh under the tie contract."""
    ref = {k: np.asarray(x) for k, x in ref.items()}
    face_r, face_o = ref["face"], np.asarray(out["face"])
    np.testing.assert_allclose(out["sqdist"], ref["sqdist"], atol=VALUE_TOL)
    np.testing.assert_allclose(out["point"], ref["point"], atol=VALUE_TOL)
    same = face_r == face_o
    np.testing.assert_array_equal(np.asarray(out["part"])[same],
                                  ref["part"][same])
    if not same.all():
        # the reference's own distance to the port's face
        vc = v.astype(np.float32) - v.astype(np.float32).mean(0)
        qc = q.astype(np.float32) - v.astype(np.float32).mean(0)
        tri = vc[f[face_o[~same]]]
        _, sq_o, _ = jpt.closest_point_on_triangle(
            qc[~same], tri[:, 0], tri[:, 1], tri[:, 2])
        gap = np.abs(np.asarray(sq_o) - ref["sqdist"][~same])
        assert gap.max() <= TIE_TOL, gap.max()
    return same.mean()


def _np(res):
    return {k: v.numpy() for k, v in res.items()}


# -- point_triangle -----------------------------------------------------------

def _part_probe_queries():
    """A triangle and queries reaching every CGAL part code."""
    a, b, c = np.array([0.0, 0, 0]), np.array([1.0, 0, 0]), np.array([0.0, 1, 0])
    q = np.array([
        [0.2, 0.2, 0.5],     # interior
        [0.5, -0.5, 0.1],    # edge ab
        [0.8, 0.8, -0.2],    # edge bc
        [-0.5, 0.5, 0.3],    # edge ca
        [-0.5, -0.5, 0.0],   # vertex a
        [1.5, -0.2, 0.1],    # vertex b
        [-0.2, 1.5, 0.1],    # vertex c
    ])
    return q, a, b, c


def test_closest_point_on_triangle_all_parts_and_degenerate():
    q, a, b, c = _part_probe_queries()
    rng = np.random.RandomState(1)
    q = np.vstack([q, rng.randn(64, 3)]).astype(np.float32)
    tris = [(a, b, c), (a, a, b), (a, b, (a + b) / 2.0),
            (a, b + 1e-9, 2 * b)]          # regular, zero-area, collinear x2
    parts_seen = set()
    for ta, tb, tc in tris:
        ta, tb, tc = (np.broadcast_to(np.asarray(x, np.float32), q.shape)
                      for x in (ta, tb, tc))
        rp, rs, rpart = jpt.closest_point_on_triangle(q, ta, tb, tc)
        op, os_, opart = tpt.closest_point_on_triangle(
            *(torch.from_numpy(np.array(x)) for x in (q, ta, tb, tc)))
        # same float32 formula on both sides: agreement to rounding
        np.testing.assert_allclose(op.numpy(), np.asarray(rp), atol=1e-6)
        np.testing.assert_allclose(os_.numpy(), np.asarray(rs), atol=1e-6)
        np.testing.assert_array_equal(opart.numpy(), np.asarray(rpart))
        parts_seen |= set(opart.numpy().tolist())
    assert parts_seen == set(range(7))


def test_barycentric_matches_reference():
    rng = np.random.RandomState(2)
    p, a, b, c = (rng.randn(200, 3).astype(np.float32) for _ in range(4))
    rb, rpart = jpt.closest_point_barycentric(p, a, b, c)
    ob, opart = tpt.closest_point_barycentric(
        *(torch.from_numpy(x) for x in (p, a, b, c)))
    # barycentric coordinates of well-shaped random triangles: rounding only
    np.testing.assert_allclose(ob.numpy(), np.asarray(rb), atol=1e-5)
    np.testing.assert_array_equal(opart.numpy(), np.asarray(rpart))


# -- the closest_faces kernel's plain version vs the Pallas kernel -------------

@pytest.mark.parametrize("variant,tail", VARIANTS)
def test_closest_point_kernel_matches_pallas(variant, tail):
    v, f = small_body(seed=3)
    q = (np.random.RandomState(4).randn(96, 3) * 0.4).astype(np.float32)
    ref = closest_point_pallas(v, f, q, tile_q=32, tile_f=128,
                               interpret=True, assume_nondegenerate=not tail,
                               tile_variant=variant)
    out = ck.closest_point_kernel(
        torch.from_numpy(v), torch.from_numpy(f), torch.from_numpy(q),
        assume_nondegenerate=not tail, tile_variant=variant)
    assert out["face"].dtype == torch.int32 and out["part"].dtype == torch.int32
    assert tuple(out["point"].shape) == (96, 3)
    assert assert_tie_contract(ref, _np(out), v, f, q) > 0.5


@pytest.mark.parametrize("variant", ["fast", "safe"])
def test_degenerate_tail_matches_pallas(variant):
    rng = np.random.RandomState(5)
    v, f, q = with_degenerate_faces(*small_body(seed=5), rng)
    assert not ck.mesh_is_nondegenerate(v, f)
    ref = closest_point_pallas(v, f, q, tile_q=32, tile_f=128,
                               interpret=True, tile_variant=variant)
    out = ck.closest_point_kernel(torch.from_numpy(v), torch.from_numpy(f),
                                  torch.from_numpy(q), tile_variant=variant)
    assert_tie_contract(ref, _np(out), v, f, q)
    # and the reconstruction-form scan, which needs no degenerate tail
    scan = _np(closest_faces_and_points(v, f, q, device="cpu"))
    np.testing.assert_allclose(out["sqdist"].numpy(), scan["sqdist"],
                               atol=VALUE_TOL)


def test_closest_point_kernel_smpl_size():
    """One full SMPL-sized mesh (13776 faces), few queries."""
    from mesh_tpu.models.body_model import smpl_sized_sphere

    v, f = smpl_sized_sphere()
    v = (v * np.array([0.3, 0.2, 0.9])).astype(np.float32)
    f = f.astype(np.int32)
    q = (np.random.RandomState(6).randn(48, 3) * 0.4).astype(np.float32)
    ref = closest_point_pallas(v, f, q, tile_q=16, tile_f=2048,
                               interpret=True, assume_nondegenerate=True)
    out = ck.closest_point_kernel(torch.from_numpy(v), torch.from_numpy(f),
                                  torch.from_numpy(q),
                                  assume_nondegenerate=True)
    assert_tie_contract(ref, _np(out), v, f, q)


def test_batched_kernel_matches_per_mesh():
    """A [B, V, 3] batch is one argmin over the batch dimension: each mesh's
    answer is the single-mesh answer."""
    rng = np.random.RandomState(7)
    vs = np.stack([small_body(seed=s)[0] for s in range(3)])
    f = small_body()[1]
    qs = (rng.randn(3, 40, 3) * 0.4).astype(np.float32)
    batch = _np(ck.closest_point_kernel(torch.from_numpy(vs),
                                        torch.from_numpy(f),
                                        torch.from_numpy(qs)))
    for b in range(3):
        one = _np(ck.closest_point_kernel(torch.from_numpy(vs[b]),
                                          torch.from_numpy(f),
                                          torch.from_numpy(qs[b])))
        assert_tie_contract(one, {k: x[b] for k, x in batch.items()},
                            vs[b], f, qs[b])


def test_plain_argmin_chunking_is_exact(monkeypatch):
    """Chunking the plain version over queries and meshes changes nothing."""
    rng = np.random.RandomState(8)
    vs = np.stack([small_body(seed=s)[0] for s in range(2)])
    f = small_body()[1]
    qs = (rng.randn(2, 50, 3) * 0.4).astype(np.float32)
    pts, planes, _, _ = ck.closest_point_operands(
        torch.from_numpy(vs), torch.from_numpy(f), torch.from_numpy(qs))
    whole = ck.argmin_faces_plain(pts, planes)
    monkeypatch.setitem(ck._PLAIN_PAIRS, "cpu", 7 * f.shape[0] + 3)
    assert torch.equal(ck.argmin_faces_plain(pts, planes), whole)


def test_plain_scan_matches_reference_scan():
    v, f = small_body(seed=9)
    q = (np.random.RandomState(9).randn(70, 3) * 0.5).astype(np.float32)
    ref = jax_scan(v, f, q, chunk=32)
    out = _np(closest_faces_and_points(v, f, q, chunk=32, device="cpu"))
    assert_tie_contract(ref, out, v, f, q)


def test_auto_matches_pallas():
    v, f = small_body(seed=10)
    q = (np.random.RandomState(10).randn(64, 3) * 0.4).astype(np.float32)
    ref = closest_point_pallas(v, f, q, tile_q=32, tile_f=128,
                               interpret=True, assume_nondegenerate=True)
    out = closest_faces_and_points_auto(v, f, q, device="cpu")
    assert set(out) == {"face", "part", "point", "sqdist"}
    assert all(isinstance(x, np.ndarray) for x in out.values())
    assert_tie_contract(ref, out, v, f, q)


# -- nearest vertices ------------------------------------------------------------

def test_nearest_vertices_matches_pallas():
    v, _ = small_body(seed=11)
    q = (np.random.RandomState(11).randn(100, 3) * 0.6).astype(np.float32)
    i_ref, d_ref = nearest_vertices_pallas(v, q, tile_q=32, tile_v=64,
                                           interpret=True)
    i_out, d_out = closest_vertices_with_distance(v, q, device="cpu")
    assert i_out.dtype == torch.int32
    # distances: same float32 formula after centering, to rounding
    np.testing.assert_allclose(d_out.numpy(), np.asarray(d_ref), atol=1e-6)
    same = i_out.numpy() == np.asarray(i_ref)
    assert same.mean() > 0.9
    np.testing.assert_array_equal(closest_vertices(v, q, device="cpu").numpy(),
                                  i_out.numpy())


def test_nearest_vertices_batched_and_ties():
    """Exact ties keep the lowest index, as the reference's strict-< merge."""
    v = np.array([[1.0, 0, 0], [-1.0, 0, 0], [1.0, 0, 0]], np.float32)
    q = np.array([[0.0, 0, 0], [2.0, 0, 0]], np.float32)
    idx, dist = ck.nearest_vertices_kernel(torch.from_numpy(v),
                                           torch.from_numpy(q))
    assert idx.tolist() == [0, 0]
    np.testing.assert_allclose(dist.numpy(), [1.0, 1.0], atol=1e-6)
    idx_b, _ = ck.nearest_vertices_kernel(torch.from_numpy(np.stack([v, -v])),
                                          torch.from_numpy(np.stack([q, -q])))
    assert idx_b.tolist() == [[0, 0], [0, 0]]


# -- staging, wrappers, build ----------------------------------------------------

def test_mesh_is_nondegenerate_matches_reference(monkeypatch):
    rng = np.random.RandomState(12)
    v, f = small_body(seed=12)
    v2, f2, _ = with_degenerate_faces(v, f, rng)
    for vv, ff in ((v, f), (v2, f2)):
        assert ck.mesh_is_nondegenerate(vv, ff) == jax_nondegenerate(vv, ff)
    assert ck.mesh_is_nondegenerate(v, f) and not ck.mesh_is_nondegenerate(v2, f2)
    monkeypatch.setenv("MESH_TPU_SAFE_TILES", "1")
    assert not ck.mesh_is_nondegenerate(v, f)


def test_tile_rows_match_reference():
    from mesh_tpu.query import pallas_closest as jpc

    v, f = small_body(seed=13)
    tri = (v - v.mean(0))[f]
    for name in ("fast_tile_rows", "safe_tile_rows"):
        ref = getattr(jpc, name)(tri)
        out = getattr(ck, name)(torch.from_numpy(tri))
        assert len(out) == len(ref) == ck.N_FACE_ROWS
        for r, o in zip(ref, out):
            # per-face sums of three products and reciprocals: rounding only
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6,
                                       atol=1e-7)


def test_wrappers_reject_bad_operands():
    v, f = small_body()
    pts, planes, _, _ = ck.closest_point_operands(
        torch.from_numpy(v)[None], torch.from_numpy(f),
        torch.zeros(1, 4, 3))
    with pytest.raises(ValueError):
        ck.argmin_faces(pts.double(), planes)
    with pytest.raises(ValueError):
        ck.argmin_faces(pts, planes[:, :18])
    with pytest.raises(ValueError):
        ck.argmin_faces(pts.to("meta"), planes.to("meta"))
    with pytest.raises(ValueError):
        ck.closest_point_kernel(torch.from_numpy(v), torch.from_numpy(f),
                                torch.zeros(4, 3), tile_variant="exact")


def test_cpu_tensors_take_the_plain_version():
    v, f = small_body()
    before = dict(ck.LAUNCHES)
    out = ck.closest_point_kernel(torch.from_numpy(v), torch.from_numpy(f),
                                  torch.zeros(5, 3))
    plain = ck.closest_point_plain(torch.from_numpy(v), torch.from_numpy(f),
                                   torch.zeros(5, 3))
    assert torch.equal(out["face"], plain["face"])
    assert ck.LAUNCHES == before


def test_kernel_build_flags_and_sources(monkeypatch):
    assert "--fmad=false" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    for name, (source, entry, _) in _build.KERNELS.items():
        text = open(os.path.join(_build._CSRC, source)).read()
        assert 'extern "C" int %s(' % entry in text
        assert "Replaces: mesh_tpu/" in text
        path = _build._library_path(name)
        assert path == _build._library_path(name)
        assert path.startswith(_build.BUILD_DIR)
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build, "TOOLKIT_NVCC", os.path.join(root_dir(), "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()


def root_dir():
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_neither_jax_nor_mesh_tpu():
    root = root_dir()
    files = [os.path.join(root, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(root, "mesh_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in ("jax", "jaxlib", "mesh_tpu"), (path, mod)
