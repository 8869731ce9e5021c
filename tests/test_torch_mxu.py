"""mesh_tpu_torch's MXU rung (dense scan, bf16 bound pass, f32 exact repair)
vs mesh_tpu, on the CPU.

Inputs come from numpy RandomState seeds.  The JAX side runs
``closest_point_pallas_mxu`` / ``closest_point_pallas_mxu_repair`` and the
bound kernel ``_mxu_bound_kernel`` in interpret mode with small tiles
(tile_q 64, tile_f 256), as tests/test_mxu.py does; the port runs the
kernels' plain versions, which is what a CPU tensor selects.

Contracts: the port's answers hold to the reference's under the tie
contract of test_torch_closest (faces equal except at exact-distance ties
within 1e-6, points and sqdist within 1e-5, parts equal where faces are);
the bound pass's ub and cert agree with the JAX kernel's within the float32
rounding of their different summation orders (1e-6 of p2 + max a2 for ub,
1e-6 of 1 + its square root for cert); the repair equals the dense scan
bit for bit;
the screen keeps the exact float64 winner; the repaired tiles equal the
JAX kernel's except on blocks whose decision is borderline within that
rounding.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mesh_tpu.query import pallas_closest as pc
from mesh_tpu.query import point_triangle as jpt
from mesh_tpu.query.closest_point import closest_faces_and_points as jax_scan
from mesh_tpu.sphere import _icosphere
from mesh_tpu.utils.jax_compat import tpu_compiler_params

from mesh_tpu_torch import Mesh
from mesh_tpu_torch.accel.traverse import closest_faces_and_points_accel
from mesh_tpu_torch.obs.metrics import REGISTRY
from mesh_tpu_torch.query import autotune
from mesh_tpu_torch.query import closest_kernel as ck
from mesh_tpu_torch.query import culled as tculled
from mesh_tpu_torch.query import mxu_kernel as mk
from mesh_tpu_torch.query.closest_point import closest_faces_and_points_t
from mesh_tpu_torch.utils import knobs

from .test_torch_closest import (
    TIE_TOL,
    VALUE_TOL,
    small_body,
    with_degenerate_faces,
)

torch.set_num_threads(2)

TILES = {"tile_q": 64, "tile_f": 256}
#: relative rounding band of the bound pass across the two packages
BOUND_REL = 1e-6

_MXU_KNOBS = ("MESH_TPU_MXU", "MESH_TPU_MXU_BF16",
              "MESH_TPU_MXU_CROSSOVER_FACES", "MESH_TPU_SAFE_TILES",
              "MESH_TPU_BRUTE_MAX_FACES", "MESH_TPU_ACCEL_MIN_FACES",
              "MESH_TPU_NO_ACCEL")


@pytest.fixture
def clean_knobs(monkeypatch):
    for name in _MXU_KNOBS:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def icosphere(sub=3):
    v, f = _icosphere(sub)
    return np.asarray(v, np.float32), np.asarray(f, np.int32)


def degenerate_mesh():
    """icosphere(2) with every 7th face collapsed to an edge (the
    reference's tests/test_mxu.py mesh)."""
    v, f = icosphere(2)
    f = f.copy()
    f[::7, 2] = f[::7, 1]
    return v, f


def scattered(n, seed=0, spread=0.8):
    return (np.random.RandomState(seed).randn(n, 3) * spread).astype(
        np.float32)


def clustered(n, seed=1):
    """Surface-proximal clusters, the workload the bf16 screen prunes."""
    rng = np.random.RandomState(seed)
    dirs = rng.randn(4, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    q = np.repeat(dirs * 1.005, n // 4, axis=0)
    return (q + 0.002 * rng.randn(q.shape[0], 3)).astype(np.float32)


MESHES = {"icosphere": (lambda: icosphere(3), True),
          "degenerate": (degenerate_mesh, False)}
QUERIES = {"scattered": lambda: scattered(200, seed=6),
           "clustered": lambda: clustered(200, seed=3)}

#: JAX results computed once per (mesh, queries, entry)
_JAX = {}


def case(mesh, queries):
    make, nondegen = MESHES[mesh]
    v, f = make()
    return v, f, QUERIES[queries](), nondegen


def jax_result(mesh, queries, entry):
    key = (mesh, queries, entry)
    if key not in _JAX:
        v, f, q, nondegen = case(mesh, queries)
        if entry == "dense":
            _JAX[key] = pc.closest_point_pallas_mxu(
                v, f, q, interpret=True, assume_nondegenerate=nondegen,
                **TILES), None
        elif entry == "repair":
            _JAX[key] = pc.closest_point_pallas_mxu_repair(
                v, f, q, interpret=True, assume_nondegenerate=nondegen,
                with_stats=True, **TILES)
        else:
            _JAX[key] = jax_bound(v, f, q, **TILES)
    return _JAX[key]


def jax_bound(v, f, q, tile_q, tile_f):
    """(ub [Qp], cert [Qp, n_tiles]) of the reference's bound kernel, run
    as _mxu_repair_staged runs it."""
    center, _, _, planes, ga, reach = pc._mxu_staged_inputs(v, f, tile_f)
    p = pc._pad_rows(jnp.asarray(q, jnp.float32) - center, tile_q, 0.0)
    p2 = jnp.sum(p * p, axis=-1, keepdims=True)
    q_pad, f_pad = p.shape[0], planes[0].shape[1]
    bound_tf = max(m * tile_f for m in (1, 2, 4) if f_pad % (m * tile_f) == 0)
    ub, cert = pl.pallas_call(
        pc._mxu_bound_kernel,
        grid=(q_pad // tile_q, f_pad // bound_tf),
        in_specs=[
            pl.BlockSpec((tile_q, 3), lambda i, j: (i, 0)),
            pl.BlockSpec((tile_q, 1), lambda i, j: (i, 0)),
            pl.BlockSpec((3, bound_tf), lambda i, j: (0, j)),
            pl.BlockSpec((1, bound_tf), lambda i, j: (0, j)),
            pl.BlockSpec((1, bound_tf), lambda i, j: (0, j)),
        ],
        out_specs=[
            pl.BlockSpec((tile_q, 1), lambda i, j: (i, 0)),
            pl.BlockSpec((tile_q, bound_tf // tile_f), lambda i, j: (i, j)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((q_pad, 1), jnp.float32),
            jax.ShapeDtypeStruct((q_pad, f_pad // tile_f), jnp.float32),
        ],
        scratch_shapes=[pltpu.VMEM((tile_q, 1), jnp.float32)],
        compiler_params=tpu_compiler_params(dimension_semantics=pc.DIMSEM_QF),
        interpret=True,
    )(p, p2, ga, planes[3], reach)
    return np.asarray(ub)[:, 0], np.asarray(cert)


def port_bound(v, f, q, tile_q, tile_f):
    p, rec, _, _, _ = mk.mxu_operands(v, f, q, tile_q, device="cpu")
    ub, cert = mk.mxu_bound(p, rec, tile_f)
    return p, rec, ub, cert


def _np(res):
    return {k: x.numpy() for k, x in res.items()}


#: the corners each CGAL part code names: interior, edges ab bc ca,
#: vertices a b c
_PART_CORNERS = [(0, 1, 2), (0, 1), (1, 2), (2, 0), (0,), (1,), (2,)]


def part_elements(f, faces, parts):
    """The mesh element each (face, part) names, as a sorted tuple of
    vertex ids padded with -1: on a face with two equal corners, edges ab
    and ca are one segment, and the two codes name one element."""
    out = np.full((len(faces), 3), -1, np.int64)
    for i, (face, part) in enumerate(zip(faces, parts)):
        ids = sorted(set(int(f[face, k]) for k in _PART_CORNERS[part]))
        out[i, :len(ids)] = ids
    return out


def assert_mxu_contract(ref, out, v, f, q):
    """The tie contract of test_torch_closest with points held where they
    are defined: sqdist within 1e-5 everywhere; where the faces agree,
    points within 1e-5 and parts that name the same mesh element; where
    they differ, the two faces
    within 1e-6 by the reference's own distances, and the port's point
    within 1e-5 of the reference's closest point on the port's face (two
    tied faces have different closest points).  Returns the share of
    equal faces."""
    ref = {k: np.asarray(x) for k, x in ref.items()}
    out = {k: np.asarray(x) for k, x in out.items()}
    np.testing.assert_allclose(out["sqdist"], ref["sqdist"], atol=VALUE_TOL)
    same = ref["face"] == out["face"]
    np.testing.assert_allclose(out["point"][same], ref["point"][same],
                               atol=VALUE_TOL)
    np.testing.assert_array_equal(
        part_elements(f, ref["face"][same], out["part"][same]),
        part_elements(f, ref["face"][same], ref["part"][same]))
    if not same.all():
        center = v.astype(np.float32).mean(0)
        tri = (v.astype(np.float32) - center)[f[out["face"][~same]]]
        point, sq, _ = jpt.closest_point_on_triangle(
            q[~same] - center, tri[:, 0], tri[:, 1], tri[:, 2])
        gap = np.abs(np.asarray(sq) - ref["sqdist"][~same])
        assert gap.max() <= TIE_TOL, gap.max()
        np.testing.assert_allclose(out["point"][~same],
                                   np.asarray(point) + center, atol=VALUE_TOL)
    return same.mean()


# -- port vs the JAX kernels --------------------------------------------------

@pytest.mark.parametrize("entry", ["dense", "repair"])
@pytest.mark.parametrize("queries", sorted(QUERIES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_matches_jax_kernel(mesh, queries, entry):
    v, f, q, nondegen = case(mesh, queries)
    ref, ref_stats = jax_result(mesh, queries, entry)
    if entry == "dense":
        out = mk.closest_point_mxu_kernel(v, f, q, device="cpu",
                                          assume_nondegenerate=nondegen,
                                          **TILES)
    else:
        out, stats = mk.closest_point_mxu_repair_kernel(
            v, f, q, device="cpu", assume_nondegenerate=nondegen,
            with_stats=True, **TILES)
        assert stats["screened"] == ref_stats["screened"]
    same = assert_mxu_contract(ref, _np(out), v, f, q)
    assert same > 0.8


def _margins(ub, cert, tile_q):
    """Per (query tile, face tile): min over the tile's queries of
    cert - sqrt(max(ub, 0)), the block's screen decision being <= 0."""
    su = np.sqrt(np.maximum(np.asarray(ub, np.float32), np.float32(0.0)))
    m = np.asarray(cert, np.float64) - su.astype(np.float64)[:, None]
    return m.reshape(-1, tile_q, m.shape[1]).min(axis=1)


@pytest.mark.parametrize("queries", sorted(QUERIES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_bound_matches_jax_kernel(mesh, queries):
    v, f, q, _ = case(mesh, queries)
    ub_j, cert_j = jax_result(mesh, queries, "bound")
    p, rec, ub, cert = port_bound(v, f, q, **TILES)
    assert ub.shape == ub_j.shape and cert.shape == cert_j.shape
    p2 = (p.double() ** 2).sum(-1).numpy()
    tol = BOUND_REL * (p2 + float(rec[:, 15].max()))
    np.testing.assert_array_less(np.abs(ub.numpy() - ub_j), tol + 1e-30)
    tol_c = BOUND_REL * (1.0 + np.sqrt(p2 + float(rec[:, 15].max())))
    np.testing.assert_array_less(np.abs(cert.numpy() - cert_j),
                                 np.broadcast_to(tol_c[:, None],
                                                 cert_j.shape))


@pytest.mark.parametrize("queries", sorted(QUERIES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_repaired_tiles_match_jax_except_borderline(mesh, queries):
    v, f, q, _ = case(mesh, queries)
    ub_j, cert_j = jax_result(mesh, queries, "bound")
    _, ref_stats = jax_result(mesh, queries, "repair")
    p, rec, ub, cert = port_bound(v, f, q, **TILES)
    m_j = _margins(ub_j, cert_j, TILES["tile_q"])
    m_p = _margins(ub, cert, TILES["tile_q"])
    # the reference's own decisions reproduce its kernel's count
    assert int((m_j <= 0).sum()) == ref_stats["repaired"]
    surv = mk.survivors(ub, cert, TILES["tile_q"]).numpy()
    np.testing.assert_array_equal(surv, m_p <= 0)
    p2 = (p.double() ** 2).sum(-1).numpy()
    band = 2 * BOUND_REL * (1.0 + np.sqrt(p2.max()
                                          + float(rec[:, 15].max())))
    borderline = (np.abs(m_j) <= band) | (np.abs(m_p) <= band)
    assert borderline.mean() < 0.2
    np.testing.assert_array_equal(surv[~borderline], (m_j <= 0)[~borderline])
    _, stats = mk.closest_point_mxu_repair_kernel(
        v, f, q, device="cpu", with_stats=True, **TILES)
    assert stats["screened"] == ref_stats["screened"] == surv.size
    assert stats["repaired"] == int(surv.sum())
    if (mesh, queries) == ("icosphere", "clustered"):
        assert 0 < stats["repaired"] < stats["screened"]


# -- the port's own promises --------------------------------------------------

REPAIR_CASES = {
    "icosphere-scattered": lambda: (*icosphere(3), scattered(200), True),
    "icosphere-clustered": lambda: (*icosphere(4), clustered(256), True),
    "degenerate": lambda: (*degenerate_mesh(), scattered(150, 4, 1.2), False),
    "planted-body": lambda: (*with_degenerate_faces(
        *small_body(3), np.random.RandomState(3)), False),
}


@pytest.mark.parametrize("tiles", [(64, 128), (64, 256), (256, 2048)])
@pytest.mark.parametrize("name", sorted(REPAIR_CASES))
def test_repair_bit_identical_to_dense(name, tiles):
    v, f, q, nondegen = REPAIR_CASES[name]()
    tile_q, tile_f = tiles
    kw = dict(tile_q=tile_q, tile_f=tile_f, device="cpu",
              assume_nondegenerate=nondegen)
    dense = mk.closest_point_mxu_kernel(v, f, q, **kw)
    rep, stats = mk.closest_point_mxu_repair_kernel(v, f, q, with_stats=True,
                                                    **kw)
    for key in ("face", "part", "point", "sqdist"):
        assert torch.equal(dense[key], rep[key]), key
    assert 0 < stats["repaired"] <= stats["screened"]
    # the nondegenerate flag on a mesh that passes the check changes nothing
    if nondegen:
        tail = mk.closest_point_mxu_kernel(
            v, f, q, tile_q=tile_q, tile_f=tile_f, device="cpu")
        assert torch.equal(tail["face"], dense["face"])


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_survivor_set_contains_exact_winner(scale):
    """Every query's exact float64 winner lies in a face tile whose
    certificate passes that query's own screen (the reference's
    adversarial near-tie queries: edge midpoints, vertices, the center)."""
    v, f = icosphere(2)
    v64 = v.astype(np.float64) * scale
    rng = np.random.RandomState(0)
    mids = 0.5 * (v64[f[:24, 0]] + v64[f[:24, 1]])
    q = np.concatenate([mids, v64[:24], np.zeros((4, 3)),
                        mids[:12] + 1e-6 * scale * rng.randn(12, 3)])
    winner = closest_faces_and_points_t(
        torch.from_numpy(v64), torch.from_numpy(f),
        torch.from_numpy(q))["face"].numpy()
    _, _, ub, cert = port_bound(v64.astype(np.float32), f,
                                q.astype(np.float32), 64, 128)
    su = torch.sqrt(torch.clamp_min(ub, 0.0))[:q.shape[0]]
    kept = (cert[np.arange(q.shape[0]), winner // 128] <= su).numpy()
    assert kept.all(), np.nonzero(~kept)[0]


@pytest.mark.parametrize("scale", [1e-2, 1e-1, 1.0, 1e1, 1e2, 1e3])
def test_envelope_covers_bf16_rounding(scale):
    """|ap2~ - ap2| <= E = 2^-6 (p2 + a2) against the float64 corner
    distance, for random operands at each scale (the certificate the
    reference's derivation promises, on the port's bf16 rounding)."""
    rng = np.random.RandomState(11)
    p = torch.from_numpy((rng.randn(256, 3) * scale).astype(np.float32))
    a = torch.from_numpy((rng.randn(512, 3) * scale).astype(np.float32))
    cols = [None] * mk.MXU_RECORD
    cols[9], cols[10], cols[11] = a[None, :, 0], a[None, :, 1], a[None, :, 2]
    cols[15] = (a * a).sum(-1)[None]
    ap2t, env = mk._mxu_ap2_env(p, cols)
    exact = ((p.double()[:, None, :] - a.double()[None]) ** 2).sum(-1)
    slack = env.double() - (ap2t.double() - exact).abs()
    assert float(slack.min()) >= 0.0


def test_face_cache_hit_and_bounded(monkeypatch):
    monkeypatch.setattr(mk, "_MXU_FACE_CACHE", {})
    v, f = icosphere(2)
    cpu = torch.device("cpu")
    first = mk._mxu_staged_inputs(v, f, cpu)
    assert mk._mxu_staged_inputs(v, f, cpu) is first
    assert mk._mxu_staged_inputs(torch.from_numpy(v), torch.from_numpy(f),
                                 cpu) is first
    assert mk._mxu_staged_inputs(v * 1.5, f, cpu) is not first
    for i in range(mk._MXU_FACE_CACHE_MAX + 2):
        mk._mxu_staged_inputs(v * (2.0 + i), f, cpu)
    assert len(mk._MXU_FACE_CACHE) == mk._MXU_FACE_CACHE_MAX
    assert mk._mxu_staged_inputs(v, f, cpu) is not first


def test_face_record_layout():
    """The record's columns are the reference's G operand and planes."""
    v, f = icosphere(1)
    center, tri, rec = mk._mxu_staged_inputs(v, f, torch.device("cpu"))
    ref_c, ref_tri, g, planes, ga, reach = pc._mxu_staged_inputs(v, f, 128)
    n_f = f.shape[0]
    np.testing.assert_allclose(center[0, 0].numpy(), np.asarray(ref_c),
                               atol=1e-7)
    # g is (xyz, tile, op, col); reorder to (op, tile, col, xyz)
    groups = np.asarray(g).reshape(3, -1, 4, 128)
    ops = np.moveaxis(groups, 0, -1).transpose(1, 0, 2, 3)
    ops = ops.reshape(4, -1, 3)[:, :n_f]
    np.testing.assert_allclose(rec[:, :12].numpy(),
                               np.concatenate(list(ops), axis=-1), atol=1e-6)
    for k, plane in enumerate(planes):
        np.testing.assert_allclose(rec[:, 12 + k].numpy(),
                                   np.asarray(plane)[0, :n_f], rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(rec[:, 23].numpy(), np.asarray(reach)[0, :n_f],
                               rtol=1e-6)


def test_wrappers_reject_bad_devices_and_operands():
    v, f = icosphere(1)
    q = scattered(8)
    with pytest.raises(ValueError):
        mk.closest_point_mxu_kernel(v, f, q, device="meta")
    with pytest.raises(ValueError):
        mk.closest_point_mxu_repair_kernel(v, f, q, device="meta")
    p, rec, _, _, _ = mk.mxu_operands(v, f, q, 64, device="cpu")
    with pytest.raises(ValueError):
        mk.mxu_faces(p.to("meta"), rec.to("meta"), 64)
    with pytest.raises(ValueError):
        mk.mxu_bound(p.to("meta"), rec.to("meta"))
    with pytest.raises(ValueError):
        mk.mxu_faces(p, rec, tile_q=48)              # not a multiple of 32
    with pytest.raises(ValueError):
        mk.mxu_faces(p[:50].contiguous(), rec, 64)   # not padded to tile_q
    with pytest.raises(ValueError):
        mk.mxu_faces(p.double(), rec, 64)
    with pytest.raises(ValueError):
        mk.mxu_repair(p, rec, torch.zeros(64), torch.zeros(64, 2), 64, 128)
    with pytest.raises(ValueError):
        mk.closest_point_mxu_kernel(v, np.zeros((0, 3), np.int32), q,
                                    device="cpu")


def test_cpu_tensors_take_the_plain_version():
    v, f = icosphere(2)
    q = scattered(70)
    before = dict(mk.LAUNCHES)
    p, rec, _, _, _ = mk.mxu_operands(v, f, q, 64, device="cpu")
    assert torch.equal(mk.mxu_faces(p, rec, 64, 128),
                       mk.mxu_faces_plain(p, rec, 64, 128))
    ub, cert = mk.mxu_bound(p, rec, 128)
    ub_p, cert_p = mk.mxu_bound_plain(p, rec, 128)
    assert torch.equal(ub, ub_p) and torch.equal(cert, cert_p)
    got = mk.mxu_repair(p, rec, ub, cert, 64, 128)
    want = mk.mxu_repair_plain(p, rec, ub, cert, 64, 128)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert mk.LAUNCHES == before


def test_bound_minima_propagate_nan():
    v, f = icosphere(2)
    p, rec, _, _, _ = mk.mxu_operands(v, f, scattered(64), 64, device="cpu")
    rec = rec.clone()
    rec[5, 15] = float("nan")                        # a2 of face 5
    ub, cert = mk.mxu_bound(p, rec, 128)
    assert bool(ub.isnan().all())
    assert bool(cert[:, 0].isnan().all())
    assert not bool(cert[:, 1:].isnan().any())


# -- routing, knobs, thresholds ----------------------------------------------

def test_knob_predicates(clean_knobs):
    assert not knobs.mxu_enabled() and not knobs.mxu_bf16_enabled()
    clean_knobs.setenv("MESH_TPU_MXU", "1")
    clean_knobs.setenv("MESH_TPU_MXU_BF16", "off")
    assert knobs.mxu_enabled() and not knobs.mxu_bf16_enabled()
    clean_knobs.setenv("MESH_TPU_MXU_BF16", "yes")
    assert knobs.mxu_bf16_enabled()


def test_mxu_crossover_faces(clean_knobs):
    clean_knobs.setattr(autotune, "_mxu_measured", None)
    assert autotune.mxu_crossover_faces() == autotune.MXU_DEFAULT_CROSSOVER
    clean_knobs.setenv("MESH_TPU_MXU_CROSSOVER_FACES", "1234")
    assert autotune.mxu_crossover_faces() == 1234
    clean_knobs.setenv("MESH_TPU_MXU_CROSSOVER_FACES", "many")
    assert autotune.mxu_crossover_faces() == autotune.MXU_DEFAULT_CROSSOVER


def test_calibrate_mxu_crossover_saves_per_device(clean_knobs, tmp_path):
    clean_knobs.setattr(autotune, "_mxu_measured", None)
    clean_knobs.setattr(autotune, "CACHE_DIR", str(tmp_path))
    got = autotune.calibrate_mxu_crossover(ladder=(80, 320), n_queries=64,
                                           reps=1, tile_q=64, tile_f=128,
                                           device="cpu")
    rec = autotune.MXU_CALIBRATION
    assert got == rec["mxu_crossover_faces"] == autotune.mxu_crossover_faces()
    faces = [autotune._sphere_mesh(n)[1].shape[0] for n in (80, 320)]
    assert [row["faces"] for row in rec["ladder"]] == faces
    assert got in (*faces, 2 * faces[-1])
    path = tmp_path / "mxu_crossover_cpu_cpu.json"
    assert path.exists() == rec["stable"]


@pytest.mark.parametrize("bf16", [False, True])
def test_auto_routes_mxu_above_crossover(clean_knobs, bf16):
    v, f = icosphere(3)                               # 1280 faces
    q = clustered(128, seed=2)
    clean_knobs.setenv("MESH_TPU_MXU", "1")
    clean_knobs.setenv("MESH_TPU_MXU_CROSSOVER_FACES", "1024")
    if bf16:
        clean_knobs.setenv("MESH_TPU_MXU_BF16", "1")
    series = REGISTRY.counter("mesh_tpu_query_mxu_repair_total")
    before = {o: series.value(kind="dense", outcome=o)
              for o in ("repaired", "skipped")}
    tculled.STRATEGY.clear()
    out = tculled.closest_faces_and_points_auto(v, f, q, device="cpu")
    assert tculled.STRATEGY == {"mxu": 1}
    direct, stats = mk.closest_point_mxu_repair_kernel(
        v, f, q, assume_nondegenerate=True, with_stats=True, device="cpu")
    for key in ("face", "part", "point", "sqdist"):
        assert np.array_equal(out[key], direct[key].numpy())
    delta = {o: series.value(kind="dense", outcome=o) - before[o]
             for o in before}
    if bf16:
        assert delta == {"repaired": stats["repaired"],
                         "skipped": stats["screened"] - stats["repaired"]}
        assert stats["repaired"] > 0
    else:
        assert delta == {"repaired": 0, "skipped": 0}
    assert_mxu_contract(jax_scan(v, f, q), out, v, f, q)


@pytest.mark.parametrize("setting", ["unset", "off", "below_crossover",
                                     "above_brute_max", "safe_tiles"])
def test_auto_keeps_pre_mxu_path(clean_knobs, setting):
    """With the knob off, below the MXU crossover, above the brute-force
    ceiling or on the safe tile, auto answers exactly as without the knob
    (the reference's tests/test_mxu.py:319-346)."""
    v, f = icosphere(3)
    q = scattered(64, seed=5)
    if setting in ("above_brute_max", "safe_tiles"):
        clean_knobs.setenv("MESH_TPU_BRUTE_MAX_FACES", "1000")
    if setting == "safe_tiles":
        clean_knobs.setenv("MESH_TPU_SAFE_TILES", "1")
    tculled.STRATEGY.clear()
    want = tculled.closest_faces_and_points_auto(v, f, q, device="cpu")
    rung = dict(tculled.STRATEGY)
    assert "mxu" not in rung
    if setting != "unset":
        clean_knobs.setenv("MESH_TPU_MXU", "0" if setting == "off" else "1")
        clean_knobs.setenv("MESH_TPU_MXU_CROSSOVER_FACES",
                           "2000" if setting == "below_crossover" else "100")
    tculled.STRATEGY.clear()
    got = tculled.closest_faces_and_points_auto(v, f, q, device="cpu")
    assert tculled.STRATEGY == rung
    for key in ("face", "part", "point", "sqdist"):
        assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("setting", ["mxu", "off", "below_crossover"])
def test_bvh_rung_under_mxu(clean_knobs, setting):
    """Under the reference's condition for its MXU leaf visit (the knob on,
    F >= the MXU crossover) the BVH rung raises; otherwise it serves."""
    v, f = icosphere(3)
    q = scattered(32, seed=8)
    clean_knobs.setenv("MESH_TPU_ACCEL_MIN_FACES", "1000")
    clean_knobs.setenv("MESH_TPU_MXU_CROSSOVER_FACES",
                       "5000" if setting == "below_crossover" else "1000")
    if setting != "off":
        clean_knobs.setenv("MESH_TPU_MXU", "1")
    tculled.STRATEGY.clear()
    if setting == "mxu":
        with pytest.raises(NotImplementedError, match="Queue 2 item 1"):
            tculled.closest_faces_and_points_auto(v, f, q, device="cpu")
        with pytest.raises(NotImplementedError, match="MESH_TPU_MXU"):
            closest_faces_and_points_accel(v, f, q, device="cpu")
        return
    out = tculled.closest_faces_and_points_auto(v, f, q, device="cpu")
    assert tculled.STRATEGY == {"accel_bvh": 1}
    assert_mxu_contract(jax_scan(v, f, q), out, v, f, q)


@pytest.mark.parametrize("bf16", [False, True])
def test_mesh_facade_under_mxu(clean_knobs, bf16):
    """The slice end to end: ``Mesh.closest_faces_and_points`` on the MXU
    rung against the reference's scan, under the tie contract."""
    v, f = small_body(2, n_seg=24, n_ring=20)
    q = np.vstack([clustered(96, seed=4) * np.float32([0.3, 0.2, 0.9]),
                   scattered(64, seed=9, spread=0.4)]).astype(np.float32)
    clean_knobs.setenv("MESH_TPU_MXU", "1")
    clean_knobs.setenv("MESH_TPU_MXU_CROSSOVER_FACES", "500")
    if bf16:
        clean_knobs.setenv("MESH_TPU_MXU_BF16", "1")
    assert ck.mesh_is_nondegenerate(v, f)
    tculled.STRATEGY.clear()
    faces, points = Mesh(v, f, device="cpu").closest_faces_and_points(q)
    out = tculled.closest_faces_and_points_auto(v, f, q, device="cpu")
    assert tculled.STRATEGY == {"mxu": 2}
    assert faces.dtype == np.uint32 and faces.shape == (1, q.shape[0])
    assert np.array_equal(faces[0], out["face"].astype(np.uint32))
    assert np.array_equal(points, out["point"].astype(np.float64))
    assert_mxu_contract(jax_scan(v, f, q), out, v, f, q)
