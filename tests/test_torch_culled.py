"""mesh_tpu_torch's sphere-culled closest point and the auto ladder vs
mesh_tpu, on the CPU.

Inputs come from numpy RandomState seeds.  The JAX side runs
``closest_point_pallas_culled`` in interpret mode with small tiles
(tile_q 64, tile_f 256), as tests/test_pallas_culled.py does; the port runs
the kernel's plain version, which is what a CPU tensor selects.  Results
are held to the tie contract of test_torch_closest (faces equal except at
equidistant ties, points and sqdist to 1e-5); Morton orders are held to
equality.
"""

import functools

import numpy as np
import pytest
import torch

from mesh_tpu.query import autotune as jautotune
from mesh_tpu.query.culled import (
    closest_faces_and_points_auto as jax_auto,
)
from mesh_tpu.query.pallas_culled import (
    _prologue as jax_prologue,
    closest_point_pallas_culled,
)
from mesh_tpu.sphere import _icosphere

from mesh_tpu_torch.batch import batch_step
from mesh_tpu_torch.query import autotune, closest_kernel as ck
from mesh_tpu_torch.query import culled as tculled
from mesh_tpu_torch.query import culled_kernel as qk
from mesh_tpu_torch.query.closest_point import closest_point_dispatch

from .test_torch_closest import assert_tie_contract, with_degenerate_faces

torch.set_num_threads(2)

TILES = {"tile_q": 64, "tile_f": 256}

VARIANTS = [("fast", False), ("fast", True), ("safe", False), ("safe", True)]


def sphere(sub=3, seed=0, jitter=0.002):
    """An icosphere with slightly jittered vertices, float32 / int32."""
    v, f = _icosphere(sub)
    rng = np.random.RandomState(seed)
    v = np.asarray(v) + rng.randn(*np.shape(v)) * jitter
    return v.astype(np.float32), np.asarray(f, np.int32)


def surface_queries(v, f, n, seed, noise=0.02):
    """Surface-proximal queries: a random face, a random barycentric point
    and normal noise, as scan points are."""
    rng = np.random.RandomState(seed)
    w = rng.dirichlet([1.0, 1.0, 1.0], n)
    tri = v[f[rng.randint(0, f.shape[0], n)]]
    q = np.einsum("qk,qkx->qx", w, tri) + rng.randn(n, 3) * noise
    return q.astype(np.float32)


def _np(res):
    return {k: x.numpy() for k, x in res.items()}


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# -- prologue ---------------------------------------------------------------

def test_prologue_orders_match_reference():
    """Morton face and query orders, padded face ids and sorted rows equal
    the JAX prologue's; spheres and seeds agree to float32 rounding."""
    v, f = sphere(3, seed=1)
    q = surface_queries(v, f, 300, seed=1)
    vc = v - v.mean(0)
    pc = q - v.mean(0)
    ref = jax_prologue(vc, f, pc, 64, 256)
    vt, ft, pt = _t(vc, f, pc)
    out = qk._prologue(vt[None], ft, pt[None], 64, 256)
    for key in ("face_ids", "qorder", "tri_s", "pts_s"):
        np.testing.assert_array_equal(out[key][0].numpy(),
                                      np.asarray(ref[key]), err_msg=key)
    for key in ("fc", "fr", "qc", "qr"):
        # tile means of 64..768 points: float32 summation order only
        np.testing.assert_allclose(out[key][0].numpy(), np.asarray(ref[key]),
                                   atol=1e-6, err_msg=key)
    np.testing.assert_allclose(out["seed"][0].numpy(), np.asarray(ref["seed"]),
                               rtol=1e-5)


def test_morton_codes_match_reference_and_builder():
    from mesh_tpu.query.pallas_culled import _morton_codes as jax_codes
    from mesh_tpu_torch.accel import build as tbuild

    xyz = np.random.RandomState(2).randn(500, 3).astype(np.float32)
    ref = np.asarray(jax_codes(xyz)).astype(np.int64)
    np.testing.assert_array_equal(
        qk._morton_codes(torch.from_numpy(xyz)).numpy(), ref)
    np.testing.assert_array_equal(tbuild._morton_codes(xyz).astype(np.int64),
                                  ref)


def test_pad_rows_edge_repeats_real_rows():
    x = torch.arange(10).reshape(5, 2)
    padded = qk._pad_rows_edge(x, 4)
    assert padded.shape == (8, 2)
    assert torch.equal(padded[5:], x[4:].expand(3, 2))
    assert qk._pad_rows_edge(x, 5) is x


# -- the culled kernel's plain version vs the Pallas kernel -----------------

@functools.lru_cache(maxsize=None)
def _culled_case(variant, tail):
    """Two meshes of one topology with their queries, and mesh_tpu's
    batched culled answer for them (one interpret-mode compile per
    variant, shared by the single and batched cases)."""
    v, f = sphere(3, seed=10)
    q = surface_queries(v, f, 200, seed=20)
    if tail:   # planted zero-area and collinear faces, queries near them
        v, f, q_deg = with_degenerate_faces(v, f, np.random.RandomState(3))
        q = np.vstack([q, q_deg]).astype(np.float32)
    v1 = (v * 1.1 + np.float32(0.05)).astype(np.float32)
    vs = np.stack([v, v1])
    qs = np.stack([q, surface_queries(v1, f, q.shape[0], seed=21)])
    ref = closest_point_pallas_culled(vs, f, qs, interpret=True,
                                      assume_nondegenerate=not tail,
                                      tile_variant=variant, **TILES)
    return vs, f, qs, {k: np.asarray(x) for k, x in ref.items()}


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("variant,tail", VARIANTS)
def test_culled_matches_pallas(variant, tail, batched):
    """One mesh ([V, 3]) or the batch of two ([B, V, 3], one launch)
    against mesh_tpu's culled kernel on the same batch."""
    vs, f, qs, ref = _culled_case(variant, tail)
    n_b = 2 if batched else 1
    args = _t(vs, f, qs) if batched else _t(vs[0], f, qs[0])
    out = _np(qk.closest_point_culled_kernel(
        *args, assume_nondegenerate=not tail, tile_variant=variant, **TILES))
    if not batched:
        out = {k: x[None] for k, x in out.items()}
    assert out["face"].dtype == np.int32
    assert out["point"].shape == (n_b,) + qs.shape[1:]
    for b in range(n_b):
        assert assert_tie_contract({k: x[b] for k, x in ref.items()},
                                   {k: x[b] for k, x in out.items()},
                                   vs[b], f, qs[b]) > 0.5


def test_culled_skips_tiles_and_stays_exact():
    """On a finer mesh with surface-proximal queries some face tiles are
    skipped, and the answer is the brute-force answer up to ties."""
    v, f = sphere(4, seed=4)
    q = surface_queries(v, f, 1024, seed=4)
    vt, ft, qt = _t(v, f, q)
    ops = qk.culled_operands(vt[None], ft, qt[None], "fast", **TILES)
    best, visits, chunks, _ = qk.argmin_culled(ops, "fast", False,
                                               with_stats=True)
    n_tiles = ops["fsph"].shape[1]
    assert visits.shape == (1, ops["qsph"].shape[1])
    assert 0 < int(visits.max()) and int(visits.sum()) < visits.numel() * n_tiles
    # each warp tests at most its tile's visits x chunks per tile, and some
    # fewer
    per_tile = TILES["tile_f"] // qk.chunk_faces(TILES["tile_f"])
    assert chunks.shape == visits.shape + (TILES["tile_q"] // 32,)
    assert bool((chunks <= visits[..., None] * per_tile).all())
    assert int(chunks.sum()) < int(visits.sum()) * per_tile * chunks.shape[-1]
    res = _np(qk.culled_epilogue(ops, best))
    res = {k: x[0] for k, x in res.items()}
    brute = _np(ck.closest_point_kernel(vt, ft, qt, assume_nondegenerate=True))
    assert_tie_contract(brute, res, v, f, q)


def test_culled_cpu_takes_plain_and_rejects_bad_operands():
    v, f = sphere(2)
    q = surface_queries(v, f, 40, seed=5)
    before = dict(qk.LAUNCHES)
    vt, ft, qt = _t(v, f, q)
    out = qk.closest_point_culled_kernel(vt, ft, qt, **TILES)
    plain = qk.closest_point_culled_plain(vt, ft, qt, **TILES)
    assert all(torch.equal(out[k], plain[k]) for k in out)
    assert qk.LAUNCHES == before
    ops = qk.culled_operands(vt[None], ft, qt[None], "fast", **TILES)
    with pytest.raises(ValueError):
        qk.argmin_culled(dict(ops, seed=ops["seed"].double()))
    with pytest.raises(ValueError):
        qk.argmin_culled(dict(ops, tile_q=48))
    with pytest.raises(ValueError):
        qk.argmin_culled(ops, tile_variant="exact")


# -- routing ----------------------------------------------------------------

@pytest.fixture
def reference_defaults(monkeypatch, tmp_path):
    """The reference's autotune without any calibration in this process or
    on disk, so both packages resolve their thresholds from env + default."""
    missing = str(tmp_path / "none.json")
    monkeypatch.setattr(jautotune, "_measured", None)
    monkeypatch.setattr(jautotune, "_accel_measured", None)
    monkeypatch.setattr(jautotune, "_cache_path", lambda: missing)


@pytest.mark.parametrize("brute,accel", [
    (None, None), ("100", "5000"), ("0", "1"), ("abc", " "), ("", "12x"),
    ("65536", "131072"),
])
def test_crossovers_match_reference(monkeypatch, reference_defaults, brute,
                                    accel):
    for name, value in (("MESH_TPU_BRUTE_MAX_FACES", brute),
                        ("MESH_TPU_ACCEL_MIN_FACES", accel)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    assert autotune.crossover_faces() == jautotune.crossover_faces()
    assert (autotune.accel_crossover_faces()
            == jautotune.accel_crossover_faces())
    assert autotune.DEFAULT_CROSSOVER == jautotune.DEFAULT_CROSSOVER
    assert (autotune.ACCEL_DEFAULT_CROSSOVER
            == jautotune.ACCEL_DEFAULT_CROSSOVER)
    assert autotune.STREAM_DEFAULT_TILES == jautotune.STREAM_DEFAULT_TILES


def test_sphere_mesh_matches_reference():
    for n in (500, 5000):
        v, f = autotune._sphere_mesh(n)
        rv, rf = jautotune._sphere_mesh(n)
        np.testing.assert_array_equal(v, rv)
        np.testing.assert_array_equal(f, rf)


@pytest.mark.parametrize("rung,brute_max,accel_min", [
    ("brute", "100000", "200000"),
    ("culled", "100", "200000"),
    ("accel_bvh", "100", "1000"),
])
def test_auto_ladder_takes_each_rung(monkeypatch, reference_defaults, rung,
                                     brute_max, accel_min):
    """With the crossovers pinned small, a 1280-face mesh takes each rung;
    the answer is mesh_tpu's auto answer under the tie contract."""
    monkeypatch.setenv("MESH_TPU_BRUTE_MAX_FACES", brute_max)
    monkeypatch.setenv("MESH_TPU_ACCEL_MIN_FACES", accel_min)
    monkeypatch.setenv("MESH_TPU_NO_ENGINE", "1")
    v, f = sphere(3, seed=6)
    q = surface_queries(v, f, 150, seed=6)
    tculled.STRATEGY.clear()
    out = tculled.closest_faces_and_points_auto(v, f, q, device="cpu")
    assert tculled.STRATEGY == {rung: 1}
    assert set(out) == {"face", "part", "point", "sqdist"}
    ref = jax_auto(v, f, q)
    assert_tie_contract(ref, out, v, f, q)


def test_auto_ladder_safe_tiles_and_no_accel(monkeypatch):
    monkeypatch.setenv("MESH_TPU_SAFE_TILES", "1")
    monkeypatch.setenv("MESH_TPU_BRUTE_MAX_FACES", "100")
    monkeypatch.setenv("MESH_TPU_ACCEL_MIN_FACES", "1000")
    monkeypatch.setenv("MESH_TPU_NO_ACCEL", "1")
    v, f = sphere(3, seed=7)
    q = surface_queries(v, f, 100, seed=7)
    tculled.STRATEGY.clear()
    out = tculled.closest_faces_and_points_auto(v, f, q, device="cpu")
    assert tculled.STRATEGY == {"culled_safe": 1}
    brute = _np(ck.closest_point_kernel(*_t(v, f, q), tile_variant="safe"))
    assert_tie_contract(brute, out, v, f, q)


def test_grid_kind_and_stream_hole_raise(monkeypatch):
    """Once refused, now parity: MESH_TPU_ACCEL_KIND=grid takes the grid
    rung, and MESH_TPU_BVH_STREAM=0 above the resident ceiling the plain
    BVH walk; each equals the plain scan bit for bit and mesh_tpu's auto
    answer under the tie contract."""
    from mesh_tpu_torch.accel import traverse
    from mesh_tpu_torch.query.closest_point import closest_faces_and_points_t

    v, f = sphere(2)
    q = surface_queries(v, f, 60, seed=8)
    scan = _np(closest_faces_and_points_t(*_t(v, f.astype(np.int64), q)))
    monkeypatch.setenv("MESH_TPU_ACCEL_MIN_FACES", "10")
    monkeypatch.setenv("MESH_TPU_ACCEL_KIND", "grid")
    tculled.STRATEGY.clear()
    out = tculled.closest_faces_and_points_auto(v, f, q, device="cpu")
    assert tculled.STRATEGY == {"accel_grid": 1}
    assert_tie_contract(jax_auto(v, f, q), out, v, f, q)
    for key in scan:
        np.testing.assert_array_equal(out[key], scan[key])
    monkeypatch.delenv("MESH_TPU_ACCEL_KIND")
    monkeypatch.setenv("MESH_TPU_BVH_STREAM", "0")
    monkeypatch.setattr(traverse, "PALLAS_BVH_MAX_FACES", 100)
    out = tculled.closest_faces_and_points_auto(v, f, q, device="cpu")
    assert tculled.STRATEGY == {"accel_grid": 1, "accel_bvh": 1}
    for key in scan:
        np.testing.assert_array_equal(out[key], scan[key])


# -- the batched path ---------------------------------------------------------

def test_batch_step_above_crossover_matches_per_mesh(monkeypatch):
    """Above a pinned crossover, batch_step runs the culled kernel on the
    whole [B, V, 3] batch; each mesh's answer is the single-mesh answer."""
    monkeypatch.setenv("MESH_TPU_BRUTE_MAX_FACES", "500")
    vs, qs = [], []
    for b in range(3):
        v, f = sphere(3, seed=30 + b)
        vs.append(v)
        qs.append(surface_queries(v, f, 120, seed=40 + b))
    vs, qs = np.stack(vs), np.stack(qs)
    tculled.STRATEGY.clear()
    normals, res = batch_step(*_t(vs, f, qs), assume_nondegenerate=True)
    assert tculled.STRATEGY == {"culled": 1}
    assert normals.shape == vs.shape
    res = _np(res)
    for b in range(3):
        one = _np(qk.closest_point_culled_kernel(
            *_t(vs[b], f, qs[b]), assume_nondegenerate=True))
        assert_tie_contract(one, {k: x[b] for k, x in res.items()},
                            vs[b], f, qs[b])
    monkeypatch.setenv("MESH_TPU_BRUTE_MAX_FACES", "5000")
    tculled.STRATEGY.clear()
    brute = closest_point_dispatch(*_t(vs, f, qs), use_pallas=True,
                                   nondegen=True, variant="safe")
    assert tculled.STRATEGY == {"brute_safe": 1}
    for b in range(3):
        assert_tie_contract({k: x[b] for k, x in _np(brute).items()},
                            {k: x[b] for k, x in res.items()},
                            vs[b], f, qs[b])


@pytest.mark.parametrize("rung,brute_max,accel_min", [
    ("brute", "100000", "200000"),
    ("culled", "100", "200000"),
    ("accel_bvh", "100", "1000"),
])
def test_mesh_facade_reaches_each_rung(monkeypatch, rung, brute_max,
                                       accel_min):
    """``Mesh.closest_faces_and_points`` goes through the auto ladder, so
    with the crossovers pinned it takes every rung, with the facade's
    dtypes and shapes and the brute-force answer up to ties."""
    from mesh_tpu_torch import Mesh

    monkeypatch.setenv("MESH_TPU_BRUTE_MAX_FACES", brute_max)
    monkeypatch.setenv("MESH_TPU_ACCEL_MIN_FACES", accel_min)
    v, f = sphere(3, seed=60)
    q = surface_queries(v, f, 90, seed=60)
    tculled.STRATEGY.clear()
    faces, points = Mesh(v, f, device="cpu").closest_faces_and_points(q)
    assert tculled.STRATEGY == {rung: 1}
    assert faces.dtype == np.uint32 and faces.shape == (1, q.shape[0])
    assert points.dtype == np.float64 and points.shape == q.shape
    brute = _np(ck.closest_point_kernel(*_t(v, f, q)))
    assert_tie_contract(brute, {"face": faces[0].astype(np.int32),
                                "point": points.astype(np.float32),
                                "sqdist": ((q - points) ** 2).sum(-1),
                                "part": brute["part"]}, v, f, q)
