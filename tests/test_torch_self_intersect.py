"""mesh_tpu_torch self-intersection vs mesh_tpu, on the CPU: the per-face
counts of the ``self_intersect`` kernel in both tiles, and the
``self_intersection_count`` facade.

Inputs come from numpy RandomState seeds or fixed geometry and go to both
packages.  The JAX side runs ``self_intersection_count_pallas`` in
interpret mode (small tiles) and its XLA path ``_self_intersection_count_xla``
(what its CPU facade takes); the port runs its kernel's plain version.
Counts are held to equality; per-face involvement is also held to the
pairs of mesh_tpu's own ``tri_tri_intersects``, with the vertex-sharing and
self pairs left out.  The reference fixtures (tests/test_reference_fixtures.py)
keep their counts in both tiles: 0 for the double box, 2 x 8 for the bent
cylinder, the two tiles equal on the open cylinder.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mesh_tpu.models import body_model as jbm
from mesh_tpu.query import self_intersection_count as jax_self_count
from mesh_tpu.query.pallas_ray import self_intersection_count_pallas
from mesh_tpu.query.ray import (
    _self_intersection_count_xla,
    tri_tri_intersects as jax_tri_tri_intersects,
)

from mesh_tpu_torch.models import body_model as tbm
from mesh_tpu_torch.query import tri_tri_kernel as tk
from mesh_tpu_torch.query.ray import self_intersection_count

from .fixtures import icosphere
from .test_reference_fixtures import (
    CYL_F,
    CYL_V,
    DOUBLEBOX_F,
    DOUBLEBOX_V,
    SELF_INT_CYL_F,
    SELF_INT_CYL_V,
)

torch.set_num_threads(2)

FIXTURES = {
    "doublebox": (DOUBLEBOX_V, DOUBLEBOX_F, 0),
    "bent_cylinder": (SELF_INT_CYL_V, SELF_INT_CYL_F, 2 * 8),
    "translated_cylinder": (CYL_V, CYL_F, None),
}


def _counts(v, f, algorithm):
    return tk.self_intersection_counts_kernel(
        torch.from_numpy(np.asarray(v, np.float32)),
        torch.from_numpy(np.asarray(f, np.int64)), algorithm).numpy()


def _sphere_and_slab():
    """The icosphere with a large triangle slicing through it, sharing no
    vertex with the shell (tests/test_pallas_ray.py:175-190)."""
    v, f = icosphere(2)
    v32, f32 = v.astype(np.float32), f.astype(np.int32)
    n0 = len(v32)
    v2 = np.vstack([v32, [[-2, -2, 0.1], [2, -2, 0.1], [0, 3, 0.1]]])
    f2 = np.vstack([f32, [[n0, n0 + 1, n0 + 2]]])
    return v2.astype(np.float32), f2.astype(np.int32)


def _involved_from_reference_pairs(v, f):
    """Per face, whether mesh_tpu's pairwise tri_tri_intersects finds a
    partner sharing no vertex index with it."""
    tri = jnp.asarray(v)[jnp.asarray(f)]
    inter = np.asarray(jax_tri_tri_intersects(tri[:, None], tri[None]))
    shares = (f[:, None, :, None] == f[None, :, None, :]).any(axis=(-1, -2))
    return (inter & ~shares).any(axis=1)


@pytest.mark.parametrize("algorithm", tk.ALGORITHMS)
def test_sphere_and_slab_match_reference(algorithm):
    v, f = _sphere_and_slab()
    counts = _counts(v, f, algorithm)
    assert counts.dtype == np.int32 and counts.shape == (len(f),)
    ref = int(self_intersection_count_pallas(v, f, tile_q=32, tile_f=64,
                                             interpret=True,
                                             algorithm=algorithm))
    assert int((counts > 0).sum()) == ref == int(
        _self_intersection_count_xla(v, f))
    assert ref > 0
    np.testing.assert_array_equal(counts > 0,
                                  _involved_from_reference_pairs(v, f))
    # the slab meets every face it crosses: its count is the others' sum
    assert counts[-1] == counts[:-1].sum() == ref - 1


@pytest.mark.parametrize("algorithm", tk.ALGORITHMS)
def test_closed_sphere_is_zero(algorithm):
    v, f = icosphere(2)
    assert not _counts(v, f, algorithm).any()
    assert int(self_intersection_count_pallas(
        v.astype(np.float32), f.astype(np.int32), tile_q=32, tile_f=64,
        interpret=True, algorithm=algorithm)) == 0


@pytest.mark.parametrize("algorithm", tk.ALGORITHMS)
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_reference_fixture_counts(name, algorithm):
    """tests/test_reference_fixtures.py:153-169, 200-210 through the port:
    the double box 0, the bent cylinder 2 x 8, both tiles equal on the
    open cylinder."""
    v, f, expect = FIXTURES[name]
    count = int((_counts(v, f, algorithm) > 0).sum())
    if expect is not None:
        assert count == expect
    other = tk.ALGORITHMS[1 - tk.ALGORITHMS.index(algorithm)]
    assert count == int((_counts(v, f, other) > 0).sum())


@pytest.mark.parametrize("name", sorted(FIXTURES) + ["sphere_and_slab"])
def test_facade_matches_reference(name):
    """self_intersection_count (the gate, the prologue, the plain version)
    against mesh_tpu's CPU facade, with its dtype and shape."""
    v, f = (_sphere_and_slab() if name == "sphere_and_slab"
            else FIXTURES[name][:2])
    v, f = np.asarray(v, np.float32), np.asarray(f, np.int32)
    got = self_intersection_count(v, f, device="cpu")
    assert got.dtype == torch.int32 and got.shape == ()
    ref = jax_self_count(v, f)
    assert np.asarray(ref).dtype == np.int32
    assert int(got) == int(ref)
    assert int(self_intersection_count(torch.from_numpy(v),
                                       torch.from_numpy(f),
                                       device="cpu")) == int(ref)


def test_facade_gate_follows_the_data(monkeypatch):
    """The Moller tile on a nondegenerate mesh, the segment tile on one
    with a zero-area face or under MESH_TPU_SAFE_TILES=1."""
    seen = []
    plain = tk.self_intersect_counts

    def spy(qplanes, fplanes, ids, algorithm, q0=0, q1=None):
        seen.append(algorithm)
        return plain(qplanes, fplanes, ids, algorithm, q0, q1)

    monkeypatch.setattr(tk, "self_intersect_counts", spy)
    v, f = _sphere_and_slab()
    count = int(self_intersection_count(v, f, device="cpu"))
    f_degen = np.vstack([f, [[0, 0, 1]]]).astype(np.int32)
    assert int(self_intersection_count(v, f_degen, device="cpu")) == count
    monkeypatch.setenv("MESH_TPU_SAFE_TILES", "1")
    assert int(self_intersection_count(v, f, device="cpu")) == count
    assert seen == ["moller", "segment", "segment"]


def _posed_small_body(seed=0):
    """A small synthetic body posed hard enough to fold through itself,
    from both packages: (JAX vertices, port vertices, faces)."""
    v, f = jbm._uv_sphere(20, 16)
    template = (v * np.array([0.3, 0.2, 0.9]), f)
    jm = jbm.synthetic_body_model(seed=seed, template=template)
    tm = tbm.synthetic_body_model(seed=seed, template=template,
                                  device="cpu")
    rng = np.random.RandomState(seed)
    betas = (rng.randn(1, 10) * 0.3).astype(np.float32)
    pose = (rng.randn(1, 24, 3) * 0.4).astype(np.float32)
    jv = np.array(jbm.lbs(jm, betas, pose)[0])[0]
    tv = tbm.lbs(tm, betas, pose, device="cpu")[0][0]
    return jv, tv, f.astype(np.int32)


def test_posed_body_counts_match_reference():
    """A posed body that folds through itself: both tiles count the same
    faces, as mesh_tpu's XLA path does on the same vertices."""
    jv, tv, f = _posed_small_body()
    np.testing.assert_allclose(tv.numpy(), jv, atol=1e-5)
    counts = {alg: _counts(jv, f, alg) for alg in tk.ALGORITHMS}
    np.testing.assert_array_equal(counts["segment"] > 0,
                                  counts["moller"] > 0)
    ref = int(_self_intersection_count_xla(jv, f))
    assert int((counts["moller"] > 0).sum()) == ref > 0
    np.testing.assert_array_equal(counts["segment"] > 0,
                                  _involved_from_reference_pairs(jv, f))


@pytest.mark.parametrize("algorithm", tk.ALGORITHMS)
def test_query_range_is_a_slice(algorithm, monkeypatch):
    """A launch over faces [q0, q1) gives those faces' counts against all
    faces, also when the plain version chunks."""
    v, f = _sphere_and_slab()
    tri = torch.from_numpy(v)[torch.from_numpy(f.astype(np.int64))]
    qp, fp = tk.self_planes(tri, algorithm)
    ids = torch.from_numpy(f)
    full = tk.self_intersect_counts(qp, fp, ids, algorithm)
    part = tk.self_intersect_counts(qp, fp, ids, algorithm, 100, 321)
    assert torch.equal(part, full[100:321])
    monkeypatch.setitem(tk._PLAIN_PAIRS, "cpu", 5 * len(f) + 1)
    assert torch.equal(tk.self_intersect_counts(qp, fp, ids, algorithm),
                       full)
    assert tk.self_intersect_counts(qp, fp, ids, algorithm, 7, 7).numel() == 0


def test_self_wrappers_reject_bad_operands():
    v, f = _sphere_and_slab()
    tri = torch.from_numpy(v)[torch.from_numpy(f.astype(np.int64))]
    qp, fp = tk.self_planes(tri, "segment")
    ids = torch.from_numpy(f)
    with pytest.raises(ValueError):
        tk.self_intersect_counts(qp, fp, ids.long(), "segment")
    with pytest.raises(ValueError):
        tk.self_intersect_counts(qp, fp[:, :-1].contiguous(), ids, "segment")
    with pytest.raises(ValueError):
        tk.self_intersect_counts(qp, fp, ids, "segment", 5, len(f) + 1)
    with pytest.raises(ValueError):
        tk.self_intersect_counts(qp, fp, ids, "moller")
    before = dict(tk.LAUNCHES)
    assert torch.equal(tk.self_intersect_counts(qp, fp, ids, "segment"),
                       tk.self_intersect_counts_plain(qp, fp, ids,
                                                      "segment"))
    assert tk.LAUNCHES == before
