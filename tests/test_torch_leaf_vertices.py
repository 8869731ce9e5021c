"""The schedules of mesh_tpu_torch's leaf-box and nearest-vertex kernels
(``refit_kernel.leaf_boxes_schedule``, ``closest_kernel.
argmin_vertices_split_plain``) vs their plain versions and mesh_tpu's, on
the CPU.

Leaf boxes: the schedule's items (48-byte units of four corners, or single
corners where the leaf size is not a multiple of 4 or ``tri_s`` is not
16-byte aligned), its groups of threads and its segmented reduction,
held to ``leaf_boxes_plain``, mesh_tpu's numpy twin ``refit_leaf_boxes``
and its Pallas kernel in interpret mode.  min and max round nothing, so
boxes are held to equality (NaN in the same leaves, -0.0 equal to 0.0).

Nearest vertices: the split of the vertex axis into contiguous ranges and
their merge by the least packed (distance, index) key, held to
``argmin_vertices_plain`` and mesh_tpu's Pallas kernel in interpret mode,
indices exactly.  The meshes and queries are dyadic, and the vertices sum
to zero, so every centering and every cost is exact in both packages and
exact ties stay ties.
"""

import ast
import os

import numpy as np
import pytest
import torch

from mesh_tpu.accel import build as jbuild
from mesh_tpu.accel.pallas_refit import leaf_boxes_pallas
from mesh_tpu.anim import refit as jrefit
from mesh_tpu.query import closest_point as jclosest
from mesh_tpu.query.pallas_closest import nearest_vertices_pallas
from mesh_tpu.sphere import _icosphere

from mesh_tpu_torch import _build
from mesh_tpu_torch.accel import build as tbuild
from mesh_tpu_torch.accel import refit_kernel as rk
from mesh_tpu_torch.anim import refit as trefit
from mesh_tpu_torch.query import closest_kernel as ck
from mesh_tpu_torch.query.closest_point import closest_vertices_with_distance

torch.set_num_threads(2)

LEAF_SIZES = [1, 3, 5, 8, 256]
SPLITS = [1, 2, 3, 7, 16]


def sphere(subdiv=3):
    v, f = _icosphere(subdiv)
    return np.asarray(v, np.float32), np.asarray(f, np.int32)


@pytest.fixture(autouse=True)
def _fresh_caches():
    tbuild.clear_index_cache()
    jbuild.clear_index_cache()
    yield
    tbuild.clear_index_cache()
    jbuild.clear_index_cache()


# -- leaf boxes --------------------------------------------------------------

def leaf_operand(leaf_size, case, seed):
    """(tri_s [Fp, 3, 3] float32, n_leaves, NaN leaves) of a deformed
    sphere over its own index, with planted NaN corners or whole leaves of
    zeros of both signs."""
    v, f = sphere()
    index = tbuild.build_bvh(v, f, leaf_size=leaf_size)
    n_leaves = index.meta["n_leaves"]
    rng = np.random.RandomState(seed)
    v2 = np.asarray(v + 0.05 * rng.randn(*v.shape), np.float32)
    tri_s = np.ascontiguousarray(
        (v2 - index.arrays["center"])[f][index.arrays["order"]])
    nan_leaves = np.zeros(n_leaves, bool)
    if case == "nan":
        n_corners = 3 * leaf_size
        for leaf, corner in ((0, n_corners - 1), (n_leaves - 1, 0),
                             (n_leaves // 2, n_corners // 2)):
            face = leaf * leaf_size + corner // 3
            tri_s[face, corner % 3, (leaf + corner) % 3] = np.nan
            nan_leaves[leaf] = True
    elif case == "signed_zero":
        # two leaves whose x is all zeros of both signs, one whose z mixes
        # them with values of both signs
        span = 2 * leaf_size
        tri_s[:span, :, 0] = -0.0
        tri_s[:span:2, :, 0] = 0.0
        band = tri_s[span:2 * span, :, 2]
        tri_s[span:2 * span, :, 2] = np.where(band > 0, 0.0, -0.0)
    return tri_s, n_leaves, nan_leaves


def misaligned(tri_s):
    """A torch view of ``tri_s`` whose data starts 4 bytes past a 16-byte
    boundary."""
    buf = torch.empty(tri_s.size + 4, dtype=torch.float32)
    start = next(k for k in range(4)
                 if (buf.data_ptr() + 4 * k) % 16 == 4)
    view = buf[start:start + tri_s.size].view(tri_s.shape)
    view.copy_(torch.from_numpy(tri_s))
    return view


@pytest.mark.parametrize("case", ["deformed", "nan", "signed_zero"])
@pytest.mark.parametrize("layout", ["aligned", "offset"])
@pytest.mark.parametrize("leaf_size", LEAF_SIZES)
def test_leaf_schedule_matches_plain_and_reference(leaf_size, layout, case):
    """The schedule's boxes equal the plain version's, the numpy twin's
    and the Pallas kernel's (interpret mode) on every leaf, exactly."""
    tri_s, n_leaves, nan_leaves = leaf_operand(leaf_size, case, leaf_size)
    t = (torch.from_numpy(tri_s) if layout == "aligned"
         else misaligned(tri_s))
    units, items, group = rk.leaf_plan(t, leaf_size)
    assert units == (layout == "aligned" and leaf_size % 4 == 0)
    assert items * (4 if units else 1) == 3 * leaf_size
    ref = jrefit.refit_leaf_boxes(tri_s, n_leaves, leaf_size)
    pallas = leaf_boxes_pallas(tri_s, n_leaves, leaf_size, interpret=True)
    plain = rk.leaf_boxes_plain(t, n_leaves, leaf_size)
    for got, want_plain, want, ker in zip(
            rk.leaf_boxes_schedule(t, n_leaves, leaf_size), plain, ref,
            pallas):
        got = got.numpy()
        assert got.dtype == np.float32
        # array_equal semantics: NaN equals NaN, -0.0 equals 0.0
        np.testing.assert_array_equal(got, want_plain.numpy())
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.asarray(ker))
        np.testing.assert_array_equal(np.isnan(got).any(axis=1), nan_leaves)


def test_leaf_plan_covers_each_leaf_in_one_round_up_to_the_block():
    """The anim shapes' plans (leaf 256: 64 threads a leaf; leaf 8: 2), and
    every plan's group the least power of two whose one round of
    ROUND_ITEMS covers the leaf, at most BLOCK_THREADS."""
    base = torch.zeros(256 * 9)
    assert base.data_ptr() % 16 == 0
    assert rk.leaf_plan(base.view(256, 3, 3), 256) == (True, 192, 64)
    assert rk.leaf_plan(base.view(256, 3, 3), 8) == (True, 6, 2)
    assert rk.leaf_plan(base.view(256, 3, 3), 5) == (False, 15, 8)
    for leaf_size in range(1, 400, 7):
        t = torch.zeros(leaf_size * 9).view(leaf_size, 3, 3)
        for view in (t, misaligned(t.numpy())):
            units, items, group = rk.leaf_plan(view, leaf_size)
            assert group & (group - 1) == 0 and group <= rk.BLOCK_THREADS
            assert (group * rk.ROUND_ITEMS >= items
                    or group == rk.BLOCK_THREADS)
            assert group == 1 or (group // 2) * rk.ROUND_ITEMS < items


def test_leaf_wrappers_take_the_plain_version_on_the_cpu():
    tri_s, n_leaves, _ = leaf_operand(8, "deformed", 0)
    t = torch.from_numpy(tri_s)
    before = dict(rk.LAUNCHES)
    want = rk.leaf_boxes_plain(t, n_leaves, 8)
    for fn in (rk.leaf_boxes_kernel, rk.leaf_boxes_warp_kernel):
        for got, exp in zip(fn(t, n_leaves, 8), want):
            assert torch.equal(got, exp)
        with pytest.raises(ValueError):
            fn(t, n_leaves + 1, 8)
    assert rk.LAUNCHES == before
    assert set(before) == {"leaf_boxes", "leaf_boxes_warp"}


@pytest.mark.parametrize("leaf_size", [3, 5])
def test_refit_at_a_leaf_size_not_a_multiple_of_four(leaf_size):
    """refit_bvh through the wrapper at leaf sizes that take the corner
    items: node boxes equal mesh_tpu's refit on every node."""
    v, f = sphere()
    jbase = jbuild.build_bvh(v, f, leaf_size=leaf_size)
    tbase = tbuild.build_bvh(v, f, leaf_size=leaf_size)
    v2 = np.asarray(v * np.array([1.3, 0.8, 1.1], np.float32), np.float32)
    jref, _ = jrefit.refit_bvh(jbase, v2, f)
    out, _ = trefit.refit_bvh(tbase, torch.from_numpy(v2), f,
                              kernel="pallas", device="cpu")
    for name in ("node_lo", "node_hi"):
        np.testing.assert_array_equal(out.arrays[name],
                                      np.asarray(jref.arrays[name]))


# -- nearest vertices --------------------------------------------------------

#: vertices of the dyadic test mesh, and its queries (not a multiple of a
#: block's 256 or 512 queries)
N_VERTS = 700
N_QUERIES = 299


def dyadic_mesh(split, seed):
    """(v [V, 3], q [Q, 3]) float32, every coordinate a multiple of 1/32
    small enough that every sum, difference and square below is exact,
    and the vertices summing to zero (the last one balances the rest).
    Planted at each boundary b of ``split``'s ranges: vertex b a duplicate
    of vertex b - 1 (across the boundary) and a query on it; vertices b - 2
    and b + 1 on either side of a query, equidistant from it; far from the
    cloud of the others, so that those pairs are the nearest.  Then a NaN
    query and far queries whose costs overflow to +inf."""
    rng = np.random.RandomState(seed)
    v = rng.randint(-96, 97, size=(N_VERTS, 3)).astype(np.float32) / 32
    q = rng.randint(-128, 129, size=(N_QUERIES, 3)).astype(np.float32) / 32
    planted = []
    for s, (b, _) in enumerate(ck.vertex_split_bounds(N_VERTS, split)):
        if not 2 <= b <= N_VERTS - 3:
            continue
        at = np.array([8.0 + s, 4.0, -2.0], np.float32)
        v[b - 1] = v[b] = at
        mid = np.array([-8.0 - s, 5.0, 2.0], np.float32)
        v[b - 2] = mid + np.float32(0.0625) * np.array([1, 0, 0], np.float32)
        v[b + 1] = mid - np.float32(0.0625) * np.array([1, 0, 0], np.float32)
        planted += [at, mid]
    v[-1] = -v[:-1].sum(axis=0)
    assert float(np.abs(v.sum(axis=0)).max()) == 0.0
    extra = planted + [[np.nan, 0.0, 0.0], [2.0 ** 70, 0.0, 0.0],
                       [0.0, -2.0 ** 68, 2.0 ** 69]]
    q[:len(extra)] = np.asarray(extra, np.float32)
    return v, q


@pytest.mark.parametrize("split", SPLITS)
def test_vertex_split_matches_plain_and_reference(split):
    """The split-and-merge model's indices equal the plain version's and
    the Pallas kernel's (interpret mode), exactly: ties across a split
    boundary go to the lower index, a NaN query and queries whose costs
    are all +inf to index 0."""
    v, q = dyadic_mesh(split, seed=split)
    pts = torch.from_numpy(q)[None].contiguous()
    vplanes = torch.from_numpy(np.ascontiguousarray(v.T))[None]
    got = ck.argmin_vertices_split_plain(pts, vplanes, split)
    plain = ck.argmin_vertices_plain(pts, vplanes)
    ref, _ = nearest_vertices_pallas(v, q, tile_q=64, tile_v=128,
                                     interpret=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref))
    bounds = ck.vertex_split_bounds(N_VERTS, split)
    n_planted = 0
    for b, _ in bounds:
        if 2 <= b <= N_VERTS - 3:
            # the duplicate pair and the equidistant pair, each straddling
            # a boundary of this split's ranges when b is one of them
            assert got[0, 2 * n_planted] == b - 1
            assert got[0, 2 * n_planted + 1] == b - 2
            n_planted += 1
    assert n_planted == (split - 1 if split > 1 else 0)
    assert got[0, 2 * n_planted:2 * n_planted + 3].tolist() == [0, 0, 0]
    assert bounds[0][0] == 0 and bounds[-1][1] == N_VERTS


def test_vertex_split_at_the_kernel_split_bounds():
    """Planted exactly at the kernel's own range boundaries (V = 700 and
    the splits the kernel cuts), several meshes in one batch: the model's
    indices equal the plain version's for every split up to 16."""
    meshes, queries = zip(*(dyadic_mesh(7, seed) for seed in range(3)))
    pts = torch.from_numpy(np.stack(queries)).contiguous()
    vplanes = torch.from_numpy(
        np.ascontiguousarray(np.stack(meshes).transpose(0, 2, 1)))
    plain = ck.argmin_vertices_plain(pts, vplanes)
    for split in range(1, 17):
        assert torch.equal(
            ck.argmin_vertices_split_plain(pts, vplanes, split), plain), split


def test_vertex_keys_order_as_the_kernels_unsigned_keys():
    """On the bit patterns themselves: finite distances in value order,
    below +inf, below every NaN (either sign), and the lower index first
    at an equal distance; the int64 keys order as numpy's unsigned
    ``(bits << 32) | index``."""
    patterns = [0x00000000, 0x00000001, 0x00800000, 0x3F800000, 0x3F800001,
                0x7F7FFFFF, 0x7F800000, 0x7F800001, 0x7FC00000, 0x7FFFFFFF,
                0xFFC00000, 0xFFFFFFFF]
    bits = np.repeat(np.array(patterns, np.uint32), 3)
    index = np.tile(np.array([0, 5, 2 ** 31 - 1], np.int64), len(patterns))
    d = torch.from_numpy(bits.view(np.float32).copy())
    keys = ck.vertex_keys(d, torch.from_numpy(index)).numpy()
    unsigned = (bits.astype(np.uint64) << np.uint64(32)) | index.astype(
        np.uint64)
    assert (np.argsort(keys, kind="stable")
            == np.argsort(unsigned, kind="stable")).all()
    # the listed order is the wanted order: strictly increasing keys
    assert (np.diff(keys) > 0).all()
    finite, inf = d[:18], d[18:21]
    assert torch.isfinite(finite).all() and torch.isinf(inf).all()
    assert torch.isnan(d[21:]).all()


def test_vertex_plan_and_wrappers_on_the_cpu():
    """The plans at the sweep's shapes on the H100's 132 SMs, on a card of
    twice the SMs, and with too few vertices for a split; the wrappers
    take the plain version on the CPU, with no launch, and refuse a plan
    the kernel is not built for."""
    assert ck.vertex_plan(1, 4096, 6890, 132) == (2, 12)
    assert ck.vertex_plan(4, 4096, 6890, 132) == (2, 7)
    assert ck.vertex_plan(48, 1024, 6890, 132) == (2, 7)
    assert ck.vertex_plan(64, 1024, 6890, 132) == (4, 2)
    assert ck.vertex_plan(256, 1024, 6890, 132) == (4, 2)
    assert ck.vertex_plan(64, 1024, 6890, 264) == (2, 7)
    assert ck.vertex_plan(1, 4096, 2000, 132) == (2, 7)
    assert ck.vertex_plan(1, 10, 100, 132) == (2, 1)
    v, q = dyadic_mesh(1, 3)
    pts = torch.from_numpy(q)[None].contiguous()
    vplanes = torch.from_numpy(np.ascontiguousarray(v.T))[None]
    before = dict(ck.LAUNCHES)
    plain = ck.argmin_vertices_plain(pts, vplanes)
    for fn in (ck.argmin_vertices, ck.argmin_vertices_every):
        assert torch.equal(fn(pts, vplanes), plain)
    for per in ck.VERTEX_PER_THREAD:
        assert torch.equal(ck.argmin_vertices(pts, vplanes, _plan=(per, 3)),
                           plain)
    for plan in ((2, 0), (2, ck.VERTEX_MAX_SPLIT + 1), (3, 1)):
        with pytest.raises(ValueError, match="plan"):
            ck.argmin_vertices(pts, vplanes, _plan=plan)
    assert ck.LAUNCHES == before


def test_closest_vertices_match_reference_through_the_facade():
    """The port's closest_vertices_with_distance (centering, argmin,
    distances) against mesh_tpu's on the dyadic mesh: indices exactly,
    distances to float32 rounding."""
    v, q = dyadic_mesh(4, 5)
    finite = np.isfinite(q).all(axis=1) & (np.abs(q).max(axis=1) < 1e6)
    q = q[finite]
    idx, dist = closest_vertices_with_distance(v, q, device="cpu")
    ridx, rdist = jclosest.closest_vertices_with_distance(v, q)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_allclose(dist.numpy(), np.asarray(rdist), rtol=1e-6)


# -- the A/B tool ------------------------------------------------------------

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


def test_ab_harness_checks_answers_by_name_and_queues_short_variants(
        tmp_path, monkeypatch):
    """tools/ab_common.py: ``same_per_name`` names the answers that differ
    from the first process's answer of the same name (a name one side
    lacks is not compared), and the side program queues the variants named
    in ``queued`` behind a spin."""
    monkeypatch.syspath_prepend(TOOLS)
    import ab_common

    paths = []
    for k, answers in enumerate((
            {"a": torch.tensor([1, 2]), "b": torch.tensor([3])},
            {"a": torch.tensor([1, 2])},
            {"a": torch.tensor([1, 2]), "b": torch.tensor([4]),
             "c": torch.tensor([5])})):
        paths.append(str(tmp_path / ("a%d.pt" % k)))
        torch.save(answers, paths[-1])
    assert ab_common.same_per_name(paths[:2]) == []
    assert ab_common.same_per_name(paths) == ["b"]
    program = ab_common.side_program(
        "queued.add('k')\nvariants.append(('k', lambda: None))\n")
    ast.parse(program)
    assert "torch.cuda._sleep" in program and "spin_overrun" in program
    assert "QUEUE_SPIN_MS = %r" % ab_common.QUEUE_SPIN_MS in program


def test_ab_leaf_vertices_tool_parses_and_compares_argmin_users(
        monkeypatch):
    """tools/ab_leaf_vertices.py imports neither jax nor mesh_tpu, its side
    program parses, and the kernels whose SASS it compares are the ones
    that include csrc/argmin.cuh besides the retired nearest_vertices."""
    path = os.path.join(TOOLS, "ab_leaf_vertices.py")
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            mods = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        assert all(m.split(".")[0] not in ("jax", "jaxlib", "mesh_tpu")
                   for m in mods)
    monkeypatch.syspath_prepend(TOOLS)
    import ab_leaf_vertices

    ast.parse(ab_leaf_vertices.SIDE)
    users = sorted(
        name for name, (source, _, _) in _build.KERNELS.items()
        if '#include "argmin.cuh"' in open(
            os.path.join(_build._CSRC, source)).read())
    assert users == sorted(ab_leaf_vertices.SHARED
                           + ("nearest_vertices_every",))
