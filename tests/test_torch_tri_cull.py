"""The cull of mesh_tpu_torch's contact kernel (``tri_tri_any_hit``, the
Moller tile), on the CPU: its operands (``tri_records_plain``, the query
box) and the plain version of its design (``tri_tri_any_hit_culled_plain``)
against the every-pair plain version and mesh_tpu.

Inputs come from numpy RandomState seeds or fixed geometry: a downsized
hand-vs-body pair of chip_smoke.py's contact inputs
(``synthetic_family_model``), random soups, the icosphere pair of
tests/test_torch_tri_tri.py and chip_smoke.py's planted sets
(``tri_planted``: NaN corners and normals, zero normals, coplanar
overlaps, grazing copies, far queries, the margin's 2^100 cap, triangles
hitting in several splits).  The culled plain version must give the
every-pair plain version's flags and first hits bit for bit; against
mesh_tpu's ``tri_tri_any_hit_pallas(interpret=True)`` a flag may differ
only on a borderline query (tests/test_torch_tri_tri.py's contract: the
port's Moller prologue rounds its reciprocal square root in PyTorch).
"""

import ast
import os
import sys

import numpy as np
import pytest
import torch

from hypothesis import given, settings, strategies as st

from mesh_tpu_torch import _build
from mesh_tpu_torch.query import tri_tri_kernel as tk

from .test_torch_tri_tri import (
    _pallas,
    _shifted_spheres,
    _soup,
    borderline_queries,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def chip_smoke():
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke as cs

    return cs


_CONTACT = {}


def contact_pair():
    """chip_smoke.py phase 9's hand and body (float32 corners [Q, 3, 3],
    [F, 3, 3]), downsized: every 2nd hand face against every 3rd body
    face."""
    if not _CONTACT:
        body_v, body_f, hand_v, hand_f = chip_smoke().contact_inputs(
            torch.device("cpu"))
        hand = torch.as_tensor(hand_v.astype(np.float32))[
            torch.as_tensor(hand_f.astype(np.int64))]
        body = torch.as_tensor(body_v)[
            torch.as_tensor(body_f.astype(np.int64))]
        _CONTACT["pair"] = (hand[::2].contiguous(), body[::3].contiguous())
    return _CONTACT["pair"]


def operands(name):
    """The Moller operands (qplanes [13, Q], fplanes [13, F]) of a named
    input set."""
    if name == "contact":
        return tk.moller_planes(*contact_pair())
    if name == "spheres":
        v, f, qv = _shifted_spheres()
        return tk.moller_planes(torch.from_numpy(qv[f]),
                                torch.from_numpy(v[f]))
    if name == "soup":
        v, f, qv, qf = _soup()
        return tk.moller_planes(torch.from_numpy(qv[qf]),
                                torch.from_numpy(v[f]))
    planted = dict((label, (q, f)) for label, q, f in chip_smoke().tri_planted(
        tk, *tk.moller_planes(*contact_pair()), np.random.RandomState(23)))
    return planted[name]


PLANTED = ["nan_faces", "nan_queries", "zero_normal", "coplanar", "graze",
           "far", "cap", "splits"]
SETS = ["contact", "spheres", "soup"] + PLANTED


def culled(qp, fp, split):
    return tk.tri_tri_any_hit_culled_plain(qp, tk.tri_any_hit_operands(qp,
                                                                       fp),
                                           split)


# -- the culled plain version against every pair ------------------------------

@pytest.mark.parametrize("split", [1, 3, 16])
@pytest.mark.parametrize("name", SETS)
def test_culled_plain_equals_every_pair(name, split):
    """Flags and first hits bit for bit, on every set and split; the
    wrapper with statistics on a CPU tensor runs the same plain version."""
    qp, fp = operands(name)
    hit, tested, warp, lane = culled(qp, fp, split)
    every = tk.tri_tri_any_hit_plain(qp, fp, "moller")
    assert hit.dtype == torch.bool and tested.dtype == torch.int32
    assert torch.equal(hit, every[0]) and torch.equal(tested, every[1])
    assert warp.shape == (-(-qp.shape[1] // tk.WARP), 2)
    assert lane.shape == (qp.shape[1], 2)
    via = tk.tri_tri_any_hit(qp, fp, "moller", split=split, with_stats=True)
    for a, b in zip(via, (hit, tested, warp, lane)):
        assert torch.equal(a, b)


def test_contact_pair_hits_and_culls():
    """The downsized contact pair has hits, few candidate faces and chunks
    its warps skip, as the full-size pair does."""
    qp, fp = operands("contact")
    ops = tk.tri_any_hit_operands(qp, fp)
    hit, _, warp, lane = tk.tri_tri_any_hit_culled_plain(qp, ops, 1)
    assert 0 < int(hit.sum()) < hit.numel()
    bits = tk._mask_bits(ops["chunks"])
    assert 0 < int(bits.sum()) < fp.shape[1] // 4
    n_c = ops["chunks"].shape[0]
    assert int(warp[:, 0].sum()) < warp.shape[0] * n_c // 4
    assert int(lane[:, 0].sum()) < qp.shape[1] * fp.shape[1] // 10


def test_splits_set_hits_in_several_splits():
    """The planted triangles across the mesh meet faces in several ranges
    of a 16-way split, so their first hits fold over warps."""
    qp, fp = operands("splits")
    h = tk.moller_hit_tile(tk._cols(qp, 0, qp.shape[1]), tk._rows(fp))
    n_c = -(-fp.shape[1] // tk.TRI_CHUNK)
    ranges = [n_c * s // 16 * tk.TRI_CHUNK for s in range(17)]
    per = torch.stack([h[:, a:b].any(dim=1)
                       for a, b in zip(ranges[:-1], ranges[1:])], dim=1)
    assert int((per.sum(dim=1) >= 2).sum()) >= 8


@pytest.mark.parametrize("name", ["spheres", "soup"])
def test_culled_flags_match_pallas(name):
    """Against mesh_tpu's Pallas kernel in interpret mode: flags equal but
    on borderline queries (tests/test_torch_tri_tri.py's contract)."""
    if name == "spheres":
        v, f, qv = _shifted_spheres()
        q_tri, m_tri = qv[f], v[f]
        ref = _pallas(q_tri, m_tri, "moller")
    else:
        v, f, qv, qf = _soup()
        q_tri, m_tri = qv[qf], v[f]
        ref = _pallas(q_tri, m_tri, "moller", tile_q=16, tile_f=32)
    qp, fp = tk.moller_planes(torch.from_numpy(q_tri),
                              torch.from_numpy(m_tri))
    hit = tk.tri_tri_any_hit(qp, fp, "moller", with_stats=True)[0].numpy()
    assert ref.any() and not ref.all()
    assert not ((hit != ref) & ~borderline_queries(q_tri, m_tri)).any()


# -- exactness of each skip ---------------------------------------------------

def _skipped(qp, fp):
    """[Q, F] bool: the pairs the cull never tests, the faces that are not
    candidates and the candidates of chunks a query's plane clears."""
    ops = tk.tri_any_hit_operands(qp, fp)
    n_f = fp.shape[1]
    cand = tk._mask_bits(ops["chunks"])[:n_f]
    need = tk.moller_tile_needs(qp, ops["chunks"], 0, qp.shape[1])
    kept = need.repeat_interleave(tk.TRI_CHUNK, dim=1)[:, :n_f]
    return ~cand[None] | ~kept, cand


def _soup_operands(seed, n_q, n_f, scale, flat):
    rng = np.random.RandomState(seed)
    q = rng.randn(n_q, 3, 3) * rng.uniform(0.02, 1.0, (n_q, 1, 1))
    q += rng.randn(n_q, 1, 3)
    m = rng.randn(n_f, 3, 3) * rng.uniform(0.02, 1.0, (n_f, 1, 1))
    m += rng.randn(n_f, 1, 3)
    if flat:
        # near-coplanar sheets: every corner's z within 1e-7 of 0
        q[..., 2] = rng.randn(n_q, 3) * 1e-7
        m[..., 2] = rng.randn(n_f, 3) * 1e-7
    return tk.moller_planes(torch.as_tensor(q * scale, dtype=torch.float32),
                            torch.as_tensor(m * scale, dtype=torch.float32))


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 31 - 1), n_q=st.integers(1, 40),
       n_f=st.integers(1, 150), scale=st.sampled_from([1e-3, 1.0, 1e4]),
       flat=st.booleans())
def test_no_skipped_pair_hits(seed, n_q, n_f, scale, flat):
    """No pair the face-side prefilter or a chunk test skips is a
    moller_hit; every non-candidate face is rejected by reject_q for every
    query; the sides-first pair test (the interval part only where neither
    plane side rejects) is moller_hit."""
    qp, fp = _soup_operands(seed, n_q, n_f, scale, flat)
    q, m = tk._cols(qp, 0, n_q), tk._rows(fp)
    hit = tk.moller_hit_tile(q, m)
    skipped, cand = _skipped(qp, fp)
    assert not bool((hit & skipped).any())
    sides = tk.moller_sides(q[0:3], q[3:6], q[6:9], q[9:12], q[12], m[0:3],
                            m[3:6], m[6:9], m[9:12], m[12])
    dv0dv1, dv0dv2 = sides[0][3], sides[0][4]
    reject_q = (dv0dv1 > 0) & (dv0dv2 > 0)
    assert bool(reject_q[:, ~cand].all())
    first = torch.where(sides[2], torch.zeros_like(hit),
                        tk.moller_intervals(q[0:3], q[3:6], q[6:9], q[9:12],
                                            m[0:3], m[3:6], m[6:9], m[9:12],
                                            sides[:2]))
    assert torch.equal(first, hit)
    every = tk.tri_tri_any_hit_plain(qp, fp, "moller")
    got = tk.tri_tri_any_hit_culled_plain(qp, tk.tri_any_hit_operands(qp, fp),
                                          2)
    assert torch.equal(got[0], every[0]) and torch.equal(got[1], every[1])


@pytest.mark.parametrize("trap", ["box_too_small", "first_hit_dropped",
                                  "query_box_too_small"])
def test_planted_traps_change_an_answer(trap):
    """Three wrong copies of the cull's operands, each caught by the
    every-pair answer: chunk boxes shrunk by a fifth of their span; the
    candidate bit of each query's first hit cleared; the face side's test
    run on the query box shrunk by a fifth of its span."""
    qp, fp = operands("contact")
    want = tk.tri_tri_any_hit_plain(qp, fp, "moller")
    ops = tk.tri_any_hit_operands(qp, fp)
    got = tk.tri_tri_any_hit_culled_plain(qp, ops, 4)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    chunks = ops["chunks"].clone()
    if trap == "box_too_small":
        span = chunks[:, 3:6] - chunks[:, 0:3]
        chunks[:, 0:3] += 0.2 * span
        chunks[:, 3:6] -= 0.2 * span
    elif trap == "first_hit_dropped":
        bits = tk._mask_bits(chunks)
        bits[(want[1][want[0]] - 1).long()] = False
        words = tk._mask_words(bits)
        chunks.view(torch.int32)[:, 7] = words
    else:
        lo, hi = tk.tri_query_box(qp)
        span = hi - lo
        chunks = tk.tri_records_plain(lo + 0.2 * span, hi - 0.2 * span,
                                      fp)[1]
    bad = tk.tri_tri_any_hit_culled_plain(qp, dict(ops, chunks=chunks), 4)
    assert not (torch.equal(bad[0], want[0])
                and torch.equal(bad[1], want[1])), trap


def _unit_tri(z, center=(0.0, 0.0), size=0.1):
    cx, cy = center
    return np.array([[cx - size, cy - size, z], [cx + size, cy - size, z],
                     [cx, cy + size, z]])


def _rows13(tris):
    return chip_smoke().moller_rows(tk, torch.as_tensor(np.asarray(tris)))


@pytest.mark.parametrize("factor,skipped", [(0.5, False), (2.0, True)])
def test_face_side_margin_boundary(factor, skipped):
    """Queries in z = 0 (their box's largest magnitude 0.6) and a face at
    height factor x M above or below them, M its plane's margin against
    the query box: a candidate at M / 2, not at 2 M, where every query
    lies strictly on one side of its plane."""
    for sign in (1.0, -1.0):
        queries = [_unit_tri(0.0, (0.5, 0.5)), _unit_tri(0.0, (-0.5, -0.5))]
        qp = _rows13(queries)
        lo, hi = tk.tri_query_box(qp)
        p_max = float(tk._box_magnitude(lo, hi))
        assert p_max == np.float32(0.6)
        m = tk.MARGIN_FLOOR + tk.MARGIN_REL * (1.0 * p_max + 0.0)
        h = sign * factor * m
        face = _unit_tri(0.0, (0.0, 0.0), size=0.05)
        # the plane z = h: normal (0, 0, 1), offset -h
        fp = _rows13([face])
        fp[12, 0] = float(np.float32(-h))
        faces, chunks = tk.tri_records_plain(lo, hi, fp)
        cand = bool(tk._mask_bits(chunks)[0])
        assert cand != skipped
        if skipped:
            q, f = tk._cols(qp, 0, 2), tk._rows(fp)
            sides = tk.moller_sides(q[0:3], q[3:6], q[6:9], q[9:12], q[12],
                                    f[0:3], f[3:6], f[6:9], f[9:12], f[12])
            assert bool(((sides[0][3] > 0) & (sides[0][4] > 0)).all())


def test_zero_normal_and_nan_are_never_skipped():
    """A zero-normal face is a candidate; a zero-normal query needs every
    chunk with a candidate; a NaN query corner makes every face a
    candidate; a NaN corner of a candidate makes its chunk's box NaN,
    which every query needs."""
    qp, fp = operands("contact")
    qp, fp = qp.clone(), fp.clone()
    fp[9:13, 40] = 0.0
    qp[9:13, 3] = 0.0
    ops = tk.tri_any_hit_operands(qp, fp)
    bits = tk._mask_bits(ops["chunks"])
    assert bool(bits[40])
    need = tk.moller_tile_needs(qp, ops["chunks"], 0, qp.shape[1])
    nonempty = bits.view(-1, tk.TRI_CHUNK).any(dim=1)
    assert bool(need[3][nonempty].all())
    assert not bool(need[:, nonempty].all())
    k = int(bits.nonzero()[0, 0])
    fp2 = fp.clone()
    fp2[1, k] = float("nan")
    ops2 = tk.tri_any_hit_operands(qp, fp2)
    chunk = k // tk.TRI_CHUNK
    assert bool(torch.isnan(ops2["chunks"][chunk, :7]).any())
    assert bool(tk.moller_tile_needs(qp, ops2["chunks"], 0,
                                     qp.shape[1])[:, chunk].all())
    qp2 = qp.clone()
    qp2[0, 7] = float("nan")
    ops3 = tk.tri_any_hit_operands(qp2, fp)
    assert bool(tk._mask_bits(ops3["chunks"])[:fp.shape[1]].all())


# -- the records --------------------------------------------------------------

def test_records_fields():
    """The face records are the operand's rows, zero-padded, the last face
    repeated; a chunk record is the box of its candidates' corners, their
    largest magnitude and the candidate bits (no padding face is one); a
    chunk without a candidate has the empty box."""
    qp, fp = operands("contact")
    lo, hi = tk.tri_query_box(qp)
    corners = qp[0:9].view(3, 3, -1)
    assert torch.equal(lo, corners.amin(dim=(0, 2)))
    assert torch.equal(hi, corners.amax(dim=(0, 2)))
    faces, chunks = tk.tri_records_plain(lo, hi, fp)
    n_f = fp.shape[1]
    n_c = -(-n_f // tk.TRI_CHUNK)
    assert faces.shape == (n_c * tk.TRI_CHUNK, tk.TRI_FACE_WORDS)
    assert chunks.shape == (n_c, tk.TRI_CHUNK_WORDS)
    assert torch.equal(faces[:n_f, :13], fp.t())
    assert not bool(faces[:, 13:].any())
    assert bool((faces[n_f:, :13] == fp[:, -1]).all())
    qbox = torch.cat([lo, hi, tk._box_magnitude(lo, hi)[None],
                      torch.zeros(1)])[None]
    cand = tk.moller_tile_needs(fp, qbox, 0, n_f)[:, 0]
    bits = tk._mask_bits(chunks)
    assert torch.equal(bits[:n_f], cand) and not bool(bits[n_f:].any())
    for k in range(n_c):
        sel = bits[k * 32:(k + 1) * 32].nonzero()[:, 0] + k * 32
        box = chunks[k, :7]
        if not sel.numel():
            assert torch.equal(box[:6], torch.tensor([float("inf")] * 3
                                                     + [-float("inf")] * 3))
            continue
        pts = fp[0:9, sel].t().reshape(-1, 3)
        assert torch.equal(box[0:3], pts.amin(dim=0))
        assert torch.equal(box[3:6], pts.amax(dim=0))
        assert float(box[6]) == float(pts.abs().max())


def test_mask_words_round_trip():
    """Every bit pattern of a candidate mask, the sign bit included, comes
    back from the chunk record's last word."""
    rng = np.random.RandomState(5)
    cand = torch.as_tensor(rng.rand(7 * 32) < 0.5)
    cand[31] = True                      # bit 31 of chunk 0
    words = tk._mask_words(cand)
    assert words.dtype == torch.int32 and int(words[0]) < 0
    rec = torch.cat([torch.zeros((7, 7), dtype=torch.int32), words[:, None]],
                    dim=1).view(torch.float32)
    assert torch.equal(tk._mask_bits(rec), cand)


# -- the statistics -----------------------------------------------------------

@pytest.mark.parametrize("name", ["contact", "spheres", "coplanar"])
def test_statistics_invariants(name):
    """Per lane, the interval part at most the pairs run, the pairs run at
    most the candidates of the chunks its warp took; per warp, the chunks
    taken at most those with a candidate, the slots their candidates; a
    split only adds work (a lane that hit in an earlier range goes on in
    the later ones); a NumPy recount of split 1 agrees."""
    qp, fp = operands(name)
    ops = tk.tri_any_hit_operands(qp, fp)
    n_q, n_f = qp.shape[1], fp.shape[1]
    bits = tk._mask_bits(ops["chunks"]).view(-1, tk.TRI_CHUNK)
    slots = bits.sum(dim=1)
    runs = {s: tk.tri_tri_any_hit_culled_plain(qp, ops, s) for s in (1, 4)}
    for s, (hit, tested, warp, lane) in runs.items():
        assert bool((lane[:, 1] <= lane[:, 0]).all())
        per_warp = torch.zeros(warp.shape[0] * tk.WARP, dtype=torch.int32)
        per_warp[:n_q] = lane[:, 0]
        assert bool((per_warp.view(-1, tk.WARP).max(dim=1).values
                     <= warp[:, 1]).all())
        assert bool((warp[:, 0] <= int((slots > 0).sum())).all())
        assert bool((warp[:, 1] <= warp[:, 0] * tk.TRI_CHUNK).all())
    assert bool((runs[4][2] >= runs[1][2]).all())
    assert bool((runs[4][3] >= runs[1][3]).all())
    # split 1 recounted in NumPy from the pair matrices
    q, m = tk._cols(qp, 0, n_q), tk._rows(fp)
    hit = tk.moller_hit_tile(q, m).numpy()
    reject = tk.moller_sides(q[0:3], q[3:6], q[6:9], q[9:12], q[12], m[0:3],
                             m[3:6], m[6:9], m[9:12], m[12])[2].numpy()
    need = tk.moller_tile_needs(qp, ops["chunks"], 0, n_q).numpy()
    cand = bits.reshape(-1).numpy()[:n_f]
    pairs = np.zeros(n_q, np.int64)
    deep = np.zeros(n_q, np.int64)
    for i in range(n_q):
        js = np.nonzero(cand)[0]
        js = js[need[i, js // tk.TRI_CHUNK]]
        hits = np.nonzero(hit[i, js])[0]
        js = js[:hits[0] + 1] if hits.size else js
        pairs[i] = js.size
        deep[i] = int((~reject[i, js]).sum())
    np.testing.assert_array_equal(runs[1][3][:, 0].numpy(), pairs)
    np.testing.assert_array_equal(runs[1][3][:, 1].numpy(), deep)


# -- the wrappers -------------------------------------------------------------

def test_wrappers_route_and_check_operands():
    """A CPU call without statistics takes the every-pair plain version, with
    them the culled one; no CPU call counts a launch; bad operands, a split
    out of range, statistics of the segment tile, an empty operand set and
    a bad query box raise."""
    qp, fp = operands("spheres")
    before = dict(tk.LAUNCHES), dict(tk.TILE_LAUNCHES)
    plain = tk.tri_tri_any_hit(qp, fp, "moller")
    every = tk.tri_tri_any_hit_plain(qp, fp, "moller")
    assert all(torch.equal(a, b) for a, b in zip(plain, every))
    assert all(torch.equal(a, b) for a, b in zip(
        tk.tri_tri_any_hit_every(qp, fp, "moller"), every))
    ops = tk.tri_any_hit_operands(qp, fp)
    stats = tk.tri_tri_any_hit(qp, fp, "moller", ops=ops, with_stats=True)
    assert len(stats) == 4 and torch.equal(stats[0], every[0])
    assert (dict(tk.LAUNCHES), dict(tk.TILE_LAUNCHES)) == before
    for split in (0, tk.TRI_MAX_SPLIT + 1):
        with pytest.raises(ValueError):
            tk.tri_tri_any_hit(qp, fp, "moller", split=split)
    sq, sf = tk.segment_planes(*(t.reshape(-1, 3, 3) for t in (
        qp[0:9].t(), fp[0:9].t())))
    with pytest.raises(ValueError):
        tk.tri_tri_any_hit(sq, sf, "segment", with_stats=True)
    for key, bad in (("faces", ops["faces"][:-1]),
                     ("chunks", ops["chunks"].double()),
                     ("chunks", ops["chunks"].t()),
                     ("n_faces", fp.shape[1] + 1)):
        with pytest.raises(ValueError):
            tk.tri_tri_any_hit(qp, fp, "moller", ops=dict(ops, **{key: bad}),
                               with_stats=True)
    with pytest.raises(ValueError):
        tk.tri_any_hit_operands(qp[:, :0], fp)
    lo, hi = tk.tri_query_box(qp)
    with pytest.raises(ValueError):
        tk.tri_records(lo.double(), hi, fp)
    with pytest.raises(ValueError):
        tk.tri_records(lo, hi[:2], fp)
    empty = tk.tri_tri_any_hit(qp[:, :0].contiguous(), fp, "moller",
                               with_stats=True)
    assert [tuple(t.shape) for t in empty] == [(0,), (0,), (0, 2), (0, 2)]
    none = tk.tri_tri_any_hit(qp, fp[:, :0].contiguous(), "moller",
                              with_stats=True)
    assert not bool(none[0].any()) and not bool(none[1].any())


def test_kernel_sources_share_the_margin():
    """plane_needs_box lives in tri_tri_cost.cuh, which both Moller culls
    include; the every-pair loop in tri_tri_every.cuh, which the oracle and
    the segment tile include; the header note of the cull carries the
    exactness argument; every kernel is built."""
    csrc = _build._CSRC

    def text(name):
        return open(os.path.join(csrc, name)).read()

    assert "bool plane_needs_box(" in text("tri_tri_cost.cuh")
    for name in ("self_intersect.cu", "tri_tri_any_hit.cu",
                 "tri_records.cu"):
        assert "bool plane_needs_box(" not in text(name)
    cull = text("tri_tri_any_hit.cu")
    assert '#include "tri_tri_every.cuh"' in cull
    assert '#include "tri_tri_every.cuh"' in text("tri_tri_any_hit_every.cu")
    for item in ("(i)", "(ii)", "(iii)", "(iv)"):
        assert "// %s " % item in cull
    for name in ("tri_tri_any_hit", "tri_tri_any_hit_every", "tri_records"):
        assert _build.KERNELS[name][0] == name + ".cu"
    cs = chip_smoke()
    assert cs.KERNEL_PATHS["tri_tri_any_hit_every"] == ()
    assert cs.KERNEL_PATHS["tri_records"] == ("contact",)


@pytest.mark.parametrize("tool", ["ab_tri_tri.py", "cull_counts.py",
                                  "tri_costs.py"])
def test_tools_import_neither_jax_nor_mesh_tpu(tool):
    path = os.path.join(ROOT, "tools", tool)
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] not in ("jax", "jaxlib", "mesh_tpu")
