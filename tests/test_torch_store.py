"""mesh_tpu_torch.store vs mesh_tpu.store on the CPU.

Each scenario of the reference's store tests runs through both packages,
and the results must be the same: the same digests, manifests (but their
wall-clock ``created_utc``) and block bytes, the same quantization bits,
counters, corruption findings, gc victims and page-cache provenance.  A
store written by either package opens in the other with bit-equal arrays;
a side-car written by either serves the other, and the port's plain BVH
walk over a rehydrated side-car equals its walk over a fresh build bit for
bit.  A fresh process (a child with a timeout) answers off the store with
side-car hits and no host build.  Store-keyed serve requests answer bit
for bit as the same requests with the inline mesh.
"""

import json
import os
import subprocess
import sys
import threading
import types

import numpy as np
import pytest
import torch

import mesh_tpu
import mesh_tpu.errors as jerrors
import mesh_tpu.obs as jobs
import mesh_tpu.store as jstore
from mesh_tpu.accel import build as jbuild
from mesh_tpu.serialization import store_io as jstore_io
from mesh_tpu.store import deltas as jdeltas
from mesh_tpu.store import sidecar as jsidecar

import mesh_tpu_torch
import mesh_tpu_torch.errors as terrors
import mesh_tpu_torch.obs as tobs
import mesh_tpu_torch.store as tstore
from mesh_tpu_torch.accel import build as tbuild
from mesh_tpu_torch.accel.traverse import bvh_closest_point
from mesh_tpu_torch.serialization import store_io as tstore_io
from mesh_tpu_torch.store import deltas as tdeltas
from mesh_tpu_torch.store import sidecar as tsidecar

from .fixtures import icosphere

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT = types.SimpleNamespace(
    name="port", store=tstore, build=tbuild, deltas=tdeltas,
    sidecar=tsidecar, store_io=tstore_io, errors=terrors, obs=tobs,
    mesh=lambda **kw: mesh_tpu_torch.Mesh(device="cpu", **kw))
REF = types.SimpleNamespace(
    name="ref", store=jstore, build=jbuild, deltas=jdeltas,
    sidecar=jsidecar, store_io=jstore_io, errors=jerrors, obs=jobs,
    mesh=lambda **kw: mesh_tpu.Mesh(**kw))
PKGS = (PORT, REF)


def _clear():
    for pkg in PKGS:
        pkg.store.clear_page_cache()
        pkg.build.clear_index_cache()
        pkg.obs.reset()


@pytest.fixture(autouse=True)
def root(tmp_path, monkeypatch):
    """The store root both packages' knob points at."""
    path = str(tmp_path / "store")
    monkeypatch.setenv("MESH_TPU_STORE_DIR", path)
    monkeypatch.setenv("MESH_TPU_INCIDENT_DIR", str(tmp_path / "incidents"))
    for knob in ("MESH_TPU_STORE_SIDECAR", "MESH_TPU_STORE_VERIFY",
                 "MESH_TPU_STORE_COMPACT", "MESH_TPU_STORE_BLOCK_ROWS"):
        monkeypatch.delenv(knob, raising=False)
    _clear()
    yield path
    _clear()


def both(fn, tmp_path):
    """``fn(pkg, store)`` on each package, each in a store of its own ->
    (port's result, reference's result)."""
    return tuple(fn(pkg, pkg.store.MeshStore(str(tmp_path / pkg.name)))
                 for pkg in PKGS)


def same(fn, tmp_path):
    mine, theirs = both(fn, tmp_path)
    assert mine == theirs
    return mine


def counter(pkg, name, **labels):
    metric = pkg.obs.REGISTRY.get(name)
    if metric is None:
        return 0
    return metric.value(**labels) if labels else metric.total()


def soup(seed=0, n_v=120, n_f=260):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n_v, 3)).astype(np.float32)
    f = rng.integers(0, n_v, size=(n_f, 3)).astype(np.int32)
    return v, f


def sphere(subdiv=2):
    v, f = icosphere(subdiv)
    return v.astype(np.float32), f.astype(np.int32)


def object_files(store, digest):
    """{relative path: bytes} of an object's files, less its LRU stamp and
    its manifest (whose ``created_utc`` is the wall clock's)."""
    base = store.object_dir(digest)
    out = {}
    for dirpath, _dirs, files in os.walk(base):
        for name in files:
            if name not in ("last_used", "manifest.json"):
                path = os.path.join(dirpath, name)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, base)] = fh.read()
    return out


def wall_free(doc):
    """A manifest without its wall-clock field."""
    return {k: v for k, v in doc.items() if k != "created_utc"}


# ---------------------------------------------------------------------------
# blocks: the quantizer's bits and bound


@pytest.mark.parametrize("seed", range(3))
def test_quantize_matches_reference_and_bounds(seed):
    rng = np.random.default_rng(seed)
    rows = (rng.normal(size=(500, 3))
            * rng.uniform(0.01, 100)).astype(np.float32)
    q, lo, scale, tol = tstore.quantize_rows(rows)
    jq, jlo, jscale, jtol = jstore.quantize_rows(rows)
    assert q.dtype == np.uint16 and np.array_equal(q, jq)
    assert np.array_equal(lo, jlo) and np.array_equal(scale, jscale)
    assert tol == jtol
    back = tstore.dequantize_rows(q, lo, scale, np.float32)
    assert np.array_equal(back, jstore.dequantize_rows(q, lo, scale,
                                                       np.float32))
    err = float(np.max(np.abs(back.astype(np.float64)
                              - rows.astype(np.float64))))
    assert err <= tol


def test_quantize_constant_rows_roundtrip_exact():
    rows = np.full((16, 3), 2.5, np.float32)
    back = tstore.dequantize_rows(*tstore.quantize_rows(rows)[:3])
    assert np.array_equal(back, rows)


# ---------------------------------------------------------------------------
# one on-disk format: the same bytes, read across in both directions


INGEST_CASES = {
    "single": lambda: (soup(1), {}),
    "multi_block": lambda: (soup(2, n_v=1000, n_f=2200),
                            {"block_rows": 256}),
    "f64_non_contiguous": lambda: (
        (np.asfortranarray(soup(4)[0].astype(np.float64)),
         soup(4)[1][::-1].astype(np.int64)[::-1]), {}),
    "degenerate": lambda: ((np.zeros((5, 3), np.float32),
                            np.array([[0, 0, 0], [1, 1, 2]], np.int32)), {}),
    "empty_faces": lambda: ((np.zeros((5, 3), np.float32),
                             np.zeros((0, 3), np.int32)), {}),
}


@pytest.mark.parametrize("case", sorted(INGEST_CASES))
def test_ingest_writes_the_references_bytes(case, tmp_path):
    (v, f), kw = INGEST_CASES[case]()

    def ingest(pkg, store):
        digest = store.ingest(v, f, **kw)
        return (digest, wall_free(store.manifest(digest)),
                object_files(store, digest))

    digest, manifest, files = same(ingest, tmp_path)
    assert digest == jbuild.topology_digest(v, f)
    assert sorted(manifest["tiers"]) == ["compact", "exact"]
    assert any(name.startswith("compact" + os.sep) for name in files)


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["ref_to_port", "port_to_ref"])
def test_store_opens_in_the_other_package(writer, reader, root):
    v, f = soup(3, n_v=800)
    digest = writer.store.MeshStore(root).ingest(v, f, block_rows=300)
    w, r = writer.store.MeshStore(root), reader.store.MeshStore(root)
    exact = r.open(digest)
    assert np.array_equal(np.asarray(exact.v), v)
    assert np.array_equal(np.asarray(exact.f), f)
    assert exact.v.dtype == np.float32 and exact.f.dtype == np.int32
    compact, compact_w = r.open(digest, tier="compact"), w.open(
        digest, tier="compact")
    assert np.array_equal(np.asarray(compact.v), np.asarray(compact_w.v))
    tol = r.manifest(digest)["tiers"]["compact"]["tolerance"]
    assert float(np.max(np.abs(np.asarray(compact.v, np.float64)
                               - v.astype(np.float64)))) <= tol
    assert r.verify() == [] and r.ls() == [digest]


# ---------------------------------------------------------------------------
# ingest / open round trips


def test_exact_tier_round_trip(tmp_path):
    v, f = soup(1)

    def run(pkg, store):
        digest = store.ingest(v, f)
        m = store.open(digest)
        assert np.array_equal(np.asarray(m.v), v)
        assert np.array_equal(np.asarray(m.f), f)
        return (digest, m.topology_key, m.tier, str(m.v.dtype),
                str(m.f.dtype), bool(np.asarray(m.v).flags.writeable))

    digest, key, tier, vd, fd, writable = same(run, tmp_path)
    assert (key, tier, vd, fd) == (digest, "exact", "float32", "int32")
    assert not writable                    # an mmap-backed block


def test_bad_shapes_rejected(tmp_path):
    def run(pkg, store):
        with pytest.raises(pkg.errors.StoreError, match="vertices"):
            store.ingest(np.zeros((4, 2), np.float32),
                         np.zeros((0, 3), np.int32))
        with pytest.raises(pkg.errors.StoreError, match="malformed"):
            store.open("../escape")
        return True

    same(run, tmp_path)


def test_dedupe_short_circuits(tmp_path):
    v, f = soup(5)

    def run(pkg, store):
        d1 = store.ingest(v, f)
        d2 = store.ingest(v.copy(), f.copy())
        return (d1 == d2, counter(pkg, "mesh_tpu_store_dedupe_total"),
                counter(pkg, "mesh_tpu_store_ingest_total", tier="exact"),
                counter(pkg, "mesh_tpu_store_ingest_total", tier="compact"),
                len(store.ls()))

    assert same(run, tmp_path) == (True, 1, 1, 1, 1)


def test_concurrent_same_digest_publishes_one_object(tmp_path):
    v, f = soup(6, n_v=600, n_f=1400)
    store = tstore.MeshStore(str(tmp_path / "port"))
    errs = []
    barrier = threading.Barrier(4)

    def go():
        try:
            barrier.wait(timeout=10)
            store.ingest(v, f)
        except Exception as exc:                        # noqa: BLE001
            errs.append(exc)

    threads = [threading.Thread(target=go) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert errs == []
    assert store.ls() == [tbuild.topology_digest(v, f)]
    assert store.verify() == []
    assert not os.listdir(os.path.join(store.root, "tmp"))


def test_default_store_root_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("MESH_TPU_STORE_DIR")
    mine, theirs = tstore.default_store_root(), jstore.default_store_root()
    assert mine.endswith(os.path.join(".mesh_tpu_torch", "store"))
    assert theirs.endswith(os.path.join(".mesh_tpu", "store"))
    monkeypatch.setenv("MESH_TPU_STORE_DIR", "/x/y")
    assert tstore.get_store().root == jstore.get_store().root == "/x/y"


# ---------------------------------------------------------------------------
# the serialization ramps and the Mesh facade


@pytest.mark.parametrize("fmt", ["obj", "ply", "json"])
def test_file_round_trip_matches_reference(fmt, tmp_path):
    v, f = sphere(1)
    src = str(tmp_path / ("mesh." + fmt))
    getattr(PORT.mesh(v=v, f=f), "write_" + fmt)(src)

    def run(pkg, store):
        pv, pf = pkg.store_io.parse_file(src)
        digest = pkg.store_io.ingest_file(src, store=store)
        man = store.manifest(digest)
        m = store.open(digest)
        assert np.array_equal(np.asarray(m.v), pv)
        assert np.array_equal(np.asarray(m.f), pf)
        out = str(tmp_path / ("%s_back.%s" % (pkg.name, fmt)))
        pkg.store_io.export_file(digest, out, store=store, fmt=fmt)
        bv, _ = pkg.store_io.parse_file(out)
        d2 = pkg.store_io.ingest_file(out, store=store)
        return (digest, man["source"]["format"], pv.tobytes(), pf.tobytes(),
                d2 == digest, bool(np.allclose(bv, pv, atol=1e-5)))

    digest, got_fmt, _, _, dedupes, close = same(run, tmp_path)
    assert got_fmt == fmt and close
    # binary ply and repr-printed json are exact: the re-ingest dedupes;
    # obj prints %f, lossy by design (closed to print precision above)
    assert dedupes or fmt == "obj"


@pytest.mark.parametrize("writer,reader", [
    (PORT, PORT), (REF, PORT), (PORT, REF)],
    ids=["port", "ref_to_port", "port_to_ref"])
def test_mesh_facade_round_trip(writer, reader, root):
    v, f = soup(7)
    store_w = writer.store.MeshStore(root)
    digest = writer.mesh(v=v, f=f).write_store(store=store_w)
    m2 = reader.mesh().load_from_store(digest,
                                       store=reader.store.MeshStore(root))
    src = writer.mesh(v=v, f=f)
    assert np.array_equal(m2.v, src.v) and np.array_equal(m2.f, src.f)
    assert m2.v.dtype == src.v.dtype
    compact = reader.mesh().load_from_store(
        digest, store=reader.store.MeshStore(root), tier="compact")
    assert np.allclose(compact.v, src.v, atol=1e-3)


# ---------------------------------------------------------------------------
# side-cars


def _same_index(a, b):
    assert a.kind == b.kind and a.digest == b.digest and a.meta == b.meta
    assert sorted(a.arrays) == sorted(b.arrays)
    for name in a.arrays:
        x, y = np.asarray(a.arrays[name]), np.asarray(b.arrays[name])
        assert x.dtype == y.dtype and np.array_equal(x, y), name


@pytest.mark.parametrize("params", [{}, {"leaf_size": 4}],
                         ids=["default", "leaf4"])
def test_reference_sidecar_serves_the_port(params, root):
    v, f = soup(8, n_v=400, n_f=900)
    jst = jstore.MeshStore(root)
    digest = jst.ingest(v, f)
    tag = jst.put_sidecar(jbuild.build_bvh(v, f, **params), params or None)
    assert tag == tsidecar.sidecar_tag("bvh", params or None)
    loaded = tstore.MeshStore(root).load_sidecar(digest, "bvh",
                                                 params or None)
    fresh = tbuild.build_bvh(v, f, **params)
    _same_index(loaded, fresh)
    pts = np.random.RandomState(2).randn(64, 3).astype(np.float32)
    walked = bvh_closest_point(v, f, pts, index=loaded, device="cpu")
    want = bvh_closest_point(v, f, pts, index=fresh, device="cpu")
    for key in ("face", "point", "sqdist", "part"):
        assert torch.equal(walked[key], want[key]), key
    # get_index serves it: a side-car hit, no build
    idx = tbuild.get_index(v, f, "bvh", **params)
    _same_index(idx, fresh)
    assert counter(PORT, "mesh_tpu_store_sidecar_hits_total", kind="bvh") \
        == 1
    assert counter(PORT, "mesh_tpu_accel_cache_misses_total", kind="bvh") \
        == 0


def test_port_sidecar_serves_the_reference(root):
    v, f = soup(9, n_v=400, n_f=900)
    digest = tstore.MeshStore(root).ingest(v, f)
    tbuild.get_index(v, f, "bvh", leaf_size=16)      # builds and persists
    tbuild.get_index(v, f, "grid")
    jst = jstore.MeshStore(root)
    assert jst.sidecar_tags(digest) == sorted(
        ["grid", jsidecar.sidecar_tag("bvh", {"leaf_size": 16})])
    assert jst.verify() == []
    _same_index(jst.load_sidecar(digest, "bvh", {"leaf_size": 16}),
                jbuild.build_bvh(v, f, leaf_size=16))
    _same_index(jst.load_sidecar(digest, "grid"), jbuild.build_grid(v, f))
    jbuild.get_index(v, f, "bvh", leaf_size=16)
    assert counter(REF, "mesh_tpu_store_sidecar_hits_total", kind="bvh") == 1
    assert counter(REF, "mesh_tpu_accel_cache_misses_total", kind="bvh") == 0


def test_params_key_separate_tags(tmp_path):
    v, f = soup(9)

    def run(pkg, store):
        digest = store.ingest(v, f)
        store.put_sidecar(pkg.build.build_bvh(v, f))
        store.put_sidecar(pkg.build.build_bvh(v, f, leaf_size=4),
                          params={"leaf_size": 4})
        store.put_sidecar(pkg.build.build_grid(v, f))
        custom = store.load_sidecar(digest, "bvh", params={"leaf_size": 4})
        return (store.sidecar_tags(digest), custom.meta["leaf_size"],
                counter(pkg, "mesh_tpu_store_sidecar_writes_total",
                        kind="bvh"))

    tags, leaf, writes = same(run, tmp_path)
    assert "bvh" in tags and "grid" in tags and leaf == 4 and writes == 2


def _get_index_counts(pkg):
    return tuple(counter(pkg, name, kind="bvh") for name in (
        "mesh_tpu_store_sidecar_hits_total",
        "mesh_tpu_accel_cache_misses_total",
        "mesh_tpu_accel_cache_hits_total",
        "mesh_tpu_store_sidecar_writes_total"))


@pytest.mark.parametrize("scenario", [
    "sidecar_hit", "fresh_build_persists", "kill_switch", "unstored"])
def test_get_index_counters(scenario, root, monkeypatch):
    """The reference's get_index scenarios, through both packages on one
    root (each package's own mesh, so neither serves the other)."""
    if scenario == "kill_switch":
        monkeypatch.setenv("MESH_TPU_STORE_SIDECAR", "0")
    out = []
    for seed, pkg in enumerate(PKGS):
        v, f = soup(10 + seed, n_v=500, n_f=1100)
        store = pkg.store.MeshStore(root)
        if scenario != "unstored":
            digest = store.ingest(v, f)
        if scenario in ("sidecar_hit", "kill_switch"):
            store.put_sidecar(pkg.build.build_bvh(v, f))
        pkg.build.clear_index_cache()
        pkg.obs.reset()
        idx = pkg.build.get_index(v, f, "bvh")
        pkg.build.get_index(v, f, "bvh")
        assert idx.digest == pkg.build.topology_digest(v, f)
        persisted = (scenario != "unstored"
                     and store.sidecar_tag_exists(digest, "bvh"))
        out.append(_get_index_counts(pkg) + (persisted,))
    assert out[0] == out[1]
    assert out[0] == {"sidecar_hit": (1, 0, 1, 0, True),
                      "fresh_build_persists": (0, 1, 1, 1, True),
                      "kill_switch": (0, 1, 1, 0, True),
                      "unstored": (0, 1, 1, 0, False)}[scenario]


def test_rope_route_persists_and_finds_its_tag(root, monkeypatch):
    """The rope walks ask ``get_index(..., leaf_size=tile_f)``: their
    side-car is persisted under that tag at the first build, and a cold
    call finds it (a hit, no build)."""
    from mesh_tpu_torch.accel.traverse import (
        RESIDENT_TILE_F,
        closest_faces_and_points_accel,
        pallas_bvh_variant,
    )

    v, f = sphere(3)
    assert pallas_bvh_variant(len(f)) == "resident"
    digest = tstore.MeshStore(root).ingest(v, f)
    pts = np.random.RandomState(3).randn(256, 3).astype(np.float32)
    first = closest_faces_and_points_accel(v, f, pts, device="cpu")
    assert tstore.MeshStore(root).sidecar_tags(digest) == [
        tsidecar.sidecar_tag("bvh", {"leaf_size": RESIDENT_TILE_F})]
    tbuild.clear_index_cache()
    tobs.reset()
    again = closest_faces_and_points_accel(v, f, pts, device="cpu")
    assert counter(PORT, "mesh_tpu_store_sidecar_hits_total", kind="bvh") \
        == 1
    assert counter(PORT, "mesh_tpu_accel_cache_misses_total", kind="bvh") \
        == 0
    for key in ("face", "point"):
        assert np.array_equal(np.asarray(first[key]), np.asarray(again[key]))


_CHILD = r"""
import json, sys
import numpy as np
import torch
from mesh_tpu_torch.accel.build import get_index
from mesh_tpu_torch.accel.traverse import bvh_closest_point
from mesh_tpu_torch.obs.metrics import REGISTRY
from mesh_tpu_torch.store import get_store

digest, ref_path = sys.argv[1], sys.argv[2]
ref = np.load(ref_path)
m = get_store().open(digest)
idx = get_index(m.v, m.f, "bvh")
out = bvh_closest_point(m.v, m.f, ref["pts"], index=idx, device="cpu")
ok = all(np.array_equal(out[k].numpy(), ref[k])
         for k in ("face", "point", "sqdist"))
print(json.dumps({
    "identical": bool(ok),
    "sidecar_hits": REGISTRY.counter(
        "mesh_tpu_store_sidecar_hits_total").value(kind="bvh"),
    "build_misses": REGISTRY.counter(
        "mesh_tpu_accel_cache_misses_total").value(kind="bvh"),
    "jax": "jax" in sys.modules,
}))
"""


def test_cold_start_child_serves_without_host_build(root, tmp_path):
    """A fresh process answers its first query entirely off the store: a
    side-car hit, no host build, answers bit-equal to the warm process."""
    v, f = sphere(3)
    store = tstore.MeshStore(root)
    digest = store.ingest(v, f)
    idx = tbuild.build_bvh(v, f)
    store.put_sidecar(idx)
    pts = np.random.RandomState(0).randn(32, 3).astype(np.float32)
    ref = bvh_closest_point(v, f, pts, index=idx, device="cpu")
    np.savez(tmp_path / "ref.npz", pts=pts,
             **{k: ref[k].numpy() for k in ("face", "point", "sqdist")})
    env = dict(os.environ, MESH_TPU_STORE_DIR=root, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=_REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, digest, str(tmp_path / "ref.npz")],
        capture_output=True, text=True, timeout=120, env=env, cwd=_REPO)
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    assert doc == {"identical": True, "sidecar_hits": 1, "build_misses": 0,
                   "jax": False}


# ---------------------------------------------------------------------------
# corruption: degrade, count, never crash


def _first_block(store, digest):
    spec = store.manifest(digest)["tiers"]["exact"]["v"][0]
    return os.path.join(store.object_dir(digest), spec["file"])


def _flip_last_byte(path):
    with open(path, "rb") as fh:
        data = bytearray(fh.read())
    data[-1] ^= 0xFF
    with open(path, "wb") as fh:
        fh.write(bytes(data))


def _corrupt(mode, store, digest):
    if mode == "truncated":
        path = _first_block(store, digest)
        with open(path, "r+b") as fh:
            fh.truncate(os.path.getsize(path) // 2)
    elif mode == "bitflip":
        _flip_last_byte(_first_block(store, digest))
    elif mode == "manifest":
        path = store.manifest_path(digest)
        with open(path) as fh:
            doc = json.load(fh)
        doc["digest"] = "deadbeef-deadbeef-v9-f9"
        with open(path, "w") as fh:
            json.dump(doc, fh)


@pytest.mark.parametrize("mode", ["truncated", "bitflip", "manifest"])
def test_corrupt_object_raises_and_counts(mode, tmp_path):
    v, f = soup(20)

    def run(pkg, store):
        digest = store.ingest(v, f)
        _corrupt(mode, store, digest)
        pkg.obs.reset()
        with pytest.raises(pkg.errors.StoreCorrupt) as err:
            store.open(digest)
        counts = {what: counter(pkg, "mesh_tpu_store_corrupt_total",
                                what=what)
                  for what in ("block_crc", "block_read", "manifest")}
        return err.value.what, counts, len(store.verify(digest)) > 0

    what, counts, flagged = same(run, tmp_path)
    assert flagged and counts[what] == 1


@pytest.mark.parametrize("mode", ["stale", "bad_array"])
def test_corrupt_sidecar_falls_back_to_host_build(mode, tmp_path,
                                                  monkeypatch):
    """A side-car whose digest drifted or whose array fails its CRC is not
    served: get_index counts the corruption and builds on the host."""
    v, f = soup(23, n_v=300, n_f=700)

    def run(pkg, store):
        monkeypatch.setenv("MESH_TPU_STORE_DIR", store.root)
        digest = store.ingest(v, f)
        store.put_sidecar(pkg.build.build_bvh(v, f))
        tag_dir = os.path.join(store.object_dir(digest), "sidecar", "bvh")
        if mode == "stale":
            path = os.path.join(tag_dir, "sidecar.json")
            with open(path) as fh:
                doc = json.load(fh)
            doc["digest"] = "deadbeef-deadbeef-v1-f1"
            with open(path, "w") as fh:
                json.dump(doc, fh)
        else:
            _flip_last_byte(os.path.join(tag_dir, "node_lo.npy"))
        pkg.build.clear_index_cache()
        pkg.obs.reset()
        idx = pkg.build.get_index(v, f, "bvh")
        return (idx.digest == digest, _get_index_counts(pkg)[:2],
                counter(pkg, "mesh_tpu_store_corrupt_total",
                        what="sidecar_digest"),
                counter(pkg, "mesh_tpu_store_corrupt_total",
                        what="sidecar_crc"),
                len(store.verify(digest)))

    ok, counts, stale, crc, problems = same(run, tmp_path)
    assert ok and counts == (0, 1) and problems == 1
    assert (stale, crc) == ((1, 0) if mode == "stale" else (0, 1))


def test_incident_is_rate_limited_to_one():
    from mesh_tpu_torch.obs.recorder import FlightRecorder
    from mesh_tpu_torch.store.store import report_corrupt

    t = [0.0]
    rec = FlightRecorder(clock=lambda: t[0])
    dumped = []
    rec._write = lambda incident, reason, seq: (
        dumped.append(incident) or "path")
    for _ in range(5):                                  # a hammered object
        report_corrupt("block_crc", "d-d-v1-f1", "test", recorder=rec)
    assert len(dumped) == 1 and dumped[0]["reason"] == "store_corrupt"
    t[0] = 60.0                                         # the window passes
    report_corrupt("block_crc", "d-d-v1-f1", "test", recorder=rec)
    assert len(dumped) == 2


# ---------------------------------------------------------------------------
# gc: LRU, budget, sequences


def _fill(store, n=4):
    digests = []
    for i in range(n):
        v, f = soup(30 + i, n_v=400, n_f=800)
        digests.append(store.ingest(v, f))
        store._touch(digests[-1])
    return digests


@pytest.mark.parametrize("scenario", ["lru", "budget", "dry_run", "noop"])
def test_gc_matches_reference(scenario, tmp_path):
    def run(pkg, store):
        digests = _fill(store)
        if scenario == "lru":
            store._touch(digests[0])
            return store.ls()[-1] == digests[0], sorted(store.ls())
        if scenario == "budget":
            keep = sum(store.object_bytes(d) for d in digests[2:]) + 1
            deleted = store.gc(budget_bytes=keep)
            return (deleted == digests[:2], sorted(store.ls()),
                    counter(pkg, "mesh_tpu_store_gc_deleted_total"),
                    store.verify())
        if scenario == "dry_run":
            return store.gc(budget_bytes=1, dry_run=True), len(store.ls())
        return store.gc(budget_bytes=1 << 40), len(store.ls())

    out = same(run, tmp_path)
    if scenario == "budget":
        assert out[0] and out[2] == 2 and out[3] == []


def _keyframe_with_sequences(pkg, store, seed, seqs=("walk",), n_frames=3):
    v, f = soup(seed, n_v=400, n_f=800)
    digest = store.ingest(v, f)
    for seq in seqs:
        pkg.deltas.write_sequence(
            store, digest, seq,
            [np.asarray(v + 0.01 * (k + 1), np.float32)
             for k in range(n_frames)])
    return digest


@pytest.mark.parametrize("scenario", [
    "pinned", "same_call", "all_sequences_first", "dry_run", "bytes"])
def test_sequence_gc_matches_reference(scenario, tmp_path):
    def run(pkg, store):
        if scenario == "all_sequences_first":
            d_key = _keyframe_with_sequences(pkg, store, 73,
                                             seqs=("walk", "run"))
            deleted = store.gc(budget_bytes=0)
            return (deleted[-1] == d_key,
                    sorted(deleted[:-1]) == sorted(
                        ["%s/walk" % d_key, "%s/run" % d_key]))
        d_key = _keyframe_with_sequences(pkg, store, 70)
        if scenario == "pinned":
            d_plain = store.ingest(*soup(71, n_v=400, n_f=800))
            store._touch(d_plain)
            deleted = store.gc(budget_bytes=store.object_bytes(d_key) + 1)
            return (deleted == ["%s/walk" % d_key, d_plain], store.ls(),
                    store.list_sequences(), store.verify())
        if scenario == "same_call":
            deleted = store.gc(budget_bytes=0)
            return (deleted == ["%s/walk" % d_key, d_key], store.ls(),
                    counter(pkg, "mesh_tpu_store_gc_deleted_total"))
        if scenario == "dry_run":
            return (store.gc(budget_bytes=0, dry_run=True)
                    == ["%s/walk" % d_key, d_key], store.ls(),
                    [s for _d, s in store.list_sequences()])
        return store.total_bytes() == (store.object_bytes(d_key)
                                       + store.sequence_bytes(d_key, "walk"))

    out = same(run, tmp_path)
    assert out is True or out[0] is True


# ---------------------------------------------------------------------------
# the page cache


def test_page_cache_miss_then_hit(tmp_path):
    v, f = soup(40)

    def run(pkg, store):
        digest = store.ingest(v, f)
        pkg.obs.reset()
        cache = pkg.store.PageCache(store=store)
        m1, src1 = cache.resolve(digest)
        m2, src2 = cache.resolve(digest)
        mc, src3 = cache.resolve(digest, tier="compact")
        assert m1 is m2 and np.array_equal(np.asarray(m1.v), v)
        return (src1, src2, src3, mc.tier, cache.info()["entries"],
                cache.info()["bytes"],
                counter(pkg, "mesh_tpu_store_page_cache_misses_total"),
                counter(pkg, "mesh_tpu_store_page_cache_hits_total"))

    assert same(run, tmp_path)[:5] == ("paged", "resident", "paged",
                                       "compact", 2)


def test_page_cache_budget_keeps_at_least_one(tmp_path):
    def run(pkg, store):
        d = [store.ingest(*soup(41 + i, n_v=500, n_f=900)) for i in range(3)]
        cache = pkg.store.PageCache(budget_bytes=1, store=store)
        for digest in d:
            cache.resolve(digest)
        entries = cache.info()["entries"]
        return entries, cache.resolve(d[-1])[1]

    assert same(run, tmp_path) == (1, "resident")


def test_page_cache_unknown_key_raises_store_error(tmp_path):
    def run(pkg, store):
        with pytest.raises(pkg.errors.StoreError) as err:
            pkg.store.PageCache(store=store).resolve(
                "0badc0de-0badc0de-v3-f1")
        return type(err.value).__name__

    assert same(run, tmp_path) == "StoreError"


# ---------------------------------------------------------------------------
# store-keyed serve requests


def _service(device="cpu"):
    from mesh_tpu_torch.serve import QueryService
    from mesh_tpu_torch.serve.health import HealthMonitor

    return QueryService(workers=1, default_deadline_s=60.0,
                        health=HealthMonitor(watchdog=False), device=device)


def test_serve_store_key_paged_then_resident(root):
    v, f = sphere(2)
    digest = tstore.get_store().ingest(v, f)
    pts = np.random.RandomState(1).randn(24, 3).astype(np.float32)
    svc = _service()
    try:
        tobs.reset()
        ref = svc.query(PORT.mesh(v=v, f=f), pts)
        r1 = svc.query(digest, pts)                          # page miss
        r2 = svc.query(digest, pts)                          # resident
    finally:
        svc.stop(write_stats=False)
    for resp in (r1, r2):
        assert np.array_equal(resp.faces, ref.faces)
        assert np.array_equal(resp.points, ref.points)
        assert resp.rung == ref.rung
    assert counter(PORT, "mesh_tpu_store_page_cache_misses_total") == 1
    assert counter(PORT, "mesh_tpu_store_page_cache_hits_total") == 1
    rows = tobs.LEDGER.records()
    assert [row.get("mesh_source") for row in rows][-3:] == [
        "inline", "paged", "resident"]
    keyed = [row for row in rows if row.get("store_key")]
    assert len(keyed) == 2
    assert all("page_in" in row["stages"] and row["store_key"] == digest
               for row in keyed)
    # the page cache keeps the store's own host arrays, on no device
    cached, _ = tstore.get_page_cache().resolve(digest)
    assert cached.device is None and not np.asarray(cached.v).flags.writeable


def test_serve_unknown_store_key_fails_one_request_only(root):
    v, f = sphere(1)
    pts = np.zeros((4, 3), np.float32)
    svc = _service()
    try:
        fut = svc.submit("0badc0de-0badc0de-v3-f1", pts, tenant="k")
        with pytest.raises(terrors.StoreError):
            fut.result(timeout=30)
        resp = svc.query(PORT.mesh(v=v, f=f), pts)
        assert resp.faces.shape[-1] == pts.shape[0]
    finally:
        svc.stop(write_stats=False)
    assert counter(PORT, "mesh_tpu_serve_requests_total", tenant="k",
                   outcome="error") == 1
    row = [r for r in tobs.get_ledger().records()
           if r.get("store_key")][-1]
    assert row["outcome"] == "error" and row["store_key"].startswith("0bad")
    assert "page_in" not in row["stages"]


def test_executor_coalesces_one_digest_and_keeps_tiers_apart(root):
    """Requests on one digest ride one dispatch; the exact and compact
    tiers of one digest share the dispatch's group key but each answers
    from its own vertices."""
    from mesh_tpu_torch.engine import EngineExecutor, stats

    v, f = sphere(2)
    store = tstore.get_store()
    digest = store.ingest(v, f)
    exact = store.open(digest).on("cpu")
    compact = store.open(digest, tier="compact").on("cpu")
    rng = np.random.RandomState(4)
    pts = [rng.randn(40, 3).astype(np.float32) for _ in range(3)]
    meshes = (exact, exact, compact)
    ex = EngineExecutor()
    try:
        alone = [ex.submit("closest_point", m, p).result(timeout=60)
                 for m, p in zip(meshes, pts)]
        before = stats()["coalesced"]["dispatches"]
        with ex.coalesce():
            futs = [ex.submit("closest_point", m, p)
                    for m, p in zip(meshes, pts)]
        together = [fut.result(timeout=60) for fut in futs]
        after = stats()["coalesced"]["dispatches"]
    finally:
        ex.shutdown()
    assert after - before == 1
    for (fa, pa), (ft, pt) in zip(alone, together):
        assert np.array_equal(fa, ft) and np.array_equal(pa, pt)
    assert not np.array_equal(np.asarray(exact.v), np.asarray(compact.v))
