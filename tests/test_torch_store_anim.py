"""mesh_tpu_torch.store.deltas and store-keyed avatar sessions vs the
reference's, on the CPU.

A sequence of absolute frames written through either package has the same
manifest (but its wall-clock ``created_utc``) and the same delta blocks,
and decodes to the same bits in both packages, within the manifest's
stated tolerance of the frames written.  Frames open through the
``anim:<sequence>:<frame>`` tier and page in through the page cache.  An
``AvatarSession(digest=..., device="cpu")`` opens its keyframe from the
store and answers frame for frame as a session built from the same mesh,
bit for bit, and as the reference's store-keyed session under the tie
contract (sqdist within 1e-5, faces equal except at ties).
"""

import json
import os

import numpy as np
import pytest
import torch

import mesh_tpu.errors as jerrors
import mesh_tpu.obs as jobs
import mesh_tpu.store as jstore
from mesh_tpu.accel import build as jbuild
from mesh_tpu.anim import AvatarSession as JaxSession
from mesh_tpu.store import deltas as jdeltas

import mesh_tpu_torch
import mesh_tpu_torch.errors as terrors
import mesh_tpu_torch.obs as tobs
import mesh_tpu_torch.store as tstore
from mesh_tpu_torch.accel import build as tbuild
from mesh_tpu_torch.anim import AvatarSession
from mesh_tpu_torch.store import deltas as tdeltas

from .test_torch_anim import assert_tie_answers, deform, sphere
from .test_torch_culled import surface_queries

torch.set_num_threads(2)

N_FRAMES = 4


@pytest.fixture(autouse=True)
def root(tmp_path, monkeypatch):
    path = str(tmp_path / "store")
    monkeypatch.setenv("MESH_TPU_STORE_DIR", path)
    monkeypatch.setenv("MESH_TPU_INCIDENT_DIR", str(tmp_path / "incidents"))
    for pkg_store, build, obs in ((tstore, tbuild, tobs),
                                  (jstore, jbuild, jobs)):
        pkg_store.clear_page_cache()
        build.clear_index_cache()
        obs.reset()
    yield path
    for pkg_store, build in ((tstore, tbuild), (jstore, jbuild)):
        pkg_store.clear_page_cache()
        build.clear_index_cache()


def frames_of(v, n=N_FRAMES):
    """Absolute frames: small random deformations, one scaled 1.5x."""
    out = [deform(v, 40 + k, amp=0.02) for k in range(n - 1)]
    return out + [np.asarray(v * 1.5, np.float32)]


def published(store_mod, deltas_mod, root, v, f, seq="walk"):
    store = store_mod.MeshStore(root)
    digest = store.ingest(v, f)
    manifest = deltas_mod.write_sequence(store, digest, seq, frames_of(v))
    return store, digest, manifest


def sequence_files(store, digest, seq):
    base = store.sequence_dir(digest, seq)
    out = {}
    for name in sorted(os.listdir(base)):
        if name.endswith(".npy"):
            with open(os.path.join(base, name), "rb") as fh:
                out[name] = fh.read()
    return out


def test_sequence_matches_reference_bytes_and_bits(tmp_path):
    v, f = sphere(2)
    frames = frames_of(v)
    mine = published(tstore, tdeltas, str(tmp_path / "port"), v, f)
    ref = published(jstore, jdeltas, str(tmp_path / "ref"), v, f)
    assert mine[1] == ref[1]
    strip = [{k: x for k, x in m.items() if k != "created_utc"}
             for m in (mine[2], ref[2])]
    assert strip[0] == strip[1]
    assert mine[2]["schema_version"] == 2
    assert sequence_files(mine[0], mine[1], "walk") == sequence_files(
        ref[0], ref[1], "walk")
    tol = tdeltas.sequence_tolerance(mine[2])
    assert tol == jdeltas.sequence_tolerance(ref[2]) and tol > 0
    for k, frame in enumerate(frames):
        got, faces, _ = tdeltas.read_frame(mine[0], mine[1], "walk", k)
        want, _, _ = jdeltas.read_frame(ref[0], ref[1], "walk", k)
        assert got.dtype == np.float32 and np.array_equal(got, want)
        assert np.array_equal(faces, f)
        assert float(np.max(np.abs(got.astype(np.float64)
                                   - frame.astype(np.float64)))) <= tol


@pytest.mark.parametrize("writer,reader", [
    ((jstore, jdeltas), (tstore, tdeltas)),
    ((tstore, tdeltas), (jstore, jdeltas))], ids=["ref_to_port",
                                                  "port_to_ref"])
def test_sequence_opens_in_the_other_package(writer, reader, root):
    v, f = sphere(2)
    _, digest, _ = published(*writer, root, v, f)
    w, r = writer[0].MeshStore(root), reader[0].MeshStore(root)
    assert r.list_sequences() == [(digest, "walk")]
    for k in range(N_FRAMES):
        tier = reader[1].frame_tier("walk", k)
        assert tier == "anim:walk:%d" % k
        got = r.open(digest, tier=tier)
        want = w.open(digest, tier=writer[1].frame_tier("walk", k))
        assert got.tier == tier and np.array_equal(got.v, want.v)
        assert np.array_equal(got.f, want.f)
    assert reader[1].verify_sequence(r, digest, "walk") == []
    assert r.verify() == []


def test_sequence_errors_match_reference(root, tmp_path):
    v, f = sphere(1)

    def run(store_mod, deltas_mod, errors, name):
        store = store_mod.MeshStore(str(tmp_path / name))
        out = []
        with pytest.raises(errors.StoreError) as err:   # keyframe absent
            deltas_mod.write_sequence(store, tbuild.topology_digest(v, f),
                                      "walk", [v])
        out.append(type(err.value).__name__)
        digest = store.ingest(v, f)
        for seq, frames in (("walk", []), ("walk", [v[:3]]),
                            ("bad:id", [v]), (".hidden", [v])):
            with pytest.raises(errors.StoreError) as err:
                deltas_mod.write_sequence(store, digest, seq, frames)
            out.append(str(err.value).split(" ")[0])
        for tier in ("anim:walk", "anim:walk:x"):
            with pytest.raises(errors.StoreError):
                deltas_mod.parse_tier(tier)
        assert deltas_mod.parse_tier("exact") is None
        assert deltas_mod.parse_tier("anim:a:b:7") == ("a:b", 7)
        first = deltas_mod.write_sequence(store, digest, "walk", [v + 0.1])
        again = deltas_mod.write_sequence(store, digest, "walk", [v])
        out.append(first == again)                       # dedupe by name
        with pytest.raises(errors.StoreError, match="no frame"):
            deltas_mod.read_frame(store, digest, "walk", 5)
        return out

    assert run(tstore, tdeltas, terrors, "port") == run(
        jstore, jdeltas, jerrors, "ref")


def test_corrupt_frame_is_found_by_both(tmp_path):
    v, f = sphere(2)

    def run(store_mod, deltas_mod, errors, obs, name):
        store, digest, manifest = published(store_mod, deltas_mod,
                                            str(tmp_path / name), v, f)
        path = os.path.join(store.sequence_dir(digest, "walk"),
                            manifest["blocks"][1]["file"])
        with open(path, "rb") as fh:
            data = bytearray(fh.read())
        data[-1] ^= 0xFF
        with open(path, "wb") as fh:
            fh.write(bytes(data))
        obs.reset()
        with pytest.raises(errors.StoreCorrupt):
            deltas_mod.read_frame(store, digest, "walk", 1)
        problems = deltas_mod.verify_sequence(store, digest, "walk")
        return (len(problems), obs.REGISTRY.get(
            "mesh_tpu_store_corrupt_total").value(what="block_crc"))

    assert run(tstore, tdeltas, terrors, tobs, "port") == run(
        jstore, jdeltas, jerrors, jobs, "ref") == (1, 2)


def test_resolve_frame_pages_then_stays_resident(root):
    v, f = sphere(2)
    _, digest, _ = published(tstore, tdeltas, root, v, f)
    m1, src1 = tdeltas.resolve_frame(digest, "walk", 2)
    m2, src2 = tdeltas.resolve_frame(digest, "walk", 2)
    _, src3 = tdeltas.resolve_frame(digest, "walk", 3)
    assert (src1, src2, src3) == ("paged", "resident", "paged")
    assert m1 is m2 and m1.tier == "anim:walk:2"
    assert tstore.get_page_cache().info()["entries"] == 2
    tstore.get_page_cache().drop(digest)
    assert tstore.get_page_cache().info()["entries"] == 0


@pytest.mark.parametrize("leaf_size", [None, 256])
def test_store_keyed_session_answers_as_the_mesh_session(leaf_size, root):
    v, f = sphere()
    _, digest, _ = published(tstore, tdeltas, root, v, f)
    mine = AvatarSession(digest=digest, leaf_size=leaf_size, device="cpu")
    plain = AvatarSession(mesh_tpu_torch.Mesh(v, f, device="cpu"),
                          leaf_size=leaf_size, device="cpu")
    ref = JaxSession(digest=digest, store=jstore.MeshStore(root),
                     leaf_size=leaf_size)
    with mine, plain, ref:
        assert mine.digest == plain.digest == ref.digest == digest
        assert np.array_equal(mine.v_key, plain.v_key)
        assert np.array_equal(mine.f, plain.f)
        for k in range(N_FRAMES):
            frame, _ = tdeltas.resolve_frame(digest, "walk", k)
            verts = np.array(frame.v)
            pts = surface_queries(verts, f, 200, seed=60 + k)
            out = mine.frame(vertices=verts, points=pts)
            same = plain.frame(vertices=verts, points=pts)
            want = ref.frame(vertices=verts, points=pts)
            assert out["action"] == same["action"] == want["action"]
            for key in ("faces", "points", "sqdist"):
                assert np.array_equal(out[key], same[key]), key
            assert_tie_answers(
                {"face": want["faces"], "point": want["points"],
                 "sqdist": want["sqdist"], "part": np.zeros(len(pts))},
                {"face": out["faces"], "point": out["points"],
                 "sqdist": out["sqdist"], "part": np.zeros(len(pts))},
                verts, f, pts)


def test_session_needs_a_mesh_or_a_stored_digest(root):
    with pytest.raises(ValueError, match="keyframe mesh"):
        AvatarSession(device="cpu")
    with pytest.raises(terrors.StoreError, match="no object"):
        AvatarSession(digest="0badc0de-0badc0de-v3-f1", device="cpu")
    v, f = sphere(1)
    store = tstore.MeshStore(root)
    digest = store.ingest(v, f)
    with AvatarSession(digest=digest, store=store, device="cpu") as sess:
        assert sess.v_key.flags.writeable and sess.f.flags.writeable
        out = sess.frame(delta=np.zeros_like(v), points=v[:8])
        assert np.allclose(out["sqdist"], 0.0, atol=1e-10)
    manifest = json.loads(open(store.manifest_path(digest)).read())
    assert manifest["digest"] == digest
