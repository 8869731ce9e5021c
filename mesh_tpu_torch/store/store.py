"""MeshStore: the content-addressed on-disk mesh corpus (a copy of
mesh_tpu/store/store.py: the same layout, manifests, CRCs, metric and
span names, so a store written by either package opens in the other).

Layout under one root (``MESH_TPU_STORE_DIR``)::

    <root>/objects/<digest>/manifest.json      object manifest (schema 2)
    <root>/objects/<digest>/exact/v_0000.npy   chunked exact-tier blocks
    <root>/objects/<digest>/compact/v_0000.npy quantized uint16 blocks
    <root>/objects/<digest>/sidecar/<tag>/     serialized AccelIndex
    <root>/objects/<digest>/last_used          LRU touch file (gc order)
    <root>/sequences/<digest>/<seq>/           anim delta frames (deltas.py)
    <root>/tmp/<digest>.<pid>.<n>/             staging (same filesystem)

Publishing is write-then-rename: an object is staged complete under
``tmp/`` and becomes visible with ONE ``os.rename`` of the directory,
so readers never observe a half-written object and two processes racing
the same digest publish exactly one copy (the rename loser discards its
staging and adopts the winner's object — content addressing makes both
byte-equivalent).  Every block CRC is verified on read; any mismatch
raises :class:`~mesh_tpu_torch.errors.StoreCorrupt` after counting
``mesh_tpu_store_corrupt_total`` and dropping one rate-limited
flight-recorder incident — corruption is loud but never a crash loop.

The reference's XLA executable tier (``store/aot.py``, under ``aot/``)
has no counterpart here: the port's compiled artefacts are its nvcc
extensions, built into the checkout's ``build/``.
"""

import json
import os
import shutil
import threading

import numpy as np

from ..errors import StoreCorrupt, StoreError
from ..obs.clock import monotonic, wall
from ..obs.trace import span as obs_span
from ..utils import knobs
from .blocks import (
    block_spans, dequantize_rows, quantize_rows, read_block, write_block,
)

__all__ = [
    "MeshStore", "StoredMesh", "default_store_root", "get_store",
    "MANIFEST_SCHEMA_VERSION",
]

#: manifest.json schema (bump on breaking shape changes); 2 adds the
#: ``anim_sequence`` manifest family under ``sequences/`` (store/deltas.py)
MANIFEST_SCHEMA_VERSION = 2

_STAGE_LOCK = threading.Lock()
_STAGE_SEQ = [0]


def default_store_root():
    """``MESH_TPU_STORE_DIR`` (expanded), default
    ``~/.mesh_tpu_torch/store`` (the reference's path shape under the
    port's own name; point both packages' knob at one root to share it)."""
    return os.path.expanduser(
        knobs.get_str("MESH_TPU_STORE_DIR", None)
        or os.path.join("~", ".mesh_tpu_torch", "store"))


_STORE = None
_STORE_LOCK = threading.Lock()


def get_store(root=None):
    """The process-wide :class:`MeshStore` over the knob-configured root
    (rebuilt when the knob moves the root, so tests can repoint it)."""
    global _STORE
    root = os.path.abspath(root or default_store_root())
    with _STORE_LOCK:
        if _STORE is None or _STORE.root != root:
            _STORE = MeshStore(root)
        return _STORE


def _metrics():
    from ..obs.metrics import REGISTRY

    return {
        "ingest": REGISTRY.counter(
            "mesh_tpu_store_ingest_total",
            "Meshes published into the store (label: tier — exact objects "
            "always, compact when the quantized tier is written, anim per "
            "delta sequence)."),
        "dedupe": REGISTRY.counter(
            "mesh_tpu_store_dedupe_total",
            "Ingests that found the digest already published (no bytes "
            "written)."),
        "corrupt": REGISTRY.counter(
            "mesh_tpu_store_corrupt_total",
            "Store reads that failed digest/CRC verification (label: what "
            "— block_crc / block_read / manifest / sidecar_digest / "
            "sidecar_crc / sidecar_meta / aot_meta / aot_version / "
            "aot_crc)."),
        "gc": REGISTRY.counter(
            "mesh_tpu_store_gc_deleted_total",
            "Objects and anim sequences deleted by the size-budgeted LRU "
            "gc."),
        "sidecar_writes": REGISTRY.counter(
            "mesh_tpu_store_sidecar_writes_total",
            "AccelIndex side-cars persisted next to store objects "
            "(label: kind)."),
        "bytes": REGISTRY.gauge(
            "mesh_tpu_store_bytes",
            "Total payload bytes across published objects (refreshed on "
            "ingest and gc)."),
        "open_hist": REGISTRY.histogram(
            "mesh_tpu_store_open_seconds",
            "Wall seconds to open (CRC-verify + map) one stored mesh "
            "(label: tier)."),
    }


def report_corrupt(what, digest, detail, recorder=None):
    """Count + flight-record one corruption observation.  The incident
    trigger is rate-limited (recorder default interval), so a corrupt
    object hammered by traffic produces one forensic dump, not a pile."""
    from ..obs.recorder import get_recorder

    _metrics()["corrupt"].inc(what=what)
    rec = recorder or get_recorder()
    rec.record("store.corrupt", what=what, digest=digest, detail=detail)
    rec.trigger("store_corrupt",
                context={"what": what, "digest": digest, "detail": detail})


class StoredMesh(object):
    """A (possibly mmap-backed) ``(v, f)`` holder straight off the
    store — duck-type compatible with every facade/engine/serve path
    that reads ``mesh.v`` / ``mesh.f`` (batch.stack_mesh_batch,
    serve/deadline._mesh_tensors).  ``topology_key`` short-circuits the
    engine executor's coalescing-key CRC.  ``device`` is where a serving
    path runs the mesh: None (the store's own) is the card, as for every
    entry point; ``on("cpu")`` gives a holder of the same arrays that runs
    on the CPU.  The arrays stay on the host either way."""

    __slots__ = ("v", "f", "digest", "tier", "manifest", "device")

    def __init__(self, v, f, digest, tier, manifest, device=None):
        self.v = v
        self.f = f
        self.digest = digest
        self.tier = tier
        self.manifest = manifest
        self.device = device

    def on(self, device):
        """A holder of the same (uncopied) arrays whose serving paths run
        on ``device``."""
        return StoredMesh(self.v, self.f, self.digest, self.tier,
                          self.manifest, device=device)

    @property
    def topology_key(self):
        return self.digest

    def nbytes(self):
        return int(np.asarray(self.v).nbytes + np.asarray(self.f).nbytes)

    def to_mesh(self, device="cuda"):
        """A port :class:`~mesh_tpu_torch.mesh.Mesh` of copies of the
        arrays, on ``device`` (the card unless ``"cpu"``)."""
        from ..mesh import Mesh

        return Mesh(v=np.array(self.v), f=np.array(self.f), device=device)

    def __repr__(self):
        return "StoredMesh(digest=%r, tier=%r, v=%s, f=%s)" % (
            self.digest, self.tier, np.asarray(self.v).shape,
            np.asarray(self.f).shape)


class MeshStore(object):
    """One content-addressed corpus root; every method is safe to call
    concurrently from many threads/processes (publish is an atomic
    rename, reads only see published objects)."""

    def __init__(self, root=None):
        self.root = os.path.abspath(root or default_store_root())

    # -- paths ---------------------------------------------------------

    @property
    def objects_dir(self):
        return os.path.join(self.root, "objects")

    def object_dir(self, digest):
        self._check_key(digest)
        return os.path.join(self.objects_dir, digest)

    def manifest_path(self, digest):
        return os.path.join(self.object_dir(digest), "manifest.json")

    @staticmethod
    def _check_key(digest):
        if (not digest or os.path.sep in digest or digest != digest.strip()
                or digest.startswith(".")):
            raise StoreError("malformed store key %r" % (digest,))

    def _stage_dir(self, digest):
        with _STAGE_LOCK:
            _STAGE_SEQ[0] += 1
            seq = _STAGE_SEQ[0]
        stage = os.path.join(
            self.root, "tmp", "%s.%d.%d" % (digest, os.getpid(), seq))
        os.makedirs(stage)
        return stage

    def exists(self, digest):
        return os.path.isfile(self.manifest_path(digest))

    # -- ingest --------------------------------------------------------

    def ingest(self, v, f, source=None, block_rows=None, compact=None):
        """Publish ``(v, f)`` and return the store key (topology digest).

        Dedupe by content: an already-published digest touches the LRU
        stamp and returns immediately.  Otherwise the object is staged
        complete under ``tmp/`` (exact tier in the arrays' own dtypes,
        plus the quantized compact tier unless disabled) and published
        with one atomic directory rename — a lost publish race adopts
        the winner's object, so concurrent ingests of one digest yield
        exactly one copy."""
        from ..accel.build import topology_digest

        v = np.ascontiguousarray(np.asarray(v))
        f = np.ascontiguousarray(np.asarray(f))
        if v.ndim != 2 or v.shape[1] != 3:
            raise StoreError("vertices must be (N, 3), got %s"
                             % (v.shape,))
        if f.size and (f.ndim != 2 or f.shape[1] != 3):
            raise StoreError("faces must be (F, 3), got %s" % (f.shape,))
        f = f.reshape(-1, 3) if f.size else f.reshape(0, 3)
        digest = topology_digest(v, f)
        metrics = _metrics()
        with obs_span("store.ingest", digest=digest,
                      verts=int(v.shape[0]), faces=int(f.shape[0])) as sp:
            if self.exists(digest):
                metrics["dedupe"].inc()
                self._touch(digest)
                sp.set(dedupe=True)
                return digest
            if block_rows is None:
                block_rows = knobs.get_int("MESH_TPU_STORE_BLOCK_ROWS")
            if compact is None:
                compact = knobs.flag("MESH_TPU_STORE_COMPACT")
            stage = self._stage_dir(digest)
            try:
                manifest = self._write_object(stage, digest, v, f,
                                              block_rows, bool(compact),
                                              source)
                self._publish(stage, digest)
            finally:
                shutil.rmtree(stage, ignore_errors=True)
            metrics["ingest"].inc(tier="exact")
            if "compact" in manifest["tiers"]:
                metrics["ingest"].inc(tier="compact")
            metrics["bytes"].set(float(self.total_bytes()))
            sp.set(dedupe=False, bytes=manifest["bytes"])
        return digest

    def _write_object(self, stage, digest, v, f, block_rows, compact,
                      source):
        os.makedirs(os.path.join(stage, "exact"))
        tiers = {"exact": {}}
        total = 0
        for name, arr in (("v", v), ("f", f)):
            entries = []
            for i, (a, b) in enumerate(
                    block_spans(arr.shape[0], block_rows)):
                rel = "exact/%s_%04d.npy" % (name, i)
                crc, rows, nbytes = write_block(
                    os.path.join(stage, rel), arr[a:b])
                entries.append({"file": rel, "rows": rows, "crc32": crc})
                total += nbytes
            tiers["exact"][name] = entries
        if compact and v.size:
            os.makedirs(os.path.join(stage, "compact"))
            entries = []
            tolerance = 0.0
            for i, (a, b) in enumerate(block_spans(v.shape[0], block_rows)):
                q, lo, scale, tol = quantize_rows(v[a:b])
                rel = "compact/v_%04d.npy" % i
                crc, rows, nbytes = write_block(os.path.join(stage, rel), q)
                entries.append({
                    "file": rel, "rows": rows, "crc32": crc,
                    "lo": [float(x) for x in lo],
                    "scale": [float(x) for x in scale],
                })
                tolerance = max(tolerance, tol)
                total += nbytes
            tiers["compact"] = {"dtype": "uint16", "v": entries,
                                "tolerance": tolerance}
        manifest = {
            "schema_version": MANIFEST_SCHEMA_VERSION,
            "digest": digest,
            "created_utc": wall(),
            "n_vertices": int(v.shape[0]),
            "n_faces": int(f.shape[0]),
            "v_dtype": str(v.dtype),
            "f_dtype": str(f.dtype),
            "block_rows": int(max(1, block_rows)),
            "bytes": int(total),
            "tiers": tiers,
        }
        if source:
            manifest["source"] = dict(source)
        with open(os.path.join(stage, "manifest.json"), "w") as fh:
            json.dump(manifest, fh, indent=1, sort_keys=True)
            fh.write("\n")
        return manifest

    def _publish(self, stage, digest):
        os.makedirs(self.objects_dir, exist_ok=True)
        dest = self.object_dir(digest)
        try:
            os.rename(stage, dest)
        except OSError:
            # publish race (or leftover object): content addressing means
            # the published copy is byte-equivalent — adopt it
            if not self.exists(digest):
                raise
        self._touch(digest)

    def _touch(self, digest):
        # LRU stamp is a sibling touch file so the manifest stays
        # immutable (mmap readers never see it change)
        try:
            path = os.path.join(self.object_dir(digest), "last_used")
            with open(path, "a"):
                os.utime(path, None)
        except OSError:
            pass

    # -- read ----------------------------------------------------------

    def manifest(self, digest):
        """The parsed manifest; StoreError when absent, StoreCorrupt
        (counted + flight-recorded) when unreadable or digest-drifted."""
        path = self.manifest_path(digest)
        if not os.path.isfile(path):
            raise StoreError("no object %r in store %s"
                             % (digest, self.root))
        try:
            with open(path) as fh:
                manifest = json.load(fh)
        except (OSError, ValueError) as exc:
            report_corrupt("manifest", digest, str(exc))
            raise StoreCorrupt("manifest for %s unreadable: %s"
                               % (digest, exc), what="manifest",
                               digest=digest)
        if manifest.get("digest") != digest:
            detail = ("manifest says digest %r" % manifest.get("digest"))
            report_corrupt("manifest", digest, detail)
            raise StoreCorrupt(
                "object %s manifest digest drift (%s)" % (digest, detail),
                what="manifest", digest=digest)
        return manifest

    def _tier_array(self, digest, manifest, tier, name, verify, mmap):
        entries = (manifest["tiers"].get(tier) or {}).get(name)
        if entries is None:
            raise StoreError("object %s has no %s/%s tier"
                             % (digest, tier, name))
        blocks = []
        for entry in entries:
            path = os.path.join(self.object_dir(digest), entry["file"])
            try:
                block = read_block(path, entry.get("crc32"), verify=verify,
                                   mmap=mmap)
            except StoreCorrupt as exc:
                report_corrupt(exc.what, digest, str(exc))
                raise StoreCorrupt(str(exc), what=exc.what, digest=digest)
            if int(block.shape[0]) != int(entry["rows"]):
                detail = ("%s has %d rows, manifest says %s"
                          % (entry["file"], block.shape[0], entry["rows"]))
                report_corrupt("block_read", digest, detail)
                raise StoreCorrupt("object %s truncated: %s"
                                   % (digest, detail), what="block_read",
                                   digest=digest)
            blocks.append(block)
        if not blocks:
            dtype = manifest["v_dtype"] if name == "v" \
                else manifest["f_dtype"]
            return np.zeros((0, 3), np.dtype(dtype))
        if len(blocks) == 1:
            return blocks[0]      # single block: stays mmap, zero-copy
        return np.concatenate([np.asarray(b) for b in blocks], axis=0)

    def open(self, digest, tier="exact", verify=None, mmap=True):
        """A :class:`StoredMesh` for ``digest``.  ``tier="exact"`` is a
        bit-identical (mmap-backed when single-block) view; ``compact``
        dequantizes the uint16 tier to float32 within the manifest's
        stated tolerance; ``anim:<sequence>:<frame>`` reconstructs one
        animation frame from the keyframe plus its quantized delta
        (store/deltas.py).  Every block CRC is checked unless
        ``MESH_TPU_STORE_VERIFY`` (or ``verify=``) turns it off."""
        if verify is None:
            verify = knobs.flag("MESH_TPU_STORE_VERIFY")
        if isinstance(tier, str) and tier.startswith("anim:"):
            from . import deltas as deltas_mod

            t0 = monotonic()
            with obs_span("store.open", digest=digest, tier=tier):
                mesh = deltas_mod.open_frame(self, digest, tier,
                                             verify=verify, mmap=mmap)
            _metrics()["open_hist"].observe(monotonic() - t0, tier="anim")
            return mesh
        t0 = monotonic()
        with obs_span("store.open", digest=digest, tier=tier):
            manifest = self.manifest(digest)
            faces = self._tier_array(digest, manifest, "exact", "f",
                                     verify, mmap)
            if tier == "exact":
                verts = self._tier_array(digest, manifest, "exact", "v",
                                         verify, mmap)
            elif tier == "compact":
                spec = manifest["tiers"].get("compact")
                if not spec:
                    raise StoreError("object %s has no compact tier"
                                     % digest)
                parts = []
                for entry in spec["v"]:
                    path = os.path.join(self.object_dir(digest),
                                        entry["file"])
                    try:
                        q = read_block(path, entry.get("crc32"),
                                       verify=verify, mmap=mmap)
                    except StoreCorrupt as exc:
                        report_corrupt(exc.what, digest, str(exc))
                        raise StoreCorrupt(str(exc), what=exc.what,
                                           digest=digest)
                    parts.append(dequantize_rows(
                        q, entry["lo"], entry["scale"]))
                verts = (np.concatenate(parts, axis=0) if parts
                         else np.zeros((0, 3), np.float32))
            else:
                raise StoreError(
                    "unknown tier %r (exact|compact|anim:<seq>:<frame>)"
                    % tier)
        self._touch(digest)
        _metrics()["open_hist"].observe(monotonic() - t0, tier=tier)
        return StoredMesh(verts, faces, digest, tier, manifest)

    # -- inventory / verify / gc --------------------------------------

    def ls(self):
        """Published digests, oldest-LRU first."""
        try:
            names = sorted(os.listdir(self.objects_dir))
        except FileNotFoundError:
            return []               # a fresh root IS an empty store; any
                                    # other OSError (file-as-root, perms)
                                    # must surface as unreadable instead
        out = [n for n in names
               if os.path.isfile(os.path.join(self.objects_dir, n,
                                              "manifest.json"))]
        out.sort(key=lambda n: self._last_used(n))
        return out

    def _last_used(self, digest):
        for name in ("last_used", "manifest.json"):
            try:
                return os.path.getmtime(
                    os.path.join(self.object_dir(digest), name))
            except OSError:
                continue
        return 0.0

    def stat(self, digest):
        """Manifest + size/sidecar summary for one object."""
        manifest = self.manifest(digest)
        return {
            "digest": digest,
            "n_vertices": manifest.get("n_vertices"),
            "n_faces": manifest.get("n_faces"),
            "v_dtype": manifest.get("v_dtype"),
            "f_dtype": manifest.get("f_dtype"),
            "bytes": self.object_bytes(digest),
            "tiers": sorted(manifest.get("tiers") or {}),
            "sidecars": self.sidecar_tags(digest),
            "created_utc": manifest.get("created_utc"),
            "source": manifest.get("source"),
        }

    def object_bytes(self, digest):
        total = 0
        for dirpath, _dirs, files in os.walk(self.object_dir(digest)):
            for name in files:
                try:
                    total += os.path.getsize(os.path.join(dirpath, name))
                except OSError:
                    pass
        return int(total)

    def total_bytes(self):
        return int(sum(self.object_bytes(d) for d in self.ls())
                   + sum(self.sequence_bytes(d, s)
                         for d, s in self.list_sequences()))

    # -- anim sequences (codec lives in deltas.py) ---------------------

    @property
    def sequences_dir(self):
        return os.path.join(self.root, "sequences")

    def sequence_dir(self, digest, sequence_id):
        from . import deltas as deltas_mod

        self._check_key(digest)
        deltas_mod.check_sequence_id(sequence_id)
        return os.path.join(self.sequences_dir, digest, sequence_id)

    def list_sequences(self, digest=None):
        """Published ``(digest, sequence_id)`` pairs, oldest-LRU
        first (restricted to one keyframe digest when given)."""
        try:
            digests = [digest] if digest else sorted(
                os.listdir(self.sequences_dir))
        except FileNotFoundError:
            return []
        out = []
        for d in digests:
            base = os.path.join(self.sequences_dir, d)
            try:
                names = sorted(os.listdir(base))
            except OSError:
                continue
            out.extend(
                (d, s) for s in names
                if os.path.isfile(os.path.join(base, s, "manifest.json")))
        out.sort(key=lambda ds: self._seq_last_used(*ds))
        return out

    def sequence_manifest(self, digest, sequence_id, missing_ok=False):
        """The parsed sequence manifest; StoreError when absent (None
        with ``missing_ok``), StoreCorrupt (counted + flight-recorded)
        when unreadable or key-drifted."""
        path = os.path.join(self.sequence_dir(digest, sequence_id),
                            "manifest.json")
        if not os.path.isfile(path):
            if missing_ok:
                return None
            raise StoreError("no sequence %s/%s in store %s"
                             % (digest, sequence_id, self.root))
        try:
            with open(path) as fh:
                manifest = json.load(fh)
        except (OSError, ValueError) as exc:
            report_corrupt("manifest", digest, str(exc))
            raise StoreCorrupt(
                "sequence %s/%s manifest unreadable: %s"
                % (digest, sequence_id, exc), what="manifest",
                digest=digest)
        if (manifest.get("kind") != "anim_sequence"
                or manifest.get("digest") != digest
                or manifest.get("sequence_id") != sequence_id):
            detail = ("manifest says %s/%s kind %r"
                      % (manifest.get("digest"),
                         manifest.get("sequence_id"),
                         manifest.get("kind")))
            report_corrupt("manifest", digest, detail)
            raise StoreCorrupt(
                "sequence %s/%s manifest drift (%s)"
                % (digest, sequence_id, detail), what="manifest",
                digest=digest)
        return manifest

    def _publish_sequence(self, stage, digest, sequence_id):
        dest = self.sequence_dir(digest, sequence_id)
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        try:
            os.rename(stage, dest)
        except OSError:
            # publish race: the sequence is keyed by name, both writers
            # quantized against the same published keyframe — adopt
            if self.sequence_manifest(digest, sequence_id,
                                      missing_ok=True) is None:
                raise
        self._touch_sequence(digest, sequence_id)

    def _touch_sequence(self, digest, sequence_id):
        try:
            path = os.path.join(self.sequence_dir(digest, sequence_id),
                                "last_used")
            with open(path, "a"):
                os.utime(path, None)
        except OSError:
            pass

    def _seq_last_used(self, digest, sequence_id):
        for name in ("last_used", "manifest.json"):
            try:
                return os.path.getmtime(os.path.join(
                    self.sequence_dir(digest, sequence_id), name))
            except OSError:
                continue
        return 0.0

    def sequence_bytes(self, digest, sequence_id):
        total = 0
        for dirpath, _dirs, files in os.walk(
                self.sequence_dir(digest, sequence_id)):
            for name in files:
                try:
                    total += os.path.getsize(os.path.join(dirpath, name))
                except OSError:
                    pass
        return int(total)

    def delete_sequence(self, digest, sequence_id):
        shutil.rmtree(self.sequence_dir(digest, sequence_id),
                      ignore_errors=True)
        # drop the now-empty per-digest directory so ls-style scans of
        # sequences/ stay proportional to live sequences
        try:
            os.rmdir(os.path.join(self.sequences_dir, digest))
        except OSError:
            pass

    def verify(self, digest=None, deep=True):
        """Verify one object (or every object): block CRCs, manifest
        digest, side-car digests/CRCs, delta sequences.  ``deep``
        additionally recomputes the topology digest from the exact tier.  Returns a list of
        problem strings (empty = clean); each problem is also counted
        and flight-recorded."""
        if digest and not self.exists(digest):
            # naming an absent object is an argument error (CLI rc 2),
            # not a corruption finding
            raise StoreError("no such object %s" % digest)
        digests = [digest] if digest else self.ls()
        problems = []
        with obs_span("store.verify", objects=len(digests)):
            from . import deltas as deltas_mod

            for d in digests:
                problems.extend(self._verify_one(d, deep))
                for _d, seq in self.list_sequences(d):
                    problems.extend(
                        deltas_mod.verify_sequence(self, d, seq))
        return problems

    def _verify_one(self, digest, deep):
        from ..accel.build import topology_digest

        problems = []
        try:
            mesh = self.open(digest, verify=True)
        except (StoreError, StoreCorrupt) as exc:
            return ["%s: %s" % (digest, exc)]
        if deep:
            actual = topology_digest(mesh.v, mesh.f)
            if actual != digest:
                detail = "exact tier recomputes to %s" % actual
                report_corrupt("manifest", digest, detail)
                problems.append("%s: digest drift (%s)" % (digest, detail))
        spec = mesh.manifest["tiers"].get("compact")
        if spec:
            try:
                compact = self.open(digest, tier="compact", verify=True)
                err = float(np.max(np.abs(
                    np.asarray(compact.v, np.float64)
                    - np.asarray(mesh.v, np.float64)))) if mesh.v.size \
                    else 0.0
                if err > spec["tolerance"]:
                    report_corrupt(
                        "block_crc", digest,
                        "compact tier error %.3g > tolerance %.3g"
                        % (err, spec["tolerance"]))
                    problems.append(
                        "%s: compact tier error %.3g exceeds stated "
                        "tolerance %.3g" % (digest, err, spec["tolerance"]))
            except (StoreError, StoreCorrupt) as exc:
                problems.append("%s: %s" % (digest, exc))
        problems.extend(
            "%s: %s" % (digest, p)
            for p in self._verify_sidecars(digest))
        return problems

    def _verify_sidecars(self, digest):
        from . import sidecar as sidecar_mod

        problems = []
        for tag in self.sidecar_tags(digest):
            problems.extend(sidecar_mod.verify_sidecar(self, digest, tag))
        return problems

    def sidecar_tags(self, digest):
        base = os.path.join(self.object_dir(digest), "sidecar")
        try:
            return sorted(
                n for n in os.listdir(base)
                if os.path.isfile(os.path.join(base, n, "sidecar.json")))
        except OSError:
            return []

    def delete(self, digest):
        self._check_key(digest)
        shutil.rmtree(self.object_dir(digest), ignore_errors=True)

    def gc(self, budget_bytes=None, dry_run=False):
        """Size-budgeted, sequence-aware LRU gc: delete least-recently-
        used objects AND anim sequences until the corpus fits
        ``budget_bytes`` (default knob ``MESH_TPU_STORE_GC_MB``).

        A keyframe object is never removed while delta sequences still
        depend on it — evicting the base would orphan every frame — so
        pinned objects are skipped and whole sequences go oldest-first
        instead; once a digest's last sequence is gone the keyframe
        becomes evictable again (same call, second pass).  Returns the
        deleted keys: digests for objects, ``digest/sequence_id`` for
        sequences."""
        if budget_bytes is None:
            budget_bytes = int(
                knobs.get_float("MESH_TPU_STORE_GC_MB") * 1024 * 1024)
        deleted = []
        with obs_span("store.gc", budget_bytes=int(budget_bytes)) as sp:
            dependents = {}
            candidates = []
            for d, s in self.list_sequences():    # oldest-LRU first
                dependents[d] = dependents.get(d, 0) + 1
                candidates.append((self._seq_last_used(d, s), d, s,
                                   self.sequence_bytes(d, s)))
            for d in self.ls():
                candidates.append((self._last_used(d), d, None,
                                   self.object_bytes(d)))
            candidates.sort(key=lambda c: c[0])
            total = sum(c[3] for c in candidates)

            def _evict(digest, seq, size):
                if not dry_run:
                    if seq is None:
                        self.delete(digest)
                    else:
                        self.delete_sequence(digest, seq)
                    _metrics()["gc"].inc()
                deleted.append(digest if seq is None
                               else "%s/%s" % (digest, seq))
                return size

            pinned = []
            for _t, digest, seq, size in candidates:
                if total <= budget_bytes:
                    break
                if seq is None and dependents.get(digest):
                    pinned.append((digest, size))
                    continue
                total -= _evict(digest, seq, size)
                if seq is not None:
                    dependents[digest] -= 1
            # keyframes whose sequences all died above are fair game now
            for digest, size in pinned:
                if total <= budget_bytes:
                    break
                if dependents.get(digest):
                    continue
                total -= _evict(digest, None, size)
            if not dry_run:
                _metrics()["bytes"].set(float(total))
            sp.set(deleted=len(deleted), remaining_bytes=int(total))
        # leaked staging dirs from crashed writers age out here too
        self._sweep_tmp(dry_run)
        return deleted

    def _sweep_tmp(self, dry_run, max_age_s=3600.0):
        tmp = os.path.join(self.root, "tmp")
        try:
            names = os.listdir(tmp)
        except OSError:
            return
        now = wall()
        for name in names:
            path = os.path.join(tmp, name)
            try:
                age = now - os.path.getmtime(path)
            except OSError:
                continue
            if age > max_age_s and not dry_run:
                shutil.rmtree(path, ignore_errors=True)

    # -- side-cars (thin forwarders; the codec lives in sidecar.py) ----

    def put_sidecar(self, index, params=None):
        from . import sidecar as sidecar_mod

        return sidecar_mod.put_sidecar(self, index, params)

    def load_sidecar(self, digest, kind, params=None):
        from . import sidecar as sidecar_mod

        return sidecar_mod.load_sidecar(self, digest, kind, params)

    def sidecar_tag_exists(self, digest, kind, params=None):
        from . import sidecar as sidecar_mod

        tag = sidecar_mod.sidecar_tag(kind, params)
        return os.path.isfile(os.path.join(
            self.object_dir(digest), "sidecar", tag, "sidecar.json"))
