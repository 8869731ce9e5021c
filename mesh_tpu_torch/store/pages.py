"""In-process digest-keyed page cache over the mesh store (a copy of
mesh_tpu/store/pages.py).

The serving tier accepts a *store key* (topology digest) in place of a
mesh; :func:`PageCache.resolve` turns it into a ready
:class:`~mesh_tpu_torch.store.store.StoredMesh`, LRU-bounded by a byte budget
(``MESH_TPU_STORE_PAGE_CACHE_MB``).  "Paged" vs "resident" is the
ledger-provenance distinction the serve integration records: a resident
hit costs a dict lookup; a paged miss walks ``store.open`` (CRC verify
+ mmap) under a ``store.page_in`` span.
"""

import threading
from collections import OrderedDict

from ..obs.trace import span as obs_span
from ..utils import knobs

__all__ = ["PageCache", "get_page_cache", "clear_page_cache"]


def _metrics():
    from ..obs.metrics import REGISTRY

    return (
        REGISTRY.counter(
            "mesh_tpu_store_page_cache_hits_total",
            "Store-key resolutions served by the resident page cache."),
        REGISTRY.counter(
            "mesh_tpu_store_page_cache_misses_total",
            "Store-key resolutions that paged the mesh in from disk."),
        REGISTRY.gauge(
            "mesh_tpu_store_page_cache_bytes",
            "Mesh bytes currently resident in the page cache."),
    )


class PageCache(object):
    """Byte-budgeted LRU of StoredMesh objects keyed by
    ``(digest, tier)`` — exact, compact, and anim delta-frame tiers of
    one digest are independent pages."""

    def __init__(self, budget_bytes=None, store=None):
        self._budget = budget_bytes
        self._store = store
        self._lock = threading.Lock()
        self._cache = OrderedDict()          # (digest, tier) -> StoredMesh
        self._bytes = 0

    @property
    def budget_bytes(self):
        if self._budget is not None:
            return int(self._budget)
        return int(knobs.get_float("MESH_TPU_STORE_PAGE_CACHE_MB")
                   * 1024 * 1024)

    def _get_store(self):
        if self._store is not None:
            return self._store
        from .store import get_store

        return get_store()

    def resolve(self, digest, tier="exact"):
        """``(mesh, provenance)`` for a store key; provenance is
        ``"resident"`` on a cache hit, ``"paged"`` when the mesh came
        off disk this call.  Raises StoreError/StoreCorrupt upward —
        admission already happened, the serve tier maps these to a
        request error."""
        hits, misses, gauge = _metrics()
        key = (digest, tier)
        with self._lock:
            mesh = self._cache.get(key)
            if mesh is not None:
                self._cache.move_to_end(key)
                hits.inc()
                return mesh, "resident"
        misses.inc()
        with obs_span("store.page_in", digest=digest, tier=tier):
            mesh = self._get_store().open(digest, tier=tier)
        nbytes = mesh.nbytes()
        with self._lock:
            prev = self._cache.pop(key, None)
            if prev is not None:
                self._bytes -= prev.nbytes()
            self._cache[key] = mesh
            self._bytes += nbytes
            budget = self.budget_bytes
            while self._bytes > budget and len(self._cache) > 1:
                _, old = self._cache.popitem(last=False)
                self._bytes -= old.nbytes()
            gauge.set(float(self._bytes))
        return mesh, "paged"

    def drop(self, digest=None):
        with self._lock:
            if digest is None:
                self._cache.clear()
                self._bytes = 0
            else:
                # every resident tier/frame of the digest goes at once
                for key in [k for k in self._cache if k[0] == digest]:
                    self._bytes -= self._cache.pop(key).nbytes()
            _metrics()[2].set(float(self._bytes))

    def info(self):
        with self._lock:
            return {
                "entries": len(self._cache),
                "bytes": int(self._bytes),
                "budget_bytes": self.budget_bytes,
                "digests": sorted({k[0] for k in self._cache}),
            }


_PAGE_CACHE = None
_PAGE_LOCK = threading.Lock()


def get_page_cache():
    """The process-wide page cache (knob-budgeted)."""
    global _PAGE_CACHE
    with _PAGE_LOCK:
        if _PAGE_CACHE is None:
            _PAGE_CACHE = PageCache()
        return _PAGE_CACHE


def clear_page_cache():
    global _PAGE_CACHE
    with _PAGE_LOCK:
        if _PAGE_CACHE is not None:
            _PAGE_CACHE.drop()
        _PAGE_CACHE = None
