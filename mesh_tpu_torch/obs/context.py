"""End-to-end request identity: RequestContext + tail-sampled traces (a
copy of mesh_tpu/obs/context.py).

- :class:`RequestContext` is minted once per admission
  (``QueryService.submit``, ``AvatarSession.frame``) and propagated
  *explicitly*: the serving tier stamps it into the ledger record's meta
  (``request_id``/``seq``/``routing_key``/...), rides it on the record
  through the engine executor's thread hop, and binds it around
  worker-side work, so spans opened on any thread tag ``request_id`` and
  parent under the request's root span (obs/trace.py's context fallback).
- **Tail sampling** (:class:`TraceTail`): full span *trees* are retained
  per request only for the tail — every deadline-miss/error/cancelled/
  spilled request, plus a bounded reservoir of the slowest ``ok`` ones
  (``MESH_TPU_TRACE_RESERVOIR``) — in a bounded ring that flight-recorder
  incidents embed as their ``requests`` tail, joining ledger row + span
  tree by request_id.

``request_id`` is a seeded CRC of ``(tenant, seq, admit)``: cheap to mint
per request and carrying no request payload.  It belongs in ledger meta,
span attrs and histogram *exemplars*, never in metric label values.

Kill switch: ``MESH_TPU_TRACE_CONTEXT=0`` makes :func:`mint` return
``None`` and every propagation site no-op — bit-identical to the
identity-free path (pinned by test).

Stdlib-only; imports nothing from obs/trace.py (trace.py imports *this*
module for the parent fallback, so the dependency is one-way).
"""

import json
import threading
import zlib
from collections import deque
from contextlib import contextmanager

from ..utils import knobs

__all__ = [
    "RequestContext", "TraceTail", "TRACE_TAIL", "mint", "bind_context",
    "current_context", "trace_context_enabled", "get_trace_tail",
]


def trace_context_enabled():
    """``MESH_TPU_TRACE_CONTEXT=0`` = no identity anywhere (kill
    switch; re-read per mint so tests can toggle at runtime)."""
    return knobs.flag("MESH_TPU_TRACE_CONTEXT")


class RequestContext(object):
    """One request's identity, minted at admission.

    ``root_span_id`` is filled in by the serving tier when the
    request's root span opens; spans opened later on *other* threads
    (the executor's drain/dispatch hop) parent under it when their own
    thread-local span stack is empty.
    """

    __slots__ = ("request_id", "tenant", "seq", "routing_key", "replica",
                 "session_id", "spilled", "root_span_id")

    def __init__(self, request_id, tenant, seq, routing_key=None,
                 replica=None, session_id=None):
        self.request_id = request_id
        self.tenant = tenant
        self.seq = seq
        self.routing_key = routing_key
        self.replica = replica
        self.session_id = session_id
        self.spilled = False
        self.root_span_id = None

    def to_meta(self):
        """The JSON-able identity fields the ledger record's meta
        carries (the join key set `mesh-tpu prof trace` looks up)."""
        meta = {"request_id": self.request_id, "seq": self.seq}
        if self.routing_key is not None:
            meta["routing_key"] = self.routing_key
        if self.replica is not None:
            meta["replica"] = self.replica
        if self.session_id is not None:
            meta["session_id"] = self.session_id
        if self.spilled:
            meta["spilled"] = True
        return meta

    def __repr__(self):
        return ("RequestContext(%s, tenant=%r, seq=%r)"
                % (self.request_id, self.tenant, self.seq))


def mint(tenant, seq, admit, routing_key=None, replica=None,
         session_id=None):
    """Mint one request's context (or ``None`` with the kill switch
    off).  The id is a seeded CRC of ``(tenant, seq, admit)`` — stable
    for a given admission, unique within a retention window."""
    if not trace_context_enabled():
        return None
    payload = json.dumps([str(tenant), int(seq), round(float(admit), 6)],
                         separators=(",", ":"))
    request_id = "req-%08x" % (zlib.crc32(payload.encode("utf-8"))
                               & 0xFFFFFFFF)
    return RequestContext(request_id, tenant, int(seq),
                          routing_key=routing_key, replica=replica,
                          session_id=session_id)


# -- thread-local binding ---------------------------------------------------

_TLS = threading.local()


@contextmanager
def bind_context(ctx):
    """Bind ``ctx`` as the thread's current request identity for the
    block (``None`` binds nothing — the no-op the kill switch rides)."""
    if ctx is None:
        yield None
        return
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = ctx
    try:
        yield ctx
    finally:
        _TLS.ctx = prev


def current_context():
    """The thread's bound :class:`RequestContext`, or ``None``."""
    return getattr(_TLS, "ctx", None)


# -- tail sampling ----------------------------------------------------------

#: hard cap on distinct request_ids buffering finished spans at once —
#: an unclosed record can never grow the pending map without bound
_PENDING_REQUESTS_MAX = 1024
#: spans buffered per request before the oldest are dropped
_SPANS_PER_REQUEST_MAX = 256


class TraceTail(object):
    """Per-process bounded ring of retained request traces.

    Fed from two sides: a tracer sink buffers every finished span that
    carries a ``request_id`` attr, and the ledger's close path calls
    :meth:`observe_close` with the closed row — which either *retains*
    the request (ledger row + buffered span tree) or drops its spans.

    Retention policy (the tail-sampling contract, doc/observability.md):
    every request whose outcome is not ``ok`` — deadline misses, errors,
    cancellations — and every spilled request keeps its full trace;
    ``ok`` requests compete for a small reservoir that keeps the
    slowest ones.  The ring is bounded (``MESH_TPU_TRACE_TAIL``), so a
    storm of misses ages out the oldest traces instead of growing.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._pending = {}            # request_id -> [span dict, ...]
        self._ring = deque()          # retained entries, oldest first
        self._reservoir = []          # (total_s, request_id) of slow-ok

    # -- feed: tracer sink --------------------------------------------

    def record_span(self, event):
        """Tracer sink: buffer one finished span under its request_id
        (spans without one are not request-joinable and are skipped)."""
        attrs = event.get("attrs") or {}
        rid = attrs.get("request_id")
        if not rid:
            return
        with self._lock:
            spans = self._pending.get(rid)
            if spans is None:
                if len(self._pending) >= _PENDING_REQUESTS_MAX:
                    # oldest-inserted request's buffer is evicted
                    self._pending.pop(next(iter(self._pending)))
                spans = self._pending[rid] = []
            spans.append(event)
            if len(spans) > _SPANS_PER_REQUEST_MAX:
                del spans[0]

    # -- feed: ledger close -------------------------------------------

    def observe_close(self, row):
        """Ledger-close hook: decide retention for the closed row."""
        rid = row.get("request_id")
        if not rid:
            return
        with self._lock:
            spans = self._pending.pop(rid, None)
            outcome = row.get("outcome")
            tail = (outcome is not None and outcome != "ok") \
                or bool(row.get("spilled"))
            if not tail and not self._reserve_locked(rid, row):
                return
            self._ring.append({
                "request_id": rid,
                "outcome": outcome,
                "retained": "tail" if tail else "reservoir",
                "row": row,
                "spans": spans or [],
            })
            capacity = max(4, knobs.get_int("MESH_TPU_TRACE_TAIL") or 64)
            while len(self._ring) > capacity:
                self._ring.popleft()

    def _reserve_locked(self, rid, row):
        # slow-ok reservoir: keep the N slowest ok closes seen so far
        slots = knobs.get_int("MESH_TPU_TRACE_RESERVOIR")
        slots = 0 if slots is None else max(0, slots)
        if slots <= 0:
            return False
        total = row.get("total_s")
        if total is None:
            return False
        total = float(total)
        if len(self._reservoir) < slots:
            self._reservoir.append((total, rid))
            self._reservoir.sort()
            return True
        if total <= self._reservoir[0][0]:
            return False
        evicted = self._reservoir[0][1]
        self._reservoir[0] = (total, rid)
        self._reservoir.sort()
        # the evicted request's retained entry leaves the ring too
        for i, entry in enumerate(self._ring):
            if entry["request_id"] == evicted \
                    and entry["retained"] == "reservoir":
                del self._ring[i]
                break
        return True

    # -- query ---------------------------------------------------------

    def retained(self):
        """Retained entries, oldest first (what incidents embed)."""
        with self._lock:
            return [dict(e) for e in self._ring]

    def lookup(self, request_id):
        """The retained entry for one request_id, or ``None``."""
        with self._lock:
            for entry in reversed(self._ring):
                if entry["request_id"] == request_id:
                    return dict(entry)
        return None

    def clear(self):
        with self._lock:
            self._pending.clear()
            self._ring.clear()
            del self._reservoir[:]


#: process singleton (obs.reset() clears it)
TRACE_TAIL = TraceTail()


def get_trace_tail():
    return TRACE_TAIL
