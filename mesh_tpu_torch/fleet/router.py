"""FleetRouter: the digest-affine front door over N QueryService replicas
(a copy of mesh_tpu/fleet/router.py).

One process, one card is the serving tier's shape (serve/service.py);
the router is the piece that federates N of them.  It exposes the exact
``submit``/``query`` surface of ``QueryService`` — loadgen generators,
trace replay, and callers that code against the service interface all
take a router without changes — and places each request by
consistent-hashing its **routing key**:

    (op, topology digest, query-count bucket)

— the same identity the engine's plan cache and the store's page cache
key on, so every replica keeps re-seeing the digests it already has
warm plans (CUDA graphs) and resident pages for (cache affinity is the
entire win: a random balancer makes every replica re-capture every
plan).  The avatar session pins its key with ``routing_key`` too.

Admission follows the replicas' own backpressure:

- **spill-to-sibling**: a primary that rejects with ``queue_full``
  spills the request to the second choice on the hash ring (one hop
  only — a fleet-wide full queue should reject, not cascade), so a hot
  tenant's stampede degrades one digest's affinity instead of turning
  into caller-visible rejections while siblings idle.
- **ring ejection**: replicas whose health monitor is not ``ready()``
  (DRAINING — graceful shutdown or watchdog escalation,
  serve/health.py) are skipped during the ring walk; consistent
  hashing means only their own keys move.  DEGRADED replicas stay in
  the ring (they still answer, one rung down).
- every other rejection (``draining``, ``low_priority``) propagates
  unchanged — the router adds placement, never new admission policy.

**Ledger cleanliness by construction**: the router opens no ledger
records.  Admission into a replica is what opens a record
(``QueryService.submit``), and every replica path closes it — a
``ServeRejected`` hop between replicas happens strictly *before* any
record exists, so no router edge can leak an open record.

``MESH_TPU_FLEET=0`` is the kill switch: ``submit`` delegates straight
to the first replica — no key, no ring walk, no fleet metrics — which
with a single replica is bit-identical to calling the service
directly.

Stdlib-only at import (numpy is touched only when a raw-faces mesh
needs digesting); the fleet metrics ride the always-on registry:
``mesh_tpu_fleet_requests_total{replica,outcome}``,
``mesh_tpu_fleet_spill_total{replica}``,
``mesh_tpu_fleet_ring_members`` / ``mesh_tpu_fleet_ring_eligible``.
"""

import itertools
import json
import threading
import zlib
from collections import OrderedDict

from ..errors import ServeRejected
from ..obs.clock import monotonic
from ..obs.context import mint as mint_context
from ..utils import knobs
from .ring import HashRing

__all__ = [
    "FleetRouter", "fleet_enabled", "spill_enabled", "routing_key",
    "topology_digest", "shape_bucket", "ROUTER_Q_LADDER",
]

#: the engine's query-count bucket ladder (engine/planner.py Q_LADDER),
#: restated here so the router imports without torch
ROUTER_Q_LADDER = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)


def fleet_enabled():
    """Router kill switch: ``MESH_TPU_FLEET=0`` = direct pass-through."""
    return knobs.flag("MESH_TPU_FLEET")


def spill_enabled():
    """``MESH_TPU_FLEET_SPILL=0`` disables spill-to-sibling (a full
    primary rejects, exactly like a standalone service)."""
    return knobs.flag("MESH_TPU_FLEET_SPILL")


def shape_bucket(q):
    """Smallest ladder rung >= q (next multiple of the top rung beyond)
    — the engine's ``bucket_size`` over its Q_LADDER."""
    q = int(q)
    if q <= 0:
        raise ValueError("shape_bucket wants a positive count, got %d" % q)
    for b in ROUTER_Q_LADDER:
        if q <= b:
            return b
    top = ROUTER_Q_LADDER[-1]
    return ((q + top - 1) // top) * top


def topology_digest(mesh):
    """The mesh identity the routing key hashes: a store key verbatim,
    a mesh's ``topology_key`` when it carries one, else a crc32 of the
    face buffer — the same chain the engine executor keys coalescing
    groups with."""
    if isinstance(mesh, str):
        return mesh
    topo = getattr(mesh, "topology_key", None)
    if topo:
        return str(topo)
    import numpy as np

    faces = np.ascontiguousarray(np.asarray(mesh.f, np.int32))
    return "crc32:%08x" % (zlib.crc32(faces.tobytes()) & 0xFFFFFFFF)


def routing_key(op, mesh, points):
    """``op|digest|bucket`` — the affinity identity one request hashes
    onto the ring with."""
    q = points.shape[0] if hasattr(points, "shape") else len(points)
    return "%s|%s|%d" % (op, topology_digest(mesh), shape_bucket(q))


class FleetRouter(object):
    """Digest-affine consistent-hash front end over replica services.

    ``replicas`` maps name -> service handle (anything exposing the
    ``QueryService`` interface: ``submit``, ``query``, ``health``,
    ``stop``).  Membership changes and the admission log are serialized
    by ``_lock``; replica ``submit`` calls and metric bumps run after
    it drops.  The only lock taken underneath is each replica's
    ``HealthMonitor._lock`` (the eligibility read in ``plan``), which
    is why the router sits above health in the lock order.
    """

    def __init__(self, replicas=None, vnodes=None, recorder=None):
        if vnodes is None:
            vnodes = max(1, knobs.get_int("MESH_TPU_FLEET_VNODES"))
        self._lock = threading.Lock()
        self._replicas = OrderedDict()
        self._ring = HashRing(vnodes=vnodes)
        self._seq = 0
        self._mint_seq = itertools.count(1)
        self._log = {}                # name -> [admission event, ...]
        self._recorder = recorder
        self._init_metrics()
        for name, service in (replicas or {}).items():
            self.add_replica(name, service)

    # ------------------------------------------------------------------
    # metrics

    def _init_metrics(self):
        from ..obs.metrics import REGISTRY

        self._m_requests = REGISTRY.counter(
            "mesh_tpu_fleet_requests_total",
            "Router admissions by replica and outcome (routed / spilled "
            "/ rejected).",
        )
        self._m_spill = REGISTRY.counter(
            "mesh_tpu_fleet_spill_total",
            "Requests spilled to the ring's second choice because the "
            "primary replica's tenant queue was full.",
        )
        self._m_members = REGISTRY.gauge(
            "mesh_tpu_fleet_ring_members",
            "Replicas registered on the hash ring.",
        )
        self._m_eligible = REGISTRY.gauge(
            "mesh_tpu_fleet_ring_eligible",
            "Registered replicas currently admitting (health ready).",
        )

    def _record(self, kind, **fields):
        recorder = self._recorder
        if recorder is None:
            from ..obs.recorder import get_recorder

            recorder = get_recorder()
        recorder.record(kind, **fields)

    # ------------------------------------------------------------------
    # membership

    def add_replica(self, name, service):
        with self._lock:
            if name in self._replicas:
                raise ValueError("replica %r already registered" % (name,))
            self._replicas[name] = service
            self._ring.add(name)
            self._log.setdefault(name, [])
            members = len(self._ring)
        self._m_members.set(members)
        self._record("fleet.member", action="add", replica=name,
                     members=members)

    def remove_replica(self, name):
        """Take a replica off the ring (it is NOT stopped — draining is
        the owner's job); only its own keys remap."""
        with self._lock:
            service = self._replicas.pop(name, None)
            self._ring.remove(name)
            members = len(self._ring)
        self._m_members.set(members)
        if service is not None:
            self._record("fleet.member", action="remove", replica=name,
                         members=members)
        return service

    def replicas(self):
        with self._lock:
            return OrderedDict(self._replicas)

    def _eligible(self, name):
        service = self._replicas.get(name)
        if service is None:
            return False
        health = getattr(service, "health", None)
        if health is None:
            return True
        try:
            return bool(health.ready())
        except Exception:       # a dying health monitor reads as ejected
            return False

    def plan(self, op, mesh, points):
        """The eligible preference order for one request (primary
        first) — what ``submit`` walks; exposed for tests and the bench
        affinity probe."""
        key = routing_key(op, mesh, points)
        with self._lock:
            order = self._ring.choices(key)
            order = [n for n in order if self._eligible(n)]
            eligible = sum(1 for n in self._replicas
                           if self._eligible(n))
        self._m_eligible.set(eligible)
        return key, order

    # ------------------------------------------------------------------
    # admission (the QueryService-compatible surface)

    def submit(self, mesh, points, tenant="default", priority=0,
               deadline_s=None, op="closest_point"):
        """Route one request onto its affinity replica; returns that
        replica's Future.  ``ServeRejected`` propagates once spill is
        exhausted (or for any non-queue_full reason) — the router never
        queues requests itself."""
        with self._lock:
            if not self._replicas:
                raise ServeRejected("fleet has no replicas",
                                    retry_after=5.0, reason="draining")
            first = next(iter(self._replicas.values()))
        if not fleet_enabled():
            # kill switch: the single-replica direct path, bit-identical
            # to calling the service (no key, no ring, no fleet series)
            return first.submit(mesh, points, tenant=tenant,
                                priority=priority, deadline_s=deadline_s)
        key, order = self.plan(op, mesh, points)
        if not order:
            self._record("fleet.reject", key=key, reason="no_replica")
            raise ServeRejected(
                "no fleet replica is admitting", retry_after=5.0,
                reason="draining")
        primary = order[0]
        # Mint the fleet-wide request identity at the admission edge:
        # the routing key and chosen replica travel with the request so
        # a spill hop stays attributable end-to-end.
        ctx = mint_context(tenant, next(self._mint_seq), monotonic(),
                           routing_key=key, replica=primary)
        ctx_kw = {"ctx": ctx} if ctx is not None else {}
        try:
            future = self._replicas[primary].submit(
                mesh, points, tenant=tenant, priority=priority,
                deadline_s=deadline_s, **ctx_kw)
        except ServeRejected as e:
            if (e.reason != "queue_full" or not spill_enabled()
                    or len(order) < 2):
                self._m_requests.inc(replica=primary, outcome="rejected")
                self._record("fleet.reject", key=key, replica=primary,
                             reason=e.reason)
                raise
            sibling = order[1]
            self._m_spill.inc(replica=primary)
            self._record("fleet.spill", key=key, tenant=tenant,
                         src=primary, dst=sibling)
            if ctx is not None:
                ctx.replica = sibling
                ctx.spilled = True
            try:
                future = self._replicas[sibling].submit(
                    mesh, points, tenant=tenant, priority=priority,
                    deadline_s=deadline_s, **ctx_kw)
            except ServeRejected:
                self._m_requests.inc(replica=sibling, outcome="rejected")
                self._record("fleet.reject", key=key, replica=sibling,
                             reason="spill_exhausted")
                raise
            self._m_requests.inc(replica=sibling, outcome="spilled")
            self._log_admission(sibling, key, tenant)
            return future
        self._m_requests.inc(replica=primary, outcome="routed")
        self._log_admission(primary, key, tenant)
        return future

    def query(self, mesh, points, tenant="default", priority=0,
              deadline_s=None, op="closest_point"):
        """Synchronous submit (the ``QueryService.query`` twin)."""
        future = self.submit(mesh, points, tenant=tenant, priority=priority,
                             deadline_s=deadline_s, op=op)
        return future.result()

    # ------------------------------------------------------------------
    # determinism surface (per-replica admission checksums)

    def _log_admission(self, replica, key, tenant):
        with self._lock:
            self._seq += 1
            self._log.setdefault(replica, []).append(
                [len(self._log[replica]), tenant, key])

    def admission_checksums(self):
        """Deterministic per-replica CRC over the admission sequence
        each replica received (same trace + same membership => same
        checksums; loadgen reports carry them under
        ``replica_checksums``)."""
        with self._lock:
            logs = {name: list(events)
                    for name, events in self._log.items()}
        out = {}
        for name, events in logs.items():
            payload = json.dumps(events, sort_keys=True,
                                 separators=(",", ":"))
            out[name] = float(zlib.crc32(payload.encode("utf-8")))
        return out

    def reset_admission_log(self):
        """Zero the per-replica admission logs (between runs)."""
        with self._lock:
            for name in self._log:
                self._log[name] = []
            self._seq = 0

    # ------------------------------------------------------------------
    # introspection / lifecycle

    def status(self):
        """JSON-able ring/replica view."""
        with self._lock:
            names = list(self._replicas)
            members = self._ring.members()
            log_sizes = {n: len(e) for n, e in self._log.items()}
        rows = []
        for name in names:
            service = self._replicas.get(name)
            health = getattr(service, "health", None)
            rows.append({
                "replica": name,
                "in_ring": name in members,
                "eligible": self._eligible(name),
                "health": (health.snapshot()
                           if health is not None else None),
                "admitted": log_sizes.get(name, 0),
            })
        return {"members": members, "replicas": rows}

    def stop(self, drain=True, write_stats=True):
        """Stop every replica (drain semantics are the services' own)."""
        for service in self.replicas().values():
            service.stop(drain=drain, write_stats=write_stats)
