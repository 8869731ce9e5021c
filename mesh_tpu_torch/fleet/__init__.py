"""Fleet serving fabric: one process becomes N replicas behind a
digest-affine front door (a copy of mesh_tpu/fleet).

- ``ring``: consistent-hash ring (stable placement, minimal movement).
- ``router``: the ``QueryService``-compatible front end — hashes
  (op, topology digest, shape bucket) onto replica handles, spills to
  the ring sibling on ``queue_full``, ejects draining replicas.
- ``coordinator``: fleet-level SLO burn over per-replica serve-stats
  sinks + widen arbitration for per-replica tuners.

The three modules are stdlib code: the replicas behind a router are what
run the card's kernels.
"""

from .ring import DEFAULT_VNODES, HashRing
from .router import (
    FleetRouter, fleet_enabled, routing_key, shape_bucket, spill_enabled,
    topology_digest,
)
from .coordinator import FleetCoordinator, aggregate_sinks, read_sink

__all__ = [
    "HashRing", "DEFAULT_VNODES",
    "FleetRouter", "fleet_enabled", "spill_enabled",
    "routing_key", "shape_bucket", "topology_digest",
    "FleetCoordinator", "aggregate_sinks", "read_sink",
]
