"""The routing key of a request: ``op|digest|bucket`` (the key half of
mesh_tpu/fleet/router.py, lines 72-120).

The reference's ``FleetRouter`` places each request on a consistent-hash
ring of replicas by this key, the same identity its plan cache and store
key on, so a replica keeps seeing the meshes it has warm.  The port's
avatar session pins its key on its first queried frame, as the
reference's does; the ring and the router are not ported (ROADMAP.md,
Queue 1).
"""

import zlib

import numpy as np

__all__ = ["ROUTER_Q_LADDER", "shape_bucket", "topology_digest",
           "routing_key"]

#: the reference engine's query-count bucket ladder (its planner's Q_LADDER)
ROUTER_Q_LADDER = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)


def shape_bucket(q):
    """Smallest ladder rung >= q (next multiple of the top rung beyond)."""
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
    face buffer."""
    if isinstance(mesh, str):
        return mesh
    topo = getattr(mesh, "topology_key", None)
    if topo:
        return str(topo)
    faces = np.ascontiguousarray(np.asarray(mesh.f, np.int32))
    return "crc32:%08x" % (zlib.crc32(faces.tobytes()) & 0xFFFFFFFF)


def routing_key(op, mesh, points):
    """``op|digest|bucket`` — the affinity identity one request hashes
    onto the ring with."""
    q = points.shape[0] if hasattr(points, "shape") else len(points)
    return "%s|%s|%d" % (op, topology_digest(mesh), shape_bucket(q))
