"""Exception hierarchy of the port: a copy of mesh_tpu/errors.py, with the
same class names and bases, so callers catch the same errors from either
package.

Parity with reference mesh/errors.py:8-15 (MeshError <- SerializationError),
extended with the error classes the reference registers per C extension
(spatialsearchmodule.cpp:60-62, py_visibility.cpp:52-54, py_loadobj.cpp:56-58).
"""


class MeshError(Exception):
    """Base error for every mesh_tpu_torch failure."""


class SerializationError(MeshError):
    """Raised on file I/O / parse failures (reference errors.py:12-15)."""


class SpatialSearchError(MeshError):
    """Raised on spatial-query failures (reference Mesh_IntersectionsError)."""


class VisibilityError(MeshError):
    """Raised on visibility-computation failures (reference VisibilityError)."""


class TopologyError(MeshError):
    """Raised on topology-op failures (decimation/subdivision)."""


class EngineShutdown(MeshError, RuntimeError):
    """Raised when work is submitted to an engine executor (or serving
    tier) that has been shut down.  Subclasses RuntimeError so callers of
    the pre-hardening ``executor.submit`` contract keep working."""


class DeadlineExceeded(MeshError, TimeoutError):
    """A request's deadline expired before (or while) it was served.

    Raised by the engine executor when a queued request's deadline passes
    before dispatch, and by the serving tier when every degradation rung
    failed inside the request's hard time budget (doc/serving.md).

    ``rung`` carries the last rung attempted before the budget ran out
    (None when the request never reached the ladder — e.g. it expired in
    the queue), so load reports and replay tallies keep rung provenance
    for failures, not just successes."""

    rung = None


class StoreError(MeshError):
    """Content-addressed mesh-store failure: missing object, bad key,
    unwritable root (mesh_tpu/store, doc/store.md)."""


class StoreCorrupt(StoreError):
    """On-disk store state failed digest/CRC verification (truncated
    block, manifest mismatch, stale side-car).  ``what`` names the
    check that failed — the same label the
    ``mesh_tpu_store_corrupt_total`` counter carries."""

    def __init__(self, message, what="block_crc", digest=None):
        super(StoreCorrupt, self).__init__(message)
        self.what = what
        self.digest = digest


class ServeRejected(MeshError):
    """Admission control turned a request away (queue full, tenant over
    budget, or the service is draining).  ``retry_after`` is the server's
    backpressure hint in seconds."""

    def __init__(self, message, retry_after=0.1, reason="rejected"):
        super(ServeRejected, self).__init__(message)
        self.retry_after = float(retry_after)
        self.reason = reason
