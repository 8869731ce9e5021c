"""Training and sharded queries over several devices (counterpart of
mesh_tpu/parallel), on ``torch.distributed``: device meshes
(``DeviceMesh``), query-, face- and batch-sharded closest point,
visibility and normals, multi-process placement (DTensor), the scan-fit
step on one device or sharded over a ``("dp", "sp")`` mesh, and fit
checkpoints.  One process per rank; every rank of a mesh calls a sharded
function with the same arguments (``comm`` holds the collectives)."""

from .sharding import (  # noqa: F401
    make_device_mesh,
    shard_queries,
    sharded_closest_faces_and_points,
    sharded_closest_faces_sharded_topology,
    sharded_batched_vert_normals,
    sharded_batched_visibility,
    sharded_visibility,
)
from .checkpoint import restore_fit_state, save_fit_state  # noqa: F401
from .distributed import (  # noqa: F401
    gather_to_hosts,
    global_device_mesh,
    initialize_multihost,
    multihost_closest_faces_and_points,
    replicate_to_mesh,
    shard_from_local,
)
from .fit import (  # noqa: F401
    BatchShard,
    FitState,
    fit_scan,
    gather_fit_state,
    init_fit_state,
    landmark_arrays,
    landmark_loss,
    make_fit_step,
    place_fit_state,
    scan_to_model_loss,
)
