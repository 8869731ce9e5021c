"""Training on the card (counterpart of mesh_tpu/parallel): the
single-device scan-fit step.  The sharded step, device meshes, sharded
queries, checkpoints and multi-host setup are not ported (ROADMAP.md,
Queue 1)."""

from .fit import (  # noqa: F401
    FitState,
    fit_scan,
    init_fit_state,
    landmark_arrays,
    landmark_loss,
    make_fit_step,
    scan_to_model_loss,
)
