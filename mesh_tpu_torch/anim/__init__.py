"""Dynamic meshes: animation-rate BVH refit and avatar stream sessions
(counterpart of mesh_tpu/anim).

A fixed-topology mesh (SMPL / FLAME / MANO body pipelines) deforms every
frame: the faces never change, only the vertices.

- :mod:`mesh_tpu_torch.anim.refit`: bottom-up AABB refit over the frozen
  Morton order and preorder+skip rope layout of an existing
  :class:`~mesh_tpu_torch.accel.build.AccelIndex` (leaf boxes by the
  ``leaf_boxes`` CUDA kernel on the card), with a tracked box-inflation
  ratio that trips a full rebuild through the digest cache past the
  ``anim_refit_max_inflation`` tunable.
- :mod:`mesh_tpu_torch.anim.session`: avatar sessions: one pinned topology
  digest, refit state and routing key per client; per-frame vertices (or
  deltas) and queries at animation rate.

``MESH_TPU_ANIM=0`` is the kill switch: sessions build the index cold per
frame through ``get_index``.  Sequences of frames are stored as
quantized deltas against a stored keyframe by ``store/deltas.py``.
"""

from .refit import RefitState, box_measure, refit_bvh, refit_max_inflation
from .session import AvatarSession, SessionClosed

__all__ = [
    "AvatarSession", "RefitState", "SessionClosed", "box_measure",
    "refit_bvh", "refit_max_inflation",
]
