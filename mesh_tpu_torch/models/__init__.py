"""Body models of the PyTorch port."""

from .body_model import (  # noqa: F401
    MODEL_FAMILIES,
    BodyModel,
    lbs,
    load_body_model_npz,
    mano_pose_from_pca,
    save_body_model_npz,
    smpl_sized_sphere,
    synthetic_body_model,
    synthetic_family_model,
)
