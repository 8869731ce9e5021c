"""Body models of the PyTorch port."""

from .body_model import (  # noqa: F401
    MODEL_FAMILIES,
    BodyModel,
    lbs,
    smpl_sized_sphere,
    synthetic_body_model,
    synthetic_family_model,
)
