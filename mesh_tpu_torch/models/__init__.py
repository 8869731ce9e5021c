"""Body models of the PyTorch port."""

from .body_model import (  # noqa: F401
    BodyModel,
    lbs,
    smpl_sized_sphere,
    synthetic_body_model,
)
