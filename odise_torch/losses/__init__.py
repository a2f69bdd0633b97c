"""Training losses (counterpart of ``odise_tpu/losses``)."""

from .grounding import GroundingConfig, mask_grounding_criterion
from .set_criterion import (
    CriterionConfig,
    get_uncertain_point_coords_with_randomness,
    set_criterion,
)

__all__ = ["CriterionConfig", "GroundingConfig",
           "get_uncertain_point_coords_with_randomness",
           "mask_grounding_criterion", "set_criterion"]
