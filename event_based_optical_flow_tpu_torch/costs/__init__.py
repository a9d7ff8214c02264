"""Cost layer of the port: the contrast objectives of the hybrid cost."""

from .functional import (
    gradient_magnitude,
    multi_focal_normalized_gradient_magnitude,
    nan_to_penalty,
    normalized_gradient_magnitude,
    normalized_image_variance,
    total_variation,
)
from .registry import (
    CostBase,
    HybridCost,
    MultiFocalNormalizedGradientMagnitude,
    TotalVariation,
    functions,
)

__all__ = [
    "CostBase",
    "functions",
    "HybridCost",
    "MultiFocalNormalizedGradientMagnitude",
    "TotalVariation",
    "gradient_magnitude",
    "multi_focal_normalized_gradient_magnitude",
    "nan_to_penalty",
    "normalized_gradient_magnitude",
    "normalized_image_variance",
    "total_variation",
]
