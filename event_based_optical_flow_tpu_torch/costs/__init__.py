"""Cost layer of the port: the contrast objectives, the total variation
and their hybrid."""

from .functional import (
    gradient_magnitude,
    image_variance,
    multi_focal_normalized_image_variance,
    multi_focal_normalized_gradient_magnitude,
    nan_to_penalty,
    normalized_gradient_magnitude,
    normalized_image_variance,
    total_variation,
)
from .registry import (
    CostBase,
    GradientMagnitude,
    HybridCost,
    ImageVariance,
    MultiFocalNormalizedGradientMagnitude,
    MultiFocalNormalizedImageVariance,
    NormalizedGradientMagnitude,
    NormalizedImageVariance,
    TotalVariation,
    functions,
)

__all__ = [
    "CostBase",
    "functions",
    "GradientMagnitude",
    "HybridCost",
    "ImageVariance",
    "MultiFocalNormalizedGradientMagnitude",
    "MultiFocalNormalizedImageVariance",
    "NormalizedGradientMagnitude",
    "NormalizedImageVariance",
    "TotalVariation",
    "gradient_magnitude",
    "image_variance",
    "multi_focal_normalized_gradient_magnitude",
    "multi_focal_normalized_image_variance",
    "nan_to_penalty",
    "normalized_gradient_magnitude",
    "normalized_image_variance",
    "total_variation",
]
