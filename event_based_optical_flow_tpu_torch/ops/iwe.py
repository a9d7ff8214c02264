"""Image of Warped Events (IWE) rasterization (port of
``event_based_optical_flow_tpu/ops/iwe.py``).

Every standalone vote of the port, the init sweep's patch images, the
metrics' orig IWE, event mask and FWL images, goes through ``bilinear_vote``
(``ops/vote.py``): the hand-written CUDA kernel K8 for a CUDA tensor, its
plain scatter version for a CPU tensor.  Exact scatter semantics: corners at
``floor(x + eps)`` and ``+1``, weights ``(1 - fx)(1 - fy) * w`` etc. with
``fx = x - floor(x + eps)``, corners outside the image dropped.  The batched
form rasterizes ``[..., n, 4]`` events into ``[..., H, W]`` images in one
call (the init sweep votes every patch x candidate at once).  Gradients
w.r.t. event positions flow through the fractional weights, one-sided at
the corners (reference autograd semantics).
"""

from typing import Tuple, Union

import torch

from .blur import gaussian_blur3, gaussian_filter
from .vote import bilinear_vote, bilinear_vote_plain

Tensor = torch.Tensor

__all__ = ["bilinear_vote", "bilinear_vote_plain", "event_mask", "create_iwe"]


def event_mask(events: Tensor, image_size: Tuple[int, int], weight: Union[float, Tensor] = 1.0) -> Tensor:
    """Boolean ``[..., 1, H, W]`` mask of pixels receiving any vote."""
    return (bilinear_vote(events, image_size, weight) != 0)[..., None, :, :]


def create_iwe(
    events: Tensor,
    image_size: Tuple[int, int],
    sigma: float = 1,
    weight: Union[float, Tensor] = 1.0,
    blur_mode: str = "torch",
) -> Tensor:
    """Bilinear-vote IWE, optionally blurred: ``blur_mode='torch'`` is the
    3-tap reflect gaussian of the optimization path, ``'scipy'`` the
    truncated symmetric gaussian of the metrics path."""
    image = bilinear_vote(events, image_size, weight)
    if sigma > 0:
        image = gaussian_blur3(image, sigma) if blur_mode == "torch" else gaussian_filter(image, sigma)
    return image
