"""Image of Warped Events (IWE) rasterization (port of
``event_based_optical_flow_tpu/ops/iwe.py``).

Every standalone vote of the port, the init sweep's patch images, the
metrics' orig IWE, event mask and FWL images, goes through ``bilinear_vote``
or ``count_vote`` (``ops/vote.py``): the hand-written CUDA kernel K8 for a
CUDA tensor, its plain scatter version for a CPU tensor.  Exact scatter
semantics: corners at ``floor(x + eps)`` and ``+1``, weights ``(1 - fx)(1 -
fy) * w`` etc. with ``fx = x - floor(x + eps)`` (the count vote: ``w`` at
each corner), corners outside the image dropped.  The batched form
rasterizes ``[..., n, 4]`` events into ``[..., H, W]`` images in one call
(the init sweep votes every patch x candidate at once).  Gradients w.r.t.
event positions flow through the fractional weights, one-sided at the
corners (reference autograd semantics); the count vote has none.

``EventImageConverter`` is the JAX package's facade: its image grows by
twice the outer padding (``solver.outer_padding``), and ``create_iwe``
votes by ``iwe.method``: ``bilinear_vote``, ``count``, or ``polarity``, the
bilinear images of the positive and the non-positive events stacked at
axis -3 (one K8 launch for both: each image reads the same events with
its own weight row).
"""

from typing import Tuple, Union

import torch

from .blur import gaussian_blur3, gaussian_filter
from .vote import bilinear_vote, bilinear_vote_plain, count_vote

Tensor = torch.Tensor

__all__ = ["bilinear_vote", "bilinear_vote_plain", "count_vote", "event_mask", "create_iwe",
           "EventImageConverter", "IWE_METHODS"]

IWE_METHODS = ("bilinear_vote", "count", "polarity")


def padded_size(image_size: Tuple[int, int], padding: int = 0) -> Tuple[int, int]:
    """The image size grown by ``padding`` pixels on every side."""
    return (int(image_size[0]) + 2 * padding, int(image_size[1]) + 2 * padding)


def event_mask(events: Tensor, image_size: Tuple[int, int], weight: Union[float, Tensor] = 1.0,
               padding: int = 0) -> Tensor:
    """Boolean ``[..., 1, H + 2 padding, W + 2 padding]`` mask of pixels
    receiving any bilinear vote."""
    return (bilinear_vote(events, padded_size(image_size, padding), weight, padding=padding) != 0)[..., None, :, :]


def vote_by_method(events: Tensor, image_size: Tuple[int, int], weight: Union[float, Tensor] = 1.0,
                   padding: int = 0, method: str = "bilinear_vote") -> Tensor:
    """The raw (unblurred) IWE of ``iwe.method`` in images of
    ``image_size`` grown by ``padding``: ``[..., H', W']``, a polarity
    IWE ``[..., 2, H', W']`` (positive events, then the others)."""
    size = padded_size(image_size, padding)
    if method == "bilinear_vote":
        return bilinear_vote(events, size, weight, padding=padding)
    if method == "count":
        return count_vote(events, size, weight, padding=padding)
    if method == "polarity":
        pos = (events[..., 3] > 0).to(events.dtype)
        wgt = torch.as_tensor(weight, dtype=events.dtype, device=events.device)
        weights = torch.stack(torch.broadcast_tensors(wgt * pos, wgt * (1 - pos)), dim=-2)
        both = events[..., None, :, :].expand(events.shape[:-2] + (2,) + events.shape[-2:])
        return bilinear_vote(both, size, weights, padding=padding)
    raise NotImplementedError(f"IWE method {method!r} is not supported.")


def create_iwe(
    events: Tensor,
    image_size: Tuple[int, int],
    sigma: float = 1,
    weight: Union[float, Tensor] = 1.0,
    blur_mode: str = "torch",
    padding: int = 0,
    method: str = "bilinear_vote",
) -> Tensor:
    """The IWE of ``method`` (``vote_by_method``), optionally blurred:
    ``blur_mode='torch'`` is the 3-tap reflect gaussian of the optimization
    path, ``'scipy'`` the truncated symmetric gaussian of the metrics
    path."""
    image = vote_by_method(events, image_size, weight, padding, method)
    if sigma > 0:
        image = gaussian_blur3(image, sigma) if blur_mode == "torch" else gaussian_filter(image, sigma)
    return image


class EventImageConverter:
    """The JAX package's facade: ``image_size`` is the padded size (the
    sensor's grown by twice ``outer_padding``)."""

    def __init__(self, image_size: Tuple[int, int], outer_padding: int = 0):
        self.outer_padding = int(outer_padding)
        self.image_size = padded_size(image_size, self.outer_padding)
        self._sensor = tuple(int(s) for s in image_size)

    def create_iwe(self, events: Tensor, method: str = "bilinear_vote", sigma: float = 1,
                   weight: Union[float, Tensor] = 1.0, blur_mode: str = "torch") -> Tensor:
        return create_iwe(events, self._sensor, sigma, weight, blur_mode, self.outer_padding, method)

    def create_eventmask(self, events: Tensor, weight: Union[float, Tensor] = 1.0) -> Tensor:
        return event_mask(events, self._sensor, weight, self.outer_padding)
