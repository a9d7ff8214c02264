"""Image of Warped Events (IWE) rasterization (port of
``event_based_optical_flow_tpu/ops/iwe.py``, scatter backend).

Exact scatter semantics: corners at ``floor(x + eps)`` and ``+1``, weights
``(1 - fx)(1 - fy) * w`` etc. with ``fx = x - floor(x + eps)``, corners
outside the image dropped, one flattened ``index_add`` per call.  The
batched form rasterizes ``[..., n, 4]`` events into ``[..., H, W]`` images
in ONE scatter (the init sweep votes every patch x candidate at once).
Gradients w.r.t. event positions flow through the fractional weights,
one-sided at the corners (reference autograd semantics).

The standalone Pallas vote of the JAX package (``pallas_iwe.py``) is not
on the eval path (reached only with an explicit ``iwe_backend: pallas*``)
and is not ported yet; this plain scatter is what the port runs.
"""

from typing import Tuple, Union

import torch

from .blur import gaussian_blur3, gaussian_filter

Tensor = torch.Tensor


def bilinear_vote(
    events: Tensor,
    image_size: Tuple[int, int],
    weight: Union[float, Tensor] = 1.0,
    eps: float = 1e-6,
) -> Tensor:
    """Bilinear voting of ``[..., n, 4]`` events into ``[..., H, W]``.

    ``weight`` is a scalar or a tensor broadcastable to ``[..., n]``; zero
    weights make padded events inert."""
    h, w = image_size
    x = events[..., 0]
    y = events[..., 1]
    fl_x = torch.floor(x + eps)
    fl_y = torch.floor(y + eps)
    fx = x - fl_x
    fy = y - fl_y
    wgt = torch.as_tensor(weight, dtype=x.dtype, device=x.device)
    batch = x.shape[:-1]
    n_img = 1
    for b in batch:
        n_img *= b
    base = (torch.arange(n_img, device=x.device) * (h * w)).reshape(batch + (1,))
    vals, inds = [], []
    for dr, dc, wr, wc in (
        (0, 0, 1 - fx, 1 - fy),
        (1, 0, fx, 1 - fy),
        (0, 1, 1 - fx, fy),
        (1, 1, fx, fy),
    ):
        row = fl_x + dr
        col = fl_y + dc
        inside = (row >= 0) & (row < h) & (col >= 0) & (col < w)
        lin = torch.where(inside, row * w + col, torch.zeros_like(row)).to(torch.int64)
        inds.append((lin + base).reshape(-1))
        vals.append((wr * wc * wgt * inside).reshape(-1))
    image = torch.zeros(n_img * h * w, dtype=x.dtype, device=x.device)
    image = image.index_add(0, torch.cat(inds), torch.cat(vals))
    return image.reshape(batch + (h, w))


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
