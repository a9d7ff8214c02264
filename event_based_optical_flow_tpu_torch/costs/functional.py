"""Pure-function cost kernels (port of
``event_based_optical_flow_tpu/costs/functional.py``).

All functions return the 'natural' (unsigned) value; direction handling
lives in the registry wrappers.  Reductions run over the last two
(image) axes, so a ``[..., H, W]`` stack of images gives ``[...]``
values — the init sweep scores every patch x candidate in one call.
Variance uses ddof=1 by default (the optimization path); the FWL metric
passes ddof=0.
"""

import torch

from ..ops.sobel import sobel_flow, sobel_xy

Tensor = torch.Tensor


def nan_to_penalty(loss: Tensor, penalty: float = 1e10) -> Tensor:
    """Guard a cost against NaN: a large finite penalty instead of the
    reference's 0, so line searches and candidate sweeps reject NaN basins;
    every finite value is unchanged (the JAX package's documented
    deviation, kept)."""
    return torch.where(torch.isnan(loss), torch.full_like(loss, penalty), loss)


def variance(x: Tensor, ddof: int = 1) -> Tensor:
    """Variance over all elements (the JAX package's ``variance``)."""
    n = x.numel()
    mean = x.mean()
    return torch.square(x - mean).sum() / max(n - ddof, 1)


def image_variance(iwe: Tensor, omit_boundary: bool = True, ddof: int = 1) -> Tensor:
    """Var(IWE) over all elements."""
    if omit_boundary:
        iwe = iwe[..., 1:-1, 1:-1]
    return variance(iwe, ddof)


def gradient_magnitude(iwe: Tensor, omit_boundary: bool = True, image_axes: int = 2) -> Tensor:
    """mean(||Sobel(IWE)/8||^2) over the last ``image_axes`` axes: 2 for an
    image, 3 for a polarity IWE's ``[2, H, W]`` (one value over both
    channels, as the JAX package takes the mean of the whole array)."""
    gx, gy = sobel_xy(iwe)
    gx = gx / 8.0
    gy = gy / 8.0
    if omit_boundary:
        gx = gx[..., 1:-1, 1:-1]
        gy = gy[..., 1:-1, 1:-1]
    return (torch.square(gx) + torch.square(gy)).mean(dim=tuple(range(-image_axes, 0)))


def normalized_image_variance(iwe: Tensor, orig_iwe: Tensor, omit_boundary: bool = True, ddof: int = 1) -> Tensor:
    """Var(IWE)/Var(orig), natural orientation (only ``iwe`` is cropped —
    reference quirk kept)."""
    if omit_boundary:
        iwe = iwe[..., 1:-1, 1:-1]
    return variance(iwe, ddof) / variance(orig_iwe, ddof)


def normalized_gradient_magnitude(iwe: Tensor, orig_iwe: Tensor, omit_boundary: bool = True,
                                  image_axes: int = 2) -> Tensor:
    """GradMag(IWE)/GradMag(orig), natural orientation."""
    return (gradient_magnitude(iwe, omit_boundary, image_axes)
            / gradient_magnitude(orig_iwe, omit_boundary, image_axes))


def multi_focal_normalized_image_variance(
    orig_iwe: Tensor,
    forward_iwe: Tensor,
    backward_iwe: Tensor,
    middle_iwe=None,
    omit_boundary: bool = True,
    ddof: int = 1,
) -> Tensor:
    """Multi-reference focal loss, variance flavor, minimize orientation:
    Var(orig)/Var(fwd) + Var(orig)/Var(bwd) [+ 2 Var(orig)/Var(mid)]; the
    warped images are cropped before the ratio, the orig image is not."""
    if omit_boundary:
        forward_iwe = forward_iwe[..., 1:-1, 1:-1]
        backward_iwe = backward_iwe[..., 1:-1, 1:-1]
        if middle_iwe is not None:
            middle_iwe = middle_iwe[..., 1:-1, 1:-1]
    var_orig = variance(orig_iwe, ddof)
    loss = var_orig / variance(forward_iwe, ddof) + var_orig / variance(backward_iwe, ddof)
    if middle_iwe is not None:
        loss = loss + 2.0 * var_orig / variance(middle_iwe, ddof)
    return loss


def multi_focal_normalized_gradient_magnitude(
    orig_iwe: Tensor,
    forward_iwe: Tensor,
    backward_iwe: Tensor,
    middle_iwe=None,
    omit_boundary: bool = True,
    image_axes: int = 2,
) -> Tensor:
    """Multi-reference focal loss, gradient-magnitude flavor, minimize
    orientation: G(orig)/G(fwd) + G(orig)/G(bwd) [+ 2 G(orig)/G(mid)]."""
    g_orig = gradient_magnitude(orig_iwe, omit_boundary, image_axes)
    loss = g_orig / gradient_magnitude(forward_iwe, omit_boundary, image_axes)
    loss = loss + g_orig / gradient_magnitude(backward_iwe, omit_boundary, image_axes)
    if middle_iwe is not None:
        loss = loss + 2.0 * g_orig / gradient_magnitude(middle_iwe, omit_boundary, image_axes)
    return loss


def total_variation(flow: Tensor, omit_boundary: bool = True) -> Tensor:
    """mean |Sobel(flow)/8| over the 4 (dxx,dyy,dyx,dxy) channels; the ring
    is cropped only when the spatial dims exceed 2 (reference quirk kept
    for tiny tile grids).  The absolute value takes ``jnp.abs``'s
    derivative, +1 at 0 (``torch.abs`` takes 0 there): a uniform tile
    motion, whose Sobel taps are all 0, gets the JAX package's gradient."""
    sob = sobel_flow(flow) / 8.0
    if omit_boundary and sob.shape[-2] > 2 and sob.shape[-1] > 2:
        sob = sob[..., 1:-1, 1:-1]
    return torch.where(sob >= 0, sob, -sob).mean()
