"""Gaussian blurs as separable shifted-slice sums (port of
``event_based_optical_flow_tpu/ops/blur.py``).

No ``conv2d``: a convolution would route float32 through cuDNN, whose
TF32 default keeps ~3 decimal digits.  The taps are summed in the same
order as the JAX package.

* ``gaussian_blur3`` — torchvision ``gaussian_blur(kernel_size=3, sigma)``
  with *reflect* padding (edge not repeated); the optimization path.
* ``gaussian_filter`` — scipy ``ndimage.gaussian_filter`` semantics
  (radius = round(4*sigma), *symmetric* padding); the metrics path.
"""

import math
from typing import Sequence

import torch

Tensor = torch.Tensor


def _pad_index(n: int, r: int, mode: str, device) -> Tensor:
    """Source indices of a length-n axis padded by r on both sides."""
    idx = torch.arange(-r, n + r, device=device)
    if mode == "reflect":  # ... 2 1 | 0 1 2 ... n-1 | n-2 ...
        period = max(2 * (n - 1), 1)
        idx = idx.remainder(period)
        return torch.where(idx > n - 1, period - idx, idx)
    if mode == "symmetric":  # ... 1 0 | 0 1 ... n-1 | n-1 n-2 ...
        idx = idx.remainder(2 * n)
        return torch.where(idx > n - 1, 2 * n - 1 - idx, idx)
    raise ValueError(f"unknown pad mode {mode!r}")


def _separable_blur(image: Tensor, kernel: Sequence[float], pad_mode: str) -> Tensor:
    """Apply a 1-D kernel along the last two axes with the given padding."""
    k = len(kernel)
    r = k // 2
    h, w = image.shape[-2], image.shape[-1]
    padded = image.index_select(-2, _pad_index(h, r, pad_mode, image.device))
    out = sum(kernel[i] * padded[..., i : i + h, :] for i in range(k))
    padded = out.index_select(-1, _pad_index(w, r, pad_mode, image.device))
    return sum(kernel[i] * padded[..., :, i : i + w] for i in range(k))


def _gaussian_kernel1d(sigma: float, radius: int) -> list:
    xs = [math.exp(-0.5 * ((i - radius) / sigma) ** 2) for i in range(2 * radius + 1)]
    s = sum(xs)
    return [x / s for x in xs]


def gaussian_blur3(image: Tensor, sigma: float) -> Tensor:
    """3-tap separable gaussian, reflect padding (torchvision parity)."""
    return _separable_blur(image, _gaussian_kernel1d(float(sigma), 1), "reflect")


def gaussian_filter(image: Tensor, sigma: float, truncate: float = 4.0) -> Tensor:
    """scipy.ndimage.gaussian_filter parity (symmetric boundary)."""
    radius = int(truncate * float(sigma) + 0.5)
    if radius < 1:
        return image
    return _separable_blur(image, _gaussian_kernel1d(float(sigma), radius), "symmetric")
