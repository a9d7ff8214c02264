"""Gaussian blurs as separable shifted-slice sums (port of
``event_based_optical_flow_tpu/ops/blur.py``).

No ``conv2d``: a convolution would route float32 through cuDNN, whose
TF32 default keeps ~3 decimal digits.  The taps are summed in the same
order as the JAX package.

* ``gaussian_blur3`` — torchvision ``gaussian_blur(kernel_size=3, sigma)``
  with *reflect* padding (edge not repeated); the optimization path.
* ``gaussian_filter`` — scipy ``ndimage.gaussian_filter`` semantics
  (radius = round(4*sigma), *symmetric* padding); the metrics path.

The pads (``pad_axis``, also ``ops/interp.py``'s) and every other static
gather of the objective (``take``) are slices of the input joined by
``torch.cat``: their adjoint is slice copies and sums in a fixed order.
An ``index_select`` gather's backward under deterministic algorithms
sorts its indices and scatters them (``index_put`` with accumulate), and
``F.pad``'s reflect and replicate backward use atomics.
"""

import functools
import math
from typing import Sequence, Tuple

import numpy as np
import torch

Tensor = torch.Tensor


@functools.lru_cache(maxsize=1024)
def _runs(table: Tuple[int, ...]) -> Tuple[Tuple[int, int, int], ...]:
    """(first source, step, length) of each maximal run of ``table`` whose
    sources step by -1, 0 or +1, left to right."""
    runs, i = [], 0
    while i < len(table):
        step = table[i + 1] - table[i] if i + 1 < len(table) else 1
        step = step if step in (-1, 0, 1) else 1
        j = i + 1
        while j < len(table) and table[j] - table[j - 1] == step:
            j += 1
        runs.append((table[i], step, j - i))
        i = j
    return tuple(runs)


def take(x: Tensor, axis: int, table: Tuple[int, ...]) -> Tensor:
    """``x.index_select(axis, table)`` for a static ``table`` (a tuple of
    ints), as narrow, flipped and expanded slices of ``x`` joined by
    ``torch.cat``: the same values, and an adjoint of slice copies and
    sums in a fixed order (no sort, no scatter, no atomics)."""
    pieces = []
    for first, step, length in _runs(table):
        if step == 0:
            shape = list(x.shape)
            shape[axis] = length
            pieces.append(x.narrow(axis, first, 1).expand(shape))
        elif step == 1:
            pieces.append(x if length == x.shape[axis] else x.narrow(axis, first, length))
        else:
            pieces.append(x.narrow(axis, first - length + 1, length).flip(axis))
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, axis)


@functools.lru_cache(maxsize=256)
def _pad_sides(n: int, r: int, mode: str) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Source indices of the r entries before and the r after a length-n
    axis padded on both sides."""
    idx = np.arange(-r, n + r)
    if mode == "reflect":  # ... 2 1 | 0 1 2 ... n-1 | n-2 ...
        period = max(2 * (n - 1), 1)
        idx = idx % period
        idx = np.where(idx > n - 1, period - idx, idx)
    elif mode == "symmetric":  # ... 1 0 | 0 1 ... n-1 | n-1 n-2 ...
        idx = idx % (2 * n)
        idx = np.where(idx > n - 1, 2 * n - 1 - idx, idx)
    elif mode == "clamp":  # 0 0 | 0 1 ... n-1 | n-1 n-1
        idx = np.clip(idx, 0, n - 1)
    else:
        raise ValueError(f"unknown pad mode {mode!r}")
    return tuple(idx[:r].tolist()), tuple(idx[n + r:].tolist())


def pad_axis(x: Tensor, axis: int, r: int, mode: str) -> Tensor:
    """``x`` padded by ``r`` on both sides of ``axis`` (``reflect``,
    ``symmetric`` or ``clamp``): ``x`` itself between the two sides'
    ``take``."""
    if r == 0:
        return x
    before, after = _pad_sides(x.shape[axis], r, mode)
    return torch.cat([take(x, axis, before), x, take(x, axis, after)], axis)


def _separable_blur(image: Tensor, kernel: Sequence[float], pad_mode: str) -> Tensor:
    """Apply a 1-D kernel along the last two axes with the given padding."""
    k = len(kernel)
    r = k // 2
    h, w = image.shape[-2], image.shape[-1]
    padded = pad_axis(image, -2, r, pad_mode)
    out = sum(kernel[i] * padded[..., i : i + h, :] for i in range(k))
    padded = pad_axis(out, -1, r, pad_mode)
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
