"""Tile-grid -> dense-flow interpolation and pyramid resampling (port of
``event_based_optical_flow_tpu/ops/interp.py``).

* ``resize_flow`` — resize the last two axes as the JAX package's does:
  ``bilinear`` is ``jax.image.resize(method="linear")``, the half-pixel
  convention with edge clamping when upsampling (torch
  ``align_corners=False``) and a triangle filter widened by the factor
  (antialiased) along an axis that shrinks; ``nearest`` reads
  ``floor(dst * in / out)`` (torch's nearest).
* ``tile_to_dense_flow`` — negate the per-tile motion, replicate-pad by a
  patch-geometry-derived margin, upscale by the sliding-window factor
  (bilinear, half-pixel convention with edge clamping, as
  ``jax.image.resize(method="linear")`` upsamples), center-crop to the
  sensor size.  Differentiable w.r.t. the motion.
* ``pyramid_expand`` / ``pyramid_reduce`` — factor-2 bilinear resize
  combined with a sigma = 2*factor/6 gaussian smooth (symmetric boundary),
  the coarse<->fine initialization feedback between pyramid scales.  The
  JAX package runs these in host numpy; here they run on the solver's
  device so the warm-start state never leaves it.

The resizes are written as four static-index gathers and a lerp (index
and weight tables from numpy): no ``F.interpolate`` and no convolution.
"""

import functools
import math
from typing import Tuple

import numpy as np
import torch

from .blur import _pad_index

Tensor = torch.Tensor


@functools.lru_cache(maxsize=256)
def _bilinear_tables(in_h: int, in_w: int, oh: int, ow: int, device: torch.device, dtype: torch.dtype):
    """(y0, y1, x0, x1, wy, wx) of a half-pixel resize, on the device, once
    per geometry: a table built per call would copy from the host in every
    evaluation, which a CUDA graph cannot capture."""
    ys = (np.arange(oh) + 0.5) * in_h / oh - 0.5
    xs = (np.arange(ow) + 0.5) * in_w / ow - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, in_h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, in_w - 1)
    y1 = np.clip(y0 + 1, 0, in_h - 1)
    x1 = np.clip(x0 + 1, 0, in_w - 1)
    wy = torch.as_tensor(np.clip(ys - y0, 0.0, 1.0), dtype=dtype, device=device)
    wx = torch.as_tensor(np.clip(xs - x0, 0.0, 1.0), dtype=dtype, device=device)
    return tuple(torch.as_tensor(a, device=device) for a in (y0, y1, x0, x1)) + (wy, wx)


@functools.lru_cache(maxsize=256)
def _index_table(kind: str, n: int, m: int, device: torch.device) -> Tensor:
    """A static gather index on the device, once per geometry: ``clamp``,
    the n indices of an axis replicate-padded by m on both sides;
    ``nearest``, the m sources of a nearest resize of n."""
    if kind == "clamp":
        values = np.clip(np.arange(-m, n + m), 0, n - 1)
    else:
        values = np.arange(m) * n // m
    return torch.as_tensor(values, device=device)


def _resize_bilinear(img: Tensor, out_hw: Tuple[int, int]) -> Tensor:
    """Half-pixel bilinear resize with edge clamping, last two axes."""
    y0, y1, x0, x1, wy, wx = _bilinear_tables(img.shape[-2], img.shape[-1], out_hw[0], out_hw[1],
                                              img.device, img.dtype)
    rows0 = img.index_select(-2, y0)
    rows1 = img.index_select(-2, y1)
    a = rows0.index_select(-1, x0)
    b = rows0.index_select(-1, x1)
    c = rows1.index_select(-1, x0)
    d = rows1.index_select(-1, x1)
    top = a * (1 - wx)[None, :] + b * wx[None, :]
    bot = c * (1 - wx)[None, :] + d * wx[None, :]
    return top * (1 - wy)[:, None] + bot * wy[:, None]


def _resize_nearest(img: Tensor, out_hw: Tuple[int, int]) -> Tensor:
    """torch nearest semantics: src = floor(dst * in / out)."""
    ih = _index_table("nearest", img.shape[-2], out_hw[0], img.device)
    iw = _index_table("nearest", img.shape[-1], out_hw[1], img.device)
    return img.index_select(-2, ih).index_select(-1, iw)


@functools.lru_cache(maxsize=256)
def _triangle_weights(n_in: int, n_out: int, device: torch.device, dtype: torch.dtype) -> Tensor:
    """The ``[n_out, n_in]`` weights of ``jax.image.resize``'s linear
    kernel along one axis (its ``compute_weight_mat``): the triangle at
    each half-pixel sample, widened by ``n_in / n_out`` when the axis
    shrinks, normalized to sum 1."""
    inv_scale = n_in / n_out
    sample = (np.arange(n_out) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[:, None] - np.arange(n_in)[None, :]) / max(inv_scale, 1.0)
    weights = np.maximum(0.0, 1.0 - x)
    total = weights.sum(axis=1, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, 1.0), 0.0)
    weights = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[:, None], weights, 0.0)
    return torch.as_tensor(weights, dtype=dtype, device=device)


def resize_flow(flow: Tensor, out_hw: Tuple[int, int], method: str = "bilinear") -> Tensor:
    """Resize a ``[..., H, W]`` tensor to ``[..., *out_hw]`` on its device,
    as the JAX package's ``resize_flow``: ``bilinear`` is the half-pixel
    lerp with edge clamping (torch ``align_corners=False``) when neither
    axis shrinks, else ``jax.image.resize``'s antialiased linear filter
    (two small matrix products); ``nearest`` reads ``floor(dst * in /
    out)``; any other method raises ``ValueError``."""
    out_hw = tuple(out_hw)
    if method == "bilinear":
        in_h, in_w = flow.shape[-2:]
        if out_hw[0] >= in_h and out_hw[1] >= in_w:
            return _resize_bilinear(flow, out_hw)
        wy = _triangle_weights(in_h, out_hw[0], flow.device, flow.dtype)
        wx = _triangle_weights(in_w, out_hw[1], flow.device, flow.dtype)
        return wy @ flow @ wx.T
    if method == "nearest":
        return _resize_nearest(flow, tuple(out_hw))
    raise ValueError(f"Unknown filter type {method!r}")


def tile_to_dense_flow(
    motion: Tensor,
    patch_image_size: Tuple[int, int],
    image_shape: Tuple[int, int],
    patch_size: Tuple[int, int],
    sliding_window: Tuple[int, int],
    patch_shift: Tuple[int, int] = (0, 0),
    filter_type: str = "bilinear",
) -> Tensor:
    """[2 * h_p * w_p] tile motions -> [2, H, W] dense flow (negated)."""
    pad_h = int(patch_size[0] / 2 // sliding_window[0]) + patch_shift[0] // sliding_window[0] + 1
    pad_w = int(patch_size[1] / 2 // sliding_window[1]) + patch_shift[1] // sliding_window[1] + 1
    arr = -motion.reshape((2,) + tuple(patch_image_size))
    # replicate padding as clamped gathers: their backward is a scatter add
    # that deterministic mode orders (replicate pad's own backward is not)
    for axis, pad in ((-2, pad_h), (-1, pad_w)):
        n = arr.shape[axis]
        arr = arr.index_select(axis, _index_table("clamp", n, pad, arr.device))
    out_hw = (arr.shape[1] * sliding_window[0], arr.shape[2] * sliding_window[1])
    dense = resize_flow(arr, out_hw, filter_type)
    cx, cy = dense.shape[1] // 2, dense.shape[2] // 2
    h1 = cx - image_shape[0] // 2
    w1 = cy - image_shape[1] // 2
    return dense[..., h1 : h1 + image_shape[0], w1 : w1 + image_shape[1]]


def _gaussian1d(sigma: float) -> np.ndarray:
    radius = int(4.0 * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _smooth(img: Tensor, sigma: float) -> Tensor:
    """Separable gaussian along the last two axes, symmetric boundary
    (taps accumulated from zero in the numpy twin's order)."""
    k = _gaussian1d(sigma)
    r = len(k) // 2
    out = img
    for axis in (-2, -1):
        n = out.shape[axis]
        padded = out.index_select(axis, _pad_index(n, r, "symmetric", out.device))
        acc = torch.zeros_like(out)
        for i, c in enumerate(k):
            acc = acc + float(c) * padded.narrow(axis, i, n)
        out = acc
    return out


def pyramid_expand(motion: Tensor, upscale: int = 2) -> Tensor:
    """[c, h, w] -> [c, h*2, w*2]: bilinear upsample then smooth
    (skimage pyramid_expand equivalent, sigma = 2*upscale/6)."""
    out_hw = (motion.shape[-2] * upscale, motion.shape[-1] * upscale)
    return _smooth(_resize_bilinear(motion, out_hw), 2.0 * upscale / 6.0)


def pyramid_reduce(motion: Tensor, downscale: int = 2) -> Tensor:
    """[c, h, w] -> [c, ceil(h/2), ceil(w/2)]: smooth then downsample
    (skimage pyramid_reduce equivalent)."""
    smoothed = _smooth(motion, 2.0 * downscale / 6.0)
    out_hw = (
        int(math.ceil(motion.shape[-2] / downscale)),
        int(math.ceil(motion.shape[-1] / downscale)),
    )
    return _resize_bilinear(smoothed, out_hw)
