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

The bilinear resize is a lerp along the width, then one along the height
(index and weight tables from numpy): no ``F.interpolate`` and no
convolution.  Where an axis grows by a whole factor ``s`` (always in
``tile_to_dense_flow``), its output is viewed as ``[n, s]`` and each run
of phases that reads the same sources is one broadcast lerp of two
``blur.take`` slices of the input; otherwise the axis gathers with
``index_select``, whose backward under deterministic algorithms is a
sort and a scatter (on the benchmark's geometries only
``pyramid_reduce``'s, which runs under ``no_grad``).
"""

import functools
import math
from typing import Tuple

import numpy as np
import torch

from .blur import pad_axis, take

Tensor = torch.Tensor


def _lerp_table(n_in: int, n_out: int):
    """(i0, i1, w) of a half-pixel resize of one axis with edge clamping
    (numpy): output i reads sources i0 and i1, weighted 1 - w and w."""
    src = (np.arange(n_out) + 0.5) * n_in / n_out - 0.5
    i0 = np.clip(np.floor(src).astype(int), 0, n_in - 1)
    i1 = np.clip(i0 + 1, 0, n_in - 1)
    return i0, i1, np.clip(src - i0, 0.0, 1.0)


@functools.lru_cache(maxsize=256)
def _axis_lerp(n_in: int, n_out: int, device: torch.device, dtype: torch.dtype):
    """(phases, gather) of one axis' resize, on the device once per
    geometry (a table built per call would copy from the host in every
    evaluation, which a CUDA graph cannot capture).  When ``n_out`` is a
    whole multiple ``s`` of ``n_in``, ``phases`` holds, for each run of
    phases ``p`` whose sources over ``q`` (output ``q * s + p``) are the
    same, the source tables and the weights ``1 - w`` and ``w`` as ``[n_in,
    run]``; else ``gather`` holds ``(i0, i1, 1 - w, w)`` as device
    vectors."""
    i0, i1, w = _lerp_table(n_in, n_out)
    w = torch.as_tensor(w, dtype=dtype, device=device)
    if n_out % n_in:
        return None, tuple(torch.as_tensor(a, device=device) for a in (i0, i1)) + (1 - w, w)
    s = n_out // n_in
    i0, i1, w = i0.reshape(n_in, s), i1.reshape(n_in, s), w.reshape(n_in, s)
    phases, p = [], 0
    for q in range(1, s + 1):
        if q == s or not (np.array_equal(i0[:, q], i0[:, p]) and np.array_equal(i1[:, q], i1[:, p])):
            phases.append((tuple(i0[:, p].tolist()), tuple(i1[:, p].tolist()), 1 - w[:, p:q], w[:, p:q]))
            p = q
    return tuple(phases), None


def _lerp_axis(u: Tensor, axis: int, n_out: int) -> Tensor:
    """The half-pixel resize of ``u``'s ``axis`` (-1 or -2) to ``n_out``:
    ``u[i0] * (1 - w) + u[i1] * w`` per output."""
    phases, gather = _axis_lerp(u.shape[axis], n_out, u.device, u.dtype)
    if phases is None:
        i0, i1, w0, w1 = gather
        shape = (-1,) if axis == -1 else (-1, 1)
        return u.index_select(axis, i0) * w0.view(shape) + u.index_select(axis, i1) * w1.view(shape)
    parts = []
    for t0, t1, w0, w1 in phases:  # [.., n, run] (width) or [.., n, run, W] (height)
        if axis == -2:
            w0, w1 = w0[..., None], w1[..., None]
        parts.append(take(u, axis, t0).unsqueeze(axis) * w0 + take(u, axis, t1).unsqueeze(axis) * w1)
    out = parts[0] if len(parts) == 1 else torch.cat(parts, axis)
    return out.flatten(axis - 1, axis)


def _resize_bilinear(img: Tensor, out_hw: Tuple[int, int]) -> Tensor:
    """Half-pixel bilinear resize with edge clamping, last two axes: the
    width's lerp of every input row, then the height's lerp of those rows,
    so each output is ``(a (1 - wx) + b wx) (1 - wy) + (c (1 - wx) + d wx)
    wy`` of its four corners, in that order."""
    return _lerp_axis(_lerp_axis(img, -1, out_hw[1]), -2, out_hw[0])


def _resize_nearest(img: Tensor, out_hw: Tuple[int, int]) -> Tensor:
    """torch nearest semantics: src = floor(dst * in / out)."""
    ih = _nearest_index(img.shape[-2], out_hw[0], img.device)
    iw = _nearest_index(img.shape[-1], out_hw[1], img.device)
    return img.index_select(-2, ih).index_select(-1, iw)


@functools.lru_cache(maxsize=256)
def _nearest_index(n: int, m: int, device: torch.device) -> Tensor:
    """The m sources of a nearest resize of n, on the device once per
    geometry."""
    return torch.as_tensor(np.arange(m) * n // m, device=device)


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
    # replicate padding as the edge slices expanded: their backward is a
    # slice copy and a sum over the expanded axis (``F.pad``'s replicate
    # backward uses atomics)
    arr = pad_axis(pad_axis(arr, -2, pad_h, "clamp"), -1, pad_w, "clamp")
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
        padded = pad_axis(out, axis, r, "symmetric")
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
