"""EV-FlowNet building blocks (port of
``event_based_optical_flow_tpu/models/basic_layers.py``), NCHW.

The JAX package's flax layers, with their numerics kept:

* ``Conv2d`` pads as flax's ``padding="SAME"`` does: ``pad_total = max((out
  - 1) s + k - n, 0)`` split ``pad_total // 2`` before and the rest after,
  so a stride-2 3x3 conv on an even side pads (0, 1), not torch's (1, 1).
* ``GroupNorm`` with one channel per group (the instance norm of the JAX
  package) computes flax's fast variance ``max(E[x^2] - E[x]^2, 0)`` with
  eps 1e-6.
* The decoder's 2x upsample (``jax.image.resize(..., "linear")``, half-pixel
  centers, edge samples clamped) and its reflect pad are fixed-weight sums
  of slices: their backward is slicing and concatenation, deterministic on
  the GPU (``F.interpolate``'s bilinear backward and reflection padding's
  backward have no deterministic CUDA implementation).

Initialization follows flax's distributions: conv kernels ``lecun_normal``
(a normal truncated at two standard deviations, fan-in scaled, drawn in
float32 from the caller's ``torch.Generator`` in creation order), biases
zero, norm scales one.
"""

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

Tensor = torch.Tensor

# std of a unit normal truncated to [-2, 2] (flax's variance_scaling constant)
_TRUNC_STD = 0.87962566103423978


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Module):
    """A conv with flax's ``SAME`` (or ``VALID``) padding and init."""

    def __init__(self, in_ch: int, features: int, kernel: int, stride: int = 1, padding: str = "SAME"):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.weight = nn.Parameter(torch.empty(features, in_ch, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        fan_in = self.weight.shape[1] * self.kernel * self.kernel
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        with torch.no_grad():
            w = torch.empty(self.weight.shape, dtype=torch.float32)
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
            self.weight.copy_(w)

    def forward(self, x: Tensor) -> Tensor:
        if self.padding == "SAME":
            top, bottom = _same_pads(x.shape[-2], self.kernel, self.stride)
            left, right = _same_pads(x.shape[-1], self.kernel, self.stride)
            if top or bottom or left or right:
                x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, self.bias, self.stride)


class GroupNorm(nn.Module):
    """flax ``GroupNorm(num_groups=None, group_size=1)``: per sample and
    channel over the image, fast variance, eps 1e-6, a scale and a bias."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: Tensor) -> Tensor:
        mean = x.mean(dim=(-2, -1), keepdim=True)
        var = torch.clamp((x * x).mean(dim=(-2, -1), keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight[:, None, None]
        return (x - mean) * mul + self.bias[:, None, None]


class ConvBlock(nn.Module):
    """general_conv2d: stride-2 (default) 3x3 conv + activation + opt. norm."""

    def __init__(self, in_ch: int, features: int, kernel: int = 3, strides: int = 2, use_norm: bool = False,
                 activation: str = "relu"):
        super().__init__()
        self.activation = activation
        self.conv = Conv2d(in_ch, features, kernel, strides)
        self.norm = GroupNorm(features) if use_norm else None

    def forward(self, x: Tensor) -> Tensor:
        x = self.conv(x)
        if self.activation == "relu":
            x = torch.relu(x)
        elif self.activation == "tanh":
            x = torch.tanh(x)
        return x if self.norm is None else self.norm(x)


class ResidualBlock(nn.Module):
    """Two stride-1 conv blocks with a skip connection."""

    def __init__(self, features: int, use_norm: bool = False):
        super().__init__()
        self.blocks = nn.ModuleList([ConvBlock(features, features, strides=1, use_norm=use_norm) for _ in range(2)])

    def forward(self, x: Tensor) -> Tensor:
        h = x
        for block in self.blocks:
            h = block(h)
        return h + x


def upsample2x(x: Tensor) -> Tensor:
    """2x bilinear upsample of the last two axes with half-pixel centers:
    ``out[2i] = 0.75 x[i] + 0.25 x[i - 1]``, ``out[2i + 1] = 0.75 x[i] +
    0.25 x[i + 1]``, the neighbour clamped at the edges."""
    for dim in (-2, -1):
        n = x.shape[dim]
        prev = torch.cat([x.narrow(dim, 0, 1), x.narrow(dim, 0, n - 1)], dim=dim)
        nxt = torch.cat([x.narrow(dim, 1, n - 1), x.narrow(dim, n - 1, 1)], dim=dim)
        even = 0.75 * x + 0.25 * prev
        odd = 0.75 * x + 0.25 * nxt
        shape = list(x.shape)
        shape[dim] = 2 * n
        x = torch.stack([even, odd], dim=dim).reshape(shape)
    return x


def reflect_pad1(x: Tensor) -> Tensor:
    """Reflect-pad the last two axes by one (``jnp.pad(mode="reflect")``:
    the edge is not repeated)."""
    for dim in (-2, -1):
        n = x.shape[dim]
        x = torch.cat([x.narrow(dim, 1, 1), x, x.narrow(dim, n - 2, 1)], dim=dim)
    return x


class UpsampleConvAndPredict(nn.Module):
    """Decoder stage: bilinear 2x upsample, reflect-padded 3x3 conv (ReLU),
    then a 1x1 tanh flow head scaled by ``scale``; returns
    (concat(features, flow), flow)."""

    def __init__(self, in_ch: int, features: int, scale: float = 256.0, use_norm: bool = False):
        super().__init__()
        self.scale = scale
        self.conv = Conv2d(in_ch, features, 3, 1, padding="VALID")
        self.norm = GroupNorm(features) if use_norm else None
        self.head = Conv2d(features, 2, 1, 1)

    def forward(self, x: Tensor) -> Tuple[Tensor, Tensor]:
        x = torch.relu(self.conv(reflect_pad1(upsample2x(x))))
        if self.norm is not None:
            x = self.norm(x)
        flow = torch.tanh(self.head(x)) * self.scale
        return torch.cat([x, flow], dim=-3), flow
