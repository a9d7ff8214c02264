"""EV-FlowNet and its event voxel-grid input (port of
``event_based_optical_flow_tpu/models/ev_flownet.py``), NCHW.

4 stride-2 encoders (64/128/256/512 channels), 2 residual transition
blocks, 4 decoder stages each predicting a 2-channel flow at increasing
resolution (tanh * scale_time) that is concatenated into the next stage's
input together with the encoder skip (``[x, skip]``, as in the JAX
package).  Returns ``{"flow0"`` (coarsest) ... ``"flow3"`` (full
resolution)``}``, each ``[B, 2, h, w]``, channel 0 the height component.
"""

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..ops import iwe as iwe_ops
from ..ops.warp import _masked_max, _masked_min
from .basic_layers import ConvBlock, Conv2d, ResidualBlock, UpsampleConvAndPredict

Tensor = torch.Tensor

_BASE_CHANNELS = 64
_ENCODER_MULTS = (1, 2, 4, 8)
_DECODER_MULTS = (4, 2, 1, 0.5)


class EVFlowNet(nn.Module):
    """EV-FlowNet at the published widths; ``forward(voxel [B, n_bin, H, W])``
    with H and W divisible by 16.  Parameters are drawn at construction from
    ``torch.Generator().manual_seed(seed)`` on the CPU (flax's
    distributions), so a seed gives the same weights on every device."""

    def __init__(self, n_bin: int = 4, scale_time: float = 128.0, use_norm: bool = False, seed: int = 0):
        super().__init__()
        self.n_bin, self.scale_time = n_bin, scale_time
        c = _BASE_CHANNELS
        chans = [n_bin] + [m * c for m in _ENCODER_MULTS]
        self.encoders = nn.ModuleList(
            [ConvBlock(chans[i], chans[i + 1], use_norm=use_norm) for i in range(len(_ENCODER_MULTS))])
        self.residuals = nn.ModuleList([ResidualBlock(8 * c, use_norm) for _ in range(2)])
        decoders, in_ch = [], 8 * c
        for i, mult in enumerate(_DECODER_MULTS):
            feats = int(mult * c)
            decoders.append(UpsampleConvAndPredict(in_ch + chans[4 - i], feats, scale_time, use_norm))
            in_ch = feats + 2
        self.decoders = nn.ModuleList(decoders)
        generator = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, Conv2d):
                m.reset_parameters(generator)

    def forward(self, voxel: Tensor) -> Dict[str, Tensor]:
        x = voxel
        skips = []
        for enc in self.encoders:
            x = enc(x)
            skips.append(x)
        for res in self.residuals:
            x = res(x)
        flows = {}
        for i, dec in enumerate(self.decoders):
            x, flows[f"flow{i}"] = dec(torch.cat([x, skips[3 - i]], dim=-3))
        return flows


def events_to_voxel_grid(events: Tensor, image_size: Tuple[int, int], n_bin: int = 4,
                         weights: Optional[Tensor] = None) -> Tensor:
    """Rasterize ``[..., n, 4]`` events into ``[..., n_bin, H, W]``
    time-binned voxel grids: each event votes its polarity sign (times its
    weight) times its temporal bilinear weight for bin ``b``, ``max(0, 1 -
    |pos - 0.5 - b|)`` with ``pos = (t - t_min) / span * n_bin`` (the masked
    time range of its own event set).  Every plane of every event set is
    voted in one call of ``bilinear_vote`` (one K8 launch on the GPU, which
    reads each event set once for its ``n_bin`` planes: the planes' events
    are a stride-0 expand)."""
    t = events[..., 2]
    t_min = _masked_min(t, weights)[..., None]
    t_max = _masked_max(t, weights)[..., None]
    span = torch.where(t_max > t_min, t_max - t_min, torch.ones_like(t_max))
    pos = (t - t_min) / span * n_bin
    pol = torch.where(events[..., 3] > 0, 1.0, -1.0).to(events.dtype)
    base_w = pol if weights is None else pol * weights
    bins = torch.arange(n_bin, dtype=events.dtype, device=events.device)[:, None]
    w_b = torch.clamp(1.0 - torch.abs(pos[..., None, :] - 0.5 - bins), min=0.0)  # [..., n_bin, n]
    planes = events[..., None, :, :].expand(events.shape[:-2] + (n_bin,) + events.shape[-2:])
    return iwe_ops.bilinear_vote(planes, tuple(image_size), weight=base_w[..., None, :] * w_b)
