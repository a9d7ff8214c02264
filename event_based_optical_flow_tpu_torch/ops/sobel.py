"""3x3 Sobel stencils as shifted-slice sums (port of
``event_based_optical_flow_tpu/ops/sobel.py``): zero-padded correlation with

    Gx = [[-1,-2,-1],[0,0,0],[1,2,1]]   (gradient along the height axis)
    Gy = [[-1,0,1],[-2,0,2],[-1,0,1]]   (gradient along the width axis)

No ``conv2d`` (no cuDNN TF32); terms are summed in the JAX package's order.
"""

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

_GX = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))
_GY = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))


def _correlate3(image: Tensor, kernel) -> Tensor:
    h, w = image.shape[-2], image.shape[-1]
    p = F.pad(image, (1, 1, 1, 1))
    out = None
    for i in range(3):
        for j in range(3):
            c = kernel[i][j]
            if c == 0.0:
                continue
            term = c * p[..., i : i + h, j : j + w]
            out = term if out is None else out + term
    return out


def sobel_xy(image: Tensor):
    """Return (gx, gy) for a [..., H, W] image."""
    return _correlate3(image, _GX), _correlate3(image, _GY)


def sobel_flow(flow: Tensor) -> Tensor:
    """[..., 2, H, W] flow -> [..., 4, H, W] channels (dxx, dyy, dyx, dxy):
    Sobel_x on u, Sobel_y on v, Sobel_x on v, Sobel_y on u."""
    u = flow[..., 0, :, :]
    v = flow[..., 1, :, :]
    return torch.stack(
        [_correlate3(u, _GX), _correlate3(v, _GY), _correlate3(v, _GX), _correlate3(u, _GY)],
        dim=-3,
    )
