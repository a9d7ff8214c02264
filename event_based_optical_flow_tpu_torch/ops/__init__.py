"""Op layer of the port: warp, IWE rasterization, blur, sobel, tile
interpolation, and the fused warp+vote kernel (submodule ``fused_iwe``)."""

from .blur import gaussian_blur3, gaussian_filter
from .interp import pyramid_expand, pyramid_reduce, tile_to_dense_flow
from .iwe import bilinear_vote, create_iwe, event_mask
from .sobel import sobel_flow, sobel_xy
from .warp import (calculate_dt, calculate_reftime, multi_direction_dense_warp, warp_2dof,
                   warp_dense_flow, warp_voxel_flow)

__all__ = [
    "bilinear_vote",
    "calculate_dt",
    "calculate_reftime",
    "create_iwe",
    "event_mask",
    "gaussian_blur3",
    "gaussian_filter",
    "multi_direction_dense_warp",
    "pyramid_expand",
    "pyramid_reduce",
    "sobel_flow",
    "sobel_xy",
    "tile_to_dense_flow",
    "warp_2dof",
    "warp_dense_flow",
    "warp_voxel_flow",
]
