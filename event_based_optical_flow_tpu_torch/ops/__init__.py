"""Op layer of the port: warp and the global motion models' fields, IWE
rasterization, blur, sobel, tile interpolation, the fused warp+vote
kernels (submodule ``fused_iwe``, K1-K7) and the standalone vote kernel
(submodule ``vote``, K8)."""

from . import fused_iwe, vote

from .blur import gaussian_blur3, gaussian_filter
from .interp import pyramid_expand, pyramid_reduce, tile_to_dense_flow
from .iwe import bilinear_vote, create_iwe, event_mask
from .sobel import sobel_flow, sobel_xy
from .warp import (Warp, calculate_dt, calculate_reftime, calib_tuple, flow_from_2d_translation,
                   flow_from_rotation, flow_from_similarity, multi_direction_dense_warp, warp_2dof,
                   warp_dense_flow, warp_voxel_flow)

__all__ = [
    "Warp",
    "bilinear_vote",
    "calculate_dt",
    "calculate_reftime",
    "calib_tuple",
    "create_iwe",
    "event_mask",
    "flow_from_2d_translation",
    "flow_from_rotation",
    "flow_from_similarity",
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
    "add_launch_counts",
    "launch_counts",
    "mesh_launch_counts",
    "reset_launch_counts",
]


def launch_counts() -> dict:
    """Launches of every hand-written kernel since the last reset: the
    ``fused_iwe`` forms (``fused_iwe.launch_counts``) and ``vote`` (K8)."""
    return {**fused_iwe.launch_counts(), **vote.launch_counts()}


def mesh_launch_counts() -> dict:
    """Of the launches since the last reset, those on a shard of an
    event-sharded frame (``fused_iwe.mesh_launch_counts``, and K8's keyed
    ``vote`` and ``vote_from_fixed``)."""
    return {**fused_iwe.mesh_launch_counts(), **vote.mesh_launch_counts()}


def reset_launch_counts() -> None:
    fused_iwe.reset_launch_counts()
    vote.reset_launch_counts()


def add_launch_counts(counts: dict) -> None:
    """Add ``counts`` (keyed as ``launch_counts`` keys them) to the
    counters: the launches of a replayed CUDA graph, whose kernels no
    wrapper launched (``solver/graphs.py``)."""
    fused_iwe.add_launch_counts(counts)
    vote.add_launch_counts(counts)
