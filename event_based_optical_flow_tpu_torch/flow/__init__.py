"""Flow layer of the port: accuracy metrics, GT advection, flow-map files,
and the time-aware flow voxel's propagation (``voxel``)."""

from .gt import estimate_corresponding_gt_flow, generate_dense_optical_flow
from .io import read_png16, save_flow_frame, write_flow_dsec_png
from .metrics import calculate_flow_error, calculate_flow_error_numpy
from .voxel import burgers_step, construct_dense_flow_voxel, propagate_flow_to_voxel, upwind_step

__all__ = [
    "upwind_step",
    "burgers_step",
    "construct_dense_flow_voxel",
    "propagate_flow_to_voxel",
    "calculate_flow_error",
    "calculate_flow_error_numpy",
    "estimate_corresponding_gt_flow",
    "generate_dense_optical_flow",
    "read_png16",
    "save_flow_frame",
    "write_flow_dsec_png",
]
