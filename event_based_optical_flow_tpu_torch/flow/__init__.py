"""Flow layer of the port: accuracy metrics, GT advection, flow-map files."""

from .gt import estimate_corresponding_gt_flow
from .io import read_png16, save_flow_frame, write_flow_dsec_png
from .metrics import calculate_flow_error, calculate_flow_error_numpy

__all__ = ["calculate_flow_error", "calculate_flow_error_numpy", "estimate_corresponding_gt_flow", "read_png16", "save_flow_frame",
           "write_flow_dsec_png"]
