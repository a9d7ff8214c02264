"""Flow layer of the port: accuracy metrics and GT advection."""

from .gt import estimate_corresponding_gt_flow
from .metrics import calculate_flow_error

__all__ = ["calculate_flow_error", "estimate_corresponding_gt_flow"]
