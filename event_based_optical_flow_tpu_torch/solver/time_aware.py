"""Time-aware single-scale tile solver (port of
``event_based_optical_flow_tpu/solver/time_aware.py``, registry name
``time_aware_mixed_patch_contrast_maximization``): the single-scale solver
whose dense flow is propagated into a ``[time_bin, 2, H, W]`` voxel before
warping.  The objective voxelizes itself (``ObjectiveSpec.time_aware``), so
this subclass only overrides the metrics' ``motion_to_dense_flow``.
"""

import torch

from ..flow.voxel import construct_dense_flow_voxel
from .mixed import MixedPatchContrastMaximization


class TimeAwarePatchContrastMaximization(MixedPatchContrastMaximization):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if not self.is_time_aware:
            raise ValueError("time_aware_mixed_patch_contrast_maximization needs 'solver.time_aware: true'")

    def motion_to_dense_flow(self, motion: torch.Tensor) -> torch.Tensor:
        """[2, h_p, w_p] tiles -> [time_bin, 2, H, W] voxel."""
        motion = torch.as_tensor(motion)
        scale = torch.amax(motion) if self.scale_later else 1.0
        dense_t0 = super().motion_to_dense_flow(motion / scale)
        voxel = construct_dense_flow_voxel(dense_t0, self.time_bin, self.flow_interpolation,
                                           t0_location=self.t0_flow_location)
        return voxel * scale
