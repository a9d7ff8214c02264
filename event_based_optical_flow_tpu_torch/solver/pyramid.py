"""Pyramidal (coarse-to-fine) tile CMax — the eval protocol's solver (port
of ``event_based_optical_flow_tpu/solver/pyramid.py``: the per-scale loop
``optimize``, ``_presearch_motion``, ``_init_scale``, warm-start averaging,
``update_coarse_from_fine`` and the metrics of ``calculate_flow_error``).

Scales s = 1..patch.scale-1 over a center crop, per-scale non-overlapping
tile grids (size crop/2^s).  The coarsest scale starts from the warm
motion or the cold init; every finer scale starts from the expanded
coarser solution (averaged with the previous frame's when warm), refined
per patch by the sampling sweep; each scale is then solved by Newton-CG.
A fine-to-coarse pyramid_reduce feedback produces the per-scale result.

The JAX package's whole-frame device chains (``_optimize_chain``,
``optimize_with_metrics``) fuse this same loop into one TPU dispatch;
the port runs the loop itself.
"""

import logging
from typing import Dict

import numpy as np
import torch

from ..costs import functional as F
from ..flow.metrics import calculate_flow_error
from ..ops.interp import pyramid_expand, pyramid_reduce, tile_to_dense_flow
from ..ops.iwe import create_iwe, event_mask
from ..ops.warp import calculate_reftime, warp_dense_flow
from .objective import FrameEvents, build_orig_iwe
from .patch_base import PatchContrastMaximization, prepare_patch

logger = logging.getLogger(__name__)


class PyramidalPatchContrastMaximization(PatchContrastMaximization):
    def __init__(self, image_shape: tuple, calibration_parameter: dict, solver_config: dict = {},
                 optimizer_config: dict = {}, output_config: dict = {}, **kwargs):
        super().__init__(image_shape, calibration_parameter, solver_config, optimizer_config,
                         output_config, **kwargs)
        self.coarsest_scale = 1
        self.patch_scales = self.slv_config["patch"]["scale"]
        self.cropped_height = self.slv_config["patch"]["crop_height"]
        self.cropped_width = self.slv_config["patch"]["crop_width"]
        self.cropped_image_shape = (self.cropped_height, self.cropped_width)
        self.prepare_pyramidal_patch(self.cropped_image_shape, self.coarsest_scale, self.patch_scales)
        self.overload_patch_configuration(self.coarsest_scale)
        self.patch_shift = (
            (self.image_shape[0] - self.cropped_height) // 2,
            (self.image_shape[1] - self.cropped_width) // 2,
        )
        self.last_frame_stats: dict = {}

    def prepare_pyramidal_patch(self, image_size, coarsest_scale: int, finest_scale: int):
        """Per-scale tile geometry."""
        self.scaled_patches = {}
        self.scaled_patch_image_size = {}
        self.scaled_n_patch = {}
        self.scaled_patch_size = {}
        self.scaled_sliding_window = {}
        self.total_n_patch = 0
        self.current_scale = coarsest_scale
        for i in range(coarsest_scale, finest_scale):
            scaled = (image_size[0] // (2**i), image_size[1] // (2**i))
            self.scaled_patch_size[i] = scaled
            self.scaled_sliding_window[i] = scaled
            self.scaled_patches[i], self.scaled_patch_image_size[i] = prepare_patch(
                image_size, scaled, scaled
            )
            self.scaled_n_patch[i] = len(self.scaled_patches[i])
            self.total_n_patch += self.scaled_n_patch[i]

    def overload_patch_configuration(self, n_scale: int):
        self.current_scale = n_scale
        self.patches = self.scaled_patches[n_scale]
        self.patch_image_size = self.scaled_patch_image_size[n_scale]
        self.n_patch = self.scaled_n_patch[n_scale]
        self.sliding_window = self.scaled_sliding_window[n_scale]
        self.patch_size = self.scaled_patch_size[n_scale]

    def _scale_budget(self, s: int):
        """(max_iter, cg_maxiter override) for scale ``s``: the
        ``coarse_max_iter`` / ``coarse_cg_maxiter`` knobs apply to every
        scale but the finest."""
        mi = int(self.opt_config.get("max_iter", 25))
        cg = None
        if s < self.patch_scales - 1:
            mi = int(self.opt_config.get("coarse_max_iter", mi))
            if "coarse_cg_maxiter" in self.opt_config:
                cg = int(self.opt_config["coarse_cg_maxiter"])
        return mi, cg

    # ----------------------------------------------------------------- main
    def optimize(self, events: np.ndarray) -> Dict[int, torch.Tensor]:
        """Solve one frame: {scale: motion [2, h_s, w_s]} on the solver's
        device (the finest scale is the output flow's tile motion)."""
        logger.info(f"Start optimization. DoF {self.motion_vector_size * self.total_n_patch}")
        events = np.asarray(events, dtype=np.float64)
        frame = FrameEvents.from_numpy(events, self.device, self.dtype)
        self.overload_patch_configuration(self.coarsest_scale)
        orig = build_orig_iwe(self._current_spec())(frame)
        self.syncs = 0
        stats = {"iters": {}, "loss": {}}
        best_motion_per_scale: Dict[int, torch.Tensor] = {}
        for s in range(self.coarsest_scale, self.patch_scales):
            self.overload_patch_configuration(s)
            spec = self._current_spec()
            presearch = self._presearch_motion(s, best_motion_per_scale)
            if presearch is None:
                x0 = self._init_scale(s)
            else:
                motion0, n_cand = presearch
                x0 = self.initialize_guess_from_patch_search(events, motion0, n_cand)
            scale_mi, scale_cg = self._scale_budget(s)
            best_x, best_f, n_iter = self._run_newton(spec, x0, frame, orig, scale_mi, scale_cg)
            best_motion_per_scale[s] = best_x.reshape((self.motion_vector_size,) + tuple(self.patch_image_size))
            loss = float(best_f)
            self.syncs += 1
            stats["iters"][s], stats["loss"][s] = n_iter, loss
            logger.info(f"Scale {s} done: {n_iter} iters, loss {loss:.6f}")
        stats["syncs"] = self.syncs
        self.last_frame_stats = stats
        return self.update_coarse_from_fine(best_motion_per_scale)

    def _presearch_motion(self, s: int, coarser: Dict[int, torch.Tensor]):
        """For scales that refine a coarser result by the per-patch sweep:
        (pre-sweep motion0 [2, n_patch], n_cand); None for the coarsest."""
        if s <= self.coarsest_scale:
            return None
        expect = self.scaled_patch_image_size[s]
        motion0 = pyramid_expand(coarser[s - 1]).reshape((2,) + tuple(expect))
        warm = self.previous_frame_best_estimation
        if warm is not None:
            motion0 = (motion0 + warm[s]) / 2.0
        n_cand = max(4, int(self.opt_config["n_iter"] / max(1, s - self.coarsest_scale)))
        return motion0.reshape(2, -1), n_cand

    def _init_scale(self, s: int) -> torch.Tensor:
        """Coarsest-scale start: the warm motion, else the configured cold
        init."""
        warm = self.previous_frame_best_estimation
        if warm is not None:
            return warm[s].clone()
        init = self.slv_config["patch"]["initialize"]
        if init == "random":
            return self.initialize_random()
        if init == "zero":
            return self.initialize_zeros()
        raise NotImplementedError(f"Initialization {init!r} is not ported yet")

    def update_coarse_from_fine(self, motion_per_scale: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
        """Fine-to-coarse feedback via pyramid_reduce."""
        finest = max(motion_per_scale.keys())
        coarsest = min(motion_per_scale.keys())
        refined = {finest: motion_per_scale[finest]}
        for i in range(finest, coarsest, -1):
            refined[i - 1] = pyramid_reduce(refined[i])
        return refined

    # --------------------------------------------------------------- metrics
    def motion_to_dense_flow(self, pyramidal_motion, t_scale: float = 1.0) -> torch.Tensor:
        """Finest-scale tiles -> dense flow [2, H, W] (pix/s)."""
        finest = pyramidal_motion[self.current_scale] if isinstance(pyramidal_motion, dict) else pyramidal_motion
        return tile_to_dense_flow(
            torch.as_tensor(finest).reshape(-1), self.patch_image_size, self.image_shape,
            self.patch_size, self.sliding_window, self.patch_shift, self.filter_type,
        )

    def _fwl(self, events: torch.Tensor, flow: torch.Tensor, orig_iwe: torch.Tensor) -> torch.Tensor:
        """Var(IWE_orig)/Var(IWE_warped) of a dense displacement; < 1 is
        better."""
        warped = warp_dense_flow(events, flow, calculate_reftime(events, "first"),
                                 self.image_shape, normalize_t=True)
        warped_iwe = create_iwe(warped, self.image_shape, sigma=1, blur_mode="scipy")
        return 1.0 / F.normalized_image_variance(warped_iwe, orig_iwe, omit_boundary=False, ddof=0)

    def calculate_flow_error(self, motion, gt_flow: np.ndarray, timescale: float, events: np.ndarray) -> dict:
        """AEE/NPE/AE with the event mask, plus GT_FWL and PRED_FWL, of the
        finest motion against the GT displacement ``gt_flow [H, W, 2]``
        over a window of ``timescale`` seconds."""
        with torch.no_grad():
            e = self.tensor(events)
            gt = self.tensor(np.transpose(np.asarray(gt_flow), (2, 0, 1)))
            pred = self.motion_to_dense_flow(motion) * timescale
            orig_iwe = create_iwe(e, self.image_shape, sigma=1, blur_mode="scipy")
            mask = event_mask(e, self.image_shape)[None]
            err = calculate_flow_error(gt[None], pred[None], mask)
            err["GT_FWL"] = self._fwl(e, gt, orig_iwe)
            err["PRED_FWL"] = self._fwl(e, pred, orig_iwe)
            flow_error = {k: float(v) for k, v in err.items()}
        logger.info(f"flow_error = {flow_error} for time period {timescale} sec.")
        return flow_error
