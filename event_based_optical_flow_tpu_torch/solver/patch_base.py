"""Patch (tile) based contrast maximization: shared machinery (port of
``event_based_optical_flow_tpu/solver/patch_base.py``): tile-grid
construction, cold init, the per-scale objective and Newton-CG solve, and
the per-patch init sweep.

Route (the JAX package's fused-kernel route, ``patch_base.py:414-419``):
the banded objective with a central finite-difference HVP.  The orig IWE
is voted once per frame and shared by every scale's solve.
"""

import logging
from typing import Dict, Tuple

import numpy as np
import torch

from ..types import FlowPatch
from .base import SolverBase
from .newton_cg import build_newton_cg
from .objective import FrameEvents, ObjectiveSpec, build_objective
from .sampling import build_patch_search, gather_patch_events

logger = logging.getLogger(__name__)


def prepare_patch(
    image_size: Tuple[int, int],
    patch_size: Tuple[int, int],
    sliding_window: Tuple[int, int],
) -> Tuple[Dict[int, FlowPatch], tuple]:
    """Tile-center lattice."""
    image_h, image_w = image_size
    patch_h, patch_w = patch_size
    slide_h, slide_w = sliding_window
    center_x = np.arange(0, image_h - patch_h + slide_h, slide_h) + patch_h / 2
    center_y = np.arange(0, image_w - patch_w + slide_w, slide_w) + patch_w / 2
    xx, yy = np.meshgrid(center_x, center_y)
    patch_shape = xx.T.shape
    xx = xx.T.reshape(-1)
    yy = yy.T.reshape(-1)
    patches = {
        i: FlowPatch(x=xx[i], y=yy[i], shape=patch_size)
        for i in range(len(xx))
    }
    return patches, patch_shape


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(np.ceil(np.log2(max(1, x)))))


class PatchContrastMaximization(SolverBase):
    def __init__(self, image_shape: tuple, calibration_parameter: dict, solver_config: dict = {},
                 optimizer_config: dict = {}, output_config: dict = {}, **kwargs):
        self.patch_shift = (0, 0)
        self.patch_image_size = (0, 0)
        self.n_patch = 0
        self.patches: Dict[int, FlowPatch] = {}
        super().__init__(image_shape, calibration_parameter, solver_config, optimizer_config,
                         output_config, **kwargs)
        self.filter_type = self.slv_config.get("patch", {}).get("filter_type", "bilinear")
        self.syncs = 0  # host reads of device values in the current frame

    # --- initialization strategies ------------------------------------------
    def initialize_random(self) -> torch.Tensor:
        """Uniform in the configured parameter box (the JAX package's numpy
        draws, so cold starts match it exactly)."""
        x0 = self._rng.random((self.motion_vector_size, self.n_patch))
        p = self.opt_config["parameters"]
        x0[0] = x0[0] * (p["trans_x"]["max"] - p["trans_x"]["min"]) + p["trans_x"]["min"]
        x0[1] = x0[1] * (p["trans_y"]["max"] - p["trans_y"]["min"]) + p["trans_y"]["min"]
        return self.tensor(x0)

    def initialize_zeros(self) -> torch.Tensor:
        return torch.zeros((self.motion_vector_size, self.n_patch), dtype=self.dtype, device=self.device)

    # --- objective and Newton solve -------------------------------------------
    def _current_spec(self) -> ObjectiveSpec:
        return ObjectiveSpec(
            image_shape=self.image_shape,
            patch_image_size=tuple(self.patch_image_size),
            patch_size=tuple(self.patch_size),
            sliding_window=tuple(self.sliding_window),
            patch_shift=tuple(self.patch_shift),
            filter_type=self.filter_type,
            blur_sigma=self.iwe_config["blur_sigma"],
            cost_name=self.slv_config["cost"],
            cost_with_weight=(
                tuple(self.slv_config["cost_with_weight"].items())
                if self.slv_config["cost"] == "hybrid"
                else None
            ),
        )

    def _run_newton(self, spec: ObjectiveSpec, x0: torch.Tensor, frame: FrameEvents,
                    orig: torch.Tensor, maxiter: int, cg_maxiter=None):
        """One Newton-CG solve of this scale's objective from ``x0``
        (flat [2 * n_patch]); returns (best_x, best_f, n_iter)."""
        obj = build_objective(spec)
        solve = build_newton_cg(
            lambda x, *a: obj(x, *a)[0],
            maxiter=maxiter,
            cg_maxiter=int(cg_maxiter if cg_maxiter is not None
                           else self.opt_config.get("cg_maxiter", 32)),
            xtol=1e-5,
            gtol=1e-5,
            hvp_mode="fd",
            fd_central=bool(self.opt_config.get("hvp_central", True)),
        )
        best_x, best_f, n_iter = solve(x0.reshape(-1).to(self.dtype), orig, frame)
        self.syncs += solve.syncs
        return best_x, best_f, n_iter

    # --- per-patch init sweep -----------------------------------------------
    def _patch_capacity(self, n_events: int) -> int:
        guess = 2 * n_events // max(1, self.n_patch)
        return int(min(max(512, _next_pow2(guess)), _next_pow2(n_events)))

    def initialize_guess_from_patch_search(self, events_np: np.ndarray, motion0: torch.Tensor,
                                           n_candidates: int) -> torch.Tensor:
        """Per-patch refinement of motion0 [2, n_patch] by the batched
        sampling sweep; returns [2, n_patch]."""
        capacity = self._patch_capacity(len(events_np))
        patch_events, weights, counts = gather_patch_events(events_np, self.patches, capacity)
        search = build_patch_search(
            tuple(self.patch_size), int(n_candidates),
            blur_sigma=self.iwe_config["blur_sigma"], candidates_fn=self.candidates_fn,
        )
        motion1 = search(
            self.tensor(patch_events), self.tensor(weights),
            torch.as_tensor(counts, device=self.device),
            motion0.reshape(2, -1).T.contiguous(), self.generator,
        )
        return motion1.T
