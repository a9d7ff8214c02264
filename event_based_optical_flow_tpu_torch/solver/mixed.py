"""Single-scale tile CMax solver (port of
``event_based_optical_flow_tpu/solver/mixed.py``): one tile grid from
``patch.size`` / ``patch.sliding_window``, its motion solved jointly by the
device Newton-CG or L-BFGS (gtol 1e-7, as the JAX package's device
branch), or by any other ``optimizer.method`` from the host (a scipy
method at gtol 1e-7, the sampling optimizer, a first-order rule, optax's
L-BFGS: ``patch_base``).  Every
``solver.patch.initialize`` of the JAX package starts it: ``random``,
``zero``, ``optuna-sampling``, ``grid-best``, ``global-best``
(``patch_base.initialize_from_init``).

With a ``parallel:`` mesh whose event axis is > 1 the device solve takes
the frame's events sharded over the mesh's first row (``patch_base``).

The history register is plotted after every frame and, as in the JAX
package's single-scale solvers, never cleared: a frame's plot shows every
frame's values so far.
"""

import logging

import numpy as np
import torch

from ..utils.tracing import read, span, synced
from .objective import FrameEvents, build_orig_iwe
from .patch_base import PatchContrastMaximization, prepare_patch

logger = logging.getLogger(__name__)


class MixedPatchContrastMaximization(PatchContrastMaximization):
    def __init__(self, image_shape: tuple, calibration_parameter: dict, solver_config: dict = {},
                 optimizer_config: dict = {}, output_config: dict = {}, **kwargs):
        super().__init__(image_shape, calibration_parameter, solver_config, optimizer_config,
                         output_config, **kwargs)
        self.set_patch_size_and_sliding_window()
        self.patches, self.patch_image_size = prepare_patch(image_shape, self.patch_size, self.sliding_window)
        self.n_patch = len(self.patches)
        self.last_frame_stats: dict = {}

    def _initial_motion(self, events_np: np.ndarray, frame: FrameEvents, orig: torch.Tensor) -> torch.Tensor:
        """The warm motion, else ``solver.patch.initialize``'s cold start
        (``initialize_from_init``)."""
        if self.previous_frame_best_estimation is not None:
            return self.previous_frame_best_estimation.clone()
        return self.initialize_from_init(self.slv_config["patch"]["initialize"], events_np, frame, orig)

    def optimize(self, events: np.ndarray) -> torch.Tensor:
        """Solve one frame: the tile motion [2, h_p, w_p] on the solver's
        device."""
        from .. import ops

        self._check_optimizer()
        logger.info(f"Start optimization; DoF {self.motion_vector_size * self.n_patch}")
        events = np.asarray(events, dtype=np.float64)
        spec = self._current_spec()
        before = ops.launch_counts()
        mark = synced()
        with span("solver.prep"):
            frame = self.frame_events(events)
            orig = build_orig_iwe(spec)(frame)
        motion0 = self._initial_motion(events, frame, orig)
        if self._device_newton():
            best_x, best_f, n_iter, hvp = self._run_newton(
                spec, motion0, self._newton_frame(frame, self._shards_events()), orig,
                int(self.opt_config.get("max_iter", 25)), finest=True,
                warm=self.previous_frame_best_estimation is not None, gtol=1e-7)
            loss = float(read(best_f, "scale_loss"))
            self._history_cb(loss)
        else:
            best_x, loss, n_iter, hvp = self._run_host_optimizer(spec, motion0, frame, orig, gtol=1e-7)
        after = ops.launch_counts()
        self.last_frame_stats = {
            "iters": {0: n_iter}, "loss": {0: loss}, "hvp": {0: hvp}, "events": {0: len(events)},
            "launches": {0: {k: after[k] - before[k] for k in after}}, "syncs": synced() - mark,
        }
        self._plot_history()
        logger.info(f"Done: {n_iter} iters ({hvp} HVP), loss {loss:.6f}")
        return best_x.reshape((self.motion_vector_size,) + tuple(self.patch_image_size))

    def set_previous_frame_best_estimation(self, previous_best):
        """Warm start from the previous frame's tile motion (a tensor, or
        the JAX layout's numpy array)."""
        self.previous_frame_best_estimation = self.tensor(
            read(previous_best, "start"))

    def predicted_flow(self, motion, timescale: float) -> torch.Tensor:
        return self.motion_to_dense_flow(torch.as_tensor(motion) * timescale)
