"""Global (whole-frame) motion-model CMax solver (port of
``event_based_optical_flow_tpu/solver/global_motion.py``).

Optimizes a motion model's parameter vector directly: the 2-DoF
translation, the 4-DoF similarity (translation, rotation and zoom about
the image center) or the calibrated 3-DoF camera rotation ("3-rotation",
the classic CMax rotation problem), through the same fused objective as
the tile solvers: the kernels take the model's analytic dense field
(``ObjectiveSpec.motion_model``), so an evaluation runs K1 and K2, the
analytic HVP K3 and K4, the metrics K8.  Its users estimate ego-motion on
sequences dominated by the camera's (ECD slider and rotation sequences).

Config surface: ``solver.method: global_contrast_maximization`` with
``solver.motion_model`` 2d-translation / rigid-optical-flow /
4-param-similarity / 3-rotation; ``optimizer.parameters`` boxes keyed by
the model's parameter names drive the random init and the init sweep;
"3-rotation" reads the camera's ``K`` from the calibration (a generic
pinhole without one).  The cost has no total variation (no tile grid).

The solve works in pixel-equivalent units (``_param_scale``: one unit of
rot / zoom moves a pixel at radius R by R px/s, one unit of rot_x / rot_y
a pixel by ~f px/s), converted at the boundary.  The frame starts from
the previous frame's parameters (warm), else from the configured init
refined by the per-axis sweep of ``optimizer.n_iter`` candidates, then
one Newton-CG solve (gtol 1e-7), the finest-scale routing of
``optimizer.hvp_mode``.  Under ``optimizer.chain`` (the default) the
solve's evaluations replay from CUDA graphs (a ``graphs.Stage`` of its
own, keyed by the spec: a 3- or 4-vector never meets a tile solver's
graphs); ``chain: false`` runs them eagerly with the same bits.

Any other ``optimizer.method`` but the sampling optimizer (which the JAX
package's global solver has no branch for) solves the same scaled problem
from the host (a scipy method at gtol 1e-7 or a first-order rule:
``patch_base._run_host_optimizer``), eagerly.  As in the JAX package, the
history register is plotted after every frame and never cleared.
"""

import dataclasses
import logging

import numpy as np
import torch

from ..ops.warp import calib_tuple
from ..utils.config_schema import ConfigError
from ..utils.tracing import read, span, synced
from .base import SolverBase
from .graphs import ChainGraphs
from .objective import FrameEvents, ObjectiveSpec, build_objective, build_orig_iwe
from .patch_base import PatchContrastMaximization

logger = logging.getLogger(__name__)

# the random init's and the sweep's half-ranges per parameter where
# optimizer.parameters has no box for it
_DEFAULT_BOX = {
    "trans_x": 50.0, "trans_y": 50.0, "rot": 1.0, "zoom": 1.0,
    "rot_x": 0.5, "rot_y": 0.5, "rot_z": 1.0,
}


class GlobalMotionContrastMaximization(PatchContrastMaximization):
    def __init__(self, image_shape: tuple, calibration_parameter: dict, solver_config: dict = {},
                 optimizer_config: dict = {}, output_config: dict = {}, **kwargs):
        super().__init__(image_shape, calibration_parameter, solver_config, optimizer_config,
                         output_config, **kwargs)
        if self.is_time_aware:
            # the JAX package's metrics score a time-aware global solve on a
            # slice of the dense field, not of a voxel: no result to hold
            raise ConfigError("solver.method global_contrast_maximization with solver.time_aware is not ported")
        # the whole frame is one "patch"; the objective maps the parameters
        # to the model's field (ObjectiveSpec.motion_model)
        self.patches = {}
        self.n_patch = 1
        self.patch_image_size = (1, 1)
        self.patch_size = tuple(image_shape)
        self.sliding_window = tuple(image_shape)
        self.objective_motion_model = self.motion_model
        r_char = (image_shape[0] + image_shape[1]) / 4.0
        self._calib = calib_tuple(tuple(image_shape), self.calib_param)
        f_char = (self._calib[0] + self._calib[1]) / 2.0
        scale_of = {"trans_x": 1.0, "trans_y": 1.0, "rot_x": 1.0 / f_char, "rot_y": 1.0 / f_char}
        self._param_scale = np.array([scale_of.get(k, 1.0 / r_char) for k in self.motion_model_keys])
        if self.slv_config["cost"] == "hybrid" and "total_variation" in (self.slv_config.get("cost_with_weight")
                                                                          or {}):
            raise ValueError("global_contrast_maximization has no tile grid: drop total_variation from "
                             "solver.cost_with_weight")
        self.last_frame_stats: dict = {}
        self._graphs = None  # the chain's captured evaluations

    def _current_spec(self) -> ObjectiveSpec:
        return dataclasses.replace(super()._current_spec(), param_scale=tuple(float(s) for s in self._param_scale),
                                   calib=self._calib)

    # --- the model's field (metrics, save_flow) ------------------------------
    # the model's dense [2, H, W] field (px/s) of the parameters, not a
    # tile interpolation
    motion_to_dense_flow = SolverBase.motion_to_dense_flow

    def predicted_flow(self, motion, timescale: float) -> torch.Tensor:
        return self.motion_to_dense_flow(np.asarray(motion, dtype=np.float64) * timescale)

    # --- initialization -------------------------------------------------------
    def initialize_zeros(self) -> np.ndarray:
        return np.zeros(self.motion_vector_size, dtype=np.float64)

    def initialize_random(self) -> np.ndarray:
        """One uniform draw per parameter, in key order, from its box (the
        JAX package's draws)."""
        lo, hi = self._param_boxes()
        return np.array([self._rng.uniform(a, b) for a, b in zip(lo, hi)], dtype=np.float64)

    def _param_boxes(self):
        params = self.opt_config.get("parameters")
        lo, hi = [], []
        for key in self.motion_model_keys:
            if isinstance(params, dict) and key in params:
                lo.append(params[key]["min"])
                hi.append(params[key]["max"])
            else:
                half = _DEFAULT_BOX.get(key, 1.0)
                lo.append(-half)
                hi.append(half)
        return np.array(lo), np.array(hi)

    def _initial_motion(self, spec: ObjectiveSpec, frame: FrameEvents, orig) -> np.ndarray:
        """The frame's start in the model's units: the warm parameters, else
        the configured init, refined by the sweep when ``optimizer.n_iter``
        > 0."""
        if self.previous_frame_best_estimation is not None:
            return np.copy(np.asarray(self.previous_frame_best_estimation)).reshape(-1)
        init = (self.slv_config.get("patch") or {}).get("initialize", "zero")
        if init == "random":
            x0 = self.initialize_random()
        elif init == "zero":
            x0 = self.initialize_zeros()
        else:
            raise ConfigError(f"global motion initialization {init!r} is not implemented (zero/random)")
        n_cand = int(self.opt_config.get("n_iter", 0))
        if n_cand > 0:
            x0 = self._sampling_init(spec, frame, orig, x0, n_cand)
        return x0

    def _sampling_init(self, spec: ObjectiveSpec, frame: FrameEvents, orig, x0: np.ndarray,
                       n_cand: int) -> np.ndarray:
        """The per-axis sweep before Newton: x0, then ``max(4, n_cand // P)``
        evenly spaced values of each parameter over its box with the others
        at x0 (CMax is multi-modal; a joint random search over the box
        needs exponentially many samples).  Every candidate is scored by
        the objective, one eager evaluation each (K1 on the card), and the
        best is read back once.  A loop rather than one frame-table batch
        of the candidates: the sweep runs once per cold frame, and a batch
        would copy the frame's events once per candidate."""
        lo, hi = self._param_boxes()
        per_axis = max(4, n_cand // self.motion_vector_size)
        cands = [np.asarray(x0, dtype=np.float64)[None]]
        for k in range(self.motion_vector_size):
            sweep = np.tile(np.asarray(x0, dtype=np.float64)[None], (per_axis, 1))
            sweep[:, k] = np.linspace(lo[k], hi[k], per_axis)
            cands.append(sweep)
        cands = np.concatenate(cands, axis=0)
        obj = build_objective(spec)
        with torch.no_grad():
            xs = self.tensor(cands / self._param_scale[None, :])  # the objective's scaled units
            losses = torch.stack([obj(x, orig, frame)[0] for x in xs])
            best = int(read(torch.argmin(losses), "sweep"))
        return cands[best]

    # --- main -----------------------------------------------------------------
    def optimize(self, events: np.ndarray) -> np.ndarray:
        """Solve one frame: the model's parameters, a float64 ``[P]`` host
        array."""
        from .. import ops

        # the JAX package's global solver has no sampling branch either
        self._check_optimizer(sampling=False)
        logger.info(f"Start global-motion optimization ({self.motion_model}, DoF {self.motion_vector_size})")
        events = np.asarray(events, dtype=np.float64)
        spec = self._current_spec()
        before = ops.launch_counts()
        mark = synced()
        with span("solver.prep"):
            frame = self.frame_events(events)
            orig = build_orig_iwe(spec)(frame)
        warm = self.previous_frame_best_estimation is not None
        # the solve works in scaled (pixel-equivalent) units
        motion0 = self._initial_motion(spec, frame, orig) / self._param_scale
        chain = bool(self.opt_config.get("chain", True)) and self._device_newton()
        if self._device_newton():
            stage = None
            if chain:
                if self._graphs is None:
                    self._graphs = ChainGraphs(self.device)
                stage = self._graphs.stage("global", frame, orig)
                frame, orig = stage.frame, stage.orig
            best_x, best_f, n_iter, hvp = self._run_newton(spec, self.tensor(motion0), frame, orig,
                                                           int(self.opt_config.get("max_iter", 25)), finest=True,
                                                           warm=warm, gtol=1e-7, stage=stage)
            loss = float(read(best_f, "scale_loss"))
            self._history_cb(loss)
        else:
            best_x, loss, n_iter, hvp = self._run_host_optimizer(spec, motion0, frame, orig, gtol=1e-7,
                                                                 sampling=False)
        after = ops.launch_counts()
        best_motion = read(best_x, "solution").to(torch.float64).numpy().reshape(-1) * self._param_scale
        self.last_frame_stats = {
            "iters": {0: n_iter}, "loss": {0: loss}, "hvp": {0: hvp}, "events": {0: len(events)},
            "launches": {0: {k: after[k] - before[k] for k in after}}, "chain": chain, "syncs": synced() - mark,
            "params": dict(zip(self.motion_model_keys, best_motion.tolist())),
        }
        self._plot_history()
        logger.info(f"Global solve{' (chained)' if chain else ''}: {n_iter} iters ({hvp} HVP), loss {loss:.6f}; "
                    f"best {dict(zip(self.motion_model_keys, np.round(best_motion, 4)))}")
        return best_motion
