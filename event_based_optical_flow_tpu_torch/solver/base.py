"""Solver base: config plumbing, device/dtype policy, warm start (port of
``event_based_optical_flow_tpu/solver/base.py``).

Every solver object holds an explicit ``device`` (``cuda`` unless the
caller asks for the CPU) and ``dtype``: ``solver.precision`` ("32"/"64")
picks the dtype when set, otherwise float64 on the CPU (parity with the JAX
package) and float32 on CUDA.  Randomness is explicit too: a seeded numpy
``Generator`` for the cold init (the JAX package's ``initialize_random``
draws, reproduced exactly) and a ``torch.Generator`` on the solver's device
for the init sweep; ``rng_state`` / ``set_rng_state`` snapshot and restore
both.

The base also holds what every solver shares around the solve: the cost
registry's history register (``cost_func``, ``_history_cb``: the loss
values the solve's loop already read, plotted by the visualizer per
frame), the visualization of a frame (``visualize_*``: IWEs through K8 on
the card, flows colorized on the host, written by the ``Visualizer``
passed as ``visualize_module``) and ``profiled_optimize``, a
``torch.profiler`` trace of the solve into ``output.trace_dir``.

``solver.outer_padding`` p (``padding``) grows every image the solver
votes by p pixels a side, as the JAX package's ``EventImageConverter``
does: the metrics' orig and FWL images are the padded bilinear images
(their variances taken over the padded image), the event mask is the
padded one cropped back to the sensor, and the visualizations vote by
``iwe.method`` (``iwe_method``) and are cropped back (a polarity IWE is
drawn as the sum of its two channels).
"""

import logging
import os
from typing import Callable, Optional

import numpy as np
import torch

from .. import costs as costs_mod
from ..costs import functional as F
from ..flow import voxel
from ..flow.metrics import calculate_flow_error
from ..ops.iwe import create_iwe, event_mask
from ..ops.warp import Warp, calculate_reftime, warp_dense_flow, warp_voxel_flow
from ..state import from_jax
from ..utils import check_key_and_bool
from ..visualizer import clip_iwe

logger = logging.getLogger(__name__)


def resolve_dtype(precision, device: torch.device) -> torch.dtype:
    if precision is None:
        return torch.float64 if device.type == "cpu" else torch.float32
    return torch.float64 if str(precision) == "64" else torch.float32


class SolverBase:
    """Params:
        image_shape (tuple) ... (H, W)
        calibration_parameter (dict) ... the loader's calibration; the
            "3-rotation" motion model reads its ``K`` (``ops/warp.py``).
        solver_config / optimizer_config / output_config (dict) ... the JAX
            package's YAML schema (``output.trace_dir``: ``profiled_optimize``).
        visualize_module ... a ``Visualizer`` (the ``visualize_*`` methods
            and the history plot write through it), or None.
        device, dtype ... where and in what type the solve runs (dtype
            None: see resolve_dtype).
        candidates_fn ... optional init-sweep draw hook (solver/sampling.py).
        mesh ... a prebuilt ``parallel.Mesh`` (``_setup_parallel``); it
            replaces the one ``solver.parallel`` would build.
    """

    def __init__(
        self,
        image_shape: tuple,
        calibration_parameter: dict = {},
        solver_config: dict = {},
        optimizer_config: dict = {},
        output_config: dict = {},
        visualize_module=None,
        device="cuda",
        dtype: Optional[torch.dtype] = None,
        candidates_fn: Optional[Callable] = None,
        mesh=None,
    ):
        self.image_shape = tuple(image_shape)
        self.calib_param = calibration_parameter
        self.opt_config = optimizer_config
        self.slv_config = solver_config
        self.out_config = output_config
        self.visualizer = visualize_module
        self.iwe_config = solver_config["iwe"]
        self.iwe_method = self.iwe_config.get("method", "bilinear_vote")
        self.padding = int(solver_config.get("outer_padding", 0))
        self.iwe_visualize_max_scale = solver_config.get("max_scale", 50)
        self.normalize_t_in_batch = True
        self.device = torch.device(device)
        self.dtype = dtype or resolve_dtype(solver_config.get("precision"), self.device)
        self.previous_frame_best_estimation = None
        self.warper = Warp(self.image_shape, normalize_t=True, calib_param=self.calib_param)
        # a tile solver's model is its tiles' (2d-translation); a global
        # solver optimizes the model's own parameters
        self.motion_model = solver_config.get("motion_model", "2d-translation")
        self.motion_model_keys = self.warper.get_key_names(self.motion_model)
        self.motion_vector_size = self.warper.get_motion_vector_size(self.motion_model)
        self.seed = int(solver_config.get("seed", 0))
        self._rng = np.random.default_rng(self.seed)
        self.generator = torch.Generator(device=self.device).manual_seed(self.seed)
        self.candidates_fn = candidates_fn
        self._setup_parallel(solver_config.get("parallel") or {}, mesh)
        self.setup_cost_func()
        self.setup_time_aware()
        logger.info(
            f"Solver config: {solver_config}; optimizer: {optimizer_config}; "
            f"device {self.device}, dtype {self.dtype}"
        )

    def _setup_parallel(self, parallel_config: dict, mesh=None):
        """The ("data", "event") device mesh of the ``parallel:`` block (the
        JAX package's rules): ``event: M`` shards each frame's events over M
        devices inside the fused objective (partial votes reduced on the
        lead device, ``solver/objective.py``); ``data: N`` is the fleet's
        frame axis.  No block, or 1x1, leaves the solver on one device with
        no mesh.  On CUDA the mesh takes the visible devices (a block that
        asks for more raises); on the CPU it repeats the CPU device, as the
        JAX tests' virtual devices do.  ``mesh``, a prebuilt mesh (one that
        repeats a device, say), replaces the block's."""
        from ..parallel.sharded import make_mesh

        self.parallel_config = parallel_config
        self.mesh = None
        self.n_event_shards = 1
        if mesh is not None:
            if mesh.size > 1:
                self.mesh = mesh
                self.n_event_shards = mesh.shape["event"]
                logger.info(f"Parallel mesh: data={mesh.shape['data']}, event={mesh.shape['event']} over "
                            f"{list(mesh.devices.reshape(-1))} (given)")
            return
        if not parallel_config:
            return
        data = int(parallel_config.get("data", 1))
        event = int(parallel_config.get("event", 1))
        if data * event <= 1:
            return
        if self.device.type == "cuda":
            n_avail = torch.cuda.device_count()
            if data * event > n_avail:
                raise ValueError(f"config 'parallel' asks for data={data} x event={event} = {data * event} "
                                 f"devices but only {n_avail} are visible")
            devices = [torch.device("cuda", i) for i in range(n_avail)]
        else:
            devices = [self.device] * (data * event)
        self.mesh = make_mesh(data * event, data=data, event=event, devices=devices)
        self.n_event_shards = event
        logger.info(f"Parallel mesh: data={data}, event={event} over {data * event} devices")

    def setup_cost_func(self):
        """The configured cost as a history register (the objective builds
        its own cost objects per spec)."""
        if self.slv_config["cost"] == "hybrid":
            self.cost_weight = self.slv_config["cost_with_weight"]
            self.cost_func = costs_mod.HybridCost(direction="minimize", cost_with_weight=self.cost_weight,
                                                  store_history=True)
        else:
            self.cost_weight = None
            self.cost_func = costs_mod.functions[self.slv_config["cost"]](direction="minimize", store_history=True)

    def _history_cb(self, loss: float, components: Optional[dict] = None) -> None:
        """Record a host value the solve already read (and a hybrid's
        component values) in the history register."""
        if not self.cost_func.store_history:
            return
        self.cost_func.history["loss"].append(float(loss))
        if components and isinstance(self.cost_func, costs_mod.HybridCost):
            for name, val in components.items():
                if name in self.cost_func.cost_func:
                    self.cost_func.cost_func[name]["func"].history["loss"].append(float(val))

    def _plot_history(self) -> None:
        """The history plot of what the register holds, if any."""
        if self.visualizer is not None and self.cost_func.get_history()["loss"]:
            self.visualizer.visualize_scipy_history(self.cost_func.get_history(), self.cost_weight)

    def setup_time_aware(self):
        """``solver.time_aware``: the flow is a ``[time_bin, 2, H, W]``
        voxel propagated from t0 by ``flow_interpolation``.  For a dense
        flow ``time_bin``, ``flow_interpolation`` and ``t0_flow_location``
        are None and ``scale_later`` is False."""
        ta = self.is_time_aware = check_key_and_bool(self.slv_config, "time_aware")
        self.time_bin = int(self.slv_config.get("time_bin", 10)) if ta else None
        self.flow_interpolation = self.slv_config["flow_interpolation"] if ta else None
        self.t0_flow_location = self.slv_config["t0_flow_location"] if ta else None
        self.scale_later = ta and check_key_and_bool(self.slv_config, "scale_later")

    def get_original_flow_from_time_aware_flow_voxel(self, flow_voxel: torch.Tensor) -> torch.Tensor:
        """``[(b,) T, 2, H, W]`` -> the t0 slice ``[(b,) 2, H, W]``."""
        return flow_voxel[..., voxel.t0_index(flow_voxel.shape[-4], self.t0_flow_location), :, :, :]

    def tensor(self, a) -> torch.Tensor:
        """Host array (or a tensor) -> the solver's device and dtype."""
        if torch.is_tensor(a):
            return a.to(self.device, self.dtype)
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=self.device).to(self.dtype)

    # --- warm start and randomness ------------------------------------------
    def _motion_dict(self, motion: dict) -> dict:
        return {
            int(k): (v.detach().to(self.device, self.dtype).clone() if torch.is_tensor(v)
                     else from_jax({k: v}, self.device, self.dtype)[int(k)])
            for k, v in motion.items()
        }

    def set_previous_frame_best_estimation(self, previous_best):
        """Warm start from a per-scale motion dict (port tensors, or the
        JAX layout's numpy arrays, as a loaded state file holds them), from
        a list of such dicts, one per frame of a fleet batch (None: a frame
        without warm state), or from one motion array (a single-scale
        solver's, e.g. the global solver's parameters), kept as a float64
        host array as the JAX package keeps it."""
        if isinstance(previous_best, dict):
            self.previous_frame_best_estimation = self._motion_dict(previous_best)
        elif isinstance(previous_best, (list, tuple)) and all(d is None or isinstance(d, dict)
                                                             for d in previous_best):
            self.previous_frame_best_estimation = [
                None if d is None else self._motion_dict(d) for d in previous_best
            ]
        else:
            motion = previous_best.detach().cpu() if torch.is_tensor(previous_best) else previous_best
            self.previous_frame_best_estimation = np.array(motion, dtype=np.float64)

    def rng_state(self):
        """A snapshot of the solver's randomness: the init sweep's
        ``torch.Generator`` and the cold init's numpy generator."""
        return self.generator.get_state(), self._rng.bit_generator.state

    def set_rng_state(self, snapshot) -> None:
        torch_state, numpy_state = snapshot
        self.generator.set_state(torch_state)
        self._rng.bit_generator.state = numpy_state

    def save_flow_error_as_text(self, out_dir: str, nth_frame: int, flow_error_dict: dict,
                                fname: str = "flow_error_per_frame.txt"):
        with open(os.path.join(out_dir, fname), "a") as f:
            f.write(f"frame {nth_frame}::" + str(flow_error_dict) + "\n")

    # --- metrics -----------------------------------------------------------
    def predicted_flow(self, motion, timescale: float) -> torch.Tensor:
        """The solution as a displacement over ``timescale`` seconds:
        ``[2, H, W]``, or the time-aware voxel ``[T, 2, H, W]``."""
        raise NotImplementedError

    def _fwl(self, events: torch.Tensor, flow: torch.Tensor, orig_iwe: torch.Tensor) -> torch.Tensor:
        """Var(IWE_orig)/Var(IWE_warped) of a dense displacement (or a
        voxel of them); < 1 is better."""
        warp = warp_voxel_flow if flow.ndim == 4 else warp_dense_flow
        warped = warp(events, flow, calculate_reftime(events, "first"), self.image_shape, normalize_t=True)
        warped_iwe = create_iwe(warped, self.image_shape, sigma=1, blur_mode="scipy", padding=self.padding)
        return 1.0 / F.normalized_image_variance(warped_iwe, orig_iwe, omit_boundary=False, ddof=0)

    def _crop(self, image):
        """An image of the padded size cropped back to the sensor's."""
        p = self.padding
        return image[..., p:-p, p:-p] if p > 0 else image

    def calculate_flow_error(self, motion, gt_flow: np.ndarray, timescale: float, events: np.ndarray) -> dict:
        """AEE/NPE/AE with the event mask, plus GT_FWL and PRED_FWL, of the
        solution against the GT displacement ``gt_flow [H, W, 2]`` over a
        window of ``timescale`` seconds.  A time-aware solution is scored
        on its t0 slice (EPE) and warps through the whole voxel (PRED_FWL);
        GT_FWL stays dense."""
        with torch.no_grad():
            e = self.tensor(events)
            gt = self.tensor(np.transpose(np.asarray(gt_flow), (2, 0, 1)))
            pred = self.predicted_flow(motion, timescale)
            pred_t0 = self.get_original_flow_from_time_aware_flow_voxel(pred) if self.is_time_aware else pred
            orig_iwe = create_iwe(e, self.image_shape, sigma=1, blur_mode="scipy", padding=self.padding)
            mask = self._crop(event_mask(e, self.image_shape, padding=self.padding))[None]
            err = calculate_flow_error(gt[None], pred_t0[None], mask)
            err["GT_FWL"] = self._fwl(e, gt, orig_iwe)
            err["PRED_FWL"] = self._fwl(e, pred, orig_iwe)
            flow_error = {k: float(v) for k, v in err.items()}
        logger.info(f"flow_error = {flow_error} for time period {timescale} sec.")
        return flow_error

    def calculate_fwl_pred(self, motion, events: np.ndarray, timescale: float = 1.0) -> dict:
        """{"PRED_FWL": ...} of the solution over a window of ``timescale``
        seconds, the GT-free eval's metric (a time-aware solution warps
        through its whole voxel)."""
        with torch.no_grad():
            e = self.tensor(events)
            orig_iwe = create_iwe(e, self.image_shape, sigma=1, blur_mode="scipy", padding=self.padding)
            return {"PRED_FWL": float(self._fwl(e, self.predicted_flow(motion, timescale), orig_iwe))}

    def dense_displacement(self, motion, timescale: float) -> np.ndarray:
        """The solution as a ``[2, H, W]`` displacement over ``timescale``
        seconds on the host, the slice the metrics score (t0 of a
        time-aware voxel): what ``output.save_flow`` writes."""
        with torch.no_grad():
            flow = self.predicted_flow(motion, timescale)
            if self.is_time_aware:
                flow = self.get_original_flow_from_time_aware_flow_voxel(flow)
            return flow.double().cpu().numpy()

    # --- visualization ---------------------------------------------------------
    def _viz_iwe(self, events: torch.Tensor) -> np.ndarray:
        """The unblurred IWE of ``iwe.method`` a visualization draws,
        cropped back to the sensor (a polarity IWE's channels summed)."""
        iwe = create_iwe(events, self.image_shape, sigma=0, padding=self.padding, method=self.iwe_method)
        if self.iwe_method == "polarity":
            iwe = iwe.sum(-3)
        return self._crop(iwe).cpu().numpy()

    def create_clipped_iwe_for_visualization(self, events, max_scale=50) -> np.ndarray:
        """The events' unwarped, unblurred IWE, clipped to uint8."""
        with torch.no_grad():
            return clip_iwe(self._viz_iwe(self.tensor(events)), max_scale)

    def _warped_viz_iwe(self, events, motion, motion_model: str, direction="first", return_warped: bool = False):
        """The events warped by ``motion`` under ``motion_model`` to
        ``direction``, voted unblurred and clipped to uint8 (and the warped
        events on the device with ``return_warped``)."""
        with torch.no_grad():
            warped = self.warper.warp_event(self.tensor(events), self.tensor(motion), motion_model, direction)
            clipped = clip_iwe(self._viz_iwe(warped), self.iwe_visualize_max_scale)
        return (clipped, warped) if return_warped else clipped

    def _t_range(self, events) -> float:
        events = np.asarray(events)
        return float(np.max(events[:, 2]) - np.min(events[:, 2])) if self.normalize_t_in_batch else 1.0

    def _viz_warp(self, events, warp):
        """(the motion a visualization warps ``events`` with, its motion
        model, the dense flow the mask composite colorizes) of the solution
        ``warp`` (per second): the model's parameters times the window's
        span (the JAX package's ``visualize_*``)."""
        motion = self.tensor(np.asarray(warp, dtype=np.float64) * self._t_range(events))
        return motion, self.motion_model, self.motion_to_dense_flow(motion)

    def visualize_one_batch_warp(self, events, warp=None):
        """The events' IWE (``warp`` None), or their IWE warped by the
        solution and its flow on the warped events' mask."""
        if self.visualizer is None:
            return
        if warp is None:
            self.visualizer.visualize_image(self.create_clipped_iwe_for_visualization(
                events, self.iwe_visualize_max_scale))
            return
        motion, model, flow = self._viz_warp(events, warp)
        clipped, warped = self._warped_viz_iwe(events, motion, model, return_warped=True)
        self.visualizer.visualize_image(clipped)
        self.visualizer.visualize_optical_flow_on_event_mask(flow.cpu().numpy(), warped)

    def visualize_original_sequential(self, events):
        if self.visualizer is None:
            return
        clipped = self.create_clipped_iwe_for_visualization(events, self.iwe_visualize_max_scale)
        self.visualizer.visualize_image(clipped, file_prefix="original")

    def visualize_pred_sequential(self, events, warp):
        if self.visualizer is None:
            return
        motion, model, _ = self._viz_warp(events, warp)
        self.visualizer.visualize_image(self._warped_viz_iwe(events, motion, model), file_prefix="pred_warp")

    def visualize_gt_sequential(self, events, gt_warp, gt_type: str = "flow"):
        """The events warped by the GT (a ``[H, W, 2]`` displacement with
        ``gt_type`` "flow", else the model's parameters) and the GT flow's
        colorization."""
        if self.visualizer is None:
            return
        if gt_type == "flow":
            motion_model = "dense-flow"
            gt_warp = np.transpose(np.asarray(gt_warp), (2, 0, 1))
        else:
            motion_model = self.motion_model
        clipped = self._warped_viz_iwe(events, self.tensor(gt_warp), motion_model)
        self.visualizer.visualize_image(clipped, file_prefix="gt_warp")
        if motion_model == "dense-flow":
            self.visualizer.visualize_optical_flow(gt_warp[0], gt_warp[1], visualize_color_wheel=False,
                                                   file_prefix="gt_flow")

    def visualize_flows(self, motion, gt_flow, timescale: float = 1.0) -> None:
        """The prediction and the GT colorized on their shared scale."""
        if self.visualizer is None:
            return
        with torch.no_grad():
            pred = self.predicted_flow(motion, timescale)
            if self.is_time_aware:
                pred = self.get_original_flow_from_time_aware_flow_voxel(pred)
        self.visualizer.visualize_optical_flow_pred_and_gt(
            pred.cpu().numpy(), np.transpose(np.asarray(gt_flow), (2, 0, 1)),
            pred_file_prefix="flow_comparison_pred", gt_file_prefix="flow_comparison_gt")

    # --- the solve ---------------------------------------------------------------
    def profiled_optimize(self, events: np.ndarray):
        """``optimize``, inside a ``torch.profiler`` trace (host and, on the
        card, CUDA activity) written to ``output.trace_dir`` when the config
        sets it (a ``*.pt.trace.json`` per solve, TensorBoard's layout)."""
        trace_dir = (self.out_config or {}).get("trace_dir")
        if not trace_dir:
            return self.optimize(events)
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(trace_dir)):
            return self.optimize(events)

    def optimize(self, events: np.ndarray):
        raise NotImplementedError

    def optimize_with_metrics(self, events: np.ndarray, gt_flow: np.ndarray, timescale: float,
                              metric_events: np.ndarray):
        """The eval loop's solve and AEE/FWL metrics in one call (the JAX
        pyramid's ``optimize_with_metrics``): (solution, flow-error dict),
        the values of ``optimize`` then ``calculate_flow_error``.  JAX's
        fusable conditions (the chain, no outer padding, no host griddata
        voxel scheme, no trace) decide whether it appends the metrics to the
        chain's dispatch; the port captures no metrics (one evaluation per
        frame), so every solver solves (the pyramid chained when
        ``_chain_ready``; ``profiled_optimize``, as the JAX package's
        unfused route) and then scores."""
        best = self.profiled_optimize(events)
        return best, self.calculate_flow_error(best, gt_flow, timescale=timescale, events=metric_events)
