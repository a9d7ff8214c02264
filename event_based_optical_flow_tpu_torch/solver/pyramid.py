"""Pyramidal (coarse-to-fine) tile CMax — the eval protocol's solver (port
of ``event_based_optical_flow_tpu/solver/pyramid.py``: the per-scale loop
``optimize``, ``_presearch_motion``, ``_init_scale``, warm-start averaging,
``update_coarse_from_fine`` and the metrics of ``calculate_flow_error``).

Scales s = 1..patch.scale-1 over a center crop, per-scale non-overlapping
tile grids (size crop/2^s).  The coarsest scale starts from the warm
motion or the cold init (``solver.patch.initialize``: ``random``,
``zero``, the per-patch sampling sweep ``optuna-sampling``, or the best
shared translation of a 10 x 10 (``grid-best``) or 30 x 30
(``global-best``) grid swept through the scale's objective); every
finer scale starts from the expanded coarser solution (averaged with the
previous frame's when warm), refined per patch by the sampling sweep;
each scale is then solved by Newton-CG (L-BFGS with
``optimizer.device_solver: lbfgs``).
A fine-to-coarse pyramid_reduce feedback produces the per-scale result.
With ``solver.time_aware`` every scale's objective votes through the flow
voxel propagated from its tile motion (K5), and the metrics score the
voxel's t0 slice.
With ``optimizer.coarse_event_fraction`` below 1, every scale but the
finest solves its Newton problem on a stride subsample of the events (its
own ``FrameEvents`` and its own orig IWE); the init sweep and the finest
scale see every event.

With ``optimizer.chain`` (on by default, as in the JAX package) the frame
runs chained (``_optimize_chain``, the port's counterpart of the JAX
package's one-dispatch ``_optimize_chain``): the same loop, every Newton
evaluation replayed from the solver's CUDA graphs (``solver/graphs.py``),
with the loop's bits; ``optimizer.chain: false`` runs the loop with eager
evaluations.

``optimizer.warm_finest_only`` (the chain only, as in the JAX package): a
warm frame skips the coarse scales and their init sweeps and runs one
finest-scale Newton solve from the warm finest motion
(``_optimize_warm_finest``); the coarse entries of its result are the
finest's ``pyramid_reduce``.  ``optimizer.warm_full_every: K`` runs the
full pyramid on every K-th consecutive warm frame (the warm streak,
``_warm_finest_active``) to re-anchor the basin.  A deviation from the
original method, which runs every scale; off by default.

With a ``parallel:`` mesh whose event axis is > 1 (``n_event_shards``),
the device Newton (or L-BFGS) solves every scale on the frame's events
sharded over the mesh's first row (``objective.ShardedFrame``, cut once
per event set): on the card the single-device solve's bits.  Such a frame
runs the loop (``chain`` off: a CUDA graph per device is not captured
across distinct cards); the warm finest-only path runs it too.  The init
sweeps and the metrics stay on the lead device, and the unfused route and
the host optimizers run on one device, with the JAX package's warning.

Any other ``optimizer.method`` (scipy's, with ``optimizer.device: false``
its Newton-CG too, a first-order rule or the sampling optimizer) runs the
loop: every scale's start as above, then that optimizer on the scale's
objective over every event (``patch_base._run_host_optimizer``).  Each
route records the history register (a device Newton solve: its best loss
per scale, the value the loop reads anyway; scipy: every evaluation; the
sampling optimizer: every round), which the visualizer plots at the end of
the frame.
"""

import logging
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.interp import pyramid_expand, pyramid_reduce
from ..utils.tracing import read, span, synced
from . import objective
from .graphs import ChainGraphs
from .objective import FrameEvents, build_orig_iwe
from .patch_base import PatchContrastMaximization, prepare_patch

logger = logging.getLogger(__name__)

# below this many events a stride subsample is not statistically
# meaningful for a coarse-scale solve
COARSE_SUBSAMPLE_MIN_EVENTS = 512


def coarse_subsample(events_np: np.ndarray, frac: float):
    """Stride-k subsample (k = round(1/frac)) of a time-sorted event array
    for the coarse pyramid scales, keeping temporal and spatial coverage;
    None when ``frac`` >= 1 or the subsample would hold fewer than
    ``COARSE_SUBSAMPLE_MIN_EVENTS`` events."""
    if frac >= 1.0:
        return None
    k = max(1, int(round(1.0 / max(frac, 1e-3))))
    sub = np.ascontiguousarray(np.asarray(events_np)[::k])
    if len(sub) < COARSE_SUBSAMPLE_MIN_EVENTS:
        return None
    return sub


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
        self._graphs: Optional[ChainGraphs] = None  # the chain's captured evaluations
        # the warm finest-only cadence: consecutive warm frames, and whether
        # the last frame or batch took the fast path
        self._warm_streak = 0
        self._wfo_last = False

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
        device (the finest scale is the output flow's tile motion);
        chained when ``_chain_ready``."""
        logger.info(f"Start optimization. DoF {self.motion_vector_size * self.total_n_patch}")
        self._check_optimizer()
        if self._chain_ready():
            return self._optimize_chain(events)
        if self.opt_config.get("warm_finest_only") and not getattr(self, "_warned_wfo", False):
            logger.warning("optimizer.warm_finest_only requires the device chain path (optimizer.chain with device "
                           "Newton-CG, >=2 scales); the per-scale loop runs the full pyramid")
            self._warned_wfo = True
        return self._optimize_scales(events, chain=False)

    def _chain_ready(self) -> bool:
        """Whether the frame runs chained (the JAX package's gate,
        ``pyramid.py::_chain_ready``): the device Newton-CG,
        ``optimizer.chain`` (default on), at least two scales."""
        return (self.opt_config.get("method") == "Newton-CG" and bool(self.opt_config.get("device", True))
                and bool(self.opt_config.get("chain", True)) and self.patch_scales - self.coarsest_scale >= 2)

    def _optimize_chain(self, events: np.ndarray) -> Dict[int, torch.Tensor]:
        """The per-scale loop with every Newton evaluation replayed from
        the solver's CUDA graphs: the frame's event sets are staged into
        their captured buffers, and the init sweeps stay eager (one call
        per scale, with their draws).  The JAX chain's contract is the
        loop's result ("same kernels, same key order"); here it is the
        loop's bits.  An event-sharded solve runs the loop (its bits)."""
        sharded = self._shards_events()
        if self._graphs is None and not sharded:
            self._graphs = ChainGraphs(self.device)
        warm = self.previous_frame_best_estimation
        # a dict only: a per-frame warm list here is a fleet's state
        if self._warm_finest_active(isinstance(warm, dict) and self._warm_has_finest(warm, self.patch_scales - 1)):
            return self._optimize_warm_finest(events)
        return self._optimize_scales(events, chain=not sharded)

    @staticmethod
    def _warm_has_finest(warm, s_fin: int) -> bool:
        """The warmth predicate of the ``warm_finest_only`` gate, shared by
        the sequential chain and the fleet chain so a stream's streak
        cadence is the same on both: a per-scale dict holding ``s_fin``, or
        a non-empty list of such dicts."""
        if isinstance(warm, (list, tuple)):
            return len(warm) > 0 and all(isinstance(w, dict) and s_fin in w for w in warm)
        return isinstance(warm, dict) and s_fin in warm

    def _warm_finest_active(self, use_warm: bool) -> bool:
        """Whether this frame or batch takes the warm finest-only fast path,
        decided once per solve: a cold solve resets the warm streak;
        ``warm_full_every: K`` (K > 0) sends every K-th consecutive warm
        solve through the full pyramid (K = 1 disables the fast path).
        Recorded in ``_wfo_last``."""
        self._wfo_last = False
        if not use_warm:
            self._warm_streak = 0
            return False
        if not bool(self.opt_config.get("warm_finest_only", False)):
            return False
        self._warm_streak += 1
        every = int(self.opt_config.get("warm_full_every", 0))
        self._wfo_last = not (every > 0 and self._warm_streak % every == 0)
        return self._wfo_last

    def _optimize_warm_finest(self, events: np.ndarray) -> Dict[int, torch.Tensor]:
        """The warm finest-only fast path (the JAX package's
        ``_optimize_warm_finest``): one finest-scale Newton solve on every
        event from the warm finest motion, its evaluations from the staged
        CUDA graphs; no coarse scale, no init sweep.  ``last_frame_stats``
        holds the finest scale only."""
        from .. import ops

        events = np.asarray(events, dtype=np.float64)
        s_fin = self.patch_scales - 1
        self.overload_patch_configuration(s_fin)
        spec = self._current_spec()
        with span("solver.prep"):
            full = self._newton_frame(self.frame_events(events), self._shards_events())
            if isinstance(full, objective.ShardedFrame):
                stage, frame, orig = None, full, build_orig_iwe(spec)(full)
            else:
                stage = self._graphs.stage("full", full, build_orig_iwe(spec)(full))
                frame, orig = stage.frame, stage.orig
        mark = synced()
        before = ops.launch_counts()
        scale_mi, scale_cg = self._scale_budget(s_fin)
        with span("solver.scale", scale=s_fin):
            best_x, best_f, n_iter, hvp = self._run_newton(spec, self.previous_frame_best_estimation[s_fin],
                                                           frame, orig, scale_mi, scale_cg, finest=True,
                                                           warm=True, stage=stage)
            loss = float(read(best_f, "scale_loss"))
        self._history_cb(loss)
        after = ops.launch_counts()
        self.last_frame_stats = {
            "iters": {s_fin: n_iter}, "loss": {s_fin: loss}, "hvp": {s_fin: hvp}, "events": {s_fin: len(events)},
            "launches": {s_fin: {k: after[k] - before[k] for k in after}}, "chain": stage is not None,
            "warm_finest": True,
            "syncs": synced() - mark,
        }
        logger.info(f"Warm finest-only solve: {n_iter} iters, loss {loss:.6f}")
        refined = self.update_coarse_from_fine({s_fin: best_x.reshape((self.motion_vector_size,)
                                                                       + tuple(self.patch_image_size))})
        self._plot_history()
        self.cost_func.clear_history()
        return refined

    def _optimize_scales(self, events: np.ndarray, chain: bool) -> Dict[int, torch.Tensor]:
        """The coarse-to-fine loop; ``chain``: the evaluations from the
        staged CUDA graphs (``_optimize_chain``)."""
        from .. import ops

        events = np.asarray(events, dtype=np.float64)
        self.overload_patch_configuration(self.coarsest_scale)
        orig_fn = build_orig_iwe(self._current_spec())
        device_newton = self._device_newton()
        sharded = device_newton and self._shards_events()
        if self.mesh is not None and self.n_event_shards > 1 and not device_newton \
                and not getattr(self, "_warned_mesh_host", False):
            logger.warning(f"a 'parallel' mesh is configured but optimizer.method {self.opt_config['method']!r} "
                           "solves from the host; the solve runs single-device")
            self._warned_mesh_host = True
        # (FrameEvents, orig IWE) of the full frame and of the coarse scales'
        # subsample: the orig IWE depends on the events only; the device
        # Newton's frames cut over the mesh's row when sharded (the init
        # sweeps take the unsharded full frame)
        with span("solver.prep"):
            full = self.frame_events(events)
            full_newton = self._newton_frame(full, sharded)
            newton_events = {"full": (full_newton, orig_fn(full_newton))}
            init_events = (full, newton_events["full"][1])
            sub = coarse_subsample(events, float(self.opt_config.get("coarse_event_fraction", 1.0)))
            if sub is not None:
                coarse = self._newton_frame(self.frame_events(sub), sharded)
                newton_events["coarse"] = (coarse, orig_fn(coarse))
            stages = {}
            if chain:
                stages = {name: self._graphs.stage(name, *fo) for name, fo in newton_events.items()}
                newton_events = {name: (st.frame, st.orig) for name, st in stages.items()}
        warm_motion = self.previous_frame_best_estimation
        warm = warm_motion is not None
        mark = synced()
        self.cost_func.enable_history_register()
        stats = {"iters": {}, "loss": {}, "hvp": {}, "events": {}, "launches": {}, "chain": chain}
        best_motion_per_scale: Dict[int, torch.Tensor] = {}
        for s in range(self.coarsest_scale, self.patch_scales):
            self.overload_patch_configuration(s)
            spec = self._current_spec()
            finest = s == self.patch_scales - 1
            # the device Newton solves the coarse scales on the subsample;
            # every other optimizer sees every event
            events_key = "full" if finest or sub is None or not device_newton else "coarse"
            frame, orig = newton_events[events_key]
            before = ops.launch_counts()
            with span("solver.scale", scale=s):
                with span("solver.init"):
                    presearch = self._presearch_motion(s, best_motion_per_scale, warm_motion)
                    if presearch is None:
                        x0 = self._init_scale(s, warm_motion, events, *init_events)
                    else:
                        motion0, n_cand = presearch
                        x0 = self.initialize_guess_from_patch_search(events, motion0, n_cand)
                if device_newton:
                    scale_mi, scale_cg = self._scale_budget(s)
                    best_x, best_f, n_iter, hvp = self._run_newton(spec, x0, frame, orig, scale_mi, scale_cg,
                                                                   finest=finest, warm=warm,
                                                                   stage=stages.get(events_key))
                    loss = float(read(best_f, "scale_loss"))
                    self._history_cb(loss)
                else:
                    best_x, loss, n_iter, hvp = self._run_host_optimizer(spec, x0, frame, orig, gtol=1e-5)
            best_motion_per_scale[s] = best_x.reshape((self.motion_vector_size,) + tuple(self.patch_image_size))
            after = ops.launch_counts()
            stats["iters"][s], stats["loss"][s], stats["hvp"][s] = n_iter, loss, hvp
            stats["events"][s] = frame.n_events
            stats["launches"][s] = {k: after[k] - before[k] for k in after}
            if chain:
                logger.info(f"Scale {s} done (chained): {n_iter} iters, loss {loss:.6f}")
            else:
                logger.info(f"Scale {s} done: {n_iter} iters ({hvp} HVP, {frame.n_events} events), "
                            f"loss {loss:.6f}")
        stats["syncs"] = synced() - mark
        self.last_frame_stats = stats
        refined = self.update_coarse_from_fine(best_motion_per_scale)
        self._plot_history()
        self.cost_func.clear_history()
        return refined

    def _presearch_motion(self, s: int, coarser: Dict[int, torch.Tensor], warm: Optional[Dict[int, torch.Tensor]]):
        """For scales that refine a coarser result by the per-patch sweep:
        (pre-sweep motion0 [2, n_patch], n_cand), the expanded coarser motion
        averaged with the ``warm`` one when warm; None for the coarsest."""
        if s <= self.coarsest_scale:
            return None
        expect = self.scaled_patch_image_size[s]
        motion0 = pyramid_expand(coarser[s - 1]).reshape((2,) + tuple(expect))
        if warm is not None:
            motion0 = (motion0 + warm[s]) / 2.0
        n_cand = max(4, int(self.opt_config["n_iter"] / max(1, s - self.coarsest_scale)))
        return motion0.reshape(2, -1), n_cand

    def _init_scale(self, s: int, warm: Optional[Dict[int, torch.Tensor]], events_np=None, frame=None,
                    orig=None) -> torch.Tensor:
        """Coarsest-scale start: the ``warm`` motion, else the configured
        cold init (``initialize_from_init``: the sweeps see every event of
        the frame, ``events_np`` and its ``frame`` / ``orig``)."""
        if warm is not None:
            return warm[s].clone()
        return self.initialize_from_init(self.slv_config["patch"]["initialize"], events_np, frame, orig)

    def update_coarse_from_fine(self, motion_per_scale: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
        """Fine-to-coarse feedback via pyramid_reduce: every scale's entry
        from the finest one (the warm finest-only path gives only that)."""
        finest = max(motion_per_scale.keys())
        refined = {finest: motion_per_scale[finest]}
        for i in range(finest, self.coarsest_scale, -1):
            refined[i - 1] = pyramid_reduce(refined[i])
        return refined

    # --------------------------------------------------------------- metrics
    def motion_to_dense_flow(self, pyramidal_motion, t_scale: float = 1.0) -> torch.Tensor:
        """Finest-scale tiles -> dense flow [2, H, W] (pix/s), or for a
        time-aware solver the voxel [T, 2, H, W] of a window of ``t_scale``
        seconds, divided by ``t_scale``."""
        finest = pyramidal_motion[self.current_scale] if isinstance(pyramidal_motion, dict) else pyramidal_motion
        return objective.motion_to_dense_flow(self._current_spec(), torch.as_tensor(finest).reshape(-1),
                                              t_scale)

    def predicted_flow(self, motion, timescale: float) -> torch.Tensor:
        """The JAX pyramid's timescale form (its ``calculate_fwl_pred``):
        the window's voxel, not the per-second one scaled."""
        return self.motion_to_dense_flow(motion, timescale) * timescale

    # --------------------------------------------------------- visualization
    def visualize_one_batch_warp(self, events, warp=None):
        """The base's images, and the flow's colorization over the warped
        IWE."""
        if self.visualizer is None or warp is None:
            return super().visualize_one_batch_warp(events, warp)
        flow, model, shown = self._viz_warp(events, warp)
        clipped, warped = self._warped_viz_iwe(events, flow, model, return_warped=True)
        shown = read(shown, "viz").numpy()
        self.visualizer.visualize_image(clipped)
        self.visualizer.visualize_optical_flow_on_event_mask(shown, warped)
        self.visualizer.visualize_overlay_optical_flow_on_event(shown, clipped)

    def visualize_pred_sequential(self, events, warp):
        """The events warped to the window's middle by the solution's dense
        flow (voxel) over the window (``pred_warp``), and the flow on the
        warped events' mask (``pred_masked``)."""
        if self.visualizer is None:
            return
        t_scale = self._t_range(events)
        with torch.no_grad():
            flow = self.motion_to_dense_flow(warp, t_scale) * t_scale
            shown = self.get_original_flow_from_time_aware_flow_voxel(flow) if self.is_time_aware else flow
        clipped, warped = self._warped_viz_iwe(events, flow, "dense-flow-voxel" if self.is_time_aware
                                               else "dense-flow", direction="middle", return_warped=True)
        self.visualizer.visualize_image(clipped, file_prefix="pred_warp")
        self.visualizer.visualize_optical_flow_on_event_mask(read(shown, "viz").numpy(), warped,
                                                             file_prefix="pred_masked")
