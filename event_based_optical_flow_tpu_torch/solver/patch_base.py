"""Patch (tile) based contrast maximization: shared machinery (port of
``event_based_optical_flow_tpu/solver/patch_base.py``): tile-grid
construction, cold init, the per-scale objective and Newton-CG solve, and
the per-patch init sweep.

Route (the JAX package's fused-kernel route, ``patch_base.py:287-456``):
the banded objective, with the HVP chosen per (warmth, scale) by
``optimizer.hvp_mode`` (``_want_analytic``): the central (or one-sided)
finite-difference HVP, or the analytic Gauss-Newton HVP through the JVP
and HVP-backward kernels (full Hessian with ``analytic-full``).  The orig
IWE is voted once per event set and passed to the solve.  A time-aware
spec routes to the voxel kernels (K5; K6 for the analytic HVP, whose
assembly is Gauss-Newton only there: ``analytic-full`` warns and solves
with the FD HVP).  A spec of the JAX package's unfused route (an outer
padding, a count or polarity vote: ``objective.is_unfused``) solves with
the full analytic HVP and no step clip or FD polish whatever
``optimizer.hvp_mode`` says, as the JAX package's Newton takes its exact
autodiff HVP there (``patch_base.py:414-419``).

The other ``optimizer.method`` values solve a scale's objective from the
host (the JAX package's ``_run_scipy_on_spec``, ``run_first_order`` and
``_run_sampling_on_spec``): a scipy method through ``scipy_bridge`` (one
host read per evaluation: the loss, gradient and hybrid components
together), a first-order rule (``first_order.py``: one read per solve) or
the sampling ("optuna") search (rounds of candidates drawn from the
solver's numpy generator in the JAX package's order, each scored by one
K1 evaluation, one read per round).  ``optimizer.device: false`` sends
``Newton-CG`` to scipy's.

With a ``parallel:`` mesh (``SolverBase._setup_parallel``) the device
solves take an event-sharded frame (``objective.ShardedFrame``) and its
sharded objective; the sweeps and the host optimizers see the unsharded
frame on the lead device.
"""

import logging
from typing import Dict, Tuple

import numpy as np
import torch

from ..types import FlowPatch
from ..utils.config_schema import ConfigError
from .base import SolverBase
from .first_order import FIRST_ORDER, run_first_order
from .newton_cg import build_lbfgs, build_newton_cg
from .objective import (
    FleetEvents,
    FrameEvents,
    ObjectiveSpec,
    build_objective,
    build_objective_hvp_staged,
    build_value_grad_hvp,
    is_unfused,
    objective_supports_analytic_hvp,
)
from .sampling import build_patch_search, gather_patch_events
from .scipy_bridge import SCIPY_OPTIMIZERS, _NEEDS_HESS, _NEEDS_HVP, minimize

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


HVP_MODES = ("fd", "analytic", "analytic-warm", "analytic-coldfd", "analytic-all", "analytic-full")


# the grid-best / global-best sweep: candidates per call of the batched
# objective (K7 over that many copies of the frame's events)
GRID_SWEEP_CHUNK = 100


def grid_translations(step: int) -> np.ndarray:
    """The init sweep's shared translations ``[K, 2]``: the ij-meshgrid of
    ``np.arange(-150, 150, step)`` (``grid-best``: step 30, 100 candidates;
    ``global-best``: step 10, 900)."""
    field = np.arange(-150, 150, step, dtype=np.float64)
    return np.stack(np.meshgrid(field, field, indexing="ij"), -1).reshape(-1, 2)


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

    def initialize_from_init(self, init: str, events_np: np.ndarray, frame: FrameEvents,
                             orig: torch.Tensor) -> torch.Tensor:
        """The cold start ``solver.patch.initialize`` names, ``[2, n_patch]``
        at the current tile grid: ``random``, ``zero``, ``optuna-sampling``
        (the per-patch sampling sweep from zero motion, ``optimizer.n_iter``
        candidates) or ``grid-best`` / ``global-best`` (the best shared
        translation of ``grid_translations``, tiled over every patch)."""
        if init == "random":
            return self.initialize_random()
        if init == "zero":
            return self.initialize_zeros()
        if init == "optuna-sampling":
            return self.initialize_guess_from_patch_search(events_np, self.initialize_zeros(),
                                                           self.opt_config["n_iter"])
        if init in ("grid-best", "global-best"):
            best = self._grid_best_translation(frame, orig, 10 if init == "global-best" else 30)
            return self.tensor(np.repeat(best[:, None], self.n_patch, axis=1))
        raise ConfigError(f"'solver.patch.initialize: {init!r}' is not a known initialization")

    def _grid_sweep_losses(self, spec: ObjectiveSpec, frame: FrameEvents, orig, motions: torch.Tensor,
                           chunk: int = GRID_SWEEP_CHUNK) -> torch.Tensor:
        """The objective of ``spec`` (TV included) at each row of ``motions``
        ``[K, M]``, in chunks of ``chunk`` candidates through the batched
        objective: one K7 forward over ``chunk`` copies of the frame's
        events (``chip_smoke.py`` ``[init-grid]`` times it, with its peak
        memory, against one K1 evaluation per candidate)."""
        from .fleet import build_batched_objective

        with torch.no_grad():
            obj = build_batched_objective(spec)
            losses, copies = [], None
            for lo in range(0, len(motions), chunk):
                part = motions[lo:lo + chunk]
                if copies is None or len(copies) != len(part):
                    copies = FleetEvents.copies(frame, len(part))
                losses.append(obj(part, None if orig is None else orig.expand((len(part),) + orig.shape), copies))
            return torch.cat(losses)

    def _grid_best_translation(self, frame: FrameEvents, orig, step: int) -> np.ndarray:
        """The JAX package's ``_grid_best_translation``: the current scale's
        objective at every translation of ``grid_translations(step)`` tiled
        over the patches; the first minimum (``nanargmin``), read back once."""
        grid = grid_translations(step)
        tiles = np.repeat(grid[:, :, None], self.n_patch, axis=2).reshape(len(grid), -1)
        losses = self._grid_sweep_losses(self._current_spec(), frame, orig, self.tensor(tiles))
        self.syncs += 1
        return grid[int(np.nanargmin(losses.cpu().numpy()))]

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
            time_aware=self.is_time_aware,
            time_bin=self.time_bin,
            flow_interpolation=self.flow_interpolation,
            t0_location=self.t0_flow_location,
            scale_later=self.scale_later,
            motion_model=getattr(self, "objective_motion_model", "tiles"),
            outer_padding=self.padding,
            iwe_method=self.iwe_method,
        )

    def frame_events(self, events: np.ndarray) -> FrameEvents:
        """A frame's events as this solver's objective takes them: its
        device and dtype, time bins when time-aware, polarity channels with
        ``iwe.method: polarity``."""
        return FrameEvents.from_numpy(events, self.device, self.dtype, self.time_bin,
                                      polarity=self.iwe_method == "polarity")

    def _shards_events(self) -> bool:
        """Whether the device solve shards its frames' events: a mesh with
        an event axis > 1 and the fused objective (the unfused route runs on
        one device, with the JAX package's warning, once)."""
        if self.mesh is None or self.n_event_shards <= 1:
            return False
        if is_unfused(self._current_spec()):
            if not getattr(self, "_warned_mesh_unused", False):
                logger.warning("a 'parallel' mesh is configured but the objective does not route through the fused "
                               f"kernel (outer_padding {self.padding}, iwe.method {self.iwe_method!r}); the solve "
                               "runs single-device")
                self._warned_mesh_unused = True
            return False
        return True

    def _newton_frame(self, frame: FrameEvents, sharded: bool):
        """The device solve's frame: cut over the mesh's first row when
        ``sharded``, else ``frame``."""
        return frame.shard(self.mesh.event_devices()) if sharded else frame

    def _want_analytic(self, warm: bool, finest: bool) -> bool:
        """The hvp-mode routing table: does the solve of this (warmth,
        scale) pair use the analytic HVP?  ``analytic``: the finest scale
        only (cold-start basin selection on the coarse scales needs the FD
        curvature); ``analytic-warm``: also every scale of a warm frame;
        ``analytic-coldfd``: the finest scale of warm frames only;
        ``analytic-all`` / ``analytic-full``: every scale (Gauss-Newton /
        full Hessian)."""
        mode = str(self.opt_config.get("hvp_mode", "fd")).lower()
        if mode in ("analytic-all", "analytic-full"):
            return True
        if mode == "analytic":
            return bool(finest)
        if mode == "analytic-warm":
            return bool(finest or warm)
        if mode == "analytic-coldfd":
            return bool(warm and finest)
        return False

    def _curvature(self, spec: ObjectiveSpec, warm: bool, finest: bool) -> str:
        """The curvature model of this (warmth, scale) Newton solve: "exact"
        on an unfused spec whatever ``hvp_mode`` says (the full analytic
        HVP, as the JAX package's autodiff there), else "analytic-gn" /
        "analytic-full" where ``_want_analytic`` asks for it and the
        objective supports it, else "fd"; warns once on an unknown
        ``hvp_mode`` and on an analytic mode the objective does not
        support."""
        if is_unfused(spec):
            return "exact"
        mode = str(self.opt_config.get("hvp_mode", "fd")).lower()
        if mode not in HVP_MODES and not getattr(self, "_warned_hvp_mode", False):
            logger.warning(f"optimizer.hvp_mode: {mode!r} is not recognized ({' | '.join(HVP_MODES)}) "
                           "— using fd")
            self._warned_hvp_mode = True
        gauss_newton = mode != "analytic-full"
        if not self._want_analytic(warm, finest):
            return "fd"
        if not objective_supports_analytic_hvp(spec, gauss_newton=gauss_newton):
            if not getattr(self, "_warned_analytic_hvp", False):
                logger.warning("optimizer.hvp_mode: analytic is not supported for this objective "
                               "(time-aware: analytic-full) — falling back to the FD HVP")
                self._warned_analytic_hvp = True
            return "fd"
        return "analytic-gn" if gauss_newton else "analytic-full"

    def _newton_options(self, curvature: str, finest: bool, maxiter: int, cg_maxiter=None,
                        gtol: float = 1e-5) -> dict:
        """The Newton-CG budget and curvature options of one solve of
        ``curvature`` (``_curvature``'s; the sequential and the fleet Newton
        take the same): the HVP's mode, and the analytic HVPs' step clip and
        FD polish (the exact HVP takes neither, as the JAX package's
        autodiff mode)."""
        kw = {
            "maxiter": maxiter,
            "cg_maxiter": int(cg_maxiter if cg_maxiter is not None else self.opt_config.get("cg_maxiter", 32)),
            "xtol": 1e-5,
            "gtol": gtol,
            "fd_central": bool(self.opt_config.get("hvp_central", True)),
            "hvp_mode": "fd" if curvature == "fd" else "analytic",
        }
        if curvature.startswith("analytic"):
            # the analytic curvature needs the per-component step clip (px/s);
            # central-FD refinement iterations: finest scale only
            kw["max_step"] = float(self.opt_config.get("hvp_max_step", 10.0))
            kw["fd_polish"] = int(self.opt_config.get("fd_polish", 0)) if finest else 0
        return kw

    def _lbfgs_options(self, maxiter: int, gtol: float = 1e-5):
        """The device L-BFGS's options (``optimizer.device_solver: lbfgs``),
        or None for Newton-CG; warns once of the Newton keys it ignores."""
        if str(self.opt_config.get("device_solver", "newton-cg")).lower() != "lbfgs":
            return None
        ignored = [k for k in ("cg_maxiter", "coarse_cg_maxiter", "hvp_central", "hvp_mode", "fd_polish")
                   if k in self.opt_config]
        if ignored and not getattr(self, "_warned_lbfgs_ignored", False):
            logger.warning(f"optimizer keys {ignored} have no effect under device_solver: lbfgs "
                           "(no CG inner loop / no HVPs)")
            self._warned_lbfgs_ignored = True
        return {"maxiter": maxiter, "xtol": 1e-5, "gtol": gtol, "memory": int(self.opt_config.get("lbfgs_memory", 8))}

    def _run_newton(self, spec: ObjectiveSpec, x0: torch.Tensor, frame: FrameEvents,
                    orig: torch.Tensor, maxiter: int, cg_maxiter=None, finest: bool = True,
                    warm: bool = False, gtol: float = 1e-5, stage=None):
        """One device solve of this scale's objective from ``x0`` (flat [2 *
        n_patch], or a global model's [P]): Newton-CG, or L-BFGS with
        ``optimizer.device_solver: lbfgs``; returns (best_x, best_f,
        n_iter, hvp), hvp naming the curvature model: ``_curvature``'s, or
        "lbfgs".  With ``stage`` (a ``graphs.Stage``
        whose buffers are ``frame`` and ``orig``) the evaluations are the
        stage's, replayed from CUDA graphs on the card (the chain);
        without, they run eagerly (the loop).  An event-sharded ``frame``
        (``objective.ShardedFrame``) takes the sharded objective and HVP
        (the JAX package's ``_build_newton`` with its mesh), L-BFGS's too."""
        obj = build_objective(spec)
        lbfgs = self._lbfgs_options(maxiter, gtol)
        if lbfgs is not None:
            solve, name = build_lbfgs(lambda x, *a: obj(x, *a)[0], **lbfgs), "lbfgs"
        else:
            name = self._curvature(spec, warm, finest)
            hvp_kw = {}
            if name != "fd":
                prep, hvp = build_objective_hvp_staged(spec, gauss_newton=name == "analytic-gn")
                hvp_kw = {"hvp_fn": hvp, "hvp_prep_fn": prep}
            solve = build_newton_cg(lambda x, *a: obj(x, *a)[0],
                                    **self._newton_options(name, finest, maxiter, cg_maxiter, gtol), **hvp_kw)
        x0 = x0.reshape(-1).to(self.dtype)
        if stage is None:
            best_x, best_f, n_iter = solve(x0, orig, frame)
        else:
            ev = stage.evaluations((spec, name), solve.value_fn, solve.hvp_fn, solve.hvp_prep_fn)
            best_x, best_f, n_iter = solve.solve(ev, x0)
        self.syncs += solve.syncs
        return best_x, best_f, n_iter, name

    # --- the host-driven optimizers ----------------------------------------------
    def _device_newton(self) -> bool:
        return self.opt_config["method"] == "Newton-CG" and bool(self.opt_config.get("device", True))

    def _check_optimizer(self, sampling: bool = True) -> None:
        """Raise ``ConfigError`` before a solve unless ``optimizer.method``
        is one this solver runs: the device Newton-CG (or L-BFGS), a scipy
        method, a first-order rule, optax's ``LBFGS``, the sampling optimizer
        with ``sampling``."""
        method = self.opt_config["method"]
        if self._device_newton():
            return
        if method not in SCIPY_OPTIMIZERS + list(FIRST_ORDER) + ["LBFGS"] + (["optuna"] if sampling else []):
            raise ConfigError(f"optimizer.method {method!r} is not supported by {type(self).__name__}")

    def _run_scipy_on_spec(self, spec: ObjectiveSpec, frame: FrameEvents, orig, motion0, options: dict):
        """A scipy method on this objective from ``motion0``; each
        evaluation's loss, gradient and hybrid components come back in one
        read and go to the history register.  Returns scipy's result."""
        vg, hvp, hess = build_value_grad_hvp(spec)
        n = int(np.prod(np.shape(motion0)))

        def read(t: torch.Tensor) -> np.ndarray:
            self.syncs += 1
            return t.detach().to("cpu", torch.float64).numpy()

        def vg_np(x):
            loss, grad, comps = vg(self.tensor(x), orig, frame)
            host = read(torch.cat([loss.reshape(1), grad.reshape(-1)] + [c.reshape(1) for c in comps.values()]))
            return host[0], host[1:1 + n], dict(zip(comps, host[1 + n:]))

        return minimize(vg_np, np.asarray(motion0.cpu() if torch.is_tensor(motion0) else motion0,
                                          dtype=np.float64).reshape(-1),
                        method=self.opt_config["method"], options=options,
                        hvp=lambda x, p: read(hvp(self.tensor(x), self.tensor(p), orig, frame)),
                        hess=lambda x: read(hess(self.tensor(x), orig, frame)),
                        history_cb=self._history_cb)

    def _run_sampling_on_spec(self, spec: ObjectiveSpec, frame: FrameEvents, orig, motion0, n_iter: int,
                              n_rounds: int = 4):
        """The sampling ("optuna") optimizer: ``n_rounds`` rounds of
        ``n_iter // n_rounds`` candidates of the whole motion (round 0
        uniform in the ``optimizer.parameters`` box for the ``TPE`` /
        ``random`` samplers, then gaussians around the incumbent of a
        halving width), each scored by the objective (K1); the incumbent
        survives.  The draws are the JAX package's, from the solver's numpy
        generator.  Returns (best motion, float64 [M], its loss)."""
        obj = build_objective(spec)
        p = self.opt_config["parameters"]
        lo = np.array([p["trans_x"]["min"], p["trans_y"]["min"]])
        hi = np.array([p["trans_x"]["max"], p["trans_y"]["max"]])
        k_per_round = max(1, n_iter // n_rounds)
        best = np.asarray(motion0.cpu() if torch.is_tensor(motion0) else motion0, dtype=np.float64).reshape(-1)

        def losses_of(cands: np.ndarray) -> np.ndarray:
            with torch.no_grad():
                losses = torch.stack([obj(x, orig, frame)[0] for x in self.tensor(cands)])
            self.syncs += 1
            return losses.cpu().numpy()

        best_loss = float(losses_of(best[None])[0])
        scale = 1.0
        for r in range(n_rounds):
            if r == 0 and self.opt_config.get("sampler", "TPE") in ("TPE", "random"):
                cands = self._rng.random((k_per_round, best.size))
                box_lo = np.tile(lo, best.size // 2)
                box_hi = np.tile(hi, best.size // 2)
                cands = cands * (box_hi - box_lo) + box_lo
            else:
                sigma = (np.tile(hi - lo, best.size // 2)) / 8.0 * scale
                cands = best[None] + self._rng.standard_normal((k_per_round, best.size)) * sigma
            losses = losses_of(cands)
            i = int(np.nanargmin(losses))
            if losses[i] < best_loss:
                best_loss = float(losses[i])
                best = cands[i]
            scale *= 0.5
            self._history_cb(best_loss, None)
        return best, best_loss

    def _run_host_optimizer(self, spec: ObjectiveSpec, x0, frame: FrameEvents, orig, gtol: float,
                            sampling: bool = True):
        """One solve of this objective by ``optimizer.method`` other than the
        device Newton-CG (``_check_optimizer``'s): a scipy method (at most
        ``max_iter`` iterations, ``gtol``), the sampling optimizer
        (``sampling``), a first-order rule or optax's ``LBFGS``.  Returns (best motion, flat
        on the device; its loss; the iterations; the curvature scipy took:
        "bridge-fd" HVPs, a "hessian", or "none")."""
        method = self.opt_config["method"]
        if method in SCIPY_OPTIMIZERS:
            self.cost_func.enable_history_register()
            result = self._run_scipy_on_spec(spec, frame, orig, x0, options={
                "gtol": gtol, "disp": False, "maxiter": self.opt_config.get("max_iter", 25)})
            hvp = "bridge-fd" if method in _NEEDS_HVP else "hessian" if method in _NEEDS_HESS else "none"
            return self.tensor(result.x), float(result.fun), int(getattr(result, "nit", result.nfev)), hvp
        if method == "optuna" and sampling:
            best, loss = self._run_sampling_on_spec(spec, frame, orig, x0, int(self.opt_config["n_iter"]))
            return self.tensor(best), loss, int(self.opt_config["n_iter"]), "none"
        vg = build_value_grad_hvp(spec)[0]
        best, loss, reads = run_first_order(lambda x: vg(x, orig, frame)[:2], self.tensor(x0).reshape(-1), method,
                                            self.opt_config)
        self.syncs += reads
        return best, loss, int(self.opt_config["n_iter"]), "none"

    # --- visualization ---------------------------------------------------------
    def _viz_warp(self, events, warp):
        """A tile solver warps by the dense flow of its tiles (the flow
        voxel when time-aware) times the window's span, and colorizes that
        flow (the voxel's t0 slice).  A deviation from the JAX package's
        single-scale tile solvers, which hand their tile array to the 2-DoF
        translation warp, which raises (its pyramid overrides the
        ``visualize_*`` methods as ``solver/pyramid.py`` does)."""
        with torch.no_grad():
            flow = self.motion_to_dense_flow(warp) * self._t_range(events)
            shown = self.get_original_flow_from_time_aware_flow_voxel(flow) if self.is_time_aware else flow
        return flow, "dense-flow-voxel" if self.is_time_aware else "dense-flow", shown

    # --- per-patch init sweep -----------------------------------------------
    def _patch_capacity(self, n_events: int) -> int:
        guess = 2 * n_events // max(1, self.n_patch)
        return int(min(max(512, _next_pow2(guess)), _next_pow2(n_events)))

    def _patch_search(self, patch_events: np.ndarray, weights: np.ndarray, counts: np.ndarray,
                      motion0: torch.Tensor, n_candidates: int) -> torch.Tensor:
        """One call of the sampling sweep over a patch batch ``[P, C, 4]``
        from ``motion0`` [P, 2] (one draw for the whole batch); [P, 2]."""
        search = build_patch_search(
            tuple(self.patch_size), int(n_candidates),
            blur_sigma=self.iwe_config["blur_sigma"], candidates_fn=self.candidates_fn,
            iwe_method=self.iwe_method, outer_padding=self.padding,
        )
        return search(self.tensor(patch_events), self.tensor(weights), torch.as_tensor(counts, device=self.device),
                      motion0.to(self.dtype).contiguous(), self.generator)

    def initialize_guess_from_patch_search(self, events_np: np.ndarray, motion0: torch.Tensor,
                                           n_candidates: int) -> torch.Tensor:
        """Per-patch refinement of motion0 [2, n_patch] by the batched
        sampling sweep; returns [2, n_patch]."""
        capacity = self._patch_capacity(len(events_np))
        patch_events, weights, counts = gather_patch_events(events_np, self.patches, capacity)
        return self._patch_search(patch_events, weights, counts, motion0.reshape(2, -1).T, n_candidates).T

    def initialize_guess_from_patch_search_batched(self, events_list, motion0: torch.Tensor, n_candidates: int,
                                                   max_events: int) -> torch.Tensor:
        """The fleet chain's init sweep (the JAX package's
        ``_optimize_batch_chain``): every frame's patches gathered at the
        capacity of ``max_events`` (the batch's largest frame), stacked
        frame-major into one ``[B * P, C, 4]`` batch and refined by ONE
        sweep call, so one draw serves the batch; motion0 [B, 2, n_patch]
        -> [B, 2, n_patch]."""
        capacity = self._patch_capacity(max_events)
        gathered = [gather_patch_events(e, self.patches, capacity) for e in events_list]
        patch_events, weights, counts = (np.concatenate([g[i] for g in gathered]) for i in range(3))
        bsz = motion0.shape[0]
        rows = motion0.transpose(1, 2).reshape(-1, 2)  # [B * P, 2], frame-major
        motion1 = self._patch_search(patch_events, weights, counts, rows, n_candidates)
        return motion1.reshape(bsz, -1, 2).transpose(1, 2)
