"""Online (streaming) flow estimation: the serving surface (port of
``event_based_optical_flow_tpu/streaming.py``).

A consumer has a live event stream and wants per-window dense flow with the
warm-start chaining of the eval protocol.  This wraps the pyramidal solver
behind a push API, on the card unless the caller asks for the CPU:

    est = StreamingFlowEstimator(image_shape=(260, 346))
    for window in event_windows:           # [n, 4] (x, y, t, p) arrays
        flow = est.push(window)            # [2, H, W] px displacement
                                           # over the window

The warm start and the solver's randomness live inside; ``reset()`` drops
the warm-start chain (e.g. on a scene cut).  ``MultiStreamFlowEstimator``
serves several independent streams, one window each per push, solved one
after another or as one fleet batch (``solver/fleet.py``) with per-stream
warm starts.

Event-count discipline (``fixed_event_count=N``): windows larger than N are
uniformly subsampled to exactly N (temporal order kept), and windows smaller
than N borrow the most recent events from the previous window's tail (the
sliding fixed-count window of event pipelines; assumes consecutive
non-overlapping pushes), so every solved window has the protocol's size, and the pyramid's chained
solve (``optimizer.chain``, on by default) replays the CUDA graphs its
first window of that size captured.

State files are npz in the JAX package's layout (``warm_{s}`` /
``warm_{k}_{s}`` float64 motions per scale, ``tail`` / ``tail_{k}``,
``n_windows`` / ``n_batches``, ``streaks``): a state file either package's
server wrote resumes the other's warm chain (``state_from_numpy``).
"""

import logging
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .state import to_numpy
from .utils import set_numerics
from .utils.config_schema import ConfigError, _KNOWN_OPT_KEYS, _KNOWN_SOLVER_KEYS, check_ported

logger = logging.getLogger(__name__)

_DEFAULT_SOLVER = {
    "method": "pyramidal_patch_contrast_maximization",
    "time_aware": False,
    "patch": {"initialize": "random", "scale": 5, "crop_height": 256,
              "crop_width": 336, "filter_type": "bilinear"},
    "motion_model": "2d-translation",
    "warp_direction": "first",
    "parameters": ["trans_x", "trans_y"],
    "cost": "hybrid",
    "outer_padding": 0,
    "cost_with_weight": {"multi_focal_normalized_gradient_magnitude": 1.0,
                         "total_variation": 0.01},
    "iwe": {"method": "bilinear_vote", "blur_sigma": 1},
}
_DEFAULT_OPT = {
    "n_iter": 40,
    "method": "Newton-CG",
    "max_iter": 25,
    # Serving is warm-dominated (every window after the first is a warm
    # frame), so the analytic Gauss-Newton HVP runs on every pyramid scale
    # of warm windows; cold windows keep the FD HVP on the coarse scales.
    # Accuracy-critical deployments pass optimizer_config={"hvp_mode": "fd"}
    # (the eval protocol's default).
    "hvp_mode": "analytic-warm",
    "parameters": {"trans_x": {"min": -150, "max": 150},
                   "trans_y": {"min": -150, "max": 150}},
}


def _subsample_fixed(events: np.ndarray, count: int) -> np.ndarray:
    """Uniform-stride subsample to exactly ``count`` rows (t-sorted input
    keeps temporal order; first and last events always kept).  Indices
    are strictly increasing for count <= n (spacing >= 1), so no event
    is duplicated."""
    n = len(events)
    if n <= count:
        return events
    idx = np.round(np.linspace(0, n - 1, count)).astype(np.int64)
    return events[idx]


def _fixed_count(events: np.ndarray, tail: Optional[np.ndarray], count: int) -> np.ndarray:
    """``events`` brought to ``count`` rows: topped up from the front of
    the previous solved window's most recent events (``tail``) when
    smaller, uniformly subsampled when larger (keeps t order for
    consecutive pushes)."""
    if len(events) < count and tail is not None:
        events = np.concatenate([tail[-(count - len(events)):], events], axis=0)
    return _subsample_fixed(events, count)


def _warmup_window(image_shape, n_events, seed, t0=0.0, span=0.05):
    """Aperiodic moving-dots window (global ~14 px/s translation) for the
    warm-up pushes: a recoverable scene, so warm-chained warm-up windows
    drive the same cold -> warm sequence as production traffic.  Events are
    clipped (not dropped) at the sensor border so exactly ``n_events`` rows
    come back."""
    rng = np.random.default_rng(seed)
    H, W = image_shape
    n_dots = max(50, (H * W) // 256)
    dx = rng.uniform(1.0, H - 2.0, n_dots)
    dy = rng.uniform(1.0, W - 2.0, n_dots)
    idx = rng.integers(0, n_dots, n_events)
    t = np.sort(rng.uniform(0.0, span, n_events))
    u, v = 12.0, 7.0  # px/s, well inside the default +-150 search bounds
    x = np.clip(dx[idx] - t * u + rng.normal(0, 0.2, n_events), 0, H - 1)
    y = np.clip(dy[idx] - t * v + rng.normal(0, 0.2, n_events), 0, W - 1)
    p = rng.integers(0, 2, n_events).astype(np.float64)
    return np.stack([x, y, t0 + t, p], axis=1)


def _warm_streak(solver) -> Tuple[int, bool]:
    """The solver's ``warm_finest_only`` cadence (its warm streak and
    whether the last solve took the fast path)."""
    return solver._warm_streak, solver._wfo_last


def _set_warm_streak(solver, streak: Tuple[int, bool]) -> None:
    solver._warm_streak, solver._wfo_last = streak


def _deep_merge(base: dict, override: dict) -> dict:
    """Recursive dict merge (override wins; nested dicts merge instead of
    replace) — partial user configs keep the defaults' remaining keys.
    Nested dicts are copied: the crop fit below writes into the merged
    ``patch`` dict, which must not be the module's default (the JAX
    package's copy shares it, so one estimator's sensor-fitted crop
    becomes every later estimator's default)."""
    out = {k: _deep_merge(v, {}) if isinstance(v, dict) else v for k, v in base.items()}
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def _prepare_configs(image_shape, solver_config, optimizer_config):
    """Deep-merge user configs over the MVSEC-protocol defaults and fit
    the pyramid crop to the sensor (largest multiple of 2^(scales-1):
    each pyramid level halves the patch size).  Unknown keys warn like
    the CLI's schema validation; an option the port does not run raises
    ``ConfigError`` (``utils.config_schema.check_ported``)."""
    H, W = image_shape
    slv = _deep_merge(_DEFAULT_SOLVER, solver_config or {})
    user_patch = (solver_config or {}).get("patch", {})
    if "crop_height" not in user_patch or "crop_width" not in user_patch:
        scales = int(slv["patch"]["scale"]) - 1
        unit = 2 ** max(1, scales)
        if (H // unit) * unit == 0 or (W // unit) * unit == 0:
            raise ValueError(
                f"image_shape {image_shape} too small for "
                f"patch.scale={slv['patch']['scale']} (needs >= {unit} px)"
            )
        slv["patch"].setdefault("crop_height", (H // unit) * unit)
        slv["patch"].setdefault("crop_width", (W // unit) * unit)
        slv["patch"]["crop_height"] = min(slv["patch"]["crop_height"], (H // unit) * unit)
        slv["patch"]["crop_width"] = min(slv["patch"]["crop_width"], (W // unit) * unit)
    opt = _deep_merge(_DEFAULT_OPT, optimizer_config or {})
    for key in slv:
        if key not in _KNOWN_SOLVER_KEYS:
            logger.warning(f"unknown solver config key '{key}' (ignored?)")
    for key in opt:
        if key not in _KNOWN_OPT_KEYS:
            logger.warning(f"unknown optimizer config key '{key}' (ignored?)")
    check_ported({"solver": slv, "optimizer": opt})
    return slv, opt


def state_from_numpy(data, n_streams: Optional[int] = None):
    """The warm-start motions of a serving state file (an npz in the JAX
    package's layout), as the solver's ``set_previous_frame_best_estimation``
    takes them: for one stream (``n_streams`` None) a ``{scale: array}``
    dict from the ``warm_{s}`` keys; for ``n_streams`` streams a list with
    one such dict per stream from the ``warm_{k}_{s}`` keys (None for a
    stream the file has no motion of; streams ``k >= n_streams`` dropped).
    None when the file holds no warm motion."""
    keys = [k for k in data.files if k.startswith("warm_")]
    if n_streams is None:
        return {int(k[5:]): data[k] for k in keys} or None
    warm: List[Dict[int, np.ndarray]] = [dict() for _ in range(n_streams)]
    for key in keys:
        _, k, s = key.split("_")
        if int(k) < n_streams:
            warm[int(k)][int(s)] = data[key]
    return [d or None for d in warm] if any(warm) else None


class StreamingFlowEstimator:
    """Warm-start-chained per-window dense flow over a live event stream.

    Parameters
    ----------
    image_shape : (H, W) sensor resolution.
    solver_config / optimizer_config : same dicts as the YAML `solver:` /
        `optimizer:` sections, DEEP-merged over the defaults (the
        MVSEC-protocol pyramidal configuration with the crop fitted to
        the sensor), so partial overrides like
        ``{"patch": {"scale": 3}}`` keep the remaining keys.  Unknown
        keys warn like the CLI's schema validation; options the port does
        not run raise ``ConfigError``.
    The default HVP mode is ``analytic-warm`` (the analytic Gauss-Newton
    HVP on every pyramid scale once windows are warm-chained; cold windows
    run it on the finest scale only).  Accuracy-critical deployments pass
    ``optimizer_config={"hvp_mode": "fd"}`` for the eval-protocol behavior.

    warm_start : chain each window's solution into the next one's
        initialization (the reference eval protocol).
    fixed_event_count : if set, every solved window has exactly this
        many events once history allows: oversize windows are uniformly
        subsampled, undersized ones are topped up from the previous
        window's tail.
    device : where the solve runs (``cuda``: the CUDA kernels; ``cpu``:
        their plain versions).
    """

    def __init__(
        self,
        image_shape: Tuple[int, int],
        solver_config: Optional[dict] = None,
        optimizer_config: Optional[dict] = None,
        warm_start: bool = True,
        fixed_event_count: Optional[int] = None,
        device="cuda",
    ):
        from . import solver as solver_mod

        H, W = image_shape
        slv, opt = _prepare_configs(image_shape, solver_config, optimizer_config)
        set_numerics()  # the solve on the card is deterministic only under these
        self.image_shape = (H, W)
        self.warm_start = warm_start
        self.fixed_event_count = fixed_event_count
        self._tail: Optional[np.ndarray] = None
        self._solver = solver_mod.collections[slv["method"]]((H, W), {}, slv, opt, {}, device=device)
        self.n_windows = 0
        # time span (s) of the most recently SOLVED window — differs from
        # the pushed window's span when fixed_event_count borrowed tail
        # events; the px/s scale of the returned displacement
        self.last_span: Optional[float] = None

    def push(self, events: np.ndarray) -> np.ndarray:
        """Solve one event window; returns the dense flow as a
        [2, H, W] float array in PIXEL DISPLACEMENT over the window's
        time span (divide by the span for px/s).  Time-aware solvers
        (``solver_config: {time_aware: true, time_bin: T}``) return the
        flow VOXEL instead: [T, 2, H, W], one flow field per time bin.
        Events are [n, 4] (x=height coord, y=width coord, t, p) like
        everywhere else."""
        events = np.asarray(events, dtype=np.float64)
        if events.ndim != 2 or events.shape[1] != 4 or not len(events):
            raise ValueError("push expects a non-empty [n, 4] event array")
        if self.fixed_event_count:
            events = self._tail = _fixed_count(events, self._tail, int(self.fixed_event_count))
        t = events[:, 2]
        span = float(t.max() - t.min()) or 1.0
        self.last_span = span
        best = self._solver.optimize(events)
        if self.warm_start:
            self._solver.set_previous_frame_best_estimation(best)
        self.n_windows += 1
        flow = self._solver.motion_to_dense_flow(best, span) * span
        return flow.detach().cpu().double().numpy()

    def reset(self) -> None:
        """Drop the warm-start chain and the fixed-count borrow tail."""
        self._solver.previous_frame_best_estimation = None
        self._tail = None

    def warmup(self, n_windows: int = 2, n_events: Optional[int] = None,
               seed: int = 0) -> float:
        """Push synthetic moving-dot windows through the full solve path
        before real traffic (the kernels' build, the allocator's pools, and
        the pyramid chain's CUDA graphs for ``count``-event windows, which
        later pushes of that size replay),
        then restore the pre-warmup serving state: the warm chain, the
        borrow tail, the counters, the solver's randomness and its
        ``warm_finest_only`` streak, so warmup never leaks into real
        results or shifts which real windows re-anchor (a resumed chain
        survives it).  Two windows cover the cold and the warm solve.
        Returns the elapsed wall seconds."""
        t_start = time.time()
        count = int(n_events or self.fixed_event_count or 30000)
        warm_prev = self._solver.previous_frame_best_estimation
        tail_prev, span_prev, n_prev = self._tail, self.last_span, self.n_windows
        rng_snap = self._solver.rng_state()
        streak_snap = _warm_streak(self._solver)
        try:
            for i in range(int(n_windows)):
                self.push(_warmup_window(self.image_shape, count, seed + i, t0=0.05 * i))
        finally:
            self._solver.previous_frame_best_estimation = warm_prev
            self._tail, self.last_span, self.n_windows = tail_prev, span_prev, n_prev
            self._solver.set_rng_state(rng_snap)
            _set_warm_streak(self._solver, streak_snap)
        return time.time() - t_start

    def save_state(self, path) -> None:
        """Persist the serving state (warm-start motions + borrow tail +
        window counter) so a restarted process resumes chaining instead
        of re-initializing cold."""
        state: Dict[str, np.ndarray] = {"n_windows": np.asarray(self.n_windows)}
        warm = self._solver.previous_frame_best_estimation
        if isinstance(warm, dict):
            for s, v in to_numpy(warm).items():
                state[f"warm_{s}"] = v
        if self._tail is not None:
            state["tail"] = self._tail
        np.savez(path, **state)

    def load_state(self, path) -> None:
        """Restore state written by :meth:`save_state` (of either package)."""
        with np.load(path) as data:
            warm = state_from_numpy(data)
            self._tail = data["tail"] if "tail" in data.files else None
            self.n_windows = int(data["n_windows"])
        self._solver.previous_frame_best_estimation = None
        if warm is not None:
            self._solver.set_previous_frame_best_estimation(warm)

    def metrics(self, flow: np.ndarray, gt_flow: np.ndarray,
                events: np.ndarray) -> Dict[str, float]:
        """AEE/NPE/AE of a pushed flow against a GT displacement field
        ([H, W, 2] loader convention), masked by the window's events —
        the eval pipeline's metric contract."""
        import torch

        from .flow.metrics import calculate_flow_error

        H, W = self.image_shape
        gt_2hw = np.transpose(np.asarray(gt_flow, dtype=np.float64)[:H, :W], (2, 0, 1))
        mask = np.zeros((H, W), bool)
        xs = np.clip(events[:, 0].astype(int), 0, H - 1)
        ys = np.clip(events[:, 1].astype(int), 0, W - 1)
        mask[xs, ys] = True
        err = calculate_flow_error(torch.as_tensor(gt_2hw)[None],
                                   torch.as_tensor(np.asarray(flow, dtype=np.float64))[None],
                                   torch.as_tensor(mask)[None, None])
        return {k: float(v) for k, v in err.items()}


class MultiStreamFlowEstimator:
    """Dense flow for several INDEPENDENT event streams (multi-sensor /
    multi-client serving): each ``push`` takes one window per stream,
    with PER-STREAM warm-start chaining (each stream's window
    initializes from that stream's own previous solution, not a shared
    one).

    ``batching`` picks how the batch is solved:

    - ``"sequential"``: one pyramidal solve per stream, back to back.
    - ``"fleet"``: the whole batch as one lockstep solve per pyramid scale
      (``solver/fleet.py``), each frame warm-started from its own stream's
      motion.  A lockstep Newton runs every frame for the slowest frame's
      iterations at every scale.
      Required when the streams shard over a ``parallel_config={"data":
      N}`` device mesh: there the batch is the scaling mechanism (each data
      shard solves its streams on its own device, ``solver/fleet.py``).
    - ``"auto"`` (default): the JAX package's rule, measured there on one
      TPU chip: ``"fleet"`` with a data mesh; else ``"sequential"`` for
      time-aware configs (lockstep stragglers dominated the deep voxel
      solves), ``"fleet"`` for dense ones.  Its H100 measurement is in
      ``PERF.md``.

    Same config surface as :class:`StreamingFlowEstimator`; all streams
    share one sensor geometry and solver configuration.  Warm state is a
    per-stream list on the solver in BOTH modes (save_state / load_state
    round-trip across modes).  With ``optimizer.warm_finest_only``, the
    sequential mode keeps one warm streak per stream (swapped into the
    solver around the stream's solve, persisted as ``streaks``); with
    ``warm_full_every: K`` > 1 the streams' initial streaks are staggered
    by stream index (``k % K``), so their full-pyramid re-anchors fall on
    different pushes.  Fleet mode is one lockstep solve: one streak, on
    the solver.
    """

    def __init__(
        self,
        image_shape: Tuple[int, int],
        n_streams: int,
        solver_config: Optional[dict] = None,
        optimizer_config: Optional[dict] = None,
        warm_start: bool = True,
        fixed_event_count: Optional[int] = None,
        parallel_config: Optional[dict] = None,
        batching: str = "auto",
        device="cuda",
    ):
        from . import solver as solver_mod

        if n_streams < 1:
            raise ValueError("n_streams must be >= 1")
        if batching not in ("auto", "fleet", "sequential"):
            raise ValueError(
                f"batching must be auto|fleet|sequential, got {batching!r}"
            )
        H, W = image_shape
        slv, opt = _prepare_configs(image_shape, solver_config, optimizer_config)
        set_numerics()  # the solve on the card is deterministic only under these
        data_mesh = bool(parallel_config) and int((parallel_config or {}).get("data", 1)) > 1
        if batching == "auto":
            batching = "sequential" if (slv.get("time_aware") and not data_mesh) else "fleet"
        if batching == "sequential" and data_mesh:
            raise ValueError("batching='sequential' cannot shard streams over a parallel data mesh; "
                             "use batching='fleet'")
        if parallel_config:
            slv = dict(slv, parallel=dict(parallel_config))
        self.image_shape = (H, W)
        self.n_streams = int(n_streams)
        self.warm_start = warm_start
        self.fixed_event_count = fixed_event_count
        self.batching = batching
        self._tails: List[Optional[np.ndarray]] = [None] * self.n_streams
        solver_name = (
            "pyramidal_patch_contrast_maximization"
            if batching == "sequential"
            else "fleet_pyramidal_patch_contrast_maximization"
        )
        self._solver = solver_mod.collections[solver_name]((H, W), {}, slv, opt, {}, device=device)
        # per-stream warm_finest_only streaks (sequential mode), staggered
        # so the streams re-anchor on different pushes: an all-stream
        # re-anchor is one push that pays every stream's full pyramid
        wfe = int(opt.get("warm_full_every", 0) or 0)
        if batching == "sequential" and wfe > 1 and opt.get("warm_finest_only"):
            self._streaks0 = [(k % wfe, False) for k in range(self.n_streams)]
        else:
            self._streaks0 = [(0, False)] * self.n_streams
        self._streaks = list(self._streaks0)
        self.n_batches = 0

    def push(self, windows) -> np.ndarray:
        """Solve one event window per stream (list of ``n_streams``
        [n, 4] arrays, any per-stream length); returns [n_streams, 2, H,
        W] pixel displacements over each stream's window span
        ([n_streams, T, 2, H, W] — one field per time bin — for
        time-aware solver configs)."""
        if len(windows) != self.n_streams:
            raise ValueError(
                f"push expects {self.n_streams} windows, got {len(windows)}"
            )
        prepped = []
        for k, ev in enumerate(windows):
            ev = np.asarray(ev, dtype=np.float64)
            if ev.ndim != 2 or ev.shape[1] != 4 or not len(ev):
                raise ValueError(f"stream {k}: non-empty [n, 4] array required")
            if self.fixed_event_count:
                ev = self._tails[k] = _fixed_count(ev, self._tails[k], int(self.fixed_event_count))
            prepped.append(ev)
        if self.batching == "sequential":
            results = self._solve_sequential(prepped)
        else:
            results = self._solver.optimize_batch(prepped)
            if self.warm_start:
                # per-frame motion dicts -> per-stream warm chaining
                self._solver.set_previous_frame_best_estimation(results)
        self.n_batches += 1
        flows = []
        for ev, best in zip(prepped, results):
            t = ev[:, 2]
            span = float(t.max() - t.min()) or 1.0
            flows.append(self._solver.motion_to_dense_flow(best, span).detach().cpu().double().numpy() * span)
        return np.stack(flows)

    def _solve_sequential(self, prepped):
        """One sequential solve per stream (``batching: "sequential"``):
        each stream's warm state and warm streak swap in around its solve;
        afterwards the solver holds the SAME per-stream warm list as fleet
        mode.  A stream whose solve went cold restarts its streak at its
        initial offset.  A failure midway leaves the warm list and the
        streak counters as they were before the push (all streams or none
        advance)."""
        warm = self._solver.previous_frame_best_estimation
        warm_list = list(warm) if isinstance(warm, (list, tuple)) else [None] * self.n_streams
        streaks = list(self._streaks)
        results = []
        try:
            for k, ev in enumerate(prepped):
                self._solver.previous_frame_best_estimation = warm_list[k]
                _set_warm_streak(self._solver, streaks[k])
                results.append(self._solver.optimize(ev))
                streak, wfo = _warm_streak(self._solver)
                streaks[k] = (self._streaks0[k][0] if streak == 0 else streak, wfo)
        finally:
            if len(results) == len(prepped):
                self._streaks = streaks
                self._solver.previous_frame_best_estimation = list(results) if self.warm_start else warm
            else:
                self._solver.previous_frame_best_estimation = warm
        return results

    def warmup(self, n_windows: int = 2, n_events: Optional[int] = None,
               seed: int = 0) -> float:
        """Push synthetic windows on every stream before real traffic; see
        :meth:`StreamingFlowEstimator.warmup` (same contract: per-stream
        warm state, tails, streaks, the batch counter, the solver's
        randomness and its streak are restored afterwards)."""
        t_start = time.time()
        count = int(n_events or self.fixed_event_count or 30000)
        warm_prev = self._solver.previous_frame_best_estimation
        tails_prev, n_prev = list(self._tails), self.n_batches
        streaks_prev = list(self._streaks)
        rng_snap = self._solver.rng_state()
        streak_snap = _warm_streak(self._solver)
        try:
            for i in range(int(n_windows)):
                self.push([
                    _warmup_window(self.image_shape, count,
                                   seed + 97 * k + i, t0=0.05 * i)
                    for k in range(self.n_streams)
                ])
        finally:
            self._solver.previous_frame_best_estimation = warm_prev
            self._tails, self.n_batches = tails_prev, n_prev
            self._streaks = streaks_prev
            self._solver.set_rng_state(rng_snap)
            _set_warm_streak(self._solver, streak_snap)
        return time.time() - t_start

    def reset(self, stream: Optional[int] = None) -> None:
        """Drop warm-start state and borrow tails — all streams, or one
        stream's tail (per-stream warm entries cannot be dropped
        individually once set; a scene cut on one stream is handled by
        that stream's next window simply re-initializing worse)."""
        if stream is None:
            self._solver.previous_frame_best_estimation = None
            self._tails = [None] * self.n_streams
            self._streaks = list(self._streaks0)
        else:
            self._tails[stream] = None
            self._streaks[stream] = self._streaks0[stream]

    def save_state(self, path) -> None:
        """Persist per-stream serving state (warm motions + tails +
        streaks); see :meth:`StreamingFlowEstimator.save_state`."""
        state: Dict[str, np.ndarray] = {"n_batches": np.asarray(self.n_batches)}
        warm = self._solver.previous_frame_best_estimation
        if isinstance(warm, list):
            for k, d in enumerate(warm):
                for s, v in ({} if d is None else to_numpy(d)).items():
                    state[f"warm_{k}_{s}"] = v
        for k, t in enumerate(self._tails):
            if t is not None:
                state[f"tail_{k}"] = t
        state["streaks"] = np.asarray([[st, int(wf)] for st, wf in self._streaks])
        np.savez(path, **state)

    def load_state(self, path) -> None:
        """Restore state written by :meth:`save_state` (of either package,
        with any number of streams: streams the file lacks start cold with
        their initial streaks, streams beyond ``n_streams`` are dropped)."""
        with np.load(path) as data:
            warm = state_from_numpy(data, self.n_streams)
            self._tails = [data[f"tail_{k}"] if f"tail_{k}" in data.files else None
                           for k in range(self.n_streams)]
            if "streaks" in data.files:
                loaded = [(int(st), bool(wf)) for st, wf in data["streaks"]][: self.n_streams]
                self._streaks = loaded + self._streaks0[len(loaded):]
            self.n_batches = int(data["n_batches"])
        self._solver.previous_frame_best_estimation = None
        if warm is not None:
            self._solver.set_previous_frame_best_estimation(warm)
