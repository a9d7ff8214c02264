"""CLI driver of the PyTorch port (the JAX package's ``main.py`` stays the
JAX driver):

    python -m event_based_optical_flow_tpu_torch.main --config_file configs/<cfg>.yaml \
        [--eval] [--device cuda|cpu] [--log LEVEL]

Reads the same YAML and the same datasets (``data.dataset``: MVSEC, DSEC,
ECD, EVT2, EVT3 or synthetic).  Single-frame mode optimizes the event
slice [data.ind1, data.ind2); ``--eval`` runs the sequential evaluation
over the gray-frame windows with GT flow (AEE/NPE/AE + FWL per frame) and
writes the same ``flow_error_per_frame_with_mask.txt``,
``eval_metrics.jsonl`` and ``eval_state.npz`` as the JAX CLI, so either
CLI resumes the other's run.  A dataset without GT flow (ECD, the raw
camera streams) runs the GT-free protocol instead: PRED_FWL per window of
the loader's clock, the same files.  With ``data.fleet_batch > 1`` and a
solver that solves batches (``solver.method:
fleet_pyramidal_patch_contrast_maximization``), ``--eval`` on a dataset
with GT runs the fleet evaluation: ``fleet_batch`` frames per lockstep
solve, independent (``data.warm_start: false``) or each batch warm-started
from the previous batch's last solution (``data.warm_start: batch``).
``output.save_flow`` (``dsec_png`` or ``npz``) dumps every frame's
displacement into ``<output_dir>/flow_submission/``.  The global solver
(``solver.method: global_contrast_maximization``) runs through the same
loops: its solution, warm start and checkpoint are one parameter array
(``eval_state.npz`` key ``array``, as the JAX CLI writes it).  An
``is_dnn: true`` config (``configs/synthetic_dnn.yaml``) trains EV-FlowNet
with the unsupervised CMax loss (``models/``; checkpoints under
``dnn.checkpoint_dir``, default ``<output_dir>/checkpoints/step_<n>/``, a
rerun resumes) and with ``--eval`` evaluates it per gray-frame window
into ``<output_dir>/dnn_flow_error.txt``.

The solver paths write the JAX CLI's PNGs into ``output_dir``
(``visualizer.py``): every ``data.visualize_every`` frames (default 1; 0:
none) the sequential eval writes ``original<i>``, ``pred_warp<i>`` (and the
pyramid's ``pred_masked<i>``), ``gt_warp<i>`` and ``gt_flow<i>``, the GT-free
eval ``original<i>`` and ``pred_warp<i>``, after the frame's record (its
``seconds`` do not include them); every solve that records a loss history
writes ``optimization_steps<i>``; single-frame mode writes the events' IWE
before and after the solve.  The fleet eval writes none, as in the JAX CLI.
``output.trace_dir`` traces every solve with ``torch.profiler``
(``SolverBase.profiled_optimize``).
"""

import argparse
import logging
import os
import shutil
import sys
import time

import numpy as np
import torch
import yaml

from . import data, solver
from .state import to_numpy
from .flow.io import save_flow_frame
from .utils import (ConfigError, check_key_and_bool, crop_event, fetch_runtime_info, fix_random_seed, set_numerics,
                    validate_config)
from .utils import checkpoint as ckpt
from .visualizer import Visualizer

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config_file", default="./configs/mvsec_indoor_no_timeaware.yaml",
                        help="Config file yaml path", type=str)
    parser.add_argument("--eval", help="Add for evaluation run", action="store_true")
    parser.add_argument("--device", default="cuda", type=str,
                        help="torch device of the solve (cuda runs the CUDA kernels; "
                             "cpu runs their plain versions)")
    parser.add_argument("--log", help="Log level: [debug, info, warning, error, critical]",
                        type=str, default="info")
    return parser.parse_args(argv)


def setup_output(save_dir: str, config_file=None, log_level=logging.INFO):
    os.makedirs(save_dir, exist_ok=True)
    if config_file:
        shutil.copy(config_file, save_dir)
    logging.basicConfig(
        handlers=[
            logging.FileHandler(os.path.join(save_dir, "main.log"), mode="w"),
            logging.StreamHandler(sys.stdout),
        ],
        level=log_level,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
        force=True,
    )


def build(config: dict, device, candidates_fn=None, visualize_module=None, mesh=None):
    """(loader, solver) for a validated config; the solver visualizes
    through ``visualize_module`` (None: no images).  The top-level
    ``parallel:`` block goes to the solver as ``solver.parallel`` (its
    device mesh, ``SolverBase._setup_parallel``); ``mesh``, a prebuilt
    ``parallel.Mesh`` (one that repeats a device, say), replaces it."""
    data_config = config["data"]
    loader = data.collections[data_config["dataset"]](config=data_config)
    loader.set_sequence(data_config["sequence"])
    if config.get("parallel"):
        config["solver"]["parallel"] = config["parallel"]
    kw = {} if mesh is None else {"mesh": mesh}
    solv = solver.collections[config["solver"]["method"]](
        (data_config["height"], data_config["width"]),
        calibration_parameter=loader.load_calib(),
        solver_config=config["solver"],
        optimizer_config=config["optimizer"],
        output_config=config["output"],
        visualize_module=visualize_module,
        device=device,
        candidates_fn=candidates_fn,
        **kw,
    )
    return loader, solv


def _optimization_batch(loader, data_config, ind1: int, ind2: int) -> np.ndarray:
    """Renormalize the window [ind1, ind2) to the fixed event count."""
    n_events = data_config["n_events_per_batch"]
    if ind2 - ind1 < n_events:
        insufficient = n_events - (ind2 - ind1)
        ind1 -= insufficient // 2
        ind2 += insufficient // 2
    elif ind2 - ind1 > n_events:
        ind1 = ind2 - n_events
    batch = loader.load_event(max(ind1, 0), min(ind2, len(loader)))
    batch[..., 2] -= np.min(batch[..., 2])
    if check_key_and_bool(data_config, "remove_car"):
        batch = crop_event(batch, 0, 193, 0, 346)
    return batch


def _gather_frame(loader, data_config, t1: float, t2: float):
    """One eval window: (optimization batch, the window's own events for
    the metrics, GT flow or None when the loader has none, window
    seconds).  The window's events are ``load_event(time_to_index(t1),
    time_to_index(t2))`` as they come, also where the first index is -1."""
    ind1 = loader.time_to_index(t1)
    ind2 = loader.time_to_index(t2)
    batch_for_gt_slice = loader.load_event(ind1, ind2)
    gt_flow = loader.load_optical_flow(t1, t2) if loader.gt_flow_available else None
    batch_for_gt_slice[..., 2] -= np.min(batch_for_gt_slice[..., 2])
    return _optimization_batch(loader, data_config, ind1, ind2), batch_for_gt_slice, gt_flow, t2 - t1


def _maybe_save_flow(save_flow, out_dir: str, solv, frame_index: int, best_motion, flow_time: float) -> None:
    """``output.save_flow`` (``dsec_png`` or ``npz``, None: off): the frame's
    displacement over its window, written next to the metrics."""
    if save_flow:
        save_flow_frame(out_dir, frame_index, solv.dense_displacement(best_motion, flow_time), save_flow)


def evaluate_dataset_with_gt(eval_frame_time_stamp_list, data_config, loader, solv, out_dir: str,
                             save_flow=None):
    """Sequential evaluation: per gray-frame window, a fixed-count event
    batch for the solve and the exact window's events for the metrics,
    warm start chaining (``data.warm_start``), per-frame checkpoint, the
    flow dump of ``save_flow`` (``output.save_flow``).  ``data.ind1``/``ind2``
    select the frame range (frames, as in the JAX CLI: the MVSEC configs'
    event indices select none).  Every ``data.visualize_every`` frames the
    solver writes the frame's images after its record.  Returns the
    per-frame records (frame, metrics, seconds, solver stats, and
    ``viz_seconds`` where images were written) of this run."""
    eval_dt = data_config["eval_dt"]
    warm_start = data_config.get("warm_start", True)
    start_frame, warm_motion = ckpt.load_eval_state(out_dir)
    if warm_motion is not None and warm_start:
        solv.set_previous_frame_best_estimation(warm_motion)
    logger.info(f"Evaluation pipeline, dt={eval_dt}, warm_start={warm_start}, from frame {start_frame}")
    viz_every = int(data_config.get("visualize_every", 1))
    records = []
    for i1 in range(start_frame, len(eval_frame_time_stamp_list) - eval_dt):
        logger.info(f"Frame {i1} of {len(eval_frame_time_stamp_list)}")
        if "ind1" in data_config and "ind2" in data_config:
            if i1 < data_config["ind1"] or i1 > data_config["ind2"]:
                continue
        t0 = time.perf_counter()
        batch_for_optimization, batch_for_gt_slice, gt_flow, flow_time = _gather_frame(
            loader, data_config, eval_frame_time_stamp_list[i1], eval_frame_time_stamp_list[i1 + eval_dt])
        best_motion, flow_error = solv.optimize_with_metrics(batch_for_optimization, gt_flow, flow_time,
                                                             batch_for_gt_slice)
        if warm_start:
            solv.set_previous_frame_best_estimation(best_motion)
        solv.save_flow_error_as_text(out_dir, i1, flow_error, "flow_error_per_frame_with_mask.txt")
        ckpt.append_frame_metrics(out_dir, i1, flow_error)
        _maybe_save_flow(save_flow, out_dir, solv, i1, best_motion, flow_time)
        ckpt.save_eval_state(out_dir, i1 + 1, to_numpy(best_motion) if warm_start else None)
        records.append(_record(i1, flow_error, time.perf_counter() - t0, solv.last_frame_stats))
        if viz_every and i1 % viz_every == 0:
            t_viz = time.perf_counter()
            solv.visualize_original_sequential(batch_for_gt_slice)
            solv.visualize_pred_sequential(batch_for_gt_slice, best_motion)
            solv.visualize_gt_sequential(batch_for_gt_slice, gt_flow)
            records[-1]["viz_seconds"] = time.perf_counter() - t_viz
    if solv.visualizer is not None:
        solv.visualizer.flush()
    return records


def _record(frame: int, metrics: dict, seconds: float, stats: dict) -> dict:
    logger.info(f"Frame {frame}: {seconds:.3f} s, {stats.get('syncs')} host syncs")
    return {"frame": frame, "metrics": metrics, "seconds": seconds, "stats": dict(stats)}


def evaluate_dataset_fwl_only(eval_frame_time_stamp_list, data_config, loader, solv, out_dir: str,
                              save_flow=None):
    """GT-free evaluation (ECD, the raw camera streams): per window of the
    loader's clock, the sequential loop's solve, warm start, checkpoint,
    flow dump and text/JSONL lines, with PRED_FWL (Var(IWE_orig) /
    Var(IWE_warped) of the predicted flow on the window's events; < 1 is
    better) as the metrics.  Every window is solved: ``data.ind1``/``ind2``
    are not read.  Images (original, pred_warp) every
    ``data.visualize_every`` windows.  Returns the per-frame records of
    this run."""
    eval_dt = data_config["eval_dt"]
    warm_start = data_config.get("warm_start", True)
    start_frame, warm_motion = ckpt.load_eval_state(out_dir)
    if warm_motion is not None and warm_start:
        solv.set_previous_frame_best_estimation(warm_motion)
    logger.info(f"FWL-only evaluation (no GT flow), dt={eval_dt}, warm_start={warm_start}, "
                f"from frame {start_frame}")
    viz_every = int(data_config.get("visualize_every", 1))
    records = []
    for i1 in range(start_frame, len(eval_frame_time_stamp_list) - eval_dt):
        logger.info(f"Frame {i1} of {len(eval_frame_time_stamp_list)}")
        t0 = time.perf_counter()
        batch_for_optimization, batch_for_metrics, _, flow_time = _gather_frame(
            loader, data_config, eval_frame_time_stamp_list[i1], eval_frame_time_stamp_list[i1 + eval_dt])
        best_motion = solv.profiled_optimize(batch_for_optimization)
        fwl = solv.calculate_fwl_pred(best_motion, batch_for_metrics, flow_time)
        if warm_start:
            solv.set_previous_frame_best_estimation(best_motion)
        solv.save_flow_error_as_text(out_dir, i1, fwl, "flow_error_per_frame_with_mask.txt")
        ckpt.append_frame_metrics(out_dir, i1, fwl)
        _maybe_save_flow(save_flow, out_dir, solv, i1, best_motion, flow_time)
        ckpt.save_eval_state(out_dir, i1 + 1, to_numpy(best_motion) if warm_start else None)
        records.append(_record(i1, fwl, time.perf_counter() - t0, solv.last_frame_stats))
        if viz_every and i1 % viz_every == 0:
            t_viz = time.perf_counter()
            solv.visualize_original_sequential(batch_for_metrics)
            solv.visualize_pred_sequential(batch_for_metrics, best_motion)
            records[-1]["viz_seconds"] = time.perf_counter() - t_viz
    if solv.visualizer is not None:
        solv.visualizer.flush()
    return records


def evaluate_dataset_fleet(eval_frame_time_stamp_list, data_config, loader, solv, out_dir: str,
                           fleet_batch: int, save_flow=None):
    """Fleet evaluation: from the checkpoint's frame on, every eval window in
    chunks of ``fleet_batch`` frames (the last chunk may be smaller), each
    chunk solved by one ``solv.optimize_batch``; per-frame metrics, text and
    ``eval_metrics.jsonl`` lines as the sequential loop writes them, the
    checkpoint once per chunk.  With ``data.warm_start: batch`` every frame
    of a chunk warm-starts from the previous chunk's last solution (the
    checkpoint keeps it, so a resumed run continues the chain); else the
    frames are independent.  A solver with a data mesh shards each chunk
    over its devices (``FleetPyramidalSolver._optimize_batch_sharded``).
    ``save_flow`` dumps each frame's flow.
    ``data.ind1``/``ind2`` are not read.  Returns
    the per-frame records (frame, metrics, the chunk's seconds / B, the
    chunk's solver stats)."""
    eval_dt = data_config["eval_dt"]
    batch_warm = data_config.get("warm_start") == "batch"
    start_frame, warm_motion = ckpt.load_eval_state(out_dir)
    if batch_warm and warm_motion is not None:
        solv.set_previous_frame_best_estimation(warm_motion)
    frames = list(range(start_frame, len(eval_frame_time_stamp_list) - eval_dt))
    logger.info(f"Fleet evaluation: {len(frames)} frames, batch {fleet_batch}, from frame {start_frame}"
                + (", batch warm start" if batch_warm else ""))
    records = []
    for chunk_start in range(0, len(frames), fleet_batch):
        chunk = frames[chunk_start : chunk_start + fleet_batch]
        t0 = time.perf_counter()
        gathered = [_gather_frame(loader, data_config, eval_frame_time_stamp_list[i],
                                  eval_frame_time_stamp_list[i + eval_dt]) for i in chunk]
        motions = solv.optimize_batch([g[0] for g in gathered])
        if batch_warm:
            # the next chunk's frames start from this chunk's last solution
            solv.set_previous_frame_best_estimation(motions[-1])
        errors = []
        for i1, (_, gt_slice, gt_flow, flow_time), best in zip(chunk, gathered, motions):
            flow_error = solv.calculate_flow_error(best, gt_flow, timescale=flow_time, events=gt_slice)
            solv.save_flow_error_as_text(out_dir, i1, flow_error, "flow_error_per_frame_with_mask.txt")
            ckpt.append_frame_metrics(out_dir, i1, flow_error)
            _maybe_save_flow(save_flow, out_dir, solv, i1, best, flow_time)
            errors.append(flow_error)
        ckpt.save_eval_state(out_dir, chunk[-1] + 1, to_numpy(motions[-1]) if batch_warm else None)
        seconds = (time.perf_counter() - t0) / len(chunk)
        stats = dict(solv.last_batch_stats)
        logger.info(f"Frames {chunk[0]}..{chunk[-1]}: {seconds:.3f} s per frame, {stats['syncs']} host syncs "
                    "for the batch")
        records.extend({"frame": i1, "metrics": e, "seconds": seconds, "stats": stats}
                       for i1, e in zip(chunk, errors))
    return records


def run_dnn(config: dict, eval_mode: bool, device) -> dict:
    """``is_dnn``: train EV-FlowNet on the loaded sequence (and evaluate it
    with ``--eval``), no solver built.  The network crops
    ``data.height``/``width`` to multiples of 16, as in the JAX package
    (whose CLI reads ``data.preprocess.crop`` only for its visualizer).
    Returns ``run_dnn_flow``'s result."""
    from .models.train import run_dnn_flow

    data_config = config["data"]
    loader = data.collections[data_config["dataset"]](config=data_config)
    loader.set_sequence(data_config["sequence"])
    return run_dnn_flow(config, loader, device, evaluate=eval_mode)


def run(config: dict, eval_mode: bool, device, candidates_fn=None, mesh=None):
    """What the CLI runs, after logging is set up: validate, build, solve
    (``is_dnn``: ``run_dnn``), visualize into ``output_dir``.  Returns the
    per-frame records (eval), the single-frame result, or the DNN run's.
    ``mesh``: a prebuilt device mesh for the solver (``build``)."""
    validate_config(config)
    logger.info(f"runtime: {fetch_runtime_info()}")
    set_numerics()
    if check_key_and_bool(config, "fix_random_seed"):
        fix_random_seed()
    data_config = config["data"]
    out_dir = config["output"]["output_dir"]
    os.makedirs(out_dir, exist_ok=True)
    if config.get("is_dnn"):
        return run_dnn(config, eval_mode, device)
    viz = Visualizer((data_config["height"], data_config["width"]), show=config["output"]["show_interactive_result"],
                     save=True, save_dir=out_dir, device=device)
    try:
        return _solve(config, eval_mode, device, candidates_fn, viz, mesh)
    finally:
        viz.close()


def _solve(config: dict, eval_mode: bool, device, candidates_fn, viz: Visualizer, mesh=None):
    """``run``'s solver paths: the eval loops, or single-frame mode."""
    data_config = config["data"]
    out_dir = config["output"]["output_dir"]
    loader, solv = build(config, device, candidates_fn, viz, mesh)
    if eval_mode:
        eval_ts = loader.eval_frame_time_list()
        fleet_batch = int(data_config.get("fleet_batch", 1))
        save_flow = config["output"].get("save_flow")
        if not loader.gt_flow_available:
            records = evaluate_dataset_fwl_only(eval_ts, data_config, loader, solv, out_dir, save_flow)
        elif fleet_batch > 1 and hasattr(solv, "optimize_batch"):
            if data_config.get("warm_start", True) not in (False, "batch"):
                raise ConfigError("data.fleet_batch > 1 needs data.warm_start: false (independent frames) "
                                  "or data.warm_start: batch (each batch from the previous batch's last "
                                  "solution)")
            records = evaluate_dataset_fleet(eval_ts, data_config, loader, solv, out_dir, fleet_batch, save_flow)
        else:
            records = evaluate_dataset_with_gt(eval_ts, data_config, loader, solv, out_dir, save_flow)
        summary = ckpt.summarize_metrics(out_dir)
        if summary:
            logger.info(f"Evaluation summary (mean over frames): {summary}")
        logger.info(f"Evaluation done! {data_config['sequence']}")
        return records

    ind1, ind2 = data_config["ind1"], data_config["ind2"]
    batch = loader.load_event(ind1, ind2)
    batch[..., 2] -= np.min(batch[..., 2])
    if check_key_and_bool(data_config, "remove_car"):
        batch = crop_event(batch, 0, 193, 0, 346)
    solv.visualize_one_batch_warp(batch)
    best_motion = solv.profiled_optimize(batch)
    solv.visualize_one_batch_warp(batch, best_motion)
    result = {"motion": to_numpy(best_motion)}
    if loader.gt_flow_available:
        t1 = loader.index_to_time(ind1)
        t2 = loader.index_to_time(ind2)
        result["flow_error"] = solv.calculate_flow_error(best_motion, loader.load_optical_flow(t1, t2), t2 - t1, batch)
    return result


def main(argv=None):
    args = parse_args(argv)
    with open(args.config_file, "r") as f:
        config = yaml.safe_load(f)
    log_level = getattr(logging, args.log.upper(), None)
    if not isinstance(log_level, int):
        raise ValueError(f"Invalid log level: {args.log}")
    setup_output(config["output"]["output_dir"], args.config_file, log_level)
    logger.info(f"torch {torch.__version__}, device {args.device}")
    run(config, args.eval, torch.device(args.device))


if __name__ == "__main__":
    main()
