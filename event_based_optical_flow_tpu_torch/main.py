"""CLI driver of the PyTorch port (the JAX package's ``main.py`` stays the
JAX driver):

    python -m event_based_optical_flow_tpu_torch.main --config_file configs/<cfg>.yaml \
        [--eval] [--device cuda|cpu] [--log LEVEL]

Reads the same YAML.  Single-frame mode optimizes the event slice
[data.ind1, data.ind2); ``--eval`` runs the sequential evaluation over the
gray-frame windows with GT flow (AEE/NPE/AE + FWL per frame) and writes
the same ``flow_error_per_frame_with_mask.txt``, ``eval_metrics.jsonl``
and ``eval_state.npz`` as the JAX CLI, so either CLI resumes the other's
run.  Visualization (PNGs) is not ported yet.
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
from .utils import check_key_and_bool, crop_event, set_numerics, fix_random_seed, validate_config
from .utils import checkpoint as ckpt

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


def build(config: dict, device, candidates_fn=None):
    """(loader, solver) for a validated config."""
    data_config = config["data"]
    loader = data.collections[data_config["dataset"]](config=data_config)
    loader.set_sequence(data_config["sequence"])
    solv = solver.collections[config["solver"]["method"]](
        (data_config["height"], data_config["width"]),
        calibration_parameter=loader.load_calib(),
        solver_config=config["solver"],
        optimizer_config=config["optimizer"],
        output_config=config["output"],
        device=device,
        candidates_fn=candidates_fn,
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


def evaluate_dataset_with_gt(eval_frame_time_stamp_list, data_config, loader, solv, out_dir: str):
    """Sequential evaluation: per gray-frame window, a fixed-count event
    batch for the solve and the exact window's events for the metrics,
    warm start chaining (``data.warm_start``), per-frame checkpoint.
    ``data.ind1``/``ind2`` select the frame range.  Returns the per-frame
    records (frame, metrics, seconds, solver stats) of this run."""
    eval_dt = data_config["eval_dt"]
    warm_start = data_config.get("warm_start", True)
    start_frame, warm_motion = ckpt.load_eval_state(out_dir)
    if warm_motion is not None and warm_start:
        solv.set_previous_frame_best_estimation(warm_motion)
    logger.info(f"Evaluation pipeline, dt={eval_dt}, warm_start={warm_start}, from frame {start_frame}")
    if int(data_config.get("visualize_every", 1)):
        logger.info("visualization is not ported yet: no PNGs are written")

    records = []
    for i1 in range(start_frame, len(eval_frame_time_stamp_list) - eval_dt):
        logger.info(f"Frame {i1} of {len(eval_frame_time_stamp_list)}")
        if "ind1" in data_config and "ind2" in data_config:
            if i1 < data_config["ind1"] or i1 > data_config["ind2"]:
                continue
        t0 = time.perf_counter()
        t1 = eval_frame_time_stamp_list[i1]
        t2 = eval_frame_time_stamp_list[i1 + eval_dt]
        ind1 = loader.time_to_index(t1)
        ind2 = loader.time_to_index(t2)
        batch_for_gt_slice = loader.load_event(ind1, ind2)
        gt_flow = loader.load_optical_flow(t1, t2)
        flow_time = t2 - t1
        batch_for_gt_slice[..., 2] -= np.min(batch_for_gt_slice[..., 2])
        batch_for_optimization = _optimization_batch(loader, data_config, ind1, ind2)

        best_motion = solv.optimize(batch_for_optimization)
        flow_error = solv.calculate_flow_error(
            best_motion, gt_flow, timescale=flow_time, events=batch_for_gt_slice
        )
        if warm_start:
            solv.set_previous_frame_best_estimation(best_motion)
        solv.save_flow_error_as_text(out_dir, i1, flow_error, "flow_error_per_frame_with_mask.txt")
        ckpt.append_frame_metrics(out_dir, i1, flow_error)
        ckpt.save_eval_state(out_dir, i1 + 1, to_numpy(best_motion) if warm_start else None)
        seconds = time.perf_counter() - t0
        stats = dict(solv.last_frame_stats)
        logger.info(f"Frame {i1}: {seconds:.3f} s, {stats.get('syncs')} host syncs")
        records.append({"frame": i1, "metrics": flow_error, "seconds": seconds, "stats": stats})
    return records


def run(config: dict, eval_mode: bool, device, candidates_fn=None):
    """What the CLI runs, after logging is set up: validate, build, solve.
    Returns the per-frame records (eval) or the single-frame result."""
    validate_config(config)
    set_numerics()
    if check_key_and_bool(config, "fix_random_seed"):
        fix_random_seed()
    data_config = config["data"]
    out_dir = config["output"]["output_dir"]
    os.makedirs(out_dir, exist_ok=True)
    loader, solv = build(config, device, candidates_fn)
    if eval_mode:
        records = evaluate_dataset_with_gt(loader.eval_frame_time_list(), data_config, loader, solv, out_dir)
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
    best_motion = solv.optimize(batch)
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
