"""Checkpoint / resume for the sequential evaluation loop (port of
``event_based_optical_flow_tpu/utils/checkpoint.py``, same file layout).

The loop persists its state after every frame — next frame index, the
warm-start motion per pyramid scale, and accumulated per-frame metrics —
so ``--eval`` runs resume exactly where they stopped.  The ``.npz`` layout
is shared with the JAX CLI: a run begun by either CLI resumes in the
other (``state.from_jax`` / ``state.to_numpy`` convert the motion).
"""

import json
import logging
import os
from typing import Any, Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)

STATE_FILE = "eval_state.npz"
METRICS_FILE = "eval_metrics.jsonl"


def _flatten_motion(motion) -> Dict[str, np.ndarray]:
    if motion is None:
        return {}
    if isinstance(motion, dict):
        return {f"scale_{k}": np.asarray(v) for k, v in motion.items()}
    return {"array": np.asarray(motion)}


def _unflatten_motion(arrays: Dict[str, np.ndarray]):
    if not arrays:
        return None
    if "array" in arrays:
        return arrays["array"]
    return {int(k.split("_", 1)[1]): v for k, v in arrays.items()}


def save_eval_state(out_dir: str, next_frame: int, warm_start_motion=None) -> None:
    path = os.path.join(out_dir, STATE_FILE)
    np.savez(path, __next_frame=np.asarray(next_frame), **_flatten_motion(warm_start_motion))


def load_eval_state(out_dir: str):
    """Returns (next_frame, warm_start_motion) or (0, None)."""
    path = os.path.join(out_dir, STATE_FILE)
    if not os.path.exists(path):
        return 0, None
    data = dict(np.load(path))
    next_frame = int(data.pop("__next_frame"))
    logger.info(f"Resuming evaluation from frame {next_frame}")
    return next_frame, _unflatten_motion(data)


def append_frame_metrics(out_dir: str, frame: int, metrics: Dict[str, Any]) -> None:
    path = os.path.join(out_dir, METRICS_FILE)
    record = {"frame": frame}
    record.update({k: float(v) for k, v in metrics.items()})
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")


def summarize_metrics(out_dir: str) -> Optional[Dict[str, float]]:
    """Mean of each metric over all completed frames."""
    path = os.path.join(out_dir, METRICS_FILE)
    if not os.path.exists(path):
        return None
    rows = [json.loads(line) for line in open(path)]
    if not rows:
        return None
    # a crash between the metric append and the state save can re-emit a
    # frame after resume: keep the last record per frame index
    rows = list({r["frame"]: r for r in rows}.values())
    keys = [k for k in rows[0] if k != "frame"]
    return {k: float(np.mean([r[k] for r in rows if k in r])) for k in keys}
