"""What decides ``correct``: the timed path's answers for every frame it
solved in the window, held to the plain reference's at the same motion.

For each frame the program gives its finest-scale tile motion, the
objective value its solver reported there and the AEE its eval loop
reported.  The reference works out the frame's window from the stream,
the dense flow, the objective at that motion and the AEE against the
scene's exact ground truth, and compares (``numbers``):

* ``loss_gap``: the largest relative gap between the program's objective
  value and the reference's, over the frames (the warp, vote, blur and
  hybrid cost with its TV term, on the window's optimization batch);
* ``aee_gap``: the largest relative gap between the program's AEE and the
  reference's (the tile-to-dense interpolation and the masked metric);
* ``aee_share``: the reference's AEE of the program's flows over the
  zero flow's, summed over the frames (a solve that does not move its
  start, or that solves the wrong frames, reads near or above 1);
* ``descent_gain``: the mean over the frames of the share of the cost
  that one plain steepest-descent step still removes from the program's
  motion (``plain.descent_gain``): a solve that stopped short of its
  minimum, as the init sweeps alone do, reads more than a converged one.

``LIMITS`` holds each number's limit; ``PERF.md`` gives the readings each
was set from.
"""

from dataclasses import dataclass

import numpy as np
import torch

from . import plain

# each number's limit: above the largest reading of sound runs, below the
# control's (TF32) and the planted faults' smallest readings (PERF.md)
LIMITS = {"loss_gap": 5e-6, "aee_gap": 2e-6, "aee_share": 0.8, "descent_gain": 6.5e-4}


@dataclass
class Answer:
    """One frame's answers: the eval window [t1, t2] of the stream, the
    finest tile motion [2, h, w], the objective value there and the AEE."""

    t1: float
    t2: float
    motion: torch.Tensor
    loss: float
    aee: float


def reference_answers(answers, stream: np.ndarray, scene, config: dict, device, tf32: bool = False) -> list:
    """The reference's (loss, AEE, zero-flow AEE, descent gain) of each
    frame at the program's motion: float64, or the control's TF32 products
    (``tf32``; no descent gain, NaN).  ``scene.load_optical_flow`` gives
    the ground truth."""
    lin = plain.Linear(tf32, device)
    objective = plain.Objective(config, lin)
    n_events = int(config["data"]["n_events_per_batch"])
    out = []
    for a in answers:
        batch, metric = plain.window(stream, a.t1, a.t2, n_events)
        motion = a.motion.to(device=lin.device, dtype=torch.float64)
        mask = plain.event_mask(metric, objective.shape, lin.device)
        gt = scene.load_optical_flow(a.t1, a.t2)
        pred = plain.dense_displacement(objective, motion, a.t2 - a.t1)
        ev = objective.prepare(batch)
        loss = float(objective.value(ev, motion))
        gain = float("nan") if tf32 else plain.descent_gain(objective, ev, motion)
        out.append((loss, plain.aee(gt, pred, mask), plain.aee(gt, None, mask), gain))
    return out


def numbers(losses, aees, reference) -> dict:
    """The compared numbers of answers (``losses``, ``aees`` per frame)
    against the reference's ``(loss, AEE, zero-flow AEE, descent gain)``
    per frame."""
    ref = np.asarray(reference, dtype=np.float64).reshape(-1, 4)
    loss_gap = np.max(np.abs(np.asarray(losses, dtype=np.float64) - ref[:, 0]) / np.abs(ref[:, 0]))
    aee_gap = np.max(np.abs(np.asarray(aees, dtype=np.float64) - ref[:, 1]) / ref[:, 1])  # NaN stays NaN
    share = ref[:, 1].sum() / ref[:, 2].sum()
    return {"loss_gap": float(loss_gap), "aee_gap": float(aee_gap), "aee_share": float(share),
            "descent_gain": float(ref[:, 3].mean())}


def verdict(values: dict) -> bool:
    """Every number finite and within its limit."""
    return all(np.isfinite(values[k]) and values[k] <= LIMITS[k] for k in LIMITS)
