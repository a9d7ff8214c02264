"""What decides ``correct``: the timed path's answers for every frame it
solved in the window, held to the answers of the cell's reference at the
same motion.

Each configuration names its reference: ``"reference": "<module>"`` in
its file picks ``reference/<module>.py``, and a file without the key is
judged by ``plain.py`` (``cells.reference`` finds it by path, before
set-up).  A reference module keeps this contract and needs nothing else:

* ``reference_answers(answers, stream, scene, config, device, tf32=False)``
  returns one ``(loss, AEE, zero-flow AEE, descent gain)`` per answer
  (``Answer``), worked out from the stream, the scene's ground truth and
  the port's config, in float64; with ``tf32`` the control's answers
  (the step below the configuration's precision) take the program's
  place;
* ``LIMITS`` holds exactly the four numbers below, each a finite limit,
  set from that reference's own readings of sound runs, of its control
  and of the planted faults (``control.py``), which ``PERF.md`` records.

For each frame the program gives its finest-scale tile motion, the
objective value its solver reported there and the AEE its eval loop
reported.  ``numbers`` compares them with the reference's:

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

``LIMITS`` and ``reference_answers`` here are the plain reference's.
"""

from dataclasses import dataclass

import numpy as np
import torch

from .plain import LIMITS, reference_answers  # noqa: F401 (the plain reference's, by their old names)


@dataclass
class Answer:
    """One frame's answers: the eval window [t1, t2] of the stream, the
    finest tile motion [2, h, w], the objective value there and the AEE."""

    t1: float
    t2: float
    motion: torch.Tensor
    loss: float
    aee: float


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


def verdict(values: dict, limits: dict) -> bool:
    """Every number finite and within its limit in ``limits`` (the cell's
    reference's ``LIMITS``)."""
    return all(np.isfinite(values[k]) and values[k] <= limits[k] for k in limits)
