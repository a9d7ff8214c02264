"""The solver's carried state: the per-scale warm-start motion
``{scale: [2, h_s, w_s]}`` (a single-scale solver's: one motion array).

The JAX package keeps it as float64 numpy arrays and checkpoints it in
``eval_state.npz`` (``utils/checkpoint.py``, keys ``scale_<s>``); the port
keeps it as tensors on the solver's device.  These two functions convert
between the layouts, so a run begun by either CLI resumes in the other.
"""

from typing import Dict

import numpy as np
import torch

MotionState = Dict[int, torch.Tensor]


def from_jax(motion_by_scale: Dict[int, np.ndarray], device, dtype) -> MotionState:
    """The JAX layout (dict of numpy arrays, e.g. from
    ``checkpoint.load_eval_state``) -> the port's state on ``device``."""
    return {
        int(s): torch.as_tensor(np.asarray(m, dtype=np.float64), device=device).to(dtype)
        for s, m in motion_by_scale.items()
    }


def to_numpy(state):
    """The port's state -> the JAX layout (float64 numpy arrays): a dict per
    scale, or one array for a single-scale solver's motion (a tensor, or
    the global solver's host array)."""
    if torch.is_tensor(state):
        return state.detach().to("cpu", torch.float64).numpy()
    if isinstance(state, np.ndarray):
        return np.asarray(state, dtype=np.float64)
    return {int(s): m.detach().to("cpu", torch.float64).numpy() for s, m in state.items()}
