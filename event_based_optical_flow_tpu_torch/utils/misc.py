"""Misc helpers (port of ``event_based_optical_flow_tpu/utils/misc.py`` and
the host-side ``crop_event`` of ``utils/events.py``)."""

import random

import numpy as np
import torch


def fix_random_seed(seed: int = 46) -> None:
    """Fix host RNG seeds (same seed as the JAX package).  Device
    randomness in the port is explicit: each solver owns a seeded
    ``torch.Generator``."""
    random.seed(seed)
    np.random.seed(seed)


def check_key_and_bool(config: dict, key: str) -> bool:
    """True iff key exists and is truthy."""
    return key in config and bool(config[key])


def check_file_utils(path: str) -> bool:
    import os

    return os.path.exists(path)


def crop_event(events: np.ndarray, x0, x1, y0, y1) -> np.ndarray:
    """Boolean-filter host events to [x0,x1) x [y0,y1)."""
    mask = (
        (x0 <= events[..., 0])
        & (events[..., 0] < x1)
        & (y0 <= events[..., 1])
        & (events[..., 1] < y1)
    )
    return events[mask]


def set_numerics() -> None:
    """The port's numerics, set at its entry points.

    * Full float32 in matmuls and convolutions: the port's stencils are
      shifted-slice sums (no conv), but any library matmul or convolution
      a later layer adds must not silently drop to TF32's ~3 decimal
      digits.
    * Deterministic algorithms: PyTorch's scatter adds (the init sweep's
      votes, the backward of ``index_select``) then sum in a fixed order,
      as the fused kernel does, so a solve on the GPU gives the same bits
      on every run.  Without this, float atomics reorder sums from run to
      run, and the finite-difference Hessian of Newton-CG turns those last
      bits into different iterates.  Uninitialized memory is not filled:
      the port reads none.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
