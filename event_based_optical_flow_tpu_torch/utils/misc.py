"""Misc helpers (port of ``event_based_optical_flow_tpu/utils/misc.py``)."""

import contextlib
import os
import random
import subprocess
from typing import Dict, Optional

import numpy as np
import torch

from .tracing import timed


def fix_random_seed(seed: int = 46) -> None:
    """Fix host RNG seeds (same seed as the JAX package).  Device
    randomness in the port is explicit: each solver owns a seeded
    ``torch.Generator``."""
    random.seed(seed)
    np.random.seed(seed)


def fetch_runtime_info() -> dict:
    """Reproducibility stamp for the run log: the checkout's git commit
    ("unknown" outside a git checkout), torch's version and, when CUDA is
    available, the device's name."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        commit = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True, timeout=10,
                                cwd=root).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        commit = "unknown"
    info = {"git_commit": commit, "torch": torch.__version__}
    if torch.cuda.is_available():
        info["device"] = torch.cuda.get_device_name(0)
    return info


def check_key_and_bool(config: dict, key: str) -> bool:
    """True iff key exists and is truthy."""
    return key in config and bool(config[key])


def check_file_utils(path: str) -> bool:
    import os

    return os.path.exists(path)


def set_numerics() -> None:
    """The port's numerics, set at its entry points.

    * Full float32 in matmuls and convolutions: the port's stencils are
      shifted-slice sums (no conv), but any library matmul or convolution
      a later layer adds must not silently drop to TF32's ~3 decimal
      digits.
    * Deterministic algorithms: PyTorch's scatter adds (the init sweep's
      votes, the time-aware voxel's ``index_select`` shifts' backward)
      then sum in a fixed order, as the fused kernel does, so a solve on
      the GPU gives the same bits on every run.  Without this, float
      atomics reorder sums from run to run, and the finite-difference
      Hessian of Newton-CG turns those last bits into different iterates.
      The objective chain's static gathers (the blur's and the tile map's
      pads, the tile map's upsample) are slices (``ops.blur.take``), whose
      backward needs neither atomics nor the sort that deterministic
      ``index_select`` backward takes.  Uninitialized memory is not
      filled: the port reads none.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False


_TIMINGS: Dict[str, list] = {}


@contextlib.contextmanager
def profile_section(name: str, timings: Optional[Dict[str, list]] = None):
    """Wall-clock section timer on the host, a span of ``utils.tracing``
    (recorded there while a profiler records): appends the seconds the
    block took to ``timings[name]`` (a module-wide store by default) for
    ``timing_report``.  It does not synchronize the device: CUDA work the
    block queued but that has not finished is not counted (call
    ``torch.cuda.synchronize()`` inside the block to count it)."""
    store = _TIMINGS if timings is None else timings
    section = timed(name)
    try:
        with section:
            yield
    finally:
        store.setdefault(name, []).append(section.seconds)


def timing_report(timings: Optional[Dict[str, list]] = None) -> str:
    """One line per section, sorted by name: count, total and mean (the
    JAX package's format)."""
    store = _TIMINGS if timings is None else timings
    return "\n".join(f"{name}: n={len(vals)} total={sum(vals):.3f}s mean={sum(vals) / len(vals) * 1e3:.1f}ms"
                     for name, vals in sorted(store.items()))


def clear_timings() -> None:
    _TIMINGS.clear()
