"""Core data types (port of ``event_based_optical_flow_tpu/types.py``).

Events are plain ``[n, 4]`` float arrays ``(x, y, t, p)`` where ``x`` is the
*height* coordinate and ``y`` the *width* coordinate.

Variable-length event slices may be carried as a fixed-size buffer plus a
``{0,1}`` weight mask (``pad_events``); every op and kernel of the port
accepts the mask and padded entries contribute nothing.  Host-side numpy,
identical to the JAX package so both pad to the same layout.
"""

import copy
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class FlowPatch:
    """One tile of the patch grid: center coordinates, shape, flow value.

    Mirrors the reference dataclass (reference ``src/types/flow_patch.py:8-60``)
    so that solver tiling semantics (x_min/x_max rounding) are identical.
    """

    x: float  # center, height direction
    y: float  # center, width direction
    shape: Tuple[int, int]  # (height, width)
    u: float = 0.0
    v: float = 0.0

    @property
    def h(self) -> int:
        return self.shape[0]

    @property
    def w(self) -> int:
        return self.shape[1]

    @property
    def x_min(self) -> int:
        return int(self.x - np.ceil(self.h / 2))

    @property
    def x_max(self) -> int:
        return int(self.x + np.floor(self.h / 2))

    @property
    def y_min(self) -> int:
        return int(self.y - np.ceil(self.w / 2))

    @property
    def y_max(self) -> int:
        return int(self.y + np.floor(self.w / 2))

    @property
    def position(self) -> np.ndarray:
        return np.array([self.x, self.y])

    @property
    def flow(self) -> np.ndarray:
        return np.array([self.u, self.v])

    def update_flow(self, u: float, v: float) -> None:
        self.u = u
        self.v = v

    def copy(self) -> "FlowPatch":
        return copy.deepcopy(self)


def pad_events(
    events: np.ndarray,
    target_n: Optional[int] = None,
    bucket: int = 4096,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a variable-length event array to a static size with a weight mask.

    Padded rows get ``(0, 0, t_min, 0)`` so that time min/max statistics of
    the batch are unchanged and gather indices stay in-bounds; their weight
    is zero so they contribute nothing to any IWE.

    Returns:
        (padded_events [N, 4], weights [N]) with N = target_n or the next
        multiple of ``bucket``.
    """
    n = len(events)
    if target_n is None:
        target_n = max(bucket, ((n + bucket - 1) // bucket) * bucket)
    if n > target_n:
        raise ValueError(f"{n} events exceed target size {target_n}")
    t_min = float(events[:, 2].min()) if n else 0.0
    padded = np.zeros((target_n, 4), dtype=events.dtype)
    padded[:n] = events
    padded[n:, 2] = t_min
    weights = np.zeros(target_n, dtype=events.dtype)
    weights[:n] = 1.0
    return padded, weights
