"""Event-array utilities (port of ``event_based_optical_flow_tpu/utils/events.py``):
host numpy, and torch tensors where the JAX module takes ``jnp`` arrays.

Events are ``[n, 4] = (x=height, y=width, t, p)``.
"""

import numpy as np
import torch


def generate_events(
    n_events: int,
    height: int,
    width: int,
    tmin: float = 0.0,
    tmax: float = 0.5,
    dist: str = "uniform",
) -> np.ndarray:
    """Random synthetic events [n, 4] = (x, y, t, p) from numpy's global
    generator; x is the height coordinate, t sorted."""
    x = np.random.randint(0, height, n_events)
    y = np.random.randint(0, width, n_events)
    t = np.sort(np.random.uniform(tmin, tmax, n_events))
    p = np.random.randint(0, 2, n_events)
    return np.stack([x, y, t, p], axis=1).astype(np.float64)


def crop_event_mask(events, x0, x1, y0, y1):
    """Whether each event lies in [x0,x1) x [y0,y1) (numpy or torch)."""
    return (
        (x0 <= events[..., 0])
        & (events[..., 0] < x1)
        & (y0 <= events[..., 1])
        & (events[..., 1] < y1)
    )


def crop_event(events, x0, x1, y0, y1):
    """Boolean-filter events to [x0,x1) x [y0,y1)."""
    return events[crop_event_mask(events, x0, x1, y0, y1)]


def set_event_origin_to_zero(events, x0, y0, t0: float = 0.0):
    """Shift event origins by (x0, y0, t0); numpy in, numpy out, a tensor
    in, a tensor of its dtype and device out."""
    basis = np.array([x0, y0, t0, 0.0])
    if isinstance(events, np.ndarray):
        return events - basis
    return events - torch.as_tensor(basis, dtype=events.dtype, device=events.device)


def undistort_events(events: np.ndarray, map_x: np.ndarray, map_y: np.ndarray, h: int, w: int) -> np.ndarray:
    """Rectify events through precomputed maps ([h, w] each: the rectified
    width and height coordinate of every raw pixel), truncated to int32,
    dropping events that land outside the frame."""
    k = np.int32(map_y[events[:, 0].astype(np.int32), events[:, 1].astype(np.int32)])
    l = np.int32(map_x[events[:, 0].astype(np.int32), events[:, 1].astype(np.int32)])
    out = np.copy(events)
    out[:, 0] = k
    out[:, 1] = l
    return out[((0 <= k) & (k < h)) & ((0 <= l) & (l < w))]
