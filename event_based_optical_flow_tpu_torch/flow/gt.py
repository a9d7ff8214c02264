"""Ground-truth flow handling for MVSEC-style datasets (host-side numpy;
port of ``event_based_optical_flow_tpu/flow/gt.py``).

The GT flow frames are displacements between GT timestamps; evaluating
over an arbitrary [start, end) window requires advecting a pixel grid
through the successive GT flows (protocol from daniilidis-group/EV-FlowNet;
behavioral parity with reference ``src/utils/flow_utils.py:763-857``).
This is per-frame I/O-adjacent work, so it stays on the host.
"""

from typing import Tuple

import numpy as np


def generate_dense_optical_flow(image_size: Tuple[int, int], max_val: int = 30) -> np.ndarray:
    """A uniform random ``[2, H, W]`` flow in [-max_val, max_val) for tests,
    drawn from numpy's global generator as the JAX package draws it (one
    ``np.random.seed`` gives both packages the same field)."""
    return np.random.uniform(-max_val, max_val, (2,) + tuple(image_size))


def _remap_nearest(src: np.ndarray, map_x: np.ndarray, map_y: np.ndarray) -> np.ndarray:
    """dst[i, j] = src[round(map_y[i,j]), round(map_x[i,j])], 0 outside.
    Matches cv2.remap(..., INTER_NEAREST) with constant border."""
    ry = np.rint(map_y).astype(np.int64)
    rx = np.rint(map_x).astype(np.int64)
    h, w = src.shape[:2]
    valid = (ry >= 0) & (ry < h) & (rx >= 0) & (rx < w)
    out = np.zeros_like(src, shape=map_x.shape)
    out[valid] = src[ry[valid], rx[valid]]
    return out


def prop_flow(x_flow, y_flow, x_indices, y_indices, x_mask, y_mask, scale_factor=1.0):
    """Advect the index grids by one GT flow frame, in place
    (ref flow_utils.py:842-857)."""
    flow_x_interp = _remap_nearest(x_flow, x_indices, y_indices)
    flow_y_interp = _remap_nearest(y_flow, x_indices, y_indices)
    x_mask[flow_x_interp == 0] = False
    y_mask[flow_y_interp == 0] = False
    x_indices += flow_x_interp * scale_factor
    y_indices += flow_y_interp * scale_factor


def estimate_corresponding_gt_flow(x_flow_in, y_flow_in, gt_timestamps, start_time, end_time):
    """GT displacement between start_time and end_time
    (ref flow_utils.py:763-839).  Returns (x_disp, y_disp)."""
    gt_iter = np.searchsorted(gt_timestamps, start_time, side="right") - 1
    gt_dt = gt_timestamps[gt_iter + 1] - gt_timestamps[gt_iter]
    x_flow = np.squeeze(x_flow_in[gt_iter, ...])
    y_flow = np.squeeze(y_flow_in[gt_iter, ...])
    dt = end_time - start_time

    if gt_dt >= dt:
        return x_flow * dt / gt_dt, y_flow * dt / gt_dt

    x_indices, y_indices = np.meshgrid(
        np.arange(x_flow.shape[1]), np.arange(x_flow.shape[0])
    )
    x_indices = x_indices.astype(np.float32)
    y_indices = y_indices.astype(np.float32)
    orig_x_indices = np.copy(x_indices)
    orig_y_indices = np.copy(y_indices)
    x_mask = np.ones(x_indices.shape, dtype=bool)
    y_mask = np.ones(y_indices.shape, dtype=bool)

    scale_factor = (gt_timestamps[gt_iter + 1] - start_time) / gt_dt
    prop_flow(x_flow, y_flow, x_indices, y_indices, x_mask, y_mask, scale_factor=scale_factor)

    gt_iter += 1
    while gt_timestamps[gt_iter + 1] < end_time:
        x_flow = np.squeeze(x_flow_in[gt_iter, ...])
        y_flow = np.squeeze(y_flow_in[gt_iter, ...])
        prop_flow(x_flow, y_flow, x_indices, y_indices, x_mask, y_mask)
        gt_iter += 1

    final_dt = end_time - gt_timestamps[gt_iter]
    final_gt_dt = gt_timestamps[gt_iter + 1] - gt_timestamps[gt_iter]
    x_flow = np.squeeze(x_flow_in[gt_iter, ...])
    y_flow = np.squeeze(y_flow_in[gt_iter, ...])
    prop_flow(x_flow, y_flow, x_indices, y_indices, x_mask, y_mask, final_dt / final_gt_dt)

    x_shift = x_indices - orig_x_indices
    y_shift = y_indices - orig_y_indices
    x_shift[~x_mask] = 0
    y_shift[~y_mask] = 0
    return x_shift, y_shift
