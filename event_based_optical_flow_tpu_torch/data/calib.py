"""ECD-style calibration files (port of ``event_based_optical_flow_tpu/data/calib.py``;
the ECD, EVT2 and EVT3 loaders read them): a whitespace text file with

    fx fy cx cy [k1 k2 p1 p2 k3]

Distortion coefficients are optional and may be partial; missing ones
are zero-filled with a warning (a silently dropped k1 turns undistortion
into a no-op)."""

import logging

import numpy as np

logger = logging.getLogger(__name__)


def load_ecd_calib_file(path: str) -> dict:
    """Parse ``path`` into {"K": [3,3], "D": [5]}.  Raises ValueError on
    fewer than the 4 required intrinsics."""
    vals = np.loadtxt(path).reshape(-1)
    if len(vals) < 4:
        raise ValueError(
            f"{path}: calibration needs at least fx fy cx cy (got {len(vals)} values)"
        )
    K = np.array([[vals[0], 0, vals[2]], [0, vals[1], vals[3]], [0, 0, 1.0]])
    D = np.zeros(5)
    n_dist = min(len(vals) - 4, 5)
    D[:n_dist] = vals[4 : 4 + n_dist]
    if 0 < n_dist < 5:
        logger.warning(
            f"{path}: {n_dist}/5 distortion coefficients provided; the "
            f"remaining {5 - n_dist} are zero-filled"
        )
    return {"K": K, "D": D}
