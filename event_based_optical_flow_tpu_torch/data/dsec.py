"""DSEC dataset loader (port of ``event_based_optical_flow_tpu/data/dsec.py``).

Layout (the public DSEC distribution):
    <root>/<sequence>/events/left/events.h5      events/{x,y,t,p}, t_offset
    <root>/<sequence>/flow/forward/<NNNNNN>.png  16-bit GT flow (x*128+2^15, y*128+2^15, valid)
    <root>/<sequence>/flow/forward_timestamps.txt  "from_ts, to_ts" per line (us)

Events come out in the port's convention: [n, 4] with x = height
coordinate, y = width, t in seconds (``t_offset`` added), p in {-1, 1}.
GT flow is the pixel displacement over its window; the flow windows are
the eval clock.
"""

import logging
import os

import numpy as np

from ..flow.io import read_png16
from .base import DataLoaderBase

logger = logging.getLogger(__name__)


class DsecDataLoader(DataLoaderBase):
    NAME = "DSEC"

    def set_sequence(self, sequence_name: str, undistort: bool = False) -> None:
        import h5py

        logger.info(f"Use DSEC sequence {sequence_name}")
        self.sequence_name = sequence_name
        self.dataset_files = self.get_sequence(sequence_name)
        self._h5 = h5py.File(self.dataset_files["event"], "r")
        self._ev = self._h5["events"]
        self.t_offset = float(self._h5["t_offset"][()]) if "t_offset" in self._h5 else 0.0
        self._n = self._ev["t"].shape[0]

        ts_file = self.dataset_files["flow_timestamps"]
        if self.gt_flow_available and os.path.exists(ts_file):
            raw = np.loadtxt(ts_file, delimiter=",", comments="#")
            self.flow_windows_us = raw.reshape(-1, 2)
            flow_dir = self.dataset_files["flow_dir"]
            self.flow_files = sorted(
                os.path.join(flow_dir, f) for f in os.listdir(flow_dir) if f.endswith(".png")
            )
        else:
            self.gt_flow_available = False
            self.flow_windows_us = np.zeros((0, 2))
            self.flow_files = []

    def get_sequence(self, sequence_name: str) -> dict:
        seq = os.path.join(self.root_dir, sequence_name)
        return {
            "event": os.path.join(seq, "events", "left", "events.h5"),
            "flow_dir": os.path.join(seq, "flow", "forward"),
            "flow_timestamps": os.path.join(seq, "flow", "forward_timestamps.txt"),
        }

    def __len__(self):
        return self._n

    def load_event(self, start_index: int, end_index: int, cam: str = "left") -> np.ndarray:
        x = np.asarray(self._ev["x"][start_index:end_index], dtype=np.float64)  # width coord
        y = np.asarray(self._ev["y"][start_index:end_index], dtype=np.float64)  # height coord
        t = np.asarray(self._ev["t"][start_index:end_index], dtype=np.float64)  # us
        p = np.asarray(self._ev["p"][start_index:end_index], dtype=np.float64)
        return np.stack([y, x, (t + self.t_offset) * 1e-6, np.where(p > 0, 1.0, -1.0)], axis=1)

    def index_to_time(self, index: int) -> float:
        return float(self._ev["t"][min(index, self._n - 1)] + self.t_offset) * 1e-6

    def time_to_index(self, time: float) -> int:
        """searchsorted - 1 as a binary search over the file's sorted us
        timestamps, reading one timestamp per step."""
        us = time * 1e6 - self.t_offset
        lo, hi = 0, self._n
        while lo < hi:
            mid = (lo + hi) // 2
            if float(self._ev["t"][mid]) < us:
                lo = mid + 1
            else:
                hi = mid
        return lo - 1

    def eval_frame_time_list(self):
        """The flow windows' start times and the last window's end (s)."""
        starts = self.flow_windows_us[:, 0] * 1e-6
        ends = self.flow_windows_us[-1:, 1] * 1e-6 if len(self.flow_windows_us) else []
        return np.concatenate([starts, ends]) if len(self.flow_windows_us) else starts

    def gt_time_list(self):
        return self.flow_windows_us * 1e-6

    def load_optical_flow(self, t1: float, t2: float) -> np.ndarray:
        """GT displacement of the flow window starting nearest t1: [H, W, 2]
        with (height, width) components; invalid pixels inf, which the
        metrics mask out (a 0.0 fill would pass for a zero flow)."""
        starts = self.flow_windows_us[:, 0] * 1e-6
        idx = int(np.argmin(np.abs(starts - t1)))
        img = read_png16(self.flow_files[idx])
        flow_x = (img[..., 0] - 2**15) / 128.0  # width direction
        flow_y = (img[..., 1] - 2**15) / 128.0  # height direction
        valid = img[..., 2] > 0
        flow = np.stack([flow_y, flow_x], axis=2)
        flow[~valid] = np.inf
        return flow

    def load_calib(self) -> dict:
        return {}
