"""MVSEC dataset loader (port of ``event_based_optical_flow_tpu/data/mvsec.py``).

Reads the ``<sequence>_data.hdf5`` event stream (held as int16, as the
JAX package holds it) and the ``<sequence>_gt_flow_dist.npz`` ground
truth.  The file's event columns are (x=width, y=height, t, p); they are
swapped so that ``events[:, 0]`` is the height coordinate.  The
per-sequence valid GT frame ranges are those of the original reference.

Layout under ``data.root`` (and ``data.gt`` for the GT):
    <root>/<sequence>_data.hdf5          davis/left/events [n, 4], davis/left/image_raw_ts,
                                         davis/right/events
    <root>/<sequence minus its last character>_left_{x,y}_map.txt   rectify maps (undistort)
    <gt>/<sequence>_gt_flow_dist.npz     timestamps, x_flow_dist, y_flow_dist
"""

import logging
import os

import numpy as np

from ..flow.gt import estimate_corresponding_gt_flow
from ..utils.events import undistort_events
from .base import DataLoaderBase

logger = logging.getLogger(__name__)

_VALID_FRAMES = {
    "indoor_flying1": (60, 1340),
    "indoor_flying2": (140, 1500),
    "indoor_flying3": (100, 1711),
    "indoor_flying4": (104, 380),
    "outdoor_day1": (0, 5020),
    "outdoor_day2": (30, None),
}


def h5py_loader(path: str):
    """(timestamps per camera, left {event int16 [n, 4], gray_ts}, right
    {event}) of an MVSEC ``_data.hdf5`` file."""
    import h5py

    data = h5py.File(path, "r")
    ts = {
        "left": np.array(data["davis"]["left"]["events"][:, 2]),
        "right": np.array(data["davis"]["right"]["events"][:, 2]),
    }
    left = {
        "event": np.array(data["davis"]["left"]["events"], dtype=np.int16),
        "gray_ts": np.array(data["davis"]["left"]["image_raw_ts"], dtype=np.float64),
    }
    right = {"event": np.array(data["davis"]["right"]["events"], dtype=np.int16)}
    data.close()
    return ts, left, right


class MvsecDataLoader(DataLoaderBase):
    NAME = "MVSEC"

    def set_sequence(self, sequence_name: str, undistort: bool = False) -> None:
        logger.info(f"Use sequence {sequence_name}")
        self.sequence_name = sequence_name
        self.dataset_files = self.get_sequence(sequence_name)
        ts, l_event, _ = h5py_loader(self.dataset_files["event"])
        self.left_event = l_event["event"]
        self.left_ts = ts["left"]
        self.left_gray_ts = l_event["gray_ts"]

        if self.gt_flow_available:
            self.setup_gt_flow(os.path.join(self.gt_flow_dir, sequence_name))
            self.omit_invalid_data(sequence_name)

        self.undistort = undistort
        if self.undistort:
            self.calib_map_x, self.calib_map_y = self.get_calib_map(
                self.dataset_files["calib_map_x"], self.dataset_files["calib_map_y"]
            )
        self.min_ts = self.left_ts.min()
        self.max_ts = self.left_ts.max()
        self.data_duration = self.max_ts - self.min_ts

    def get_sequence(self, sequence_name: str) -> dict:
        data_path = os.path.join(self.root_dir, sequence_name)
        return {
            "event": data_path + "_data.hdf5",
            "calib_map_x": data_path[:-1] + "_left_x_map.txt",
            "calib_map_y": data_path[:-1] + "_left_y_map.txt",
        }

    def setup_gt_flow(self, path):
        path = path + "_gt_flow_dist.npz"
        logger.info(f"Loading ground truth flow {path}")
        gt = np.load(path)
        self.gt_timestamps = gt["timestamps"]
        self.U_gt_all = gt["x_flow_dist"]
        self.V_gt_all = gt["y_flow_dist"]

    def free_up_flow(self):
        del self.gt_timestamps, self.U_gt_all, self.V_gt_all

    def omit_invalid_data(self, sequence_name: str):
        """Keep the sequence's valid GT frames and the events and gray
        frames inside their time span."""
        first, last = 0, -1
        for key, (f, l) in _VALID_FRAMES.items():
            if key in sequence_name:
                first = f
                last = l if l is not None else -1
                break
        self.gt_timestamps = self.gt_timestamps[first:last]
        self.U_gt_all = self.U_gt_all[first:last]
        self.V_gt_all = self.V_gt_all[first:last]

        first_ev = self.time_to_index(self.gt_timestamps[0])
        last_ev = self.time_to_index(self.gt_timestamps[-1])
        self.left_event = self.left_event[first_ev:last_ev]
        self.left_ts = self.left_ts[first_ev:last_ev]
        self.min_ts = self.left_ts.min()
        self.max_ts = self.left_ts.max()
        self.left_gray_ts = self.left_gray_ts[
            (self.gt_timestamps[0] < self.left_gray_ts) & (self.gt_timestamps[-1] > self.left_gray_ts)
        ]

    def __len__(self):
        return len(self.left_event)

    def load_event(self, start_index: int, end_index: int, cam: str = "left") -> np.ndarray:
        """Events [n, 4] = (x=height, y=width, t[s], p in {-1, 1})."""
        if cam != "left":
            raise NotImplementedError("Only `left` camera is supported.")
        if len(self.left_event) <= start_index:
            raise IndexError(f"{start_index}:{end_index} out of {len(self.left_event)}")
        n = end_index - start_index
        events = np.zeros((n, 4), dtype=np.float64)
        events[:, 0] = self.left_event[start_index:end_index, 1]
        events[:, 1] = self.left_event[start_index:end_index, 0]
        events[:, 2] = self.left_ts[start_index:end_index]
        events[:, 3] = self.left_event[start_index:end_index, 3]
        if self.undistort:
            events = undistort_events(events, self.calib_map_x, self.calib_map_y, self._HEIGHT, self._WIDTH)
        return events

    def gt_time_list(self):
        return self.gt_timestamps

    def eval_frame_time_list(self):
        return self.left_gray_ts

    def index_to_time(self, index: int) -> float:
        return self.left_ts[index]

    def time_to_index(self, time: float) -> int:
        return int(np.searchsorted(self.left_ts, time)) - 1

    def load_optical_flow(self, t1: float, t2: float) -> np.ndarray:
        """GT displacement between t1 and t2: [H, W, 2], the channels
        (height, width)."""
        U_gt, V_gt = estimate_corresponding_gt_flow(
            self.U_gt_all, self.V_gt_all, self.gt_timestamps, t1, t2
        )
        return np.stack((V_gt, U_gt), axis=2)

    def load_calib(self) -> dict:
        outdoor_K = np.array(
            [
                [223.9940010790056, 0, 170.7684322973841, 0],
                [0, 223.61783486959376, 128.18711828338436, 0],
                [0, 0, 1, 0],
                [0, 0, 0, 1],
            ],
            dtype=np.float32,
        )
        return {"K": outdoor_K}

    def get_calib_map(self, map_txt_x, map_txt_y):
        return self.load_map_txt(map_txt_x), self.load_map_txt(map_txt_y)

    def load_map_txt(self, map_txt):
        """One rectify map ([H, W], one text row per image row)."""
        with open(map_txt) as f:
            lines = f.readlines()
        out = np.zeros((self._HEIGHT, self._WIDTH))
        for i, line in enumerate(lines):
            out[i] = np.array([float(k) for k in line.split()])
        return out
