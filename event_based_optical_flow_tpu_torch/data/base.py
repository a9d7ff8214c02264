"""Data loader base class (port of event_based_optical_flow_tpu/data/base.py)."""

import logging
import os

import numpy as np

from ..utils.misc import check_file_utils, check_key_and_bool

logger = logging.getLogger(__name__)


class DataLoaderBase:
    NAME = "example"

    def __init__(self, config: dict = {}):
        from . import DATASET_ROOT_DIR

        self._HEIGHT = config["height"]
        self._WIDTH = config["width"]
        root_dir = config.get("root") or DATASET_ROOT_DIR
        self.root_dir = os.path.expanduser(root_dir)
        data_dir = config.get("dataset") or self.NAME
        self.dataset_dir = os.path.join(self.root_dir, data_dir)
        self.__dataset_files: dict = {}
        self.config = config

        if check_key_and_bool(config, "load_gt_flow"):
            self.gt_flow_dir = os.path.expanduser(config["gt"])
            self.gt_flow_available = check_file_utils(self.gt_flow_dir)
        else:
            self.gt_flow_available = False
        self.auto_undistort = check_key_and_bool(config, "undistort")

    @property
    def dataset_files(self) -> dict:
        return self.__dataset_files

    @dataset_files.setter
    def dataset_files(self, sequence: dict):
        self.__dataset_files = sequence

    def set_sequence(self, sequence_name: str) -> None:
        self.sequence_name = sequence_name
        self.dataset_files = self.get_sequence(sequence_name)

    def get_sequence(self, sequence_name: str) -> dict:
        raise NotImplementedError

    def load_event(self, start_index: int, end_index: int, *args, **kwargs) -> np.ndarray:
        raise NotImplementedError

    def load_calib(self) -> dict:
        raise NotImplementedError

    def load_optical_flow(self, t1: float, t2: float, *args, **kwargs) -> np.ndarray:
        raise NotImplementedError

    def index_to_time(self, index: int) -> float:
        raise NotImplementedError

    def time_to_index(self, time: float) -> int:
        raise NotImplementedError


class EventArrayLoader(DataLoaderBase):
    """A loader that holds a whole recording in memory as ``self.events``
    ([n, 4], time-sorted) and has no dense GT flow (ECD, EVT2, EVT3): the
    FWL-only eval protocol over a fixed-rate clock, and an optional
    ECD-style calibration file (``dataset_files["calib"]``)."""

    def __len__(self):
        return len(self.events)

    def load_event(self, start_index: int, end_index: int, cam: str = "left") -> np.ndarray:
        return np.copy(self.events[start_index:end_index])

    def index_to_time(self, index: int) -> float:
        return float(self.left_ts[min(index, len(self.left_ts) - 1)])

    def time_to_index(self, time: float) -> int:
        """searchsorted - 1, clamped at 0: the eval clock starts exactly at
        the first event's timestamp."""
        return max(int(np.searchsorted(self.left_ts, time)) - 1, 0)

    def eval_frame_time_list(self):
        """``data.eval_n_frames`` (default 200) evenly spaced times over the
        recording (no GT frames to anchor on)."""
        n = int(self.config.get("eval_n_frames", 200))
        return np.linspace(self.left_ts[0], self.left_ts[-1], n)

    def load_calib(self) -> dict:
        path = self.dataset_files.get("calib", "")
        if not path or not os.path.exists(path):
            return {}
        from .calib import load_ecd_calib_file

        return load_ecd_calib_file(path)
