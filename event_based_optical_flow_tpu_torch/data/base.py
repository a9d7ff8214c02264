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
