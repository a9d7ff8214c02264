"""ECD (Event Camera Dataset, Mueggler et al.) text-format loader (port of
``event_based_optical_flow_tpu/data/ecd.py``).

Layout:
    <root>/<sequence>/events.txt      "t x y p" per line (t seconds,
                                      x = width coord, y = height coord)
    <root>/<sequence>/calib.txt       fx fy cx cy k1 k2 p1 p2 k3 (optional)

No dense flow GT exists for ECD: ``gt_flow_available`` is False and the
eval runs the FWL-only protocol.  240x180 DAVIS sensor.
"""

import logging
import os

import numpy as np

from .base import EventArrayLoader

logger = logging.getLogger(__name__)


class EcdDataLoader(EventArrayLoader):
    NAME = "ECD"

    def set_sequence(self, sequence_name: str, undistort: bool = False) -> None:
        logger.info(f"Use ECD sequence {sequence_name}")
        self.sequence_name = sequence_name
        self.dataset_files = self.get_sequence(sequence_name)
        raw = np.loadtxt(self.dataset_files["event"])
        # file columns: t, x (width), y (height), p
        self.events = np.stack(
            [raw[:, 2], raw[:, 1], raw[:, 0], np.where(raw[:, 3] > 0, 1.0, -1.0)], axis=1
        )
        self.left_ts = self.events[:, 2]
        self.gt_flow_available = False

    def get_sequence(self, sequence_name: str) -> dict:
        seq = os.path.join(self.root_dir, sequence_name)
        return {"event": os.path.join(seq, "events.txt"), "calib": os.path.join(seq, "calib.txt")}
