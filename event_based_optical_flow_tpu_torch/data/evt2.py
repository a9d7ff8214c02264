"""Prophesee RAW (EVT2.0) loader for live-camera recordings (port of
``event_based_optical_flow_tpu/data/evt2.py``).

File layout: an ASCII header of lines starting with ``%`` (e.g.
``% format EVT2;height=480;width=640``), then little-endian 32-bit words.
A word's top 4 bits are its type: CD_OFF (0x0) and CD_ON (0x1) events
carry a 6-bit microsecond remainder (bits 22-27), an 11-bit sensor column
(bits 11-21) and an 11-bit sensor row (bits 0-10); EVT_TIME_HIGH (0x8)
carries the upper 28 timestamp bits; every other type is skipped.

The loader decodes through the port's native C++ decoder
(``native.decode_evt2``, built with g++ at first use);
``decode_evt2_numpy`` is its plain version, the same arrays in vectorized
numpy, which the tests hold the native one to.  Events come out in the port's
convention, (x=height, y=width, t seconds, polarity +-1): the sensor
(column, row) pair swaps, as in the MVSEC loader.  Raw streams have no
dense GT flow, so the eval runs the FWL-only protocol.
"""

import logging
import os

import numpy as np

from .. import native
from ..ops.filters import apply_config_filters
from .base import EventArrayLoader

logger = logging.getLogger(__name__)


def decode_evt2_numpy(words: np.ndarray):
    """EVT2.0 words -> (x_col, y_row, t_us, polarity) float64 arrays.  The
    sequential TIME_HIGH register becomes a forward fill: each CD word
    takes the latest EVT_TIME_HIGH before it (0 before the first)."""
    words = np.ascontiguousarray(words, np.uint32)
    types = words >> 28
    is_cd = types <= 1
    is_th = types == 8

    th_idx = np.flatnonzero(is_th)
    th_vals = (words[th_idx] & np.uint32(0x0FFFFFFF)).astype(np.uint64)
    cd_idx = np.flatnonzero(is_cd)
    if len(th_idx):
        pos = np.searchsorted(th_idx, cd_idx) - 1  # latest TIME_HIGH before each CD word (-1: none)
        time_high = np.where(pos >= 0, th_vals[np.maximum(pos, 0)], np.uint64(0))
    else:
        time_high = np.zeros(len(cd_idx), np.uint64)

    cd = words[cd_idx]
    ts6 = ((cd >> 22) & np.uint32(0x3F)).astype(np.uint64)
    t_us = ((time_high << np.uint64(6)) | ts6).astype(np.float64)
    x_col = ((cd >> 11) & np.uint32(0x7FF)).astype(np.float64)
    y_row = (cd & np.uint32(0x7FF)).astype(np.float64)
    pol = types[cd_idx].astype(np.float64)
    return x_col, y_row, t_us, pol


def read_raw_header(path: str, fmt_tag: str) -> bytes:
    """Skip a Prophesee .raw file's ``%`` ASCII header (warning when its
    ``format`` line names another format than ``fmt_tag``); returns the
    binary payload."""
    with open(path, "rb") as f:
        data = f.read()
    offset = 0
    while offset < len(data) and data[offset : offset + 1] == b"%":
        nl = data.find(b"\n", offset)
        if nl < 0:
            raise ValueError(f"{path}: unterminated header line")
        line = data[offset:nl].decode("latin-1")
        if "format" in line and fmt_tag not in line.upper().replace(" ", ""):
            logger.warning(f"{path}: header says {line.strip()!r}; this loader decodes {fmt_tag}")
        offset = nl + 1
    return data[offset:]


def read_raw_evt2(path: str):
    """A Prophesee EVT2 .raw file -> (x_col, y_row, t_us, polarity),
    decoded natively; a trailing partial word (a capture cut mid-word) is
    dropped."""
    payload = read_raw_header(path, "EVT2")
    payload = payload[: len(payload) - len(payload) % 4]
    return native.decode_evt2(np.frombuffer(payload, dtype="<u4"))


class Evt2DataLoader(EventArrayLoader):
    """Sequence = one ``<root>/<sequence>.raw`` file (or
    ``<root>/<sequence>/events.raw``), with an optional ECD-style
    calibration file beside it (``<sequence>_calib.txt``, or
    ``calib.txt`` in the sequence's directory).  ``data.hot_pixel_sigma``
    and ``data.refractory_us`` filter the decoded stream."""

    NAME = "EVT2"
    read_raw = staticmethod(read_raw_evt2)

    def set_sequence(self, sequence_name: str, undistort: bool = False) -> None:
        logger.info(f"Use {self.NAME} raw sequence {sequence_name}")
        self.sequence_name = sequence_name
        self.dataset_files = self.get_sequence(sequence_name)
        x_col, y_row, t_us, pol = self.read_raw(self.dataset_files["event"])
        events = np.stack([y_row, x_col, t_us * 1e-6, np.where(pol > 0, 1.0, -1.0)], axis=1)
        self.events = apply_config_filters(events, (self._HEIGHT, self._WIDTH), self.config)
        self.left_ts = self.events[:, 2]
        self.gt_flow_available = False

    def get_sequence(self, sequence_name: str) -> dict:
        flat = os.path.join(self.root_dir, sequence_name + ".raw")
        if os.path.exists(flat):
            return {"event": flat, "calib": os.path.join(self.root_dir, sequence_name + "_calib.txt")}
        seq = os.path.join(self.root_dir, sequence_name)
        return {"event": os.path.join(seq, "events.raw"), "calib": os.path.join(seq, "calib.txt")}
