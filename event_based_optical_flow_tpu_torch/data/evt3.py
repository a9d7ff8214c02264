"""Prophesee RAW (EVT3, Gen4 / IMX636) loader (port of
``event_based_optical_flow_tpu/data/evt3.py``); the same contract as the
EVT2 loader.

EVT3 is a stateful stream of little-endian 16-bit words; the top 4 bits
are the type.  ADDR_Y (0x0) sets the row register; TIME_LOW (0x6) and
TIME_HIGH (0x8) set 12 bits each of the time (a TIME_HIGH that goes
backward is a 24-bit rollover); ADDR_X (0x2) emits one event at an 11-bit
column with its polarity in bit 11; VECT_BASE_X (0x3) sets the vector
base column and polarity; VECT_12 (0x4) / VECT_8 (0x5) emit one event per
set bit of their 12 / 8-bit mask at base + lane, then advance the base by
12 / 8.  Other types are skipped.  The registers start at 0.

The decode rebuilds the register state with forward fills (searchsorted)
and, for the vector base, segmented cumulative sums (each VECT_BASE_X
starts a segment).
"""

import numpy as np

from .evt2 import Evt2DataLoader, read_raw_header


def _ffill(marker_idx, marker_vals, query_idx, default):
    """Value of the latest marker at or before each query word index
    (``default`` before the first marker)."""
    if len(marker_idx) == 0:
        return np.full(len(query_idx), default, dtype=np.uint64)
    pos = np.searchsorted(marker_idx, query_idx, side="right") - 1
    return np.where(pos >= 0, marker_vals[np.maximum(pos, 0)], np.uint64(default))


def decode_evt3_numpy(words: np.ndarray):
    """EVT3 words -> (x_col, y_row, t_us, polarity) float64 arrays in
    stream order."""
    words = np.ascontiguousarray(words, np.uint16)
    types = words >> 12

    # register forward fills
    y_idx = np.flatnonzero(types == 0x0)
    y_vals = (words[y_idx] & np.uint16(0x7FF)).astype(np.uint64)
    tl_idx = np.flatnonzero(types == 0x6)
    tl_vals = (words[tl_idx] & np.uint16(0xFFF)).astype(np.uint64)
    th_idx = np.flatnonzero(types == 0x8)
    th_vals = (words[th_idx] & np.uint16(0xFFF)).astype(np.uint64)
    wraps = np.zeros(len(th_idx), np.uint64)
    if len(th_idx) > 1:
        wraps[1:] = (th_vals[1:] < th_vals[:-1]).astype(np.uint64)
    epoch_vals = np.cumsum(wraps)

    def time_at(query_idx):
        tl = _ffill(tl_idx, tl_vals, query_idx, 0)
        th = _ffill(th_idx, th_vals, query_idx, 0)
        ep = _ffill(th_idx, epoch_vals, query_idx, 0)
        return (ep << np.uint64(24)) | (th << np.uint64(12)) | tl

    # single events (ADDR_X)
    sg_idx = np.flatnonzero(types == 0x2)
    sg_x = (words[sg_idx] & np.uint16(0x7FF)).astype(np.float64)
    sg_p = ((words[sg_idx] >> 11) & np.uint16(1)).astype(np.float64)
    sg_y = _ffill(y_idx, y_vals, sg_idx, 0).astype(np.float64)
    sg_t = time_at(sg_idx).astype(np.float64)

    # vector events (VECT_BASE_X; VECT_12 / VECT_8)
    vb_idx = np.flatnonzero(types == 0x3)
    vb_vals = (words[vb_idx] & np.uint16(0x7FF)).astype(np.int64)
    vb_pol = ((words[vb_idx] >> 11) & np.uint16(1)).astype(np.float64)
    vc_idx = np.flatnonzero((types == 0x4) | (types == 0x5))
    is12 = types[vc_idx] == 0x4
    incr = np.where(is12, 12, 8).astype(np.int64)
    # base(j) = the segment's VECT_BASE_X + the increments of the vector
    # words after it and before j
    cum = np.concatenate([[0], np.cumsum(incr)])  # cum[j]: increments before vector word j
    seg = np.searchsorted(vb_idx, vc_idx, side="right") - 1  # each vector word's base word
    first_vc = np.searchsorted(vc_idx, vb_idx, side="left")  # each base word's first vector word
    if len(vb_idx):
        base0 = np.where(seg >= 0, vb_vals[np.maximum(seg, 0)], 0)
        cum_at_seg = np.where(seg >= 0, cum[first_vc[np.maximum(seg, 0)]], 0)
    else:  # vector words before any VECT_BASE_X: the zero registers
        base0 = np.zeros(len(vc_idx), np.int64)
        cum_at_seg = np.zeros(len(vc_idx), np.int64)
    base_j = base0 + (cum[:-1] - cum_at_seg)

    masks = np.where(is12, words[vc_idx] & np.uint16(0xFFF), words[vc_idx] & np.uint16(0xFF)).astype(np.uint16)
    lanes = np.arange(12)
    bits = ((masks[:, None] >> lanes[None, :]) & 1).astype(bool)  # [n_vc, 12]
    vj, lane = np.nonzero(bits)
    vc_x = (base_j[vj] + lane).astype(np.float64)
    if len(vb_idx):
        vc_p = np.where(seg[vj] >= 0, vb_pol[np.maximum(seg[vj], 0)], 0.0)
    else:
        vc_p = np.zeros(len(vj), np.float64)
    vc_y = _ffill(y_idx, y_vals, vc_idx, 0)[vj].astype(np.float64)
    vc_t = time_at(vc_idx)[vj].astype(np.float64)

    # merge in stream order (word index, then lane within a word)
    key_sg = sg_idx.astype(np.int64) * 16
    key_vc = vc_idx[vj].astype(np.int64) * 16 + (lane + 1)
    order = np.argsort(np.concatenate([key_sg, key_vc]), kind="stable")
    return tuple(np.concatenate(pair)[order] for pair in ((sg_x, vc_x), (sg_y, vc_y), (sg_t, vc_t), (sg_p, vc_p)))


def read_raw_evt3(path: str):
    """A Prophesee EVT3 .raw file -> (x_col, y_row, t_us, polarity); a
    trailing odd byte is dropped."""
    payload = read_raw_header(path, "EVT3")
    payload = payload[: len(payload) - len(payload) % 2]
    return decode_evt3_numpy(np.frombuffer(payload, dtype="<u2"))


class Evt3DataLoader(Evt2DataLoader):
    """The EVT2 loader's layout, calibration, filters and FWL-only clock on
    an EVT3 stream."""

    NAME = "EVT3"
    read_raw = staticmethod(read_raw_evt3)
