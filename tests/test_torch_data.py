"""The port's data layer against the JAX package's, on fixtures written
from numpy seeds in each format's own layout: the MVSEC, DSEC, ECD, EVT2
and EVT3 loaders, the EVT2/EVT3 decoders, the ECD calibration files, the
raw-camera filters and the event-array utilities give the same arrays bit
for bit.  The MVSEC and EVT2 fixtures are ``chip_smoke.py``'s own writers,
so the JAX loaders check what the smoke runs on the card."""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import main as jax_cli
from event_based_optical_flow_tpu import data as jdata
from event_based_optical_flow_tpu.data import calib as jcalib
from event_based_optical_flow_tpu.data import evt2 as jevt2
from event_based_optical_flow_tpu.data import evt3 as jevt3
from event_based_optical_flow_tpu.ops import filters as jfilters
from event_based_optical_flow_tpu.utils import events as jevents
from event_based_optical_flow_tpu_torch import data as tdata
from event_based_optical_flow_tpu_torch import main as port_cli
from event_based_optical_flow_tpu_torch.data import calib as tcalib
from event_based_optical_flow_tpu_torch.data import evt2 as tevt2
from event_based_optical_flow_tpu_torch.data import evt3 as tevt3
from event_based_optical_flow_tpu_torch.data import mvsec as tmvsec
from event_based_optical_flow_tpu_torch.ops import filters as tfilters
from event_based_optical_flow_tpu_torch.utils import events as tevents
from test_torch_flow_io import png16

H, W = 36, 44


def _both(name, config, sequence, **kw):
    """The JAX package's and the port's loader of ``name`` on ``config``,
    each with ``sequence`` set."""
    loaders = []
    for pkg in (jdata, tdata):
        loader = pkg.collections[name](config=dict(config))
        loader.set_sequence(sequence, **kw)
        loaders.append(loader)
    return loaders


def _same_contract(jl, tl, times, flow=True):
    """load_event, len, the clocks, time_to_index / index_to_time at
    ``times`` and every event index, the GT of consecutive clock windows
    and the calibration: the same arrays, dtypes and values."""
    assert len(tl) == len(jl) > 0
    got, want = tl.load_event(0, len(tl)), jl.load_event(0, len(jl))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tl.load_event(3, 17), jl.load_event(3, 17))
    np.testing.assert_array_equal(tl.eval_frame_time_list(), jl.eval_frame_time_list())
    assert tl.gt_flow_available == jl.gt_flow_available
    for t in times:
        assert tl.time_to_index(t) == jl.time_to_index(t), t
    for i in (0, 1, len(tl) // 2, len(tl) - 1):
        assert tl.index_to_time(i) == jl.index_to_time(i)
    if flow:
        np.testing.assert_array_equal(tl.gt_time_list(), jl.gt_time_list())
        ts = tl.eval_frame_time_list()
        for a, b in ((0, 1), (1, 3), (0, len(ts) - 1)):
            np.testing.assert_array_equal(tl.load_optical_flow(ts[a], ts[b]), jl.load_optical_flow(ts[a], ts[b]))
    jc, tc = jl.load_calib(), tl.load_calib()
    assert sorted(jc) == sorted(tc)
    for k in jc:
        assert tc[k].dtype == jc[k].dtype
        np.testing.assert_array_equal(tc[k], jc[k])


def _times(ts, lo, hi):
    """Query times: every stamp of ``ts``, midpoints, and times before and
    after the stream."""
    ts = np.asarray(ts)
    return list(ts) + list((ts[1:] + ts[:-1]) / 2) + [lo - 1.0, lo, hi, hi + 1.0]


@pytest.fixture(scope="module")
def mvsec_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("mvsec")
    datasets = chip_smoke.mvsec_fixture(str(root), H, W, event_rate=20000.0, flow_max=15.0)
    chip_smoke.write_mvsec_h5(str(root / "indoor_flying1_data.hdf5"), datasets)
    return root, datasets


def _mvsec_config(root, load_gt=True):
    return {"height": H, "width": W, "root": str(root), "dataset": "MVSEC", "load_gt_flow": load_gt,
            "gt": str(root)}


@pytest.mark.parametrize("undistort", [False, True])
@pytest.mark.parametrize("load_gt", [True, False])
def test_mvsec_loader_matches_jax(mvsec_root, undistort, load_gt):
    """The MVSEC loader on chip_smoke's indoor_flying1 fixture read through
    h5py: with GT (valid-frame slicing: GT frames 60.. and the events and
    gray frames inside their span) and without, with and without the
    rectify maps."""
    root, datasets = mvsec_root
    jl, tl = _both("MVSEC", _mvsec_config(root, load_gt), "indoor_flying1", undistort=undistort)
    assert tl.left_event.dtype == np.int16
    events = datasets["davis/left/events"]
    _same_contract(jl, tl, _times(tl.eval_frame_time_list(), events[0, 2], events[-1, 2]), flow=load_gt)
    if load_gt:
        n_kept = chip_smoke.MVSEC_FIXTURE["n_gt"] - chip_smoke.MVSEC_FIRST_VALID_GT
        assert len(tl.gt_time_list()) == n_kept and len(tl.eval_frame_time_list()) == n_kept - 2
        assert tl.min_ts < tl.gt_time_list()[0] < tl.eval_frame_time_list()[0]
    # the column swap: the file's (x=width, y=height) -> (height, width)
    first = np.searchsorted(events[:, 2], tl.gt_time_list()[0]) - 1 if load_gt else 0
    np.testing.assert_array_equal(tl.load_event(0, 5)[:, :2], events[first : first + 5, 1::-1])
    assert tl.time_to_index(events[0, 2] - 1.0) == jl.time_to_index(events[0, 2] - 1.0) == -1


def test_mvsec_arrays_reader_is_h5py_loader(mvsec_root):
    """chip_smoke's stand-in reader (used on the card, which has no h5py)
    returns h5py_loader's arrays and dtypes for the written file, and a
    loader reading through it equals one reading the file."""
    root, datasets = mvsec_root
    path = str(root / "indoor_flying1_data.hdf5")
    for got, want in zip(chip_smoke.mvsec_arrays_reader(datasets)(path), tmvsec.h5py_loader(path)):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])
    (_, via_file) = _both("MVSEC", _mvsec_config(root), "indoor_flying1")
    reader = tmvsec.h5py_loader
    tmvsec.h5py_loader = chip_smoke.mvsec_arrays_reader(datasets)
    try:
        via_arrays = tdata.collections["MVSEC"](config=_mvsec_config(root))
        via_arrays.set_sequence("indoor_flying1")
    finally:
        tmvsec.h5py_loader = reader
    np.testing.assert_array_equal(via_arrays.left_event, via_file.left_event)
    np.testing.assert_array_equal(via_arrays.eval_frame_time_list(), via_file.eval_frame_time_list())


@pytest.fixture(scope="module")
def dsec_root(tmp_path_factory):
    h5py = pytest.importorskip("h5py")
    root = tmp_path_factory.mktemp("dsec")
    seq = root / "zurich_city_00_a"
    (seq / "events" / "left").mkdir(parents=True)
    (seq / "flow" / "forward").mkdir(parents=True)
    rng = np.random.default_rng(1)
    n = 3000
    with h5py.File(seq / "events" / "left" / "events.h5", "w") as f:
        g = f.create_group("events")
        g.create_dataset("x", data=rng.integers(0, W, n).astype(np.uint16))
        g.create_dataset("y", data=rng.integers(0, H, n).astype(np.uint16))
        g.create_dataset("t", data=np.sort(rng.integers(0, 1_000_000, n)).astype(np.int64))
        g.create_dataset("p", data=rng.integers(0, 2, n).astype(np.uint8))
        f.create_dataset("t_offset", data=np.int64(5_000_000))
    windows = np.array([[5_050_000, 5_150_000], [5_150_000, 5_250_000], [5_250_000, 5_400_000]])
    for i in range(len(windows)):
        img = rng.integers(2**15 - 3000, 2**15 + 3000, (H, W, 3)).astype(np.uint16)
        img[..., 2] = rng.random((H, W)) > 0.2  # invalid pixels -> inf
        (seq / "flow" / "forward" / f"{i:06d}.png").write_bytes(png16(img, filters=(i % 5, (i + 2) % 5)))
    np.savetxt(seq / "flow" / "forward_timestamps.txt", windows, fmt="%d", delimiter=",")
    return root


def test_dsec_loader_matches_jax(dsec_root):
    """The DSEC h5 layout with ``t_offset``, the binary-search
    time_to_index, the flow windows as the eval clock and the 16-bit PNG GT
    (invalid pixels inf): the same arrays.  Without the GT files the clock
    is empty in both."""
    config = {"height": H, "width": W, "root": str(dsec_root), "dataset": "DSEC", "load_gt_flow": True,
              "gt": str(dsec_root)}
    jl, tl = _both("DSEC", config, "zurich_city_00_a")
    assert tl.t_offset == jl.t_offset == 5_000_000.0
    _same_contract(jl, tl, _times(tl.eval_frame_time_list(), 5.0, 6.0) + [5.0004, 5.5])
    flow = tl.load_optical_flow(*tl.eval_frame_time_list()[:2])
    assert np.isinf(flow).any() and np.isfinite(flow).any()
    jl, tl = _both("DSEC", {**config, "load_gt_flow": False}, "zurich_city_00_a")
    assert not tl.gt_flow_available and len(tl.eval_frame_time_list()) == 0
    _same_contract(jl, tl, [5.0, 5.3, 6.0], flow=False)


@pytest.mark.parametrize("calib", [[199.0, 198.0, 132.0, 110.0, -0.38, 0.18, 0.0, 0.0, 0.0],
                                   [199.0, 198.0, 132.0, 110.0, -0.38], None])
def test_ecd_loader_matches_jax(tmp_path, calib):
    """The ECD text format (t x y p), the clamped time_to_index, the
    ``eval_n_frames`` clock and the calibration file (whole, partial with
    the zero-fill warning, absent)."""
    seq = tmp_path / "slider"
    seq.mkdir()
    rng = np.random.default_rng(0)
    n = 800
    cols = np.stack([np.sort(rng.uniform(0, 1, n)), rng.integers(0, W, n), rng.integers(0, H, n),
                     rng.integers(0, 2, n)], 1)
    np.savetxt(seq / "events.txt", cols, fmt="%.6f %d %d %d")
    if calib is not None:
        np.savetxt(seq / "calib.txt", np.array(calib)[None])
    config = {"height": H, "width": W, "root": str(tmp_path), "dataset": "ECD", "eval_n_frames": 7}
    jl, tl = _both("ECD", config, "slider")
    _same_contract(jl, tl, _times(tl.eval_frame_time_list(), 0.0, 1.0), flow=False)
    assert not tl.gt_flow_available and len(tl.eval_frame_time_list()) == 7
    assert tl.time_to_index(-1.0) == jl.time_to_index(-1.0) == 0


def test_calib_file_parsing_matches_jax(tmp_path, caplog):
    """load_ecd_calib_file: the same K and D, the same zero-fill warning,
    and the same refusal of fewer than four intrinsics."""
    for vals in ([1.0, 2.0, 3.0, 4.0], [1.0, 2.0, 3.0, 4.0, 0.1, 0.2], list(np.arange(1.0, 12.0))):
        path = tmp_path / f"calib{len(vals)}.txt"
        np.savetxt(path, np.array(vals)[None])
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            want = jcalib.load_ecd_calib_file(str(path))
            got = tcalib.load_ecd_calib_file(str(path))
        np.testing.assert_array_equal(got["K"], want["K"])
        np.testing.assert_array_equal(got["D"], want["D"])
        messages = [r.getMessage() for r in caplog.records]
        assert len(messages) == (2 if len(vals) == 6 else 0) and messages[0:1] == messages[1:2]
    short = tmp_path / "short.txt"
    np.savetxt(short, np.array([1.0, 2.0, 3.0])[None])
    for load in (jcalib.load_ecd_calib_file, tcalib.load_ecd_calib_file):
        with pytest.raises(ValueError, match="at least fx fy cx cy"):
            load(str(short))


def _evt2_cd(pol, ts6, x, y):
    return (pol << 28) | (ts6 << 22) | (x << 11) | y


def _evt3(ty, payload):
    return (ty << 12) | payload


EVT2_SPEC = [  # tests/test_format_conformance.py's vectors
    [(0x8 << 28) | 0x0000001, _evt2_cd(1, 5, 1213, 677), _evt2_cd(0, 63, 0, 2047), (0x8 << 28) | 0x0FFFFFF,
     _evt2_cd(1, 0, 2047, 0), 0xA << 28, _evt2_cd(0, 1, 7, 8)],
    [_evt2_cd(1, 9, 3, 4)],
    [(0x1 << 28) | (5 << 22) | (3 << 11) | 7],
    [],
]
EVT3_SPEC = [
    [_evt3(0x8, 0x001), _evt3(0x6, 0x0FE), _evt3(0x0, 321), _evt3(0x2, (1 << 11) | 100), _evt3(0x3, 512),
     _evt3(0x4, 0b100000000101), _evt3(0x5, 0b10000001), _evt3(0x6, 0x0FF), _evt3(0x2, 45)],
    [_evt3(0x8, 0xFFF), _evt3(0x6, 0x005), _evt3(0x0, 10), _evt3(0x2, 1), _evt3(0x8, 0x000), _evt3(0x6, 0x002),
     _evt3(0x2, 2)],
    [_evt3(0x4, 0b11), _evt3(0x2, 7)],
    [(0x4 << 12) | 0b101, (0x5 << 12) | 0b1],
    [],
]


def _same_decode(got, want):
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float64
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fmt", ["evt2", "evt3"])
def test_decoders_match_jax_on_spec_vectors_and_fuzz(fmt):
    """decode_evt2_numpy / decode_evt3_numpy against the JAX package's on
    the format-conformance vectors and on seeded random word streams (any
    type code, registers in any order)."""
    decode, want_decode, spec, dtype, bits = (
        (tevt2.decode_evt2_numpy, jevt2.decode_evt2_numpy, EVT2_SPEC, np.uint32, 32) if fmt == "evt2"
        else (tevt3.decode_evt3_numpy, jevt3.decode_evt3_numpy, EVT3_SPEC, np.uint16, 16))
    for words in spec:
        words = np.asarray(words, dtype)
        _same_decode(decode(words), want_decode(words))
    rng = np.random.default_rng(1234)
    for _ in range(8):
        words = rng.integers(0, 1 << bits, size=int(rng.integers(1, 6000)), dtype=np.uint64).astype(dtype)
        _same_decode(decode(words), want_decode(words))


@pytest.mark.parametrize("fmt", ["evt2", "evt3"])
def test_raw_readers_match_jax(tmp_path, fmt, caplog):
    """read_raw_evt2 / read_raw_evt3 on files with a header (the right
    format, and another one, which warns), a stray trailing byte and a
    seeded word stream: the same arrays and warnings."""
    rng = np.random.default_rng(5)
    dtype, bits, read, want_read, tag = (
        (np.uint32, 32, tevt2.read_raw_evt2, jevt2.read_raw_evt2, "EVT2") if fmt == "evt2"
        else (np.uint16, 16, tevt3.read_raw_evt3, jevt3.read_raw_evt3, "EVT3"))
    words = rng.integers(0, 1 << bits, size=3000, dtype=np.uint64).astype(dtype)
    for header in (f"% format {tag};height=480;width=640\n% end\n", "% format EVT4\n", ""):
        path = tmp_path / "stream.raw"
        path.write_bytes(header.encode() + words.astype(words.dtype.newbyteorder("<")).tobytes() + b"\x55")
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            got, want = read(str(path)), want_read(str(path))
        _same_decode(got, want)
        messages = [r.getMessage() for r in caplog.records]
        assert len(messages) == 2 * ("EVT4" in header) and messages[0:1] == messages[1:2]


@pytest.mark.parametrize("name", ["EVT2", "EVT3"])
@pytest.mark.parametrize("filters", [{}, {"hot_pixel_sigma": 5.0, "refractory_us": 50}])
def test_raw_loaders_match_jax(tmp_path, name, filters):
    """The EVT2 loader on chip_smoke's RAW fixture (dots translating, hot
    pixels) and the EVT3 loader on a seeded stream, with and without the
    filters, with the calibration file beside the recording (flat layout)
    and in the sequence's directory (nested layout)."""
    if name == "EVT2":
        chip_smoke.evt2_fixture(str(tmp_path / "rec.raw"), H, W, events=20000, n_dots=60, n_hot=3,
                                seconds=0.05, velocity=(-30.0, 40.0))
        np.savetxt(tmp_path / "rec_calib.txt", np.array([40.0, 41.0, 20.0, 18.0, -0.1, 0.02, 0.0, 0.0, 0.0])[None])
    else:
        rng = np.random.default_rng(3)
        words = [_evt3(0x8, 0), _evt3(0x6, 0)]
        for k in range(6000):
            words += [_evt3(0x6, k % 4096)] if k % 7 == 0 else []
            words += [_evt3(0x8, k // 4096)] if k % 4096 == 0 and k else []
            words += [_evt3(0x0, int(rng.integers(0, H))), _evt3(0x2, (int(rng.integers(0, 2)) << 11)
                                                                 | int(rng.integers(0, W)))]
        (tmp_path / "rec").mkdir()
        (tmp_path / "rec" / "events.raw").write_bytes(b"% format EVT3\n" + np.asarray(words, "<u2").tobytes())
        np.savetxt(tmp_path / "rec" / "calib.txt", np.array([40.0, 41.0, 20.0, 18.0])[None])
    config = {"height": H, "width": W, "root": str(tmp_path), "dataset": name, "eval_n_frames": 5, **filters}
    jl, tl = _both(name, config, "rec")
    ts = tl.eval_frame_time_list()
    _same_contract(jl, tl, _times(ts, ts[0], ts[-1]), flow=False)
    assert not tl.gt_flow_available and tl.load_calib()["K"][0, 0] == 40.0


def test_filters_match_jax():
    """hot_pixel_mask, remove_hot_pixels, refractory_filter and
    apply_config_filters keep the same events (and masks) as the JAX
    package's on a seeded stream with hot pixels and bursts."""
    rng = np.random.default_rng(7)
    n = 20000
    ev = np.stack([rng.integers(0, H, n), rng.integers(0, W, n), np.sort(rng.uniform(0, 0.5, n)),
                   rng.choice([-1.0, 1.0], n)], 1).astype(np.float64)
    hot = np.stack([np.full(3000, 5.0), np.full(3000, 7.0), np.linspace(0, 0.5, 3000), np.ones(3000)], 1)
    burst = np.stack([np.full(50, 20.0), np.full(50, 30.0), 0.25 + np.arange(50) * 2e-5, np.ones(50)], 1)
    ev = np.concatenate([ev, hot, burst])
    ev = ev[np.argsort(ev[:, 2], kind="stable")]
    for sigma, rate in ((5.0, 500.0), (3.0, 100.0), (50.0, 500.0)):
        np.testing.assert_array_equal(tfilters.hot_pixel_mask(ev, (H, W), sigma, rate),
                                      jfilters.hot_pixel_mask(ev, (H, W), sigma, rate))
        (got, got_mask), (want, want_mask) = (f.remove_hot_pixels(ev, (H, W), sigma, rate)
                                              for f in (tfilters, jfilters))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_mask, want_mask)
    for refr in (0.0, 1e-5, 1e-4, 1e-3):
        np.testing.assert_array_equal(tfilters.refractory_filter(ev, (H, W), refr),
                                      jfilters.refractory_filter(ev, (H, W), refr))
    for config in ({}, {"hot_pixel_sigma": 5}, {"refractory_us": 100}, {"hot_pixel_sigma": 4.0, "refractory_us": 30,
                                                                        "hot_pixel_min_rate_hz": 200.0}):
        got = tfilters.apply_config_filters(ev, (H, W), config)
        np.testing.assert_array_equal(got, jfilters.apply_config_filters(ev, (H, W), config))
    assert len(tfilters.apply_config_filters(ev, (H, W), {"hot_pixel_sigma": 5, "refractory_us": 100})) < len(ev)
    empty = np.zeros((0, 4))
    assert not tfilters.hot_pixel_mask(empty, (H, W)).any() and len(tfilters.refractory_filter(empty, (H, W), 1.0)) == 0


def test_event_utils_match_jax():
    """generate_events (numpy's global generator), crop_event,
    crop_event_mask, set_event_origin_to_zero (numpy, and a tensor where
    the JAX module takes a jnp array) and undistort_events."""
    np.random.seed(3)
    want = jevents.generate_events(500, H, W, 0.1, 0.4)
    np.random.seed(3)
    got = tevents.generate_events(500, H, W, 0.1, 0.4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tevents.crop_event(got, 3, 20, 5, 30), jevents.crop_event(want, 3, 20, 5, 30))
    np.testing.assert_array_equal(tevents.crop_event_mask(got, 3, 20, 5, 30),
                                  np.asarray(jevents.crop_event_mask(want, 3, 20, 5, 30)))
    mask = tevents.crop_event_mask(torch.as_tensor(got), 3, 20, 5, 30)
    assert mask.dtype == torch.bool
    np.testing.assert_array_equal(mask.numpy(), jevents.crop_event_mask(want, 3, 20, 5, 30))
    shifted = jevents.set_event_origin_to_zero(want, 2, 3, 0.1)
    np.testing.assert_array_equal(tevents.set_event_origin_to_zero(got, 2, 3, 0.1), shifted)
    t = tevents.set_event_origin_to_zero(torch.as_tensor(got), 2, 3, 0.1)
    assert t.dtype == torch.float64
    np.testing.assert_array_equal(t.numpy(), shifted)
    t = tevents.set_event_origin_to_zero(torch.as_tensor(got, dtype=torch.float32), 2, 3, 0.1)
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), jevents.set_event_origin_to_zero(jnp.asarray(want, jnp.float32), 2, 3, 0.1))
    rng = np.random.default_rng(0)
    map_x, map_y = rng.uniform(-3, W + 3, (H, W)), rng.uniform(-3, H + 3, (H, W))
    np.testing.assert_array_equal(tevents.undistort_events(got, map_x, map_y, H, W),
                                  jevents.undistort_events(want, map_x, map_y, H, W))


class _RecordingLoader:
    """A loader whose clock's first time maps to event index -1 (a window
    that starts before the first event): records each load_event call and
    returns ``end - start`` rows."""

    gt_flow_available = False

    def __init__(self):
        self.calls = []

    def __len__(self):
        return 10000

    def time_to_index(self, t):
        return int(round(t * 1000)) - 1

    def load_event(self, start, end):
        self.calls.append((start, end))
        n = max(end - start, 0)
        return np.stack([np.arange(n) % H, np.arange(n) % W, 1.0 + np.arange(n) * 1e-4, np.ones(n)], 1)


@pytest.mark.parametrize("window", [(0.0, 0.3), (0.0, 4.0), (1.0, 1.2)])
def test_gather_frame_slices_as_jax(window):
    """The eval window whose first index is -1 is sliced as the JAX CLI
    slices it (load_event(-1, ind2), then the renormalized batch from
    max(ind1, 0)), with the same events, and no GT where the loader has
    none."""
    data_config = {"n_events_per_batch": 1000}
    jl, tl = _RecordingLoader(), _RecordingLoader()
    want = jax_cli._gather_frame(jl, data_config, *window)
    got = port_cli._gather_frame(tl, data_config, *window)
    assert tl.calls == jl.calls and tl.calls[0][0] == tl.time_to_index(window[0])
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    assert got[2] is want[2] is None and got[3] == want[3]
