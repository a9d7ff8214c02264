"""The port's flow-map file IO (``flow/io.py``) against the JAX package's:
the 16-bit PNG decoder (the port's own spec decoder on every machine; the
JAX package reads through cv2 where it imports) on PNGs with every scanline
filter and on cv2's own encodings, the DSEC submission writer's bytes, and
the per-frame dumps of ``output.save_flow``."""

import struct
import zlib

import numpy as np
import pytest

from event_based_optical_flow_tpu.flow import io as jio
from event_based_optical_flow_tpu_torch.flow import io as tio


def png16(img: np.ndarray, filters=(0,), idat_chunks: int = 1) -> bytes:
    """A 16-bit RGB PNG of ``img`` [H, W, 3] uint16 whose rows use
    ``filters`` in turn (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), its
    payload split over ``idat_chunks`` IDAT chunks; encoded here from the
    PNG spec, independently of both packages' encoders."""
    h, w, _ = img.shape
    rows = img.astype(">u2").view(np.uint8).reshape(h, w * 6).astype(np.int64)
    bpp, out, prev = 6, [], np.zeros(w * 6, np.int64)
    for i in range(h):
        f, cur = filters[i % len(filters)], rows[i]
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, up_left))
        out.append(bytes([f]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = cur

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    data = zlib.compress(b"".join(out))
    cut = np.linspace(0, len(data), idat_chunks + 1).astype(int)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0))
            + b"".join(chunk(b"IDAT", data[a:b]) for a, b in zip(cut[:-1], cut[1:])) + chunk(b"IEND", b""))


def _image(seed: int, h: int = 23, w: int = 31) -> np.ndarray:
    """A smooth gradient with noise and a few saturated samples: every
    filter's predictor wraps somewhere."""
    rng = np.random.default_rng(seed)
    base = np.arange(h)[:, None, None] * 1700 + np.arange(w)[None, :, None] * 900 + np.arange(3) * 20000
    img = (base + rng.integers(0, 300, (h, w, 3))) % 65536
    img[rng.random((h, w)) < 0.05] = 65535
    return img.astype(np.uint16)


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4), (4, 2, 3, 1)])
@pytest.mark.parametrize("idat_chunks", [1, 3])
def test_read_png16_equals_jax_on_every_filter(tmp_path, filters, idat_chunks):
    """read_png16 gives the image, and the JAX package's read_png16 (cv2
    where it imports) gives the same float64 array; decode_png16 equals the
    JAX package's decoder on the bytes."""
    img = _image(len(filters) + idat_chunks)
    data = png16(img, filters, idat_chunks)
    path = tmp_path / "flow.png"
    path.write_bytes(data)
    got = tio.read_png16(path)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, img.astype(np.float64))
    np.testing.assert_array_equal(got, jio.read_png16(path))
    decoded = tio.decode_png16(data)
    assert decoded.dtype == np.uint16
    np.testing.assert_array_equal(decoded, jio.decode_png16(data))


def test_read_png16_equals_jax_on_cv2_encodings(tmp_path):
    """PNGs that cv2 (libpng, adaptive filters) writes, at several
    compression levels: the port's decode equals the image and the JAX
    package's read."""
    cv2 = pytest.importorskip("cv2")
    img = _image(9, 48, 64)
    for level in (0, 3, 9):
        ok, buf = cv2.imencode(".png", img[..., ::-1], [cv2.IMWRITE_PNG_COMPRESSION, level])
        assert ok
        path = tmp_path / f"cv2_{level}.png"
        path.write_bytes(buf.tobytes())
        np.testing.assert_array_equal(tio.read_png16(path), img.astype(np.float64))
        np.testing.assert_array_equal(tio.read_png16(path), jio.read_png16(path))


def test_decode_png16_refuses_what_jax_refuses():
    """Not a PNG, 8-bit RGB, no IDAT, a short payload, a bad filter type:
    the port's decoder raises ValueError naming the fault, as the JAX
    package's does."""
    img = _image(1, 4, 5)
    good = png16(img)
    ihdr8 = good.replace(struct.pack(">IIBBBBB", 5, 4, 16, 2, 0, 0, 0), struct.pack(">IIBBBBB", 5, 4, 8, 2, 0, 0, 0))
    raw = bytearray(b"".join(b"\x00" + row.astype(">u2").tobytes() for row in img))
    raw[0] = 7  # no such filter
    cases = {
        "not a PNG": b"GIF89a" + good[6:],
        "unsupported": ihdr8,
        "missing": good[: good.index(b"IDAT") - 4] + good[-12:],
        "payload size": good[:33] + png16(img[:3])[33:],
        "bad PNG filter": good[:33] + _idat(bytes(raw)) + good[-12:],
    }
    for match, data in cases.items():
        with pytest.raises(ValueError, match=match):
            tio.decode_png16(data)
        with pytest.raises(ValueError):  # the JAX package's native defilter words its own message
            jio.decode_png16(data)


def _idat(payload: bytes) -> bytes:
    body = zlib.compress(payload)
    return struct.pack(">I", len(body)) + b"IDAT" + body + struct.pack(">I", zlib.crc32(b"IDAT" + body))


@pytest.mark.parametrize("with_valid", [False, True])
def test_dsec_writer_writes_jax_bytes(tmp_path, with_valid):
    """write_flow_dsec_png writes the JAX package's bytes (clipping at
    +-256 px, 1/128 px quantization, the valid plane), and the port reads
    them back to the quantized flow."""
    rng = np.random.default_rng(2)
    flow = rng.normal(0.0, 60.0, (2, 17, 29))
    flow[0, 0, :3] = (300.0, -300.0, 1 / 256)
    valid = rng.random((17, 29)) > 0.3 if with_valid else None
    tio.write_flow_dsec_png(tmp_path / "port.png", flow, valid)
    jio.write_flow_dsec_png(tmp_path / "jax.png", flow, valid)
    assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
    back = tio.read_png16(tmp_path / "port.png")
    want = np.clip(np.rint(flow[::-1] * 128.0 + 2**15), 0, 65535)
    np.testing.assert_array_equal(back[..., :2], np.moveaxis(want, 0, -1))
    np.testing.assert_array_equal(back[..., 2], 1.0 if valid is None else valid.astype(np.float64))
    for bad in (flow[0], flow[None]):
        for write in (tio.write_flow_dsec_png, jio.write_flow_dsec_png):
            with pytest.raises(ValueError, match=r"expected \[2, H, W\]"):
                write(tmp_path / "bad.png", bad)


@pytest.mark.parametrize("fmt", ["dsec_png", "npz"])
def test_save_flow_frame_matches_jax(tmp_path, fmt):
    """save_flow_frame: the benchmark layout (flow_submission/<NNNNNN>),
    the same PNG bytes, or the same float32 ``flow`` array; an unknown
    format is refused by both."""
    flow = np.random.default_rng(4).normal(0.0, 5.0, (2, 9, 13))
    tio.save_flow_frame(tmp_path / "port", 12, flow, fmt)
    jio.save_flow_frame(tmp_path / "jax", 12, flow, fmt)
    name = "000012." + ("png" if fmt == "dsec_png" else "npz")
    got, want = tmp_path / "port" / "flow_submission" / name, tmp_path / "jax" / "flow_submission" / name
    if fmt == "dsec_png":
        assert got.read_bytes() == want.read_bytes()
    else:
        with np.load(got) as g, np.load(want) as w:
            assert g.files == w.files == ["flow"] and g["flow"].dtype == w["flow"].dtype == np.float32
            np.testing.assert_array_equal(g["flow"], w["flow"])
    for save in (tio.save_flow_frame, jio.save_flow_frame):
        with pytest.raises(ValueError, match="unknown save_flow format"):
            save(tmp_path / "x", 0, flow, "exr")
