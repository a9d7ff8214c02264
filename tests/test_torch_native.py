"""The port's native host decoders (``native/``) against the JAX package's
native decoders and the port's numpy decoders, bit for bit: the format
conformance vectors, seeded random word streams (any type code: TIME_HIGH
rollovers, events before the first time base, vectors before their base),
PNG payloads with every scanline filter at 2, 6 and 8 bytes per pixel, and
malformed payloads, which raise as the JAX package's do.  The loaders
decode through ``native``; a failed or impossible build raises, with no
fallback."""

import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

from event_based_optical_flow_tpu import native as jnative
from event_based_optical_flow_tpu_torch import native
from event_based_optical_flow_tpu_torch.data import evt2 as tevt2
from event_based_optical_flow_tpu_torch.data import evt3 as tevt3
from event_based_optical_flow_tpu_torch.flow import io as tio

from test_torch_data import EVT2_SPEC, EVT3_SPEC, _evt3
from test_torch_flow_io import _image, png16

ROOT = Path(__file__).resolve().parent.parent


def _same(*decodes):
    first = decodes[0]
    for other in decodes[1:]:
        assert len(other) == len(first)
        for a, b in zip(first, other):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _streams(fmt: str):
    """The spec vectors, then seeded random streams of every type code, and
    for EVT3 a stream whose TIME_HIGH wraps several times."""
    dtype, bits, spec = (np.uint32, 32, EVT2_SPEC) if fmt == "evt2" else (np.uint16, 16, EVT3_SPEC)
    for words in spec:
        yield np.asarray(words, dtype)
    rng = np.random.default_rng(2024)
    for n in (1, 17, 4096, 50000):
        yield rng.integers(0, 1 << bits, size=n, dtype=np.uint64).astype(dtype)
    if fmt == "evt3":
        words = []
        for k in range(3000):
            words += [_evt3(0x8, (k * 37) % 4096), _evt3(0x6, k % 4096), _evt3(0x0, k % 480),
                      _evt3(0x2, ((k & 1) << 11) | (k % 640)), _evt3(0x3, k % 600), _evt3(0x4, k % 4096)]
        yield np.asarray(words, dtype)


@pytest.mark.parametrize("fmt", ["evt2", "evt3"])
def test_decoders_match_jax_native_and_numpy(fmt):
    decode, numpy_decode, jax_decode = (
        (native.decode_evt2, tevt2.decode_evt2_numpy, jnative.decode_evt2) if fmt == "evt2"
        else (native.decode_evt3, tevt3.decode_evt3_numpy, jnative.decode_evt3))
    for words in _streams(fmt):
        got = decode(words)
        assert all(a.dtype == np.float64 for a in got)
        _same(got, numpy_decode(words), jax_decode(words))


def _payload(rng, h: int, stride: int) -> bytes:
    """``h`` rows of random bytes, row i with filter type i % 5."""
    rows = rng.integers(0, 256, (h, stride), dtype=np.uint8)
    return b"".join(bytes([i % 5]) + rows[i].tobytes() for i in range(h))


@pytest.mark.parametrize("bpp", [2, 6, 8])
def test_png_defilter_matches_jax_and_plain(bpp):
    rng = np.random.default_rng(bpp)
    for h, width in ((1, 1), (5, 3), (23, 31)):
        stride = width * bpp
        raw = _payload(rng, h, stride)
        got = native.png_defilter(raw, h, stride, bpp)
        assert got.dtype == np.uint8 and got.shape == (h, stride)
        np.testing.assert_array_equal(got, tio._defilter(raw, h, stride, bpp))
        np.testing.assert_array_equal(got, jnative.png_defilter(raw, h, stride, bpp))


@pytest.mark.parametrize("case", ["filter type 5", "short payload", "long payload", "bpp above stride", "bpp 0"])
def test_malformed_png_payloads_raise_as_jax(case):
    rng = np.random.default_rng(0)
    h, stride, bpp = 4, 12, 6
    raw = _payload(rng, h, stride)
    if case == "filter type 5":
        raw = raw[:stride + 1] + b"\x05" + raw[stride + 2:]
    elif case == "short payload":
        raw = raw[:-1]
    elif case == "long payload":
        raw = raw + b"\x00"
    else:
        bpp = stride + 1 if case == "bpp above stride" else 0
    for defilter in (native.png_defilter, jnative.png_defilter):
        with pytest.raises(ValueError, match="malformed PNG payload"):
            defilter(raw, h, stride, bpp)


def test_loaders_take_the_native_route(tmp_path, monkeypatch):
    """``read_raw_evt2`` / ``read_raw_evt3`` / ``decode_png16`` call the
    native decoders (and give the plain versions' arrays)."""
    calls = []

    def spy(name):
        real = getattr(native, name)

        def wrapped(*args, **kwargs):
            calls.append(name)
            return real(*args, **kwargs)

        monkeypatch.setattr(native, name, wrapped)

    for name in ("decode_evt2", "decode_evt3", "png_defilter"):
        spy(name)
    rng = np.random.default_rng(5)
    for fmt, dtype, bits, read, plain in (("EVT2", "<u4", 32, tevt2.read_raw_evt2, tevt2.decode_evt2_numpy),
                                          ("EVT3", "<u2", 16, tevt3.read_raw_evt3, tevt3.decode_evt3_numpy)):
        words = rng.integers(0, 1 << bits, size=3000, dtype=np.uint64).astype(dtype)
        path = tmp_path / f"{fmt}.raw"
        path.write_bytes(f"% format {fmt};height=480;width=640\n".encode() + words.tobytes())
        _same(read(str(path)), plain(words))
    img = _image(3)
    np.testing.assert_array_equal(tio.decode_png16(png16(img, filters=(0, 1, 2, 3, 4))), img)
    assert calls == ["decode_evt2", "decode_evt3", "png_defilter"]


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """A source g++ refuses raises with g++'s output and leaves no file;
    ``available()`` is False, and the loaders raise too: nothing falls back
    to numpy.  Without g++ the error names it."""
    src = tmp_path / "src"
    src.mkdir()
    for name in native.SOURCES:
        (src / f"{name}.cpp").write_text("this is not C++;\n")
    out = tmp_path / "build"
    monkeypatch.setattr(native, "SRC_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", out)
    monkeypatch.setattr(native, "_LOADED", {})
    with pytest.raises(RuntimeError, match=r"g\+\+ failed for .*evt2\.cpp.*\n.*error"):
        native.decode_evt2(np.zeros(3, np.uint32))
    assert not native.available()
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        tio.decode_png16(png16(_image(1)))
    assert not out.exists() or not any(out.iterdir())
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        native.load_library("png16")


def test_concurrent_builds_converge(tmp_path):
    """Three processes building into one empty directory at once end with
    one library per source and no temporary file."""
    code = ("import sys; from pathlib import Path; from event_based_optical_flow_tpu_torch import native; "
            "native.BUILD_DIR = Path(sys.argv[1]); assert native.available()")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT) for _ in range(3)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0, 0]
    names = sorted(p.name for p in tmp_path.iterdir())
    assert len(names) == len(native.SOURCES) and all(n.endswith(".so") for n in names), names


def test_png16_payload_through_zlib_matches_plain():
    """A DSEC-sized 16-bit RGB frame's payload with Paeth and Average rows
    (the rows real encoders pick): the native defilter's bytes are the
    plain version's."""
    rng = np.random.default_rng(11)
    h, stride = 48, 640 * 6
    rows = rng.integers(0, 256, (h, stride), dtype=np.uint8)
    raw = zlib.decompress(zlib.compress(b"".join(bytes([3 + i % 2]) + rows[i].tobytes() for i in range(h))))
    np.testing.assert_array_equal(native.png_defilter(raw, h, stride, 6), tio._defilter(raw, h, stride, 6))
