"""Native (C++) host decoders of the port (port of
``event_based_optical_flow_tpu/native/``): EVT2.0 and EVT3 word streams
(``evt2.cpp``, ``evt3.cpp``) and the PNG scanline defilter (``png16.cpp``).

Each decoder is a strictly sequential pass over a register state or a byte
recurrence, which vectorized numpy can only rebuild with forward fills, or
not at all (Paeth and Average rows go byte by byte in Python).  The
loaders (``data/evt2.py``, ``data/evt3.py``, ``flow/io.py``) decode through
these; the numpy decoders there stay as the plain versions the tests hold
these to, bit for bit.

Each source is built with ``g++ -O3 -shared -fPIC -std=c++17`` at first
use into ``build/native/`` at the root of the checkout, the source's hash
in the file name (``ops/cuda_build.build_library``, shared with the CUDA
kernels' build), and loaded by ctypes.  There is no fallback: a missing
``g++`` or a failed build raises with the compiler's output.
``available()`` says whether the three build and load.
"""

import ctypes
import shutil
from pathlib import Path

import numpy as np

from ..ops.cuda_build import PACKAGE_DIR, KernelLibrary, build_library

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR.parent / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
SOURCES = ("evt2", "evt3", "png16")

_F64 = ctypes.POINTER(ctypes.c_double)
# each library's entry point: (name, restype, argtypes)
_SIGNATURES = {
    "evt2": ("evf_decode_evt2", ctypes.c_int64,
             [ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64, _F64, _F64, _F64, _F64]),
    "evt3": ("evf_decode_evt3", ctypes.c_int64,
             [ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64, _F64, _F64, _F64, _F64]),
    "png16": ("evf_png_defilter", ctypes.c_int64,
              [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
               ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8)]),
}

_LOADED = {}


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the native decoders (native/*.cpp) are built with it at first use")
    return found


def load_library(name: str) -> KernelLibrary:
    """Build ``native/<name>.cpp`` if needed and load it, its entry point
    typed (cached per process)."""
    if name not in _LOADED:
        kl = build_library(name, SRC_DIR / f"{name}.cpp", (_gxx(), *GXX_FLAGS), BUILD_DIR)
        fn_name, restype, argtypes = _SIGNATURES[name]
        fn = getattr(kl.lib, fn_name)
        fn.restype, fn.argtypes = restype, argtypes
        _LOADED[name] = kl
    return _LOADED[name]


def available() -> bool:
    """Whether the three decoders build and load on this machine."""
    try:
        for name in SOURCES:
            load_library(name)
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _decode(name: str, words: np.ndarray, word_type, ctype, cap: int):
    words = np.ascontiguousarray(words, word_type)
    out = [np.empty(cap, np.float64) for _ in range(4)]
    fn = getattr(load_library(name).lib, _SIGNATURES[name][0])
    n_out = fn(_ptr(words, ctype), len(words), *(_ptr(a, ctypes.c_double) for a in out))
    if n_out < 0:
        raise RuntimeError(f"{_SIGNATURES[name][0]}: bad arguments")
    return tuple(a[:n_out] for a in out)


def decode_evt2(words: np.ndarray):
    """An EVT2.0 word stream (uint32) -> (x_col, y_row, t_us, polarity)
    float64 arrays (layout in ``evt2.cpp``)."""
    return _decode("evt2", words, np.uint32, ctypes.c_uint32, len(words))


def decode_evt3(words: np.ndarray):
    """An EVT3 word stream (uint16) -> (x_col, y_row, t_us, polarity)
    float64 arrays (the stateful layout in ``evt3.cpp``).  The outputs are
    sized by a typed pre-pass: one event per ADDR_X word, at most 12 per
    VECT_12 and 8 per VECT_8 (a blanket 12 per word would allocate ~192x
    the payload)."""
    words = np.ascontiguousarray(words, np.uint16)
    types = words >> 12
    cap = int(np.count_nonzero(types == 0x2) + 12 * np.count_nonzero(types == 0x4)
              + 8 * np.count_nonzero(types == 0x5))
    return tuple(a.copy() for a in _decode("evt3", words, np.uint16, ctypes.c_uint16, max(cap, 1)))


def png_defilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Reconstruct PNG scanlines from the inflated IDAT payload (``h`` rows
    of a filter-type byte and ``stride`` bytes): [h, stride] uint8.  Raises
    ``ValueError`` on a malformed payload (a bad filter type, a size that is
    not ``h * (stride + 1)``, ``bpp`` outside 1..stride), naming the fault."""
    raw_arr = np.frombuffer(raw, np.uint8)
    out = np.empty((h, stride), np.uint8)
    fn = load_library("png16").lib.evf_png_defilter
    if fn(_ptr(raw_arr, ctypes.c_uint8), len(raw_arr), h, stride, bpp, _ptr(out, ctypes.c_uint8)) < 0:
        raise ValueError(f"evf_png_defilter: malformed PNG payload ({_fault(raw_arr, h, stride, bpp)})")
    return out


def _fault(raw: np.ndarray, h: int, stride: int, bpp: int) -> str:
    """What ``evf_png_defilter`` refused, in the checks' order."""
    if h < 0 or stride <= 0 or not 0 < bpp <= stride:
        return f"h={h}, stride={stride}, bpp={bpp}"
    if len(raw) != h * (stride + 1):
        return f"payload size {len(raw)} != {h}x({stride}+1)"
    ftypes = raw[::stride + 1][:h]
    row = int(np.flatnonzero(ftypes > 4)[0])
    return f"bad PNG filter type {int(ftypes[row])} in row {row}"
