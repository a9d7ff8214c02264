"""Build and load the port's hand-written native sources.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` compiles it in seconds into ``build/kernels/`` at the root of the
checkout, at first use, and ``ctypes`` loads it.  The library's file name
carries a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source is never served from a stale build.
``build_library`` is that build for any compiler: the host decoders of
``native/`` go through it with ``g++``.  A build writes a per-process
temporary file and renames it into place, so concurrent processes converge
on one library.  Nothing here runs at import time: the CPU tests import
every module on machines without ``nvcc`` or a GPU.
"""

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Sequence

logger = logging.getLogger(__name__)

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

# sm_90a: Hopper with its architecture-specific features; -fmad=false keeps
# every multiply and add separately rounded, as PyTorch's elementwise ops
# round them in the kernels' plain versions.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
    "-Xptxas", "-v",
)


class KernelLibrary:
    """One compiled source (``csrc/<name>.cu``, or a ``native/`` decoder):
    the ctypes handle, the build's wall-clock seconds (0 when the library
    was already built) and the compiler's output (nvcc's ``-Xptxas -v``:
    registers, spills per kernel)."""

    def __init__(self, lib: ctypes.CDLL, path: Path, build_seconds: float, build_log: str):
        self.lib = lib
        self.path = path
        self.build_seconds = build_seconds
        self.build_log = build_log


_LOADED = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build_library(name: str, src: Path, cmd: Sequence[str], out_dir: Path,
                  extra_inputs: bytes = b"") -> KernelLibrary:
    """Compile ``src`` with ``cmd`` (the compiler and its flags; ``-o out
    src`` is appended) into ``out_dir/lib<name>-<hash>.so`` unless that
    file exists, and load it.  The hash covers the source, ``extra_inputs``
    (headers it includes) and the flags.  A failed build raises with the
    compiler's output and leaves no file behind."""
    digest = hashlib.sha256(src.read_bytes() + extra_inputs + " ".join(cmd[1:]).encode()).hexdigest()[:16]
    out = out_dir / f"lib{name}-{digest}.so"
    build_seconds, build_log = 0.0, ""
    if not out.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        try:
            proc = subprocess.run([*cmd, "-o", str(tmp), str(src)], capture_output=True, text=True)
            build_seconds = time.perf_counter() - t0
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"{Path(cmd[0]).name} failed for {src} ({proc.returncode}):\n{build_log}")
            os.replace(tmp, out)
        finally:
            tmp.unlink(missing_ok=True)
        logger.info(f"built {out.name} in {build_seconds:.1f} s")
    return KernelLibrary(ctypes.CDLL(str(out)), out, build_seconds, build_log)


def load_kernel_library(name: str) -> KernelLibrary:
    """Compile ``csrc/<name>.cu`` if needed and load it (cached per
    process: every launch asks for its library)."""
    if name not in _LOADED:
        headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
        _LOADED[name] = build_library(name, CSRC_DIR / f"{name}.cu", (_nvcc(), *NVCC_FLAGS), BUILD_DIR, headers)
    return _LOADED[name]
