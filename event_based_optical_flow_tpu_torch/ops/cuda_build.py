"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so
``nvcc`` compiles it in seconds into ``build/kernels/`` at the root of the
checkout, at first use, and ``ctypes`` loads it.  The library's file name
carries a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source is never served from a stale build.  Nothing
here runs at import time: the CPU tests import every module on machines
without ``nvcc`` or a GPU.
"""

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import time
from pathlib import Path

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
    """One compiled ``csrc/<name>.cu``: the ctypes handle, the build's
    wall-clock seconds (0 when the library was already built) and the
    compiler's output (``-Xptxas -v``: registers, spills per kernel)."""

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


def load_kernel_library(name: str) -> KernelLibrary:
    """Compile ``csrc/<name>.cu`` if needed and load it (cached per
    process: every launch asks for its library)."""
    if name in _LOADED:
        return _LOADED[name]
    src = CSRC_DIR / f"{name}.cu"
    content = src.read_bytes() + b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(content + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    build_seconds, build_log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src} ({proc.returncode}):\n{build_log}")
        os.replace(tmp, out)
        logger.info(f"built {out.name} in {build_seconds:.1f} s")
    kl = KernelLibrary(ctypes.CDLL(str(out)), out, build_seconds, build_log)
    _LOADED[name] = kl
    return kl
