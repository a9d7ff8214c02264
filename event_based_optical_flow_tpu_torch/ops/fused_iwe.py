"""Fused flow gather + multi-reference-time warp + bilinear vote: the CMax
objective's rasterizer, as a hand-written CUDA kernel pair with a plain
PyTorch version beside it.

Replaces the TPU kernels of the JAX package (one contract, two TPU
layouts):

* ``ops/pallas_objective.py::fused_multi_iwe`` — ``_fwd_kernel`` and the
  custom-VJP ``_bwd_kernel`` on unpacked events;
* ``ops/pallas_objective_banded.py::fused_multi_iwe_banded`` — the same
  contract on events packed by row band (``_fwd_kernel``/``_fwd_one_chunk``,
  ``_bwd_kernel``/``_bwd_one_chunk``), the TPU main path.

Contract, for events ``x, y, dtf, wt`` ``[N]`` and a flow ``[2, H, W]``:
image ``k`` of the ``[(orig) + K, H, W]`` result is the bilinear vote of
every event warped to ``x - (dtf - o_k) u, y - (dtf - o_k) v``, with
``(u, v)`` gathered at the TRUNCATED source pixel (zero outside the image)
and corners at ``floor(c + eps)``; image 0 is the unwarped vote when
``include_orig``.  The backward gives ``dflow`` from one-sided corner
derivatives; ``x, y, dtf, wt`` get no gradient.  Band/tile packing, row
windows and bf16 splits were TPU layout and are not carried over.

Routing: ``fused_iwe`` runs the plain version for a tensor on the CPU and
the kernel (``FusedIWE``) for a CUDA tensor; a CUDA tensor never falls
back — an unsupported input raises.

On the H100 the kernel is bound by scattered atomic adds (votes) and
gathers (cotangent reads), not FLOPs: see ``csrc/fused_iwe.cu``.  Float
atomics would make every sum depend on the order in which the adds land,
which changes from run to run.  This pair gives the same bits on every
run instead: the forward sums the votes in 64-bit fixed point (integer
atomics, whose order cannot change the sum), and the backward sums each
source pixel's events in index order, one add per pixel when the events
are sorted by source pixel, as ``FrameEvents`` sorts them.  The plain
version sums in another order, so the two agree to rounding.
"""

import ctypes
from typing import Sequence

import torch

from .cuda_build import load_kernel_library

Tensor = torch.Tensor

KERNEL_SOURCE = "event_based_optical_flow_tpu_torch/csrc/fused_iwe.cu"
MAX_OFFSETS = 8  # kMaxOffsets in csrc/fused_iwe.cu
# The forward's fixed-point sums (2^-36 units in an int64) hold 2^27 weight
# units per pixel: with |wt| <= 2, fewer than 2^26 events never overflow.
MAX_EVENTS = 2**26

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_DBL = ctypes.c_double
_FWD_ARGS = [_PTR] * 4 + [_INT, _PTR, _PTR, _INT, _INT, _INT, _INT, _DBL, _PTR, _PTR, _PTR]
_BWD_ARGS = [_PTR] * 4 + [_INT, _PTR, _PTR, _INT, _INT, _INT, _INT, _DBL, _PTR, _PTR, _PTR, _PTR]
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _library():
    kl = load_kernel_library("fused_iwe")
    lib = kl.lib
    if not getattr(lib, "_evflow_bound", False):
        for direction, args in (("fwd", _FWD_ARGS), ("bwd", _BWD_ARGS)):
            for suffix in _SUFFIX.values():
                fn = getattr(lib, f"evflow_fused_iwe_{direction}_{suffix}")
                fn.argtypes = args
                fn.restype = ctypes.c_int
        lib.evflow_max_offsets.restype = ctypes.c_int
        if lib.evflow_max_offsets() != MAX_OFFSETS:
            raise RuntimeError("csrc/fused_iwe.cu and ops/fused_iwe.py disagree on kMaxOffsets")
        lib._evflow_bound = True
    return lib


def _check(flow: Tensor, events: Sequence[Tensor], offsets: Sequence[float]):
    """Raise on anything the kernel does not take."""
    if flow.device.type != "cuda":
        raise ValueError(f"the fused_iwe kernel runs on CUDA tensors, got a {flow.device} tensor")
    if flow.dtype not in _SUFFIX:
        raise TypeError(f"fused_iwe kernel takes float32 or float64, got {flow.dtype}")
    if flow.ndim != 3 or flow.shape[0] != 2 or not flow.is_contiguous():
        raise ValueError(f"flow must be a contiguous [2, H, W] tensor, got {tuple(flow.shape)}")
    n = events[0].shape[0]
    for t in events:
        if t.device != flow.device or t.dtype != flow.dtype:
            raise ValueError("x, y, dtf, wt must share the flow's device and dtype")
        if t.ndim != 1 or t.shape[0] != n or not t.is_contiguous():
            raise ValueError("x, y, dtf, wt must be contiguous [N] tensors of one length")
    if len(offsets) > MAX_OFFSETS:
        raise ValueError(f"at most {MAX_OFFSETS} reference-time offsets, got {len(offsets)}")
    if n >= MAX_EVENTS:
        raise ValueError(f"fused_iwe takes fewer than {MAX_EVENTS} events (fixed-point sums), got {n}")
    if (len(offsets) + 1) * flow.shape[1] * flow.shape[2] >= 2**31:
        raise ValueError("fused_iwe indexes with 32-bit ints: too many pixels")


def _launch(name: str, flow: Tensor, args):
    stream = torch.cuda.current_stream(flow.device).cuda_stream
    with torch.cuda.device(flow.device):
        rc = getattr(_library(), name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed: cudaGetLastError() = {rc}")


def fused_iwe_fwd(flow: Tensor, x: Tensor, y: Tensor, dtf: Tensor, wt: Tensor,
                  offsets: Sequence[float], include_orig: bool, eps: float = 1e-6) -> Tensor:
    """Launch the forward kernel: ``[(orig) + len(offsets), H, W]`` images."""
    _check(flow, (x, y, dtf, wt), offsets)
    h, w = flow.shape[1], flow.shape[2]
    shape = (len(offsets) + int(include_orig), h, w)
    # fixed-point sums; freed on return while the kernels may still run,
    # which is safe: the caching allocator reuses it only in stream order
    acc = torch.zeros(shape, dtype=torch.int64, device=flow.device)
    out = torch.empty(shape, dtype=flow.dtype, device=flow.device)
    offs = (ctypes.c_double * MAX_OFFSETS)(*offsets)
    _launch(
        f"evflow_fused_iwe_fwd_{_SUFFIX[flow.dtype]}", flow,
        (x.data_ptr(), y.data_ptr(), dtf.data_ptr(), wt.data_ptr(), x.shape[0],
         flow.data_ptr(), offs, len(offsets), int(include_orig), h, w, float(eps),
         acc.data_ptr(), out.data_ptr()),
    )
    fused_iwe_fwd.launches += 1
    return out


def fused_iwe_bwd(flow: Tensor, x: Tensor, y: Tensor, dtf: Tensor, wt: Tensor, g: Tensor,
                  offsets: Sequence[float], include_orig: bool, eps: float = 1e-6) -> Tensor:
    """Launch the backward kernel: ``dflow [2, H, W]`` for the image
    cotangent ``g [(orig) + len(offsets), H, W]``."""
    _check(flow, (x, y, dtf, wt), offsets)
    k_total = len(offsets) + int(include_orig)
    if g.shape != (k_total,) + tuple(flow.shape[1:]) or g.dtype != flow.dtype \
            or g.device != flow.device or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous {(k_total,) + tuple(flow.shape[1:])} tensor "
                         f"like the flow, got {tuple(g.shape)} {g.dtype}")
    h, w = flow.shape[1], flow.shape[2]
    duv = torch.empty((2, x.shape[0]), dtype=flow.dtype, device=flow.device)  # per-event du, dv
    dflow = torch.zeros_like(flow)
    offs = (ctypes.c_double * MAX_OFFSETS)(*offsets)
    _launch(
        f"evflow_fused_iwe_bwd_{_SUFFIX[flow.dtype]}", flow,
        (x.data_ptr(), y.data_ptr(), dtf.data_ptr(), wt.data_ptr(), x.shape[0],
         flow.data_ptr(), offs, len(offsets), int(include_orig), h, w, float(eps),
         g.data_ptr(), duv.data_ptr(), dflow.data_ptr()),
    )
    fused_iwe_bwd.launches += 1
    return dflow


fused_iwe_fwd.launches = 0
fused_iwe_bwd.launches = 0


def launch_counts() -> dict:
    return {"fwd": fused_iwe_fwd.launches, "bwd": fused_iwe_bwd.launches}


def reset_launch_counts() -> None:
    fused_iwe_fwd.launches = 0
    fused_iwe_bwd.launches = 0


class FusedIWE(torch.autograd.Function):
    """The kernel pair as an autograd function (CUDA tensors only);
    differentiable w.r.t. ``flow``."""

    @staticmethod
    def forward(ctx, flow, x, y, dtf, wt, offsets, include_orig, eps):
        flow = flow.contiguous()
        ctx.save_for_backward(flow, x, y, dtf, wt)
        ctx.config = (offsets, include_orig, eps)
        return fused_iwe_fwd(flow, x, y, dtf, wt, offsets, include_orig, eps)

    @staticmethod
    def backward(ctx, g):
        flow, x, y, dtf, wt = ctx.saved_tensors
        offsets, include_orig, eps = ctx.config
        dflow = fused_iwe_bwd(flow, x, y, dtf, wt, g.contiguous(), offsets, include_orig, eps)
        return dflow, None, None, None, None, None, None, None


def fused_iwe_reference(flow: Tensor, x: Tensor, y: Tensor, dtf: Tensor, wt: Tensor,
                        offsets: Sequence[float], include_orig: bool, eps: float = 1e-6) -> Tensor:
    """The kernel's plain PyTorch version: gather, warp, accumulate the
    corner votes with ``index_put_(accumulate=True)``; autograd gives the
    backward."""
    h, w = flow.shape[-2], flow.shape[-1]
    inside = (x > -1) & (x < h) & (y > -1) & (y < w)
    zero = torch.zeros_like(x)
    lin = (torch.where(inside, x, zero).to(torch.int64) * w
           + torch.where(inside, y, zero).to(torch.int64))
    u = torch.where(inside, flow[0].reshape(-1)[lin], zero)
    v = torch.where(inside, flow[1].reshape(-1)[lin], zero)
    coords = [(x, y)] if include_orig else []
    for off in offsets:
        dt = dtf - off
        coords.append((x - dt * u, y - dt * v))
    inds, vals = [], []
    for k, (xw, yw) in enumerate(coords):
        flx = torch.floor(xw + eps)
        fly = torch.floor(yw + eps)
        fx = xw - flx
        fy = yw - fly
        for dr, dc, wgt in (
            (0, 0, (1 - fx) * (1 - fy) * wt),
            (1, 0, fx * (1 - fy) * wt),
            (0, 1, (1 - fx) * fy * wt),
            (1, 1, fx * fy * wt),
        ):
            row = flx + dr
            col = fly + dc
            ok = (row >= 0) & (row < h) & (col >= 0) & (col < w)
            idx = torch.where(ok, k * h * w + row * w + col, zero)
            inds.append(idx.to(torch.int64))
            vals.append(torch.where(ok, wgt, zero))
    images = torch.zeros(len(coords) * h * w, dtype=flow.dtype, device=flow.device)
    images = images.index_put((torch.cat(inds),), torch.cat(vals), accumulate=True)
    return images.reshape(len(coords), h, w)


def fused_iwe(flow: Tensor, x: Tensor, y: Tensor, dtf: Tensor, wt: Tensor,
              offsets: Sequence[float], include_orig: bool, eps: float = 1e-6) -> Tensor:
    """``[(orig) + len(offsets), H, W]`` raw (unblurred) IWEs, differentiable
    w.r.t. ``flow``: the plain version for CPU tensors, the CUDA kernel
    for CUDA tensors."""
    if flow.device.type == "cpu":
        return fused_iwe_reference(flow, x, y, dtf, wt, offsets, include_orig, eps)
    return FusedIWE.apply(flow, x, y, dtf, wt, tuple(float(o) for o in offsets),
                          bool(include_orig), float(eps))
