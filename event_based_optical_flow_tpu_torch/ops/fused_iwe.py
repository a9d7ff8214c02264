"""Fused flow gather + multi-reference-time warp + bilinear vote: the CMax
objective's rasterizer, as hand-written CUDA kernels with a plain PyTorch
version beside each: the forward (K1) and its backward (K2), and the two
kernels of the analytic Hessian-vector product, the tangent of the
forward along a flow direction (K3, ``fused_iwe_jvp``) and the
second-order backward (K4, ``fused_iwe_hvp_bwd``).  Each also takes a
time-aware flow voxel ``[T, 2, H, W]`` with per-event time bins
(``bins``): K5 (forward and backward) and K6 (tangent and HVP backward).

Replaces the TPU kernels of the JAX package (one contract, three TPU
layouts):

* ``ops/pallas_objective.py::fused_multi_iwe`` — ``_fwd_kernel`` and the
  custom-VJP ``_bwd_kernel`` on unpacked events;
* ``ops/pallas_objective_banded.py::fused_multi_iwe_banded`` — the same
  contract on events packed by row band (``_fwd_kernel``/``_fwd_one_chunk``,
  ``_bwd_kernel``/``_bwd_one_chunk``), the TPU main path;
* ``ops/pallas_objective_banded.py::fused_multi_iwe_banded_voxel`` (K5,
  ``_vox_fwd_impl`` / ``_vox_vjp_bwd``) and ``..._voxel_jvp`` /
  ``..._voxel_hvp_bwd`` (K6): the same on events packed by (time bin, row
  band), the flow a voxel;
* the fleet's batched forms (K7: ``_fwd_impl_batched`` / ``_vjp_bwd_b``,
  ``_vox_fwd_impl_batched`` / ``_vox_vjp_bwd_b``, ``..._jvp_batched``,
  ``..._hvp_bwd_batched``, ``..._voxel_jvp_batched``,
  ``..._voxel_hvp_bwd_batched``) and
  ``ops/pallas_objective_batched.py::fused_multi_iwe_batched`` (K9, the
  batched forward and backward on unpacked events): each of the above with
  a leading frame axis.

Contract, for events ``x, y, dtf, wt`` ``[N]`` and a flow ``[2, H, W]``:
image ``k`` of the ``[(orig) + K, H, W]`` result is the bilinear vote of
every event warped to ``x - (dtf - o_k) u, y - (dtf - o_k) v``, with
``(u, v)`` gathered at the TRUNCATED source pixel (zero outside the image)
and corners at ``floor(c + eps)``; image 0 is the unwarped vote when
``include_orig``.  The backward gives ``dflow`` from one-sided corner
derivatives; ``x, y, dtf, wt`` get no gradient.  With ``bins`` (int32
``[N]``) the flow is a voxel ``[T, 2, H, W]``: each event gathers from its
bin's slice (a bin outside ``[0, T)`` is clipped into it, as the TPU packer
clips it) and the backward gives ``dvoxel [T, 2, H, W]``.  With
``frames`` (a ``Frames`` table) the events of B frames lie concatenated in
frame order, the flow (voxel) and every image, tangent and cotangent gain a
leading frame axis ``[B, ...]``, and frame b's results are, bit for bit,
the single-frame kernels' on frame b's events alone (``csrc/fused_iwe.cu``).
Band/tile packing, row windows, padding to a common chunk count and bf16
splits were TPU layout and are not carried over.

Routing: ``fused_iwe``, ``fused_iwe_jvp`` and ``fused_iwe_hvp_bwd`` run the
plain version for a tensor on the CPU and the kernel for a CUDA tensor; a
CUDA tensor never falls back — an unsupported input raises.

Float atomics would make every sum depend on the order in which the adds
land, which changes from run to run.  This pair gives the same bits on
every run instead: the forward sums the votes in 64-bit fixed point
(integers, whose order cannot change the sum) with integer atomics, and
the backward sums each source pixel's events in index order in one pass,
one add per pixel when the events are sorted by source pixel (by time bin,
then source pixel, for a voxel), as ``FrameEvents`` sorts them.  The plain
version sums in another order, so the two agree to rounding;
``fused_iwe_fixed_reference`` and ``fused_iwe_bwd_ordered_reference`` are
exact models of the kernels' bits, for tests and checks.  K3 sums its
tangent images in fixed point too, in a unit scaled per frame on the device
to the frame's largest tangent vote, and K4 takes K2's one-pass kernel.
"""

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .cuda_build import load_kernel_library

Tensor = torch.Tensor

KERNEL_SOURCE = "event_based_optical_flow_tpu_torch/csrc/fused_iwe.cu"
MAX_OFFSETS = 8  # kMaxOffsets in csrc/fused_iwe.cu
# The forward's fixed-point sums (2^-36 units in an int64) hold 2^27 weight
# units per pixel: with |wt| <= 2, fewer than 2^26 events never overflow.
# K3's tangent unit 2^-s is chosen per frame so that 2 N b 2^s < 2^62 (b the
# largest event's tangent bound): no overflow at any N, and below 2^26 events
# every tangent vote keeps at least 2^-35 of b.  Both bounds hold per frame.
MAX_EVENTS = 2**26
FIX_BITS = 36  # kFixBits in csrc/fixed_point.cuh

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_DBL = ctypes.c_double
# x, y, dtf, wt, bins, n_bins, frame_ptr, n_frames, n, then each kernel's own
_EVENTS = [_PTR] * 5 + [_INT, _PTR, _INT, _INT]
_ARGS = {
    "fwd": _EVENTS + [_PTR, _PTR, _INT, _INT, _INT, _INT, _DBL, _PTR, _PTR, _PTR],
    "bwd": _EVENTS + [_PTR, _PTR, _INT, _INT, _INT, _INT, _DBL, _PTR, _PTR, _PTR],
    "jvp": _EVENTS + [_PTR, _PTR, _PTR, _INT, _INT, _INT, _DBL, _INT] + [_PTR] * 6,
    "hvp_bwd": _EVENTS + [_PTR, _PTR, _PTR, _INT, _INT, _INT, _DBL, _INT] + [_PTR] * 4,
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
KERNELS = ("fwd", "bwd", "jvp", "hvp_bwd")
# the launch counts' forms of each kernel: single frame or batched, dense or voxel
FORMS = ("", "voxel_", "batched_", "batched_voxel_")


class Frames(NamedTuple):
    """The frames of a batch whose events lie concatenated in frame order:
    frame b holds events ``[ptr[b], ptr[b + 1])``.  ``ptr`` is int32 ``[B +
    1]`` on the events' device, ``sizes`` the host's copy of the per-frame
    event counts (the wrappers check them without reading the device)."""

    ptr: torch.Tensor
    sizes: Tuple[int, ...]

    @classmethod
    def of_sizes(cls, sizes: Sequence[int], device) -> "Frames":
        ptr = np.concatenate([[0], np.cumsum(np.asarray(sizes, dtype=np.int64))])
        return cls(torch.as_tensor(ptr.astype(np.int32), device=device), tuple(int(s) for s in sizes))

    def index(self) -> torch.Tensor:
        """Each event's frame (int64 ``[N]``): the plain versions' layout."""
        dev = self.ptr.device
        return torch.repeat_interleave(torch.arange(len(self.sizes), device=dev),
                                       torch.as_tensor(self.sizes, device=dev), output_size=sum(self.sizes))


@functools.lru_cache(maxsize=None)
def _kernel(kernel: str, dtype: torch.dtype):
    """The C entry point of one kernel and type, bound once."""
    lib = load_kernel_library("fused_iwe").lib
    lib.evflow_max_offsets.restype = ctypes.c_int
    if lib.evflow_max_offsets() != MAX_OFFSETS:
        raise RuntimeError("csrc/fused_iwe.cu and ops/fused_iwe.py disagree on kMaxOffsets")
    fn = getattr(lib, f"evflow_fused_iwe_{kernel}_{_SUFFIX[dtype]}")
    fn.argtypes = _ARGS[kernel]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _offsets_array(offsets: Tuple[float, ...]):
    """The offsets as the C interface's double array, one per distinct tuple."""
    return (ctypes.c_double * MAX_OFFSETS)(*offsets)


def _check_like(name: str, t: Tensor, shape, flow: Tensor):
    if tuple(t.shape) != tuple(shape) or t.dtype != flow.dtype or t.device != flow.device \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {tuple(shape)} tensor like the flow, "
                         f"got {tuple(t.shape)} {t.dtype} on {t.device}")


def _n_bins(flow: Tensor, bins: Optional[Tensor]) -> int:
    return 0 if bins is None else flow.shape[-4]


def _n_frames(frames: Optional[Frames]) -> int:
    return 1 if frames is None else len(frames.sizes)


def _lead(frames: Optional[Frames]) -> tuple:
    """The images' leading frame axis: ``(B,)`` with ``frames``, else ``()``."""
    return () if frames is None else (len(frames.sizes),)


@functools.lru_cache(maxsize=1024)
def _check_shapes(flow_shape: tuple, n: int, n_off: int, voxel: bool, sizes: Optional[tuple]):
    """The checks that depend on shapes alone, once per distinct call shape."""
    batched = sizes is not None
    if len(flow_shape) != 3 + voxel + batched or flow_shape[-3] != 2:
        layout = "[" + ("B, " if batched else "") + ("T, " if voxel else "") + "2, H, W]"
        raise ValueError(f"flow must be a contiguous {layout} tensor, got {flow_shape}")
    if n_off > MAX_OFFSETS:
        raise ValueError(f"at most {MAX_OFFSETS} reference-time offsets, got {n_off}")
    if batched and (len(sizes) != flow_shape[0] or sum(sizes) != n or min(sizes) < 0):
        raise ValueError(f"frames.sizes {sizes} must count the {n} events of the flow's {flow_shape[0]} frames")
    if max(sizes or (n,)) >= MAX_EVENTS:
        raise ValueError(f"fused_iwe takes fewer than {MAX_EVENTS} events per frame (fixed-point sums), "
                         f"got {max(sizes or (n,))}")
    if n >= 2**30:
        raise ValueError(f"fused_iwe indexes events with 32-bit ints: fewer than 2^30, got {n}")
    slices = max(n_off + 1, 2 * (flow_shape[-4] if voxel else 1))
    if (len(sizes) if batched else 1) * slices * flow_shape[-2] * flow_shape[-1] >= 2**31:
        raise ValueError("fused_iwe indexes with 32-bit ints: too many pixels")


def _check(flow: Tensor, events: Sequence[Tensor], offsets: Sequence[float],
           bins: Optional[Tensor], frames: Optional[Frames]):
    """Raise on anything the kernels do not take: each tensor's device,
    type and layout on every call, the shapes' limits once per shape."""
    if flow.device.type != "cuda":
        raise ValueError(f"the fused_iwe kernel runs on CUDA tensors, got a {flow.device} tensor")
    if flow.dtype not in _SUFFIX:
        raise TypeError(f"fused_iwe kernel takes float32 or float64, got {flow.dtype}")
    if not flow.is_contiguous():
        raise ValueError(f"flow must be contiguous, got strides {flow.stride()}")
    n = events[0].shape[0]
    for t in events:
        if t.device != flow.device or t.dtype != flow.dtype:
            raise ValueError("x, y, dtf, wt must share the flow's device and dtype")
        if t.ndim != 1 or t.shape[0] != n or not t.is_contiguous():
            raise ValueError("x, y, dtf, wt must be contiguous [N] tensors of one length")
    if bins is not None and (bins.device != flow.device or bins.dtype != torch.int32
                             or tuple(bins.shape) != (n,) or not bins.is_contiguous()):
        raise ValueError(f"bins must be a contiguous int32 [N] tensor on the flow's device, got "
                         f"{bins.dtype} {tuple(bins.shape)} on {bins.device}")
    sizes = None
    if frames is not None:
        ptr, sizes = frames
        if (ptr.device != flow.device or ptr.dtype != torch.int32 or tuple(ptr.shape) != (len(sizes) + 1,)
                or not ptr.is_contiguous()):
            raise ValueError(f"frames.ptr must be a contiguous int32 [B + 1] tensor on the flow's device, got "
                             f"{ptr.dtype} {tuple(ptr.shape)} on {ptr.device}")
    _check_shapes(tuple(flow.shape), n, len(offsets), bins is not None, sizes)


def _event_args(x: Tensor, y: Tensor, dtf: Tensor, wt: Tensor, flow: Tensor, bins: Optional[Tensor],
                frames: Optional[Frames]):
    """The C interface's leading arguments: x, y, dtf, wt, bins, n_bins,
    frame_ptr, n_frames, n."""
    return (x.data_ptr(), y.data_ptr(), dtf.data_ptr(), wt.data_ptr(),
            None if bins is None else bins.data_ptr(), _n_bins(flow, bins),
            None if frames is None else frames.ptr.data_ptr(), _n_frames(frames), x.shape[0])


# launches per kernel and form since the last reset
_LAUNCHES = {}


def form(bins: Optional[Tensor], frames: Optional[Frames]) -> str:
    """The launch counts' prefix of a call's form (``FORMS``)."""
    return ("batched_" if frames is not None else "") + ("voxel_" if bins is not None else "")


def _launch(kernel: str, flow: Tensor, bins: Optional[Tensor], frames: Optional[Frames], args):
    fn = _kernel(kernel, flow.dtype)
    device = flow.device
    if device.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"evflow_fused_iwe_{kernel}_{_SUFFIX[flow.dtype]} failed: cudaGetLastError() = {rc}")
    _LAUNCHES[form(bins, frames) + kernel] += 1


def launch_counts() -> dict:
    """Kernel launches per kernel since the last reset: ``fwd``, ``bwd``,
    ``jvp``, ``hvp_bwd`` (K1-K4), their ``voxel_`` forms (K5, K6) and the
    ``batched_`` and ``batched_voxel_`` forms of all four (K7, K9)."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for prefix in FORMS:
        for k in KERNELS:
            _LAUNCHES[prefix + k] = 0


reset_launch_counts()


def fused_iwe_fwd(flow: Tensor, x: Tensor, y: Tensor, dtf: Tensor, wt: Tensor,
                  offsets: Sequence[float], include_orig: bool, eps: float = 1e-6,
                  bins: Optional[Tensor] = None, frames: Optional[Frames] = None) -> Tensor:
    """Launch the forward kernel (K1; K5 with ``bins``; the batched forms
    with ``frames``): ``[(B,) (orig) + len(offsets), H, W]`` images."""
    _check(flow, (x, y, dtf, wt), offsets, bins, frames)
    h, w = flow.shape[-2], flow.shape[-1]
    shape = _lead(frames) + (len(offsets) + int(include_orig), h, w)
    # fixed-point sums; freed on return while the kernels may still run,
    # which is safe: the caching allocator reuses it only in stream order
    acc = torch.zeros(shape, dtype=torch.int64, device=flow.device)
    out = torch.empty(shape, dtype=flow.dtype, device=flow.device)
    _launch("fwd", flow, bins, frames,
            _event_args(x, y, dtf, wt, flow, bins, frames)
            + (flow.data_ptr(), _offsets_array(tuple(offsets)), len(offsets), int(include_orig), h, w,
               float(eps), acc.data_ptr(), out.data_ptr()))
    return out


def fused_iwe_bwd(flow: Tensor, x: Tensor, y: Tensor, dtf: Tensor, wt: Tensor, g: Tensor,
                  offsets: Sequence[float], include_orig: bool, eps: float = 1e-6,
                  bins: Optional[Tensor] = None, frames: Optional[Frames] = None) -> Tensor:
    """Launch the backward kernel (K2; K5's backward with ``bins``; the
    batched forms with ``frames``): the gradient of the flow (or voxel), its
    shape, for the image cotangent ``g [(B,) (orig) + len(offsets), H, W]``."""
    _check(flow, (x, y, dtf, wt), offsets, bins, frames)
    h, w = flow.shape[-2], flow.shape[-1]
    _check_like("g", g, _lead(frames) + (len(offsets) + int(include_orig), h, w), flow)
    dflow = torch.empty_like(flow)  # zeroed by the launcher
    _launch("bwd", flow, bins, frames,
            _event_args(x, y, dtf, wt, flow, bins, frames)
            + (flow.data_ptr(), _offsets_array(tuple(offsets)), len(offsets), int(include_orig), h, w,
               float(eps), g.data_ptr(), dflow.data_ptr()))
    return dflow


def fused_iwe_jvp(flow: Tensor, dflow: Tensor, x: Tensor, y: Tensor, dtf: Tensor, wt: Tensor,
                  offsets: Sequence[float], emit_value: bool, eps: float = 1e-6,
                  bins: Optional[Tensor] = None, frames: Optional[Frames] = None):
    """K3 (K6's tangent with ``bins``, ``flow`` and ``dflow`` voxels; the
    batched forms with ``frames``): the direction images' tangent along
    ``dflow`` (``[(B,) K, H, W]``, ``K = len(offsets)``, no orig image: its
    tangent is 0), and with ``emit_value`` first the images themselves,
    ``fused_iwe_fwd``'s bits: ``(images, dimages)``.  The plain version for
    CPU tensors, the kernel for CUDA tensors."""
    if flow.device.type == "cpu":
        return fused_iwe_jvp_reference(flow, dflow, x, y, dtf, wt, offsets, emit_value, eps, bins, frames)
    _check(flow, (x, y, dtf, wt), offsets, bins, frames)
    _check_like("dflow", dflow, flow.shape, flow)
    if not offsets:
        raise ValueError("fused_iwe_jvp computes direction images: give at least one offset")
    h, w = flow.shape[-2], flow.shape[-1]
    shape = _lead(frames) + (len(offsets), h, w)
    # bits of each frame's tangent bound
    bound = torch.zeros(_n_frames(frames), dtype=torch.int64, device=flow.device)
    acc_tan = torch.zeros(shape, dtype=torch.int64, device=flow.device)
    acc_val = torch.zeros(shape, dtype=torch.int64, device=flow.device) if emit_value else None
    out_tan = torch.empty(shape, dtype=flow.dtype, device=flow.device)
    out_val = torch.empty(shape, dtype=flow.dtype, device=flow.device) if emit_value else None
    _launch("jvp", flow, bins, frames,
            _event_args(x, y, dtf, wt, flow, bins, frames)
            + (flow.data_ptr(), dflow.data_ptr(), _offsets_array(tuple(offsets)), len(offsets), h, w, float(eps),
               int(bool(emit_value)), bound.data_ptr(),
               acc_val.data_ptr() if emit_value else None, acc_tan.data_ptr(),
               out_val.data_ptr() if emit_value else None, out_tan.data_ptr()))
    return (out_val, out_tan) if emit_value else out_tan


def fused_iwe_hvp_bwd(flow: Tensor, dflow: Tensor, g1: Tensor, g2: Tensor, x: Tensor, y: Tensor,
                      dtf: Tensor, wt: Tensor, offsets: Sequence[float], term_a: bool,
                      eps: float = 1e-6, bins: Optional[Tensor] = None,
                      frames: Optional[Frames] = None) -> Tensor:
    """K4 (K6's HVP backward with ``bins``, per bin ``[T, 2, H, W]``; the
    batched forms with ``frames``): the vote's flow-space HVP contribution
    from the cost cotangent ``g1`` and its directional derivative ``g2``
    (``[(B,) K, H, W]``): term B, the backward against ``g2``
    (``fused_iwe_bwd(g2)``'s bits with ``term_a`` off), plus with ``term_a``
    the vote's mixed second derivative against ``g1`` along ``dflow``.  The
    plain version for CPU tensors, the kernel for CUDA tensors."""
    if flow.device.type == "cpu":
        return fused_iwe_hvp_bwd_reference(flow, dflow, g1, g2, x, y, dtf, wt, offsets, term_a, eps,
                                           bins, frames)
    _check(flow, (x, y, dtf, wt), offsets, bins, frames)
    _check_like("dflow", dflow, flow.shape, flow)
    h, w = flow.shape[-2], flow.shape[-1]
    for name, g in (("g1", g1), ("g2", g2)):
        _check_like(name, g, _lead(frames) + (len(offsets), h, w), flow)
    if not offsets:
        raise ValueError("fused_iwe_hvp_bwd computes direction terms: give at least one offset")
    out = torch.empty_like(flow)  # zeroed by the launcher
    _launch("hvp_bwd", flow, bins, frames,
            _event_args(x, y, dtf, wt, flow, bins, frames)
            + (flow.data_ptr(), dflow.data_ptr(), _offsets_array(tuple(offsets)), len(offsets), h, w,
               float(eps), int(bool(term_a)), g1.data_ptr(), g2.data_ptr(), out.data_ptr()))
    return out


class FusedIWE(torch.autograd.Function):
    """The kernel pair (K1/K2, K5 with ``bins``, the batched forms with
    ``frames``) as an autograd function (CUDA tensors only); differentiable
    w.r.t. ``flow``."""

    @staticmethod
    def forward(ctx, flow, x, y, dtf, wt, bins, frames, offsets, include_orig, eps):
        flow = flow.contiguous()
        ctx.save_for_backward(flow, x, y, dtf, wt, bins)
        ctx.config = (frames, offsets, include_orig, eps)
        return fused_iwe_fwd(flow, x, y, dtf, wt, offsets, include_orig, eps, bins, frames)

    @staticmethod
    def backward(ctx, g):
        flow, x, y, dtf, wt, bins = ctx.saved_tensors
        frames, offsets, include_orig, eps = ctx.config
        dflow = fused_iwe_bwd(flow, x, y, dtf, wt, g.contiguous(), offsets, include_orig, eps, bins,
                              frames)
        return (dflow,) + (None,) * 9


def _slices(flow: Tensor, x: Tensor, bins: Optional[Tensor], frames: Optional[Frames]):
    """(the flow as ``[S, 2, H * W]`` slices, each event's slice ``frame * T
    + bin``, or None for one dense slice)."""
    n_bins = 1 if bins is None else flow.shape[-4]
    slab = None if bins is None else bins.to(torch.int64).clamp(0, n_bins - 1)
    if frames is not None:
        first = frames.index() * n_bins
        slab = first if slab is None else first + slab
    return flow.reshape(-1, 2, flow.shape[-2] * flow.shape[-1]), slab


def _gather_uv(flow: Tensor, x: Tensor, y: Tensor, bins: Optional[Tensor],
               frames: Optional[Frames]):
    """(u, v) of each event at its truncated source pixel (of its frame's
    and bin's slice), zero outside the image."""
    h, w = flow.shape[-2], flow.shape[-1]
    inside = (x > -1) & (x < h) & (y > -1) & (y < w)
    zero = torch.zeros_like(x)
    lin = (torch.where(inside, x, zero).to(torch.int64) * w
           + torch.where(inside, y, zero).to(torch.int64))
    per_slab, slab = _slices(flow, x, bins, frames)
    if slab is None:
        u, v = per_slab[0, 0, lin], per_slab[0, 1, lin]
    else:
        u, v = per_slab[slab, 0, lin], per_slab[slab, 1, lin]
    return torch.where(inside, u, zero), torch.where(inside, v, zero)


def _corner_votes(flow: Tensor, x: Tensor, y: Tensor, dtf: Tensor, wt: Tensor, offsets: Sequence[float],
                  include_orig: bool, eps: float, bins: Optional[Tensor], frames: Optional[Frames]):
    """(flat output index, value) of every corner vote, 0 at index 0 for a
    corner outside the image, and the images' shape: each value is the
    kernel's expression, an elementwise op per operation."""
    h, w = flow.shape[-2], flow.shape[-1]
    zero = torch.zeros_like(x)
    u, v = _gather_uv(flow, x, y, bins, frames)
    coords = [(x, y)] if include_orig else []
    for off in offsets:
        dt = dtf - off
        coords.append((x - dt * u, y - dt * v))
    n_img = len(coords)
    block = 0 if frames is None else frames.index() * (n_img * h * w)  # each event's image block
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
            idx = block + k * h * w + torch.where(ok, row * w + col, zero).to(torch.int64)
            inds.append(torch.where(ok, idx, 0))
            vals.append(torch.where(ok, wgt, zero))
    return torch.cat(inds), torch.cat(vals), _lead(frames) + (n_img, h, w)


def fused_iwe_reference(flow: Tensor, x: Tensor, y: Tensor, dtf: Tensor, wt: Tensor,
                        offsets: Sequence[float], include_orig: bool, eps: float = 1e-6,
                        bins: Optional[Tensor] = None, frames: Optional[Frames] = None) -> Tensor:
    """The kernel's plain PyTorch version: gather (from the voxel's bin
    slices with ``bins``, the frame's slices with ``frames``), warp,
    accumulate the corner votes into the frame's image block with one
    ``index_put_(accumulate=True)``; autograd gives the backward."""
    inds, vals, shape = _corner_votes(flow, x, y, dtf, wt, offsets, include_orig, eps, bins, frames)
    images = torch.zeros(int(np.prod(shape)), dtype=flow.dtype, device=flow.device)
    return images.index_put((inds,), vals, accumulate=True).reshape(shape)


def fused_iwe_fixed_reference(flow: Tensor, x: Tensor, y: Tensor, dtf: Tensor, wt: Tensor,
                              offsets: Sequence[float], include_orig: bool, eps: float = 1e-6,
                              bins: Optional[Tensor] = None, frames: Optional[Frames] = None) -> Tensor:
    """An exact model of the forward kernel's bits, for tests and checks
    (nothing on the main path calls it): each vote's value in the flow's
    type by the kernel's expressions, rounded half to even to an int64 of
    2^-36 units, the votes summed with an integer ``index_add_`` (any order
    gives the same integers), the sums converted to the flow's type.  Run it
    on CPU tensors: the card's own elementwise kernels may contract a
    multiply and an add, which the kernels are built not to do."""
    inds, vals, shape = _corner_votes(flow, x, y, dtf, wt, offsets, include_orig, eps, bins, frames)
    fixed = torch.round(vals.double() * 2.0 ** FIX_BITS).to(torch.int64)
    sums = torch.zeros(int(np.prod(shape)), dtype=torch.int64, device=flow.device).index_add_(0, inds, fixed)
    return (sums.double() * 2.0 ** -FIX_BITS).to(flow.dtype).reshape(shape)


def fused_iwe_bwd_ordered_reference(flow: Tensor, x: Tensor, y: Tensor, dtf: Tensor, wt: Tensor, g: Tensor,
                                    offsets: Sequence[float], include_orig: bool, eps: float = 1e-6,
                                    bins: Optional[Tensor] = None, frames: Optional[Frames] = None,
                                    g1: Optional[Tensor] = None, dflow: Optional[Tensor] = None) -> Tensor:
    """An exact model of the backward kernel's bits for events sorted by
    (frame, bin, source pixel), for tests and checks (nothing on the main
    path calls it): each event's du, dv summed over the offsets in
    ``event_grad``'s operation order (with ``g1`` and ``dflow``, K4's term
    A against ``g1`` along the tangent flow ``dflow`` too, no orig image),
    each run of one (frame, bin, source pixel) summed in index order from 0
    (vectorised over the position within a run), each run's sum added onto
    zeros.  Run it on CPU tensors (see ``fused_iwe_fixed_reference``)."""
    h, w = flow.shape[-2], flow.shape[-1]
    hw = h * w
    term_a = g1 is not None
    inside = (x > -1) & (x < h) & (y > -1) & (y < w)
    zero = torch.zeros_like(x)
    p = (torch.where(inside, x, zero).to(torch.int64) * w + torch.where(inside, y, zero).to(torch.int64))
    per_slab, slab = _slices(flow, x, bins, frames)
    slab = torch.zeros_like(p) if slab is None else slab
    u, v = _gather_uv(flow, x, y, bins, frames)
    if term_a:
        du_g, dv_g = _gather_uv(dflow, x, y, bins, frames)
    n_img = len(offsets) + int(include_orig)
    first = 0 if frames is None else frames.index() * (n_img * hw)  # each event's cotangent block
    g_flat, g1_flat = g.reshape(-1), None if g1 is None else g1.reshape(-1)

    def at(flat, k, r, c):  # flat[image k of the event's block][r, c], 0 outside
        ok = (r >= 0) & (r < h) & (c >= 0) & (c < w)
        idx = first + k * hw + torch.where(ok, r * w + c, zero).to(torch.int64)
        return torch.where(ok, flat[torch.where(ok, idx, 0)], zero)

    du, dv = zero.clone(), zero.clone()
    k0 = int(include_orig)
    for k, off in enumerate(offsets):
        dt = dtf - off
        xw = x - dt * u
        yw = y - dt * v
        flx = torch.floor(xw + eps)
        fly = torch.floor(yw + eps)
        ok = (flx >= -1) & (flx <= h - 1) & (fly >= -1) & (fly <= w - 1)
        fx = xw - flx
        fy = yw - fly
        g00, g10 = at(g_flat, k0 + k, flx, fly), at(g_flat, k0 + k, flx + 1, fly)
        g01, g11 = at(g_flat, k0 + k, flx, fly + 1), at(g_flat, k0 + k, flx + 1, fly + 1)
        dxw = wt * (((1 - fy) * g10 + fy * g11) - ((1 - fy) * g00 + fy * g01))
        dyw = wt * ((1 - fx) * (g01 - g00) + fx * (g11 - g10))
        du = torch.where(ok, du + (-dt) * dxw, du)
        dv = torch.where(ok, dv + (-dt) * dyw, dv)
        if term_a:
            s = wt * ((at(g1_flat, k, flx, fly) - at(g1_flat, k, flx, fly + 1))
                      - (at(g1_flat, k, flx + 1, fly) - at(g1_flat, k, flx + 1, fly + 1)))
            du = torch.where(ok, du + dt * dt * s * dv_g, du)
            dv = torch.where(ok, dv + dt * dt * s * du_g, dv)
    active = inside & (wt != 0)
    du, dv = torch.where(active, du, zero), torch.where(active, dv, zero)
    key = torch.where(inside, slab * hw + p, -1)
    prev = torch.cat([key.new_full((1,), -1), key[:-1]])
    head = (key >= 0) & (key != prev)
    run = torch.cumsum(head.long(), 0) - 1  # each event's run, in index order
    member = key >= 0
    start = torch.nonzero(head).squeeze(1)
    pos = torch.arange(len(key), device=key.device) - start[run.clamp(min=0)] if len(start) else torch.zeros_like(key)
    su = zero.new_zeros(len(start))
    sv = zero.new_zeros(len(start))
    for q in range(int(pos[member].max()) + 1 if member.any() else 0):
        sel = member & (pos == q)
        su[run[sel]] = su[run[sel]] + du[sel]
        sv[run[sel]] = sv[run[sel]] + dv[sel]
    target = 2 * hw * slab[start] + p[start]
    out = torch.zeros(flow.numel(), dtype=flow.dtype, device=flow.device)
    out.index_add_(0, torch.cat([target, target + hw]), torch.cat([su, sv]))
    return out.reshape(flow.shape)


def fused_iwe(flow: Tensor, x: Tensor, y: Tensor, dtf: Tensor, wt: Tensor,
              offsets: Sequence[float], include_orig: bool, eps: float = 1e-6,
              bins: Optional[Tensor] = None, frames: Optional[Frames] = None) -> Tensor:
    """``[(B,) (orig) + len(offsets), H, W]`` raw (unblurred) IWEs,
    differentiable w.r.t. ``flow`` (a voxel ``[(B,) T, 2, H, W]`` with
    ``bins``, a batch ``[B, ...]`` with ``frames``): the plain version for
    CPU tensors, the CUDA kernel for CUDA tensors."""
    if flow.device.type == "cpu":
        return fused_iwe_reference(flow, x, y, dtf, wt, offsets, include_orig, eps, bins, frames)
    return FusedIWE.apply(flow, x, y, dtf, wt, bins, frames, tuple(float(o) for o in offsets),
                          bool(include_orig), float(eps))


def fused_iwe_jvp_reference(flow: Tensor, dflow: Tensor, x: Tensor, y: Tensor, dtf: Tensor,
                            wt: Tensor, offsets: Sequence[float], emit_value: bool,
                            eps: float = 1e-6, bins: Optional[Tensor] = None,
                            frames: Optional[Frames] = None):
    """K3's and K6's plain version (and their batched forms'):
    ``torch.func.jvp`` of ``fused_iwe_reference``."""
    images, dimages = torch.func.jvp(
        lambda f: fused_iwe_reference(f, x, y, dtf, wt, offsets, False, eps, bins, frames), (flow,),
        (dflow,))
    return (images, dimages) if emit_value else dimages


def fused_iwe_hvp_bwd_reference(flow: Tensor, dflow: Tensor, g1: Tensor, g2: Tensor, x: Tensor,
                                y: Tensor, dtf: Tensor, wt: Tensor, offsets: Sequence[float],
                                term_a: bool, eps: float = 1e-6,
                                bins: Optional[Tensor] = None,
                                frames: Optional[Frames] = None) -> Tensor:
    """K4's and K6's plain version (and their batched forms'): term B is
    the VJP of ``fused_iwe_reference`` against ``g2``; term A the double
    backward of ``<vjp(flow)(g1), dflow>``."""
    with torch.enable_grad():
        fl = flow.detach().requires_grad_(True)
        images = fused_iwe_reference(fl, x, y, dtf, wt, offsets, False, eps, bins, frames)
        (out,) = torch.autograd.grad(images, fl, g2, retain_graph=term_a)
        if term_a:
            (vjp1,) = torch.autograd.grad(images, fl, g1, create_graph=True)
            (term,) = torch.autograd.grad((vjp1 * dflow).sum(), fl, allow_unused=True)
            if term is not None:
                out = out + term
    return out.detach()
