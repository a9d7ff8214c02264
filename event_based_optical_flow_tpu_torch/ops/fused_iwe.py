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

Outer padding and the count vote (``solver.outer_padding``, ``iwe.method:
count``; the JAX package's unfused objective warps, then votes with its
``EventImageConverter``): with ``pad`` p every image, cotangent and tangent
is ``(H + 2p) x (W + 2p)`` and each position votes at ``c + p``, while the
flow is still gathered at the unpadded, truncated source pixel; ``pad`` 0
is the unpadded call, bit for bit.  ``count`` votes ``wt`` into each corner
inside the image (``fused_iwe`` and its forward only): a count image has
no flow derivative, so its gradient, tangent and HVP term are zeros,
launched by no kernel.

Routing: ``fused_iwe``, ``fused_iwe_bwd``, ``fused_iwe_jvp`` and
``fused_iwe_hvp_bwd`` run the plain version for a tensor on the CPU and the
kernel for a CUDA tensor; a CUDA tensor never falls back — an unsupported
input raises.

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
to the frame's largest tangent vote (``fused_iwe_jvp_fixed_reference``
models its bits), and K4 takes K2's one-pass kernel.
"""

import ctypes
import functools
import math
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
    "fwd": _EVENTS + [_PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _INT, _DBL, _PTR, _PTR, _PTR],
    "bwd": _EVENTS + [_PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _DBL, _PTR, _PTR, _PTR],
    "jvp": _EVENTS + [_PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _DBL, _INT] + [_PTR] * 4,
    "hvp_bwd": _EVENTS + [_PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _DBL, _INT] + [_PTR] * 4,
    # the event mesh's split entry points
    "fwd_acc": _EVENTS + [_PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _INT, _DBL, _PTR, _PTR],
    "from_fixed": [_PTR, _INT, _PTR, _PTR],
    "jvp_bound": _EVENTS + [_PTR, _PTR, _INT, _INT, _INT, _PTR, _PTR],
    "jvp_acc": _EVENTS + [_PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _DBL, _INT, _INT] + [_PTR] * 4,
    "from_scaled": [_PTR, _PTR, _INT, _PTR, _INT, _PTR, _PTR, _PTR],
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
KERNELS = ("fwd", "bwd", "jvp", "hvp_bwd")
# the launch counts' forms of each kernel: single frame or batched, dense or voxel
FORMS = ("", "voxel_", "batched_", "batched_voxel_")
# the event mesh's counts (form + kernel, ``mesh_launch_counts``): the
# launches of each kernel on a shard of a frame, and of the split's own passes
MESH_KERNELS = KERNELS + ("jvp_bound", "from_fixed", "from_scaled")


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


def _image_hw(flow: Tensor, pad: int) -> Tuple[int, int]:
    """The images' size for the flow's and the outer padding ``pad``."""
    return flow.shape[-2] + 2 * pad, flow.shape[-1] + 2 * pad


@functools.lru_cache(maxsize=1024)
def _check_shapes(flow_shape: tuple, n: int, n_off: int, voxel: bool, sizes: Optional[tuple], pad: int = 0):
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
    if pad < 0:
        raise ValueError(f"the outer padding must be >= 0, got {pad}")
    slices = max(n_off + 1, 2 * (flow_shape[-4] if voxel else 1))
    if (len(sizes) if batched else 1) * slices * (flow_shape[-2] + 2 * pad) * (flow_shape[-1] + 2 * pad) >= 2**31:
        raise ValueError("fused_iwe indexes with 32-bit ints: too many pixels")


def _check(flow: Tensor, events: Sequence[Tensor], offsets: Sequence[float],
           bins: Optional[Tensor], frames: Optional[Frames], pad: int = 0):
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
    _check_shapes(tuple(flow.shape), n, len(offsets), bins is not None, sizes, int(pad))


def _event_args(x: Tensor, y: Tensor, dtf: Tensor, wt: Tensor, flow: Tensor, bins: Optional[Tensor],
                frames: Optional[Frames]):
    """The C interface's leading arguments: x, y, dtf, wt, bins, n_bins,
    frame_ptr, n_frames, n."""
    return (x.data_ptr(), y.data_ptr(), dtf.data_ptr(), wt.data_ptr(),
            None if bins is None else bins.data_ptr(), _n_bins(flow, bins),
            None if frames is None else frames.ptr.data_ptr(), _n_frames(frames), x.shape[0])


# launches per kernel and form since the last reset, and of them (and of
# the split's passes) those on a shard of an event-sharded frame
_LAUNCHES = {}
_MESH_LAUNCHES = {}


def form(bins: Optional[Tensor], frames: Optional[Frames]) -> str:
    """The launch counts' prefix of a call's form (``FORMS``)."""
    return ("batched_" if frames is not None else "") + ("voxel_" if bins is not None else "")


def _launch(kernel: str, flow: Tensor, bins: Optional[Tensor], frames: Optional[Frames], args,
            count_as: Optional[str] = None, mesh: bool = False):
    """Call entry point ``kernel`` for ``flow``'s type on its device's
    stream; count one launch of ``count_as`` (default ``kernel``) in the
    call's form, and with ``mesh`` one of ``mesh_`` + that (a shard's)."""
    fn = _kernel(kernel, flow.dtype)
    device = flow.device
    if device.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"evflow_fused_iwe_{kernel}_{_SUFFIX[flow.dtype]} failed: cudaGetLastError() = {rc}")
    key = form(bins, frames) + (count_as or kernel)
    if key in _LAUNCHES:
        _LAUNCHES[key] += 1
    if mesh:
        _MESH_LAUNCHES[key] += 1


def launch_counts() -> dict:
    """Kernel launches per kernel since the last reset: ``fwd``, ``bwd``,
    ``jvp``, ``hvp_bwd`` (K1-K4), their ``voxel_`` forms (K5, K6) and the
    ``batched_`` and ``batched_voxel_`` forms of all four (K7, K9)."""
    return dict(_LAUNCHES)


def mesh_launch_counts() -> dict:
    """Of the launches since the last reset, those on a shard of an
    event-sharded frame, keyed as ``launch_counts`` keys them (dense and
    ``voxel_``), with the split's own passes: ``jvp_bound`` and the
    conversions ``from_fixed``, ``from_scaled``."""
    return dict(_MESH_LAUNCHES)


def add_launch_counts(counts: dict) -> None:
    """Add the entries of ``counts`` that name these kernels' forms."""
    for k, v in counts.items():
        if k in _LAUNCHES:
            _LAUNCHES[k] += v


def reset_launch_counts() -> None:
    for prefix in FORMS:
        for k in KERNELS:
            _LAUNCHES[prefix + k] = 0
    for k in MESH_KERNELS + tuple("voxel_" + k for k in KERNELS + ("jvp_bound",)):
        _MESH_LAUNCHES[k] = 0


reset_launch_counts()


def fused_iwe_fwd(flow: Tensor, x: Tensor, y: Tensor, dtf: Tensor, wt: Tensor,
                  offsets: Sequence[float], include_orig: bool, eps: float = 1e-6,
                  bins: Optional[Tensor] = None, frames: Optional[Frames] = None, pad: int = 0,
                  count: bool = False) -> Tensor:
    """Launch the forward kernel (K1; K5 with ``bins``; the batched forms
    with ``frames``): ``[(B,) (orig) + len(offsets), H + 2 pad, W + 2 pad]``
    images, count votes with ``count``."""
    _check(flow, (x, y, dtf, wt), offsets, bins, frames, pad)
    h, w = flow.shape[-2], flow.shape[-1]
    shape = _lead(frames) + (len(offsets) + int(include_orig),) + _image_hw(flow, pad)
    # fixed-point sums; freed on return while the kernels may still run,
    # which is safe: the caching allocator reuses it only in stream order
    acc = torch.zeros(shape, dtype=torch.int64, device=flow.device)
    out = torch.empty(shape, dtype=flow.dtype, device=flow.device)
    _launch("fwd", flow, bins, frames,
            _event_args(x, y, dtf, wt, flow, bins, frames)
            + (flow.data_ptr(), _offsets_array(tuple(offsets)), len(offsets), int(include_orig), h, w, int(pad),
               int(bool(count)), float(eps), acc.data_ptr(), out.data_ptr()))
    return out


def fused_iwe_bwd(flow: Tensor, x: Tensor, y: Tensor, dtf: Tensor, wt: Tensor, g: Tensor,
                  offsets: Sequence[float], include_orig: bool, eps: float = 1e-6,
                  bins: Optional[Tensor] = None, frames: Optional[Frames] = None, pad: int = 0,
                  mesh: bool = False) -> Tensor:
    """Launch the backward kernel (K2; K5's backward with ``bins``; the
    batched forms with ``frames``): the gradient of the flow (or voxel), its
    shape, for the image cotangent ``g [(B,) (orig) + len(offsets), H + 2
    pad, W + 2 pad]``.  The plain version (the VJP of
    ``fused_iwe_reference``) for CPU tensors.  ``mesh``: the events are a
    shard of a frame (counted as such)."""
    if flow.device.type == "cpu":
        with torch.enable_grad():
            fl = flow.detach().requires_grad_(True)
            images = fused_iwe_reference(fl, x, y, dtf, wt, offsets, include_orig, eps, bins, frames, pad)
            return torch.autograd.grad(images, fl, g)[0]
    _check(flow, (x, y, dtf, wt), offsets, bins, frames, pad)
    h, w = flow.shape[-2], flow.shape[-1]
    _check_like("g", g, _lead(frames) + (len(offsets) + int(include_orig),) + _image_hw(flow, pad), flow)
    dflow = torch.empty_like(flow)  # zeroed by the launcher
    _launch("bwd", flow, bins, frames,
            _event_args(x, y, dtf, wt, flow, bins, frames)
            + (flow.data_ptr(), _offsets_array(tuple(offsets)), len(offsets), int(include_orig), h, w, int(pad),
               float(eps), g.data_ptr(), dflow.data_ptr()), mesh=mesh)
    return dflow


def fused_iwe_jvp(flow: Tensor, dflow: Tensor, x: Tensor, y: Tensor, dtf: Tensor, wt: Tensor,
                  offsets: Sequence[float], emit_value: bool, eps: float = 1e-6,
                  bins: Optional[Tensor] = None, frames: Optional[Frames] = None, pad: int = 0,
                  count: bool = False):
    """K3 (K6's tangent with ``bins``, ``flow`` and ``dflow`` voxels; the
    batched forms with ``frames``): the direction images' tangent along
    ``dflow`` (``[(B,) K, H + 2 pad, W + 2 pad]``, ``K = len(offsets)``, no
    orig image: its tangent is 0), and with ``emit_value`` first the images
    themselves, ``fused_iwe_fwd``'s bits: ``(images, dimages)``.  The plain
    version for CPU tensors, the kernel for CUDA tensors.  A count vote's
    tangent is zeros (its images by the forward alone)."""
    if count:
        shape = _lead(frames) + (len(offsets),) + _image_hw(flow, pad)
        dimages = flow.new_zeros(shape)
        if not emit_value:
            return dimages
        with torch.no_grad():
            return fused_iwe(flow, x, y, dtf, wt, offsets, False, eps, bins, frames, pad, True), dimages
    if flow.device.type == "cpu":
        return fused_iwe_jvp_reference(flow, dflow, x, y, dtf, wt, offsets, emit_value, eps, bins, frames, pad)
    _check(flow, (x, y, dtf, wt), offsets, bins, frames, pad)
    _check_like("dflow", dflow, flow.shape, flow)
    if not offsets:
        raise ValueError("fused_iwe_jvp computes direction images: give at least one offset")
    h, w = flow.shape[-2], flow.shape[-1]
    shape = _lead(frames) + (len(offsets),) + _image_hw(flow, pad)
    n_out = int(np.prod(shape))
    # one int64 scratch, zeroed by the launcher: the tangent's fixed-point
    # sums, the value's (emit_value), each n_out rounded up to even, then the
    # bits of each frame's tangent bound
    scratch = torch.empty((1 + int(bool(emit_value))) * (n_out + n_out % 2) + _n_frames(frames),
                          dtype=torch.int64, device=flow.device)
    out_tan = torch.empty(shape, dtype=flow.dtype, device=flow.device)
    out_val = torch.empty(shape, dtype=flow.dtype, device=flow.device) if emit_value else None
    _launch("jvp", flow, bins, frames,
            _event_args(x, y, dtf, wt, flow, bins, frames)
            + (flow.data_ptr(), dflow.data_ptr(), _offsets_array(tuple(offsets)), len(offsets), h, w, int(pad),
               float(eps), int(bool(emit_value)), scratch.data_ptr(), out_val.data_ptr() if emit_value else None,
               out_tan.data_ptr()))
    return (out_val, out_tan) if emit_value else out_tan


def fused_iwe_hvp_bwd(flow: Tensor, dflow: Tensor, g1: Tensor, g2: Tensor, x: Tensor, y: Tensor,
                      dtf: Tensor, wt: Tensor, offsets: Sequence[float], term_a: bool,
                      eps: float = 1e-6, bins: Optional[Tensor] = None,
                      frames: Optional[Frames] = None, pad: int = 0, count: bool = False,
                      mesh: bool = False) -> Tensor:
    """K4 (K6's HVP backward with ``bins``, per bin ``[T, 2, H, W]``; the
    batched forms with ``frames``): the vote's flow-space HVP contribution
    from the cost cotangent ``g1`` and its directional derivative ``g2``
    (``[(B,) K, H, W]``): term B, the backward against ``g2``
    (``fused_iwe_bwd(g2)``'s bits with ``term_a`` off), plus with ``term_a``
    the vote's mixed second derivative against ``g1`` along ``dflow``.  The
    plain version for CPU tensors, the kernel for CUDA tensors; zeros for a
    count vote."""
    if count:
        return torch.zeros_like(flow)
    if flow.device.type == "cpu":
        return fused_iwe_hvp_bwd_reference(flow, dflow, g1, g2, x, y, dtf, wt, offsets, term_a, eps,
                                           bins, frames, pad)
    _check(flow, (x, y, dtf, wt), offsets, bins, frames, pad)
    _check_like("dflow", dflow, flow.shape, flow)
    h, w = flow.shape[-2], flow.shape[-1]
    for name, g in (("g1", g1), ("g2", g2)):
        _check_like(name, g, _lead(frames) + (len(offsets),) + _image_hw(flow, pad), flow)
    if not offsets:
        raise ValueError("fused_iwe_hvp_bwd computes direction terms: give at least one offset")
    out = torch.empty_like(flow)  # zeroed by the launcher
    _launch("hvp_bwd", flow, bins, frames,
            _event_args(x, y, dtf, wt, flow, bins, frames)
            + (flow.data_ptr(), dflow.data_ptr(), _offsets_array(tuple(offsets)), len(offsets), h, w, int(pad),
               float(eps), int(bool(term_a)), g1.data_ptr(), g2.data_ptr(), out.data_ptr()), mesh=mesh)
    return out


# --- the event mesh's split entry points ------------------------------------
# An event-sharded frame (``parallel/sharded.py``, the sharded objective of
# ``solver/objective.py``) reaches K1/K5 and K3/K6 in another order: each
# shard votes into its own int64 sums, the sums are added as integers in
# mesh order, and one conversion gives the unsharded call's bits (K3's votes
# in the unit of the frame's bound, reduced over the shards by a max, and of
# the frame's event count).  One frame each (no frame table).  On a CPU
# tensor each runs its plain version, which for an integer sum is its exact
# model (``fused_iwe_fixed_reference(..., fixed=True)`` and
# ``fused_iwe_jvp_fixed_reference(..., bound=, unit_events=, fixed=True)``).


def _split_check(flow: Tensor, events, offsets, bins, pad, acc: Tensor, shape):
    _check(flow, events, offsets, bins, None, pad)
    if tuple(acc.shape) != tuple(shape) or acc.dtype != torch.int64 or acc.device != flow.device \
            or not acc.is_contiguous():
        raise ValueError(f"the sums must be a contiguous int64 {tuple(shape)} tensor on the flow's device, got "
                         f"{acc.dtype} {tuple(acc.shape)} on {acc.device}")


def fused_iwe_fwd_acc(flow: Tensor, x: Tensor, y: Tensor, dtf: Tensor, wt: Tensor, offsets: Sequence[float],
                      include_orig: bool, acc: Tensor, eps: float = 1e-6, bins: Optional[Tensor] = None,
                      pad: int = 0, count: bool = False) -> Tensor:
    """K1's (K5's with ``bins``) vote alone: adds these events' fixed-point
    votes (2^-36 units) into ``acc``, int64 ``[(orig) + K, H + 2 pad, W +
    2 pad]`` (the caller zeroes it); returns ``acc``.  Convert the sum with
    ``fused_iwe_from_fixed``."""
    offsets = tuple(float(o) for o in offsets)
    shape = (len(offsets) + int(include_orig),) + _image_hw(flow, pad)
    if flow.device.type == "cpu":
        return acc.add_(fused_iwe_fixed_reference(flow, x, y, dtf, wt, offsets, include_orig, eps, bins, None, pad,
                                                  count, fixed=True))
    _split_check(flow, (x, y, dtf, wt), offsets, bins, pad, acc, shape)
    h, w = flow.shape[-2], flow.shape[-1]
    _launch("fwd_acc", flow, bins, None,
            _event_args(x, y, dtf, wt, flow, bins, None)
            + (flow.data_ptr(), _offsets_array(offsets), len(offsets), int(include_orig), h, w, int(pad),
               int(bool(count)), float(eps), acc.data_ptr()), count_as="fwd", mesh=True)
    return acc


def fused_iwe_from_fixed(acc: Tensor, dtype: torch.dtype) -> Tensor:
    """K1's conversion: the images of the int64 sums ``acc`` (2^-36 units)
    in ``dtype``."""
    if acc.device.type == "cpu":
        return (acc.double() * 2.0 ** -FIX_BITS).to(dtype)
    acc = acc.contiguous()
    out = torch.empty(acc.shape, dtype=dtype, device=acc.device)
    if acc.numel() >= 2**31:
        raise ValueError("fused_iwe indexes with 32-bit ints: too many pixels")
    _launch("from_fixed", out, None, None, (acc.data_ptr(), acc.numel(), out.data_ptr()), mesh=True)
    return out


def fused_iwe_jvp_bound(dflow: Tensor, x: Tensor, y: Tensor, dtf: Tensor, wt: Tensor, offsets: Sequence[float],
                        bins: Optional[Tensor] = None) -> Tensor:
    """K3's (K6's) bound pass alone: the bits of these events' tangent bound
    b = max |wt| max_k |dtf - o_k| (|du| + |dv|) over the voting events (a
    non-finite b as +inf), an int64 ``[1]``.  A frame's bound is the max of
    its shards' (non-negative doubles order as their bits)."""
    offsets = tuple(float(o) for o in offsets)
    if dflow.device.type == "cpu":
        b = _tangent_bounds(dflow, x, y, dtf, wt, offsets, bins, None)[0]
        return torch.tensor([b], dtype=torch.float64).view(torch.int64)
    _check(dflow, (x, y, dtf, wt), offsets, bins, None)
    if not offsets:
        raise ValueError("fused_iwe_jvp_bound bounds direction images: give at least one offset")
    bound = torch.zeros(1, dtype=torch.int64, device=dflow.device)
    _launch("jvp_bound", dflow, bins, None,
            _event_args(x, y, dtf, wt, dflow, bins, None)
            + (dflow.data_ptr(), _offsets_array(offsets), len(offsets), dflow.shape[-2], dflow.shape[-1],
               bound.data_ptr()), mesh=True)
    return bound


def fused_iwe_jvp_acc(flow: Tensor, dflow: Tensor, x: Tensor, y: Tensor, dtf: Tensor, wt: Tensor,
                      offsets: Sequence[float], bound: Tensor, unit_events: int, acc_tan: Tensor,
                      acc_val: Optional[Tensor] = None, eps: float = 1e-6, bins: Optional[Tensor] = None,
                      pad: int = 0) -> Tuple[Tensor, Optional[Tensor]]:
    """K3's (K6's) vote alone, in the unit of the frame's ``bound`` (int64
    ``[1]``, ``fused_iwe_jvp_bound``'s, reduced over the shards) and of
    ``unit_events`` (the frame's event count): adds the tangent votes into
    ``acc_tan`` and, given ``acc_val``, the value votes (K1's unit) into it,
    each int64 ``[K, H + 2 pad, W + 2 pad]`` zeroed by the caller.  Convert
    with ``fused_iwe_from_scaled``."""
    offsets = tuple(float(o) for o in offsets)
    shape = (len(offsets),) + _image_hw(flow, pad)
    if int(unit_events) < x.shape[0]:
        raise ValueError(f"unit_events {unit_events} must count at least these {x.shape[0]} events")
    if flow.device.type == "cpu":
        tan = fused_iwe_jvp_fixed_reference(flow, dflow, x, y, dtf, wt, offsets, False, eps, bins, None, pad,
                                            bound=float(bound.view(torch.float64)[0]), unit_events=int(unit_events),
                                            fixed=True)
        acc_tan.add_(tan)
        if acc_val is not None:
            acc_val.add_(fused_iwe_fixed_reference(flow, x, y, dtf, wt, offsets, False, eps, bins, None, pad,
                                                   fixed=True))
        return acc_tan, acc_val
    _split_check(flow, (x, y, dtf, wt), offsets, bins, pad, acc_tan, shape)
    _check_like("dflow", dflow, flow.shape, flow)
    if acc_val is not None:
        _split_check(flow, (x, y, dtf, wt), offsets, bins, pad, acc_val, shape)
    if not offsets:
        raise ValueError("fused_iwe_jvp_acc computes direction images: give at least one offset")
    if bound.dtype != torch.int64 or bound.device != flow.device or bound.numel() != 1:
        raise ValueError("the bound must be an int64 [1] tensor on the flow's device")
    _launch("jvp_acc", flow, bins, None,
            _event_args(x, y, dtf, wt, flow, bins, None)
            + (flow.data_ptr(), dflow.data_ptr(), _offsets_array(offsets), len(offsets), flow.shape[-2],
               flow.shape[-1], int(pad), float(eps), int(acc_val is not None), int(unit_events), bound.data_ptr(),
               None if acc_val is None else acc_val.data_ptr(), acc_tan.data_ptr()), count_as="jvp", mesh=True)
    return acc_tan, acc_val


def fused_iwe_from_scaled(acc_tan: Tensor, bound: Tensor, unit_events: int, dtype: torch.dtype) -> Tensor:
    """K3's conversion: the tangent images of one frame's int64 sums in the
    unit of ``bound`` and ``unit_events`` (NaN for a non-finite bound), in
    ``dtype``."""
    if acc_tan.device.type == "cpu":
        ex = _exponent_of(float(bound.view(torch.float64)[0]), int(unit_events))
        if ex is None:
            return torch.full(acc_tan.shape, float("nan"), dtype=dtype)
        return torch.from_numpy(np.ldexp(acc_tan.double().numpy(), -ex)).to(dtype)
    acc_tan = acc_tan.contiguous()
    if acc_tan.numel() >= 2**31:
        raise ValueError("fused_iwe indexes with 32-bit ints: too many pixels")
    if acc_tan.data_ptr() % 16:  # the conversion reads two sums at a time
        acc_tan = acc_tan.clone()
    out = torch.empty(acc_tan.shape, dtype=dtype, device=acc_tan.device)
    _launch("from_scaled", out, None, None,
            (acc_tan.data_ptr(), None, acc_tan.numel(), bound.data_ptr(), int(unit_events), out.data_ptr(), None),
            mesh=True)
    return out


class FusedIWE(torch.autograd.Function):
    """The kernel pair (K1/K2, K5 with ``bins``, the batched forms with
    ``frames``) as an autograd function (CUDA tensors only); differentiable
    w.r.t. ``flow``."""

    @staticmethod
    def forward(ctx, flow, x, y, dtf, wt, bins, frames, offsets, include_orig, eps, pad=0):
        flow = flow.contiguous()
        ctx.save_for_backward(flow, x, y, dtf, wt, bins)
        ctx.config = (frames, offsets, include_orig, eps, pad)
        return fused_iwe_fwd(flow, x, y, dtf, wt, offsets, include_orig, eps, bins, frames, pad)

    @staticmethod
    def backward(ctx, g):
        flow, x, y, dtf, wt, bins = ctx.saved_tensors
        frames, offsets, include_orig, eps, pad = ctx.config
        dflow = fused_iwe_bwd(flow, x, y, dtf, wt, g.contiguous(), offsets, include_orig, eps, bins,
                              frames, pad)
        return (dflow,) + (None,) * 10


class CountIWE(torch.autograd.Function):
    """The count vote (K1's count mode on a CUDA tensor, the plain version
    on the CPU) as an autograd function: its flow derivative is zero, as
    the JAX package's (the count image is piecewise constant in the
    positions), and no backward kernel runs."""

    @staticmethod
    def forward(ctx, flow, x, y, dtf, wt, bins, frames, offsets, include_orig, eps, pad):
        ctx.flow_like = (flow.shape, flow.dtype, flow.device)
        if flow.device.type == "cpu":
            return fused_iwe_reference(flow.detach(), x, y, dtf, wt, offsets, include_orig, eps, bins, frames, pad,
                                       True)
        return fused_iwe_fwd(flow.contiguous(), x, y, dtf, wt, offsets, include_orig, eps, bins, frames, pad,
                             True)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.flow_like
        # zeros, not None: a cost of count images alone still has a gradient (0)
        return (torch.zeros(shape, dtype=dtype, device=device),) + (None,) * 10


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


def _padded(c: Tensor, pad: int) -> Tensor:
    """A coordinate shifted by the images' outer padding (itself for 0, as
    the kernels' ``padded``)."""
    return c + pad if pad else c


def _corner_votes(flow: Tensor, x: Tensor, y: Tensor, dtf: Tensor, wt: Tensor, offsets: Sequence[float],
                  include_orig: bool, eps: float, bins: Optional[Tensor], frames: Optional[Frames],
                  dflow: Optional[Tensor] = None, pad: int = 0, count: bool = False):
    """(flat output index, value) of every corner vote, 0 at index 0 for a
    corner outside the image, and the images' shape: each value is the
    kernel's expression, an elementwise op per operation.  With ``dflow``
    the tangent votes along it instead (K3's ``vote_tangent``; no orig
    image), 0 for an event that casts none (zero weight, source pixel
    outside the image).  ``pad``: the images' outer padding; ``count``:
    ``wt`` at every corner inside the image."""
    fh, fw = flow.shape[-2], flow.shape[-1]
    h, w = fh + 2 * pad, fw + 2 * pad
    zero = torch.zeros_like(x)
    u, v = _gather_uv(flow, x, y, bins, frames)
    coords = [(_padded(x, pad), _padded(y, pad), None)] if include_orig else []
    for off in offsets:
        dt = dtf - off
        coords.append((_padded(x - dt * u, pad), _padded(y - dt * v, pad), dt))
    if dflow is not None:
        du, dv = _gather_uv(dflow, x, y, bins, frames)
        casts = (wt != 0) & (x > -1) & (x < fh) & (y > -1) & (y < fw)
    n_img = len(coords)
    block = 0 if frames is None else frames.index() * (n_img * h * w)  # each event's image block
    inds, vals = [], []
    for k, (xw, yw, dt) in enumerate(coords):
        flx = torch.floor(xw + eps)
        fly = torch.floor(yw + eps)
        fx = xw - flx
        fy = yw - fly
        if count:
            weights = (wt,) * 4
        elif dflow is None:
            weights = ((1 - fx) * (1 - fy) * wt, fx * (1 - fy) * wt, (1 - fx) * fy * wt, fx * fy * wt)
        else:
            dxw, dyw = -(dt * du), -(dt * dv)
            weights = (((-dxw) * (1 - fy) + (1 - fx) * (-dyw)) * wt, (dxw * (1 - fy) + fx * (-dyw)) * wt,
                       ((-dxw) * fy + (1 - fx) * dyw) * wt, (dxw * fy + fx * dyw) * wt)
        for (dr, dc), wgt in zip(((0, 0), (1, 0), (0, 1), (1, 1)), weights):
            row = flx + dr
            col = fly + dc
            ok = (row >= 0) & (row < h) & (col >= 0) & (col < w)
            if dflow is not None:
                ok = ok & casts
            idx = block + k * h * w + torch.where(ok, row * w + col, zero).to(torch.int64)
            inds.append(torch.where(ok, idx, 0))
            vals.append(torch.where(ok, wgt, zero))
    return torch.cat(inds), torch.cat(vals), _lead(frames) + (n_img, h, w)


def fused_iwe_reference(flow: Tensor, x: Tensor, y: Tensor, dtf: Tensor, wt: Tensor,
                        offsets: Sequence[float], include_orig: bool, eps: float = 1e-6,
                        bins: Optional[Tensor] = None, frames: Optional[Frames] = None, pad: int = 0,
                        count: bool = False) -> Tensor:
    """The kernel's plain PyTorch version: gather (from the voxel's bin
    slices with ``bins``, the frame's slices with ``frames``), warp,
    accumulate the corner votes into the frame's image block with one
    ``index_put_(accumulate=True)``; autograd gives the backward."""
    inds, vals, shape = _corner_votes(flow, x, y, dtf, wt, offsets, include_orig, eps, bins, frames, None, pad,
                                      count)
    images = torch.zeros(int(np.prod(shape)), dtype=flow.dtype, device=flow.device)
    return images.index_put((inds,), vals, accumulate=True).reshape(shape)


def fused_iwe_fixed_reference(flow: Tensor, x: Tensor, y: Tensor, dtf: Tensor, wt: Tensor,
                              offsets: Sequence[float], include_orig: bool, eps: float = 1e-6,
                              bins: Optional[Tensor] = None, frames: Optional[Frames] = None, pad: int = 0,
                              count: bool = False, fixed: bool = False) -> Tensor:
    """An exact model of the forward kernel's bits, for tests and checks
    (nothing on the main path calls it): each vote's value in the flow's
    type by the kernel's expressions, rounded half to even to an int64 of
    2^-36 units, the votes summed with an integer ``index_add_`` (any order
    gives the same integers), the sums converted to the flow's type (with
    ``fixed`` the int64 sums themselves: ``fused_iwe_fwd_acc``'s).  Run it
    on CPU tensors: the card's own elementwise kernels may contract a
    multiply and an add, which the kernels are built not to do."""
    inds, vals, shape = _corner_votes(flow, x, y, dtf, wt, offsets, include_orig, eps, bins, frames, None, pad,
                                      count)
    units = torch.round(vals.double() * 2.0 ** FIX_BITS).to(torch.int64)
    sums = torch.zeros(int(np.prod(shape)), dtype=torch.int64, device=flow.device).index_add_(0, inds, units)
    if fixed:
        return sums.reshape(shape)
    return (sums.double() * 2.0 ** -FIX_BITS).to(flow.dtype).reshape(shape)


def fused_iwe_bwd_ordered_reference(flow: Tensor, x: Tensor, y: Tensor, dtf: Tensor, wt: Tensor, g: Tensor,
                                    offsets: Sequence[float], include_orig: bool, eps: float = 1e-6,
                                    bins: Optional[Tensor] = None, frames: Optional[Frames] = None,
                                    g1: Optional[Tensor] = None, dflow: Optional[Tensor] = None,
                                    pad: int = 0) -> Tensor:
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
    hi, wi = h + 2 * pad, w + 2 * pad  # the cotangents' size
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
    first = 0 if frames is None else frames.index() * (n_img * hi * wi)  # each event's cotangent block
    g_flat, g1_flat = g.reshape(-1), None if g1 is None else g1.reshape(-1)

    def at(flat, k, r, c):  # flat[image k of the event's block][r, c], 0 outside
        ok = (r >= 0) & (r < hi) & (c >= 0) & (c < wi)
        idx = first + k * hi * wi + torch.where(ok, r * wi + c, zero).to(torch.int64)
        return torch.where(ok, flat[torch.where(ok, idx, 0)], zero)

    du, dv = zero.clone(), zero.clone()
    k0 = int(include_orig)
    for k, off in enumerate(offsets):
        dt = dtf - off
        xw = _padded(x - dt * u, pad)
        yw = _padded(y - dt * v, pad)
        flx = torch.floor(xw + eps)
        fly = torch.floor(yw + eps)
        ok = (flx >= -1) & (flx <= hi - 1) & (fly >= -1) & (fly <= wi - 1)
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
              bins: Optional[Tensor] = None, frames: Optional[Frames] = None, pad: int = 0,
              count: bool = False) -> Tensor:
    """``[(B,) (orig) + len(offsets), H + 2 pad, W + 2 pad]`` raw
    (unblurred) IWEs, differentiable w.r.t. ``flow`` (a voxel ``[(B,) T, 2,
    H, W]`` with ``bins``, a batch ``[B, ...]`` with ``frames``): the plain
    version for CPU tensors, the CUDA kernel for CUDA tensors; count votes
    (``CountIWE``, a zero flow derivative) with ``count``."""
    offsets = tuple(float(o) for o in offsets)
    if count:
        return CountIWE.apply(flow, x, y, dtf, wt, bins, frames, offsets, bool(include_orig), float(eps), int(pad))
    if flow.device.type == "cpu":
        return fused_iwe_reference(flow, x, y, dtf, wt, offsets, include_orig, eps, bins, frames, int(pad))
    return FusedIWE.apply(flow, x, y, dtf, wt, bins, frames, offsets, bool(include_orig), float(eps), int(pad))


def fused_iwe_jvp_reference(flow: Tensor, dflow: Tensor, x: Tensor, y: Tensor, dtf: Tensor,
                            wt: Tensor, offsets: Sequence[float], emit_value: bool,
                            eps: float = 1e-6, bins: Optional[Tensor] = None,
                            frames: Optional[Frames] = None, pad: int = 0):
    """K3's and K6's plain version (and their batched forms'):
    ``torch.func.jvp`` of ``fused_iwe_reference``."""
    images, dimages = torch.func.jvp(
        lambda f: fused_iwe_reference(f, x, y, dtf, wt, offsets, False, eps, bins, frames, pad), (flow,),
        (dflow,))
    return (images, dimages) if emit_value else dimages


def _tangent_bounds(dflow: Tensor, x: Tensor, y: Tensor, dtf: Tensor, wt: Tensor, offsets: Sequence[float],
                    bins: Optional[Tensor], frames: Optional[Frames]) -> list:
    """Each frame's tangent bound, as ``jvp_bound_kernel`` computes it: b =
    max over the frame's casting events of |wt| max_k|dtf - o_k| (|du| +
    |dv|) in double (the offsets in the flow's type), +inf for a NaN or inf
    b, 0.0 for a frame that casts none."""
    h, w = dflow.shape[-2], dflow.shape[-1]
    du, dv = _gather_uv(dflow, x, y, bins, frames)
    d = dtf.double()
    dt_max = torch.zeros_like(d)
    for off in offsets:
        dt_max = torch.fmax(dt_max, (d - float(torch.tensor(off, dtype=dflow.dtype))).abs())
    b = wt.double().abs() * dt_max * (du.double().abs() + dv.double().abs())
    b = torch.where(b <= torch.finfo(torch.float64).max, b, torch.inf)  # NaN and inf: +inf
    casts = (wt != 0) & (x > -1) & (x < h) & (y > -1) & (y < w)
    b = torch.where(casts, b, 0.0)
    sizes = (len(x),) if frames is None else frames.sizes
    bounds, start = [], 0
    for size in sizes:
        bounds.append(float(b[start:start + size].max()) if size else 0.0)
        start += size
    return bounds


def _exponent_of(b: float, n_events: int) -> Optional[int]:
    """The tangent exponent s (the unit 2^-s) of a frame's bound ``b`` and
    event count, as ``tangent_exponent`` computes it: s = 61 - ceil(log2 N)
    - e with frexp's e of b, 0 for b == 0, None for a non-finite b."""
    scale_bits = 61 - ((n_events - 1).bit_length() if n_events > 1 else 0)
    return None if not math.isfinite(b) else 0 if b == 0.0 else scale_bits - math.frexp(b)[1]


def _tangent_exponents(dflow: Tensor, x: Tensor, y: Tensor, dtf: Tensor, wt: Tensor, offsets: Sequence[float],
                       bins: Optional[Tensor], frames: Optional[Frames]) -> list:
    """Each frame's tangent exponent s (the unit 2^-s), None for a
    non-finite bound (``_tangent_bounds``, ``_exponent_of``)."""
    sizes = (len(x),) if frames is None else frames.sizes
    return [_exponent_of(b, n) for b, n in zip(_tangent_bounds(dflow, x, y, dtf, wt, offsets, bins, frames), sizes)]


def fused_iwe_jvp_fixed_reference(flow: Tensor, dflow: Tensor, x: Tensor, y: Tensor, dtf: Tensor,
                                  wt: Tensor, offsets: Sequence[float], emit_value: bool,
                                  eps: float = 1e-6, bins: Optional[Tensor] = None,
                                  frames: Optional[Frames] = None, pad: int = 0,
                                  bound: Optional[float] = None, unit_events: Optional[int] = None,
                                  fixed: bool = False):
    """An exact model of K3's bits (all forms), for tests and checks
    (nothing on the main path calls it): each frame's bound and exponent s
    in double as the kernel computes them (``_tangent_exponents``), each
    tangent corner vote in the flow's type by the kernel's expressions,
    ``ldexp(vote, s)`` rounded half to even to an int64, the votes summed
    with an integer ``index_add_``, the sums converted with ``ldexp(sum,
    -s)`` to the flow's type, a frame of a non-finite bound NaN; with
    ``emit_value`` the value images first, ``fused_iwe_fixed_reference``'s.
    A shard of one frame (no ``frames``) takes the frame's ``bound`` (a
    double, the max over its shards) and event count ``unit_events``
    (``fused_iwe_jvp_acc``'s unit); with ``fixed`` the int64 sums come back
    unconverted (the tangent's alone).  Run it on CPU tensors (see
    ``fused_iwe_fixed_reference``)."""
    if bound is None:
        exps = _tangent_exponents(dflow, x, y, dtf, wt, offsets, bins, frames)
    else:
        exps = [_exponent_of(bound, len(x) if unit_events is None else int(unit_events))]
    inds, vals, shape = _corner_votes(flow, x, y, dtf, wt, offsets, False, eps, bins, frames, dflow, pad)
    per_frame = int(np.prod(shape[-3:]))
    ex = np.array([0 if e is None else e for e in exps], dtype=np.int32)
    nonfinite = np.array([e is None for e in exps])
    frame = inds.numpy() // per_frame
    votes = np.where(nonfinite[frame], 0.0, vals.double().numpy())  # such a frame is NaN whatever its votes
    fixed_only, fixed = fixed, np.rint(np.ldexp(votes, ex[frame])).astype(np.int64)
    sums = torch.zeros(int(np.prod(shape)), dtype=torch.int64).index_add_(0, inds, torch.from_numpy(fixed))
    if fixed_only:
        return sums.reshape(shape)
    out = np.ldexp(sums.double().numpy(), -np.repeat(ex, per_frame))
    out[np.repeat(nonfinite, per_frame)] = np.nan
    dimages = torch.from_numpy(out).to(flow.dtype).reshape(shape)
    if not emit_value:
        return dimages
    return fused_iwe_fixed_reference(flow, x, y, dtf, wt, offsets, False, eps, bins, frames, pad), dimages


def fused_iwe_hvp_bwd_reference(flow: Tensor, dflow: Tensor, g1: Tensor, g2: Tensor, x: Tensor,
                                y: Tensor, dtf: Tensor, wt: Tensor, offsets: Sequence[float],
                                term_a: bool, eps: float = 1e-6,
                                bins: Optional[Tensor] = None,
                                frames: Optional[Frames] = None, pad: int = 0) -> Tensor:
    """K4's and K6's plain version (and their batched forms'): term B is
    the VJP of ``fused_iwe_reference`` against ``g2``; term A the double
    backward of ``<vjp(flow)(g1), dflow>``."""
    with torch.enable_grad():
        fl = flow.detach().requires_grad_(True)
        images = fused_iwe_reference(fl, x, y, dtf, wt, offsets, False, eps, bins, frames, pad)
        (out,) = torch.autograd.grad(images, fl, g2, retain_graph=term_a)
        if term_a:
            (vjp1,) = torch.autograd.grad(images, fl, g1, create_graph=True)
            (term,) = torch.autograd.grad((vjp1 * dflow).sum(), fl, allow_unused=True)
            if term is not None:
                out = out + term
    return out.detach()
