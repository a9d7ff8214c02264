"""The standalone bilinear vote of weighted events into images (K8): a
hand-written CUDA kernel (``csrc/vote.cu``) with its plain PyTorch version
beside it.

Replaces the TPU kernel of the JAX package
``ops/pallas_iwe.py::bilinear_vote_pallas`` (``_iwe_forward``, whose
``pl.pallas_call`` votes per-chunk corner-weight blocks on the matrix unit,
vmapped over a batch of event sets) and its custom-VJP backward
``_fused_bwd`` (plain XLA there, a plain PyTorch gather here).

Contract: events ``[..., n, 4]`` (``x`` the row, ``y`` the column) and a
weight that is a scalar or broadcastable to ``[..., n]`` give images
``[..., H, W]``: each event votes ``w (1 - fx)(1 - fy)``, ``w fx (1 - fy)``,
``w (1 - fx) fy``, ``w fx fy`` into the corners ``floor(c + eps)`` and
``+1`` (``fx = x - floor(x + eps)``), corners outside the image are dropped,
zero-weight (padded) events are inert, a NaN position votes nothing (the
events of an empty sweep patch, whose reference time is 0/0) and has a zero
gradient on either route (the JAX package's Pallas kernel gives NaN images
there, its scatter form NaN gradients).  Every image of a batched call is
voted in one launch (the init sweep votes P patches x K candidates at once).
With ``padding`` p (``solver.outer_padding``) each event votes at ``(x + p,
y + p)`` into images of ``image_size``, the padded size (the JAX package's
``bilinear_vote(..., padding)``); ``count_vote`` votes ``w`` into each
corner inside the image instead of the bilinear fraction (``iwe.method:
count``), with no derivative w.r.t. the positions.

Routing: ``bilinear_vote`` runs the plain version for a tensor on the CPU and
the kernel for a CUDA tensor; a CUDA tensor never falls back, an input the
kernel does not take raises.  The kernel sums in 64-bit fixed point
(``csrc/fixed_point.cuh``): in one block's shared memory for an image of at
most ``shared_pixels()`` pixels (the init sweep's patches; one launch), with
global integer atomics and a conversion pass for a larger one (a full-frame
metric image).  Its images are the same bits on every run and on either
path, and ``bilinear_vote_fixed_reference`` is an exact model of them; the
plain version's ``index_add`` sums in another order, so the two agree to
rounding.  On a CUDA tensor the gradient (w.r.t. the event
positions and the weight) is ``BilinearVote``'s analytic four-corner
backward; on the CPU autograd differentiates the plain scatter, which gives
the same one-sided corner derivatives.
"""

import ctypes
import functools
import math
from typing import Tuple, Union

import torch

from .cuda_build import load_kernel_library

Tensor = torch.Tensor

KERNEL_SOURCE = "event_based_optical_flow_tpu_torch/csrc/vote.cu"
# A pixel's fixed-point sum (2^-36 units in an int64) holds 2^27 weight
# units, and one event adds at most |w| to a pixel: with |w| <= 2, fewer than
# 2^26 events per image never overflow.  The largest batched call of the
# port is the init sweep's scoring call, P x K images of at most C events
# each (C, the patch capacity, at most the next power of two above the
# window's events: 2^15 for a 30 000-event window), weights 0 or 1; the
# metric votes are single full-frame images of the window's events.
MAX_EVENTS = 2**26
FIX_BITS = 36  # kFixBits in csrc/fixed_point.cuh

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_DBL = ctypes.c_double
# events, event_rep, weight, weight_rep, weight_scalar, n_img, n, H, W, pad, count, eps, acc, out, stream
_VOTE_ARGS = [_PTR, _INT, _PTR, _INT, _DBL, _INT, _INT, _INT, _INT, _INT, _INT, _DBL, _PTR, _PTR, _PTR]
_ARGS = {"": _VOTE_ARGS,
         # the event mesh's split: the vote into int64 sums (no out), their conversion
         "acc_": _VOTE_ARGS[:13] + [_PTR],
         "from_fixed_": [_PTR, _INT, _PTR, _PTR]}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}

# launches of the kernel since the last reset, and of them those on a shard
# of an event-sharded vote (with the split's conversions)
_LAUNCHES = {"vote": 0}
_MESH_LAUNCHES = {"vote": 0, "vote_from_fixed": 0}


def launch_counts() -> dict:
    """Kernel launches since the last reset: ``vote`` (K8)."""
    return dict(_LAUNCHES)


def mesh_launch_counts() -> dict:
    """Of the launches since the last reset, those on a shard of an
    event-sharded vote (``vote``), and the split's conversions
    (``vote_from_fixed``)."""
    return dict(_MESH_LAUNCHES)


def add_launch_counts(counts: dict) -> None:
    """Add ``counts["vote"]``, if there is one."""
    _LAUNCHES["vote"] += counts.get("vote", 0)


def reset_launch_counts() -> None:
    _LAUNCHES["vote"] = 0
    for k in _MESH_LAUNCHES:
        _MESH_LAUNCHES[k] = 0


@functools.lru_cache(maxsize=None)
def _kernel(dtype: torch.dtype, entry: str = ""):
    """The C entry point ``evflow_vote_<entry><type>``, bound once."""
    fn = getattr(load_kernel_library("vote").lib, f"evflow_vote_{entry}{_SUFFIX[dtype]}")
    fn.argtypes = _ARGS[entry]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def shared_pixels() -> int:
    """The largest image (``H * W``) that the kernel sums in shared memory
    (``kSharedPixels`` in ``csrc/vote.cu``); a larger one takes the global
    path and its int64 scratch."""
    lib = load_kernel_library("vote").lib
    lib.evflow_vote_shared_pixels.restype = ctypes.c_int
    return lib.evflow_vote_shared_pixels()


def _weight_rows(weight: Tensor, batch: tuple, n: int):
    """(the weight as contiguous rows of ``n``, the images per row): a
    weight whose leading axes are the batch's first ones and whose other
    batch axes are 1 (the sweep's per-patch ``[P, 1, C]`` for ``[P, K]``
    images) is read as it is, image ``i`` reading row ``i // rep``; any
    other broadcast is copied out to one row per image."""
    shape = (1,) * (len(batch) + 1 - weight.ndim) + tuple(weight.shape)
    if len(shape) == len(batch) + 1 and shape[-1] == n and weight.is_contiguous():
        s = 0
        while s < len(batch) and shape[s] == batch[s]:
            s += 1
        if all(d == 1 for d in shape[s:-1]):
            return weight, math.prod(batch[s:])
    return torch.broadcast_to(weight, batch + (n,)).contiguous(), 1


def _event_rows(events: Tensor, batch: tuple):
    """(the events as contiguous rows of ``[n, 4]``, the images per row):
    events whose trailing batch axes are a stride-0 expand (the voxel
    grid's ``n_bin`` planes of one event set) are read once per set, image
    ``i`` reading row ``i // rep``; any other layout is copied out to one
    row per image."""
    s = len(batch)
    while s > 0 and (batch[s - 1] == 1 or events.stride(s - 1) == 0):
        s -= 1
    rep = math.prod(batch[s:])
    if rep == 1:
        return events.contiguous(), 1
    return events[(slice(None),) * s + (0,) * (len(batch) - s)].contiguous(), rep


def corner_terms(events: Tensor, image_size: Tuple[int, int], weight: Union[float, Tensor] = 1.0,
                 eps: float = 1e-6, padding: int = 0, count: bool = False):
    """The plain version's scatter operands: (flat image indices ``[4 n_img
    n]`` into ``n_img`` images of ``H * W``, the corner votes, the batch
    shape).  An outside corner (any corner of a NaN position) points at its
    image's pixel 0 with vote 0.  ``padding`` shifts the voted position;
    ``count`` votes the weight itself into each corner."""
    h, w = image_size
    x = events[..., 0]
    y = events[..., 1]
    if padding:
        x, y = x + padding, y + padding
    fl_x = torch.floor(x + eps)
    fl_y = torch.floor(y + eps)
    # a non-finite position votes nothing (no corner is inside) and, with its
    # fractions held at 0, has a zero gradient rather than a NaN one
    finite = torch.isfinite(x) & torch.isfinite(y)
    fx = torch.where(finite, x - fl_x, torch.zeros_like(x))
    fy = torch.where(finite, y - fl_y, torch.zeros_like(y))
    wgt = torch.as_tensor(weight, dtype=x.dtype, device=x.device)
    batch = x.shape[:-1]
    base = (torch.arange(math.prod(batch), device=x.device) * (h * w)).reshape(batch + (1,))
    vals, inds = [], []
    for dr, dc, wr, wc in (
        (0, 0, 1 - fx, 1 - fy),
        (1, 0, fx, 1 - fy),
        (0, 1, 1 - fx, fy),
        (1, 1, fx, fy),
    ):
        row = fl_x + dr
        col = fl_y + dc
        inside = (row >= 0) & (row < h) & (col >= 0) & (col < w)
        zero = torch.zeros_like(row)
        lin = torch.where(inside, row * w + col, zero).to(torch.int64)
        inds.append((lin + base).reshape(-1))
        # where, not a product with the mask: a NaN position (an empty sweep
        # patch's events) votes nothing, as in the kernel
        vals.append(torch.where(inside, wgt if count else wr * wc * wgt, zero).reshape(-1))
    return torch.cat(inds), torch.cat(vals), batch


def bilinear_vote_plain(events: Tensor, image_size: Tuple[int, int], weight: Union[float, Tensor] = 1.0,
                        eps: float = 1e-6, padding: int = 0, count: bool = False) -> Tensor:
    """K8's plain PyTorch version: the corner votes of every image of the
    call in one flattened ``index_add``; differentiable by autograd."""
    h, w = image_size
    inds, vals, batch = corner_terms(events, image_size, weight, eps, padding, count)
    image = torch.zeros(math.prod(batch) * h * w, dtype=events.dtype, device=events.device)
    return image.index_add(0, inds, vals).reshape(batch + (h, w))


def bilinear_vote_fixed_reference(events: Tensor, image_size: Tuple[int, int],
                                  weight: Union[float, Tensor] = 1.0, eps: float = 1e-6, padding: int = 0,
                                  count: bool = False, fixed: bool = False) -> Tensor:
    """An exact model of K8's bits, for tests and checks (nothing on the
    main path calls it): each corner vote in the events' type by the
    kernel's expressions (``corner_terms``), rounded half to even to an
    int64 of 2^-36 units, summed with an integer ``index_add_`` (any order
    gives the same integers), converted back (with ``fixed`` the int64 sums
    themselves: ``vote_acc``'s).  Run it on CPU tensors (see
    ``fused_iwe.fused_iwe_fixed_reference``)."""
    h, w = image_size
    inds, vals, batch = corner_terms(events, image_size, weight, eps, padding, count)
    units = torch.round(vals.double() * 2.0 ** FIX_BITS).to(torch.int64)
    sums = torch.zeros(math.prod(batch) * h * w, dtype=torch.int64, device=events.device).index_add_(0, inds, units)
    if fixed:
        return sums.reshape(batch + (h, w))
    return (sums.double() * 2.0 ** -FIX_BITS).to(events.dtype).reshape(batch + (h, w))


def bilinear_vote_kernel(events: Tensor, image_size: Tuple[int, int], weight: Union[float, Tensor] = 1.0,
                         eps: float = 1e-6, padding: int = 0, count: bool = False, fixed: bool = False) -> Tensor:
    """Launch K8 on CUDA tensors: ``[..., n, 4]`` events -> ``[..., H, W]``
    images, one launch for the whole batch (no gradient: see
    ``BilinearVote``).  Events expanded over trailing batch axes (stride 0)
    are read in place, once per event set.  With ``fixed`` the images' int64
    sums (2^-36 units) instead, unconverted: ``vote_acc``."""
    if events.device.type != "cuda":
        raise ValueError(f"the vote kernel runs on CUDA tensors, got a {events.device} tensor")
    if events.dtype not in _SUFFIX:
        raise TypeError(f"the vote kernel takes float32 or float64 events, got {events.dtype}")
    if events.ndim < 2 or events.shape[-1] != 4:
        raise ValueError(f"events must be [..., n, 4], got {tuple(events.shape)}")
    h, w = (int(s) for s in image_size)
    if h < 1 or w < 1:
        raise ValueError(f"image_size must be positive, got {image_size}")
    if int(padding) < 0:
        raise ValueError(f"padding must be >= 0, got {padding}")
    batch, n = tuple(events.shape[:-2]), int(events.shape[-2])
    n_img = math.prod(batch)
    if n >= MAX_EVENTS:
        raise ValueError(f"the vote kernel takes fewer than {MAX_EVENTS} events per image (fixed-point sums), "
                         f"got {n}")
    if n_img * n >= 2**31 or n_img * h * w >= 2**31:
        raise ValueError("the vote kernel indexes with 32-bit ints: too many events or pixels in one call")
    events, e_rep = _event_rows(events, batch)
    shared = h * w <= shared_pixels()
    w_ptr, w_rep, w_scalar = None, 1, 0.0
    if torch.is_tensor(weight):
        if weight.device != events.device or weight.dtype != events.dtype:
            raise ValueError(f"the weight must share the events' device and dtype ({events.device}, "
                             f"{events.dtype}), got {weight.device} {weight.dtype}")
        weight, w_rep = _weight_rows(weight, batch, n)
        w_ptr = weight.data_ptr()
    else:
        w_scalar = float(weight)
    with torch.cuda.device(events.device):
        if fixed:  # the shared path writes every sum, the global path adds into zeros
            acc = (torch.empty if shared else torch.zeros)(batch + (h, w), dtype=torch.int64, device=events.device)
            rc = _kernel(events.dtype, "acc_")(events.data_ptr(), e_rep, w_ptr, w_rep, w_scalar, n_img, n, h, w,
                                               int(padding), int(bool(count)), float(eps), acc.data_ptr(),
                                               torch.cuda.current_stream(events.device).cuda_stream)
            out = acc
        else:
            out = torch.empty(batch + (h, w), dtype=events.dtype, device=events.device)
            # the global path's fixed-point sums; none for an image summed in shared memory
            acc = None if shared else torch.zeros(batch + (h, w), dtype=torch.int64, device=events.device)
            rc = _kernel(events.dtype)(events.data_ptr(), e_rep, w_ptr, w_rep, w_scalar, n_img, n, h, w,
                                       int(padding), int(bool(count)), float(eps),
                                       None if acc is None else acc.data_ptr(), out.data_ptr(),
                                       torch.cuda.current_stream(events.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"evflow_vote_{'acc_' if fixed else ''}{_SUFFIX[events.dtype]} failed: "
                           f"cudaGetLastError() = {rc}")
    _LAUNCHES["vote"] += 1
    if fixed:
        _MESH_LAUNCHES["vote"] += 1
    return out


def vote_acc(events: Tensor, image_size: Tuple[int, int], weight: Union[float, Tensor] = 1.0, eps: float = 1e-6,
             padding: int = 0) -> Tensor:
    """K8's vote alone, for one shard of an event-sharded vote: the int64
    sums (2^-36 units) ``[..., H, W]`` of these events' bilinear votes; add
    the shards' sums as integers and convert them once with
    ``vote_from_fixed``, which gives the unsharded vote's bits.  On a CPU
    tensor its plain version, the exact model
    (``bilinear_vote_fixed_reference(..., fixed=True)``)."""
    if events.device.type == "cpu":
        return bilinear_vote_fixed_reference(events, image_size, weight, eps, int(padding), fixed=True)
    return bilinear_vote_kernel(events, image_size, weight, eps, int(padding), fixed=True)


def vote_from_fixed(acc: Tensor, dtype: torch.dtype) -> Tensor:
    """K8's conversion of int64 sums ``acc`` (2^-36 units) to images in
    ``dtype`` (the plain conversion on a CPU tensor)."""
    if acc.device.type == "cpu":
        return (acc.double() * 2.0 ** -FIX_BITS).to(dtype)
    if dtype not in _SUFFIX:
        raise TypeError(f"the vote kernel converts to float32 or float64, got {dtype}")
    acc = acc.contiguous()
    if acc.numel() >= 2**31:
        raise ValueError("the vote kernel indexes with 32-bit ints: too many pixels in one call")
    out = torch.empty(acc.shape, dtype=dtype, device=acc.device)
    with torch.cuda.device(acc.device):
        rc = _kernel(dtype, "from_fixed_")(acc.data_ptr(), acc.numel(), out.data_ptr(),
                                           torch.cuda.current_stream(acc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"evflow_vote_from_fixed_{_SUFFIX[dtype]} failed: cudaGetLastError() = {rc}")
    _MESH_LAUNCHES["vote_from_fixed"] += 1
    return out


def _vote_backward(events: Tensor, weight: Union[float, Tensor], g: Tensor, eps: float, padding: int = 0,
                   count: bool = False):
    """The analytic four-corner backward (``pallas_iwe.py::_fused_bwd``):
    each event gathers the cotangent at its four corners (0 outside the
    image); (d events ``[..., n, 4]``: dx, dy and zeros for t and p,
    d weight ``[..., n]``).  A count vote has no position derivative and
    the sum of its corners' cotangents as the weight's."""
    h, w = g.shape[-2], g.shape[-1]
    x, y = events[..., 0], events[..., 1]
    if padding:
        x, y = x + padding, y + padding
    zero = torch.zeros_like(x)
    # a non-finite position (which votes nothing) gets a zero gradient: its
    # fractions are held at 0 and its corners masked, whatever integer
    # floor(NaN) converts to (INT64_MIN on the CPU, 0 on the GPU)
    finite = torch.isfinite(x) & torch.isfinite(y)
    fx = torch.floor(x + eps)
    fy = torch.floor(y + eps)
    ax = torch.where(finite, x - fx, zero)
    ay = torch.where(finite, y - fy, zero)
    r0 = torch.where(finite, fx, zero).to(torch.int64)
    c0 = torch.where(finite, fy, zero).to(torch.int64)
    flat = g.reshape(g.shape[:-2] + (h * w,))

    def corner(r, c):
        ok = finite & (r >= 0) & (r < h) & (c >= 0) & (c < w)
        return torch.where(ok, torch.gather(flat, -1, torch.where(ok, r * w + c, 0)), zero)

    g00, g10, g01, g11 = corner(r0, c0), corner(r0 + 1, c0), corner(r0, c0 + 1), corner(r0 + 1, c0 + 1)
    wt = weight if torch.is_tensor(weight) else torch.full_like(x, float(weight))
    if count:
        return torch.zeros_like(events), g00 + g10 + g01 + g11
    dwt = (1 - ax) * (1 - ay) * g00 + ax * (1 - ay) * g10 + (1 - ax) * ay * g01 + ax * ay * g11
    dx = wt * ((1 - ay) * (g10 - g00) + ay * (g11 - g01))
    dy = wt * ((1 - ax) * (g01 - g00) + ax * (g11 - g10))
    return torch.stack([dx, dy, zero, zero], dim=-1), dwt


class BilinearVote(torch.autograd.Function):
    """``bilinear_vote`` as an autograd function: K8 forward on a CUDA
    tensor (the plain version on the CPU), the analytic four-corner
    backward; differentiable w.r.t. the events' positions and a tensor
    weight."""

    @staticmethod
    def forward(ctx, events, weight, image_size, eps, padding=0, count=False):
        ctx.save_for_backward(events, weight if torch.is_tensor(weight) else None)
        ctx.config = (weight if not torch.is_tensor(weight) else None, eps, padding, count)
        if events.device.type == "cpu":
            return bilinear_vote_plain(events, image_size, weight, eps, padding, count)
        return bilinear_vote_kernel(events, image_size, weight, eps, padding, count)

    @staticmethod
    def backward(ctx, g):
        events, weight_t = ctx.saved_tensors
        scalar, eps, padding, count = ctx.config
        weight = scalar if weight_t is None else torch.broadcast_to(weight_t, events.shape[:-1])
        d_events, d_weight = _vote_backward(events, weight, g, eps, padding, count)
        if weight_t is None or not ctx.needs_input_grad[1]:
            return d_events, None, None, None, None, None
        return d_events, d_weight.sum_to_size(weight_t.shape), None, None, None, None


def bilinear_vote(events: Tensor, image_size: Tuple[int, int], weight: Union[float, Tensor] = 1.0,
                  eps: float = 1e-6, padding: int = 0) -> Tensor:
    """Bilinear voting of ``[..., n, 4]`` events into ``[..., H, W]``:
    the plain version for a CPU tensor, K8 for a CUDA tensor.  ``weight``
    is a scalar or a tensor broadcastable to ``[..., n]``; zero weights make
    padded events inert; ``padding`` shifts the voted positions into images
    of ``image_size``, the padded size."""
    if events.device.type == "cpu":
        return bilinear_vote_plain(events, image_size, weight, eps, int(padding))
    return BilinearVote.apply(events, weight, tuple(int(s) for s in image_size), float(eps), int(padding), False)


def count_vote(events: Tensor, image_size: Tuple[int, int], weight: Union[float, Tensor] = 1.0,
               eps: float = 1e-6, padding: int = 0) -> Tensor:
    """The count vote (the JAX package's ``count_vote``): ``w`` into each of
    the four corners ``floor(c + eps)``, ``+1`` that lies in the image, the
    reference's quirk kept; the plain version for a CPU tensor, K8's count
    mode for a CUDA tensor.  No derivative w.r.t. the positions."""
    if events.device.type == "cpu":
        return bilinear_vote_plain(events, image_size, weight, eps, int(padding), True)
    return BilinearVote.apply(events, weight, tuple(int(s) for s in image_size), float(eps), int(padding), True)
