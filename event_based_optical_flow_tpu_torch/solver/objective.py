"""The CMax objective of one pyramid scale or one global motion model
(port of ``event_based_optical_flow_tpu/solver/objective.py``:
``motion_to_dense_flow``, the objective body of ``build_objective_banded``,
the hoisted orig IWE of ``build_orig_iwe_banded``, and the analytic
Hessian-vector products ``build_objective_banded_hvp`` / ``_hvp_staged``).

One evaluation: tile motion -> dense flow (x ``t_scale``) -> the fused
warp+vote kernel for the reference-time offsets the cost needs (0 first,
1 last, 0.5 middle) -> 3-tap blur -> cost (hybrid: multi-focal normalized
gradient magnitude + total variation of the raw tile motion) ->
``nan_to_penalty``.  A global motion model (``ObjectiveSpec.motion_model``
other than "tiles") takes the model's parameter vector instead: scaled
per parameter by ``param_scale`` and mapped to the model's analytic dense
field (``ops/warp.py``), the rest as for tiles; its cost has no TV term.
The orig IWE never depends on the motion: it is
voted and blurred once per frame and passed in.  A time-aware objective
propagates the dense flow into a ``[time_bin, 2, H, W]`` voxel (Burgers,
upwind or a direct scheme, ``flow/voxel.py``) and votes each event with
its time bin's slice (K5; the orig IWE is the same image as from a zero
voxel).

The analytic HVP (Gauss-Newton by default): with L(m) = C(F(flow(m)), m),
F the vote and flow(m) linear in m (the tile interpolation, and every
global model's field with its ``param_scale``),
``H p = flow^T [dF(flow)[dflow]^T g1 + F(flow)^T g2] + dC_mm`` where
``dflow = flow(p)``, ``g1 = dC/dimages`` and ``(g2, dC_mm)`` its
directional derivative along ``(dimages, p)``.  The kernels give
``dimages`` (K3) and the bracket (K4; its first term, the vote's own
curvature, only without Gauss-Newton); the cost (blur, Sobel, hybrid, TV)
is differentiated by ``torch.func``: ``jvp`` of its ``grad``.  The
time-aware motion -> voxel map is nonlinear: its tangent and transpose
come from ``torch.func.jvp`` / ``vjp`` of the map, and K6 takes K3/K4's
place; the full form adds the map's own curvature (the jvp of its vjp
against the voxel's cotangent), on the unfused route only (below).

The options that put the JAX package on its unfused (warp-then-vote)
route, ``objective.py:192-322`` (``is_unfused``): ``solver.outer_padding``
p > 0 votes every image into ``(H + 2p) x (W + 2p)`` at the warped position
plus p (the kernels' ``pad``); ``iwe.method: count`` votes ``wt`` at each
corner (the kernels' count mode: no flow derivative, so only TV moves the
gradient); ``iwe.method: polarity`` votes the positive and the other events
as two images stacked at axis -3: the frame's events twice, weighted by
``wt * pos`` and ``wt * (1 - pos)``, as a two-frame table of the batched
kernels (K7: one launch each for the forward, backward, tangent and HVP
backward; ``FrameEvents.from_numpy(..., polarity=True)``), the cost taking
its gradient magnitudes over both channels.  The math is the JAX route's,
not its route: the kernels still gather, warp and vote in one pass.  The
JAX package's HVP there is exact (reverse-over-reverse), so the Newton
solver of such a spec takes the full analytic HVP (K3 plus K4 with term A;
a time-aware one K6 plus the voxel map's own curvature by ``torch.func``)
whatever ``optimizer.hvp_mode`` says (``patch_base``).

Per-frame event inputs (``FrameEvents``) are built on the host in float64
from the masked time min/max, as the JAX banded path packs them, and cast
once to the solver's device and dtype.

An event-sharded frame (the ``parallel:`` mesh's event axis, the JAX
package's ``build_objective_banded(mesh=...)``; ``ShardedFrame``,
``FrameEvents.shard``): the frame's pixel-sorted events cut into
contiguous shards at run boundaries of the sort key, shard s on the mesh
row's device s, the frame's own time normalization and ``t_scale``.  The
objectives above take such a frame in place of a ``FrameEvents``: the
flow, the cost, the blur and the voxel run once on the lead device (the
row's first); each shard votes its events on its device (K1/K5 into its
own int64 sums, added as integers on the lead device in mesh order, then
one conversion; K3/K6 in the unit of the frame's bound, reduced over the
shards by a max); the backward kernels (K2/K4, K5/K6's) run per shard on
the cotangents copied to it, their disjoint ``dflow`` partials added on
the lead device.  On the card every image, gradient, tangent and HVP is
the single-device call's bits (``csrc/fused_iwe.cu``'s header).  On the
CPU the plain versions run on the whole frame, the shards' events gathered
back in order on the lead device: float partials added across shards would
differ from the single-device sums by rounding, which the Newton iterates
amplify, so the CPU keeps the single-device bits too.  The unfused route (padding, count,
polarity) is not sharded (``patch_base``).
"""

import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import costs as costs_mod
from ..costs.functional import nan_to_penalty
from ..ops.blur import gaussian_blur3
from ..ops import fused_iwe as fi
from ..ops.fused_iwe import Frames, fused_iwe, fused_iwe_bwd, fused_iwe_hvp_bwd, fused_iwe_jvp
from ..ops.iwe import IWE_METHODS
from ..flow.voxel import DEVICE_SCHEMES, construct_dense_flow_voxel
from ..parallel.sharded import sum_on
from ..ops.interp import tile_to_dense_flow
from ..ops.warp import flow_from_2d_translation, flow_from_rotation, flow_from_similarity
from ..utils.tracing import count, device_bytes, read

Tensor = torch.Tensor


@dataclass(frozen=True)
class ObjectiveSpec:
    """Static description of one CMax objective (one pyramid scale)."""

    image_shape: Tuple[int, int]
    patch_image_size: Tuple[int, int]
    patch_size: Tuple[int, int]
    sliding_window: Tuple[int, int]
    patch_shift: Tuple[int, int]
    filter_type: str
    blur_sigma: float
    cost_name: str
    cost_with_weight: Optional[Tuple[Tuple[str, object], ...]]  # for hybrid
    time_aware: bool = False
    time_bin: Optional[int] = None  # the three set when time_aware
    flow_interpolation: Optional[str] = None
    t0_location: Optional[str] = None
    scale_later: bool = False
    # "tiles": the motion is the per-tile translations, interpolated to the
    # dense flow; a global model's name makes it the model's parameter
    # vector and the dense flow its analytic field (solver/global_motion.py)
    motion_model: str = "tiles"
    # per-parameter scale applied before a model's map: the solver works in
    # pixel-equivalent units
    param_scale: Optional[Tuple[float, ...]] = None
    # (f_row, f_col, c_row, c_col) of a calibrated model ("3-rotation")
    calib: Optional[Tuple[float, float, float, float]] = None
    # solver.outer_padding and iwe.method: anything but (0, "bilinear_vote")
    # is the JAX package's unfused route (is_unfused)
    outer_padding: int = 0
    iwe_method: str = "bilinear_vote"


def is_unfused(spec: ObjectiveSpec) -> bool:
    """Whether the JAX package solves this spec on its unfused
    (warp-then-vote) objective (``objective_uses_banded``'s option test):
    an outer padding, or a vote other than ``bilinear_vote``."""
    if spec.iwe_method not in IWE_METHODS:
        raise ValueError(f"iwe.method must be one of {IWE_METHODS}, got {spec.iwe_method!r}")
    return spec.outer_padding != 0 or spec.iwe_method != "bilinear_vote"


# the global motion models the objective maps (each field linear in its
# parameters, so the analytic HVP's assembly is exact for them)
MODEL_FLOWS = ("2d-translation", "rigid-optical-flow", "4-param-similarity", "3-rotation")


@dataclass
class FrameEvents:
    """One frame's events as the fused kernel takes them: ``x, y`` pixel
    coordinates, ``dtf`` time normalized to [0, 1] by the masked min/max,
    ``wt`` weights, each ``[N]``; ``t_scale`` = t_max - t_min (a 0-d
    tensor); for a time-aware objective ``bins``, each event's time bin
    (int32 ``[N]``), else None.  The events are sorted by their source
    pixel (truncated ``x``, ``y`` in the target dtype), by time bin first
    when there are bins, which makes the fused kernel's backward add each
    (bin,) pixel's gradient once, in a fixed order.  ``channels`` (a
    polarity objective's): the events twice, weights ``wt * pos`` then
    ``wt * (1 - pos)`` (``pos``: polarity > 0), as the two frames of this
    table; else None."""

    x: Tensor
    y: Tensor
    dtf: Tensor
    wt: Tensor
    t_scale: Tensor
    bins: Optional[Tensor] = None
    channels: Optional[Frames] = None
    # ``shard``'s last cut (devices, ShardedFrame), dropped by ``copy_``
    _cut: Optional[tuple] = dataclasses.field(default=None, init=False, repr=False, compare=False)

    @property
    def n_events(self) -> int:
        """The frame's events (each counted once with ``channels``)."""
        return self.x.shape[0] // (1 if self.channels is None else 2)

    @property
    def kernel_frames(self) -> Optional[Frames]:
        """The kernels' frame table: the polarity channels', or none."""
        return self.channels

    @classmethod
    def from_numpy(cls, events: np.ndarray, device, dtype,
                   time_bin: Optional[int] = None, polarity: bool = False) -> "FrameEvents":
        """``time_bin``: the voxel's bin count of a time-aware objective;
        each event's bin is ``clip(floor(dtf * time_bin), 0, time_bin - 1)``
        of the float64 ``dtf``, as the JAX package packs them (a float32
        ``dtf`` would move events on bin edges to another bin).
        ``polarity``: the two channels of ``iwe.method: polarity``."""
        ev = np.asarray(events, dtype=np.float64)
        t = ev[:, 2]
        t_min, t_max = t.min(), t.max()
        span = (t_max - t_min) or 1.0
        dtf = (t - t_min) / span
        xy = torch.as_tensor(ev[:, :2]).to(dtype).trunc().to(torch.int64).numpy()
        keys = (xy[:, 1], xy[:, 0])
        bins = None
        if time_bin is not None:
            bins = np.clip(np.floor(dtf * time_bin).astype(np.int64), 0, time_bin - 1)
            keys += (bins,)
        order = np.lexsort(keys)
        ev, dtf = ev[order], dtf[order]

        def dev(a, a_dtype=dtype):
            t = torch.as_tensor(np.ascontiguousarray(a), dtype=a_dtype, device=device)
            count("h2d_bytes", device_bytes(t))
            return t

        bins = None if bins is None else bins[order]
        wt = np.ones(len(ev))
        channels = None
        if polarity:
            pos = (ev[:, 3] > 0).astype(np.float64)
            ev, dtf, wt = np.concatenate([ev, ev]), np.concatenate([dtf, dtf]), np.concatenate([pos, 1.0 - pos])
            bins = None if bins is None else np.concatenate([bins, bins])
            channels = Frames.of_sizes([len(pos)] * 2, device)
        t_scale = torch.as_tensor(t_max - t_min, dtype=dtype, device=device)
        return cls(dev(ev[:, 0]), dev(ev[:, 1]), dev(dtf), dev(wt), t_scale,
                   None if bins is None else dev(bins, torch.int32), channels)

    def shard(self, devices: Sequence) -> "ShardedFrame":
        """The frame cut into ``len(devices)`` contiguous shards, shard s on
        ``devices[s]`` (a mesh row's event axis; a device may repeat): each
        cut at the boundary between two runs of one sort key ((bin,) source
        pixel) nearest the even split, so every run lies in one shard and
        the backward's ordered run sums are the unsharded call's.  A shard
        may be empty.  The shards keep the frame's ``dtf`` and ``t_scale``
        (the frame's time min/max, as the JAX package's pmin/pmax make
        them).  One host read of the run heads; the cut is kept for the
        next call on the same devices until ``copy_``.  Not for polarity
        channels (their unfused route runs on one device)."""
        if self.channels is not None:
            raise ValueError("a polarity frame is not event-sharded: its unfused route runs on one device")
        devices = tuple(torch.device(d) for d in devices)
        if self._cut is not None and self._cut[0] == devices:
            return self._cut[1]
        n = self.x.shape[0]
        heads = np.zeros(0, dtype=np.int64)
        if n > 1:
            xt, yt = self.x.trunc(), self.y.trunc()
            change = (xt[1:] != xt[:-1]) | (yt[1:] != yt[:-1])
            if self.bins is not None:
                change = change | (self.bins[1:] != self.bins[:-1])
            heads = read(torch.nonzero(change).squeeze(1), "shard_heads").numpy() + 1
        cuts = run_cuts(heads, n, len(devices))
        shards = []
        for s, dev in enumerate(devices):
            part = slice(cuts[s], cuts[s + 1])
            to = lambda t: t[part].to(dev)  # noqa: E731
            shards.append(FrameEvents(to(self.x), to(self.y), to(self.dtf), to(self.wt), self.t_scale.to(dev),
                                      None if self.bins is None else to(self.bins)))
        self._cut = (devices, ShardedFrame(tuple(shards), self.t_scale.to(devices[0]), n))
        return self._cut[1]

    def copy_(self, other: "FrameEvents") -> "FrameEvents":
        """Copy ``other``'s events into this instance's tensors, in place
        (a captured CUDA graph reads them): the same event count, dtype,
        device, and time bins or none."""
        if (other.x.shape != self.x.shape or other.x.dtype != self.x.dtype or other.x.device != self.x.device
                or (other.bins is None) != (self.bins is None) or (other.channels is None) != (self.channels is None)):
            raise ValueError(f"copy_ takes a frame of {self.x.shape[0]} {self.x.dtype} events on {self.x.device} "
                             f"{'with' if self.bins is not None else 'without'} time bins, got "
                             f"{other.x.shape[0]} {other.x.dtype} on {other.x.device}")
        for name in ("x", "y", "dtf", "wt", "t_scale") + (() if self.bins is None else ("bins",)):
            getattr(self, name).copy_(getattr(other, name))
        self._cut = None
        return self


def run_cuts(heads: np.ndarray, n: int, n_shards: int) -> list:
    """The ``n_shards + 1`` bounds of contiguous shards of ``n`` sorted
    events whose runs start at ``heads`` (ascending, each in ``[1, n)``):
    cut s at the run boundary (0, a head, or n) nearest ``s n /
    n_shards`` (the lower on a tie), never before cut s - 1."""
    bounds = np.concatenate([[0], np.asarray(heads, dtype=np.int64), [n]])
    cuts = [0]
    for s in range(1, n_shards):
        target = s * n / n_shards
        i = int(np.searchsorted(bounds, target))
        lo, hi = bounds[max(i - 1, 0)], bounds[min(i, len(bounds) - 1)]
        cut = int(lo if target - lo <= hi - target else hi)
        cuts.append(max(cut, cuts[-1]))
    return cuts + [n]


@dataclass
class ShardedFrame:
    """One frame's events cut over a mesh row's event axis
    (``FrameEvents.shard``): ``shards[s]`` on the row's device s (a
    ``FrameEvents`` each, possibly empty, with the frame's ``t_scale``),
    ``t_scale`` on the lead device (the row's first), ``n_total`` the
    frame's events.  The objectives take it in place of a ``FrameEvents``
    (the module docstring)."""

    shards: Tuple[FrameEvents, ...]
    t_scale: Tensor
    n_total: int
    channels = None  # never polarity
    _whole: Optional[FrameEvents] = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def n_events(self) -> int:
        return self.n_total

    @property
    def bins(self) -> Optional[Tensor]:
        """The first shard's bins: None exactly when the frame has none."""
        return self.shards[0].bins

    @property
    def lead(self) -> torch.device:
        return self.t_scale.device

    def voting(self):
        """The shards with events."""
        return [sh for sh in self.shards if sh.x.shape[0] > 0]

    def whole(self) -> FrameEvents:
        """The shards' events gathered back in order on the lead device
        (the CPU's plain route; made once)."""
        if self._whole is None:
            cat = lambda name: torch.cat([getattr(sh, name).to(self.lead) for sh in self.shards])  # noqa: E731
            self._whole = FrameEvents(cat("x"), cat("y"), cat("dtf"), cat("wt"), self.t_scale,
                                      None if self.bins is None else cat("bins"))
        return self._whole


def _sharded_images(flow: Tensor, frame: ShardedFrame, offsets, include_orig: bool, eps: float = 1e-6) -> Tensor:
    """The frame's raw images ``[(orig) + K, H, W]`` on the lead device: on
    the card each shard's K1 (K5) votes into its own int64 sums, added as
    integers, converted once (the unsharded call's bits); on the CPU the
    plain version of the whole frame."""
    h, w = flow.shape[-2], flow.shape[-1]
    shape = (len(offsets) + int(include_orig), h, w)
    if frame.lead.type == "cpu":
        fr = frame.whole()
        return fi.fused_iwe_reference(flow, fr.x, fr.y, fr.dtf, fr.wt, offsets, include_orig, eps, fr.bins)
    sums = []
    for sh in frame.voting():
        acc = torch.zeros(shape, dtype=torch.int64, device=sh.x.device)
        sums.append(fi.fused_iwe_fwd_acc(flow.to(sh.x.device), sh.x, sh.y, sh.dtf, sh.wt, offsets, include_orig,
                                         acc, eps, sh.bins))
    return fi.fused_iwe_from_fixed(sum_on(sums, frame.lead, torch.zeros(shape, dtype=torch.int64,
                                                                            device=frame.lead)), flow.dtype)


class ShardedFusedIWE(torch.autograd.Function):
    """The event-sharded vote (``_sharded_images``) as an autograd function
    of the flow (or voxel): the backward copies the image cotangent to each
    shard, runs K2 (K5's backward) there and adds the disjoint ``dflow``
    partials on the lead device in mesh order."""

    @staticmethod
    def forward(ctx, flow, frame, offsets, include_orig, eps):
        flow = flow.contiguous()
        ctx.save_for_backward(flow)
        ctx.config = (frame, offsets, include_orig, eps)
        return _sharded_images(flow, frame, offsets, include_orig, eps)

    @staticmethod
    def backward(ctx, g):
        (flow,) = ctx.saved_tensors
        frame, offsets, include_orig, eps = ctx.config
        g = g.contiguous()
        if frame.lead.type == "cpu":
            fr = frame.whole()
            return (fi.fused_iwe_bwd(flow, fr.x, fr.y, fr.dtf, fr.wt, g, offsets, include_orig, eps, fr.bins),) \
                + (None,) * 4
        parts = (fi.fused_iwe_bwd(flow.to(sh.x.device), sh.x, sh.y, sh.dtf, sh.wt, g.to(sh.x.device), offsets,
                                  include_orig, eps, sh.bins, mesh=True) for sh in frame.voting())
        return (sum_on(parts, frame.lead, flow),) + (None,) * 4


def _sharded_tangent(flow: Tensor, dflow: Tensor, frame: ShardedFrame, offsets, eps: float = 1e-6) -> Tensor:
    """K3's (K6's) tangent images of the sharded frame on the lead device:
    on the card each shard's bound, their max (copied back to every shard),
    each shard's votes in that unit and the frame's event count, the int64
    sums added, one conversion (the unsharded call's bits); on the CPU the
    plain version of the whole frame."""
    h, w = flow.shape[-2], flow.shape[-1]
    shape = (len(offsets), h, w)
    voting = frame.voting()
    if frame.lead.type == "cpu":
        fr = frame.whole()
        return fi.fused_iwe_jvp_reference(flow, dflow, fr.x, fr.y, fr.dtf, fr.wt, offsets, False, eps, fr.bins)
    bound = None
    for sh in voting:
        b = fi.fused_iwe_jvp_bound(dflow.to(sh.x.device), sh.x, sh.y, sh.dtf, sh.wt, offsets, sh.bins).to(frame.lead)
        bound = b if bound is None else torch.maximum(bound, b)
    if bound is None:
        bound = torch.zeros(1, dtype=torch.int64, device=frame.lead)
    sums = []
    for sh in voting:
        acc = torch.zeros(shape, dtype=torch.int64, device=sh.x.device)
        fi.fused_iwe_jvp_acc(flow.to(sh.x.device), dflow.to(sh.x.device), sh.x, sh.y, sh.dtf, sh.wt, offsets,
                             bound.to(sh.x.device), frame.n_total, acc, None, eps, sh.bins)
        sums.append(acc)
    total = sum_on(sums, frame.lead, torch.zeros(shape, dtype=torch.int64, device=frame.lead))
    return fi.fused_iwe_from_scaled(total, bound, frame.n_total, flow.dtype)


def _sharded_hvp_bwd(flow: Tensor, dflow: Tensor, g1: Tensor, g2: Tensor, frame: ShardedFrame, offsets,
                     term_a: bool, eps: float = 1e-6) -> Tensor:
    """K4 (K6's HVP backward) per shard on the cotangents copied to it, the
    disjoint partials added on the lead device in mesh order (on the CPU
    the plain version of the whole frame)."""
    if frame.lead.type == "cpu":
        fr = frame.whole()
        return fi.fused_iwe_hvp_bwd(flow, dflow, g1, g2, fr.x, fr.y, fr.dtf, fr.wt, offsets, term_a, eps, fr.bins)
    parts = (fi.fused_iwe_hvp_bwd(flow.to(sh.x.device), dflow.to(sh.x.device), g1.to(sh.x.device),
                                  g2.to(sh.x.device), sh.x, sh.y, sh.dtf, sh.wt, offsets, term_a, eps, sh.bins,
                                  mesh=True) for sh in frame.voting())
    return sum_on(parts, frame.lead, flow)


def _sharded_on(mesh, frame):
    """``frame`` for an objective built with ``mesh``: a ``FrameEvents``
    cut over the mesh's first row (``FrameEvents.shard``: once per frame),
    anything else as it is."""
    if mesh is not None and isinstance(frame, FrameEvents):
        return frame.shard(mesh.event_devices())
    return frame


@dataclass
class FleetEvents:
    """B frames' events as the batched kernels take them: each frame built
    exactly as ``FrameEvents.from_numpy`` builds it (its own float64 ``dtf``
    from its own time min/max, its own bins and sort), concatenated in frame
    order, so the events are sorted by (frame, bin, source pixel);
    ``t_scales`` ``[B]``; ``frames`` the frames' table.  The JAX package
    pads every frame to a common multiple of 4096 events; padded events are
    inert (they change no sum), so none are added here.  With ``polarity``
    each frame holds its events twice (``FrameEvents``' polarity channels)
    and ``channels`` is the kernels' table of the 2B channels, frame-major
    (``kernel_frames``)."""

    x: Tensor
    y: Tensor
    dtf: Tensor
    wt: Tensor
    t_scales: Tensor
    frames: Frames
    bins: Optional[Tensor] = None
    channels: Optional[Frames] = None

    @classmethod
    def from_numpy(cls, events_list, device, dtype, time_bin: Optional[int] = None,
                   polarity: bool = False) -> "FleetEvents":
        parts = [FrameEvents.from_numpy(e, device, dtype, time_bin, polarity) for e in events_list]

        def cat(name):
            return torch.cat([getattr(p, name) for p in parts])

        channels = Frames.of_sizes([p.n_events for p in parts for _ in range(2)], device) if polarity else None
        return cls(cat("x"), cat("y"), cat("dtf"), cat("wt"), torch.stack([p.t_scale for p in parts]),
                   Frames.of_sizes([p.x.shape[0] for p in parts], device),
                   None if time_bin is None else cat("bins"), channels)

    @property
    def kernel_frames(self) -> Frames:
        """The kernels' frame table: the polarity channels', or the frames'."""
        return self.frames if self.channels is None else self.channels

    @classmethod
    def copies(cls, frame: FrameEvents, n: int) -> "FleetEvents":
        """``n`` copies of one frame's events as a batch (``frame``'s own
        order in each; a polarity frame's two channels in each)."""
        rep = lambda t: t.repeat(n)  # noqa: E731
        channels = None if frame.channels is None else Frames.of_sizes([frame.n_events] * 2 * n, frame.x.device)
        return cls(rep(frame.x), rep(frame.y), rep(frame.dtf), rep(frame.wt), rep(frame.t_scale.reshape(1)),
                   Frames.of_sizes([frame.x.shape[0]] * n, frame.x.device),
                   None if frame.bins is None else rep(frame.bins), channels)

    def __len__(self) -> int:
        return len(self.frames.sizes)

    def copy_(self, other: "FleetEvents") -> "FleetEvents":
        """Copy ``other``'s events, ``t_scales`` and frame table into this
        instance's tensors, in place (a captured CUDA graph reads them):
        the same per-frame event counts, dtype, device, and time bins or
        none."""
        if (other.frames.sizes != self.frames.sizes or other.x.dtype != self.x.dtype
                or other.x.device != self.x.device or (other.bins is None) != (self.bins is None)
                or (other.channels is None) != (self.channels is None)):
            raise ValueError(f"copy_ takes a fleet of frames of {list(self.frames.sizes)} {self.x.dtype} events on "
                             f"{self.x.device} {'with' if self.bins is not None else 'without'} time bins, got "
                             f"{list(other.frames.sizes)} {other.x.dtype} on {other.x.device}")
        for name in ("x", "y", "dtf", "wt", "t_scales") + (() if self.bins is None else ("bins",)):
            getattr(self, name).copy_(getattr(other, name))
        self.frames.ptr.copy_(other.frames.ptr)
        if self.channels is not None:
            self.channels.ptr.copy_(other.channels.ptr)
        return self

    def frame(self, b: int) -> FrameEvents:
        """Frame ``b``'s events alone (views)."""
        lo = sum(self.frames.sizes[:b])
        part = slice(lo, lo + self.frames.sizes[b])
        channels = None if self.channels is None else Frames.of_sizes([self.frames.sizes[b] // 2] * 2, self.x.device)
        return FrameEvents(self.x[part], self.y[part], self.dtf[part], self.wt[part], self.t_scales[b],
                           None if self.bins is None else self.bins[part], channels)


def make_cost(spec: ObjectiveSpec):
    if spec.cost_name == "hybrid":
        return costs_mod.HybridCost(direction="minimize", cost_with_weight=dict(spec.cost_with_weight))
    return costs_mod.functions[spec.cost_name](direction="minimize")


@functools.lru_cache(maxsize=64)
def _param_scale_table(param_scale: Tuple[float, ...], device: torch.device, dtype: torch.dtype) -> Tensor:
    """``param_scale`` on the device, once per spec: a table built per call
    would copy from the host in every evaluation, which a CUDA graph
    cannot capture."""
    return torch.as_tensor(param_scale, dtype=dtype, device=device)


def model_flow(spec: ObjectiveSpec, motion: Tensor) -> Tensor:
    """A global model's dense [2, H, W] field of its parameters ``[P]``:
    multiplied by ``param_scale``, then mapped (the JAX package's order)."""
    if spec.param_scale is not None:
        motion = motion * _param_scale_table(spec.param_scale, motion.device, motion.dtype)
    if spec.motion_model == "4-param-similarity":
        return flow_from_similarity(motion, spec.image_shape)
    if spec.motion_model == "3-rotation":
        return flow_from_rotation(motion, spec.image_shape, spec.calib)
    if spec.motion_model in ("2d-translation", "rigid-optical-flow"):
        return flow_from_2d_translation(motion, spec.image_shape)
    raise NotImplementedError(f"objective motion model {spec.motion_model!r} not implemented")


def motion_to_dense_flow(spec: ObjectiveSpec, motion_flat: Tensor, t_scale=1.0) -> Tensor:
    """Tile motion [2 * h_p * w_p] (or a global model's parameters, mapped
    by ``model_flow``) -> dense flow [2, H, W], or for a time-aware spec the
    voxel [time_bin, 2, H, W]: the chain runs on ``dense * t_scale / scale``
    (``scale`` the dense flow's max with ``scale_later``, else 1) and the
    voxel is rescaled by ``scale / t_scale``, in the JAX package's order."""
    if spec.motion_model != "tiles":
        dense = model_flow(spec, motion_flat)
    else:
        dense = tile_to_dense_flow(
            motion_flat, spec.patch_image_size, spec.image_shape, spec.patch_size,
            spec.sliding_window, spec.patch_shift, spec.filter_type,
        )
    if not spec.time_aware:
        return dense
    scale = torch.amax(dense) if spec.scale_later else 1.0
    voxel = construct_dense_flow_voxel(dense * t_scale / scale, spec.time_bin,
                                       spec.flow_interpolation, t0_location=spec.t0_location)
    return voxel * scale / t_scale


def _directions(required) -> list:
    """(name, reference-time offset) of each warp the cost needs, in the
    JAX package's image order."""
    directions = []
    if required & {"iwe", "backward_iwe"}:
        directions.append(("backward", 0.0))
    if "forward_iwe" in required:
        directions.append(("forward", 1.0))
    if "middle_iwe" in required:
        directions.append(("middle", 0.5))
    return directions


def kernel_call(spec: ObjectiveSpec, events) -> dict:
    """The kernels' keyword arguments for ``events`` (``FrameEvents`` or
    ``FleetEvents``) and this spec's padding and vote."""
    return {"bins": events.bins, "frames": events.kernel_frames, "pad": spec.outer_padding,
            "count": spec.iwe_method == "count"}


def _channels(frame: FrameEvents, t: Tensor) -> Tensor:
    """A flow-shaped tensor as the kernels take it for ``frame``: one copy
    per polarity channel, or itself."""
    return t if frame.channels is None else t.expand((2,) + tuple(t.shape)).contiguous()


def _check_sharded(spec: ObjectiveSpec) -> None:
    if is_unfused(spec):
        raise ValueError("an event-sharded frame takes the fused objective: the unfused route (outer padding, "
                         "count or polarity votes) runs on one device")


def _vote(spec: ObjectiveSpec, flow: Tensor, frame: FrameEvents, offsets, include_orig: bool) -> Tensor:
    """The kernel's raw images ``[(orig) + K, (2,) H', W']`` of this spec's
    padding and vote; a polarity frame's two channels at axis 1; an
    event-sharded frame's by ``ShardedFusedIWE``."""
    if isinstance(frame, ShardedFrame):
        _check_sharded(spec)
        return ShardedFusedIWE.apply(flow, frame, tuple(float(o) for o in offsets), bool(include_orig), 1e-6)
    imgs = fused_iwe(_channels(frame, flow), frame.x, frame.y, frame.dtf, frame.wt, offsets, include_orig,
                     **kernel_call(spec, frame))
    return imgs if frame.channels is None else imgs.transpose(0, 1)


def build_orig_iwe(spec: ObjectiveSpec, mesh=None):
    """fn(frame) -> the motion-independent blurred orig IWE [(2,) H', W']
    (the kernel's orig-only call), computed once per frame; with ``mesh``
    (or a ``ShardedFrame``) voted by the frame's shards."""

    def orig_fn(frame: FrameEvents) -> Tensor:
        frame = _sharded_on(mesh, frame)
        with torch.no_grad():
            h, w = spec.image_shape
            if isinstance(frame, ShardedFrame):  # a dense zero flow: the orig image reads no bin
                zeros = torch.zeros((2, h, w), dtype=frame.t_scale.dtype, device=frame.lead)
                frame = dataclasses.replace(frame, shards=tuple(dataclasses.replace(sh, bins=None)
                                                                for sh in frame.shards))
            else:
                zeros = frame.x.new_zeros((2, h, w))
                frame = dataclasses.replace(frame, bins=None)
            imgs = _vote(spec, zeros, frame, (), True)
            if spec.blur_sigma > 0:
                imgs = gaussian_blur3(imgs, spec.blur_sigma)
            return imgs[0]

    return orig_fn


def cost_of_images(spec: ObjectiveSpec):
    """(offsets, fn(raw direction images, motion_flat, orig_blurred) ->
    (loss, components)): the objective after the vote."""
    cost = make_cost(spec)
    required = set(cost.required_keys)
    if spec.motion_model != "tiles" and "flow" in required:
        raise ValueError("cost key 'flow' (total_variation) requires tile motion; "
                         "global motion models have no tile grid to regularize")
    directions = _directions(required)
    need_orig = "orig_iwe" in required

    def cost_of(imgs: Tensor, motion_flat: Tensor, orig_blurred: Optional[Tensor]):
        if spec.blur_sigma > 0:
            imgs = gaussian_blur3(imgs, spec.blur_sigma)
        arg = {"omit_boundary": True, "clip": True}
        if spec.iwe_method == "polarity":
            arg["image_axes"] = 3  # each image is [2, H', W']
        if need_orig:
            arg["orig_iwe"] = orig_blurred
        for k, (name, _) in enumerate(directions):
            if name == "backward":
                arg.update({"iwe": imgs[k], "backward_iwe": imgs[k]})
            else:
                arg[f"{name}_iwe"] = imgs[k]
        if "flow" in required:
            arg["flow"] = motion_flat.reshape((2,) + tuple(spec.patch_image_size))
        if isinstance(cost, costs_mod.HybridCost):
            loss, components = cost.calculate_with_components(arg)
        else:
            loss = cost.calculate(arg)
            components = {cost.name: loss}
        return nan_to_penalty(loss), components

    return tuple(o for _, o in directions), cost_of


def check_events(spec: ObjectiveSpec, events) -> None:
    """Raise unless ``events`` (``FrameEvents`` or ``FleetEvents``) carry
    time bins exactly when the objective is time-aware, with a voxel
    scheme the objective runs, and polarity channels exactly when it votes
    by polarity."""
    if spec.time_aware != (events.bins is not None):
        raise ValueError("a time-aware objective takes events with time bins "
                         "(FrameEvents.from_numpy(..., time_bin=spec.time_bin)), a dense one without")
    if (spec.iwe_method == "polarity") != (events.channels is not None):
        raise ValueError("a polarity objective takes events with polarity channels "
                         "(FrameEvents.from_numpy(..., polarity=True)), any other without")
    if spec.time_aware and spec.flow_interpolation not in DEVICE_SCHEMES:
        raise ValueError(f"the objective runs the voxel schemes {DEVICE_SCHEMES}, "
                         f"not {spec.flow_interpolation!r}")


def flow_of(spec: ObjectiveSpec, motion_flat: Tensor, t_scale) -> Tensor:
    """The kernel's flow (x ``t_scale``): dense, or the time-aware voxel."""
    return motion_to_dense_flow(spec, motion_flat, t_scale) * t_scale


def _flow(spec: ObjectiveSpec, motion_flat: Tensor, frame: FrameEvents) -> Tensor:
    check_events(spec, frame)
    return flow_of(spec, motion_flat, frame.t_scale)


def build_objective(spec: ObjectiveSpec, mesh=None):
    """fn(motion_flat, orig_blurred, frame) -> (loss, components); with
    ``mesh`` (or a ``ShardedFrame``) the frame's events sharded over the
    mesh's event axis."""
    offsets, cost_of = cost_of_images(spec)

    def objective(motion_flat: Tensor, orig_blurred: Optional[Tensor], frame: FrameEvents):
        frame = _sharded_on(mesh, frame)
        return cost_of(_vote(spec, _flow(spec, motion_flat, frame), frame, offsets, False), motion_flat,
                       orig_blurred)

    return objective


def objective_supports_analytic_hvp(spec: ObjectiveSpec, gauss_newton: bool = True) -> bool:
    """Whether the analytic HVP applies to this objective: it needs at
    least one warped direction image (the kernels compute no orig image)
    and a motion -> flow map the assembly handles.  The dense maps (tile
    interpolation, the global models' fields with their ``param_scale``)
    are linear, so the assembly is exact, full Hessian included; the
    time-aware motion -> voxel map is not: its full form adds the map's own
    curvature, and is taken on the unfused route only (where the JAX
    package differentiates its objective twice; elsewhere a time-aware
    objective takes the Gauss-Newton form only, as in the JAX package)."""
    if spec.motion_model != "tiles" and spec.motion_model not in MODEL_FLOWS:
        return False
    return bool(cost_of_images(spec)[0]) and (gauss_newton or not spec.time_aware or is_unfused(spec))


def _tangent(spec: ObjectiveSpec, flow: Tensor, dflow: Tensor, frame: FrameEvents, offsets, emit_value: bool):
    """K3 on this spec's padding and vote (``_vote``'s layout):
    ``(images, dimages)`` with ``emit_value``, else ``dimages``; an
    event-sharded frame's by ``_sharded_tangent``."""
    if isinstance(frame, ShardedFrame):
        _check_sharded(spec)
        dimages = _sharded_tangent(flow, dflow, frame, offsets)
        return (_sharded_images(flow, frame, offsets, False), dimages) if emit_value else dimages
    out = fused_iwe_jvp(_channels(frame, flow), _channels(frame, dflow), frame.x, frame.y, frame.dtf, frame.wt,
                        offsets, emit_value, **kernel_call(spec, frame))
    if frame.channels is None:
        return out
    return tuple(o.transpose(0, 1) for o in out) if emit_value else out.transpose(0, 1)


def map_curvature(flow_fn, motion: Tensor, p: Tensor, kflow: Tensor, g1: Tensor, events, offsets, call: dict,
                  per_flow=lambda g: g) -> Tensor:
    """The time-aware motion -> voxel map's own curvature against the
    voxels' cotangent, ``d/dm [J(m)^T g_V] p`` (``torch.func``'s jvp of the
    map's vjp): ``g_V`` is the vote's backward of the cost cotangent ``g1``
    (K5's, or its batched form: ``fused_iwe_bwd`` on the kernels' voxel
    ``kflow``, the events ``(x, y, dtf, wt)`` and the kernel ``call``'s
    bins, frames and padding), ``per_flow`` folding the kernels' polarity
    channels onto ``flow_fn``'s voxels.  A count vote has no flow
    derivative: zeros."""
    if call["count"]:
        return torch.zeros_like(motion)
    g_v = per_flow(fused_iwe_bwd(kflow, *events, g1, offsets, False, bins=call["bins"], frames=call["frames"],
                                 pad=call["pad"]))
    return torch.func.jvp(lambda m: torch.func.vjp(flow_fn, m)[1](g_v)[0], (motion,), (p,))[1]


def _hvp_assembly(spec: ObjectiveSpec, gauss_newton: bool):
    """(offsets, fn(images, dimages, motion, p, orig, frame) -> H p) around
    the two kernels: g1 and (g2, dC_mm) from the cost's jvp-of-grad, K4,
    and the transpose of the motion -> flow map; the full form of a
    time-aware objective adds the map's own curvature (``map_curvature``)."""
    offsets, cost_of = cost_of_images(spec)
    grad_cost = torch.func.grad(lambda ii, mm, oo: cost_of(ii, mm, oo)[0], argnums=(0, 1))

    def assemble(images, dimages, flow, dflow, flow_vjp, motion_flat, p, orig_blurred, frame):
        (g1, _), (g2, dgm) = torch.func.jvp(
            lambda ii, mm: grad_cost(ii, mm, orig_blurred), (images, motion_flat), (dimages, p))
        if frame.channels is not None:  # the kernels take the channel axis first
            g1, g2 = g1.transpose(0, 1), g2.transpose(0, 1)
        if isinstance(frame, ShardedFrame):
            _check_sharded(spec)
            return flow_vjp(_sharded_hvp_bwd(flow, dflow, g1.contiguous(), g2.contiguous(), frame, offsets,
                                             not gauss_newton))[0] + dgm
        kflow, g1, call = _channels(frame, flow), g1.contiguous(), kernel_call(spec, frame)
        events = (frame.x, frame.y, frame.dtf, frame.wt)
        per_flow = lambda g: g if frame.channels is None else g.sum(0)  # noqa: E731
        dgflow = fused_iwe_hvp_bwd(kflow, _channels(frame, dflow), g1, g2.contiguous(), *events, offsets,
                                   not gauss_newton, **call)
        if spec.time_aware and not gauss_newton:
            flow_fn = lambda m: _flow(spec, m, frame)  # noqa: E731
            dgm = dgm + map_curvature(flow_fn, motion_flat, p, kflow, g1, events, offsets, call, per_flow)
        return flow_vjp(per_flow(dgflow))[0] + dgm

    return offsets, assemble


def _flow_and_tangent(spec: ObjectiveSpec, motion_flat: Tensor, p: Tensor, frame: FrameEvents):
    """(flow, dflow, the map's transpose).  A dense map is linear: the
    tile interpolation, and a global model's field of the scaled
    parameters (``param_scale`` times p, then a field whose every term is a
    fixed coefficient grid times one parameter), so its tangent along p is
    the map of p, exactly (``tests/test_torch_global.py`` holds it to
    ``torch.func.jvp``); the time-aware map is not, so its tangent is
    ``torch.func.jvp``'s."""
    flow_fn = lambda m: _flow(spec, m, frame)  # noqa: E731
    flow, flow_vjp = torch.func.vjp(flow_fn, motion_flat)
    if spec.time_aware:
        _, dflow = torch.func.jvp(flow_fn, (motion_flat,), (p,))
    else:
        dflow = flow_fn(p)
    return flow.contiguous(), dflow.contiguous(), flow_vjp


def build_objective_hvp(spec: ObjectiveSpec, gauss_newton: bool = True, mesh=None):
    """hvp(motion_flat, p, orig_blurred, frame) -> H p in one call: K3
    emits the direction images and their tangent together (the unstaged
    form; ``build_objective_hvp_staged`` is the CG loop's); ``mesh`` as
    for ``build_objective``."""
    offsets, assemble = _hvp_assembly(spec, gauss_newton)

    def hvp(motion_flat: Tensor, p: Tensor, orig_blurred: Optional[Tensor], frame: FrameEvents):
        frame = _sharded_on(mesh, frame)
        flow, dflow, flow_vjp = _flow_and_tangent(spec, motion_flat, p, frame)
        images, dimages = _tangent(spec, flow, dflow, frame, offsets, True)
        return assemble(images, dimages, flow, dflow, flow_vjp, motion_flat, p, orig_blurred, frame)

    return hvp


def build_objective_hvp_staged(spec: ObjectiveSpec, gauss_newton: bool = True, mesh=None):
    """``(prep, hvp)`` for the CG loop: ``aux = prep(motion, orig, frame)``
    votes the direction images once per CG solve (K1: they depend on the
    iterate, not on the CG direction); ``hvp(aux, motion, p, orig, frame)``
    runs K3 for the tangent only, the cost's jvp-of-grad and K4 (K6 for
    a time-aware objective); ``mesh`` as for ``build_objective``."""
    offsets, assemble = _hvp_assembly(spec, gauss_newton)

    def prep(motion_flat: Tensor, orig_blurred: Optional[Tensor], frame: FrameEvents) -> Tensor:
        frame = _sharded_on(mesh, frame)
        with torch.no_grad():
            return _vote(spec, _flow(spec, motion_flat, frame), frame, offsets, False)

    def hvp(images: Tensor, motion_flat: Tensor, p: Tensor, orig_blurred: Optional[Tensor],
            frame: FrameEvents):
        frame = _sharded_on(mesh, frame)
        flow, dflow, flow_vjp = _flow_and_tangent(spec, motion_flat, p, frame)
        dimages = _tangent(spec, flow, dflow, frame, offsets, False)
        return assemble(images, dimages, flow, dflow, flow_vjp, motion_flat, p, orig_blurred, frame)

    return prep, hvp


def build_value_grad_hvp(spec: ObjectiveSpec):
    """(value_and_grad, hvp, hess) of the objective over the flat motion,
    for the host-driven optimizers (the scipy bridge, the first-order loop;
    the JAX package's ``build_value_grad_hvp``):

    * ``value_and_grad(x, orig, frame) -> (loss, grad, components)``: K1
      forward, K2 in the backward;
    * ``hvp(x, p, orig, frame)``: the central difference of two gradients
      at ``x +- eps p``, ``eps = 1e-3 (1 + |x|) / |p|`` (the JAX bridge's
      step on the fused kernel, whose backward is not itself
      differentiable; the Newton-CG loop's ``fd_hvp`` steps differently);
      on an unfused spec (``is_unfused``) the full analytic HVP, as the
      JAX package differentiates its unfused objective twice there;
    * ``hess(x, orig, frame)``: the ``[M, M]`` Hessian, one column per
      unit vector, for ``dogleg`` / ``trust-exact``.  The JAX package takes
      ``jax.hessian`` of its exact, non-fused backends (its fused route
      cannot differentiate the kernel twice): the a.e. Hessian, which the
      analytic full HVP (K3 / K4, ``build_objective_hvp(spec,
      gauss_newton=False)``) gives column by column to ~1e-15 in float64.
      The FD HVP's columns differ from it by O(1) relative on the
      piecewise CMax objective (its steps cross the vote's floors), so
      they stand in only where the full analytic HVP does not apply (a
      time-aware objective), symmetrized."""
    obj = build_objective(spec)
    exact_hvp = (build_objective_hvp(spec, gauss_newton=False)
                 if objective_supports_analytic_hvp(spec, gauss_newton=False) else None)

    def value_and_grad(x: Tensor, orig_blurred: Optional[Tensor], frame: FrameEvents):
        xr = x.detach().requires_grad_(True)
        with torch.enable_grad():
            loss, components = obj(xr, orig_blurred, frame)
            (grad,) = torch.autograd.grad(loss, xr)
        return loss.detach(), grad, {k: v.detach() for k, v in components.items()}

    def hvp(x: Tensor, p: Tensor, orig_blurred: Optional[Tensor], frame: FrameEvents) -> Tensor:
        if exact_hvp is not None and is_unfused(spec):
            with torch.no_grad():
                return exact_hvp(x, p, orig_blurred, frame)
        eps = 1e-3 * (1.0 + torch.linalg.vector_norm(x)) / (torch.linalg.vector_norm(p) + 1e-12)
        g_plus = value_and_grad(x + eps * p, orig_blurred, frame)[1]
        g_minus = value_and_grad(x - eps * p, orig_blurred, frame)[1]
        return (g_plus - g_minus) / (2.0 * eps)

    def hess(x: Tensor, orig_blurred: Optional[Tensor], frame: FrameEvents) -> Tensor:
        eye = torch.eye(x.numel(), dtype=x.dtype, device=x.device)
        if exact_hvp is not None:
            with torch.no_grad():
                return torch.stack([exact_hvp(x, e, orig_blurred, frame) for e in eye], dim=1)
        h = torch.stack([hvp(x, e, orig_blurred, frame) for e in eye], dim=1)
        return (h + h.T) / 2.0

    return value_and_grad, hvp, hess
