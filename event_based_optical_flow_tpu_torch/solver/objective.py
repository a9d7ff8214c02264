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
"""

import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .. import costs as costs_mod
from ..costs.functional import nan_to_penalty
from ..ops.blur import gaussian_blur3
from ..ops.fused_iwe import Frames, fused_iwe, fused_iwe_bwd, fused_iwe_hvp_bwd, fused_iwe_jvp
from ..ops.iwe import IWE_METHODS
from ..flow.voxel import DEVICE_SCHEMES, construct_dense_flow_voxel
from ..ops.interp import tile_to_dense_flow
from ..ops.warp import flow_from_2d_translation, flow_from_rotation, flow_from_similarity

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

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

        bins = None if bins is None else bins[order]
        wt = np.ones(len(ev))
        channels = None
        if polarity:
            pos = (ev[:, 3] > 0).astype(np.float64)
            ev, dtf, wt = np.concatenate([ev, ev]), np.concatenate([dtf, dtf]), np.concatenate([pos, 1.0 - pos])
            bins = None if bins is None else np.concatenate([bins, bins])
            channels = Frames.of_sizes([len(pos)] * 2, device)
        return cls(dev(ev[:, 0]), dev(ev[:, 1]), dev(dtf), dev(wt),
                   torch.as_tensor(t_max - t_min, dtype=dtype, device=device),
                   None if bins is None else torch.as_tensor(bins, dtype=torch.int32, device=device), channels)

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
        return self


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


def _vote(spec: ObjectiveSpec, flow: Tensor, frame: FrameEvents, offsets, include_orig: bool) -> Tensor:
    """The kernel's raw images ``[(orig) + K, (2,) H', W']`` of this spec's
    padding and vote; a polarity frame's two channels at axis 1."""
    imgs = fused_iwe(_channels(frame, flow), frame.x, frame.y, frame.dtf, frame.wt, offsets, include_orig,
                     **kernel_call(spec, frame))
    return imgs if frame.channels is None else imgs.transpose(0, 1)


def build_orig_iwe(spec: ObjectiveSpec):
    """fn(frame) -> the motion-independent blurred orig IWE [(2,) H', W']
    (the kernel's orig-only call), computed once per frame."""

    def orig_fn(frame: FrameEvents) -> Tensor:
        with torch.no_grad():
            h, w = spec.image_shape
            zeros = frame.x.new_zeros((2, h, w))  # a dense zero flow: the orig image reads no bin
            imgs = _vote(spec, zeros, dataclasses.replace(frame, bins=None), (), True)
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


def build_objective(spec: ObjectiveSpec):
    """fn(motion_flat, orig_blurred, frame) -> (loss, components)."""
    offsets, cost_of = cost_of_images(spec)

    def objective(motion_flat: Tensor, orig_blurred: Optional[Tensor], frame: FrameEvents):
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
    ``(images, dimages)`` with ``emit_value``, else ``dimages``."""
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


def build_objective_hvp(spec: ObjectiveSpec, gauss_newton: bool = True):
    """hvp(motion_flat, p, orig_blurred, frame) -> H p in one call: K3
    emits the direction images and their tangent together (the unstaged
    form; ``build_objective_hvp_staged`` is the CG loop's)."""
    offsets, assemble = _hvp_assembly(spec, gauss_newton)

    def hvp(motion_flat: Tensor, p: Tensor, orig_blurred: Optional[Tensor], frame: FrameEvents):
        flow, dflow, flow_vjp = _flow_and_tangent(spec, motion_flat, p, frame)
        images, dimages = _tangent(spec, flow, dflow, frame, offsets, True)
        return assemble(images, dimages, flow, dflow, flow_vjp, motion_flat, p, orig_blurred, frame)

    return hvp


def build_objective_hvp_staged(spec: ObjectiveSpec, gauss_newton: bool = True):
    """``(prep, hvp)`` for the CG loop: ``aux = prep(motion, orig, frame)``
    votes the direction images once per CG solve (K1: they depend on the
    iterate, not on the CG direction); ``hvp(aux, motion, p, orig, frame)``
    runs K3 for the tangent only, the cost's jvp-of-grad and K4 (K6 for
    a time-aware objective)."""
    offsets, assemble = _hvp_assembly(spec, gauss_newton)

    def prep(motion_flat: Tensor, orig_blurred: Optional[Tensor], frame: FrameEvents) -> Tensor:
        with torch.no_grad():
            return _vote(spec, _flow(spec, motion_flat, frame), frame, offsets, False)

    def hvp(images: Tensor, motion_flat: Tensor, p: Tensor, orig_blurred: Optional[Tensor],
            frame: FrameEvents):
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
