"""The CMax objective of one pyramid scale (port of
``event_based_optical_flow_tpu/solver/objective.py``: ``motion_to_dense_flow``
for tiles, the objective body of ``build_objective_banded`` and the
hoisted orig IWE of ``build_orig_iwe_banded``).

One evaluation: tile motion -> dense flow (x ``t_scale``) -> the fused
warp+vote kernel for the reference-time offsets the cost needs (0 first,
1 last, 0.5 middle) -> 3-tap blur -> cost (hybrid: multi-focal normalized
gradient magnitude + total variation of the raw tile motion) ->
``nan_to_penalty``.  The orig IWE never depends on the motion: it is
voted and blurred once per frame and passed in.

Per-frame event inputs (``FrameEvents``) are built on the host in float64
from the masked time min/max, as the JAX banded path packs them, and cast
once to the solver's device and dtype.
"""

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .. import costs as costs_mod
from ..costs.functional import nan_to_penalty
from ..ops.blur import gaussian_blur3
from ..ops.fused_iwe import fused_iwe
from ..ops.interp import tile_to_dense_flow

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


@dataclass
class FrameEvents:
    """One frame's events as the fused kernel takes them: ``x, y`` pixel
    coordinates, ``dtf`` time normalized to [0, 1] by the masked min/max,
    ``wt`` weights, each ``[N]``; ``t_scale`` = t_max - t_min (a 0-d
    tensor).  The events are sorted by their source pixel (truncated
    ``x``, ``y`` in the target dtype), which makes the fused kernel's
    backward add each pixel's gradient once, in a fixed order."""

    x: Tensor
    y: Tensor
    dtf: Tensor
    wt: Tensor
    t_scale: Tensor

    @classmethod
    def from_numpy(cls, events: np.ndarray, device, dtype) -> "FrameEvents":
        ev = np.asarray(events, dtype=np.float64)
        xy = torch.as_tensor(ev[:, :2]).to(dtype).trunc().to(torch.int64).numpy()
        ev = ev[np.lexsort((xy[:, 1], xy[:, 0]))]
        t = ev[:, 2]
        t_min, t_max = t.min(), t.max()
        span = (t_max - t_min) or 1.0
        dtf = (t - t_min) / span

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

        return cls(dev(ev[:, 0]), dev(ev[:, 1]), dev(dtf), dev(np.ones(len(ev))),
                   torch.as_tensor(t_max - t_min, dtype=dtype, device=device))


def make_cost(spec: ObjectiveSpec):
    if spec.cost_name == "hybrid":
        return costs_mod.HybridCost(direction="minimize", cost_with_weight=dict(spec.cost_with_weight))
    return costs_mod.functions[spec.cost_name](direction="minimize")


def motion_to_dense_flow(spec: ObjectiveSpec, motion_flat: Tensor) -> Tensor:
    """Tile motion [2 * h_p * w_p] -> dense flow [2, H, W]."""
    return tile_to_dense_flow(
        motion_flat, spec.patch_image_size, spec.image_shape, spec.patch_size,
        spec.sliding_window, spec.patch_shift, spec.filter_type,
    )


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


def build_orig_iwe(spec: ObjectiveSpec):
    """fn(frame) -> the motion-independent blurred orig IWE [H, W] (the
    kernel's orig-only call), computed once per frame."""

    def orig_fn(frame: FrameEvents) -> Tensor:
        with torch.no_grad():
            h, w = spec.image_shape
            zeros = frame.x.new_zeros((2, h, w))
            imgs = fused_iwe(zeros, frame.x, frame.y, frame.dtf, frame.wt, (), True)
            if spec.blur_sigma > 0:
                imgs = gaussian_blur3(imgs, spec.blur_sigma)
            return imgs[0]

    return orig_fn


def build_objective(spec: ObjectiveSpec):
    """fn(motion_flat, orig_blurred, frame) -> (loss, components)."""
    cost = make_cost(spec)
    required = set(cost.required_keys)
    directions = _directions(required)
    offsets = tuple(o for _, o in directions)
    need_orig = "orig_iwe" in required

    def objective(motion_flat: Tensor, orig_blurred: Optional[Tensor], frame: FrameEvents):
        flow = motion_to_dense_flow(spec, motion_flat) * frame.t_scale
        imgs = fused_iwe(flow, frame.x, frame.y, frame.dtf, frame.wt, offsets, False)
        if spec.blur_sigma > 0:
            imgs = gaussian_blur3(imgs, spec.blur_sigma)
        arg = {"omit_boundary": True, "clip": True}
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

    return objective
