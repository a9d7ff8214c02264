"""Cost registry with the reference's class/config surface (port of
``event_based_optical_flow_tpu/costs/registry.py``: its seven costs and
the hybrid).

Same names, ``direction`` semantics (the reference's quirks included),
``required_keys`` (they decide which warped IWEs the objective
assembles) and history register; the math lives in functional.py.

The history register (``store_history``, ``enable_history_register`` /
``disable_history_register``, ``clear_history``, ``get_history``; a
hybrid's per-component histories under its costs' names) holds the loss
values a solver records per evaluation or per scale for the visualizer's
history plot.  ``calculate`` never records: the JAX package records only
host values too (it skips traced ones), and a device value recorded there
would cost a host read per evaluation.  The solver appends the values its
loop already read (``SolverBase._history_cb``).
"""

from typing import Dict, List

import torch

from . import functional as F


class CostBase:
    required_keys: List[str] = []
    name = "base"

    def __init__(self, direction: str = "minimize", store_history: bool = False):
        if direction not in ("minimize", "maximize", "natural"):
            raise ValueError(f"direction should be minimize/maximize/natural, got {direction}")
        self.direction = direction
        self.store_history = store_history
        self.clear_history()

    def clear_history(self) -> None:
        self.history: Dict[str, list] = {"loss": []}

    def get_history(self) -> dict:
        return self.history.copy()

    def enable_history_register(self) -> None:
        self.store_history = True

    def disable_history_register(self) -> None:
        self.store_history = False

    def calculate(self, arg: dict):
        raise NotImplementedError


class ImageVariance(CostBase):
    """Var(IWE) (Gallego CVPR'18), negated to minimize."""

    name = "image_variance"
    required_keys = ["iwe", "omit_boundary"]

    def calculate(self, arg: dict):
        loss = F.image_variance(arg["iwe"], arg["omit_boundary"])
        if self.direction == "minimize":
            loss = -loss
        return loss


class GradientMagnitude(CostBase):
    """mean ||Sobel(IWE)/8||^2 (Gallego CVPR'19), negated to minimize."""

    name = "gradient_magnitude"
    required_keys = ["iwe", "omit_boundary"]

    def calculate(self, arg: dict):
        loss = F.gradient_magnitude(arg["iwe"], arg["omit_boundary"], arg.get("image_axes", 2))
        if self.direction == "minimize":
            loss = -loss
        return loss


class NormalizedImageVariance(CostBase):
    """Var(IWE)/Var(orig), inverted to minimize."""

    name = "normalized_image_variance"
    required_keys = ["orig_iwe", "iwe", "omit_boundary"]

    def calculate(self, arg: dict):
        ratio = F.normalized_image_variance(arg["iwe"], arg["orig_iwe"], arg["omit_boundary"])
        return 1.0 / ratio if self.direction == "minimize" else ratio


class NormalizedGradientMagnitude(CostBase):
    """GradMag(IWE)/GradMag(orig), inverted to minimize."""

    name = "normalized_gradient_magnitude"
    required_keys = ["orig_iwe", "iwe", "omit_boundary"]

    def calculate(self, arg: dict):
        ratio = F.normalized_gradient_magnitude(arg["iwe"], arg["orig_iwe"], arg["omit_boundary"],
                                                arg.get("image_axes", 2))
        return 1.0 / ratio if self.direction == "minimize" else ratio


class MultiFocalNormalizedImageVariance(CostBase):
    """The multi-focal cost, variance flavor."""

    name = "multi_focal_normalized_image_variance"
    required_keys = ["forward_iwe", "backward_iwe", "middle_iwe", "omit_boundary", "orig_iwe"]

    def calculate(self, arg: dict):
        middle = arg.get("middle_iwe", None)
        if self.direction in ("minimize", "maximize"):
            loss = F.multi_focal_normalized_image_variance(
                arg["orig_iwe"], arg["forward_iwe"], arg["backward_iwe"], middle, arg["omit_boundary"]
            )
            if self.direction == "maximize":
                loss = -loss
        else:  # 'natural' sums the per-warp natural ratios (reference quirk)
            omit = arg["omit_boundary"]
            loss = F.normalized_image_variance(arg["forward_iwe"], arg["orig_iwe"], omit)
            loss = loss + F.normalized_image_variance(arg["backward_iwe"], arg["orig_iwe"], omit)
            if middle is not None:
                loss = loss + 2.0 * F.normalized_image_variance(middle, arg["orig_iwe"], omit)
        return loss


class MultiFocalNormalizedGradientMagnitude(CostBase):
    """The multi-focal cost of both shipped reference configs."""

    name = "multi_focal_normalized_gradient_magnitude"
    required_keys = ["forward_iwe", "backward_iwe", "middle_iwe", "omit_boundary", "orig_iwe"]

    def calculate(self, arg: dict):
        middle = arg.get("middle_iwe", None)
        if self.direction in ("minimize", "maximize"):
            loss = F.multi_focal_normalized_gradient_magnitude(
                arg["orig_iwe"], arg["forward_iwe"], arg["backward_iwe"], middle, arg["omit_boundary"],
                arg.get("image_axes", 2),
            )
            if self.direction == "maximize":
                loss = -loss
        else:  # 'natural' sums the per-warp natural ratios (reference quirk)
            omit, axes = arg["omit_boundary"], arg.get("image_axes", 2)
            loss = F.normalized_gradient_magnitude(arg["forward_iwe"], arg["orig_iwe"], omit, axes)
            loss = loss + F.normalized_gradient_magnitude(arg["backward_iwe"], arg["orig_iwe"], omit, axes)
            if middle is not None:
                loss = loss + 2.0 * F.normalized_gradient_magnitude(middle, arg["orig_iwe"], omit, axes)
        return loss


class TotalVariation(CostBase):
    """L1 total variation of the tile motion (the hybrid's regularizer)."""

    name = "total_variation"
    required_keys = ["flow", "omit_boundary"]

    def calculate(self, arg: dict):
        loss = F.total_variation(torch.as_tensor(arg["flow"]), arg["omit_boundary"])
        if self.direction != "minimize":  # reference returns -loss otherwise
            loss = -loss
        return loss


functions = {
    k.name: k
    for k in (
        ImageVariance,
        GradientMagnitude,
        NormalizedImageVariance,
        NormalizedGradientMagnitude,
        MultiFocalNormalizedImageVariance,
        MultiFocalNormalizedGradientMagnitude,
        TotalVariation,
    )
}


class HybridCost(CostBase):
    """Weighted composition over named costs, weight "inv" => 1/loss."""

    name = "hybrid"

    def __init__(self, direction: str, cost_with_weight: dict, store_history: bool = False):
        self.cost_func = {
            key: {"func": functions[key](direction=direction, store_history=store_history), "weight": value}
            for key, value in cost_with_weight.items()
        }
        super().__init__(direction=direction, store_history=store_history)
        self.required_keys = []
        for name in self.cost_func:
            self.required_keys.extend(self.cost_func[name]["func"].required_keys)

    def calculate(self, arg: dict):
        return self.calculate_with_components(arg)[0]

    def calculate_with_components(self, arg: dict):
        """Return (total, {name: unweighted sub-loss})."""
        components = {}
        loss = 0.0
        for name, entry in self.cost_func.items():
            sub = entry["func"].calculate(arg)
            components[name] = sub
            if entry["weight"] == "inv":
                loss = loss + 1.0 / sub
            else:
                loss = loss + entry["weight"] * sub
        return loss, components

    # the history fans out to the component costs
    def clear_history(self) -> None:
        self.history = {"loss": []}
        for entry in getattr(self, "cost_func", {}).values():
            entry["func"].clear_history()

    def get_history(self) -> dict:
        dic = self.history.copy()
        for name, entry in self.cost_func.items():
            dic[name] = entry["func"].get_history()["loss"]
        return dic

    def enable_history_register(self) -> None:
        self.store_history = True
        for entry in self.cost_func.values():
            entry["func"].store_history = True

    def disable_history_register(self) -> None:
        self.store_history = False
        for entry in self.cost_func.values():
            entry["func"].store_history = False
