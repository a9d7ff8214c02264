"""Cost registry with the reference's class/config surface (port of
``event_based_optical_flow_tpu/costs/registry.py``, limited to the costs
of the hybrid objective the eval configs use).

Same names, ``direction`` semantics and ``required_keys`` (they decide
which warped IWEs the objective assembles); the math lives in
functional.py.  The other five costs of the JAX registry, and the loss
history the JAX visualizer plots, are still to be ported.
"""

from typing import List

import torch

from . import functional as F


class CostBase:
    required_keys: List[str] = []
    name = "base"

    def __init__(self, direction: str = "minimize"):
        if direction not in ("minimize", "maximize", "natural"):
            raise ValueError(f"direction should be minimize/maximize/natural, got {direction}")
        self.direction = direction

    def calculate(self, arg: dict):
        raise NotImplementedError


class MultiFocalNormalizedGradientMagnitude(CostBase):
    """The multi-focal cost of both shipped reference configs."""

    name = "multi_focal_normalized_gradient_magnitude"
    required_keys = ["forward_iwe", "backward_iwe", "middle_iwe", "omit_boundary", "orig_iwe"]

    def calculate(self, arg: dict):
        middle = arg.get("middle_iwe", None)
        if self.direction in ("minimize", "maximize"):
            loss = F.multi_focal_normalized_gradient_magnitude(
                arg["orig_iwe"], arg["forward_iwe"], arg["backward_iwe"], middle, arg["omit_boundary"]
            )
            if self.direction == "maximize":
                loss = -loss
        else:  # 'natural' sums the per-warp natural ratios (reference quirk)
            omit = arg["omit_boundary"]
            loss = F.normalized_gradient_magnitude(arg["forward_iwe"], arg["orig_iwe"], omit)
            loss = loss + F.normalized_gradient_magnitude(arg["backward_iwe"], arg["orig_iwe"], omit)
            if middle is not None:
                loss = loss + 2.0 * F.normalized_gradient_magnitude(middle, arg["orig_iwe"], omit)
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
        MultiFocalNormalizedGradientMagnitude,
        TotalVariation,
    )
}


class HybridCost(CostBase):
    """Weighted composition over named costs, weight "inv" => 1/loss."""

    name = "hybrid"

    def __init__(self, direction: str, cost_with_weight: dict):
        self.cost_func = {
            key: {"func": functions[key](direction=direction), "weight": value}
            for key, value in cost_with_weight.items()
        }
        super().__init__(direction=direction)
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
