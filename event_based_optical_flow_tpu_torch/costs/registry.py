"""Cost registry with the reference's class/config surface (port of
``event_based_optical_flow_tpu/costs/registry.py``: its seven costs and
the hybrid).

Same names, ``direction`` semantics (the reference's quirks included),
``required_keys`` (they decide which warped IWEs the objective
assembles) and history register; the math lives in functional.py.

The history register (``store_history``, ``enable_history_register`` /
``disable_history_register``, ``clear_history``, ``get_history``; a
hybrid's per-component histories under its costs' names) holds loss
values for the visualizer's history plot.  As in the JAX package, every
cost's ``calculate`` (the hybrid's: its total, and each component's own
``calculate``) returns ``register(loss)``, which records ``float(loss)``
when ``store_history`` is on; it skips a value that cannot be read there,
as the JAX package skips a traced one: inside a CUDA graph capture and
inside a ``torch.func`` transform.  The objective builds its costs with
``store_history`` off (``solver/objective.py::make_cost``), so a solve
reads nothing for them; the solvers append the values their loops already
read (``SolverBase._history_cb``).
"""

from typing import Dict, List

import torch

from . import functional as F


def _unreadable(loss) -> bool:
    """Whether ``loss`` has no value to read now: a CUDA graph is being
    captured, or it is a ``torch.func`` transform's wrapped tensor."""
    if torch.is_tensor(loss) and torch._C._functorch.is_functorch_wrapped_tensor(loss):
        return True
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


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

    def register(self, loss):
        """Record ``float(loss)`` with ``store_history`` on (not inside a
        CUDA graph capture or a ``torch.func`` transform); returns ``loss``."""
        if self.store_history and not _unreadable(loss):
            self.history["loss"].append(float(loss))
        return loss

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
        return self.register(loss)


class GradientMagnitude(CostBase):
    """mean ||Sobel(IWE)/8||^2 (Gallego CVPR'19), negated to minimize."""

    name = "gradient_magnitude"
    required_keys = ["iwe", "omit_boundary"]

    def calculate(self, arg: dict):
        loss = F.gradient_magnitude(arg["iwe"], arg["omit_boundary"], arg.get("image_axes", 2))
        if self.direction == "minimize":
            loss = -loss
        return self.register(loss)


class NormalizedImageVariance(CostBase):
    """Var(IWE)/Var(orig), inverted to minimize."""

    name = "normalized_image_variance"
    required_keys = ["orig_iwe", "iwe", "omit_boundary"]

    def calculate(self, arg: dict):
        ratio = F.normalized_image_variance(arg["iwe"], arg["orig_iwe"], arg["omit_boundary"])
        return self.register(1.0 / ratio if self.direction == "minimize" else ratio)


class NormalizedGradientMagnitude(CostBase):
    """GradMag(IWE)/GradMag(orig), inverted to minimize."""

    name = "normalized_gradient_magnitude"
    required_keys = ["orig_iwe", "iwe", "omit_boundary"]

    def calculate(self, arg: dict):
        ratio = F.normalized_gradient_magnitude(arg["iwe"], arg["orig_iwe"], arg["omit_boundary"],
                                                arg.get("image_axes", 2))
        return self.register(1.0 / ratio if self.direction == "minimize" else ratio)


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
        return self.register(loss)


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
        return self.register(loss)


class TotalVariation(CostBase):
    """L1 total variation of the tile motion (the hybrid's regularizer)."""

    name = "total_variation"
    required_keys = ["flow", "omit_boundary"]

    def calculate(self, arg: dict):
        loss = F.total_variation(torch.as_tensor(arg["flow"]), arg["omit_boundary"])
        if self.direction != "minimize":  # reference returns -loss otherwise
            loss = -loss
        return self.register(loss)


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
        return self.register(self.calculate_with_components(arg)[0])

    def calculate_with_components(self, arg: dict):
        """Return (total, {name: unweighted sub-loss}); the components
        register themselves, the total does not (the JAX package's)."""
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
