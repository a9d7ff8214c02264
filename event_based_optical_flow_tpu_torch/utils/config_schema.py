"""Config validation for the YAML surface (port of
``event_based_optical_flow_tpu/utils/config_schema.py``).

Same known-key sets and the same hard errors as the JAX package, checked
against the port's own registries: a config the port cannot run (another
dataset, solver, optimizer or cost, time-aware solving, fleet batching,
the DNN path, flow dumps) fails fast here with the YAML path of the entry,
instead of deep inside a solve.  Unknown keys produce warnings.
"""

import logging
from typing import Any, Dict, List

logger = logging.getLogger(__name__)


class ConfigError(ValueError):
    """A config entry is missing, has the wrong type/value, or asks for a
    part of the system the port does not run yet."""


def _require(cfg: dict, key: str, types, path: str):
    if key not in cfg:
        raise ConfigError(f"missing required config key '{path}.{key}'")
    val = cfg[key]
    if types is not None and not isinstance(val, types):
        names = types.__name__ if isinstance(types, type) else "/".join(t.__name__ for t in types)
        raise ConfigError(
            f"config key '{path}.{key}' must be {names}, got {type(val).__name__}: {val!r}"
        )
    return val


def _choice(cfg: dict, key: str, allowed, path: str, default=None):
    val = cfg.get(key, default)
    if val is not None and val not in allowed:
        raise ConfigError(
            f"config key '{path}.{key}' must be one of {sorted(map(str, allowed))}, got {val!r}"
        )
    return val


_NUM = (int, float)

_KNOWN_DATA_KEYS = {
    "eval_dt", "root", "dataset", "sequence", "height", "width", "load_gt_flow",
    "hot_pixel_sigma", "hot_pixel_min_rate_hz", "refractory_us",
    "gt", "n_events_per_batch", "ind1", "ind2", "remove_car", "undistort",
    "preprocess", "warm_start", "fleet_batch", "visualize_every",
    "eval_n_frames",
    "duration", "event_rate", "n_frames", "flow_max", "seed",
    "scene", "omega", "zoom_rate", "noise_fraction", "pattern", "n_dots",
    "omega3", "focal", "gt_advection",
}
_KNOWN_SOLVER_KEYS = {
    "method", "time_aware", "time_bin", "flow_interpolation", "t0_flow_location",
    "scale_later", "patch", "motion_model", "warp_direction", "parameters",
    "cost", "cost_with_weight", "outer_padding", "iwe", "max_scale",
    "precision", "iwe_backend", "seed", "parallel",
}
_KNOWN_OPT_KEYS = {
    "n_iter", "method", "max_iter", "sampler", "parameters", "cg_maxiter", "device",
    "chain", "hvp_central", "hvp_mode", "hvp_max_step", "coarse_event_fraction",
    "coarse_max_iter", "coarse_cg_maxiter", "device_solver", "lbfgs_memory",
    "warm_finest_only", "warm_full_every", "fd_polish",
}

# JAX-package options that select a part of the system the port does not
# run yet: (section, key, value the port runs, reason)
_UNPORTED = (
    ("solver", "time_aware", False, "time-aware solving"),
    ("solver", "outer_padding", 0, "outer padding"),
    ("optimizer", "hvp_mode", "fd", "the analytic Hessian-vector product"),
    ("optimizer", "device_solver", "newton-cg", "the device L-BFGS solver"),
    ("optimizer", "coarse_event_fraction", 1.0, "coarse-scale event subsampling"),
    ("optimizer", "warm_finest_only", False, "the warm finest-only fast path"),
    ("data", "fleet_batch", 1, "fleet (batched-frame) evaluation"),
    ("data", "remove_car", False, "MVSEC car cropping"),
)


def validate_config(config: Dict[str, Any]) -> List[str]:
    """Validate the full YAML dict; raises ConfigError on hard errors and
    returns a list of warning strings (also logged) for soft issues."""
    from ..costs import functions as cost_functions
    from ..data import collections as data_collections
    from ..solver import OPTIMIZERS
    from ..solver import collections as solver_collections

    warnings: List[str] = []

    for section in ("data", "output", "solver", "optimizer"):
        _require(config, section, dict, "<root>")
    if config.get("is_dnn"):
        raise ConfigError("'is_dnn: true' (the EV-FlowNet path) is not ported yet")
    if config.get("parallel"):
        raise ConfigError("'parallel' (multi-device meshes) is not ported yet")

    data = config["data"]
    _require(data, "dataset", str, "data")
    _choice(data, "dataset", set(data_collections), "data")
    _require(data, "sequence", (str, int), "data")
    _require(data, "height", int, "data")
    _require(data, "width", int, "data")
    _require(data, "n_events_per_batch", int, "data")
    for key in data:
        if key not in _KNOWN_DATA_KEYS:
            warnings.append(f"unknown config key 'data.{key}' (ignored?)")

    out = config["output"]
    _require(out, "output_dir", str, "output")
    _require(out, "show_interactive_result", bool, "output")
    if out.get("save_flow"):
        raise ConfigError("'output.save_flow' (per-frame flow dumps) is not ported yet")

    slv = config["solver"]
    _require(slv, "method", str, "solver")
    _choice(slv, "method", set(solver_collections), "solver")
    _require(slv, "cost", str, "solver")
    _choice(slv, "cost", set(cost_functions) | {"hybrid"}, "solver")
    if slv["cost"] == "hybrid":
        cww = _require(slv, "cost_with_weight", dict, "solver")
        for name in cww:
            _choice({"c": name}, "c", set(cost_functions), "solver.cost_with_weight")
    _choice(slv, "motion_model", {"2d-translation", "rigid-optical-flow"}, "solver")
    _choice(
        slv, "warp_direction",
        {"first", "middle", "last", "random", "before", "after"}, "solver",
    )
    patch = _require(slv, "patch", dict, "solver")
    _choice(patch, "initialize", {"random", "zero"}, "solver.patch")
    _choice(patch, "filter_type", {"bilinear", "nearest"}, "solver.patch")
    iwe = _require(slv, "iwe", dict, "solver")
    _choice(iwe, "method", {"bilinear_vote"}, "solver.iwe")
    _require(iwe, "blur_sigma", _NUM, "solver.iwe")
    _choice(slv, "precision", {"32", "64", 32, 64}, "solver")
    _choice(slv, "iwe_backend", {"auto", "scatter", "matmul", "pallas", "pallas_bf16"}, "solver")
    for key in slv:
        if key not in _KNOWN_SOLVER_KEYS:
            warnings.append(f"unknown config key 'solver.{key}' (ignored?)")

    opt = config["optimizer"]
    _require(opt, "method", str, "optimizer")
    _choice(opt, "method", set(OPTIMIZERS), "optimizer")
    if opt.get("device", True) is not True:
        raise ConfigError("'optimizer.device: false' (host scipy Newton-CG) is not ported yet")
    params = opt.get("parameters")
    if isinstance(params, dict):
        for pname, box in params.items():
            if not isinstance(box, dict) or "min" not in box or "max" not in box:
                raise ConfigError(
                    f"'optimizer.parameters.{pname}' must be a dict with 'min' and 'max'"
                )
            if box["min"] > box["max"]:
                raise ConfigError(
                    f"'optimizer.parameters.{pname}': min ({box['min']}) > max ({box['max']})"
                )
    for budget_key in ("coarse_max_iter", "coarse_cg_maxiter", "cg_maxiter"):
        if budget_key in opt:
            val = opt[budget_key]
            if not isinstance(val, int) or val < 1:
                raise ConfigError(
                    f"'optimizer.{budget_key}' must be a positive int, got {val!r}"
                )
    for key in opt:
        if key not in _KNOWN_OPT_KEYS:
            warnings.append(f"unknown config key 'optimizer.{key}' (ignored?)")

    sections = {"data": data, "solver": slv, "optimizer": opt}
    for section, key, runs, what in _UNPORTED:
        val = sections[section].get(key, runs)
        if (str(val).lower() if isinstance(runs, str) else val) != runs:
            raise ConfigError(
                f"config key '{section}.{key}: {val!r}' selects {what}, "
                "which is not ported yet"
            )

    for w in warnings:
        logger.warning(w)
    return warnings
