"""Config validation for the YAML surface (port of
``event_based_optical_flow_tpu/utils/config_schema.py``).

Same known-key sets and the same hard errors as the JAX package, checked
against the port's own registries: a config the port cannot run (another
solver, optimizer or cost, a host griddata voxel scheme, device meshes, the
DNN's multi-device train step) fails fast here with the YAML
path of the entry, instead of deep inside a solve.  An ``is_dnn`` config (the EV-FlowNet path) validates its ``dnn``
keys and its solver blocks, as the JAX package validates them.  Unknown keys, and
the raw-camera filters on a dataset that ignores them, produce the JAX
package's warnings; a global motion model under a tile solver, and a TV
term under the global solver, are refused as the JAX package refuses
them.
"""

import logging
from typing import Any, Dict, List

from ..ops.iwe import IWE_METHODS

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
_KNOWN_PARALLEL_KEYS = {"data", "event"}
_KNOWN_OPT_KEYS = {
    "n_iter", "method", "max_iter", "sampler", "parameters", "cg_maxiter", "device",
    "chain", "hvp_central", "hvp_mode", "hvp_max_step", "coarse_event_fraction",
    "coarse_max_iter", "coarse_cg_maxiter", "device_solver", "lbfgs_memory",
    "warm_finest_only", "warm_full_every", "fd_polish", "lr",
}
_KNOWN_DNN_KEYS = {
    "n_bin", "batch_size", "n_steps", "lr", "data_parallel",
    "checkpoint_dir", "checkpoint_every", "eval_only", "multi_scale", "resume", "scale_time",
    "supervised",
}


def check_ported(sections: Dict[str, dict]) -> None:
    """Raise ``ConfigError`` for an option that selects what the port does
    not run, or a value no solver takes (``sections``: some of ``data``,
    ``solver``, ``optimizer``; the CLI's validation and the serving
    surface's config merge both call it): an outer padding that is not an
    int >= 0, an ``iwe.method`` outside ``IWE_METHODS``."""
    slv = sections.get("solver", {})
    pad = slv.get("outer_padding", 0)
    if not isinstance(pad, int) or isinstance(pad, bool) or pad < 0:
        raise ConfigError(f"config key 'solver.outer_padding' must be an int >= 0, got {pad!r}")
    _choice(slv.get("iwe") or {}, "method", set(IWE_METHODS), "solver.iwe")


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

    data = config["data"]
    _require(data, "dataset", str, "data")
    _choice(data, "dataset", set(data_collections), "data")
    _require(data, "sequence", (str, int), "data")
    if (data.get("hot_pixel_sigma") or data.get("refractory_us")) and data.get("dataset") not in ("EVT2", "EVT3"):
        warnings.append(
            "data.hot_pixel_sigma/refractory_us are only applied by the "
            "raw-camera loaders (EVT2/EVT3); this dataset ignores them"
        )
    _require(data, "height", int, "data")
    _require(data, "width", int, "data")
    if not config.get("is_dnn"):
        _require(data, "n_events_per_batch", int, "data")
    for key in data:
        if key not in _KNOWN_DATA_KEYS:
            warnings.append(f"unknown config key 'data.{key}' (ignored?)")

    for key in config.get("dnn", {}) or {}:
        if key not in _KNOWN_DNN_KEYS:
            warnings.append(f"unknown config key 'dnn.{key}' (ignored?)")

    out = config["output"]
    _require(out, "output_dir", str, "output")
    _require(out, "show_interactive_result", bool, "output")
    if "save_flow" in out:
        _choice(out, "save_flow", {"dsec_png", "npz"}, "output")

    slv = config["solver"]
    _require(slv, "method", str, "solver")
    _choice(slv, "method", set(solver_collections), "solver")
    _require(slv, "cost", str, "solver")
    _choice(slv, "cost", set(cost_functions) | {"hybrid"}, "solver")
    if slv["cost"] == "hybrid":
        cww = _require(slv, "cost_with_weight", dict, "solver")
        for name in cww:
            _choice({"c": name}, "c", set(cost_functions), "solver.cost_with_weight")
    _choice(
        slv, "motion_model",
        {"2d-translation", "rigid-optical-flow", "dense-flow", "4-param-similarity", "3-rotation"},
        "solver",
    )
    is_global = slv.get("method") == "global_contrast_maximization"
    if is_global:
        if slv.get("cost") == "hybrid" and "total_variation" in (slv.get("cost_with_weight") or {}):
            raise ConfigError(
                "solver.method global_contrast_maximization has no tile grid: "
                "drop total_variation from solver.cost_with_weight"
            )
    elif slv.get("motion_model") in ("4-param-similarity", "3-rotation"):
        raise ConfigError(
            f"solver.motion_model {slv['motion_model']} requires solver.method "
            "global_contrast_maximization (tile solvers parameterize per-tile translations)"
        )
    _choice(
        slv, "warp_direction",
        {"first", "middle", "last", "random", "before", "after"}, "solver",
    )
    if is_global:
        patch = slv.get("patch") or {}  # optional: only 'initialize' applies
        _choice(patch, "initialize", {"random", "zero"}, "solver.patch")
    else:
        patch = _require(slv, "patch", dict, "solver")
        _choice(patch, "initialize", {"random", "zero", "grid-best", "global-best", "optuna-sampling"},
                "solver.patch")
        _choice(patch, "filter_type", {"bilinear", "nearest"}, "solver.patch")
    iwe = _require(slv, "iwe", dict, "solver")
    _choice(iwe, "method", set(IWE_METHODS), "solver.iwe")
    _require(iwe, "blur_sigma", _NUM, "solver.iwe")
    _choice(slv, "precision", {"32", "64", 32, 64}, "solver")
    _choice(slv, "iwe_backend", {"auto", "scatter", "matmul", "pallas", "pallas_bf16"}, "solver")
    if slv.get("time_aware"):
        from ..flow.voxel import DEVICE_SCHEMES, HOST_SCHEMES

        for key in ("flow_interpolation", "t0_flow_location"):
            _require(slv, key, str, "solver")
        _choice(slv, "t0_flow_location", {"first", "middle"}, "solver")
        tb = slv.get("time_bin", 10)
        if not isinstance(tb, int) or tb < 1:
            raise ConfigError(f"config key 'solver.time_bin' must be a positive int, got {tb!r}")
        scheme = _choice(slv, "flow_interpolation", set(DEVICE_SCHEMES) | set(HOST_SCHEMES), "solver")
        if scheme in HOST_SCHEMES:
            raise ConfigError(
                f"config key 'solver.flow_interpolation: {scheme!r}' selects a host scipy griddata "
                "scheme, which the JAX package cannot solve either (its objective hands the traced flow "
                "to scipy there and raises, flow/voxel.py): not ported yet"
            )
    for key in slv:
        if key not in _KNOWN_SOLVER_KEYS:
            warnings.append(f"unknown config key 'solver.{key}' (ignored?)")

    # top-level parallel: {data: N, event: M}, the device mesh's axes;
    # main.py forwards it to the solver as solver_config["parallel"]
    par = config.get("parallel")
    if par is not None:
        if not isinstance(par, dict):
            raise ConfigError(f"config key 'parallel' must be a dict, got {type(par).__name__}")
        for axis in ("data", "event"):
            v = par.get(axis, 1)
            if not isinstance(v, int) or v < 1:
                raise ConfigError(f"config key 'parallel.{axis}' must be a positive int, got {v!r}")
        for key in par:
            if key not in _KNOWN_PARALLEL_KEYS:
                warnings.append(f"unknown config key 'parallel.{key}' (ignored?)")

    opt = config["optimizer"]
    _choice(opt, "method", set(OPTIMIZERS), "optimizer")
    _require(opt, "method", str, "optimizer")
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
    frac = opt.get("coarse_event_fraction", 1.0)
    if not isinstance(frac, (int, float)) or not (0.0 < float(frac) <= 1.0):
        raise ConfigError(f"'optimizer.coarse_event_fraction' must be in (0, 1], got {frac!r}")
    for budget_key in ("coarse_max_iter", "coarse_cg_maxiter", "lbfgs_memory"):
        if budget_key in opt:
            val = opt[budget_key]
            if not isinstance(val, int) or val < 1:
                raise ConfigError(
                    f"'optimizer.{budget_key}' must be a positive int, got {val!r}"
                )
    if "warm_finest_only" in opt and not isinstance(opt["warm_finest_only"], bool):
        raise ConfigError(f"'optimizer.warm_finest_only' must be a bool, got {opt['warm_finest_only']!r}")
    if "warm_full_every" in opt:
        val = opt["warm_full_every"]
        if not isinstance(val, int) or val < 0:
            raise ConfigError(f"'optimizer.warm_full_every' must be an int >= 0, got {val!r}")
    dev_solver = opt.get("device_solver", "newton-cg")
    if str(dev_solver).lower() not in ("newton-cg", "lbfgs"):
        raise ConfigError(f"'optimizer.device_solver' must be 'newton-cg' or 'lbfgs', got {dev_solver!r}")
    # optimizer.chain (default on): the pyramid and the fleet run chained,
    # their Newton evaluations replayed from CUDA graphs (solver/graphs.py)
    if not isinstance(opt.get("chain", True), bool):
        warnings.append(f"'optimizer.chain' is read as a bool, got {opt['chain']!r}")
    for key in opt:
        if key not in _KNOWN_OPT_KEYS:
            warnings.append(f"unknown config key 'optimizer.{key}' (ignored?)")

    check_ported({"data": data, "solver": slv, "optimizer": opt})

    for w in warnings:
        logger.warning(w)
    return warnings
