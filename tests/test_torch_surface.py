"""The port's public surface against the JAX package's.

The JAX package is read by its syntax tree, never imported: every name in
an ``__all__``, every public module-level function and class, and every
public method of every class (inherited ones included, resolved through
the package's own base classes).  Each name must exist at its counterpart
in ``event_based_optical_flow_tpu_torch`` (the same module path), or stand
in ``RENAMED`` (the port's counterpart under another name, and the test
that holds the one to the other) or in ``NOT_CARRIED`` (a TPU layout or
XLA knob the port has no use for, with the reason).  One case per JAX
module.
"""

import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "event_based_optical_flow_tpu"
PORT_PKG = ROOT / "event_based_optical_flow_tpu_torch"
PORT = "event_based_optical_flow_tpu_torch"

_K = "tests/test_torch_fused_iwe.py::"
_H = "tests/test_torch_hvp.py::"

# JAX name -> (the port's counterpart, the test that holds one to the other)
RENAMED = {
    "ops.interp.pyramid_expand_jax": ("ops.interp.pyramid_expand",
                                      "tests/test_torch_ops.py::test_pyramid_resampling_matches_jax"),
    "ops.pallas_iwe.bilinear_vote_pallas": ("ops.vote.bilinear_vote",
                                            "tests/test_torch_vote.py::test_plain_matches_pallas_on_one_event_set"),
    "ops.pallas_objective.fused_multi_iwe": ("ops.fused_iwe.fused_iwe", _K + "test_plain_version_matches_pallas"),
    "ops.pallas_objective_batched.fused_multi_iwe_batched": (
        "ops.fused_iwe.fused_iwe", _K + "test_batched_plain_version_matches_pallas"),
    "ops.pallas_objective_banded.fused_multi_iwe_banded": (
        "ops.fused_iwe.fused_iwe", _K + "test_plain_version_matches_pallas"),
    "ops.pallas_objective_banded.fused_multi_iwe_banded_voxel": (
        "ops.fused_iwe.fused_iwe", _K + "test_voxel_plain_version_matches_pallas"),
    "ops.pallas_objective_banded.fused_multi_iwe_banded_batched": (
        "ops.fused_iwe.fused_iwe", _K + "test_batched_plain_version_matches_pallas"),
    "ops.pallas_objective_banded.fused_multi_iwe_banded_voxel_batched": (
        "ops.fused_iwe.fused_iwe", _K + "test_batched_plain_version_matches_pallas"),
    "ops.pallas_objective_banded.fused_multi_iwe_banded_jvp": (
        "ops.fused_iwe.fused_iwe_jvp", _H + "test_jvp_plain_version_matches_pallas"),
    "ops.pallas_objective_banded.fused_multi_iwe_banded_voxel_jvp": (
        "ops.fused_iwe.fused_iwe_jvp", _H + "test_voxel_jvp_plain_version_matches_pallas"),
    "ops.pallas_objective_banded.fused_multi_iwe_banded_jvp_batched": (
        "ops.fused_iwe.fused_iwe_jvp", _K + "test_batched_jvp_plain_version_matches_pallas"),
    "ops.pallas_objective_banded.fused_multi_iwe_banded_voxel_jvp_batched": (
        "ops.fused_iwe.fused_iwe_jvp", _K + "test_batched_jvp_plain_version_matches_pallas"),
    "ops.pallas_objective_banded.fused_multi_iwe_banded_hvp_bwd": (
        "ops.fused_iwe.fused_iwe_hvp_bwd", _H + "test_hvp_bwd_plain_version_matches_pallas"),
    "ops.pallas_objective_banded.fused_multi_iwe_banded_voxel_hvp_bwd": (
        "ops.fused_iwe.fused_iwe_hvp_bwd", _H + "test_voxel_hvp_bwd_plain_version_matches_pallas"),
    "ops.pallas_objective_banded.fused_multi_iwe_banded_hvp_bwd_batched": (
        "ops.fused_iwe.fused_iwe_hvp_bwd", _K + "test_batched_hvp_bwd_plain_version_matches_pallas"),
    "ops.pallas_objective_banded.fused_multi_iwe_banded_voxel_hvp_bwd_batched": (
        "ops.fused_iwe.fused_iwe_hvp_bwd", _K + "test_batched_hvp_bwd_plain_version_matches_pallas"),
    "solver.objective.build_objective_banded": (
        "solver.objective.build_objective", "tests/test_torch_costs.py::test_cost_through_the_tile_objective_matches_jax"),
    "solver.objective.build_orig_iwe_banded": (
        "solver.objective.build_orig_iwe", "tests/test_torch_costs.py::test_cost_through_the_tile_objective_matches_jax"),
    "solver.objective.build_objective_banded_hvp": (
        "solver.objective.build_objective_hvp", _H + "test_staged_and_unstaged_hvp_match_jax"),
    "solver.objective.build_objective_banded_hvp_staged": (
        "solver.objective.build_objective_hvp_staged", _H + "test_staged_and_unstaged_hvp_match_jax"),
    "solver.fleet.build_orig_iwe_banded_batched": (
        "solver.fleet.build_orig_iwe_batched", "tests/test_torch_fleet.py::test_batched_objective_matches_jax"),
    "solver.fleet.build_batched_objective_banded": (
        "solver.fleet.build_batched_objective", "tests/test_torch_fleet.py::test_batched_objective_matches_jax"),
    "solver.fleet.build_batched_objective_banded_hvp": (
        "solver.fleet.build_batched_objective_hvp_staged", "tests/test_torch_fleet.py::test_batched_staged_hvp_matches_jax"),
    "solver.fleet.build_newton_cg_batched": (
        "solver.fleet.BatchedNewtonCG", "tests/test_torch_fleet.py::test_lockstep_newton_on_cmax_objective_matches_jax"),
    "solver.fleet.build_lbfgs_batched": ("solver.fleet.BatchedLBFGS", "tests/test_torch_lbfgs.py::test_batched_lbfgs_matches_jax"),
    "solver.optax_loop.run_first_order": (
        "solver.first_order.run_first_order", "tests/test_torch_optimizers.py::test_first_order_loop_matches_jax"),
}

_BAND = "a knob or packer of the TPU kernels' band / tile / flex event layouts; the CUDA kernels take the events unpacked"
# JAX name (or "module.*": every name of a module) -> why the port has no counterpart
NOT_CARRIED = {
    "config": "XLA's compile cache and the iwe_backend switch; the port has one backend per device",
    "config.*": "XLA's compile cache and the iwe_backend switch; the port has one backend per device",
    "native.pack_events": "native/packer.cpp packs events into the TPU kernels' bands; the port has no band layout",
    "parallel.sharded.pad_chunks_for_sharding": "pads the banded chunk layout to a multiple of the XLA mesh's shards; "
                                                "the port cuts a frame's sorted events at run boundaries",
    "parallel.sharded.fleet_shardings": "jax.sharding NamedShardings of the fleet's arrays; the port places each "
                                        "shard's tensors on its device explicitly",
    "solver.TORCH_OPTIMIZERS": "the torch.optim names mapped to optax; the port's list is solver.FIRST_ORDER",
    "solver.objective.objective_uses_fused": "picks the XLA / Pallas route of an objective; the port's route is "
                                             "the fused CUDA kernel, its unfused options read by is_unfused",
    "solver.objective.objective_uses_banded": "picks the XLA / Pallas route of an objective; the port's route is "
                                              "the fused CUDA kernel, its unfused options read by is_unfused",
    "solver.fleet.pack_fleet_banded": _BAND,
    **{f"ops.pallas_objective_banded.{name}": _BAND for name in (
        "max_chunks", "max_chunks_tile", "n_bands_of", "n_col_bands", "pack_events_by_band", "pack_events_by_band_bin",
        "pack_events_by_tile", "pack_events_by_tile_flex", "pack_events_dense", "objective_row_window",
        "objective_col_window", "objective_dense_packing", "objective_dense_col_bands", "objective_dense_chunk",
        "objective_tent", "objective_row_scale", "objective_pregather")},
}

# the names this slice ported: each must be the port's own, on neither list
PORTED_HERE = (
    "native.available", "native.decode_evt2", "native.decode_evt3", "native.png_defilter",
    "ops.resize_flow", "ops.EventImageConverter", "ops.count_vote", "ops.interp.resize_flow",
    "ops.warp.warp_voxel_flow_streaming", "flow.generate_dense_optical_flow", "flow.upwind_step", "flow.burgers_step",
    "flow.construct_dense_flow_voxel", "flow.propagate_flow_to_voxel", "flow.gt.generate_dense_optical_flow",
    "costs.hybrid_loss", "costs.functional.hybrid_loss", "costs.registry.HybridCost.update_weight",
    "utils.profile_section", "utils.misc.profile_section", "utils.misc.timing_report", "utils.misc.clear_timings",
    "types.FlowPatch.position", "types.FlowPatch.flow", "types.FlowPatch.update_flow", "types.FlowPatch.copy",
    "data.synthetic.SyntheticDataLoader.gt_time_list", "solver.build_value_grad_hvp",
    "solver.sampling.build_global_search", "solver.pyramid.PyramidalPatchContrastMaximization.calculate_fwl",
    *(f"solver.base.SolverBase.{m}" for m in (
        "motion_model_to_motion", "motion_to_motion_model", "motion_to_dense_flow", "initialize_random",
        "initialize_zeros", "update_time_scale_for_previous_frame_best_estimation", "prepare_events",
        "calculate_fwl", "undistort_image", "setup_single_training", "train")),
    *(f"solver.patch_base.PatchContrastMaximization.{m}" for m in (
        "set_patch_size_and_sliding_window", "interpolate_dense_flow_from_patch", "motion_to_dense_flow")),
)


def _module_name(path: Path) -> str:
    parts = list(path.relative_to(JAX_PKG).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _parse():
    return {_module_name(p): ast.parse(p.read_text()) for p in sorted(JAX_PKG.rglob("*.py"))}


TREES = _parse()


def _imported_names(module: str, tree: ast.Module) -> dict:
    """Relative ``from ... import`` names of a module -> (source module, name)."""
    is_pkg = (JAX_PKG / module.replace(".", "/") / "__init__.py").exists() if module else True
    package = module.split(".") if module and is_pkg else module.split(".")[:-1] if module else []
    out = {}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.level:
            base = package[:len(package) - (node.level - 1)]
            src = ".".join(base + (node.module.split(".") if node.module else []))
            out.update({a.asname or a.name: (src, a.name) for a in node.names})
    return out


def _classes():
    return {(m, n.name): n for m, t in TREES.items() for n in t.body if isinstance(n, ast.ClassDef)}


CLASSES = _classes()
IMPORTS = {m: _imported_names(m, t) for m, t in TREES.items()}


def _methods(module: str, cls: str) -> set:
    """Public methods of a JAX class, its package bases' included."""
    node = CLASSES[(module, cls)]
    out = {n.name for n in node.body
           if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and not n.name.startswith("_")}
    for base in node.bases:
        if isinstance(base, ast.Name):
            src = (module, base.id) if (module, base.id) in CLASSES else IMPORTS[module].get(base.id)
            if src in CLASSES:
                out |= _methods(*src)
    return out


def public_names(module: str) -> list:
    """(qualified name, kind) of a JAX module's public surface."""
    tree = TREES[module]
    prefix = module + "." if module else ""
    names = []
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            names += [(prefix + e.value, "__all__") for e in node.value.elts]
        elif isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            names.append((prefix + node.name, "function"))
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            names.append((prefix + node.name, "class"))
            names += [(f"{prefix}{node.name}.{m}", "method") for m in sorted(_methods(module, node.name))]
    return names


def resolve(qualified: str):
    """The port's object at a qualified name, or None."""
    parts = qualified.split(".")
    for cut in range(len(parts), -1, -1):
        try:
            obj = importlib.import_module(".".join([PORT] + parts[:cut]))
        except ModuleNotFoundError:
            continue
        for attr in parts[cut:]:
            if not hasattr(obj, attr):
                return None
            obj = getattr(obj, attr)
        return obj
    return None


def _not_carried(qualified: str) -> bool:
    module = qualified.rsplit(".", 1)[0]
    return qualified in NOT_CARRIED or f"{module}.*" in NOT_CARRIED


def _test_exists(ref: str) -> bool:
    path, name = ref.split("::")
    tree = ast.parse((ROOT / path).read_text())
    return any(isinstance(n, ast.FunctionDef) and n.name == name for n in tree.body)


@pytest.mark.parametrize("module", sorted(TREES), ids=lambda m: m or "<package>")
def test_every_public_name_is_ported_renamed_or_set_aside(module):
    missing = []
    for qualified, kind in public_names(module):
        if resolve(qualified) is not None:
            assert qualified not in RENAMED and not _not_carried(qualified), \
                f"{qualified} is in the port: take it off RENAMED / NOT_CARRIED"
        elif qualified in RENAMED:
            target, holder = RENAMED[qualified]
            assert resolve(target) is not None, f"{qualified}: the port has no {target}"
            assert _test_exists(holder), f"{qualified}: no test {holder}"
        elif not _not_carried(qualified):
            missing.append(f"{qualified} ({kind})")
    assert not missing, f"the port lacks {missing}"


def test_the_lists_name_only_real_jax_names():
    """No stale entry: each key is a public name of the JAX package (or one
    of its modules), each reason is given, and nothing this slice ported is
    on either list."""
    every = {q for m in TREES for q, _ in public_names(m)}
    for key in RENAMED:
        assert key in every, key
    for key, reason in NOT_CARRIED.items():
        assert (key[:-2] in TREES) if key.endswith(".*") else key in every, key
        assert reason
    for name in PORTED_HERE:
        assert name in every, name
        assert resolve(name) is not None, name
        assert name not in RENAMED and not _not_carried(name), name


def test_the_port_imports_nothing_of_jax():
    """No module of the port (nor ``chip_smoke.py``) imports ``jax`` or the
    JAX package, and the native decoders build from the port's own copies
    of their sources."""
    offenders = []
    for path in sorted(PORT_PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                mods = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}: {m}" for m in mods
                          if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "event_based_optical_flow_tpu")]
    assert not offenders, offenders
    from event_based_optical_flow_tpu_torch import native

    assert native.SRC_DIR == PORT_PKG / "native"
    assert all((native.SRC_DIR / f"{name}.cpp").is_file() for name in native.SOURCES)
