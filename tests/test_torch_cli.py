"""The port's CLI eval loop against the JAX CLI's (``main.py``), and the
port's independence from JAX.

* The synthetic loader is byte-identical: same events, same GT, same
  frame times for the same config.
* ``--eval`` on a tiny synthetic config: the JAX package in Pallas
  interpret mode at ``precision: "64"`` (the TPU route), the port on the
  CPU at float64, with JAX's init-sweep draws fed to the port
  (``candidates_fn``).  Per-frame EPE, AE and FWL agree to 1e-6 (last-bit
  differences of the two frameworks' sums, amplified through a few
  Newton iterations); a rerun adds no lines.
* A run begun by the JAX CLI (its ``eval_state.npz``) resumes in the
  port exactly as it resumes in the JAX CLI.
* The whole port imports, and its CLI runs, with ``jax`` blocked.
* Config validation: the shipped configs the port runs validate with the
  JAX package's warnings; every other one is refused up front.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import main as jax_cli
from event_based_optical_flow_tpu import data as jdata
from event_based_optical_flow_tpu import solver as jsolver
from event_based_optical_flow_tpu import visualizer
from event_based_optical_flow_tpu_torch import data as tdata
from event_based_optical_flow_tpu_torch import main as port_cli
from test_torch_pyramid import JaxDraws

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_DIR = REPO / "event_based_optical_flow_tpu_torch"
METRICS = ("EPE", "1PE", "3PE", "AE", "GT_FWL", "PRED_FWL")
TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _config(out_dir) -> dict:
    return {
        "is_dnn": False,
        "data": {
            "eval_dt": 1, "root": "", "dataset": "synthetic", "sequence": "tiny",
            "height": 36, "width": 44, "load_gt_flow": True, "gt": ".",
            "n_events_per_batch": 2000, "ind1": 0, "ind2": 3000,
            "duration": 0.75, "event_rate": 8000, "n_frames": 3, "visualize_every": 0,
            "pattern": "dots", "n_dots": 80,
        },
        "output": {"output_dir": str(out_dir), "show_interactive_result": False},
        "solver": {
            "method": "pyramidal_patch_contrast_maximization", "time_aware": False,
            "patch": {"initialize": "random", "scale": 3, "crop_height": 32, "crop_width": 40,
                      "filter_type": "bilinear"},
            "motion_model": "2d-translation", "warp_direction": "first",
            "parameters": ["trans_x", "trans_y"], "cost": "hybrid", "outer_padding": 0,
            "cost_with_weight": {"multi_focal_normalized_gradient_magnitude": 1.0, "total_variation": 0.01},
            "iwe": {"method": "bilinear_vote", "blur_sigma": 1},
            "iwe_backend": "pallas", "precision": "64",
        },
        "optimizer": {
            "n_iter": 8, "method": "Newton-CG", "max_iter": 2, "cg_maxiter": 4,
            "parameters": {"trans_x": {"min": -20, "max": 20}, "trans_y": {"min": -20, "max": 20}},
        },
    }


def _jax_eval(config):
    out_dir = config["output"]["output_dir"]
    os.makedirs(out_dir, exist_ok=True)
    d = config["data"]
    loader = jdata.collections[d["dataset"]](config=d)
    loader.set_sequence(d["sequence"])
    viz = visualizer.Visualizer((d["height"], d["width"]), show=False, save=True, save_dir=out_dir)
    solv = jsolver.collections[config["solver"]["method"]](
        (d["height"], d["width"]), calibration_parameter=loader.load_calib(),
        solver_config=config["solver"], optimizer_config=config["optimizer"],
        output_config=config["output"], visualize_module=viz,
    )
    jax_cli.evaluate_dataset_with_gt(loader.eval_frame_time_list(), d, loader, solv)


def _metrics(out_dir):
    with open(os.path.join(out_dir, "eval_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _text_lines(out_dir):
    with open(os.path.join(out_dir, "flow_error_per_frame_with_mask.txt")) as f:
        return f.read().strip().splitlines()


def _assert_same_metrics(got, want):
    assert [r["frame"] for r in got] == [r["frame"] for r in want]
    for g, w in zip(got, want):
        for k in METRICS:
            assert g[k] == pytest.approx(w[k], rel=0, abs=TOL), (g["frame"], k, g[k], w[k])


@pytest.mark.parametrize("extra", [
    {},
    {"pattern": "dots", "n_dots": 50},
    {"scene": "rot", "noise_fraction": 0.1},
    {"scene": "disc", "gt_advection": True},
])
def test_synthetic_loader_is_byte_identical(extra):
    config = {**_config("unused")["data"], "pattern": "lattice", "n_frames": 5, **extra}
    jl = jdata.collections["synthetic"](config=dict(config))
    tl = tdata.collections["synthetic"](config=dict(config))
    jl.set_sequence("mvsec-geometry")
    tl.set_sequence("mvsec-geometry")
    assert len(jl) == len(tl) > 0
    np.testing.assert_array_equal(tl.load_event(0, len(tl)), jl.load_event(0, len(jl)))
    ts_j, ts_t = jl.eval_frame_time_list(), tl.eval_frame_time_list()
    np.testing.assert_array_equal(ts_t, ts_j)
    for t1, t2 in ((ts_j[0], ts_j[1]), (ts_j[1], ts_j[3])):
        assert tl.time_to_index(t1) == jl.time_to_index(t1)
        np.testing.assert_array_equal(tl.load_optical_flow(t1, t2), jl.load_optical_flow(t1, t2))


def test_eval_matches_jax_cli_and_rerun_adds_nothing(tmp_path):
    jcfg, tcfg = _config(tmp_path / "jax"), _config(tmp_path / "port")
    _jax_eval(jcfg)
    records = port_cli.run(tcfg, eval_mode=True, device=torch.device("cpu"), candidates_fn=JaxDraws())
    assert [r["frame"] for r in records] == [0, 1]
    want, got = _metrics(tmp_path / "jax"), _metrics(tmp_path / "port")
    assert len(got) == 2
    _assert_same_metrics(got, want)
    assert all(np.isfinite(r["EPE"]) and np.isfinite(r["PRED_FWL"]) for r in got)
    assert all(r["stats"]["syncs"] > 0 for r in records)
    port_lines = _text_lines(tmp_path / "port")
    assert [l.split("::")[0] for l in port_lines] == [l.split("::")[0] for l in _text_lines(tmp_path / "jax")]

    # the checkpoint layout is the JAX CLI's: same keys, same shapes
    with np.load(tmp_path / "jax" / "eval_state.npz") as j, np.load(tmp_path / "port" / "eval_state.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        assert int(t["__next_frame"]) == int(j["__next_frame"]) == 2
        for k in j.files:
            assert t[k].shape == j[k].shape and t[k].dtype == j[k].dtype

    # a rerun on the same output dir resumes at the end and adds no lines
    assert port_cli.run(tcfg, eval_mode=True, device=torch.device("cpu")) == []
    assert _text_lines(tmp_path / "port") == port_lines
    assert len(_metrics(tmp_path / "port")) == 2


def test_port_resumes_a_jax_run(tmp_path):
    """Frame 0 by the JAX CLI; frame 1 resumed from its eval_state.npz
    once by the JAX CLI and once by the port: the same metrics."""
    first = _config(tmp_path / "jax")
    first["data"]["ind2"] = 0
    _jax_eval(first)
    shutil.copytree(tmp_path / "jax", tmp_path / "port")

    _jax_eval(_config(tmp_path / "jax"))
    records = port_cli.run(_config(tmp_path / "port"), eval_mode=True, device=torch.device("cpu"),
                           candidates_fn=JaxDraws())
    assert [r["frame"] for r in records] == [1]
    got, want = _metrics(tmp_path / "port"), _metrics(tmp_path / "jax")
    assert len(got) == len(want) == 2
    _assert_same_metrics(got, want)


def test_port_imports_and_runs_without_jax(tmp_path):
    """Every module of the port imports with ``jax`` blocked, none pulls in
    the JAX package, and the CLI's --eval runs on the CPU."""
    sources = [p for p in PORT_DIR.rglob("*.py")]
    assert sources
    for path in sources:
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "event_based_optical_flow_tpu." not in text.replace("event_based_optical_flow_tpu_torch.", ""), path

    config = _config(tmp_path / "out")
    config["solver"].pop("iwe_backend")
    config["data"]["ind2"] = 0
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(config))
    script = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import event_based_optical_flow_tpu_torch as port\n"
        "names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert not any(m == 'event_based_optical_flow_tpu' or m.startswith('event_based_optical_flow_tpu.')\n"
        "               for m in sys.modules), 'the JAX package was imported'\n"
        "print('modules', len(names))\n"
        "from event_based_optical_flow_tpu_torch.main import main\n"
        f"main(['--config_file', {str(cfg_path)!r}, '--eval', '--device', 'cpu'])\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True,
                          timeout=240, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert int(proc.stdout.split("modules", 1)[1].split()[0]) >= 25
    metrics = _metrics(tmp_path / "out")
    assert [r["frame"] for r in metrics] == [0] and np.isfinite(metrics[0]["EPE"])


PORTED_CONFIGS = {"synthetic_mvsec_geometry.yaml", "synthetic_quickstart.yaml"}


@pytest.mark.parametrize("name", sorted(p.name for p in (REPO / "configs").glob("*.yaml")))
def test_config_validation(name):
    """Every shipped config the JAX package accepts either validates in the
    port with the same warnings, or is refused up front with a ConfigError
    naming what is not ported yet."""
    from event_based_optical_flow_tpu.utils import validate_config as jax_validate
    from event_based_optical_flow_tpu_torch.utils import ConfigError, validate_config

    config = yaml.safe_load((REPO / "configs" / name).read_text())
    want = jax_validate(config)
    if name in PORTED_CONFIGS:
        assert validate_config(config) == want
        config["optimizer"]["surprise"] = 1
        assert validate_config(config) == jax_validate(config) == ["unknown config key 'optimizer.surprise' (ignored?)"]
        for section, key, value in (("solver", "time_aware", True), ("optimizer", "hvp_mode", "analytic")):
            with pytest.raises(ConfigError, match="not ported yet"):
                validate_config({**config, section: {**config[section], key: value}})
    else:
        with pytest.raises(ConfigError, match="not ported yet|must be one of"):
            validate_config(config)
