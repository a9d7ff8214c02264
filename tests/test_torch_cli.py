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
* ``--eval`` on an MVSEC-layout fixture (``chip_smoke.mvsec_fixture``,
  the reference protocol's data block) and the GT-free loop on an ECD text
  fixture: the JAX CLI's per-frame metrics, text lines, checkpoint and
  ``output.save_flow`` dumps; a rerun adds nothing.
* The whole port imports, and its CLI runs, with ``jax`` blocked.
* Config validation: the shipped configs the port runs validate with the
  JAX package's warnings; every other one is refused up front.
"""

import copy
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
from PIL import Image

import chip_smoke
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
    """The JAX CLI's eval on ``config``: the GT-free loop when the loader
    has no GT, else the sequential loop."""
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
    if loader.gt_flow_available:
        jax_cli.evaluate_dataset_with_gt(loader.eval_frame_time_list(), d, loader, solv)
    else:
        jax_cli.evaluate_dataset_fwl_only(loader.eval_frame_time_list(), d, loader, solv)


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
    """Every module of the port and ``chip_smoke.py`` import with ``jax``
    blocked (the data and IO modules among them), none pulls in the JAX
    package, and the CLI's --eval runs on the CPU."""
    sources = [p for p in PORT_DIR.rglob("*.py")] + [REPO / "chip_smoke.py"]
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
        "for n in names + ['chip_smoke']: importlib.import_module(n)\n"
        "assert not any(m == 'event_based_optical_flow_tpu' or m.startswith('event_based_optical_flow_tpu.')\n"
        "               for m in sys.modules), 'the JAX package was imported'\n"
        "print('modules', len(names), ' '.join(names))\n"
        "from event_based_optical_flow_tpu_torch.main import main\n"
        f"main(['--config_file', {str(cfg_path)!r}, '--eval', '--device', 'cpu'])\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True,
                          timeout=240, env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    count, *names = proc.stdout.split("modules", 1)[1].splitlines()[0].split()
    assert int(count) >= 45
    new = {"data.calib", "data.dsec", "data.ecd", "data.evt2", "data.evt3", "data.mvsec", "flow.io",
           "ops.filters", "utils.events"}
    assert {f"event_based_optical_flow_tpu_torch.{m}" for m in new} <= set(names)
    metrics = _metrics(tmp_path / "out")
    assert [r["frame"] for r in metrics] == [0] and np.isfinite(metrics[0]["EPE"])


PORTED_CONFIGS = {"synthetic_fleet.yaml", "synthetic_mvsec_geometry.yaml", "synthetic_quickstart.yaml",
                  "mvsec_indoor_no_timeaware.yaml", "mvsec_indoor_burgers.yaml", "dsec_zurich_city.yaml",
                  "ecd_slider_depth.yaml", "evt2_raw.yaml", "synthetic_rotation_global.yaml",
                  "synthetic_rotation3d_global.yaml", "synthetic_dnn.yaml"}


@pytest.mark.parametrize("name", sorted(p.name for p in (REPO / "configs").glob("*.yaml")))
def test_config_validation(name):
    """Every shipped config the JAX package accepts either validates in the
    port with the same warnings (with ``device_solver: lbfgs`` too), or is
    refused up front with a ConfigError naming what is not ported yet.  Both refuse a global motion model
    under a tile solver, and a TV term under the global solver."""
    from event_based_optical_flow_tpu.utils import ConfigError as JaxConfigError
    from event_based_optical_flow_tpu.utils import validate_config as jax_validate
    from event_based_optical_flow_tpu_torch.utils import ConfigError, validate_config

    config = yaml.safe_load((REPO / "configs" / name).read_text())
    want = jax_validate(config)
    if name in PORTED_CONFIGS:
        assert validate_config(config) == want
        config["optimizer"]["surprise"] = 1
        assert validate_config(config) == jax_validate(config) == ["unknown config key 'optimizer.surprise' (ignored?)"]
        griddata = {"time_aware": True, "time_bin": 10, "flow_interpolation": "linear",
                    "t0_flow_location": "middle"}
        with pytest.raises(ConfigError, match="not ported yet"):
            validate_config({**config, "solver": {**config["solver"], **griddata}})
        lbfgs = {**config, "optimizer": {**config["optimizer"], "device_solver": "lbfgs"}}
        assert validate_config(copy.deepcopy(lbfgs)) == jax_validate(copy.deepcopy(lbfgs))
        if config["solver"]["method"] == "global_contrast_maximization":
            bad = {**config, "solver": {**config["solver"], "cost": "hybrid", "cost_with_weight": {
                "multi_focal_normalized_gradient_magnitude": 1.0, "total_variation": 0.01}}}
            match = "no tile grid"
        else:
            bad = {**config, "solver": {**config["solver"], "motion_model": "3-rotation"}}
            match = "requires solver.method global_contrast_maximization"
        for validate, error in ((validate_config, ConfigError), (jax_validate, JaxConfigError)):
            with pytest.raises(error, match=match):
                validate(bad)
    else:
        with pytest.raises(ConfigError, match="not ported yet|must be one of"):
            validate_config(config)


def test_dsec_solver_and_optimizer_blocks_validate(tmp_path):
    """configs/dsec_zurich_city.yaml's solver and optimizer blocks (the
    analytic HVP, the coarse-scale event subsample, the FD polish) validate
    in the port with the JAX package's warnings, also under a synthetic
    data block (as chip_smoke.py runs them); a coarse_event_fraction
    outside (0, 1] is refused by both."""
    from event_based_optical_flow_tpu.utils import validate_config as jax_validate
    from event_based_optical_flow_tpu_torch.utils import ConfigError, validate_config

    config = yaml.safe_load((REPO / "configs" / "dsec_zurich_city.yaml").read_text())
    assert config["optimizer"]["hvp_mode"] == "analytic"
    assert config["optimizer"]["coarse_event_fraction"] == 0.25
    config["data"] = _config(tmp_path)["data"]
    assert validate_config(config) == jax_validate(config) == []
    for frac in (0.0, 1.5):
        bad = {**config, "optimizer": {**config["optimizer"], "coarse_event_fraction": frac}}
        for validate in (validate_config, jax_validate):
            with pytest.raises(ConfigError if validate is validate_config else Exception,
                               match="coarse_event_fraction"):
                validate(bad)


def test_burgers_solver_and_optimizer_blocks_validate(tmp_path):
    """configs/mvsec_indoor_burgers.yaml's solver and optimizer blocks (the
    time-aware Burgers voxel) validate in the port with the JAX package's
    warnings, also under a synthetic data block (as chip_smoke.py runs
    them); the five device schemes pass, the host griddata schemes are
    refused as not ported."""
    from event_based_optical_flow_tpu.utils import validate_config as jax_validate
    from event_based_optical_flow_tpu_torch.utils import ConfigError, validate_config

    config = yaml.safe_load((REPO / "configs" / "mvsec_indoor_burgers.yaml").read_text())
    assert config["solver"]["time_aware"] and config["solver"]["flow_interpolation"] == "burgers"
    config["data"] = _config(tmp_path)["data"]
    assert validate_config(config) == jax_validate(config) == []
    for scheme in ("upwind", "burgers", "same", "bilinear", "max", "nearest", "linear", "cubic"):
        cfg = {**config, "solver": {**config["solver"], "flow_interpolation": scheme}}
        jax_validate(cfg)
        if scheme in ("nearest", "linear", "cubic"):
            with pytest.raises(ConfigError, match="griddata.*not ported yet"):
                validate_config(cfg)
        else:
            assert validate_config(cfg) == []


@pytest.mark.parametrize("method", ["pyramidal_patch_contrast_maximization",
                                    "time_aware_mixed_patch_contrast_maximization"])
def test_time_aware_eval_runs_on_the_cpu(tmp_path, method):
    """The CLI's eval loop with the Burgers config's time-aware keys (3
    bins) on a tiny scene, with the pyramid and with the single-scale
    solver: finite metrics, one record per frame, the warm state saved (per
    scale, or as the one tile grid) and resumed."""
    config = _config(tmp_path / "out")
    config["solver"].update(method=method, time_aware=True, time_bin=3, flow_interpolation="burgers",
                            t0_flow_location="middle")
    config["solver"]["patch"].update(size=[16, 20], sliding_window=[16, 20])
    config["data"].update(n_frames=4, ind2=1)
    records = port_cli.run(config, eval_mode=True, device=torch.device("cpu"))
    assert [r["frame"] for r in records] == [0, 1]
    assert all(np.isfinite(r["metrics"]["EPE"]) and np.isfinite(r["metrics"]["PRED_FWL"]) for r in records)
    pyramid = method.startswith("pyramidal")
    assert records[0]["stats"]["hvp"] == ({1: "fd", 2: "fd"} if pyramid else {0: "fd"})
    with np.load(tmp_path / "out" / "eval_state.npz") as state:
        assert sorted(state.files) == (["__next_frame", "scale_1", "scale_2"] if pyramid
                                       else ["__next_frame", "array"])
    config["data"]["ind2"] = 2  # one more frame, warm-started from the saved state
    assert [r["frame"] for r in port_cli.run(config, eval_mode=True, device=torch.device("cpu"))] == [2]


def _mvsec_config(root, out_dir) -> dict:
    """configs/mvsec_indoor_no_timeaware.yaml's data block on the
    36x44 fixture of ``chip_smoke.mvsec_fixture`` (eval_dt 4 as shipped,
    frames 0..1 through ind1/ind2, 2000-event windows), with the tiny
    solver of ``_config`` and ``output.save_flow: npz``."""
    config = _config(out_dir)
    shipped = yaml.safe_load((REPO / "configs" / "mvsec_indoor_no_timeaware.yaml").read_text())["data"]
    config["data"] = {**shipped, "root": str(root), "gt": str(root), "height": 36, "width": 44,
                      "n_events_per_batch": 2000, "ind1": 0, "ind2": 1, "visualize_every": 0}
    config["output"]["save_flow"] = "npz"
    return config


@pytest.fixture(scope="module")
def mvsec_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("mvsec")
    datasets = chip_smoke.mvsec_fixture(str(root), 36, 44, event_rate=20000.0, flow_max=15.0)
    chip_smoke.write_mvsec_h5(str(root / "indoor_flying1_data.hdf5"), datasets)
    return root


def _dumps(out_dir):
    sub = pathlib.Path(out_dir) / "flow_submission"
    return {p.name: p for p in sorted(sub.iterdir())}


def test_mvsec_eval_matches_jax_cli_and_rerun_adds_nothing(tmp_path, mvsec_root):
    """The reference protocol's data block on an indoor_flying1 fixture in
    MVSEC's layout: frames 0 and 1 (warm-started) give the JAX CLI's
    per-frame metrics to 1e-6 with its draws injected, the same text lines,
    checkpoint layout and npz flow dumps (to 1e-6); a rerun adds nothing."""
    jcfg, tcfg = _mvsec_config(mvsec_root, tmp_path / "jax"), _mvsec_config(mvsec_root, tmp_path / "port")
    _jax_eval(jcfg)
    records = port_cli.run(tcfg, eval_mode=True, device=torch.device("cpu"), candidates_fn=JaxDraws())
    assert [r["frame"] for r in records] == [0, 1]
    want, got = _metrics(tmp_path / "jax"), _metrics(tmp_path / "port")
    _assert_same_metrics(got, want)
    assert all(np.isfinite(r["EPE"]) and np.isfinite(r["PRED_FWL"]) for r in got)
    port_lines = _text_lines(tmp_path / "port")
    assert [l.split("::")[0] for l in port_lines] == [l.split("::")[0] for l in _text_lines(tmp_path / "jax")]
    with np.load(tmp_path / "jax" / "eval_state.npz") as j, np.load(tmp_path / "port" / "eval_state.npz") as t:
        assert sorted(j.files) == sorted(t.files) and int(t["__next_frame"]) == int(j["__next_frame"]) == 2
    jd, td = _dumps(tmp_path / "jax"), _dumps(tmp_path / "port")
    assert list(td) == list(jd) == ["000000.npz", "000001.npz"]
    for name in jd:
        with np.load(jd[name]) as j, np.load(td[name]) as t:
            assert t["flow"].shape == j["flow"].shape == (2, 36, 44) and t["flow"].dtype == np.float32
            np.testing.assert_allclose(t["flow"], j["flow"], rtol=0, atol=TOL)
    assert port_cli.run(tcfg, eval_mode=True, device=torch.device("cpu")) == []
    assert _text_lines(tmp_path / "port") == port_lines and len(_metrics(tmp_path / "port")) == 2


def _ecd_config(root, out_dir) -> dict:
    """configs/ecd_slider_depth.yaml's data block on a 36x44 ECD text
    fixture (3 clock times: two windows), the tiny solver of ``_config``,
    ``output.save_flow: dsec_png``."""
    config = _config(out_dir)
    shipped = yaml.safe_load((REPO / "configs" / "ecd_slider_depth.yaml").read_text())["data"]
    config["data"] = {**shipped, "root": str(root), "height": 36, "width": 44, "n_events_per_batch": 2000,
                      "eval_n_frames": 3, "visualize_every": 0}
    config["output"]["save_flow"] = "dsec_png"
    return config


def test_fwl_only_eval_matches_jax_on_ecd_and_resumes(tmp_path):
    """The GT-free protocol on an ECD text fixture (the synthetic dots
    scene written as ``t x y p`` lines): both windows give the JAX CLI's
    PRED_FWL to 1e-6 with its draws injected, the same text lines,
    checkpoint and DSEC-PNG dumps (to one 1/128 px quantum); a rerun adds
    no lines."""
    scene = tdata.collections["synthetic"](config={"height": 36, "width": 44, "duration": 0.5, "event_rate": 9000,
                                                   "pattern": "dots", "n_dots": 80})
    scene.set_sequence("slider_depth")
    ev = scene.load_event(0, len(scene))
    (tmp_path / "data" / "slider_depth").mkdir(parents=True)
    np.savetxt(tmp_path / "data" / "slider_depth" / "events.txt", np.stack([ev[:, 2], ev[:, 1], ev[:, 0], ev[:, 3]], 1),
               fmt="%.9f %d %d %d")
    jcfg, tcfg = (_ecd_config(tmp_path / "data", tmp_path / name) for name in ("jax", "port"))
    _jax_eval(jcfg)
    records = port_cli.run(tcfg, eval_mode=True, device=torch.device("cpu"), candidates_fn=JaxDraws())
    assert [r["frame"] for r in records] == [0, 1]
    want, got = _metrics(tmp_path / "jax"), _metrics(tmp_path / "port")
    assert [sorted(r) for r in got] == [sorted(r) for r in want] == [["PRED_FWL", "frame"]] * 2
    for g, w in zip(got, want):
        assert g["frame"] == w["frame"] and g["PRED_FWL"] == pytest.approx(w["PRED_FWL"], rel=0, abs=TOL)
        assert np.isfinite(g["PRED_FWL"])
    port_lines = _text_lines(tmp_path / "port")
    assert [l.split("::")[0] for l in port_lines] == [l.split("::")[0] for l in _text_lines(tmp_path / "jax")]
    with np.load(tmp_path / "jax" / "eval_state.npz") as j, np.load(tmp_path / "port" / "eval_state.npz") as t:
        assert sorted(j.files) == sorted(t.files) and int(t["__next_frame"]) == int(j["__next_frame"]) == 2
    from event_based_optical_flow_tpu_torch.flow.io import read_png16

    jd, td = _dumps(tmp_path / "jax"), _dumps(tmp_path / "port")
    assert list(td) == list(jd) == ["000000.png", "000001.png"]
    for name in jd:
        np.testing.assert_allclose(read_png16(td[name]), read_png16(jd[name]), rtol=0, atol=1)
    assert port_cli.run(tcfg, eval_mode=True, device=torch.device("cpu")) == []
    assert _text_lines(tmp_path / "port") == port_lines and len(_metrics(tmp_path / "port")) == 2


def test_time_aware_eval_runs_on_the_mvsec_fixture(tmp_path, mvsec_root):
    """configs/mvsec_indoor_burgers.yaml's time-aware keys (3 bins here) on
    the MVSEC fixture: finite metrics for frames 0 and 1, and each frame's
    dump is the t0 slice the metrics score."""
    config = _mvsec_config(mvsec_root, tmp_path / "out")
    burgers = yaml.safe_load((REPO / "configs" / "mvsec_indoor_burgers.yaml").read_text())["solver"]
    config["solver"].update({k: burgers[k] for k in ("time_aware", "flow_interpolation", "t0_flow_location")},
                            time_bin=3)
    records = port_cli.run(config, eval_mode=True, device=torch.device("cpu"))
    assert [r["frame"] for r in records] == [0, 1]
    assert all(np.isfinite(r["metrics"][k]) for r in records for k in METRICS)
    dumps = _dumps(tmp_path / "out")
    assert list(dumps) == ["000000.npz", "000001.npz"]
    with np.load(dumps["000001.npz"]) as d:
        assert d["flow"].shape == (2, 36, 44) and np.isfinite(d["flow"]).all()


def test_data_and_output_keys_validate_as_jax():
    """The keys this slice lifts validate as in the JAX package: the
    raw-camera filters (warned about on a dataset that ignores them),
    ``output.save_flow`` (``dsec_png``/``npz``; another value refused by
    both), ``data.remove_car``."""
    from event_based_optical_flow_tpu.utils import validate_config as jax_validate
    from event_based_optical_flow_tpu_torch.utils import ConfigError, validate_config

    filters = {"hot_pixel_sigma": 5.0, "refractory_us": 50}
    for name, data_update, out_update in (
            ("evt2_raw.yaml", filters, {"save_flow": "npz"}),
            ("mvsec_indoor_no_timeaware.yaml", filters, {"save_flow": "dsec_png"}),
            ("mvsec_indoor_no_timeaware.yaml", {"remove_car": True, "refractory_us": 20}, {}),
            ("ecd_slider_depth.yaml", {"hot_pixel_sigma": 3.0}, {"save_flow": None})):
        config = yaml.safe_load((REPO / "configs" / name).read_text())
        config["data"].update(data_update)
        config["output"].update(out_update)
        want = jax_validate(config)
        assert validate_config(config) == want
        assert ("raw-camera" in " ".join(want)) == (config["data"]["dataset"] != "EVT2")
    config["output"]["save_flow"] = "exr"
    with pytest.raises(ConfigError, match="save_flow"):
        validate_config(config)
    with pytest.raises(Exception, match="save_flow"):
        jax_validate(config)


def test_visualized_mvsec_eval_writes_the_jax_cli_pngs_and_traces(tmp_path, mvsec_root):
    """``data.visualize_every: 1`` on the MVSEC fixture: the port's CLI
    writes the JAX CLI's PNG names for both frames (original, pred_warp,
    pred_masked, gt_warp, gt_flow, optimization_steps), the solution-free
    ones (original, gt_warp, gt_flow) decoding to the JAX CLI's arrays, and
    the same metrics as a run without images.  Single-frame mode with
    ``output.trace_dir`` writes the events' IWE before and after the solve
    and one ``torch.profiler`` trace."""
    jcfg, tcfg = _mvsec_config(mvsec_root, tmp_path / "jax"), _mvsec_config(mvsec_root, tmp_path / "port")
    for cfg in (jcfg, tcfg):
        cfg["data"]["visualize_every"] = 1
    _jax_eval(jcfg)
    port_cli.run(tcfg, eval_mode=True, device=torch.device("cpu"), candidates_fn=JaxDraws())
    pngs = {d: sorted(p.name for p in (tmp_path / d).glob("*.png")) for d in ("jax", "port")}
    assert pngs["port"] == pngs["jax"] == sorted(f"{p}{i}.png" for i in (0, 1) for p in (
        "original", "pred_warp", "pred_masked", "gt_warp", "gt_flow", "optimization_steps"))
    for name in pngs["jax"]:
        if name.startswith(("original", "gt_")):
            np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port" / name)),
                                          np.asarray(Image.open(tmp_path / "jax" / name)), err_msg=name)
    plain = _mvsec_config(mvsec_root, tmp_path / "plain")
    port_cli.run(plain, eval_mode=True, device=torch.device("cpu"), candidates_fn=JaxDraws())
    assert _metrics(tmp_path / "plain") == _metrics(tmp_path / "port")

    single = _mvsec_config(mvsec_root, tmp_path / "single")
    single["data"].update(ind1=0, ind2=1500)
    single["output"]["trace_dir"] = str(tmp_path / "trace")
    port_cli.run(single, eval_mode=False, device=torch.device("cpu"))
    assert sorted(p.name for p in (tmp_path / "single").glob("*.png")) == [
        "0.png", "1.png", "2.png", "3.png", "optimization_steps0.png"]
    traces = list((tmp_path / "trace").glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert "traceEvents" in json.loads(traces[0].read_text())
