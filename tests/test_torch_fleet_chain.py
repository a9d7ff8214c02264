"""The port's fleet chain (``optimizer.chain``, on by default:
``FleetPyramidalSolver._optimize_batch_chain``, its warm modes and
``_optimize_batch_warm_finest``) against the JAX package's
(``solver/fleet.py``: ``optimize_batch`` with ``chain: true``), float64,
JAX's Pallas kernels in interpret mode (``iwe_backend: pallas``), Newton
budgets of 2 iterations (the piecewise objective amplifies last-bit
differences, ``tests/test_torch_pyramid.py``).

JAX's draws are injected: the cold starts come from the same numpy
generator on both sides, and the chain's init sweep takes one key per finer
scale, split over the ``B x P`` patch batch frame-major (``ChainDraws``: the
port's chain sweeps the batch in one call per scale).

* Per scale and per frame to 1e-6: cold (dense FD), shared warm (one motion
  dict for every frame: ``data.warm_start: batch``), per-frame warm (the
  multi-stream serving case), the DSEC block's split coarse chain (analytic
  HVP, ``fd_polish``, the stride-4 subsample), time-aware (Gauss-Newton).
* The warm finest-only fast path, per-frame and shared warm.
* The chain and the loop (``chain: false``) share the coarsest scale and
  draw differently after it, as in the JAX package.
* The CLI's ``warm_start: batch`` fleet eval against the JAX CLI's, run in
  two parts (the second resumes the checkpoint's warm motion), per-frame
  metrics to 1e-6; a rerun adds no line.
"""

import os

import numpy as np
import pytest
import torch

import main as jax_cli
from event_based_optical_flow_tpu import data as jdata
from event_based_optical_flow_tpu import solver as jsolver
from event_based_optical_flow_tpu import visualizer
from event_based_optical_flow_tpu_torch import main as port_cli
from event_based_optical_flow_tpu_torch.solver import fleet as TF
from test_torch_fleet import FLEET_OPTIMIZER, FLEET_SOLVER, SH, SW, T_BINS, _cli_config, _metrics
from test_torch_pyramid import JaxDraws

TOL = 1e-6
CHAIN = dict(FLEET_OPTIMIZER, chain=True)
DSEC = {"hvp_mode": "analytic", "fd_polish": 2, "cg_maxiter": 8, "coarse_event_fraction": 0.25}
TIME_AWARE = {"time_aware": True, "time_bin": T_BINS, "flow_interpolation": "burgers", "t0_flow_location": "middle"}


class ChainDraws(JaxDraws):
    """The JAX fleet chain's init-sweep draws: one key per finer scale
    (``_next_key``), split over the ``[B * P]`` patch batch frame-major
    (``sampling.build_patch_search``), which is ``JaxDraws``' draw with
    ``n_patch = B * P``; records each call's patch count."""

    def __init__(self, n_frames, seed=0):
        super().__init__(seed)
        self.n_frames = n_frames
        self.calls = []

    def __call__(self, n_patch, k1, k2):
        assert n_patch % self.n_frames == 0
        self.calls.append(n_patch)
        return super().__call__(n_patch, k1, k2)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def windows():
    """The optimization windows of eval frames 0 and 1 of a small dots
    scene (~3 000 events each; their counts differ, so the batch's patch
    capacity is its larger frame's)."""
    loader = jdata.collections["synthetic"]({"height": SH, "width": SW, "duration": 1.0, "event_rate": 12000,
                                             "n_frames": 4, "pattern": "dots", "n_dots": 60, "flow_max": 12.0})
    loader.set_sequence("fleet")
    ts = loader.eval_frame_time_list()
    out = []
    for i in (0, 1):
        ev = loader.load_event(loader.time_to_index(ts[i]), loader.time_to_index(ts[i + 1]))
        ev[:, 2] -= ev[:, 2].min()
        out.append(ev)
    assert len(out[0]) != len(out[1])
    return out


def _warm_dict(seed):
    """A smooth per-scale warm motion (px/s) on the solver's two grids."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-8, 8, (2, 1, 1))
    return {1: base + rng.normal(0, 0.5, (2, 2, 2)), 2: base + rng.normal(0, 0.5, (2, 4, 4))}


WARMS = {"shared": _warm_dict(3), "per_frame": [_warm_dict(4), _warm_dict(5)]}
CASES = {
    "cold-dense": ({}, {}, None),
    "shared-warm": ({}, {}, "shared"),
    "per-frame-warm": ({}, {}, "per_frame"),
    "split-coarse": ({}, DSEC, None),
    "time-aware": (TIME_AWARE, {"hvp_mode": "analytic"}, None),
}


def _pair(slv, opt, n_frames=2):
    """(JAX solver, port solver with ``ChainDraws``) of one config."""
    sj = jsolver.collections[slv["method"]]((SH, SW), {}, slv, opt, {}, None)
    st = TF.FleetPyramidalSolver((SH, SW), {}, slv, opt, {}, device="cpu", candidates_fn=ChainDraws(n_frames))
    return sj, st


def _spy(solver, sink, to_np):
    """Record the per-scale motions every frame's result is reduced from."""
    fn = solver.update_coarse_from_fine
    solver.update_coarse_from_fine = lambda m: sink.append({s: to_np(v) for s, v in m.items()}) or fn(m)


def _same_pyramids(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for s in w:
            np.testing.assert_allclose(np.asarray(g[s]), np.asarray(w[s]), rtol=0, atol=TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fleet_chain_matches_jax(windows, case, caplog):
    """Per scale and per frame to 1e-6; the port sweeps each finer scale in
    ONE call over both frames' patches, logs JAX's chain line and records
    the chain's per-scale stats."""
    extra_slv, extra_opt, warm = CASES[case]
    if case == "split-coarse":
        assert all(len(e) > 4 * 512 for e in windows)  # the stride-4 subsample engages
    sj, st = _pair(dict(FLEET_SOLVER, **extra_slv), dict(CHAIN, **extra_opt))
    if warm is not None:
        sj.set_previous_frame_best_estimation(WARMS[warm])
        st.set_previous_frame_best_estimation(WARMS[warm])
    assert sj._chain_ready() and st._chain_ready()
    got_j, got_t = [], []
    _spy(sj, got_j, np.asarray)
    _spy(st, got_t, lambda v: v.numpy().copy())
    bj = sj.optimize_batch(windows)
    with caplog.at_level("INFO"):
        bt = st.optimize_batch(windows)
    assert any(r.getMessage().startswith("fleet chain done (2 frames, 2 scales); losses ") for r in caplog.records)
    assert len(got_j) == len(got_t) == 2
    _same_pyramids(got_t, got_j)
    _same_pyramids([{s: v.numpy() for s, v in b.items()} for b in bt], bj)
    stats = st.last_batch_stats
    n_patch = 4 * 4  # the finest grid
    assert stats["chain"] and st.candidates_fn.calls == [2 * n_patch]
    finest = {"split-coarse": "analytic-gn", "time-aware": "analytic-gn"}.get(case, "fd")
    assert stats["hvp"] == {1: "fd", 2: finest} and stats["syncs"] > 0
    if case == "split-coarse":
        assert stats["events"] == {1: [len(e[::4]) for e in windows], 2: [len(e) for e in windows]}
        assert stats["iters"][2] > CHAIN["max_iter"]  # the polish iterations are counted


@pytest.mark.parametrize("warm", ["per_frame", "shared"])
def test_fleet_warm_finest_matches_jax(windows, warm):
    """``warm_finest_only``: a warm batch solves the finest scale only,
    from each frame's or the shared warm motion, one lockstep solve; every
    scale of the result to 1e-6, the coarse ones the finest's
    ``pyramid_reduce``; no init sweep draws."""
    from event_based_optical_flow_tpu_torch.ops.interp import pyramid_reduce

    sj, st = _pair(FLEET_SOLVER, dict(CHAIN, warm_finest_only=True))
    for s in (sj, st):
        s.set_previous_frame_best_estimation(WARMS[warm])
    bj = sj.optimize_batch(windows)
    bt = st.optimize_batch(windows)
    assert sj._wfo_last is st._wfo_last is True and sj._warm_streak == st._warm_streak == 1
    _same_pyramids([{s: v.numpy() for s, v in b.items()} for b in bt], bj)
    for b in bt:
        assert torch.equal(b[1], pyramid_reduce(b[2]))
    stats = st.last_batch_stats
    assert st.candidates_fn.calls == [] and stats["warm_finest"] and list(stats["iters"]) == [2]
    assert stats["hvp"] == {2: "fd"} and stats["events"] == {2: [len(e) for e in windows]}


def test_chain_and_loop_share_the_coarsest_scale_and_draw_differently(windows, caplog):
    """The same cold starts and lockstep Newton on the coarsest scale, bit
    for bit; the chain's one sweep per scale over the batch and the loop's
    sweep per frame draw differently, so the finest scale differs.  The loop
    drops a warm motion with the JAX package's warning and solves cold."""
    results = {}
    for chain in (True, False):
        st = TF.FleetPyramidalSolver((SH, SW), {}, FLEET_SOLVER, dict(CHAIN, chain=chain), {}, device="cpu")
        results[chain] = (st.optimize_batch(windows), st.last_batch_stats)
    (chained, cs), (loop, ls) = results[True], results[False]
    assert cs["chain"] and not ls["chain"]
    assert cs["loss"][1] == ls["loss"][1] and cs["iters"][1] == ls["iters"][1]
    assert not all(torch.equal(a[2], b[2]) for a, b in zip(chained, loop))
    st = TF.FleetPyramidalSolver((SH, SW), {}, FLEET_SOLVER, dict(CHAIN, chain=False), {}, device="cpu")
    st.set_previous_frame_best_estimation(WARMS["shared"])
    with caplog.at_level("WARNING"):
        cold = st.optimize_batch(windows)
    assert st.previous_frame_best_estimation is None
    assert any("falling back to cold initialization" in r.getMessage() for r in caplog.records)
    assert all(torch.equal(a[s], b[s]) for a, b in zip(cold, loop) for s in a)


def _batch_config(out_dir) -> dict:
    config = _cli_config(out_dir)
    config["data"].update(n_frames=5, warm_start="batch")
    config["optimizer"]["chain"] = True
    return config


def test_batch_warm_eval_matches_jax_cli_and_resumes(tmp_path):
    """4 eval frames in chunks of 2 with ``warm_start: batch`` (the second
    chunk starts from the first chunk's last solution): the JAX CLI's
    per-frame metrics to 1e-6.  The port runs the first chunk, then the
    CLI resumes from the checkpoint (its warm motion) with the draws
    continued; a rerun adds no line."""
    jcfg, tcfg = _batch_config(tmp_path / "jax"), _batch_config(tmp_path / "port")
    os.makedirs(tmp_path / "jax")
    d = jcfg["data"]
    loader = jdata.collections["synthetic"](config=d)
    loader.set_sequence(d["sequence"])
    viz = visualizer.Visualizer((d["height"], d["width"]), show=False, save=True, save_dir=str(tmp_path / "jax"))
    solv = jsolver.collections[jcfg["solver"]["method"]](
        (d["height"], d["width"]), calibration_parameter=loader.load_calib(), solver_config=jcfg["solver"],
        optimizer_config=jcfg["optimizer"], output_config=jcfg["output"], visualize_module=viz)
    jax_cli.evaluate_dataset_fleet(loader.eval_frame_time_list(), d, loader, solv, 2)

    draws = ChainDraws(2)
    os.makedirs(tmp_path / "port")
    tloader, tsolv = port_cli.build(tcfg, torch.device("cpu"), draws)
    first = port_cli.evaluate_dataset_fleet(tloader.eval_frame_time_list()[:3], tcfg["data"], tloader, tsolv,
                                            str(tmp_path / "port"), 2)
    assert [r["frame"] for r in first] == [0, 1] and first[0]["stats"]["chain"]
    rest = port_cli.run(tcfg, eval_mode=True, device=torch.device("cpu"), candidates_fn=draws)
    assert [r["frame"] for r in rest] == [2, 3]
    assert rest[0]["stats"]["hvp"] == {1: "fd", 2: "fd"} and draws.calls == [2 * 16] * 2
    want, got = _metrics(tmp_path / "jax"), _metrics(tmp_path / "port")
    assert [r["frame"] for r in got] == [r["frame"] for r in want] == [0, 1, 2, 3]
    for g, w in zip(got, want):
        for k in ("EPE", "1PE", "3PE", "AE", "GT_FWL", "PRED_FWL"):
            assert g[k] == pytest.approx(w[k], rel=0, abs=1e-6), (g["frame"], k)
    with np.load(tmp_path / "port" / "eval_state.npz") as state:
        assert int(state["__next_frame"]) == 4 and sorted(state.files) == ["__next_frame", "scale_1", "scale_2"]
    assert port_cli.run(tcfg, eval_mode=True, device=torch.device("cpu")) == []
    assert len(_metrics(tmp_path / "port")) == 4
