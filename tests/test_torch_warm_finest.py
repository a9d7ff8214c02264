"""``optimizer.warm_finest_only``, the warm tracking fast path, against the
JAX package (``solver/pyramid.py``: ``_warm_has_finest``,
``_warm_finest_active``, ``_optimize_warm_finest``; ``streaming.py``: the
streak around ``warmup`` and the per-stream streaks of the sequential
multi-stream mode), float64, JAX's Pallas kernels in interpret mode, Newton
budgets of 2 iterations, JAX's draws injected (``JaxDraws``).

* The decision logic step for step: cold solves reset the streak,
  ``warm_full_every: K`` re-anchors every K-th warm solve, K = 1 disables
  the fast path, the flag off never takes it; the shared warmth predicate.
* The sequential chain's finest-only solve (``optimize_with_metrics``)
  against JAX's: every scale to 1e-6, the coarse entries the finest's
  ``pyramid_reduce``, the metrics; the loop (``chain: false``) warns once
  and runs every scale.
* Serving: ``StreamingFlowEstimator.warmup`` restores the streak, and the
  pushes around it equal JAX's; the sequential ``MultiStreamFlowEstimator``
  staggers its streams' streaks (``k % K``) so one stream re-anchors while
  the others take the fast path, with JAX's flows.
* The configs validate with the fast path on and ``data.warm_start: batch``,
  and bad values are refused, as in the JAX package.
"""

import copy
import pathlib

import numpy as np
import pytest
import torch
import yaml

from event_based_optical_flow_tpu import solver as jsolver
from event_based_optical_flow_tpu import streaming as JS
from event_based_optical_flow_tpu.ops.interp import pyramid_reduce as jax_pyramid_reduce
from event_based_optical_flow_tpu_torch import solver as tsolver
from event_based_optical_flow_tpu_torch import streaming as TS
from event_based_optical_flow_tpu_torch.ops.interp import pyramid_reduce
from test_torch_pyramid import OPTIMIZER, SOLVER, H, W, JaxDraws
from test_torch_streaming import N_FIX, _window
from test_torch_streaming import H as SH
from test_torch_streaming import OPTIMIZER as SERVE_OPTIMIZER
from test_torch_streaming import SOLVER as SERVE_SOLVER
from test_torch_streaming import W as SW

REPO = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-6
WFO = dict(OPTIMIZER, chain=True, warm_finest_only=True)


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _pair(opt):
    sj = jsolver.collections[SOLVER["method"]]((H, W), {}, SOLVER, opt, {}, None)
    st = tsolver.collections[SOLVER["method"]]((H, W), {}, SOLVER, opt, {}, device="cpu", candidates_fn=JaxDraws())
    return sj, st


def test_warm_finest_decision_logic_matches_jax():
    """The same sequence of warm and cold solves, with ``warm_full_every``
    changed between them, gives JAX's decisions, streaks and ``_wfo_last``
    at every step; the warmth predicate agrees on every warm state."""
    sj, st = _pair(WFO)
    steps = [(None, False), (None, True), (None, True), (None, False),
             (2, True), (2, True), (2, True), (1, True), (0, True), (0, False)]
    decisions = []
    for every, warm in steps:
        for s in (sj, st):
            if every is not None:
                s.opt_config["warm_full_every"] = every
        got = st._warm_finest_active(warm)
        assert got is sj._warm_finest_active(warm)
        assert (st._warm_streak, st._wfo_last) == (sj._warm_streak, sj._wfo_last)
        decisions.append(got)
    assert decisions == [False, True, True, False, True, False, True, False, True, False]
    off_j, off_t = _pair(OPTIMIZER)
    assert off_t._warm_finest_active(True) is off_j._warm_finest_active(True) is False
    assert off_t._warm_streak == 0
    fin = {1: 0, 2: 0}
    for warm in (None, fin, {1: 0}, [fin, fin], [fin, None], [], [{1: 0}], 3):
        assert st._warm_has_finest(warm, 2) is sj._warm_has_finest(warm, 2), warm


@pytest.fixture(scope="module")
def scene():
    from test_torch_chain import _window as chain_window
    from test_torch_chain import SyntheticDataLoader

    loader = SyntheticDataLoader({"height": H, "width": W, "duration": 1.0, "event_rate": 12000,
                                  "n_frames": 4, "pattern": "dots", "n_dots": 60, "flow_max": 12.0})
    loader.set_sequence("pyramid")
    return chain_window(loader, 1)


def test_sequential_warm_finest_solve_matches_jax(scene, caplog):
    """A warm frame on the chain takes one finest-scale solve from the warm
    finest motion (``optimize_with_metrics`` too): JAX's pyramid and
    metrics to 1e-6, the coarse entry the finest's ``pyramid_reduce``, no
    init sweep, the finest scale's stats only."""
    events, gt_flow, dt = scene
    rng = np.random.default_rng(2)
    warm = {1: rng.uniform(-6, 6, (2, 2, 2)), 2: rng.uniform(-6, 6, (2, 4, 4))}
    sj, st = _pair(WFO)
    for s in (sj, st):
        s.set_previous_frame_best_estimation(warm)
    bj, ej = sj.optimize_with_metrics(events, gt_flow, dt, events)
    key = np.asarray(st.candidates_fn.key).copy()
    with caplog.at_level("INFO"):
        bt, et = st.optimize_with_metrics(events, gt_flow, dt, events)
    assert sj._wfo_last is st._wfo_last is True
    assert sorted(bt) == sorted(bj) == [1, 2]
    for s in bj:
        np.testing.assert_allclose(bt[s].numpy(), bj[s], rtol=0, atol=TOL)
    assert torch.equal(bt[1], pyramid_reduce(bt[2]))
    np.testing.assert_allclose(bj[1], jax_pyramid_reduce(bj[2]), atol=1e-12)
    for k in ("EPE", "AE", "GT_FWL", "PRED_FWL"):
        assert et[k] == pytest.approx(ej[k], rel=1e-6, abs=1e-9), k
    assert np.array_equal(np.asarray(st.candidates_fn.key), key)  # no sweep drew
    stats = st.last_frame_stats
    assert stats["warm_finest"] and stats["chain"] and list(stats["iters"]) == [2] and stats["hvp"] == {2: "fd"}
    assert any(r.getMessage().startswith("Warm finest-only solve: ") for r in caplog.records)


def test_loop_warns_and_runs_every_scale(scene, caplog):
    """With ``chain: false`` the fast path is not taken: one warning, every
    scale solved, the streak untouched."""
    events, _, _ = scene
    st = tsolver.collections[SOLVER["method"]]((H, W), {}, SOLVER, dict(WFO, chain=False), {}, device="cpu")
    warm = st.optimize(events)
    with caplog.at_level("WARNING"):
        for _ in range(2):
            st.set_previous_frame_best_estimation(warm)
            warm = st.optimize(events)
            assert sorted(st.last_frame_stats["iters"]) == [1, 2] and not st.last_frame_stats["chain"]
    assert sum("warm_finest_only requires the device chain" in r.getMessage() for r in caplog.records) == 1
    assert (st._warm_streak, st._wfo_last) == (0, False)


# --- serving -------------------------------------------------------------------

SERVE_WFO = dict(SERVE_OPTIMIZER, chain=True, warm_finest_only=True)


def test_warmup_restores_the_streak_as_jax():
    """Cold push, warm push (the fast path, streak 1), two warmup pushes,
    another warm push: JAX's flows at every push, and warmup leaves the
    streak and the fast-path flag as they were (the next push is streak 2
    on both)."""
    opt = dict(SERVE_WFO, warm_full_every=4)
    jx = JS.StreamingFlowEstimator((SH, SW), solver_config=SERVE_SOLVER, optimizer_config=opt,
                                   fixed_event_count=N_FIX)
    port = TS.StreamingFlowEstimator((SH, SW), solver_config=SERVE_SOLVER, optimizer_config=opt,
                                     fixed_event_count=N_FIX, device="cpu")
    port._solver.candidates_fn = JaxDraws()
    windows = [_window(0.4 * i, 2200, seed=70 + i) for i in range(3)]
    for i in range(2):
        np.testing.assert_allclose(port.push(windows[i]), jx.push(windows[i]), rtol=0, atol=TOL)
    snap = (port._solver._warm_streak, port._solver._wfo_last)
    assert snap == (jx._solver._warm_streak, jx._solver._wfo_last) == (1, True)
    jx.warmup(n_windows=2, n_events=N_FIX)
    port.warmup(n_windows=2, n_events=N_FIX)
    assert (port._solver._warm_streak, port._solver._wfo_last) == snap
    assert (jx._solver._warm_streak, jx._solver._wfo_last) == snap
    np.testing.assert_allclose(port.push(windows[2]), jx.push(windows[2]), rtol=0, atol=TOL)
    assert port._solver._warm_streak == jx._solver._warm_streak == 2 and port._solver._wfo_last


def test_multistream_sequential_staggered_reanchor_as_jax():
    """Three streams, ``warm_full_every: 2``: initial streaks [0, 1, 0]; the
    cold push re-seeds them; on the warm push stream 1 re-anchors (its
    full pyramid) while streams 0 and 2 take the fast path: JAX's streaks
    and flows at both pushes."""
    opt = dict(SERVE_WFO, warm_full_every=2)
    kw = dict(solver_config=SERVE_SOLVER, optimizer_config=opt, fixed_event_count=N_FIX, batching="sequential")
    jx = JS.MultiStreamFlowEstimator((SH, SW), 3, **kw)
    port = TS.MultiStreamFlowEstimator((SH, SW), 3, device="cpu", **kw)
    port._solver.candidates_fn = JaxDraws()
    assert port._streaks == jx._streaks == [(0, False), (1, False), (0, False)]
    for step, want_streaks in enumerate(([(0, False), (1, False), (0, False)],
                                         [(1, True), (2, False), (1, True)])):
        windows = [_window(0.4 * step, 2000, seed=80 + 10 * step + k) for k in range(3)]
        np.testing.assert_allclose(port.push(windows), jx.push(windows), rtol=0, atol=TOL)
        assert port._streaks == jx._streaks == want_streaks
    fleet = TS.MultiStreamFlowEstimator((SH, SW), 3, device="cpu", **dict(kw, batching="fleet"))
    assert fleet._streaks == [(0, False)] * 3  # one lockstep solve: one streak, on the solver


PORTED = ("synthetic_fleet.yaml", "synthetic_mvsec_geometry.yaml", "synthetic_quickstart.yaml")


@pytest.mark.parametrize("name", PORTED)
def test_fast_path_and_batch_warm_configs_validate(name):
    """With ``warm_finest_only: true``, ``warm_full_every: 8`` and
    ``data.warm_start: batch`` every ported config validates with the JAX
    package's warnings; a non-bool flag and a negative cadence are refused
    by both; the mesh (``solver.parallel``) and ``device_solver: lbfgs``
    validate as in the JAX package."""
    from event_based_optical_flow_tpu.utils import validate_config as jax_validate
    from event_based_optical_flow_tpu_torch.utils import ConfigError, validate_config

    config = yaml.safe_load((REPO / "configs" / name).read_text())
    config["optimizer"].update(warm_finest_only=True, warm_full_every=8)
    config["data"]["warm_start"] = "batch"
    assert validate_config(copy.deepcopy(config)) == jax_validate(copy.deepcopy(config))
    for update in ({"warm_finest_only": 3}, {"warm_full_every": -1}):
        bad = {**config, "optimizer": {**config["optimizer"], **update}}
        for validate in (validate_config, jax_validate):
            with pytest.raises(ConfigError if validate is validate_config else Exception, match=list(update)[0]):
                validate(copy.deepcopy(bad))
    lbfgs = {**config, "optimizer": {**config["optimizer"], "device_solver": "lbfgs"}}
    assert validate_config(copy.deepcopy(lbfgs)) == jax_validate(copy.deepcopy(lbfgs))
    meshed = {**config, "solver": {**config["solver"], "parallel": {"data": 2}}}
    assert validate_config(copy.deepcopy(meshed)) == jax_validate(copy.deepcopy(meshed))
