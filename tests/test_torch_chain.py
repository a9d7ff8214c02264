"""The port's chained pyramid (``optimizer.chain``, on by default:
``PyramidalPatchContrastMaximization._optimize_chain``, the Newton
evaluations staged through ``solver/graphs.py``) against the port's own
per-scale loop (``chain: false``) and against the JAX package's whole-frame
chain (``_optimize_chain``, ``optimize_with_metrics``; ``iwe_backend:
pallas`` in interpret mode, ``precision: "64"``), on the small dots scene of
tests/test_torch_pyramid.py.

* Chain against loop, bit for bit: per-scale motions, losses, iterations,
  HVP models, host syncs and kernel launches, on the MVSEC FD solver, the
  DSEC config's solver block (analytic HVP, ``fd_polish``, the coarse
  subsample) and the time-aware Burgers solver.  On the CPU the staging
  runs the closures eagerly, as the CUDA graphs replay them on the card.
* Chain against JAX's chain with JAX's draws injected, to 1e-6: per-scale
  motions, the returned pyramid and the metrics of ``optimize_with_metrics``.
* Frames: a second frame with the same event count reuses the staged
  buffers and evaluations and gives the loop's result; another count
  stages anew.
"""

import copy

import numpy as np
import pytest
import torch

from event_based_optical_flow_tpu import solver as jsolver
from event_based_optical_flow_tpu.data.synthetic import SyntheticDataLoader
from event_based_optical_flow_tpu_torch import solver as tsolver
from event_based_optical_flow_tpu_torch.solver.objective import FrameEvents

from test_torch_pyramid import JaxDraws, OPTIMIZER, SOLVER, TIME_AWARE, H, W, _record

CHAIN = dict(OPTIMIZER, chain=True)
LOOP = dict(OPTIMIZER, chain=False)
# the DSEC config's solver block: analytic HVP on the finest scale, two
# central-FD polish iterations, the coarse scale on a stride-4 subsample
DSEC = {"hvp_mode": "analytic", "fd_polish": 2, "cg_maxiter": 8, "coarse_event_fraction": 0.25}
CONFIGS = {
    "mvsec_fd": (SOLVER, {}),
    "dsec_analytic": (SOLVER, DSEC),
    "time_aware_fd": (dict(SOLVER, **TIME_AWARE), {}),
}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def loader():
    loader = SyntheticDataLoader({"height": H, "width": W, "duration": 1.0, "event_rate": 12000,
                                  "n_frames": 4, "pattern": "dots", "n_dots": 60, "flow_max": 12.0})
    loader.set_sequence("pyramid")
    return loader


def _window(loader, k):
    """Eval window k: (events, GT flow, window seconds)."""
    ts = loader.eval_frame_time_list()
    i1, i2 = loader.time_to_index(ts[k]), loader.time_to_index(ts[k + 1])
    events = loader.load_event(i1, i2)
    events[:, 2] -= events[:, 2].min()
    return events, loader.load_optical_flow(ts[k], ts[k + 1]), ts[k + 1] - ts[k]


@pytest.fixture(scope="module")
def scene(loader):
    return _window(loader, 1)


def _port(slv, opt, **kw):
    return tsolver.collections[slv["method"]]((H, W), {}, slv, opt, {}, device="cpu", **kw)


def _solve(slv, opt, events, **kw):
    """(solver, returned pyramid, every Newton solve's (best_x, best_f,
    n_iter, hvp), frame stats) of one port solve."""
    st = _port(slv, opt, **kw)
    solves = []
    _record(st, ["_run_newton"], solves, lambda out: (out[0].numpy().copy(), float(out[1]), out[2], out[3]))
    best = st.optimize(events)
    return st, best, solves, st.last_frame_stats


def _same_solve(a, b):
    (_, best_a, solves_a, stats_a), (_, best_b, solves_b, stats_b) = a, b
    assert sorted(best_a) == sorted(best_b)
    for s in best_a:
        assert torch.equal(best_a[s], best_b[s]), s
    assert len(solves_a) == len(solves_b)
    for (xa, fa, ka, ha), (xb, fb, kb, hb) in zip(solves_a, solves_b):
        np.testing.assert_array_equal(xa, xb)
        assert (fa, ka, ha) == (fb, kb, hb)
    for key in ("iters", "loss", "hvp", "events", "launches", "syncs"):
        assert stats_a[key] == stats_b[key], key


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_chain_equals_loop_bit_for_bit(scene, config, caplog):
    """Per-scale motions, losses, iterations, HVP models, syncs and kernel
    launches of the chained frame are the loop's, bit for bit; the chained
    frame logs the JAX chain's per-scale line."""
    events, _, _ = scene
    slv, extra = CONFIGS[config]
    with caplog.at_level("INFO"):
        chained = _solve(slv, dict(CHAIN, **extra), events)
    loop = _solve(slv, dict(LOOP, **extra), events)
    assert chained[3]["chain"] and not loop[3]["chain"]
    _same_solve(chained, loop)
    lines = [r.getMessage() for r in caplog.records if "done (chained)" in r.getMessage()]
    assert len(lines) == 2 and lines[0].startswith("Scale 1 done (chained): ")
    if config == "dsec_analytic":
        assert chained[3]["hvp"] == {1: "fd", 2: "analytic-gn"}
        assert chained[3]["events"] == {1: len(events[::4]), 2: len(events)}
        assert set(chained[0]._graphs.stages) == {"full", "coarse"}


def test_chain_is_the_default_and_needs_two_scales(scene):
    """``optimizer.chain`` defaults to on; one scale, ``chain: false`` or
    another optimizer run the loop (the JAX package's ``_chain_ready``)."""
    opt = {k: v for k, v in OPTIMIZER.items() if k != "chain"}
    assert _port(SOLVER, opt)._chain_ready()
    assert not _port(SOLVER, LOOP)._chain_ready()
    one_scale = copy.deepcopy(SOLVER)
    one_scale["patch"]["scale"] = 2
    assert not _port(one_scale, CHAIN)._chain_ready()
    assert not _port(SOLVER, dict(CHAIN, method="BFGS"))._chain_ready()


def _jax_solver(slv, opt):
    return jsolver.collections[slv["method"]]((H, W), {}, slv, opt, {}, None)


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_chain_matches_jax_chain(scene, config):
    """With JAX's init-sweep draws injected, the port's chained frame
    (``optimize_with_metrics``) gives JAX's chained per-scale motions,
    pyramid and metrics to 1e-6.  JAX runs with ``chain: true``: one
    dispatch with the metrics for the MVSEC and time-aware blocks; for the
    DSEC block the
    split coarse chain and the finest solver through ``optimize``, then
    ``calculate_flow_error``, since JAX's ``optimize_with_metrics`` fails
    there (its finest solver's metrics body is built while the coarsest
    scale's tile geometry is current: ``pyramid.py:396,444-448``)."""
    events, gt_flow, dt = scene
    slv, extra = CONFIGS[config]
    opt = dict(CHAIN, **extra)
    sj = _jax_solver(slv, opt)
    st = _port(slv, opt, candidates_fn=JaxDraws())
    assert sj._chain_ready() and st._chain_ready()
    got_j, got_t = [], []
    spy_j = sj.update_coarse_from_fine
    sj.update_coarse_from_fine = lambda m: got_j.append({s: np.asarray(v) for s, v in m.items()}) or spy_j(m)
    spy_t = st.update_coarse_from_fine
    st.update_coarse_from_fine = lambda m: got_t.append({s: v.numpy().copy() for s, v in m.items()}) or spy_t(m)
    if config == "dsec_analytic":
        bj = sj.optimize(events)
        ej = sj.calculate_flow_error(bj, gt_flow, dt, events)
    else:
        bj, ej = sj.optimize_with_metrics(events, gt_flow, dt, events)
    bt, et = st.optimize_with_metrics(events, gt_flow, dt, events)
    assert st.last_frame_stats["chain"]
    assert len(got_j) == len(got_t) == 1 and sorted(got_t[0]) == sorted(got_j[0]) == [1, 2]
    for s in got_j[0]:
        np.testing.assert_allclose(got_t[0][s], got_j[0][s], atol=1e-6)
        np.testing.assert_allclose(bt[s].numpy(), bj[s], atol=1e-6)
    for k in ("EPE", "AE", "GT_FWL", "PRED_FWL"):
        assert et[k] == pytest.approx(ej[k], rel=1e-6, abs=1e-9), k


def test_frames_reuse_staged_buffers_and_restage_on_another_count(loader):
    """A second frame with the first's event count is copied into the
    staged buffers and replays the same evaluations; a frame with another
    count stages anew.  Every frame gives the loop's bits (the loop solver
    takes the same frames in the same order, so both draw alike)."""
    first, _, _ = _window(loader, 1)
    second, _, _ = _window(loader, 2)
    n = min(len(first), len(second))
    frames = [first[-n:], second[-n:], second[-(n - 100):]]
    chained, loop = _port(SOLVER, CHAIN), _port(SOLVER, LOOP)
    stages, evaluations = [], []
    for k, events in enumerate(frames):
        _same_solve((chained, chained.optimize(events), [], chained.last_frame_stats),
                    (loop, loop.optimize(events), [], loop.last_frame_stats))
        stage = chained._graphs.stages["full"]
        stages.append((stage, stage.frame.x))
        evaluations.append(dict(stage._evaluations))
        want = FrameEvents.from_numpy(events, "cpu", torch.float64)
        assert torch.equal(stage.frame.x, want.x) and torch.equal(stage.frame.dtf, want.dtf)
    assert stages[1][0] is stages[0][0] and stages[1][1] is stages[0][1]  # copied in place
    assert evaluations[1] == evaluations[0] and len(evaluations[0]) == 2  # one per scale
    assert stages[2][0] is not stages[0][0] and stages[2][0].key[0] == n - 100
    with pytest.raises(ValueError, match="copy_ takes a frame of"):
        stages[0][0].frame.copy_(stages[2][0].frame)
