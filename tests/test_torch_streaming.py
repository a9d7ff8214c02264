"""The port's serving surface (``event_based_optical_flow_tpu_torch/streaming.py``)
against the JAX package's (``event_based_optical_flow_tpu/streaming.py``),
float64 on the CPU, JAX's Pallas kernels in interpret mode
(``iwe_backend: pallas``), the serving defaults (``hvp_mode:
analytic-warm``, random cold init) on a small sensor (32x48, 3 scales,
Newton budgets of 2 iterations: the piecewise objective amplifies last-bit
differences, ``tests/test_torch_pyramid.py``).  JAX's init-sweep draws are
fed to the port (``candidates_fn``), so both solve the same problems.

* ``StreamingFlowEstimator``: three pushes (cold, warm, warm) under
  ``fixed_event_count`` (the first and last window subsampled, the second
  topped up from the tail): flows to 1e-6 px.
* State files cross: the port resumes a JAX state file, and JAX a port
  state file, and the next push equals the other package's to 1e-6.
* Warmup leaves the next push equal to a never-warmed estimator's.
* ``MultiStreamFlowEstimator``: sequential mode against JAX's sequential
  mode; fleet mode, per-stream warm starts, the port's fleet chain against
  the JAX fleet chain's ``per_frame`` warm mode (its draws reproduced by
  ``ChainDraws``, one call per scale).
* The two faults of the JAX package's multi-stream state handling are not
  carried over: a state file with fewer streams pads the streak counters,
  and a push that fails midway rolls back the streaks with the warm list.
* A time-aware push returns the flow voxel; the unported options raise;
  the entry points default to the card.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_based_optical_flow_tpu import streaming as JS
from event_based_optical_flow_tpu_torch import serve as TSERVE
from event_based_optical_flow_tpu_torch import streaming as TS
from event_based_optical_flow_tpu_torch.solver import SolverBase
from event_based_optical_flow_tpu_torch.utils import ConfigError
from test_torch_fleet_chain import ChainDraws
from test_torch_pyramid import JaxDraws

H, W = 32, 48
VEL = np.array([8.0, -6.0])  # px/s
TOL = 1e-6  # px
N_FIX = 1500
# the crop given explicitly: the JAX package's serving defaults keep the
# crop the last estimator fitted to its sensor (test_defaults_are_not_shared)
SOLVER = {"patch": {"scale": 3, "crop_height": H, "crop_width": W}, "iwe_backend": "pallas", "precision": "64"}
OPTIMIZER = {"n_iter": 8, "max_iter": 2, "cg_maxiter": 6, "chain": False,
             "parameters": {"trans_x": {"min": -20, "max": 20}, "trans_y": {"min": -20, "max": 20}}}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _window(t0, n=2200, dur=0.4, seed=0):
    """A dots scene moving at ``VEL`` over ``dur`` seconds from ``t0``."""
    rng = np.random.default_rng(seed)
    dx = rng.uniform(2, H - 2, 48)
    dy = rng.uniform(2, W - 2, 48)
    idx = rng.integers(0, 48, n)
    t = np.sort(rng.uniform(0, dur, n))
    x = dx[idx] + rng.normal(0, 0.2, n) + t * VEL[0]
    y = dy[idx] + rng.normal(0, 0.2, n) + t * VEL[1]
    ok = (x >= 0) & (x < H - 1) & (y >= 0) & (y < W - 1)
    return np.stack([np.round(x), np.round(y), t0 + t, rng.integers(0, 2, n)], 1)[ok]


# the first and last windows hold more than N_FIX events (subsampled), the
# second fewer (topped up from the first's tail)
WINDOWS = [_window(0.0, 2200, seed=10), _window(0.4, 1100, seed=11), _window(0.8, 2200, seed=12)]


def _port(**kw):
    est = TS.StreamingFlowEstimator((H, W), solver_config=SOLVER, optimizer_config=OPTIMIZER,
                                    fixed_event_count=N_FIX, device="cpu", **kw)
    est._solver.candidates_fn = JaxDraws()
    return est


def _jax(**kw):
    return JS.StreamingFlowEstimator((H, W), solver_config=SOLVER, optimizer_config=OPTIMIZER,
                                     fixed_event_count=N_FIX, **kw)


def _run(est, key_of, tmp):
    """Push WINDOWS; the flows, tails and spans after each push, the state
    file written after push 1 and the draw key at that point."""
    out = {"flows": [], "tails": [], "spans": []}
    for i, ev in enumerate(WINDOWS):
        out["flows"].append(est.push(ev))
        out["tails"].append(est._tail.copy())
        out["spans"].append(est.last_span)
        if i == 1:
            out["state"] = str(tmp / "state.npz")
            est.save_state(out["state"])
            out["key"] = np.asarray(key_of(est)).copy()
    out["est"] = est
    return out


@pytest.fixture(scope="module")
def jax_single(tmp_path_factory):
    return _run(_jax(), lambda e: e._solver._key, tmp_path_factory.mktemp("jax"))


@pytest.fixture(scope="module")
def port_single(tmp_path_factory):
    return _run(_port(), lambda e: e._solver.candidates_fn.key, tmp_path_factory.mktemp("port"))


def test_three_pushes_match_jax(jax_single, port_single):
    """Cold, warm, warm under ``fixed_event_count``: the solved windows
    (tails), their spans and the flows."""
    assert [len(ev) > N_FIX for ev in WINDOWS] == [True, False, True]
    for i in range(3):
        np.testing.assert_array_equal(port_single["tails"][i], jax_single["tails"][i])
        assert port_single["spans"][i] == jax_single["spans"][i]
        assert port_single["flows"][i].shape == (2, H, W)
        np.testing.assert_allclose(port_single["flows"][i], jax_single["flows"][i], rtol=0, atol=TOL)
    stats = port_single["est"]._solver.last_frame_stats
    assert stats["hvp"] == {1: "analytic-gn", 2: "analytic-gn"}  # a warm push: analytic on every scale
    assert port_single["est"].n_windows == jax_single["est"].n_windows == 3


def test_state_files_cross_between_packages(jax_single, port_single):
    """The port resumes JAX's state file written after push 1 (warm chain,
    tail, window count), and JAX resumes the port's: the next push of each
    equals the other package's push 2."""
    port = _port()
    port.load_state(jax_single["state"])
    port._solver.candidates_fn.key = jnp.asarray(jax_single["key"])
    assert port.n_windows == 2
    np.testing.assert_array_equal(port._tail, jax_single["tails"][1])
    np.testing.assert_allclose(port.push(WINDOWS[2]), jax_single["flows"][2], rtol=0, atol=TOL)

    jx = _jax()
    jx.load_state(port_single["state"])
    jx._solver._key = jnp.asarray(port_single["key"])
    assert jx.n_windows == 2 and sorted(jx._solver.previous_frame_best_estimation) == [1, 2]
    np.testing.assert_allclose(jx.push(WINDOWS[2]), port_single["flows"][2], rtol=0, atol=TOL)


def test_warmup_leaves_the_next_push_unchanged():
    """Warmup pushes (a warm-chained pair) restore the warm chain, tail,
    counters and both generators: the next push is a never-warmed
    estimator's, bit for bit, with the port's own draws."""
    warmed, fresh = (TS.StreamingFlowEstimator((H, W), solver_config=SOLVER, optimizer_config=OPTIMIZER,
                                               fixed_event_count=N_FIX, device="cpu") for _ in range(2))
    warmed.push(WINDOWS[0])
    fresh.push(WINDOWS[0])
    warm_before = warmed._solver.previous_frame_best_estimation
    assert warmed.warmup(n_windows=2, n_events=N_FIX) > 0
    assert warmed._solver.previous_frame_best_estimation is warm_before
    assert warmed.n_windows == 1 and np.array_equal(warmed._tail, fresh._tail)
    np.testing.assert_array_equal(warmed.push(WINDOWS[1]), fresh.push(WINDOWS[1]))
    cold_warmed = TS.StreamingFlowEstimator((H, W), solver_config=SOLVER, optimizer_config=OPTIMIZER,
                                            device="cpu")
    cold_warmed.warmup(n_windows=1, n_events=N_FIX)
    cold_fresh = TS.StreamingFlowEstimator((H, W), solver_config=SOLVER, optimizer_config=OPTIMIZER,
                                           device="cpu")
    np.testing.assert_array_equal(cold_warmed.push(WINDOWS[0]), cold_fresh.push(WINDOWS[0]))


# --- several streams ----------------------------------------------------------------

STREAMS = [[_window(0.0, 2000, seed=30), _window(0.0, 2000, seed=40)],
           [_window(0.4, 2000, seed=31), _window(0.4, 2000, seed=41)]]


def _multi(module, batching, draws=None, optimizer=OPTIMIZER, **kw):
    kw = {"device": "cpu", **kw} if module is TS else kw
    est = module.MultiStreamFlowEstimator((H, W), 2, solver_config=SOLVER, optimizer_config=optimizer,
                                          fixed_event_count=N_FIX, batching=batching, **kw)
    if draws is not None:
        est._solver.candidates_fn = draws
    return est


@pytest.mark.parametrize("batching", ["sequential", "fleet"])
def test_multistream_matches_jax(batching):
    """Two streams, a cold and a warm push.  Sequential: one solve per
    stream, as JAX's sequential mode.  Fleet: both packages' fleet chains
    (``optimizer.chain`` on: the JAX package's per-frame warm path), one
    init sweep per scale over both streams' patches."""
    opt = OPTIMIZER if batching == "sequential" else dict(OPTIMIZER, chain=True)
    jx = _multi(JS, batching, optimizer=opt)
    port = _multi(TS, batching, JaxDraws() if batching == "sequential" else ChainDraws(2), optimizer=opt)
    for step, windows in enumerate(STREAMS):
        want = jx.push(windows)
        got = port.push(windows)
        assert got.shape == (2, 2, H, W)
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        warm = port._solver.previous_frame_best_estimation
        assert isinstance(warm, list) and len(warm) == 2 and sorted(warm[0]) == [1, 2]
    if batching == "fleet":
        stats = port._solver.last_batch_stats
        assert stats["hvp"] == {1: "analytic-gn", 2: "analytic-gn"} and stats["chain"]
        assert len(port._solver.candidates_fn.calls) == 2  # one sweep call per push
    assert port.n_batches == jx.n_batches == 2


def test_load_state_pads_streaks_of_fewer_streams(tmp_path):
    """A state file written for one stream resumes three: the streak list is
    padded to three (the JAX package truncates without padding, and its
    next sequential push fails on stream 1); warm entries of streams beyond
    ``n_streams`` are dropped."""
    one = TS.MultiStreamFlowEstimator((H, W), 1, solver_config=SOLVER, optimizer_config=OPTIMIZER,
                                      batching="sequential", device="cpu")
    one.push([STREAMS[0][0]])
    one._streaks = [(1, False)]
    one.save_state(tmp_path / "one.npz")
    three = TS.MultiStreamFlowEstimator((H, W), 3, solver_config=SOLVER, optimizer_config=OPTIMIZER,
                                        batching="sequential", device="cpu")
    three.load_state(tmp_path / "one.npz")
    assert three._streaks == [(1, False), (0, False), (0, False)]
    warm = three._solver.previous_frame_best_estimation
    assert sorted(warm[0]) == [1, 2] and warm[1] is None and warm[2] is None
    flows = three.push([STREAMS[1][0], STREAMS[1][1], STREAMS[0][1]])
    assert flows.shape == (3, 2, H, W) and np.isfinite(flows).all()
    three.save_state(tmp_path / "three.npz")
    two = TS.MultiStreamFlowEstimator((H, W), 2, solver_config=SOLVER, optimizer_config=OPTIMIZER,
                                      batching="fleet", device="cpu")
    two.load_state(tmp_path / "three.npz")
    assert len(two._solver.previous_frame_best_estimation) == len(two._streaks) == 2


def test_failed_sequential_push_rolls_back_streaks_and_warm(monkeypatch):
    """A push whose second stream fails leaves every stream's warm motion
    and streak counter as before the push (the JAX package rolls back the
    warm list only, so stream 0's streak would run ahead of its chain); the
    next push advances both streaks (``warm_finest_only``, chained)."""
    est = _multi(TS, "sequential", optimizer=dict(OPTIMIZER, chain=True, warm_finest_only=True))
    est.push(STREAMS[0])
    assert est._streaks == [(0, False), (0, False)]
    est._streaks = [(1, False), (1, False)]
    warm = est._solver.previous_frame_best_estimation
    calls = []
    solve = est._solver.optimize

    def failing(ev):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("solve failed")
        return solve(ev)

    monkeypatch.setattr(est._solver, "optimize", failing)
    with pytest.raises(RuntimeError, match="solve failed"):
        est.push(STREAMS[1])
    assert est._streaks == [(1, False), (1, False)]
    assert est._solver.previous_frame_best_estimation is warm
    monkeypatch.setattr(est._solver, "optimize", solve)
    est.push(STREAMS[1])
    assert est._streaks == [(2, True), (2, True)]


def test_time_aware_push_returns_the_voxel():
    ta = dict(SOLVER, time_aware=True, time_bin=2, flow_interpolation="burgers", t0_flow_location="middle")
    est = TS.StreamingFlowEstimator((H, W), solver_config=ta, optimizer_config=OPTIMIZER, device="cpu")
    flow = est.push(WINDOWS[0])
    assert flow.shape == (2, 2, H, W) and np.isfinite(flow).all()
    ms = TS.MultiStreamFlowEstimator((H, W), 2, solver_config=ta, optimizer_config=OPTIMIZER, device="cpu")
    assert ms.batching == "sequential"  # the auto rule: time-aware -> sequential, dense -> fleet
    assert _multi(TS, "auto").batching == "fleet"
    assert ms.push(STREAMS[0]).shape == (2, 2, 2, H, W)


def test_defaults_are_not_shared():
    """An estimator's crop, fitted to its sensor, stays its own: a later
    estimator of a larger sensor gets its own fit (the JAX package writes
    the fit into its module's defaults, so there the second estimator keeps
    the first one's 16 x 32 crop)."""
    small = TS.StreamingFlowEstimator((16, 32), device="cpu")
    large = TS.StreamingFlowEstimator((H, W), device="cpu")
    assert small._solver.cropped_image_shape == (16, 32)
    assert large._solver.cropped_image_shape == (H, W)  # the default 5 scales: multiples of 16
    assert TS._DEFAULT_SOLVER["patch"]["crop_height"] == 256 and TS._DEFAULT_SOLVER["patch"]["crop_width"] == 336


def test_unported_options_raise():
    """The serving surface takes the mesh (``parallel_config``, and
    ``solver.parallel``: the CPU's mesh repeats the CPU device), the device
    L-BFGS and outer padding (both modes)."""
    est = TS.StreamingFlowEstimator((H, W), solver_config=SOLVER, optimizer_config={"device_solver": "lbfgs"},
                                    device="cpu")
    assert est._solver.opt_config["device_solver"] == "lbfgs"
    multi = TS.MultiStreamFlowEstimator((H, W), 2, solver_config=SOLVER, optimizer_config=OPTIMIZER,
                                        parallel_config={"data": 2}, device="cpu")
    assert multi.batching == "fleet" and multi._solver.n_data_shards == 2
    single = TS.StreamingFlowEstimator((H, W), solver_config=dict(SOLVER, parallel={"data": 2}), device="cpu")
    assert single._solver.mesh.shape == {"data": 2, "event": 1}
    assert TS.StreamingFlowEstimator((H, W), solver_config=dict(SOLVER, outer_padding=2),
                                     device="cpu")._solver.padding == 2
    assert TS.MultiStreamFlowEstimator((H, W), 2, solver_config=dict(SOLVER, outer_padding=2),
                                       optimizer_config=OPTIMIZER, batching="fleet", device="cpu")._solver.padding == 2


def test_entry_points_default_to_the_card(monkeypatch):
    """Solvers, estimators and the server run on ``cuda`` unless asked for
    the CPU (every other test passes ``device="cpu"``)."""
    for fn in (SolverBase.__init__, TS.StreamingFlowEstimator.__init__, TS.MultiStreamFlowEstimator.__init__,
               TSERVE.FlowServer.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    seen = {}

    class Recorder:
        def __init__(self, image_shape, host, port, **kw):
            seen.update(kw, image_shape=image_shape)

        def serve_forever(self):
            pass

    monkeypatch.setattr(TSERVE, "FlowServer", Recorder)
    TSERVE.main(["--height", "26", "--width", "34"])
    assert seen["device"] == "cuda" and seen["image_shape"] == (26, 34)
    TSERVE.main(["--height", "26", "--width", "34", "--device", "cpu"])
    assert seen["device"] == "cpu"
