"""The port's L-BFGS solvers against the JAX package's, at float64.

* ``newton_cg.LBFGS`` against ``build_lbfgs`` on a quadratic, on
  Rosenbrock and on a plateau that arms the escape probe: the same best
  iterate (to 1e-10), loss and iteration count at every budget, so the
  iterates agree step by step (on Rosenbrock over its first 30
  iterations: the two frameworks' last-bit sums differ, and its valley
  amplifies them ~10x per 5 iterations; both converge to the minimum in
  the same iterations).
* ``fleet.BatchedLBFGS`` against ``build_lbfgs_batched`` on a batch whose
  frames stop at different iterations (to 1e-10); each frame's result is
  its own sequential solve's.
* The host-driven ``optimizer.method: LBFGS`` (``first_order``) against
  ``optax.lbfgs`` step by step on Rosenbrock (to 1e-12), with steps where
  the zoom search interpolates; ``ZoomLinesearch`` against optax's
  ``scale_by_zoom_linesearch`` on line problems that succeed, zoom and fail.
* The solvers: the pyramid (loop and chain), the fleet (loop and chain),
  the single-scale tile solver and the global solver with ``device_solver:
  lbfgs``, and the pyramid with ``optimizer.method: LBFGS``, against the
  JAX package at ``iwe_backend: pallas`` (interpret mode) with JAX's draws
  injected: per-scale motions to 1e-6; the chain equals the loop bit for
  bit; the config validation takes them as the JAX package's does.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from event_based_optical_flow_tpu import solver as jsolver
from event_based_optical_flow_tpu.solver.fleet import build_lbfgs_batched as jax_lbfgs_batched
from event_based_optical_flow_tpu.solver.newton_cg import build_lbfgs as jax_lbfgs
from event_based_optical_flow_tpu_torch import solver as tsolver
from event_based_optical_flow_tpu_torch.solver import first_order
from event_based_optical_flow_tpu_torch.solver.fleet import BatchedLBFGS
from event_based_optical_flow_tpu_torch.solver.newton_cg import LBFGS, build_lbfgs

from test_torch_newton_cg import plateau, rosenbrock
from test_torch_pyramid import OPTIMIZER, SOLVER, H, W, JaxDraws, _record

TOL = 1e-10

A = np.diag([1.0, 4.0, 9.0, 25.0]) + 0.3


def quadratic(x, lib):
    a = lib.asarray(A) if lib is jnp else torch.as_tensor(A)
    return 0.5 * lib.sum(x * (a @ x)) - lib.sum(x)


CASES = {
    "quadratic": (quadratic, np.array([3.0, -2.0, 1.0, 0.5])),
    "rosenbrock": (rosenbrock, np.array([-1.2, 1.0, -0.5, 0.8, 1.3, 0.2])),
    "plateau": (plateau, np.array([-2.0, -1.0])),
}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", sorted(CASES))
def test_lbfgs_matches_jax(name, monkeypatch):
    fn, x0 = CASES[name]
    escapes = []
    orig = LBFGS._escape_probe
    monkeypatch.setattr(LBFGS, "_escape_probe", lambda self, *a: escapes.append(1) or orig(self, *a))
    for maxiter in (1, 2, 3, 5, 8, 30, 120):
        jx, jf, jk = jax.jit(jax_lbfgs(lambda x: fn(x, jnp), maxiter=maxiter, memory=4))(jnp.asarray(x0))
        solve = build_lbfgs(lambda x: fn(x, torch), maxiter=maxiter, memory=4)
        tx, tf, tk = solve(torch.as_tensor(x0))
        assert tk == int(jk), maxiter
        assert solve.syncs >= tk - 1
        if name == "rosenbrock" and maxiter > 30:
            continue  # last-bit sums grow ~10x per 5 iterations here: 1e-10 holds to 30
        assert float(tf) == pytest.approx(float(jf), rel=TOL, abs=1e-14)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=TOL)
    if name == "plateau":
        assert escapes, "the plateau case must exercise the escape probe"
    else:
        assert tk < 120  # converged (gtol or xtol) before the budget
        want = np.linalg.solve(A, np.ones(4)) if name == "quadratic" else np.ones_like(x0)
        np.testing.assert_allclose(tx.numpy(), want, atol=1e-4)


def _batched(lib):
    """Three frames of one batched objective ``[B, 4] -> [B]``: the
    quadratic, a scaled quadratic and Rosenbrock, which stop at different
    iterations."""

    def fn(x):
        q0, q1 = quadratic(x[0], lib), 3.0 * quadratic(x[1], lib)
        stack = jnp.stack if lib is jnp else torch.stack
        return stack([q0, q1, rosenbrock(x[2], lib)])

    return fn


def test_batched_lbfgs_matches_jax():
    x0 = np.array([[3.0, -2.0, 1.0, 0.5], [-1.0, 0.5, 2.0, 1.0], [-1.2, 1.0, -0.5, 0.8]])
    ks = []
    for b in range(3):
        fn = (lambda x: quadratic(x, torch)) if b == 0 else (lambda x: 3.0 * quadratic(x, torch)) if b == 1 \
            else (lambda x: rosenbrock(x, torch))
        ks.append(build_lbfgs(fn, maxiter=80, memory=5)(torch.as_tensor(x0[b]))[2])
    assert len(set(ks)) == 3, ks  # the frames stop at different iterations
    for maxiter in (3, 80):
        jx, jf, jk = jax.jit(jax_lbfgs_batched(_batched(jnp), maxiter=maxiter, memory=5))(jnp.asarray(x0))
        solve = BatchedLBFGS(_batched(torch), maxiter=maxiter, memory=5)
        tx, tf, tk = solve(torch.as_tensor(x0))
        assert tk == int(jk)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=TOL, atol=1e-14)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=TOL)
    assert tk == max(ks)
    for b in range(3):  # lockstep, each frame's own sequential solve
        seq = build_lbfgs(lambda x, b=b: _batched(torch)(torch.stack([x] * 3))[b], maxiter=80, memory=5)
        np.testing.assert_allclose(tx[b].numpy(), seq(torch.as_tensor(x0[b]))[0].numpy(), rtol=0, atol=TOL)


# --- optax's LBFGS ------------------------------------------------------------------


def _optax_steps(fn, x0, lr, n):
    tx = optax.lbfgs(lr)
    x = jnp.asarray(x0)
    state = tx.init(x)
    value_fn = lambda xx: fn(xx, jnp)  # noqa: E731
    update = jax.jit(lambda g, s, x, v: tx.update(g, s, x, value=v, grad=g, value_fn=value_fn))
    xs = []
    for _ in range(n):
        v, g = jax.value_and_grad(value_fn)(x)
        updates, state = update(g, state, x, v)
        x = optax.apply_updates(x, updates)
        xs.append(np.asarray(x))
    return xs


@pytest.mark.parametrize("lr", [1.0, 3.0])
def test_optax_lbfgs_step_by_step(lr, monkeypatch):
    x0 = np.array([-1.2, 1.0, -0.5, 0.8, 1.3, 0.2])
    n = 25
    want = _optax_steps(rosenbrock, x0, lr, n)
    interpolated = []
    for name in ("_cubicmin", "_quadmin"):
        fn = getattr(first_order, name)
        monkeypatch.setattr(first_order, name, lambda *a, _fn=fn: interpolated.append(_fn(*a)) or interpolated[-1])
    trials = []

    def value_and_grad(x):
        trials.append(x)
        xr = x.detach().requires_grad_(True)
        with torch.enable_grad():
            f = rosenbrock(xr, torch)
            (g,) = torch.autograd.grad(f, xr)
        return f.detach(), g

    step = first_order._OptaxLBFGS(torch.as_tensor(x0), lr)
    x = torch.as_tensor(x0)
    for k in range(n):
        loss, g = value_and_grad(x)
        x = step.step(x, loss, g, value_and_grad)
        np.testing.assert_allclose(x.numpy(), want[k], rtol=0, atol=1e-12, err_msg=f"step {k}")
    # the zoom interpolated: some trial's step is a cubic or quadratic minimizer
    assert np.isfinite(interpolated).any()
    n_trials = len(trials) - n  # the loop's own evaluation, then the search's
    assert n_trials > n and step.reads == n + n_trials  # one read per step and per trial


@pytest.mark.parametrize("case", ["accept", "expand", "zoom", "fail"])
def test_zoom_linesearch_matches_optax(case):
    """One search along ``u`` from ``x``: the accepted step of optax's
    zoom search (``max_linesearch_steps`` 20, or 3 where it fails and
    returns its last, unsafe, step) and its trial count."""
    fn = {"accept": lambda x: jnp.sum(x**2), "expand": lambda x: jnp.sum(x**2),
          "zoom": lambda x: jnp.sum(jnp.sin(3.0 * x) + 0.1 * x**2),
          "fail": lambda x: jnp.sum(jnp.sin(9.0 * x) + 0.01 * x**2)}[case]
    x = jnp.asarray([0.7, -0.4])
    g = jax.grad(fn)(x)
    u = {"accept": -0.5 * g, "expand": -0.01 * g, "zoom": -2.0 * g, "fail": 30.0 * g}[case]
    steps = 3 if case == "fail" else 20
    ls = optax.scale_by_zoom_linesearch(max_linesearch_steps=steps, initial_guess_strategy="one")
    updates, state = ls.update(u, ls.init(x), x, value=fn(x), grad=g, value_fn=fn)
    want = float(np.linalg.norm(np.asarray(updates)) / np.linalg.norm(np.asarray(u)))
    tfn = {"accept": lambda t: torch.sum(t**2), "expand": lambda t: torch.sum(t**2),
           "zoom": lambda t: torch.sum(torch.sin(3.0 * t) + 0.1 * t**2),
           "fail": lambda t: torch.sum(torch.sin(9.0 * t) + 0.01 * t**2)}[case]
    xt, ut = torch.as_tensor(np.array(x)), torch.as_tensor(np.array(u))

    def value_and_slope(eta):
        p = (xt + float(eta) * ut).requires_grad_(True)
        f = tfn(p)
        (gt,) = torch.autograd.grad(f, p)
        return float(f.detach()), float(torch.sum(gt * ut))

    search = first_order.ZoomLinesearch(steps)
    got = search.search(value_and_slope, float(fn(x)), float(jnp.sum(u * g)))
    assert got == pytest.approx(want, rel=1e-12, abs=1e-15)
    # accept at 1; expand 1, 2, 4, 8; zoom into (0, 1); fail after 3 trials
    assert search.trials == int(state.info.num_linesearch_steps) == {"accept": 1, "expand": 4, "zoom": 4,
                                                                      "fail": 3}[case]


# --- the solvers ----------------------------------------------------------------------

LBFGS_OPT = dict(OPTIMIZER, device_solver="lbfgs", max_iter=3)


@pytest.fixture(scope="module")
def scene():
    from test_torch_chain import _window
    from event_based_optical_flow_tpu.data.synthetic import SyntheticDataLoader

    loader = SyntheticDataLoader({"height": H, "width": W, "duration": 1.0, "event_rate": 12000,
                                  "n_frames": 4, "pattern": "dots", "n_dots": 60, "flow_max": 12.0})
    loader.set_sequence("pyramid")
    return _window(loader, 1)


def test_pyramid_lbfgs_matches_jax_and_the_chain_the_loop(scene, caplog):
    """The pyramid's loop with ``device_solver: lbfgs`` and JAX's draws:
    per-scale motions to 1e-6 (JAX's per-scale loop); the Newton keys it
    ignores are named once; the chained frame gives the loop's bits and
    stages its evaluations under the "lbfgs" curvature name."""
    from test_torch_chain import _same_solve, _solve

    events, gt_flow, dt = scene
    sj = jsolver.collections[SOLVER["method"]]((H, W), {}, SOLVER, LBFGS_OPT, {}, None)
    got_j, got_t = [], []
    _record(sj, ["_run_newton_device", "_run_fused_scale_device"], got_j, np.asarray)
    bj = sj.optimize(events)
    with caplog.at_level("WARNING"):
        loop = _solve(SOLVER, LBFGS_OPT, events, candidates_fn=JaxDraws())
    assert sum("no effect under device_solver: lbfgs" in r.getMessage() for r in caplog.records
               if r.name.startswith("event_based_optical_flow_tpu_torch")) == 1
    st, bt, solves, stats = loop
    assert len(got_j) == len(solves) == 2
    for a, (b, _, _, _) in zip(got_j, solves):
        np.testing.assert_allclose(b.reshape(-1), a.reshape(-1), rtol=0, atol=1e-6)
    for s in bj:
        np.testing.assert_allclose(bt[s].numpy(), bj[s], rtol=0, atol=1e-6)
    assert stats["hvp"] == {1: "lbfgs", 2: "lbfgs"} and stats["iters"] == {1: 3, 2: 3}
    ej, et = sj.calculate_flow_error(bj, gt_flow, dt, events), st.calculate_flow_error(bt, gt_flow, dt, events)
    for k in ("EPE", "AE", "GT_FWL", "PRED_FWL"):
        assert et[k] == pytest.approx(ej[k], rel=1e-6, abs=1e-9), k
    chained = _solve(SOLVER, dict(LBFGS_OPT, chain=True), events, candidates_fn=JaxDraws())
    assert chained[3]["chain"] and not stats["chain"]
    _same_solve(chained, loop)
    stage = chained[0]._graphs.stages["full"]
    assert {name for _, name in stage._evaluations} == {"lbfgs"}


def test_time_aware_pyramid_lbfgs_matches_jax(scene):
    """The time-aware pyramid (Burgers voxel, K5's plain version) with
    ``device_solver: lbfgs`` and JAX's draws: per-scale motions to 1e-6."""
    from test_torch_pyramid import TIME_AWARE

    events = scene[0]
    slv = dict(SOLVER, **TIME_AWARE)
    sj = jsolver.collections[slv["method"]]((H, W), {}, slv, LBFGS_OPT, {}, None)
    st = tsolver.collections[slv["method"]]((H, W), {}, slv, LBFGS_OPT, {}, device="cpu", candidates_fn=JaxDraws())
    bj, bt = sj.optimize(events), st.optimize(events)
    for s in bj:
        np.testing.assert_allclose(bt[s].numpy(), bj[s], rtol=0, atol=1e-6)
    assert st.last_frame_stats["hvp"] == {1: "lbfgs", 2: "lbfgs"}


@pytest.mark.parametrize("chain", [False, True])
def test_fleet_lbfgs_matches_jax(chain):
    """The fleet with ``device_solver: lbfgs`` (the lockstep L-BFGS) on two
    windows with JAX's draws, its per-scale loop and its chain (one sweep
    per finer scale over both frames): each frame's per-scale motions to
    1e-6."""
    from test_torch_fleet_chain import ChainDraws, FLEET_OPTIMIZER, FLEET_SOLVER, SH, SW, _same_pyramids, _spy
    from event_based_optical_flow_tpu.data.synthetic import SyntheticDataLoader
    from event_based_optical_flow_tpu_torch.solver import fleet as TF

    loader = SyntheticDataLoader({"height": SH, "width": SW, "duration": 1.0, "event_rate": 12000,
                                  "n_frames": 4, "pattern": "dots", "n_dots": 60, "flow_max": 12.0})
    loader.set_sequence("fleet")
    ts = loader.eval_frame_time_list()
    windows = []
    for i in (0, 1):
        ev = loader.load_event(loader.time_to_index(ts[i]), loader.time_to_index(ts[i + 1]))
        ev[:, 2] -= ev[:, 2].min()
        windows.append(ev)
    opt = dict(FLEET_OPTIMIZER, device_solver="lbfgs", max_iter=3, chain=chain)
    sj = jsolver.collections[FLEET_SOLVER["method"]]((SH, SW), {}, FLEET_SOLVER, opt, {}, None)
    st = TF.FleetPyramidalSolver((SH, SW), {}, FLEET_SOLVER, opt, {}, device="cpu",
                                 candidates_fn=ChainDraws(2) if chain else JaxDraws())
    got_j, got_t = [], []
    _spy(sj, got_j, np.asarray)
    _spy(st, got_t, lambda v: v.numpy())
    sj.optimize_batch(windows)
    st.optimize_batch(windows)
    _same_pyramids(got_t, got_j)
    stats = st.last_batch_stats
    assert stats["hvp"] == {1: "lbfgs", 2: "lbfgs"} and stats["chain"] == chain and stats["syncs"] > 0


@pytest.mark.parametrize("which", ["mixed", "global"])
def test_single_scale_and_global_lbfgs_match_jax(scene, which):
    """The single-scale tile solver and the global solver (2d-translation)
    with ``device_solver: lbfgs``: JAX's motion to 1e-6; the global
    solver's chained frame gives its loop's bits."""
    events = scene[0]
    if which == "mixed":
        slv = dict(SOLVER, method="mixed_patch_contrast_maximization",
                   patch={"initialize": "random", "size": [16, 20], "sliding_window": [16, 20],
                          "filter_type": "bilinear"})
    else:
        slv = {"method": "global_contrast_maximization", "motion_model": "2d-translation",
               "patch": {"initialize": "zero"}, "cost": "multi_focal_normalized_gradient_magnitude",
               "outer_padding": 0, "iwe": {"method": "bilinear_vote", "blur_sigma": 1}, "iwe_backend": "pallas",
               "precision": "64", "parameters": ["trans_x", "trans_y"]}
    opt = dict(LBFGS_OPT, max_iter=4)
    sj = jsolver.collections[slv["method"]]((H, W), {}, slv, opt, {}, None)
    st = tsolver.collections[slv["method"]]((H, W), {}, slv, opt, {}, device="cpu")
    bj, bt = sj.optimize(events), st.optimize(events)
    got = bt if isinstance(bt, np.ndarray) else bt.numpy()
    np.testing.assert_allclose(got, np.asarray(bj), rtol=0, atol=1e-6)
    assert st.last_frame_stats["hvp"] == {0: "lbfgs"}
    if which == "global":
        chained = tsolver.collections[slv["method"]]((H, W), {}, slv, dict(opt, chain=True), {}, device="cpu")
        assert np.array_equal(chained.optimize(events), bt) and chained.last_frame_stats["chain"]


def test_pyramid_optax_lbfgs_matches_jax(scene):
    """``optimizer.method: LBFGS`` (optax's L-BFGS, host-driven) on the
    pyramid's loop with JAX's draws: per-scale motions to 1e-6, one host
    read per step and per trial point.  The JAX side runs its matmul
    backend: optax's zoom search differentiates the objective inside
    ``lax.while_loop``, which its Pallas kernels in interpret mode do not
    trace (``program_id`` outside a grid)."""
    events = scene[0]
    opt = dict(OPTIMIZER, method="LBFGS", n_iter=4, lr=1.0)
    sj = jsolver.collections[SOLVER["method"]]((H, W), {}, dict(SOLVER, iwe_backend="matmul"), opt, {}, None)
    st = tsolver.collections[SOLVER["method"]]((H, W), {}, SOLVER, opt, {}, device="cpu",
                                               candidates_fn=JaxDraws())
    bj, bt = sj.optimize(events), st.optimize(events)
    for s in bj:
        np.testing.assert_allclose(bt[s].numpy(), bj[s], rtol=0, atol=1e-6)
    assert st.last_frame_stats["syncs"] > 2 * 4 * 2


@pytest.mark.parametrize("update", [{"optimizer": {"device_solver": "lbfgs", "lbfgs_memory": 4}},
                                    {"optimizer": {"method": "LBFGS"}},
                                    {"optimizer": {"device_solver": "bfgs"}},
                                    {"optimizer": {"lbfgs_memory": 0}}])
def test_schema_takes_lbfgs_as_jax(tmp_path, update):
    """The L-BFGS settings validate as in the JAX package; a bad
    ``device_solver`` and a non-positive ``lbfgs_memory`` raise JAX's
    errors."""
    from event_based_optical_flow_tpu.utils import validate_config as jax_validate
    from event_based_optical_flow_tpu_torch.utils import ConfigError, validate_config
    from test_torch_cli import _config

    cfg = copy.deepcopy(_config(tmp_path))
    for section, values in update.items():
        cfg[section].update(values)
    try:
        want = jax_validate(copy.deepcopy(cfg))
    except Exception as e:  # noqa: BLE001 - JAX's ConfigError
        with pytest.raises(ConfigError, match=str(e).split("'")[1]):
            validate_config(cfg)
        assert str(e) == str(pytest.raises(ConfigError, validate_config, cfg).value)
        return
    assert validate_config(cfg) == want


def test_warm_finest_only_lbfgs_matches_jax(scene):
    """``warm_finest_only`` with the device L-BFGS: a warm frame's one
    finest-scale L-BFGS solve from the warm motion, JAX's pyramid to 1e-6."""
    events = scene[0]
    rng = np.random.default_rng(2)
    warm = {1: rng.uniform(-6, 6, (2, 2, 2)), 2: rng.uniform(-6, 6, (2, 4, 4))}
    opt = dict(LBFGS_OPT, chain=True, warm_finest_only=True)
    sj = jsolver.collections[SOLVER["method"]]((H, W), {}, SOLVER, opt, {}, None)
    st = tsolver.collections[SOLVER["method"]]((H, W), {}, SOLVER, opt, {}, device="cpu", candidates_fn=JaxDraws())
    for s in (sj, st):
        s.set_previous_frame_best_estimation(warm)
    bj, bt = sj.optimize(events), st.optimize(events)
    assert st.last_frame_stats["warm_finest"] and st.last_frame_stats["hvp"] == {2: "lbfgs"}
    for s in bj:
        np.testing.assert_allclose(bt[s].numpy(), bj[s], rtol=0, atol=1e-6)


def test_serving_pushes_with_lbfgs_match_jax():
    """Three pushes (cold, warm, warm) of a ``StreamingFlowEstimator`` with
    ``device_solver: lbfgs``: JAX's flows to 1e-6."""
    from event_based_optical_flow_tpu import streaming as JS
    from event_based_optical_flow_tpu_torch import streaming as TS
    from test_torch_streaming import N_FIX, OPTIMIZER as SERVE_OPT, SOLVER as SERVE_SOLVER, WINDOWS
    from test_torch_streaming import H as SH
    from test_torch_streaming import W as SW

    opt = dict(SERVE_OPT, device_solver="lbfgs", max_iter=3)
    ej = JS.StreamingFlowEstimator((SH, SW), solver_config=SERVE_SOLVER, optimizer_config=opt,
                                   fixed_event_count=N_FIX)
    et = TS.StreamingFlowEstimator((SH, SW), solver_config=SERVE_SOLVER, optimizer_config=opt,
                                   fixed_event_count=N_FIX, device="cpu")
    et._solver.candidates_fn = JaxDraws()
    for ev in WINDOWS:
        np.testing.assert_allclose(et.push(ev), ej.push(ev), rtol=0, atol=1e-6)
    assert set(et._solver.last_frame_stats["hvp"].values()) == {"lbfgs"}
