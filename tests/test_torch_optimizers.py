"""The port's host-driven optimizers against the JAX package's, at float64
(``iwe_backend: pallas`` in interpret mode, the TPU route, unless a case
says otherwise):

* the 14 scipy methods through ``scipy_bridge.minimize`` on a single-scale
  tile problem (``_run_scipy_on_spec`` of the mixed solver, 8 tile
  parameters, 2 iterations): the same result, evaluation count and
  per-evaluation history to 1e-6.  ``dogleg`` and ``trust-exact`` take a
  Hessian, which the JAX package builds with ``jax.hessian`` of its exact
  backends only (its fused route cannot differentiate the kernel twice):
  they run against ``iwe_backend: matmul``, the port's Hessian from the
  analytic full HVP (held to ``jax.hessian`` to 1e-12);
* the pyramid with the device Newton-CG, ``optimizer.device: false``
  (scipy's Newton-CG) and BFGS, JAX's init-sweep draws injected: the
  per-scale motions and the history register (device Newton: one best loss
  per scale; scipy: every evaluation, with the hybrid's components) to
  1e-6;
* each first-order rule's 10 steps against optax on the same gradients to
  1e-10, and the loop against ``optax_loop.run_first_order`` to 1e-6;
* the sampling ("optuna") optimizer: the same candidates, best and
  per-round history to 1e-6, and the same numpy generator state after;
* the config schema: the 28 method names (optax's ``LBFGS`` among them)
  and ``optimizer.device: false`` validate as in the JAX package, ``lr``
  is a known key.
"""

import copy

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from event_based_optical_flow_tpu import solver as jsolver
from event_based_optical_flow_tpu.data.synthetic import SyntheticDataLoader
from event_based_optical_flow_tpu.solver import base as jbase
from event_based_optical_flow_tpu.solver.optax_loop import run_first_order as jax_run_first_order
from event_based_optical_flow_tpu_torch import solver as tsolver
from event_based_optical_flow_tpu_torch.solver import first_order
from event_based_optical_flow_tpu_torch.solver.objective import FrameEvents, build_orig_iwe, build_value_grad_hvp
from test_torch_pyramid import OPTIMIZER, SOLVER, JaxDraws, H, W

TOL = 1e-6
MIXED = dict(SOLVER, method="mixed_patch_contrast_maximization",
             patch={"initialize": "random", "size": [16, 20], "sliding_window": [16, 20], "filter_type": "bilinear"})
SCIPY = ["Nelder-Mead", "Powell", "CG", "BFGS", "Newton-CG", "L-BFGS-B", "TNC", "COBYLA", "SLSQP", "trust-constr",
         "dogleg", "trust-ncg", "trust-exact", "trust-krylov"]
NEEDS_HESSIAN = ("dogleg", "trust-exact")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def events():
    """One eval window of the pyramid tests' dots scene."""
    loader = SyntheticDataLoader({"height": H, "width": W, "duration": 1.0, "event_rate": 12000,
                                  "n_frames": 4, "pattern": "dots", "n_dots": 60, "flow_max": 12.0})
    loader.set_sequence("pyramid")
    ts = loader.eval_frame_time_list()
    ev = loader.load_event(loader.time_to_index(ts[1]), loader.time_to_index(ts[2]))
    ev[:, 2] -= ev[:, 2].min()
    return ev


class HistoryRecorder:
    """A visualizer stand-in that keeps every history the solver plots."""

    def __init__(self):
        self.histories = []

    def visualize_scipy_history(self, history, weight=None):
        self.histories.append(copy.deepcopy({k: list(v) for k, v in history.items()}))


def _assert_history(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert len(got[k]) == len(want[k]), k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TOL, err_msg=k)


@pytest.fixture(scope="module")
def mixed_problem(events):
    """Per iwe backend: (JAX solver, its spec and padded events, port solver,
    its spec, frame and orig IWE) of the mixed solver's one-scale problem;
    the solvers are reused by every method (the optimizer is read per
    call)."""
    out = {}
    for backend in ("pallas", "matmul"):
        slv = dict(MIXED, iwe_backend=backend)
        sj = jsolver.collections[slv["method"]]((H, W), {}, slv, dict(OPTIMIZER), {}, None)
        st = tsolver.collections[slv["method"]]((H, W), {}, slv, dict(OPTIMIZER), {}, device="cpu")
        tspec = st._current_spec()
        frame = FrameEvents.from_numpy(events, "cpu", torch.float64)
        out[backend] = (sj, sj._current_spec(), sj.prepare_events(events), st, tspec, frame,
                        build_orig_iwe(tspec)(frame))
    return out


@pytest.mark.parametrize("method", SCIPY)
def test_scipy_methods_match_jax(mixed_problem, method):
    sj, jspec, (ev, w), st, tspec, frame, orig = mixed_problem["matmul" if method in NEEDS_HESSIAN else "pallas"]
    x0 = np.random.default_rng(3).uniform(-15.0, 15.0, 8)
    options = {"gtol": 1e-7, "disp": False, "maxiter": 2}
    for s in (sj, st):
        s.opt_method = method
        s.opt_config = dict(OPTIMIZER, method=method, max_iter=2)
        s.cost_func.clear_history()
    rj = sj._run_scipy_on_spec(jspec, ev, w, x0, options)
    rt = st._run_scipy_on_spec(tspec, frame, orig, x0, options)
    assert rt.nfev == rj.nfev > 0
    assert rt.fun == pytest.approx(rj.fun, rel=0, abs=TOL)
    np.testing.assert_allclose(rt.x, rj.x, rtol=0, atol=TOL)
    history = st.cost_func.get_history()
    assert len(history["loss"]) == rt.nfev
    assert len(history["multi_focal_normalized_gradient_magnitude"]) == rt.nfev
    _assert_history(history, sj.cost_func.get_history())


def test_hessian_is_jax_hessian_of_the_exact_backend(mixed_problem):
    """The port's Hessian (analytic full HVP, K3 / K4, per column) against
    ``jax.hessian`` of the JAX package's exact matmul objective."""
    sj, jspec, (ev, w), st, tspec, frame, orig = mixed_problem["matmul"]
    hess = sj._get_funs(jspec)[2]
    thess = build_value_grad_hvp(tspec)[2]
    for x in np.random.default_rng(4).uniform(-15.0, 15.0, (2, 8)):
        want = np.asarray(hess(jnp.asarray(x), ev, w))
        got = thess(torch.as_tensor(x), orig, frame).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("method,device", [("Newton-CG", True), ("Newton-CG", False), ("BFGS", True)])
def test_pyramid_optimizers_match_jax(events, method, device):
    """The pyramid's loop with JAX's init-sweep draws: per-scale motions and
    the history register's plot of the frame to 1e-6 (device Newton: one
    best loss per scale)."""
    opt = dict(OPTIMIZER, method=method, device=device)
    jviz, tviz = HistoryRecorder(), HistoryRecorder()
    sj = jsolver.collections[SOLVER["method"]]((H, W), {}, SOLVER, opt, {}, jviz)
    st = tsolver.collections[SOLVER["method"]]((H, W), {}, SOLVER, opt, {}, visualize_module=tviz, device="cpu",
                                               candidates_fn=JaxDraws())
    bj, bt = sj.optimize(events), st.optimize(events)
    assert sorted(bj) == sorted(bt) == [1, 2]
    for s in bj:
        np.testing.assert_allclose(bt[s].numpy(), bj[s], rtol=0, atol=TOL)
    assert len(jviz.histories) == len(tviz.histories) == 1
    history = tviz.histories[0]
    if method == "Newton-CG" and device:
        assert history["loss"] == [st.last_frame_stats["loss"][s] for s in (1, 2)]
    else:
        assert len(history["loss"]) > 2 and len(history["total_variation"]) == len(history["loss"])
    _assert_history(history, jviz.histories[0])
    assert st.cost_func.get_history()["loss"] == []  # cleared after the frame's plot


@pytest.mark.parametrize("name", first_order.FIRST_ORDER)
def test_first_order_rules_match_optax(name):
    """Ten steps of each rule on the same gradient sequence as optax's
    update (``base._optax_factory``) at lr 0.05."""
    rng = np.random.default_rng(5)
    x0 = rng.normal(size=6)
    grads = rng.normal(size=(10, 6)) * np.linspace(0.1, 3.0, 6)
    grads[3, 2] = 0.0  # rprop's zero-product branch, adagrad's accumulator
    tx = jbase._optax_factory(name, 0.05)
    xj = jnp.asarray(x0)
    state = tx.init(xj)
    rule = first_order.make_rule(name, torch.as_tensor(x0), 0.05)
    xt = torch.as_tensor(x0)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, xj)
        xj = optax.apply_updates(xj, updates)
        xt = rule(xt, torch.as_tensor(g))
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-10)


def test_first_order_loop_matches_jax(mixed_problem):
    """The loop (best iterate, its loss) against the JAX package's
    ``run_first_order`` on the mixed problem."""
    sj, jspec, (ev, w), st, tspec, frame, orig = mixed_problem["pallas"]
    x0 = np.random.default_rng(6).uniform(-15.0, 15.0, 8)
    opt = {"n_iter": 6, "lr": 0.5}
    bj, fj = jax_run_first_order(sj._get_funs(jspec)[0], x0, "Adam", opt, ev, w, jnp.float64)
    vg = build_value_grad_hvp(tspec)[0]
    bt, ft, reads = first_order.run_first_order(lambda x: vg(x, orig, frame)[:2], torch.as_tensor(x0), "Adam", opt)
    assert reads == 1
    assert ft == pytest.approx(fj, rel=0, abs=TOL)
    np.testing.assert_allclose(bt.numpy(), bj, rtol=0, atol=TOL)


def test_sampling_matches_jax(events):
    """The sampling optimizer from the same numpy generator state: the same
    best motion and loss, the history's best per round, and the generator
    left in the same state (the same draws)."""
    opt = dict(OPTIMIZER, method="optuna", n_iter=12)
    sj = jsolver.collections[MIXED["method"]]((H, W), {}, MIXED, opt, {}, None)
    st = tsolver.collections[MIXED["method"]]((H, W), {}, MIXED, opt, {}, device="cpu")
    x0 = sj.initialize_random()
    np.testing.assert_array_equal(st.initialize_random().numpy(), x0)
    ev, w = sj.prepare_events(events)
    bj, fj = sj._run_sampling_on_spec(sj._current_spec(), ev, w, x0, 12)
    tspec = st._current_spec()
    frame = FrameEvents.from_numpy(events, "cpu", torch.float64)
    bt, ft = st._run_sampling_on_spec(tspec, frame, build_orig_iwe(tspec)(frame), x0, 12)
    assert ft == pytest.approx(fj, rel=0, abs=TOL)
    np.testing.assert_allclose(bt, bj, rtol=0, atol=TOL)
    assert sj._rng.bit_generator.state == st._rng.bit_generator.state
    _assert_history(st.cost_func.get_history(), sj.cost_func.get_history())
    assert len(st.cost_func.get_history()["loss"]) == 4


def test_schema_accepts_the_optimizers_and_refuses_lbfgs(tmp_path):
    """Every ``optimizer.method`` of the JAX package validates in the port
    as in the JAX package, optax's ``LBFGS`` too (no longer refused)."""
    from event_based_optical_flow_tpu.solver.base import TORCH_OPTIMIZERS
    from event_based_optical_flow_tpu.utils import validate_config as jax_validate
    from event_based_optical_flow_tpu_torch.utils import validate_config
    from test_torch_cli import _config

    assert len(tsolver.OPTIMIZERS) == 28
    assert set(tsolver.OPTIMIZERS) == set(SCIPY) | set(first_order.FIRST_ORDER) | {"LBFGS", "optuna"}
    assert set(tsolver.OPTIMIZERS) == set(SCIPY) | set(TORCH_OPTIMIZERS) | {"optuna"}
    config = _config(tmp_path)
    for method in tsolver.OPTIMIZERS:
        cfg = copy.deepcopy(config)
        cfg["optimizer"]["method"] = method
        assert validate_config(cfg) == jax_validate(copy.deepcopy(cfg)) == []
    cfg = copy.deepcopy(config)
    cfg["optimizer"].update(device=False, lr=0.1)
    assert validate_config(cfg) == []
    cfg["optimizer"]["method"] = "LBFGS"
    assert validate_config(copy.deepcopy(cfg)) == []  # the JAX package warns of lr, which it ignores
    del cfg["optimizer"]["lr"]
    assert validate_config(copy.deepcopy(cfg)) == jax_validate(copy.deepcopy(cfg)) == []
