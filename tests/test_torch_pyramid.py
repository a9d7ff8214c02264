"""The port's pyramidal solver against the JAX package's per-scale loop
(``iwe_backend: pallas`` in interpret mode, ``precision: "64"``: the fused
banded objective and central-FD HVP, the TPU route), on a small aperiodic
``pattern: dots`` scene.

* Per-scale parity: JAX's ``jax.random`` init-sweep draws are fed to the
  port through the ``candidates_fn`` hook, so both solve the same problem
  from the same starts.  Newton budgets stay short (2 iterations): the
  piecewise objective amplifies last-bit differences ~30x per iteration
  (tests/test_torch_newton_cg.py), so per-scale motions agree to 1e-6.
* The DSEC config's solver block (``hvp_mode: analytic``, ``fd_polish: 2``,
  ``cg_maxiter: 8``, ``coarse_event_fraction: 0.25``): per-scale parity
  with JAX's draws again, the coarse scale solved on the stride-4
  subsample with its own orig IWE, the finest on every event with the
  analytic Gauss-Newton HVP.
* Whole solve: the port with its own ``torch.Generator`` draws and a
  longer budget recovers the flow as well as JAX does with its own draws:
  every EPE below 0.7 x the zero-flow EPE, the port's mean over three
  seeds within 0.3 px of JAX's.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_based_optical_flow_tpu import solver as jsolver
from event_based_optical_flow_tpu.data.synthetic import SyntheticDataLoader
from event_based_optical_flow_tpu_torch import solver as tsolver

H, W = 32, 40
SOLVER = {
    "method": "pyramidal_patch_contrast_maximization", "time_aware": False,
    "patch": {"initialize": "random", "scale": 3, "crop_height": 32, "crop_width": 40, "filter_type": "bilinear"},
    "motion_model": "2d-translation", "warp_direction": "first", "parameters": ["trans_x", "trans_y"],
    "cost": "hybrid", "outer_padding": 0,
    "cost_with_weight": {"multi_focal_normalized_gradient_magnitude": 1.0, "total_variation": 0.01},
    "iwe": {"method": "bilinear_vote", "blur_sigma": 1},
    "iwe_backend": "pallas", "precision": "64",
}
OPTIMIZER = {"n_iter": 8, "method": "Newton-CG", "max_iter": 2, "cg_maxiter": 6, "chain": False,
             "parameters": {"trans_x": {"min": -20, "max": 20}, "trans_y": {"min": -20, "max": 20}}}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def scene():
    """One eval window of a small dots scene: (events, GT flow, window
    seconds); the loader is the JAX package's (the port's is byte-equal,
    tests/test_torch_cli.py)."""
    loader = SyntheticDataLoader({"height": H, "width": W, "duration": 1.0, "event_rate": 12000,
                                  "n_frames": 4, "pattern": "dots", "n_dots": 60, "flow_max": 12.0})
    loader.set_sequence("pyramid")
    ts = loader.eval_frame_time_list()
    i1, i2 = loader.time_to_index(ts[1]), loader.time_to_index(ts[2])
    events = loader.load_event(i1, i2)
    events[:, 2] -= events[:, 2].min()
    return events, loader.load_optical_flow(ts[1], ts[2]), ts[2] - ts[1]


class JaxDraws:
    """The JAX solver's init-sweep draws, reproduced: the key chain of
    ``patch_base._next_key`` and the per-patch splits of
    ``sampling.build_patch_search``."""

    def __init__(self, seed=0):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, n_patch, k1, k2):
        self.key, sub = jax.random.split(self.key)

        def one(k):
            a, b = jax.random.split(k)
            return (jax.random.uniform(a, (k1, 2), dtype=jnp.float64),
                    jax.random.normal(b, (k2, 2), dtype=jnp.float64))

        u, n = jax.vmap(one)(jax.random.split(sub, n_patch))
        return np.asarray(u), np.asarray(n)


def _record(obj, names, sink, to_np):
    for name in names:
        fn = getattr(obj, name)

        def wrapped(*a, _fn=fn, **k):
            out = _fn(*a, **k)
            sink.append(to_np(out))
            return out

        setattr(obj, name, wrapped)


def _jax_solver(opt):
    return jsolver.collections[SOLVER["method"]]((H, W), {}, SOLVER, opt, {}, None)


def test_per_scale_parity(scene):
    events, gt_flow, dt = scene
    sj = _jax_solver(OPTIMIZER)
    st = tsolver.collections[SOLVER["method"]]((H, W), {}, SOLVER, OPTIMIZER, {}, device="cpu",
                                               candidates_fn=JaxDraws())
    assert st.dtype == torch.float64
    got_j, got_t = [], []
    _record(sj, ["_run_newton_device", "_run_fused_scale_device"], got_j, np.asarray)
    _record(st, ["_run_newton"], got_t, lambda out: out[0].numpy().copy())
    bj = sj.optimize(events)
    bt = st.optimize(events)
    assert len(got_j) == len(got_t) == 2  # scales 1 and 2
    for a, b in zip(got_j, got_t):
        np.testing.assert_allclose(b.reshape(-1), a.reshape(-1), atol=1e-6)
    assert sorted(bj) == sorted(bt) == [1, 2]
    for s in bj:
        np.testing.assert_allclose(bt[s].numpy(), bj[s], atol=1e-6)
    ej = sj.calculate_flow_error(bj, gt_flow, dt, events)
    et = st.calculate_flow_error(bt, gt_flow, dt, events)
    for k in ("EPE", "AE", "GT_FWL", "PRED_FWL"):
        assert et[k] == pytest.approx(ej[k], rel=1e-6, abs=1e-9), k


def test_per_scale_parity_analytic_dsec_solver(scene):
    events, gt_flow, dt = scene
    assert len(events) > 4 * 512  # the stride-4 subsample engages
    opt = dict(OPTIMIZER, hvp_mode="analytic", fd_polish=2, cg_maxiter=8, coarse_event_fraction=0.25)
    sj = _jax_solver(opt)
    st = tsolver.collections[SOLVER["method"]]((H, W), {}, SOLVER, opt, {}, device="cpu",
                                               candidates_fn=JaxDraws())
    got_j, got_t = [], []
    _record(sj, ["_run_newton_device", "_run_fused_scale_device"], got_j, np.asarray)
    _record(st, ["_run_newton"], got_t, lambda out: out[0].numpy().copy())
    bj = sj.optimize(events)
    bt = st.optimize(events)
    assert len(got_j) == len(got_t) == 2
    for a, b in zip(got_j, got_t):
        np.testing.assert_allclose(b.reshape(-1), a.reshape(-1), atol=1e-6)
    for s in bj:
        np.testing.assert_allclose(bt[s].numpy(), bj[s], atol=1e-6)
    stats = st.last_frame_stats
    assert stats["hvp"] == {1: "fd", 2: "analytic-gn"}
    assert stats["events"] == {1: len(events[::4]), 2: len(events)}
    assert stats["iters"][2] > opt["max_iter"]  # the polish iterations are counted
    ej = sj.calculate_flow_error(bj, gt_flow, dt, events)
    et = st.calculate_flow_error(bt, gt_flow, dt, events)
    for k in ("EPE", "AE", "GT_FWL", "PRED_FWL"):
        assert et[k] == pytest.approx(ej[k], rel=1e-6, abs=1e-9), k


def test_whole_solve_epe_close_to_jax(scene):
    """Own random draws on each side (the frameworks' generators differ,
    and one solve's EPE moves by ~0.4 px with the draws on this scene):
    every port solve, over three seeds, recovers the flow (EPE below 0.7 x
    the zero-flow EPE), and their mean is within 0.3 px of JAX's EPE."""
    events, gt_flow, dt = scene
    opt = dict(OPTIMIZER, max_iter=10, cg_maxiter=12)
    ets = []
    for seed in range(3):
        slv = dict(SOLVER, seed=seed)
        st = tsolver.collections[SOLVER["method"]]((H, W), {}, slv, opt, {}, device="cpu")
        bt = st.optimize(events)
        ets.append(st.calculate_flow_error(bt, gt_flow, dt, events)["EPE"])
        assert st.last_frame_stats["syncs"] > 0
    sj = _jax_solver(opt)
    ej = sj.calculate_flow_error(sj.optimize(events), gt_flow, dt, events)["EPE"]
    zero = st.calculate_flow_error({2: torch.zeros_like(bt[2])}, gt_flow, dt, events)["EPE"]
    assert max(ets) < 0.7 * zero and ej < 0.7 * zero, (ets, ej, zero)
    assert abs(np.mean(ets) - ej) < 0.3, (ets, ej)


def test_warm_start_from_jax_state(scene):
    """A JAX-layout warm motion (numpy, per scale) seeds the port's solve."""
    events, _, _ = scene
    opt = copy.deepcopy(OPTIMIZER)
    st = tsolver.collections[SOLVER["method"]]((H, W), {}, SOLVER, opt, {}, device="cpu",
                                               candidates_fn=JaxDraws())
    warm = {1: np.full((2, 2, 2), 3.0), 2: np.full((2, 4, 4), -2.0)}
    st.set_previous_frame_best_estimation(warm)
    assert all(torch.is_tensor(v) and v.dtype == torch.float64 for v in st.previous_frame_best_estimation.values())
    warm_t = st.previous_frame_best_estimation
    np.testing.assert_array_equal(st._init_scale(1, warm_t).numpy(), warm[1])
    motion0, n_cand = st._presearch_motion(2, {1: torch.zeros((2, 2, 2), dtype=torch.float64)}, warm_t)
    np.testing.assert_allclose(motion0.numpy(), (0.0 + warm[2].reshape(2, -1)) / 2.0)
    assert n_cand == 8


TIME_AWARE = {"time_aware": True, "time_bin": 3, "flow_interpolation": "burgers", "t0_flow_location": "middle"}


def test_per_scale_parity_time_aware(scene):
    """The Burgers config's time-aware keys (3 bins here): per-scale
    motions with JAX's draws, and the metrics (t0-slice EPE, PRED_FWL
    through the voxel, GT_FWL dense) against the JAX eval."""
    events, gt_flow, dt = scene
    slv = dict(SOLVER, **TIME_AWARE)
    sj = jsolver.collections[slv["method"]]((H, W), {}, slv, OPTIMIZER, {}, None)
    st = tsolver.collections[slv["method"]]((H, W), {}, slv, OPTIMIZER, {}, device="cpu",
                                            candidates_fn=JaxDraws())
    got_j, got_t = [], []
    _record(sj, ["_run_newton_device", "_run_fused_scale_device"], got_j, np.asarray)
    _record(st, ["_run_newton"], got_t, lambda out: out[0].numpy().copy())
    bj = sj.optimize(events)
    bt = st.optimize(events)
    assert len(got_j) == len(got_t) == 2
    for a, b in zip(got_j, got_t):
        np.testing.assert_allclose(b.reshape(-1), a.reshape(-1), atol=1e-6)
    for s in bj:
        np.testing.assert_allclose(bt[s].numpy(), bj[s], atol=1e-6)
    voxel = st.motion_to_dense_flow(bt, dt)
    assert voxel.shape == (3, 2, H, W)
    np.testing.assert_allclose(voxel.numpy(), sj.motion_to_dense_flow(bj, dt), atol=1e-6)
    ej = sj.calculate_flow_error(bj, gt_flow, dt, events)
    et = st.calculate_flow_error(bt, gt_flow, dt, events)
    for k in ("EPE", "AE", "GT_FWL", "PRED_FWL"):
        assert et[k] == pytest.approx(ej[k], rel=1e-6, abs=1e-9), k


@pytest.mark.parametrize("mode,want", [("analytic", {1: "fd", 2: "analytic-gn"}),
                                       ("analytic-full", {1: "fd", 2: "fd"})])
def test_time_aware_hvp_routing(scene, caplog, mode, want):
    """On a time-aware solve ``analytic`` takes the Gauss-Newton HVP on the
    finest scale; ``analytic-full`` warns once and solves with the FD HVP."""
    events, _, _ = scene
    slv = dict(SOLVER, **TIME_AWARE)
    opt = dict(OPTIMIZER, hvp_mode=mode)
    st = tsolver.collections[slv["method"]]((H, W), {}, slv, opt, {}, device="cpu")
    with caplog.at_level("WARNING"):
        st.optimize(events)
    assert st.last_frame_stats["hvp"] == want
    warned = [r for r in caplog.records if "falling back to the FD HVP" in r.getMessage()]
    assert len(warned) == (mode == "analytic-full")
