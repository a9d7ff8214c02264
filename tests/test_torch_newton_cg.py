"""The port's host-driven Newton-CG against the JAX package's device
Newton-CG at float64: same objective, same x0 -> same best iterate, loss
and iteration count.  FD HVPs (``hvp_mode="fd"``, central and one-sided),
and the analytic mode (``hvp_mode="analytic"``) with the same exact
``hvp_fn`` on both sides, its per-component step clip ``max_step`` and
its central-FD polish ``fd_polish``.

Smooth test functions converge to the same point to 1e-9.  On the real
CMax objective (fused-kernel route, JAX in Pallas interpret mode) the
objectives agree to ~1e-15, but the piecewise landscape amplifies those
last-bit differences through the finite-difference HVP (~30x per Newton
iteration, measured), so that comparison runs 3 iterations to 1e-6.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_based_optical_flow_tpu.ops import pallas_objective_banded as PB
from event_based_optical_flow_tpu.solver import objective as JO
from event_based_optical_flow_tpu.solver.newton_cg import build_newton_cg as jax_newton
from event_based_optical_flow_tpu.types import pad_events
from event_based_optical_flow_tpu_torch.solver import objective as TO
from event_based_optical_flow_tpu_torch.solver.newton_cg import NewtonCG, build_newton_cg


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def rosenbrock(x, lib):
    return lib.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2)


def plateau(x, lib):
    """A gaussian well seen from its flat, concave outskirts: negative
    curvature at the start and a negligible first decrease, which arms
    the plateau-escape probe."""
    return 1.0 - lib.exp(-0.5 * lib.sum((x - 3.0) ** 2))


def washboard(x, lib):
    return lib.sum(x**2) / 40.0 + 0.3 * lib.sum(lib.sin(2.5 * x))


CASES = {
    "rosenbrock": (rosenbrock, np.array([-1.2, 1.0, -0.5, 0.8, 1.3, 0.2]), 60),
    "plateau": (plateau, np.array([-2.0, -1.0]), 12),
    "washboard": (washboard, np.linspace(-4.0, 5.0, 7), 25),
}


def _run_both(fn, x0, maxiter, cg_maxiter=20):
    jsolve = jax.jit(jax_newton(lambda x: fn(x, jnp), maxiter=maxiter, cg_maxiter=cg_maxiter, hvp_mode="fd"))
    jx, jf, jk = jsolve(jnp.asarray(x0))
    tsolve = build_newton_cg(lambda x: fn(x, torch), maxiter=maxiter, cg_maxiter=cg_maxiter, hvp_mode="fd")
    tx, tf, tk = tsolve(torch.as_tensor(x0))
    return (np.asarray(jx), float(jf), int(jk)), (tx.numpy(), float(tf), tk), tsolve


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax_on_test_functions(name, monkeypatch):
    fn, x0, maxiter = CASES[name]
    escapes = []
    orig = NewtonCG._escape_probe
    monkeypatch.setattr(NewtonCG, "_escape_probe",
                        lambda self, *a: escapes.append(1) or orig(self, *a))
    (jx, jf, jk), (tx, tf, tk), solve = _run_both(fn, x0, maxiter)
    assert tk == jk
    assert tf == pytest.approx(jf, rel=1e-9, abs=1e-12)
    np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-9)
    assert solve.syncs > tk  # one host read per loop condition at least
    if name == "plateau":
        assert escapes, "the plateau case must exercise the escape probe"
    if name == "rosenbrock":
        assert tk < maxiter  # converged, at the known minimum
        np.testing.assert_allclose(tx, np.ones_like(x0), atol=1e-4)


def test_one_sided_fd_hvp_matches_jax():
    fn, x0, _ = CASES["washboard"]
    jsolve = jax.jit(jax_newton(lambda x: fn(x, jnp), maxiter=10, hvp_mode="fd", fd_central=False))
    jx, jf, jk = jsolve(jnp.asarray(x0))
    tx, tf, tk = build_newton_cg(lambda x: fn(x, torch), maxiter=10, fd_central=False)(torch.as_tensor(x0))
    assert tk == int(jk)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-9)


def _exact_hvps(fn, staged):
    """The same exact Hessian-vector product for both frameworks (forward
    over reverse), unstaged or staged (``prep`` hands the iterate over)."""
    jgrad, tgrad = jax.grad(lambda x: fn(x, jnp)), torch.func.grad(lambda x: fn(x, torch))
    if staged:
        return ((lambda aux, x, p: jax.jvp(jgrad, (aux,), (p,))[1], lambda x: x),
                (lambda aux, x, p: torch.func.jvp(tgrad, (aux,), (p,))[1], lambda x: x))
    return ((lambda x, p: jax.jvp(jgrad, (x,), (p,))[1], None),
            (lambda x, p: torch.func.jvp(tgrad, (x,), (p,))[1], None))


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("name", ["rosenbrock", "washboard"])
def test_analytic_mode_matches_jax(name, staged, monkeypatch):
    """Same iterations and iterates to 1e-9 with the step clip engaged;
    the clip is per component (the clipped directions keep components
    below the cap, unlike an inf-norm rescale); the central-FD polish
    iterations are counted in the iterations."""
    fn, x0, _ = CASES[name]
    cap = 0.3
    (jh, jprep), (th, tprep) = _exact_hvps(fn, staged)
    directions = []
    orig = NewtonCG._line_search
    monkeypatch.setattr(NewtonCG, "_line_search",
                        lambda self, x, f, g, p, a: directions.append(p) or orig(self, x, f, g, p, a))
    ks = []
    for polish in (0, 2):
        kw = dict(maxiter=6, cg_maxiter=8, hvp_mode="analytic", max_step=cap, fd_polish=polish)
        jx, jf, jk = jax.jit(jax_newton(lambda x: fn(x, jnp), hvp_fn=jh, hvp_prep_fn=jprep, **kw))(
            jnp.asarray(x0))
        directions.clear()
        tx, tf, tk = build_newton_cg(lambda x: fn(x, torch), hvp_fn=th, hvp_prep_fn=tprep, **kw)(
            torch.as_tensor(x0))
        assert tk == int(jk)
        assert tf.item() == pytest.approx(float(jf), rel=1e-9, abs=1e-12)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-9)
        ks.append(tk)
        if polish == 0:  # every direction is an analytic one
            assert all(d.abs().max() <= cap for d in directions)
            clipped = [d for d in directions if d.abs().max() == cap]
            assert clipped and any(((d.abs() > 0) & (d.abs() < cap)).any() for d in clipped)
    assert 0 < ks[1] - ks[0] <= 2


def test_analytic_mode_needs_its_hvp():
    with pytest.raises(ValueError):
        build_newton_cg(lambda x: x.sum(), hvp_mode="analytic")
    with pytest.raises(ValueError):
        build_newton_cg(lambda x: x.sum(), hvp_mode="autodiff")


def _cmax_problem():
    rng = np.random.default_rng(3)
    h, w, n = 20, 28, 2600
    dots = np.stack([rng.uniform(2, h - 2, 40), rng.uniform(2, w - 2, 40)], 1)
    idx = rng.integers(0, 40, n)
    tt = np.sort(rng.uniform(0, 0.4, n))
    x = np.round(dots[idx, 0] + rng.normal(0, 0.2, n) - tt * 8.0)
    y = np.round(dots[idx, 1] + rng.normal(0, 0.2, n) + tt * 6.0)
    ok = (x >= 0) & (x < h - 1) & (y >= 0) & (y < w - 1)
    ev = np.stack([x, y, tt, rng.integers(0, 2, n)], 1)[ok]
    cww = (("multi_focal_normalized_gradient_magnitude", 1.0), ("total_variation", 0.01))
    geom = dict(patch_image_size=(4, 4), patch_size=(4, 6), sliding_window=(4, 6), patch_shift=(2, 2))
    jspec = JO.ObjectiveSpec(image_shape=(h, w), outer_padding=0, filter_type="bilinear",
                             iwe_method="bilinear_vote", blur_sigma=1, cost_name="hybrid",
                             cost_with_weight=cww, iwe_backend="pallas", **geom)
    tspec = TO.ObjectiveSpec(image_shape=(h, w), filter_type="bilinear", blur_sigma=1,
                             cost_name="hybrid", cost_with_weight=cww, **geom)
    return ev, jspec, tspec, rng.uniform(-15, 15, 32)


def test_matches_jax_on_cmax_objective():
    ev, jspec, tspec, x0 = _cmax_problem()
    h, w = jspec.image_shape
    padded, wgt = pad_events(ev)
    tcol = padded[:, 2]
    t_min, t_max = tcol[wgt > 0].min(), tcol[wgt > 0].max()
    packed = PB.pack_events_dense(padded, wgt, (tcol - t_min) / (t_max - t_min), h, w)
    jargs = tuple(jnp.asarray(a) for a in packed) + (jnp.asarray(t_max - t_min),)
    jorig = JO.build_orig_iwe_banded(jspec)(*jargs)
    jobj = JO.build_objective_banded(jspec, precomputed_orig=True)
    frame = TO.FrameEvents.from_numpy(ev, "cpu", torch.float64)
    torig = TO.build_orig_iwe(tspec)(frame)
    tobj = TO.build_objective(tspec)
    np.testing.assert_allclose(torig.numpy(), np.asarray(jorig), atol=1e-12)

    lj, gj = jax.value_and_grad(lambda m: jobj(m, jorig, *jargs)[0])(jnp.asarray(x0))
    m = torch.as_tensor(x0).requires_grad_(True)
    (gt,) = torch.autograd.grad(tobj(m, torig, frame)[0], m)
    assert tobj(m, torig, frame)[0].item() == pytest.approx(float(lj), rel=1e-12)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-12)

    js = jax.jit(jax_newton(lambda x, *a: jobj(x, *a)[0], maxiter=3, cg_maxiter=6, hvp_mode="fd"))
    jx, jf, jk = js(jnp.asarray(x0), jorig, *jargs)
    ts = build_newton_cg(lambda x, *a: tobj(x, *a)[0], maxiter=3, cg_maxiter=6)
    tx, tf, tk = ts(torch.as_tensor(x0), torig, frame)
    assert tk == int(jk) == 3
    assert tf.item() == pytest.approx(float(jf), rel=1e-9)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6)


@pytest.mark.parametrize("method,extra", [
    ("mixed_patch_contrast_maximization", {}),
    ("time_aware_mixed_patch_contrast_maximization",
     {"time_aware": True, "time_bin": 3, "flow_interpolation": "burgers", "t0_flow_location": "middle"}),
])
def test_single_scale_solvers_match_jax(method, extra):
    """The single-scale tile solver and its time-aware subclass: the
    device Newton-CG solve (gtol 1e-7, the same numpy cold start) and the
    metrics (the time-aware one scores its voxel's t0 slice) against the
    JAX package's, ``iwe_backend: pallas`` in interpret mode."""
    from event_based_optical_flow_tpu import solver as jsolver
    from event_based_optical_flow_tpu.data.synthetic import SyntheticDataLoader
    from event_based_optical_flow_tpu_torch import solver as tsolver
    from test_torch_pyramid import H, OPTIMIZER, SOLVER, W

    loader = SyntheticDataLoader({"height": H, "width": W, "duration": 1.0, "event_rate": 12000,
                                  "n_frames": 4, "pattern": "dots", "n_dots": 60, "flow_max": 12.0})
    loader.set_sequence("pyramid")
    ts = loader.eval_frame_time_list()
    events = loader.load_event(loader.time_to_index(ts[1]), loader.time_to_index(ts[2]))
    events[:, 2] -= events[:, 2].min()
    gt_flow, dt = loader.load_optical_flow(ts[1], ts[2]), ts[2] - ts[1]
    slv = dict(SOLVER, method=method, **extra,
               patch={"initialize": "random", "size": [16, 20], "sliding_window": [16, 20], "filter_type": "bilinear"})
    opt = dict(OPTIMIZER, max_iter=3)
    sj = jsolver.collections[method]((H, W), {}, slv, opt, {}, None)
    st = tsolver.collections[method]((H, W), {}, slv, opt, {}, device="cpu")
    bj, bt = sj.optimize(events), st.optimize(events)
    assert bt.shape == (2, 2, 2) and st.last_frame_stats["iters"] == {0: 3}
    np.testing.assert_allclose(bt.numpy(), bj, rtol=0, atol=1e-6)
    ej, et = sj.calculate_flow_error(bj, gt_flow, dt, events), st.calculate_flow_error(bt, gt_flow, dt, events)
    for k in ("EPE", "AE", "GT_FWL", "PRED_FWL"):
        assert et[k] == pytest.approx(ej[k], rel=1e-6, abs=1e-9), k


def test_single_scale_solver_refuses_unported_optimizers():
    """The single-scale solver runs the JAX package's optax ``LBFGS`` and
    ``grid-best`` init (they validate as the JAX package validates them),
    and refuses a method neither package has before it solves."""
    from event_based_optical_flow_tpu.utils import validate_config as jax_validate
    from event_based_optical_flow_tpu_torch import solver as tsolver
    from event_based_optical_flow_tpu_torch.utils import ConfigError, validate_config
    from test_torch_pyramid import OPTIMIZER, SOLVER

    slv = dict(SOLVER, method="mixed_patch_contrast_maximization",
               patch={"initialize": "grid-best", "size": 8, "sliding_window": 8})
    rng = np.random.default_rng(0)
    events = np.stack([rng.integers(0, 16, 200), rng.integers(0, 16, 200), np.sort(rng.uniform(0, 0.1, 200)),
                       rng.integers(0, 2, 200)], axis=1).astype(np.float64)
    for opt in (dict(OPTIMIZER, method="LBFGS", n_iter=2), dict(OPTIMIZER, max_iter=2)):
        cfg = {"data": {"dataset": "synthetic", "sequence": "s", "height": 16, "width": 16, "n_events_per_batch": 200},
               "output": {"output_dir": "out", "show_interactive_result": False}, "solver": slv, "optimizer": opt}
        assert validate_config(copy.deepcopy(cfg)) == jax_validate(copy.deepcopy(cfg))
        st = tsolver.collections[slv["method"]]((16, 16), {}, slv, opt, {}, device="cpu")
        assert np.isfinite(st.optimize(events).numpy()).all()
    st = tsolver.collections[slv["method"]]((16, 16), {}, slv, dict(OPTIMIZER, method="Nope"), {}, device="cpu")
    with pytest.raises(ConfigError, match="Nope"):
        st.optimize(events)
