"""The port's host-driven Newton-CG against the JAX package's device
Newton-CG (``build_newton_cg(hvp_mode="fd")``, central-FD HVP) at float64:
same objective, same x0 -> same best iterate, loss and iteration count.

Smooth test functions converge to the same point to 1e-9.  On the real
CMax objective (fused-kernel route, JAX in Pallas interpret mode) the
objectives agree to ~1e-15, but the piecewise landscape amplifies those
last-bit differences through the finite-difference HVP (~30x per Newton
iteration, measured), so that comparison runs 3 iterations to 1e-6.
"""

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


def test_only_fd_hvp_is_ported():
    with pytest.raises(NotImplementedError):
        build_newton_cg(lambda x: x.sum(), hvp_mode="analytic")


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
