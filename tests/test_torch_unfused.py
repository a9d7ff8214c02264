"""The JAX package's unfused (warp-then-vote) objective's options in the
port: ``solver.outer_padding``, ``iwe.method: count`` and ``polarity``,
against the JAX package at float64 with its matmul backend (its Pallas
backend cannot differentiate K8 twice, which the exact HVP of this route
needs), JAX's init-sweep draws injected.

* The votes (K8's plain version) and ``EventImageConverter``: 1e-12.
* The objective's value and gradient, and the exact HVP (K3 plus K4 with
  term A; JAX's reverse-over-reverse): 1e-10 x the largest value.
* The init sweep's choice per patch, the pyramid's per-scale motions and
  eval metrics (loop and chain, the chain bit for bit the loop), the
  single-scale tile solver from a grid sweep, and the sampling optimizer
  on the count vote: 1e-6.
* The global motion-model solver's parameters and metrics: 1e-6.
* The time-aware objective's value, gradient and exact HVP (the voxel
  map's own curvature included): 1e-10; the time-aware pyramid and
  single-scale solver: 1e-6.
* The fleet's lockstep solves (loop and chain) against the JAX package's:
  1e-6.
* The schema: the options on every solver; a
  host griddata scheme raises in the JAX package and is refused here with a
  message that says so.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_based_optical_flow_tpu import solver as jsolver
from event_based_optical_flow_tpu.data.synthetic import SyntheticDataLoader
from event_based_optical_flow_tpu.ops.iwe import EventImageConverter as JaxConverter
from event_based_optical_flow_tpu.solver import objective as JO
from event_based_optical_flow_tpu.solver import sampling as JS
from event_based_optical_flow_tpu_torch import solver as tsolver
from event_based_optical_flow_tpu_torch.ops.iwe import EventImageConverter
from event_based_optical_flow_tpu_torch.solver import objective as TO
from event_based_optical_flow_tpu_torch.solver.sampling import build_patch_search
from event_based_optical_flow_tpu_torch.utils.config_schema import ConfigError, validate_config
from test_torch_chain import _same_solve, _solve
from test_torch_newton_cg import _cmax_problem
from test_torch_pyramid import OPTIMIZER, SOLVER, H, W, JaxDraws, _record

# (outer_padding, iwe.method) of each case
CASES = {"pad": (3, "bilinear_vote"), "count": (0, "count"), "polarity": (0, "polarity"),
         "pad-polarity": (2, "polarity"), "pad-count": (2, "count")}
RTOL = 1e-10  # x the largest value


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def scene():
    """One eval window of the pyramid tests' dots scene, thinned to a third
    of its events, with polarities of both signs."""
    loader = SyntheticDataLoader({"height": H, "width": W, "duration": 1.0, "event_rate": 12000,
                                  "n_frames": 4, "pattern": "dots", "n_dots": 60, "flow_max": 12.0})
    loader.set_sequence("pyramid")
    ts = loader.eval_frame_time_list()
    events = loader.load_event(loader.time_to_index(ts[1]), loader.time_to_index(ts[2]))
    events[:, 2] -= events[:, 2].min()
    gt, dt = loader.load_optical_flow(ts[1], ts[2]), ts[2] - ts[1]
    events = np.ascontiguousarray(events[::3])
    events[:, 3] = np.where(np.random.default_rng(5).random(len(events)) < 0.5, 1.0, -1.0)
    return events, gt, dt


def _solver_config(case, **kw):
    pad, method = CASES[case]
    return dict(SOLVER, outer_padding=pad, iwe=dict(SOLVER["iwe"], method=method), iwe_backend="matmul", **kw)


def _close(got, want, least=1e-3):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale >= least
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("backend", ["matmul", "scatter"])
def test_converter_matches_jax(case, backend):
    pad, method = CASES[case]
    rng = np.random.default_rng(0)
    n, h, w = 400, 18, 22
    ev = np.stack([rng.uniform(-4, h + 3, n), rng.uniform(-4, w + 3, n), rng.uniform(0, 1, n),
                   rng.choice([-1.0, 1.0], n)], 1)
    wt = rng.uniform(0, 1, n)
    for sigma in (0, 1):
        want = JaxConverter((h, w), pad).create_iwe(jnp.asarray(ev), method, sigma, weight=jnp.asarray(wt),
                                                    backend=backend)
        got = EventImageConverter((h, w), pad).create_iwe(torch.tensor(ev), method, sigma, weight=torch.tensor(wt))
        assert got.shape == want.shape == ((2,) if method == "polarity" else ()) + (h + 2 * pad, w + 2 * pad)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    mask = EventImageConverter((h, w), pad).create_eventmask(torch.tensor(ev))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(JaxConverter((h, w), pad).create_eventmask(
        jnp.asarray(ev))))


@pytest.mark.parametrize("case", sorted(CASES))
def test_objective_value_gradient_and_exact_hvp_match_jax(case):
    """The JAX package's ``build_value_grad_hvp`` (value_and_grad, and its
    reverse-over-reverse HVP on the unfused objective) against the port's:
    K1, K2 and the full analytic HVP, staged and unstaged."""
    pad, method = CASES[case]
    ev, jspec, tspec, x0 = _cmax_problem()
    ev[:, 3] = np.where(np.random.default_rng(1).random(len(ev)) < 0.5, 1.0, -1.0)
    jspec = dataclasses.replace(jspec, outer_padding=pad, iwe_method=method, iwe_backend="matmul")
    tspec = dataclasses.replace(tspec, outer_padding=pad, iwe_method=method)
    assert not JO.objective_uses_banded(jspec) and TO.is_unfused(tspec)
    p = np.random.default_rng(2).normal(size=x0.shape)
    vg, hvp, _ = JO.build_value_grad_hvp(jspec)
    e, w = jnp.asarray(ev), jnp.ones(len(ev))
    lj, gj, _ = vg(jnp.asarray(x0), e, w)
    hj = hvp(jnp.asarray(x0), jnp.asarray(p), e, w)

    frame = TO.FrameEvents.from_numpy(ev, "cpu", torch.float64, polarity=method == "polarity")
    assert frame.n_events == len(ev)
    orig = TO.build_orig_iwe(tspec)(frame)
    tvg, thvp, _ = TO.build_value_grad_hvp(tspec)
    lt, gt, _ = tvg(torch.tensor(x0), orig, frame)
    assert float(lt) == pytest.approx(float(lj), rel=RTOL)
    _close(gt.numpy(), gj, least=1e-4)
    ht = thvp(torch.tensor(x0), torch.tensor(p), orig, frame)
    if method == "count":  # no image curvature; TV's is 0 a.e.
        assert np.abs(np.asarray(hj)).max() == 0 and torch.all(ht == 0)
    else:
        _close(ht.numpy(), hj)
    prep, staged = TO.build_objective_hvp_staged(tspec, gauss_newton=False)
    hs = staged(prep(torch.tensor(x0), orig, frame), torch.tensor(x0), torch.tensor(p), orig, frame)
    assert torch.equal(hs, ht)


@pytest.mark.parametrize("case,scheme", [("pad", "burgers"), ("polarity", "upwind"), ("pad-count", "burgers")])
def test_time_aware_objective_and_exact_hvp_match_jax(case, scheme):
    """A time-aware unfused objective: value and gradient (K5), and the
    exact HVP (K6 with term A plus the voxel map's own curvature) against
    the JAX package's reverse-over-reverse HVP."""
    pad, method = CASES[case]
    ev, jspec, tspec, x0 = _cmax_problem()
    ev[:, 3] = np.where(np.random.default_rng(1).random(len(ev)) < 0.5, 1.0, -1.0)
    ta = dict(time_aware=True, time_bin=3, flow_interpolation=scheme, t0_location="middle")
    jspec = dataclasses.replace(jspec, outer_padding=pad, iwe_method=method, iwe_backend="matmul", **ta)
    tspec = dataclasses.replace(tspec, outer_padding=pad, iwe_method=method, **ta)
    x0 = x0 / 4.0  # the voxel chain's CFL range
    p = np.random.default_rng(2).normal(size=x0.shape)
    vg, hvp, _ = JO.build_value_grad_hvp(jspec)
    e, w = jnp.asarray(ev), jnp.ones(len(ev))
    lj, gj, _ = vg(jnp.asarray(x0), e, w)
    hj = hvp(jnp.asarray(x0), jnp.asarray(p), e, w)
    frame = TO.FrameEvents.from_numpy(ev, "cpu", torch.float64, time_bin=3, polarity=method == "polarity")
    orig = TO.build_orig_iwe(tspec)(frame)
    tvg, thvp, _ = TO.build_value_grad_hvp(tspec)
    lt, gt, _ = tvg(torch.tensor(x0), orig, frame)
    assert float(lt) == pytest.approx(float(lj), rel=RTOL)
    _close(gt.numpy(), gj, least=1e-5)
    ht = thvp(torch.tensor(x0), torch.tensor(p), orig, frame)
    if method == "count":
        assert np.abs(np.asarray(hj)).max() == 0 and torch.all(ht == 0)
    else:
        _close(ht.numpy(), hj, least=1e-5)


@pytest.mark.parametrize("case", ["pad", "polarity", "pad-count"])
def test_sweep_choice_matches_jax(scene, case):
    """One scale's per-patch init sweep (JAX's draws) picks JAX's motions."""
    pad, method = CASES[case]
    events = scene[0]
    st = tsolver.collections[SOLVER["method"]]((H, W), {}, _solver_config(case), OPTIMIZER, {}, device="cpu")
    st.overload_patch_configuration(2)
    from event_based_optical_flow_tpu_torch.solver.sampling import gather_patch_events

    pe, wt, counts = gather_patch_events(events, st.patches, st._patch_capacity(len(events)))
    motion0 = np.random.default_rng(3).uniform(-8, 8, (st.n_patch, 2))
    jsearch = JS.build_patch_search(tuple(st.patch_size), 8, iwe_method=method, outer_padding=pad,
                                    iwe_backend="matmul")
    key = jax.random.PRNGKey(4)
    want = np.asarray(jsearch(jnp.asarray(pe), jnp.asarray(wt), jnp.asarray(counts), jnp.asarray(motion0), key))

    def cands(n_patch, k1, k2):
        def one(k):
            a, b = jax.random.split(k)
            return (jax.random.uniform(a, (k1, 2), dtype=jnp.float64),
                    jax.random.normal(b, (k2, 2), dtype=jnp.float64))

        u, n = jax.vmap(one)(jax.random.split(key, n_patch))
        return np.asarray(u), np.asarray(n)

    search = build_patch_search(tuple(st.patch_size), 8, candidates_fn=cands, iwe_method=method,
                                outer_padding=pad)
    got = search(torch.tensor(pe), torch.tensor(wt), torch.tensor(counts), torch.tensor(motion0), None)
    assert np.abs(want - motion0).max() > 0  # some patch moved
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("case", ["pad", "polarity", "count"])
def test_pyramid_matches_jax_and_the_chain_the_loop(scene, case):
    """The pyramid's loop (device Newton-CG: the exact HVP on every scale)
    against the JAX package's, JAX's draws injected: every scale's motion
    and the eval metrics (padded FWL images, cropped event mask) to 1e-6;
    the chained frame gives the loop's bits."""
    events, gt_flow, dt = scene
    slv = _solver_config(case)
    sj = jsolver.collections[SOLVER["method"]]((H, W), {}, slv, OPTIMIZER, {}, None)
    st = tsolver.collections[SOLVER["method"]]((H, W), {}, slv, OPTIMIZER, {}, device="cpu",
                                               candidates_fn=JaxDraws())
    bj, bt = sj.optimize(events), st.optimize(events)
    assert set(st.last_frame_stats["hvp"].values()) == {"exact"}
    for s in bj:
        np.testing.assert_allclose(bt[s].numpy(), bj[s], rtol=0, atol=1e-6)
    ej = sj.calculate_flow_error(bj, gt_flow, dt, events)
    et = st.calculate_flow_error(bt, gt_flow, dt, events)
    for k in ("EPE", "AE", "GT_FWL", "PRED_FWL"):
        assert et[k] == pytest.approx(ej[k], rel=1e-6, abs=1e-9), k
    loop = _solve(slv, OPTIMIZER, events, candidates_fn=JaxDraws())
    chained = _solve(slv, dict(OPTIMIZER, chain=True), events, candidates_fn=JaxDraws())
    assert chained[3]["chain"] and not loop[3]["chain"]
    _same_solve(chained, loop)


@pytest.mark.parametrize("case,method", [("pad", "pyramidal_patch_contrast_maximization"),
                                         ("polarity", "time_aware_mixed_patch_contrast_maximization")])
def test_time_aware_solvers_match_jax(scene, case, method):
    """The time-aware pyramid and single-scale solver (Burgers, 3 bins) on
    the unfused objective, Newton with the exact HVP (K6 and the map's
    curvature): JAX's motions to 1e-6 and its metrics (the voxel's PRED_FWL
    through the padded images)."""
    from test_torch_pyramid import TIME_AWARE

    events, gt_flow, dt = scene
    slv = _solver_config(case, **TIME_AWARE)
    slv["method"] = method
    if method.startswith("time_aware_mixed"):
        slv["patch"] = {"initialize": "zero", "size": [16, 20], "sliding_window": [16, 20], "filter_type": "bilinear"}
    sj = jsolver.collections[method]((H, W), {}, slv, OPTIMIZER, {}, None)
    st = tsolver.collections[method]((H, W), {}, slv, OPTIMIZER, {}, device="cpu", candidates_fn=JaxDraws())
    bj, bt = sj.optimize(events), st.optimize(events)
    assert set(st.last_frame_stats["hvp"].values()) == {"exact"}
    for s in (bj if isinstance(bj, dict) else {0: bj}):
        np.testing.assert_allclose((bt[s] if isinstance(bt, dict) else bt).numpy(),
                                   bj[s] if isinstance(bj, dict) else bj, rtol=0, atol=1e-6)
    ej = sj.calculate_flow_error(bj, gt_flow, dt, events)
    et = st.calculate_flow_error(bt, gt_flow, dt, events)
    for k in ("EPE", "AE", "GT_FWL", "PRED_FWL"):
        assert et[k] == pytest.approx(ej[k], rel=1e-6, abs=1e-9), k


@pytest.mark.parametrize("case,opt", [("pad-polarity", {"device_solver": "lbfgs", "max_iter": 4}),
                                      ("pad", {"method": "BFGS", "max_iter": 3})])
def test_mixed_solver_grid_start_matches_jax(scene, case, opt):
    """The single-scale tile solver from ``grid-best`` (the sweep's
    candidates scored through the batched objective, K7), then the device L-BFGS or
    scipy's BFGS, against the JAX package's to 1e-6."""
    events = scene[0]
    slv = _solver_config(case, method="mixed_patch_contrast_maximization",
                         patch={"initialize": "grid-best", "size": [16, 20], "sliding_window": [16, 20],
                                "filter_type": "bilinear"})
    opt = dict(OPTIMIZER, **opt)
    sj = jsolver.collections[slv["method"]]((H, W), {}, slv, opt, {}, None)
    st = tsolver.collections[slv["method"]]((H, W), {}, slv, opt, {}, device="cpu")
    np.testing.assert_allclose(st.optimize(events).numpy(), sj.optimize(events), rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["pad", "count", "pad-polarity"])
def test_grid_sweep_matches_jax(scene, case):
    """``grid-best``'s sweep on an unfused spec: each candidate's loss
    through the batched objective (``FleetEvents.copies``, a polarity
    frame's two channels in each copy) against the JAX package's objective
    to ``RTOL``, and JAX's translation chosen."""
    from event_based_optical_flow_tpu_torch.solver import patch_base

    events = scene[0]
    slv = _solver_config(case, method="mixed_patch_contrast_maximization",
                         patch={"initialize": "grid-best", "size": [16, 20], "sliding_window": [16, 20],
                                "filter_type": "bilinear"})
    sj = jsolver.collections[slv["method"]]((H, W), {}, slv, OPTIMIZER, {}, None)
    st = tsolver.collections[slv["method"]]((H, W), {}, slv, OPTIMIZER, {}, device="cpu")
    obj = JO.build_objective(sj._current_spec())
    ev, w = sj.prepare_events(events)
    grid = patch_base.grid_translations(30)
    tiles = np.repeat(grid[:, :, None], sj.n_patch, axis=2).reshape(len(grid), -1)
    want = np.asarray(jax.lax.map(jax.jit(lambda x: obj(x, ev, w)[0]), jnp.asarray(tiles)))
    spec = st._current_spec()
    frame = st.frame_events(events)
    orig = TO.build_orig_iwe(spec)(frame)
    _close(patch_base.grid_sweep_losses(spec, frame, orig, st.tensor(tiles)).numpy(), want)
    np.testing.assert_array_equal(st._grid_best_translation(frame, orig, 30), sj._grid_best_translation(events, 30))


def test_count_vote_sampling_optimizer_matches_jax(scene):
    """``iwe.method: count`` has no image gradient in either package, so its
    frame is solved by the sampling ("optuna") optimizer: the pyramid's
    per-scale motions to 1e-6 (the numpy draws are the JAX package's)."""
    events = scene[0]
    slv = _solver_config("pad-count")
    opt = dict(OPTIMIZER, method="optuna", n_iter=8)
    sj = jsolver.collections[SOLVER["method"]]((H, W), {}, slv, opt, {}, None)
    st = tsolver.collections[SOLVER["method"]]((H, W), {}, slv, opt, {}, device="cpu", candidates_fn=JaxDraws())
    bj, bt = sj.optimize(events), st.optimize(events)
    for s in bj:
        np.testing.assert_allclose(bt[s].numpy(), bj[s], rtol=0, atol=1e-6)


def test_serving_push_with_padding_matches_jax():
    """The serving surface takes ``outer_padding`` (the sequential
    estimator's pyramid): a cold and a warm push against the JAX package's
    estimator to 1e-6 px, its draws injected."""
    from event_based_optical_flow_tpu import streaming as JS
    from event_based_optical_flow_tpu_torch import streaming as TS
    from test_torch_streaming import H as SH, N_FIX, OPTIMIZER as SOPT, SOLVER as SSLV, W as SW, WINDOWS

    slv = dict(SSLV, outer_padding=2, iwe_backend="matmul")
    jest = JS.StreamingFlowEstimator((SH, SW), solver_config=slv, optimizer_config=SOPT, fixed_event_count=N_FIX)
    test = TS.StreamingFlowEstimator((SH, SW), solver_config=slv, optimizer_config=SOPT, fixed_event_count=N_FIX,
                                     device="cpu")
    test._solver.candidates_fn = JaxDraws()
    for ev in WINDOWS[:2]:
        np.testing.assert_allclose(test.push(ev), jest.push(ev), rtol=0, atol=1e-6)
    assert set(test._solver.last_frame_stats["hvp"].values()) == {"exact"}


@pytest.mark.parametrize("case", ["pad", "polarity", "pad-count"])
def test_global_solver_matches_jax(case):
    """The global motion-model solver (4-param-similarity, the sweep, then
    Newton with the exact HVP) on the unfused objective: JAX's parameters
    to 1e-6 and its metrics (padded FWL images, cropped mask)."""
    from test_torch_global import METHOD, _configs, _scene

    pad, method = CASES[case]
    ev, gt, dt, calib = _scene("rot", omega=0.8)
    ev[:, 3] = np.where(np.random.default_rng(6).random(len(ev)) < 0.5, 1.0, -1.0)
    slv, opt = _configs("4-param-similarity")
    slv.update(outer_padding=pad, iwe=dict(slv["iwe"], method=method), iwe_backend="matmul")
    sj = jsolver.collections[METHOD]((48, 56), calib, slv, opt, {}, None)
    st = tsolver.collections[METHOD]((48, 56), calib, slv, opt, {}, device="cpu")
    bj, bt = sj.optimize(ev), st.optimize(ev)
    assert st.last_frame_stats["hvp"][0] == "exact"
    np.testing.assert_allclose(bt, bj, rtol=0, atol=1e-6)
    ej, et = sj.calculate_flow_error(bj, gt, dt, ev), st.calculate_flow_error(bt, gt, dt, ev)
    for k in ("EPE", "AE", "GT_FWL", "PRED_FWL"):
        assert et[k] == pytest.approx(ej[k], rel=1e-6, abs=1e-9), k


# the count vote runs the loop: on the chain's batched sweep of this scene
# three round-1 candidates of one patch give the same count image up to a
# whole-pixel move, so their losses tie to the last bits (JAX ...0619,
# ...0615, ...0615; the port ...0618 three times) and the two argmins take
# different ones; from the same starts both packages' lockstep Newton
# solves agree to 1e-15
FLEET_CASES = {"pad": ("pad", {}), "polarity-chain": ("polarity", {"chain": True}),
               "pad-ta": ("pad", {"time_aware": True}), "count": ("pad-count", {})}


@pytest.mark.parametrize("name", sorted(FLEET_CASES))
def test_fleet_matches_jax(name):
    """The fleet (batches of 2 frames through one lockstep Newton per
    scale, the exact HVP) on the unfused objective: the loop and the chain
    against the JAX package's per-scale motions to 1e-6 (the chain with
    JAX's fleet-chain draws); a time-aware batch with the voxel map's
    curvature."""
    from test_torch_fleet import FLEET_OPTIMIZER, FLEET_SOLVER, SH, SW, T_BINS
    from test_torch_fleet_chain import ChainDraws
    from event_based_optical_flow_tpu_torch.solver import fleet as TF

    case, extra = FLEET_CASES[name]
    pad, method = CASES[case]
    slv = dict(FLEET_SOLVER, outer_padding=pad, iwe=dict(FLEET_SOLVER["iwe"], method=method), iwe_backend="matmul")
    opt = dict(FLEET_OPTIMIZER, chain=bool(extra.get("chain")))
    if extra.get("time_aware"):
        slv.update(time_aware=True, time_bin=T_BINS, flow_interpolation="burgers", t0_flow_location="middle")
    loader = SyntheticDataLoader({"height": SH, "width": SW, "duration": 1.0, "event_rate": 12000, "n_frames": 4,
                                  "pattern": "dots", "n_dots": 60, "flow_max": 12.0})
    loader.set_sequence("fleet")
    ts = loader.eval_frame_time_list()
    windows = []
    for i in (0, 1):  # the fleet tests' windows, a third of their events, polarities of both signs
        ev = loader.load_event(loader.time_to_index(ts[i]), loader.time_to_index(ts[i + 1]))[::3].copy()
        ev[:, 2] -= ev[:, 2].min()
        ev[:, 3] = np.where(np.random.default_rng(i).random(len(ev)) < 0.5, 1.0, -1.0)
        windows.append(ev)
    sj = jsolver.collections[slv["method"]]((SH, SW), {}, slv, opt, {}, None)
    draws = ChainDraws(len(windows)) if opt["chain"] else JaxDraws()
    st = TF.FleetPyramidalSolver((SH, SW), {}, slv, opt, {}, device="cpu", candidates_fn=draws)
    bj, bt = sj.optimize_batch(windows), st.optimize_batch(windows)
    for fj, ft in zip(bj, bt):
        for s in fj:
            np.testing.assert_allclose(ft[s].numpy(), fj[s], rtol=0, atol=1e-6)
    assert set(st.last_batch_stats["hvp"].values()) == {"exact"}


def _config(**slv):
    return {"data": {"dataset": "synthetic", "sequence": "s", "height": H, "width": W, "n_events_per_batch": 1000},
            "output": {"output_dir": "out", "show_interactive_result": False},
            "solver": dict(SOLVER, **slv), "optimizer": dict(OPTIMIZER)}


@pytest.mark.parametrize("method", ["pyramidal_patch_contrast_maximization", "mixed_patch_contrast_maximization",
                                    "global_contrast_maximization", "fleet_pyramidal_patch_contrast_maximization",
                                    "time_aware_mixed_patch_contrast_maximization"])
def test_schema_takes_the_options(method):
    """Every solver takes the options, as the JAX schema does; a method
    outside the three is refused."""
    extra = {"cost": "multi_focal_normalized_gradient_magnitude"} if method.startswith("global") else {}
    if method.startswith("time_aware"):
        extra = {"time_aware": True, "flow_interpolation": "burgers", "t0_flow_location": "middle"}
    for case in CASES:
        assert validate_config(_config(**_solver_config(case, method=method, **extra))) == []
    with pytest.raises(ConfigError, match="solver.iwe.method"):
        validate_config(_config(**dict(_solver_config("pad", method=method, **extra), iwe={"method": "sum",
                                                                                          "blur_sigma": 1})))


@pytest.mark.parametrize("value", [-1, 1.5, "2"])
def test_schema_refuses_bad_padding(value):
    with pytest.raises(ConfigError, match="outer_padding"):
        validate_config(_config(outer_padding=value))


def test_griddata_scheme_raises_in_jax_and_is_refused_with_a_true_message(scene):
    """A time-aware griddata scheme: the JAX package's objective hands its
    traced flow to scipy (``flow/voxel.py``) and raises; the port's schema
    refuses it and says so."""
    events = scene[0]
    slv = dict(SOLVER, method="time_aware_mixed_patch_contrast_maximization", time_aware=True,
               flow_interpolation="nearest", t0_flow_location="middle", time_bin=3, iwe_backend="matmul",
               patch={"initialize": "zero", "size": [16, 20], "sliding_window": [16, 20], "filter_type": "bilinear"})
    sj = jsolver.collections[slv["method"]]((H, W), {}, slv, OPTIMIZER, {}, None)
    with pytest.raises(jax.errors.TracerArrayConversionError):
        sj.optimize(events)
    with pytest.raises(ConfigError, match="griddata scheme, which the JAX package cannot solve either"):
        validate_config(_config(**slv))
