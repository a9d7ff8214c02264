"""The port's cold-start initializations ``grid-best``, ``global-best`` and
``optuna-sampling`` against the JAX package's, at float64 on the CPU.

* The sweep: the objective at every shared translation of the 10 x 10
  (``grid-best``, step 30) and 30 x 30 (``global-best``, step 10) grids,
  in chunks of 1, 64 and 100 candidates through the batched objective,
  against the JAX package's sweep (its matmul objective, vmapped) to 1e-9
  x the largest loss; the chosen translation is JAX's
  (``_grid_best_translation``), on the single-scale tile solver and on the
  pyramid's coarsest scale.
* The solves: the single-scale tile solver and the pyramid's loop with each
  init against the JAX package (``iwe_backend: pallas``, interpret mode,
  JAX's sweep draws injected): the start to 1e-9 and the motions to 1e-6;
  the pyramid's chain gives its loop's bits.  These solves keep the TV
  term: a tiled translation is a uniform motion, where the TV's
  ``|Sobel|`` sits at 0, and the port takes JAX's derivative of ``|0|``
  there, +1 (``test_tv_gradient_at_uniform_motion``).
* The fleet keeps the JAX package's rule: any init but ``zero`` is the
  random draw.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_based_optical_flow_tpu import solver as jsolver
from event_based_optical_flow_tpu.data.synthetic import SyntheticDataLoader
from event_based_optical_flow_tpu.solver import objective as JO
from event_based_optical_flow_tpu_torch import solver as tsolver
from event_based_optical_flow_tpu_torch.solver import patch_base
from event_based_optical_flow_tpu_torch.solver.objective import FrameEvents, build_orig_iwe

from test_torch_pyramid import OPTIMIZER, SOLVER, H, W, JaxDraws, _record

MIXED = dict(SOLVER, method="mixed_patch_contrast_maximization",
             patch={"initialize": "random", "size": [16, 20], "sliding_window": [16, 20], "filter_type": "bilinear"})
STEPS = {"grid-best": 30, "global-best": 10}
NO_TV = {"cost": "multi_focal_normalized_gradient_magnitude"}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def events():
    """One eval window of the pyramid tests' dots scene, thinned to ~500
    events: the JAX sweep vmaps its dense matmul vote over every
    candidate."""
    loader = SyntheticDataLoader({"height": H, "width": W, "duration": 1.0, "event_rate": 12000,
                                  "n_frames": 4, "pattern": "dots", "n_dots": 60, "flow_max": 12.0})
    loader.set_sequence("pyramid")
    ts = loader.eval_frame_time_list()
    ev = loader.load_event(loader.time_to_index(ts[1]), loader.time_to_index(ts[2]))
    ev[:, 2] -= ev[:, 2].min()
    return np.ascontiguousarray(ev[::6])


def _pair(slv, opt, **kw):
    sj = jsolver.collections[slv["method"]]((H, W), {}, slv, opt, {}, None)
    st = tsolver.collections[slv["method"]]((H, W), {}, slv, opt, {}, device="cpu", **kw)
    return sj, st


def _jax_sweep(sj, events, step):
    """The JAX package's sweep losses (``_grid_best_translation``'s body)."""
    spec = dataclasses.replace(sj._current_spec(), iwe_backend="matmul")
    obj = JO.build_objective(spec)
    ev, w = sj.prepare_events(events)
    grid = patch_base.grid_translations(step)
    tiles = np.repeat(grid[:, :, None], sj.n_patch, axis=2).reshape(len(grid), -1)
    return np.asarray(jax.jit(jax.vmap(lambda x: obj(x, ev, w)[0]))(jnp.asarray(tiles)))


@pytest.mark.parametrize("solver", ["mixed", "pyramid"])
@pytest.mark.parametrize("init", sorted(STEPS))
def test_sweep_matches_jax(events, init, solver):
    step = STEPS[init]
    slv = MIXED if solver == "mixed" else SOLVER
    sj, st = _pair(slv, OPTIMIZER)
    if solver == "pyramid":
        sj.overload_patch_configuration(sj.coarsest_scale)
        st.overload_patch_configuration(st.coarsest_scale)
    want = _jax_sweep(sj, events, step)
    assert len(want) == {"grid-best": 100, "global-best": 900}[init]
    spec = st._current_spec()
    frame = FrameEvents.from_numpy(events, "cpu", torch.float64)
    orig = build_orig_iwe(spec)(frame)
    grid = patch_base.grid_translations(step)
    tiles = st.tensor(np.repeat(grid[:, :, None], st.n_patch, axis=2).reshape(len(grid), -1))
    scale = np.abs(want).max()
    for chunk in (1, 64, patch_base.GRID_SWEEP_CHUNK):
        got = patch_base.grid_sweep_losses(spec, frame, orig, tiles, chunk=chunk).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * scale, err_msg=f"chunk {chunk}")
    chosen = st._grid_best_translation(frame, orig, step)
    np.testing.assert_array_equal(chosen, sj._grid_best_translation(events, step))
    np.testing.assert_array_equal(chosen, grid[int(np.nanargmin(want))])


@pytest.mark.parametrize("init", ["grid-best", "global-best", "optuna-sampling"])
def test_mixed_solver_init_matches_jax(events, init):
    """The single-scale tile solver from each init: JAX's start (the tiled
    translation, or the per-patch sweep from zero with JAX's draws) and
    JAX's solve to 1e-6."""
    slv = dict(MIXED, patch=dict(MIXED["patch"], initialize=init))
    opt = dict(OPTIMIZER, max_iter=2)
    sj, st = _pair(slv, opt, candidates_fn=JaxDraws())
    starts_j, starts_t = [], []
    _record(sj, ["_initial_motion"], starts_j, np.asarray)
    _record(st, ["initialize_from_init"], starts_t, lambda out: out.numpy().copy())
    bj, bt = sj.optimize(events), st.optimize(events)
    assert len(starts_j) == len(starts_t) == 1
    np.testing.assert_allclose(starts_t[0].reshape(-1), starts_j[0].reshape(-1), rtol=0, atol=1e-9)
    if init != "optuna-sampling":  # one translation over every tile
        assert np.all(starts_t[0] == starts_t[0][:, :1])
    np.testing.assert_allclose(bt.numpy(), bj, rtol=0, atol=1e-6)


@pytest.mark.parametrize("init", ["grid-best", "global-best", "optuna-sampling"])
def test_pyramid_init_matches_jax_and_the_chain_the_loop(events, init):
    """The pyramid's loop from each init at its coarsest scale, JAX's draws
    injected: the coarsest start and every scale's motion to 1e-6; the
    chained frame gives the loop's bits."""
    from test_torch_chain import _same_solve, _solve

    slv = dict(SOLVER, patch=dict(SOLVER["patch"], initialize=init))
    sj, st = _pair(slv, OPTIMIZER, candidates_fn=JaxDraws())
    starts_j, starts_t = [], []
    _record(sj, ["_init_scale"], starts_j, np.asarray)
    _record(st, ["initialize_from_init"], starts_t, lambda out: out.numpy().copy())
    bj, bt = sj.optimize(events), st.optimize(events)
    assert len(starts_j) == len(starts_t) == 1  # the coarsest scale's
    np.testing.assert_allclose(starts_t[0].reshape(-1), starts_j[0].reshape(-1), rtol=0, atol=1e-9)
    for s in bj:
        np.testing.assert_allclose(bt[s].numpy(), bj[s], rtol=0, atol=1e-6)
    loop = _solve(slv, OPTIMIZER, events, candidates_fn=JaxDraws())
    chained = _solve(slv, dict(OPTIMIZER, chain=True), events, candidates_fn=JaxDraws())
    assert chained[3]["chain"] and not loop[3]["chain"]
    _same_solve(chained, loop)


@pytest.mark.parametrize("init", ["grid-best", "zero"])
def test_fleet_keeps_jax_init_rule(init):
    """The fleet's cold start: zeros for ``zero``, the random draw (the
    sequential solver's, from the same generator) for anything else."""
    from test_torch_fleet import FLEET_OPTIMIZER, FLEET_SOLVER, SH, SW
    from event_based_optical_flow_tpu_torch.solver import fleet as TF

    slv = dict(FLEET_SOLVER, patch=dict(FLEET_SOLVER["patch"], initialize=init))
    st = TF.FleetPyramidalSolver((SH, SW), {}, slv, FLEET_OPTIMIZER, {}, device="cpu")
    seq = tsolver.collections[SOLVER["method"]]((SH, SW), {}, dict(SOLVER, patch=dict(SOLVER["patch"])),
                                                FLEET_OPTIMIZER, {}, device="cpu")
    got = st._init_scale(st.coarsest_scale, None)
    want = seq.initialize_zeros() if init == "zero" else seq.initialize_random()
    assert torch.equal(got, want)


def test_tv_gradient_at_uniform_motion(events):
    """At a tiled translation every Sobel tap of the TV term is 0, where
    JAX differentiates ``|0|`` as +1 (``torch.abs`` would take 0): the
    port's TV takes JAX's derivative, so the hybrid objective's gradient
    agrees to 1e-15 there, with and without TV, and off the lattice of
    uniform motions."""
    from event_based_optical_flow_tpu.solver import objective as JO
    from event_based_optical_flow_tpu_torch.solver.objective import build_objective

    diffs = {}
    for name, slv in (("hybrid", MIXED), ("no-tv", dict(MIXED, **NO_TV))):
        sj, st = _pair(slv, OPTIMIZER)
        spec = dataclasses.replace(sj._current_spec(), iwe_backend="scatter")
        ev, w = sj.prepare_events(events)
        tspec = st._current_spec()
        frame = FrameEvents.from_numpy(events, "cpu", torch.float64)
        orig = build_orig_iwe(tspec)(frame)
        for start in ("uniform", "varied"):
            x = np.repeat(np.array([[-30.0], [0.0]]), st.n_patch, axis=1).reshape(-1)
            if start == "varied":
                x = x + np.linspace(0.1, 0.9, x.size)
            gj = np.asarray(jax.grad(lambda m: JO.build_objective(spec)(m, ev, w)[0])(jnp.asarray(x)))
            xt = torch.as_tensor(x).requires_grad_(True)
            (gt,) = torch.autograd.grad(build_objective(tspec)(xt, orig, frame)[0], xt)
            diffs[name, start] = np.abs(gj - gt.numpy()).max()
    assert diffs["no-tv", "uniform"] < 1e-15 and diffs["no-tv", "varied"] < 1e-15
    assert diffs["hybrid", "varied"] < 1e-15
    assert diffs["hybrid", "uniform"] < 1e-15  # the TV term's |0|: JAX's +1
