"""The port's fleet path against the JAX package's (``solver/fleet.py``,
its per-scale loop: ``optimizer.chain: false``), in float64, JAX's
Pallas kernels in interpret mode (``iwe_backend: pallas``).

* The batched objective (losses and gradient) and the staged batched HVP
  (dense Gauss-Newton and full; time-aware Gauss-Newton) against
  ``build_batched_objective_banded`` / ``build_batched_objective_banded_hvp``
  on a ``pack_fleet_banded`` fleet: 1e-9 x the largest value (float64 sums
  of the same terms in another order).
* The lockstep Newton-CG against ``build_newton_cg_batched`` from the same
  ``x0``: smooth test functions to 1e-9 (one frame arms the escape probe,
  the other does not; the analytic mode with its step clip and FD polish),
  the CMax batched objective to 1e-6 (the piecewise objective amplifies
  last-bit differences through the FD HVP, ``tests/test_torch_newton_cg.py``).
* ``optimize_batch`` against the JAX package's with its init-sweep draws
  injected (``candidates_fn``): per scale and per frame to 1e-6 (Newton
  budgets of 2 iterations, as ``tests/test_torch_pyramid.py``), dense FD,
  dense analytic with the coarse-scale subsample, time-aware Gauss-Newton.
* The CLI's fleet eval against ``main.evaluate_dataset_fleet`` on a tiny
  config (5 frames in chunks of 2): metrics to 1e-6, a rerun adds no line;
  what the port leaves out of the fleet is refused up front, and
  ``warm_start: batch`` is accepted.

The fleet chain (``optimizer.chain``, the default) draws differently from
this loop: it is held against the JAX package's chain in
``tests/test_torch_fleet_chain.py``.
"""

import copy
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import main as jax_cli
from event_based_optical_flow_tpu import data as jdata
from event_based_optical_flow_tpu import solver as jsolver
from event_based_optical_flow_tpu import visualizer
from event_based_optical_flow_tpu.solver import fleet as JF
from event_based_optical_flow_tpu.solver import objective as JO
from event_based_optical_flow_tpu_torch import main as port_cli
from event_based_optical_flow_tpu_torch.solver import fleet as TF
from event_based_optical_flow_tpu_torch.solver import objective as TO
from event_based_optical_flow_tpu_torch.utils import ConfigError, validate_config
from test_torch_newton_cg import plateau, rosenbrock
from test_torch_pyramid import JaxDraws, _record

RTOL = 1e-9  # x the largest value
T_BINS = 3


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(got, want, least=1e-3):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale >= least
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * scale)


# --- the batched objective and HVP ------------------------------------------

H, W = 24, 32


def _fleet_problem(time_aware=False, n_frames=2):
    """Frames of ~2 000 events of a dots scene, each frame moving with its
    own velocity; the objective's spec on both sides; tile motions."""
    rng = np.random.default_rng(7)
    events = []
    for b in range(n_frames):
        n = 2600
        dots = np.stack([rng.uniform(2, H - 2, 40), rng.uniform(2, W - 2, 40)], 1)
        idx = rng.integers(0, 40, n)
        tt = np.sort(rng.uniform(0, 0.4, n))
        vel = rng.uniform(-10, 10, 2)
        x = np.round(dots[idx, 0] + rng.normal(0, 0.2, n) - tt * vel[0])
        y = np.round(dots[idx, 1] + rng.normal(0, 0.2, n) - tt * vel[1])
        ok = (x >= 0) & (x < H - 1) & (y >= 0) & (y < W - 1)
        events.append(np.stack([x, y, tt, rng.integers(0, 2, n)], 1)[ok])
    cww = (("multi_focal_normalized_gradient_magnitude", 1.0), ("total_variation", 0.01))
    geom = dict(patch_image_size=(4, 4), patch_size=(5, 7), sliding_window=(5, 7), patch_shift=(2, 2))
    jspec = JO.ObjectiveSpec(image_shape=(H, W), outer_padding=0, filter_type="bilinear",
                             iwe_method="bilinear_vote", blur_sigma=1, cost_name="hybrid",
                             cost_with_weight=cww, iwe_backend="pallas", **geom)
    tspec = TO.ObjectiveSpec(image_shape=(H, W), filter_type="bilinear", blur_sigma=1, cost_name="hybrid",
                             cost_with_weight=cww, **geom)
    if time_aware:
        ta = dict(time_aware=True, time_bin=T_BINS, flow_interpolation="burgers", t0_location="middle")
        jspec, tspec = dataclasses.replace(jspec, **ta), dataclasses.replace(tspec, **ta)
    packed = JF.pack_fleet_banded(events, H, time_bin=T_BINS if time_aware else 0,
                                  image_width=0 if time_aware else W)
    jargs = tuple(jnp.asarray(a) for a in packed)
    fleet = TO.FleetEvents.from_numpy(events, "cpu", torch.float64, T_BINS if time_aware else None)
    motion = rng.uniform(-15, 15, (n_frames, 32))
    p = rng.normal(0, 1, motion.shape)
    return events, jspec, tspec, jargs, fleet, motion, p


@pytest.mark.parametrize("time_aware", [False, True])
def test_batched_objective_matches_jax(time_aware):
    """Orig IWEs, losses [B] and the gradient of their sum against the JAX
    fleet objective; each frame's loss is the single-frame objective's."""
    events, jspec, tspec, jargs, fleet, motion, _ = _fleet_problem(time_aware)
    jorig = JF.build_orig_iwe_banded_batched(jspec)(*jargs)
    jobj = JF.build_batched_objective_banded(jspec, precomputed_orig=True)
    m = jnp.asarray(motion)
    lj = np.asarray(jobj(m, jorig, *jargs))
    gj = np.asarray(jax.grad(lambda q: jnp.sum(jobj(q, jorig, *jargs)))(m))

    torig = TF.build_orig_iwe_batched(tspec)(fleet)
    _close(torig, jorig)
    mt = torch.as_tensor(motion).requires_grad_(True)
    losses = TF.build_batched_objective(tspec)(mt, torig, fleet)
    (gt,) = torch.autograd.grad(losses.sum(), mt)
    np.testing.assert_allclose(losses.detach().numpy(), lj, rtol=1e-12)
    _close(gt, gj, least=1e-2)
    single = TO.build_objective(tspec)
    for b in range(len(events)):
        frame = fleet.frame(b)
        alone = single(torch.as_tensor(motion[b]), TO.build_orig_iwe(tspec)(frame), frame)[0]
        assert losses[b].item() == pytest.approx(alone.item(), rel=1e-12)


@pytest.mark.parametrize("time_aware,gauss_newton", [(False, True), (False, False), (True, True)])
def test_batched_staged_hvp_matches_jax(time_aware, gauss_newton):
    """The staged batched HVP (the batched K1 values, K3 tangent and K4
    backward, each frame's cost jvp-of-grad, the flow map's transpose;
    the Burgers chain's jvp/vjp when time-aware) against
    ``build_batched_objective_banded_hvp(staged=True)``."""
    _, jspec, tspec, jargs, fleet, motion, p = _fleet_problem(time_aware)
    jorig = JF.build_orig_iwe_banded_batched(jspec)(*jargs)
    prep, hvp = JF.build_batched_objective_banded_hvp(jspec, precomputed_orig=True, gauss_newton=gauss_newton,
                                                      staged=True)
    m, pj = jnp.asarray(motion), jnp.asarray(p)
    want = hvp(prep(m, jorig, *jargs), m, pj, jorig, *jargs)
    torig = TF.build_orig_iwe_batched(tspec)(fleet)
    tprep, thvp = TF.build_batched_objective_hvp_staged(tspec, gauss_newton)
    mt, pt = torch.as_tensor(motion), torch.as_tensor(p)
    _close(thvp(tprep(mt, torig, fleet), mt, pt, torig, fleet), want)


# --- the lockstep Newton-CG --------------------------------------------------


def _pair(lib):
    """A batch of two frames: frame 0 starts on the plateau's flat, concave
    outskirts (it arms the escape probe), frame 1 on Rosenbrock (it does
    not)."""
    return lambda x: lib.stack([plateau(x[0], lib), rosenbrock(x[1], lib)])


X0_PAIR = np.array([[-2.0, -1.0], [-1.2, 1.0]])


def test_lockstep_newton_matches_jax_with_escape_probe(monkeypatch):
    escapes = []
    orig = TF.BatchedNewtonCG._escape_probe
    monkeypatch.setattr(TF.BatchedNewtonCG, "_escape_probe",
                        lambda self, *a: escapes.append(1) or orig(self, *a))
    kw = dict(maxiter=40, cg_maxiter=20)
    jx, jf, jk = jax.jit(JF.build_newton_cg_batched(lambda x: _pair(jnp)(x), **kw))(jnp.asarray(X0_PAIR))
    solve = TF.BatchedNewtonCG(_pair(torch), **kw)
    tx, tf, tk = solve(torch.as_tensor(X0_PAIR))
    assert tk == int(jk)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-9)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-9, atol=1e-12)
    assert escapes, "the plateau frame must arm the escape probe"
    np.testing.assert_allclose(tx[1].numpy(), [1.0, 1.0], atol=1e-4)
    assert solve.syncs > tk
    # Rosenbrock alone never arms it
    escapes.clear()
    TF.BatchedNewtonCG(lambda x: rosenbrock(x[0], torch)[None], **kw)(torch.as_tensor(X0_PAIR[1:]))
    assert not escapes


@pytest.mark.parametrize("polish", [0, 2])
def test_lockstep_analytic_newton_and_fd_polish_match_jax(polish):
    """The analytic mode (the same exact batched HVP on both sides) with
    the per-component step clip, then ``fd_polish`` central-FD lockstep
    iterations, counted in the iterations."""
    cap = 0.3
    jh = lambda x, d: jax.jvp(jax.grad(lambda z: jnp.sum(_pair(jnp)(z))), (x,), (d,))[1]  # noqa: E731
    th = lambda x, d: torch.func.jvp(torch.func.grad(lambda z: _pair(torch)(z).sum()), (x,), (d,))[1]  # noqa: E731
    kw = dict(maxiter=6, cg_maxiter=8, max_step=cap, fd_polish=polish)
    jx, jf, jk = jax.jit(JF.build_newton_cg_batched(lambda x: _pair(jnp)(x), hvp_fn=jh, **kw))(
        jnp.asarray(X0_PAIR))
    tx, tf, tk = TF.BatchedNewtonCG(_pair(torch), hvp_mode="analytic", hvp_fn=th, **kw)(torch.as_tensor(X0_PAIR))
    assert tk == int(jk)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-9)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-9, atol=1e-12)
    if polish:
        unpolished = TF.BatchedNewtonCG(_pair(torch), hvp_mode="analytic", hvp_fn=th, **dict(kw, fd_polish=0))
        assert 0 < tk - unpolished(torch.as_tensor(X0_PAIR))[2] <= polish


def test_lockstep_newton_on_cmax_objective_matches_jax():
    """The batched CMax objective, central-FD HVP, 3 lockstep iterations:
    iterates to 1e-6."""
    _, jspec, tspec, jargs, fleet, motion, _ = _fleet_problem(n_frames=3)
    jorig = JF.build_orig_iwe_banded_batched(jspec)(*jargs)
    jobj = JF.build_batched_objective_banded(jspec, precomputed_orig=True)
    jx, jf, jk = jax.jit(JF.build_newton_cg_batched(jobj, maxiter=3, cg_maxiter=6))(jnp.asarray(motion), jorig,
                                                                                     *jargs)
    torig = TF.build_orig_iwe_batched(tspec)(fleet)
    tx, tf, tk = TF.BatchedNewtonCG(TF.build_batched_objective(tspec), maxiter=3, cg_maxiter=6)(
        torch.as_tensor(motion), torig, fleet)
    assert tk == int(jk) == 3
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-9)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-6)


def test_lockstep_newton_needs_its_hvp():
    with pytest.raises(ValueError):
        TF.BatchedNewtonCG(lambda x: x.sum(-1), hvp_mode="analytic")
    with pytest.raises(ValueError):
        TF.BatchedNewtonCG(lambda x: x.sum(-1), hvp_mode="autodiff")


# --- optimize_batch -----------------------------------------------------------

SH, SW = 32, 40
FLEET_SOLVER = {
    "method": "fleet_pyramidal_patch_contrast_maximization", "time_aware": False,
    "patch": {"initialize": "random", "scale": 3, "crop_height": 32, "crop_width": 40, "filter_type": "bilinear"},
    "motion_model": "2d-translation", "warp_direction": "first", "parameters": ["trans_x", "trans_y"],
    "cost": "hybrid", "outer_padding": 0,
    "cost_with_weight": {"multi_focal_normalized_gradient_magnitude": 1.0, "total_variation": 0.01},
    "iwe": {"method": "bilinear_vote", "blur_sigma": 1},
    "iwe_backend": "pallas", "precision": "64",
}
FLEET_OPTIMIZER = {"n_iter": 8, "method": "Newton-CG", "max_iter": 2, "cg_maxiter": 6, "chain": False,
                   "parameters": {"trans_x": {"min": -20, "max": 20}, "trans_y": {"min": -20, "max": 20}}}


@pytest.fixture(scope="module")
def windows():
    """The optimization windows of eval frames 0 and 1 of a small dots
    scene (~3 000 events each)."""
    loader = jdata.collections["synthetic"]({"height": SH, "width": SW, "duration": 1.0, "event_rate": 12000,
                                             "n_frames": 4, "pattern": "dots", "n_dots": 60, "flow_max": 12.0})
    loader.set_sequence("fleet")
    ts = loader.eval_frame_time_list()
    out = []
    for i in (0, 1):
        ev = loader.load_event(loader.time_to_index(ts[i]), loader.time_to_index(ts[i + 1]))
        ev[:, 2] -= ev[:, 2].min()
        out.append(ev)
    return out


@pytest.mark.parametrize("case", ["dense-fd", "dense-analytic-subsample", "time-aware-gn"])
def test_optimize_batch_matches_jax(windows, case):
    slv, opt = dict(FLEET_SOLVER), dict(FLEET_OPTIMIZER)
    if case == "dense-analytic-subsample":
        opt.update(hvp_mode="analytic", fd_polish=2, cg_maxiter=8, coarse_event_fraction=0.25)
        assert all(len(e) > 4 * 512 for e in windows)  # the stride-4 subsample engages
    if case == "time-aware-gn":
        slv.update(time_aware=True, time_bin=T_BINS, flow_interpolation="burgers", t0_flow_location="middle")
        opt.update(hvp_mode="analytic")
    sj = jsolver.collections[slv["method"]]((SH, SW), {}, slv, opt, {}, None)
    st = TF.FleetPyramidalSolver((SH, SW), {}, slv, opt, {}, device="cpu", candidates_fn=JaxDraws())
    got_j, got_t = [], []
    get = sj._get_fleet_solver

    def recording(*a, **k):
        solve = get(*a, **k)

        def run(*args):
            out = solve(*args)
            got_j.append(np.asarray(out[0]))
            return out

        return run

    sj._get_fleet_solver = recording
    _record(st, ["_run_fleet_newton"], got_t, lambda out: out[0].numpy().copy())
    bj = sj.optimize_batch(windows)
    bt = st.optimize_batch(windows)
    assert len(got_j) == len(got_t) == 2  # scales 1 and 2, both frames at once
    for a, b in zip(got_j, got_t):
        assert a.shape == b.shape == (2, a.shape[1])
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    for fj, ft in zip(bj, bt):
        for s in fj:
            np.testing.assert_allclose(ft[s].numpy(), fj[s], rtol=0, atol=1e-6)
    stats = st.last_batch_stats
    finest = {"dense-fd": "fd", "dense-analytic-subsample": "analytic-gn", "time-aware-gn": "analytic-gn"}[case]
    assert stats["hvp"] == {1: "fd", 2: finest} and stats["syncs"] > 0
    if case == "dense-analytic-subsample":
        assert stats["events"] == {1: [len(e[::4]) for e in windows], 2: [len(e) for e in windows]}
        assert stats["iters"][2] > opt["max_iter"]  # the polish iterations are counted


# --- the CLI's fleet eval -------------------------------------------------------


def _cli_config(out_dir) -> dict:
    from test_torch_cli import _config

    config = _config(out_dir)
    config["data"].update(n_frames=6, fleet_batch=2, warm_start=False)
    config["solver"]["method"] = "fleet_pyramidal_patch_contrast_maximization"
    config["optimizer"]["chain"] = False
    return config


def _metrics(out_dir):
    with open(os.path.join(out_dir, "eval_metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_fleet_eval_matches_jax_cli_and_rerun_adds_nothing(tmp_path):
    """5 eval frames in chunks of 2 (the last chunk holds one frame): the
    port's per-frame metrics against ``main.evaluate_dataset_fleet`` with
    JAX's draws injected; a rerun resumes at the end and adds no line."""
    jcfg, tcfg = _cli_config(tmp_path / "jax"), _cli_config(tmp_path / "port")
    os.makedirs(tmp_path / "jax")
    d = jcfg["data"]
    loader = jdata.collections["synthetic"](config=d)
    loader.set_sequence(d["sequence"])
    viz = visualizer.Visualizer((d["height"], d["width"]), show=False, save=True, save_dir=str(tmp_path / "jax"))
    solv = jsolver.collections[jcfg["solver"]["method"]](
        (d["height"], d["width"]), calibration_parameter=loader.load_calib(), solver_config=jcfg["solver"],
        optimizer_config=jcfg["optimizer"], output_config=jcfg["output"], visualize_module=viz)
    jax_cli.evaluate_dataset_fleet(loader.eval_frame_time_list(), d, loader, solv, 2)

    records = port_cli.run(tcfg, eval_mode=True, device=torch.device("cpu"), candidates_fn=JaxDraws())
    assert [r["frame"] for r in records] == [0, 1, 2, 3, 4]
    assert records[0]["stats"] is records[1]["stats"] and records[0]["stats"] is not records[2]["stats"]
    assert all(r["stats"]["syncs"] > 0 and r["seconds"] > 0 for r in records)
    want, got = _metrics(tmp_path / "jax"), _metrics(tmp_path / "port")
    assert [r["frame"] for r in got] == [r["frame"] for r in want] == [0, 1, 2, 3, 4]
    for g, w in zip(got, want):
        for k in ("EPE", "1PE", "3PE", "AE", "GT_FWL", "PRED_FWL"):
            assert g[k] == pytest.approx(w[k], rel=0, abs=1e-6), (g["frame"], k)
    with np.load(tmp_path / "port" / "eval_state.npz") as state:
        assert int(state["__next_frame"]) == 5
    assert port_cli.run(tcfg, eval_mode=True, device=torch.device("cpu")) == []
    assert len(_metrics(tmp_path / "port")) == 5


def test_unported_fleet_options_are_refused(tmp_path):
    """A fleet eval with per-frame warm-start chaining is refused by the CLI
    (the JAX CLI asserts the same); the frame-sharding mesh (``solver.parallel``
    and the top-level ``parallel``), the fleet chain's ``warm_start:
    batch`` and the batched L-BFGS (``device_solver: lbfgs``) validate as in
    the JAX package."""
    from event_based_optical_flow_tpu.utils import validate_config as jax_validate

    config = _cli_config(tmp_path / "out")
    assert validate_config(copy.deepcopy(config)) == []
    assert validate_config({**config, "data": {**config["data"], "warm_start": "batch"}}) == []
    lbfgs = {**config, "optimizer": {**config["optimizer"], "device_solver": "lbfgs"}}
    assert validate_config(copy.deepcopy(lbfgs)) == jax_validate(copy.deepcopy(lbfgs))
    for meshed in ({**config, "solver": {**config["solver"], "parallel": {"data": 2}}},
                   {**config, "parallel": {"data": 2}}):
        assert validate_config(copy.deepcopy(meshed)) == jax_validate(copy.deepcopy(meshed)) == []
    chained = copy.deepcopy(config)
    chained["data"]["warm_start"] = True
    with pytest.raises(ConfigError, match="warm_start: false"):
        port_cli.run(chained, eval_mode=True, device=torch.device("cpu"))
