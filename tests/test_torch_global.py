"""The port's global motion-model solver against the JAX package's
(``solver/global_motion.py``), on the CPU at float64, the JAX package at
``iwe_backend: pallas`` (interpret mode: the fused banded objective and the
central-FD HVP, the TPU route), on small synthetic scenes (48x56 or 32x40
px, a few thousand events).

* The three fields (``flow_from_2d_translation``, ``flow_from_similarity``,
  ``flow_from_rotation``) and ``calib_tuple``, with and without a ``K``, to
  1e-12; the ``Warp`` facade's names, conversions and ``warp_event``.
* The objective's value and gradient for each model against JAX's banded
  objective to 1e-9 (the parameters scaled by ``param_scale``, the rotation
  with the loader's ``K``); the analytic HVP against JAX's staged HVP and
  against ``torch.func.jvp`` of the gradient; the tangent shortcut of
  ``_flow_and_tangent`` against ``torch.func.jvp`` of the map.
* The init sweep's chosen candidate equals JAX's; ``optimize`` per model
  (similarity on the ``rot`` and ``zoom`` scenes, 3-rotation on ``rot3d``)
  to 1e-6, cold and warm, on 2 Newton iterations (1 on the zoom scene; a
  third one on the ``rot`` scene's warm window takes another branch from
  a 2e-7 start difference: the piecewise objective amplifies last-bit
  differences, tests/test_torch_newton_cg.py); the chain (its stage run
  eagerly on the CPU) gives the loop's bits.
* Both shipped global configs through the port's CLI ``--eval`` against the
  JAX CLI per frame to 1e-6 on two frames, their data block cut to 48x56
  px and ~3000-event windows and the Newton budget to 3 iterations (the
  piecewise objective amplifies last-bit differences ~30x per iteration,
  tests/test_torch_newton_cg.py); the checkpoint holds the JAX CLI's
  ``array``, and the port resumes it.
* The solver base's warm start takes a plain motion array as JAX's does;
  a time-aware global solver is refused (a documented deviation).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from event_based_optical_flow_tpu import solver as jsolver
from event_based_optical_flow_tpu.data.synthetic import SyntheticDataLoader
from event_based_optical_flow_tpu.ops import warp as jwarp
from event_based_optical_flow_tpu.solver import objective as JO
from event_based_optical_flow_tpu_torch import main as port_cli
from event_based_optical_flow_tpu_torch import solver as tsolver
from event_based_optical_flow_tpu_torch.ops import warp as twarp
from event_based_optical_flow_tpu_torch.solver import objective as TO
from test_torch_cli import REPO, _jax_eval, _metrics, _text_lines

METHOD = "global_contrast_maximization"
KEYS = {"2d-translation": ["trans_x", "trans_y"], "4-param-similarity": ["trans_x", "trans_y", "rot", "zoom"],
        "3-rotation": ["rot_x", "rot_y", "rot_z"]}
RTOL = 1e-9  # x the largest value
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300))


def _scene(scene: str, h: int = 48, w: int = 56, window: int = 0, **extra):
    """(events of eval window ``window`` with t from 0, GT flow, window
    seconds, calibration) of a dots scene."""
    cfg = {"height": h, "width": w, "duration": 1.0, "event_rate": 12000, "n_frames": 5, "scene": scene,
           "pattern": "dots", "n_dots": 300, **extra}
    loader = SyntheticDataLoader(config=cfg)
    loader.set_sequence("g")
    t1, t2 = loader.eval_frame_time_list()[window : window + 2]
    ev = loader.load_event(loader.time_to_index(t1), loader.time_to_index(t2))
    ev[:, 2] -= ev[:, 2].min()
    return ev, loader.load_optical_flow(t1, t2), t2 - t1, loader.load_calib()


def _configs(model: str, cost="multi_focal_normalized_gradient_magnitude", **opt):
    slv = {"method": METHOD, "motion_model": model, "patch": {"initialize": "zero"}, "cost": cost,
           "outer_padding": 0, "iwe": {"method": "bilinear_vote", "blur_sigma": 1}, "iwe_backend": "pallas",
           "precision": "64", "parameters": KEYS[model]}
    return slv, {"method": "Newton-CG", "max_iter": 2, "n_iter": 12, "chain": False, **opt}


def _solvers(model: str, shape, calib, cost="multi_focal_normalized_gradient_magnitude", **opt):
    slv, opt = _configs(model, cost, **opt)
    return (jsolver.collections[METHOD](shape, calib, slv, opt, {}, None),
            tsolver.collections[METHOD](shape, calib, slv, opt, {}, device=CPU))


# --- the fields, calib_tuple and the facade ---------------------------------

K_ROT = {"K": np.array([[41.0, 0.0, 19.25], [0.0, 37.5, 15.5], [0.0, 0.0, 1.0]])}


@pytest.mark.parametrize("calib", [None, K_ROT], ids=["pinhole", "K"])
@pytest.mark.parametrize("model", ["2d-translation", "4-param-similarity", "3-rotation"])
def test_fields_match_jax(model, calib):
    """Each model's field of a batch ``[2, 3, P]`` of parameters (and
    ``calib_tuple`` with and without ``K``) against JAX's to 1e-12."""
    shape = (30, 40)
    ct = twarp.calib_tuple(shape, calib)
    assert ct == jwarp.calib_tuple(shape, calib)
    motion = np.random.default_rng(2).normal(0.0, 3.0, (2, 3, len(KEYS[model])))
    m = torch.as_tensor(motion)
    if model == "2d-translation":
        got, want = twarp.flow_from_2d_translation(m, shape), jwarp.flow_from_2d_translation(jnp.asarray(motion), shape)
    elif model == "4-param-similarity":
        got, want = twarp.flow_from_similarity(m, shape), jwarp.flow_from_similarity(jnp.asarray(motion), shape)
    else:
        got, want = twarp.flow_from_rotation(m, shape, ct), jwarp.flow_from_rotation(jnp.asarray(motion), shape, ct)
    assert got.shape == (2, 3, 2) + shape and got.dtype == torch.float64
    _close(got.numpy(), want, 1e-12)
    # the grids are built in the motion's dtype
    assert twarp.Warp(shape, calib_param=calib).get_flow_from_motion(m.float(), model).dtype == torch.float32


@pytest.mark.parametrize("model", ["dense-flow", "2d-translation", "rigid-optical-flow", "4-param-similarity",
                                   "3-rotation"])
def test_warp_facade_matches_jax(model):
    shape = (20, 28)
    tw, jw = twarp.Warp(shape, normalize_t=True, calib_param=K_ROT), jwarp.Warp(shape, normalize_t=True,
                                                                                  calib_param=K_ROT)
    keys = jw.get_key_names(model)
    assert tw.get_key_names(model) == keys and tw.get_motion_vector_size(model) == jw.get_motion_vector_size(model)
    params = {k: 0.5 + i for i, k in enumerate(keys)}
    motion = tw.motion_model_to_motion(model, params)
    np.testing.assert_array_equal(motion, np.asarray(jw.motion_model_to_motion(model, params)))
    if model == "dense-flow":
        return
    assert tw.motion_model_from_motion(motion, model) == jw.motion_model_from_motion(motion, model)
    rng = np.random.default_rng(4)
    ev = np.stack([rng.uniform(0, 19, 200), rng.uniform(0, 27, 200), np.sort(rng.uniform(0, 0.2, 200)),
                   rng.integers(0, 2, 200)], 1)
    for direction in ("first", "middle", 0.3):
        got = tw.warp_event(torch.as_tensor(ev), torch.as_tensor(motion), model, direction)
        want = jw.warp_event(jnp.asarray(ev), jnp.asarray(motion), model, direction)
        _close(got.numpy(), want, 1e-12)
    with pytest.raises(ValueError, match="not supported"):
        tw.get_key_names("homography")


# --- the objective, its gradient and HVP -----------------------------------

def _objective_problem(model: str, cost="multi_focal_normalized_gradient_magnitude"):
    """(JAX and port solvers, JAX's banded args, the port's frame, scaled
    parameters, a direction) on a 32x40 rot3d scene with its ``K``."""
    ev, _, _, calib = _scene("rot3d", 32, 40, omega3=[0.3, -0.25, 0.6], n_dots=120)
    sj, st = _solvers(model, (32, 40), calib, cost)
    rng = np.random.default_rng(5)
    motion = rng.normal(0.0, 8.0, len(KEYS[model]))
    return sj, st, sj._banded_newton_args(ev), TO.FrameEvents.from_numpy(ev, CPU, torch.float64), motion, \
        rng.normal(0.0, 1.0, motion.shape)


@pytest.mark.parametrize("model", ["2d-translation", "4-param-similarity", "3-rotation"])
def test_objective_value_and_gradient_match_jax(model):
    sj, st, jargs, frame, motion, _ = _objective_problem(model)
    jspec, tspec = sj._current_spec(), st._current_spec()
    assert tspec.motion_model == jspec.motion_model == model
    np.testing.assert_array_equal(tspec.param_scale, jspec.param_scale)
    assert tspec.calib == jspec.calib
    jorig = JO.build_orig_iwe_banded(jspec)(*jargs)
    lj, gj = jax.value_and_grad(lambda m: JO.build_objective_banded(jspec, precomputed_orig=True)(m, jorig, *jargs)[0])(
        jnp.asarray(motion))
    torig = TO.build_orig_iwe(tspec)(frame)
    m = torch.as_tensor(motion).requires_grad_(True)
    loss = TO.build_objective(tspec)(m, torig, frame)[0]
    (gt,) = torch.autograd.grad(loss, m)
    assert loss.item() == pytest.approx(float(lj), rel=1e-12)
    _close(gt.numpy(), gj)
    assert np.abs(gj).max() > 1e-4
    # the solver's metrics field is the spec's field of the unscaled parameters
    field = TO.motion_to_dense_flow(tspec, torch.as_tensor(motion))
    _close(field.numpy(), st.motion_to_dense_flow(motion * st._param_scale).numpy(), 1e-12)


@pytest.mark.parametrize("model", ["2d-translation", "4-param-similarity", "3-rotation"])
def test_analytic_hvp_matches_jax_and_the_jvp(model):
    """The staged Gauss-Newton HVP against JAX's; the full HVP against
    ``torch.func.jvp`` of the plain objective's gradient; the tangent of
    the field (``_flow_and_tangent``'s map of p) against ``torch.func.jvp``
    of the map, bit for bit up to the sums' order."""
    sj, st, jargs, frame, motion, p = _objective_problem(model)
    jspec, tspec = sj._current_spec(), st._current_spec()
    assert TO.objective_supports_analytic_hvp(tspec, True) and JO.objective_supports_analytic_hvp(jspec, True)
    assert TO.objective_supports_analytic_hvp(tspec, False)
    jorig = JO.build_orig_iwe_banded(jspec)(*jargs)
    prep, hvp = JO.build_objective_banded_hvp_staged(jspec, precomputed_orig=True, gauss_newton=True)
    m, pj = jnp.asarray(motion), jnp.asarray(p)
    want = hvp(prep(m, jorig, *jargs), m, pj, jorig, *jargs)
    torig = TO.build_orig_iwe(tspec)(frame)
    mt, pt = torch.as_tensor(motion), torch.as_tensor(p)
    tprep, thvp = TO.build_objective_hvp_staged(tspec, True)
    _close(thvp(tprep(mt, torig, frame), mt, pt, torig, frame).numpy(), want)

    obj = TO.build_objective(tspec)
    _, oracle = torch.func.jvp(torch.func.grad(lambda x: obj(x, torig, frame)[0]), (mt,), (pt,))
    _close(TO.build_objective_hvp(tspec, gauss_newton=False)(mt, pt, torig, frame).numpy(), oracle.numpy())

    _, dflow, _ = TO._flow_and_tangent(tspec, mt, pt, frame)
    _, jvp = torch.func.jvp(lambda x: TO.flow_of(tspec, x, frame.t_scale), (mt,), (pt,))
    _close(dflow.numpy(), jvp.numpy(), 1e-15)


def test_total_variation_is_refused_on_a_global_model():
    spec = TO.ObjectiveSpec(image_shape=(20, 28), patch_image_size=(1, 1), patch_size=(20, 28),
                            sliding_window=(20, 28), patch_shift=(0, 0), filter_type="bilinear", blur_sigma=1,
                            cost_name="hybrid", motion_model="4-param-similarity",
                            cost_with_weight=(("multi_focal_normalized_gradient_magnitude", 1.0),
                                              ("total_variation", 0.01)))
    with pytest.raises(ValueError, match="total_variation"):
        TO.build_objective(spec)
    slv, opt = _configs("4-param-similarity", "hybrid")
    slv["cost_with_weight"] = dict(spec.cost_with_weight)
    for make in (lambda: tsolver.collections[METHOD]((20, 28), {}, slv, opt, {}, device=CPU),
                 lambda: jsolver.collections[METHOD]((20, 28), {}, slv, opt, {}, None)):
        with pytest.raises(ValueError, match="total_variation"):
            make()


def test_time_aware_global_solver_is_refused():
    """A global solver with ``solver.time_aware`` is refused: the JAX
    package's metrics would score a row of the dense field as the voxel's
    t0 slice (ROADMAP Queue 3, PR 11)."""
    from event_based_optical_flow_tpu_torch.utils import ConfigError

    slv, opt = _configs("3-rotation")
    slv.update(time_aware=True, time_bin=4, flow_interpolation="burgers", t0_flow_location="middle")
    with pytest.raises(ConfigError, match="time_aware"):
        tsolver.collections[METHOD]((20, 28), {}, slv, opt, {}, device=CPU)


# --- the solver ---------------------------------------------------------------

@pytest.mark.parametrize("model,init", [("4-param-similarity", "zero"), ("3-rotation", "random")])
def test_sampling_init_chooses_jax_candidate(model, init):
    """The sweep's candidates scored by the port's objective pick JAX's
    (``jax.vmap`` of its exact objective); a random init draws JAX's."""
    ev, _, _, calib = _scene("rot3d" if model == "3-rotation" else "rot", omega=0.8, omega3=[0.3, -0.25, 0.6])
    sj, st = _solvers(model, (48, 56), calib)
    x0j = sj.initialize_random() if init == "random" else sj.initialize_zeros()
    x0t = st.initialize_random() if init == "random" else st.initialize_zeros()
    np.testing.assert_array_equal(x0t, x0j)
    ev_dev, w_dev = sj.prepare_events(ev)
    want = sj._sampling_init(sj._current_spec(), ev_dev, w_dev, x0j, 12)
    spec = st._current_spec()
    frame = TO.FrameEvents.from_numpy(ev, CPU, torch.float64)
    got = st._sampling_init(spec, frame, TO.build_orig_iwe(spec)(frame), x0t, 12)
    np.testing.assert_array_equal(got, want)
    assert np.any(got != x0t)  # the sweep moved the start


@pytest.mark.parametrize("scene,model,extra,max_iter", [
    ("rot", "4-param-similarity", {"omega": 0.8}, 2),
    # the zoom scene's second iteration from its sweep's start is a branch
    # point: JAX's own result moves by 0.3 px/s when that start moves by
    # 1e-13 (both packages alike), so its parity runs one iteration
    ("zoom", "4-param-similarity", {"zoom_rate": 0.6}, 1),
    ("rot3d", "3-rotation", {"omega3": [0.3, -0.25, 0.6]}, 2),
])
def test_optimize_matches_jax_cold_and_warm(scene, model, extra, max_iter):
    """A cold solve (zero init, the 12-candidate sweep, Newton) and a warm
    one from it on the next window: JAX's parameters to 1e-6, and the
    metrics; the chain's stage (eager on the CPU) gives the loop's bits."""
    ev, gt, dt, calib = _scene(scene, **extra)
    sj, st = _solvers(model, (48, 56), calib, max_iter=max_iter)
    bj, bt = sj.optimize(ev), st.optimize(ev)
    assert isinstance(bt, np.ndarray) and bt.dtype == np.float64 and bt.shape == (len(KEYS[model]),)
    np.testing.assert_allclose(bt, bj, rtol=0, atol=1e-6)
    stats = st.last_frame_stats
    assert stats["iters"][0] >= 1 and stats["hvp"][0] == "fd" and stats["syncs"] > 0 and not stats["chain"]
    ej, et = sj.calculate_flow_error(bj, gt, dt, ev), st.calculate_flow_error(bt, gt, dt, ev)
    for k in ("EPE", "AE", "GT_FWL", "PRED_FWL"):
        assert et[k] == pytest.approx(ej[k], rel=1e-6, abs=1e-9), k
    np.testing.assert_allclose(st.dense_displacement(bt, dt), np.asarray(sj.motion_to_dense_flow(bj)) * dt,
                               rtol=0, atol=1e-5)

    ev2 = _scene(scene, window=1, **extra)[0]
    sj.set_previous_frame_best_estimation(bj)
    st.set_previous_frame_best_estimation(bt)
    wj, wt = sj.optimize(ev2), st.optimize(ev2)
    np.testing.assert_allclose(wt, wj, rtol=0, atol=1e-6)

    # the chain: the stage's closures, the loop's bits
    chained = tsolver.collections[METHOD]((48, 56), calib, st.slv_config, {**st.opt_config, "chain": True},
                                          {}, device=CPU)
    assert np.array_equal(chained.optimize(ev), bt) and chained.last_frame_stats["chain"]
    assert {k: chained.last_frame_stats[k] for k in ("loss", "syncs", "iters", "launches")} == \
        {k: stats[k] for k in ("loss", "syncs", "iters", "launches")}


def test_analytic_hvp_solve_matches_jax():
    """``hvp_mode: analytic`` on the global solver (JAX's
    ``test_global_solver_analytic_hvp_engages``): the analytic HVP engages
    (the finest-scale routing) and the solve gives JAX's parameters."""
    ev, _, _, calib = _scene("rot", omega=0.8)
    sj, st = _solvers("4-param-similarity", (48, 56), calib, hvp_mode="analytic")
    bj, bt = sj.optimize(ev), st.optimize(ev)
    assert st.last_frame_stats["hvp"][0] == "analytic-gn"
    assert not getattr(st, "_warned_analytic_hvp", False) and not getattr(sj, "_warned_analytic_hvp", False)
    np.testing.assert_allclose(bt, bj, rtol=0, atol=1e-6)


def test_array_warm_start():
    """A plain motion array as the warm start (the JAX CLI's for a
    single-scale solver): kept as a float64 host array from a numpy array,
    a tensor or a list, as JAX keeps it; dicts and lists of dicts as
    before."""
    ev, _, _, calib = _scene("rot", omega=0.8)
    sj, st = _solvers("4-param-similarity", (48, 56), calib)
    for prev in (np.array([1.0, -2.0, 0.25, 0.0]), torch.tensor([1.0, -2.0, 0.25, 0.0]), [1.0, -2.0, 0.25, 0.0]):
        st.set_previous_frame_best_estimation(prev)
        sj.set_previous_frame_best_estimation(prev if not torch.is_tensor(prev) else prev.numpy())
        got = st.previous_frame_best_estimation
        assert isinstance(got, np.ndarray) and got.dtype == np.float64
        np.testing.assert_array_equal(got, sj.previous_frame_best_estimation)
    st.set_previous_frame_best_estimation({2: np.zeros((2, 1, 1))})
    assert torch.is_tensor(st.previous_frame_best_estimation[2])
    st.set_previous_frame_best_estimation([None, {1: np.zeros((2, 1, 1))}])
    assert st.previous_frame_best_estimation[0] is None
    # the warm start is the solve's start (no sweep): JAX's result
    st.set_previous_frame_best_estimation(np.array([2.0, -1.0, -0.7, 0.05]))
    sj.set_previous_frame_best_estimation(np.array([2.0, -1.0, -0.7, 0.05]))
    np.testing.assert_allclose(st.optimize(ev), sj.optimize(ev), rtol=0, atol=1e-6)


# --- the shipped configs through the CLIs ----------------------------------

def _shipped(name: str, out_dir) -> dict:
    """A shipped global config, its data block cut to 48x56 px and
    ~3000-event windows (frames 0 and 1), the Newton budget to 3
    iterations, JAX's TPU route and float64; the loader's default focal
    (H + W) / 2 keeps the rotation scene's field of view."""
    config = yaml.safe_load((REPO / "configs" / name).read_text())
    config["data"].update(height=48, width=56, n_dots=130, event_rate=12000, n_events_per_batch=3000, ind1=0,
                          ind2=1, visualize_every=0)
    config["data"].pop("focal", None)
    config["solver"].update(iwe_backend="pallas", precision="64")
    config["optimizer"]["max_iter"] = 3
    config["output"]["output_dir"] = str(out_dir)
    return config


@pytest.mark.parametrize("name", ["synthetic_rotation_global.yaml", "synthetic_rotation3d_global.yaml"])
def test_shipped_config_eval_matches_jax_cli(tmp_path, name):
    _jax_eval(_shipped(name, tmp_path / "jax"))
    records = port_cli.run(_shipped(name, tmp_path / "port"), eval_mode=True, device=CPU)
    assert [r["frame"] for r in records] == [0, 1]
    want, got = _metrics(tmp_path / "jax"), _metrics(tmp_path / "port")
    assert [r["frame"] for r in got] == [r["frame"] for r in want] == [0, 1]
    for g, w in zip(got, want):
        for k in ("EPE", "1PE", "3PE", "AE", "GT_FWL", "PRED_FWL"):
            assert g[k] == pytest.approx(w[k], rel=0, abs=1e-6), (g["frame"], k)
    assert [l.split("::")[0] for l in _text_lines(tmp_path / "port")] == \
        [l.split("::")[0] for l in _text_lines(tmp_path / "jax")]
    assert all(r["stats"]["chain"] and r["stats"]["syncs"] > 0 for r in records)
    with np.load(tmp_path / "jax" / "eval_state.npz") as j, np.load(tmp_path / "port" / "eval_state.npz") as t:
        assert sorted(t.files) == sorted(j.files) == ["__next_frame", "array"]
        np.testing.assert_allclose(t["array"], j["array"], rtol=0, atol=1e-6)
    # a rerun resumes at the end and adds nothing
    assert port_cli.run(_shipped(name, tmp_path / "port"), eval_mode=True, device=CPU) == []
    assert len(_metrics(tmp_path / "port")) == 2


def test_port_resumes_a_jax_global_run(tmp_path):
    """Frame 0 by the JAX CLI; frame 1 resumed from its state file's
    ``array`` by the JAX CLI and by the port: the same metrics."""
    name = "synthetic_rotation_global.yaml"
    first = _shipped(name, tmp_path / "jax")
    first["data"]["ind2"] = 0
    _jax_eval(first)
    os.makedirs(tmp_path / "port")
    for f in ("eval_state.npz", "eval_metrics.jsonl"):
        (tmp_path / "port" / f).write_bytes((tmp_path / "jax" / f).read_bytes())
    _jax_eval(_shipped(name, tmp_path / "jax"))
    records = port_cli.run(_shipped(name, tmp_path / "port"), eval_mode=True, device=CPU)
    assert [r["frame"] for r in records] == [1]
    got, want = _metrics(tmp_path / "port"), _metrics(tmp_path / "jax")
    for k in ("EPE", "AE", "PRED_FWL"):
        assert got[1][k] == pytest.approx(want[1][k], rel=0, abs=1e-6), k


def test_rotation_model_on_an_ecd_fixture_matches_jax(tmp_path):
    """The rotation config's solver on an ECD text fixture of a rotating
    camera (the model's target: ECD's rotation sequences) with its
    ``calib.txt``: the GT-free loop's PRED_FWL and the ``save_flow: npz``
    dumps of both windows equal the JAX CLI's to 1e-6, the calibration's
    ``K`` read by both."""
    from test_torch_cli import _dumps

    h, w, focal = 36, 44, 47.5
    scene = SyntheticDataLoader(config={"height": h, "width": w, "duration": 0.5, "event_rate": 9000,
                                        "pattern": "dots", "n_dots": 80, "scene": "rot3d", "focal": focal,
                                        "omega3": [0.3, -0.25, 0.6]})
    scene.set_sequence("rotation")
    ev = scene.load_event(0, len(scene))
    seq = tmp_path / "data" / "rotation"
    seq.mkdir(parents=True)
    np.savetxt(seq / "events.txt", np.stack([ev[:, 2], ev[:, 1], ev[:, 0], ev[:, 3]], 1), fmt="%.9f %d %d %d")
    (seq / "calib.txt").write_text(f"{focal} {focal} {(w - 1) / 2} {(h - 1) / 2}\n")
    shipped = yaml.safe_load((REPO / "configs" / "ecd_slider_depth.yaml").read_text())["data"]

    def config(name):
        c = _shipped("synthetic_rotation3d_global.yaml", tmp_path / name)
        c["data"] = {**shipped, "root": str(tmp_path / "data"), "sequence": "rotation", "height": h, "width": w,
                     "n_events_per_batch": 2000, "eval_n_frames": 3, "visualize_every": 0}
        c["output"]["save_flow"] = "npz"
        return c

    _jax_eval(config("jax"))
    records = port_cli.run(config("port"), eval_mode=True, device=CPU)
    assert [r["frame"] for r in records] == [0, 1]
    for g, w_ in zip(_metrics(tmp_path / "port"), _metrics(tmp_path / "jax")):
        assert g["PRED_FWL"] == pytest.approx(w_["PRED_FWL"], rel=0, abs=1e-6) and g["PRED_FWL"] < 1.0
    jd, td = _dumps(tmp_path / "jax"), _dumps(tmp_path / "port")
    assert list(td) == list(jd) == ["000000.npz", "000001.npz"]
    for name in jd:
        with np.load(jd[name]) as j, np.load(td[name]) as t:
            assert t["flow"].shape == j["flow"].shape == (2, h, w)
            np.testing.assert_allclose(t["flow"], j["flow"], rtol=0, atol=1e-6)
