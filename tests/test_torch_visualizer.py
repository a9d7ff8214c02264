"""The port's visualizer (``event_based_optical_flow_tpu_torch/visualizer.py``)
and the solvers' ``visualize_*`` methods against the JAX package's, at
float64 on the CPU.

* Every ``Visualizer`` method, called in the same order on both with the
  same inputs: the same files (names and per-prefix numbering), every PNG
  decoding to the same array, the ``.npy`` arrays equal; the history plots
  exist (the port draws them with PIL, the JAX package with matplotlib:
  other pixels).  ``flush`` re-raises a failed write.
* The solvers' images on one window of the pyramid tests' dots scene, from
  the same solution (JAX's draws are not involved): the pyramid (plain and
  time-aware Burgers), the single-scale tile solver and the global
  similarity solver.  Each visualization IWE (the events warped as
  ``_warped_viz_iwe`` warps them, voted unblurred) to 1e-9 of JAX's, and
  the uint8 images equal.  The JAX package's single-scale tile solver
  raises on ``visualize_pred_sequential`` / ``visualize_one_batch_warp``
  (it warps the tile array as one 2-DoF translation); the port warps by the
  tiles' dense flow there (a documented deviation), so those images are
  held to the pyramid's (same warp) instead.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from event_based_optical_flow_tpu import solver as jsolver
from event_based_optical_flow_tpu import visualizer as jvis
from event_based_optical_flow_tpu.data.synthetic import SyntheticDataLoader
from event_based_optical_flow_tpu_torch import solver as tsolver
from event_based_optical_flow_tpu_torch import visualizer as tvis
from event_based_optical_flow_tpu_torch.ops.iwe import create_iwe
from test_torch_pyramid import OPTIMIZER, SOLVER, H, W

TOL = 1e-9
CPU = torch.device("cpu")
TIME_AWARE = {"time_aware": True, "time_bin": 3, "flow_interpolation": "burgers", "t0_flow_location": "middle"}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def scene():
    """(events, GT displacement [H, W, 2]) of one window of the pyramid
    tests' dots scene."""
    loader = SyntheticDataLoader({"height": H, "width": W, "duration": 1.0, "event_rate": 12000,
                                  "n_frames": 4, "pattern": "dots", "n_dots": 60, "flow_max": 12.0})
    loader.set_sequence("pyramid")
    ts = loader.eval_frame_time_list()
    ev = loader.load_event(loader.time_to_index(ts[1]), loader.time_to_index(ts[2]))
    ev[:, 2] -= ev[:, 2].min()
    return ev, loader.load_optical_flow(ts[1], ts[2])


def _assert_same_files(jdir, tdir, skip_pixels=("optimization_steps", "sampling_steps")):
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names
    for name in names:
        if name.startswith(skip_pixels):
            continue
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(os.path.join(tdir, name)), np.load(os.path.join(jdir, name)))
        else:
            want = np.asarray(Image.open(os.path.join(jdir, name)))
            np.testing.assert_array_equal(np.asarray(Image.open(os.path.join(tdir, name))), want, err_msg=name)
    return names


def test_visualizer_methods_write_the_jax_files(scene, tmp_path):
    events, gt = scene
    rng = np.random.default_rng(0)
    flow = rng.normal(0.0, 2.0, (2, H, W))
    flow[0, 0, 0] = np.nan
    pred = rng.normal(0.0, 2.0, (2, H, W))
    iwe_events = events.copy()
    iwe_events[:, 3] = rng.integers(0, 2, len(events))  # polarities in {0, 1}
    event_image = rng.normal(size=(H, W))
    vizs = {"jax": jvis.Visualizer((H, W), save=True, save_dir=str(tmp_path / "jax")),
            "port": tvis.Visualizer((H, W), save=True, save_dir=str(tmp_path / "port"), device=CPU)}
    clipped = {}
    for name, vz in vizs.items():
        clipped[name] = vz.create_clipped_iwe_for_visualization(events, max_scale=40)
        vz.visualize_image(clipped[name])
        vz.visualize_image(clipped[name], file_prefix="image")
        vz.visualize_optical_flow(flow[0], flow[1], file_prefix="flow", save_flow=True)
        vz.visualize_optical_flow(flow[0], flow[1], visualize_color_wheel=False, file_prefix="flow", ord=1.0)
        vz.visualize_overlay_optical_flow_on_event(flow, iwe_events, file_prefix="overlay_events")
        vz.visualize_overlay_optical_flow_on_event(flow, clipped[name], file_prefix="overlay_image")
        vz.visualize_optical_flow_on_event_mask(flow, events, file_prefix="masked")
        vz.visualize_optical_flow_on_event_mask(flow, events, file_prefix="masked", max_color_on_mask=False)
        vz.visualize_optical_flow_pred_and_gt(pred, np.transpose(gt, (2, 0, 1)), pred_file_prefix="pg_pred",
                                              gt_file_prefix="pg_gt")
        vz.visualize_event(iwe_events, file_prefix="event")
        vz.visualize_event(iwe_events, ignore_polarity=True, file_prefix="event")
        vz.visualize_event(iwe_events, grayscale=False, file_prefix="event_color")
        vz.visualize_event_image(event_image, file_prefix="event_image")
        vz.save_array(flow, file_prefix="array")
        vz.save_array(pred, file_prefix="array", new_prefix=True)
        vz.visualize_scipy_history({"loss": [3.0, 2.5, 2.25], "multi_focal_normalized_gradient_magnitude": [2.0, 1.8, 1.7],
                                    "total_variation": [1.0, 0.9, np.nan]},
                                   {"multi_focal_normalized_gradient_magnitude": "inv", "total_variation": 0.01})
        vz.visualize_sampling_history([5.0, 3.0, 2.5])
        assert vz.get_filename_from_prefix("image").endswith("image1.png")
        vz.rollback_save_count("image")
        vz.reset_save_count("event")
        vz.visualize_event(iwe_events, file_prefix="event")  # event0 again
        vz.flush()
    np.testing.assert_array_equal(clipped["port"], clipped["jax"])
    names = _assert_same_files(tmp_path / "jax", tmp_path / "port")
    assert {"optimization_steps0.png", "optimization_steps1.png", "color_wheel.png", "0.png", "array0.npy"} <= set(names)
    assert Image.open(tmp_path / "port" / "optimization_steps0.png").size == tvis.PLOT_SIZE


def test_flush_reraises_a_failed_write(tmp_path):
    vz = tvis.Visualizer((H, W), save=True, save_dir=str(tmp_path / "gone"), device=CPU)
    os.rmdir(tmp_path / "gone")
    vz.visualize_image(np.zeros((H, W), np.uint8))
    with pytest.raises(FileNotFoundError):
        vz.flush()
    vz.close()


def _recording(solver, sink, iwe_fn):
    """Wrap ``solver._warped_viz_iwe``: record (clipped, float IWE of its
    warped events) per call."""
    fn = solver._warped_viz_iwe

    def wrapped(events, motion, model, direction="first", return_warped=False):
        out = fn(events, motion, model, direction, return_warped=True)
        sink.append((out[0], iwe_fn(out)))
        return out if return_warped else out[0]

    solver._warped_viz_iwe = wrapped


def _jax_iwe(solver):
    return lambda out: np.asarray(solver.imager.create_iwe(jnp.asarray(out[1]), "bilinear_vote", sigma=0,
                                                             weight=jnp.asarray(out[2])))


def _port_iwe(solver):
    return lambda out: create_iwe(out[1], solver.image_shape, sigma=0).numpy()


def _solver_pair(slv, opt, tmp_path, calib=None):
    jv = jvis.Visualizer((H, W), save=True, save_dir=str(tmp_path / "jax"))
    tv = tvis.Visualizer((H, W), save=True, save_dir=str(tmp_path / "port"), device=CPU)
    sj = jsolver.collections[slv["method"]]((H, W), calib or {}, slv, opt, {}, jv)
    st = tsolver.collections[slv["method"]]((H, W), calib or {}, slv, opt, {}, visualize_module=tv, device=CPU)
    return sj, st


def _compare_solver_images(sj, st, calls, tmp_path):
    got_j, got_t = [], []
    _recording(sj, got_j, _jax_iwe(sj))
    _recording(st, got_t, _port_iwe(st))
    for name, args_j, args_t in calls:
        getattr(sj, name)(*args_j)
        getattr(st, name)(*args_t)
    sj.visualizer.flush()
    st.visualizer.flush()
    assert len(got_j) == len(got_t) > 0
    for (cj, ij), (ct, it) in zip(got_j, got_t):
        np.testing.assert_allclose(it, ij, rtol=0, atol=TOL)
        np.testing.assert_array_equal(ct, cj)
    return _assert_same_files(tmp_path / "jax", tmp_path / "port")


@pytest.mark.parametrize("time_aware", [False, True])
def test_pyramid_images_match_jax(scene, tmp_path, time_aware):
    events, gt = scene
    slv = dict(SOLVER, **(TIME_AWARE if time_aware else {}))
    sj, st = _solver_pair(slv, OPTIMIZER, tmp_path)
    finest = st.patch_scales - 1
    for s in (sj, st):
        s.overload_patch_configuration(finest)
    motion = np.random.default_rng(1).uniform(-8.0, 8.0, (2,) + tuple(st.patch_image_size))
    mj, mt = {finest: motion}, {finest: torch.as_tensor(motion)}
    names = _compare_solver_images(sj, st, [
        ("visualize_one_batch_warp", (events,), (events,)),
        ("visualize_one_batch_warp", (events, mj), (events, mt)),
        ("visualize_original_sequential", (events,), (events,)),
        ("visualize_pred_sequential", (events, mj), (events, mt)),
        ("visualize_gt_sequential", (events, gt), (events, gt)),
    ], tmp_path)
    assert {"0.png", "1.png", "2.png", "3.png", "original0.png", "pred_warp0.png", "pred_masked0.png",
            "gt_warp0.png", "gt_flow0.png"} <= set(names)


def test_single_scale_tile_solver_images(scene, tmp_path):
    """The JAX package's images where its single-scale solver draws them;
    its pred warp and warped batch image raise there, and the port's equal
    the pyramid's from the same dense flow."""
    events, gt = scene
    mixed = dict(SOLVER, method="mixed_patch_contrast_maximization",
                 patch={"initialize": "random", "size": [16, 20], "sliding_window": [16, 20], "filter_type": "bilinear"})
    sj, st = _solver_pair(mixed, OPTIMIZER, tmp_path)
    motion = np.random.default_rng(2).uniform(-8.0, 8.0, (2, 2, 2))
    _compare_solver_images(sj, st, [
        ("visualize_one_batch_warp", (events,), (events,)),
        ("visualize_original_sequential", (events,), (events,)),
        ("visualize_gt_sequential", (events, gt), (events, gt)),
        ("visualize_flows", (motion, gt, 0.25), (torch.as_tensor(motion), gt, 0.25)),
    ], tmp_path)
    with pytest.raises(ValueError):
        sj.visualize_pred_sequential(events, motion)
    st.visualize_pred_sequential(events, torch.as_tensor(motion))
    st.visualize_one_batch_warp(events, torch.as_tensor(motion))
    st.visualizer.flush()
    # the pyramid whose finest grid is the same 2 x 2 tiles warps the same
    pyr = tsolver.collections[SOLVER["method"]]((H, W), {}, dict(SOLVER, patch={**SOLVER["patch"], "scale": 2}),
                                               OPTIMIZER, {}, device=CPU)
    pyr.overload_patch_configuration(1)
    flow, model, _ = pyr._viz_warp(events, {1: torch.as_tensor(motion)})
    want = pyr._warped_viz_iwe(events, flow, model)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "port" / "pred_warp0.png")), want)


def test_global_solver_images_match_jax(tmp_path):
    from test_torch_global import _configs, _scene

    events, gt, _, calib = _scene("rot", h=H, w=W, omega=0.8)
    slv, opt = _configs("4-param-similarity")
    sj, st = _solver_pair(slv, opt, tmp_path, calib)
    motion = np.array([3.0, -2.0, 0.6, 0.1])
    names = _compare_solver_images(sj, st, [
        ("visualize_one_batch_warp", (events, motion), (events, motion)),
        ("visualize_original_sequential", (events,), (events,)),
        ("visualize_pred_sequential", (events, motion), (events, motion)),
        ("visualize_gt_sequential", (events, gt), (events, gt)),
    ], tmp_path)
    assert {"0.png", "1.png", "original0.png", "pred_warp0.png", "gt_warp0.png", "gt_flow0.png"} <= set(names)
