"""The names the port took over last from the JAX package, each against
its JAX counterpart on the CPU at float64: ``ops.resize_flow`` (both
methods, odd sizes up and down: 1e-12), ``ops.warp_voxel_flow_streaming``
(Burgers and upwind, padded weights: 1e-10), ``costs.hybrid_loss`` and
``HybridCost.update_weight`` (1e-12), ``flow.generate_dense_optical_flow``
(equal under one ``np.random.seed``), ``FlowPatch``, the synthetic
loader's ``gt_time_list``, ``utils.profile_section`` / ``timing_report``,
the solver methods on the MVSEC-geometry pyramid, the time-aware pyramid
and the global models (``prepare_events``, the tile interpolation, the
motion-model conversions, the warm start's rescaling, ``undistort_image``,
``calculate_fwl``: 1e-6, the eval metrics' tolerance) and
``build_global_search``'s argmin and loss on a small grid."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from event_based_optical_flow_tpu import costs as jcosts
from event_based_optical_flow_tpu import solver as jsolver
from event_based_optical_flow_tpu import types as jtypes
from event_based_optical_flow_tpu.data.synthetic import SyntheticDataLoader as JaxSynthetic
from event_based_optical_flow_tpu.flow import gt as jgt
from event_based_optical_flow_tpu.ops import interp as jinterp
from event_based_optical_flow_tpu.ops import warp as jwarp
from event_based_optical_flow_tpu.solver import objective as JO
from event_based_optical_flow_tpu.solver import sampling as jsampling
from event_based_optical_flow_tpu.utils import misc as jmisc
from event_based_optical_flow_tpu_torch import costs as tcosts
from event_based_optical_flow_tpu_torch import flow as tflow
from event_based_optical_flow_tpu_torch import ops as tops
from event_based_optical_flow_tpu_torch import solver as tsolver
from event_based_optical_flow_tpu_torch import types as ttypes
from event_based_optical_flow_tpu_torch import utils as tutils
from event_based_optical_flow_tpu_torch.data.synthetic import SyntheticDataLoader as PortSynthetic
from event_based_optical_flow_tpu_torch.solver import sampling as tsampling
from event_based_optical_flow_tpu_torch.utils import misc as tmisc

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _close(got, want, atol):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


# --- ops ----------------------------------------------------------------------

@pytest.mark.parametrize("method", ["bilinear", "nearest"])
@pytest.mark.parametrize("in_hw,out_hw", [((5, 7), (13, 17)), ((13, 17), (5, 7)), ((9, 9), (4, 21)),
                                          ((3, 11), (7, 3))])
def test_resize_flow_matches_jax(method, in_hw, out_hw):
    a = np.random.default_rng(sum(in_hw + out_hw)).normal(size=(2,) + in_hw)
    _close(tops.resize_flow(torch.tensor(a), out_hw, method), jinterp.resize_flow(jnp.asarray(a), out_hw, method),
           1e-12)


def test_resize_flow_refuses_an_unknown_method():
    for resize, a in ((tops.resize_flow, torch.zeros(2, 3, 3)), (jinterp.resize_flow, jnp.zeros((2, 3, 3)))):
        with pytest.raises(ValueError, match="Unknown filter type"):
            resize(a, (4, 4), "bicubic")


def _stream_events(n=300, h=12, w=16, seed=0):
    rng = np.random.default_rng(seed)
    ev = np.stack([rng.integers(0, h, n).astype(float), rng.integers(0, w, n).astype(float),
                   np.sort(rng.uniform(0, 1, n)), rng.integers(0, 2, n).astype(float)], 1)
    flow0 = rng.uniform(-0.4, 0.4, (2, h, w))
    return ev, flow0


@pytest.mark.parametrize("scheme", ["burgers", "upwind"])
@pytest.mark.parametrize("padded", [False, True])
def test_streaming_voxel_warp_matches_jax(scheme, padded):
    ev, flow0 = _stream_events()
    w = None
    if padded:
        ev, w = jtypes.pad_events(ev, target_n=512)
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.tensor(w)
    ref = jwarp.calculate_reftime(jnp.asarray(ev), "first", jw)
    want = jwarp.warp_voxel_flow_streaming(jnp.asarray(ev), jnp.asarray(flow0), 4, ref, (12, 16), normalize_t=True,
                                           weights=jw, scheme=scheme)
    tev = torch.tensor(ev)
    got = tops.warp_voxel_flow_streaming(tev, torch.tensor(flow0), 4, tops.calculate_reftime(tev, "first", tw),
                                         (12, 16), normalize_t=True, weights=tw, scheme=scheme)
    _close(got, want, 1e-10)
    # the propagate-then-warp equivalent: bin k reads the (k+1)-step field
    f, slices = torch.tensor(flow0), []
    step = tflow.burgers_step if scheme == "burgers" else tflow.upwind_step
    for _ in range(4):
        f = step(f, 0.25)
        slices.append(f)
    voxel = tops.warp_voxel_flow(tev, torch.stack(slices), tops.calculate_reftime(tev, "first", tw), (12, 16),
                                 normalize_t=True, weights=tw)
    _close(got, voxel, 1e-10)


def test_streaming_voxel_warp_refuses_an_unknown_scheme():
    ev, flow0 = _stream_events(n=10)
    tev = torch.tensor(ev)
    with pytest.raises(ValueError, match="scheme"):
        tops.warp_voxel_flow_streaming(tev, torch.tensor(flow0), 2, tev[:, 2].min(), (12, 16), scheme="lax")


# --- costs, flow, types, utils, data ------------------------------------------

def test_hybrid_loss_and_update_weight_match_jax():
    values = {"a": 0.75, "b": 2.5, "c": 4.0}
    for weights in ({"a": 1.0, "b": 0.01, "c": "inv"}, {"a": "inv", "b": "inv", "c": 3.0}):
        want = jcosts.hybrid_loss(values, weights)
        assert abs(tcosts.hybrid_loss(values, weights) - want) <= 1e-12
        got = tcosts.hybrid_loss({k: torch.tensor(v, dtype=torch.float64) for k, v in values.items()}, weights)
        assert abs(float(got) - float(want)) <= 1e-12
    iwe = np.random.default_rng(3).uniform(0, 3, (17, 23))
    arg_j, arg_t = {"iwe": jnp.asarray(iwe), "omit_boundary": True}, {"iwe": torch.tensor(iwe), "omit_boundary": True}
    first = {"image_variance": 1.0, "gradient_magnitude": "inv"}
    hj = jcosts.HybridCost("minimize", dict(first))
    ht = tcosts.HybridCost("minimize", dict(first))
    for update in ({"image_variance": "inv", "gradient_magnitude": 0.5}, {"gradient_magnitude": 2.0, "image_variance": 3.0}):
        hj.update_weight(update)
        ht.update_weight(update)
        assert abs(float(ht.calculate(arg_t)) - float(hj.calculate(arg_j))) <= 1e-12
    for cost in (hj, ht):
        with pytest.raises(AssertionError):
            cost.update_weight({"image_variance": 1.0})


def test_generate_dense_optical_flow_draws_as_jax():
    np.random.seed(7)
    want = jgt.generate_dense_optical_flow((9, 13), max_val=12)
    np.random.seed(7)
    got = tflow.generate_dense_optical_flow((9, 13), max_val=12)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 9, 13) and np.abs(got).max() <= 12


def test_flow_patch_matches_jax():
    pj, pt = jtypes.FlowPatch(x=10.5, y=7.0, shape=(5, 4)), ttypes.FlowPatch(x=10.5, y=7.0, shape=(5, 4))
    for p in (pj, pt):
        p.update_flow(1.25, -3.0)
    clone = pt.copy()
    clone.update_flow(0.0, 0.0)
    np.testing.assert_array_equal(pt.position, pj.position)
    np.testing.assert_array_equal(pt.flow, pj.flow)
    np.testing.assert_array_equal(clone.flow, [0.0, 0.0])
    assert (pt.x_min, pt.x_max, pt.y_min, pt.y_max) == (pj.x_min, pj.x_max, pj.y_min, pj.y_max)
    assert dataclasses.asdict(pt) == dataclasses.asdict(pj)


def test_synthetic_gt_time_list_matches_jax():
    cfg = {"height": 24, "width": 32, "duration": 0.5, "event_rate": 4000, "n_frames": 6}
    lj, lt = JaxSynthetic(cfg), PortSynthetic(cfg)
    lj.set_sequence("s")
    lt.set_sequence("s")
    np.testing.assert_array_equal(lt.gt_time_list(), lj.gt_time_list())
    np.testing.assert_array_equal(lt.gt_time_list(), lt.eval_frame_time_list())


def test_profile_section_and_timing_report_match_jax():
    timings = {}
    for _ in range(2):
        with tutils.profile_section("solve", timings):
            pass
    with tmisc.profile_section("io", timings):
        pass
    assert sorted(timings) == ["io", "solve"] and len(timings["solve"]) == 2
    fixed = {"solve": [0.25, 0.5], "io": [0.001]}
    assert tmisc.timing_report(fixed) == jmisc.timing_report(fixed)
    assert re.fullmatch(r"io: n=1 total=\d+\.\d{3}s mean=\d+\.\dms\nsolve: n=2 total=\d+\.\d{3}s mean=\d+\.\dms",
                        tmisc.timing_report(timings))
    tmisc.clear_timings()
    with tmisc.profile_section("x"):
        pass
    assert tmisc.timing_report().startswith("x: n=1 ")
    tmisc.clear_timings()
    assert tmisc.timing_report() == ""


# --- the solver methods -----------------------------------------------------------

def _mvsec_geometry():
    with open("configs/synthetic_mvsec_geometry.yaml") as f:
        cfg = yaml.safe_load(f)
    slv = dict(cfg["solver"], precision="64", iwe_backend="matmul")
    return (cfg["data"]["height"], cfg["data"]["width"]), slv, cfg["optimizer"]


TA_SOLVER = {"method": "pyramidal_patch_contrast_maximization", "time_aware": True, "time_bin": 4,
             "flow_interpolation": "burgers", "t0_flow_location": "middle",
             "patch": {"initialize": "random", "scale": 3, "crop_height": 32, "crop_width": 40,
                       "filter_type": "bilinear"},
             "motion_model": "2d-translation", "warp_direction": "first", "parameters": ["trans_x", "trans_y"],
             "cost": "hybrid", "outer_padding": 0,
             "cost_with_weight": {"multi_focal_normalized_gradient_magnitude": 1.0, "total_variation": 0.01},
             "iwe": {"method": "bilinear_vote", "blur_sigma": 1}, "iwe_backend": "matmul", "precision": "64"}
TA_OPTIMIZER = {"n_iter": 8, "method": "Newton-CG", "max_iter": 2,
                "parameters": {"trans_x": {"min": -20, "max": 20}, "trans_y": {"min": -20, "max": 20}}}


def _pair(shape, slv, opt, calib=None):
    calib = calib or {}
    return (jsolver.collections[slv["method"]](shape, calib, slv, opt, {}, None),
            tsolver.collections[slv["method"]](shape, calib, slv, opt, {}, device=CPU))


def _events(shape, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, shape[0], n).astype(float), rng.integers(0, shape[1], n).astype(float),
                     np.sort(rng.uniform(0.0, 0.05, n)), rng.integers(0, 2, n).astype(float)], 1)


@pytest.mark.parametrize("cell", ["mvsec-geometry", "time-aware"])
def test_pyramid_methods_match_jax(cell):
    """prepare_events, the tile interpolation at the finest scale, the warm
    start's rescaling in its three forms and calculate_fwl (the pyramid's
    timescale form) against JAX; calculate_fwl is the FWL pair
    calculate_flow_error reports."""
    shape, slv, opt = _mvsec_geometry() if cell == "mvsec-geometry" else ((32, 40), TA_SOLVER, TA_OPTIMIZER)
    sj, st = _pair(shape, slv, opt)
    finest = st.patch_scales - 1
    sj.overload_patch_configuration(finest)
    st.overload_patch_configuration(finest)
    ev = _events(shape, 3000, 1)
    (pj, wj), (pt, wt) = sj.prepare_events(ev), st.prepare_events(ev)
    assert pt.device == CPU and pt.dtype == torch.float64 and wt.dtype == torch.float64
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))

    rng = np.random.default_rng(2)
    tiles = rng.uniform(-30, 30, (2,) + tuple(st.patch_image_size))
    _close(st.interpolate_dense_flow_from_patch(tiles), sj.interpolate_dense_flow_from_patch(tiles), 1e-12)

    motion = {finest: tiles}
    gt = rng.uniform(-2, 2, shape + (2,))
    ts = 0.05
    want = sj.calculate_fwl(motion, np.transpose(gt, (2, 0, 1)), ts, ev)
    got = st.calculate_fwl(motion, np.transpose(gt, (2, 0, 1)), ts, ev)
    assert sorted(got) == ["GT_FWL", "PRED_FWL"]
    for k in want:
        assert got[k] == pytest.approx(float(want[k]), rel=1e-6, abs=1e-9), k
    err = st.calculate_flow_error(motion, gt, ts, ev)
    assert (err["GT_FWL"], err["PRED_FWL"]) == (got["GT_FWL"], got["PRED_FWL"])

    per_scale = {s: rng.normal(size=(2,) + tuple(st.scaled_patch_image_size[s])) for s in range(1, st.patch_scales)}
    for warm in (per_scale, [per_scale, per_scale], per_scale[finest]):
        sj.set_previous_frame_best_estimation(warm)
        st.set_previous_frame_best_estimation(warm)
        sj.update_time_scale_for_previous_frame_best_estimation(0.5)
        st.update_time_scale_for_previous_frame_best_estimation(0.5)
        want, got = sj.previous_frame_best_estimation, st.previous_frame_best_estimation
        for w_one, g_one in zip(want if isinstance(want, list) else [want], got if isinstance(got, list) else [got]):
            if isinstance(w_one, dict):
                assert sorted(g_one) == sorted(w_one)
                for s in w_one:
                    _close(g_one[s], w_one[s], 0)
            else:
                _close(g_one, w_one, 0)
    st.set_previous_frame_best_estimation([None, per_scale])
    st.update_time_scale_for_previous_frame_best_estimation(2.0)
    assert st.previous_frame_best_estimation[0] is None
    assert st.setup_single_training() is None and st.train() is None


GLOBAL_KEYS = {"2d-translation": ["trans_x", "trans_y"], "4-param-similarity": ["trans_x", "trans_y", "rot", "zoom"],
               "3-rotation": ["rot_x", "rot_y", "rot_z"]}


def _global_configs(model):
    slv = {"method": "global_contrast_maximization", "motion_model": model, "patch": {"initialize": "zero"},
           "cost": "multi_focal_normalized_gradient_magnitude", "outer_padding": 0,
           "iwe": {"method": "bilinear_vote", "blur_sigma": 1}, "iwe_backend": "matmul", "precision": "64",
           "parameters": GLOBAL_KEYS[model]}
    return slv, {"method": "Newton-CG", "max_iter": 2, "n_iter": 12}


CALIB = {"K": np.array([[41.0, 0.0, 19.25], [0.0, 37.5, 15.5], [0.0, 0.0, 1.0]]),
         "D": np.array([-0.21, 0.05, 0.001, -0.002, 0.0])}


@pytest.mark.parametrize("model", sorted(GLOBAL_KEYS))
def test_global_methods_match_jax(model):
    """The motion-model conversions round trip, the base's field, its cold
    inits and undistort_image, as the JAX package's."""
    slv, opt = _global_configs(model)
    sj, st = _pair((32, 40), slv, opt, CALIB)
    motion = np.random.default_rng(4).normal(size=len(GLOBAL_KEYS[model])) * 0.3
    params_j, params_t = sj.motion_to_motion_model(motion), st.motion_to_motion_model(motion)
    assert list(params_t) == list(params_j) == GLOBAL_KEYS[model]
    assert all(params_t[k] == params_j[k] for k in params_j)
    np.testing.assert_array_equal(st.motion_model_to_motion(params_t), sj.motion_model_to_motion(params_j))
    np.testing.assert_array_equal(st.motion_model_to_motion(params_t), motion)
    _close(st.motion_to_dense_flow(motion), sj.motion_to_dense_flow(motion), 1e-12)
    base_j, base_t = jsolver.SolverBase, tsolver.SolverBase
    np.testing.assert_array_equal(base_t.initialize_random(st), base_j.initialize_random(sj))
    np.testing.assert_array_equal(base_t.initialize_zeros(st), base_j.initialize_zeros(sj))
    image = np.random.default_rng(5).uniform(0, 255, (32, 40)).astype(np.float32)
    np.testing.assert_array_equal(st.undistort_image(image), sj.undistort_image(image))


def _grid_problem():
    shape = (32, 40)
    rng = np.random.default_rng(6)
    dots = rng.uniform([2, 2], [shape[0] - 8, shape[1] - 8], (40, 2))
    t = np.sort(rng.uniform(0, 1, 2500))
    pos = dots[rng.integers(0, 40, 2500)] + np.array([4.0, -3.0]) * t[:, None] + rng.normal(0, 0.2, (2500, 2))
    ev = np.stack([np.round(pos[:, 0]), np.round(pos[:, 1]), t, np.ones_like(t)], 1)
    ev = ev[(ev[:, 0] >= 0) & (ev[:, 0] < shape[0]) & (ev[:, 1] >= 0) & (ev[:, 1] < shape[1])]
    return shape, ev, np.arange(-8.0, 9.0, 2.0)


@pytest.mark.parametrize("solver", ["global", "pyramid-coarsest"])
def test_global_search_matches_jax(solver):
    """The 2-DoF grid sweep on the port's own objective (its spec: the
    grid inits' batched route) against the JAX package's search of its
    objective: the same argmin and loss."""
    shape, ev, field = _grid_problem()
    if solver == "global":
        slv, opt = _global_configs("2d-translation")
    else:
        slv = dict(TA_SOLVER, time_aware=False)
        opt = TA_OPTIMIZER
    sj, st = _pair(shape, slv, opt)
    jspec = dataclasses.replace(sj._current_spec(), iwe_backend="matmul")
    jobj = JO.build_objective(jspec)
    n_tiles = int(np.prod(jspec.patch_image_size)) if jspec.motion_model == "tiles" else 1
    jsearch = jsampling.build_global_search(shape, lambda c, e, w: jobj(jnp.repeat(c[:, None], n_tiles, 1).reshape(-1),
                                                                         e, w)[0], field)
    want_best, want_loss = jsearch(*sj.prepare_events(ev))
    best, loss = tsampling.build_global_search(shape, st._current_spec(), field, chunk=32)(*st.prepare_events(ev))
    assert best.dtype == loss.dtype == torch.float64
    np.testing.assert_array_equal(best.numpy(), np.asarray(want_best))
    assert float(loss) == pytest.approx(float(want_loss), rel=1e-9)


def test_global_search_of_a_callable_matches_jax():
    """A callable objective (the JAX package's contract): vmapped when it
    can be, one call per candidate when it reads the host; the first
    minimum of the grid, as JAX's argmin."""
    shape, ev, field = _grid_problem()
    target = np.array([3.0, -5.0])

    def jax_obj(c, e, w):
        return jnp.sum((c - target) ** 2) + 0.0 * jnp.sum(e * w[:, None])

    def port_obj(c, e, w):
        return ((c - torch.as_tensor(target)) ** 2).sum() + 0.0 * (e * w[:, None]).sum()

    def host_obj(c, e, w):
        return torch.tensor(float(port_obj(c, e, w).item()), dtype=torch.float64)

    pj, wj = jtypes.pad_events(ev)
    want_best, want_loss = jsampling.build_global_search(shape, jax_obj, field)(jnp.asarray(pj), jnp.asarray(wj))
    for fn in (port_obj, host_obj):
        best, loss = tsampling.build_global_search(shape, fn, field)(torch.tensor(pj), torch.tensor(wj))
        np.testing.assert_array_equal(best.numpy(), np.asarray(want_best))
        assert float(loss) == float(want_loss)
    with pytest.raises(ValueError, match="2-DoF grid"):
        slv, opt = _global_configs("4-param-similarity")
        spec = tsolver.collections[slv["method"]](shape, {}, slv, opt, {}, device=CPU)._current_spec()
        tsampling.build_global_search(shape, spec, field)
