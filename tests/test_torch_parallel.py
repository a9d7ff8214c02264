"""The port's multi-device layer against the JAX package's, on the CPU (the
JAX side on the 8 virtual devices of ``tests/conftest.py``, the port's
meshes repeating the CPU device): ``make_mesh``, ``sharded_iwe``,
``sharded_multifocal_loss`` and its gradient, ``build_fleet_step``, the
exact models of every kernel's sharded form (the card's bits: sharded and
reduced, they equal the unsharded models bit for bit), the event-sharded
objective, ``validate_config`` on ``parallel:`` blocks, the cost
registry's history register and ``dnn_train_step_parallel``.  The solvers
on a mesh are ``tests/test_torch_parallel_solvers.py``."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.sharding import PartitionSpec as P

from event_based_optical_flow_tpu.parallel import sharded as JS
from event_based_optical_flow_tpu_torch.ops import fused_iwe as FI
from event_based_optical_flow_tpu_torch.ops import vote as TV
from event_based_optical_flow_tpu_torch.parallel import sharded as TSH
from event_based_optical_flow_tpu_torch.solver import objective as TO

CPU = torch.device("cpu")
H, W = 24, 32
IMAGE = (H, W)
PATCH_IMAGE = (2, 2)
PATCH = (12, 16)
SLIDE = (12, 16)
OFFSETS = (0.0, 1.0, 0.5)


def _events(n, seed, long_run=0):
    """``n`` events ``[n, 4]`` over the image in time order; the first
    ``long_run`` sit on one pixel (a run that crosses the even cuts)."""
    rng = np.random.default_rng(seed)
    ev = np.stack([rng.uniform(0, H, n), rng.uniform(0, W, n), np.sort(rng.uniform(0, 0.05, n)),
                   rng.integers(0, 2, n).astype(float)], 1)
    ev[:long_run, :2] = (7.25, 9.5)
    return ev


def _cpus(k):
    return [CPU] * k


# ---- the mesh --------------------------------------------------------------


def test_make_mesh_shapes_and_errors():
    """``make_mesh``'s arithmetic and assert are the JAX package's; the
    port's mesh takes a device list (a device may repeat) and never falls
    back to the CPU on its own."""
    for kw, shape in (({}, (8, 1)), ({"event": 2}, (4, 2)), ({"data": 2, "event": 4}, (2, 4)),
                      ({"n_devices": 4, "event": 4}, (1, 4))):
        jm = JS.make_mesh(**kw)
        tm = TSH.make_mesh(**kw, devices=_cpus(8))
        assert tuple(jm.devices.shape) == tm.devices.shape == shape
        assert tuple(jm.axis_names) == tm.axis_names == ("data", "event")
        assert dict(jm.shape) == tm.shape and jm.size == tm.size
    for kw in ({"data": 3, "event": 2}, {"n_devices": 6, "data": 4}):
        with pytest.raises(AssertionError):
            JS.make_mesh(**kw)
        with pytest.raises(AssertionError):
            TSH.make_mesh(**kw, devices=_cpus(8))
    with pytest.raises(ValueError, match="needs 8 devices, 4 are available"):
        TSH.make_mesh(8, data=4, event=2, devices=_cpus(4))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TSH.make_mesh(2)
    mesh = TSH.make_mesh(8, data=4, event=2, devices=_cpus(8))
    assert mesh.event_devices(3) == (CPU, CPU) and mesh.data_devices() == (CPU,) * 4 and mesh.lead == CPU


# ---- the sharded functions against the JAX package -----------------------------


@pytest.mark.parametrize("blur", [0.0, 1.0])
def test_sharded_iwe_matches_jax(blur):
    """``sharded_iwe`` on ``event: 8`` (the JAX mesh of the 8 virtual
    devices, the port's of the CPU 8 times), float64, to 1e-12."""
    ev = _events(2048, 1)
    wt = (np.random.default_rng(2).uniform(size=len(ev)) > 0.2).astype(float)
    jm = JS.make_mesh(8, data=1, event=8)
    want = np.asarray(JS.sharded_iwe(jnp.asarray(ev), jnp.asarray(wt), IMAGE, jm, blur_sigma=blur))
    tm = TSH.make_mesh(8, data=1, event=8, devices=_cpus(8))
    got = TSH.sharded_iwe(torch.as_tensor(ev), torch.as_tensor(wt), IMAGE, tm, blur_sigma=blur)
    assert got.shape == want.shape == IMAGE
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def _jax_loss_fn(mesh):
    def body(m, e, w):
        return JS.sharded_multifocal_loss(m, e, w, IMAGE, PATCH_IMAGE, PATCH, SLIDE)

    return jax.shard_map(body, mesh=mesh, in_specs=(P(), P("event", None), P("event")), out_specs=P(),
                         check_vma=False)


def test_sharded_multifocal_loss_and_gradient_match_jax():
    """The loss and its motion gradient on an ``event: 2`` mesh, against the
    JAX function inside ``shard_map`` (float64, 1e-9)."""
    ev = _events(1024, 3, long_run=40)
    wt = np.ones(len(ev))
    motion = np.random.default_rng(4).uniform(-20, 20, 2 * 4)
    jm = JS.make_mesh(2, data=1, event=2)
    loss_j, grad_j = jax.jit(jax.value_and_grad(_jax_loss_fn(jm)))(jnp.asarray(motion), jnp.asarray(ev),
                                                                    jnp.asarray(wt))
    tm = TSH.make_mesh(2, data=1, event=2, devices=_cpus(2))
    m = torch.as_tensor(motion).requires_grad_(True)
    loss_t = TSH.sharded_multifocal_loss(m, torch.as_tensor(ev), torch.as_tensor(wt), IMAGE, PATCH_IMAGE, PATCH,
                                         SLIDE, mesh=tm)
    (grad_t,) = torch.autograd.grad(loss_t, m)
    assert float(loss_t.detach()) == pytest.approx(float(loss_j), rel=1e-9)
    np.testing.assert_allclose(grad_t.numpy(), np.asarray(grad_j), rtol=1e-9, atol=1e-9)


def test_build_fleet_step_matches_jax():
    """One gradient step of 4 frames on a (4, 2) mesh (frames over "data",
    each frame's events over "event"): the new motions and the mean loss,
    float64, to 1e-9."""
    b, n = 4, 512
    ev = np.stack([_events(n, 10 + i) for i in range(b)])
    wt = np.ones((b, n))
    motions = np.random.default_rng(5).uniform(-15, 15, (b, 8))
    jm = JS.make_mesh(8, data=4, event=2)
    step_j = JS.build_fleet_step(jm, IMAGE, PATCH_IMAGE, PATCH, SLIDE, lr=0.5)
    shard = JS.fleet_shardings(jm)
    args = [jax.device_put(jnp.asarray(a), s) for a, s in zip((motions, ev, wt), shard)]
    new_j, loss_j = step_j(*args)
    tm = TSH.make_mesh(8, data=4, event=2, devices=_cpus(8))
    step_t = TSH.build_fleet_step(tm, IMAGE, PATCH_IMAGE, PATCH, SLIDE, lr=0.5)
    new_t, loss_t = step_t(torch.as_tensor(motions), torch.as_tensor(ev), torch.as_tensor(wt))
    np.testing.assert_allclose(new_t.numpy(), np.asarray(new_j), rtol=1e-9, atol=1e-9)
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-9)
    with pytest.raises(ValueError, match="does not divide"):
        step_t(torch.as_tensor(motions[:3]), torch.as_tensor(ev[:3]), torch.as_tensor(wt[:3]))


# ---- the card's bits: the exact models, sharded and reduced ---------------------


def _frame(dtype, time_bin, seed=6):
    """A frame whose first 1200 events (of 2000) sit on one pixel: with 2, 3
    or 8 shards its run crosses an even cut, and with 8 a shard gets no
    events."""
    return TO.FrameEvents.from_numpy(_events(2000, seed, long_run=1200), CPU, dtype, time_bin)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("time_bin", [None, 3])
@pytest.mark.parametrize("n_shards", [2, 3, 8])
def test_sharded_exact_models_equal_the_unsharded_models(dtype, time_bin, n_shards):
    """K1 (K5 with bins): each shard's int64 sums (``fused_iwe_fwd_acc``),
    added and converted once (``fused_iwe_from_fixed``); K3 (K6): each
    shard's bound, their max, each shard's votes in that unit and the
    frame's event count (``fused_iwe_jvp_acc``), converted once; K2, K4
    (K5's and K6's backward): the ordered run sums per run-aligned shard,
    added; K8: even shards' int64 sums (``vote_acc``), added, converted
    once (``vote_from_fixed``) -- each the unsharded exact model's bits."""
    frame = _frame(dtype, time_bin)
    sf = frame.shard(_cpus(n_shards))
    sizes = [sh.x.shape[0] for sh in sf.shards]
    assert sum(sizes) == frame.x.shape[0] and (n_shards != 8 or 0 in sizes)
    rng = np.random.default_rng(7)
    lead = (time_bin,) if time_bin else ()
    flow = torch.as_tensor(rng.normal(size=lead + (2, H, W)) * 3, dtype=dtype)
    dflow = torch.as_tensor(rng.normal(size=flow.shape), dtype=dtype)
    g, g1, g2 = (torch.as_tensor(rng.normal(size=(3, H, W)), dtype=dtype) for _ in range(3))
    ev = (frame.x, frame.y, frame.dtf, frame.wt)
    n = frame.x.shape[0]

    for include_orig in (False, True):
        acc = torch.zeros((3 + include_orig, H, W), dtype=torch.int64)
        for sh in sf.shards:
            FI.fused_iwe_fwd_acc(flow, sh.x, sh.y, sh.dtf, sh.wt, OFFSETS, include_orig, acc, bins=sh.bins)
        want = FI.fused_iwe_fixed_reference(flow, *ev, OFFSETS, include_orig, bins=frame.bins)
        assert torch.equal(FI.fused_iwe_from_fixed(acc, dtype), want)

    bound = torch.stack([FI.fused_iwe_jvp_bound(dflow, sh.x, sh.y, sh.dtf, sh.wt, OFFSETS, sh.bins)
                         for sh in sf.shards]).amax(0)
    acc_tan, acc_val = torch.zeros((3, H, W), dtype=torch.int64), torch.zeros((3, H, W), dtype=torch.int64)
    for sh in sf.shards:
        FI.fused_iwe_jvp_acc(flow, dflow, sh.x, sh.y, sh.dtf, sh.wt, OFFSETS, bound, n, acc_tan, acc_val,
                             bins=sh.bins)
    val_want, tan_want = FI.fused_iwe_jvp_fixed_reference(flow, dflow, *ev, OFFSETS, True, bins=frame.bins)
    assert torch.equal(FI.fused_iwe_from_scaled(acc_tan, bound, n, dtype), tan_want)
    assert torch.equal(FI.fused_iwe_from_fixed(acc_val, dtype), val_want)

    for kw in ({}, {"g1": g1, "dflow": dflow}):
        gk = g2 if kw else g
        got = sum(FI.fused_iwe_bwd_ordered_reference(flow, sh.x, sh.y, sh.dtf, sh.wt, gk, OFFSETS, False,
                                                     bins=sh.bins, **kw) for sh in sf.shards)
        assert torch.equal(got, FI.fused_iwe_bwd_ordered_reference(flow, *ev, gk, OFFSETS, False, bins=frame.bins,
                                                                   **kw))

    pos = torch.as_tensor(_events(2000, 8, long_run=900)[:, :4], dtype=dtype)
    for size in (IMAGE, (H // 2, W // 2)):
        sums = sum(TV.vote_acc(p, size) for p in torch.tensor_split(pos, n_shards))
        assert torch.equal(TV.vote_from_fixed(sums, dtype), TV.bilinear_vote_fixed_reference(pos, size))


def test_run_cuts_fall_on_run_boundaries():
    """Each cut is the run boundary nearest the even split, never before the
    previous cut; a run longer than a shard leaves a shard empty.  A frame
    keeps its cut for the same devices until ``copy_``."""
    heads = np.array([3, 4, 9])  # runs [0, 3), [3, 4), [4, 9), [9, 10)
    assert TO.run_cuts(heads, 10, 2) == [0, 4, 10]
    assert TO.run_cuts(heads, 10, 3) == [0, 3, 9, 10]
    assert TO.run_cuts(np.array([8]), 10, 4) == [0, 0, 8, 8, 10]
    assert TO.run_cuts(np.array([], dtype=np.int64), 0, 3) == [0, 0, 0, 0]
    frame = _frame(torch.float64, 3)
    for k in (2, 3, 8):
        sf = frame.shard(_cpus(k))
        keys = [(int(b), int(x), int(y)) for b, x, y in zip(frame.bins, frame.x.trunc(), frame.y.trunc())]
        cuts = np.cumsum([sh.x.shape[0] for sh in sf.shards])[:-1]
        assert all(keys[c - 1] != keys[c] for c in cuts if 0 < c < len(keys))  # no run is cut
        assert all(torch.equal(sh.t_scale, frame.t_scale) for sh in sf.shards)
        assert torch.equal(torch.cat([sh.dtf for sh in sf.shards]), frame.dtf)
    cut = frame.shard(_cpus(3))
    assert frame.shard(_cpus(3)) is cut
    frame.copy_(_frame(torch.float64, 3))
    assert frame.shard(_cpus(3)) is not cut
    with pytest.raises(ValueError, match="polarity"):
        TO.FrameEvents.from_numpy(_events(100, 1), CPU, torch.float64, polarity=True).shard(_cpus(2))


# ---- the event-sharded objective -------------------------------------------------


def _spec(time_aware):
    extra = {"time_aware": True, "time_bin": 3, "flow_interpolation": "burgers", "t0_location": "middle"} \
        if time_aware else {}
    return TO.ObjectiveSpec(image_shape=IMAGE, patch_image_size=PATCH_IMAGE, patch_size=PATCH,
                            sliding_window=SLIDE, patch_shift=(0, 0), filter_type="bilinear", blur_sigma=1.0,
                            cost_name="hybrid",
                            cost_with_weight=(("multi_focal_normalized_gradient_magnitude", 1.0),
                                              ("total_variation", 0.01)), **extra)


@pytest.mark.parametrize("time_aware", [False, True])
def test_sharded_objective_keeps_the_single_device_bits(time_aware):
    """The objective, its gradient, the orig IWE and both analytic HVPs
    (staged: the tangent and the HVP backward) of a frame cut over a
    3-device mesh are the single-device objective's bits (the CPU's plain
    route votes the whole frame, as the card's integer reduction keeps its
    bits); an unfused spec refuses a sharded frame."""
    spec = _spec(time_aware)
    frame = _frame(torch.float64, 3 if time_aware else None)
    mesh = TSH.make_mesh(3, data=1, event=3, devices=_cpus(3))
    sf = frame.shard(mesh.event_devices())
    motion = torch.as_tensor(np.random.default_rng(9).uniform(-20, 20, 8))
    p = torch.as_tensor(np.random.default_rng(10).normal(size=8))
    orig = TO.build_orig_iwe(spec)(frame)
    assert torch.equal(TO.build_orig_iwe(spec, mesh=mesh)(frame), orig)
    for fr, kw in ((frame, {}), (sf, {}), (frame, {"mesh": mesh})):
        m = motion.clone().requires_grad_(True)
        loss, _ = TO.build_objective(spec, **kw)(m, orig, fr)
        (grad,) = torch.autograd.grad(loss, m)
        prep, hvp = TO.build_objective_hvp_staged(spec, **kw)
        hp = hvp(prep(motion, orig, fr), motion, p, orig, fr)
        if fr is frame and not kw:
            want = (loss, grad, hp)
        else:
            assert torch.equal(loss, want[0]) and torch.equal(grad, want[1]) and torch.equal(hp, want[2])
    unfused = TO.ObjectiveSpec(**{**_spec(False).__dict__, "outer_padding": 2})
    with pytest.raises(ValueError, match="one device"):
        TO.build_objective(unfused)(motion, None, _frame(torch.float64, None).shard(_cpus(2)))


# ---- the config ------------------------------------------------------------------


@pytest.mark.parametrize("block", [
    {"data": 2}, {"data": 1, "event": 4}, {"event": 2, "surprise": 1}, {},
    {"data": 0}, {"event": "2"}, {"data": 1.5}, [2, 1], "data",
])
def test_validate_config_parallel_blocks_as_jax(block):
    """A top-level ``parallel:`` block validates, warns and fails as in the
    JAX package (positive ints, unknown keys warned), on the shipped MVSEC
    geometry config; ``solver.parallel`` is taken as it is."""
    from event_based_optical_flow_tpu.utils import validate_config as jax_validate
    from event_based_optical_flow_tpu_torch.utils import ConfigError, validate_config

    with open("configs/synthetic_mvsec_geometry.yaml") as f:
        config = yaml.safe_load(f)
    config["parallel"] = block
    try:
        want = jax_validate(copy.deepcopy(config))
    except Exception as e:  # noqa: BLE001 - the JAX package's ConfigError
        with pytest.raises(ConfigError) as got:
            validate_config(copy.deepcopy(config))
        assert str(got.value) == str(e)
    else:
        assert validate_config(copy.deepcopy(config)) == want
    config.pop("parallel")
    config["solver"]["parallel"] = {"data": 2}
    assert validate_config(copy.deepcopy(config)) == jax_validate(copy.deepcopy(config))


# ---- the cost registry's history ---------------------------------------------------


def test_cost_history_matches_jax():
    """The seven costs and the hybrid record ``float(loss)`` per
    ``calculate`` with ``store_history`` on, as the JAX package's
    ``register`` does (the hybrid's total and each component's own), and
    nothing with it off or inside a ``torch.func`` transform (the JAX
    package's tracer skip)."""
    from event_based_optical_flow_tpu import costs as JC
    from event_based_optical_flow_tpu_torch import costs as TC

    rng = np.random.default_rng(11)
    imgs = {k: rng.uniform(0, 3, (H, W)) for k in ("iwe", "orig_iwe", "forward_iwe", "backward_iwe", "middle_iwe")}
    arg_np = {**imgs, "flow": rng.normal(size=(2, 4, 5)), "omit_boundary": True}
    arg_j = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in arg_np.items()}
    arg_t = {k: torch.as_tensor(v) if isinstance(v, np.ndarray) else v for k, v in arg_np.items()}
    arg_j["backward_iwe"] = arg_j["iwe"]
    arg_t["backward_iwe"] = arg_t["iwe"]
    for name in TC.functions:
        for direction in ("minimize", "maximize"):
            cj = JC.functions[name](direction=direction, store_history=True)
            ct = TC.functions[name](direction=direction, store_history=True)
            for _ in range(2):
                cj.calculate(arg_j)
                ct.calculate(arg_t)
            np.testing.assert_allclose(ct.get_history()["loss"], cj.get_history()["loss"], rtol=1e-12)
            assert len(ct.get_history()["loss"]) == 2
    weights = {"multi_focal_normalized_gradient_magnitude": 1.0, "total_variation": 0.01, "image_variance": "inv"}
    hj = JC.HybridCost(direction="minimize", cost_with_weight=weights, store_history=True)
    ht = TC.HybridCost(direction="minimize", cost_with_weight=weights, store_history=True)
    for _ in range(3):
        hj.calculate(arg_j)
        ht.calculate(arg_t)
    hj.calculate_with_components(arg_j)
    ht.calculate_with_components(arg_t)
    want, got = hj.get_history(), ht.get_history()
    assert sorted(got) == sorted(want) and len(got["loss"]) == 3 and len(got["total_variation"]) == 4
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12)
    off = TC.HybridCost(direction="minimize", cost_with_weight=weights)
    off.calculate(arg_t)
    assert off.get_history() == {"loss": [], **{k: [] for k in weights}}
    ht.clear_history()
    torch.func.grad(lambda im: ht.calculate({**arg_t, "iwe": im, "backward_iwe": im}))(arg_t["iwe"])
    assert ht.get_history() == {"loss": [], **{k: [] for k in weights}}


# ---- the data-parallel DNN step ------------------------------------------------------


def test_dnn_train_step_parallel_matches_jax():
    """``dnn_train_step_parallel`` over 8 data devices (the CPU 8 times)
    against the JAX package's on its 8 virtual devices, from the same flax
    weights (``models/convert.py``), one Adam step on 8 items at 32x32:
    the loss to rel 1e-6 and the parameters to 1e-5, the JAX test's bounds
    (tests/test_models.py), and the port's single-device step to the same
    bounds."""
    from jax.sharding import Mesh

    from event_based_optical_flow_tpu.models import train as JT
    from event_based_optical_flow_tpu.types import pad_events
    from event_based_optical_flow_tpu_torch.models import convert
    from event_based_optical_flow_tpu_torch.models import train as TT

    size = (32, 32)
    model_j, params, tx, opt_state = JT.make_dnn_train_state(size, n_bin=4, lr=3e-4, scale_time=8.0)
    mesh_j = Mesh(np.asarray(jax.devices()), ("data",))
    step_j, _ = JT.dnn_train_step_parallel(model_j, tx, size, mesh_j, n_bin=4)
    evs, wgts = [], []
    for b in range(8):
        rng = np.random.default_rng(b)
        ev = np.stack([rng.uniform(0, 32, 600), rng.uniform(0, 32, 600), np.sort(rng.uniform(0, 0.1, 600)),
                       rng.integers(0, 2, 600).astype(float)], 1)
        ev[:, 1] = np.clip(ev[:, 1] + 40 * ev[:, 2], 0, 31.9)
        p, w = pad_events(ev, target_n=1024)
        evs.append(p)
        wgts.append(w)
    events, weights = np.stack(evs), np.stack(wgts)
    params_j, _, loss_j = step_j(params, opt_state, jnp.asarray(events), jnp.asarray(weights))

    results = []
    for parallel in (True, False):
        model_t, opt_t = TT.make_dnn_train_state(size, n_bin=4, lr=3e-4, scale_time=8.0, device=CPU,
                                                 dtype=torch.float32)
        model_t.load_state_dict(convert.params_from_flax(params))
        if parallel:
            step_t, _ = TT.dnn_train_step_parallel(model_t, opt_t, size, TSH.make_mesh(8, devices=_cpus(8)), n_bin=4)
        else:
            step_t, _ = TT.dnn_train_step(model_t, opt_t, size, n_bin=4)
        loss_t = step_t(torch.as_tensor(events, dtype=torch.float32), torch.as_tensor(weights, dtype=torch.float32))
        results.append((float(loss_t), model_t))
    (loss_p, model_p), (loss_s, model_s) = results
    assert loss_p == pytest.approx(float(loss_j), rel=1e-6)
    assert loss_p == pytest.approx(loss_s, rel=1e-6)
    want = convert.params_from_flax(params_j)
    for name, tensor in model_p.state_dict().items():
        np.testing.assert_allclose(tensor.numpy(), want[name].numpy(), atol=1e-5, err_msg=name)
        np.testing.assert_allclose(tensor.numpy(), model_s.state_dict()[name].numpy(), atol=1e-5, err_msg=name)
