"""The port's EV-FlowNet path (``event_based_optical_flow_tpu_torch/models/``)
against the JAX package's (``event_based_optical_flow_tpu/models/``), in
float64 on the CPU.

The JAX side runs at ``iwe_backend: scatter`` (its exact scatter vote, the
semantics of the port's plain vote), and at ``pallas`` (the TPU kernel K8
in interpret mode) for the loss values.  Flax initializes in float32: its
parameters are cast to float64 after ``init``, and carried into the port
with ``models.convert.params_from_flax``.

* Building blocks on a non-square 32x48 input (an H/W swap shows): the
  stride-2 conv's asymmetric ``SAME`` pad, the stride-1 conv, the residual
  block, the decoder stage (the 2x upsample and reflect pad written as
  slice sums), each with and without the instance norm: to 1e-12 x the
  largest value (float64 sums in another order).
* ``EVFlowNet`` forward from converted weights, ``use_norm`` off and on: to
  1e-9 x the largest flow; the conversion round trip is exact.
* ``events_to_voxel_grid`` on a batch with padded events and an all-padded
  item, ``_masked_min``/``_masked_max`` on that item; the CMax losses
  (``unsupervised_cmax_loss``, ``multi_scale_cmax_loss``) and
  ``supervised_epe_loss`` with their gradients w.r.t. the flow: to 1e-9 x
  the largest value; the CMax loss values also against JAX at ``pallas``.
* Far-out (+-1e6, inf) and NaN event positions through the vote: they vote
  nothing and get a zero gradient on both of the port's routes; every other
  event's gradient is the Pallas kernel's custom VJP's.
* Three Adam steps (``dnn_train_step``, multi-scale) from the same
  converted weights: loss per step to 1e-7 relative, every parameter to
  1e-7 x its tensor's largest value.
* A checkpoint round trip keeps training with the same bits; a JAX (orbax)
  checkpoint directory is refused, not read.
* ``run_dnn_flow`` at 32x32, 2 steps, 3 frames (2 eval windows) against the
  JAX package's run: its orbax checkpoint, converted, against the port's
  trained parameters, and ``dnn_flow_error.txt`` per frame to 1e-6.
* The DNN config's validation: the JAX package's warnings, and
  ``dnn.data_parallel: true`` refused.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from event_based_optical_flow_tpu import config as jconfig
from event_based_optical_flow_tpu.models import basic_layers as JB
from event_based_optical_flow_tpu.models import ev_flownet as JE
from event_based_optical_flow_tpu.models import train as JT
from event_based_optical_flow_tpu.ops import warp as JW
from event_based_optical_flow_tpu.ops.pallas_iwe import bilinear_vote_pallas
from event_based_optical_flow_tpu_torch.models import basic_layers as TB
from event_based_optical_flow_tpu_torch.models import convert
from event_based_optical_flow_tpu_torch.models import ev_flownet as TE
from event_based_optical_flow_tpu_torch.models import train as TT
from event_based_optical_flow_tpu_torch.ops import vote as TV
from event_based_optical_flow_tpu_torch.ops import warp as TW

REPO = pathlib.Path(__file__).resolve().parent.parent
H, W = 32, 48
BLOCK_TOL = 1e-12  # x the largest value
NET_TOL = 1e-9
LOSS_TOL = 1e-9
ADAM_TOL = 1e-7
EVAL_TOL = 1e-6
_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_MODULE = {"Conv_0": "conv", "Conv_1": "head", "GroupNorm_0": "norm"}


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def backend():
    """Set the JAX package's standalone-vote backend; restored afterwards."""
    before = jconfig.raw_iwe_backend()
    yield jconfig.set_iwe_backend
    jconfig.set_iwe_backend(before)


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, np.abs(want).max()))


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _perturbed(tree, rng):
    """Float64 params with random biases and norm scales (flax initializes
    them to 0 and 1, which would hide a mis-mapped one)."""
    flat = jax.tree_util.tree_flatten_with_path(_f64(tree))
    leaves = [v + 0.05 * rng.normal(size=v.shape) if "kernel" not in jax.tree_util.keystr(k) else v
              for k, v in flat[0]]
    return jax.tree_util.tree_unflatten(flat[1], leaves)


def _block_state(tree) -> dict:
    """A building block's flax params as its port module's state_dict."""
    out = {}
    for path, value in jax.tree_util.tree_flatten_with_path(tree.get("params", tree))[0]:
        keys = [p.key for p in path]
        names = [_MODULE.get(k) or f"blocks.{k.rsplit('_', 1)[1]}" for k in keys[:-1]]
        value = np.asarray(value)
        if keys[-1] == "kernel":
            value = value.transpose(3, 2, 0, 1)
        out[".".join(names + [_LEAF[keys[-1]]])] = torch.from_numpy(np.ascontiguousarray(value))
    return out


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, -3)))


def _events(rng, n=1500, pad=500, b=2, h=H, w=W):
    """[b, n + pad, 4] events over the image (some on exact integers, some on
    the last row / column) padded as ``pad_events`` pads, and their weights."""
    evs, wts = [], []
    for _ in range(b):
        x = rng.uniform(0, h - 1, n)
        y = rng.uniform(0, w - 1, n)
        x[:100], y[:100] = np.round(x[:100]), np.round(y[:100])
        x[100:120] = h - 1
        t = np.sort(rng.uniform(0.0, 0.1, n))
        ev = np.stack([x, y, t - t.min(), rng.integers(0, 2, n).astype(float)], axis=1)
        padded = np.zeros((n + pad, 4))
        padded[:n] = ev
        wt = np.zeros(n + pad)
        wt[:n] = 1.0
        evs.append(padded)
        wts.append(wt)
    return np.stack(evs), np.stack(wts)


def _flows(rng, b=2, sizes=((4, 6), (8, 12), (16, 24), (32, 48)), amp=30.0):
    """Random smooth flows (px/s; x the 0.1 s window: a few px) per scale."""
    out = {}
    for i, (h, w) in enumerate(sizes):
        yy, xx = np.meshgrid(np.linspace(0, 1, w), np.linspace(0, 1, h))
        base = np.stack([np.sin(3 * xx + 1) * np.cos(2 * yy), np.cos(2 * xx) * np.sin(3 * yy + 0.5)])
        out[f"flow{i}"] = amp * (base[None] + 0.3 * rng.normal(size=(b, 2, h, w)))
    return out


# ---- building blocks -------------------------------------------------------


@pytest.mark.parametrize("strides", [2, 1])
@pytest.mark.parametrize("use_norm", [False, True])
def test_conv_block_matches_flax(strides, use_norm):
    """ConvBlock, stride 2 (flax pads (0, 1) on an even side) and 1."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, H, W, 5))
    jm = JB.ConvBlock(7, strides=strides, use_norm=use_norm)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 5))), rng)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = TB.ConvBlock(5, 7, strides=strides, use_norm=use_norm).double()
    tm.load_state_dict(_block_state(params))
    got = tm(_nchw(x)).detach()
    assert got.shape == (2, 7, H // strides, W // strides)
    _close(got, _nchw(want), BLOCK_TOL)


@pytest.mark.parametrize("use_norm", [False, True])
def test_residual_block_matches_flax(use_norm):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, H // 4, W // 4, 6))
    jm = JB.ResidualBlock(6, use_norm)
    params = _perturbed(jm.init(jax.random.PRNGKey(1), jnp.zeros((1, H // 4, W // 4, 6))), rng)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = TB.ResidualBlock(6, use_norm).double()
    tm.load_state_dict(_block_state(params))
    _close(tm(_nchw(x)).detach(), _nchw(want), BLOCK_TOL)


@pytest.mark.parametrize("use_norm", [False, True])
def test_upsample_conv_and_predict_matches_flax(use_norm):
    """The decoder stage: jax.image.resize's 2x linear upsample and the
    reflect pad against their slice-sum forms, then the conv and the tanh
    flow head; both outputs."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, H // 2, W // 2, 9))
    jm = JB.UpsampleConvAndPredict(5, scale=7.0, use_norm=use_norm)
    params = _perturbed(jm.init(jax.random.PRNGKey(2), jnp.zeros((1, H // 2, W // 2, 9))), rng)
    want_x, want_flow = jm.apply(params, jnp.asarray(x))
    tm = TB.UpsampleConvAndPredict(9, 5, scale=7.0, use_norm=use_norm).double()
    tm.load_state_dict(_block_state(params))
    got_x, got_flow = tm(_nchw(x))
    assert got_flow.shape == (2, 2, H, W)
    _close(got_x.detach(), _nchw(want_x), BLOCK_TOL)
    _close(got_flow.detach(), _nchw(want_flow), BLOCK_TOL)


def test_upsample_and_reflect_pad_match_jax_on_odd_sides():
    """The slice-sum upsample and reflect pad alone, on 1-, 2- and odd-sized
    sides, against jax.image.resize and jnp.pad."""
    rng = np.random.default_rng(3)
    for h, w in ((1, 3), (2, 5), (7, 4)):
        x = rng.normal(size=(2, 3, h, w))
        want = jax.image.resize(jnp.asarray(x), (2, 3, 2 * h, 2 * w), method="linear")
        _close(TB.upsample2x(torch.from_numpy(x)), want, BLOCK_TOL)
        if min(h, w) >= 2:
            want = jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (1, 1), (1, 1)), mode="reflect")
            np.testing.assert_array_equal(TB.reflect_pad1(torch.from_numpy(x)).numpy(), np.asarray(want))


# ---- the network and its weights -------------------------------------------


@pytest.mark.parametrize("use_norm", [False, True])
def test_evflownet_forward_from_converted_weights(use_norm):
    """The full network at the published widths, 32x48, from
    ``params_from_flax`` weights (biases and norm scales perturbed)."""
    rng = np.random.default_rng(4)
    jm = JE.EVFlowNet(n_bin=4, scale_time=8.0, use_norm=use_norm)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 4))), rng)
    voxel = rng.normal(size=(2, H, W, 4))
    want = jm.apply(params, jnp.asarray(voxel))
    tm = TE.EVFlowNet(n_bin=4, scale_time=8.0, use_norm=use_norm).double()
    state = convert.params_from_flax(params)
    tm.load_state_dict(state)
    with torch.no_grad():
        got = tm(_nchw(voxel))
    assert sorted(got) == ["flow0", "flow1", "flow2", "flow3"]
    for k in got:
        assert got[k].shape == want[k].shape
        _close(got[k], want[k], NET_TOL)
    back = convert.params_to_flax(state)
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert flat_back.keys() == flat_want.keys()
    for k in flat_want:
        np.testing.assert_array_equal(flat_back[k], flat_want[k])


def test_port_init_follows_flax_distributions():
    """The port's own init: lecun-normal kernels (std sqrt(1/fan_in),
    truncated at 2 std), zero biases; the same seed gives the same
    weights, another seed others."""
    a, b, c = (TE.EVFlowNet(seed=s).state_dict() for s in (0, 0, 1))
    for name, w in a.items():
        assert torch.equal(w, b[name])
        if name.endswith("bias"):
            assert not w.any()
            continue
        fan_in = w.shape[1] * w.shape[2] * w.shape[3]
        assert w.abs().max() <= 2.0 * np.sqrt(1.0 / fan_in) / 0.87962566103423978 + 1e-7
        if w.numel() > 10000:
            assert abs(w.std().item() * np.sqrt(fan_in) - 1.0) < 0.02
            assert not torch.equal(w, c[name])


# ---- the voxel grid and the losses -----------------------------------------


def test_voxel_grid_matches_jax_with_padding(backend):
    """Batched voxel grids ([B, n_bin, H, W], one vote call) against the JAX
    package's per-item grids (vmapped), signed and temporally weighted
    votes, padded events; the third item is all padding: the masked time
    range of JAX's ``_masked_min``/``_masked_max`` (+-float max) and an
    empty grid."""
    backend("scatter")
    rng = np.random.default_rng(5)
    ev, wt = _events(rng, b=3)
    wt[2] = 0.0
    ev[2, :, :2] = 0.0
    for fn_t, fn_j in ((TW._masked_min, JW._masked_min), (TW._masked_max, JW._masked_max)):
        got = fn_t(torch.from_numpy(ev[..., 2]), torch.from_numpy(wt)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jax.vmap(fn_j)(ev[..., 2], wt)))
    assert TW._masked_min(torch.from_numpy(ev[2, :, 2]), torch.from_numpy(wt[2])).item() == np.finfo(float).max
    want = jax.vmap(lambda e, w: JE.events_to_voxel_grid(e, (H, W), 5, w))(jnp.asarray(ev), jnp.asarray(wt))
    got = TE.events_to_voxel_grid(torch.from_numpy(ev), (H, W), 5, torch.from_numpy(wt))
    assert got.shape == (3, 5, H, W)
    _close(got, np.moveaxis(np.asarray(want), -1, -3), LOSS_TOL)
    assert not got[2].any() and (got[:2] < 0).any()


def _jax_cmax(kind, flows, ev, wt):
    """The JAX package's per-item loss (vmapped) and its gradient w.r.t. the
    flows of its sum."""
    if kind == "single":
        fn = lambda f, e, w: JT.unsupervised_cmax_loss(f, e, (H, W), w)
        args = (jnp.asarray(flows["flow3"]),)
    else:
        fn = lambda f0, f1, f2, f3, e, w: JT.multi_scale_cmax_loss(
            {"flow0": f0, "flow1": f1, "flow2": f2, "flow3": f3}, e, (H, W), w)
        args = tuple(jnp.asarray(flows[f"flow{i}"]) for i in range(4))
    batched = jax.vmap(fn)
    total = lambda *a: jnp.sum(batched(*a, jnp.asarray(ev), jnp.asarray(wt)))
    value = batched(*args, jnp.asarray(ev), jnp.asarray(wt))
    grads = jax.grad(total, argnums=tuple(range(len(args))))(*args)
    return np.asarray(value), [np.asarray(g) for g in grads]


def _port_cmax(kind, flows, ev, wt):
    keys = ["flow3"] if kind == "single" else [f"flow{i}" for i in range(4)]
    tf = {k: torch.from_numpy(flows[k]).requires_grad_(True) for k in keys}
    e, w = torch.from_numpy(ev), torch.from_numpy(wt)
    if kind == "single":
        value = TT.unsupervised_cmax_loss(tf["flow3"], e, (H, W), w)
    else:
        value = TT.multi_scale_cmax_loss(tf, e, (H, W), w)
    value.sum().backward()
    return value.detach().numpy(), [tf[k].grad.numpy() for k in keys]


@pytest.mark.parametrize("kind", ["single", "multi_scale"])
def test_cmax_losses_and_flow_gradients_match_jax(backend, kind):
    """unsupervised_cmax_loss (flow head 3) and multi_scale_cmax_loss (all
    four heads, each on its downscaled grid): per-item values and the
    gradient w.r.t. every head's flow, through the dense-flow gather, the
    vote's corner weights, the blur, the NGM ratios and TV."""
    backend("scatter")
    rng = np.random.default_rng(6)
    ev, wt = _events(rng)
    flows = _flows(rng)
    want, want_g = _jax_cmax(kind, flows, ev, wt)
    got, got_g = _port_cmax(kind, flows, ev, wt)
    assert got.shape == (2,) and np.isfinite(got).all()
    _close(got, want, LOSS_TOL)
    for g, wg in zip(got_g, want_g):
        assert np.abs(wg).max() > 0
        _close(g, wg, LOSS_TOL)


@pytest.mark.parametrize("kind", ["single", "multi_scale"])
def test_cmax_loss_values_match_jax_pallas(backend, kind):
    """The same losses against the JAX package at ``iwe_backend: pallas``
    (K8, the TPU kernel, in interpret mode)."""
    backend("pallas")
    rng = np.random.default_rng(7)
    ev, wt = _events(rng, n=700, pad=124)
    flows = _flows(rng)
    fn = ((lambda f, e, w: JT.unsupervised_cmax_loss(f, e, (H, W), w)) if kind == "single" else
          (lambda f0, f1, f2, f3, e, w: JT.multi_scale_cmax_loss(
              {"flow0": f0, "flow1": f1, "flow2": f2, "flow3": f3}, e, (H, W), w)))
    keys = ["flow3"] if kind == "single" else [f"flow{i}" for i in range(4)]
    want = jax.vmap(fn)(*(jnp.asarray(flows[k]) for k in keys), jnp.asarray(ev), jnp.asarray(wt))
    got, _ = _port_cmax(kind, flows, ev, wt)
    _close(got, want, LOSS_TOL)


def test_supervised_epe_loss_matches_jax():
    """supervised_epe_loss per item with its gradient w.r.t. the flow
    (finite GT), the window spans of ``_event_t_scale``; an inf-marked GT
    half scores only the valid half, in both packages."""
    rng = np.random.default_rng(8)
    ev, wt = _events(rng)
    flow = 30.0 * rng.normal(size=(2, 2, H, W))
    gt = rng.normal(size=(2, 2, H, W))
    spans = jax.vmap(JT._event_t_scale)(jnp.asarray(ev), jnp.asarray(wt))
    np.testing.assert_array_equal(TT._event_t_scale(torch.from_numpy(ev), torch.from_numpy(wt)).numpy(),
                                  np.asarray(spans))
    fn = jax.vmap(JT.supervised_epe_loss)
    want = fn(jnp.asarray(flow), jnp.asarray(gt), spans)
    want_g = jax.grad(lambda f: jnp.sum(fn(f, jnp.asarray(gt), spans)))(jnp.asarray(flow))
    tf = torch.from_numpy(flow).requires_grad_(True)
    got = TT.supervised_epe_loss(tf, torch.from_numpy(gt), torch.tensor(np.asarray(spans)))
    got.sum().backward()
    _close(got.detach(), want, LOSS_TOL)
    _close(tf.grad, want_g, LOSS_TOL)
    half = np.stack([np.full((4, 4), 3.0), np.zeros((4, 4))])
    half[:, :2] = np.inf
    zero = torch.zeros(2, 4, 4, dtype=torch.float64, requires_grad=True)
    loss = TT.supervised_epe_loss(zero, torch.from_numpy(half))
    assert loss.item() == pytest.approx(3.0)
    assert float(JT.supervised_epe_loss(jnp.zeros((2, 4, 4)), jnp.asarray(half))) == pytest.approx(3.0)
    loss.backward()
    assert torch.isfinite(zero.grad).all() and not zero.grad[:, :2].any()


def test_far_and_nan_positions_vote_nothing_with_zero_gradient():
    """Events at +-1e6, inf and NaN positions vote nothing and get a zero
    gradient, through the plain vote's autograd and through
    ``BilinearVote``'s analytic backward (what a CUDA tensor runs); the
    other events' images and gradients are the Pallas kernel's (its custom
    VJP) on those events alone."""
    rng = np.random.default_rng(9)
    n, h, w = 300, 9, 11
    ev = np.stack([rng.uniform(0, h - 1, n), rng.uniform(0, w - 1, n), rng.uniform(0, 1, n), np.ones(n)], 1)
    wt = rng.uniform(-1.0, 1.0, n)  # signed, as the voxel grid votes them
    bad = np.array([[1e6, 3.0], [-1e6, 2.0], [4.0, 1e6], [2.0, -1e6], [np.nan, 3.0], [2.0, np.nan],
                    [np.inf, 1.0], [np.nan, np.nan]])
    ev[: len(bad), :2] = bad
    g = rng.normal(size=(h, w))
    good = slice(len(bad), n)
    jfn = lambda e: jnp.sum(bilinear_vote_pallas(e, (h, w), weight=jnp.asarray(wt[good])) * g)
    want_image = bilinear_vote_pallas(jnp.asarray(ev[good]), (h, w), weight=jnp.asarray(wt[good]))
    want_grad = np.asarray(jax.grad(jfn)(jnp.asarray(ev[good])))
    for vote in (lambda e, t: TV.bilinear_vote(e, (h, w), t),
                 lambda e, t: TV.BilinearVote.apply(e, t, (h, w), 1e-6)):
        e = torch.from_numpy(ev).requires_grad_(True)
        image = vote(e, torch.from_numpy(wt))
        _close(image.detach(), want_image, 1e-12)
        (image * torch.from_numpy(g)).sum().backward()
        assert not e.grad[: len(bad)].any()
        _close(e.grad[good, :2], want_grad[:, :2], 1e-10)


# ---- training ---------------------------------------------------------------


def _jax_state(image_size, lr, scale_time, seed=0):
    model, params, tx, _ = JT.make_dnn_train_state(image_size, 4, lr=lr, seed=seed, scale_time=scale_time)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
    return model, params, tx, tx.init(params)


def test_three_adam_steps_match_optax(backend):
    """dnn_train_step (multi-scale, batch 2) from the same converted weights:
    three steps of torch.optim.Adam against optax.adam (same defaults, same
    lr): the loss of every step and every parameter afterwards."""
    backend("scatter")
    rng = np.random.default_rng(10)
    image_size, lr = (32, 32), 3e-4
    ev, wt = _events(rng, n=900, pad=124, h=32, w=32)
    jmodel, params, tx, opt_state = _jax_state(image_size, lr, 8.0)
    jstep, _ = JT.dnn_train_step(jmodel, tx, image_size, 4, multi_scale=True)
    tmodel, topt = TT.make_dnn_train_state(image_size, 4, lr=lr, scale_time=8.0, device="cpu", dtype=torch.float64)
    tmodel.load_state_dict(convert.params_from_flax(params))
    tstep, _ = TT.dnn_train_step(tmodel, topt, image_size, 4, multi_scale=True)
    for _ in range(3):
        params, opt_state, jloss = jstep(params, opt_state, jnp.asarray(ev), jnp.asarray(wt))
        tloss = tstep(torch.from_numpy(ev), torch.from_numpy(wt))
        assert float(tloss) == pytest.approx(float(jloss), rel=ADAM_TOL, abs=0)
    want = convert.params_from_flax(params)
    got = tmodel.state_dict()
    moved = 0
    for name, value in want.items():
        _close(got[name], value, ADAM_TOL)
        moved += int(not torch.equal(value, convert.params_from_flax(_jax_state(image_size, lr, 8.0)[1])[name]))
    assert moved == len(want)


def test_checkpoint_round_trip_keeps_training_bits(tmp_path):
    """save_dnn_checkpoint / latest_dnn_checkpoint / restore_dnn_checkpoint:
    the highest step is found, a fresh state from another seed restores to
    the saved bits, and one more step from either gives the same bits."""
    rng = np.random.default_rng(11)
    size = (16, 16)
    ev, wt = (torch.from_numpy(a) for a in _events(rng, n=300, pad=212, b=1, h=16, w=16))
    model, opt = TT.make_dnn_train_state(size, 2, seed=3, device="cpu", dtype=torch.float64)
    step, _ = TT.dnn_train_step(model, opt, size, 2)
    assert np.isfinite(float(step(ev, wt)))
    ckpt_dir = str(tmp_path / "ckpts")
    TT.save_dnn_checkpoint(ckpt_dir, model, opt, 1)
    TT.save_dnn_checkpoint(ckpt_dir, model, opt, 7)
    latest = TT.latest_dnn_checkpoint(ckpt_dir)
    assert latest is not None and latest.endswith("step_7")
    model2, opt2 = TT.make_dnn_train_state(size, 2, seed=99, device="cpu", dtype=torch.float64)
    assert TT.restore_dnn_checkpoint(latest, model2, opt2) == 7
    for (k, a), b in zip(model.state_dict().items(), model2.state_dict().values()):
        assert torch.equal(a, b), k
    step2, _ = TT.dnn_train_step(model2, opt2, size, 2)
    assert float(step(ev, wt)) == float(step2(ev, wt))
    for a, b in zip(model.state_dict().values(), model2.state_dict().values()):
        assert torch.equal(a, b)
    assert TT.latest_dnn_checkpoint(str(tmp_path / "nope")) is None


def test_orbax_checkpoint_is_refused(tmp_path):
    """A JAX package (orbax) checkpoint where the port looks for its own is
    refused with an error that names it, never misread."""
    _, params, _, opt_state = _jax_state((16, 16), 1e-4, 8.0)
    ckpt_dir = tmp_path / "out" / "checkpoints"
    JT.save_dnn_checkpoint(str(ckpt_dir), params, opt_state, 3)
    model, opt = TT.make_dnn_train_state((16, 16), device="cpu")
    with pytest.raises(ValueError, match="orbax"):
        TT.restore_dnn_checkpoint(str(ckpt_dir / "step_3"), model, opt)
    config = _run_config(tmp_path / "out", 16)
    with pytest.raises(ValueError, match="orbax"):
        TT.run_dnn_flow(config, _loader(config), torch.device("cpu"))


def _run_config(out_dir, size=32, supervised=False) -> dict:
    data_cfg = {"eval_dt": 1, "root": "", "dataset": "synthetic", "sequence": "dnn_t", "height": size,
                "width": size, "load_gt_flow": True, "gt": ".", "n_events_per_batch": 2048, "duration": 1.0,
                "event_rate": 20000, "n_frames": 3}
    dnn = {"n_bin": 4, "batch_size": 1, "n_steps": 2, "lr": 1e-4, **({"supervised": True} if supervised else {})}
    return {"is_dnn": True, "data": data_cfg, "dnn": dnn,
            "output": {"output_dir": str(out_dir), "show_interactive_result": False}}


def _loader(config):
    from event_based_optical_flow_tpu_torch import data as tdata

    loader = tdata.collections["synthetic"](config=config["data"])
    loader.set_sequence(config["data"]["sequence"])
    return loader


def _errors(path) -> list:
    return [ast.literal_eval(line.split("::", 1)[1]) for line in path.read_text().splitlines()]


@pytest.mark.parametrize("supervised", [False, True])
def test_run_dnn_flow_matches_jax(tmp_path, backend, monkeypatch, supervised):
    """run_dnn_flow on the synthetic loader (32x32, 2 steps, batch 1, 3
    frames: 2 eval windows), the JAX package's run with its parameters cast
    to float64, the port's from the same weights (``initial_state``) in
    float64: the same batch draws (with ``dnn.supervised``, the same GT
    windows), the trained parameters (JAX's orbax checkpoint restored and
    converted) and ``dnn_flow_error.txt`` per frame and its mean.  A rerun
    of the port restores its checkpoint, trains no step and evaluates the
    same; a supervised run on a loader without GT is refused."""
    from event_based_optical_flow_tpu import data as jdata
    from event_based_optical_flow_tpu import visualizer

    backend("scatter")
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    made = {}

    def state64(*args, **kw):
        model, params, tx, _ = make(*args, **kw)
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        made["params"] = params
        return model, params, tx, tx.init(params)

    make = JT.make_dnn_train_state
    monkeypatch.setattr(JT, "make_dnn_train_state", state64)
    config = _run_config(jax_dir, supervised=supervised)
    jloader = jdata.collections["synthetic"](config=config["data"])
    jloader.set_sequence("dnn_t")
    viz = visualizer.Visualizer((32, 32), show=False, save=True, save_dir=str(jax_dir))
    JT.run_dnn_flow(config, jloader, viz, evaluate=True)

    pconfig = _run_config(port_dir, supervised=supervised)
    initial = convert.params_from_flax(made["params"])
    make_port = TT.make_dnn_train_state
    monkeypatch.setattr(TT, "make_dnn_train_state", lambda *a, **kw: make_port(*a, **kw, dtype=torch.float64))
    run = TT.run_dnn_flow(pconfig, _loader(pconfig), torch.device("cpu"), evaluate=True, initial_state=initial)
    assert len(run["losses"]) == 2 and np.isfinite(run["losses"]).all()
    assert len(run["eval_zero_epe"]) == 2 and all(np.isfinite(z) and z > 0 for z in run["eval_zero_epe"])
    ckpt = JT.latest_dnn_checkpoint(str(jax_dir / "checkpoints"))
    jparams, _, step = JT.restore_dnn_checkpoint(ckpt, made["params"], optax.adam(1e-4).init(made["params"]))
    assert step == 2
    want = convert.params_from_flax(_f64(jparams))
    got = run["model"].state_dict()
    for name, value in want.items():
        _close(got[name], value, ADAM_TOL)
    want_err = _errors(jax_dir / "dnn_flow_error.txt")
    got_err = _errors(port_dir / "dnn_flow_error.txt")
    assert len(got_err) == len(want_err) == 3  # 2 frames and the mean
    for g, w in zip(got_err, want_err):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k] == pytest.approx(w[k], rel=0, abs=EVAL_TOL), k
    assert TT.latest_dnn_checkpoint(str(port_dir / "checkpoints")).endswith("step_2")
    rerun = TT.run_dnn_flow(pconfig, _loader(pconfig), torch.device("cpu"), evaluate=True)
    assert rerun["losses"] == []
    for a, b in zip(run["model"].state_dict().values(), rerun["model"].state_dict().values()):
        assert torch.equal(a, b)
    assert _errors(port_dir / "dnn_flow_error.txt") == got_err
    if supervised:
        loader = _loader(pconfig)
        loader.gt_flow_available = False
        with pytest.raises(ValueError, match="supervised"):
            TT.run_dnn_flow(_run_config(tmp_path / "gt_free", supervised=True), loader, torch.device("cpu"))


# ---- the config ------------------------------------------------------------


def test_dnn_config_validates_as_in_jax():
    """configs/synthetic_dnn.yaml validates with the JAX package's warnings,
    also with an unknown ``dnn`` key and without ``data.n_events_per_batch``
    (not required of a DNN config) and with ``dnn.data_parallel: true``
    (the multi-device train step)."""
    from event_based_optical_flow_tpu.utils import validate_config as jax_validate
    from event_based_optical_flow_tpu_torch.utils import validate_config

    config = yaml.safe_load((REPO / "configs" / "synthetic_dnn.yaml").read_text())
    assert validate_config(config) == jax_validate(config)
    config["dnn"]["surprise"] = 1
    del config["data"]["n_events_per_batch"]
    want = jax_validate(config)
    assert want == ["unknown config key 'dnn.surprise' (ignored?)"]
    assert validate_config(config) == want
    config["dnn"]["data_parallel"] = True
    assert validate_config(config) == jax_validate(config) == want
