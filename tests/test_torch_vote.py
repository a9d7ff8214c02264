"""The standalone bilinear vote (K8, ``ops/vote.py``) against the JAX
package's Pallas kernel ``ops/pallas_iwe.py::bilinear_vote_pallas`` (in
interpret mode on the CPU), in float64.

* The plain version (what a CPU tensor runs, and the CUDA kernel's test
  oracle) on ``[n, 4]`` events and on the init sweep's ``[P, K, C, 4]``
  batch (JAX: vmapped over ``[P * K, C, 4]``), with scalar and per-event
  weights, zero-weight padded events and corners on all four borders
  (x in ``[H - 1, H)``, y in ``[W - 1, W)``, negative coordinates): to
  1e-12 x the largest pixel (float64 sums of the same votes in another
  order).
* ``BilinearVote``'s analytic four-corner backward (dx, dy, dweight)
  against ``jax.grad`` through ``bilinear_vote_pallas``'s custom VJP, and
  against autograd through the plain scatter: to 1e-10.
* Routing: a CPU tensor runs the plain version and launches nothing; the
  kernel wrapper refuses a CPU tensor.  The CUDA kernel itself is held to
  the plain version in ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_based_optical_flow_tpu.ops.pallas_iwe import bilinear_vote_pallas
from event_based_optical_flow_tpu_torch.ops import iwe as TI
from event_based_optical_flow_tpu_torch.ops import vote as TV

H, W = 13, 19
FWD_TOL = 1e-12  # x the largest pixel
GRAD_TOL = 1e-10


def _events(rng, n, pad=40):
    """[n, 4] events over the image and past its borders: interior
    positions, exact integers, the last row / column band [H - 1, H) /
    [W - 1, W), slightly negative coordinates, and ``pad`` padded rows at
    (-10, -10) (weight 0 in ``_weights``)."""
    x = rng.uniform(0, H - 1, n)
    y = rng.uniform(0, W - 1, n)
    x[:30], y[:30] = np.round(x[:30]), np.round(y[:30])
    x[30:45] = rng.uniform(H - 1, H, 15)
    y[45:60] = rng.uniform(W - 1, W, 15)
    x[60:70] = rng.uniform(-0.999, 0.0, 10)
    y[70:80] = rng.uniform(-0.999, 0.0, 10)
    x[80:85], y[80:85] = H - 1, W - 1
    x[n - pad:], y[n - pad:] = -10.0, -10.0
    return np.stack([x, y, rng.uniform(0, 0.1, n), rng.integers(0, 2, n)], axis=1)


def _weights(rng, shape, pad=40):
    w = rng.uniform(0.2, 1.7, shape)
    w[..., shape[-1] - pad:] = 0.0
    w[..., 100:110] = 0.0  # in-image events with zero weight are inert too
    return w


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _jax_vote(events, weight):
    """bilinear_vote_pallas on ``[..., n, 4]`` events (vmapped over the
    flattened batch) with a scalar or broadcastable weight."""
    batch, n = events.shape[:-2], events.shape[-2]
    ev = jnp.asarray(events.reshape((-1, n, 4)) if batch else events)
    if isinstance(weight, float):
        out = bilinear_vote_pallas(ev, (H, W), weight=weight)
    else:
        wt = np.broadcast_to(weight, batch + (n,))
        out = bilinear_vote_pallas(ev, (H, W), weight=jnp.asarray(wt.reshape((-1, n)) if batch else wt))
    return np.asarray(out).reshape(batch + (H, W))


@pytest.mark.parametrize("weight", ["one", "scalar", "per-event"])
def test_plain_matches_pallas_on_one_event_set(weight):
    rng = np.random.default_rng(0)
    ev = _events(rng, 600)
    wt = {"one": 1.0, "scalar": 0.7, "per-event": _weights(rng, (600,))}[weight]
    tw = wt if isinstance(wt, float) else torch.as_tensor(wt)
    got = TV.bilinear_vote_plain(torch.as_tensor(ev), (H, W), tw).numpy()
    _close(got, _jax_vote(ev, wt), FWD_TOL)
    if weight == "per-event":
        # the padded rows vote nothing: the vote of the unpadded events alone
        keep = wt != 0
        alone = TV.bilinear_vote_plain(torch.as_tensor(ev[keep]), (H, W), torch.as_tensor(wt[keep])).numpy()
        _close(got, alone, FWD_TOL)


@pytest.mark.parametrize("weight", ["scalar", "per-patch"])
def test_plain_matches_pallas_on_the_sweep_batch(weight):
    """The init sweep's call: P patches x K candidates of C events each,
    the patch's weights [P, 1, C] broadcast over the candidates."""
    rng = np.random.default_rng(1)
    P, K, C = 3, 4, 256
    ev = np.stack([np.stack([_events(rng, C) for _ in range(K)]) for _ in range(P)])
    wt = 1.0 if weight == "scalar" else _weights(rng, (P, 1, C))
    tw = wt if isinstance(wt, float) else torch.as_tensor(wt)
    got = TV.bilinear_vote_plain(torch.as_tensor(ev), (H, W), tw).numpy()
    assert got.shape == (P, K, H, W)
    _close(got, _jax_vote(ev, wt), FWD_TOL)


@pytest.mark.parametrize("batched", [False, True])
def test_analytic_backward_matches_jax_grad(batched):
    """d/dx, d/dy and d/dweight of <vote, g> through ``BilinearVote`` (CPU
    tensors: the plain forward, the analytic backward) against jax.grad
    through bilinear_vote_pallas, and against autograd through the plain
    scatter."""
    rng = np.random.default_rng(2)
    shape = (2, 3) if batched else ()
    n = 300
    ev = np.stack([_events(rng, n) for _ in range(int(np.prod(shape)))]).reshape(shape + (n, 4))
    wt = _weights(rng, (2, 1, n) if batched else (n,))
    g = rng.normal(size=shape + (H, W))

    def jax_loss(xy, w):
        events = jnp.concatenate([xy, jnp.asarray(ev[..., 2:])], axis=-1)
        return jnp.sum(jnp.asarray(_jax_vote_traced(events, w, shape, n)) * g)

    want_xy, want_w = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(ev[..., :2]), jnp.asarray(wt))

    et = torch.as_tensor(ev).requires_grad_(True)
    wtt = torch.as_tensor(wt).requires_grad_(True)
    out = TV.BilinearVote.apply(et, wtt, (H, W), 1e-6)
    got_e, got_w = torch.autograd.grad((out * torch.as_tensor(g)).sum(), (et, wtt))
    assert torch.count_nonzero(got_e[..., 2:]) == 0
    _close(got_e[..., :2].numpy(), np.asarray(want_xy), GRAD_TOL)
    _close(got_w.numpy(), np.asarray(want_w), GRAD_TOL)

    ep = torch.as_tensor(ev).requires_grad_(True)
    wp = torch.as_tensor(wt).requires_grad_(True)
    plain_e, plain_w = torch.autograd.grad(
        (TV.bilinear_vote_plain(ep, (H, W), wp) * torch.as_tensor(g)).sum(), (ep, wp))
    _close(got_e.numpy(), plain_e.numpy(), GRAD_TOL)
    _close(got_w.numpy(), plain_w.numpy(), GRAD_TOL)


def _jax_vote_traced(events, weight, shape, n):
    if not shape:
        return bilinear_vote_pallas(events, (H, W), weight=weight)
    flat = bilinear_vote_pallas(events.reshape((-1, n, 4)), (H, W),
                                weight=jnp.broadcast_to(weight, shape + (n,)).reshape((-1, n)))
    return flat.reshape(shape + (H, W))


def test_scalar_weight_backward_has_no_weight_gradient():
    rng = np.random.default_rng(3)
    ev = torch.as_tensor(_events(rng, 200)).requires_grad_(True)
    g = torch.as_tensor(rng.normal(size=(H, W)))
    (got,) = torch.autograd.grad((TV.BilinearVote.apply(ev, 0.5, (H, W), 1e-6) * g).sum(), ev)
    (want,) = torch.autograd.grad((TV.bilinear_vote_plain(ev, (H, W), 0.5) * g).sum(), ev)
    _close(got.numpy(), want.numpy(), GRAD_TOL)


def test_cpu_tensors_run_the_plain_version():
    """``bilinear_vote`` (and ``create_iwe`` / ``event_mask`` through it) on
    CPU tensors: the plain version's bits, no kernel launch; the kernel
    wrapper refuses a CPU tensor."""
    rng = np.random.default_rng(4)
    ev = torch.as_tensor(_events(rng, 500))
    wt = torch.as_tensor(_weights(rng, (500,)))
    before = TV.launch_counts()
    assert torch.equal(TI.bilinear_vote(ev, (H, W), wt), TV.bilinear_vote_plain(ev, (H, W), wt))
    assert torch.equal(TI.event_mask(ev, (H, W))[0], TV.bilinear_vote_plain(ev, (H, W)) != 0)
    assert TV.launch_counts() == before == {"vote": before["vote"]}
    with pytest.raises(ValueError, match="CUDA tensors"):
        TV.bilinear_vote_kernel(ev, (H, W), wt)


# --- the exact model of K8's bits ---------------------------------------------


def _model_case(name, rng):
    """(events, weight) of one call shape: "one" set of 600 events with
    per-event weights or a scalar, the "sweep" batch [P, K, C, 4] with
    per-patch weights [P, 1, C] or a scalar; a few NaN positions (an empty
    sweep patch's events) vote nothing."""
    if name.startswith("one"):
        ev = _events(rng, 600)
        wt = 0.7 if name.endswith("scalar") else _weights(rng, (600,))
    else:
        P, K, C = 3, 4, 256
        ev = np.stack([np.stack([_events(rng, C) for _ in range(K)]) for _ in range(P)])
        wt = 1.0 if name.endswith("scalar") else _weights(rng, (P, 1, C))
    ev[..., 90:93, :2] = np.nan
    return ev, wt


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["one-scalar", "one-per-event", "sweep-scalar", "sweep-per-patch"])
def test_exact_vote_model_matches_plain_version(name, dtype):
    """K8's model against the plain version on the same tensors: within
    2^-37 (half the fixed-point unit) per vote in each pixel, plus the
    plain version's own summation rounding (1e-12 x the largest pixel in
    float64, 1e-5 in float32)."""
    ev, wt = _model_case(name, np.random.default_rng(8))
    ev = torch.as_tensor(ev, dtype=dtype)
    wt = wt if isinstance(wt, float) else torch.as_tensor(wt, dtype=dtype)
    model = TV.bilinear_vote_fixed_reference(ev, (H, W), wt)
    plain = TV.bilinear_vote_plain(ev, (H, W), wt)
    inds, vals, batch = TV.corner_terms(ev, (H, W), wt)
    votes = torch.zeros(plain.numel(), dtype=torch.float64).index_add_(0, inds, (vals != 0).double())
    assert model.shape == plain.shape == batch + (H, W) and votes.max() > 1
    assert not model.isnan().any()
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    tol = votes.reshape(plain.shape) * 2.0 ** -(TV.FIX_BITS + 1) + rtol * plain.abs().max().double()
    assert ((model.double() - plain.double()).abs() <= tol).all()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("name", ["one-per-event", "sweep-per-patch"])
def test_vote_model_bits_do_not_depend_on_event_order(name, dtype):
    """Integer sums: shuffling each image's events (and their weights)
    leaves the model's bits as they are."""
    rng = np.random.default_rng(9)
    ev, wt = _model_case(name, rng)
    order = rng.permutation(ev.shape[-2])
    shuffled_wt = wt[..., order]
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)
    want = TV.bilinear_vote_fixed_reference(t(ev), (H, W), t(wt))
    got = TV.bilinear_vote_fixed_reference(t(ev[..., order, :]), (H, W), t(shuffled_wt))
    assert torch.equal(got, want)


def test_event_rows_read_an_expand_once():
    """The kernel wrapper's event layout: events expanded over trailing batch
    axes (the voxel grid's planes of one event set) are passed as their
    distinct rows, image ``i`` reading row ``i // rep``, with no copy of a
    contiguous base; any other layout is copied out to one row per image."""
    base = torch.as_tensor(_events(np.random.default_rng(6), 300)).reshape(2, 150, 4)
    planes = base[:, None].expand(2, 4, 150, 4)
    rows, rep = TV._event_rows(planes, (2, 4))
    assert rep == 4 and rows.data_ptr() == base.data_ptr() and torch.equal(rows, base)
    # a plane index that the kernel computes as i // rep reads its set's row
    flat = planes.reshape(8, 150, 4)
    assert all(torch.equal(flat[i], rows[i // rep]) for i in range(8))
    rows, rep = TV._event_rows(base[None, :, None].expand(3, 2, 1, 150, 4), (3, 2, 1))
    assert rep == 1 and rows.shape == (3, 2, 1, 150, 4) and rows.is_contiguous()
    rows, rep = TV._event_rows(base[:, None, None].expand(2, 3, 5, 150, 4), (2, 3, 5))
    assert rep == 15 and torch.equal(rows, base)
    rows, rep = TV._event_rows(base, (2,))
    assert rep == 1 and rows.data_ptr() == base.data_ptr()
