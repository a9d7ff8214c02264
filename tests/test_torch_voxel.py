"""The port's time-aware flow voxel (``flow/voxel.py``), its metric warp
(``ops/warp.py::warp_voxel_flow``) and the time-aware ``FrameEvents``
against the JAX package, in float64.

* Chains and schemes: ``upwind`` / ``burgers`` chains and the direct
  schemes (``same``, ``bilinear``, ``max``; the host ``griddata`` ones
  for one advection step) against
  ``construct_dense_flow_voxel``, both t0 locations, batched and unbatched,
  with and without ``clamp``, to 1e-10 x max(1, max|ref|) (the same float64
  ops in the same order; an unstable upwind chain grows the values); and
  to the golden ``tests/golden/reference_oracle.npz`` keys.
* Chain gradients: the VJP against ``jax.vjp`` on a field with exact zeros
  (ties of ``max(u, 0)`` and of the one-sided differences, where the
  gradient splits 1/2 : 1/2 in both frameworks), to 1e-10 x max|ref|.
* The metric warp: ``warp_voxel_flow`` against JAX's, events on bin edges
  and outside the image included, to 1e-12.
* ``FrameEvents``' time bins come from the float64 ``dtf`` as JAX's
  ``pack_events_by_band_bin`` computes them, and the events are sorted by
  (bin, source pixel); without ``time_bin`` the order is the dense one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_based_optical_flow_tpu.flow import voxel as JV
from event_based_optical_flow_tpu.ops import warp as JW
from event_based_optical_flow_tpu_torch.flow import voxel as TV
from event_based_optical_flow_tpu_torch.ops import warp as TW
from event_based_optical_flow_tpu_torch.solver.objective import FrameEvents

H, W = 12, 15
RTOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _field(seed=0, scale=2.0):
    """A flow with a block of exact zeros and exact equal neighbours."""
    rng = np.random.default_rng(seed)
    f = rng.normal(0, scale, (2, H, W))
    f[:, 3:6, 4:8] = 0.0
    f[0, 8, :] = f[0, 9, :]
    return f


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("scheme", ["upwind", "burgers", "same", "bilinear", "max"])
@pytest.mark.parametrize("loc", ["first", "middle"])
@pytest.mark.parametrize("batched", [False, True])
def test_voxel_matches_jax(scheme, loc, batched):
    f = _field()
    if batched:
        f = np.stack([f, _field(1)])
    for time_bin, clamp in ((5, None), (4, 3.0)):
        want = JV.construct_dense_flow_voxel(jnp.asarray(f), time_bin, scheme, loc, clamp=clamp)
        got = TV.construct_dense_flow_voxel(torch.as_tensor(f), time_bin, scheme, loc, clamp=clamp)
        assert got.shape == ((2,) if batched else ()) + (time_bin, 2, H, W)
        _close(got.numpy(), want)


@pytest.mark.parametrize("dt", [0.3, -0.45])
@pytest.mark.parametrize("method", ["same", "bilinear", "max", "nearest", "linear", "cubic"])
def test_direct_propagation_matches_jax(method, dt):
    """The direct schemes, the host scipy ``griddata`` ones included (NaN
    outside the advected points' hull in both)."""
    f = _field(2, scale=4.0)
    _close(TV.propagate_flow_to_voxel(torch.as_tensor(f), dt, method).numpy(),
           JV.propagate_flow_to_voxel(jnp.asarray(f), dt, method))


@pytest.mark.parametrize("scheme", ["upwind", "burgers"])
@pytest.mark.parametrize("loc", ["first", "middle"])
def test_voxel_matches_golden_oracle(scheme, loc):
    g = np.load("tests/golden/reference_oracle.npz")
    got = TV.construct_dense_flow_voxel(torch.as_tensor(g["f0"]), 6, scheme, loc)
    np.testing.assert_allclose(got.numpy(), g[f"voxel_{scheme}_{loc}"], atol=1e-10)


@pytest.mark.parametrize("scheme", ["upwind", "burgers"])
@pytest.mark.parametrize("clamp", [None, 2.5])
def test_chain_vjp_matches_jax(scheme, clamp):
    f = _field(3)
    rng = np.random.default_rng(4)
    g = rng.normal(size=(5, 2, H, W))
    _, vjp = jax.vjp(lambda q: JV.construct_dense_flow_voxel(q, 5, scheme, "middle", clamp=clamp), jnp.asarray(f))
    want = vjp(jnp.asarray(g))[0]
    ft = torch.as_tensor(f).requires_grad_(True)
    out = TV.construct_dense_flow_voxel(ft, 5, scheme, "middle", clamp=clamp)
    (got,) = torch.autograd.grad((out * torch.as_tensor(g)).sum(), ft)
    assert np.abs(np.asarray(want)).max() > 1.0
    _close(got.numpy(), want)


def test_tie_gradients_split_in_half():
    """At an exact zero, max(u, 0) and min(u, 0) each pass half the
    gradient (lax.max's rule, which torch.maximum shares and relu does
    not): one upwind step's gradient on an all-zero field."""
    f = torch.zeros((2, 4, 5), dtype=torch.float64, requires_grad=True)
    g = torch.ones((2, 4, 5), dtype=torch.float64)
    (got,) = torch.autograd.grad((TV.upwind_step(f, 0.5) * g).sum(), f)
    _, vjp = jax.vjp(lambda q: JV.upwind_step(q, 0.5), jnp.zeros((2, 4, 5)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(vjp(jnp.ones((2, 4, 5)))[0]))


def _metric_events(rng, n=900, time_bin=4):
    """Events over 0.25 s (t_min 0, t_max 0.25: dtf = t / 0.25 exactly),
    some exactly on the bin edges dtf = k / time_bin, some outside the
    image."""
    x = rng.uniform(-2.0, H + 1.0, n)
    y = rng.uniform(-2.0, W + 1.0, n)
    t = rng.uniform(0.0, 0.25, n)
    t[:2] = 0.0, 0.25
    t[2:2 + time_bin] = 0.25 * np.arange(time_bin) / time_bin  # bin edges
    return np.stack([x, y, np.sort(t), rng.integers(0, 2, n)], 1)


def test_warp_voxel_flow_matches_jax():
    rng = np.random.default_rng(6)
    ev = _metric_events(rng)
    vox = rng.normal(0, 3.0, (4, 2, H, W))
    for direction in ("first", "middle"):
        want = JW.warp_voxel_flow(jnp.asarray(ev), jnp.asarray(vox),
                                  JW.calculate_reftime(jnp.asarray(ev), direction), (H, W), normalize_t=True)
        e = torch.as_tensor(ev)
        got = TW.warp_voxel_flow(e, torch.as_tensor(vox), TW.calculate_reftime(e, direction), (H, W),
                                 normalize_t=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_frame_event_bins(dtype):
    """Bins from the float64 dtf (events exactly on bin edges stay in their
    bin in float32 too), sorted by (bin, source pixel); the dense order is
    the source-pixel order alone."""
    from event_based_optical_flow_tpu.ops import pallas_objective_banded as PB
    from event_based_optical_flow_tpu.types import pad_events

    rng = np.random.default_rng(7)
    T = 4
    ev = _metric_events(rng, n=700, time_bin=T)
    ev[:, :2] = np.clip(ev[:, :2], 0, [H - 1e-6, W - 1e-6])
    frame = FrameEvents.from_numpy(ev, "cpu", dtype, time_bin=T)
    t = ev[:, 2]
    dtf = (t - t.min()) / (t.max() - t.min())
    want_bins = np.clip(np.floor(dtf * T), 0, T - 1).astype(int)
    for k in range(T):  # an event on each bin's lower edge is in that bin
        assert want_bins[dtf == k / T].tolist() == [k] * (1 + (k == 0))
        assert frame.bins[frame.dtf == k / T].tolist() == [k] * (1 + (k == 0))
    px = frame.x.trunc().long() * W + frame.y.trunc().long()
    key = frame.bins.long() * H * W + px
    assert frame.bins.dtype == torch.int32 and (key[1:] >= key[:-1]).all()
    assert np.array_equal(np.bincount(frame.bins.numpy(), minlength=T), np.bincount(want_bins, minlength=T))
    # the same bins as the JAX package's (bin, band) packing
    padded, wgt = pad_events(ev)
    x4, _, _, w4, _ = PB.pack_events_by_band_bin(padded, wgt, np.where(wgt > 0, (padded[:, 2] - t.min())
                                                                       / (t.max() - t.min()), 0), H, T)
    per_bin = (w4 > 0).reshape(T, -1).sum(1)
    assert np.array_equal(per_bin, np.bincount(want_bins, minlength=T))
    for b in range(T):
        got = np.sort(frame.x[frame.bins == b].double().numpy())
        want = np.sort(torch.as_tensor(ev[want_bins == b, 0]).to(dtype).double().numpy())
        np.testing.assert_array_equal(got, want)
    dense = FrameEvents.from_numpy(ev, "cpu", dtype)
    assert dense.bins is None
    xy = torch.as_tensor(ev[:, :2]).to(dtype).trunc().to(torch.int64).numpy()
    order = np.lexsort((xy[:, 1], xy[:, 0]))
    np.testing.assert_array_equal(dense.x.numpy(), torch.as_tensor(ev[order, 0]).to(dtype).numpy())
    np.testing.assert_array_equal(dense.dtf.numpy(), torch.as_tensor(dtf[order]).to(dtype).numpy())
