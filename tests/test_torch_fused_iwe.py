"""The fused warp+vote kernel's plain PyTorch version against the JAX
package's Pallas kernels (interpret mode on the CPU), in float64.

Both TPU layouts are held: ``fused_multi_iwe`` on unpacked events and
``fused_multi_iwe_banded`` on events packed by row band.  Forward images
(orig + three reference-time offsets, and the orig-only call) and the
flow gradient of a scalar loss agree to atol 1e-9.  The inputs include
sentinel padded events, corners on the last row and column, and warped
coordinates far outside the image on both sides.  The CUDA kernel itself
is held against the same plain version on the GPU in
``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from event_based_optical_flow_tpu.ops import pallas_objective_banded as PB
from event_based_optical_flow_tpu.ops.pallas_objective import fused_multi_iwe
from event_based_optical_flow_tpu.types import pad_events
from event_based_optical_flow_tpu_torch.ops import fused_iwe as FI

H, W = 16, 20
OFFSETS = (0.0, 1.0, 0.5)
ATOL = 1e-9  # float64 sums of the same terms in another order


@pytest.fixture(autouse=True, scope="module")
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(seed=0, n=600):
    """Events (padded to 1024 with sentinel rows), their weights and dtf,
    and a flow large enough to push warped corners off every edge."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, H - 1, n)
    y = rng.uniform(0, W - 1, n)
    x[:40] = np.round(x[:40])  # integer sources: corners exactly on pixels
    y[:40] = np.round(y[:40])
    x[40:60], y[40:60] = H - 1, W - 1  # last row and column
    x[60:70] = H - 1e-3
    ev = np.stack([x, y, np.sort(rng.uniform(0, 0.05, n)), rng.integers(0, 2, n)], 1)
    padded, wgt = pad_events(ev, target_n=1024)
    wgt[:n] = rng.uniform(0.3, 1.5, n)
    t = padded[:, 2]
    t_min, t_max = t[wgt > 0].min(), t[wgt > 0].max()
    dtf = (t - t_min) / (t_max - t_min)
    flow = rng.uniform(-12.0, 12.0, (2, H, W))
    flow[:, : H // 2] *= 3.0  # large motion: warped coordinates < 0 and > H, W
    g = rng.normal(size=(1 + len(OFFSETS), H, W))
    return padded, wgt, dtf, flow, g


def _torch_images(padded, wgt, dtf, flow, offsets, include_orig, g=None):
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64)
    fl = t(flow).requires_grad_(g is not None)
    imgs = FI.fused_iwe(fl, t(padded[:, 0]), t(padded[:, 1]), t(dtf), t(wgt), offsets, include_orig)
    if g is None:
        return imgs.detach().numpy(), None
    (dflow,) = torch.autograd.grad((imgs * t(g[: imgs.shape[0]])).sum(), fl)
    return imgs.detach().numpy(), dflow.numpy()


def _jax_unpacked(padded, wgt, flow, offsets, include_orig, g):
    def f(fl):
        return fused_multi_iwe(jnp.asarray(padded), fl, (H, W), offsets=offsets,
                               weights=jnp.asarray(wgt), include_orig=include_orig, use_bf16=False)

    fl = jnp.asarray(flow)
    imgs = f(fl)
    dflow = jax.grad(lambda q: jnp.sum(f(q) * jnp.asarray(g[: imgs.shape[0]])))(fl)
    return np.asarray(imgs), np.asarray(dflow)


def _jax_banded(padded, wgt, dtf, flow, offsets, include_orig, g):
    packed = [jnp.asarray(a) for a in PB.pack_events_by_band(padded, wgt, dtf, H)]

    def f(fl):
        return PB.fused_multi_iwe_banded(fl, *packed, (H, W), offsets, include_orig, 1e-6, False)

    fl = jnp.asarray(flow)
    imgs = f(fl)
    dflow = jax.grad(lambda q: jnp.sum(f(q) * jnp.asarray(g[: imgs.shape[0]])))(fl)
    return np.asarray(imgs), np.asarray(dflow)


@pytest.mark.parametrize("layout", ["unpacked", "banded"])
@pytest.mark.parametrize("offsets,include_orig", [(OFFSETS, True), ((), True), (OFFSETS, False)])
def test_plain_version_matches_pallas(layout, offsets, include_orig):
    padded, wgt, dtf, flow, g = _inputs()
    if layout == "unpacked":
        want_img, want_grad = _jax_unpacked(padded, wgt, flow, offsets, include_orig, g)
    else:
        want_img, want_grad = _jax_banded(padded, wgt, dtf, flow, offsets, include_orig, g)
    got_img, got_grad = _torch_images(padded, wgt, dtf, flow, offsets, include_orig, g if offsets else None)
    assert got_img.shape == want_img.shape == (len(offsets) + int(include_orig), H, W)
    np.testing.assert_allclose(got_img, want_img, rtol=0, atol=ATOL)
    if offsets:
        assert np.abs(want_grad).max() > 1.0  # the loss really depends on the flow
        np.testing.assert_allclose(got_grad, want_grad, rtol=0, atol=ATOL)


def test_inputs_reach_every_edge():
    """The warped coordinates of the test inputs leave the image on all
    four sides, and padded events are present: the edge rules are
    exercised, not assumed."""
    padded, wgt, dtf, flow, _ = _inputs()
    ix = padded[:, 0].astype(int).clip(0, H - 1)
    iy = padded[:, 1].astype(int).clip(0, W - 1)
    xw = padded[:, 0] - dtf * flow[0, ix, iy]
    yw = padded[:, 1] - dtf * flow[1, ix, iy]
    live = wgt > 0
    assert (xw[live] < 0).any() and (xw[live] >= H).any()
    assert (yw[live] < 0).any() and (yw[live] >= W).any()
    assert (wgt == 0).sum() > 0


def test_padded_events_are_inert():
    padded, wgt, dtf, flow, _ = _inputs()
    full, _ = _torch_images(padded, wgt, dtf, flow, OFFSETS, True)
    live = wgt > 0
    trimmed, _ = _torch_images(padded[live], wgt[live], dtf[live], flow, OFFSETS, True)
    np.testing.assert_array_equal(full, trimmed)


def test_kernel_wrapper_refuses_cpu_tensors():
    """A CPU tensor never reaches the kernel launcher: the launcher raises
    instead of falling back, and ``fused_iwe`` routes CPU tensors to the
    plain version."""
    padded, wgt, dtf, flow, _ = _inputs()
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64)
    args = (t(flow), t(padded[:, 0]), t(padded[:, 1]), t(dtf), t(wgt))
    with pytest.raises(ValueError, match="CUDA"):
        FI.fused_iwe_fwd(*args, OFFSETS, True)
    before = FI.launch_counts()
    FI.fused_iwe(*args, OFFSETS, True)
    assert FI.launch_counts() == before


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_frame_events_sorted_by_source_pixel(dtype):
    """``FrameEvents`` orders the events by their truncated source pixel in
    the target dtype (so the kernel's backward adds each pixel's gradient
    once, in a fixed order), keeps every event, and leaves the images and
    the flow gradient unchanged up to summation order."""
    from event_based_optical_flow_tpu_torch.solver.objective import FrameEvents

    rng = np.random.default_rng(5)
    n = 800
    ev = np.stack([rng.uniform(-0.9, H - 1e-9, n), rng.uniform(-0.9, W - 1e-9, n),
                   np.sort(rng.uniform(0, 0.05, n)), rng.integers(0, 2, n)], 1)
    ev[:30, 0] = np.nextafter(np.round(ev[:30, 0]), -np.inf)  # just below a pixel edge
    frame = FrameEvents.from_numpy(ev, "cpu", dtype)
    px = frame.x.trunc().long() * W + frame.y.trunc().long()
    assert (px[1:] >= px[:-1]).all()
    got = torch.stack([frame.x, frame.y]).double().numpy().T
    want = torch.as_tensor(ev[:, :2]).to(dtype).double().numpy()
    assert np.array_equal(got[np.lexsort(got.T[::-1])], want[np.lexsort(want.T[::-1])])

    t_min, t_max = ev[:, 2].min(), ev[:, 2].max()
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)
    flow = torch.as_tensor(rng.uniform(-6.0, 6.0, (2, H, W)), dtype=dtype)
    g = t(rng.normal(size=(len(OFFSETS), H, W)))
    out = []
    for x, y, dtf in ((frame.x, frame.y, frame.dtf),
                      (t(ev[:, 0]), t(ev[:, 1]), t((ev[:, 2] - t_min) / (t_max - t_min)))):
        fl = flow.clone().requires_grad_(True)
        imgs = FI.fused_iwe(fl, x, y, dtf, torch.ones_like(x), OFFSETS, False)
        (dflow,) = torch.autograd.grad((imgs * g).sum(), fl)
        out.append((imgs.detach().double().numpy(), dflow.double().numpy()))
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=0, atol=tol)
    np.testing.assert_allclose(out[0][1], out[1][1], rtol=0, atol=tol * np.abs(out[1][1]).max())
