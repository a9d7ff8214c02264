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


T_BINS = 3


def _voxel_inputs(seed=0):
    """``_inputs`` with time bins: some events exactly on bin edges (dtf =
    k / T), some outside the image on every side and just inside it at
    (-1, 0), padded rows; a voxel whose bins differ strongly."""
    padded, wgt, dtf, flow, g = _inputs(seed)
    rng = np.random.default_rng(seed + 100)
    padded = padded.copy()
    dtf = dtf.copy()
    dtf[100:100 + T_BINS] = np.arange(T_BINS) / T_BINS
    padded[70:75, 0], padded[75:80, 0], padded[80:85, 0] = -0.5, -3.0, H + 0.5
    padded[85:90, 1], padded[90:95, 1] = -2.5, W + 0.25
    voxel = rng.uniform(-12.0, 12.0, (T_BINS, 2, H, W))
    voxel[1] *= 3.0
    bins = np.clip(np.floor(dtf * T_BINS), 0, T_BINS - 1).astype(np.int32)
    return padded, wgt, dtf, bins, voxel, g


def _jax_voxel_packed(padded, wgt, dtf):
    return [jnp.asarray(a) for a in PB.pack_events_by_band_bin(padded, wgt, dtf, H, T_BINS)]


@pytest.mark.parametrize("offsets,include_orig", [(OFFSETS, True), ((), True), (OFFSETS, False)])
def test_voxel_plain_version_matches_pallas(offsets, include_orig):
    """K5's plain version (``bins``) against ``fused_multi_iwe_banded_voxel``
    on (bin, band)-packed events: images and the voxel gradient."""
    padded, wgt, dtf, bins, voxel, g = _voxel_inputs()
    packed = _jax_voxel_packed(padded, wgt, dtf)

    def f(v):
        return PB.fused_multi_iwe_banded_voxel(v, *packed, (H, W), offsets, include_orig, 1e-6, False)

    vj = jnp.asarray(voxel)
    want_img = np.asarray(f(vj))
    gk = g[: want_img.shape[0]]
    want_grad = np.asarray(jax.grad(lambda v: jnp.sum(f(v) * jnp.asarray(gk)))(vj))

    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64)
    vt = t(voxel).requires_grad_(bool(offsets))
    imgs = FI.fused_iwe(vt, t(padded[:, 0]), t(padded[:, 1]), t(dtf), t(wgt), offsets, include_orig,
                        bins=torch.as_tensor(bins))
    assert imgs.shape == want_img.shape == (len(offsets) + int(include_orig), H, W)
    np.testing.assert_allclose(imgs.detach().numpy(), want_img, rtol=0,
                               atol=ATOL * max(1.0, np.abs(want_img).max()))
    if offsets:
        (got_grad,) = torch.autograd.grad((imgs * t(gk)).sum(), vt)
        assert got_grad.shape == voxel.shape
        assert all(np.abs(want_grad[b]).max() > 1.0 for b in range(T_BINS))  # every bin is reached
        np.testing.assert_allclose(got_grad.numpy(), want_grad, rtol=0,
                                   atol=ATOL * max(1.0, np.abs(want_grad).max()))


def test_voxel_with_one_bin_is_the_dense_vote():
    """One bin holding every event: the voxel form's images and gradient
    are the dense form's bits."""
    padded, wgt, dtf, flow, g = _inputs()
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64)
    ev = (t(padded[:, 0]), t(padded[:, 1]), t(dtf), t(wgt))
    out = []
    for voxel, bins in ((t(flow), None), (t(flow[None]), torch.zeros(len(dtf), dtype=torch.int32))):
        v = voxel.requires_grad_(True)
        imgs = FI.fused_iwe(v, *ev, OFFSETS, True, bins=bins)
        (grad,) = torch.autograd.grad((imgs * t(g)).sum(), v)
        out.append((imgs.detach().numpy(), grad.reshape(2, H, W).numpy()))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])


# --- batches of frames: K7 (rows 7-10, 13-14, 17-18) and K9 (rows 19-20) ----

from event_based_optical_flow_tpu.ops.pallas_objective_batched import fused_multi_iwe_batched  # noqa: E402
from event_based_optical_flow_tpu.solver.fleet import pack_fleet_banded  # noqa: E402
from event_based_optical_flow_tpu_torch.solver.objective import FleetEvents  # noqa: E402

FLEET_SIZES = (600, 450, 700)  # events per frame


def _fleet_inputs(time_bin=None, seed=3):
    """Three frames' events (some sources on pixels, on the last row and
    column, outside the image), as ``FleetEvents`` for the port and as the
    raw arrays for ``pack_fleet_banded``; flows (voxels with ``time_bin``)
    large enough to push warped corners off every edge; tangents and
    cotangents."""
    rng = np.random.default_rng(seed)
    events = []
    for n in FLEET_SIZES:
        x, y = rng.uniform(-0.9, H - 1e-6, n), rng.uniform(-0.9, W - 1e-6, n)
        x[:30], y[:30] = np.round(x[:30]), np.round(y[:30])
        x[30:40], y[30:40] = H - 1, W - 1
        x[40:45], y[45:50] = -3.0, W + 0.5
        events.append(np.stack([x, y, np.sort(rng.uniform(0, 0.05, n)), rng.integers(0, 2, n)], 1))
    lead = (len(FLEET_SIZES),) + (() if time_bin is None else (time_bin,))
    flow = rng.uniform(-12.0, 12.0, lead + (2, H, W))
    flow[..., : H // 2, :] *= 3.0
    dflow = rng.normal(0, 3.0, flow.shape)
    g = rng.normal(size=(3, len(FLEET_SIZES), 1 + len(OFFSETS), H, W))
    fleet = FleetEvents.from_numpy(events, "cpu", torch.float64, time_bin)
    return events, fleet, flow, dflow, g


def _fleet_packed(events, time_bin):
    return [jnp.asarray(a) for a in pack_fleet_banded(events, H, time_bin=time_bin or 0)[:5]]


def _fleet_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * max(1.0, np.abs(want).max()))


def _fleet_args(fleet):
    return (fleet.x, fleet.y, fleet.dtf, fleet.wt), {"bins": fleet.bins, "frames": fleet.frames}


@pytest.mark.parametrize("time_bin", [None, T_BINS])
@pytest.mark.parametrize("offsets,include_orig", [(OFFSETS, True), ((), True), (OFFSETS, False)])
def test_batched_plain_version_matches_pallas(time_bin, offsets, include_orig):
    """The batched forward and backward (rows 9-10; rows 7-8 with time
    bins) against ``fused_multi_iwe_banded_batched`` /
    ``..._voxel_batched`` on a ``pack_fleet_banded`` fleet, to 1e-9."""
    events, fleet, flow, _, g = _fleet_inputs(time_bin)
    packed = _fleet_packed(events, time_bin)
    jfn = PB.fused_multi_iwe_banded_voxel_batched if time_bin else PB.fused_multi_iwe_banded_batched

    def f(fl):
        return jfn(fl, *packed, (H, W), offsets, include_orig, 1e-6, False)

    want_img = np.asarray(f(jnp.asarray(flow)))
    gk = g[0][:, : want_img.shape[1]]
    ev, kw = _fleet_args(fleet)
    ft = torch.as_tensor(flow).requires_grad_(bool(offsets))
    imgs = FI.fused_iwe(ft, *ev, offsets, include_orig, **kw)
    assert imgs.shape == (len(FLEET_SIZES), len(offsets) + int(include_orig), H, W)
    _fleet_close(imgs.detach(), want_img)
    if offsets:
        want_grad = np.asarray(jax.grad(lambda q: jnp.sum(f(q) * jnp.asarray(gk)))(jnp.asarray(flow)))
        (got_grad,) = torch.autograd.grad((imgs * torch.as_tensor(gk)).sum(), ft)
        assert np.abs(want_grad).max() > 1.0
        _fleet_close(got_grad, want_grad)


@pytest.mark.parametrize("time_bin", [None, T_BINS])
@pytest.mark.parametrize("emit_value", [True, False])
def test_batched_jvp_plain_version_matches_pallas(time_bin, emit_value):
    """The batched tangent (row 13; row 17 with time bins) against
    ``fused_multi_iwe_banded_jvp_batched`` / ``..._voxel_jvp_batched``."""
    events, fleet, flow, dflow, _ = _fleet_inputs(time_bin)
    packed = _fleet_packed(events, time_bin)
    jfn = PB.fused_multi_iwe_banded_voxel_jvp_batched if time_bin else PB.fused_multi_iwe_banded_jvp_batched
    want = jfn(jnp.asarray(flow), jnp.asarray(dflow), *packed, (H, W), OFFSETS, eps=1e-6, use_bf16=False,
               emit_value=emit_value)
    ev, kw = _fleet_args(fleet)
    got = FI.fused_iwe_jvp(torch.as_tensor(flow), torch.as_tensor(dflow), *ev, OFFSETS, emit_value, **kw)
    if emit_value:
        _fleet_close(got[0], want[0])
        got, want = got[1], want[1]
    assert np.abs(np.asarray(want)).max() > 0.1
    _fleet_close(got, want)


@pytest.mark.parametrize("time_bin", [None, T_BINS])
@pytest.mark.parametrize("term_a", [False, True])
def test_batched_hvp_bwd_plain_version_matches_pallas(time_bin, term_a):
    """The batched HVP backward (row 14; row 18 with time bins) against
    ``fused_multi_iwe_banded_hvp_bwd_batched`` / ``..._voxel_hvp_bwd_batched``."""
    events, fleet, flow, dflow, g = _fleet_inputs(time_bin)
    packed = _fleet_packed(events, time_bin)
    g1, g2 = g[1][:, : len(OFFSETS)], g[2][:, : len(OFFSETS)]
    jfn = (PB.fused_multi_iwe_banded_voxel_hvp_bwd_batched if time_bin
           else PB.fused_multi_iwe_banded_hvp_bwd_batched)
    want = jfn(jnp.asarray(flow), jnp.asarray(dflow), jnp.asarray(g1), jnp.asarray(g2), *packed, (H, W), OFFSETS,
               eps=1e-6, use_bf16=False, term_a=term_a)
    ev, kw = _fleet_args(fleet)
    t = torch.as_tensor
    got = FI.fused_iwe_hvp_bwd(t(flow), t(dflow), t(np.ascontiguousarray(g1)), t(np.ascontiguousarray(g2)), *ev,
                               OFFSETS, term_a, **kw)
    assert got.shape == flow.shape and np.abs(np.asarray(want)).max() > 1.0
    _fleet_close(got, want)


def test_k9_unpacked_batched_matches_batched_plain_version():
    """K9 (``fused_multi_iwe_batched`` on unpacked, padded events ``[B, N,
    4]``, rows 19-20): images and flow gradient against the batched dense
    plain version, which is its port."""
    events, fleet, flow, _, g = _fleet_inputs()
    n_max = max(len(e) for e in events)
    padded, weights = zip(*(pad_events(e, target_n=n_max + 64) for e in events))
    gk = jnp.asarray(g[0])

    def f(fl):
        return fused_multi_iwe_batched(jnp.asarray(np.stack(padded)), fl, (H, W), offsets=OFFSETS,
                                       weights=jnp.asarray(np.stack(weights)), include_orig=True, use_bf16=False)

    want_img = np.asarray(f(jnp.asarray(flow)))
    want_grad = np.asarray(jax.grad(lambda q: jnp.sum(f(q) * gk))(jnp.asarray(flow)))
    ev, kw = _fleet_args(fleet)
    ft = torch.as_tensor(flow).requires_grad_(True)
    imgs = FI.fused_iwe(ft, *ev, OFFSETS, True, **kw)
    (got_grad,) = torch.autograd.grad((imgs * torch.as_tensor(g[0])).sum(), ft)
    _fleet_close(imgs.detach(), want_img)
    _fleet_close(got_grad, want_grad)


@pytest.mark.parametrize("time_bin", [None, T_BINS])
def test_batched_plain_version_is_each_frame_alone(time_bin):
    """Each frame of every batched plain version (forward, backward, tangent,
    HVP backward) is, bit for bit, the single-frame plain version on that
    frame's events alone; the CPU wrappers count no launch."""
    _, fleet, flow, dflow, g = _fleet_inputs(time_bin)
    ev, kw = _fleet_args(fleet)
    t = torch.as_tensor
    before = FI.launch_counts()
    ft = t(flow).requires_grad_(True)
    imgs = FI.fused_iwe(ft, *ev, OFFSETS, True, **kw)
    (grad,) = torch.autograd.grad((imgs * t(g[0])).sum(), ft)
    g1, g2 = (t(np.ascontiguousarray(a[:, 1:])) for a in (g[1], g[2]))
    tan = FI.fused_iwe_jvp(t(flow), t(dflow), *ev, OFFSETS, False, **kw)
    hvp = FI.fused_iwe_hvp_bwd(t(flow), t(dflow), g1, g2, *ev, OFFSETS, True, **kw)
    assert FI.launch_counts() == before
    for b in range(len(FLEET_SIZES)):
        one = fleet.frame(b)
        e1, k1 = (one.x, one.y, one.dtf, one.wt), {"bins": one.bins}
        fb = t(flow[b]).requires_grad_(True)
        img_b = FI.fused_iwe(fb, *e1, OFFSETS, True, **k1)
        (grad_b,) = torch.autograd.grad((img_b * t(g[0][b])).sum(), fb)
        np.testing.assert_array_equal(imgs[b].detach().numpy(), img_b.detach().numpy())
        np.testing.assert_array_equal(grad[b].numpy(), grad_b.numpy())
        np.testing.assert_array_equal(
            tan[b].numpy(), FI.fused_iwe_jvp(t(flow[b]), t(dflow[b]), *e1, OFFSETS, False, **k1).numpy())
        np.testing.assert_array_equal(
            hvp[b].numpy(),
            FI.fused_iwe_hvp_bwd(t(flow[b]), t(dflow[b]), g1[b], g2[b], *e1, OFFSETS, True, **k1).numpy())


# --- the exact models of the kernels' bits ------------------------------------

FIX_HALF_UNIT = 2.0 ** -(FI.FIX_BITS + 1)  # the forward's largest rounding of one vote


def _sorted_form(form):
    """(events, kwargs, flow, cotangents [3, (B,) 1 + K, H, W], tangent flow)
    of one form, the events sorted by (frame, bin, source pixel) as the
    kernels take them, with weights that differ and padded events."""
    if form.startswith("batched"):
        _, fleet, flow, dflow, g = _fleet_inputs(T_BINS if form == "batched_voxel" else None)
        ev, kw = _fleet_args(fleet)
        return ev, kw, torch.as_tensor(flow), torch.as_tensor(g), torch.as_tensor(dflow)
    if form == "voxel":
        padded, wgt, dtf, bins, flow, g = _voxel_inputs()
    else:
        (padded, wgt, dtf, flow, g), bins = _inputs(), None
    x, y = padded[:, 0], padded[:, 1]
    keys = (np.trunc(y), np.trunc(x)) + (() if bins is None else (bins,))
    order = np.lexsort(keys)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a[order]))
    kw = {"bins": None if bins is None else t(bins)}
    rng = np.random.default_rng(7)
    gs = torch.as_tensor(np.stack([g, rng.normal(size=g.shape), rng.normal(size=g.shape)]))
    return (t(x), t(y), t(dtf), t(wgt)), kw, torch.as_tensor(flow), gs, torch.as_tensor(rng.normal(0, 3.0, flow.shape))


def _votes_per_pixel(flow, ev, offsets, include_orig, kw):
    inds, vals, shape = FI._corner_votes(flow, *ev, offsets, include_orig, 1e-6, kw["bins"], kw.get("frames"))
    return torch.zeros(int(np.prod(shape)), dtype=torch.float64).index_add_(
        0, inds, (vals != 0).double()).reshape(shape)


FORMS = ["dense", "voxel", "batched", "batched_voxel"]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("offsets,include_orig", [(OFFSETS, True), ((), True), (OFFSETS, False)])
def test_exact_models_match_plain_versions(form, offsets, include_orig):
    """float64: the forward model is the plain version up to its fixed-point
    rounding, at most 2^-37 per vote in each pixel (the unit 2^-36 is above
    1e-12 of these images, so no tolerance of the scale alone could hold);
    the ordered backward model is the plain version's autograd gradient to
    1e-12 x its scale (the same terms, summed in another order)."""
    ev, kw, flow, g, _ = _sorted_form(form)
    lead = flow.shape[:1] if form.startswith("batched") else ()
    g = g[0][(slice(None),) * len(lead) + (slice(int(not include_orig), None),)].contiguous()
    plain = FI.fused_iwe_reference(flow, *ev, offsets, include_orig, **kw)
    model = FI.fused_iwe_fixed_reference(flow, *ev, offsets, include_orig, **kw)
    votes = _votes_per_pixel(flow, ev, offsets, include_orig, kw)
    assert model.shape == plain.shape and votes.max() > 1
    assert ((model - plain).abs() <= votes * FIX_HALF_UNIT + 1e-12 * plain.abs().max()).all()
    if offsets:
        fl = flow.clone().requires_grad_(True)
        (want,) = torch.autograd.grad((FI.fused_iwe_reference(fl, *ev, offsets, include_orig, **kw) * g).sum(), fl)
        got = FI.fused_iwe_bwd_ordered_reference(flow, *ev, g, offsets, include_orig, **kw)
        assert got.shape == want.shape and want.abs().max() > 1.0
        assert (got - want).abs().max() <= 1e-12 * want.abs().max()


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("term_a", [False, True])
def test_exact_hvp_model_matches_plain_version(form, term_a):
    """float64: the ordered backward model with K4's term A (and without
    it, K4 as the backward of g2) is the HVP backward's plain version to
    1e-12 x its scale."""
    ev, kw, flow, g, dflow = _sorted_form(form)
    g1, g2 = (a[..., 1:, :, :].contiguous() for a in (g[1], g[2]))
    want = FI.fused_iwe_hvp_bwd_reference(flow, dflow, g1, g2, *ev, OFFSETS, term_a, **kw)
    got = FI.fused_iwe_bwd_ordered_reference(flow, *ev, g2, OFFSETS, False, **kw,
                                             **({"g1": g1, "dflow": dflow} if term_a else {}))
    assert want.abs().max() > 1.0
    assert (got - want).abs().max() <= 1e-12 * want.abs().max()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("form", FORMS)
def test_forward_model_bits_do_not_depend_on_event_order(form, dtype):
    """Integer sums: shuffling the events (and their bins; a batch keeps
    each frame's events in its frame) leaves the forward model's bits as
    they are."""
    ev, kw, flow, _, _ = _sorted_form(form)
    rng = np.random.default_rng(11)
    frames = kw.get("frames")
    sizes = frames.sizes if frames is not None else (len(ev[0]),)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    order = torch.as_tensor(np.concatenate([a + rng.permutation(b - a) for a, b in zip(starts[:-1], starts[1:])]))
    shuffled = {k: (None if v is None or k == "frames" else v[order]) for k, v in kw.items()}
    shuffled["frames"] = frames
    t = lambda a: a.to(dtype)
    want = FI.fused_iwe_fixed_reference(t(flow), *(t(a) for a in ev), OFFSETS, True, **kw)
    got = FI.fused_iwe_fixed_reference(t(flow), *(t(a[order]) for a in ev), OFFSETS, True, **shuffled)
    assert not torch.equal(order, torch.arange(len(order)))
    assert torch.equal(got, want)
