"""GPU tests of the PyTorch port: the hand-written CUDA kernels (the fused
vote and its backward, K1/K2; the tangent and the HVP backward, K3/K4;
their time-aware voxel forms, K5/K6; the batched forms of all of them, K7;
the standalone vote, K8) against their plain PyTorch versions, every
kernel against the exact model of its bits (error 0),
each batched frame against the single-frame kernel on that frame alone, and the fused objective and its
analytic HVP (dense and time-aware) on the GPU against the same on the CPU, and the EV-FlowNet path (the voxel
featurizer's K8 launch against the plain vote and the exact model, the CMax loss and its flow gradient through K8
and its backward against the CPU, far-out and NaN positions, deterministic train steps).  Every test needs an NVIDIA GPU and skips
without one (``cuda`` marker).

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from event_based_optical_flow_tpu_torch.ops import fused_iwe as FI
from event_based_optical_flow_tpu_torch.ops import iwe as IWE
from event_based_optical_flow_tpu_torch.ops import vote as VOTE
from event_based_optical_flow_tpu_torch.solver.objective import (
    FleetEvents,
    FrameEvents,
    ObjectiveSpec,
    build_objective,
    build_objective_hvp_staged,
    build_orig_iwe,
)
from event_based_optical_flow_tpu_torch.utils import set_numerics

H, W = 40, 52
OFFSETS = (0.0, 1.0, 0.5)


def _counts(**launched) -> dict:
    """``launch_counts()`` with every kernel form at 0 but ``launched``."""
    return {prefix + k: launched.get(prefix + k, 0) for prefix in FI.FORMS for k in FI.KERNELS}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(seed=0, n=5000):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, H - 1, n)
    y = rng.uniform(0, W - 1, n)
    x[:200], y[:200] = np.round(x[:200]), np.round(y[:200])
    x[200:260], y[200:260] = H - 1, W - 1
    wt = rng.uniform(0.3, 1.5, n)
    wt[-500:] = 0.0  # padded events
    x[-500:], y[-500:] = -10.0, -10.0
    dtf = rng.uniform(0, 1, n)
    flow = rng.uniform(-12.0, 12.0, (2, H, W))
    g = rng.normal(size=(1 + len(OFFSETS), H, W))
    return (x, y, dtf, wt), flow, g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9), (torch.float32, 1e-4)])
def test_kernel_matches_plain_version(cuda_device, dtype, tol):
    """Same floor decisions (the kernel is built without FMA contraction),
    sums in another order (and in 2^-36 fixed point, forward): a tolerance
    relative to the largest value, tight in float64, ~1e-4 in float32."""
    ev_np, flow_np, g_np = _inputs()
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=cuda_device)
    ev = tuple(t(a) for a in ev_np)
    fl = t(flow_np)
    for offsets, orig in ((OFFSETS, True), ((), True), (OFFSETS, False)):
        ref = FI.fused_iwe_reference(fl, *ev, offsets, orig)
        got = FI.fused_iwe_fwd(fl, *ev, offsets, orig)
        torch.cuda.synchronize()
        assert (got - ref).abs().max().item() <= tol * max(1.0, ref.abs().max().item())
        if offsets:
            g = t(g_np[: ref.shape[0]]).contiguous()
            flr = fl.clone().requires_grad_(True)
            (want,) = torch.autograd.grad((FI.fused_iwe_reference(flr, *ev, offsets, orig) * g).sum(), flr)
            got_d = FI.fused_iwe_bwd(fl, *ev, g, offsets, orig)
            torch.cuda.synchronize()
            assert want.abs().max().item() > 1.0
            assert (got_d - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_is_reproducible(cuda_device, dtype):
    """Fixed-point votes and per-pixel run sums: a second call gives the
    same bits, forward and backward, on events sorted by source pixel as
    ``FrameEvents`` sorts them."""
    (x, y, dtf, _), flow_np, g_np = _inputs()
    frame = FrameEvents.from_numpy(np.stack([x, y, dtf, np.ones_like(x)], 1), cuda_device, dtype)
    ev = (frame.x, frame.y, frame.dtf, frame.wt)
    fl = torch.as_tensor(flow_np, dtype=dtype, device=cuda_device)
    g = torch.as_tensor(g_np[1:], dtype=dtype, device=cuda_device).contiguous()
    first = (FI.fused_iwe_fwd(fl, *ev, OFFSETS, False), FI.fused_iwe_bwd(fl, *ev, g, OFFSETS, False))
    for _ in range(3):
        assert torch.equal(FI.fused_iwe_fwd(fl, *ev, OFFSETS, False), first[0])
        assert torch.equal(FI.fused_iwe_bwd(fl, *ev, g, OFFSETS, False), first[1])


@pytest.mark.cuda
def test_launch_counters_and_autograd(cuda_device):
    ev_np, flow_np, g_np = _inputs()
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64, device=cuda_device)
    ev = tuple(t(a) for a in ev_np)
    fl = t(flow_np).requires_grad_(True)
    FI.reset_launch_counts()
    imgs = FI.fused_iwe(fl, *ev, OFFSETS, False)
    (imgs * t(g_np[1:])).sum().backward()
    assert FI.launch_counts() == _counts(fwd=1, bwd=1)
    with pytest.raises(ValueError):
        FI.fused_iwe_fwd(fl.detach(), *ev, tuple(range(FI.MAX_OFFSETS + 1)), False)


def _second_order_inputs(dtype, device):
    """Events sorted by source pixel (as ``FrameEvents`` sorts them), a
    flow, a tangent flow and two cotangents of the direction images."""
    (x, y, dtf, wt), flow_np, _ = _inputs()
    rng = np.random.default_rng(1)
    frame = FrameEvents.from_numpy(np.stack([x, y, dtf, np.ones_like(x)], 1), device, dtype)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    ev = (frame.x, frame.y, frame.dtf, t(rng.uniform(0.3, 1.5, len(x))))
    g1, g2 = (t(rng.normal(size=(len(OFFSETS), H, W))) for _ in range(2))
    return ev, t(flow_np), t(rng.normal(0, 3.0, (2, H, W))), g1, g2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9), (torch.float32, 1e-4)])
def test_jvp_and_hvp_kernels_match_plain_versions(cuda_device, dtype, tol):
    """K3 (both ways of ``emit_value``) and K4 (both ways of ``term_a``)
    against their plain versions, to ``tol`` x the largest value; K3's
    value half is ``fused_iwe_fwd``'s bits and K4 without term A is
    ``fused_iwe_bwd(g2)``'s bits."""
    ev, fl, dfl, g1, g2 = _second_order_inputs(dtype, cuda_device)

    def close(got, want):
        torch.cuda.synchronize()
        assert want.abs().max().item() > 0.1
        return (got - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())

    ref_img, ref_tan = FI.fused_iwe_jvp_reference(fl, dfl, *ev, OFFSETS, True)
    img, tan = FI.fused_iwe_jvp(fl, dfl, *ev, OFFSETS, True)
    assert torch.equal(img, FI.fused_iwe_fwd(fl, *ev, OFFSETS, False))
    assert close(img, ref_img) and close(tan, ref_tan)
    assert torch.equal(FI.fused_iwe_jvp(fl, dfl, *ev, OFFSETS, False), tan)
    for term_a in (False, True):
        got = FI.fused_iwe_hvp_bwd(fl, dfl, g1, g2, *ev, OFFSETS, term_a)
        assert close(got, FI.fused_iwe_hvp_bwd_reference(fl, dfl, g1, g2, *ev, OFFSETS, term_a))
        if not term_a:
            assert torch.equal(got, FI.fused_iwe_bwd(fl, *ev, g2, OFFSETS, False))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_jvp_and_hvp_kernels_are_reproducible(cuda_device, dtype):
    """The tangent's per-call fixed-point unit and K4's ordered run sums:
    every call gives the same bits, at tangent scales 1e-6 to 1e6 apart."""
    ev, fl, dfl, g1, g2 = _second_order_inputs(dtype, cuda_device)
    for scale in (1e-6, 1.0, 1e6):
        d = dfl * scale
        first = (FI.fused_iwe_jvp(fl, d, *ev, OFFSETS, False),
                 FI.fused_iwe_hvp_bwd(fl, d, g1, g2, *ev, OFFSETS, True))
        want = FI.fused_iwe_jvp_reference(fl, d, *ev, OFFSETS, False)
        torch.cuda.synchronize()
        assert (first[0] - want).abs().max().item() <= 1e-4 * want.abs().max().item()
        for _ in range(3):
            assert torch.equal(FI.fused_iwe_jvp(fl, d, *ev, OFFSETS, False), first[0])
            assert torch.equal(FI.fused_iwe_hvp_bwd(fl, d, g1, g2, *ev, OFFSETS, True), first[1])


@pytest.mark.cuda
def test_second_order_launch_counts_and_checks(cuda_device):
    ev, fl, dfl, g1, g2 = _second_order_inputs(torch.float64, cuda_device)
    FI.reset_launch_counts()
    FI.fused_iwe_jvp(fl, dfl, *ev, OFFSETS, True)
    FI.fused_iwe_hvp_bwd(fl, dfl, g1, g2, *ev, OFFSETS, False)
    assert FI.launch_counts() == _counts(jvp=1, hvp_bwd=1)
    with pytest.raises(ValueError):
        FI.fused_iwe_jvp(fl, dfl[:, :-1].contiguous(), *ev, OFFSETS, False)
    with pytest.raises(ValueError):
        FI.fused_iwe_hvp_bwd(fl, dfl, g1[:2].contiguous(), g2, *ev, OFFSETS, False)
    nan = torch.full_like(dfl, float("nan"))
    assert torch.isnan(FI.fused_iwe_jvp(fl, nan, *ev, OFFSETS, False)).all()


def _objective_problem(rng):
    n = 4000
    events = np.stack([np.round(rng.uniform(0, H - 1, n)), np.round(rng.uniform(0, W - 1, n)),
                       np.sort(rng.uniform(0, 0.1, n)), rng.integers(0, 2, n)], 1)
    spec = ObjectiveSpec((H, W), (2, 2), (16, 24), (16, 24), (4, 2), "bilinear", 1.0, "hybrid",
                         (("multi_focal_normalized_gradient_magnitude", 1.0), ("total_variation", 0.01)))
    return events, spec


@pytest.fixture
def deterministic():
    """The port's numerics (``set_numerics``), restored afterwards."""
    before = torch.are_deterministic_algorithms_enabled()
    set_numerics()
    yield
    torch.use_deterministic_algorithms(before)


@pytest.mark.cuda
@pytest.mark.parametrize("gauss_newton", [True, False])
def test_analytic_hvp_on_gpu_matches_cpu(cuda_device, deterministic, gauss_newton):
    """The staged analytic HVP (K1 values, K3 tangent, the cost's
    jvp-of-grad under deterministic algorithms, K4) in float64 on the GPU
    against the plain version on the CPU, to 1e-9 of max|Hp|; float32
    twice gives the same bits."""
    rng = np.random.default_rng(4)
    events, spec = _objective_problem(rng)
    motion, p = rng.uniform(-20, 20, 8), rng.normal(0, 1, 8)
    out = {}
    for dev, dtype in (("cpu", torch.float64), (cuda_device, torch.float64),
                       (cuda_device, torch.float32), (cuda_device, torch.float32)):
        frame = FrameEvents.from_numpy(events, dev, dtype)
        orig = build_orig_iwe(spec)(frame)
        m, pp = (torch.as_tensor(a, dtype=dtype, device=dev) for a in (motion, p))
        prep, hvp = build_objective_hvp_staged(spec, gauss_newton)
        out.setdefault((str(dev), dtype), []).append(hvp(prep(m, orig, frame), m, pp, orig, frame).cpu())
    want = out[("cpu", torch.float64)][0]
    got = out[(str(cuda_device), torch.float64)][0]
    assert want.abs().max().item() > 0
    assert (got - want).abs().max().item() <= 1e-9 * want.abs().max().item()
    a, b = out[(str(cuda_device), torch.float32)]
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_objective_on_gpu_matches_cpu(cuda_device):
    """The whole fused objective (kernel, blur, hybrid cost) and its
    gradient in float64 on the GPU against the plain version on the CPU."""
    rng = np.random.default_rng(3)
    events, spec = _objective_problem(rng)
    motion = rng.uniform(-20, 20, 8)
    out = {}
    for dev in ("cpu", cuda_device):
        frame = FrameEvents.from_numpy(events, dev, torch.float64)
        orig = build_orig_iwe(spec)(frame)
        m = torch.as_tensor(motion, dtype=torch.float64, device=dev).requires_grad_(True)
        loss, _ = build_objective(spec)(m, orig, frame)
        (grad,) = torch.autograd.grad(loss, m)
        out[str(dev)] = (loss.item(), grad.cpu().numpy())
    (l_cpu, g_cpu), (l_gpu, g_gpu) = out["cpu"], out[str(cuda_device)]
    assert l_gpu == pytest.approx(l_cpu, rel=1e-9)
    np.testing.assert_allclose(g_gpu, g_cpu, rtol=1e-7, atol=1e-9)


T_BINS = 4


def _voxel_inputs(dtype, device, seed=2):
    """Events sorted by (time bin, source pixel) as ``FrameEvents`` sorts
    them (some on bin edges, some outside the image), a voxel whose bins
    differ, a tangent voxel and cotangents."""
    (x, y, dtf, _), _, g_np = _inputs(seed)
    rng = np.random.default_rng(seed + 10)
    x, y = x.copy(), y.copy()
    x[300:320], y[320:340] = -3.0, W + 2.0
    t = rng.uniform(0, 0.25, len(x))
    t[:2] = 0.0, 0.25
    t[2:2 + T_BINS] = 0.25 * np.arange(T_BINS) / T_BINS  # bin edges
    frame = FrameEvents.from_numpy(np.stack([x, y, t, np.ones_like(x)], 1), device, dtype, time_bin=T_BINS)
    tt = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    ev = (frame.x, frame.y, frame.dtf, tt(rng.uniform(0.3, 1.5, len(x))))
    voxel = rng.uniform(-12.0, 12.0, (T_BINS, 2, H, W))
    voxel[1] *= 3.0
    g1, g2 = (tt(rng.normal(size=(len(OFFSETS), H, W))) for _ in range(2))
    return ev, frame.bins, tt(voxel), tt(rng.normal(0, 3.0, voxel.shape)), tt(g_np), g1, g2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9), (torch.float32, 1e-4)])
def test_voxel_kernels_match_plain_versions(cuda_device, dtype, tol):
    """K5 (forward, backward) and K6 (both ``emit_value``, both ``term_a``)
    against their plain versions, to ``tol`` x the largest value; K6's
    values are K5's bits, K6 without term A is K5's backward(g2) bits, and
    every repeat gives the same bits."""
    ev, bins, vox, dvox, g, g1, g2 = _voxel_inputs(dtype, cuda_device)

    def close(got, want):
        torch.cuda.synchronize()
        assert want.abs().max().item() > 0.1
        return (got - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())

    for offsets, orig in ((OFFSETS, True), ((), True), (OFFSETS, False)):
        ref = FI.fused_iwe_reference(vox, *ev, offsets, orig, bins=bins)
        got = FI.fused_iwe_fwd(vox, *ev, offsets, orig, bins=bins)
        assert close(got, ref) and torch.equal(got, FI.fused_iwe_fwd(vox, *ev, offsets, orig, bins=bins))
        if offsets:
            gk = g[: ref.shape[0]].contiguous()
            vr = vox.clone().requires_grad_(True)
            (want,) = torch.autograd.grad((FI.fused_iwe_reference(vr, *ev, offsets, orig, bins=bins) * gk).sum(), vr)
            got_d = FI.fused_iwe_bwd(vox, *ev, gk, offsets, orig, bins=bins)
            assert got_d.shape == vox.shape and close(got_d, want)
            assert torch.equal(got_d, FI.fused_iwe_bwd(vox, *ev, gk, offsets, orig, bins=bins))
    ref_img, ref_tan = FI.fused_iwe_jvp_reference(vox, dvox, *ev, OFFSETS, True, bins=bins)
    img, tan = FI.fused_iwe_jvp(vox, dvox, *ev, OFFSETS, True, bins=bins)
    assert torch.equal(img, FI.fused_iwe_fwd(vox, *ev, OFFSETS, False, bins=bins))
    assert close(img, ref_img) and close(tan, ref_tan)
    assert torch.equal(FI.fused_iwe_jvp(vox, dvox, *ev, OFFSETS, False, bins=bins), tan)
    for term_a in (False, True):
        got = FI.fused_iwe_hvp_bwd(vox, dvox, g1, g2, *ev, OFFSETS, term_a, bins=bins)
        assert close(got, FI.fused_iwe_hvp_bwd_reference(vox, dvox, g1, g2, *ev, OFFSETS, term_a, bins=bins))
        assert torch.equal(got, FI.fused_iwe_hvp_bwd(vox, dvox, g1, g2, *ev, OFFSETS, term_a, bins=bins))
        if not term_a:
            assert torch.equal(got, FI.fused_iwe_bwd(vox, *ev, g2, OFFSETS, False, bins=bins))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_voxel_tangent_scales(cuda_device, dtype):
    """K6's per-call tangent unit at tangent scales 1e-6 to 1e6 apart:
    within 1e-4 of the plain version, the same bits on every call."""
    ev, bins, vox, dvox, _, g1, g2 = _voxel_inputs(dtype, cuda_device)
    for scale in (1e-6, 1.0, 1e6):
        d = dvox * scale
        first = (FI.fused_iwe_jvp(vox, d, *ev, OFFSETS, False, bins=bins),
                 FI.fused_iwe_hvp_bwd(vox, d, g1, g2, *ev, OFFSETS, True, bins=bins))
        want = FI.fused_iwe_jvp_reference(vox, d, *ev, OFFSETS, False, bins=bins)
        torch.cuda.synchronize()
        assert (first[0] - want).abs().max().item() <= 1e-4 * want.abs().max().item()
        for _ in range(2):
            assert torch.equal(FI.fused_iwe_jvp(vox, d, *ev, OFFSETS, False, bins=bins), first[0])
            assert torch.equal(FI.fused_iwe_hvp_bwd(vox, d, g1, g2, *ev, OFFSETS, True, bins=bins), first[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_single_bin_voxel_kernels_give_dense_bits(cuda_device, dtype):
    """With one bin holding every event (in the dense source-pixel order,
    which is the (bin, pixel) order of one bin), K5 and K6 give K1-K4's
    bits."""
    _, _, vox, dvox, g, g1, g2 = _voxel_inputs(dtype, cuda_device)
    ev, _, _, _, _ = _second_order_inputs(dtype, cuda_device)
    one = torch.zeros(ev[0].shape[0], dtype=torch.int32, device=cuda_device)
    f, df = vox[0].contiguous(), dvox[0].contiguous()
    FI.reset_launch_counts()
    assert torch.equal(FI.fused_iwe_fwd(f[None], *ev, OFFSETS, True, bins=one), FI.fused_iwe_fwd(f, *ev, OFFSETS, True))
    assert torch.equal(FI.fused_iwe_bwd(f[None], *ev, g, OFFSETS, True, bins=one)[0],
                       FI.fused_iwe_bwd(f, *ev, g, OFFSETS, True))
    assert torch.equal(FI.fused_iwe_jvp(f[None], df[None], *ev, OFFSETS, False, bins=one),
                       FI.fused_iwe_jvp(f, df, *ev, OFFSETS, False))
    for term_a in (False, True):
        assert torch.equal(FI.fused_iwe_hvp_bwd(f[None], df[None], g1, g2, *ev, OFFSETS, term_a, bins=one)[0],
                           FI.fused_iwe_hvp_bwd(f, df, g1, g2, *ev, OFFSETS, term_a))
    assert FI.launch_counts() == _counts(fwd=1, bwd=1, jvp=1, hvp_bwd=2, voxel_fwd=1, voxel_bwd=1, voxel_jvp=1,
                                         voxel_hvp_bwd=2)
    with pytest.raises(ValueError, match="int32"):
        FI.fused_iwe_fwd(f[None], *ev, OFFSETS, True, bins=one.long())
    with pytest.raises(ValueError, match=r"\[T, 2, H, W\]"):
        FI.fused_iwe_fwd(f, *ev, OFFSETS, True, bins=one)


@pytest.mark.cuda
def test_time_aware_objective_and_hvp_on_gpu_match_cpu(cuda_device, deterministic):
    """The time-aware objective (the Burgers chain, K5) with its gradient,
    and its staged Gauss-Newton HVP (the chain's jvp/vjp, K6), in float64
    on the GPU against the CPU; float32 twice gives the same bits."""
    import dataclasses

    rng = np.random.default_rng(8)
    events, spec = _objective_problem(rng)
    spec = dataclasses.replace(spec, time_aware=True, time_bin=T_BINS, flow_interpolation="burgers",
                               t0_location="middle")
    motion, p = rng.uniform(-20, 20, 8), rng.normal(0, 1, 8)
    out = {}
    for dev, dtype in (("cpu", torch.float64), (cuda_device, torch.float64),
                       (cuda_device, torch.float32), (cuda_device, torch.float32)):
        frame = FrameEvents.from_numpy(events, dev, dtype, time_bin=T_BINS)
        orig = build_orig_iwe(spec)(frame)
        m = torch.as_tensor(motion, dtype=dtype, device=dev).requires_grad_(True)
        loss, _ = build_objective(spec)(m, orig, frame)
        (grad,) = torch.autograd.grad(loss, m)
        prep, hvp = build_objective_hvp_staged(spec, True)
        pp = torch.as_tensor(p, dtype=dtype, device=dev)
        hp = hvp(prep(m.detach(), orig, frame), m.detach(), pp, orig, frame)
        out.setdefault((str(dev), dtype), []).append((loss.item(), grad.cpu(), hp.cpu()))
    (l_cpu, g_cpu, h_cpu), = out[("cpu", torch.float64)]
    (l_gpu, g_gpu, h_gpu), = out[(str(cuda_device), torch.float64)]
    assert l_gpu == pytest.approx(l_cpu, rel=1e-9)
    assert (g_gpu - g_cpu).abs().max().item() <= 1e-9 * g_cpu.abs().max().item()
    assert (h_gpu - h_cpu).abs().max().item() <= 1e-9 * h_cpu.abs().max().item()
    a, b = out[(str(cuda_device), torch.float32)]
    assert a[0] == b[0] and torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


def _fleet_inputs(dtype, device, time_bin=None, seed=5):
    """Three frames of different sizes (FleetEvents: sorted by (frame, bin,
    pixel)), some events outside the image, flows (voxels) that differ per
    frame, tangents and cotangents."""
    rng = np.random.default_rng(seed)
    events = []
    for n in (3000, 1200, 4500):
        x, y = rng.uniform(-0.9, H - 1e-6, n), rng.uniform(-0.9, W - 1e-6, n)
        x[:100], y[:100] = np.round(x[:100]), np.round(y[:100])
        x[100:110], y[110:120] = -3.0, W + 2.0
        events.append(np.stack([x, y, np.sort(rng.uniform(0, 0.25, n)), np.ones(n)], 1))
    fleet = FleetEvents.from_numpy(events, device, dtype, time_bin)
    lead = (3,) + (() if time_bin is None else (time_bin,))
    tt = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)
    flow = rng.uniform(-12.0, 12.0, lead + (2, H, W))
    flow[1] *= 2.0
    return (fleet, tt(flow), tt(rng.normal(0, 3.0, flow.shape)), tt(rng.normal(size=(3, 1 + len(OFFSETS), H, W))),
            tt(rng.normal(size=(3, len(OFFSETS), H, W))), tt(rng.normal(size=(3, len(OFFSETS), H, W))))


@pytest.mark.cuda
@pytest.mark.parametrize("time_bin", [None, T_BINS])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9), (torch.float32, 1e-4)])
def test_batched_kernels_match_plain_versions_and_each_frame_alone(cuda_device, time_bin, dtype, tol):
    """The batched kernels (K7: forward, backward, tangent, HVP backward;
    dense and voxel) against their batched plain versions to ``tol`` x the
    largest value; each frame's output is, bit for bit, the single-frame
    kernel's on that frame's events alone (the tangent's unit is per
    frame); a repeat gives the same bits; only the ``batched_`` counts
    move."""
    fleet, fl, dfl, g, g1, g2 = _fleet_inputs(dtype, cuda_device, time_bin)
    ev, kw = (fleet.x, fleet.y, fleet.dtf, fleet.wt), {"bins": fleet.bins, "frames": fleet.frames}

    def close(got, want):
        torch.cuda.synchronize()
        assert want.abs().max().item() > 0.1
        return (got - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())

    FI.reset_launch_counts()
    img = FI.fused_iwe_fwd(fl, *ev, OFFSETS, True, **kw)
    grad = FI.fused_iwe_bwd(fl, *ev, g, OFFSETS, True, **kw)
    val, tan = FI.fused_iwe_jvp(fl, dfl, *ev, OFFSETS, True, **kw)
    hvp = FI.fused_iwe_hvp_bwd(fl, dfl, g1, g2, *ev, OFFSETS, True, **kw)
    form = FI.form(fleet.bins, fleet.frames)
    assert FI.launch_counts() == _counts(**{form + k: 1 for k in FI.KERNELS})
    assert close(img, FI.fused_iwe_reference(fl, *ev, OFFSETS, True, **kw))
    flr = fl.clone().requires_grad_(True)
    (want,) = torch.autograd.grad((FI.fused_iwe_reference(flr, *ev, OFFSETS, True, **kw) * g).sum(), flr)
    assert grad.shape == fl.shape and close(grad, want)
    ref_val, ref_tan = FI.fused_iwe_jvp_reference(fl, dfl, *ev, OFFSETS, True, **kw)
    assert close(val, ref_val) and close(tan, ref_tan)
    assert close(hvp, FI.fused_iwe_hvp_bwd_reference(fl, dfl, g1, g2, *ev, OFFSETS, True, **kw))
    assert torch.equal(val, FI.fused_iwe_fwd(fl, *ev, OFFSETS, False, **kw))
    for b in range(3):
        one = fleet.frame(b)
        e1, k1 = (one.x, one.y, one.dtf, one.wt), {"bins": one.bins}
        assert torch.equal(img[b], FI.fused_iwe_fwd(fl[b], *e1, OFFSETS, True, **k1))
        assert torch.equal(grad[b], FI.fused_iwe_bwd(fl[b], *e1, g[b], OFFSETS, True, **k1))
        assert torch.equal(tan[b], FI.fused_iwe_jvp(fl[b], dfl[b], *e1, OFFSETS, False, **k1))
        assert torch.equal(hvp[b], FI.fused_iwe_hvp_bwd(fl[b], dfl[b], g1[b], g2[b], *e1, OFFSETS, True, **k1))
    assert torch.equal(img, FI.fused_iwe_fwd(fl, *ev, OFFSETS, True, **kw))
    assert torch.equal(grad, FI.fused_iwe_bwd(fl, *ev, g, OFFSETS, True, **kw))
    assert torch.equal(tan, FI.fused_iwe_jvp(fl, dfl, *ev, OFFSETS, False, **kw))
    assert torch.equal(hvp, FI.fused_iwe_hvp_bwd(fl, dfl, g1, g2, *ev, OFFSETS, True, **kw))


@pytest.mark.cuda
def test_batched_tangent_unit_is_per_frame(cuda_device):
    """One frame's tangent 1e6 times another's: each frame keeps the bits
    it has alone (a per-call unit would round the small frame's votes to
    the large one's unit)."""
    fleet, fl, dfl, _, _, _ = _fleet_inputs(torch.float32, cuda_device)
    ev, kw = (fleet.x, fleet.y, fleet.dtf, fleet.wt), {"frames": fleet.frames}
    scaled = dfl * torch.tensor([1e-3, 1.0, 1e3], device=cuda_device)[:, None, None, None]
    tan = FI.fused_iwe_jvp(fl, scaled, *ev, OFFSETS, False, **kw)
    for b in range(3):
        one = fleet.frame(b)
        assert torch.equal(tan[b], FI.fused_iwe_jvp(fl[b], scaled[b].contiguous(), one.x, one.y, one.dtf, one.wt,
                                                    OFFSETS, False))


@pytest.mark.cuda
def test_batched_wrappers_check_the_frame_table(cuda_device):
    fleet, fl, _, _, _, _ = _fleet_inputs(torch.float64, cuda_device)
    ev = (fleet.x, fleet.y, fleet.dtf, fleet.wt)
    ptr, sizes = fleet.frames
    bad = (
        (FI.Frames(ptr.long(), sizes), "int32"),
        (FI.Frames(ptr, sizes[:2] + (sizes[2] - 1,)), "count"),
        (FI.Frames(ptr[:3].contiguous(), sizes), r"\[B \+ 1\]"),
    )
    for frames, match in bad:
        with pytest.raises(ValueError, match=match):
            FI.fused_iwe_fwd(fl, *ev, OFFSETS, True, frames=frames)
    with pytest.raises(ValueError, match=r"\[B, 2, H, W\]"):
        FI.fused_iwe_fwd(fl[0], *ev, OFFSETS, True, frames=fleet.frames)


# --- the forward and backward against the exact models of their bits ------


def _on_cpu(*tensors):
    return tuple(None if t is None else t.cpu() for t in tensors)


def _form_inputs(form, dtype, device):
    """(events, kwargs, flow, cotangent of orig + K images, tangent flow,
    g1, g2) of one form, the events sorted as the kernels take them."""
    if form.startswith("batched"):
        fleet, fl, dfl, g, g1, g2 = _fleet_inputs(dtype, device, T_BINS if form == "batched_voxel" else None)
        return (fleet.x, fleet.y, fleet.dtf, fleet.wt), {"bins": fleet.bins, "frames": fleet.frames}, fl, g, dfl, g1, g2
    if form == "voxel":
        ev, bins, vox, dvox, g, g1, g2 = _voxel_inputs(dtype, device)
        return ev, {"bins": bins}, vox, g, dvox, g1, g2
    ev, fl, dfl, g1, g2 = _second_order_inputs(dtype, device)
    g = torch.as_tensor(np.random.default_rng(3).normal(size=(1 + len(OFFSETS), H, W)), dtype=dtype, device=device)
    return ev, {"bins": None}, fl, g, dfl, g1, g2


def _model_kw(kw):
    return {"bins": None if kw["bins"] is None else kw["bins"].cpu(),
            "frames": None if kw.get("frames") is None else FI.Frames(kw["frames"].ptr.cpu(), kw["frames"].sizes)}


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["dense", "voxel", "batched", "batched_voxel"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernels_equal_the_exact_models(cuda_device, form, dtype):
    """The forward, the one-pass backward, the HVP backward (both ways of
    term A) and the tangent (both ways of emit_value) give, bit for bit,
    the exact models on the CPU copies of their inputs: max|err| 0 at
    every form."""
    ev, kw, fl, g, dfl, g1, g2 = _form_inputs(form, dtype, cuda_device)
    cev, ckw, (cfl, cg, cdfl, cg1, cg2) = _on_cpu(*ev), _model_kw(kw), _on_cpu(fl, g, dfl, g1, g2)
    k = (slice(None),) if form.startswith("batched") else ()
    for offsets, orig in ((OFFSETS, True), ((), True), (OFFSETS, False)):
        got = FI.fused_iwe_fwd(fl, *ev, offsets, orig, **kw).cpu()
        assert torch.equal(got, FI.fused_iwe_fixed_reference(cfl, *cev, offsets, orig, **ckw))
        if offsets:
            gk = g[k + (slice(int(not orig), None),)].contiguous()
            got = FI.fused_iwe_bwd(fl, *ev, gk, offsets, orig, **kw).cpu()
            assert torch.equal(got, FI.fused_iwe_bwd_ordered_reference(cfl, *cev, gk.cpu(), offsets, orig, **ckw))
    for term_a in (False, True):
        got = FI.fused_iwe_hvp_bwd(fl, dfl, g1, g2, *ev, OFFSETS, term_a, **kw).cpu()
        want = FI.fused_iwe_bwd_ordered_reference(cfl, *cev, cg2, OFFSETS, False, **ckw,
                                                  **({"g1": cg1, "dflow": cdfl} if term_a else {}))
        assert torch.equal(got, want)
    for emit_value in (False, True):
        got = FI.fused_iwe_jvp(fl, dfl, *ev, OFFSETS, emit_value, **kw)
        want = FI.fused_iwe_jvp_fixed_reference(cfl, cdfl, *cev, OFFSETS, emit_value, **ckw)
        for a, b in zip(got, want) if emit_value else ((got, want),):
            assert torch.equal(a.cpu(), b)


def _same(a, b) -> bool:
    """The same bits, NaN included."""
    return torch.equal(a.isnan(), b.isnan()) and torch.equal(torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["zero", "tiny", "nan"])
@pytest.mark.parametrize("form", ["dense", "voxel", "batched", "batched_voxel"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tangent_units_equal_the_exact_model(cuda_device, form, case, dtype):
    """K3's unit at its edges, bit for bit against the model: a zero
    tangent (unit 1, zeros), a tiny one (in float64 a unit past 2^-1023,
    where the kernel takes ldexp instead of a multiply), a NaN at a
    tangent-voting event's source pixel in the first frame (that frame NaN,
    the others as before)."""
    ev, kw, fl, _, dfl, _, _ = _form_inputs(form, dtype, cuda_device)
    if case == "zero":
        dfl = torch.zeros_like(dfl)
    elif case == "tiny":
        dfl = dfl * (1e-300 if dtype == torch.float64 else 1e-40)
    else:
        x, y, _, wt = (a.cpu() for a in ev)
        i = int(torch.nonzero((wt != 0) & (x > -1) & (x < H) & (y > -1) & (y < W))[0])
        frame = (0,) if form.startswith("batched") else ()
        time_bin = () if kw["bins"] is None else (int(kw["bins"][i].clamp(0, T_BINS - 1)),)
        dfl = dfl.clone()
        dfl[frame + time_bin + (0, int(x[i]), int(y[i]))] = float("nan")
    cev, ckw = _on_cpu(*ev), _model_kw(kw)
    exps = FI._tangent_exponents(dfl.cpu(), *cev, OFFSETS, ckw["bins"], ckw["frames"])
    assert (exps[0] is None) if case == "nan" else (exps[0] == 0 if case == "zero" else exps[0] is not None)
    if case == "tiny" and dtype == torch.float64:
        assert min(exps) > 1023
    for emit_value in (False, True):
        got = FI.fused_iwe_jvp(fl, dfl, *ev, OFFSETS, emit_value, **kw)
        want = FI.fused_iwe_jvp_fixed_reference(fl.cpu(), dfl.cpu(), *cev, OFFSETS, emit_value, **ckw)
        for a, b in zip(got, want) if emit_value else ((got, want),):
            assert _same(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_forward_any_event_order_displacement_and_hotspot(cuda_device, dtype):
    """Shuffled events, a displacement larger than the image, and a hotspot
    (every event on a few pixels) all give the exact model's bits."""
    ev, kw, fl, _, _, _, _ = _form_inputs("voxel", dtype, cuda_device)
    perm = torch.as_tensor(np.random.default_rng(9).permutation(len(ev[0])), device=cuda_device)
    for flow in (fl, fl * 10.0):
        want = FI.fused_iwe_fixed_reference(flow.cpu(), *_on_cpu(*ev), OFFSETS, True, **_model_kw(kw))
        assert torch.equal(FI.fused_iwe_fwd(flow, *ev, OFFSETS, True, **kw).cpu(), want)
        shuffled = tuple(a[perm].contiguous() for a in ev)
        got = FI.fused_iwe_fwd(flow, *shuffled, OFFSETS, True, bins=kw["bins"][perm].contiguous()).cpu()
        assert torch.equal(got, want)
    rng = np.random.default_rng(12)
    n = 6000
    events = np.stack([rng.uniform(10, 11.5, n), rng.uniform(12, 13.5, n), rng.uniform(0, 0.1, n), np.ones(n)], 1)
    frame = FrameEvents.from_numpy(events, cuda_device, dtype)
    hot = (frame.x, frame.y, frame.dtf, frame.wt)
    flow = torch.as_tensor(rng.uniform(-0.3, 0.3, (2, H, W)), dtype=dtype, device=cuda_device)
    got = FI.fused_iwe_fwd(flow, *hot, OFFSETS, True).cpu()
    assert torch.equal(got, FI.fused_iwe_fixed_reference(flow.cpu(), *_on_cpu(*hot), OFFSETS, True))
    assert got.max() > 100.0


@pytest.mark.cuda
@pytest.mark.parametrize("time_bin", [None, T_BINS])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tangent_large_launch_equals_the_exact_model(cuda_device, dtype, time_bin):
    """A tangent launch above the vote's aggregation threshold (60 000
    dense events: a warp sums its votes to one pixel in registers before
    one RED), as one frame, shuffled, and as a batch of two frames, gives
    the exact model's bits."""
    rng = np.random.default_rng(21)
    n = 60000
    events = np.stack([rng.uniform(-0.9, H, n), rng.uniform(-0.9, W, n), rng.uniform(0, 0.1, n), np.ones(n)], 1)
    lead = () if time_bin is None else (time_bin,)
    tt = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=cuda_device)
    flow, dflow = rng.uniform(-3.0, 3.0, (2,) + lead + (2, H, W)), rng.normal(0, 3.0, (2,) + lead + (2, H, W))
    frame = FrameEvents.from_numpy(events, cuda_device, dtype, time_bin)
    perm = torch.as_tensor(rng.permutation(n), device=cuda_device)
    fleet = FleetEvents.from_numpy([events[: n // 2], events[n // 2:]], cuda_device, dtype, time_bin)
    cases = [((frame.x, frame.y, frame.dtf, frame.wt), {"bins": frame.bins}, tt(flow[0]), tt(dflow[0])),
             (tuple(a[perm].contiguous() for a in (frame.x, frame.y, frame.dtf, frame.wt)),
              {"bins": None if frame.bins is None else frame.bins[perm].contiguous()}, tt(flow[0]), tt(dflow[0])),
             ((fleet.x, fleet.y, fleet.dtf, fleet.wt), {"bins": fleet.bins, "frames": fleet.frames}, tt(flow),
              tt(dflow))]
    for ev, kw, fl, dfl in cases:
        assert len(ev[0]) >= 48 * 1024  # the vote's kAggregateEvents
        got = FI.fused_iwe_jvp(fl, dfl, *ev, OFFSETS, False, **kw)
        want = FI.fused_iwe_jvp_fixed_reference(fl.cpu(), dfl.cpu(), *_on_cpu(*ev), OFFSETS, False, **_model_kw(kw))
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_forward_and_backward_in_a_cuda_graph(cuda_device):
    """The batched forward, backward and tangent (K3, tangent only) and
    K8 on its paths (the sweep's batches in shared memory, small and
    opted-in, a frame larger than ``shared_pixels()`` through global sums)
    captured in one
    CUDA graph (their scratch from the graph's pool) and replayed twice
    give the exact models' bits every time."""
    fleet, fl, dfl, g, _, _ = _fleet_inputs(torch.float32, cuda_device)
    ev, kw = (fleet.x, fleet.y, fleet.dtf, fleet.wt), {"bins": None, "frames": fleet.frames}
    ckw = _model_kw(kw)
    want_b = FI.fused_iwe_fixed_reference(fl.cpu(), *_on_cpu(*ev), OFFSETS, True, **ckw)
    want_g = FI.fused_iwe_bwd_ordered_reference(fl.cpu(), *_on_cpu(*ev), g.cpu(), OFFSETS, True, **ckw)
    want_t = FI.fused_iwe_jvp_fixed_reference(fl.cpu(), dfl.cpu(), *_on_cpu(*ev), OFFSETS, False, **ckw)
    votes = [(a.to(cuda_device, torch.float32), b if isinstance(b, float) else b.to(cuda_device, torch.float32), size)
             for a, b, size in _vote_model_cases()[:5:2] + _vote_model_cases()[1:2]]
    want_v = [VOTE.bilinear_vote_fixed_reference(a.cpu(), size, b if isinstance(b, float) else b.cpu())
              for a, b, size in votes]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up on the capture stream
        FI.fused_iwe_fwd(fl, *ev, OFFSETS, True, **kw)
        FI.fused_iwe_jvp(fl, dfl, *ev, OFFSETS, False, **kw)
        for a, b, size in votes:
            VOTE.bilinear_vote_kernel(a, size, b)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        images = FI.fused_iwe_fwd(fl, *ev, OFFSETS, True, **kw)
        grad = FI.fused_iwe_bwd(fl, *ev, g, OFFSETS, True, **kw)
        tangent = FI.fused_iwe_jvp(fl, dfl, *ev, OFFSETS, False, **kw)
        voted = [VOTE.bilinear_vote_kernel(a, size, b) for a, b, size in votes]
    for _ in range(2):
        for out in [images, grad, tangent] + voted:
            out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(images.cpu(), want_b) and torch.equal(grad.cpu(), want_g)
        assert torch.equal(tangent.cpu(), want_t)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(voted, want_v))


@pytest.mark.cuda
def test_two_host_threads_on_one_stream_give_the_same_bits(cuda_device):
    """Two host threads enqueueing the tangent (K3) and K8 (both paths) on
    one stream, interleaved, get the exact models' bits on every call: each
    call's scratch is its own."""
    import threading

    fleet, fl, dfl, _, _, _ = _fleet_inputs(torch.float32, cuda_device)
    ev, kw = (fleet.x, fleet.y, fleet.dtf, fleet.wt), {"bins": None, "frames": fleet.frames}
    want_t = FI.fused_iwe_jvp_fixed_reference(fl.cpu(), dfl.cpu(), *_on_cpu(*ev), OFFSETS, False, **_model_kw(kw))
    votes = [(a.to(cuda_device, torch.float32), b if isinstance(b, float) else b.to(cuda_device, torch.float32), size)
             for a, b, size in _vote_model_cases()[:2]]
    want_v = [VOTE.bilinear_vote_fixed_reference(a.cpu(), size, b if isinstance(b, float) else b.cpu())
              for a, b, size in votes]
    stream = torch.cuda.current_stream(cuda_device)
    results, errors = [[], []], []

    def work(k):
        try:
            with torch.cuda.stream(stream):
                for _ in range(20):
                    results[k].append((FI.fused_iwe_jvp(fl, dfl, *ev, OFFSETS, False, **kw),
                                       [VOTE.bilinear_vote_kernel(a, size, b) for a, b, size in votes]))
        except Exception as e:  # noqa: BLE001 - reraised below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert not errors and all(len(r) == 20 for r in results)
    for tangent, voted in results[0] + results[1]:
        assert torch.equal(tangent.cpu(), want_t)
        assert all(torch.equal(a.cpu(), b) for a, b in zip(voted, want_v))


# --- K8, the standalone vote ------------------------------------------------


def _vote_inputs(seed=5):
    """Events over the image and past its borders (padded rows at (-10,
    -10)), as one set [n, 4] and as the init sweep's [P, K, C, 4] batch,
    with per-event weights [n] and per-patch weights [P, 1, C] (zero on the
    padded rows)."""
    rng = np.random.default_rng(seed)

    def events(n):
        x = rng.uniform(-0.9, H, n)
        y = rng.uniform(-0.9, W, n)
        x[:100], y[:100] = np.round(x[:100]), np.round(y[:100])
        x[-50:], y[-50:] = -10.0, -10.0
        return np.stack([x, y, rng.uniform(0, 0.1, n), rng.integers(0, 2, n)], 1)

    def weights(shape):
        w = rng.uniform(0.3, 1.5, shape)
        w[..., -50:] = 0.0
        return w

    P, K, C = 6, 5, 512
    return (events(5000), weights((5000,)),
            np.stack([np.stack([events(C) for _ in range(K)]) for _ in range(P)]), weights((P, 1, C)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9), (torch.float32, 1e-4)])
def test_vote_kernel_matches_plain_version(cuda_device, dtype, tol):
    """K8 against ``bilinear_vote_plain`` on the same CUDA tensors, one set
    and the sweep batch, scalar and tensor weights: the same corner
    decisions, sums in 2^-36 fixed point against the plain version's order
    (float32 adds its own rounding); a second call gives the same bits; one
    launch per call."""
    ev1, w1, evb, wb = _vote_inputs()
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=cuda_device)
    VOTE.reset_launch_counts()
    n_calls = 0
    for ev, wt in ((t(ev1), t(w1)), (t(ev1), 0.75), (t(evb), t(wb)), (t(evb), 1.0)):
        want = VOTE.bilinear_vote_plain(ev, (H, W), wt)
        got = VOTE.bilinear_vote_kernel(ev, (H, W), wt)
        torch.cuda.synchronize()
        assert got.shape == want.shape == ev.shape[:-2] + (H, W)
        assert want.abs().max().item() > 1.0
        assert (got - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())
        assert torch.equal(got, VOTE.bilinear_vote_kernel(ev, (H, W), wt))
        n_calls += 2
    assert VOTE.launch_counts() == {"vote": n_calls}


def _vote_model_cases():
    """(events, weight, image size) in float64 on the CPU: the sweep's
    batch at the finest scale's patch (16x21, per-patch weights [P, 1, C])
    and a frame above the shared-memory path's size (180x200, per-event
    weights); then the sweep at scale 2's patches (64x84, and DSEC's
    112x160, the shared-memory path with its opted-in size) with a scalar
    weight, with one weight row for every image ([C]) and with full
    weights [P, K, C]; the frame with a scalar weight, and a batch of such
    frames with per-patch weights [2, 1, n] (each weight row read by 3
    images).  NaN positions and zero-weight rows vote nothing."""
    rng = np.random.default_rng(13)

    def events(shape, size):
        x = rng.uniform(-0.9, size[0], shape)
        y = rng.uniform(-0.9, size[1], shape)
        x[..., :40], y[..., :40] = np.round(x[..., :40]), np.round(y[..., :40])
        x[..., 40:45] = np.nan
        x[..., -30:], y[..., -30:] = -10.0, -10.0
        return torch.as_tensor(np.stack([x, y, rng.uniform(0, 0.1, shape), np.ones(shape)], -1))

    def weights(shape):
        w = rng.uniform(0.3, 1.5, shape)
        w[..., -30:] = 0.0
        return torch.as_tensor(w)

    P, K, C, n = 6, 5, 512, 20000
    return [(events((P, K, C), (16, 21)), weights((P, 1, C)), (16, 21)),
            (events((n,), (180, 200)), weights((n,)), (180, 200)),
            (events((P, K, C), (64, 84)), 1.0, (64, 84)),
            (events((P, K, C), (64, 84)), weights((C,)), (64, 84)),
            (events((P, K, 4 * C), (112, 160)), weights((P, 1, 4 * C)), (112, 160)),
            (events((2, K, C), (112, 160)), 0.5, (112, 160)),
            (events((P, K, C), (16, 21)), weights((P, K, C)), (16, 21)),
            (events((n,), (180, 200)), 0.75, (180, 200)),
            (events((2, 3, 4000), (180, 200)), weights((2, 1, 4000)), (180, 200))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9), (torch.float32, 1e-4)])
def test_vote_kernel_equals_the_exact_model(cuda_device, dtype, tol):
    """K8 on all of its paths (shared memory for the sweep's patches, in
    small blocks up to 48 KB of sums and in opted-in ones above it; global
    sums for an image above ``shared_pixels()``) equals its exact model on
    the CPU copies (max|err| 0) and its plain version to today's
    tolerance; one launch per call."""
    assert 112 * 160 <= VOTE.shared_pixels() < 180 * 200
    for ev, wt, size in _vote_model_cases():
        ev = ev.to(cuda_device, dtype)
        wt = wt if isinstance(wt, float) else wt.to(cuda_device, dtype)
        VOTE.reset_launch_counts()
        got = VOTE.bilinear_vote_kernel(ev, size, wt)
        assert VOTE.launch_counts() == {"vote": 1}
        want = VOTE.bilinear_vote_fixed_reference(ev.cpu(), size, wt if isinstance(wt, float) else wt.cpu())
        assert torch.equal(got.cpu(), want)
        plain = VOTE.bilinear_vote_plain(ev, size, wt)
        assert (got - plain).abs().max().item() <= tol * max(1.0, plain.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_vote_kernel_reads_expanded_events_in_place(cuda_device, dtype):
    """Events expanded over trailing batch axes (the voxel grid's planes,
    read once per event set) with signed per-plane weights, on each of
    K8's paths (small and opted-in shared memory, global sums): the exact
    model's bits (max|err| 0), the same bits as the contiguous copy's
    call, and a gradient through the expand as the plain version's."""
    rng = np.random.default_rng(11)
    b, planes, n = 2, 4, 3000
    for h, w in ((32, 48), (112, 160), (180, 200)):
        base = np.stack([rng.uniform(-1, h, (b, n)), rng.uniform(-1, w, (b, n)), rng.uniform(0, 1, (b, n)),
                         np.ones((b, n))], -1)
        base[:, -200:, :2] = -10.0
        wt_np = rng.uniform(-1.0, 1.0, (b, planes, n))
        wt_np[:, :, -200:] = 0.0
        ev = torch.as_tensor(base, dtype=dtype, device=cuda_device)
        expanded = ev[:, None].expand(b, planes, n, 4)
        wt = torch.as_tensor(wt_np, dtype=dtype, device=cuda_device)
        VOTE.reset_launch_counts()
        got = VOTE.bilinear_vote_kernel(expanded, (h, w), wt)
        assert VOTE.launch_counts() == {"vote": 1}
        assert torch.equal(got, VOTE.bilinear_vote_kernel(expanded.contiguous(), (h, w), wt))
        want = VOTE.bilinear_vote_fixed_reference(expanded.cpu(), (h, w), wt.cpu())
        assert torch.equal(got.cpu(), want)
    g = torch.as_tensor(rng.normal(size=(b, planes, h, w)), dtype=dtype, device=cuda_device)
    leaf = ev.clone().requires_grad_(True)
    (d_kernel,) = torch.autograd.grad((VOTE.bilinear_vote(leaf[:, None].expand(b, planes, n, 4), (h, w), wt) * g)
                                      .sum(), leaf)
    (d_plain,) = torch.autograd.grad((VOTE.bilinear_vote_plain(leaf[:, None].expand(b, planes, n, 4), (h, w), wt)
                                      * g).sum(), leaf)
    tol = 1e-9 if dtype == torch.float64 else 1e-4
    assert (d_kernel - d_plain).abs().max().item() <= tol * max(1.0, d_plain.abs().max().item())


@pytest.mark.cuda
def test_vote_routing_gradient_and_checks(cuda_device):
    """On CUDA tensors ``bilinear_vote`` (and ``create_iwe`` and
    ``event_mask`` through it) launches K8; its analytic backward on the
    card equals the CPU's; the wrapper refuses what the kernel does not
    take."""
    ev1, w1, _, _ = _vote_inputs()
    g = np.random.default_rng(6).normal(size=(H, W))
    grads = {}
    for dev in ("cpu", cuda_device):
        ev = torch.as_tensor(ev1, device=dev).requires_grad_(True)
        wt = torch.as_tensor(w1, device=dev).requires_grad_(True)
        VOTE.reset_launch_counts()
        out = VOTE.bilinear_vote(ev, (H, W), wt)
        grads[str(dev)] = [a.cpu() for a in torch.autograd.grad((out * torch.as_tensor(g, device=dev)).sum(),
                                                                (ev, wt))]
        assert VOTE.launch_counts() == {"vote": 0 if dev == "cpu" else 1}
    for a, b in zip(grads["cpu"], grads["cuda"]):
        assert (a - b).abs().max().item() <= 1e-10 * max(1.0, a.abs().max().item())
    ev = torch.as_tensor(ev1, device=cuda_device)
    VOTE.reset_launch_counts()
    IWE.create_iwe(ev, (H, W), sigma=1, blur_mode="scipy")
    IWE.event_mask(ev, (H, W))
    assert VOTE.launch_counts() == {"vote": 2}
    with pytest.raises(TypeError):
        VOTE.bilinear_vote_kernel(ev.to(torch.float16), (H, W))
    with pytest.raises(ValueError):
        VOTE.bilinear_vote_kernel(ev, (H, W), torch.ones(len(ev1), dtype=torch.float32, device=cuda_device))
    with pytest.raises(ValueError):
        VOTE.bilinear_vote_kernel(ev[:, :3].contiguous(), (H, W))


# --- the chain: Newton evaluations replayed from CUDA graphs -----------------
def _chain_problem(dtype, device, scheme=None, seed=11, n=4000):
    """A small objective (``_objective_problem``'s spec, time-aware with
    ``T_BINS`` bins and the voxel ``scheme``) on the card: (spec, frame,
    orig, motion, direction)."""
    import dataclasses

    rng = np.random.default_rng(seed)
    events, spec = _objective_problem(rng)
    time_bin = None if scheme is None else T_BINS
    if scheme is not None:
        spec = dataclasses.replace(spec, time_aware=True, time_bin=T_BINS, flow_interpolation=scheme,
                                   t0_location="middle")
    events = events[:n]
    frame = FrameEvents.from_numpy(events, device, dtype, time_bin=time_bin)
    orig = build_orig_iwe(spec)(frame)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    return spec, frame, orig, t(rng.uniform(-20, 20, 8)), t(rng.normal(0, 1, 8))


def _evaluations(spec, stage_or_args):
    """The objective's evaluations, staged on a ``graphs.Stage`` or eager
    on ``(orig, frame)``."""
    from event_based_optical_flow_tpu_torch.solver.graphs import Stage
    from event_based_optical_flow_tpu_torch.solver.newton_cg import EagerEvaluations

    obj = build_objective(spec)
    value = lambda x, *a: obj(x, *a)[0]  # noqa: E731
    prep, hvp = build_objective_hvp_staged(spec, True)
    if isinstance(stage_or_args, Stage):
        return stage_or_args.evaluations((spec, "test"), value, hvp, prep)
    return EagerEvaluations(value, stage_or_args, hvp, prep)


def _all_kinds(ev, m, p, g0):
    """Every kind of evaluation at (m, p), in one order."""
    f, g = ev.value_grad(m)
    aux = ev.prep(m)
    return [ev.value(m), f, g, ev.fd_hvp(m, p, None, True), ev.fd_hvp(m, p, g0, False), aux,
            ev.hvp(aux, m, p)]


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", [None, "burgers", "upwind", "bilinear", "max"])
def test_replayed_evaluations_equal_eager(cuda_device, deterministic, scheme):
    """Value, value and gradient, the central and one-sided FD HVP and the
    analytic prep and HVP, captured at their first call and replayed at
    every later one (at other inputs), give the eager evaluations' bits,
    dense and time-aware with every device voxel scheme (the direct
    schemes' ``index_put`` and ``scatter_reduce`` inside the capture); the
    first call is the warm-up and returns the eager result too."""
    from event_based_optical_flow_tpu_torch.solver.graphs import ChainGraphs

    spec, frame, orig, m, p = _chain_problem(torch.float32, cuda_device, scheme)
    eager = _evaluations(spec, (orig, frame))
    stage = ChainGraphs(cuda_device).stage("full", frame, orig)
    staged = _evaluations(spec, stage)
    g0 = eager.value_grad(m)[1]
    for k in range(3):
        mk, pk = m + 0.5 * k, p * (1 + k)
        want = _all_kinds(eager, mk, pk, g0)
        got = _all_kinds(staged, mk, pk, g0)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), k
        assert all(c.graph is not None for c in (staged._value, staged._value_grad, staged._fd_central,
                                                 staged._fd_one_sided, staged._prep, staged._hvp))


@pytest.mark.cuda
def test_replays_count_the_captured_launches(cuda_device, deterministic):
    """A replay adds its graph's kernel launches to the counters, the
    capture adds none: each evaluation counts what its eager twin counts."""
    from event_based_optical_flow_tpu_torch import ops
    from event_based_optical_flow_tpu_torch.solver.graphs import ChainGraphs

    spec, frame, orig, m, p = _chain_problem(torch.float32, cuda_device)
    eager = _evaluations(spec, (orig, frame))
    staged = _evaluations(spec, ChainGraphs(cuda_device).stage("full", frame, orig))
    g0 = eager.value_grad(m)[1]
    counts = []
    for ev in (eager, staged, staged, staged):
        ops.reset_launch_counts()
        _all_kinds(ev, m, p, g0)
        counts.append(ops.launch_counts())
    assert counts[0]["fwd"] > 0 and counts[0]["bwd"] > 0 and counts[0]["jvp"] > 0 and counts[0]["hvp_bwd"] > 0
    assert counts[1] == counts[2] == counts[3] == counts[0]


@pytest.mark.cuda
def test_same_count_frame_replays_another_count_recaptures(cuda_device, deterministic):
    """A second frame with the first's event count is copied into the
    stage and replays its graphs (the eager bits on the new events); a
    frame with another count gets a new stage and new graphs."""
    from event_based_optical_flow_tpu_torch.solver.graphs import ChainGraphs

    graphs = ChainGraphs(cuda_device)
    spec, frame0, orig0, m, _ = _chain_problem(torch.float32, cuda_device, seed=11)
    stage = graphs.stage("full", frame0, orig0)
    staged = _evaluations(spec, stage)
    staged.value_grad(m)
    graph = staged._value_grad.graph
    for seed, n in ((12, 4000), (13, 3000)):
        _, frame, orig, _, _ = _chain_problem(torch.float32, cuda_device, seed=seed, n=n)
        want = _evaluations(spec, (orig, frame)).value_grad(m)
        again = graphs.stage("full", frame, orig)
        got = _evaluations(spec, again).value_grad(m)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        if n == 4000:
            assert again is stage and again.frame.x is frame0.x and staged._value_grad.graph is graph
        else:
            assert again is not stage and again.key[0] == 3000


@pytest.mark.cuda
def test_chained_pyramid_frame_equals_the_loop(cuda_device, deterministic):
    """A small pyramid frame (the dense FD and analytic DSEC blocks)
    chained gives the loop's per-scale losses, iterations, HVP models, host
    syncs and launches (nonzero) bit for bit, and the same pyramid."""
    from event_based_optical_flow_tpu_torch import solver as tsolver
    from event_based_optical_flow_tpu_torch.data.synthetic import SyntheticDataLoader

    h, w = 32, 40
    loader = SyntheticDataLoader({"height": h, "width": w, "duration": 1.0, "event_rate": 12000, "n_frames": 4,
                                  "pattern": "dots", "n_dots": 60, "flow_max": 12.0})
    loader.set_sequence("pyramid")
    ts = loader.eval_frame_time_list()
    events = loader.load_event(loader.time_to_index(ts[1]), loader.time_to_index(ts[2]))
    slv = {"method": "pyramidal_patch_contrast_maximization", "time_aware": False,
           "patch": {"initialize": "random", "scale": 3, "crop_height": 32, "crop_width": 40,
                     "filter_type": "bilinear"},
           "motion_model": "2d-translation", "warp_direction": "first", "parameters": ["trans_x", "trans_y"],
           "cost": "hybrid", "outer_padding": 0,
           "cost_with_weight": {"multi_focal_normalized_gradient_magnitude": 1.0, "total_variation": 0.01},
           "iwe": {"method": "bilinear_vote", "blur_sigma": 1}}
    base = {"n_iter": 8, "method": "Newton-CG", "max_iter": 4, "cg_maxiter": 6,
            "parameters": {"trans_x": {"min": -20, "max": 20}, "trans_y": {"min": -20, "max": 20}}}
    for extra in ({}, {"hvp_mode": "analytic", "fd_polish": 2, "coarse_event_fraction": 0.25}):
        out = []
        for chain in (True, False):
            st = tsolver.collections[slv["method"]]((h, w), {}, slv, dict(base, chain=chain, **extra), {},
                                                    device=cuda_device)
            best = st.optimize(events)
            out.append((best, st.last_frame_stats))
        (bc, sc), (bl, sl) = out
        assert sc["chain"] and not sl["chain"]
        for key in ("iters", "loss", "hvp", "events", "launches", "syncs"):
            assert sc[key] == sl[key], key
        assert all(c["fwd"] > 0 and c["bwd"] > 0 for c in sc["launches"].values())
        assert all(torch.equal(bc[s], bl[s]) for s in bc)


@pytest.mark.cuda
def test_a_capture_that_reads_the_host_raises(cuda_device, deterministic):
    """An evaluation with a host read inside cannot be captured: the first
    call raises instead of running eagerly, and the card stays usable."""
    from event_based_optical_flow_tpu_torch.solver.graphs import ChainGraphs
    from event_based_optical_flow_tpu_torch.solver.newton_cg import EagerEvaluations

    spec, frame, orig, m, _ = _chain_problem(torch.float32, cuda_device)
    stage = ChainGraphs(cuda_device).stage("full", frame, orig)
    obj = build_objective(spec)
    reads = stage.evaluations((spec, "reads"), lambda x, *a: obj(x, *a)[0] * float(x.abs().sum() > 0))
    assert EagerEvaluations(lambda x, *a: obj(x, *a)[0] * float(x.abs().sum() > 0), (orig, frame)).value(m) > 0
    with pytest.raises(RuntimeError):
        reads.value(m)
    assert torch.zeros(3, device=cuda_device).add(1).sum().item() == 3.0


# --- the fleet chain: a batch's evaluations replayed from CUDA graphs ---------
def _fleet_chain_problem(dtype, device, scheme=None, seeds=(21, 22), sizes=(4000, 3500)):
    """A batch of frames of ``_objective_problem``'s events (one seed and
    count each; time-aware with ``T_BINS`` bins and ``scheme``) on the card:
    (spec, fleet, orig IWEs, motions [B, 8], directions)."""
    import dataclasses

    from event_based_optical_flow_tpu_torch.solver.fleet import build_orig_iwe_batched

    events, spec = [], None
    for seed, n in zip(seeds, sizes):
        ev, spec = _objective_problem(np.random.default_rng(seed))
        events.append(ev[:n])
    time_bin = None if scheme is None else T_BINS
    if scheme is not None:
        spec = dataclasses.replace(spec, time_aware=True, time_bin=T_BINS, flow_interpolation=scheme,
                                   t0_location="middle")
    fleet = FleetEvents.from_numpy(events, device, dtype, time_bin=time_bin)
    rng = np.random.default_rng(sum(seeds))
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    b = len(events)
    return spec, fleet, build_orig_iwe_batched(spec)(fleet), t(rng.uniform(-20, 20, (b, 8))), t(rng.normal(0, 1, (b, 8)))


def _batched_evaluations(spec, stage_or_args):
    """The batched objective's evaluations, staged on a batch's
    ``graphs.Stage`` or eager on ``(orig, fleet)``."""
    from event_based_optical_flow_tpu_torch.solver.fleet import (
        build_batched_objective,
        build_batched_objective_hvp_staged,
    )
    from event_based_optical_flow_tpu_torch.solver.graphs import Stage
    from event_based_optical_flow_tpu_torch.solver.newton_cg import BatchedEvaluations

    value = build_batched_objective(spec)
    prep, hvp = build_batched_objective_hvp_staged(spec, True)
    if isinstance(stage_or_args, Stage):
        return stage_or_args.evaluations((spec, "test"), value, hvp, prep)
    return BatchedEvaluations(value, stage_or_args, hvp, prep)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", [None, "burgers"])
def test_replayed_batched_evaluations_equal_eager(cuda_device, deterministic, scheme):
    """A batch's value, value and gradient, central and one-sided FD HVP
    (each frame's eps on the device) and analytic prep and HVP (the
    batched K1/K3/K4, or K5/K6 time-aware), captured at their first call
    and replayed at every later one, give the eager evaluations' bits and
    count the eager launches."""
    from event_based_optical_flow_tpu_torch import ops
    from event_based_optical_flow_tpu_torch.solver.graphs import ChainGraphs

    spec, fleet, orig, m, p = _fleet_chain_problem(torch.float32, cuda_device, scheme)
    eager = _batched_evaluations(spec, (orig, fleet))
    stage = ChainGraphs(cuda_device).stage("fleet-full", fleet, orig)
    assert stage.batched and stage.key[:2] == (2, (4000, 3500))
    staged = _batched_evaluations(spec, stage)
    g0 = eager.value_grad(m)[1]
    for k in range(3):
        mk, pk = m + 0.5 * k, p * (1 + k)
        ops.reset_launch_counts()
        want = _all_kinds(eager, mk, pk, g0)
        torch.cuda.synchronize()
        eager_counts = ops.launch_counts()
        ops.reset_launch_counts()
        got = _all_kinds(staged, mk, pk, g0)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want)), k
        assert ops.launch_counts() == eager_counts and eager_counts[FI.form(fleet.bins, fleet.frames) + "jvp"] > 0
    assert all(c.graph is not None for c in (staged._value, staged._value_grad, staged._fd_central,
                                             staged._fd_one_sided, staged._prep, staged._hvp))


@pytest.mark.cuda
def test_batch_of_same_counts_replays_other_counts_restage(cuda_device, deterministic):
    """A batch with the first's per-frame event counts is copied into its
    stage (the frame table too) and replays its graphs with the eager bits
    on the new events; a batch with another per-frame count gets a new
    stage and new graphs."""
    from event_based_optical_flow_tpu_torch.solver.graphs import ChainGraphs

    graphs = ChainGraphs(cuda_device)
    spec, fleet0, orig0, m, _ = _fleet_chain_problem(torch.float32, cuda_device)
    stage = graphs.stage("fleet-full", fleet0, orig0)
    staged = _batched_evaluations(spec, stage)
    staged.value_grad(m)
    graph = staged._value_grad.graph
    for seeds, sizes in (((23, 24), (4000, 3500)), ((23, 24), (4000, 3000))):
        _, fleet, orig, _, _ = _fleet_chain_problem(torch.float32, cuda_device, seeds=seeds, sizes=sizes)
        want = _batched_evaluations(spec, (orig, fleet)).value_grad(m)
        again = graphs.stage("fleet-full", fleet, orig)
        got = _batched_evaluations(spec, again).value_grad(m)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        if sizes == (4000, 3500):
            assert again is stage and again.frame.x is fleet0.x and staged._value_grad.graph is graph
        else:
            assert again is not stage and again.key[1] == (4000, 3000)
    with pytest.raises(ValueError, match="copy_ takes a fleet"):
        stage.frame.copy_(again.frame)


@pytest.mark.cuda
def test_lockstep_newton_replayed_equals_eager(cuda_device, deterministic):
    """One scale's lockstep Newton-CG (FD and analytic with its FD polish)
    through a batch's staged evaluations gives the eager solve's iterates,
    losses, iterations and host syncs bit for bit."""
    from event_based_optical_flow_tpu_torch.solver.fleet import (
        BatchedNewtonCG,
        build_batched_objective,
        build_batched_objective_hvp_staged,
    )
    from event_based_optical_flow_tpu_torch.solver.graphs import ChainGraphs

    spec, fleet, orig, m, _ = _fleet_chain_problem(torch.float32, cuda_device)
    stage = ChainGraphs(cuda_device).stage("fleet-full", fleet, orig)
    prep, hvp = build_batched_objective_hvp_staged(spec, True)
    for name, kw in (("fd", {}), ("analytic-gn", {"hvp_mode": "analytic", "hvp_fn": hvp, "hvp_prep_fn": prep,
                                                   "max_step": 10.0, "fd_polish": 2})):
        runs = []
        for use_stage in (False, True):
            solve = BatchedNewtonCG(build_batched_objective(spec), maxiter=3, cg_maxiter=6, **kw)
            if use_stage:
                ev = stage.evaluations((spec, name), solve.value_fn, solve.hvp_fn, solve.hvp_prep_fn)
                out = solve.solve(ev, m)
            else:
                out = solve(m, orig, fleet)
            torch.cuda.synchronize()
            runs.append(out + (solve.syncs,))
        (xe, fe, ke, se), (xs, fs, ks, ss) = runs
        assert torch.equal(xe, xs) and torch.equal(fe, fs) and (ke, se) == (ks, ss), name


@pytest.mark.cuda
def test_a_batched_capture_that_reads_the_host_raises(cuda_device, deterministic):
    """A batch's evaluation with a host read inside raises at its first
    call instead of running eagerly; the card stays usable."""
    from event_based_optical_flow_tpu_torch.solver.fleet import build_batched_objective
    from event_based_optical_flow_tpu_torch.solver.graphs import ChainGraphs

    spec, fleet, orig, m, _ = _fleet_chain_problem(torch.float32, cuda_device)
    stage = ChainGraphs(cuda_device).stage("fleet-full", fleet, orig)
    obj = build_batched_objective(spec)
    reads = stage.evaluations((spec, "reads"), lambda x, *a: obj(x, *a) * float(x.abs().sum() > 0))
    with pytest.raises(RuntimeError):
        reads.value(m)
    assert torch.zeros(3, device=cuda_device).add(1).sum().item() == 3.0


@pytest.mark.cuda
def test_no_garbage_collection_inside_a_capture(cuda_device, deterministic):
    """The collector is off while an evaluation is captured (a dead
    solver's graph destroyed there would reset inside the capture and
    invalidate it) and on again afterwards; the warm-up runs with it on."""
    import gc

    from event_based_optical_flow_tpu_torch.solver.graphs import ChainGraphs

    spec, frame, orig, m, _ = _chain_problem(torch.float32, cuda_device)
    obj = build_objective(spec)
    seen = []
    staged = ChainGraphs(cuda_device).stage("full", frame, orig).evaluations(
        (spec, "gc"), lambda x, *a: seen.append(gc.isenabled()) or obj(x, *a)[0])
    assert gc.isenabled()
    staged.value(m)
    staged.value(m + 1.0)
    assert seen == [True, False] and gc.isenabled()


# ---- the EV-FlowNet path: K8 forward and backward under the DNN's loss ----


def _dnn_batch(seed=0, b=2, n=3000, pad=1000, h=32, w=48):
    """[b, n + pad, 4] events with signed polarity and padded rows, their
    weights, and random smooth flows per decoder scale (px/s, a 0.1 s
    window)."""
    rng = np.random.default_rng(seed)
    ev = np.zeros((b, n + pad, 4))
    ev[:, :n, 0] = rng.uniform(0, h - 1, (b, n))
    ev[:, :n, 1] = rng.uniform(0, w - 1, (b, n))
    ev[:, :n, 2] = np.sort(rng.uniform(0, 0.1, (b, n)), axis=-1)
    ev[:, :n, 3] = rng.integers(0, 2, (b, n))
    wt = np.zeros((b, n + pad))
    wt[:, :n] = 1.0
    flows = {f"flow{i}": 30.0 * rng.normal(size=(b, 2, h >> (3 - i), w >> (3 - i))) for i in range(4)}
    return ev, wt, flows


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-9), (torch.float32, 1e-4)])
def test_dnn_voxel_grid_kernel_matches_plain_and_exact_model(cuda_device, dtype, tol):
    """The voxel featurizer's one K8 launch (signed, temporally weighted
    votes in [-1, 1] of every bin and item): the plain vote on the same
    tensors to rounding, the exact model of K8's fixed-point bits to 0."""
    from event_based_optical_flow_tpu_torch.models.ev_flownet import events_to_voxel_grid

    ev_np, wt_np, _ = _dnn_batch()
    ev = torch.as_tensor(ev_np, dtype=dtype, device=cuda_device)
    wt = torch.as_tensor(wt_np, dtype=dtype, device=cuda_device)
    VOTE.reset_launch_counts()
    got = events_to_voxel_grid(ev, (32, 48), 4, wt)
    assert VOTE.launch_counts()["vote"] == 1 and got.shape == (2, 4, 32, 48)
    calls = []
    kernel = VOTE.bilinear_vote_kernel
    VOTE.bilinear_vote_kernel = lambda e, s, w=1.0, eps=1e-6, *a: calls.append((e, w)) or kernel(e, s, w, eps, *a)
    try:
        events_to_voxel_grid(ev, (32, 48), 4, wt)
    finally:
        VOTE.bilinear_vote_kernel = kernel
    (planes, weight), = calls
    assert (weight < 0).any() and weight.abs().max() <= 1.0
    want = VOTE.bilinear_vote_plain(planes, (32, 48), weight)
    assert (got - want).abs().max().item() <= tol * max(1.0, want.abs().max().item())
    exact = VOTE.bilinear_vote_fixed_reference(planes.cpu(), (32, 48), weight.cpu())
    assert torch.equal(got.cpu(), exact)


@pytest.mark.cuda
@pytest.mark.parametrize("multi_scale", [False, True])
def test_dnn_loss_and_flow_gradient_on_gpu_match_cpu(cuda_device, deterministic, multi_scale):
    """The CMax loss of the DNN (K8 forward, the analytic four-corner
    backward) in float64 on the GPU against the same on the CPU (the plain
    vote and its autograd): per-item values and the flow gradients."""
    from event_based_optical_flow_tpu_torch.models import train as TT

    ev_np, wt_np, flows_np = _dnn_batch(1)
    keys = [f"flow{i}" for i in range(4)] if multi_scale else ["flow3"]
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        flows = {k: torch.as_tensor(flows_np[k], device=dev).requires_grad_(True) for k in keys}
        ev, wt = (torch.as_tensor(a, device=dev) for a in (ev_np, wt_np))
        VOTE.reset_launch_counts()
        if multi_scale:
            loss = TT.multi_scale_cmax_loss(flows, ev, (32, 48), wt)
        else:
            loss = TT.unsupervised_cmax_loss(flows["flow3"], ev, (32, 48), wt)
        forward = VOTE.launch_counts()["vote"]
        loss.sum().backward()
        assert VOTE.launch_counts()["vote"] == forward  # the backward is a gather, no launch
        assert forward == (len(keys) if dev.type == "cuda" else 0)
        out[dev.type] = (loss.detach().cpu(), [flows[k].grad.cpu() for k in keys])
    (want, want_g), (got, got_g) = out["cpu"], out["cuda"]
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-9 * max(1.0, want.abs().max().item())
    for g, wg in zip(got_g, want_g):
        assert wg.abs().max() > 0
        assert (g - wg).abs().max().item() <= 1e-9 * max(1.0, wg.abs().max().item())


@pytest.mark.cuda
def test_vote_far_and_nan_positions_on_gpu(cuda_device, deterministic):
    """Events at +-1e6, inf and NaN positions through K8 and its backward:
    no vote, a zero gradient (floor(NaN) converts to 0 on the GPU, so the
    backward masks non-finite positions itself), the other events as on the
    CPU."""
    rng = np.random.default_rng(3)
    n, h, w = 400, 9, 11
    ev = np.stack([rng.uniform(0, h - 1, n), rng.uniform(0, w - 1, n), rng.uniform(0, 1, n), np.ones(n)], 1)
    ev[:8, :2] = [[1e6, 3.0], [-1e6, 2.0], [4.0, 1e6], [2.0, -1e6], [np.nan, 3.0], [2.0, np.nan],
                  [np.inf, 1.0], [np.nan, np.nan]]
    wt = rng.uniform(-1.0, 1.0, n)
    g = rng.normal(size=(h, w))
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        e = torch.as_tensor(ev, device=dev).requires_grad_(True)
        image = VOTE.bilinear_vote(e, (h, w), torch.as_tensor(wt, device=dev))
        (image * torch.as_tensor(g, device=dev)).sum().backward()
        out[dev.type] = (image.detach().cpu(), e.grad.cpu())
    assert torch.isfinite(out["cuda"][0]).all() and torch.isfinite(out["cuda"][1]).all()
    assert not out["cuda"][1][:8].any()
    # K8's images are its fixed-point bits: the exact model's, and the plain sums' to rounding
    assert torch.equal(out["cuda"][0], VOTE.bilinear_vote_fixed_reference(
        torch.as_tensor(ev), (h, w), torch.as_tensor(wt)))
    assert (out["cuda"][0] - out["cpu"][0]).abs().max().item() <= 1e-9 * max(1.0, out["cpu"][0].abs().max().item())
    assert (out["cuda"][1] - out["cpu"][1]).abs().max().item() <= 1e-10


@pytest.mark.cuda
def test_dnn_train_steps_on_gpu_are_deterministic_and_match_cpu(cuda_device, deterministic):
    """Three multi-scale Adam steps of EV-FlowNet (cuDNN convolutions, the
    slice-sum upsample and reflect pad, K8) in float64 from one seed, twice
    on the GPU: the same loss and parameter bits; and against the CPU: the
    losses to 1e-9 relative, the parameters to 1e-7 x their tensor's
    largest value (TF32 is off)."""
    from event_based_optical_flow_tpu_torch.models import train as TT

    ev_np, wt_np, _ = _dnn_batch(2, n=1500, pad=548, h=32, w=32)
    runs = []
    for dev in (cuda_device, cuda_device, torch.device("cpu")):
        model, opt = TT.make_dnn_train_state((32, 32), 4, lr=3e-4, scale_time=8.0, device=dev,
                                             dtype=torch.float64)
        step, _ = TT.dnn_train_step(model, opt, (32, 32), 4, multi_scale=True)
        ev, wt = (torch.as_tensor(a, device=dev) for a in (ev_np, wt_np))
        losses = [float(step(ev, wt)) for _ in range(3)]
        runs.append((losses, {k: v.cpu() for k, v in model.state_dict().items()}))
    (l1, p1), (l2, p2), (lc, pc) = runs
    assert l1 == l2 and all(torch.equal(p1[k], p2[k]) for k in p1)
    assert np.allclose(l1, lc, rtol=1e-9, atol=0)
    for k in p1:
        assert (p1[k] - pc[k]).abs().max().item() <= 1e-7 * max(1.0, pc[k].abs().max().item())


def _small_solver(dev, **opt):
    """The single-scale tile solver (2 x 2 tiles, float64) on ``dev`` with
    the ``optimizer`` entries ``opt``, and the events of a random scene."""
    from event_based_optical_flow_tpu_torch import solver as S

    method = "mixed_patch_contrast_maximization"
    slv = {"method": method, "patch": {"initialize": "zero", "size": [20, 26], "sliding_window": [20, 26]},
           "motion_model": "2d-translation", "cost": "hybrid", "precision": "64",
           "cost_with_weight": {"multi_focal_normalized_gradient_magnitude": 1.0, "total_variation": 0.01},
           "iwe": {"method": "bilinear_vote", "blur_sigma": 1}}
    optimizer = {"n_iter": 8, "max_iter": 2, "method": "Newton-CG", "parameters": {"trans_x": {"min": -20, "max": 20},
                                                           "trans_y": {"min": -20, "max": 20}}, **opt}
    rng = np.random.default_rng(3)
    events = np.stack([rng.uniform(0, H - 1, 4000), rng.uniform(0, W - 1, 4000), np.sort(rng.uniform(0, 0.1, 4000)),
                       rng.integers(0, 2, 4000)], axis=1)
    return S.collections[method]((H, W), {}, slv, optimizer, {}, device=dev), events


@pytest.mark.cuda
def test_visualization_images_are_k8_votes(cuda_device, deterministic):
    """The solvers' visualization IWEs on the card: one K8 launch each, the
    bits of K8's exact model clipped as the visualizer clips them."""
    from event_based_optical_flow_tpu_torch.visualizer import clip_iwe

    solv, events = _small_solver(cuda_device)
    flow = torch.as_tensor(np.random.default_rng(4).uniform(-5, 5, (2, H, W)), device=cuda_device)
    for direction in ("first", "middle"):
        VOTE.reset_launch_counts()
        got = solv._warped_viz_iwe(events, flow, "dense-flow", direction, return_warped=True)
        assert VOTE.launch_counts()["vote"] == 1
        want = VOTE.bilinear_vote_fixed_reference(got[1].cpu(), (H, W))
        np.testing.assert_array_equal(got[0], clip_iwe(want.numpy(), solv.iwe_visualize_max_scale))
    VOTE.reset_launch_counts()
    got = solv.create_clipped_iwe_for_visualization(events)
    assert VOTE.launch_counts()["vote"] == 1
    want = VOTE.bilinear_vote_fixed_reference(torch.as_tensor(events), (H, W))
    np.testing.assert_array_equal(got, clip_iwe(want.numpy(), 50))


@pytest.mark.cuda
@pytest.mark.parametrize("method,kernels", [("BFGS", ("fwd", "bwd")), ("trust-exact", ("fwd", "bwd", "jvp", "hvp_bwd")),
                                            ("Adam", ("fwd", "bwd")), ("optuna", ("fwd",))])
def test_host_optimizers_launch_the_kernels_and_match_cpu(cuda_device, deterministic, method, kernels):
    """Each host-driven route on the card runs its kernels (no plain
    fallback: K1/K2, and K3/K4 for trust-exact's Hessian) and lands where
    the same float64 solve on the CPU does (to 1e-6)."""
    from event_based_optical_flow_tpu_torch import ops

    results = []
    for dev in (cuda_device, torch.device("cpu")):
        solv, events = _small_solver(dev, method=method)
        ops.reset_launch_counts()
        results.append(solv.optimize(events).cpu().numpy())
        if dev.type == "cuda":
            counts = ops.launch_counts()
            assert all(counts[k] > 0 for k in kernels), counts
    np.testing.assert_allclose(results[0], results[1], rtol=0, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("fleet", [False, True])
def test_chained_lbfgs_equals_the_loop(cuda_device, deterministic, fleet):
    """``device_solver: lbfgs`` on the card: the chained frame (the
    sequential pyramid) or batch (the fleet) gives its loop's per-scale
    losses, iterations, host syncs and launches (K1/K2 only) bit for bit;
    the sequential one also the same pyramid."""
    from event_based_optical_flow_tpu_torch import solver as tsolver
    from event_based_optical_flow_tpu_torch.data.synthetic import SyntheticDataLoader

    h, w = 32, 40
    loader = SyntheticDataLoader({"height": h, "width": w, "duration": 1.0, "event_rate": 12000, "n_frames": 4,
                                  "pattern": "dots", "n_dots": 60, "flow_max": 12.0})
    loader.set_sequence("pyramid")
    ts = loader.eval_frame_time_list()
    windows = [loader.load_event(loader.time_to_index(ts[i]), loader.time_to_index(ts[i + 1])) for i in (1, 2)]
    method = "fleet_pyramidal_patch_contrast_maximization" if fleet else "pyramidal_patch_contrast_maximization"
    slv = {"method": method, "time_aware": False,
           "patch": {"initialize": "random", "scale": 3, "crop_height": 32, "crop_width": 40,
                     "filter_type": "bilinear"},
           "motion_model": "2d-translation", "warp_direction": "first", "parameters": ["trans_x", "trans_y"],
           "cost": "hybrid", "outer_padding": 0,
           "cost_with_weight": {"multi_focal_normalized_gradient_magnitude": 1.0, "total_variation": 0.01},
           "iwe": {"method": "bilinear_vote", "blur_sigma": 1}}
    base = {"n_iter": 8, "method": "Newton-CG", "device_solver": "lbfgs", "max_iter": 12,
            "parameters": {"trans_x": {"min": -20, "max": 20}, "trans_y": {"min": -20, "max": 20}}}
    out = []
    for chain in (True, False):
        st = tsolver.collections[method]((h, w), {}, slv, dict(base, chain=chain), {}, device=cuda_device)
        if fleet:  # the chain and the loop draw their sweeps differently: same draws from a fixed start
            st.initialize_guess_from_patch_search_batched = lambda ev, m, n, mx: m
            st.initialize_guess_from_patch_search = lambda ev, m, n: m
            best = st.optimize_batch(windows)
            out.append((best, st.last_batch_stats))
        else:
            out.append((st.optimize(windows[0]), st.last_frame_stats))
    (bc, sc), (bl, sl) = out
    assert sc["chain"] and not sl["chain"] and sc["hvp"] == {1: "lbfgs", 2: "lbfgs"}
    for key in ("iters", "loss", "hvp", "events", "launches", "syncs"):
        assert sc[key] == sl[key], key
    k = "batched_" if fleet else ""
    assert all(c[k + "fwd"] > 0 and c[k + "bwd"] > 0 and c[k + "jvp"] == 0 and c[k + "hvp_bwd"] == 0
               for c in sc["launches"].values())
    frames = zip(bc, bl) if fleet else [(bc, bl)]
    assert all(torch.equal(a[s], b[s]) for a, b in frames for s in a)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 100])
def test_grid_sweep_matches_plain_version(cuda_device, deterministic, chunk, monkeypatch):
    """The ``grid-best`` sweep's losses on the card (K7 over chunks of 1 or
    100 copies of the frame) against the same sweep through the plain vote
    on the card, float64, to 1e-9 x the largest loss; the same chosen
    translation."""
    from event_based_optical_flow_tpu_torch import ops
    from event_based_optical_flow_tpu_torch.solver import objective as O
    from event_based_optical_flow_tpu_torch.solver import patch_base

    solv, events = _small_solver(cuda_device)
    spec = solv._current_spec()
    frame = FrameEvents.from_numpy(events, cuda_device, torch.float64)
    orig = build_orig_iwe(spec)(frame)
    grid = patch_base.grid_translations(30)
    tiles = solv.tensor(np.repeat(grid[:, :, None], solv.n_patch, axis=2).reshape(len(grid), -1))
    ops.reset_launch_counts()
    got = patch_base.grid_sweep_losses(spec, frame, orig, tiles, chunk=chunk)
    counts = ops.launch_counts()
    assert counts["batched_fwd"] == 100 // chunk and counts["fwd"] == 0, counts
    monkeypatch.setattr(O, "fused_iwe", FI.fused_iwe_reference)  # the single-frame objective's vote
    monkeypatch.setattr(FI, "fused_iwe", FI.fused_iwe_reference)  # the batched objective's
    want = patch_base.grid_sweep_losses(spec, frame, orig, tiles, chunk=chunk)
    assert (got - want).abs().max().item() <= 1e-9 * want.abs().max().item()
    assert int(torch.argmin(got)) == int(torch.argmin(want))


PAD = 3


def _padded_cotangents(lead, dtype, device, seed=7):
    """Cotangents of the orig + K padded images and two of the K (``lead``:
    the frame axis of a batched form, or ())."""
    rng = np.random.default_rng(seed)
    shape = (H + 2 * PAD, W + 2 * PAD)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    return (t(rng.normal(size=lead + (1 + len(OFFSETS),) + shape)), t(rng.normal(size=lead + (len(OFFSETS),) + shape)),
            t(rng.normal(size=lead + (len(OFFSETS),) + shape)))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["dense", "batched"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_padded_and_count_kernels_equal_the_exact_models(cuda_device, form, dtype):
    """With an outer padding (``pad``) the forward (bilinear and count),
    the backward, the HVP backward and the tangent give the exact models'
    bits; the count vote's tangent and HVP term are zeros and launch no
    kernel; pad 0 is the unpadded call."""
    ev, kw, fl, _, dfl, _, _ = _form_inputs(form, dtype, cuda_device)
    lead = (len(kw["frames"].sizes),) if form == "batched" else ()
    g, g1, g2 = _padded_cotangents(lead, dtype, cuda_device)
    cev, ckw = _on_cpu(*ev), dict(_model_kw(kw), pad=PAD)
    cfl, cdfl, cg1, cg2 = _on_cpu(fl, dfl, g1, g2)
    kw = dict(kw, pad=PAD)
    k = (slice(None),) if lead else ()
    for offsets, orig in ((OFFSETS, True), ((), True), (OFFSETS, False)):
        for count in (False, True):
            got = FI.fused_iwe_fwd(fl, *ev, offsets, orig, count=count, **kw).cpu()
            assert got.shape[-2:] == (H + 2 * PAD, W + 2 * PAD)
            assert torch.equal(got, FI.fused_iwe_fixed_reference(cfl, *cev, offsets, orig, count=count, **ckw))
        if offsets:
            gk = g[k + (slice(int(not orig), None),)].contiguous()
            got = FI.fused_iwe_bwd(fl, *ev, gk, offsets, orig, **kw).cpu()
            assert torch.equal(got, FI.fused_iwe_bwd_ordered_reference(cfl, *cev, gk.cpu(), offsets, orig, **ckw))
    for term_a in (False, True):
        got = FI.fused_iwe_hvp_bwd(fl, dfl, g1, g2, *ev, OFFSETS, term_a, **kw).cpu()
        want = FI.fused_iwe_bwd_ordered_reference(cfl, *cev, cg2, OFFSETS, False, **ckw,
                                                  **({"g1": cg1, "dflow": cdfl} if term_a else {}))
        assert torch.equal(got, want)
    for emit_value in (False, True):
        got = FI.fused_iwe_jvp(fl, dfl, *ev, OFFSETS, emit_value, **kw)
        want = FI.fused_iwe_jvp_fixed_reference(cfl, cdfl, *cev, OFFSETS, emit_value, **ckw)
        for a, b in zip(got, want) if emit_value else ((got, want),):
            assert torch.equal(a.cpu(), b)
    FI.reset_launch_counts()
    val, tan = FI.fused_iwe_jvp(fl, dfl, *ev, OFFSETS, True, count=True, **kw)
    term = FI.fused_iwe_hvp_bwd(fl, dfl, g1, g2, *ev, OFFSETS, True, count=True, **kw)
    assert not tan.abs().max().item() and not term.abs().max().item()
    assert torch.equal(val, FI.fused_iwe_fwd(fl, *ev, OFFSETS, False, count=True, **kw))
    assert FI.launch_counts() == _counts(**{FI.form(kw["bins"], kw.get("frames")) + "fwd": 2})
    unpadded = dict(kw, pad=0)
    assert torch.equal(FI.fused_iwe_fwd(fl, *ev, OFFSETS, True, **unpadded),
                       FI.fused_iwe_fwd(fl, *ev, OFFSETS, True, bins=kw["bins"], frames=kw.get("frames")))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_padded_and_count_votes_equal_the_exact_model(cuda_device, dtype):
    """K8 with a padding and in count mode on both launch paths (a
    full-frame image: global sums; a batch of patches: shared memory):
    the exact model's bits; the count vote's position gradient is 0."""
    rng = np.random.default_rng(11)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda_device)  # noqa: E731
    frame = t(np.stack([rng.uniform(-3, 262, 20000), rng.uniform(-3, 348, 20000), rng.uniform(0, 1, 20000),
                        rng.choice([-1.0, 1.0], 20000)], 1))
    patches = t(np.concatenate([rng.uniform(-2, 18, (6, 3, 500, 2)), rng.uniform(0, 1, (6, 3, 500, 2))], -1))
    wt = t(rng.uniform(0, 1, (6, 1, 500)))
    for ev, w, size in ((frame, 1.0, (260 + 2 * PAD, 346 + 2 * PAD)), (patches, wt, (16 + 2 * PAD, 21 + 2 * PAD))):
        cw = w.cpu() if torch.is_tensor(w) else w
        for count in (False, True):
            got = VOTE.bilinear_vote_kernel(ev, size, w, padding=PAD, count=count).cpu()
            assert torch.equal(got, VOTE.bilinear_vote_fixed_reference(ev.cpu(), size, cw, padding=PAD, count=count))
    ev = patches.clone().requires_grad_(True)
    (d,) = torch.autograd.grad(VOTE.count_vote(ev, (16, 21), wt, padding=PAD).sum(), ev)
    assert not d.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("method,pad", [("bilinear_vote", PAD), ("count", PAD), ("polarity", 0)])
def test_unfused_objective_and_exact_hvp_on_gpu_match_cpu(cuda_device, deterministic, method, pad):
    """The unfused objective's value, gradient and exact HVP (K1-K4; K7's
    two-channel table for polarity) in float64 on the GPU against the
    plain versions on the CPU."""
    import dataclasses

    from event_based_optical_flow_tpu_torch.solver.objective import build_value_grad_hvp

    rng = np.random.default_rng(5)
    events, spec = _objective_problem(rng)
    events[:, 3] = np.where(events[:, 3] > 0, 1.0, -1.0)
    spec = dataclasses.replace(spec, outer_padding=pad, iwe_method=method)
    motion, p = rng.uniform(-20, 20, 8), rng.normal(size=8)
    out = {}
    for dev in ("cpu", cuda_device):
        frame = FrameEvents.from_numpy(events, dev, torch.float64, polarity=method == "polarity")
        orig = build_orig_iwe(spec)(frame)
        vg, hvp, _ = build_value_grad_hvp(spec)
        m, pp = (torch.as_tensor(a, dtype=torch.float64, device=dev) for a in (motion, p))
        loss, grad, _ = vg(m, orig, frame)
        out[str(dev)] = (loss.item(), grad.cpu().numpy(), hvp(m, pp, orig, frame).cpu().numpy())
    (l_cpu, g_cpu, h_cpu), (l_gpu, g_gpu, h_gpu) = out["cpu"], out[str(cuda_device)]
    assert l_gpu == pytest.approx(l_cpu, rel=1e-9)
    np.testing.assert_allclose(g_gpu, g_cpu, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(h_gpu, h_cpu, rtol=0, atol=1e-9 * max(1e-3, np.abs(h_cpu).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["bilinear_vote", "polarity"])
def test_time_aware_exact_hvp_on_gpu_matches_cpu(cuda_device, deterministic, method):
    """The padded time-aware exact HVP (K6 with term A, and the voxel map's
    own curvature against K5's backward: ``objective.map_curvature``),
    sequential and batched (B=2), in float64 on the GPU against the plain
    versions on the CPU, to 1e-9 of max|Hp|."""
    import dataclasses

    from event_based_optical_flow_tpu_torch.solver.fleet import (
        build_batched_objective_hvp_staged,
        build_orig_iwe_batched,
    )

    rng = np.random.default_rng(9)
    events, spec = _objective_problem(rng)
    events[:, 3] = np.where(events[:, 3] > 0, 1.0, -1.0)
    spec = dataclasses.replace(spec, time_aware=True, time_bin=T_BINS, flow_interpolation="burgers",
                               t0_location="middle", outer_padding=PAD, iwe_method=method)
    motion, p = rng.uniform(-20, 20, (2, 8)), rng.normal(size=(2, 8))
    polarity = method == "polarity"
    out = {}
    for dev in ("cpu", cuda_device):
        t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
        frame = FrameEvents.from_numpy(events, dev, torch.float64, time_bin=T_BINS, polarity=polarity)
        orig = build_orig_iwe(spec)(frame)
        prep, hvp = build_objective_hvp_staged(spec, False)
        one = hvp(prep(t(motion[0]), orig, frame), t(motion[0]), t(p[0]), orig, frame)
        fleet = FleetEvents.from_numpy([events, events[:3000]], dev, torch.float64, time_bin=T_BINS,
                                       polarity=polarity)
        borig = build_orig_iwe_batched(spec)(fleet)
        bprep, bhvp = build_batched_objective_hvp_staged(spec, False)
        batch = bhvp(bprep(t(motion), borig, fleet), t(motion), t(p), borig, fleet)
        out[str(dev)] = (one.cpu().numpy(), batch.cpu().numpy())
    for got, want in zip(out[str(cuda_device)], out["cpu"]):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())


@pytest.mark.cuda
@pytest.mark.parametrize("time_bin", [None, 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_event_sharded_objective_keeps_the_single_device_bits(cuda_device, deterministic, time_bin, dtype):
    """A frame cut over 3 shards of one card (``FrameEvents.shard``): the
    orig IWE, the objective, its gradient and the staged analytic HVP (K1/K5
    into per-shard int64 sums, K2/K5's backward per shard, K3/K6 in the
    reduced bound, K4/K6's backward per shard) are the unsharded objective's
    bits, and K1-K4 launch once per shard."""
    import dataclasses

    from event_based_optical_flow_tpu_torch import ops

    rng = np.random.default_rng(9)
    events, spec = _objective_problem(rng)
    events[:1500, :2] = (11.0, 17.0)  # a run across the even cuts
    if time_bin:
        spec = dataclasses.replace(spec, time_aware=True, time_bin=time_bin, flow_interpolation="burgers",
                                   t0_location="middle")
    frame = FrameEvents.from_numpy(events, cuda_device, dtype, time_bin)
    sharded = frame.shard([cuda_device] * 3)
    motion = torch.as_tensor(rng.uniform(-20, 20, 8), dtype=dtype, device=cuda_device)
    p = torch.as_tensor(rng.normal(size=8), dtype=dtype, device=cuda_device)
    out = []
    for fr in (frame, sharded):
        ops.reset_launch_counts()
        orig = build_orig_iwe(spec)(fr)
        m = motion.clone().requires_grad_(True)
        loss, _ = build_objective(spec)(m, orig, fr)
        (grad,) = torch.autograd.grad(loss, m)
        prep, hvp = build_objective_hvp_staged(spec)
        out.append((orig, loss.detach(), grad, hvp(prep(motion, orig, fr), motion, p, orig, fr),
                    ops.launch_counts()))
    (o1, l1, g1, h1, c1), (o2, l2, g2, h2, c2) = out
    assert torch.equal(o1, o2) and torch.equal(l1, l2) and torch.equal(g1, g2) and torch.equal(h1, h2)
    pre = "voxel_" if time_bin else ""
    assert c1[pre + "jvp"] == 1 and c2[pre + "jvp"] == 3 and c2[pre + "hvp_bwd"] == 3 and c2[pre + "bwd"] == 3
    assert c2["fwd"] == 3 * c1["fwd"]  # the orig votes (dense), each evaluation's forward


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_split_entry_points_equal_their_exact_models(cuda_device, dtype):
    """K1's vote into int64 sums and its conversion, K3's bound, vote and
    conversion, K8's sums and conversion, each on one shard of a frame,
    against the exact models' sums (error 0)."""
    rng = np.random.default_rng(10)
    events, _ = _objective_problem(rng)
    frame = FrameEvents.from_numpy(events, cuda_device, dtype)
    sh = frame.shard([cuda_device] * 2).shards[1]
    cpu = [t.cpu() for t in (sh.x, sh.y, sh.dtf, sh.wt)]
    flow = torch.as_tensor(rng.normal(size=(2, H, W)) * 3, dtype=dtype, device=cuda_device)
    dflow = torch.as_tensor(rng.normal(size=(2, H, W)), dtype=dtype, device=cuda_device)
    offsets = (0.0, 1.0, 0.5)
    acc = torch.zeros((4, H, W), dtype=torch.int64, device=cuda_device)
    FI.fused_iwe_fwd_acc(flow, sh.x, sh.y, sh.dtf, sh.wt, offsets, True, acc)
    want = FI.fused_iwe_fixed_reference(flow.cpu(), *cpu, offsets, True, fixed=True)
    assert torch.equal(acc.cpu(), want)
    assert torch.equal(FI.fused_iwe_from_fixed(acc, dtype).cpu(), FI.fused_iwe_from_fixed(want, dtype))
    bound = FI.fused_iwe_jvp_bound(dflow, sh.x, sh.y, sh.dtf, sh.wt, offsets)
    assert torch.equal(bound.cpu(), FI.fused_iwe_jvp_bound(dflow.cpu(), *cpu, offsets))
    n = frame.x.shape[0]
    tan = torch.zeros((3, H, W), dtype=torch.int64, device=cuda_device)
    val = torch.zeros((3, H, W), dtype=torch.int64, device=cuda_device)
    FI.fused_iwe_jvp_acc(flow, dflow, sh.x, sh.y, sh.dtf, sh.wt, offsets, bound, n, tan, val)
    b = float(bound.cpu().view(torch.float64)[0])
    want_tan = FI.fused_iwe_jvp_fixed_reference(flow.cpu(), dflow.cpu(), *cpu, offsets, False, bound=b,
                                                unit_events=n, fixed=True)
    assert torch.equal(tan.cpu(), want_tan)
    assert torch.equal(val.cpu(), FI.fused_iwe_fixed_reference(flow.cpu(), *cpu, offsets, False, fixed=True))
    assert torch.equal(FI.fused_iwe_from_scaled(tan, bound, n, dtype).cpu(),
                       FI.fused_iwe_from_scaled(want_tan, bound.cpu(), n, dtype))
    pos = torch.as_tensor(events, dtype=dtype, device=cuda_device)
    for size in ((H, W), (400, 400)):  # shared memory, global sums
        sums = VOTE.vote_acc(pos, size)
        want = VOTE.bilinear_vote_fixed_reference(pos.cpu(), size, fixed=True)
        assert torch.equal(sums.cpu(), want)
        assert torch.equal(VOTE.vote_from_fixed(sums, dtype).cpu(), VOTE.vote_from_fixed(want, dtype))
