"""GPU tests of the PyTorch port: the hand-written CUDA kernels (the fused
vote and its backward, K1/K2; the tangent and the HVP backward, K3/K4;
their time-aware voxel forms, K5/K6; the batched forms of all of them, K7;
the standalone vote, K8) against their plain PyTorch versions, the
forward and backward against the exact models of their bits (error 0),
each batched frame against the single-frame kernel on that frame alone, and the fused objective and its
analytic HVP (dense and time-aware) on the GPU against the same on the CPU.  Every test needs an NVIDIA GPU and skips
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
    """The forward, the one-pass backward and the HVP
    backward (both ways of term A) give, bit for bit, the exact models on
    the CPU copies of their inputs: max|err| 0 at every form."""
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
def test_forward_and_backward_in_a_cuda_graph(cuda_device):
    """The batched forward and backward captured in one CUDA graph (their
    scratch from the graph's pool) and replayed twice give the exact
    models' bits every time."""
    fleet, fl, _, g, _, _ = _fleet_inputs(torch.float32, cuda_device)
    ev, kw = (fleet.x, fleet.y, fleet.dtf, fleet.wt), {"bins": None, "frames": fleet.frames}
    ckw = _model_kw(kw)
    want_b = FI.fused_iwe_fixed_reference(fl.cpu(), *_on_cpu(*ev), OFFSETS, True, **ckw)
    want_g = FI.fused_iwe_bwd_ordered_reference(fl.cpu(), *_on_cpu(*ev), g.cpu(), OFFSETS, True, **ckw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up on the capture stream
        FI.fused_iwe_fwd(fl, *ev, OFFSETS, True, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        images = FI.fused_iwe_fwd(fl, *ev, OFFSETS, True, **kw)
        grad = FI.fused_iwe_bwd(fl, *ev, g, OFFSETS, True, **kw)
    for _ in range(2):
        images.zero_()
        grad.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(images.cpu(), want_b) and torch.equal(grad.cpu(), want_g)


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
