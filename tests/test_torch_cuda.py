"""GPU tests of the PyTorch port: the hand-written CUDA kernel pair against
its plain PyTorch version, and the fused objective on the GPU against the
same objective on the CPU.  Every test needs an NVIDIA GPU and skips
without one (``cuda`` marker).

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from event_based_optical_flow_tpu_torch.ops import fused_iwe as FI
from event_based_optical_flow_tpu_torch.solver.objective import (
    FrameEvents,
    ObjectiveSpec,
    build_objective,
    build_orig_iwe,
)

H, W = 40, 52
OFFSETS = (0.0, 1.0, 0.5)


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
    assert FI.launch_counts() == {"fwd": 1, "bwd": 1}
    with pytest.raises(ValueError):
        FI.fused_iwe_fwd(fl.detach(), *ev, tuple(range(FI.MAX_OFFSETS + 1)), False)


@pytest.mark.cuda
def test_objective_on_gpu_matches_cpu(cuda_device):
    """The whole fused objective (kernel, blur, hybrid cost) and its
    gradient in float64 on the GPU against the plain version on the CPU."""
    rng = np.random.default_rng(3)
    n = 4000
    events = np.stack([np.round(rng.uniform(0, H - 1, n)), np.round(rng.uniform(0, W - 1, n)),
                       np.sort(rng.uniform(0, 0.1, n)), rng.integers(0, 2, n)], 1)
    spec = ObjectiveSpec((H, W), (2, 2), (16, 24), (16, 24), (4, 2), "bilinear", 1.0, "hybrid",
                         (("multi_focal_normalized_gradient_magnitude", 1.0), ("total_variation", 0.01)))
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
