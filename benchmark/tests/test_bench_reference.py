"""The plain reference against direct formulas at a tiny size, and its
control (the same arithmetic with TF32 products) failing the limits."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.reference import compare, plain
from benchmark.scene import Sequence

LIN = plain.Linear(False, "cpu")


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 3 * 2.0**-11, 1.0 + 2.0**-12, -3.14159265], dtype=torch.float32)
    got = plain.round_tf32(x)
    assert got[0] == 1.0 and got[3] == 1.0
    assert got[1] == 1.0  # a tie rounds to even
    assert got[2] == 1.0 + 4 * 2.0**-11
    assert abs(float(got[4]) + 3.14159265) < 2.0**-9 * 4
    mant = got.view(torch.int32) & 0x1FFF
    assert torch.all(mant == 0)


def test_vote_matches_the_corner_formula():
    rng = np.random.default_rng(0)
    h, w = 7, 9
    x, y = rng.uniform(-1.5, h + 0.5, 50), rng.uniform(-1.5, w + 0.5, 50)
    want = np.zeros((h, w))
    for xi, yi in zip(x, y):
        r0, c0 = int(np.floor(xi + 1e-6)), int(np.floor(yi + 1e-6))
        fx, fy = xi - r0, yi - c0
        for dr, dc, wt in ((0, 0, (1 - fx) * (1 - fy)), (1, 0, fx * (1 - fy)), (0, 1, (1 - fx) * fy), (1, 1, fx * fy)):
            if 0 <= r0 + dr < h and 0 <= c0 + dc < w:
                want[r0 + dr, c0 + dc] += wt
    got = plain.vote(torch.as_tensor(x), torch.as_tensor(y), (h, w))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_blur_and_sobel_match_direct_stencils():
    rng = np.random.default_rng(1)
    img = rng.normal(size=(6, 8))
    taps = np.exp(-0.5 * np.arange(-1, 2) ** 2)
    taps /= taps.sum()
    padded = np.pad(img, 1, mode="reflect")
    rows = sum(taps[k] * padded[k:k + 6, 1:-1] for k in range(3))
    padded = np.pad(rows, ((0, 0), (1, 1)), mode="reflect")
    want = sum(taps[k] * padded[:, k:k + 8] for k in range(3))
    blur = (LIN.tensor(plain._blur_matrix(6, 1.0)), LIN.tensor(plain._blur_matrix(8, 1.0)))
    np.testing.assert_allclose(LIN.sandwich(blur[0], LIN.tensor(img), blur[1]).numpy(), want, atol=1e-12)
    gx_k = np.array([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], float)
    z = np.pad(img, 1)
    gx = sum(gx_k[a, b] * z[a:a + 6, b:b + 8] for a in range(3) for b in range(3)) / 8
    gy = sum(gx_k.T[a, b] * z[a:a + 6, b:b + 8] for a in range(3) for b in range(3)) / 8
    sx, sy = plain.Sobel((6, 8), LIN)(LIN.tensor(img))
    np.testing.assert_allclose(sx.numpy(), gx, atol=1e-12)
    np.testing.assert_allclose(sy.numpy(), gy, atol=1e-12)
    want_g = np.mean(gx[1:-1, 1:-1] ** 2 + gy[1:-1, 1:-1] ** 2)
    assert float(plain.gradient_magnitude(LIN.tensor(img), plain.Sobel((6, 8), LIN))) == pytest.approx(want_g)


def test_dense_flow_is_replicate_pad_upsample_and_centre_crop():
    solver = {"patch": {"crop_height": 32, "crop_width": 48, "scale": 3}}
    geo = plain.finest_geometry(solver, (40, 56))
    assert geo["tile"] == (8, 12) and geo["grid"] == (4, 4) and geo["shift"] == (4, 4)
    motion = torch.as_tensor(np.random.default_rng(2).normal(size=(2, 4, 4)))
    got = plain.DenseFlow(geo, LIN)(motion)
    # torch's half-pixel bilinear upsample of the replicate-padded grid
    padded = F.pad(motion[None], (1, 1, 1, 1), mode="replicate")
    up = F.interpolate(padded, scale_factor=(8, 12), mode="bilinear", align_corners=False)[0]
    r0, c0 = up.shape[1] // 2 - 20, up.shape[2] // 2 - 28
    np.testing.assert_allclose(got.numpy(), -up[:, r0:r0 + 40, c0:c0 + 56].numpy(), atol=1e-12)


def test_aee_and_mask():
    gt = np.zeros((4, 5, 2))
    gt[..., 0], gt[..., 1] = 1.0, 2.0
    gt[0, 0] = (0.0, 2.0)  # a zero component: not scored
    pred = torch.zeros(2, 4, 5, dtype=torch.float64)
    pred[0, 1, 1] = 1.0
    events = np.array([[0, 0, 0.0, 1], [1, 1, 0.1, 0], [3, 4, 0.2, 1], [3, 4, 0.3, 1]])
    mask = plain.event_mask(events, (4, 5), "cpu")
    assert mask.sum() == 3
    # scored pixels (1, 1) and (3, 4): errors 2 and sqrt(5)
    assert plain.aee(gt, pred, mask) == pytest.approx((2 + np.sqrt(5)) / (2 + 1e-5))
    assert plain.aee(gt, None, mask) == pytest.approx(2 * np.sqrt(5) / (2 + 1e-5))


def test_window_cuts_or_widens_to_the_batch():
    ev = np.zeros((100, 4))
    ev[:, 2] = np.arange(100) * 0.01
    batch, metric = plain.window(ev, 0.105, 0.505, 30)  # indices 10 .. 50: cut to 20 .. 50
    assert len(metric) == 40 and len(batch) == 30 and batch[0, 2] == 0.0
    batch, _ = plain.window(ev, 0.105, 0.305, 30)  # 20 events widened by 5 on each side
    assert len(batch) == 30


def _tiny_config():
    return {"data": {"height": 40, "width": 56, "n_events_per_batch": 1500},
            "solver": {"patch": {"crop_height": 32, "crop_width": 48, "scale": 3},
                       "cost_with_weight": {"multi_focal_normalized_gradient_magnitude": 1.0,
                                            "total_variation": 0.01},
                       "iwe": {"blur_sigma": 1}}}


def test_objective_by_hand():
    config = _tiny_config()
    seq = Sequence({"height": 40, "width": 56, "frame_hz": 20.0, "event_rate": 40000.0, "n_dots": 40,
                    "speeds": [20.0, 15.0, 18.0, 12.0],
                    "angles_deg": [30.0, -100.0, 170.0, 60.0], "turn_period_s": 2.0}, 4, 3)
    batch, _ = plain.window(seq.events, seq.gray_ts[0], seq.gray_ts[1], 1500)
    motion = torch.as_tensor(np.random.default_rng(3).normal(scale=5.0, size=(2, 4, 4)))
    got = plain.Objective(config, LIN)(batch, motion)
    # the same cost from torch's own ops: interpolate, a per-event loop vote
    padded = F.pad(motion[None], (1, 1, 1, 1), mode="replicate")
    up = F.interpolate(padded, scale_factor=(8, 12), mode="bilinear", align_corners=False)[0]
    dense = -up[:, up.shape[1] // 2 - 20:up.shape[1] // 2 + 20, up.shape[2] // 2 - 28:up.shape[2] // 2 + 28]
    t = batch[:, 2]
    span = t.max() - t.min()
    dtf = (t - t.min()) / span
    x, y = batch[:, 0], batch[:, 1]
    u = dense[0].numpy()[x.astype(int), y.astype(int)] * span
    v = dense[1].numpy()[x.astype(int), y.astype(int)] * span
    kernel = torch.tensor([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], dtype=torch.float64)

    def g(img):
        img = torch.as_tensor(img)[None, None]
        k = torch.exp(-0.5 * torch.arange(-1, 2, dtype=torch.float64) ** 2)
        k = k / k.sum()
        img = F.conv2d(F.pad(img, (1, 1, 1, 1), mode="reflect"), (k[:, None] * k[None, :])[None, None])
        gx = F.conv2d(F.pad(img, (1, 1, 1, 1)), kernel[None, None])[0, 0] / 8
        gy = F.conv2d(F.pad(img, (1, 1, 1, 1)), kernel.T[None, None])[0, 0] / 8
        return float((gx[1:-1, 1:-1] ** 2 + gy[1:-1, 1:-1] ** 2).mean())

    def img(off):
        return plain.vote(torch.as_tensor(x - (dtf - off) * u), torch.as_tensor(y - (dtf - off) * v), (40, 56))

    g0 = g(img(0.0).numpy() * 0 + plain.vote(torch.as_tensor(x), torch.as_tensor(y), (40, 56)).numpy())
    focal = g0 / g(img(1.0)) + g0 / g(img(0.0)) + 2 * g0 / g(img(0.5))
    m = motion[None]
    tv = torch.cat([F.conv2d(F.pad(m[:, :1], (1, 1, 1, 1)), kernel[None, None]),
                    F.conv2d(F.pad(m[:, 1:], (1, 1, 1, 1)), kernel.T[None, None]),
                    F.conv2d(F.pad(m[:, 1:], (1, 1, 1, 1)), kernel[None, None]),
                    F.conv2d(F.pad(m[:, :1], (1, 1, 1, 1)), kernel.T[None, None])], 1)[0, :, 1:-1, 1:-1] / 8
    assert got == pytest.approx(focal + 0.01 * float(tv.abs().mean()), rel=1e-12)


def test_control_fails_a_limit():
    """The control (TF32 products) in the program's place at a tiny size:
    its answers differ from the float64 reference's by more than a limit
    allows (the chip run at each cell's size is in PERF.md)."""
    config = _tiny_config()
    seq = Sequence({"height": 40, "width": 56, "frame_hz": 20.0, "event_rate": 40000.0, "n_dots": 40,
                    "speeds": [20.0, 15.0, 18.0, 12.0],
                    "angles_deg": [30.0, -100.0, 170.0, 60.0], "turn_period_s": 2.0}, 11, 4)
    rng = np.random.default_rng(5)
    answers = [compare.Answer(t1=seq.gray_ts[k], t2=seq.gray_ts[k + 1],
                              motion=torch.as_tensor(rng.normal(scale=10.0, size=(2, 4, 4))), loss=0.0, aee=0.0)
               for k in range(3)]
    ref = compare.reference_answers(answers, seq.events, seq, config, "cpu")
    control = compare.reference_answers(answers, seq.events, seq, config, "cpu", tf32=True)
    values = compare.numbers([c[0] for c in control], [c[1] for c in control], ref)
    assert values["loss_gap"] > compare.LIMITS["loss_gap"] or values["aee_gap"] > compare.LIMITS["aee_gap"]
    # and the float64 reference against itself reads 0
    same = compare.numbers([r[0] for r in ref], [r[1] for r in ref], ref)
    assert same["loss_gap"] == 0 and same["aee_gap"] == 0


def _tiny_frame(seed=4):
    config = _tiny_config()
    seq = Sequence({"height": 40, "width": 56, "frame_hz": 20.0, "event_rate": 40000.0, "n_dots": 40,
                    "speeds": [20.0, 15.0, 18.0, 12.0],
                    "angles_deg": [30.0, -100.0, 170.0, 60.0], "turn_period_s": 2.0}, seed, 3)
    batch, _ = plain.window(seq.events, seq.gray_ts[0], seq.gray_ts[1], 1500)
    objective = plain.Objective(config, LIN)
    return objective, objective.prepare(batch), batch


def test_objective_gradient_matches_finite_differences():
    objective, ev, _ = _tiny_frame()
    motion = torch.as_tensor(np.random.default_rng(6).normal(scale=5.0, size=(2, 4, 4))).requires_grad_(True)
    (grad,) = torch.autograd.grad(objective.value(ev, motion), motion)
    h = 1e-6
    for idx in [(0, 1, 2), (1, 3, 0), (0, 0, 0)]:
        plus, minus = motion.detach().clone(), motion.detach().clone()
        plus[idx] += h
        minus[idx] -= h
        fd = (float(objective.value(ev, plus)) - float(objective.value(ev, minus))) / (2 * h)
        assert float(grad[idx]) == pytest.approx(fd, rel=1e-4, abs=1e-9)


def test_descent_gain_is_the_best_steepest_step():
    objective, ev, batch = _tiny_frame()
    motion = torch.as_tensor(np.random.default_rng(7).normal(scale=5.0, size=(2, 4, 4)))
    m = motion.clone().requires_grad_(True)
    f0 = objective.value(ev, m)
    (grad,) = torch.autograd.grad(f0, m)
    f0 = float(f0.detach())
    d = -grad / grad.abs().max()
    best = min(objective(batch, motion + a * d) for a in plain.GAIN_STEPS)
    want = max(f0 - best, 0.0) / abs(f0)
    got = plain.descent_gain(objective, ev, motion)
    assert got == pytest.approx(want, rel=1e-12) and got > 0
    # the same motion after a few plain descent steps gains less
    for _ in range(20):
        m = motion.clone().requires_grad_(True)
        (grad,) = torch.autograd.grad(objective.value(ev, m), m)
        d = -grad / grad.abs().max()
        motion = motion + min(plain.GAIN_STEPS, key=lambda a: objective(batch, motion + a * d)) * d
    assert plain.descent_gain(objective, ev, motion) < got / 10
