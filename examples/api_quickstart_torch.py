#!/usr/bin/env python3
"""Library-API quickstart of the PyTorch port: estimate dense flow from a
raw event array.

The port's twin of ``examples/api_quickstart.py``: the same synthetic
translating-dots window, solved by the port's ``StreamingFlowEstimator``
(one stream, warm-started window to window) or, with ``--multistream K``,
by its ``MultiStreamFlowEstimator`` (K independent streams as one fleet
batch).  The solve runs on the GPU (``--device cuda``, the hand-written
CUDA kernels) unless ``--device cpu`` asks for their plain PyTorch
versions.  No dataset needed:

    python examples/api_quickstart_torch.py [--device cpu] [--windows N] [--multistream K]

Each window prints one line: its mean flow in pixels beside the scene's.
"""

import argparse
import os
import sys
import tempfile

# allow running straight from a checkout (sys.path[0] is examples/)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def synthetic_window(h, w, n=20000, seed=0, flow_px=(6.0, -4.0)):
    """Translating random-dot scene: a few hundred persistent dots, each
    emitting many events along its trajectory (contrast maximization
    sharpens the image of warped events, so it needs repeated events per
    moving feature).  Events are integer-pixel like a real sensor."""
    rng = np.random.default_rng(seed)
    n_dots = max(24, (h * w) // 24)
    dots_x = rng.uniform(2, h - 2, n_dots)
    dots_y = rng.uniform(2, w - 2, n_dots)
    idx = rng.integers(0, n_dots, n)
    t = np.sort(rng.uniform(0.0, 1.0, n))
    x = dots_x[idx] + rng.normal(0, 0.2, n) + flow_px[0] * t
    y = dots_y[idx] + rng.normal(0, 0.2, n) + flow_px[1] * t
    ok = (x >= 0) & (x < h - 1) & (y >= 0) & (y < w - 1)
    p = rng.integers(0, 2, n).astype(np.float64)
    return np.stack([np.round(x), np.round(y), t, p], axis=1)[ok]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="where the solve runs: cuda (default) or cpu")
    ap.add_argument("--windows", type=int, default=3)
    ap.add_argument("--multistream", type=int, default=0, metavar="K",
                    help="serve K independent streams as one fleet batch (per-stream warm starts) "
                         "instead of one stream")
    args = ap.parse_args()

    H, W = 68, 84
    slv = {"patch": {"scale": 3, "crop_height": 64, "crop_width": 80}}
    opt = {
        "n_iter": 24, "max_iter": 15,
        "parameters": {"trans_x": {"min": -20, "max": 20}, "trans_y": {"min": -20, "max": 20}},
    }

    if args.multistream:
        from event_based_optical_flow_tpu_torch.streaming import MultiStreamFlowEstimator

        k = args.multistream
        est = MultiStreamFlowEstimator((H, W), k, solver_config=slv, optimizer_config=opt,
                                       fixed_event_count=16384, device=args.device)
        gts = [(6.0 - 2 * s, -4.0 + 2 * s) for s in range(k)]
        for i in range(args.windows):
            windows = [synthetic_window(H, W, seed=100 * s + i, flow_px=gts[s]) for s in range(k)]
            flows = est.push(windows)  # [K, 2, H, W]
            for s in range(k):
                u, v = float(flows[s, 0].mean()), float(flows[s, 1].mean())
                print(f"window {i} stream {s}: mean flow ({u:+.1f}, {v:+.1f}) px  "
                      f"vs GT ({gts[s][0]:+.1f}, {gts[s][1]:+.1f})")
        # a serving restart resumes from this file (the JAX layout)
        est.save_state(os.path.join(tempfile.mkdtemp(prefix="evflow_quickstart_"), "multistream_state.npz"))
        return

    from event_based_optical_flow_tpu_torch.streaming import StreamingFlowEstimator

    est = StreamingFlowEstimator(image_shape=(H, W), solver_config=slv, optimizer_config=opt, device=args.device)
    gt = (6.0, -4.0)
    for i in range(args.windows):
        window = synthetic_window(H, W, seed=i, flow_px=gt)
        flow = est.push(window)  # [2, H, W] px displacement over the window
        u, v = float(flow[0].mean()), float(flow[1].mean())
        print(f"window {i}: mean flow ({u:+.1f}, {v:+.1f}) px  vs GT ({gt[0]:+.1f}, {gt[1]:+.1f})")


if __name__ == "__main__":
    main()
