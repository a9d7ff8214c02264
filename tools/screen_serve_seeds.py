#!/usr/bin/env python3
"""Which solver seeds' cold draws solve the serving path's first window.

    python3 tools/screen_serve_seeds.py

The serving defaults draw the cold push's coarsest start at random
(``initialize: random``, the solver's ``seed``).  On the serving path of
``chip_smoke.py`` (eval windows of configs/synthetic_mvsec_geometry.yaml's
data block, each uniformly subsampled to 30 000 events by
``fixed_event_count``), this pushes window 0 through a fresh
``StreamingFlowEstimator`` on the card: with seed 0 on the CLI's window of
the same frame (its last 30 000 events, t from 0), on the serving window
with t shifted to 0, and with ``hvp_mode: fd``; then with seeds 1..8, and
for the first two seeds that pass the EPE rule (below 0.5 x the zero-flow
EPE) also the warm pushes of windows 1 and 2.  Prints the EPE, the
zero-flow EPE and the per-scale losses of each push.  Needs a GPU.
"""

import os
import sys
import time

import numpy as np
import yaml

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from event_based_optical_flow_tpu_torch.streaming import StreamingFlowEstimator  # noqa: E402


def main() -> int:
    config = yaml.safe_load(open(cs.CONFIG))
    windows = cs.serve_windows(config, 3)
    dots = dict(config, data=dict(config["data"], pattern="dots"))
    _, cli_events = cs.first_window(dots)
    shape = (config["data"]["height"], config["data"]["width"])

    def run(est, i, events, label):
        _, gt, sec = windows[i]
        t0 = time.perf_counter()
        flow = est.push(events)
        wall = time.perf_counter() - t0
        pred = flow / est.last_span * sec
        m = est.metrics(pred, gt, windows[i][0])["EPE"]
        zero = est.metrics(np.zeros_like(pred), gt, windows[i][0])["EPE"]
        st = est._solver.last_frame_stats
        print(f"[diag] {label} window {i}: {wall:.1f} s EPE {m:.4f} zero {zero:.4f} pass {m < 0.5 * zero} "
              f"loss {({s: round(v, 4) for s, v in st['loss'].items()})} span {est.last_span:.4f}", flush=True)
        return m < 0.5 * zero

    def estimator(**kw):
        return StreamingFlowEstimator(shape, fixed_event_count=cs.SERVE_EVENT_COUNT, **kw)

    run(estimator(), 0, cli_events, "seed 0, the CLI's window (last 30000, t from 0)")
    shifted = windows[0][0].copy()
    shifted[:, 2] -= shifted[:, 2].min()
    run(estimator(), 0, shifted, "seed 0, the serving window with t from 0")
    run(estimator(optimizer_config={"hvp_mode": "fd"}), 0, windows[0][0], "seed 0, hvp fd")
    chained = 0
    for seed in range(1, 9):
        est = estimator(solver_config={"seed": seed})
        if run(est, 0, windows[0][0], f"seed {seed}") and chained < 2:
            chained += 1
            for i in (1, 2):
                run(est, i, windows[i][0], f"seed {seed} warm")
    return 0


if __name__ == "__main__":
    sys.exit(main())
