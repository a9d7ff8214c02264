#!/usr/bin/env python3
"""Whether a serving seed's cold draw lands in the same coarsest basin in
the JAX package as in the PyTorch port.

    JAX_PLATFORMS=cpu python3 tools/serve_seed_basin.py [--seeds 0 1]

For each seed, window 0 of ``chip_smoke.py``'s serving path (eval window 0
of configs/synthetic_mvsec_geometry.yaml's data block, ``pattern: dots``,
uniformly subsampled to 30 000 events by ``fixed_event_count``) goes into a
fresh ``StreamingFlowEstimator`` of each package on the CPU, with the
serving defaults and that solver seed: the JAX package's per-scale loop
(``optimizer.chain: false``) through its Pallas kernels in interpret mode
(``iwe_backend: pallas``, the banded objective its TPU path runs) in
float32, and the port through its plain versions in float32 (the card's
type) and float64.  Both packages draw the coarsest start from
``numpy.random.default_rng(seed)``, so all three start from the same draw.
Each push stops after the coarsest scale's Newton-CG, which has no init
sweep; the script prints that solve's loss, the mean coarsest motion
(px/s) and the largest difference from the JAX package's coarsest
motion.  Only the coarsest scale runs: it is the scale whose basin the
draw picks.  The JAX solve takes ~20 min of CPU time per seed.
"""

import argparse
import os
import sys
import time

import numpy as np
import yaml

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from event_based_optical_flow_tpu import streaming as JS  # noqa: E402
from event_based_optical_flow_tpu_torch import streaming as TS  # noqa: E402


class Coarsest(Exception):
    """Raised after the coarsest scale's solve, carrying its result."""


def jax_coarsest(shape, events, seed):
    est = JS.StreamingFlowEstimator(shape, solver_config={"seed": seed, "iwe_backend": "pallas"},
                                    optimizer_config={"chain": False}, fixed_event_count=cs.SERVE_EVENT_COUNT)
    solver, seen = est._solver, []
    history_cb, run = solver._history_cb, solver._run_newton_device
    solver._history_cb = lambda f, g: (seen.append(f), history_cb(f, g))

    def stop(*a, **k):
        raise Coarsest(run(*a, **k), seen[-1])

    solver._run_newton_device = stop
    return _push(est, events)


def port_coarsest(shape, events, seed, precision):
    est = TS.StreamingFlowEstimator(shape, solver_config={"seed": seed, "precision": precision},
                                    fixed_event_count=cs.SERVE_EVENT_COUNT, device="cpu")
    run = est._solver._run_newton

    def stop(*a, **k):
        best_x, best_f, _, _ = run(*a, **k)
        raise Coarsest(best_x.double().numpy(), float(best_f))

    est._solver._run_newton = stop
    return _push(est, events)


def _push(est, events):
    t0 = time.perf_counter()
    try:
        est.push(events)
    except Coarsest as done:
        x, f = done.args
        return np.asarray(x, dtype=np.float64).reshape(2, -1), f, time.perf_counter() - t0
    raise RuntimeError("the push ended without a coarsest Newton-CG solve")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    args = ap.parse_args()
    with open(cs.CONFIG) as f:
        config = yaml.safe_load(f)
    shape = (config["data"]["height"], config["data"]["width"])
    events = cs.serve_windows(config, 1)[0][0]
    for seed in args.seeds:
        xj, fj, sj = jax_coarsest(shape, events, seed)
        print(f"[basin] seed {seed}, JAX float32 (Pallas, interpret): {xj.shape[1]} coarsest patches, loss "
              f"{fj:.6f}, mean motion {np.round(xj.mean(1), 3).tolist()} px/s ({sj:.1f} s)", flush=True)
        for precision in ("32", "64"):
            xt, ft, st = port_coarsest(shape, events, seed, precision)
            print(f"[basin] seed {seed}, port float{precision} (plain): loss {ft:.6f}, mean motion "
                  f"{np.round(xt.mean(1), 3).tolist()} px/s, max |port - JAX| {np.abs(xt - xj).max():.4g} px/s "
                  f"({st:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
