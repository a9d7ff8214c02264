#!/usr/bin/env python3
"""Which optimizer the JAX package brings within half the zero-flow EPE
on the MVSEC slice's scene (or the DSEC path's), at a small size on the
CPU.

    JAX_PLATFORMS=cpu python3 tools/screen_host_optimizers.py [--methods BFGS Adam optuna LBFGS] [--scale 0.5] \
        [--set optimizer.lr=5 solver.patch.initialize=zero optimizer.device_solver=lbfgs] [--scene dsec]

``--methods`` takes any ``optimizer.method`` (the host-driven ones,
optax's ``LBFGS``, the device ``Newton-CG``); ``--set
optimizer.device_solver=lbfgs optimizer.max_iter=75`` screens the device
L-BFGS's budget.  The scene is ``chip_smoke.py``'s MVSEC slice
(configs/synthetic_mvsec_geometry.yaml, ``pattern: dots``), or with
``--scene dsec`` its DSEC path (``chip_smoke.dsec_config``: the DSEC
config's blocks at 480x640, 300 000-event windows), frame 0, with its
height and width scaled by
``--scale`` (the crop to multiples of 16, the event rate and the window's
event count by the pixel ratio: the same events per pixel).  For each
method the JAX package's CLI eval loop (``main.evaluate_dataset_with_gt``)
solves the frame with the config's solver and optimizer blocks and that
``optimizer.method`` (the device Newton-CG as the baseline) and the
``--set`` overrides (YAML values), on its exact
scatter backend, float64; the script prints the EPE, the zero flow's EPE
on the same window and their ratio, and the seconds.  ``chip_smoke.py``
gates on the card the method whose ratio here is below 0.5.
``--port-seeds`` also solves the frame with the port on the CPU (the
device Newton-CG, float64), with the config's init-sweep draws and with
each seed's (the cold start stays the config's): the spread that
``chip_smoke.py``'s ``[pad-random-witness]`` band is set from.
"""

import argparse
import copy
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import chip_smoke as cs  # noqa: E402
import main as jax_cli  # noqa: E402
from event_based_optical_flow_tpu import data as jdata  # noqa: E402
from event_based_optical_flow_tpu import solver as jsolver  # noqa: E402
from event_based_optical_flow_tpu import visualizer  # noqa: E402


def zero_flow_epe(config: dict) -> float:
    """The zero flow's EPE on frame 0's window (``chip_smoke.zero_flow_epe``
    on the port's loader, byte-equal to the JAX package's)."""
    from event_based_optical_flow_tpu_torch import main as port_main

    loader, solv = port_main.build(config, "cpu")
    return cs.zero_flow_epe(loader, config["data"], 0, solv)


def run(config: dict) -> dict:
    d, out_dir = config["data"], config["output"]["output_dir"]
    os.makedirs(out_dir, exist_ok=True)
    loader = jdata.collections[d["dataset"]](config=d)
    loader.set_sequence(d["sequence"])
    viz = visualizer.Visualizer((d["height"], d["width"]), save=True, save_dir=out_dir)
    solv = jsolver.collections[config["solver"]["method"]](
        (d["height"], d["width"]), calibration_parameter=loader.load_calib(), solver_config=config["solver"],
        optimizer_config=config["optimizer"], output_config=config["output"], visualize_module=viz)
    jax_cli.evaluate_dataset_with_gt(loader.eval_frame_time_list(), d, loader, solv)
    with open(os.path.join(out_dir, "eval_metrics.jsonl")) as f:
        return json.loads(f.readline())


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--methods", nargs="+", default=["Newton-CG", "BFGS", "Adam", "optuna"])
    parser.add_argument("--scale", type=float, default=0.5)
    parser.add_argument("--set", nargs="*", default=[], metavar="SECTION.KEY=VALUE",
                        help="config overrides, e.g. optimizer.lr=5")
    parser.add_argument("--scene", choices=("mvsec", "dsec"), default="mvsec")
    parser.add_argument("--port-seeds", nargs="*", type=int, default=None, metavar="SEED",
                        help="also solve the frame with the port on the CPU (float64), with the config's init-sweep "
                             "draws and with each SEED's")
    args = parser.parse_args(argv)
    root = tempfile.mkdtemp(prefix="screen_host_optimizers_")
    zero = None
    for method in args.methods:
        config = cs.scaled_config(args.scale, method, os.path.join(root, method), args.set, args.scene)
        zero = zero if zero is not None else zero_flow_epe(copy.deepcopy(config))
        t0 = time.perf_counter()
        m = run(config)
        d = config["data"]
        print(f"{method}: {d['height']}x{d['width']}, {d['n_events_per_batch']} events, frame 0: EPE {m['EPE']!r}, "
              f"zero flow {zero:.4f}, ratio {m['EPE'] / zero:.3f} ({'within' if m['EPE'] < 0.5 * zero else 'not within'} "
              f"0.5), {time.perf_counter() - t0:.1f} s (JAX package, CPU, float64, scatter backend"
              + (f", {' '.join(args.set)}" if args.set else "") + ")", flush=True)
    for seed in [] if args.port_seeds is None else [None] + args.port_seeds:
        config = cs.scaled_config(args.scale, "Newton-CG", os.path.join(root, f"port-{seed}"), args.set, args.scene)
        t0 = time.perf_counter()
        m, zero_port, _ = cs.frame0_solve(config, "cpu", seed)
        print(f"port, Newton-CG, sweep draws {'of the config' if seed is None else f'of seed {seed}'}: EPE "
              f"{m['EPE']!r}, zero flow {zero_port:.4f}, {time.perf_counter() - t0:.1f} s (CPU, float64"
              + (f", {' '.join(args.set)}" if args.set else "") + ")", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
