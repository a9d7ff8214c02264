#!/usr/bin/env python3
"""Where one eval frame of the PyTorch port spends its time on the GPU.

    python3 tools/profile_torch_frame.py [--config configs/synthetic_mvsec_geometry.yaml]
        [--pattern dots] [--max_iter 2] [--dsec | --time-aware]

``--dsec`` profiles the analytic HVP path instead: the solver and optimizer
blocks of configs/dsec_zurich_city.yaml on the synthetic loader at DSEC
geometry (``chip_smoke.DSEC_DATA``: 480x640, 300 000-event windows).
``--time-aware`` profiles the time-aware path (``chip_smoke.ta_config``:
configs/mvsec_indoor_burgers.yaml's solver and optimizer blocks on the
synthetic MVSEC-geometry loader), then the same frame with
``time_aware: false``, and prints the difference per fused forward: the
voxel chain's (and its backward's) share of the kernels and of the device
time.

Solves frame 0 once as a warm-up (kernel build, allocator), once timed
alone, and once under ``torch.profiler`` (CPU + CUDA activities), all
with the Newton budget cut to ``--max_iter`` iterations per scale so that
the trace stays short (the per-iteration mix of work is the full
budget's).  Prints the solve's wall seconds without and with the
profiler, the summed device time of all kernels, the device's idle share
(1 - busy / unprofiled wall), the host syncs and Newton iterations per
scale, and the top device kernels by total time.  Needs a GPU.
"""

import argparse
import copy
import os
import sys
import time

import torch
import yaml

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from event_based_optical_flow_tpu_torch import main as port_main  # noqa: E402


def profile_frame(config: dict, label: str, top: int) -> dict:
    """Profile frame 0 of ``config``; print and return its numbers."""
    loader, solv = port_main.build(config, torch.device("cuda"))
    ts = loader.eval_frame_time_list()
    i1, i2 = loader.time_to_index(ts[0]), loader.time_to_index(ts[1])
    events = port_main._optimization_batch(loader, config["data"], i1, i2)
    solv.optimize(events)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solv.optimize(events)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        solv.optimize(events)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    # kernels only: a CPU op's device time repeats the kernels it launched
    kernels = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    stats = solv.last_frame_stats
    max_iter = config["optimizer"]["max_iter"]
    print(f"[profile] {label}, {torch.cuda.get_device_name(0)}: frame 0, max_iter {max_iter}: "
          f"wall {plain_wall:.3f} s, {wall:.3f} s profiled, device busy {device_us / 1e6:.3f} s, "
          f"idle share {1 - device_us / 1e6 / plain_wall:.3f} of the unprofiled wall, "
          f"host syncs {stats['syncs']}, Newton iters {stats['iters']}, HVP {stats['hvp']}", flush=True)
    fwd = sum(e.count for e in kernels if "fused_iwe_fwd" in e.key)
    n_kernels = sum(e.count for e in kernels)
    print(f"[profile] {label}: {n_kernels} kernels launched, {fwd} fused forwards, "
          f"{n_kernels / max(1, fwd):.1f} kernels and {device_us / max(1, fwd):.1f} us of device time "
          "per fused forward", flush=True)
    for e in kernels:
        # the kernels of csrc/fused_iwe.cu, conversion and bound passes included
        if any(k in e.key for k in ("fused_iwe", "from_fixed", "from_scaled", "jvp_bound")):
            print(f"[profile] {label}: {e.key}: {e.count} launches, {e.self_device_time_total / e.count:.2f} us "
                  f"each, {e.self_device_time_total / 1e3:.3f} ms in all", flush=True)
    print(averages.table(sort_by="self_device_time_total", row_limit=top, max_name_column_width=60))
    return {"kernels_per_fwd": n_kernels / max(1, fwd), "device_us_per_fwd": device_us / max(1, fwd)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="configs/synthetic_mvsec_geometry.yaml")
    ap.add_argument("--pattern", default="dots")
    ap.add_argument("--max_iter", type=int, default=2)
    ap.add_argument("--top", type=int, default=15)
    path = ap.add_mutually_exclusive_group()
    path.add_argument("--dsec", action="store_true", help="the DSEC config's solver on DSEC geometry")
    path.add_argument("--time-aware", action="store_true",
                      help="the Burgers config's time-aware solver on MVSEC geometry, then its dense twin")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_frame: needs a CUDA device")
    if args.dsec or args.time_aware:
        from chip_smoke import dsec_config, ta_config

        config = dsec_config() if args.dsec else ta_config()
    else:
        with open(args.config) as f:
            config = yaml.safe_load(f)
    config["data"]["pattern"] = args.pattern
    config["optimizer"]["max_iter"] = args.max_iter
    port_main.set_numerics()
    label = "time-aware" if args.time_aware else ("dsec" if args.dsec else "dense")
    got = profile_frame(config, label, args.top)
    if args.time_aware:
        twin = copy.deepcopy(config)
        twin["solver"]["time_aware"] = False
        dense = profile_frame(twin, "dense twin", args.top)
        k, d = got["kernels_per_fwd"], got["device_us_per_fwd"]
        print(f"[profile] the voxel chain and its backward, per fused forward (time-aware minus its dense "
              f"twin): {k - dense['kernels_per_fwd']:.1f} of {k:.1f} kernels "
              f"({(k - dense['kernels_per_fwd']) / k:.3f}), {d - dense['device_us_per_fwd']:.1f} of {d:.1f} us "
              f"of device time ({(d - dense['device_us_per_fwd']) / d:.3f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
