#!/usr/bin/env python3
"""Where one eval frame of the PyTorch port spends its time on the GPU.

    python3 tools/profile_torch_frame.py [--config configs/synthetic_mvsec_geometry.yaml]
        [--pattern dots] [--max_iter 2]

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
import os
import sys
import time

import torch
import yaml

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from event_based_optical_flow_tpu_torch import main as port_main  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="configs/synthetic_mvsec_geometry.yaml")
    ap.add_argument("--pattern", default="dots")
    ap.add_argument("--max_iter", type=int, default=2)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_frame: needs a CUDA device")
    with open(args.config) as f:
        config = yaml.safe_load(f)
    config["data"]["pattern"] = args.pattern
    config["optimizer"]["max_iter"] = args.max_iter
    port_main.set_numerics()
    loader, solv = port_main.build(config, torch.device("cuda"))
    data_config = config["data"]
    ts = loader.eval_frame_time_list()

    i1, i2 = loader.time_to_index(ts[0]), loader.time_to_index(ts[1])
    events = port_main._optimization_batch(loader, data_config, i1, i2)
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
    print(f"[profile] {torch.cuda.get_device_name(0)}: frame 0, max_iter {args.max_iter}: wall {plain_wall:.3f} s, "
          f"{wall:.3f} s profiled, "
          f"device busy {device_us / 1e6:.3f} s, idle share {1 - device_us / 1e6 / plain_wall:.3f} of the unprofiled wall, "
          f"host syncs {stats['syncs']}, Newton iters {stats['iters']}", flush=True)
    fwd = sum(e.count for e in kernels if "fused_iwe_fwd" in e.key)
    n_kernels = sum(e.count for e in kernels)
    print(f"[profile] {n_kernels} kernels launched, {n_kernels / max(1, fwd):.1f} per fused forward", flush=True)
    for e in kernels:
        if "fused_iwe" in e.key or "from_fixed" in e.key:  # the forward's conversion kernel
            print(f"[profile] {e.key}: {e.count} launches, {e.self_device_time_total / e.count:.2f} us "
                  f"each, {e.self_device_time_total / 1e3:.3f} ms in all", flush=True)
    print(averages.table(sort_by="self_device_time_total", row_limit=args.top, max_name_column_width=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
