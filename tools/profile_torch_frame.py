#!/usr/bin/env python3
"""Where one eval frame of the PyTorch port spends its time on the GPU.

    python3 tools/profile_torch_frame.py [--config configs/synthetic_mvsec_geometry.yaml]
        [--pattern dots] [--max_iter 2] [--hvp_mode MODE] [--dsec | --time-aware] [--fleet]
        [--chain both|on|off]
    python3 tools/profile_torch_frame.py --multistream 2
    python3 tools/profile_torch_frame.py --dnn [--config configs/synthetic_dnn.yaml] [--steps 10]

``--chain`` (default ``both``) profiles the sequential frame (with
``--fleet`` the batch and the frame beside it) chained
(``optimizer.chain: true``: the Newton evaluations replayed from CUDA
graphs, captured in the warm-up solve) and then with the loop (``chain:
false``; the fleet's loop draws differently), or one of the two.

``--dsec`` profiles the analytic HVP path instead: the solver and optimizer
blocks of configs/dsec_zurich_city.yaml on the synthetic loader at DSEC
geometry (``chip_smoke.DSEC_DATA``: 480x640, 300 000-event windows).
``--time-aware`` profiles the time-aware path (``chip_smoke.ta_config``:
configs/mvsec_indoor_burgers.yaml's solver and optimizer blocks on the
synthetic MVSEC-geometry loader), then the same frame with
``time_aware: false``, and prints the difference per fused forward: the
voxel chain's (and its backward's) share of the kernels and of the device
time.  ``--fleet`` profiles one lockstep batch of ``chip_smoke.FLEET_BATCH``
frames (the config's blocks, or the time-aware ones with ``--time-aware``,
solved by the fleet solver, frames 0..3 as one batch) and then frame 0 of
the same windows through the sequential pyramid, and prints what the
batch amortizes: seconds, host syncs, kernels and device time per frame
and per objective evaluation.  ``--hvp_mode`` sets ``optimizer.hvp_mode``
(``analytic``: the tangent and HVP-backward kernels on the finest scale).
``--multistream K`` times the serving surface instead (no profiler, the
serving defaults and full Newton budget): a dense ``MultiStreamFlowEstimator``
of K streams (windows of the config's data block, 30 000 events each),
a cold and a warm push, in ``fleet`` and in ``sequential`` mode, in turns
(fleet, sequential, sequential, fleet), each push ending in a synchronize.
``--dnn`` profiles ``--steps`` EV-FlowNet train steps of an ``is_dnn``
config (default configs/synthetic_dnn.yaml) on its first batch
(``chip_smoke.dnn_batch``), each step ending in its loss's read as in
``run_dnn_flow``: wall per step, device busy and idle share, kernels per
step, and the device time under the step's parts (the convolutions
forward and backward, K8's launches, the vote's backward, Adam).

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

import numpy as np
import torch
import yaml

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from event_based_optical_flow_tpu_torch import main as port_main  # noqa: E402

# the device kernels of PyTorch's sort-based deterministic index_put /
# index_add (accumulate=True)
SCATTER_KERNELS = ("indexing_backward", "RadixSort", "index_put", "index_add", "scatter")


def profile_solve(solve, stats_of, label: str, what: str, top: int, n_frames: int = 1) -> dict:
    """Run ``solve`` once as a warm-up (kernel build, allocator), once timed
    alone and once under the profiler; print and return its numbers, per
    frame of the ``n_frames`` it solves."""
    solve()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    # kernels only: a CPU op's device time repeats the kernels it launched
    kernels = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in kernels)
    stats = stats_of()
    idle = 1 - device_us / 1e6 / plain_wall
    print(f"[profile] {label}, {torch.cuda.get_device_name(0)}: {what}: wall {plain_wall:.3f} s "
          f"({plain_wall / n_frames:.3f} s per frame), {wall:.3f} s profiled, device busy {device_us / 1e6:.3f} s, "
          f"idle share {idle:.3f} of the unprofiled wall, host syncs {stats['syncs']} "
          f"({stats['syncs'] / n_frames:.1f} per frame), Newton iters {stats['iters']}, HVP {stats['hvp']}",
          flush=True)
    # one fused forward per objective evaluation (all frames of a batch in one)
    fwd = sum(e.count for e in kernels if "fused_iwe_fwd" in e.key)
    n_kernels = sum(e.count for e in kernels)
    print(f"[profile] {label}: {n_kernels} kernels launched ({n_kernels / n_frames:.0f} per frame), {fwd} fused "
          f"forwards, {n_kernels / max(1, fwd):.1f} kernels and {device_us / max(1, fwd):.1f} us of device time "
          "per fused forward (one objective evaluation)", flush=True)
    for e in kernels:
        # the kernels of csrc/fused_iwe.cu and csrc/vote.cu (bilinear_vote_kernel and, for the sweep's
        # patches, bilinear_vote_shared_kernel), conversion and bound passes included
        if any(k in e.key for k in ("fused_iwe", "bilinear_vote", "from_fixed", "from_scaled", "jvp_bound")):
            print(f"[profile] {label}: {e.key}: {e.count} launches, {e.self_device_time_total / e.count:.2f} us "
                  f"each, {e.self_device_time_total / 1e3:.3f} ms in all", flush=True)
    # PyTorch's deterministic scatter adds (index_add / index_put with
    # accumulate: a radix sort of the indices, then ordered sums)
    scatter = [e for e in kernels if any(k in e.key for k in SCATTER_KERNELS)]
    scatter_us = sum(e.self_device_time_total for e in scatter)
    print(f"[profile] {label}: deterministic scatter adds ({', '.join(SCATTER_KERNELS)}): "
          f"{sum(e.count for e in scatter)} kernels, {scatter_us / 1e3:.3f} ms, "
          f"{scatter_us / max(1.0, device_us):.3f} of the device time", flush=True)
    print(averages.table(sort_by="self_device_time_total", row_limit=top, max_name_column_width=60))
    return {"kernels_per_fwd": n_kernels / max(1, fwd), "device_us_per_fwd": device_us / max(1, fwd),
            "s_per_frame": plain_wall / n_frames, "syncs_per_frame": stats["syncs"] / n_frames, "idle": idle}


def profile_frame(config: dict, label: str, top: int) -> dict:
    """Profile frame 0 of ``config`` through the sequential solver."""
    loader, solv = port_main.build(config, torch.device("cuda"))
    ts = loader.eval_frame_time_list()
    i1, i2 = loader.time_to_index(ts[0]), loader.time_to_index(ts[1])
    events = port_main._optimization_batch(loader, config["data"], i1, i2)
    return profile_solve(lambda: solv.optimize(events), lambda: solv.last_frame_stats, label,
                         f"frame 0, max_iter {config['optimizer']['max_iter']}", top)


def profile_fleet(config: dict, top: int) -> None:
    """Profile frames 0..3 as one lockstep batch, then frame 0 of the same
    windows through the sequential pyramid; print the batch's amortization."""
    from chip_smoke import FLEET_BATCH, fleet_config, fleet_windows

    fleet = fleet_config(config, FLEET_BATCH)
    fleet["optimizer"]["hvp_mode"] = config["optimizer"].get("hvp_mode", "fd")  # one HVP mode, both sides
    windows = fleet_windows(fleet, FLEET_BATCH)
    _, solv = port_main.build(fleet, torch.device("cuda"))
    what = f"frames 0..{FLEET_BATCH - 1} as one batch, max_iter {config['optimizer']['max_iter']}"
    got = profile_solve(lambda: solv.optimize_batch(windows), lambda: solv.last_batch_stats, "fleet", what, top,
                        FLEET_BATCH)
    sequential = copy.deepcopy(config)
    sequential["solver"]["seed"] = fleet["solver"]["seed"]  # frame 0's cold start is the batch's
    _, seq = port_main.build(sequential, torch.device("cuda"))
    alone = profile_solve(lambda: seq.optimize(windows[0]), lambda: seq.last_frame_stats, "sequential",
                          f"frame 0 of the same windows, max_iter {config['optimizer']['max_iter']}", top)
    print(f"[profile] fleet of {FLEET_BATCH} vs sequential frame 0: {got['s_per_frame']:.3f} vs "
          f"{alone['s_per_frame']:.3f} s per frame, {got['syncs_per_frame']:.1f} vs {alone['syncs_per_frame']:.1f} "
          f"host syncs per frame, {got['kernels_per_fwd']:.1f} vs {alone['kernels_per_fwd']:.1f} kernels and "
          f"{got['device_us_per_fwd']:.1f} vs {alone['device_us_per_fwd']:.1f} us of device time per objective "
          f"evaluation, idle share {got['idle']:.3f} vs {alone['idle']:.3f}", flush=True)


def time_multistream(config: dict, n_streams: int) -> None:
    """A cold and a warm push of ``n_streams`` dense streams through
    ``MultiStreamFlowEstimator`` in fleet and in sequential mode, in turns;
    seconds per push, host syncs and kernel launches."""
    from chip_smoke import SERVE_EVENT_COUNT, serve_windows
    from event_based_optical_flow_tpu_torch import ops
    from event_based_optical_flow_tpu_torch.streaming import MultiStreamFlowEstimator

    h, w = config["data"]["height"], config["data"]["width"]
    windows = serve_windows(config, 2 * n_streams)
    pushes = [[windows[2 * k + step][0] for k in range(n_streams)] for step in range(2)]  # stream k: 2k, 2k+1
    for batching in ("fleet", "sequential", "sequential", "fleet"):
        est = MultiStreamFlowEstimator((h, w), n_streams, fixed_event_count=SERVE_EVENT_COUNT, batching=batching)
        for step, name in enumerate(("cold", "warm")):
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            flows = est.push(pushes[step])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            solver = est._solver
            if batching == "fleet":
                stats = solver.last_batch_stats
                syncs, hvp = stats["syncs"], stats["hvp"]
            else:
                syncs, hvp = "last stream's " + str(solver.last_frame_stats["syncs"]), solver.last_frame_stats["hvp"]
            launches = {k: v for k, v in ops.launch_counts().items() if v}
            print(f"[multistream] {torch.cuda.get_device_name(0)}: K={n_streams} {batching} {name} push: {wall:.3f} s "
                  f"({wall / n_streams:.3f} s per stream), flows {list(flows.shape)} finite "
                  f"{bool(np.isfinite(flows).all())}, host syncs {syncs}, HVP {hvp}, launches {launches}", flush=True)


def profile_dnn(config: dict, top: int, n_steps: int) -> None:
    """``n_steps`` train steps of an ``is_dnn`` config on its first batch
    (warm-up, timed alone, profiled); per step: wall, device busy time,
    idle share, kernels, and the device time under each part of the step."""
    from event_based_optical_flow_tpu_torch.data import collections
    from event_based_optical_flow_tpu_torch.models import train

    dev = torch.device("cuda")
    data_cfg, d = config["data"], config["dnn"]
    loader = collections[data_cfg["dataset"]](config=data_cfg)
    loader.set_sequence(data_cfg["sequence"])
    size = train.crop_size(data_cfg)
    ev, wt, _ = train.draw_batch(loader, np.random.default_rng(0), size, data_cfg["n_events_per_batch"],
                                 int(d["batch_size"]))
    ev, wt = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (ev, wt))
    model, opt = train.make_dnn_train_state(size, d["n_bin"], lr=float(d.get("lr", 1e-4)), device=dev,
                                            scale_time=train.default_scale_time(d, size))
    step, _ = train.dnn_train_step(model, opt, size, d["n_bin"], multi_scale=bool(d.get("multi_scale")))

    def run():
        for _ in range(n_steps):
            float(step(ev, wt))

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    plain = (time.perf_counter() - t0) / n_steps
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        run()
    averages = prof.key_averages()
    kernels = [e for e in averages if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / n_steps
    n = sum(e.count for e in kernels) / n_steps
    print(f"[profile] dnn {size[0]}x{size[1]}, batch {list(ev.shape)}, {torch.cuda.get_device_name(0)}: "
          f"{plain:.4f} s per step unprofiled, device busy {busy / 1e3:.3f} ms per step, idle share "
          f"{1 - busy / 1e6 / plain:.3f}, {n:.0f} kernels per step", flush=True)
    # the step's parts: device time of the kernels each top-level op launched
    parts = {"convolutions forward": "aten::conv2d",
             "convolutions backward": "autograd::engine::evaluate_function: ConvolutionBackward0",
             "K8 forward (the voxel and the loss votes)": "K8",
             "the vote's backward (a gather)": "autograd::engine::evaluate_function: BilinearVoteBackward",
             "Adam": "Optimizer.step#Adam.step"}
    for what, key in parts.items():
        if key == "K8":
            us = sum(e.self_device_time_total for e in kernels if "bilinear_vote" in e.key or "from_fixed" in e.key)
        else:
            us = sum(e.device_time_total for e in averages if e.key == key)
        print(f"[profile] dnn: {what}: {us / n_steps / 1e3:.3f} ms per step, {us / n_steps / max(1.0, busy):.3f} "
              "of the device time", flush=True)
    print(averages.table(sort_by="self_device_time_total", row_limit=top, max_name_column_width=60))
    # a host-bound step: where the host's time goes
    print(averages.table(sort_by="self_cpu_time_total", row_limit=top, max_name_column_width=60))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="configs/synthetic_mvsec_geometry.yaml")
    ap.add_argument("--pattern", default="dots")
    ap.add_argument("--max_iter", type=int, default=2)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--hvp_mode", default=None, help="optimizer.hvp_mode (default: the config's)")
    path = ap.add_mutually_exclusive_group()
    path.add_argument("--dsec", action="store_true", help="the DSEC config's solver on DSEC geometry")
    path.add_argument("--time-aware", action="store_true",
                      help="the Burgers config's time-aware solver on MVSEC geometry, then its dense twin")
    ap.add_argument("--fleet", action="store_true",
                    help="one lockstep batch of frames 0..3, then frame 0 alone through the sequential solver")
    ap.add_argument("--chain", choices=("both", "on", "off"), default="both",
                    help="the sequential frame (and the fleet) chained, with the loop, or both in turn")
    ap.add_argument("--multistream", type=int, default=0, metavar="K",
                    help="time a cold and a warm push of K dense streams, fleet vs sequential (no profiler)")
    ap.add_argument("--dnn", action="store_true", help="EV-FlowNet train steps of an is_dnn config")
    ap.add_argument("--steps", type=int, default=10, help="--dnn: train steps per run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_frame: needs a CUDA device")
    if args.dnn:
        config_file = "configs/synthetic_dnn.yaml" if args.config == ap.get_default("config") else args.config
        with open(config_file) as f:
            config = yaml.safe_load(f)
        port_main.set_numerics()
        profile_dnn(config, args.top, args.steps)
        return 0
    if args.multistream:
        with open(args.config) as f:
            time_multistream(yaml.safe_load(f), args.multistream)
        return 0
    if args.dsec or args.time_aware:
        from chip_smoke import dsec_config, ta_config

        config = dsec_config() if args.dsec else ta_config()
    else:
        with open(args.config) as f:
            config = yaml.safe_load(f)
    config["data"]["pattern"] = args.pattern
    config["optimizer"]["max_iter"] = args.max_iter
    if args.hvp_mode:
        config["optimizer"]["hvp_mode"] = args.hvp_mode
    port_main.set_numerics()
    for chain in {"both": (True, False), "on": (True,), "off": (False,)}[args.chain]:
        config["optimizer"]["chain"] = chain
        mode = "chained" if chain else "loop"
        if args.fleet:
            print(f"[profile] fleet and sequential frame, {mode}", flush=True)
            profile_fleet(config, args.top)
            continue
        label = "time-aware" if args.time_aware else ("dsec" if args.dsec else "dense")
        got = profile_frame(config, f"{label}, {mode}", args.top)
        if args.time_aware:
            twin = copy.deepcopy(config)
            twin["solver"]["time_aware"] = False
            dense = profile_frame(twin, f"dense twin, {mode}", args.top)
            k, d = got["kernels_per_fwd"], got["device_us_per_fwd"]
            print(f"[profile] {mode}: the voxel chain and its backward, per fused forward (time-aware minus its "
                  f"dense twin): {k - dense['kernels_per_fwd']:.1f} of {k:.1f} kernels "
                  f"({(k - dense['kernels_per_fwd']) / k:.3f}), {d - dense['device_us_per_fwd']:.1f} of {d:.1f} us "
                  f"of device time ({(d - dense['device_us_per_fwd']) / d:.3f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
