#!/usr/bin/env python3
"""Time the fused forward and backward kernels of the PyTorch port against
a parent commit's, in turns, on one GPU.

    mkdir -p build/parent
    git show <parent>:event_based_optical_flow_tpu_torch/csrc/fused_iwe.cu > build/parent/fused_iwe.cu
    git show <parent>:event_based_optical_flow_tpu_torch/csrc/fixed_point.cuh > build/parent/fixed_point.cuh
    python3 tools/time_fused_iwe.py [--parent build/parent] [--iters 200] [--rows 3 4 9 10]

The parent's source is read from an untracked copy (``build/`` is
ignored, and a copy of the repository without git history can still run
it); its C interface is the one before the backward ran in one pass: the
backward writes per-event terms to a scratch and sums them in a second
kernel (the forward's interface is the port's).  The parent's wrapper is
mimicked as it was (``torch.zeros`` scratch, a ctypes offsets array per
call).  A parent
directory that does not exist times the port's kernels alone.

Rows are those of ``PERF.md`` section 6, at the paths' shapes from
``chip_smoke.py``'s data, float32: 3/4 K1/K2 on the MVSEC slice's first
window (30 000 events, 260x346), 5/6 K5 (10 time bins), 7/8 the batched
voxel pair (the time-aware fleet's batch of 2), 9/10 the batched dense
pair (the fleet's batch of 4), and the HVP backward without term A (K4,
which shares the backward): 12 on the DSEC path's first window (300 000
events, 480x640), 14 batched, 16 voxel, 18 batched voxel.  Offsets (0, 1,
0.5), no orig image.  Rows 31 and 41 are K1 and K2 on the DSEC path's
first window (rows 3 and 4 of ``PERF.md`` at the DSEC shape); rows 32
and 42 K1 and K2 at row 3's shape with the flow scaled by 10 (vote rows up
to ~40 rows from their events', as in the solve's coarse scales).  Each
row runs the variants in turns (parent, port, port, parent).  For each
turn: the wrapper's milliseconds per call (CUDA events around
``--iters`` calls after 10 warm-up calls: the host's enqueue included),
the device microseconds per call and device operations per call
(``torch.profiler``: every kernel and memset over 50 calls), the kernels
by name, and the microseconds per call of 20 calls captured in one CUDA
graph and replayed (the device's time with its launch gaps, without the
host's enqueue).  Every variant's output must equal the port's bit for
bit.  Also prints the card's name and power limit, and writes all numbers
to ``--out`` as JSON.  Needs a GPU.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import yaml

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from event_based_optical_flow_tpu_torch.ops import cuda_build  # noqa: E402
from event_based_optical_flow_tpu_torch.ops import fused_iwe as FI  # noqa: E402
from event_based_optical_flow_tpu_torch.solver.objective import FleetEvents, FrameEvents  # noqa: E402

OFFSETS = cs.OFFSETS
ROWS = {3: ("fwd", "dense"), 4: ("bwd", "dense"), 5: ("fwd", "voxel"), 6: ("bwd", "voxel"),
        7: ("fwd", "batched_voxel"), 8: ("bwd", "batched_voxel"), 9: ("fwd", "batched"), 10: ("bwd", "batched"),
        12: ("hvp_bwd", "dsec"), 14: ("hvp_bwd", "batched"), 16: ("hvp_bwd", "voxel"),
        18: ("hvp_bwd", "batched_voxel"), 31: ("fwd", "dsec"), 41: ("bwd", "dsec"), 32: ("fwd", "dense_far"),
        42: ("bwd", "dense_far")}
# the parent's C interface: x, y, dtf, wt, bins, n_bins, frame_ptr, n_frames, n, then each kernel's own
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_EV = [_P] * 5 + [_I, _P, _I, _I]
PARENT_ARGS = {"fwd": _EV + [_P, _P, _I, _I, _I, _I, _D, _P, _P, _P],
               "bwd": _EV + [_P, _P, _I, _I, _I, _I, _D, _P, _P, _P, _P],
               "hvp_bwd": _EV + [_P, _P, _P, _I, _I, _I, _D, _I] + [_P] * 5}


def nvcc_build(src: Path, name: str) -> ctypes.CDLL:
    out = cuda_build.BUILD_DIR / f"{name}.so"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(out))


def inputs(dev):
    """{form: (events, kwargs, flow, g, dflow, g1)} at the paths' shapes, float32."""
    with open(cs.CONFIG) as f:
        config = yaml.safe_load(f)
    h, w = config["data"]["height"], config["data"]["width"]
    n_bins = cs.ta_config()["solver"]["time_bin"]
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=dev)
    _, events = cs.first_window(config)
    windows = cs.fleet_windows(config, cs.FLEET_BATCH)
    out = {}
    for form, lead, maker in (
            ("dense", (), lambda: FrameEvents.from_numpy(events, dev, torch.float32)),
            ("voxel", (n_bins,), lambda: FrameEvents.from_numpy(events, dev, torch.float32, n_bins)),
            ("batched", (cs.FLEET_BATCH,), lambda: FleetEvents.from_numpy(windows, dev, torch.float32)),
            ("batched_voxel", (cs.FLEET_TA_BATCH, n_bins),
             lambda: FleetEvents.from_numpy(windows[:cs.FLEET_TA_BATCH], dev, torch.float32, n_bins))):
        ev = maker()
        flows = np.stack([cs.smooth_flow(h, w, rng) for _ in range(int(np.prod(lead)))]).reshape(lead + (2, h, w))
        dflows = np.stack([cs.smooth_flow(h, w, rng) for _ in range(int(np.prod(lead)))]).reshape(lead + (2, h, w))
        g_lead = lead[:1] if form.startswith("batched") else ()
        kw = {"bins": ev.bins, "frames": getattr(ev, "frames", None)}
        out[form] = ((ev.x, ev.y, ev.dtf, ev.wt), kw, t(flows), t(rng.normal(size=g_lead + (3, h, w))),
                     t(dflows), t(rng.normal(size=g_lead + (3, h, w))))
    ev, kw, flow, g, dflow, g1 = out["dense"]
    out["dense_far"] = (ev, kw, flow * 10.0, g, dflow, g1)
    dsec = cs.dsec_config()
    _, dsec_events = cs.first_window(dsec)
    dh, dw = dsec["data"]["height"], dsec["data"]["width"]
    ev = FrameEvents.from_numpy(dsec_events, dev, torch.float32)
    out["dsec"] = ((ev.x, ev.y, ev.dtf, ev.wt), {"bins": None, "frames": None}, t(cs.smooth_flow(dh, dw, rng)),
                   t(rng.normal(size=(3, dh, dw))), t(cs.smooth_flow(dh, dw, rng)), t(rng.normal(size=(3, dh, dw))))
    return out


def port_call(kind, ev, kw, flow, g, dflow, g1):
    if kind == "fwd":
        return lambda: FI.fused_iwe_fwd(flow, *ev, OFFSETS, False, **kw)
    if kind == "bwd":
        return lambda: FI.fused_iwe_bwd(flow, *ev, g, OFFSETS, False, **kw)
    return lambda: FI.fused_iwe_hvp_bwd(flow, dflow, g1, g, *ev, OFFSETS, False, **kw)


def parent_call(lib, kind, ev, kw, flow, g, dflow, g1):
    """The parent's wrapper as it was: its scratch allocated per call."""
    fn = getattr(lib, f"evflow_fused_iwe_{kind}_f32")
    fn.argtypes, fn.restype = PARENT_ARGS[kind], ctypes.c_int
    h, w = flow.shape[-2:]
    frames = kw["frames"]
    lead = () if frames is None else (len(frames.sizes),)

    def call():
        stream = torch.cuda.current_stream().cuda_stream  # the capture's stream inside a CUDA graph
        head = FI._event_args(*ev, flow, kw["bins"], frames)
        offs = (ctypes.c_double * FI.MAX_OFFSETS)(*OFFSETS)
        if kind == "fwd":
            acc = torch.zeros(lead + (3, h, w), dtype=torch.int64, device=flow.device)
            out = torch.empty(lead + (3, h, w), dtype=flow.dtype, device=flow.device)
            rc = fn(*head, flow.data_ptr(), offs, 3, 0, h, w, 1e-6, acc.data_ptr(), out.data_ptr(), stream)
        elif kind == "bwd":
            duv = torch.empty((2, ev[0].shape[0]), dtype=flow.dtype, device=flow.device)
            out = torch.zeros_like(flow)
            rc = fn(*head, flow.data_ptr(), offs, 3, 0, h, w, 1e-6, g.data_ptr(), duv.data_ptr(), out.data_ptr(),
                    stream)
        else:
            duv = torch.empty((2, ev[0].shape[0]), dtype=flow.dtype, device=flow.device)
            out = torch.zeros_like(flow)
            rc = fn(*head, flow.data_ptr(), dflow.data_ptr(), offs, 3, h, w, 1e-6, 0, g1.data_ptr(), g.data_ptr(),
                    duv.data_ptr(), out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"parent {kind} failed: {rc}")
        return out

    return call


def graph_us(call, calls: int = 20, replays: int = 20):
    """Microseconds per call of ``calls`` calls captured in one CUDA graph and
    replayed: the device's time with the launch gaps but without the host's
    enqueue; None where the capture fails."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    try:
        with torch.cuda.stream(side):
            for _ in range(3):  # warm-up on the capture stream
                call()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(calls):
                call()
    except RuntimeError as e:
        print(f"[graph] capture failed: {e}", flush=True)
        return None
    return cs.cuda_ms(graph.replay, n_warm=3, n_iter=replays) * 1e3 / calls


def measure(call, iters: int) -> dict:
    """Wrapper ms per call (CUDA events), device us and device operations
    per call and the kernels by name (profiler, 50 calls), and the device
    us per call of a CUDA graph's replay."""
    ms = cs.cuda_ms(call, n_warm=10, n_iter=iters)
    n_prof = 50
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            call()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {e.key[:60]: round(e.self_device_time_total / n_prof, 3) for e in dev_events}
    return {"ms": ms, "device_us": sum(e.self_device_time_total for e in dev_events) / n_prof,
            "ops": sum(e.count for e in dev_events) / n_prof, "kernels": by_name, "graph_us": graph_us(call)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=str(ROOT / "build" / "parent"))
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--rows", type=int, nargs="+", default=sorted(ROWS))
    ap.add_argument("--out", default=str(ROOT / "build" / "time_fused_iwe.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_fused_iwe: needs an NVIDIA GPU")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from event_based_optical_flow_tpu_torch.utils import set_numerics

    set_numerics()
    kl = cuda_build.load_kernel_library("fused_iwe")
    print("[build] " + " | ".join(l.strip() for l in kl.build_log.splitlines() if "registers" in l), flush=True)
    libs = {}
    parent = Path(args.parent) / "fused_iwe.cu"
    if parent.exists():
        libs["parent"] = nvcc_build(parent, "libfused_iwe_parent")
    else:
        print(f"[build] no parent source at {parent}: the port's kernels alone", flush=True)
    data = inputs(dev)
    results = {"card": smi, "rows": {}}
    for row in args.rows:
        kind, form = ROWS[row]
        ev, kw, flow, g, dflow, g1 = data[form]
        variants = {"port": port_call(kind, ev, kw, flow, g, dflow, g1)}
        if "parent" in libs:
            variants["parent"] = parent_call(libs["parent"], kind, ev, kw, flow, g, dflow, g1)
        want = variants["port"]()
        same = {name: torch.equal(call(), want) for name, call in variants.items()}
        order = [v for v in ("parent", "port") if v in variants]
        turns = {name: [] for name in order}
        for name in order + order[::-1]:
            turns[name].append(measure(variants[name], args.iters))
        row_out = {"kind": kind, "form": form, "same_bits_as_port": same}
        for name, ts in turns.items():
            row_out[name] = {"ms": [t["ms"] for t in ts], "device_us": [t["device_us"] for t in ts],
                             "graph_us": [t["graph_us"] for t in ts], "ops": ts[0]["ops"], "kernels": ts[0]["kernels"]}
            print(f"[row {row}] {kind} {form} {name}: wrapper ms {[round(t['ms'], 4) for t in ts]}, device us "
                  f"{[round(t['device_us'], 2) for t in ts]}, graph-replayed us per call "
                  f"{[None if t['graph_us'] is None else round(t['graph_us'], 2) for t in ts]}, device ops per call "
                  f"{ts[0]['ops']:g}, kernels {ts[0]['kernels']}, same bits as the port: {same[name]}", flush=True)
        results["rows"][row] = row_out
        if not all(same.values()):
            raise SystemExit(f"time_fused_iwe: row {row}: a variant's output differs from the port's")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"[time] {smi}: written to {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"[time] {time.perf_counter() - t0:.1f} s", flush=True)
    sys.exit(rc)
