#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one informative line; any failure exits nonzero):

1. environment: torch and CUDA versions, the card's name and power limit;
   a GPU is required (there is no CPU route);
2. build: the CUDA kernels from ``event_based_optical_flow_tpu_torch/csrc``;
3. kernel vs plain version at the main path's shape (the first 30 000-event
   window of configs/synthetic_mvsec_geometry.yaml, 260x346, a random smooth
   flow of a few px), forward images and the flow gradient, in float64 and
   float32; a second float32 call must give the same bits;
4. objective: the finest scale's whole objective and gradient on the card
   (float64 and float32) against the plain version on the CPU (float64),
   and the float32 value and gradient again, bit for bit;
5. timing: kernel and plain version, forward and backward, CUDA events;
6. the slice: the port's eval loop (the function its CLI runs) on
   configs/synthetic_mvsec_geometry.yaml, frames 0..2, fresh output dir;
   asserts kernel launches, finite EPE clearly below the zero-flow EPE,
   finite PRED_FWL, three metric lines; then frame 0 once more in a fresh
   run, which must reproduce its metrics bit for bit (the solve on the
   card is deterministic, so this run's verdict is every run's).  The
   slice sets the synthetic
   scene's ``data.pattern`` to ``dots``: the config's default lattice scene
   aliases translations by its period (CMax itself, in the original
   reference too, lands ~20 px off there), so no solver beats zero flow on
   it and the EPE check would test the scene, not the port.

The last two lines of standard output are one JSON object describing the
kernels, then ``{"ok": true, "device": {...}}``.  The script imports
nothing of JAX.
"""

import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import yaml

CONFIG = "configs/synthetic_mvsec_geometry.yaml"
OFFSETS = (0.0, 1.0, 0.5)
# |kernel - plain| <= TOL * max(1, max|plain|): float64 sums the same terms in
# another order and in 2^-36 fixed point (forward); float32 adds the
# plain version's own float32 rounding of its sums (~1e-6 relative per
# sum), bounded with margin
TOL = {torch.float64: 1e-9, torch.float32: 1e-4}
# a solved frame's EPE must be below this fraction of the zero-flow EPE
EPE_FRACTION = 0.5


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def environment():
    cuda = torch.version.cuda
    phase("env", f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {cuda}, "
                 f"cuda available: {torch.cuda.is_available()}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (the port's main path runs only on the GPU)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return smi


def first_window(config: dict):
    """The eval loop's first optimization window (30 000 events)."""
    from event_based_optical_flow_tpu_torch import main as port_main
    from event_based_optical_flow_tpu_torch.data import collections

    data_config = config["data"]
    loader = collections[data_config["dataset"]](config=data_config)
    loader.set_sequence(data_config["sequence"])
    ts = loader.eval_frame_time_list()
    ind1, ind2 = loader.time_to_index(ts[0]), loader.time_to_index(ts[data_config["eval_dt"]])
    return loader, port_main._optimization_batch(loader, data_config, ind1, ind2)


def smooth_flow(h: int, w: int, rng) -> np.ndarray:
    """A random smooth displacement field of a few px."""
    from event_based_optical_flow_tpu_torch.ops.interp import _resize_bilinear

    coarse = torch.as_tensor(rng.uniform(-4.0, 4.0, (2, 6, 8)))
    return _resize_bilinear(coarse, (h, w)).numpy()


def compare(fi, frame, flow, g, include_orig, offsets):
    """(forward err, backward err or None, forward scale, backward scale,
    whether a second kernel call gave the same bits)."""
    ev = (frame.x, frame.y, frame.dtf, frame.wt)
    ref = fi.fused_iwe_reference(flow, *ev, offsets, include_orig)
    got = fi.fused_iwe_fwd(flow, *ev, offsets, include_orig)
    torch.cuda.synchronize()
    fwd_err = (got - ref).abs().max().item()
    fwd_scale = max(1.0, ref.abs().max().item())
    same = torch.equal(got, fi.fused_iwe_fwd(flow, *ev, offsets, include_orig))
    if not offsets:
        return fwd_err, None, fwd_scale, None, same
    gk = g[: ref.shape[0]].contiguous()
    flr = flow.clone().requires_grad_(True)
    (want,) = torch.autograd.grad((fi.fused_iwe_reference(flr, *ev, offsets, include_orig) * gk).sum(), flr)
    got_d = fi.fused_iwe_bwd(flow, *ev, gk, offsets, include_orig)
    same = same and torch.equal(got_d, fi.fused_iwe_bwd(flow, *ev, gk, offsets, include_orig))
    torch.cuda.synchronize()
    return (fwd_err, (got_d - want).abs().max().item(), fwd_scale, max(1.0, want.abs().max().item()),
            same)


def cuda_ms(fn, n_warm: int = 5, n_iter: int = 50) -> float:
    for _ in range(n_warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_iter):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


def objective_check(config: dict, events: np.ndarray, rng) -> str:
    """The finest scale's whole objective (kernel, blur, hybrid cost) and
    its autograd gradient on the card against the plain version on the CPU
    at float64, on the first window at random tile motions of a few px/s.
    float64 on both sides: the sums' order is all that differs (1e-9);
    float32 on the card: its rounding (1e-4 of the value), and for the
    gradient also corner decisions that flip where a warped coordinate
    rounds across a pixel edge (1e-2 of the largest component)."""
    from event_based_optical_flow_tpu_torch import main as port_main
    from event_based_optical_flow_tpu_torch.solver.objective import FrameEvents, build_objective, build_orig_iwe

    _, solv = port_main.build(config, "cpu")
    solv.overload_patch_configuration(solv.patch_scales - 1)
    spec = solv._current_spec()
    motion = rng.uniform(-15.0, 15.0, 2 * solv.n_patch)
    out = {}
    for dev, dtype, rep in (("cpu", torch.float64, 0), ("cuda", torch.float64, 0),
                            ("cuda", torch.float32, 0), ("cuda", torch.float32, 1)):
        frame = FrameEvents.from_numpy(events, dev, dtype)
        m = torch.as_tensor(motion, dtype=dtype, device=dev).requires_grad_(True)
        loss, _ = build_objective(spec)(m, build_orig_iwe(spec)(frame), frame)
        (grad,) = torch.autograd.grad(loss, m)
        out[(dev, dtype, rep)] = (loss.item(), grad.double().cpu().numpy())
    l_ref, g_ref = out[("cpu", torch.float64, 0)]
    (l0, g0), (l1, g1) = out[("cuda", torch.float32, 0)], out[("cuda", torch.float32, 1)]
    same = l0 == l1 and np.array_equal(g0, g1)
    g_scale = np.abs(g_ref).max()
    lines = []
    for key, (tol_l, tol_g) in ((("cuda", torch.float64, 0), (1e-9, 1e-9)),
                                (("cuda", torch.float32, 0), (1e-4, 1e-2))):
        l_got, g_got = out[key]
        el, eg = abs(l_got - l_ref) / abs(l_ref), np.abs(g_got - g_ref).max() / g_scale
        ok = el <= tol_l and eg <= tol_g
        lines.append(f"cuda {str(key[1])[6:]}: loss rel err {el:.2e} (tol {tol_l:g}), grad err {eg:.2e} "
                     f"x max|grad| (tol {tol_g:g}): {'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit("chip_smoke: the objective on the card disagrees with the CPU")
    if not same:
        raise SystemExit("chip_smoke: the float32 objective on the card changed between two calls")
    return (f"scale {solv.current_scale}, {solv.n_patch} tiles, loss {l_ref:.6f} (cpu float64); "
            + "; ".join(lines) + "; float32 repeat same bits: ok")


def zero_flow_epe(loader, data_config, frame_index: int, solv) -> float:
    """EPE of a zero flow on the same eval window (the metric's masks)."""
    from event_based_optical_flow_tpu_torch.flow.metrics import calculate_flow_error
    from event_based_optical_flow_tpu_torch.ops.iwe import event_mask

    ts = loader.eval_frame_time_list()
    t1, t2 = ts[frame_index], ts[frame_index + data_config["eval_dt"]]
    events = loader.load_event(loader.time_to_index(t1), loader.time_to_index(t2))
    gt = solv.tensor(np.transpose(loader.load_optical_flow(t1, t2), (2, 0, 1)))
    mask = event_mask(solv.tensor(events), solv.image_shape)[None]
    return float(calculate_flow_error(gt[None], torch.zeros_like(gt)[None], mask)["EPE"])


def slice_config(config: dict, last_frame: int, out_dir: str) -> dict:
    """The smoke's slice: frames 0..last_frame of the `dots` scene."""
    run_config = copy.deepcopy(config)
    run_config["data"]["ind2"] = last_frame
    run_config["data"]["pattern"] = "dots"
    run_config["output"]["output_dir"] = out_dir
    return run_config


def run_slice(port_main, config: dict, dev, last_frame: int):
    """(records, output dir, wall seconds) of the CLI's eval loop over
    frames 0..last_frame, in a fresh output dir."""
    out_dir = tempfile.mkdtemp(prefix="evflow_chip_smoke_")
    t0 = time.perf_counter()
    records = port_main.run(slice_config(config, last_frame, out_dir), eval_mode=True, device=dev)
    torch.cuda.synchronize()
    return records, out_dir, time.perf_counter() - t0


def main() -> int:
    smi = environment()
    dev = torch.device("cuda")

    from event_based_optical_flow_tpu_torch import main as port_main
    from event_based_optical_flow_tpu_torch.ops import cuda_build
    from event_based_optical_flow_tpu_torch.ops import fused_iwe as fi
    from event_based_optical_flow_tpu_torch.solver.objective import FrameEvents
    from event_based_optical_flow_tpu_torch.utils import set_numerics

    set_numerics()
    kl = cuda_build.load_kernel_library("fused_iwe")
    ptxas = " | ".join(l.strip() for l in kl.build_log.splitlines() if "registers" in l or "spill" in l)
    phase("build", f"{kl.path.name}: {kl.build_seconds:.2f} s (nvcc sm_90a); {ptxas or 'cached'}")

    with open(CONFIG) as f:
        config = yaml.safe_load(f)
    loader, events = first_window(config)
    h, w = config["data"]["height"], config["data"]["width"]
    rng = np.random.default_rng(0)
    flow_np = smooth_flow(h, w, rng)
    g_np = rng.normal(size=(1 + len(OFFSETS), h, w))
    errs = {}
    for dtype in (torch.float64, torch.float32):
        frame = FrameEvents.from_numpy(events, dev, dtype)
        flow = torch.as_tensor(flow_np, dtype=dtype, device=dev)
        g = torch.as_tensor(g_np, dtype=dtype, device=dev)
        for include_orig, offsets in ((False, OFFSETS), (True, ())):
            fe, be, fs, bs, same = compare(fi, frame, flow, g, include_orig, offsets)
            ok = fe <= TOL[dtype] * fs and (be is None or be <= TOL[dtype] * bs) and same
            phase("check", f"{str(dtype)[6:]} offsets={offsets} orig={include_orig} N={len(events)} "
                           f"{h}x{w}: fwd max|err| {fe:.3e} (scale {fs:.3g})"
                           + ("" if be is None else f", bwd max|err| {be:.3e} (scale {bs:.3g})")
                           + f", tol {TOL[dtype]:g} x scale; repeat same bits: {same}: "
                           + ('ok' if ok else 'FAIL'))
            if not ok:
                raise SystemExit("chip_smoke: kernel disagrees with its plain version")
            if dtype == torch.float32 and offsets:
                errs = {"fwd": fe, "bwd": be}
    phase("objective", objective_check(config, events, rng))

    # timing at the main path's shape, float32 (the main path's dtype)
    frame = FrameEvents.from_numpy(events, dev, torch.float32)
    ev = (frame.x, frame.y, frame.dtf, frame.wt)
    flow = torch.as_tensor(flow_np, dtype=torch.float32, device=dev)
    g = torch.as_tensor(g_np[1:], dtype=torch.float32, device=dev).contiguous()
    flr = flow.clone().requires_grad_(True)
    with torch.enable_grad():
        graph = fi.fused_iwe_reference(flr, *ev, OFFSETS, False)
    times = {
        "fwd": cuda_ms(lambda: fi.fused_iwe_fwd(flow, *ev, OFFSETS, False)),
        "fwd_plain": cuda_ms(lambda: fi.fused_iwe_reference(flow, *ev, OFFSETS, False)),
        "bwd": cuda_ms(lambda: fi.fused_iwe_bwd(flow, *ev, g, OFFSETS, False)),
        "bwd_plain": cuda_ms(lambda: torch.autograd.grad(graph, flr, g, retain_graph=True)),
    }
    phase("time", f"{smi}: float32 N={len(events)} offsets={OFFSETS}: kernel fwd {times['fwd']:.4f} ms "
                  f"vs plain {times['fwd_plain']:.4f} ms; kernel bwd {times['bwd']:.4f} ms vs plain "
                  f"{times['bwd_plain']:.4f} ms (CUDA events, mean of 50 after 5 warm-up)")

    # the slice: the CLI's eval loop, 3 windows
    fi.reset_launch_counts()
    records, out_dir, wall = run_slice(port_main, config, dev, last_frame=2)
    launches = fi.launch_counts()
    run_config = slice_config(config, last_frame=2, out_dir=out_dir)
    slice_loader, solv = port_main.build(run_config, dev)
    failed = []
    for r in records:
        m = r["metrics"]
        zero = zero_flow_epe(slice_loader, run_config["data"], r["frame"], solv)
        ok = np.isfinite(m["EPE"]) and m["EPE"] < EPE_FRACTION * zero and np.isfinite(m["PRED_FWL"])
        loss = {s: round(v, 6) for s, v in r["stats"]["loss"].items()}
        phase("frame", f"{r['frame']}: {r['seconds']:.3f} s, EPE {m['EPE']:.4f} (zero flow {zero:.4f}), "
                       f"3PE {m['3PE']:.4f}, AE {m['AE']:.4f}, GT_FWL {m['GT_FWL']:.4f}, "
                       f"PRED_FWL {m['PRED_FWL']:.4f}, host syncs {r['stats']['syncs']}, "
                       f"Newton iters {r['stats']['iters']}, loss per scale {loss}: {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(r["frame"])
    with open(os.path.join(out_dir, "eval_metrics.jsonl")) as f:
        n_lines = len(f.read().strip().splitlines())
    phase("slice", f"{len(records)} windows in {wall:.2f} s, eval_metrics.jsonl lines {n_lines}, "
                   f"kernel launches {launches}, out {out_dir}")
    again, _, again_wall = run_slice(port_main, config, dev, last_frame=0)
    same = [a["metrics"] == r["metrics"] and a["stats"]["loss"] == r["stats"]["loss"]
            for a, r in zip(again, records)]
    phase("repeat", f"frame 0 in a fresh run ({again_wall:.2f} s): metrics and per-scale losses "
                    f"bit for bit the same: {'ok' if same == [True] else 'FAIL'}")
    if failed:
        raise SystemExit(f"chip_smoke: frames {failed}: metrics not finite or not below the zero flow")
    if len(records) != 3 or n_lines != 3 or launches["fwd"] == 0 or launches["bwd"] == 0:
        raise SystemExit("chip_smoke: the eval loop did not run 3 windows through both kernels")
    if same != [True]:
        raise SystemExit("chip_smoke: a second run of frame 0 did not reproduce its result")

    src = fi.KERNEL_SOURCE
    kernels = [
        {"name": "fused_iwe_fwd", "route": "cuda", "source": src,
         "replaces": "event_based_optical_flow_tpu/ops/pallas_objective_banded.py:986",
         "launches": launches["fwd"], "max_abs_err": errs["fwd"],
         "ms": times["fwd"], "plain_ms": times["fwd_plain"]},
        {"name": "fused_iwe_bwd", "route": "cuda", "source": src,
         "replaces": "event_based_optical_flow_tpu/ops/pallas_objective_banded.py:1092",
         "launches": launches["bwd"], "max_abs_err": errs["bwd"],
         "ms": times["bwd"], "plain_ms": times["bwd_plain"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
