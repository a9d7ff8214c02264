"""One run of one cell: set-up, the measured window, the check.

Set-up builds the cell's scene from the seed (``scene.Sequence``), the
port's solver from the configuration and the traffic mix, and makes one
call into the port's eval loop (``main.evaluate_dataset_with_gt``, one
frame; ``main.evaluate_dataset_fleet``, one batch) on the sequence's first
frames: it loads or builds the kernels and captures the chain's CUDA
graphs for the cell's event counts.  The window then calls the eval loop
frame after frame (batch after batch) through the timestamps it passes and
the loop's own checkpoint, as the CLI's loop runs, until a call ends after
``--seconds``; a sequence that runs out starts again, cold, in a fresh
output directory.  With ``--trace 1`` the window's first call runs under
the profiler, whole (``profiling.trace_call``; ``TRACE_LIMIT_S`` guards
the run's time).  After the window the solver is
freed and the configuration's reference (``cells.reference``, found
before set-up) judges every frame the window solved
(``reference.compare``)."""

import argparse
import gc
import json
import os
import re
import sys
import tempfile
import time

from benchmark import cells, profiling
from benchmark import scene as scene_mod
from benchmark.reference import compare

PORT = "event_based_optical_flow_tpu_torch"
# host seconds after which a --trace 1 run stops tracing the window's first
# call: a guard that keeps the run within its time; a fleet batch of 8
# (4.7-4.8 M activities, ~35 s traced) and a DSEC frame end well before it
TRACE_LIMIT_S = 200.0
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "event_based_optical_flow_tpu")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def set_cache_dirs() -> None:
    """Every compiler cache at a fixed path inside the checkout (the port's
    nvcc builds go to ``build/kernels`` by themselves)."""
    build = cells.ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")


def _kernels_of(path, seen: set) -> set:
    """The names of the ``__global__`` functions that ``path`` and the
    local headers it includes define."""
    if path in seen:
        return set()
    seen.add(path)
    text = path.read_text()
    pattern = r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*\([^)]*\)\s*)?(?:void\s+)?(\w+)\s*\("
    names = set(re.findall(pattern, text))
    for header in re.findall(r'#include\s+"([^"]+)"', text):
        names |= _kernels_of(path.parent / header, seen)
    return names


def kernel_names(source: str) -> tuple:
    """The device kernels that one of the port's CUDA libraries defines
    (``csrc/<source>`` and the local headers it includes)."""
    return tuple(sorted(_kernels_of(cells.ROOT / PORT / "csrc" / source, set())))


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


class Driver:
    """The port's solver and eval loop on one generated sequence."""

    def __init__(self, config: dict, traffic: dict, seed: int, device, tmp: str):
        from event_based_optical_flow_tpu_torch import solver as port_solver
        from event_based_optical_flow_tpu_torch.utils import set_numerics, validate_config

        self.config = cells.port_config(config, traffic)
        validate_config(self.config)
        set_numerics()
        self.data = self.config["data"]
        self.eval_dt = int(self.data["eval_dt"])
        self.fleet = traffic["loop"] == "fleet"
        self.batch = int(self.data["fleet_batch"]) if self.fleet else 1
        self.seq = scene_mod.Sequence(config["scene"], seed, config["scene"]["sequence_frames"])
        if self.batch + self.eval_dt > self.seq.n_frames:
            raise ValueError("the sequence is shorter than one call of the eval loop")
        self.solver = port_solver.collections[self.config["solver"]["method"]](
            (int(self.data["height"]), int(self.data["width"])), calibration_parameter=self.seq.load_calib(),
            solver_config=self.config["solver"], optimizer_config=self.config["optimizer"],
            output_config=self.config["output"], visualize_module=None, device=device)
        self._wrap_solver()
        self.tmp = tmp
        self.answers = []
        self.passes = 0
        self._new_pass()

    def _wrap_solver(self) -> None:
        """Keep a device copy of each finest tile motion the solver returns."""
        self._motions = []
        solver = self.solver
        name = "optimize_batch" if self.fleet else "optimize"
        solve = getattr(solver, name)

        def finest(result):
            return result[max(result)].detach().clone()

        def wrapped(events):
            result = solve(events)
            self._motions.extend(finest(r) for r in (result if self.fleet else [result]))
            return result

        setattr(solver, name, wrapped)

    def _new_pass(self) -> None:
        """Start the sequence from its first frame, cold, in a fresh output
        directory."""
        self.out_dir = tempfile.mkdtemp(prefix=f"pass{self.passes}-", dir=self.tmp)
        self.passes += 1
        self.next_frame = 0
        self.solver.previous_frame_best_estimation = None

    def call(self):
        """One call into the eval loop: (frames solved, the solver's stats)."""
        from event_based_optical_flow_tpu_torch import main as port_main

        if self.next_frame + self.batch + self.eval_dt > self.seq.n_frames:
            self._new_pass()
        ts = self.seq.gray_ts[: self.next_frame + self.batch + self.eval_dt]
        self._motions.clear()
        if self.fleet:
            records = port_main.evaluate_dataset_fleet(ts, self.data, self.seq, self.solver, self.out_dir,
                                                       self.batch)
        else:
            records = port_main.evaluate_dataset_with_gt(ts, self.data, self.seq, self.solver, self.out_dir)
        if len(records) != self.batch or len(self._motions) != self.batch:
            raise RuntimeError(f"the eval loop solved {len(records)} frames ({len(self._motions)} motions), "
                               f"not {self.batch}")
        stats = records[0]["stats"]
        finest = max(stats["loss"])
        losses = stats["loss"][finest]
        losses = list(losses) if isinstance(losses, (list, tuple)) else [losses]
        for i, rec in enumerate(records):
            frame = rec["frame"]
            self.answers.append(compare.Answer(  # a frame the solver reports no loss for reads NaN
                t1=float(ts[frame]), t2=float(ts[frame + self.eval_dt]), motion=self._motions[i],
                loss=float(losses[i]) if i < len(losses) else float("nan"), aee=float(rec["metrics"]["EPE"])))
        self.next_frame += self.batch
        return self.batch, stats


def check_lines(values: dict, limits: dict) -> list:
    return [f"check {k}: {values[k]:.6g} (limit {limits[k]:g})" for k in cells.LIMIT_KEYS]


def measure(config: dict, traffic: dict, seed: int, device, seconds: float, trace: bool, t_start: float) -> dict:
    """Set-up, then the window: ``setup_s``, ``window_s``, ``run`` (what the
    per-layer readers read), ``answers`` (every frame the window solved),
    the sequence, the port config and the device's peak memory.  The
    solver is freed before this returns."""
    import torch

    on_card = device.type == "cuda"
    with tempfile.TemporaryDirectory(prefix="evflow-bench-") as tmp:
        t_build = time.perf_counter()
        driver = Driver(config, traffic, seed, device, tmp)
        t_warm = time.perf_counter()
        driver.call()  # the warm-up: kernels, graphs, allocator
        driver.answers.clear()
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start
        print(f"setup: {setup_s:.3f} s (imports {t_build - t_start:.3f} s, scene and solver "
              f"{t_warm - t_build:.3f} s, warm-up call {time.perf_counter() - t_warm:.3f} s)", file=sys.stderr)

        run = {"frames": 0, "calls": [], "trace": None}
        span = f"eval_loop.{traffic['loop']}"
        t0 = time.perf_counter()
        while True:
            t_call = time.perf_counter()
            if trace and run["trace"] is None:
                from event_based_optical_flow_tpu_torch import ops

                (n, stats), sliced = profiling.trace_call(driver.call, span, kernel_names("fused_iwe.cu"),
                                                          kernel_names("vote.cu"), ops.launch_counts, TRACE_LIMIT_S)
                sliced.update(frames=n, stats=stats, image_shape=(driver.seq.height, driver.seq.width))
                run["trace"] = sliced
            else:
                n, stats = driver.call()
            run["calls"].append({"frames": n, "stats": stats, "seconds": time.perf_counter() - t_call})
            run["frames"] += n
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        print(f"window: {window_s:.3f} s, {run['frames']} frames in {len(run['calls'])} calls of "
              f"{[round(c['seconds'], 3) for c in run['calls']]} s, {driver.passes} pass(es); peak "
              f"{peak / 2**30:.3f} GiB", file=sys.stderr)
        if run["trace"]:
            t = run["trace"]
            print(f"trace: {t['window_s']:.3f} s traced ({'the whole call' if t['whole'] else 'part of the call'}), "
                  f"{t['activities']} device activities, profiler stop {t['stop_s']:.1f} s, reduced in "
                  f"{t['reduce_s']:.1f} s", file=sys.stderr)
        out = {"setup_s": setup_s, "window_s": window_s, "run": run, "answers": driver.answers,
               "seq": driver.seq, "config": driver.config, "peak": peak}
        del driver
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    return out


def judge(measured: dict, device, reference, tf32: bool = False):
    """(the reference's (loss, AEE, zero-flow AEE, descent gain) per frame,
    the compared numbers, frames beyond a per-frame limit) of a measured
    window, by ``reference`` (``cells.reference``: its answers and its
    ``LIMITS``); with ``tf32`` the control's answers take the program's
    place."""
    answers, seq = measured["answers"], measured["seq"]
    limits = reference.LIMITS
    t_ref = time.perf_counter()
    ref = reference.reference_answers(answers, seq.events, seq, measured["config"], device)
    print(f"reference: {len(answers)} frames in {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    if tf32:
        control = reference.reference_answers(answers, seq.events, seq, measured["config"], device, tf32=True)
        losses, aees = [c[0] for c in control], [c[1] for c in control]
    else:
        losses, aees = [a.loss for a in answers], [a.aee for a in answers]
    print("per frame: AEE " + " ".join(f"{r[1]:.3f}" for r in ref) + "; zero flow "
          + " ".join(f"{r[2]:.3f}" for r in ref) + "; descent gain "
          + " ".join(f"{r[3]:.3g}" for r in ref), file=sys.stderr)
    values = compare.numbers(losses, aees, ref)
    failed = sum(1 for loss, aee, r in zip(losses, aees, ref)
                 if not (abs(loss - r[0]) <= limits["loss_gap"] * abs(r[0])
                         and abs(aee - r[1]) <= limits["aee_gap"] * r[1]))
    return ref, values, failed


def main(argv=None, t_start=None, device=None, require_cuda: bool = True, cell=None) -> int:
    """Run one cell once and print its result; returns the exit code.
    ``device``, ``require_cuda`` and ``cell`` (a (config, traffic) pair in
    place of the files) are for the CPU tests, which drive a run at a tiny
    size without a card."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse_args(argv)
    manifest = cells.load_manifest()
    workload = cells.find(manifest["workloads"], args.workload, "workload")
    set_cache_dirs()
    config, traffic = cell or (cells.load_json("configs", workload["config"]),
                               cells.load_json("traffic", workload["traffic"]))
    reference = cells.reference(config)
    import torch

    if require_cuda:
        chips = int(workload["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"benchmark: {args.workload} needs {chips} CUDA device(s), {visible} visible", file=sys.stderr)
            return 3
    device = torch.device(device or "cuda")
    on_card = device.type == "cuda"
    measured = measure(config, traffic, args.seed, device, args.seconds, bool(args.trace), t_start)
    run = measured["run"]
    ref, values, failed = judge(measured, device, reference)
    correct = compare.verdict(values, reference.LIMITS) and failed == 0

    if args.trace:
        metrics = {}
        for m in cells.cell_metrics(manifest, args.workload, "per_layer"):
            value = cells.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"setup_s": measured["setup_s"], "frame_s": measured["window_s"] / run["frames"],
               "aee_px": sum(r[1] for r in ref) / len(ref)}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cells.cell_metrics(manifest, args.workload, "end_to_end")}
    result = {"correct": bool(correct), "attempted": len(measured["answers"]), "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else device.type,
                         "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                         "count": int(workload["chips"]) if on_card else 1,
                         "memory_peak_bytes": int(measured["peak"])}}
    if args.trace:
        sliced = run["trace"]
        result["device"].update(busy_s=sliced["busy_s"], window_s=sliced["window_s"])
        result["breakdown"] = {"device_ops": sliced["device_ops"], "idle_gaps": sliced["idle_gaps"]}
    result["checks"] = {k: {"value": values[k], "limit": reference.LIMITS[k]} for k in cells.LIMIT_KEYS}
    result["checks"]["failed_frames"] = {"value": failed, "limit": 0}

    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}: no JAX and no JAX package on the measured path",
              file=sys.stderr)
        return 4
    lines = check_lines(values, reference.LIMITS) + [f"check failed_frames: {failed} (limit 0)"]
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
