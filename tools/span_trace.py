#!/usr/bin/env python3
"""The port's spans against the device trace of one call of a benchmark
cell's eval loop, on the card:

    python3 tools/span_trace.py --workload dsec-seq --seed 9101 [--out build/spans_dsec.json]

Builds the cell as ``benchmark/run.py`` does (``harness.Driver``), makes
its warm-up call, then traces one call under the benchmark's profiler
(CUDA activity only) with the port's spans recording, and reports:

* whether the spans recorded under that profiler (``tracing.recording()``
  inside the call);
* the shared clock: for every CUDA activity, the innermost span open when
  the runtime call that launched it began (kineto's correlation); an
  activity that starts before that span began is a failure (expected:
  none); the least margin seen; and the share of ``read.*`` spans that
  hold a ``cudaMemcpyAsync`` (the read's copy) on the same clock;
* idle device seconds by the innermost span open during each idle gap of
  the call (the gaps split at span boundaries), top first;
* the spans' cost: the call's seconds, the spans and counted reads it
  recorded per frame, and the cost of one site with nothing recording
  (``span`` and ``read``'s own work, timed here on the host).

Needs a CUDA device; writes the full result as JSON to ``--out``."""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from benchmark import cells, harness  # noqa: E402

TOP = 25


def null_site_ns(n: int = 200_000) -> dict:
    """Host ns per site with nothing recording: an empty ``span``, a
    ``count``, and ``read``'s work besides the copy (a CPU tensor)."""
    import torch

    from event_based_optical_flow_tpu_torch.utils import tracing

    out = {}
    t = torch.zeros(())

    def empty_span():
        with tracing.span("x"):
            pass

    for name, body in (("span", empty_span), ("count", lambda: tracing.count("x", 1)),
                       ("read_over_cpu", lambda: tracing.read(t, "done")),
                       ("cpu_copy", lambda: t.detach().cpu())):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            body()
        out[name] = (time.perf_counter_ns() - t0) / n
    out["read"] = out.pop("read_over_cpu") - out.pop("cpu_copy")
    return out


def idle_by_span(spans: list, busy_start: np.ndarray, busy_end: np.ndarray, t0: int, t1: int) -> dict:
    """Idle device ns in [t0, t1] by the innermost span open (its name; a
    ``graphs.*`` span with its kind), gaps split at span boundaries."""
    order = np.argsort(busy_start, kind="stable")
    s, e = busy_start[order], busy_end[order]
    reach = np.maximum.accumulate(e) if len(e) else e
    opens = np.ones(len(s), dtype=bool)
    opens[1:] = s[1:] > reach[:-1]
    first = np.flatnonzero(opens)
    last = np.append(first[1:] - 1, len(s) - 1)
    ms, me = s[first], reach[last]
    cum = np.concatenate([[0], np.cumsum(me - ms)])

    def busy_until(t: np.ndarray) -> np.ndarray:
        k = np.searchsorted(ms, t, side="right")  # merged intervals starting at or before t
        done = cum[np.maximum(k - 1, 0)]
        partial = np.where(k > 0, np.clip(t - ms[np.maximum(k - 1, 0)], 0, me[np.maximum(k - 1, 0)]
                                          - ms[np.maximum(k - 1, 0)]), 0)
        return np.where(k > 0, done + partial, 0)

    def label(sp: dict) -> str:
        kind = sp["attrs"].get("kind")
        return f"{sp['name']}[{kind}]" if kind else sp["name"]

    bounds = [(t0, 0, -1), (t1, 2, -1)]
    for i, sp in enumerate(spans):
        if sp["end_ns"] > t0 and sp["start_ns"] < t1:
            bounds.append((max(sp["start_ns"], t0), 1, i))
            bounds.append((min(sp["end_ns"], t1), 0, i))
    bounds.sort()
    times = np.array([b[0] for b in bounds], dtype=np.int64)
    idle_cum = (times - t0) - busy_until(times)
    out, stack = {}, []
    for k, (t, kind, i) in enumerate(bounds[:-1]):
        if kind == 1:
            stack.append(i)
        elif kind == 0 and i >= 0 and stack and stack[-1] == i:
            stack.pop()
        idle = int(idle_cum[k + 1] - idle_cum[k])
        if idle > 0:
            name = label(spans[stack[-1]]) if stack else "(no span)"
            out[name] = out.get(name, 0) + idle
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    import torch

    from event_based_optical_flow_tpu_torch.utils import tracing

    if not torch.cuda.is_available():
        print("span_trace: needs a CUDA device", file=sys.stderr)
        return 3
    manifest = cells.load_manifest()
    workload = cells.find(manifest["workloads"], args.workload, "workload")
    config, traffic = cells.load_json("configs", workload["config"]), cells.load_json("traffic", workload["traffic"])
    device = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="span-trace-") as tmp:
        driver = harness.Driver(config, traffic, args.seed, device, tmp)
        driver.call()
        torch.cuda.synchronize()
        tracing.drain()
        seen = {}

        def call():
            seen["recording"] = tracing.recording()
            return driver.call()

        prof = torch.autograd.profiler.profile(use_device="cuda", use_kineto=True, use_cpu=False)
        with prof:
            t0 = time.time_ns()
            frames, stats = call()
            torch.cuda.synchronize()
            t1 = time.time_ns()
        spans, counts = tracing.drain()
    t_reduce = time.perf_counter()
    cuda = torch.autograd.DeviceType.CUDA
    dev_start, dev_end, dev_corr, runtime, other = [], [], [], {}, {}
    for e in prof.kineto_results.events():
        if e.device_type() == cuda:
            dev_start.append(e.start_ns())
            dev_end.append(e.start_ns() + e.duration_ns())
            dev_corr.append(e.linked_correlation_id() or e.correlation_id())
        elif e.correlation_id():
            # the CUDA runtime and driver calls; the profiler's own events
            # (buffer flushes and requests) reuse correlation ids
            if e.name().startswith("cu"):
                runtime.setdefault(e.correlation_id(), []).append((e.start_ns(), e.name()))
            else:
                other[e.name()] = other.get(e.name(), 0) + 1
    dev_start, dev_end = np.asarray(dev_start, dtype=np.int64), np.asarray(dev_end, dtype=np.int64)

    # the innermost span open at each runtime call's start: spans nest, so
    # among the spans that began at or before it, the last one still open
    starts = np.array([s["start_ns"] for s in spans], dtype=np.int64)
    ends = np.array([s["end_ns"] for s in spans], dtype=np.int64)

    def innermost(t: int) -> int:
        k = int(np.searchsorted(starts, t, side="right")) - 1
        while k >= 0 and ends[k] < t:
            k = spans[k]["parent"]
        return k

    failures, margins, outside, launched = 0, [], 0, 0
    worst, worst_at, failed_at, samples = 0, None, {}, []
    before_call, worst_call = 0, 0
    memo = {}
    shared = sum(1 for calls in runtime.values() if len(calls) > 1)
    for ds, corr in zip(dev_start.tolist(), dev_corr):
        calls = runtime.get(corr)
        if calls is None:
            continue
        launched += 1
        # a correlation id that several runtime calls carry: the last of
        # them to start before the activity launched it
        call_rt = max((c for c in calls if c[0] <= ds), default=min(calls))
        if ds < call_rt[0]:  # the device's clock against the runtime call's, both kineto's
            before_call += 1
            worst_call = min(worst_call, ds - call_rt[0])
        k = memo.get((corr, call_rt[0]))
        if k is None:
            k = memo[(corr, call_rt[0])] = innermost(call_rt[0])
        if k < 0:
            outside += 1
            continue
        margin = ds - int(starts[k])
        margins.append(margin)
        if margin < 0:
            failures += 1
            if margin < worst:
                worst, worst_at = margin, (ds - t0) * 1e-9
            where = f"{call_rt[1]} in {spans[k]['name']}"
            failed_at[where] = failed_at.get(where, 0) + 1
            if len(samples) < 5 or margin == worst:
                samples.append({"activity_s": (ds - t0) * 1e-9, "call_s": (call_rt[0] - t0) * 1e-9,
                                "span": spans[k]["name"], "span_s": (int(starts[k]) - t0) * 1e-9,
                                "calls_of_the_id": len(calls)})
    copies = sorted(t for calls in runtime.values() for t, name in calls if name == "cudaMemcpyAsync")
    copies = np.asarray(copies, dtype=np.int64)
    reads = [s for s in spans if s["name"].startswith("read.")]
    held = sum(1 for s in reads if np.searchsorted(copies, s["end_ns"], side="right")
               > np.searchsorted(copies, s["start_ns"], side="left"))
    idle = idle_by_span(spans, dev_start, dev_end, t0, t1)
    busy = float(np.sum(np.maximum(0, np.minimum(dev_end, t1) - np.maximum(dev_start, t0))))
    sync_reads = sum(1 for s in reads if s["name"][len("read."):] in tracing.SYNC_SITES)
    result = {
        "workload": args.workload, "seed": args.seed, "device": torch.cuda.get_device_name(0),
        "recording_under_the_benchmark_profiler": bool(seen.get("recording")),
        "frames": frames, "call_s": (t1 - t0) * 1e-9, "activities": len(dev_start),
        "stats_syncs": stats["syncs"], "sync_site_reads": sync_reads,
        "clock": {"launched_activities": launched, "launched_outside_any_span": outside,
                  "before_their_span": failures, "worst_ns": worst, "worst_at_s": worst_at,
                  "least_margin_ns": int(min(margins)) if margins else None,
                  "median_margin_ns": int(np.median(margins)) if margins else None,
                  "failures_by_call_and_span": dict(sorted(failed_at.items(), key=lambda kv: -kv[1])[:10]),
                  "profiler_events_with_a_correlation": other,
                  "correlation_ids_of_several_runtime_calls": shared, "failure_samples": samples[-8:],
                  "before_their_own_call": before_call, "worst_before_own_call_ns": worst_call,
                  "read_spans": len(reads), "read_spans_holding_a_copy": held},
        "idle_s": {k: v * 1e-9 for k, v in list(idle.items())[:TOP]},
        "idle_total_s": sum(idle.values()) * 1e-9, "busy_overlap_s_upper": busy * 1e-9,
        "spans_per_frame": len(spans) / frames, "reads_per_frame": len(reads) / frames,
        "counters_per_frame": {k: v / frames for k, v in counts.items()},
        "null_site_ns": null_site_ns(), "reduce_s": time.perf_counter() - t_reduce,
    }
    text = json.dumps(result, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
