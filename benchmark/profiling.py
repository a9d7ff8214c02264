"""The traced slice: one call into the eval loop under ``torch.profiler``'s
CUDA activity (kernels, copies, fills and the runtime calls that launched
them), reduced in memory to what the per-layer readers and the breakdown
need.  No trace file is written.

The slice ends when the call returns or, as a guard on the run's time,
when ``limit_s`` seconds of host time have passed (a timer's signal stops
the profiler on the main thread, between two Python operations, after a
synchronize): the profiler's own cost grows with the CUDA activities it
records (millions in one fleet batch).  ``counters()`` (the port's launch
counters) are read at the slice's start and end, so a reader can scale the
slice to the call.

``window_s`` is the slice's host wall clock, ``busy_s`` the length of the
union of its CUDA activity.  Each idle gap of the union is labelled by the
runtime call that launched the work ending it, under the benchmark's span
around the call."""

import signal
import time
from array import array

import numpy as np

NOT_KERNELS = ("Memcpy", "Memset")  # the profiler's names of copies and fills
TOP = 10


def _union(starts: np.ndarray, ends: np.ndarray):
    """(merged starts, merged ends, index of the activity opening each
    merged interval) of intervals."""
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    opens = np.ones(len(s), dtype=bool)
    opens[1:] = s[1:] > reach[:-1]
    first = np.flatnonzero(opens)
    last = np.append(first[1:] - 1, len(s) - 1)
    return s[first], reach[last], order[first]


class _Slice:
    """The profiler around ``fn``, stopped at its return or by the timer."""

    def __init__(self, counters, limit_s: float):
        import torch

        self.torch = torch
        self.counters = counters
        self.limit_s = limit_s
        self.prof = torch.autograd.profiler.profile(use_device="cuda", use_kineto=True, use_cpu=False)
        self.stopped = False

    def start(self) -> None:
        self.torch.cuda.synchronize()
        self.before = self.counters()
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self, *_) -> None:
        if self.stopped:
            return
        if self.torch.cuda.is_current_stream_capturing():  # never inside a graph capture
            signal.setitimer(signal.ITIMER_REAL, 0.05)
            return
        self.torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.after = self.counters()
        t = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.stop_s = time.perf_counter() - t
        self.stopped = True

    def run(self, fn):
        previous = signal.signal(signal.SIGALRM, self.stop)
        signal.siginterrupt(signal.SIGALRM, False)
        self.start()
        signal.setitimer(signal.ITIMER_REAL, self.limit_s)
        try:
            return fn()
        finally:
            signal.setitimer(signal.ITIMER_REAL, 0)
            self.stop()
            signal.signal(signal.SIGALRM, previous)


def kernel_id(name: str) -> str:
    """A kernel's identifier in the profiler's demangled name: ``void
    (anonymous namespace)::f<float, true>(float const*, int)`` -> ``f``."""
    base = name.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0].split()
    return base[-1].split("::")[-1] if base else name


def fused_mask(ids, streams, starts, names, fused_names, vote_names) -> np.ndarray:
    """Which device activities are the fused warp+vote library's: a kernel
    that only ``fused_names`` holds, and a kernel that both libraries
    define (the fixed-point conversion) when the last kernel of
    neither's own before it on its stream is the fused library's (after a
    vote kernel it is K8's).  ``ids`` index ``names`` (kernel identifiers,
    or None for copies and fills); ``streams`` and ``starts`` per
    activity."""
    fused, vote = set(fused_names), set(vote_names)
    own = np.array([n in fused and n not in vote for n in names], dtype=bool)
    shared = np.array([n in fused and n in vote for n in names], dtype=bool)
    anchor_name = np.array([n is not None and not (n in fused and n in vote) for n in names], dtype=bool)
    ids, streams = np.asarray(ids, dtype=np.int64), np.asarray(streams, dtype=np.int64)
    mask = own[ids] if len(ids) else np.zeros(0, dtype=bool)
    if not shared.any() or not len(ids):
        return mask
    order = np.lexsort((np.asarray(starts, dtype=np.int64), streams))
    sid, sstream = ids[order], streams[order]
    pos = np.arange(len(order))
    last = np.maximum.accumulate(np.where(anchor_name[sid], pos, -1))
    ok = (last >= 0) & (sstream[np.maximum(last, 0)] == sstream)
    owner_fused = ok & own[sid[np.maximum(last, 0)]]
    mask[order[shared[sid] & owner_fused]] = True
    return mask


def trace_call(fn, span: str, fused_names, vote_names, counters, limit_s: float):
    """Run ``fn()`` traced (the trace stops after ``limit_s`` seconds if the
    call lasts longer); return (its result, the slice): ``window_s``,
    ``busy_s``, ``whole`` (the slice is the whole call), ``launches`` (the
    counters' increase over the slice), ``kernels`` (device kernels),
    ``fused_s`` (device seconds of the fused library's kernels,
    ``fused_mask``: ``fused_names`` are its kernels, ``vote_names`` K8's),
    ``device_ops`` (top kernels by device seconds) and ``idle_gaps`` (idle
    seconds by launching call, top first)."""
    sliced = _Slice(counters, limit_s)
    result = sliced.run(fn)
    whole = sliced.after == sliced.counters()
    t_reduce = time.perf_counter()
    cuda = sliced.torch.autograd.DeviceType.CUDA
    dev_start, dev_end, dev_corr = array("q"), array("q"), array("q")
    dev_id, dev_stream = array("q"), array("q")
    by_name = {}  # name -> [activities, ns]
    ids = {}  # name -> index into names
    names = []  # kernel identifier per name, None for copies and fills
    runtime = {}
    for e in sliced.prof.kineto_results.events():
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == cuda:
            name = e.name()
            dev_start.append(start)
            dev_end.append(start + dur)
            dev_corr.append(e.linked_correlation_id() or e.correlation_id())
            dev_stream.append(e.device_resource_id())
            k = ids.get(name)
            if k is None:
                k = ids[name] = len(names)
                names.append(None if name.startswith(NOT_KERNELS) else kernel_id(name))
            dev_id.append(k)
            entry = by_name.setdefault(name, [0, 0])
            entry[0] += 1
            entry[1] += dur
        elif e.correlation_id():
            runtime[e.correlation_id()] = e.name()
    kernels = {n: v for n, v in by_name.items() if not n.startswith(NOT_KERNELS)}
    durations = np.asarray(dev_end, dtype=np.int64) - np.asarray(dev_start, dtype=np.int64)
    fused = fused_mask(dev_id, dev_stream, dev_start, names, fused_names, vote_names)
    out = {"window_s": sliced.window_s, "busy_s": 0.0, "whole": whole,
           "launches": {k: sliced.after[k] - sliced.before[k] for k in sliced.after},
           "kernels": sum(v[0] for v in kernels.values()), "fused_s": float(durations[fused].sum()) * 1e-9,
           "device_ops": [[n, v[1] * 1e-9] for n, v in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP]],
           "idle_gaps": [], "activities": len(dev_start), "stop_s": sliced.stop_s}
    if dev_start:
        starts, ends = np.asarray(dev_start, dtype=np.int64), np.asarray(dev_end, dtype=np.int64)
        m_start, m_end, opener = _union(starts, ends)
        out["busy_s"] = float((m_end - m_start).sum()) * 1e-9
        gap = m_start[1:] - m_end[:-1]
        gaps = {}
        for k in np.flatnonzero(gap > 0):
            label = f"{span}: {runtime.get(dev_corr[opener[k + 1]], 'no launch recorded')}"
            gaps[label] = gaps.get(label, 0) + int(gap[k])
        out["idle_gaps"] = [[n, ns * 1e-9] for n, ns in sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]]
    out["reduce_s"] = time.perf_counter() - t_reduce
    return result, out


def fused_launches(launches: dict) -> int:
    """Launches of the fused warp+vote forms in a counter dict (every key
    but K8's ``vote``)."""
    return sum(n for k, n in launches.items() if k != "vote")


def call_share(sliced: dict) -> float:
    """The slice's share of its call, by fused launches (1 for a whole
    call)."""
    if sliced["whole"]:
        return 1.0
    total = sum(fused_launches(per_scale) for per_scale in sliced["stats"]["launches"].values())
    return fused_launches(sliced["launches"]) / total if total else 0.0
