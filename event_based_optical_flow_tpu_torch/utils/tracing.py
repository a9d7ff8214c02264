"""The port's spans and counters, and its one host-read helper.

``span(name, **attrs)`` marks a stretch of host work (a context manager);
``count(name, n)`` adds to a counter.  Both record only while a
``torch.profiler`` records (``torch.autograd.profiler._is_profiler_enabled``);
otherwise ``span`` returns one shared no-op context and ``count`` returns
at once, so an untraced run pays one global lookup per site.  A span's
start and end are ``time.time_ns()``, the epoch clock on which kineto
stamps the profiler's events, so a span and the device activity it
launched sit on one clock.  Each record holds the index of the span that
encloses it (in the same thread; -1 for none) and the eval-loop frame it
serves: a span opened with ``frame=<i>`` (the eval loop's frame, or a
fleet batch's first frame) gives its id to every span inside it.

``spans()`` and ``counters()`` read the in-memory store; ``drain()`` reads
it and clears it.  ``write_chrome`` writes spans as Chrome trace events
beside a profiler trace, in its time base (``SolverBase.profiled_optimize``
does so under ``output.trace_dir``); ``merge_chrome`` joins the two files
into one for Perfetto.

``read(t, site)`` is every host read of a device value on the eval path:
it returns ``t`` on the CPU (a dict of tensors: each), inside the span
``read.<site>``, counts the bytes it copies (``d2h_bytes``), and counts
one host sync at the sites in ``SYNC_SITES``: the Newton loops'
conditions, a scale's best loss, an init sweep's pick and each host
optimizer's reads.  ``synced()`` is this thread's running count of them;
a solver's ``syncs`` is its difference over a solve or a frame.
"""

import functools
import json
import os
import re
import threading
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler

# the read sites that count a host sync (a solver's ``syncs``)
SYNC_SITES = frozenset({"cg", "cg_flags", "line_search", "escape", "trigger", "done", "scale_loss", "sweep",
                        "host_opt"})
# the read sites that do not: the frame's preparation, its metrics and its
# outputs, and the solvers' results and visualizations
OTHER_SITES = frozenset({"shard_heads", "metrics", "checkpoint", "flow_dump", "solution", "start", "voxel",
                         "viz"})

_store: List["Span"] = []
_counters: Dict[str, int] = {}
_lock = threading.Lock()
_local = threading.local()


def recording() -> bool:
    """Whether a ``torch.profiler`` records now (so spans and counters do)."""
    return _profiler._is_profiler_enabled


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One span: ``name``, ``start`` / ``end`` (``time.time_ns()``),
    ``frame`` (the eval-loop frame it serves, or None), ``attrs``.  It
    always times itself (``seconds``); it is recorded in the store, with
    its enclosing span, only where ``record`` is true."""

    __slots__ = ("name", "attrs", "frame", "start", "end", "parent", "record")

    def __init__(self, name: str, attrs: dict, record: bool):
        self.name, self.attrs, self.record = name, attrs, record
        self.frame = attrs.pop("frame", None)
        self.parent: Optional[Span] = None
        self.start = self.end = 0

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9

    def __enter__(self) -> "Span":
        if self.record:
            stack = _stack()
            if stack:
                self.parent = stack[-1]
                if self.frame is None:
                    self.frame = self.parent.frame
            stack.append(self)
            with _lock:
                _store.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.time_ns()
        if self.record:
            _stack().pop()
        return False


class _NullSpan:
    """The shared context ``span`` returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _NullSpan()


def span(name: str, **attrs):
    """A span of host work named ``name`` (``frame=<i>``: the eval-loop
    frame it and the spans inside it serve); a no-op unless a profiler
    records."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return Span(name, attrs, True)


def traced(name: str) -> Callable:
    """A function (a method) that runs inside the span ``name``."""

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def inside(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inside

    return wrap


def timed(name: str, **attrs) -> Span:
    """A span that times itself whether or not a profiler records (read
    its ``seconds`` after the block); recorded as ``span`` records."""
    return Span(name, attrs, _profiler._is_profiler_enabled)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name``; a no-op unless a profiler
    records."""
    if not _profiler._is_profiler_enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + int(n)


def _as_records(spans: List[Span]) -> List[dict]:
    index = {id(s): i for i, s in enumerate(spans)}
    return [{"name": s.name, "start_ns": s.start, "end_ns": s.end,
             "parent": index.get(id(s.parent), -1) if s.parent is not None else -1,
             "frame": s.frame, "attrs": dict(s.attrs)} for s in spans]


def spans() -> List[dict]:
    """The recorded spans, in the order they opened: ``name``,
    ``start_ns``, ``end_ns`` (0 while open), ``parent`` (the index in this
    list of the enclosing span, -1 for none), ``frame``, ``attrs``."""
    with _lock:
        held = list(_store)
    return _as_records(held)


def counters() -> Dict[str, int]:
    with _lock:
        return dict(_counters)


def drain():
    """(``spans()``, ``counters()``), and the store emptied."""
    with _lock:
        held, counts = list(_store), dict(_counters)
        _store.clear()
        _counters.clear()
    return _as_records(held), counts


# --- the host-read helper ---------------------------------------------------------------------------------------

_READ_NAMES = {site: f"read.{site}" for site in SYNC_SITES | OTHER_SITES}


def synced() -> int:
    """This thread's count of host syncs so far (reads at ``SYNC_SITES``)."""
    return getattr(_local, "synced", 0)


def _to_host(t):
    if torch.is_tensor(t):
        return t.detach().cpu()
    if isinstance(t, dict):
        return {k: _to_host(v) for k, v in t.items()}
    return t


def device_bytes(t) -> int:
    """The bytes of ``t`` (a tensor, or a dict of them) that lie on a
    device: what a copy of it between the host and the device moves."""
    if torch.is_tensor(t):
        return t.numel() * t.element_size() if t.device.type != "cpu" else 0
    if isinstance(t, dict):
        return sum(device_bytes(v) for v in t.values())
    return 0


def read(t, site: str):
    """``t`` (a tensor, or a dict of them; anything else passes through)
    on the CPU: the host waits for the device there.  Counts one host sync
    at a site in ``SYNC_SITES``."""
    if site in SYNC_SITES:
        _local.synced = getattr(_local, "synced", 0) + 1
    elif site not in OTHER_SITES:
        raise ValueError(f"unknown host-read site {site!r}")
    if not _profiler._is_profiler_enabled:
        return _to_host(t)
    with Span(_READ_NAMES[site], {}, True):
        host = _to_host(t)
    count("d2h_bytes", device_bytes(t))
    return host


# --- Chrome trace events ----------------------------------------------------------------------------------------

_BASE = re.compile(rb'"baseTimeNanoseconds"\s*:\s*(\d+)')


def trace_base_ns(trace_path: str) -> int:
    """The ``baseTimeNanoseconds`` of a kineto Chrome trace (its ``ts``
    are microseconds from it), read from the file's head; 0 where it has
    none (``ts`` from the epoch)."""
    with open(trace_path, "rb") as f:
        m = _BASE.search(f.read(1 << 16))
    return int(m.group(1)) if m else 0


def write_chrome(path: str, records: List[dict], base_ns: int, counts: dict) -> None:
    """A Chrome trace file of ``records`` (``spans()``'s) as "X" events,
    ``ts`` and ``dur`` in microseconds from ``base_ns``, on a row of their
    own (``spans <thread id>``) of this process beside the thread's
    profiler rows, and ``counts`` as its ``counters`` entry."""
    pid, tid = os.getpid(), f"spans {threading.get_native_id()}"
    events = [{"ph": "X", "cat": "span", "name": r["name"], "pid": pid, "tid": tid,
               "ts": (r["start_ns"] - base_ns) / 1e3, "dur": (r["end_ns"] - r["start_ns"]) / 1e3,
               "args": dict(r["attrs"], frame=r["frame"], parent=r["parent"])} for r in records if r["end_ns"]]
    with open(path, "w") as f:
        json.dump({"displayTimeUnit": "ms", "baseTimeNanoseconds": base_ns, "counters": counts,
                   "traceEvents": events}, f)


def merge_chrome(trace_path: str, spans_path: str, out_path: str) -> None:
    """One Chrome trace of a profiler trace and the spans file written
    beside it (both in the profiler trace's time base)."""
    with open(trace_path) as f:
        trace = json.load(f)
    with open(spans_path) as f:
        trace["traceEvents"] += json.load(f)["traceEvents"]
    with open(out_path, "w") as f:
        json.dump(trace, f)


if __name__ == "__main__":
    import sys

    if len(sys.argv) != 4:
        sys.exit("usage: python -m event_based_optical_flow_tpu_torch.utils.tracing TRACE.pt.trace.json "
                 "TRACE.spans.json OUT.json")
    merge_chrome(*sys.argv[1:])
