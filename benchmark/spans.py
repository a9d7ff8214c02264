"""The port's spans and counters of the traced call, for the per-layer
readers: ``event_based_optical_flow_tpu_torch.utils.tracing`` records them
only while a profiler records, so after the window its store holds the
traced call's alone.  A port without that recorder gives no reading
(``store`` is None), nor does a slice that is not the whole call.

Spans nest (``parent``: the index of the enclosing span); a quantity sums
the outermost spans of a kind, so a span inside another of its kind is
counted once."""


def store():
    """(spans, counters) of the port's recorder, or None without one."""
    try:
        from event_based_optical_flow_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing.spans(), tracing.counters()


def per_frame(run, quantity):
    """``quantity(spans, counters)`` over the traced call's frames; None
    unless the slice is the whole call and the quantity is found."""
    trace = run.get("trace")
    if not trace or not trace.get("whole") or not trace.get("frames"):
        return None
    found = store()
    if found is None:
        return None
    value = quantity(*found)
    return None if value is None else value / trace["frames"]


def _under(spans, kind) -> list:
    """Per span: whether an enclosing span is of ``kind`` (a predicate of
    its name)."""
    under = []
    for s in spans:
        p = s["parent"]
        under.append(p >= 0 and (kind(spans[p]["name"]) or under[p]))
    return under


def _seconds(s) -> float:
    return (s["end_ns"] - s["start_ns"]) * 1e-9


def seconds(spans, kind):
    """Seconds inside the outermost spans of ``kind``; None where there
    are none."""
    under = _under(spans, kind)
    found = [_seconds(s) for s, u in zip(spans, under) if kind(s["name"]) and not u]
    return sum(found) if found else None


def uncovered_seconds(spans, outer, cover):
    """Seconds inside the outermost spans of ``outer`` that no span of
    ``cover`` inside them covers; None where there is no ``outer`` span."""
    total = seconds(spans, outer)
    if total is None:
        return None
    under_outer, under_cover = _under(spans, outer), _under(spans, cover)
    covered = sum(_seconds(s) for s, uo, uc in zip(spans, under_outer, under_cover)
                  if cover(s["name"]) and uo and not uc)
    return total - covered


def named(name: str):
    return lambda n: n == name


def prefixed(*prefixes: str):
    return lambda n: n.startswith(prefixes)
