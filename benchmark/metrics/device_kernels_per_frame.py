"""Device kernels per frame in the traced slice (copies and fills not
counted): the profiler's kernel count over the frames the slice covers
(the call's frames times the slice's share of the call's fused launches,
``profiling.call_share``)."""

from benchmark import profiling


def read(run):
    trace = run.get("trace")
    if not trace or not trace["kernels"]:
        return None
    frames = trace["frames"] * profiling.call_share(trace)
    return trace["kernels"] / frames if frames > 0 else None
