"""The device's idle share of the traced slice, in %: 1 - (union of the
slice's CUDA activity) / (the slice's wall clock)."""


def read(run):
    trace = run.get("trace")
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
