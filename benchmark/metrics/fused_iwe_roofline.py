"""The fused warp+vote kernels' share of their roofline in the traced
slice, in %: the least time one H100 needs for the fused calls launched in
the slice (``roofline.slice_seconds``) over the device time of the fused
library's kernels (``profiling.fused_mask``: those ``csrc/fused_iwe.cu``
and the headers it includes define, the conversion it shares with K8's
``vote.cu`` only where it follows a fused kernel)."""

from benchmark import roofline


def read(run):
    trace = run.get("trace")
    if not trace or trace["fused_s"] <= 0:
        return None
    least = roofline.slice_seconds(trace["stats"], trace["launches"], trace["image_shape"])
    if least <= 0:
        return None
    return 100.0 * least / trace["fused_s"]
