"""Bytes per solved frame that the port copies from the host to the
device: events (``FrameEvents.from_numpy``), flows, GT and the init
sweeps' patch batches (``SolverBase.tensor`` of a host array); the
``h2d_bytes`` counter over the traced call's frames."""

from benchmark import spans


def read(run):
    return spans.per_frame(run, lambda _, c: c.get("h2d_bytes"))
