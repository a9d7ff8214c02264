"""Host seconds per solved frame in the solver's frame preparation
(``solver.prep``: the events sorted and uploaded, ``FrameEvents`` /
``FleetEvents``, the coarse subsample, the orig IWE, the copies into the
chain's staged buffers), over the traced call's frames."""

from benchmark import spans


def read(run):
    return spans.per_frame(run, lambda s, _: spans.seconds(s, spans.named("solver.prep")))
