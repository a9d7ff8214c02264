"""Host seconds per solved frame inside the device solvers (``newton.*``)
that no host read (``read.*``) or CUDA graph capture or replay
(``graphs.*``) covers: the host's own arithmetic and launches between
replays, over the traced call's frames."""

from benchmark import spans


def read(run):
    return spans.per_frame(run, lambda s, _: spans.uncovered_seconds(s, spans.prefixed("newton."),
                                                                      spans.prefixed("read.", "graphs.")))
