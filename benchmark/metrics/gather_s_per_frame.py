"""Host seconds per solved frame in the eval loop's gather
(``eval_loop.gather``: the loader's window, the fixed-count batch and the
GT flow of each frame), over the traced call's frames."""

from benchmark import spans


def read(run):
    return spans.per_frame(run, lambda s, _: spans.seconds(s, spans.named("eval_loop.gather")))
