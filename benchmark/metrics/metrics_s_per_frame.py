"""Host seconds per solved frame in the eval loop's metrics
(``eval_loop.metrics``: AEE, the outlier rates, AE and the FWLs of each
frame, their upload and their one host read), over the traced call's
frames."""

from benchmark import spans


def read(run):
    return spans.per_frame(run, lambda s, _: spans.seconds(s, spans.named("eval_loop.metrics")))
