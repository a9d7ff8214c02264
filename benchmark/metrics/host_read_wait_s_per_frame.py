"""Host seconds per solved frame inside the port's host reads (``read.*``:
the host blocked until the device has computed what it reads, and the
copy), over the traced call's frames."""

from benchmark import spans


def read(run):
    return spans.per_frame(run, lambda s, _: spans.seconds(s, spans.prefixed("read.")))
