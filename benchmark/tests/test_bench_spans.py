"""The span and counter readers on a hand-made store: each reads the
outermost spans of its kind over the traced call's frames, the Newton
host seconds less the reads and graph replays inside them, and none
reads a slice that is not the whole call or a port without a recorder."""

import pytest

from benchmark import cells, spans

READERS = ("gather_s_per_frame", "metrics_s_per_frame", "frame_prep_s_per_frame", "host_read_wait_s_per_frame",
           "newton_host_s_per_frame", "h2d_bytes_per_frame")


def _span(name, start_s, end_s, parent=-1, frame=0):
    return {"name": name, "start_ns": int(start_s * 1e9), "end_ns": int(end_s * 1e9), "parent": parent,
            "frame": frame, "attrs": {}}


# one fleet call of 2 frames, seconds on one clock
STORE = [
    _span("eval_loop.frame", 0.0, 10.0),                  # 0
    _span("eval_loop.gather", 0.0, 0.5, 0),               # 1
    _span("eval_loop.gather", 0.5, 1.0, 0),               # 2
    _span("eval_loop.solve", 1.0, 8.0, 0),                # 3
    _span("solver.prep", 1.0, 2.0, 3),                    # 4
    _span("solver.scale", 2.0, 8.0, 3),                   # 5
    _span("newton.solve", 2.5, 7.5, 5),                   # 6
    _span("newton.cg", 3.0, 5.0, 6),                      # 7
    _span("graphs.replay", 3.0, 3.5, 7),                  # 8
    _span("read.cg", 3.5, 4.0, 7),                        # 9
    _span("newton.line_search", 5.0, 7.0, 6),             # 10
    _span("graphs.replay", 5.0, 6.0, 10),                 # 11
    _span("read.line_search", 6.0, 6.25, 10),             # 12
    _span("read.scale_loss", 7.5, 7.75, 5),               # 13
    _span("eval_loop.metrics", 8.0, 8.5, 0),              # 14
    _span("read.metrics", 8.25, 8.5, 14),                 # 15
    _span("eval_loop.metrics", 8.5, 9.0, 0),              # 16
    _span("eval_loop.write", 9.0, 10.0, 0),               # 17
]
COUNTERS = {"h2d_bytes": 1000, "d2h_bytes": 64}
RUN = {"frames": 2, "calls": [], "trace": {"whole": True, "frames": 2}}
WANT = {"gather_s_per_frame": 0.5, "metrics_s_per_frame": 0.5, "frame_prep_s_per_frame": 0.5,
        "host_read_wait_s_per_frame": (0.5 + 0.25 + 0.25 + 0.25) / 2,
        # newton 5 s, less replays 0.5 + 1.0 and reads 0.5 + 0.25
        "newton_host_s_per_frame": (5.0 - 1.5 - 0.75) / 2, "h2d_bytes_per_frame": 500.0}


@pytest.fixture
def hand_made(monkeypatch):
    monkeypatch.setattr(spans, "store", lambda: (STORE, COUNTERS))


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_hand_made_store(hand_made, name):
    assert cells.metric_reader(name)(RUN) == pytest.approx(WANT[name], rel=1e-9)


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_of_a_partial_slice_or_a_port_without_a_recorder(monkeypatch, name):
    reader = cells.metric_reader(name)
    monkeypatch.setattr(spans, "store", lambda: (STORE, COUNTERS))
    assert reader({**RUN, "trace": {"whole": False, "frames": 2}}) is None
    assert reader({**RUN, "trace": None}) is None
    monkeypatch.setattr(spans, "store", lambda: ([], {}))
    assert reader(RUN) is None
    monkeypatch.setattr(spans, "store", lambda: None)
    assert reader(RUN) is None


def test_nested_spans_of_one_kind_count_once():
    nested = [_span("read.cg", 0.0, 1.0), _span("read.cg", 0.2, 0.4, 0), _span("read.done", 2.0, 2.5)]
    assert spans.seconds(nested, spans.prefixed("read.")) == pytest.approx(1.5)
