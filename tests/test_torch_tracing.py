"""The port's spans and counters (``utils/tracing.py``) around its eval
loops, on a 64 x 96 synthetic scene on the CPU:

* recording changes no bit: a sequential call and a fleet batch of 2 give
  the same motions, per-scale losses and host syncs inside a profiler and
  outside one, and outside one the store stays empty;
* every span closes inside its parent and carries its frame's id, and the
  gather, solve, metrics and write spans cover a frame;
* the spans share the profiler's clock: the metrics' ops fall inside
  ``eval_loop.metrics``, none inside ``eval_loop.solve``;
* the ``read.*`` spans at the sync sites number the solver's ``syncs``;
* ``output.trace_dir`` writes the spans beside the profiler trace, in its
  time base, and drains the store.
"""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from event_based_optical_flow_tpu_torch import main as port_main
from event_based_optical_flow_tpu_torch.utils import profile_section, tracing

LOOP_SPANS = ("eval_loop.gather", "eval_loop.solve", "eval_loop.metrics", "eval_loop.write")


def _config(out_dir, fleet: bool) -> dict:
    config = {
        "is_dnn": False,
        "data": {
            "eval_dt": 1, "root": "", "dataset": "synthetic", "sequence": "tiny", "height": 64, "width": 96,
            "load_gt_flow": True, "gt": ".", "n_events_per_batch": 3000, "duration": 0.5, "event_rate": 12000,
            "n_frames": 3, "visualize_every": 0, "pattern": "dots", "n_dots": 80,
        },
        "output": {"output_dir": str(out_dir), "show_interactive_result": False},
        "solver": {
            "method": "pyramidal_patch_contrast_maximization", "time_aware": False,
            "patch": {"initialize": "random", "scale": 3, "crop_height": 64, "crop_width": 96,
                      "filter_type": "bilinear"},
            "motion_model": "2d-translation", "warp_direction": "first", "parameters": ["trans_x", "trans_y"],
            "cost": "hybrid", "outer_padding": 0,
            "cost_with_weight": {"multi_focal_normalized_gradient_magnitude": 1.0, "total_variation": 0.01},
            "iwe": {"method": "bilinear_vote", "blur_sigma": 1}, "precision": "64",
        },
        "optimizer": {
            "n_iter": 8, "method": "Newton-CG", "max_iter": 2, "cg_maxiter": 3,
            "parameters": {"trans_x": {"min": -20, "max": 20}, "trans_y": {"min": -20, "max": 20}},
        },
    }
    if fleet:
        config["data"].update(fleet_batch=2, warm_start=False)
        config["solver"]["method"] = "fleet_pyramidal_patch_contrast_maximization"
    return config


def _eval(out_dir, fleet: bool, profiled: bool) -> dict:
    """One call of the eval loop (two frames, or one fleet batch of two),
    traced or not: the finest motions, the records, the drained spans and
    counters, and the profiler."""
    config = _config(out_dir, fleet)
    loader, solv = port_main.build(config, torch.device("cpu"))
    name = "optimize_batch" if fleet else "optimize"
    solve, motions = getattr(solv, name), []

    def kept(events):
        result = solve(events)
        motions.extend(r[max(r)].clone() for r in (result if fleet else [result]))
        return result

    setattr(solv, name, kept)
    ts = loader.eval_frame_time_list()[:3]
    tracing.drain()

    def call():
        if fleet:
            return port_main.evaluate_dataset_fleet(ts, config["data"], loader, solv, str(out_dir), 2)
        return port_main.evaluate_dataset_with_gt(ts, config["data"], loader, solv, str(out_dir))

    prof = None
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            records = call()
    else:
        records = call()
    spans, counters = tracing.drain()
    return {"motions": motions, "records": records, "spans": spans, "counters": counters, "prof": prof}


@pytest.fixture(scope="module", params=["seq", "fleet"])
def runs(request, tmp_path_factory):
    fleet = request.param == "fleet"
    torch.set_num_threads(2)
    plain = _eval(tmp_path_factory.mktemp("plain"), fleet, profiled=False)
    traced = _eval(tmp_path_factory.mktemp("traced"), fleet, profiled=True)
    return {"fleet": fleet, "plain": plain, "traced": traced}


def test_recording_changes_no_bit_and_off_records_nothing(runs):
    plain, traced = runs["plain"], runs["traced"]
    assert plain["spans"] == [] and plain["counters"] == {}
    assert len(plain["motions"]) == len(traced["motions"]) == 2
    for a, b in zip(plain["motions"], traced["motions"]):
        assert torch.equal(a, b)
    for a, b in zip(plain["records"], traced["records"]):
        assert a["stats"]["loss"] == b["stats"]["loss"] and a["stats"]["syncs"] == b["stats"]["syncs"] > 0
        assert a["metrics"] == b["metrics"]


def test_spans_close_nest_and_carry_their_frame(runs):
    spans = runs["traced"]["spans"]
    frames = [s for s in spans if s["name"] == "eval_loop.frame"]
    assert [s["frame"] for s in frames] == ([0] if runs["fleet"] else [0, 1])
    for s in spans:
        assert 0 < s["start_ns"] <= s["end_ns"], s["name"]
        if s["parent"] >= 0:
            p = spans[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"], (s["name"], p["name"])
            assert s["frame"] == p["frame"], s["name"]
        else:
            assert s["name"] == "eval_loop.frame", s["name"]
    names = {s["name"] for s in spans}
    assert set(LOOP_SPANS) | {"solver.prep", "solver.scale", "solver.init", "newton.solve", "newton.cg",
                              "newton.line_search", "read.scale_loss", "read.metrics", "read.done"} <= names
    for i, f in enumerate(spans):
        if f["name"] != "eval_loop.frame":
            continue
        inside = sum(s["end_ns"] - s["start_ns"] for s in spans if s["parent"] == i and s["name"] in LOOP_SPANS)
        assert inside >= 0.95 * (f["end_ns"] - f["start_ns"])


def test_profiler_ops_sort_into_the_spans_that_issued_them(runs):
    spans = runs["traced"]["spans"]
    within = {name: [(s["start_ns"], s["end_ns"]) for s in spans if s["name"] == name]
              for name in ("eval_loop.metrics", "eval_loop.solve")}
    ops = [e.start_ns() for e in runs["traced"]["prof"].profiler.kineto_results.events() if e.name() == "aten::acos"]
    # the AE metric's arccos, one per frame
    assert len(ops) >= 2
    for t in ops:
        assert any(a <= t <= b for a, b in within["eval_loop.metrics"])
        assert not any(a <= t <= b for a, b in within["eval_loop.solve"])


def test_sync_site_reads_number_the_solver_syncs(runs):
    spans = runs["traced"]["spans"]
    for frame_id, record in {r["frame"]: r for r in runs["traced"]["records"]}.items():
        if runs["fleet"] and frame_id != 0:
            continue
        reads = [s for s in spans if s["frame"] == frame_id and s["name"].startswith("read.")
                 and s["name"][len("read."):] in tracing.SYNC_SITES]
        assert len(reads) == record["stats"]["syncs"], frame_id


def test_trace_dir_writes_spans_in_the_profiler_trace_time_base(tmp_path):
    config = _config(tmp_path / "out", fleet=False)
    config["output"]["trace_dir"] = str(tmp_path / "trace")
    loader, solv = port_main.build(config, torch.device("cpu"))
    events = port_main._gather_frame(loader, config["data"], *loader.eval_frame_time_list()[:2])[0]
    tracing.drain()
    solv.profiled_optimize(events)
    assert tracing.spans() == [] and tracing.counters() == {}
    (trace,) = (tmp_path / "trace").glob("*.pt.trace.json")
    spans_path = trace.parent / trace.name.replace(".pt.trace.json", ".spans.json")
    with open(trace) as f:
        kineto = json.load(f)
    with open(spans_path) as f:
        written = json.load(f)
    assert written["baseTimeNanoseconds"] == kineto.get("baseTimeNanoseconds", 0)
    events = written["traceEvents"]
    assert events and all(e["ph"] == "X" for e in events)
    assert {"newton.solve", "solver.prep", "read.scale_loss"} <= {e["name"] for e in events}
    ops = [e for e in kineto["traceEvents"] if e.get("ph") == "X" and str(e.get("name", "")).startswith("aten::")]
    lo, hi = min(e["ts"] for e in ops), max(e["ts"] + e.get("dur", 0) for e in ops)
    solves = [e for e in events if e["name"] == "newton.solve"]
    # the profiler's ops and the spans share one time base: every Newton
    # solve lies among the solve's ops
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in solves)
    merged = tmp_path / "merged.json"
    tracing.merge_chrome(str(trace), str(spans_path), str(merged))
    with open(merged) as f:
        assert len(json.load(f)["traceEvents"]) == len(kineto["traceEvents"]) + len(events)


def test_spans_and_counters_record_only_under_a_profiler():
    tracing.drain()
    with tracing.span("outer", frame=3):
        with tracing.span("inner"):
            tracing.count("bytes", 5)
    assert tracing.spans() == [] and tracing.counters() == {}
    timings = {}
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("outer", frame=3, kind="x"):
            with profile_section("inner", timings):
                tracing.count("bytes", 5)
                tracing.count("bytes", 2)
        host = tracing.read(torch.ones(3), "metrics")
    spans, counters = tracing.drain()
    assert [(s["name"], s["parent"], s["frame"]) for s in spans] == [("outer", -1, 3), ("inner", 0, 3),
                                                                     ("read.metrics", -1, None)]
    assert spans[0]["attrs"] == {"kind": "x"} and counters == {"bytes": 7, "d2h_bytes": 0}
    assert len(timings["inner"]) == 1 and timings["inner"][0] == pytest.approx(
        (spans[1]["end_ns"] - spans[1]["start_ns"]) * 1e-9)
    np.testing.assert_array_equal(host.numpy(), np.ones(3))
    before = tracing.synced()
    tracing.read(torch.ones(()), "done")
    tracing.read(torch.ones(()), "checkpoint")
    assert tracing.synced() == before + 1
    with pytest.raises(ValueError, match="unknown host-read site"):
        tracing.read(torch.ones(()), "nowhere")
