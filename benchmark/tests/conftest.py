"""Tiny copies of the benchmark's cells for CPU tests: the same files and
traffic, cut to a 64 x 96 sensor and a few thousand events per window with
the configuration's iteration budgets, small enough to solve in a minute
or two on the CPU and large enough that a sound solve reads an
``aee_share`` of ~0.4 and a ``descent_gain`` under its limit."""

import copy

import pytest

from benchmark import cells

# one set of directions for both cells: with DSEC's own, the tiny DSEC cell
# stalls at its zero start (aee_share ~1.05), with these it reads ~0.35
TINY_SCENE = {"height": 64, "width": 96, "n_dots": 80, "speeds": [40.0, 35.0, 45.0, 30.0],
              "angles_deg": [-142.1, 91.8, 41.5, 148.5], "sequence_frames": 12}
TINY_EVENTS = {"mvsec-indoor-flying": (32000.0, 3000), "dsec-zurich-city": (40000.0, 3500)}


def tiny_cell(workload: str):
    """(config, traffic) of ``workload`` at the tiny size."""
    entry = cells.find(cells.load_manifest()["workloads"], workload, "workload")
    config = copy.deepcopy(cells.load_json("configs", entry["config"]))
    traffic = copy.deepcopy(cells.load_json("traffic", entry["traffic"]))
    rate, n_events = TINY_EVENTS[entry["config"]]
    config["scene"].update(TINY_SCENE, event_rate=rate)
    port = config["port"]
    port["data"].update(height=64, width=96, n_events_per_batch=n_events)
    port["solver"]["patch"].update(scale=3, crop_height=64, crop_width=96)
    port["optimizer"]["parameters"] = {k: {"min": -50, "max": 50} for k in ("trans_x", "trans_y")}
    if "data.fleet_batch" in traffic["port"]:
        traffic["port"]["data.fleet_batch"] = 2
    return config, traffic


@pytest.fixture
def tiny():
    return tiny_cell
