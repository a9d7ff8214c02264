"""Fused warp+vote launches per solved frame: the launch counters of the
``fused_iwe`` forms (``profiling.fused_launches``: every key of the
solver's ``launches`` but K8's ``vote``; a replayed CUDA graph adds its
launches) summed over the scales and the window's calls, over the
window's frames."""

from benchmark import profiling


def read(run):
    if not run["frames"]:
        return None
    total = sum(profiling.fused_launches(launches) for c in run["calls"] for launches in c["stats"]["launches"].values())
    return total / run["frames"]
