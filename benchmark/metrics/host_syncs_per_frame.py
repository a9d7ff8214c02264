"""Host syncs per solved frame: the solver's ``syncs`` counter (one host
read of the device per Newton condition, and one per scale) summed over the
window's calls, over the window's frames (a fleet batch's count serves its
B frames)."""


def read(run):
    if not run["frames"]:
        return None
    return sum(c["stats"]["syncs"] for c in run["calls"]) / run["frames"]
