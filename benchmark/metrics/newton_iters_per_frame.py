"""Newton iterations per solved frame: the solver's ``iters`` counter
summed over the scales and the window's calls, over the window's frames
(a fleet batch iterates in lockstep, so its count serves its B frames)."""


def read(run):
    if not run["frames"]:
        return None
    return sum(sum(c["stats"]["iters"].values()) for c in run["calls"]) / run["frames"]
