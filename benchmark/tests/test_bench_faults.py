"""A run of each cell at a tiny size on the CPU, past the harness's look
for a card, with the timed path broken underneath: ``correct`` must come
out false for every fault the cell can have, and true with none.

The faults are ``faults.NAMES``: a Newton step that returns its state
unchanged (the init sweeps kept, or returning their start too); half of
the batch left out (every second event of each window, and for the fleet
half of its frames); an answer altered where it is produced (the returned
motion, and the AEE the eval loop reports).  One
card runs each cell: there is no exchange between chips to leave out."""

import json

import pytest
import torch

from benchmark import faults, harness

CASES = [(w, f) for w in ("mvsec-fleet-b8", "dsec-seq") for f in ("none",) + faults.NAMES
         if not (f == "half_frames" and w == "dsec-seq")]  # one frame per call: no half to leave out


def run_tiny(workload, tiny, capsys, seed=2**31 + 3):
    rc = harness.main(["--workload", workload, "--seed", str(seed), "--seconds", "0", "--trace", "0"],
                      device="cpu", require_cuda=False, cell=tiny(workload))
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    return json.loads(out.out.strip().splitlines()[-1]), out.err


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_makes_the_run_incorrect(workload, fault, tiny, capsys, monkeypatch):
    torch.manual_seed(0)
    if fault != "none":
        faults.plant(fault, monkeypatch.setattr)
    result, err = run_tiny(workload, tiny, capsys)
    assert result["correct"] is (fault == "none"), (fault, result["checks"])
    assert err.strip().splitlines()[-1].startswith("check failed_frames")
    assert list(result)[-1] == "checks"
