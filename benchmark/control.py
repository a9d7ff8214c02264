#!/usr/bin/env python3
"""The readings that a reference's limits (``LIMITS`` of the module that
the cell's configuration names, ``reference/plain.py`` by default) are set
from, on the card, at a cell's own size (the benchmark's runs do not run
this):

    python benchmark/control.py --workload <cell> --seeds 1 2 3 --seconds <s> [--fault NAME]

For each seed, one process-local run of the cell (set-up, a window of
``--seconds``), then the compared numbers of the program's answers and of
the control's: the reference in the program's place, computed with TF32
products (``plain.round_tf32``), the step below the configuration's
float32 with TF32 off.  ``--fault`` plants one of ``faults.NAMES`` under
the timed path first and prints the program's numbers.  One JSON line per
seed and kind on standard output, with each frame's descent gain."""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from benchmark import cells, faults, harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--fault", choices=faults.NAMES)
    args = p.parse_args(argv)
    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 3
    workload = cells.find(cells.load_manifest()["workloads"], args.workload, "workload")
    config, traffic = cells.load_json("configs", workload["config"]), cells.load_json("traffic", workload["traffic"])
    reference = cells.reference(config)
    device = torch.device("cuda")
    if args.fault:
        faults.plant(args.fault, faults.Patcher().setattr)
    for seed in args.seeds:
        measured = harness.measure(config, traffic, seed, device, args.seconds, False, time.perf_counter())
        kinds = [(args.fault or "program", False)] + ([] if args.fault else [("control_tf32", True)])
        for kind, tf32 in kinds:
            ref, values, failed = harness.judge(measured, device, reference, tf32=tf32)
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": kind,
                              "frames": len(measured["answers"]), "failed_frames": failed, **values,
                              "gains": [r[3] for r in ref]}), flush=True)
        del measured
    return 0


if __name__ == "__main__":
    sys.exit(main())
