#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on the card:

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the compared numbers beside their
limits as the last lines of standard error and the result as one JSON
object on the last line of standard output; exits nonzero, with no result,
without the CUDA devices the cell asks for.  See ``harness.py``."""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root, not this folder, leads the import path
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
