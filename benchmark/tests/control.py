#!/usr/bin/env python3
"""The control of a cell on the card at the cell's own size: the plain
reference, computed in float32, put in the program's place, and held to
the float64 reference as a run holds the program.  Its compared numbers
set the upper end of each limit (PERF.md).  Not one of the benchmark's
runs.

    python3 benchmark/tests/control.py --workload <name> --seed <n>
                                       --seconds <s> --trace 0
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import run  # noqa: E402

if __name__ == "__main__":
    sys.exit(run.main(control=np.float32))
