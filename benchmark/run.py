#!/usr/bin/env python3
"""Benchmark of gaml_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA GPU.  The
cell (a ``workloads`` entry of BENCHMARK.json) names its configuration
(``benchmark/configs/<config>.json``) and its traffic mix
(``benchmark/traffic/<traffic>.json``, whose ``driver`` is one of the
general drivers in ``benchmark/harness``); its per-layer metrics are read
by ``benchmark/metrics/<metric>.py``; the mix names its driver
(``benchmark/drivers/<driver>.py``) and the configuration its world maker
(``benchmark/worlds/<maker>.py``).  Set-up holds the program to the
configuration's ``host_threads``, makes the world from the seed under
TMPDIR, builds the program's kernels into the checkout
(``gaml_tpu_torch/_build``) on the first run there, warms up the cell's
shapes, and then the window measures for ``--seconds``.  With ``--trace
1`` the window runs under torch.profiler and the result carries the
per-layer metrics and a breakdown; with ``--trace 0`` the end-to-end
metrics.  After the window the program's outputs are held to the plain
reference (``benchmark/reference``); each number compared is printed
beside its limit on standard error and, last, in the result.  The last
line of standard output is the result, a JSON object.  Without a CUDA
device, with fewer devices than the cell asks for, or with a module of
jax, jaxlib, flax or gaml_tpu loaded, the run exits non-zero and prints
no result.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from harness import common  # noqa: E402

PROCESS_START = common.process_start()


def main(argv=None, device: str = "cuda", control=None, faults=None,
         cell=None):
    """One run.  For the tests of the comparison only: ``cell`` replaces
    the workload's (a smaller world); ``device`` "cpu" skips the look for
    a card and runs the program's CPU route;
    ``control`` (a numpy float type) puts the reference, computed in that
    precision, in the program's place before the comparison; ``faults``
    is called first, to break the timed path underneath."""
    import shutil
    import tempfile

    args = common.parse_args(argv)
    cell = cell or common.Cell(args.workload)
    # the configuration's host threads: the program's OpenMP pool and
    # torch's, set before either starts
    if cell.config.get("host_threads"):
        os.environ["OMP_NUM_THREADS"] = str(cell.config["host_threads"])
    if device == "cuda":
        import torch

        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell.chips:
            print(f"{cell.name} needs {cell.chips} CUDA device(s)",
                  file=sys.stderr)
            return 3
    sys.path.insert(0, common.ROOT)
    from harness import trace
    from harness.context import Context

    root = tempfile.mkdtemp(prefix="gaml_bench_",
                            dir=os.environ.get("TMPDIR") or None)
    try:
        ctx = Context(cell, args, device, root, PROCESS_START,
                      trace.Tracer(bool(args.trace), root, device == "cuda"),
                      control)
        if faults is not None:
            faults()
        ctx.run()
        found = common.foreign_modules()
        if found:
            print("modules of jax or the JAX package were loaded: "
                  + ", ".join(found), file=sys.stderr)
            return 4
        ctx.report()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
