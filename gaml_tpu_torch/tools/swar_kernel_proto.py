"""K1 at the SWAR prototype's inputs: the port of K6.

tools/swar_kernel_proto.py::swar_costs (kernel K6) is the TPU prototype
that proved the 4-bit SWAR form of K1's cost (the forward d=0 cost over
all rmax rows, saturated at 7) against the exact sublane kernel
dp_rows_pallas.  The TPU needed a separate prototype only for the SWAR
packing; on the card K1 (ops.extend_cuda.swar_cost) computes that
function with an exact band in registers.  This tool runs K1 at the
prototype's inputs (n = 131072, rmax = 96, rlen 0..rmax, sentinels,
half the candidates on the diagonal), holds it against
min(dp_rows_exact, 7) as the prototype held swar_costs against
dp_rows_pallas, and prints both times.

    python -m gaml_tpu_torch.tools.swar_kernel_proto [--device cuda|cpu]
                                                     [--n N] [--rmax R]

Exits non-zero on a mismatch.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..ops.extend import BAND, PAD, SENT_GEN, SENT_READ
from ..ops.extend_cuda import SAT, dp_rows_exact, swar_cost


def prototype_inputs(n: int, rmax: int, device, seed: int = 0):
    """The prototype's main() inputs (same generator calls), as the
    kernels' candidate-minor (read_t, gwin_t, rlen, glen)."""
    rng = np.random.default_rng(seed)
    read = rng.integers(0, 5, (rmax, n)).astype(np.uint8)
    gwin = rng.integers(0, 5, (rmax + 2 * PAD, n)).astype(np.uint8)
    gwin[PAD:PAD + rmax, :n // 2] = read[:, :n // 2]
    gwin[gwin == 4] = SENT_GEN
    read[read == 4] = SENT_READ
    rlen = rng.integers(0, rmax + 1, n).astype(np.int32)
    glen = rng.integers(0, rmax + PAD, n).astype(np.int32)
    return tuple(torch.as_tensor(x, device=device)
                 for x in (read, gwin, rlen, glen))


def _median_ms(device, fn, reps):
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def run(device="cuda", n: int = 131072, rmax: int = 96, reps: int = 20):
    """K1 against min(dp_rows_exact, 7) at the prototype's inputs, and
    both times (CUDA events on the card, medians of ``reps``).  Returns a
    dict; ``mismatches`` must be 0."""
    device = torch.device(device)
    args = prototype_inputs(n, rmax, device)
    got = swar_cost(*args)
    want = torch.clamp(dp_rows_exact(*args)[0], max=SAT)
    res = {"device": str(device), "n": n, "rmax": rmax,
           "mismatches": int((got != want).sum()),
           "ms": _median_ms(device, lambda: swar_cost(*args), reps),
           "exact_ms": _median_ms(device, lambda: dp_rows_exact(*args),
                                  reps)}
    res["band_cells_per_s"] = n * rmax * BAND / (res["ms"] / 1e3)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="swar_kernel_proto")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=131072)
    ap.add_argument("--rmax", type=int, default=96)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    res = run(args.device, args.n, args.rmax, args.reps)
    print(json.dumps(res), flush=True)
    return 0 if res["mismatches"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
