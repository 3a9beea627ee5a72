"""Batches for kernel K5 (csrc/banded_forward.cu) and its time per row
on the card.

``aureus_batch`` is an S. aureus-sized long-read batch (chip_smoke.py
phase 5); ``adversarial_batch`` holds the cases where scaled linear space
could part from log space (tests/test_torch_forward.py and phase 5).
Both return numpy arrays in the kernel's layout: reads [B, rmax] uint8,
row [B] int32 (= arange), seq [S] uint8, steps [B, rmax] uint8, c0,
gstart, glen, rlen [B] int32.

    python -m gaml_tpu_torch.tools.forward_bench [--reps N]

times K5 on batches of 1 to 32 jobs per SM, every job 5120 rows long,
and prints one JSON line per batch and width: at one warp per SM the
time per row is the serial chain of one row, and the growth with more
warps shows what the SM's issue shares.  It needs an NVIDIA GPU and
nvcc.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

TOL_REL, TOL_ABS = 1e-4, 1e-3  # |kernel - plain| <= rel |plain| + abs
ADVERSARIAL_KINDS = ("lead", "lag", "stuck", "target_ends", "target_mid",
                     "target_beyond", "glen0", "rlen0", "plain")


def aureus_batch(seed=0, n_jobs=2048, rmax=5120, seq_len=2_800_000,
                 err=0.1):
    """A random 2.8 Mb walk buffer; each job's read follows its guide path
    (steps from {0,1,1,1,2}) with 10 % substitutions; read lengths from
    rmax/8 to rmax; random targets, some of which end inside the read's
    span."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 4, seq_len).astype(np.uint8)
    rlen = rng.integers(rmax // 8, rmax + 1, n_jobs).astype(np.int32)
    steps = rng.choice(np.array([0, 1, 1, 1, 2], np.uint8), (n_jobs, rmax))
    c0 = rng.integers(256, seq_len - 2 * rmax - 256, n_jobs)
    pos = c0[:, None] + np.cumsum(steps, axis=1, dtype=np.int64)
    reads = seq[pos - 1]
    sub = rng.random(reads.shape) < err
    reads[sub] = (reads[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    gstart = c0 - rng.integers(0, 300, n_jobs)
    span = pos[np.arange(n_jobs), rlen - 1] - gstart
    glen = (span * rng.uniform(0.7, 1.3, n_jobs)).astype(np.int64)
    return _layout(reads, seq, steps, c0, gstart, glen, rlen)


def adversarial_batch(seed=0, n_jobs=len(ADVERSARIAL_KINDS), rmax=5000,
                      seq_len=60_000, lo=2000, err=0.15):
    """Reads of lo..rmax bases with ``err`` errors (a third each
    substitutions, insertions, deletions) along a true path, job i of the
    kind ADVERSARIAL_KINDS[i % 9]:

    - lead / lag: the guide runs 20-45 columns ahead of / behind the true
      path over the middle of the read (outside a 64-lane band's half);
    - stuck: the guide starts at the buffer's first column and stays
      there for 300-700 rows while the true path, from column 40-150, runs
      on, then catches up at two columns a row: most of the band holds
      lanes hundreds of nats below its max, some of which later carry
      the alignment (what a chain whose first anchor lies deep in the
      read gives at a walk's start);
    - target_ends: the target ends where the true path is 24 rows before
      the read's end, so the last rows only insert at its edge;
    - target_mid: the target ends where the true path is half-way, so the
      band leaves it and no mass is left;
    - target_beyond: the target starts 100 columns right of the guide's
      start, beyond both bands' first row;
    - glen0 / rlen0: an empty target / no rows;
    - plain: the guide follows the true path.
    """
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, 4, seq_len).astype(np.uint8)
    p_ind = err / 3
    reads = np.full((n_jobs, rmax), 6, np.uint8)
    steps = np.ones((n_jobs, rmax), np.uint8)
    c0 = rng.integers(500, seq_len - 2 * rmax - 500, n_jobs)
    gstart = c0 - rng.integers(0, 300, n_jobs)
    glen = np.full(n_jobs, 2 * rmax + 600, np.int64)
    rlen = rng.integers(lo, rmax + 1, n_jobs).astype(np.int32)
    for i in range(n_jobs):
        kind = ADVERSARIAL_KINDS[i % len(ADVERSARIAL_KINDS)]
        n = int(rlen[i])
        true = rng.choice(np.array([0, 1, 2], np.int64), n,
                          p=[p_ind, 1 - 2 * p_ind, p_ind])
        if kind == "stuck":
            c0[i] = gstart[i] = 0
            start = int(rng.integers(40, 151))
        else:
            start = int(c0[i])
        pos = start + np.cumsum(true)  # the true path's cell after row j
        read = seq[pos - 1].copy()
        read[true == 0] = rng.integers(0, 4, int((true == 0).sum()))
        sub = rng.random(n) < p_ind
        read[sub] = (read[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        reads[i, :n] = read
        guide = true.copy()
        if kind == "stuck":
            stop, cur = int(rng.integers(300, 701)), 0
            for j in range(n):
                guide[j] = 0 if j < stop else min(2, max(
                    0, true[j] + np.sign(pos[j] - cur - true[j])))
                cur += int(guide[j])
        elif kind in ("lead", "lag"):
            off = int(rng.integers(20, 46)) * (1 if kind == "lead" else -1)
            a, b = int(n * 0.3), int(n * 0.7)
            cur = 0
            for j in range(n):
                want = off if a <= j < b else 0
                guide[j] = min(2, max(0, true[j] + np.sign(want - cur)))
                cur += int(guide[j] - true[j])
        steps[i, :n] = guide
        if kind == "target_ends":
            glen[i] = pos[n - 24] - gstart[i]
        elif kind == "target_mid":
            glen[i] = pos[n // 2] - gstart[i]
        elif kind == "target_beyond":
            gstart[i] = c0[i] + 100
        elif kind == "glen0":
            glen[i] = 0
        elif kind == "rlen0":
            rlen[i] = 0
    return _layout(reads, seq, steps, c0, gstart, glen, rlen)


def _layout(reads, seq, steps, c0, gstart, glen, rlen):
    b = len(rlen)
    i32 = lambda x: np.ascontiguousarray(x, dtype=np.int32)  # noqa: E731
    return (np.ascontiguousarray(reads, dtype=np.uint8),
            np.arange(b, dtype=np.int32), np.ascontiguousarray(seq, np.uint8),
            np.ascontiguousarray(steps, dtype=np.uint8), i32(c0),
            i32(gstart), i32(glen), i32(rlen))


def to_device(batch, device):
    import torch

    return tuple(torch.from_numpy(x).to(device) for x in batch)


def dense_layout(batch):
    """(genome, reads, rlens, centers, gstarts, glens) of ops/forward.py
    (and of gaml_tpu.ops.forward) for a batch with row = arange."""
    reads, _row, seq, steps, c0, gstart, glen, rlen = batch
    centers = np.concatenate(
        [c0[:, None], c0[:, None] + np.cumsum(steps, 1, dtype=np.int64)],
        1).astype(np.int32)
    return seq, reads, rlen, centers, gstart, glen


def within_tolerance(got, want):
    """Jobs of ``got`` outside TOL_REL |want| + TOL_ABS, and the largest
    absolute error over the jobs with mass (want > -1e29, where -1e30
    stands for none) (torch tensors)."""
    diff = (got.double() - want.double()).abs()
    bad = int((diff > TOL_REL * want.double().abs() + TOL_ABS).sum())
    live = diff[want > -1e29]
    return bad, float(live.max()) if live.numel() else 0.0


def median_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def occupancy(dev, lm, lmm, reps, rows=5120):
    """K5 on 1, 4, 8, 16 and 32 jobs per SM of the card, every job
    ``rows`` long; one JSON line per batch and width."""
    import torch

    from ..ops.forward_cuda import banded_forward

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for per_sm in (1, 4, 8, 16, 32):
        batch = list(aureus_batch(1, n_jobs=sms * per_sm, rmax=rows))
        batch[7] = np.full_like(batch[7], rows)
        a = to_device(batch, dev)
        for width in (64, 128):
            ms = median_ms(lambda: banded_forward(*a, lm, lmm, width), reps)
            print(json.dumps({"jobs_per_sm": per_sm, "jobs": sms * per_sm,
                              "rows": rows, "width": width, "ms": ms,
                              "ns_per_row": ms * 1e6 / rows}), flush=True)
    return 0


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    lm, lmm = float(np.log(0.85)), float(np.log(0.0375))
    return occupancy(torch.device("cuda", 0), lm, lmm, args.reps)


if __name__ == "__main__":
    sys.exit(main())
