"""Peaks of one NVIDIA H100 SXM and the least time each kernel's work could
take on it, frozen here so that a redesign of a kernel leaves the
yardstick as it is.

The counts follow chip_smoke.py's bound functions (band_bound,
exact_bound, resident_exact_bound, forward_bound, candgen_bound) and
depend only on the work the inputs and outputs define: window bases,
candidates, read lengths, band width, rows.  Two of chip_smoke.py's
candgen terms followed its kernels and are rewritten in terms of the work:

- the window maximum: chip_smoke.py counts van Herk/Gil-Werman's three
  64-bit maxima (6 int32 operations) per window start; here 2, the
  amortised comparisons of a monotone queue (each start pushed and
  popped once), whatever the kernel does;
- the output: chip_smoke.py counts the five int64 the kernels write per
  candidate (40 bytes) and an int64 gather from each of three program
  arrays; here 16 bytes written (read, segment, window position and
  seed offset as int32, the strand in the sign) and 8 read (the read id
  and its seed offset as int32), at most 12 bytes an indexed read.

Peaks: HBM 3.35 TB/s (NVIDIA's data sheet, SXM, at 700 W).  The integer
rates are derived, not published: 132 SMs x 64 int32 lanes x 1.98 GHz
boost clock = 16.7 T int32 operations/s, twice that in 16-bit lanes of
the packed band (33.5 T); FP32 instructions 132 x 128 x 1.98 GHz
(33.45 T/s, NVIDIA's 67 TFLOP/s counting an FMA as two).  A card set
below 700 W runs below them; the run reports the card's power limit.
"""
from __future__ import annotations

import numpy as np

HBM_BPS = 3.35e12
SM_HZ = 1.98e9
INT32_OPS = 132 * 64 * SM_HZ
LANE_OPS = 2 * INT32_OPS
FP32_OPS = 132 * 128 * SM_HZ
K = 15
# 16-bit lane operations per band cell: the cost, and the accept offset
COST_OPS, ACCEPT_OPS = 12, 12
BAND = 7


def band_bound(rows_cost: int, rows_accept: int, nbytes: int) -> dict:
    """A band DP of ``rows_cost`` candidate-rows for the cost alone and
    ``rows_accept`` with the accept offset, moving ``nbytes``."""
    ops = BAND * (COST_OPS * rows_cost + (COST_OPS + ACCEPT_OPS) * rows_accept)
    t_ops, t_bytes = ops / LANE_OPS * 1e3, nbytes / HBM_BPS * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "lane_ops": ops, "bytes": nbytes}


def exact_bound(g0, r0, read_len, orient, rid, n_window_bases: int,
                rmax: int) -> dict:
    """The exact two-direction extension of candidates (seed at ``g0`` in
    its window, ``r0`` in its oriented read of ``read_len`` bases) over
    windows of ``n_window_bases`` codes: backward rows (before the seed,
    cost and accept offset) and forward rows (after it, cost alone), the
    oriented reads the candidates name with their lengths, the window
    codes, five int32 in and three outputs (9 bytes) a candidate."""
    g0, r0, read_len = (np.asarray(x, np.int64) for x in (g0, r0, read_len))
    rows_b = np.clip(np.where(g0 > 0, r0, 0), 0, rmax)
    rows_f = np.clip(read_len - r0 - K, 0, rmax)
    _u, first = np.unique(np.asarray(rid, np.int64) * 2
                          + np.asarray(orient, np.int64), return_index=True)
    nbytes = int(read_len[first].sum()) + 4 * len(first) \
        + int(n_window_bases) + 29 * len(g0)
    return band_bound(int(rows_f.sum()), int(rows_b.sum()), nbytes)


def forward_bound(rlen, width: int, walk_bases: int) -> dict:
    """K5 on jobs of ``rlen`` read rows at band ``width`` over a walk
    buffer of ``walk_bases``: the largest of 3 FP32 instructions a band
    cell, the bytes (each row's read and step byte, the buffer once,
    seven int32 in and one float32 out a job), and the longest job's rows
    at one dependent FMA (4 cycles) each."""
    rlen = np.asarray(rlen, np.int64)
    rows = int(rlen.sum())
    terms = {"fp32": 3 * rows * width / FP32_OPS * 1e3,
             "bytes": (2 * rows + int(walk_bases) + 32 * len(rlen))
             / HBM_BPS * 1e3,
             "serial": int(rlen.max(initial=0)) * 4 / SM_HZ * 1e3}
    term = max(terms, key=terms.get)
    return {"bound_ms": terms[term], "bound_term": term,
            "fp32_ops": 3 * rows * width}


def candgen_bound(g: int, n: int, runs: int, n_fp: int,
                  n_indexed: int) -> dict:
    """Candidate generation over ``g`` window codes giving ``n``
    candidates from ``runs`` runs with hits, against an index of
    ``n_fp`` fingerprints over ``n_indexed`` reads.  Bytes: each code
    once; a run's index lookup two 32-byte sectors (at most the index's
    12 bytes a fingerprint); each candidate's read id and seed offset (at
    most 12 bytes an indexed read) and its 16 bytes out.  Operations, per
    window start of each strand: the rolling hash (shift, or, mask, xor),
    the key (2), the window maximum (2) and the validity and run flags
    (8); 12 a candidate."""
    nbytes = g + min(64 * runs, 12 * n_fp) + min(8 * n, 12 * n_indexed) \
        + 16 * n
    ops = 2 * g * (4 + 2 + 2 + 8) + 12 * n
    t_ops, t_bytes = ops / INT32_OPS * 1e3, nbytes / HBM_BPS * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "int32_ops": ops, "bytes": nbytes}
