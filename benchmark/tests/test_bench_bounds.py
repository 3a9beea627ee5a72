"""The frozen roofline counts (harness/bounds.py) against chip_smoke.py's
bound functions on the same shapes: equal wherever the count was not
rewritten, and the two rewritten candgen terms as documented."""
import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)
sys.path.insert(0, os.path.dirname(BENCH))

import chip_smoke  # noqa: E402
from harness import bounds  # noqa: E402


def test_peaks_equal():
    assert bounds.HBM_BPS == chip_smoke.HBM_BPS
    assert bounds.LANE_OPS == chip_smoke.LANE_OPS
    assert bounds.INT32_OPS == chip_smoke.INT32_OPS
    assert bounds.FP32_OPS == chip_smoke.FP32_OPS


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exact_extension_bound_equal(seed):
    rng = np.random.default_rng(seed)
    n, rows, L, rmax = 500, 40, 100, 96
    rid = rng.integers(0, rows, n)
    orient = rng.integers(0, 2, n)
    g0 = rng.integers(0, 300, n)
    r0 = rng.integers(0, L - 15, n)
    buf = torch.zeros(5000, dtype=torch.uint8)
    lens = torch.full((2 * rows,), L, dtype=torch.int32)
    args = (None, lens, buf, None, None, torch.as_tensor(g0),
            torch.as_tensor(r0), torch.as_tensor(rid + orient * rows))
    want = chip_smoke.resident_exact_bound(args, rmax)
    got = bounds.exact_bound(g0, r0, np.full(n, L), orient, rid, 5000, rmax)
    assert got["bound_ms"] == want["bound_ms"]
    assert got["lane_ops"] == want["lane_ops"]
    assert got["bytes"] == want["bytes"]


@pytest.mark.parametrize("width", [64, 128])
def test_forward_bound_equal(width):
    rng = np.random.default_rng(width)
    rlen = rng.integers(600, 5000, 300)
    seq = torch.zeros(2_800_000, dtype=torch.uint8)
    args = (None, None, seq, None, None, None, None, torch.as_tensor(rlen))
    want = chip_smoke.forward_bound(args, width)
    got = bounds.forward_bound(rlen, width, seq.numel())
    assert got["bound_ms"] == want["bound_ms"]
    assert got["fp32_ops"] == want["fp32_ops"]


def test_candgen_bound_rewritten_terms():
    """chip_smoke.py's count on a query's candidates, and the frozen one:
    the code bytes, the run lookups and the hash, key and flag operations
    agree; the window maximum counts 2 operations a start, not 6, and a
    candidate moves 16 + 8 bytes, not 40 + 3 x 8."""
    rng = np.random.default_rng(3)
    n, g, n_fp, n_reads = 4000, 300_000, 9000, 10_000

    class C:
        n_total = n
        orient = torch.as_tensor(rng.integers(0, 2, n))
        seg = torch.as_tensor(rng.integers(0, 3, n))
        g0 = torch.as_tensor(rng.integers(0, g // 3, n))

    class Gen:
        rids = torch.zeros(n_reads, dtype=torch.int64)
        row_of = torch.zeros(n_reads, dtype=torch.int64)
        seed2 = torch.zeros((n_reads, 2), dtype=torch.int64)
        sf = torch.zeros(n_fp + 1, dtype=torch.int64)
        off = torch.zeros(n_fp + 1, dtype=torch.int64)

    want = chip_smoke.candgen_bound(Gen, g, C)
    runs = want["runs"]
    got = bounds.candgen_bound(g, n, runs, n_fp, n_reads)
    assert want["int32_ops"] - got["int32_ops"] == 2 * g * (6 - 2)
    # chip_smoke.py: each code, the run lookups (at most its index arrays'
    # bytes), an int64 gather from three arrays and five int64 written
    assert want["bytes"] == g + min(64 * runs, 16 * (n_fp + 1)) + 3 * 8 * n \
        + 40 * n
    assert got["bytes"] == g + min(64 * runs, 12 * n_fp) + \
        min(8 * n, 12 * n_reads) + 16 * n
