"""Log-space probability numerics.

Reproduces the reference's ``logdouble`` scalar semantics
(reference: logdouble.hpp:13-78):

- value is carried as its natural log; "zero" is ``-inf``;
- addition is ``max + log1p(exp(min - max))`` with -inf identities;
- multiplication adds logs, power scales, division subtracts.

Host parity code uses float64 numpy (bit-matching the C++ doubles); device
code uses the jnp variants in float32.
"""
from __future__ import annotations

import numpy as np

NEG_INF = -np.inf


def logadd(a, b):
    """log(exp(a)+exp(b)) with the reference's exact formula
    (logdouble.hpp:37-47). Works elementwise on arrays."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    hi = np.maximum(a, b)
    lo = np.minimum(a, b)
    with np.errstate(invalid="ignore"):
        out = hi + np.log1p(np.exp(lo - hi))
    # -inf identities: if one side is -inf, result is the other side.
    out = np.where(np.isneginf(a), b, np.where(np.isneginf(b), a, out))
    return out


def logsum(values: np.ndarray) -> float:
    """Left-fold logadd over a 1-D array, in order — matching how the
    reference accumulates ``logdouble`` sums term by term
    (e.g. graph.cc:3052-3060).  Order matters for bit-parity."""
    acc = NEG_INF
    for v in np.asarray(values, dtype=np.float64):
        acc = float(logadd(acc, v))
    return acc


def gaussian_pdf(x, mean, std):
    """Insert-size probability (reference GetInsertProbability,
    graph.cc:1593-1598)."""
    z = (np.asarray(x, dtype=np.float64) - mean) / std
    e = np.exp(-z * z / 2.0)
    c = np.sqrt(2 * np.pi) * std
    return e / c


_INSERT_TABLE_MEMO: dict = {}


def insert_prob_table(insert_mean: float, insert_std: float) -> np.ndarray:
    """Precomputed pdf for distances 0 .. mean+5*std (exclusive), as the
    reference does per scoring call (graph.cc:2050-2053).  Memoized (the
    table is immutable and rebuilt every rescore otherwise)."""
    key = (float(insert_mean), float(insert_std))
    hit = _INSERT_TABLE_MEMO.get(key)
    if hit is None:
        n = int(insert_mean + 5 * insert_std)
        hit = gaussian_pdf(np.arange(n), insert_mean, insert_std)
        hit.setflags(write=False)
        _INSERT_TABLE_MEMO[key] = hit
    return hit


def insert_prob(dist: int, table: np.ndarray, insert_mean: float, insert_std: float) -> float:
    """Table lookup with on-demand tail (graph.cc:2076-2081).

    Note the reference indexes the table with a possibly *negative* ``dist``
    only via the ``dist < insert_probs.size()`` check on a signed int, so a
    negative dist would read out of bounds in C++; our scorers never produce
    one (innie geometry guarantees dist >= read len)."""
    if 0 <= dist < len(table):
        return float(table[dist])
    return float(gaussian_pdf(dist, insert_mean, insert_std))
