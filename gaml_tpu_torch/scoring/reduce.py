"""Per-read probability -> assembly score reductions.

Reference GetTotalProb family (graph.cc:1495-1576): each read's summed
position probability is normalized by ``2 * total_len`` (both strands),
floored at ``exp(min_prob_start + min_prob_per_base * L)`` (counting floored
reads as ``zero_reads``), and the score is the mean natural log.  A legacy
variant uses log10 with a fixed threshold (graph.cc:1559-1576) — kept for
the single-path debug scorer only.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

K_THRESHOLD_PROB = 1e-35  # reference kThresholdProb (graph.cc:24)


_THRESH_MEMO: dict = {}


def floor_thresholds(min_prob_per_base: float, min_prob_start: float,
                     lens: np.ndarray) -> np.ndarray:
    """exp(min_prob_start + min_prob_per_base*L) per read — invariant
    across rescores, so memoized (keyed on the parameters and the lens
    buffer identity; read lengths never change after ingestion)."""
    key = (float(min_prob_per_base), float(min_prob_start), id(lens),
           len(lens))
    hit = _THRESH_MEMO.get(key)
    if hit is None:
        if len(_THRESH_MEMO) > 64:
            _THRESH_MEMO.clear()
        hit = np.exp(min_prob_start +
                     min_prob_per_base * np.asarray(lens, dtype=np.float64))
        _THRESH_MEMO[key] = (lens, hit)  # keep lens alive so id() is stable
    else:
        hit = hit[1]
    return hit


_LOG_THRESH_MEMO: dict = {}


def log_floor_thresholds(min_prob_per_base: float, min_prob_start: float,
                         lens: np.ndarray) -> np.ndarray:
    """log of floor_thresholds: min_prob_start + min_prob_per_base*L per
    read (same memoization contract as floor_thresholds)."""
    key = (float(min_prob_per_base), float(min_prob_start), id(lens),
           len(lens))
    hit = _LOG_THRESH_MEMO.get(key)
    if hit is None:
        if len(_LOG_THRESH_MEMO) > 64:
            _LOG_THRESH_MEMO.clear()
        hit = (min_prob_start +
               min_prob_per_base * np.asarray(lens, dtype=np.float64))
        _LOG_THRESH_MEMO[key] = (lens, hit)
    else:
        hit = hit[1]
    return hit


def get_total_prob_from_logs(log_probs: np.ndarray, total_len: int,
                             min_prob_per_base: float, min_prob_start: float,
                             lens: np.ndarray) -> Tuple[float, int]:
    """get_total_prob evaluated from cached per-read log probabilities
    (``log_probs[i] = log(read_probs[i])``, -inf for zero): the incremental
    scorer maintains that array so the per-iteration reduction avoids an
    np.log over every read.  log(p/(2L)) is computed as log(p) - log(2L)
    and the floor as its log — equal to the direct formulas up to 1-ulp
    rounding (all score parity tests use tolerances far above that)."""
    if total_len == 0:
        total_len = 1
    n = len(log_probs)
    if n == 0:
        return 0.0, 0
    log_thresh = log_floor_thresholds(min_prob_per_base, min_prob_start, lens)
    from ..native import get_lib
    if get_lib() is not None:
        from ..native import reduce_floored_logs
        s, zero_reads = reduce_floored_logs(log_probs, log_thresh,
                                            math.log(2 * total_len))
        return s / n, zero_reads
    adj = log_probs - math.log(2 * total_len)
    floored = adj < log_thresh
    zero_reads = int(np.count_nonzero(floored))
    return float(np.sum(np.maximum(adj, log_thresh)) / n), zero_reads


def get_total_prob(read_probs: np.ndarray, total_len: int,
                   min_prob_per_base: float, min_prob_start: float,
                   lens: np.ndarray) -> Tuple[float, int]:
    """(score, zero_reads).  ``lens`` is the per-read length used in the
    floor: L for single reads (graph.cc:1518-1537), L1+L2 for pairs
    (graph.cc:1495-1516) — the caller builds it."""
    if total_len == 0:
        total_len = 1
    probs = np.asarray(read_probs, dtype=np.float64) / (2 * total_len)
    thresholds = floor_thresholds(min_prob_per_base, min_prob_start, lens)
    floored = probs < thresholds
    zero_reads = int(np.count_nonzero(floored))
    probs = np.where(floored, thresholds, probs)
    if len(probs) == 0:
        return 0.0, 0
    return float(np.sum(np.log(probs)) / len(probs)), zero_reads


def get_total_prob_legacy(read_probs: np.ndarray, total_len: int) -> Tuple[float, int]:
    """log10 variant with fixed threshold (graph.cc:1559-1576)."""
    if total_len == 0:
        total_len = 1
    probs = np.asarray(read_probs, dtype=np.float64) / (2 * total_len)
    floored = probs < K_THRESHOLD_PROB
    zero_reads = int(np.count_nonzero(floored))
    probs = np.where(floored, K_THRESHOLD_PROB, probs)
    if len(probs) == 0:
        return 0.0, 0
    return float(np.sum(np.log10(probs)) / len(probs)), zero_reads


def positions_to_read_probs(num_reads: int, positions, read_set) -> np.ndarray:
    """read_probs[i] = sum over positions of mm^ed * m^(L-ed)
    (reference PositionsToReadProbs, graph.cc:1482-1493), accumulated in
    list order for bit-parity with the C++ loop."""
    out = np.zeros(num_reads, dtype=np.float64)
    for i in range(len(positions)):
        for _pos, (ed, _orient) in positions[i]:
            out[i] += (read_set.mismatch_probs[ed] *
                       read_set.match_probs[read_set.get_read_len(i) - ed])
    return out
