"""PacBio walk-set scorer (reference CalcScoreForPacbio,
graph.cc:3040-3261)."""
from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from ..utils.metrics import count, span


def add_positions_to_read_probs(positions2, read_probs: np.ndarray) -> None:
    """read_probs[i] (log) += sum of hit masses (reference
    AddPositionsToReadProbsPacbio, graph.cc:3052-3060) — left-fold logadd
    in list order like the logdouble accumulation.  Scalar math fast path
    (same libm calls as the numpy logadd, so bit-identical)."""
    import math

    inf = math.inf
    for i, plist in enumerate(positions2):
        if not plist:
            continue
        a = float(read_probs[i])
        for _span, lp in plist:
            b = float(lp)
            if a == -inf:
                a = b
            elif b != -inf:
                if a < b:
                    a, b = b, a
                a = a + math.log1p(math.exp(b - a))
        read_probs[i] = a


def get_total_prob_pacbio(read_probs: np.ndarray, total_len: int, read_set,
                          min_prob_per_base: float, min_prob_start: float,
                          dump_path: str = "") -> Tuple[float, int]:
    """score = (sum log floored)/n - log(2*total_len)
    (reference GetTotalProbPacbio, graph.cc:3062-3088); the floor is
    exp(min_prob_start) * exp(min_prob_per_base)^L.  ``dump_path`` writes
    the per-read logprob table the reference dumps to rp.dat."""
    if total_len == 0:
        total_len = 1
    zero_reads = 0
    total = 0.0
    dump = open(dump_path, "w") if dump_path else None
    for i in range(len(read_probs)):
        lp = read_probs[i]
        if dump:
            dump.write(f"{read_set.get_read_name(i)} {lp:.6f}\n")
        floor = min_prob_start + min_prob_per_base * read_set.get_read_len(i)
        if lp < floor:
            zero_reads += 1
            lp = floor
        total += lp
    if dump:
        dump.close()
    n = max(len(read_probs), 1)
    return total / n - np.log(2 * total_len), zero_reads


def walk_events(graph, path):
    """(normalized walk, the sweep's events of its nodes) (reference
    graph.cc:3196-3208)."""
    path = graph.normalize_path(list(path))
    events: List[Tuple[int, int]] = [(-1000, 1), (2000, -3000)]
    pp = 0
    for e in path:
        if e >= 0:
            cl = graph.node_len(e)
            events.append((pp, 1))
            events.append((pp + cl, -cl))
            pp += cl
        else:
            pp += -e
    return path, events


def hit_spans(positions2, read_set):
    """The (start, end) spans of every hit at or above its read's floor,
    read by read (the hits' events, graph.cc:3209-3224)."""
    min_probs = read_set.min_read_probs_array()
    spans = []
    for i in range(len(positions2)):
        if not positions2[i]:
            continue
        floor_i = min_probs[i]
        for span, lp in positions2[i]:
            if lp >= floor_i:
                spans.append(span)
    return spans


def interval_sweep(events, tl: int, exp_cov_move: float) -> int:
    """Bad bases of the interval multiset sweep (graph.cc:3226-3250) over
    ``events`` (sorted here)."""
    events.sort()
    inters: List[int] = []
    bad_bases = 0
    import bisect

    for j, (pos, typ) in enumerate(events):
        if typ == 1:
            bisect.insort(inters, pos)
        else:
            k = bisect.bisect_left(inters, pos + typ)
            if k < len(inters) and inters[k] == pos + typ:
                del inters[k]
        good_start = tl - 250
        if inters:
            good_start = inters[0] + exp_cov_move
        if j + 1 < len(events):
            good_start = min(events[j + 1][0], good_start)
        good_start = min(good_start, tl - 250)
        if good_start > max(2500, pos):
            bad_bases += int(good_start - max(2500, pos))
    return bad_bases


def sweep_walk(graph, path, read_set, exp_cov_move: float):
    """Host position collection + interval multiset sweep for ONE walk
    (reference graph.cc:3196-3250): returns (positions2, total_len,
    bad_bases).  Shared by the host reducer below and the mesh scorer
    (parallel.pacbio_sharded) so the coverage semantics cannot drift."""
    path, events = walk_events(graph, path)
    positions2, tl = read_set.get_read_probabilities(graph, path)
    for pstart, pend in hit_spans(positions2, read_set):
        events.append((pstart, 1))
        events.append((pend, pstart - pend))
    return positions2, tl, interval_sweep(events, tl, exp_cov_move)


def calc_score_for_pacbio(graph, paths: Sequence[Sequence[int]], read_set,
                          no_cov_penalty: float = 0.0,
                          exp_cov_move: float = 0.75,
                          min_prob_per_base: float = -0.7,
                          min_prob_start: float = -10.0):
    """Returns (score, zero_reads, total_len).  Walk gaps are NOT split
    (the reference's gap-splitting loop is commented out,
    graph.cc:3188-3194) — gaps spell as N runs inside one contig.  Traced
    as the counter ``pacbio.scores`` and the spans ``pacbio.sweep`` (every
    walk's positions, interval sweep and per-read sums) and
    ``pacbio.reduce``, besides the read set's own."""
    count("pacbio.scores")
    read_probs = np.full(read_set.get_number_of_reads(), -np.inf)
    total_len = 0
    bad_bases = 0
    # all walks' missing windows in ONE forward-DP device batch; the
    # per-walk loop below then scores from cache
    read_set.precompute_ranges_for_paths(graph, paths)
    with span("pacbio.sweep"):
        for path in paths:
            positions2, tl, bad = sweep_walk(graph, path, read_set,
                                             exp_cov_move)
            add_positions_to_read_probs(positions2, read_probs)
            total_len += tl
            bad_bases += bad

    dump = os.environ.get("GAML_TPU_RP_DUMP", "")
    with span("pacbio.reduce"):
        score, zero_reads = get_total_prob_pacbio(
            read_probs, total_len, read_set, min_prob_per_base,
            min_prob_start, dump_path=dump)
    return score - bad_bases * no_cov_penalty, zero_reads, total_len
