"""Single-end read-set scorer.

Reference CalcScoreForPaths (single variant, graph.cc:1650-1743): walks are
split at gaps into contigs placed at running offsets (walks separated by
st += 1,000,000), per-read probabilities are summed over alignment
positions, and the score is the floored mean log (see reduce.py).

The reference's coverage sweep here is *dead code*: ``last_event_type`` is
only ever set to 1 (path-start events), so the ``last_event_type >= 3``
guard never fires and ``bad_bases`` stays 0 (graph.cc:1710-1733).  We
replicate the sweep literally so the behavior (and its zero result) matches.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from ..core.paths import split_at_gaps
from .reduce import get_total_prob, positions_to_read_probs

K_THRESHOLD_PROB2 = 1e-15  # position-level event cutoff (graph.cc:25)


def calc_score_for_paths_single(graph, paths: Sequence[Sequence[int]],
                                read_set,
                                no_cov_penalty: float = 0.0,
                                exp_cov_move: float = 0.75,
                                min_prob_per_base: float = -0.7,
                                min_prob_start: float = -10.0):
    """Returns (score, zero_reads, total_len)."""
    from ..native import get_lib

    total_len1 = 0
    st = 0
    events: List[Tuple[int, int]] = []

    if get_lib() is not None:
        # native path: AddPositions-semantics window collection in C++,
        # probabilities accumulated per read in entry order (bit-identical
        # to the reference's sequential +=)
        from ..core.paths import path_len as _plen
        from ..native import collect_positions_ptr

        ctgs_with_st = []
        for path in paths:
            ctgs, gaps = split_at_gaps(path)
            events.append((st + total_len1, 1))
            for i, ctg in enumerate(ctgs):
                if i > 0:
                    total_len1 += gaps[i - 1]
                    events.append((st + total_len1, 1))
                ctgs_with_st.append((ctg, st + total_len1))
                total_len1 += _plen(graph, ctg)
            st += 1000000
        rids_g, starts_g, cnts_g, pos_g, ed_g, or_g = collect_positions_ptr(
            read_set.stage_position_windows(graph, ctgs_with_st,
                                            simple=True),
            use_filter=False, n_reads=read_set.get_number_of_reads())
        total_entries = int(cnts_g.sum()) if len(cnts_g) else 0
        read_probs = np.zeros(read_set.get_number_of_reads(),
                              dtype=np.float64)
        if total_entries:
            entry_rid = np.repeat(rids_g, cnts_g)
            ed_e = ed_g[:total_entries]
            lens_e = read_set.read_lens_array()[entry_rid]
            p1 = (read_set.mismatch_probs[ed_e] *
                  read_set.match_probs[lens_e - ed_e])
            np.add.at(read_probs, entry_rid, p1)
        # the reference also emits per-position coverage events here, but
        # its single-end sweep is dead code (last_event_type never reaches
        # >= 3, graph.cc:1710-1733) — bad_bases is provably 0
        bad_bases = 0
        lens = read_set.read_lens_array()
        score, zero_reads = get_total_prob(read_probs, total_len1,
                                           min_prob_per_base,
                                           min_prob_start, lens)
        return score - bad_bases * no_cov_penalty, zero_reads, total_len1

    read_set.clear_positions()
    for path in paths:
        ctgs, gaps = split_at_gaps(path)
        events.append((st + total_len1, 1))
        for i, ctg in enumerate(ctgs):
            if i > 0:
                total_len1 += gaps[i - 1]
                events.append((st + total_len1, 1))
            total_len1 += read_set.add_positions(graph, ctg, st + total_len1)
        st += 1000000

    positions = read_set.positions
    read_probs = np.zeros(read_set.get_number_of_reads(), dtype=np.float64)
    for i in range(len(positions)):
        for pos, (ed, _orient) in positions[i]:
            p1 = (read_set.mismatch_probs[ed] *
                  read_set.match_probs[read_set.get_read_len(i) - ed])
            if p1 > K_THRESHOLD_PROB2:
                events.append((pos, read_set.get_read_len(i)))
            read_probs[i] += p1

    events.sort()
    last_fin = -1
    last_event_type = -1
    bad_bases = 0
    for pos, typ in events:
        if typ >= 3:
            if pos > last_fin and last_event_type >= 3:
                bad_bases += pos - last_fin
            last_fin = max(last_fin, int(pos + typ * exp_cov_move))
        if typ == 1:
            last_event_type = typ

    lens = read_set.read_lens_array()
    score, zero_reads = get_total_prob(read_probs, total_len1,
                                       min_prob_per_base, min_prob_start, lens)
    return score - bad_bases * no_cov_penalty, zero_reads, total_len1


def calc_score_for_path_legacy(graph, path: Sequence[int], read_set):
    """Single-walk debug scorer with the log10 reduction
    (reference CalcScoreForPath, graph.cc:1578-1591)."""
    from .reduce import get_total_prob_legacy

    positions, total_len = read_set.get_positions(graph, path)
    read_probs = positions_to_read_probs(read_set.get_number_of_reads(),
                                         positions, read_set)
    score, _zero = get_total_prob_legacy(read_probs, total_len)
    return score
