"""Paired-end scorers: full rescore and the incremental per-move fast path.

Reference semantics:
- full: CalcScoreForPaths paired (graph.cc:1991-2127) — all (pos1, pos2)
  combinations per read with opposite orientations in innie geometry
  (leftmost mate forward), ``dist = far - near + farther mate's length``,
  ``read_prob += p1*p2*insert_pdf(dist)``; pairs above a per-read threshold
  emit coverage events; bad bases from the event sweep.
- incremental: CalcScoreForPathsNew (graph.cc:1952-1989) — diff the new
  walk multiset against the previous one (GetChanges, graph.cc:1745-1764),
  subtract erased walks' per-read contributions and bad bases, add the new
  walks' (CalcScoreForPathInc, graph.cc:1794-1920), keep running per-read
  totals in a ScoringState.

Quirk preserved: the incremental per-pair event threshold uses read_set2's
length twice (graph.cc:1855-1857), unlike the full scorer's L1+L2.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core.logprob import insert_prob, insert_prob_table
from ..core.paths import path_len, split_at_gaps, total_len as paths_total_len
from ..utils.metrics import count, span
from .reduce import get_total_prob, get_total_prob_from_logs


@dataclass
class ScoringState:
    """Reference ScoringState (graph.h:612-619)."""
    old_paths: List[List[int]] = field(default_factory=list)
    bad_bases: int = 0
    probs: np.ndarray = field(default_factory=lambda: np.zeros(0))


def get_changes(new_paths: Sequence[Sequence[int]],
                old_paths: Sequence[Sequence[int]]):
    """Multiset diff of walks (reference GetChanges, graph.cc:1745-1764;
    the reverse-complement matching there is commented out)."""
    old_index = Counter(map(tuple, old_paths))
    added = []
    get = old_index.get
    for p in new_paths:
        key = tuple(p)
        c = get(key, 0)
        if c > 0:
            old_index[key] = c - 1
        else:
            added.append(list(p))
    erased = []
    for key, cnt in old_index.items():
        for _ in range(cnt):
            erased.append(list(key))
    return erased, added


def _pair_lens(read_set1, read_set2) -> np.ndarray:
    """Cached L1+L2 per pair (constant after ingestion; feeds the memoized
    floor thresholds, so the buffer identity must be stable)."""
    cached = getattr(read_set1, "_pair_lens_cache", None)
    if cached is not None and cached[0] is read_set2:
        return cached[1]
    lens = read_set1.read_lens_array() + read_set2.read_lens_array()
    read_set1._pair_lens_cache = (read_set2, lens)
    return lens


def _pair_product(read_set1, read_set2, rid: int, x_pos: int, x_ed: int,
                  x_or: int, y_pos: int, y_ed: int, y_or: int,
                  table, insert_mean, insert_std):
    """Innie-geometry pair term; None if geometry rejects
    (graph.cc:2057-2088)."""
    if x_or == y_or:
        return None
    if x_pos < y_pos:
        if x_or != 0 or y_or != 1:
            return None
        dist = y_pos - x_pos + read_set2.get_read_len(rid)
    else:
        if x_or != 1 or y_or != 0:
            return None
        dist = x_pos - y_pos + read_set1.get_read_len(rid)
    p1 = (read_set1.mismatch_probs[x_ed] *
          read_set1.match_probs[read_set1.get_read_len(rid) - x_ed])
    p2 = (read_set2.mismatch_probs[y_ed] *
          read_set2.match_probs[read_set2.get_read_len(rid) - y_ed])
    return p1 * p2 * insert_prob(dist, table, insert_mean, insert_std), dist


def collect_paired_positions(graph, paths, read_set1, read_set2):
    """Shared position-assembly pass of the full paired rescore
    (reference graph.cc:2010-2049): precompute windows, walk the scaffold
    parts at ``st += 1000000`` offsets filling both mates' position lists,
    and record the scaffold-boundary coverage events.  Returns
    (scaffold_events, total_len)."""
    total_len1 = 0
    read_set1.clear_positions()
    read_set2.clear_positions()
    read_set1.precompute_alignment_for_paths(paths, graph)
    read_set2.precompute_alignment_for_paths(paths, graph)
    st = 0
    events: List[Tuple[int, int]] = []

    for path in paths:
        ctgs, gaps = split_at_gaps(path)
        events.append((st + total_len1, 1))
        for i, ctg in enumerate(ctgs):
            if i > 0:
                total_len1 += gaps[i - 1]
                events.append((st + total_len1, 1))
            added1 = read_set1.add_positions(graph, ctg, st + total_len1)
            read_set2.add_positions(graph, ctg, st + total_len1)
            total_len1 += added1
        st += 1000000
    return events, total_len1


def calc_score_for_paths_paired(graph, paths, read_set1, read_set2,
                                insert_mean: float, insert_std: float,
                                no_cov_penalty: float = 0.0,
                                exp_cov_move: float = 0.75,
                                use_all_to_cov: bool = False,
                                min_prob_per_base: float = -0.7,
                                min_prob_start: float = -10.0):
    """Full paired rescore.  Returns (score, zero_reads, total_len)."""
    assert read_set1.get_number_of_reads() == read_set2.get_number_of_reads()
    events, total_len1 = collect_paired_positions(graph, paths, read_set1,
                                                  read_set2)
    positions1 = read_set1.positions
    positions2 = read_set2.positions
    table = insert_prob_table(insert_mean, insert_std)
    n = read_set1.get_number_of_reads()
    read_probs = np.zeros(n, dtype=np.float64)
    for i in range(n):
        threshold = np.exp(min_prob_start + min_prob_per_base *
                           (read_set1.get_read_len(i) + read_set2.get_read_len(i)))
        for x_pos, (x_ed, x_or) in positions1[i]:
            for y_pos, (y_ed, y_or) in positions2[i]:
                res = _pair_product(read_set1, read_set2, i, x_pos, x_ed, x_or,
                                    y_pos, y_ed, y_or, table, insert_mean, insert_std)
                if res is None:
                    continue
                p, _dist = res
                if p > threshold:
                    events.append((max(x_pos, y_pos), 3))
                    if use_all_to_cov:
                        events.append((min(x_pos, y_pos), 3))
                read_probs[i] += p

    bad_bases = _coverage_sweep(events, insert_mean, insert_std, exp_cov_move)
    lens = _pair_lens(read_set1, read_set2)
    score, zero_reads = get_total_prob(read_probs, total_len1,
                                       min_prob_per_base, min_prob_start, lens)
    return score - bad_bases * no_cov_penalty, zero_reads, total_len1


def _coverage_sweep(events: List[Tuple[int, int]], insert_mean: float,
                    insert_std: float, exp_cov_move: float) -> int:
    """Paired coverage-gap sweep (graph.cc:2092-2119 == graph.cc:1893-1919)."""
    events.sort()
    last_event_pos = 0
    last_event_type = -1
    last_begin = 0
    bad_bases = 0
    for pos, typ in events:
        if typ == 3:
            if (pos - last_event_pos > exp_cov_move and
                    (last_event_type == 3 or last_event_type < 0) and
                    pos - last_begin > insert_mean + 5 * insert_std):
                bad_bases += pos - last_event_pos
        if typ == 1:
            last_begin = pos
        last_event_pos = pos
        last_event_type = typ
    return bad_bases


def _ctg_missing_union(read_set, ctgs_with_st):
    """Union of the per-contig missing-window lists from the readset's
    contig stage memo (None if any contig entry is absent)."""
    memo = getattr(read_set, "_stage_memo", None)
    if memo is None:
        return None
    out: List = []
    for ctg, _st in ctgs_with_st:
        entry = memo.get(tuple(ctg))
        if entry is None:
            return None
        out.extend(entry[2])
    return out


def calc_score_for_path_inc(graph, path, read_set1, read_set2,
                            insert_mean: float, insert_std: float,
                            exp_cov_move: float, use_all_to_cov: bool,
                            min_prob_per_base: float, min_prob_start: float,
                            changes: List, memo_hits=None) -> int:
    """Per-walk contribution (reference CalcScoreForPathInc,
    graph.cc:1794-1920).  Appends (rid_array, p_array) chunks (pair
    contributions in x-major emission order) to ``changes`` and returns
    this walk's bad bases.  The pair loop runs in the C++ native kernel
    when built (bit-identical float64 sequence).  ``memo_hits``: a
    one-element list, incremented when the contribution memo answers."""
    table = insert_prob_table(insert_mean, insert_std)
    events: List[Tuple[int, int]] = [(0, 1)]
    ctgs, gaps = split_at_gaps(path)

    from ..native import get_lib

    if get_lib() is not None:
        # fully native per-walk pipeline: window staging (python, O(nodes))
        # -> C++ position collection -> C++ two-sided pair loop
        from ..native import collect_positions_ptr, paired_inc_pairs2

        ctgs_with_st = []
        cur_len = 0
        for i, ctg in enumerate(ctgs):
            if i > 0:
                cur_len += gaps[i - 1]
                events.append((cur_len, 1))
            ctgs_with_st.append((ctg, cur_len))
            cur_len += path_len(graph, ctg)
        # contribution memo: the per-walk (rids, ps, bad) is a pure
        # function of walk content for a fixed alignment-cache view; the
        # view only changes when one of the staged streams' missing
        # windows becomes cached, so the entry carries both mates'
        # missing-window lists and revalidates them directly against the
        # caches (version-stamped fast path) — bit-exact by construction
        # and independent of walk-stage-memo eviction.
        wkey = (False, tuple((tuple(c), st) for c, st in ctgs_with_st))
        mkey = (wkey, float(insert_mean), float(insert_std),
                float(exp_cov_move), bool(use_all_to_cov),
                float(min_prob_per_base), float(min_prob_start))
        memo = getattr(read_set1, "_inc_contrib_memo", None)
        if memo is None:
            memo = read_set1._inc_contrib_memo = {}
        hit = memo.get(mkey)
        if hit is not None:
            ok = True
            for rs, vi, mi in ((read_set1, 3, 5), (read_set2, 4, 6)):
                if hit[vi] != rs.cache_version:
                    cache = rs.aligment_cache
                    if any(k in cache for k in hit[mi]):
                        ok = False
                        break
                    hit[vi] = rs.cache_version
            if ok:
                changes.append((hit[0], hit[1]))
                if memo_hits is not None:
                    memo_hits[0] += 1
                return hit[2]
            del memo[mkey]
        v1 = read_set1.cache_version
        v2 = read_set2.cache_version
        pool1 = getattr(read_set1, "_collect_pool", None)
        if pool1 is None:
            pool1 = read_set1._collect_pool = [None]
        pool2 = None  # same-object mates must not share one buffer slot
        if read_set2 is not read_set1:
            pool2 = getattr(read_set2, "_collect_pool", None)
            if pool2 is None:
                pool2 = read_set2._collect_pool = [None]
        staged1 = read_set1.stage_position_windows(graph, ctgs_with_st)
        staged2 = read_set2.stage_position_windows(graph, ctgs_with_st)
        g1 = collect_positions_ptr(
            staged1, pool=pool1, n_reads=read_set1.get_number_of_reads())
        g2 = collect_positions_ptr(
            staged2, pool=pool2, n_reads=read_set2.get_number_of_reads())
        p_arr, rid_arr, ev_pos, ev_typ = paired_inc_pairs2(
            g1, g2,
            read_set1.read_lens_i32(), read_set2.read_lens_i32(),
            np.ascontiguousarray(read_set1.match_probs),
            np.ascontiguousarray(read_set1.mismatch_probs),
            np.ascontiguousarray(read_set2.match_probs),
            np.ascontiguousarray(read_set2.mismatch_probs),
            np.ascontiguousarray(table), float(insert_mean), float(insert_std),
            float(min_prob_start), float(min_prob_per_base), use_all_to_cov)
        changes.append((rid_arr, p_arr))
        from ..native import coverage_sweep as native_sweep

        py_pos = np.array([e[0] for e in events], dtype=np.int32)
        py_typ = np.array([e[1] for e in events], dtype=np.int32)
        bad = int(native_sweep(np.concatenate([py_pos, ev_pos]),
                               np.concatenate([py_typ, ev_typ]),
                               exp_cov_move,
                               insert_mean + 5 * insert_std))
        # store only when no insert wave ran during staging (the streams
        # were all read at versions v1/v2) and both mates' per-contig
        # missing lists are available for future validation
        if read_set1.cache_version == v1 and read_set2.cache_version == v2:
            m1 = _ctg_missing_union(read_set1, ctgs_with_st)
            m2 = _ctg_missing_union(read_set2, ctgs_with_st)
            if m1 is not None and m2 is not None:
                budget = getattr(read_set1, "_inc_contrib_entries", 0)
                if budget > 30_000_000:
                    memo.clear()
                    budget = 0
                read_set1._inc_contrib_entries = budget + len(p_arr)
                memo[mkey] = [rid_arr, p_arr, bad, v1, v2, m1, m2]
        return bad

    positions1: Dict[int, list] = {}
    positions2: Dict[int, list] = {}
    cur_len = 0
    for i, ctg in enumerate(ctgs):
        if i > 0:
            cur_len += gaps[i - 1]
            events.append((cur_len, 1))
        read_set1.get_positions_only_path(graph, ctg, cur_len, positions1)
        read_set2.get_positions_only_path(graph, ctg, cur_len, positions2)
        cur_len += path_len(graph, ctg)

    rids = [rid for rid in sorted(positions1) if rid in positions2]

    chunk_r: List[int] = []
    chunk_p: List[float] = []
    for rid in rids:
        # quirk: threshold uses read_set2's length twice (graph.cc:1855-1857)
        threshold = np.exp(min_prob_start + min_prob_per_base *
                           (read_set2.get_read_len(rid) + read_set2.get_read_len(rid)))
        for x in positions1[rid]:
            for y in positions2[rid]:
                res = _pair_product(read_set1, read_set2, rid,
                                    x.position, x.edit_dist, x.orientation,
                                    y.position, y.edit_dist, y.orientation,
                                    table, insert_mean, insert_std)
                if res is None:
                    continue
                p, _dist = res
                if p > threshold:
                    events.append((max(x.position, y.position), 3))
                    if use_all_to_cov:
                        events.append((min(x.position, y.position), 3))
                chunk_r.append(rid)
                chunk_p.append(p)
    changes.append((np.array(chunk_r, dtype=np.int32),
                    np.array(chunk_p, dtype=np.float64)))
    return _coverage_sweep(events, insert_mean, insert_std, exp_cov_move)


def _state_derived(state: ScoringState, graph):
    """Persistent caches derived from state.old_paths: the walk-multiset
    Counter (so get_changes never rehashes the old side) and the total
    spelled length.  Rebuilt whenever old_paths was replaced externally
    (checkpoint resume, direct assignment in tests) — detected by object
    identity."""
    if getattr(state, "_derived_tag", None) is not state.old_paths:
        state._counter = Counter(map(tuple, state.old_paths))
        state._total_len = paths_total_len(graph, state.old_paths)
        state._derived_tag = state.old_paths
    return state._counter, state._total_len


def _state_log_probs(state: ScoringState) -> np.ndarray:
    """Cached log of state.probs (-inf at zero/negative entries), kept in
    sync by the incremental scorer; rebuilt if probs was replaced."""
    logp = getattr(state, "_log_probs", None)
    if logp is None or getattr(state, "_log_probs_tag", None) is not state.probs:
        with np.errstate(divide="ignore", invalid="ignore"):
            logp = np.where(state.probs > 0, np.log(
                np.where(state.probs > 0, state.probs, 1.0)), -np.inf)
        state._log_probs = logp
        state._log_probs_tag = state.probs
    return logp


def calc_score_for_paths_incremental(graph, paths, read_set1, read_set2,
                                     insert_mean: float, insert_std: float,
                                     scoring_state: ScoringState,
                                     no_cov_penalty: float = 0.0,
                                     exp_cov_move: float = 0.75,
                                     use_all_to_cov: bool = False,
                                     min_prob_per_base: float = -0.7,
                                     min_prob_start: float = -10.0,
                                     keys=None):
    """Incremental rescore (reference CalcScoreForPathsNew,
    graph.cc:1952-1989).  Returns (score, zero_reads, total_len).

    The walk set is tuple-ized exactly once per call (callers scoring the
    same set against several read sets pass shared ``keys`` so it happens
    once per ITERATION); the old side of the multiset diff, the total
    length, and the per-read log probabilities are maintained
    incrementally across calls (all three were per-iteration
    O(assembly)/O(reads) passes before).  Traced as the spans
    ``score.diff``, ``score.align``, ``score.pairs`` and ``score.reduce``
    and the counters ``score.walks`` and ``score.walk_memo_hits``."""
    state = scoring_state
    new_tuples = keys if keys is not None else \
        [p if type(p) is tuple else tuple(p) for p in paths]
    with span("score.diff"):
        counter, old_total = _state_derived(state, graph)

        # multiset diff against the persistent counter (reference
        # GetChanges, graph.cc:1745-1764); dict.copy() copies hash
        # entries, so the old side costs no rehashing
        remaining = counter.copy()
        added: List[tuple] = []
        get = remaining.get
        for key in new_tuples:
            c = get(key, 0)
            if c > 0:
                remaining[key] = c - 1
            else:
                added.append(key)
        erased = [key for key, cnt in remaining.items() for _ in range(cnt)]

        n = read_set1.get_number_of_reads()
        assert n == read_set2.get_number_of_reads()
        if len(state.probs) == 0:
            state.probs = np.zeros(n, dtype=np.float64)
        total = old_total
        if added or erased:
            # vectorized walk lengths (the python per-entry loop was the
            # hottest pure-python line at late phase)
            lens_np = graph.lens_np()

            def plen(t):
                a = np.asarray(t, dtype=np.int64)
                return int(np.where(a >= 0, lens_np[np.maximum(a, 0)],
                                    -a).sum()) if len(a) else 0

            for p in added:
                total += plen(p)
            for p in erased:
                total -= plen(p)
    with span("score.align"):
        read_set1.precompute_alignment_for_paths(paths, graph,
                                                 keys=new_tuples)
        read_set2.precompute_alignment_for_paths(paths, graph,
                                                 keys=new_tuples)

    device = getattr(state, "device", None)
    with span("score.pairs"):
        logp = None if device is not None else _state_log_probs(state)
        touched: List[np.ndarray] = []
        memo_hits = [0]
        for group, sign in ((erased, -1), (added, +1)):
            group_changes: List = []
            group_bad = 0
            for path in group:
                group_bad += calc_score_for_path_inc(
                    graph, path, read_set1, read_set2, insert_mean,
                    insert_std, exp_cov_move, use_all_to_cov,
                    min_prob_per_base, min_prob_start, group_changes,
                    memo_hits)
            state.bad_bases += sign * group_bad
            for rid_arr, p_arr in group_changes:
                if device is not None:
                    # sharded on-device running totals (opt-in scale path)
                    device.apply(rid_arr, p_arr, sign)
                    continue
                # unbuffered in-order accumulation (np.add.at), matching
                # the reference's sequential probs[read] += p
                np.add.at(state.probs, rid_arr, sign * p_arr)
                touched.append(rid_arr)
        if touched:
            # no dedup needed: probs is final here, so duplicate rids
            # write the same value (np.unique's sort was a per-iteration
            # O(pairs log pairs) cost)
            rids = np.concatenate(touched) if len(touched) > 1 \
                else touched[0]
            vals = state.probs[rids]
            pos = vals > 0
            with np.errstate(divide="ignore", invalid="ignore"):
                logp[rids] = np.where(pos, np.log(np.where(pos, vals, 1.0)),
                                      -np.inf)
    count("score.walks", len(erased) + len(added))
    count("score.walk_memo_hits", memo_hits[0])

    with span("score.reduce"):
        if device is not None:
            score, zero_reads = device.reduce(total, min_prob_per_base,
                                              min_prob_start)
        else:
            lens = _pair_lens(read_set1, read_set2)
            score, zero_reads = get_total_prob_from_logs(
                logp, total, min_prob_per_base, min_prob_start, lens)

    # fold the diff into the persistent caches and store the new walk set
    for key in added:
        counter[key] += 1
    for key in erased:
        c = counter[key] - 1
        if c:
            counter[key] = c
        else:
            del counter[key]
    state.old_paths = new_tuples
    state._counter = counter
    state._total_len = total
    state._derived_tag = state.old_paths
    return score - state.bad_bases * no_cov_penalty, zero_reads, total
