"""Gap-length fitting moves (reference FixGapLength family,
moves.cc:694-800 and moves.cc:1080-1092).

Note on batching: gap-length probes change NO alignment windows (windows
stop at gap entries, so only event offsets and pair distances move) —
the incremental scorer reuses every alignment across probes and there is
nothing for a multi-candidate window prefetch (ProbCalculator.score_batch)
to batch; probes stay sequential by design."""
from __future__ import annotations

from typing import List

from ..core.paths import Path


def _fix_gap_inner(paths: List[Path], path_id: int, gap_pos: int,
                   prob_calc, lower: int, upper: int) -> None:
    """Ternary-style refinement (reference moves.cc:694-727).  The 2-point
    case preserves the reference quirk of overwriting the midpoint with
    ``lower`` before probing, making both probes identical
    (moves.cc:702-712)."""
    if upper - lower <= 1:
        paths[path_id][gap_pos] = -lower
        return
    if upper - lower == 2:
        paths[path_id][gap_pos] = -((upper + lower) // 2)
        paths[path_id][gap_pos] = -lower
        low_p = prob_calc.score(paths)
        mid_p = prob_calc.score(paths)
        if mid_p > low_p:
            return
        paths[path_id][gap_pos] = -lower
        return
    mid1 = lower + (upper - lower) // 3
    mid2 = lower + (upper - lower) // 3 * 2
    paths[path_id][gap_pos] = -mid1
    mid1_p = prob_calc.score(paths)
    paths[path_id][gap_pos] = -mid2
    mid2_p = prob_calc.score(paths)
    if mid1_p >= mid2_p:
        _fix_gap_inner(paths, path_id, gap_pos, prob_calc, lower, mid2)
    else:
        _fix_gap_inner(paths, path_id, gap_pos, prob_calc, mid1, upper)


def fix_gap_length(paths: List[Path], path_id: int, gap_pos: int,
                   prob_calc, prev_len: int = -1) -> bool:
    """Hill-climb one gap's length: probe +-1 to pick a direction,
    double for an upper bracket, then refine (reference moves.cc:729-800)."""
    cur_length = -paths[path_id][gap_pos]
    assert cur_length > 0
    state = 0  # 0 minimum, 1 up, 2 down
    cur_p = prob_calc.score(paths)
    paths[path_id][gap_pos] = -(cur_length + 1)
    up_p = prob_calc.score(paths)
    if cur_length == 1:
        if up_p > cur_p:
            state = 1
    else:
        paths[path_id][gap_pos] = -(cur_length - 1)
        down_p = prob_calc.score(paths)
        if down_p > cur_p > up_p:
            state = 2
        if up_p > cur_p > down_p:
            state = 1
    if state == 0:
        # faithful to the reference: the gap stays at its last probed value
        # (cur_length-1, or cur_length+1 when cur_length==1) — the change
        # rides into the proposal and the acceptance test decides its fate
        # (moves.cc:741-759 with the by-reference paths in gaml.cc:204-206)
        return True
    if state == 1:
        last_p = cur_p
        upper_bound = cur_length * 2
        while True:
            paths[path_id][gap_pos] = -upper_bound
            probe = prob_calc.score(paths)
            if probe < last_p:
                break
            last_p = probe
            upper_bound *= 2
        _fix_gap_inner(paths, path_id, gap_pos, prob_calc,
                       cur_length + 1, upper_bound)
    if state == 2:
        _fix_gap_inner(paths, path_id, gap_pos, prob_calc, 1, cur_length)
    return True


def fix_random_gap_length(paths: List[Path], prob_calc, rng) -> bool:
    """Dispatcher: pick a random gap across all walks
    (reference moves.cc:1080-1092)."""
    opts = []
    for i, p in enumerate(paths):
        for j, e in enumerate(p):
            if e < 0:
                opts.append((i, j))
    if not opts:
        return False
    i, j = opts[rng.randint(len(opts))]
    return fix_gap_length(paths, i, j, prob_calc, -1)
