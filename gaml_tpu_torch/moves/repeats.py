"""Repeat-resolution moves (reference moves.cc:1094-1493)."""
from __future__ import annotations

from typing import List

from ..core.paths import Path, reverse_path


def _strand_collapse(e: int) -> int:
    return (e // 2) * 2


def _tail_swap_candidates(paths, poses):
    """Candidate walk-sets of the tail-swap phase, in scoring order
    (reference moves.cc:1158-1204).  Yields (pi, pj, paths2)."""
    out = []
    for i in range(len(poses)):
        for j in range(i):
            if poses[i][0] == poses[j][0]:
                continue
            paths2 = [list(p) for p in paths]
            pi, pj = poses[i], poses[j]
            p1 = paths[pi[0]]
            p2 = paths[pj[0]]
            if p1[pi[1]] == p2[pj[1]]:  # same strand: swap tails
                pp1 = p1[:pi[1]] + p2[pj[1]:]
                pp2 = p2[:pj[1]] + p1[pi[1]:]
            else:  # opposite strand splice
                s1 = p1[:pi[1] + 1]
                e1 = p1[pi[1] + 1:]
                s2 = list(p2[:pj[1]])
                e2 = list(p2[pj[1]:])
                reverse_path(s2)
                reverse_path(e2)
                pp1 = s1 + s2
                pp2 = e2 + e1
            paths2[pi[0]] = pp1
            paths2[pj[0]] = pp2
            hi, lo = max(pi[0], pj[0]), min(pi[0], pj[0])
            if len(paths2[hi]) <= 1:
                del paths2[hi]
            if len(paths2[lo]) <= 1:
                del paths2[lo]
            out.append((pi, pj, paths2))
    return out


def _transplant_candidates(paths, poses, doubles):
    """Candidate walk-sets of the double-occurrence loop-transplant phase
    (reference moves.cc:1205-1281).  Yields (pi, double, paths2)."""
    out = []
    for i in range(len(poses)):
        for dj in range(len(doubles)):
            paths2 = [list(p) for p in paths]
            pi = poses[i]
            d_path, d_a, d_b = doubles[dj]
            if pi[0] != d_path:
                p1 = paths[pi[0]][:pi[1]]
                p2 = paths[d_path][:d_a] + paths[d_path][d_b:]
                pj_seg = paths[d_path][d_a:d_b + 1]
                if pj_seg[0] != paths[pi[0]][pi[1]]:
                    reverse_path(pj_seg)
                p1 = p1 + pj_seg + paths[pi[0]][pi[1] + 1:]
                paths2[pi[0]] = p1
                paths2[d_path] = p2
            else:
                pj_seg = paths[d_path][d_a:d_b]
                if pj_seg and pj_seg[0] != paths[pi[0]][pi[1]]:
                    reverse_path(pj_seg)
                    pj_seg.insert(0, pj_seg.pop())
                if pi[1] < d_a:
                    p1 = list(paths[pi[0]])
                    del p1[d_a:d_b]
                    p1[pi[1]:pi[1]] = pj_seg
                    paths2[pi[0]] = p1
                elif pi[1] > d_b:
                    p1 = list(paths[pi[0]])
                    p1[pi[1]:pi[1]] = pj_seg
                    del p1[d_a:d_b]
                    paths2[pi[0]] = p1
                else:
                    continue
            if len(paths2[d_path]) <= 1:
                del paths2[d_path]
            out.append((pi, doubles[dj], paths2))
    return out


def _reversal_candidates(paths, pals):
    """Candidate walk-sets of the palindromic-reversal phase (reference
    moves.cc:1282-1305).  Yields ((pi, a, b), paths2)."""
    out = []
    for (pi, a, b) in pals:
        paths2 = [list(p) for p in paths]
        seg = paths2[pi][a:b + 1]
        reverse_path(seg)
        paths2[pi][a:b + 1] = seg
        out.append(((pi, a, b), paths2))
    return out


def fix_rep_for_node2(paths: List[Path], gr, threshold: int,
                      disjoin_similar: bool, node: int, prob_calc) -> None:
    """Hill-climb repeat resolution for one strand-collapsed node: try
    tail swaps between occurrence pairs, double-occurrence loop
    transplants, and palindromic segment reversals; recurse on improvement;
    in postprocess mode score-ties are split apart
    (reference FixRepForNode2, moves.cc:1129-1324).

    Every round's candidate set is known before any scoring, so the
    round's missing alignment windows are union-prefilled in ONE batched
    aligner dispatch (ProbCalculator.prefetch_candidates) and the
    sequential early-exit scoring then runs entirely from cache — the
    trajectory is bit-identical to unprefetched sequential scoring
    (window alignments are pure functions of window content), with one
    device round trip per round instead of per candidate."""
    poses = []
    doubles = []
    pals = []
    for i, p in enumerate(paths):
        lp = -1
        cur_poses = []
        for j, e in enumerate(p):
            if e < 0:
                continue
            if _strand_collapse(e) == node:
                poses.append((i, j))
                if lp != -1 and p[j] == p[lp]:
                    doubles.append((i, lp, j))
                lp = j
                for k in cur_poses:
                    if p[j] != p[k]:
                        pals.append((i, k, j))
                cur_poses.append(j)
    cur_score = prob_calc.score(paths)
    disjoint = set()

    cand_tail = _tail_swap_candidates(paths, poses)
    cand_dbl = _transplant_candidates(paths, poses, doubles)
    cand_pal = _reversal_candidates(paths, pals)
    prefetch = getattr(prob_calc, "prefetch_candidates", None)
    if prefetch is not None:
        prefetch([c[-1] for c in cand_tail]
                 + [c[-1] for c in cand_dbl]
                 + [c[-1] for c in cand_pal])

    # tail swaps between occurrences in different walks (moves.cc:1158-1204)
    for pi, pj, paths2 in cand_tail:
        score = prob_calc.score(paths2)
        if abs(score - cur_score) < 0.001 and disjoin_similar:
            disjoint.add(pi)
            disjoint.add(pj)
        if score > cur_score:
            paths[:] = paths2
            fix_rep_for_node2(paths, gr, threshold, disjoin_similar,
                              node, prob_calc)
            return

    # double-occurrence loop transplants (moves.cc:1205-1281)
    for pi, (d_path, d_a, d_b), paths2 in cand_dbl:
        score = prob_calc.score(paths2)
        if abs(score - cur_score) < 0.002 and disjoin_similar:
            disjoint.add(pi)
            disjoint.add((d_path, d_a))
            disjoint.add((d_path, d_b))
        if score > cur_score:
            paths[:] = paths2
            fix_rep_for_node2(paths, gr, threshold, disjoin_similar,
                              node, prob_calc)
            return

    # palindromic segment reversals (moves.cc:1282-1305)
    for (pi, a, b), paths2 in cand_pal:
        score = prob_calc.score(paths2)
        if abs(score - cur_score) < 0.002 and disjoin_similar:
            disjoint.add((pi, a))
            disjoint.add((pi, b))
        if score > cur_score:
            paths[:] = paths2
            fix_rep_for_node2(paths, gr, threshold, disjoin_similar,
                              node, prob_calc)
            return

    if disjoin_similar:
        for (pi, j) in sorted(disjoint, reverse=True):
            paths.append(paths[pi][j:])
            del paths[pi][j + 1:]
            if not paths[pi]:
                del paths[pi]


def _repeated_long_nodes(paths: List[Path], gr, threshold: int) -> List[int]:
    counts = {}
    for p in paths:
        for e in p:
            if e < 0:
                continue
            if gr.node_len(e) > threshold:
                key = _strand_collapse(e)
                counts[key] = counts.get(key, 0) + 1
    return [k for k, v in counts.items() if v >= 2]


def fix_big_reps(paths: List[Path], gr, threshold: int, disjoin_similar: bool,
                 prob_calc) -> bool:
    """Resolve every repeated long node (postprocess mode)
    (reference FixBigReps, moves.cc:1326-1348)."""
    for node in _repeated_long_nodes(paths, gr, threshold):
        fix_rep_for_node2(paths, gr, threshold, disjoin_similar, node, prob_calc)
    return True


def fix_some_big_reps(paths: List[Path], gr, threshold: int,
                      disjoin_similar: bool, prob_calc, rng) -> bool:
    """Resolve one random repeated long node (interchange move)
    (reference FixSomeBigReps, moves.cc:1350-1372)."""
    rr = _repeated_long_nodes(paths, gr, threshold)
    if not rr:
        return False
    node = rr[rng.randint(len(rr))]
    fix_rep_for_node2(paths, gr, threshold, disjoin_similar, node, prob_calc)
    return True


def split_on_node(node: int, paths: List[Path]) -> None:
    """Cut every walk at each occurrence of a strand-collapsed node
    (reference SplitOnNode, moves.cc:1094-1127)."""
    paths2 = [list(p) for p in paths]
    with_node = []
    for i in range(len(paths2) - 1, -1, -1):
        if any(e >= 0 and _strand_collapse(e) == node for e in paths2[i]):
            with_node.append(paths2[i])
            paths2[i], paths2[-1] = paths2[-1], paths2[i]
            paths2.pop()
    for p in with_node:
        last = 0
        for i in range(1, len(p)):
            if p[i] >= 0 and _strand_collapse(p[i]) == node:
                paths2.append(p[last:i + 1])
                last = i
        if last != len(p) - 1:
            paths2.append(p[last:])
    paths[:] = paths2


def fix_rep_for_node(node: int, paths: List[Path], threshold: int, gr,
                     prob_calc) -> bool:
    """Brute-force repeat resolver: cut all walks at the node, try every
    before/after arm pairing, keep the best-scoring matching (reference
    FixRepForNode, moves.cc:1374-1493; unused by the reference Optimize but
    part of the public move surface)."""
    from itertools import permutations

    paths2 = [list(p) for p in paths]
    with_node = []
    for i in range(len(paths2) - 1, -1, -1):
        if any(e >= 0 and _strand_collapse(e) == node for e in paths2[i]):
            with_node.append(paths2[i])
            paths2[i], paths2[-1] = paths2[-1], paths2[i]
            paths2.pop()

    before, after = [], []
    for p in with_node:
        last = -1
        last_inv = False
        for j, e in enumerate(p):
            if e >= 0 and _strand_collapse(e) == node:
                if last != -1:
                    return False  # self repeat
                if e == node:
                    last_inv = False
                    before.append(p[last + 1:j])
                else:
                    seg = p[last + 1:j]
                    reverse_path(seg)
                    after.append(seg)
                    last_inv = True
                last = j
        assert last != -1
        if not last_inv:
            after.append(p[last + 1:])
        else:
            seg = p[last + 1:]
            reverse_path(seg)
            before.append(seg)

    all_opts = list(permutations(range(len(after))))
    cands = []
    for opts in all_opts:
        paths3 = [list(p) for p in paths2]
        for i in range(min(len(opts), len(before))):
            pp = list(before[i]) + [node] + list(after[opts[i]])
            if len(pp) > 1:
                paths3.append(pp)
        cands.append(paths3)
    # every pairing is evaluated, so the batched union prefill + scoring
    # is trajectory-identical to the sequential loop (score_batch
    # contract) with one aligner dispatch for the whole enumeration
    score_batch = getattr(prob_calc, "score_batch", None)
    scores = score_batch(cands) if score_batch is not None else \
        [prob_calc.score(c) for c in cands]
    best_opts = None
    best_score = -1e6
    for opts, score in zip(all_opts, scores):
        if score > best_score:
            best_score = score
            best_opts = opts
    paths3 = [list(p) for p in paths2]
    for i in range(min(len(best_opts), len(before))):
        pp = list(before[i]) + [node] + list(after[best_opts[i]])
        if len(pp) > 1:
            paths3.append(pp)
    paths[:] = paths3
    return True
