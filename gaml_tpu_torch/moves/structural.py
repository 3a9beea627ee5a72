"""Structural moves: disconnect, local reroute, guided local reroute, and
the smaller unused-but-present reference helpers.

All moves mutate the passed walk list in place and return True on success
(reference moves.cc).  Callers pass copies and discard on failure, matching
the reference driver (gaml.cc:151-213).
"""
from __future__ import annotations

from typing import List

from ..core.paths import Path


def break_path(new_paths: List[Path], gr, threshold: int, rng) -> bool:
    """Split a walk between a random adjacent long-node pair, duplicating
    the boundary nodes into both halves (reference BreakPath,
    moves.cc:4-41)."""
    options = []
    for i, path in enumerate(new_paths):
        if len(path) <= 1:
            continue
        last = -1
        for j, e in enumerate(path):
            if e >= 0 and gr.node_len(e) > threshold:
                if last != -1:
                    options.append((i, last, j))
                last = j
    if not options:
        return False
    path_id, a, b = options[rng.randint(len(options))]
    path = new_paths[path_id]
    del new_paths[path_id]
    new_paths.append(path[:a + 1])
    new_paths.append(path[b:])
    return True


def local_change2(new_paths: List[Path], gr, threshold: int, path_id: int,
                  ps: int, pt: int, prob_calc, rng) -> bool:
    """Guided reroute: detach suffix/prefix at (ps, pt) and greedily rebuild
    ps->pt, scoring two candidate extensions per step with the full
    likelihood and keeping the better (reference LocalChange2,
    moves.cc:43-132)."""
    path = new_paths[path_id]
    assert gr.node_len(path[ps]) > threshold
    assert gr.node_len(path[pt]) > threshold
    elength = threshold
    gap = False
    for i in range(ps + 1, pt):
        if path[i] < 0:
            elength += -path[i]
            gap = True
        else:
            elength += gr.node_len(path[i])
    del new_paths[path_id]
    new_paths.append(path[pt:])
    new_paths.append(path[:ps + 1])

    expect = path[pt]
    max_extend = (pt - ps) * 2
    total_added = 0
    last_path = list(new_paths[-1])
    start_size = len(last_path)
    while last_path[-1] != expect:
        if (len(last_path) > start_size + max_extend and not gap) or \
                total_added > 3 * elength:
            return False
        cand_ends = []
        cand_add = []
        for _ in range(2):
            cp = list(last_path)
            added_l = 0
            while True:
                fails = 0
                while True:
                    if fails >= 20:
                        return False
                    nxt = gr.sample_next(cp[-1], rng)
                    if nxt is None:
                        return False
                    fails += 1
                    if gr.node_len(nxt) > 2 * elength and nxt != expect:
                        continue
                    if expect in gr.reach_limit[nxt] or nxt == expect:
                        break
                cp.append(nxt)
                if nxt == expect:
                    break
                added_l += gr.node_len(nxt)
                if added_l > 200:
                    break
            cand_ends.append(cp)
            cand_add.append(added_l)
        if hasattr(prob_calc, "score_batch"):
            # both candidates always get scored: one batched window
            # prefetch (single aligner dispatch), then sequential scores —
            # bit-identical to the plain loop (see score_batch)
            variants = [new_paths[:-1] + [cand] for cand in cand_ends]
            scores = prob_calc.score_batch(variants)
        else:
            scores = []
            for cand in cand_ends:
                new_paths[-1] = cand
                scores.append(prob_calc.score(new_paths))
        best = max(range(len(scores)), key=lambda i: (scores[i], -i))
        last_path = cand_ends[best]
        total_added += cand_add[best]
        new_paths[-1] = last_path
    assert new_paths[-1][-1] == new_paths[-2][0]
    op = list(new_paths[-1]) + new_paths[-2][1:]
    new_paths[-2] = op
    new_paths.pop()
    return True


def local_change(new_paths: List[Path], gr, threshold: int, prob_calc, rng):
    """Local reroute between two long anchors (reference LocalChange,
    moves.cc:197-324).  Returns (ok, path_id, xx, yy); path_id == -1 when
    the move delegated to local_change2 (long/gapped windows — the
    reference's ``rand() % 2 <= 1`` gate is always true, moves.cc:269)."""
    options = []
    for i, path in enumerate(new_paths):
        if len(path) <= 1:
            continue
        lp = []
        pos = 0
        for j, e in enumerate(path):
            if e >= 0 and gr.node_len(e) > threshold:
                lp.append((pos, j))
            pos += -e if e < 0 else gr.node_len(e)
        for j in range(1, len(lp)):
            options.append((i, lp[j - 1][1], lp[j][1]))
            k = 2
            while j - k >= 0:
                if lp[j][0] - lp[j - k][0] < 5000:
                    options.append((i, lp[j - k][1], lp[j][1]))
                else:
                    break
                k += 1
    if not options:
        return False, -1, -1, -1
    path_id, s_idx, t_idx = options[rng.randint(len(options))]
    has_gap = any(new_paths[path_id][i] < 0 for i in range(s_idx, t_idx + 1))
    if t_idx - s_idx > 7 or has_gap:
        rng.randint(2)  # reference consumes a rand() here (moves.cc:269)
        ok = local_change2(new_paths, gr, threshold, path_id, s_idx, t_idx,
                           prob_calc, rng)
        return ok, -1, -1, -1

    path = new_paths[path_id]
    t = path[t_idx]
    xx = s_idx
    p2 = path[:s_idx + 1]
    found = False
    for _extend in range(2 * (t_idx - s_idx + 1)):
        tries = 0
        nxt = None
        while True:
            tries += 1
            if tries > 100:
                return False, -1, -1, -1
            nxt = gr.sample_next(p2[-1], rng)
            if nxt is None:
                return False, -1, -1, -1
            if t in gr.reach_limit[nxt] or nxt == t:
                break
        if nxt == t:
            found = True
            break
        p2.append(nxt)
    if not found:
        return False, -1, -1, -1
    yy = len(p2)
    p2.extend(path[t_idx:])
    new_paths[path_id] = p2
    assert new_paths[path_id][xx] == path[s_idx]
    assert new_paths[path_id][yy] == t
    return True, path_id, xx, yy


def fix_self_loops(new_paths: List[Path], gr, threshold: int, rng) -> bool:
    """Insert a random <=4-hop self-cycle before a node occurrence
    (reference FixSelfLoops, moves.cc:326-356; present but disabled in the
    reference's LocalChange dispatch)."""
    path_id = rng.randint(len(new_paths))
    path = new_paths[path_id]
    opts = [i for i, e in enumerate(path)
            if e >= 0 and len(gr.reach_self[e]) > 0]
    if not opts:
        return False
    opt = opts[rng.randint(len(opts))]
    loops = gr.reach_self[path[opt]]
    ip = loops[rng.randint(len(loops))]
    new_paths[path_id] = path[:opt] + list(ip) + path[opt:]
    return True


def fix_multi_local(new_paths: List[Path], gr, threshold: int, rng) -> bool:
    """Swap the two segments between three occurrences of a node
    (reference FixMultiLocal, moves.cc:134-163; disabled in dispatch)."""
    path_id = rng.randint(len(new_paths))
    path = new_paths[path_id]
    poses = {}
    for i, e in enumerate(path):
        if e < 0:
            continue
        poses.setdefault(e, []).append(i)
    opts = []
    for locs in poses.values():
        for i in range(2, len(locs)):
            opts.append((locs[i - 2], locs[i - 1], locs[i]))
    if not opts:
        return False
    a, b, c = opts[rng.randint(len(opts))]
    npath = list(path)
    pp = a
    for i in range(b, c):
        npath[pp] = path[i]
        pp += 1
    for i in range(a, b):
        npath[pp] = path[i]
        pp += 1
    assert pp == c
    new_paths[path_id] = npath
    return True


def fix_rep(new_paths: List[Path], gr, threshold: int, rng) -> bool:
    """Duplicate or remove the segment between two occurrences of a node
    (reference FixRep, moves.cc:165-195; disabled in dispatch)."""
    path_id = rng.randint(len(new_paths))
    path = new_paths[path_id]
    poses = {}
    for i, e in enumerate(path):
        if e < 0:
            continue
        poses.setdefault(e, []).append(i)
    opts = []
    for locs in poses.values():
        for i in range(1, len(locs)):
            opts.append((locs[i - 1], locs[i]))
    if not opts:
        return False
    a, b = opts[rng.randint(len(opts))]
    if rng.randint(4) == 0:  # double
        new_paths[path_id] = path[:b] + path[a:b] + path[b:]
    else:  # remove
        new_paths[path_id] = path[:a] + path[b:]
    return True
