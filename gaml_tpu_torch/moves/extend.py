"""Extend/join moves (reference ExtendPaths / ExtendPathsAlt,
moves.cc:358-692)."""
from __future__ import annotations

import math
from typing import Dict, List

from ..core.paths import Path, reverse_path
from .structural import local_change2


def sample_path_by_length(paths: List[Path], gr, rng) -> int:
    """Sample a walk with probability ~ sqrt(len + 10)
    (reference SamplePathByLength, moves.cc:668-692; the C++ truncates the
    sqrt to int before the roulette)."""
    lens = []
    for p in paths:
        ln = 0
        for e in p:
            ln += gr.node_len(e) if e >= 0 else -e
        lens.append(int(math.sqrt(ln + 10)))
    ss = sum(lens)
    r = rng.randint(ss)
    acc = 0
    for i, ln in enumerate(lens):
        acc += ln
        if r < acc:
            return i
    return len(paths) - 1


def _build_path_ends(paths: List[Path]) -> Dict[int, List[int]]:
    """first-node -> +(i+1), inverted-last-node -> -(i+1)
    (reference moves.cc:569-573)."""
    ends: Dict[int, List[int]] = {}
    for i, p in enumerate(paths):
        ends.setdefault(p[0], []).append(i + 1)
        ends.setdefault(p[-1] ^ 1, []).append(-(i + 1))
    return ends


def _resolve_join(paths: List[Path], join: int):
    """Returns (join_num, join_path oriented so join_path[0] is the node
    being joined onto)."""
    if join < 0:
        join_num = -join - 1
        join_path = list(reversed(paths[join_num]))
        join_path = [(e ^ 1) if e >= 0 else e for e in join_path]
    else:
        join_num = join - 1
        join_path = list(paths[join_num])
    return join_num, join_path


def _random_walk_extend(path: Path, gr, rng) -> bool:
    """Append long nodes via reach_big with continuation prob
    exp(-added/1000) (reference moves.cc:583-608).  Returns False when the
    walk is stuck with nothing added."""
    add_length = 0
    if path[-1] < 0:
        # walk ends with a scaffold gap: nothing to extend from (the
        # reference would index reach_big_ with a negative id here — UB)
        return False
    while True:
        next_cand = list(gr.reach_big[path[-1]].keys())
        if not next_cand and add_length == 0:
            return False
        if not next_cand:
            return True
        nxt = next_cand[rng.randint(len(next_cand))]
        s = path[-1]
        for e in gr.reach_big[s][nxt]:
            path.append(e)
            add_length += gr.node_len(e)
        path.append(nxt)
        add_length += gr.node_len(nxt)
        if rng.uniform() > math.exp(-add_length / 1000.0):
            return True


def extend_paths_alt(paths: List[Path], gr, threshold: int, rng) -> bool:
    """Extend allowing joins into the *middle* of another walk, 2-opt style
    (reference ExtendPathsAlt, moves.cc:358-541).  Mutates ``paths`` even on
    some failure paths, like the reference — callers pass a copy."""
    if not paths:
        return False  # reference: rand() % 0 (UB)
    for i in range(len(paths)):
        if rng.randint(2) == 0:
            reverse_path(paths[i])

    rp = rng.randint(len(paths))
    rev = rng.randint(2)
    path = list(paths[rp])
    del paths[rp]
    if rev:
        reverse_path(path)

    path_ends = _build_path_ends(paths)
    path_poses: Dict[int, List] = {}
    for i, p in enumerate(paths):
        for j in range(1, len(p) - 1):
            if p[j] >= 0 and gr.node_len(p[j]) > threshold:
                path_poses.setdefault(p[j], []).append((i, j))
                path_poses.setdefault(p[j] ^ 1, []).append((i, j))

    found = False
    join = 0
    if path[-1] in path_ends and len(path) > 1:
        ends = path_ends[path[-1]]
        join = ends[rng.randint(len(ends))]
        found = True
    if not found:
        if not _random_walk_extend(path, gr, rng):
            return False
    if path[-1] in path_ends:
        ends = path_ends[path[-1]]
        join = ends[rng.randint(len(ends))]
        join_num, join_path = _resolve_join(paths, join)
        assert path[-1] == join_path[0]
        path.extend(join_path[1:])
        del paths[join_num]
        paths.append(path)
        return True
    if not path_poses.get(path[-1]):
        return False
    pp_i, pp_j = path_poses[path[-1]][rng.randint(len(path_poses[path[-1]]))]
    if paths[pp_i][pp_j] != path[-1]:
        return False
    # split the other walk at the middle hit and try to rejoin its tail
    # ("2opt extend", moves.cc:449-536)
    path2 = list(paths[pp_i])
    del paths[pp_i]
    path.extend(path2[pp_j + 1:])
    path_ends = _build_path_ends(paths)
    path2 = path2[:pp_j + 1]
    path, path2 = path2, path
    found = False
    if path[-1] in path_ends and len(path) > 1:
        # reference quirk: an immediate end match sets found=true but the
        # join code lives inside the !found branch, so the move fails
        # (moves.cc:472-475 vs 536)
        found = True
    if not found:
        # reference quirk: 5 walk attempts with no early break, sharing
        # add_length (compounding the stop probability); the last attempt
        # wins (moves.cc:477-507)
        add_length = 0
        path_zal = list(path)
        for _tries in range(5):
            path = list(path_zal)
            while True:
                next_cand = list(gr.reach_big[path[-1]].keys())
                if not next_cand and add_length == 0:
                    return False
                if not next_cand:
                    break
                nxt = next_cand[rng.randint(len(next_cand))]
                s = path[-1]
                for e in gr.reach_big[s][nxt]:
                    path.append(e)
                    add_length += gr.node_len(e)
                path.append(nxt)
                add_length += gr.node_len(nxt)
                if rng.uniform() > math.exp(-add_length / 1000.0):
                    break
        if path[-1] in path_ends:
            ends = path_ends[path[-1]]
            join = ends[rng.randint(len(ends))]
            join_num, join_path = _resolve_join(paths, join)
            assert path[-1] == join_path[0]
            path.extend(join_path[1:])
            del paths[join_num]
            paths.append(path)
            paths.append(path2)
            return True
    return False


def extend_paths(new_paths: List[Path], gr, threshold: int, prob_calc, rng) -> bool:
    """Extend/join move (reference ExtendPaths, moves.cc:543-666).

    Quirk preserved: after five failed ExtendPathsAlt attempts the
    reference's bare ``false;`` statement (moves.cc:553) falls through to
    the normal extension instead of returning."""
    if not new_paths:
        # empty walk set (e.g. threshold above every node): the reference
        # hits rand() % 0 here (moves.cc:556, UB) — fail the move instead
        return False
    if rng.randint(7) == 0:
        for _ in range(5):
            pp = [list(p) for p in new_paths]
            if extend_paths_alt(pp, gr, threshold, rng):
                new_paths[:] = pp
                return True
        # missing return in the reference: fall through to normal extend

    found = False
    rp = rng.randint(len(new_paths))
    rev = rng.randint(2)
    path = list(new_paths[rp])
    ps = len(path) - 1
    if rev == 1:
        reverse_path(path)

    path_ends = _build_path_ends(new_paths)
    join = 0
    if path[-1] in path_ends and len(new_paths[rp]) > 1:
        ends = path_ends[path[-1]]
        join = ends[rng.randint(len(ends))]
        found = True
    if not found:
        if not _random_walk_extend(path, gr, rng):
            return False
        if path[-1] in path_ends:
            ends = path_ends[path[-1]]
            join = ends[rng.randint(len(ends))]
            found = True
        if rng.randint(5) == 0:
            found = True
    if not found:
        return False
    pt = len(path) - 1

    if join != 0:
        join_num, join_path = _resolve_join(new_paths, join)
        assert path[-1] == join_path[0]
        if join_num != rp:
            path.extend(join_path[1:])
        del new_paths[max(join_num, rp)]
        if join_num != rp:
            del new_paths[min(join_num, rp)]
        new_paths.append(path)
    else:
        del new_paths[rp]
        new_paths.append(path)

    paths2 = [list(p) for p in new_paths]
    if local_change2(paths2, gr, threshold, len(paths2) - 1, ps, pt,
                     prob_calc, rng):
        new_paths[:] = paths2
    return True
