"""Join-by-advice moves (reference ExtendPathsAdv, moves.cc:802-1078).

Paired variant: align advice mate-1 reads to the sampled walk, map forward
hits through mate-2's advice index to candidate long nodes, connect via
reach_limit or a fresh -21 gap, join onto another walk's end, refine.

PacBio variant: reads anchored at the walk's last node map through the
anchor reverse index to long nodes sharing a spanning read; gap length is
estimated from the read itself.
"""
from __future__ import annotations

from typing import List

from ..core.paths import Path, reverse_path
from .extend import sample_path_by_length, _build_path_ends, _resolve_join
from .gaps import fix_gap_length
from .structural import local_change2


def _join_onto_end(paths: List[Path], path: Path, path_ends, rng):
    """Common join tail: returns join code or 0."""
    if path[-1] in path_ends:
        ends = path_ends[path[-1]]
        return ends[rng.randint(len(ends))]
    return 0


def _advice_csr(rs2):
    """advice_index1 as CSR arrays (rid-sorted) for vectorized candidate
    collection; built once per read set."""
    import numpy as np

    csr = getattr(rs2, "_advice_csr1", None)
    if csr is None:
        items = sorted(rs2.advice_index1.items())
        rids = np.array([k for k, _ in items], dtype=np.int64)
        off = np.zeros(len(items) + 1, dtype=np.int64)
        nodes_l: List[int] = []
        for i, (_k, v) in enumerate(items):
            off[i + 1] = off[i] + len(v)
            nodes_l.extend(v)
        csr = rs2._advice_csr1 = (rids, off,
                                  np.array(nodes_l, dtype=np.int64))
    return csr


def _reach_keys(gr, node):
    """Sorted key array of gr.reach_limit[node] (keys are static after
    the precompute — accept write-backs only reassign values)."""
    import numpy as np

    cache = getattr(gr, "_reach_limit_keys", None)
    if cache is None:
        cache = gr._reach_limit_keys = {}
    arr = cache.get(node)
    if arr is None:
        arr = cache[node] = np.array(sorted(gr.reach_limit[node]),
                                     dtype=np.int64)
    return arr


def _collect_candidates(rs2, gr, fwd_first_rids, path_v, path_last,
                        only_out: bool, allow_gaps_flag: bool):
    """Vectorized, emission-order-preserving candidate collection
    (reference moves.cc:964-987): rows in fwd_first_rids order, each
    rid's advice nodes in index order, filtered by path membership and
    reach_limit."""
    import numpy as np

    rids_s, off, nodes = _advice_csr(rs2)
    if len(fwd_first_rids) == 0 or len(rids_s) == 0:
        return []
    q = np.asarray(fwd_first_rids, dtype=np.int64)
    idx = np.searchsorted(rids_s, q)
    idx_c = np.minimum(idx, len(rids_s) - 1)
    hit = rids_s[idx_c] == q
    counts = np.where(hit, off[idx_c + 1] - off[idx_c], 0)
    total = int(counts.sum())
    if total == 0:
        return []
    starts = off[idx_c]
    cum = np.zeros(len(q), dtype=np.int64)
    cum[1:] = np.cumsum(counts[:-1])
    flat_pos = np.arange(total) - np.repeat(cum, counts)
    src = np.repeat(starts, counts) + flat_pos
    cand = nodes[src]                      # emission order preserved
    keep = np.ones(total, dtype=bool)
    if only_out and path_v:
        keep &= ~np.isin(cand, np.fromiter(path_v, dtype=np.int64,
                                           count=len(path_v)))
    if not allow_gaps_flag:
        keep &= np.isin(cand, _reach_keys(gr, path_last))
    return cand[keep].tolist()


def extend_paths_adv_paired(paths: List[Path], gr, threshold: int,
                            rs1, rs2, kmer: int, prob_calc, rng) -> bool:
    """Reference moves.cc:933-1078."""
    if not paths:
        return False  # reference: rand() % 0 in SamplePathByLength (UB)
    rp = sample_path_by_length(paths, gr, rng)
    path = list(paths[rp])
    if rng.randint(2) == 1:
        reverse_path(path)
    del paths[rp]

    rs2.build_advice_index(gr, threshold)
    read_poses_1 = rs2.advice_index1

    path_v = set(path)
    path_v.update(e ^ 1 for e in path if e >= 0)
    fwd_first_rids = rs1.fwd_first_rids(gr, path)

    only_out = True
    if rng.randint(5) == 0:
        only_out = False
    allow_gaps = False
    if rng.randint(5) == 0:
        allow_gaps = True

    _ = read_poses_1  # CSR form of the same index drives the collection
    cands = _collect_candidates(rs2, gr, fwd_first_rids, path_v, path[-1],
                                only_out, allow_gaps)
    if not cands:
        allow_gaps = True
        cands = _collect_candidates(rs2, gr, fwd_first_rids, path_v,
                                    path[-1], only_out, True)

    path_ends = _build_path_ends(paths)
    if not cands:
        return False
    nxt = cands[rng.randint(len(cands))]
    gap = False
    if nxt not in gr.reach_limit[path[-1]]:
        gap = True
    elif allow_gaps and rng.randint(2) == 0:
        gap = True

    ps = len(path) - 1
    s = path[-1]
    gap_pos = -1
    if gap:
        gap_pos = len(path)
        path.append(-21)
        path.append(nxt)
    else:
        path.extend(gr.reach_limit[s][nxt])
        path.append(nxt)
    pt = len(path) - 1

    join = _join_onto_end(paths, path, path_ends, rng)
    if join == 0:
        return False
    join_num, join_path = _resolve_join(paths, join)
    assert path[-1] == join_path[0]
    path.extend(join_path[1:])
    del paths[join_num]
    paths.append(path)

    paths2 = [list(p) for p in paths]
    if gap:
        fix_gap_length(paths, len(paths) - 1, gap_pos, prob_calc, -1)
        if paths[-1][gap_pos] == -1:
            return False
    else:
        if local_change2(paths2, gr, threshold, len(paths) - 1, ps, pt,
                         prob_calc, rng):
            paths[:] = paths2
    return True


def extend_paths_adv_pacbio(paths: List[Path], gr, threshold: int,
                            rs, kmer: int, prob_calc, rng) -> bool:
    """Reference moves.cc:802-931."""
    if not paths:
        return False  # reference: rand() % 0 in SamplePathByLength (UB)
    rp = sample_path_by_length(paths, gr, rng)
    path = list(paths[rp])
    if rng.randint(2) == 1:
        reverse_path(path)
    del paths[rp]

    cands = []
    for r in rs.anchors_end.get(path[-1], ()):
        for x in rs.anchors_reverse.get(r, ()):
            if gr.node_len(x) > threshold:
                cands.append((x, r))

    path_ends = _build_path_ends(paths)
    if not cands:
        return False
    nxt, read_id = cands[rng.randint(len(cands))]
    allow_gaps = rng.randint(5) == 0
    gap = False
    gap_len = 0
    if nxt not in gr.reach_limit[path[-1]]:
        gap = True
    elif allow_gaps and rng.randint(2) == 0:
        gap = True
    if gap:
        gap_len = rs.get_gap(gr, path[-1], nxt, read_id)
        if gap_len < 0:
            return False

    ps = len(path) - 1
    s = path[-1]
    if gap:
        path.append(-gap_len)
        path.append(nxt)
    else:
        path.extend(gr.reach_limit[s][nxt])
        path.append(nxt)
    pt = len(path) - 1

    join = _join_onto_end(paths, path, path_ends, rng)
    found = join != 0
    if rng.randint(5) == 0:
        found = True
    if not found:
        return False
    if join != 0:
        join_num, join_path = _resolve_join(paths, join)
        assert path[-1] == join_path[0]
        path.extend(join_path[1:])
        del paths[join_num]
        paths.append(path)
    else:
        paths.append(path)

    paths2 = [list(p) for p in paths]
    if not gap:
        if local_change2(paths2, gr, threshold, len(paths) - 1, ps, pt,
                         prob_calc, rng):
            paths[:] = paths2
    # gap case: the reference's FixGapLength call here is commented out
    # (moves.cc:914-920)
    return True
