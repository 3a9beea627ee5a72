"""The long-read sweep by walk (gaml_tpu_torch.scoring.pacbio_score) on the
CPU: the per-call fold over every walk's flat hits equals
``add_positions_to_read_probs`` applied walk by walk, bit for bit;
``PacbioReadSet.walk_hits`` keeps ``get_read_probabilities``' hits read by
read; and ``calc_score_for_pacbio`` with its walk memo equals the
unmemoized sweep (the kept functions, walk by walk, on a second read set
of the same world) bit for bit over a sequence of calls that share walks,
through ``sweep_walk``, which sees every walk of every call once with its
bad bases, and whose counters count what the memo did."""
import os

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from gaml_tpu_torch.scoring import pacbio_score
from gaml_tpu_torch.scoring.pacbio_score import (
    add_positions_to_read_probs, fold_read_probs, get_total_prob_pacbio,
    hit_spans, interval_sweep, walk_events)
from gaml_tpu_torch.utils.metrics import TRACE


def random_walk_hits(rng, n_reads, n_walks):
    """Each walk's (read ids, log-probabilities): reads 0 and 1 never hit,
    read 2 is hit in every walk, some values are -inf and some repeat
    exactly; the last walks repeat earlier ones (duplicate walks of one
    call)."""
    rids, lps = [], []
    pool = np.round(rng.normal(-400.0, 150.0, 8), 1)
    for _ in range(n_walks):
        n = int(rng.integers(0, 40))
        rid = np.concatenate([[2] * int(rng.integers(1, 4)),
                              rng.integers(3, n_reads, n)]).astype(np.int32)
        rng.shuffle(rid)
        lp = rng.normal(-500.0, 200.0, len(rid))
        lp[rng.random(len(rid)) < 0.15] = -np.inf
        same = rng.random(len(rid)) < 0.3
        lp[same] = rng.choice(pool, int(same.sum()))
        rids.append(rid)
        lps.append(lp)
    for k in rng.choice(n_walks, 3):
        rids.append(rids[k])
        lps.append(lps[k])
    return rids, lps


@pytest.mark.parametrize("seed", range(6))
def test_fold_equals_walk_by_walk_logadd(seed):
    rng = np.random.default_rng(seed)
    n_reads = 64
    rids, lps = random_walk_hits(rng, n_reads, int(rng.integers(1, 30)))
    want = np.full(n_reads, -np.inf)
    for rid, lp in zip(rids, lps):
        positions2 = [[] for _ in range(n_reads)]
        for r, v in zip(rid.tolist(), lp.tolist()):
            positions2[r].append(((0, 0), v))
        add_positions_to_read_probs(positions2, want)
    got = fold_read_probs(rids, lps, n_reads)
    assert got.tobytes() == want.tobytes()
    assert got[0] == got[1] == -np.inf and np.isfinite(got[2])


def test_fold_of_no_hits_is_minus_inf():
    empty = (np.zeros(0, dtype=np.int32), np.zeros(0))
    for rids, lps in (([], []), ([empty[0]] * 2, [empty[1]] * 2)):
        got = fold_read_probs(rids, lps, 5)
        assert got.shape == (5,) and (got == -np.inf).all()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Two read sets of one seeded world (the ``ecoli_pacbio`` shapes at
    40 kb, 24 reads of 0.5-2.5 kb): one scored with the memo, one by the
    unmemoized sweep."""
    from test_torch_pacbio_reference import SmallWorld

    return [SmallWorld(str(tmp_path_factory.mktemp(f"pbsweep{k}")), seed=11,
                       genome_bp=40_000, reads=24, read_bp=(500, 2500))
            for k in range(2)]


@pytest.fixture(autouse=True)
def native_route(monkeypatch):
    monkeypatch.setenv("GAML_PB_DEVICE_MIN_CELLS", str(1 << 62))


def unmemoized_score(graph, paths, rs, penalty, cov_move, min_prob_per_base,
                     min_prob_start):
    """``calc_score_for_pacbio`` as it was before the walk memo: every
    walk's ``positions2`` lists, spans, sweep and logadd, walk by walk.
    Returns ((score, zero reads, total length), each walk's bad bases)."""
    read_probs = np.full(rs.get_number_of_reads(), -np.inf)
    total_len = 0
    bads = []
    rs.precompute_ranges_for_paths(graph, paths)
    for path in paths:
        path, events = walk_events(graph, path)
        positions2, tl = rs.get_read_probabilities(graph, path)
        for a, b in hit_spans(positions2, rs):
            events += [(a, 1), (b, a - b)]
        bads.append(interval_sweep(events, tl, cov_move))
        add_positions_to_read_probs(positions2, read_probs)
        total_len += tl
    score, zeros = get_total_prob_pacbio(read_probs, total_len, rs,
                                         min_prob_per_base, min_prob_start)
    return (score - sum(bads) * penalty, zeros, total_len), bads


def test_walk_hits_keep_positions2_order(worlds):
    w = worlds[0]
    rs = w.rs
    rs.aligment_cache = {}
    for path in w.walk_sets[1] + w.walk_sets[0][:4]:
        path = w.graph.normalize_path(list(path))
        rid, start, end, lp, tl, _filled = rs.walk_hits(w.graph, path)
        assert rs.walk_hits(w.graph, path)[-1] is False
        positions2, tl2 = rs.get_read_probabilities(w.graph, path)
        assert tl == tl2
        assert rid.dtype == np.int32 and start.dtype == end.dtype == np.int64
        assert lp.dtype == np.float64
        got = [[] for _ in positions2]
        for r, a, b, v in zip(rid.tolist(), start.tolist(), end.tolist(),
                              lp.tolist()):
            got[r].append(((a, b), v))
        assert got == positions2


def test_memo_equals_unmemoized_sweep(worlds, monkeypatch):
    """The sequence: the start walks twice; a call with a gap walk and a
    duplicate walk; a joined walk whose windows a prefetch fills between
    calls; the cache emptied; the misassembly, the start walks again and
    the chain with the gap walk."""
    w, plain = worlds
    graph, p = w.graph, w.params
    start, mis = w.walk_sets
    chain = [[2 * k for k in range(w.world.n_chain)]]
    gap = [start[0][0], start[1][0], -30, start[2][0]]
    joined = start[3] + start[4]
    calls = [start, start, start[2:] + [gap, start[0], start[0]],
             "prefetch", start[:3] + [joined] + start[5:],
             "reset", mis, start, chain + [gap]]
    seen = []
    sweep = pacbio_score.sweep_walk

    def recorded(graph_, path, rs_, cov):
        out = sweep(graph_, path, rs_, cov)
        seen.append((list(path), out[2]))
        return out

    monkeypatch.setattr(pacbio_score, "sweep_walk", recorded)
    for rs in (w.rs, plain.rs):
        rs.aligment_cache = {}
    keys, want_walks, want_hits = set(), 0, 0
    TRACE.reset()
    try:
        for paths in calls:
            if paths == "prefetch":
                for rs in (w.rs, plain.rs):
                    rs.precompute_ranges_for_paths(graph, [joined])
                continue
            if paths == "reset":
                for rs in (w.rs, plain.rs):
                    rs.aligment_cache = {}
                keys = set()
                continue
            want, bads = unmemoized_score(graph, paths, plain.rs, **p)
            del seen[:]
            with profile(activities=[ProfilerActivity.CPU]):
                got = pacbio_score.calc_score_for_pacbio(
                    graph, paths, w.rs, no_cov_penalty=p["penalty"],
                    exp_cov_move=p["cov_move"],
                    min_prob_per_base=p["min_prob_per_base"],
                    min_prob_start=p["min_prob_start"])
            assert got == want
            assert seen == [(list(q), b) for q, b in zip(paths, bads)]
            assert w.rs.aligment_cache.keys() == plain.rs.aligment_cache.keys()
            for path in paths:
                key = tuple(graph.normalize_path(list(path)))
                want_walks += 1
                want_hits += key in keys
                keys.add(key)
        counters = dict(TRACE.counters)
    finally:
        TRACE.reset()
    assert counters["pacbio.walks"] == want_walks
    assert counters["pacbio.walk_memo_hits"] == want_hits
    assert 0 < want_hits < want_walks


def test_memo_keeps_only_walks_with_every_window_cached(worlds):
    w = worlds[0]
    rs, graph, cov = w.rs, w.graph, w.params["cov_move"]
    rs.aligment_cache = {}
    walk = w.walk_sets[1][0]
    first = pacbio_score.sweep_walk(graph, walk, rs, cov)
    memo = pacbio_score.walk_memo(graph, rs)
    assert not memo.walks
    second = pacbio_score.sweep_walk(graph, walk, rs, cov)
    assert len(memo.walks) == 1
    assert pacbio_score.sweep_walk(graph, walk, rs, cov) is second
    assert first[1:] == second[1:]
    for a, b in zip(first[0], second[0]):
        assert a.tobytes() == b.tobytes()
    rs.aligment_cache = dict(rs.aligment_cache)
    assert not pacbio_score.walk_memo(graph, rs).walks


def test_memo_starts_anew_on_load_and_normalize(worlds, tmp_path):
    w = worlds[0]
    rs, graph = w.rs, w.graph
    pacbio_score.sweep_walk(graph, w.walk_sets[0][0], rs,
                            w.params["cov_move"])
    assert rs.walk_memo is not None
    rs.normalize_cache(graph)
    assert rs.walk_memo is None
    pacbio_score.walk_memo(graph, rs)
    path = os.path.join(str(tmp_path), "cache")
    rs.save_alignments(path)
    assert rs.load_alignments(path) and rs.walk_memo is None
