"""Long-read (PacBio) seeding and chaining.

TPU-native replacement for the reference's BLASR subprocess
(graph.cc:2530-2539, 2705-2715): k-mer seed matches between a read and a
target sequence are chained colinearly; the chain supplies (a) anchor
presence/extents for the anchor indexes (reference ComputeAnchors,
graph.cc:2505-2576) and (b) the guide diagonal path whose band the
log-space forward DP (ops.forward) integrates over — the role BLASR's
CIGAR plays in the reference's AligmentProbability band construction
(graph.cc:2183-2222).
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np

from ..core import dna

SEED_K = 13  # survives ~15% long-read error at useful density


class ChainAlignment(NamedTuple):
    tstart: int   # target (genome) start of the chained region
    tend: int     # target end (exclusive-ish, last anchor end)
    qstart: int   # query (read) start
    qend: int
    strand: int   # 0 = read forward, 1 = read reverse-complement
    n_seeds: int
    anchors: List[Tuple[int, int]]  # (tpos, qpos) chain, ascending


MAX_KMER_OCC = 64  # skip k-mers this repetitive in the target


class SortedKmerIndex:
    """Sorted-array k-mer index supporting fully vectorized queries
    (searchsorted instead of per-k-mer dict lookups)."""

    def __init__(self, target: np.ndarray, k: int = SEED_K):
        from ..index.maxhash import pack_kmers

        self.k = k
        tk = pack_kmers(target, k)
        self.order = np.argsort(tk, kind="stable").astype(np.int64)
        self.sorted_vals = tk[self.order]

    def hits(self, query: np.ndarray):
        """(tpos, qpos) int64 arrays of exact k-mer matches."""
        from ..index.maxhash import pack_kmers

        return self.hits_kmers(pack_kmers(query, self.k))

    def hits_kmers(self, qk: np.ndarray):
        """hits() from pre-packed query k-mers."""
        if len(qk) == 0 or len(self.sorted_vals) == 0:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64))
        left = np.searchsorted(self.sorted_vals, qk, "left")
        right = np.searchsorted(self.sorted_vals, qk, "right")
        counts = np.minimum(right - left, MAX_KMER_OCC)
        total = int(counts.sum())
        if total == 0:
            return (np.zeros(0, np.int64), np.zeros(0, np.int64))
        qpos = np.repeat(np.arange(len(qk), dtype=np.int64), counts)
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
        idx = (np.arange(total, dtype=np.int64) -
               np.repeat(offsets, counts) + np.repeat(left, counts))
        tpos = self.order[idx]
        return tpos, qpos

    def hits_batch_kmers(self, qks):
        """Per-query (tpos, qpos) for many pre-packed k-mer arrays with ONE
        searchsorted pair over the concatenation — identical outputs (and
        per-query hit order) to calling hits_kmers per query."""
        spans = []
        at = 0
        for qk in qks:
            spans.append((at, at + len(qk)))
            at += len(qk)
        empty = (np.zeros(0, np.int64), np.zeros(0, np.int64))
        if at == 0 or len(self.sorted_vals) == 0:
            return [empty for _ in qks]
        allqk = np.concatenate(qks)
        left = np.searchsorted(self.sorted_vals, allqk, "left")
        right = np.searchsorted(self.sorted_vals, allqk, "right")
        counts = np.minimum(right - left, MAX_KMER_OCC)
        total = int(counts.sum())
        if total == 0:
            return [empty for _ in qks]
        qpos = np.repeat(np.arange(at, dtype=np.int64), counts)
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
        idx = (np.arange(total, dtype=np.int64) -
               np.repeat(offsets, counts) + np.repeat(left, counts))
        tpos = self.order[idx]
        # qpos ascends globally; split at the query boundaries
        bounds = np.searchsorted(qpos, [s for s, _e in spans] + [at])
        out = []
        for i, (s, _e) in enumerate(spans):
            a, b = int(bounds[i]), int(bounds[i + 1])
            out.append((tpos[a:b], qpos[a:b] - s))
        return out


def _kmer_hits(target: np.ndarray, query: np.ndarray, k: int = SEED_K):
    """Exact k-mer matches (tpos, qpos) via the sorted index."""
    if len(target) < k or len(query) < k:
        return []
    tpos, qpos = SortedKmerIndex(target, k).hits(query)
    return list(zip(tpos.tolist(), qpos.tolist()))


def chain_hits(hits: List[Tuple[int, int]], max_diag_drift: int = 100,
               min_seeds: int = 3) -> List[ChainAlignment]:
    """Greedy diagonal-banded chaining: bucket hits by diagonal band, merge
    overlapping bands, keep colinear runs.  Lightweight stand-in for full
    DP chaining — adequate for banded-DP guidance since the forward DP
    re-integrates over the whole band."""
    if not hits:
        return []
    by_diag = sorted(hits, key=lambda h: (h[0] - h[1], h[1]))
    chains: List[List[Tuple[int, int]]] = []
    cur: List[Tuple[int, int]] = []
    cur_diag = None
    for t, q in by_diag:
        d = t - q
        if cur_diag is None or abs(d - cur_diag) <= max_diag_drift:
            cur.append((t, q))
            cur_diag = d if cur_diag is None else (cur_diag + d) / 2
        else:
            if len(cur) >= min_seeds:
                chains.append(cur)
            cur = [(t, q)]
            cur_diag = d
    if len(cur) >= min_seeds:
        chains.append(cur)

    out = []
    for ch in chains:
        ch.sort(key=lambda h: (h[1], h[0]))
        # enforce monotonicity in both coordinates
        mono = []
        last_t = last_q = -1
        for t, q in ch:
            if t > last_t and q > last_q:
                mono.append((t, q))
                last_t, last_q = t, q
        if len(mono) >= min_seeds:
            out.append(ChainAlignment(
                tstart=mono[0][0], tend=mono[-1][0] + SEED_K,
                qstart=mono[0][1], qend=mono[-1][1] + SEED_K,
                strand=0, n_seeds=len(mono), anchors=mono))
    out.sort(key=lambda c: -c.n_seeds)
    return out


def align_long_read(target: np.ndarray, read: np.ndarray,
                    min_seeds: int = 3,
                    index: SortedKmerIndex = None) -> List[ChainAlignment]:
    """Chained alignments of a read against a target, both strands.
    Reverse-strand chains carry strand=1 with coordinates in the
    *reverse-complemented read's* frame.  Pass a prebuilt SortedKmerIndex
    of the target when aligning many reads against the same sequence."""
    if len(read) < SEED_K or len(target) < SEED_K:
        return []
    if index is None:
        index = SortedKmerIndex(target)
    out = []
    for strand, q in ((0, read), (1, dna.revcomp(read))):
        tpos, qpos = index.hits(q)
        hits = list(zip(tpos.tolist(), qpos.tolist()))
        for ch in chain_hits(hits, min_seeds=min_seeds):
            out.append(ch._replace(strand=strand))
    out.sort(key=lambda c: -c.n_seeds)
    return out


def guide_path(chain: ChainAlignment, read_len: int, target_len: int,
               slack: int = 200) -> np.ndarray:
    """Per-read-position guide column (genome position) for the banded
    forward DP: linear interpolation through the chain anchors, clamped
    diagonal extrapolation into the start/end slack regions (the analogue
    of the reference's CIGAR trace + <=200 start/end blocks,
    graph.cc:2181-2207)."""
    centers = np.zeros(read_len + 1, dtype=np.int32)
    anchors = chain.anchors
    qs = [q for _t, q in anchors]
    ts = [t for t, _q in anchors]
    centers[:] = np.interp(np.arange(read_len + 1), qs, ts).astype(np.int32)
    # extrapolate diagonally before the first / after the last anchor
    first_q, first_t = qs[0], ts[0]
    last_q, last_t = qs[-1], ts[-1]
    left = np.arange(0, first_q)
    centers[left] = first_t - (first_q - left)
    right = np.arange(last_q + 1, read_len + 1)
    centers[right] = last_t + (right - last_q)
    return np.clip(centers, 0, max(target_len, 1))
