"""Assembly graph model.

Nodes come in reverse-complement pairs: Velvet node ``i`` becomes graph nodes
``2(i-1)`` (forward) and ``2(i-1)+1`` (reverse); the complement of node ``x``
is ``x ^ 1`` (reference: graph.h:48-57).  Every arc is stored in both
orientations (reference LoadGraph, graph.cc:84-96).

The node table is structure-of-arrays: encoded sequences, adjacency lists and
edge sampling weights live in parallel Python lists indexed by node id.
Sequences are uint8 code arrays (see core.dna); strings only exist at the IO
boundary.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import dna
from .paths import Path

K_SMOOTH = 1.0  # initial edge weight (reference kSmooth, graph.cc:26)


def convert_node_id(x: int) -> int:
    """Velvet signed 1-based id -> internal id (reference graph.h:48-53)."""
    if x > 0:
        return 2 * (x - 1)
    return 2 * (-x - 1) + 1


def invert_node(x: int) -> int:
    """Reverse-complement partner (reference graph.h:55-57)."""
    return x ^ 1


class Node:
    """Lightweight per-node view; the canonical storage is in Graph arrays."""

    __slots__ = ("graph", "id")

    def __init__(self, graph: "Graph", node_id: int):
        self.graph = graph
        self.id = node_id

    @property
    def seq(self) -> np.ndarray:
        return self.graph.seqs[self.id]

    def __len__(self) -> int:
        return len(self.graph.seqs[self.id])


class Graph:
    def __init__(self):
        self.seqs: List[np.ndarray] = []       # encoded node sequences
        self.next: List[List[int]] = []        # out-edges (node ids)
        self.next_prob: List[List[float]] = [] # per-edge sampling weights
        self.next_sum: List[float] = []
        # reachability caches (reference graph.h:243-245)
        self.reach_big: List[Dict[int, List[int]]] = []
        self.reach_limit: List[Dict[int, List[int]]] = []
        self.reach_self: List[List[List[int]]] = []
        self.normalize_map: List[int] = []

    # ---------------------------------------------------------------- basics
    @property
    def num_nodes(self) -> int:
        return len(self.seqs)

    def __getitem__(self, i: int) -> Node:
        return Node(self, i)

    def node_len(self, i: int) -> int:
        return len(self.seqs[i])

    def lens_np(self) -> np.ndarray:
        """Cached int64 per-node length array (node sequences are
        immutable, so the cache only invalidates when nodes are added)."""
        arr = getattr(self, "_lens_np", None)
        if arr is None or len(arr) != len(self.seqs):
            arr = np.fromiter((len(s) for s in self.seqs), dtype=np.int64,
                              count=len(self.seqs))
            self._lens_np = arr
        return arr

    def add_node_pair(self, fwd_seq: np.ndarray, rev_seq: Optional[np.ndarray] = None) -> int:
        """Append a forward/reverse node pair; returns the forward id."""
        if rev_seq is None:
            rev_seq = dna.revcomp(fwd_seq)
        nid = len(self.seqs)
        self.seqs.append(np.asarray(fwd_seq, dtype=np.uint8))
        self.seqs.append(np.asarray(rev_seq, dtype=np.uint8))
        for _ in range(2):
            self.next.append([])
            self.next_prob.append([])
            self.next_sum.append(0.0)
        return nid

    def add_arc(self, source: int, dest: int) -> None:
        """Insert an arc in both orientations (reference graph.cc:90-93)."""
        self.next[source].append(dest)
        self.next_prob[source].append(K_SMOOTH)
        self.next[invert_node(dest)].append(invert_node(source))
        self.next_prob[invert_node(dest)].append(K_SMOOTH)

    def has_next(self, i: int, next_id: int) -> bool:
        return next_id in self.next[i]

    # --------------------------------------------------------- edge sampling
    def calc_prob_sums(self) -> None:
        """Reference Node::CalcProbSums (graph.h:104-106).  The C++ uses an
        int accumulator, truncating fractional weights; weights are always
        integral in practice so a float sum is equivalent."""
        for i in range(self.num_nodes):
            self.next_sum[i] = float(np.floor(sum(self.next_prob[i]) if self.next_prob[i] else 0.0))

    def init_probs(self, i: int) -> None:
        self.next_prob[i] = [K_SMOOTH for _ in self.next[i]]

    def add_jump(self, i: int, jump: int) -> None:
        """Bump the weight of edge i->jump (reference graph.h:191-199)."""
        for j, nxt in enumerate(self.next[i]):
            if nxt == jump:
                self.next_prob[i][j] += 1
                return
        raise AssertionError(f"no edge {i}->{jump}")

    def recalculate_probs_by_path(self, path: Sequence[int]) -> None:
        """Re-derive edge weights from observed jumps in a walk
        (reference graph.h:285-296)."""
        for i in range(self.num_nodes):
            self.init_probs(i)
        for a, b in zip(path, path[1:]):
            self.add_jump(a, b)
            self.add_jump(invert_node(b), invert_node(a))
        self.calc_prob_sums()

    def sample_next(self, i: int, rng) -> Optional[int]:
        """Weighted edge sample (reference Node::SampleNext, graph.h:108-120)."""
        probs = self.next_prob[i]
        if not probs:
            return None
        samp = rng.uniform(0.0, self.next_sum[i])
        ss = 0.0
        for j, p in enumerate(probs):
            ss += p
            if ss > samp or j == len(probs) - 1:
                return self.next[i][j]
        return self.next[i][-1]

    def sample_next_with_prob(self, i: int, rng):
        probs = self.next_prob[i]
        if not probs:
            return None, 0.0
        samp = rng.uniform(0.0, self.next_sum[i])
        ss = 0.0
        for j, p in enumerate(probs):
            ss += p
            if ss > samp or j == len(probs) - 1:
                return self.next[i][j], p / self.next_sum[i]
        return self.next[i][-1], probs[-1] / self.next_sum[i]

    def sample_next_with_prob_and_ban(self, i: int, ban: int, rng):
        """Weighted sample excluding one banned successor
        (reference Node::SampleNextWithProbAndBan, graph.h:138-155;
        precondition: at least 2 successors)."""
        next_sum_ban = sum(p for nxt, p in zip(self.next[i], self.next_prob[i])
                           if nxt != ban)
        samp = rng.uniform(0.0, next_sum_ban)
        ss = 0.0
        last = None
        for j, (nxt, p) in enumerate(zip(self.next[i], self.next_prob[i])):
            if nxt == ban:
                continue
            ss += p
            last = (nxt, p / next_sum_ban if next_sum_ban else 0.0)
            if ss > samp or j == len(self.next[i]) - 1:
                return last
        return last

    def get_next_prob(self, i: int, next_id: int) -> float:
        for j, nxt in enumerate(self.next[i]):
            if nxt == next_id:
                return self.next_prob[i][j] / self.next_sum[i]
        raise AssertionError(f"no edge {i}->{next_id}")

    def get_next_prob_ban(self, i: int, next_id: int, ban: int) -> float:
        """Edge probability with one successor excluded
        (reference Node::GetNextProbBan, graph.h:167-181)."""
        next_sum_ban = sum(p for nxt, p in zip(self.next[i], self.next_prob[i])
                           if nxt != ban)
        for nxt, p in zip(self.next[i], self.next_prob[i]):
            if nxt == ban:
                continue
            if nxt == next_id:
                return p / next_sum_ban
        raise AssertionError(f"no edge {i}->{next_id} (ban {ban})")

    # ------------------------------------------------------- normalize map
    def calc_normalize_map(self) -> None:
        """Dedup nodes with identical sequences of length <= 3
        (reference Graph::CalcNormalizeMap, graph.h:249-266)."""
        small: Dict[bytes, int] = {}
        self.normalize_map = list(range(self.num_nodes))
        for i in range(self.num_nodes):
            if len(self.seqs[i]) > 3:
                continue
            key = self.seqs[i].tobytes()
            if key in small:
                self.normalize_map[i] = small[key]
            else:
                small[key] = i

    def normalize_path(self, path: List[int]) -> List[int]:
        """Rewrite node ids through the normalize map (graph.h:268-273);
        returns a new list (unlike C++ which mutates in place)."""
        return [self.normalize_map[e] if e >= 0 else e for e in path]

    # ---------------------------------------------------------- reachability
    def calc_reachability(self) -> None:
        """Self-loop cycles of <= 4 hops returning to each node
        (reference Graph::CalcReachability, graph.cc:200-228).
        reach_self[i] holds the cycle paths *starting with i itself*."""
        self.reach_self = [[] for _ in range(self.num_nodes)]
        for i in range(self.num_nodes):
            cands = [[i]]
            for _ in range(4):
                cands2 = []
                for c in cands:
                    for nxt in self.next[c[-1]]:
                        if nxt == i:
                            self.reach_self[i].append(list(c))
                        else:
                            cands2.append(c + [nxt])
                cands = cands2

    def calc_reachability_big(self, threshold: int) -> None:
        """BFS from each long node through short nodes only, recording the
        short-node path between long-node pairs
        (reference Graph::CalcReachabilityBig, graph.cc:154-198).
        Uses the C++ kernel when built."""
        from ..native import get_lib

        if get_lib() is not None:
            from ..native import reach_big

            result = reach_big(self, threshold)
            self.reach_big = [result.get(i, {}) for i in range(self.num_nodes)]
            return
        self.reach_big = [dict() for _ in range(self.num_nodes)]
        for i in range(self.num_nodes):
            if self.node_len(i) <= threshold:
                continue
            visited = {i}
            prev: Dict[int, int] = {}
            frontier = [i]
            qi = 0
            while qi < len(frontier):
                x = frontier[qi]
                qi += 1
                if self.node_len(x) > threshold and x != i:
                    pp = []
                    cur = prev[x]
                    while cur != i:
                        pp.append(cur)
                        cur = prev[cur]
                    pp.reverse()
                    self.reach_big[i][x] = pp
                    continue  # do not expand through long nodes
                for ni in self.next[x]:
                    if ni in visited:
                        continue
                    visited.add(ni)
                    prev[ni] = x
                    frontier.append(ni)

    def calc_reachability_limit(self, max_dist: int) -> None:
        """Distance-bounded Dijkstra from every node recording the shortest
        connecting inner path (reference Graph::CalcReachabilityLimit,
        graph.cc:108-152).  Distances measure the spelled bases strictly
        between the two nodes: expanding from x != start adds len(x).
        Uses the C++ kernel when built."""
        from ..native import get_lib

        if get_lib() is not None:
            from ..native import reach_limit

            result = reach_limit(self, max_dist)
            self.reach_limit = [result.get(i, {})
                                for i in range(self.num_nodes)]
            return
        n = self.num_nodes
        self.reach_limit = [dict() for _ in range(n)]
        for i in range(n):
            fr = [(0, i)]
            final_dist = [-1] * n
            tmp_dist = [2 * max_dist] * n
            prev = [-1] * n
            tmp_dist[i] = 0
            prev[i] = -2
            while fr:
                d, x = heapq.heappop(fr)
                if final_dist[x] != -1:
                    continue
                final_dist[x] = d
                nd = d
                if x != i:
                    pp = []
                    cur = prev[x]
                    while cur != i:
                        pp.append(cur)
                        cur = prev[cur]
                    pp.reverse()
                    self.reach_limit[i][x] = pp
                    nd += self.node_len(x)
                for nx in self.next[x]:
                    if tmp_dist[nx] > nd and nd <= max_dist:
                        tmp_dist[nx] = nd
                        prev[nx] = x
                        heapq.heappush(fr, (nd, nx))

    # -------------------------------------------------------------- spelling
    def spell(self, path: Sequence[int], gaps_as_n: bool = True) -> np.ndarray:
        """Spell a walk into one encoded sequence.  Negative entries become
        runs of N (reference OutputPathA, graph.cc:292-314)."""
        parts = []
        for e in path:
            if e < 0:
                if gaps_as_n:
                    parts.append(np.full(-e, dna.CODE_N, dtype=np.uint8))
            else:
                parts.append(self.seqs[e])
        if not parts:
            return np.zeros(0, dtype=np.uint8)
        return np.concatenate(parts)

    def spell_long_masked(self, path: Sequence[int], threshold: int) -> np.ndarray:
        """Walk with short nodes masked to N (reference OutputPathAT,
        graph.cc:254-275).  Note the reference emits the *first* node
        unmasked regardless of its length (graph.cc:258)."""
        parts = []
        for idx, e in enumerate(path):
            if e < 0:
                parts.append(np.full(-e, dna.CODE_N, dtype=np.uint8))
            elif idx == 0 or self.node_len(e) > threshold:
                parts.append(self.seqs[e])
            else:
                parts.append(np.full(self.node_len(e), dna.CODE_N, dtype=np.uint8))
        if not parts:
            return np.zeros(0, dtype=np.uint8)
        return np.concatenate(parts)
