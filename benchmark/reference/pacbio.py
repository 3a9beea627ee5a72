"""Plain reference of the program's long-read (PacBio) rescore, in numpy
and plain torch, for the comparison that decides ``correct`` in the
``pacbio.rescore`` cell and for the tests.  It imports nothing of the
program.

It follows GAML's PacBio scorer (CalcScoreForPacbio, graph.cc:3040-3261;
the read set's cache and windows, graph.cc:2410-2795) as the program
documents it (``gaml_tpu_torch/scoring/pacbio.py``), with the program's
aligner in BLASR's place:

- Spelling: a walk's entries are node ids (node k of the LastGraph file
  is 2(k - 1), its reverse complement 2(k - 1) + 1) and gaps (-g: g N
  codes).  Its windows are the sub-walks i..j, j running on while the
  walk past node i spans at most the longest read (graph.cc:2438-2454).
- Seeds: exact 13-mer matches, N counted as G (code 0) in a k-mer; a
  k-mer seen more than 64 times in a target keeps its 64 first
  occurrences.
- Chains: seeds sorted by (diagonal t - q, q) are cut wherever a
  diagonal lies more than 100 from the running mean of its group (each
  new member halves the distance to it); a group keeps its seeds
  ascending in both coordinates (greedy, by q), and at least 3 make a
  chain; chains are ranked by seeds, most first (stable).  BLASR's
  alignment and its CIGAR band are not modelled: this is the program's
  own aligner.
- Anchors (graph.cc:2505-2576): each read strand's seeds against every
  node of at least 80 bp; the node's best chain anchors the read there,
  at its begin where the chain's projection onto the node starts within
  10 bp of it, at its end where it ends within 10 bp of the node's end.
- Guides: the read's row r maps to the column interpolated between the
  chain's seeds (truncated to an integer), on the diagonal before the
  first and after the last, clipped to the target.  Upstream bounds its
  start and end blocks by 200 bp of slack (graph.cc:2181-2207); the
  program's guide, and this one, run the diagonal to the read's ends.
- Forward: the total probability of the read against its target along
  the guide in a band of 64 lanes (graph.cc:2175-2297's model: a free
  start, the whole read consumed, match and mismatch probabilities, each
  indel at the mismatch probability), in float64 log space on the
  program's device, in blocks of jobs, rows in order.
- Cache (graph.cc:2724-2785): a fill reserves its range's windows in
  order, each hit goes to the window its span (5 bp of slack) starts and
  ends in, if that window was reserved by this fill.
- Score: the hits' spans at or above their read's 0.25-mismatch floor
  and the walks' nodes in the coverage sweep (bad bases,
  graph.cc:3196-3250); per read the log-sum of its hits, floored at
  ``min_prob_start + min_prob_per_base * length`` (graph.cc:3062-3088);
  the score is (sum of floored) / n - log(2 * total length) - bad bases
  * penalty.
"""
from __future__ import annotations

import bisect
import math
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

K = 13
MAX_OCC = 64
DRIFT = 100
MIN_SEEDS = 3
MIN_ANCHOR_LEN = 80
EDGE = 10
WIDTH = 64
HIT_SLACK = 5
NEG = -1e30  # the program's log-probability of an empty band
PAD = 6      # read code past a read's end: matches nothing
COMP = np.array([3, 2, 1, 0, 4], np.uint8)  # codes G=0 A=1 T=2 C=3 N=4


def revcomp(codes: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(COMP[codes][::-1])


def kmers(codes: np.ndarray) -> np.ndarray:
    """Every 13-mer of ``codes`` as a 26-bit number, first base most
    significant, N as G."""
    n = len(codes) - K + 1
    if n <= 0:
        return np.zeros(0, np.int64)
    v = np.where(codes < 4, codes, 0).astype(np.int64)
    out = np.zeros(n, np.int64)
    for j in range(K):
        out = out * 4 + v[j:j + n]
    return out


class Seeds:
    """The exact 13-mer matches of queries in one target."""

    def __init__(self, target: np.ndarray):
        km = kmers(target)
        self.at = np.argsort(km, kind="stable")
        self.value = km[self.at]

    def hits(self, qk: np.ndarray):
        """(t, q) of the query k-mers ``qk``: per q ascending, its target
        positions ascending, at most 64."""
        lo = np.searchsorted(self.value, qk, "left")
        hi = np.searchsorted(self.value, qk, "right")
        n = np.minimum(hi - lo, MAX_OCC)
        q = np.repeat(np.arange(len(qk)), n)
        first = np.cumsum(n) - n
        idx = np.arange(int(n.sum())) - np.repeat(first, n) + np.repeat(lo, n)
        return self.at[idx], q


class Chain(NamedTuple):
    tstart: int
    tend: int
    qstart: int
    qend: int
    n_seeds: int
    t: List[int]
    q: List[int]


def chains(t: np.ndarray, q: np.ndarray) -> List[Chain]:
    """The colinear chains of seeds (t, q), most seeds first."""
    tl, ql = t.tolist(), q.tolist()
    order = sorted(range(len(tl)), key=lambda k: (tl[k] - ql[k], ql[k]))
    groups, cur, mean = [], [], None
    for k in order:
        d = tl[k] - ql[k]
        if mean is None or abs(d - mean) <= DRIFT:
            cur.append(k)
            mean = d if mean is None else (mean + d) / 2
        else:
            groups.append(cur)
            cur, mean = [k], d
    groups.append(cur)
    out = []
    for g in groups:
        if len(g) < MIN_SEEDS:
            continue
        ts, qs = [], []
        for k in sorted(g, key=lambda k: (ql[k], tl[k])):
            if not ts or (tl[k] > ts[-1] and ql[k] > qs[-1]):
                ts.append(tl[k])
                qs.append(ql[k])
        if len(ts) >= MIN_SEEDS:
            out.append(Chain(ts[0], ts[-1] + K, qs[0], qs[-1] + K, len(ts),
                             ts, qs))
    out.sort(key=lambda c: -c.n_seeds)
    return out


def guide(ch: Chain, rlen: int, tlen: int) -> np.ndarray:
    """The column of each of the read's rows 0..rlen."""
    r = np.arange(rlen + 1)
    col = np.interp(r, ch.q, ch.t).astype(np.int64)
    col = np.where(r < ch.q[0], ch.t[0] - (ch.q[0] - r), col)
    col = np.where(r > ch.q[-1], ch.t[-1] + (r - ch.q[-1]), col)
    return np.clip(col, 0, max(tlen, 1))


class Job(NamedTuple):
    rid: int
    strand: int
    chain: Chain
    guide: np.ndarray
    fill: int  # which fill (range) it belongs to


class Fill(NamedTuple):
    """One range of a walk: its entries, bounds, spelled target and the
    windows it reserved (first index) or found reserved."""
    path: Tuple[int, ...]
    begins: List[int]
    ends: List[int]
    target: np.ndarray
    starts: Dict[Tuple[int, ...], int]
    taken: set


class Plan(NamedTuple):
    walks: List[List[int]]
    fills: List[Fill]
    windows: List[Tuple[int, ...]]  # reserved, in order
    jobs: List[Job]


class Answer(NamedTuple):
    windows: Dict[Tuple[int, ...], List[Tuple[int, int, int, float]]]
    jobs: int
    score: float
    zero_reads: int
    bad_bases: int
    total_len: int


def logadd(a: float, b: float) -> float:
    if a == -math.inf:
        return b
    if b == -math.inf:
        return a
    if a < b:
        a, b = b, a
    return a + math.log1p(math.exp(b - a))


def sweep(events, tl: int, cov_move: float) -> int:
    """Bad bases: the coverage sweep over start (+1) and end (start -
    end) events."""
    events = sorted(events)
    open_at: List[int] = []
    bad = 0
    for j, (pos, kind) in enumerate(events):
        if kind == 1:
            bisect.insort(open_at, pos)
        else:
            k = bisect.bisect_left(open_at, pos + kind)
            if k < len(open_at) and open_at[k] == pos + kind:
                del open_at[k]
        good = tl - 250
        if open_at:
            good = open_at[0] + cov_move
        if j + 1 < len(events):
            good = min(events[j + 1][0], good)
        good = min(good, tl - 250)
        if good > max(2500, pos):
            bad += int(good - max(2500, pos))
    return bad


class Reference:
    """The reference's model of one long-read library on one graph:
    ``nodes`` the graph's forward node codes in LastGraph order,
    ``reads`` the library's reads, ``mismatch_prob`` as the config gives
    it (match = 1 - 4 mismatch)."""

    def __init__(self, nodes, reads, mismatch_prob: float):
        self.seqs = []
        for s in nodes:
            self.seqs += [np.asarray(s, np.uint8), revcomp(s)]
        self.reads = [np.asarray(r, np.uint8) for r in reads]
        self.rc = [revcomp(r) for r in self.reads]
        self.read_kmers = [(kmers(r), kmers(c))
                           for r, c in zip(self.reads, self.rc)]
        self.read_len = np.array([len(r) for r in self.reads], np.int64)
        self.longest = int(self.read_len.max(initial=0))
        self.mismatch = float(mismatch_prob)
        self.match = 1.0 - 4 * self.mismatch
        lens = self.read_len.astype(np.float64)
        self.hit_floor = (0.25 * lens * np.log(self.mismatch)
                          + 0.75 * lens * np.log(self.match))
        self.anchored, self.at_begin, self.at_end = self.anchors()

    # ------------------------------------------------------------ anchors
    def anchors(self):
        ids = [i for i, s in enumerate(self.seqs)
               if len(s) >= MIN_ANCHOR_LEN]
        anchored: Dict[int, set] = {}
        at_begin: Dict[int, set] = {}
        at_end: Dict[int, set] = {}
        if not ids:
            return anchored, at_begin, at_end
        starts = np.cumsum([0] + [len(self.seqs[i]) for i in ids])
        seeds = Seeds(np.concatenate([self.seqs[i] for i in ids]))
        for rid in range(len(self.reads)):
            for strand in (0, 1):
                if self.read_len[rid] < K:
                    continue
                t, q = seeds.hits(self.read_kmers[rid][strand])
                node = np.searchsorted(starts, t, "right") - 1
                inside = t + K <= starts[node + 1]
                t, q, node = t[inside], q[inside], node[inside]
                for n in np.unique(node):
                    sel = node == n
                    found = chains(t[sel] - starts[n], q[sel])
                    if not found:
                        continue
                    best = found[0]
                    nid = ids[n]
                    nlen = len(self.seqs[nid])
                    rlen = int(self.read_len[rid])
                    anchored.setdefault(nid, set()).add(rid)
                    if best.tstart - min(best.tstart, best.qstart) <= EDGE:
                        at_begin.setdefault(nid, set()).add(rid)
                    if best.tend + min(nlen - best.tend, rlen - best.qend) \
                            >= nlen - EDGE:
                        at_end.setdefault(nid, set()).add(rid)
        return anchored, at_begin, at_end

    # ------------------------------------------------------------- walks
    def bounds(self, path):
        begins, ends, pos = [], [], 0
        for e in path:
            begins.append(pos)
            pos += -e if e < 0 else len(self.seqs[e])
            ends.append(pos)
        return begins, ends

    def spell(self, path) -> np.ndarray:
        parts = [np.full(-e, 4, np.uint8) if e < 0 else self.seqs[e]
                 for e in path]
        return np.concatenate(parts) if parts else np.zeros(0, np.uint8)

    def windows(self, path):
        """(i, j) of every window of ``path``."""
        begins, ends = self.bounds(path)
        for i in range(len(path)):
            for j in range(i, len(path)):
                yield i, j
                if ends[j] - ends[i] > self.longest:
                    break

    def plan(self, walks) -> Plan:
        """What one scoring call of ``walks`` does from an empty cache:
        the windows it reserves, in order, and its forward jobs."""
        reserved: Dict[Tuple[int, ...], None] = {}
        fills: List[Fill] = []
        seen = set()
        for walk in walks:
            walk = list(walk)
            if tuple(walk) in seen:
                continue
            seen.add(tuple(walk))
            missing = [(i, j) for i, j in self.windows(walk)
                       if tuple(walk[i:j + 1]) not in reserved]
            for a, b in merge(missing):
                path = tuple(walk[a:b + 1])
                starts, taken = {}, set()
                for i, j in self.windows(path):
                    key = path[i:j + 1]
                    if key in reserved:
                        taken.add(key)
                    else:
                        reserved[key] = None
                    starts[key] = i
                begins, ends = self.bounds(path)
                fills.append(Fill(path, begins, ends, self.spell(path),
                                  starts, taken))
        jobs = []
        for f, fill in enumerate(fills):
            jobs += self.chain_jobs(fill, f)
        return Plan([list(w) for w in walks], fills, list(reserved), jobs)

    def chain_jobs(self, fill: Fill, f: int) -> List[Job]:
        target = fill.target
        if len(target) < K:
            return []
        rids = set()
        for e in fill.path:
            if e >= 0:
                rids |= self.anchored.get(e, set())
        rids = sorted(rids) if rids else range(len(self.reads))
        seeds = Seeds(target)
        jobs = []
        for rid in rids:
            if self.read_len[rid] < K:
                continue
            found = []
            for strand in (0, 1):
                t, q = seeds.hits(self.read_kmers[rid][strand])
                found += [(strand, c) for c in chains(t, q)]
            found.sort(key=lambda sc: -sc[1].n_seeds)
            for strand, c in found:
                jobs.append(Job(rid, strand, c, guide(
                    c, int(self.read_len[rid]), len(target)), f))
        return jobs

    # ----------------------------------------------------------- forward
    def forward(self, plans, device, dtype=torch.float64,
                block: int = 8192) -> List[np.ndarray]:
        """Each plan's jobs' log-probabilities (float64 numpy, NEG for an
        empty band), computed in ``dtype`` on ``device``."""
        targets, jobs = [], []
        for p, plan in enumerate(plans):
            base = len(targets)
            targets += [fill.target for fill in plan.fills]
            jobs += [(p, k, job, base + job.fill)
                     for k, job in enumerate(plan.jobs)]
        offs = np.cumsum([0] + [len(t) for t in targets])
        buf = torch.from_numpy(np.concatenate(targets) if targets else
                               np.zeros(1, np.uint8)).to(device)
        out = [np.full(len(plan.jobs), NEG) for plan in plans]
        jobs.sort(key=lambda x: -len(x[2].guide))
        for b0 in range(0, len(jobs), block):
            part = jobs[b0:b0 + block]
            lps = self.band(buf, part, offs, device, dtype)
            for (p, k, _job, _t), lp in zip(part, lps):
                out[p][k] = lp
        return out

    def band(self, buf, part, offs, device, dtype) -> np.ndarray:
        """The banded forward of jobs sorted by read length, longest
        first: at row r only the jobs with r rows or more are live, a
        prefix."""
        n = len(part)
        rows = np.array([len(j.guide) - 1 for _p, _k, j, _t in part])
        R = int(rows.max(initial=0))
        reads = np.full((n, max(R, 1)), PAD, np.uint8)
        steps = np.zeros((n, max(R, 1)), np.int64)
        c0 = np.zeros(n, np.int64)
        gst = np.zeros(n, np.int64)
        gend = np.zeros(n, np.int64)
        for i, (_p, _k, job, t) in enumerate(part):
            q = self.reads[job.rid] if job.strand == 0 else self.rc[job.rid]
            reads[i, :len(q)] = q
            steps[i, :rows[i]] = np.clip(np.diff(job.guide), 0, 2)
            c0[i] = job.guide[0] + offs[t]
            gst[i], gend[i] = offs[t], offs[t + 1]
        T = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        reads, steps = T(reads).long(), T(steps)
        gst, gend = T(gst)[:, None], T(gend)[:, None]
        live = [int((rows >= r).sum()) for r in range(R + 1)]
        lane = torch.arange(WIDTH, device=device)
        G = buf.shape[0]
        code = buf.long()
        lmm = math.log(self.mismatch)
        ninf = torch.tensor(-math.inf, dtype=dtype, device=device)
        lm_t = torch.tensor(math.log(self.match), dtype=dtype, device=device)
        lmm_t = torch.tensor(lmm, dtype=dtype, device=device)
        lane_gap = lane.to(dtype) * lmm
        col0 = T(c0)[:, None] - WIDTH // 2 + lane
        m = torch.where((col0 >= gst) & (col0 < gend),
                        torch.zeros((), dtype=dtype, device=device), ninf)
        first = T(c0) - WIDTH // 2
        for r in range(1, R + 1):
            k = live[r]
            step = steps[:k, r - 1]
            first[:k] += step
            col = first[:k, None] + lane          # the lane's column
            prev = torch.cat([ninf.expand(k, 1), m[:k],
                              ninf.expand(k, 2)], 1)
            diag = prev.gather(1, lane + step[:, None])      # lane o+step-1
            up = prev.gather(1, lane + step[:, None] + 1)    # lane o+step
            g = col - 1                           # the base it consumes
            base = torch.where((g >= 0) & (g < G), code[g.clamp(0, G - 1)],
                               9)
            emit = torch.where(base >= 8, ninf, torch.where(
                base == reads[:k, r - 1:r], lm_t, lmm_t))
            inside = (col >= gst[:k]) & (col < gend[:k])
            val = torch.where(inside, torch.logaddexp(diag + emit, up + lmm),
                              ninf)
            # deletions along the row: the lanes inside the target are
            # contiguous and each step right costs lmm, so the chain
            # x[o] = logaddexp(val[o], x[o-1] + lmm) is a cumulative
            # log-sum of val[j] + (o - j) lmm over the lanes j <= o
            x = torch.logcumsumexp(torch.where(inside, val - lane_gap, ninf),
                                   1) + lane_gap
            m[:k] = torch.where(inside, x, ninf)
        out = torch.logsumexp(m, 1).double().cpu().numpy()
        out[~np.isfinite(out)] = NEG
        out[rows <= 0] = NEG
        return out

    # ------------------------------------------------------------ finish
    def finish(self, plan: Plan, lps: np.ndarray, penalty: float,
               cov_move: float, min_prob_per_base: float,
               min_prob_start: float) -> Answer:
        """The scoring call's answer given its jobs' log-probabilities."""
        windows = {key: [] for key in plan.windows}
        for job, lp in zip(plan.jobs, lps):
            fill = plan.fills[job.fill]
            c, tl = job.chain, len(fill.target)
            start = max(0, c.tstart - c.qstart)
            end = min(tl, c.tend + (int(self.read_len[job.rid]) - c.qend))
            i = min(bisect.bisect_left(fill.ends, max(0, start - HIT_SLACK)),
                    len(fill.path) - 1)
            j = min(bisect.bisect_left(fill.ends, min(end + HIT_SLACK, tl)),
                    len(fill.path) - 1)
            key = fill.path[i:j + 1]
            if fill.starts.get(key) == i and key not in fill.taken:
                windows[key].append((start - fill.begins[i],
                                     end - fill.begins[i], job.rid,
                                     float(lp)))
        per_read = [-math.inf] * len(self.reads)
        total_len = bad = 0
        for walk in plan.walks:
            begins, ends = self.bounds(walk)
            tl = ends[-1] if ends else 0
            events = [(-1000, 1), (2000, -3000)]
            for e, b, x in zip(walk, begins, ends):
                if e >= 0:
                    events += [(b, 1), (x, b - x)]
            for i, j in self.windows(walk):
                for s, x, rid, lp in windows.get(tuple(walk[i:j + 1]), ()):
                    s, x = begins[i] + s, begins[i] + x
                    per_read[rid] = logadd(per_read[rid], lp)
                    if lp >= self.hit_floor[rid]:
                        events += [(s, 1), (x, s - x)]
            bad += sweep(events, tl, cov_move)
            total_len += tl
        total, zeros = 0.0, 0
        for rid, lp in enumerate(per_read):
            floor = min_prob_start + min_prob_per_base * int(
                self.read_len[rid])
            if lp < floor:
                zeros += 1
                lp = floor
            total += lp
        score = total / max(len(per_read), 1) \
            - math.log(2 * max(total_len, 1)) - bad * penalty
        return Answer(windows, len(plan.jobs), score, zeros, bad, total_len)


def merge(missing) -> List[Tuple[int, int]]:
    """Overlapping (i, j) windows merged into ranges."""
    out: List[List[int]] = []
    for a, b in sorted(missing):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(r) for r in out]
