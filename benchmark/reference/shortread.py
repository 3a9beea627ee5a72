"""Plain reference of the short-read likelihood (numpy and plain torch).

Nothing here imports the program: the reference works out again, from
the reads, the graph and the walk sets that the benchmark generated,
everything the program derives from them, in the semantics of the GAML
reference (graph.cc, prob_calculator.h):

- the max-hash read index: a read's fingerprint is the largest
  ``kmer ^ 0x2204abcd`` over its 2-bit packed 15-mers (G=0 A=1 T=2 C=3,
  first base most significant); reads with a non-ACGT code stay out;
- candidates: every read-length window of a sequence (and of its reverse
  complement) takes its largest hash, first k-mer on ties; runs of equal
  fingerprints collapse to their first window; each run names the reads
  of its fingerprint, seeded at the first k-mer of the (oriented) read
  that equals the fingerprint's k-mer;
- the extension: ProcessHit's 0-1 BFS with at most 3 errors each way,
  as the seven-diagonal min-plus DP ``dp_rows`` (a frozen copy of the
  plain algorithm; the tests hold it to the BFS itself), run in plain
  torch on any device;
- dedup: first wins per (window, read, begin) in emission order (read
  ascending, forward runs, then reverse runs);
- scores: the single-end GetTotalProb of a whole-assembly rescore, and
  the paired incremental rescore (CalcScoreForPathsNew), every scoring
  call of a run followed from an empty state.

Every probability is float64 unless ``dtype`` asks for less (the
control runs the same arithmetic in float32).
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

K = 15
HASH_XOR = 0x2204ABCD
ERROR_LIMIT = 3
MIN_SUBPATH = 300  # kMinSubpathLength
PAD, BAND, INF, INVALID_A = 4, 7, 100, 100
SENT_READ, SENT_GEN = 6, 8
COMP = np.array([3, 2, 1, 0, 4], np.uint8)
_KMASK = (1 << (2 * K)) - 1


def revcomp(codes: np.ndarray) -> np.ndarray:
    return COMP[codes][..., ::-1]


def pack_kmers(codes: np.ndarray) -> np.ndarray:
    """Packed 15-mers of every row of ``codes`` [n, L] (non-ACGT as G),
    int64 [n, L - K + 1]."""
    codes = np.atleast_2d(codes)
    m = codes.shape[1] - K + 1
    if m <= 0:
        return np.zeros((codes.shape[0], 0), np.int64)
    v = np.where(codes < 4, codes, 0).astype(np.int64)
    acc = np.zeros((codes.shape[0], m), np.int64)
    for j in range(K):
        acc = (acc << 2) | v[:, j:j + m]
    return acc & _KMASK


def revcomp_kmer(km: np.ndarray) -> np.ndarray:
    """Reverse complement of packed 15-mers."""
    v = np.asarray(km, np.int64) ^ _KMASK
    out = np.zeros_like(v)
    for _ in range(K):
        out = (out << 2) | (v & 3)
        v = v >> 2
    return out


def sliding_max(x: np.ndarray, w: int) -> np.ndarray:
    """max(x[s:s+w]) for every s (van Herk / Gil-Werman)."""
    n = len(x)
    nb = -(-n // w)
    pad = np.full(nb * w, np.iinfo(np.int64).min, np.int64)
    pad[:n] = x
    blocks = pad.reshape(nb, w)
    pre = np.maximum.accumulate(blocks, axis=1).reshape(-1)
    suf = np.maximum.accumulate(blocks[:, ::-1], axis=1)[:, ::-1].reshape(-1)
    s = np.arange(n - w + 1)
    return np.maximum(suf[s], pre[s + w - 1])


class ReadIndex:
    """The max-hash index of one read set: ``reads`` [n, L] uint8 codes,
    read id = row."""

    def __init__(self, reads: np.ndarray):
        reads = np.ascontiguousarray(reads, np.uint8)
        self.reads = reads
        self.n, self.read_len = reads.shape
        h = pack_kmers(reads) ^ HASH_XOR
        fp = h.max(axis=1)
        self.fp = fp
        self.seed_f = np.argmax(h == fp[:, None], axis=1).astype(np.int64)
        del h
        rc = revcomp(reads)
        target = revcomp_kmer(fp ^ HASH_XOR)
        self.seed_r = np.argmax(pack_kmers(rc) == target[:, None],
                                axis=1).astype(np.int64)
        ok = (reads < 4).all(axis=1)
        rid = np.nonzero(ok)[0]
        order = np.argsort(fp[rid], kind="stable")
        self.sf = fp[rid][order]
        self.srid = rid[order]
        self.oriented = (reads, np.ascontiguousarray(rc))

    def lookup(self, fps: np.ndarray):
        """(run index, read id) of every read under each fingerprint."""
        lo = np.searchsorted(self.sf, fps, "left")
        hi = np.searchsorted(self.sf, fps, "right")
        cnt = hi - lo
        run = np.repeat(np.arange(len(fps)), cnt)
        start = np.repeat(lo - (np.cumsum(cnt) - cnt), cnt)
        return run, self.srid[start + np.arange(int(cnt.sum()))]

    def runs(self, seqs: Sequence[np.ndarray]):
        """(sequence, fingerprint, k-mer end in the sequence) of each run
        of equal window maxima, over every sequence of a batch at once."""
        L = self.read_len
        lens = np.array([len(x) for x in seqs], np.int64)
        keep_seg = lens >= max(L, K)
        if not keep_seg.any():
            return (np.zeros(0, np.int64),) * 3
        buf = np.concatenate([np.asarray(x, np.uint8)
                              for x, k in zip(seqs, keep_seg) if k])
        segs = np.nonzero(keep_seg)[0]
        base = np.cumsum(lens[segs]) - lens[segs]
        h = pack_kmers(buf[None])[0] ^ HASH_XOR
        key = (h << 32) | (0xFFFFFFFF - np.arange(len(h), dtype=np.int64))
        mx = sliding_max(key, L - K + 1)
        # window s lies whole inside one sequence
        seg_of = np.repeat(np.arange(len(segs)), lens[segs])[:len(mx)]
        valid = np.arange(len(mx)) + L <= (base + lens[segs])[seg_of]
        mh = mx >> 32
        first = np.ones(len(mx), bool)
        first[1:] = (mh[1:] != mh[:-1]) | (seg_of[1:] != seg_of[:-1])
        keep = valid & first
        end = (0xFFFFFFFF - (mx & 0xFFFFFFFF)) + K - 1 - base[seg_of]
        return segs[seg_of[keep]], mh[keep], end[keep]

    def candidates(self, seqs: Sequence[np.ndarray], chunk: int = 1 << 20):
        """Candidates of a batch of sequences in emission order (by
        sequence, read, forward runs then reverse ones): (seg, rid, g0,
        r0, orient) int64 arrays, g0 the seed's start in its sequence;
        worked out in groups of about ``chunk`` bases."""
        lens = np.array([len(x) for x in seqs], np.int64)
        if len(seqs) > 1 and lens.sum() > chunk:
            cut = np.searchsorted(np.cumsum(lens), np.arange(
                chunk, int(lens.sum()), chunk), "right")
            parts = []
            for lo, hi in zip(np.r_[0, cut], np.r_[cut, len(seqs)]):
                if hi > lo:
                    seg, *rest = self.candidates(seqs[lo:hi], chunk)
                    parts.append((seg + lo, *rest))
            return tuple(np.concatenate(x) for x in zip(*parts))
        out = []
        for orient, batch in ((0, seqs), (1, [revcomp(np.asarray(x))
                                              for x in seqs])):
            seg, mh, end = self.runs(batch)
            run, rid = self.lookup(mh)
            e, sg = end[run], seg[run]
            g0 = e - K + 1 if orient == 0 else lens[sg] - e - 1
            r0 = (self.seed_f if orient == 0 else self.seed_r)[rid]
            out.append((sg, rid, g0, r0, np.full(len(rid), orient,
                                                 np.int64)))
        seg, rid, g0, r0, ori = (np.concatenate(x) for x in zip(*out))
        order = np.lexsort((rid, seg))
        return seg[order], rid[order], g0[order], r0[order], ori[order]


def dp_rows(read, rlen, gwin, glen, rmax: int):
    """Cost-to-accept DP with the accept offset, rows rmax-1 down to 0
    (candidate-major: read [N, rmax], gwin [N, rmax + 2 PAD]); returns
    (cost, offset) [N, BAND] at row 0, the start state at index 3.  The
    moves of ProcessHit: a match only on the diagonal (the last genome
    base only if it ends the read), else substitution, genome skip (d+1)
    and read skip (d-1) at cost 1; ties taken as the BFS takes them."""
    n = read.shape[0]
    dev = read.device
    d_off = torch.arange(-3, 4, dtype=torch.int32, device=dev)
    rlen = rlen.to(torch.int32).unsqueeze(1)
    glen = glen.to(torch.int32).unsqueeze(1)
    inf = torch.full((n, 1), INF, dtype=torch.int32, device=dev)
    invalid = torch.full((n, 1), INVALID_A, dtype=torch.int32, device=dev)
    c = torch.zeros((n, BAND), dtype=torch.int32, device=dev)
    a = d_off.expand(n, BAND).clone()
    for r in range(rmax - 1, -1, -1):
        chars = gwin[:, r + PAD - 3:r + PAD + 4]
        match = chars == read[:, r:r + 1]
        nomatch = ~match
        g_plus_in = (r + d_off + 1) < glen
        last_row = (r + 1) == rlen
        diag = torch.where(match & (g_plus_in | last_row), c, INF)
        sub = torch.where(nomatch & g_plus_in, c + 1, INF)
        c_dm1 = torch.cat([inf, c[:, :-1]], dim=1)
        rskip = torch.where(nomatch, c_dm1 + 1, INF)
        c_row = torch.minimum(torch.minimum(diag, sub), rskip)
        gskip_ok = nomatch & g_plus_in
        for _ in range(3):
            up = torch.cat([c_row[:, 1:], inf], dim=1)
            c_row = torch.where(gskip_ok, torch.minimum(c_row, up + 1), c_row)
        in_accept = r >= rlen
        c_row = torch.where(in_accept, 0, c_row)
        take_sub = nomatch & g_plus_in & (c == c_row - 1)
        up = torch.cat([c_row[:, 1:], inf], dim=1)
        take_gskip = nomatch & ~take_sub & gskip_ok & (up == c_row - 1)
        take_rskip = nomatch & ~take_sub & ~take_gskip & (c_dm1 == c_row - 1)
        a_dm1 = torch.cat([invalid, a[:, :-1]], dim=1)
        a_row = torch.where(match | take_sub, a,
                            torch.where(take_rskip, a_dm1, INVALID_A))
        for _ in range(4):
            a_up = torch.cat([a_row[:, 1:], invalid], dim=1)
            a_row = torch.where(take_gskip, a_up, a_row)
        a_row = torch.where(in_accept, d_off, a_row)
        c, a = c_row, a_row
    return c, a


def extend(index: ReadIndex, buf: np.ndarray, base, glen, rid, g0, r0, ori,
           device, block: int = 1 << 18):
    """ProcessHit of every candidate (window ``base``/``glen`` in
    ``buf``): (ok, errs, begin) numpy arrays."""
    n = len(rid)
    ok = np.zeros(n, bool)
    errs = np.zeros(n, np.int64)
    begin = np.zeros(n, np.int64)
    if n == 0:
        return ok, errs, begin
    dev = torch.device(device)
    L = index.read_len
    fwd, rc = (torch.as_tensor(x, device=dev) for x in index.oriented)
    wl = 2 * L + 2 * PAD
    bufp = torch.as_tensor(np.concatenate([np.full(wl, SENT_GEN, np.uint8),
                                           buf, np.full(wl, SENT_GEN,
                                                        np.uint8)]),
                           device=dev)
    for s in range(0, n, block):
        sl = slice(s, min(n, s + block))
        t = {k: torch.as_tensor(np.asarray(v[sl], np.int64), device=dev)
             for k, v in dict(base=base, glen=glen, rid=rid, g0=g0, r0=r0,
                              ori=ori).items()}
        reads = torch.where((t["ori"] == 1).unsqueeze(1), rc[t["rid"]],
                            fwd[t["rid"]])
        costs = []
        offsets = None
        sent_read = torch.tensor(SENT_READ, dtype=torch.uint8, device=dev)
        sent_gen = torch.tensor(SENT_GEN, dtype=torch.uint8, device=dev)
        live = t["g0"] > 0
        for direction in ("f", "b"):
            # forward: the read after the seed against the window from
            # the seed's end (the band reaches PAD bases back); backward:
            # the reversed read before the seed against the reversed
            # window before it
            if direction == "f":
                rows = L - t["r0"] - K
                gl = t["glen"] - t["g0"] - K
                col0, step = t["r0"] + K, 1
            else:
                rows = torch.where(live, t["r0"], 0)
                gl = torch.where(live, t["g0"], 0)
                col0, step = t["r0"] - 1, -1
            rmax = max(int(rows.max()), 1)
            j = torch.arange(rmax, device=dev)
            cols = col0.unsqueeze(1) + step * j
            rd = torch.where(j < rows.unsqueeze(1),
                             reads.gather(1, cols.clamp(0, L - 1)),
                             sent_read)
            jj = torch.arange(rmax + 2 * PAD, device=dev) - PAD
            if direction == "f":
                q = (t["g0"] + K).unsqueeze(1) + jj
                inb = (q >= 0) & (q < t["glen"].unsqueeze(1))
            else:
                q = (t["g0"] - 1).unsqueeze(1) - jj
                inb = (jj >= 0) & (q >= 0) & live.unsqueeze(1)
            gw = torch.where(inb, bufp[(t["base"].unsqueeze(1) + q + wl)
                                       .clamp(0, len(bufp) - 1)], sent_gen)
            c, a = dp_rows(rd, rows, gw, gl, rmax)
            costs.append(c[:, 3])
            if direction == "b":
                offsets = a[:, 3]
        cf, cb = costs
        at_start = t["g0"] == 0
        o = (cf <= ERROR_LIMIT) & (cb <= ERROR_LIMIT) & \
            (~at_start | (t["r0"] < 6))
        e = cf.to(torch.int64) + cb + torch.where(at_start, t["r0"], 0)
        b = torch.where(at_start, -1, t["g0"] - t["r0"] - offsets)
        ok[sl], errs[sl], begin[sl] = (x.cpu().numpy() for x in (o, e, b))
    return ok, errs, begin


def align_batch(index: ReadIndex, seqs: Sequence[np.ndarray], device):
    """Every candidate of every sequence of a batch, extended: a dict of
    int64 arrays seg, rid, g0, r0, orient, ok, errs, begin, in emission
    order (by sequence, then read, forward runs before reverse)."""
    lens = np.array([len(s) for s in seqs], np.int64)
    base = np.cumsum(lens) - lens
    out = dict(zip(("seg", "rid", "g0", "r0", "orient"),
                   index.candidates(seqs)))
    buf = np.concatenate([np.asarray(s, np.uint8) for s in seqs]) \
        if len(seqs) else np.zeros(0, np.uint8)
    ok, errs, begin = extend(index, buf, base[out["seg"]], lens[out["seg"]],
                             out["rid"], out["g0"], out["r0"],
                             out["orient"], device)
    out.update(ok=ok, errs=errs, begin=begin)
    return out


def first_wins(seg, rid, begin, ok):
    """Mask of the ok candidates that are the first of their (segment,
    read, begin) in emission order."""
    idx = np.nonzero(ok)[0]
    key = np.lexsort((idx, begin[idx], rid[idx], seg[idx]))
    s = idx[key]
    first = np.ones(len(s), bool)
    first[1:] = (seg[s][1:] != seg[s][:-1]) | (rid[s][1:] != rid[s][:-1]) \
        | (begin[s][1:] != begin[s][:-1])
    keep = np.zeros(len(ok), bool)
    keep[s[first]] = True
    return keep


def rescore(index: ReadIndex, seqs, match_prob, mismatch_prob,
            min_prob_per_base, min_prob_start, device, dtype=np.float64,
            aligned=None):
    """Single-end GetTotalProb of an assembly whose contigs are ``seqs``:
    (score, zero reads, candidates, the aligned batch)."""
    a = aligned if aligned is not None else align_batch(index, seqs, device)
    keep = first_wins(a["seg"], a["rid"], a["begin"], a["ok"])
    L = index.read_len
    e = a["errs"][keep].astype(dtype)
    p = np.power(dtype(mismatch_prob), e) * np.power(dtype(match_prob),
                                                    dtype(L) - e)
    probs = np.zeros(index.n, dtype)
    np.add.at(probs, a["rid"][keep], p)
    total = max(int(sum(len(s) for s in seqs)), 1)
    score, zeros = floored_mean_log(probs, total, np.full(index.n, L),
                                    min_prob_per_base, min_prob_start, dtype)
    return score, zeros, len(a["rid"]), a


def floored_mean_log(probs, total_len, lens, mpb, mps, dtype=np.float64):
    """mean of log(max(p / (2 total_len), exp(mps + mpb L))) and the
    number of reads floored."""
    probs = np.asarray(probs, dtype)
    with np.errstate(divide="ignore"):
        adj = np.log(probs) - dtype(math.log(2 * max(total_len, 1)))
    floor = (dtype(mps) + dtype(mpb) * np.asarray(lens, dtype)).astype(dtype)
    zeros = int(np.count_nonzero(adj < floor))
    return float(np.sum(np.maximum(adj, floor), dtype=dtype)
                 / dtype(len(probs))), zeros


# ------------------------------------------------- the paired scoring call
class Graph:
    """Node sequences by the program's ids: Velvet node k (1-based, in
    file order) is 2(k-1) forward and 2(k-1)+1 reverse; a negative walk
    entry is a gap of that many bases."""

    def __init__(self, nodes: Sequence[np.ndarray]):
        self.fwd = [np.asarray(x, np.uint8) for x in nodes]
        self.lens = np.repeat([len(x) for x in self.fwd], 2).astype(np.int64)
        self._rc = {}

    def seq(self, e: int) -> np.ndarray:
        if e % 2 == 0:
            return self.fwd[e // 2]
        hit = self._rc.get(e)
        if hit is None:
            hit = self._rc[e] = revcomp(self.fwd[e // 2])
        return hit

    def node_len(self, e: int) -> int:
        return int(self.lens[e])

    def walk_len(self, path) -> int:
        return sum(-e if e < 0 else self.node_len(e) for e in path)

    def window_at(self, path, i, stop_at_gap=True):
        """Node i and the following nodes until the following ones pass
        300 bases: (window, index of its last node)."""
        win = [path[i]]
        end = i
        run = 0
        for j in range(i + 1, len(path)):
            if stop_at_gap and path[j] < 0:
                break
            run += self.node_len(path[j])
            win.append(path[j])
            end = j
            if run > MIN_SUBPATH:
                break
        return tuple(win), end

    def spell_window(self, win):
        """The window's sequence, a long first node cut to its last 300
        bases and a long last node to its first 300, and the offset of
        the cut."""
        parts, offset = [], 0
        n = len(win)
        for i, e in enumerate(win):
            s = self.seq(e)
            if i == 0 and n > 1 and len(s) > MIN_SUBPATH:
                offset = len(s) - MIN_SUBPATH
                parts.append(s[offset:])
            elif i > 0 and len(s) > MIN_SUBPATH and i + 1 == n:
                parts.append(s[:MIN_SUBPATH])
            else:
                parts.append(s)
        return np.concatenate(parts), offset


def split_at_gaps(path):
    ctgs, gaps, cur = [], [], []
    for e in path:
        if e < 0:
            ctgs.append(cur)
            gaps.append(-e)
            cur = []
        else:
            cur.append(e)
    ctgs.append(cur)
    return ctgs, gaps


def invert(win):
    return tuple((x ^ 1) if x >= 0 else x for x in reversed(win))


def process_hit(g0: int, r0: int, read: np.ndarray, seq: np.ndarray):
    """ProcessHit (graph.cc:753-837) as written: a 0-1 BFS from the seed
    over (genome, read) states, forward to the read's end and backward to
    its start, each at most 3 errors.  On a match only the diagonal move
    (the last genome base only if it ends the read); on a mismatch a
    substitution, a genome skip and a read skip at cost 1, queued in that
    order.  A state counts as seen when it is queued, so a state queued
    at cost c + 1 is not queued again at cost c.  A seed at genome
    position 0 skips the backward pass: accepted iff r0 < 6, with r0
    errors and begin -1.  Returns (errs, begin) or None."""
    from collections import deque

    glen, rlen = len(seq), len(read)

    def char(g):
        return int(seq[g]) if 0 <= g < glen else -1

    def search(g, r, step, done_r, in_genome):
        queue = deque([(0, g, r)])
        seen = set()
        while queue:
            cost, g, r = queue.popleft()
            if cost > ERROR_LIMIT:
                return None
            if r == done_r:
                return cost, g
            if char(g) == int(read[r]):
                if in_genome(g + step) or r + step == done_r:
                    if (r + step, g + step) not in seen:
                        seen.add((r + step, g + step))
                        queue.appendleft((cost, g + step, r + step))
            else:
                if in_genome(g + step):
                    for ng, nr in ((g + step, r + step), (g + step, r)):
                        if (nr, ng) not in seen:
                            seen.add((nr, ng))
                            queue.append((cost + 1, ng, nr))
                if (r + step, g) not in seen:
                    seen.add((r + step, g))
                    queue.append((cost + 1, g, r + step))
        return None

    fwd = search(g0 + K, r0 + K, 1, rlen, lambda g: g < glen)
    if fwd is None:
        return None
    if g0 == 0:
        return (fwd[0] + r0, -1) if r0 < 6 else None
    bwd = search(g0 - 1, r0 - 1, -1, -1, lambda g: g >= 0)
    if bwd is None:
        return None
    return fwd[0] + bwd[0], bwd[1] + 1


class WindowAligner:
    """Alignments of node windows against one read set, computed once per
    window: (position, errs, rid, orient) sorted by (position, read),
    first wins per (position, read), by the device route's DP.

    ``program`` (window -> the program's alignment of it), where given,
    is judged window by window: the program's device route computes the
    DP's minimum cost and its native route ProcessHit's BFS, which can
    cost more (a state seen at a higher cost is not queued again; the
    repository's open item C8).  A window that differs from the DP's
    result is aligned again by the BFS; where that equals the program's,
    the BFS's alignment is the window's, else the window counts in
    ``mismatched`` and keeps the DP's."""

    def __init__(self, graph: Graph, index: ReadIndex, device,
                 program=None):
        self.graph, self.index, self.device = graph, index, device
        self.program = program
        self.done: Dict[tuple, tuple] = {}
        self.by_bfs = 0
        self.mismatched = 0

    def fill(self, wins) -> None:
        todo = [w for w in dict.fromkeys(wins) if w not in self.done]
        if not todo:
            return
        seqs, offs, keep = [], [], []
        empty = tuple(np.zeros(0, np.int64) for _ in range(4))
        for w in todo:
            s, off = self.graph.spell_window(w)
            if len(s) < self.index.read_len:
                self.done[w] = empty
                self.judge(w, empty, None)
                continue
            seqs.append(s)
            offs.append(off)
            keep.append(w)
        if not keep:
            return
        a = align_batch(self.index, seqs, self.device)
        pos = a["begin"] + 1 + np.asarray(offs, np.int64)[a["seg"]]
        first = first_wins(a["seg"], a["rid"], pos, a["ok"])
        bounds = np.searchsorted(a["seg"], np.arange(len(keep) + 1))
        for i, w in enumerate(keep):
            sl = slice(bounds[i], bounds[i + 1])
            self.done[w] = window_columns(pos[sl], a["errs"][sl],
                                          a["rid"][sl], a["orient"][sl],
                                          first[sl])
            self.judge(w, self.done[w], (seqs[i], offs[i], {
                k: a[k][sl] for k in ("rid", "g0", "r0", "orient")}))

    def judge(self, w, cols, cands) -> None:
        if self.program is None or w not in self.program:
            return
        got = tuple(np.asarray(x, np.int64) for x in self.program[w])
        if same(got, cols):
            return
        if cands is not None:
            seq, off, c = cands
            res = [process_hit(int(g), int(r),
                               self.index.oriented[int(o)][int(rid)], seq)
                   for rid, g, r, o in zip(c["rid"], c["g0"], c["r0"],
                                           c["orient"])]
            ok = np.array([x is not None for x in res], bool)
            errs = np.array([x[0] if x else 0 for x in res], np.int64)
            pos = np.array([x[1] if x else 0 for x in res], np.int64) \
                + 1 + off
            seg = np.zeros(len(res), np.int64)
            bfs = window_columns(pos, errs, c["rid"], c["orient"],
                                 first_wins(seg, c["rid"], pos, ok))
            if same(got, bfs):
                self.done[w] = bfs
                self.by_bfs += 1
                return
        self.mismatched += 1


def window_columns(pos, errs, rid, orient, keep):
    p, e, r, o = (x[keep] for x in (pos, errs, rid, orient))
    order = np.lexsort((r, p))
    return p[order], e[order], r[order], o[order]


def same(a, b) -> bool:
    return all(len(x) == len(y) and np.array_equal(x, y)
               for x, y in zip(a, b))


class WalkPlan:
    """What scoring a walk reads and inserts, fixed by its nodes: the
    precompute's entries (window, the index its window ends at, the end
    before it inside the walk, whether a lone long node is inserted
    whatever the ends, the long node's own windows), the windows its
    staging may insert, every window its positions look up, and its
    contigs with their starts."""

    def __init__(self, graph: "Graph", path):
        g = graph
        self.entries = []
        prev = None
        for i in range(len(path)):
            if path[i] < 0:
                continue
            win, end = g.window_at(path, i, True)
            always = len(win) == 1 and g.node_len(win[0]) > 150
            singles = ((path[i],), (path[i] ^ 1,)) \
                if g.node_len(path[i]) > MIN_SUBPATH else ()
            self.entries.append((win, end, prev, always, singles))
            prev = end
        self.end_out = prev
        ctgs, gaps = split_at_gaps(path)
        self.ctgs_st, cur = [], 0
        self.staged, self.lookups = [], []
        for i, ctg in enumerate(ctgs):
            if i > 0:
                cur += gaps[i - 1]
            self.ctgs_st.append((ctg, cur))
            cur += g.walk_len(ctg)
            last_end = -1
            for j in range(len(ctg)):
                win, end = g.window_at(ctg, j, True)
                if end != last_end:
                    self.staged.append(win)
                last_end = end
                self.lookups.append(win)
                if g.node_len(win[0]) > MIN_SUBPATH:
                    self.lookups.append((win[0],))
        self.lookups = tuple(dict.fromkeys(self.lookups))
        self.gaps = gaps


class View:
    """One read set's alignment cache as the reference follows it: the
    windows it holds, those the reference itself inserted, and, per
    walk, what of the walk's precompute may still insert something and
    which of its lookups the cache still lacks."""

    def __init__(self):
        self.held = set()
        self.inserted = set()
        self.pending = {}
        self.staged = set()
        self.missing = {}

    def add(self, wins) -> None:
        new = [w for w in wins if w not in self.held]
        self.held.update(new)
        self.inserted.update(new)


def changes(counter: dict, walks):
    """GetChanges of a call as the scorer keeps its walk multiset (an
    insertion-ordered count): the walks it adds, in the call's order, and
    those it erases, in the order the multiset first held them; the
    multiset is brought up to the call's walks."""
    remaining = dict(counter)
    added = []
    for w in walks:
        c = remaining.get(w, 0)
        if c > 0:
            remaining[w] = c - 1
        else:
            added.append(w)
    erased = [w for w, c in remaining.items() for _ in range(c)]
    for w in added:
        counter[w] = counter.get(w, 0) + 1
    for w in erased:
        c = counter[w] - 1
        if c:
            counter[w] = c
        else:
            del counter[w]
    return erased, added


class PairedLibrary:
    """One paired library (two mate read sets) and its configuration, as
    the CLI parses it: match = 1 - 4 mismatch; the coverage step is
    insert_mean - penalty_step; the floor's per-base term is the
    library's ``min_prob_pre_base`` (default -0.7).

    Its scoring calls (CalcScoreForPathsNew) are followed from an empty
    state (``replay``).  A call's score rests on per-read totals that
    every earlier call added to and took from, each walk's term worked
    out under the cache of its own moment (GAML skips a window whose end
    repeats unless the cache holds it), so a call's totals are the sum
    of every term added and taken away since the first call.  Which
    windows each cache held when a call started is the program's (its
    keys in insertion order, ``keys``); what a call inserts itself, each
    walk's term and every sum are worked out here.  ``walks`` maps a
    walk's number to its nodes."""

    def __init__(self, graph, reads1, reads2, cfg: dict, device,
                 program=(None, None), walks=()):
        self.graph = graph
        self.walks = walks
        self.idx = (ReadIndex(reads1), ReadIndex(reads2))
        self.al = tuple(WindowAligner(graph, ix, device, prog)
                        for ix, prog in zip(self.idx, program))
        mm = float(cfg.get("mismatch_prob", 0.01))
        self.mismatch, self.match = mm, 1.0 - 4 * mm
        self.im = float(cfg["insert_mean"])
        self.istd = float(cfg["insert_std"])
        self.penalty = float(cfg.get("penalty_constant", 0.0))
        self.step = self.im - float(cfg.get("penalty_step", 50.0))
        self.mpb = float(cfg.get("min_prob_pre_base", -0.7))
        self.mps = float(cfg.get("min_prob_start", -10.0))
        self.weight = float(cfg.get("weight", 1.0))
        self.lens = (np.full(self.idx[0].n, self.idx[0].read_len, np.int64),
                     np.full(self.idx[1].n, self.idx[1].read_len, np.int64))
        n = int(self.im + 5 * self.istd)
        self.table = self._pdf(np.arange(n, dtype=np.float64))
        self.views = (View(), View())
        self.seen = [0, 0]
        self.plans: Dict[int, WalkPlan] = {}
        self.terms = {}

    def _pdf(self, x):
        z = (x - self.im) / self.istd
        return np.exp(-z * z / 2.0) / (np.sqrt(2 * np.pi) * self.istd)

    def plan(self, w: int) -> WalkPlan:
        p = self.plans.get(w)
        if p is None:
            p = self.plans[w] = WalkPlan(self.graph, self.walks[w])
        return p

    # ----------------------------------------------- following the calls
    def precompute(self, walks, view: View) -> None:
        """PrecomputeAlignmentForPaths of a call over one read set's cache:
        a window goes in unless the cache holds it or its end repeats the
        previous window's (a lone node over 150 bases always), with its
        inversion; a node over 300 bases goes in alone, both strands.
        Every test is against the cache the call started with."""
        out = []
        last_end = -1
        done = []
        pending = view.pending
        for w in walks:
            pend = pending.get(w)
            if pend is None:
                pend = pending[w] = list(range(len(self.plan(w).entries)))
            if pend:
                entries = self.plans[w].entries
                for k in pend:
                    win, end, prev, always, singles = entries[k]
                    before = last_end if k == 0 else prev
                    if win not in view.held and (before != end or always):
                        out += [win, invert(win)]
                    if singles and singles[0] not in view.held:
                        out += singles
                done.append(w)
            end_out = self.plans[w].end_out
            if end_out is not None:
                last_end = end_out
        view.add(out)
        for w in done:
            entries = self.plan(w).entries
            view.pending[w] = [
                k for k in view.pending[w]
                if entries[k][0] not in view.held or
                (entries[k][4] and entries[k][4][0] not in view.held)]

    def stage(self, w: int, view: View) -> tuple:
        """The staging of a walk's positions (each contig's windows whose
        end does not repeat go in), then the walk's lookups the cache
        lacks."""
        plan = self.plan(w)
        if w not in view.staged:
            view.add(plan.staged)
            view.staged.add(w)
        miss = view.missing.get(w, plan.lookups)
        miss = view.missing[w] = tuple(x for x in miss
                                       if x not in view.held)
        return miss

    def replay(self, calls, keys, pre, judged):
        """Follow ``calls`` (each its walks' numbers, in order) from an
        empty multiset and no terms; before call k each mate's cache holds
        its first ``pre[k][mate]`` keys of ``keys[mate]`` and what the
        reference inserted so far.  Returns, for each k in ``judged``, the
        terms that the totals after call k hold: {(walk, lookups missing
        from each mate's cache): count}."""
        counter, net = {}, {}
        out = {}
        for k, walks in enumerate(calls):
            for m, view in enumerate(self.views):
                n = pre[k][m]
                if n > self.seen[m]:
                    view.held.update(keys[m][self.seen[m]:n])
                    self.seen[m] = n
                self.precompute(walks, view)
            erased, added = changes(counter, walks)
            for group, sign in ((erased, -1), (added, 1)):
                for w in group:
                    key = (w,) + tuple(self.stage(w, v) for v in self.views)
                    c = net.get(key, 0) + sign
                    if c:
                        net[key] = c
                    else:
                        del net[key]
            if k in judged:
                out[k] = dict(net)
        return out

    def uncached(self, keys) -> int:
        """Windows the reference inserted that the program's cache never
        held."""
        return sum(len(v.inserted - set(ks)) for v, ks in zip(self.views,
                                                              keys))

    # ------------------------------------------------ terms and totals
    def present(self, key, m: int) -> set:
        return set(self.plan(key[0]).lookups) - set(key[1 + m])

    def prefetch(self, nets) -> None:
        """Align at once every window that the terms of ``nets`` read."""
        keys = {key for net in nets for key in net}
        for m, al in enumerate(self.al):
            al.fill([w for key in keys for w in self.present(key, m)])

    def term(self, key, dtype=np.float64):
        """A walk's term under the cache view ``key`` names:
        (reads, probabilities, bad bases)."""
        hit = self.terms.get((key, dtype))
        if hit is None:
            hit = self.terms[(key, dtype)] = self.walk(
                key[0], [self.present(key, m) for m in (0, 1)], dtype)
        return hit

    def totals(self, net, dtype=np.float64):
        """The per-read totals and bad bases that the terms ``net`` sum
        to, and each read's sum of the terms' magnitudes."""
        n = self.idx[0].n
        probs = np.zeros(n, dtype)
        size = np.zeros(n, np.float64)
        bad = 0
        for key, c in net.items():
            rid, p, b = self.term(key, dtype)
            np.add.at(probs, rid, dtype(c) * p)
            np.add.at(size, rid, abs(c) * np.abs(p.astype(np.float64)))
            bad += c * b
        return probs, size, bad

    def score(self, probs, bad, total, dtype=np.float64):
        """The library's score of per-read totals (the floored mean log
        with its coverage penalty) and its zero reads."""
        s, zeros = floored_mean_log(
            np.where(probs > 0, probs, 0), total,
            self.lens[0] + self.lens[1], self.mpb, self.mps, dtype)
        return s - bad * self.penalty, zeros

    # ------------------------------------------------ one walk's term
    def positions(self, mate, ctgs_st, present):
        """GetPositionsOnlyPath over a walk's contigs: (rid, pos, errs,
        orient) in the order of each read's list."""
        g, al = self.graph, self.al[mate]
        need = []
        for ctg, _st in ctgs_st:
            for i in range(len(ctg)):
                win, _ = g.window_at(ctg, i, False)
                need += [win, (win[0],)]
        al.fill([w for w in need if w in present])
        parts = []
        for ctg, st in ctgs_st:
            cur_pos, max_pos = st, 0
            for i in range(len(ctg)):
                win, _ = g.window_at(ctg, i, False)
                seqs = [win]
                if g.node_len(win[0]) > MIN_SUBPATH:
                    seqs.append((win[0],))
                cur_max = 0
                for w in seqs:
                    if w not in present:
                        continue
                    p, e, r, o = al.done[w]
                    p = p + cur_pos
                    m = p >= max_pos - 5
                    if m.any():
                        cur_max = max(cur_max, int(p[m].max()))
                        parts.append((r[m], p[m], e[m], o[m]))
                cur_pos += g.node_len(ctg[i])
                max_pos = max(max_pos, cur_max)
        if not parts:
            return tuple(np.zeros(0, np.int64) for _ in range(4))
        r, p, e, o = (np.concatenate(x) for x in zip(*parts))
        # an alignment at a position the read already has overwrites it
        # in place: the entry keeps its first place, the last values win
        seq = np.arange(len(r))
        key = np.lexsort((seq, p, r))
        rs, ps = r[key], p[key]
        brk = np.ones(len(key), bool)
        brk[1:] = (rs[1:] != rs[:-1]) | (ps[1:] != ps[:-1])
        starts = np.nonzero(brk)[0]
        ends = np.append(starts[1:], len(key)) - 1
        first, last = key[starts], key[ends]
        order = np.argsort(first, kind="stable")
        first, last = first[order], last[order]
        rid = r[first]
        by_read = np.argsort(rid, kind="stable")
        first, last = first[by_read], last[by_read]
        return r[first], p[first], e[last], o[last]

    def walk(self, w: int, present, dtype=np.float64):
        """CalcScoreForPathInc: the walk's (rid, p) pair terms and its bad
        bases, with the windows ``present`` (one set per mate) in the
        caches."""
        plan = self.plan(w)
        ctgs_st = plan.ctgs_st
        events_pos = [st for _c, st in ctgs_st]
        events_typ = [1] * len(ctgs_st)
        (r1, p1, e1, o1), (r2, p2, e2, o2) = (
            self.positions(m, ctgs_st, present[m]) for m in (0, 1))
        # every (x, y) of a read in both lists, x-major, reads ascending
        lo = np.searchsorted(r2, r1, "left")
        hi = np.searchsorted(r2, r1, "right")
        cnt = hi - lo
        xi = np.repeat(np.arange(len(r1)), cnt)
        yi = np.repeat(lo - (np.cumsum(cnt) - cnt), cnt) + \
            np.arange(int(cnt.sum()))
        rid = r1[xi]
        xp, yp, xo, yo = p1[xi], p2[yi], o1[xi], o2[yi]
        L1, L2 = self.lens[0][rid], self.lens[1][rid]
        fwd_first = (xp < yp) & (xo == 0) & (yo == 1)
        rev_first = (xp >= yp) & (xo == 1) & (yo == 0)
        good = (xo != yo) & (fwd_first | rev_first)
        dist = np.where(xp < yp, yp - xp + L2, xp - yp + L1)
        rid, xp, yp, dist = rid[good], xp[good], yp[good], dist[good]
        xe, ye = e1[xi][good].astype(dtype), e2[yi][good].astype(dtype)
        L1, L2 = L1[good].astype(dtype), L2[good].astype(dtype)
        mm, m = dtype(self.mismatch), dtype(self.match)
        ins = np.where((dist >= 0) & (dist < len(self.table)),
                       self.table[np.clip(dist, 0, len(self.table) - 1)],
                       self._pdf(dist.astype(np.float64))).astype(dtype)
        p = (np.power(mm, xe) * np.power(m, L1 - xe)) * \
            (np.power(mm, ye) * np.power(m, L2 - ye)) * ins
        thr = np.exp(self.mps + self.mpb * (2 * self.lens[1][rid]))
        ev = p > thr
        events_pos += np.maximum(xp, yp)[ev].tolist() + \
            np.minimum(xp, yp)[ev].tolist()
        events_typ += [3] * (2 * int(ev.sum()))
        bad = coverage_sweep(np.asarray(events_pos, np.int64),
                             np.asarray(events_typ, np.int64), self.im,
                             self.istd, self.step)
        return rid, p, bad


def coverage_sweep(pos, typ, im, istd, step) -> int:
    """The paired coverage-gap sweep over events sorted by (pos, type):
    a type-3 event more than ``step`` past the previous event, which was
    a type-3 event or none, and more than mean + 5 sd past the last
    contig start adds the bases since the previous event."""
    order = np.lexsort((typ, pos))
    pos, typ = pos[order], typ[order]
    prev_pos = np.concatenate([[0], pos[:-1]])
    prev_typ = np.concatenate([[-1], typ[:-1]])
    begins = np.where(typ == 1, pos, -1)
    last_begin = np.maximum.accumulate(np.concatenate([[0], begins[:-1]]))
    hit = (typ == 3) & (pos - prev_pos > step) & \
        ((prev_typ == 3) | (prev_typ < 0)) & \
        (pos - last_begin > im + 5 * istd)
    return int((pos - prev_pos)[hit].sum())
