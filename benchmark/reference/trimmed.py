"""Plain reference of the short-read likelihood over reads of mixed lengths
(quality-trimmed libraries): numpy and plain torch, TF32 off; nothing of
the program is imported.  For the comparison that decides ``correct`` in
the ``aureus_trimmed.anneal`` cell and for the tests.

It is ``reference/shortread.py`` with its read index, extension and
scores made ragged; the graph, the window plan, the paired replay, the
pair terms, the coverage sweep and the floors are that file's, by
import.  What changes with mixed lengths:

- the index (``RaggedIndex``): each ACGT read's fingerprint is the max
  hash over its own k-mers, its seeds the first k-mer of the read (and
  of its reverse complement) equal to that k-mer (and its reverse
  complement), as in ``shortread.ReadIndex``;
- the query length (``query_length``): one length for every window of
  every query.  GAML's index keeps one read length, that of the last
  read it indexed; the program groups the reads by length, the groups in
  the order their first read appears, and inserts group after group, so
  the query length is that of the group whose first read comes last
  (the repository's open item C11).  Windows are queried at that
  length, and a window shorter than it is skipped;
- the extension runs at each read's own length: the forward pass to the
  read's own end;
- a read's alignment probability is ``mismatch^e match^(len - e)`` with
  its own length; the paired replay gives each mate its own length, in
  the insert (mate 2's end) and in the floors.

Departures from the upstream description, both the program's too: C11
above (GAML's own index would query at the length of its last read);
the pair threshold takes mate 2's length twice (``graph.cc:1855-1857``,
inherited from ``shortread.PairedLibrary.walk``).  Reads shorter than
the k-mer are not expected (the trim keeps 60 bp or more).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import List, Sequence

import numpy as np
import torch

from reference import shortread as S

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the names drivers/anneal.py's judge reads from its reference module
Graph = S.Graph


def query_length(reads: Sequence[np.ndarray]) -> int:
    """C11: the length of the ACGT read group whose first read comes
    last (0 for no ACGT read)."""
    lens = np.array([len(r) for r in reads], np.int64)
    ok = np.array([bool((np.asarray(r) < 4).all()) for r in reads], bool)
    if not ok.any():
        return 0
    lengths, first = np.unique(lens[ok], return_index=True)
    return int(lengths[np.argmax(first)])


def padded(reads: Sequence[np.ndarray], width: int) -> np.ndarray:
    """Reads as rows of a [n, width] matrix, left-aligned, N after."""
    out = np.full((len(reads), width), 4, np.uint8)
    for i, r in enumerate(reads):
        out[i, :len(r)] = r
    return out


class RaggedIndex(S.ReadIndex):
    """The max-hash index of one read set of mixed lengths: ``reads`` a
    list of uint8 code arrays, read id = position.  ``lens`` holds each
    read's length, ``read_len`` the query length; ``oriented`` each read
    and its reverse complement at its own length, ``rows`` the same as
    left-aligned matrices."""

    def __init__(self, reads: Sequence[np.ndarray]):
        reads = [np.ascontiguousarray(r, np.uint8) for r in reads]
        self.n = len(reads)
        self.lens = np.array([len(r) for r in reads], np.int64)
        assert self.n and self.lens.min() >= S.K, "reads shorter than K"
        width = int(self.lens.max())
        rc = [S.revcomp(r) for r in reads]
        fwd_rows, rc_rows = padded(reads, width), padded(rc, width)
        valid = np.arange(width - S.K + 1) < (self.lens - S.K + 1)[:, None]
        h = np.where(valid, S.pack_kmers(fwd_rows) ^ S.HASH_XOR, -1)
        fp = h.max(axis=1)
        self.fp = fp
        self.seed_f = np.argmax(h == fp[:, None], axis=1).astype(np.int64)
        target = S.revcomp_kmer(fp ^ S.HASH_XOR)
        self.seed_r = np.argmax(valid & (S.pack_kmers(rc_rows)
                                         == target[:, None]),
                                axis=1).astype(np.int64)
        ok = np.array([bool((r < 4).all()) for r in reads], bool)
        rid = np.nonzero(ok)[0]
        order = np.argsort(fp[rid], kind="stable")
        self.sf = fp[rid][order]
        self.srid = rid[order]
        self.read_len = query_length(reads)
        self.oriented = (reads, rc)
        self.rows = (fwd_rows, rc_rows)


def extend(index: RaggedIndex, buf, base, glen, rid, g0, r0, ori, device):
    """ProcessHit of every candidate at its read's own length: for each
    read length, ``shortread.extend`` over the candidates of that length's
    reads; (ok, errs, begin) numpy arrays in the candidates' order."""
    n = len(rid)
    ok = np.zeros(n, bool)
    errs = np.zeros(n, np.int64)
    begin = np.zeros(n, np.int64)
    lens = index.lens[rid]
    for L in np.unique(lens).tolist():
        sel = np.nonzero(lens == L)[0]
        group = SimpleNamespace(read_len=L, oriented=tuple(
            np.ascontiguousarray(m[:, :L]) for m in index.rows))
        ok[sel], errs[sel], begin[sel] = S.extend(
            group, buf, base[sel], glen[sel], rid[sel], g0[sel], r0[sel],
            ori[sel], device)
    return ok, errs, begin


def align_batch(index: RaggedIndex, seqs: Sequence[np.ndarray], device):
    """``shortread.align_batch`` with the extension at each read's own
    length."""
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


def rescore(index: RaggedIndex, seqs, match_prob, mismatch_prob,
            min_prob_per_base, min_prob_start, device, dtype=np.float64):
    """Single-end GetTotalProb of an assembly whose contigs are ``seqs``,
    each read's probability and floor at its own length: (score, zero
    reads, candidates)."""
    a = align_batch(index, seqs, device)
    keep = S.first_wins(a["seg"], a["rid"], a["begin"], a["ok"])
    e = a["errs"][keep].astype(dtype)
    L = index.lens[a["rid"][keep]].astype(dtype)
    p = np.power(dtype(mismatch_prob), e) * np.power(dtype(match_prob),
                                                    L - e)
    probs = np.zeros(index.n, dtype)
    np.add.at(probs, a["rid"][keep], p)
    total = max(int(sum(len(s) for s in seqs)), 1)
    score, zeros = S.floored_mean_log(probs, total, index.lens,
                                      min_prob_per_base, min_prob_start,
                                      dtype)
    return score, zeros, len(a["rid"])


class WindowAligner(S.WindowAligner):
    """``shortread.WindowAligner`` over a ``RaggedIndex``: windows shorter
    than the query length are skipped (counted in ``skipped``), the rest
    aligned by ``align_batch`` here and judged against the program's as
    there."""

    skipped = 0

    def fill(self, wins) -> None:
        todo = [w for w in dict.fromkeys(wins) if w not in self.done]
        seqs, offs, keep = [], [], []
        empty = tuple(np.zeros(0, np.int64) for _ in range(4))
        for w in todo:
            s, off = self.graph.spell_window(w)
            if len(s) < self.index.read_len:
                self.done[w] = empty
                self.skipped += 1
                self.judge(w, empty, None)
                continue
            seqs.append(s)
            offs.append(off)
            keep.append(w)
        if not keep:
            return
        a = align_batch(self.index, seqs, self.device)
        pos = a["begin"] + 1 + np.asarray(offs, np.int64)[a["seg"]]
        first = S.first_wins(a["seg"], a["rid"], pos, a["ok"])
        bounds = np.searchsorted(a["seg"], np.arange(len(keep) + 1))
        for i, w in enumerate(keep):
            sl = slice(bounds[i], bounds[i + 1])
            self.done[w] = S.window_columns(pos[sl], a["errs"][sl],
                                            a["rid"][sl], a["orient"][sl],
                                            first[sl])
            self.judge(w, self.done[w], (seqs[i], offs[i], {
                k: a[k][sl] for k in ("rid", "g0", "r0", "orient")}))


class PairedLibrary(S.PairedLibrary):
    """``shortread.PairedLibrary`` over two mate read sets of mixed
    lengths (lists of code arrays, read id = position): each mate's index
    a ``RaggedIndex``, each read its own length."""

    def __init__(self, graph, reads1: List[np.ndarray],
                 reads2: List[np.ndarray], cfg: dict, device,
                 program=(None, None), walks=()):
        # the library's parameters and state as shortread's, over no
        # reads; then the ragged indexes, aligners and lengths
        none = np.zeros((0, S.K), np.uint8)
        super().__init__(graph, none, none, cfg, device, program, walks)
        self.idx = (RaggedIndex(reads1), RaggedIndex(reads2))
        self.al = tuple(WindowAligner(graph, ix, device, prog)
                        for ix, prog in zip(self.idx, program))
        self.lens = tuple(ix.lens for ix in self.idx)
