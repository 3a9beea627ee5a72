"""Deterministic BLASR stand-in for differential testing.

The reference drives BLASR as a subprocess in two modes (ComputeAnchors,
graph.cc:2505-2576: default tabular output; GetReadProbabilitiesSlow,
graph.cc:2650-2795: ``-sam``).  This module implements both with an
internal seed-chain + banded edit-distance aligner, as a pure function of
(reads, target) — so the built reference binary (with ``blasr_path``
pointed at tools/fake_blasr_bin) and our exact scorer
(scoring/pacbio_exact.py) consume byte-identical alignments, making the
forward-DP band model directly comparable to printf precision.

Alignment model: full-read (glocal) banded edit distance around the best
seed chains per (read, target, strand), emitting M/I/D CIGARs — the only
ops the reference's ParseCigar accepts (graph.cc:3023-3038).  Query names
get a ``/0_<len>`` suffix like BLASR's, which the reference strips at the
last '/' (graph.cc:2952-2958).
"""
from __future__ import annotations

import sys
from typing import List, NamedTuple, Tuple

import numpy as np

from ..align.longread import SEED_K, chain_hits
from ..core import dna

SLACK = 50  # band slack around the chain extent


class ShimRecord(NamedTuple):
    qname: str      # full name incl. /0_len suffix
    flags: int      # 0 or 16
    tstart: int     # 0-based first aligned target base
    cigar: str      # M/I/D run-length string
    tlen: int       # aligned target span
    seq: str        # oriented read string
    edit_dist: int


def banded_glocal_align(target: np.ndarray, read: np.ndarray,
                        t_lo: int, t_hi: int) -> Tuple[int, int, str, int]:
    """Edit-distance alignment, global in the read, free target start/end
    within window [t_lo, t_hi).  Returns (tstart, tend, cigar, edits)."""
    t = target[t_lo:t_hi]
    m = len(read)
    w = len(t)
    D = np.zeros((m + 1, w + 1), dtype=np.int32)
    D[0, :] = 0
    D[:, 0] = np.arange(m + 1)
    j_idx = np.arange(w + 1, dtype=np.int32)
    for i in range(1, m + 1):
        ne = (t != read[i - 1]).astype(np.int32)
        diag = D[i - 1, :-1] + ne
        up = D[i - 1, 1:] + 1
        tmp = np.minimum(diag, up)
        # left-dependency via prefix-min of (cost - j)
        row = np.empty(w + 1, dtype=np.int32)
        row[0] = i
        base = np.concatenate(([i], tmp))
        row = np.minimum.accumulate(base - j_idx) + j_idx
        D[i] = row
    j_end = int(np.argmin(D[m]))
    edits = int(D[m, j_end])
    # traceback
    cigar_ops: List[str] = []
    i, j = m, j_end
    while i > 0:
        if j > 0 and D[i, j] == D[i - 1, j - 1] + \
                (1 if t[j - 1] != read[i - 1] else 0):
            cigar_ops.append("M")
            i -= 1
            j -= 1
        elif D[i, j] == D[i - 1, j] + 1:
            cigar_ops.append("I")
            i -= 1
        else:
            assert j > 0 and D[i, j] == D[i, j - 1] + 1
            cigar_ops.append("D")
            j -= 1
    cigar_ops.reverse()
    # run-length encode
    out = []
    k = 0
    while k < len(cigar_ops):
        k2 = k
        while k2 < len(cigar_ops) and cigar_ops[k2] == cigar_ops[k]:
            k2 += 1
        out.append(f"{k2 - k}{cigar_ops[k]}")
        k = k2
    return t_lo + j, t_lo + j_end, "".join(out), edits


def align_read_to_target(target: np.ndarray, read: np.ndarray,
                         name: str, min_seeds: int = 3) -> List[ShimRecord]:
    """Best chain per strand -> one banded alignment each."""
    from ..align.longread import SortedKmerIndex

    if len(target) < SEED_K or len(read) < SEED_K:
        return []
    idx = SortedKmerIndex(target)
    out: List[ShimRecord] = []
    rc = dna.revcomp(read)
    for strand, q in ((0, read), (1, rc)):
        tpos, qpos = idx.hits(q)
        hits = list(zip(tpos.tolist(), qpos.tolist()))
        chains = chain_hits(hits, min_seeds=min_seeds)
        if not chains:
            continue
        chain = max(chains, key=lambda c: c.n_seeds)
        t_lo = max(0, chain.tstart - chain.qstart - SLACK)
        t_hi = min(len(target),
                   chain.tend + (len(q) - chain.qend) + SLACK)
        tstart, tend, cigar, edits = banded_glocal_align(target, q,
                                                         t_lo, t_hi)
        out.append(ShimRecord(
            qname=f"{name}/0_{len(q)}", flags=16 if strand else 0,
            tstart=tstart, cigar=cigar, tlen=tend - tstart,
            seq=dna.decode_seq(q), edit_dist=edits))
    return out


def sam_lines(reads, target: np.ndarray) -> List[str]:
    """reads: [(name, codes)].  SAM rows as the reference parses them
    (fields 0/1/3/5/8/9 + NM; POS is the 0-based first aligned target
    base — exactly the index AligmentProbability reads at the first trace
    cell, graph.cc:2252)."""
    lines = []
    for name, codes in reads:
        for rec in align_read_to_target(target, codes, name):
            lines.append("\t".join([
                rec.qname, str(rec.flags), "tmp", str(rec.tstart), "254",
                rec.cigar, "*", "0", str(rec.tlen), rec.seq, "*",
                f"NM:i:{rec.edit_dist}"]))
    return lines


def anchor_lines(reads, node_seqs) -> List[str]:
    """Anchors-mode rows: the reference reads columns 0 (qname),
    1 (node id), 6 (tstart), 7 (tend) (graph.cc:2541-2562).
    node_seqs: [(node_id, codes)] — only nodes >= kMinAnchorLen get
    printed by the reference into the temp fasta."""
    lines = []
    for name, codes in reads:
        for node_id, nseq in node_seqs:
            for rec in align_read_to_target(nseq, codes, name):
                lines.append(" ".join([
                    rec.qname, str(node_id), "0", "0", "0", "0",
                    str(rec.tstart), str(rec.tstart + rec.tlen)]))
    return lines


def _read_fastq(path: str):
    out = []
    with open(path) as f:
        while True:
            h = f.readline()
            if not h:
                break
            seq = f.readline().strip()
            f.readline()
            f.readline()
            out.append((h[1:].split()[0], dna.encode_seq(seq)))
    return out


def _read_fasta(path: str):
    out = []
    name = None
    seq: List[str] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None:
                    out.append((name, dna.encode_seq("".join(seq))))
                name = line[1:].split()[0]
                seq = []
            else:
                seq.append(line)
    if name is not None:
        out.append((name, dna.encode_seq("".join(seq))))
    return out


def main(argv=None) -> int:
    """CLI mimicking the reference's blasr invocations: the first two
    positional args are <reads.fastq> <target.fasta>; ``-sam`` selects
    SAM output; everything else is ignored; output goes to stdout (the
    reference shell-redirects it)."""
    argv = argv if argv is not None else sys.argv[1:]
    pos = [a for a in argv if not a.startswith("-")
           and not a.lstrip("-").isdigit()]
    reads_path, target_path = pos[0], pos[1]
    sam = "-sam" in argv
    reads = _read_fastq(reads_path)
    targets = _read_fasta(target_path)
    if sam:
        # scoring mode: single ">tmp" target (the spelled walk)
        _name, target = targets[0]
        sys.stdout.write("@HD\tVN:1.0\n")
        for line in sam_lines(reads, target):
            sys.stdout.write(line + "\n")
    else:
        # anchors mode: one record set per node sequence
        node_seqs = [(int(name), codes) for name, codes in targets]
        for line in anchor_lines(reads, node_seqs):
            sys.stdout.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
