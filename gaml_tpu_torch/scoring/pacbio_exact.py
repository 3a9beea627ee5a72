"""Exact port of the reference's CIGAR-banded forward probability.

The production long-read scorer (scoring/pacbio.py) builds bands from
internal seed chains; the reference builds them from a BLASR CIGAR
(AligmentProbability, graph.cc:2175-2297, band helpers graph.cc:2129-2173)
and parses BLASR SAM with soft-clip fixups (ParseAligment,
graph.cc:2945-3021).  This module ports those routines EXACTLY — same
band cells in the same iteration order, same logdouble arithmetic
(logdouble.hpp:13-78 via core.logprob.logadd), same quirks — so that,
driven by the same alignments (tools/fake_blasr emitting SAM consumed by
both the built reference binary and this code), the scores match to
printf precision.  tests/test_reference_differential.py pins this.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np

from ..core.logprob import NEG_INF, logadd

CONTIG_SEPARATOR = "\n"  # reference kContigSeparator (graph.cc:30)


class PacbioAlignmentData(NamedTuple):
    """Reference PacbioAligmentData (graph.h:491-505)."""
    name: str
    flags: int
    tstart: int       # raw SAM pos (target-forward coords)
    tend: int
    posstart: int     # strand-flipped into seqall coords
    posend: int
    sstart: int
    send: int
    slen: int
    length: int
    cigar: List[Tuple[int, str]]
    edit_dist: int


def parse_cigar(cigar: str) -> List[Tuple[int, str]]:
    """Reference ParseCigar (graph.cc:3023-3038): M/I/D only."""
    out: List[Tuple[int, str]] = []
    start = 0
    for i, c in enumerate(cigar):
        if not c.isdigit():
            if c in "MID":
                out.append((int(cigar[start:i]), c))
            start = i + 1
    return out


def parse_alignment_line(line: str, total_len: int,
                         do_reverse: bool = True) -> PacbioAlignmentData:
    """Reference ParseAligment (graph.cc:2945-3021): SAM fields, the
    last-'/'-strip of the query name, the reverse-strand coordinate flip
    over the doubled target, and the XS/XE/XQ soft-clip I-padding."""
    parts = line.rstrip("\n").split("\t")
    lastsep = 0
    for i, c in enumerate(parts[0]):
        if c == "/":
            lastsep = i
    name = parts[0][:lastsep]
    posstart = int(parts[3])
    flags = int(parts[1])
    length = int(parts[8])
    posend = posstart + length
    sstart = 0
    send = len(parts[9])
    slen = len(parts[9])
    edit_dist = 100000
    for fld in parts[11:]:
        if fld.startswith("XS"):
            sstart = int(fld[5:]) - 1
        elif fld.startswith("XE"):
            send = int(fld[5:]) - 1
        elif fld.startswith("XQ"):
            slen = int(fld[5:])
        elif fld.startswith("NM"):
            edit_dist = int(fld[5:])

    tstart = posstart
    tend = posend
    cigar = parse_cigar(parts[5])
    if (flags & 16) and do_reverse:
        ln = posend - posstart
        posstart = total_len - posend
        posend = posstart + ln
        cigar = cigar[::-1]
    if send != slen:
        cigar.append((slen - send, "I"))
    if sstart != 0:
        match = min(sstart, posstart)
        left = sstart - match
        cigar.insert(0, (match, "I"))
        if left:
            cigar.insert(0, (left, "I"))
    return PacbioAlignmentData(name, flags, tstart, tend, posstart, posend,
                               sstart, send, slen, length, cigar, edit_dist)


def expand_cigar(cigar: List[Tuple[int, str]]) -> str:
    """Reference ExpandCigar (graph.cc:2129-2137)."""
    return "".join(c * n for n, c in cigar)


def get_cigar_ends(cigar: str) -> Tuple[int, int]:
    """Reference GetCigarEnds (graph.cc:2139-2151)."""
    bl = el = 0
    for i, c in enumerate(cigar):
        if c != "I":
            bl = i
            break
    for i in range(len(cigar) - 1, -1, -1):
        if cigar[i] != "I":
            el = len(cigar) - i
            break
    return bl, el


def uniquify(positions: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Reference Uniquify (graph.cc:2153-2173): per-row [min, max] spans,
    rows ascending, columns ascending."""
    if not positions:
        return positions
    mi = min(p[0] for p in positions)
    ma = max(p[0] for p in positions)
    spans = [(1000000, -1000000)] * (ma - mi + 1)
    for r, c in positions:
        lo, hi = spans[r - mi]
        spans[r - mi] = (min(c, lo), max(c, hi))
    out: List[Tuple[int, int]] = []
    for i in range(mi, ma + 1):
        lo, hi = spans[i - mi]
        for j in range(lo, hi + 1):
            out.append((i, j))
    return out


def band_cells(cigar_str: str, band: int) -> List[Tuple[int, int]]:
    """The reference's band construction (graph.cc:2178-2221): CIGAR trace
    cells, begin/end slack blocks (<=200), +-band dilation, row-span
    filling."""
    bl, el = get_cigar_ends(cigar_str)
    bl = min(bl, 200)
    el = min(el, 200)
    positions: List[Tuple[int, int]] = [(0, 0)]
    for i in range(-bl, 3):
        for j in range(0, bl):
            positions.append((i, j))
    currow = curcol = 0
    for c in cigar_str:
        if c == "M":
            currow += 1
            curcol += 1
        elif c == "I":
            curcol += 1
        elif c == "D":
            currow += 1
        positions.append((currow, curcol))
    for i in range(currow, currow + el):
        for j in range(curcol - el, curcol + 1):
            positions.append((i, j))
    positions = uniquify(positions)
    add = []
    for r, c in positions:
        for i in range(-band, band + 1):
            for j in range(-band, band + 1):
                add.append((r + i, c + j))
    positions.extend(add)
    return uniquify(positions)


def aligment_probability(s1: str, s2: str, align: PacbioAlignmentData,
                         log_match: float, log_mismatch: float,
                         band: int = 2) -> float:
    """Reference AligmentProbability (graph.cc:2175-2297), float64 logs.

    s1: the doubled target (seq + separator + revcomp); s2: the forward
    read as stored.  Returns the log of the accumulated mass reaching the
    read end anywhere in the band.  MatchProbability semantics preserved:
    separator chars have probability 0; 'N' == 'N' counts as a match."""
    cigar = expand_cigar(align.cigar)
    positions = band_cells(cigar, band)

    offset = positions[0][0]
    n_rows = positions[-1][0] - offset + 1
    row_offsets = [positions[-1][1] + 1000000] * n_rows
    for r, c in positions:
        row_offsets[r - offset] = min(row_offsets[r - offset], c)
    sizes = [0] * n_rows
    for r, c in positions:
        sizes[r - offset] = max(sizes[r - offset],
                                c - row_offsets[r - offset] + 1)
    results = [np.full(s, NEG_INF) for s in sizes]

    def match_prob(c1: str, c2: str) -> float:
        if c1 == CONTIG_SEPARATOR or c2 == CONTIG_SEPARATOR:
            return NEG_INF
        return log_match if c1 == c2 else log_mismatch

    for r, c in positions:
        if c == 0:
            results[r - offset][0 - row_offsets[r - offset]] = 0.0

    ret = NEG_INF
    len1 = len(s1)
    len2 = len(s2)
    posstart = align.posstart
    for r, c in positions:
        if c == 0:
            continue
        if c - 1 < 0 or c - 1 >= len2:
            continue
        if r + posstart - 1 < 0 or r + posstart - 1 >= len1:
            continue
        ri = r - offset
        ci = c - row_offsets[ri]
        cell = results[ri][ci]
        # diagonal (match/mismatch)
        r2, c2 = r - 1, c - 1
        if r2 - offset >= 0 and r2 - offset < n_rows:
            c2i = c2 - row_offsets[r2 - offset]
            if 0 <= c2i < sizes[r2 - offset]:
                p = match_prob(s1[r + posstart - 1], s2[c - 1])
                cell = logadd(cell, results[r2 - offset][c2i] + p)
        # up (target gap / deletion in read)
        r2, c2 = r - 1, c
        if r2 - offset >= 0 and r2 - offset < n_rows:
            c2i = c2 - row_offsets[r2 - offset]
            if 0 <= c2i < sizes[r2 - offset]:
                p = match_prob(s1[r + posstart - 1], "-")
                cell = logadd(cell, results[r2 - offset][c2i] + p)
        # left (read gap / insertion)
        r2, c2 = r, c - 1
        if r2 - offset >= 0 and r2 - offset < n_rows:
            c2i = c2 - row_offsets[r2 - offset]
            if 0 <= c2i < sizes[r2 - offset]:
                p = match_prob("-", s2[c - 1])
                cell = logadd(cell, results[r2 - offset][c2i] + p)
        results[ri][ci] = cell
        assert not np.isnan(cell), (r, c)
        if c == len2:
            ret = logadd(ret, cell)
    return float(ret)
