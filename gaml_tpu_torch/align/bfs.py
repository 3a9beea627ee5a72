"""Host oracle for the short-read seed-and-extend kernel.

Replicates the reference's ``ProcessHit`` (graph.cc:753-837): a 0-1 BFS over
(genome_pos, read_pos) states extending a verified 15-mer seed forward to the
read end and backward to the read start, with an error cap of 3.

Semantics worth naming (the Pallas kernel must agree; see ops/extend.py):

- On a *matching* character only the diagonal move exists (cost 0); indel
  alternatives are never explored from a matching state.  This makes the
  state graph a restricted alignment graph, not full edit distance.
- On a mismatch three cost-1 moves are tried in order: substitution
  (g+1, r+1), genome-skip (g+1, r), read-skip (g, r+1) — the deque order
  makes this a lexicographic tie-break (sub > gskip > rskip at the earliest
  divergence) among minimum-cost alignments.
- Genome boundary: a match at the last genome char is only taken if it
  completes the read (graph.cc:778); genome-advancing mismatch moves require
  staying inside the genome.
- If the seed starts at genome position 0, the backward phase is skipped:
  the hit is accepted iff read_pos < 6, with read_pos counted as errors and
  begin_pos left at -1 (so the reported position becomes the window offset,
  graph.cc:797-798 with graph.cc:890).

Returns (total_errors, begin_pos, end_pos) or None.
"""
from __future__ import annotations

from collections import deque
from typing import Optional, Tuple

import numpy as np

ERROR_LIMIT = 3
K = 15  # seed length (kIndexKmer)


def _char(genome: np.ndarray, g: int) -> int:
    # g == len(genome) reads the C++ string's terminating NUL — never equal
    # to any base; model it with a sentinel.
    if 0 <= g < len(genome):
        return int(genome[g])
    return -1


def process_hit(genome_pos: int, read_pos: int, read: np.ndarray,
                genome: np.ndarray) -> Optional[Tuple[int, int, int]]:
    rlen = len(read)
    glen = len(genome)
    assert np.array_equal(read[read_pos:read_pos + K],
                          genome[genome_pos:genome_pos + K]), "seed mismatch"

    # ---------------------------------------------------------------- forward
    fr: deque = deque()
    visited = set()
    fr.append((0, genome_pos + K, read_pos + K))
    forward_errs = -1
    end_pos = -1
    while fr:
        cost, g, r = fr.popleft()
        if cost > ERROR_LIMIT:
            break
        if r == rlen:
            forward_errs = cost
            end_pos = g - 1
            break
        if _char(genome, g) == int(read[r]):
            if g + 1 < glen or r + 1 == rlen:
                key = (r + 1, g + 1)
                if key not in visited:
                    visited.add(key)
                    fr.appendleft((cost, g + 1, r + 1))
        else:
            if g + 1 < glen:
                for ng, nr in ((g + 1, r + 1), (g + 1, r)):
                    key = (nr, ng)
                    if key not in visited:
                        visited.add(key)
                        fr.append((cost + 1, ng, nr))
            key = (r + 1, g)
            if key not in visited:
                visited.add(key)
                fr.append((cost + 1, g, r + 1))
    if forward_errs == -1:
        return None

    # --------------------------------------------------------------- backward
    backward_errs = -1
    begin_pos = -1
    if genome_pos == 0:
        if read_pos < 6:
            backward_errs = read_pos
    else:
        fr = deque()
        visited = set()
        fr.append((0, genome_pos - 1, read_pos - 1))
        while fr:
            cost, g, r = fr.popleft()
            if cost > ERROR_LIMIT:
                break
            if r == -1:
                backward_errs = cost
                begin_pos = g + 1
                break
            if _char(genome, g) == int(read[r]):
                if g - 1 >= 0 or r - 1 == -1:
                    key = (r - 1, g - 1)
                    if key not in visited:
                        visited.add(key)
                        fr.appendleft((cost, g - 1, r - 1))
            else:
                if g - 1 >= 0:
                    for ng, nr in ((g - 1, r - 1), (g - 1, r)):
                        key = (nr, ng)
                        if key not in visited:
                            visited.add(key)
                            fr.append((cost + 1, ng, nr))
                key = (r - 1, g)
                if key not in visited:
                    visited.add(key)
                    fr.append((cost + 1, g, r - 1))
    if backward_errs == -1:
        return None
    return backward_errs + forward_errs, begin_pos, end_pos
