"""Trivial every-k-mer read index (reference ReadIndexTrivial,
graph.cc:1115-1233) — the alternate to the max-hash index, compiled but not
selected in the reference (graph.h:437-438).  Provided for capability
parity and as a higher-recall option: every 15-mer of every read is
indexed, and genome queries emit candidate positions with the reference's
70 bp proximity dedup."""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..core import dna
from .maxhash import K_INDEX_KMER, pack_kmers


class ReadIndexTrivial:
    def __init__(self):
        self.index: Dict[int, List[int]] = {}
        self.read_len = 0

    def add_read(self, codes: np.ndarray, read_id: int) -> None:
        for v in pack_kmers(codes, K_INDEX_KMER):
            self.index.setdefault(int(v), []).append(read_id)
        self.read_len = len(codes)

    def get_read_cands_with_poses(self, seq_codes: np.ndarray) -> Dict[int, List[int]]:
        """read -> signed k-mer end positions; hits within 70 bp of the
        previous hit for the same read are dropped (graph.cc:1142-1155)."""
        cands: Dict[int, List[int]] = {}
        k = K_INDEX_KMER
        for strand, codes in ((1, seq_codes), (-1, dna.revcomp(seq_codes))):
            for j, v in enumerate(pack_kmers(codes, k)):
                pos = j + k - 1
                for rid in self.index.get(int(v), ()):
                    lst = cands.setdefault(rid, [])
                    if lst and strand * lst[-1] > pos - 70:
                        continue
                    lst.append(strand * pos)
        return cands

    def size_info(self):
        return len(self.index), sum(1 + len(v) for v in self.index.values())
