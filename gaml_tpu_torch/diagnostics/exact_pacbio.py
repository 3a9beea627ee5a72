"""PacbioReadSet variant scoring with the reference's exact band model.

Production long-read scoring builds bands from internal seed chains
(scoring/pacbio.py); this variant drives the EXACT reference pipeline:
fake-blasr alignments (diagnostics/fake_blasr.py — the same function the
``blasr`` shim binary runs for the built reference binary) fed through the
exact ParseAligment/AligmentProbability ports (scoring/pacbio_exact.py).
All window/caching machinery (reference graph.cc:2299-2795 semantics) is
inherited from the production class, so a differential test against the
reference binary pins both the band DP and the cache assembly.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from ..core import dna
from ..scoring.pacbio import K_MIN_ANCHOR_LEN, PacbioReadSet
from ..scoring.pacbio_exact import (
    aligment_probability,
    parse_alignment_line,
)
from .fake_blasr import anchor_lines, sam_lines


class ExactPacbioReadSet(PacbioReadSet):
    """Scores with fake-blasr alignments + the reference CIGAR-band DP."""

    # ------------------------------------------------------------ anchors
    def compute_anchors(self, graph, persist: bool = False) -> None:
        """Reference ComputeAnchors (graph.cc:2505-2576) consuming the
        shim's tabular output."""
        if self.anchors_cache:
            return
        node_seqs = [(i, graph.seqs[i]) for i in range(graph.num_nodes)
                     if graph.node_len(i) >= K_MIN_ANCHOR_LEN]
        reads = [(self.get_read_name(rid), self.read_seq[rid])
                 for rid in range(self.reads_num)]
        node_len = {i: graph.node_len(i) for i, _ in node_seqs}
        for line in anchor_lines(reads, node_seqs):
            parts = line.split(" ")
            lastsep = 0
            for i, c in enumerate(parts[0]):
                if c == "/":
                    lastsep = i
            name = parts[0][:lastsep]
            node_id = int(parts[1])
            start = int(parts[6])
            end = int(parts[7])
            rid = self.get_read_id(name)
            self.anchors_cache.setdefault(node_id, set()).add(rid)
            if start <= 10:
                self.anchors_begin.setdefault(node_id, set()).add(rid)
            if end >= node_len[node_id] - 10:
                self.anchors_end.setdefault(node_id, set()).add(rid)
        for node_id, rids in self.anchors_begin.items():
            for rid in rids:
                self.anchors_reverse.setdefault(rid, set()).add(node_id)

    # --------------------------------------------------------- slow path
    def _chain_jobs(self, graph, prep):
        """Reference GetReadProbabilitiesSlow's aligner half
        (graph.cc:2650-2795) with the shim as the aligner; the windows are
        reserved as in the production class."""
        seq = self._spell(graph, prep["path"])

        # the doubled target (graph.cc:2686-2688)
        seq_str = dna.decode_seq(seq)
        seqall = seq_str + "\n" + dna.revcomp_str(seq_str)
        total_all = len(seqall)

        reads = [(self.get_read_name(rid), self.read_seq[rid])
                 for rid in self._read_filter(prep["path"])]
        jobs = []
        meta = []
        for line in sam_lines(reads, seq):
            align = parse_alignment_line(line, total_all)
            rid = self.read_map[align.name]
            read_str = dna.decode_seq(self.read_seq[rid])
            jobs.append((seqall, read_str, align))
            pseudo = SimpleNamespace(tstart=align.tstart, qstart=0,
                                     tend=align.tstart + align.length,
                                     qend=self.read_lens[rid])
            meta.append((rid, pseudo))
        prep.update(seq=seq, jobs=jobs, meta=meta)
        return prep

    def _forward_batch(self, seq, jobs, extents=None):
        log_m = float(np.log(self.match_prob))
        log_mm = float(np.log(self.mismatch_prob))
        return [aligment_probability(s1, s2, align, log_m, log_mm)
                for (s1, s2, align) in jobs]

    def _run_preps(self, preps) -> None:
        """Sequential per-prep slow fills (the production multi-range
        device batching doesn't apply to the exact host DP — its job
        tuples carry full CIGAR alignments, not concatenable extents)."""
        for prep in preps:
            self._slow_apply(prep, self._forward_batch(prep["seq"],
                                                       prep["jobs"]))
