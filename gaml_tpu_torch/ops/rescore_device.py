"""Single-end device rescore: window bytes in, score out.

Port of gaml_tpu/ops/rescore_device.py:

  candgen (ops.candgen_device, graph.cc:1289-1348)
    -> both directions of the extension in one launch (K1 + K2's
       function, ops.extend_device)
    -> first-wins (window, read, begin) dedup (graph.cc:895-897)
    -> per-read probability sum + GetTotalProb (graph.cc:1482-1537)

The reference keeps the FIRST duplicate in candidate emission order.
Candidates arrive in emission order, grouped by (window, read), so one
stable sort on an int64 (group, begin) key (ops.score.dedup_alignments
with the group in place of the read id) puts each group's earliest
candidate first.  Probabilities, their per-read sums and the reduction
are float64, where the JAX package computes in float32 (ROADMAP C12;
ops.score says why).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .candgen_device import Candidates, DeviceCandGen
from .extend_device import DeviceExtender
from .score import alignment_probs, dedup_alignments, reduce_read_probs


class DeviceRescorer:
    """Rescore engine for one read set: the resident candgen index
    (DeviceCandGen) plus the resident read codes (DeviceExtender), both
    built from the same NativeAlignBundle as gaml_tpu's engines."""

    def __init__(self, bundle, read_lens_all: np.ndarray = None,
                 ext: DeviceExtender = None, device="cuda"):
        self.device = torch.device(device)
        self.gen = DeviceCandGen(bundle, self.device)
        self.ext = ext if ext is not None else DeviceExtender(
            bundle.codes_fwd, bundle.codes_rc, self.device)
        self.read_len = int(bundle.read_len)
        self.n_reads = int(len(bundle.row_of))
        if read_lens_all is None:
            read_lens_all = np.full(self.n_reads, self.read_len, np.int32)
        self.lens = torch.as_tensor(
            np.asarray(read_lens_all, dtype=np.int32), device=self.device)

    def _extend(self, c: Candidates):
        return self.ext.extend(c.codes, c.seg_base[c.seg], c.seg_len[c.seg],
                               c.g0, c.r0, self.gen.row_of[c.rid], c.orient)

    def rescore(self, seqs: List[np.ndarray], cap: int,
                log_match: float = 0.0, log_mismatch: float = 0.0,
                total_len: int = 1, min_prob_per_base: float = 0.0,
                min_prob_start: float = 0.0):
        """Returns (score, zero_reads, n_total).  The result is valid only
        when n_total <= cap; otherwise score and zero_reads are None and
        the caller retries with cap >= n_total."""
        c = self.gen.query(seqs, cap)
        if c.overflow:
            return None, None, c.n_total
        ext = self._extend(c) if c.n_total else None
        return self.score(c, ext, log_match, log_mismatch, total_len,
                          min_prob_per_base, min_prob_start)

    def score(self, c: Candidates, ext, log_match: float,
              log_mismatch: float, total_len: int, min_prob_per_base: float,
              min_prob_start: float):
        """The stages after the extension: first-wins dedup of ``ext`` =
        (ok, errs, begin) over the candidates ``c`` (None when there are
        none), the per-read probability sum and GetTotalProb.  Returns
        (score, zero_reads, n_total)."""
        read_probs = torch.zeros(self.n_reads, dtype=torch.float64,
                                 device=self.device)
        if ext is not None:
            ok, errs, begin = ext
            new_grp = torch.ones_like(ok)
            new_grp[1:] = (c.seg[1:] != c.seg[:-1]) | \
                (c.rid[1:] != c.rid[:-1])
            grp = torch.cumsum(new_grp.to(torch.int64), 0)
            order, keep = dedup_alignments(grp, begin, ok)
            idx = order[keep]
            rid = c.rid[idx]
            read_probs.index_add_(0, rid, alignment_probs(
                errs[idx], self.lens[rid], log_match, log_mismatch))
        score, zeros, _ = reduce_read_probs(read_probs, self.lens, total_len,
                                            min_prob_per_base,
                                            min_prob_start)
        return float(score), int(zeros), c.n_total

    def extend(self, seqs: List[np.ndarray], cap: int):
        """Candgen + extension for a window batch, kernels queued; returns
        a zero-arg closure giving ((ok, errs, begin, rid, orient, seg) numpy
        [n] in the native query's emission order, n) — or (None, n) when
        n exceeds cap."""
        c = self.gen.query(seqs, cap)
        if c.overflow:
            return lambda: (None, c.n_total)
        out = self._extend(c) + (c.rid, c.orient, c.seg)

        def fetch():
            return tuple(t.cpu().numpy() for t in out), c.n_total

        return fetch
