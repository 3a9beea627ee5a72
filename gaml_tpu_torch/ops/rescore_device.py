"""Single-end device rescore: window bytes in, score out.

Port of gaml_tpu/ops/rescore_device.py:

  candgen (ops.candgen_device, graph.cc:1289-1348)
    -> both directions of the extension in one launch (K1 + K2's
       function, ops.extend_device)
    -> first-wins (window, read, begin) dedup (graph.cc:895-897)
    -> per-read probability sum + GetTotalProb (graph.cc:1482-1537)

The reference keeps the FIRST duplicate in candidate emission order.
Candidates arrive in emission order, grouped in runs of equal (window,
read) by candgen's stable sort.  On a card ``DeviceRescorer.score`` runs
the two hand-written kernels of csrc/rescore.cu (ops.rescore_cuda: the
dedup within each run by begin and the sums in one launch, the floored
reduction of every job and its one read-back in the other); on the CPU
``score_plain``, the same stages as a chain of torch operations (one
stable sort on an int64 (group, begin) key, ops.score.dedup_alignments
with the group in place of the read id, puts each group's earliest
candidate first), the kernels' plain version.  Probabilities, their
per-read sums and the reduction are float64, where the JAX package
computes in float32 (ROADMAP C12; ops.score says why).

``rescore(seg_job=, n_jobs=)`` scores k independent assemblies in one
call (one candgen, one extend_exact launch for every job's windows):
each window segment belongs to a job, the dedup groups are (window,
read) as for one assembly, and the per-read sums are binned by (job,
read) in int64, where the JAX package packs (segment << 20 | read) into
int32 and overflows past 2^11 segments (ROADMAP C2).

Traced (utils.metrics): ``rescore`` (and the counter ``rescore.calls``)
around a rescore, ``extend`` around the extension, ``rescore.sums`` and
``rescore.reduce`` around the stages of ``score`` (``rescore.dedup``
before them on the CPU route; the counters ``rescore.fused`` and
``rescore.kept`` on the card's), and ``sync`` around each point where
the host waits for the card.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..utils.metrics import count, span
from .candgen_device import Candidates, DeviceCandGen, indexed_device
from .extend_device import DeviceExtender
from .rescore_cuda import score_kernel
from .score import alignment_probs, dedup_alignments, reduce_read_probs


def dedup_sums_plain(n_reads: int, lens: torch.Tensor, c: Candidates, ext,
                     log_match: float, log_mismatch: float, seg_job=None,
                     n_jobs: int = 1):
    """First-wins dedup of ``ext`` = (ok, errs, begin) over the candidates
    ``c`` (None: there are none) and the kept alignments' probabilities
    summed per (job, read), as a chain of torch operations: (the kept
    candidates' indices, read_probs float64 [n_jobs * n_reads])."""
    n = n_reads
    dev = lens.device
    idx = torch.zeros(0, dtype=torch.int64, device=dev)
    if ext is not None:
        with span("rescore.dedup"):
            ok, errs, begin = ext
            new_grp = torch.ones_like(ok)
            new_grp[1:] = (c.seg[1:] != c.seg[:-1]) | \
                (c.rid[1:] != c.rid[:-1])
            grp = torch.cumsum(new_grp.to(torch.int64), 0)
            order, keep = dedup_alignments(grp, begin, ok)
            with span("sync"):  # the mask's count
                idx = order[keep]
            rid = c.rid[idx]
            bins = rid
            if seg_job is not None:
                job = np.zeros(len(c.seg_len), np.int64)
                job[:len(seg_job)] = np.asarray(seg_job)[:len(job)]
                bins = torch.as_tensor(job, device=dev)[c.seg[idx]] * n + rid
    with span("rescore.sums"):
        read_probs = torch.zeros(n_jobs * n, dtype=torch.float64, device=dev)
        if ext is not None:
            read_probs.index_add_(0, bins, alignment_probs(
                errs[idx], lens[rid], log_match, log_mismatch))
    return idx, read_probs


def score_plain(n_reads: int, lens: torch.Tensor, c: Candidates, ext,
                log_match: float, log_mismatch: float, total_len,
                min_prob_per_base: float, min_prob_start: float,
                seg_job=None, n_jobs: int = 1):
    """DeviceRescorer.score as a chain of torch operations (the CPU route
    and the kernels' yardstick): dedup_sums_plain, then GetTotalProb of
    each job.  Returns (score, zero_reads, n_total) as ``score``."""
    n = n_reads
    _idx, read_probs = dedup_sums_plain(n, lens, c, ext, log_match,
                                        log_mismatch, seg_job, n_jobs)
    with span("rescore.reduce"):
        if seg_job is None:
            score, zeros, _ = reduce_read_probs(
                read_probs, lens, total_len, min_prob_per_base,
                min_prob_start)
            with span("sync"):
                return float(score), int(zeros), c.n_total
        tl = np.asarray(total_len, dtype=np.int64).reshape(-1)
        per_job = [reduce_read_probs(read_probs[j * n:(j + 1) * n], lens,
                                     int(tl[j]), min_prob_per_base,
                                     min_prob_start)[:2]
                   for j in range(n_jobs)]
        stacked = torch.stack([torch.stack([s, z.to(torch.float64)])
                               for s, z in per_job])
        with span("sync"):
            out = stacked.cpu().numpy()
    return out[:, 0].copy(), out[:, 1].astype(np.int64), c.n_total


class DeviceRescorer:
    """Rescore engine for one read set: the resident candgen index
    (DeviceCandGen) plus the resident read codes (DeviceExtender), both
    built from the same NativeAlignBundle as gaml_tpu's engines, or both
    given (``gen`` and ``ext``, e.g. a max-hash index's generator over a
    ragged read matrix; ``read_lens_all`` then gives every read's
    length)."""

    def __init__(self, bundle=None, read_lens_all: np.ndarray = None,
                 ext: DeviceExtender = None, device="cuda",
                 gen: DeviceCandGen = None):
        self.device = indexed_device(device)
        self.gen = gen if gen is not None else DeviceCandGen(bundle,
                                                             self.device)
        self.ext = ext if ext is not None else DeviceExtender(
            bundle.codes_fwd, bundle.codes_rc, self.device)
        self.read_len = self.gen.read_len
        self.n_reads = int(self.gen.row_of.shape[0])
        if read_lens_all is None:
            read_lens_all = np.full(self.n_reads, self.read_len, np.int32)
        self.lens = torch.as_tensor(
            np.asarray(read_lens_all, dtype=np.int32), device=self.device)

    def _extend(self, c: Candidates):
        with span("extend"):
            return self.ext.extend(c.codes, c.seg_base[c.seg],
                                   c.seg_len[c.seg], c.g0, c.r0,
                                   self.gen.row_of[c.rid], c.orient)

    def stage(self, seqs: List[np.ndarray]):
        """Upload a window batch (DeviceCandGen.upload) for a later
        ``rescore(staged=...)``."""
        return self.gen.upload(seqs)

    def rescore(self, seqs: List[np.ndarray] = None,
                cap: Optional[int] = None, log_match: float = 0.0,
                log_mismatch: float = 0.0, total_len=1,
                min_prob_per_base: float = 0.0, min_prob_start: float = 0.0,
                staged=None, seg_job=None, n_jobs: int = 1):
        """Returns (score, zero_reads, n_total) of the windows ``seqs``
        (or of ``staged``, a ``stage`` result).  The result is valid only
        when n_total <= cap (None: unbounded); otherwise score and
        zero_reads are None and the caller retries with cap >= n_total.

        ``seg_job`` + ``n_jobs``: k independent assemblies in this one
        call: seg_job maps each window segment to its job (segments past
        its end are job 0), ``total_len`` is then a [n_jobs] sequence and
        score / zero_reads come back as [n_jobs] numpy arrays."""
        with span("rescore"):
            count("rescore.calls")
            c = self.gen.query(seqs, cap, staged=staged)
            if c.overflow:
                return None, None, c.n_total
            ext = self._extend(c) if c.n_total else None
            return self.score(c, ext, log_match, log_mismatch, total_len,
                              min_prob_per_base, min_prob_start, seg_job,
                              n_jobs)

    def score(self, c: Candidates, ext, log_match: float,
              log_mismatch: float, total_len, min_prob_per_base: float,
              min_prob_start: float, seg_job=None, n_jobs: int = 1):
        """The stages after the extension: first-wins dedup of ``ext`` =
        (ok, errs, begin) over the candidates ``c`` (None when there are
        none), the per-read probability sums of each job (float64, binned
        by (job, read)) and GetTotalProb of each.  Returns (score,
        zero_reads, n_total), per job as in ``rescore``.  On a card the
        kernels (ops.rescore_cuda.score_kernel), on the CPU
        ``score_plain``."""
        if self.device.type == "cpu":
            return score_plain(self.n_reads, self.lens, c, ext, log_match,
                               log_mismatch, total_len, min_prob_per_base,
                               min_prob_start, seg_job, n_jobs)
        scores, zeros, _kept = score_kernel(
            self, c, ext, log_match, log_mismatch, total_len,
            min_prob_per_base, min_prob_start, seg_job, n_jobs)
        if seg_job is None:
            return float(scores[0]), int(zeros[0]), c.n_total
        return scores, zeros, c.n_total

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
            with span("sync"):
                return tuple(t.cpu().numpy() for t in out), c.n_total

        return fetch
