"""PacBio (long-read) likelihood on one device.

Port of gaml_tpu/parallel/pacbio_sharded.py.  Two parts of the PacBio
scorer's per-iteration work run on the device:

- the forward DP of every batch: ProbCalculator.enable_sharded_pacbio
  sets the read set's ``forward_dispatch``, and scoring/pacbio.py::
  _forward_batch then runs every batch on the read set's own K5 engine
  (ops/forward_device.py), with its resident read rows where every job
  has a read id, whatever the batch's cell count, counting the cells
  under "mesh".  The JAX mesh route ran the jnp forward there, not its
  Pallas kernel;
- the per-read log-sum-exp over each read's alignment masses (reference
  AddPositionsToReadProbsPacbio, graph.cc:3052-3060) and the floored
  mean-log reduction (GetTotalProbPacbio, graph.cc:3062-3088), in
  float64: a segment max, exp, a segment sum in the rows' order
  (parallel/device_state.py::fold_segments), then each read's log
  probability floored and the mean less log(2 total_len).

Position collection and the coverage interval sweep stay on the host
(scoring/pacbio_score.py, shared with the host scorer).

Under a process group (parallel/distributed.py) each process runs the
forward jobs of its own reads [lo, hi) only (the read set's
``read_range``, set by ProbCalculator.enable_sharded_pacbio), so K5's
launches are split; it computes their log-sum-exps, the per-read values
are gathered in rank order and every process reduces the full vector.
The coverage sweep needs every read's hits: their spans are gathered
(``distributed.gather_rows``) and each walk swept over all of them, as
one process sweeps (the sweep sorts its events).
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from . import distributed
from .device_state import fold_segments, segment_ranks


class ShardedPacbioScorer:
    """The per-read PacBio reduction on ``device``."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)

    def read_log_probs(self, rid, lp, n_reads: int) -> torch.Tensor:
        """Each read's log probability (float64 [n_reads]) from flat
        (read, logprob) alignment rows: the log of its masses' sum, added
        in the rows' order.  A read with no rows, or only -inf rows, has
        -inf; K5's no-path value (-1e30) stays finite."""
        dev = self.device
        rid_t = torch.from_numpy(np.asarray(rid, dtype=np.int64)).to(dev)
        lp_t = torch.from_numpy(np.asarray(lp, dtype=np.float64)).to(dev)
        m = torch.full((n_reads,), -math.inf, dtype=torch.float64,
                       device=dev).scatter_reduce_(0, rid_t, lp_t, "amax")
        finite = torch.isfinite(m)
        base = torch.where(finite, m, 0.0)
        uniq, seg, rank = segment_ranks(rid_t)
        s = torch.zeros(n_reads, dtype=torch.float64, device=dev)
        s[uniq] = fold_segments(
            torch.zeros(len(uniq), dtype=torch.float64, device=dev),
            torch.exp(lp_t - base[rid_t]), seg, rank)
        return torch.where(finite & (s > 0), base + torch.log(s), -math.inf)

    def reduce(self, read_lp, read_lens, total_len: int,
               min_prob_per_base: float, min_prob_start: float):
        """(score, zero_reads): each read's log probability floored, the
        mean less log(2 total_len) (GetTotalProbPacbio)."""
        n_reads = read_lp.shape[0]
        floors = min_prob_start + min_prob_per_base * torch.tensor(
            np.asarray(read_lens, dtype=np.float64), device=self.device)
        floored = read_lp < floors
        total = torch.where(floored, floors, read_lp).sum()
        tl = max(int(total_len), 1)
        s_, z = torch.stack([total, floored.sum().to(torch.float64)]).tolist()
        return s_ / max(n_reads, 1) - math.log(2 * tl), int(z)

    def score(self, rid, lp, n_reads: int, read_lens, total_len: int,
              min_prob_per_base: float, min_prob_start: float):
        """(score, zero_reads) from flat (read, logprob) alignment rows of
        this process's reads [lo, hi) of ``n_reads`` (distributed.
        read_range; ``rid`` counted from lo): their read_log_probs,
        gathered over the process group, then reduce.  ``read_lens``:
        every read's length."""
        lo, hi = distributed.read_range(n_reads)
        read_lp = distributed.gather_read_values(
            self.read_log_probs(rid, lp, hi - lo), n_reads)
        return self.reduce(read_lp, read_lens, total_len, min_prob_per_base,
                           min_prob_start)


def calc_score_for_pacbio_sharded(graph, paths, read_set,
                                  no_cov_penalty: float = 0.0,
                                  exp_cov_move: float = 0.75,
                                  min_prob_per_base: float = -0.7,
                                  min_prob_start: float = -10.0,
                                  scorer: Optional[ShardedPacbioScorer]
                                  = None, device="cuda"):
    """CalcScoreForPacbio with the per-read reduction on ``device`` (the
    scorer's, when given).  Host: position collection and the coverage
    interval sweep (as calc_score_for_pacbio runs them); device: the
    per-read log-sum-exp and floored mean.  Under a process group the
    read set holds only this process's reads' hits (its read_range): the
    hit spans and per-read values are gathered.  Returns (score,
    zero_reads, total_len), the same on every process."""
    from ..scoring.pacbio_score import hit_spans, interval_sweep, walk_events

    if scorer is None:
        scorer = ShardedPacbioScorer(device)
    n = read_set.get_number_of_reads()
    lo, hi = distributed.read_range(n)
    rows_rid: List[int] = []
    rows_lp: List[float] = []
    spans: List[tuple] = []  # (walk, start, end) of this process's hits
    walks = []
    total_len = 0
    read_set.precompute_ranges_for_paths(graph, paths)
    for w, path in enumerate(paths):
        path, events = walk_events(graph, path)
        positions2, tl = read_set.get_read_probabilities(graph, path)
        for i in range(lo, hi):
            for _span, lp in positions2[i]:
                rows_rid.append(i - lo)
                rows_lp.append(lp)
        spans.extend((w, a, b) for a, b in hit_spans(positions2, read_set))
        walks.append((events, tl))
        total_len += tl
    for w, a, b in distributed.gather_rows(
            np.asarray(spans, dtype=np.int64).reshape(-1, 3)).tolist():
        walks[w][0].extend(((a, 1), (b, a - b)))
    bad_bases = sum(interval_sweep(events, tl, exp_cov_move)
                    for events, tl in walks)

    score, zero_reads = scorer.score(
        np.asarray(rows_rid, dtype=np.int64),
        np.asarray(rows_lp, dtype=np.float64), n,
        np.asarray(read_set.read_lens, dtype=np.float64), total_len,
        min_prob_per_base, min_prob_start)
    return score - bad_bases * no_cov_penalty, zero_reads, total_len
