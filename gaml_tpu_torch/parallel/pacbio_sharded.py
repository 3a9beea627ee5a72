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
(scoring/pacbio_score.py::sweep_walk, shared with the host scorer).
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from .device_state import fold_segments, segment_ranks


class ShardedPacbioScorer:
    """The per-read PacBio reduction on ``device``."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)

    def score(self, rid, lp, n_reads: int, read_lens, total_len: int,
              min_prob_per_base: float, min_prob_start: float):
        """(score, zero_reads) from flat (read, logprob) alignment rows.
        A read with no rows, or only -inf rows, has log probability -inf
        and floors; K5's no-path value (-1e30) stays finite."""
        dev = self.device
        rid = np.asarray(rid, dtype=np.int64)
        rid_t = torch.from_numpy(rid).to(dev)
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
        read_lp = torch.where(finite & (s > 0), base + torch.log(s),
                              -math.inf)
        floors = min_prob_start + min_prob_per_base * torch.tensor(
            np.asarray(read_lens, dtype=np.float64), device=dev)
        floored = read_lp < floors
        total = torch.where(floored, floors, read_lp).sum()
        tl = max(int(total_len), 1)
        s_, z = torch.stack([total, floored.sum().to(torch.float64)]).tolist()
        return s_ / max(n_reads, 1) - math.log(2 * tl), int(z)


def calc_score_for_pacbio_sharded(graph, paths, read_set,
                                  no_cov_penalty: float = 0.0,
                                  exp_cov_move: float = 0.75,
                                  min_prob_per_base: float = -0.7,
                                  min_prob_start: float = -10.0,
                                  scorer: Optional[ShardedPacbioScorer]
                                  = None, device="cuda"):
    """CalcScoreForPacbio with the per-read reduction on ``device`` (the
    scorer's, when given).  Host: position collection and the coverage
    interval sweep (scoring.pacbio_score.sweep_walk, as
    calc_score_for_pacbio runs them); device: the per-read log-sum-exp
    and floored mean.  Returns (score, zero_reads, total_len)."""
    from ..scoring.pacbio_score import sweep_walk

    if scorer is None:
        scorer = ShardedPacbioScorer(device)
    rows_rid: List[int] = []
    rows_lp: List[float] = []
    total_len = 0
    bad_bases = 0
    read_set.precompute_ranges_for_paths(graph, paths)
    for path in paths:
        positions2, tl, bad = sweep_walk(graph, path, read_set,
                                         exp_cov_move)
        for i in range(len(positions2)):
            for _span, lp in positions2[i]:
                rows_rid.append(i)
                rows_lp.append(lp)
        total_len += tl
        bad_bases += bad

    score, zero_reads = scorer.score(
        np.asarray(rows_rid, dtype=np.int64),
        np.asarray(rows_lp, dtype=np.float64),
        read_set.get_number_of_reads(),
        np.asarray(read_set.read_lens, dtype=np.float64), total_len,
        min_prob_per_base, min_prob_start)
    return score - bad_bases * no_cov_penalty, zero_reads, total_len
