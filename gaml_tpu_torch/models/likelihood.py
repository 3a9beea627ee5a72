"""Device likelihood models (port of gaml_tpu/models/likelihood.py).

Two model families mirror the reference's short-read set kinds:

- SingleEndModel: candidates -> two-direction extension (one exact
  dp_rows_exact launch, K4) -> dedup -> floored mean-log score
  (reference CalcScoreForPaths single, graph.cc:1650-1743);
- PairedEndModel: dense per-read position lists -> innie pair products
  with the insert-size Gaussian -> floored mean-log score (reference
  graph.cc:1991-2127).

They are ``nn.Module``s without parameters: the probabilities and floors
are plain attributes and ``device`` is where ``forward`` expects its
tensors and where the host conveniences (``score_candidates``,
``score_positions``, the JAX signatures) stage them.
"""
from __future__ import annotations

import logging

import numpy as np
import torch
from torch import nn

from ..ops.extend import stage_candidates
from ..ops.pair import paired_score_device, stage_positions_dense
from ..ops.score import single_end_forward


class LikelihoodModel(nn.Module):
    """Shared config for the device likelihood models."""

    def __init__(self, match_prob: float = 0.96, mismatch_prob: float = 0.01,
                 min_prob_per_base: float = -0.7,
                 min_prob_start: float = -10.0, device="cuda"):
        super().__init__()
        self.match_prob = match_prob
        self.mismatch_prob = mismatch_prob
        self.min_prob_per_base = min_prob_per_base
        self.min_prob_start = min_prob_start
        self.device = torch.device(device)

    @property
    def log_match(self) -> float:
        return float(np.log(self.match_prob))

    @property
    def log_mismatch(self) -> float:
        return float(np.log(self.mismatch_prob))

    def _t(self, x, dtype=torch.int32):
        return torch.as_tensor(np.asarray(x), device=self.device).to(dtype)


class SingleEndModel(LikelihoodModel):
    def forward(self, st, read_lens_all, total_len: int, n_reads: int):
        """Score of one staged candidate batch (a stage_candidates dict on
        this model's device); read_lens_all: int32 [n_reads].  Returns
        0-dim (score, zero_reads) and read_probs [n_reads]."""
        return single_end_forward(
            st["read_f"], st["rlen_f"], st["gwin_f"], st["glen_f"],
            st["read_b"], st["rlen_b"], st["gwin_b"], st["glen_b"],
            st["g0"], st["r0"], st["valid"], st["read_id"], st["read_len"],
            st["at_start"], read_lens_all, self.log_match,
            self.log_mismatch, total_len, self.min_prob_per_base,
            self.min_prob_start, rmax=st["rmax"], n_reads=n_reads)

    def score_candidates(self, seq, cands, n_reads: int, read_lens,
                         total_len: int):
        """Host convenience: stage [(Candidate, oriented_read)] against
        the window ``seq`` and run the forward step.  Returns (score,
        zero_reads, read_probs numpy)."""
        st = stage_candidates(
            seq, [c.genome_pos for c, _ in cands],
            [c.read_pos for c, _ in cands], [r for _, r in cands],
            read_ids=[c.read_id for c, _ in cands], device=self.device)
        score, zeros, probs = self(st, self._t(read_lens), total_len,
                                   n_reads)
        return float(score), int(zeros), probs.cpu().numpy()


class PairedEndModel(LikelihoodModel):
    def __init__(self, insert_mean: float, insert_std: float, **kw):
        super().__init__(**kw)
        self.insert_mean = insert_mean
        self.insert_std = insert_std

    def forward(self, pos1, ed1, or1, len1, pos2, ed2, or2, len2,
                total_len: int):
        """Pair products of dense int32 position arrays [R, K] (pos -1 =
        none) and mate lengths [R], reduced to the score.  Returns 0-dim
        (score, zero_reads) and read_probs [R]."""
        return paired_score_device(
            pos1, ed1, or1, len1, pos2, ed2, or2, len2, self.log_match,
            self.log_mismatch, float(self.insert_mean),
            float(self.insert_std), total_len, self.min_prob_per_base,
            self.min_prob_start)

    def score_positions(self, positions1, positions2, n_reads: int,
                        len1, len2, total_len: int, k_cap: int = None):
        """Dense-stage two mates' position lists (the ReadSet positions
        structure) and run the pair product.  Returns (score, zero_reads,
        read_probs numpy).  k_cap defaults to the true maximum per-read
        position count: no silent truncation."""
        if k_cap is None:
            k_cap = max([len(p) for p in positions1]
                        + [len(p) for p in positions2] + [1])
        p1, e1, o1, d1 = stage_positions_dense(positions1, n_reads, k_cap)
        p2, e2, o2, d2 = stage_positions_dense(positions2, n_reads, k_cap)
        if d1 or d2:
            logging.getLogger(__name__).warning(
                "PairedEndModel k_cap=%d dropped %d positions", k_cap,
                d1 + d2)
        score, zeros, probs = self(
            self._t(p1), self._t(e1), self._t(o1), self._t(len1),
            self._t(p2), self._t(e2), self._t(o2), self._t(len2),
            total_len)
        return float(score), int(zeros), probs.cpu().numpy()


_FLOATS = ("match_prob", "mismatch_prob", "min_prob_per_base",
           "min_prob_start")


def from_params(kind: str, params: dict, device="cuda") -> LikelihoodModel:
    """A model from plain numbers, such as the configuration a JAX
    package model carries: ``kind`` is "single", "paired" or "base";
    ``params`` holds match_prob, mismatch_prob, min_prob_per_base and
    min_prob_start, and for "paired" also insert_mean and insert_std."""
    kw = {k: float(params[k]) for k in _FLOATS}
    if kind == "paired":
        return PairedEndModel(float(params["insert_mean"]),
                              float(params["insert_std"]), device=device,
                              **kw)
    if kind == "single":
        return SingleEndModel(device=device, **kw)
    if kind == "base":
        return LikelihoodModel(device=device, **kw)
    raise ValueError(f"unknown model kind {kind!r}: want single, paired "
                     "or base")
