"""GetTotalProb on the device (graph.cc:1518-1537).

Port of gaml_tpu/ops/score.py::reduce_read_probs, in float32 as there.
"""
from __future__ import annotations

import torch


def reduce_read_probs(read_probs: torch.Tensor, lens: torch.Tensor,
                      total_len: int, min_prob_per_base: float,
                      min_prob_start: float):
    """Floored mean log of read_prob / (2 * total_len) over all reads.

    read_probs: float32 [n_reads]; lens: each read's length (reads with
    no alignment still need one for the floor).  Returns 0-dim tensors
    (score, zero_reads) and read_probs."""
    tl = max(int(total_len), 1)
    probs = read_probs / (2.0 * tl)
    thresholds = torch.exp(min_prob_start
                           + min_prob_per_base * lens.to(torch.float32))
    floored = probs < thresholds
    zero_reads = floored.sum()
    probs = torch.where(floored, thresholds, probs)
    score = torch.log(probs).sum() / max(probs.shape[0], 1)
    return score, zero_reads, read_probs
