"""Paired-end pair-product reduction on the device.

Port of gaml_tpu/ops/pair.py (reference graph.cc:2054-2091): for each
read, all (pos1, pos2) combinations with opposite orientations in innie
geometry contribute p1 * p2 * insert_pdf(dist).  Position lists per read
are short (coverage-bounded); staged as dense [R, K] arrays the whole
combination is one [R, K, K] broadcast, then the floored mean-log
reduction.  Plain torch, as the JAX package leaves it to XLA (it is not
a Pallas kernel there), but in float64 where the JAX package computes in
float32: each pair's log p1 + log p2 + log insert_pdf is formed and
exponentiated in float64, so pairs with a few errors and an insert far
off the mean keep their probability where float32 made it 0 and floored
it (ROADMAP C12; ops.score says why).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .score import alignment_log_probs, reduce_read_probs


def paired_pair_product(pos1, ed1, or1, len1, pos2, ed2, or2, len2,
                        log_match, log_mismatch, insert_mean, insert_std):
    """read_probs float64 [R] from dense position arrays [R, K] (invalid
    entries have pos == -1) and per-read mate lengths [R]."""
    v1 = (pos1 >= 0)[:, :, None]
    v2 = (pos2 >= 0)[:, None, :]
    x_pos = pos1[:, :, None]
    y_pos = pos2[:, None, :]
    x_or = or1[:, :, None]
    y_or = or2[:, None, :]

    x_first = x_pos < y_pos
    geom_ok = torch.where(x_first, (x_or == 0) & (y_or == 1),
                          (x_or == 1) & (y_or == 0))
    dist = torch.where(x_first, y_pos - x_pos + len2[:, None, None],
                       x_pos - y_pos + len1[:, None, None]).to(torch.float64)

    z = (dist - insert_mean) / insert_std
    log_ins = -z * z / 2.0 - math.log(math.sqrt(2 * math.pi) * insert_std)
    lp1 = alignment_log_probs(ed1, len1[:, None], log_match, log_mismatch)
    lp2 = alignment_log_probs(ed2, len2[:, None], log_match, log_mismatch)
    p = torch.exp(lp1[:, :, None] + lp2[:, None, :] + log_ins)
    p = torch.where(v1 & v2 & geom_ok, p, 0.0)
    return p.sum(dim=(1, 2))


def paired_score_device(pos1, ed1, or1, len1, pos2, ed2, or2, len2,
                        log_match, log_mismatch, insert_mean, insert_std,
                        total_len, min_prob_per_base, min_prob_start):
    """Pair products + floored mean-log reduction.  Returns 0-dim (score,
    zero_reads) and read_probs."""
    read_probs = paired_pair_product(
        pos1, ed1, or1, len1, pos2, ed2, or2, len2,
        log_match, log_mismatch, insert_mean, insert_std)
    return reduce_read_probs(read_probs, len1 + len2, total_len,
                             min_prob_per_base, min_prob_start)


def stage_positions_dense(positions, n_reads: int, k_cap: int = 12):
    """positions: per-read list of (pos, (ed, orient)) tuples (the ReadSet
    positions structure) -> dense [R, k_cap] int32 numpy arrays (pos, ed,
    orient) and the count of positions dropped beyond k_cap."""
    pos = np.full((n_reads, k_cap), -1, dtype=np.int32)
    ed = np.zeros((n_reads, k_cap), dtype=np.int32)
    orient = np.zeros((n_reads, k_cap), dtype=np.int32)
    dropped = 0
    for i in range(min(n_reads, len(positions))):
        plist = positions[i]
        if len(plist) > k_cap:
            dropped += len(plist) - k_cap
        for j, (p, (e, o)) in enumerate(plist[:k_cap]):
            pos[i, j] = p
            ed[i, j] = e
            orient[i, j] = o
    return pos, ed, orient, dropped
