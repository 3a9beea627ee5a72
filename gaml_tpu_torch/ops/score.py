"""Device likelihood pipeline (single-end model) and GetTotalProb.

Port of gaml_tpu/ops/score.py: a batch of seed candidates runs through
the two-direction exact extension (one launch of extend_exact_staged,
the counterpart of K3/K4), alignment probabilities mm^ed * m^(L-ed) are
deduplicated by (read, begin) (set<Aligment>, graph.cc:895-897) and
summed per read, and the per-read sums reduce to the floored mean-log
score (graph.cc:1482-1537).

The probabilities, their per-read sums and the reduction are float64,
where the JAX package computes in float32: a read's (or a pair's) p / (2
total_len) lies below float32's range (2^-149, log -103.3) for reads
that the log-space floor still keeps (-150 for 2 x 100 bp at the
default floors, lower for longer mates), and float32 turned them into
zero reads (ROADMAP C12).  The reduction takes log(p) - log(2
total_len) and floors in log space, as the float64 host's
scoring/reduce.py::get_total_prob_from_logs does.  The H100's FP64 makes
this cheap at these sizes.

The JAX package has two forward steps (single_end_forward on
candidate-major views, single_end_forward_pallas on the TPU kernel's
transposed int32 views); the port has one, ``single_end_forward``, with
the first one's positional signature.  Dedup is one stable sort on an
int64 (read_id, begin) key with invalid entries last, keeping the first
of each run: the order of the JAX two-key sort.
"""
from __future__ import annotations

import math

import torch

from .extend_cuda import extend_exact_staged

_KEY_PAD = torch.iinfo(torch.int64).max  # sorts after every valid key
_INT32_BIG = 2**31 - 1


def dedup_alignments(read_id, begin, good):
    """Drop duplicate (read, begin) alignments: sort by (read_id, begin)
    with invalid entries (``good`` false) last, keep the first of each
    run.  Returns (order, keep_mask_in_sorted_order)."""
    key = (read_id.to(torch.int64) << 32) | (begin.to(torch.int64)
                                             + (1 << 31))
    key = torch.where(good, key, _KEY_PAD)
    key_s, order = torch.sort(key, stable=True)
    first = torch.ones_like(good)
    first[1:] = key_s[1:] != key_s[:-1]
    return order, good[order] & first


def dedup_sort_payload(read_id, begin, good, payloads):
    """dedup_alignments carrying payloads: returns (rid_sorted, keep_mask,
    sorted_payloads), rid_sorted holding INT32_BIG at invalid entries as
    in JAX."""
    order, keep = dedup_alignments(read_id, begin, good)
    rid_key = torch.where(good, read_id, _INT32_BIG)
    return rid_key[order], keep, tuple(p[order] for p in payloads)


def candidates_to_score(ok, errs, begin, valid, read_id, read_len,
                        read_lens_all, log_match, log_mismatch, total_len,
                        min_prob_per_base, min_prob_start, n_reads: int):
    """Per-candidate alignment results to the assembly score.

    ok/errs/begin: extension outputs [N]; valid: padding mask [N];
    read_id/read_len: per-candidate read metadata [N]; read_lens_all:
    [n_reads] true per-read lengths (the floor of reads with no
    alignment).  Returns 0-dim (score, zero_reads) and read_probs
    (float64)."""
    good = ok & valid
    rid_s, keep, (errs_s, rlen_s) = dedup_sort_payload(
        read_id, begin, good, (errs, read_len))
    p = alignment_probs(errs_s, rlen_s, log_match, log_mismatch)
    read_probs = torch.zeros(n_reads, dtype=torch.float64,
                             device=ok.device)
    read_probs.index_add_(0, rid_s[keep].to(torch.int64), p[keep])
    return reduce_read_probs(read_probs, read_lens_all, total_len,
                             min_prob_per_base, min_prob_start)


def alignment_log_probs(errs, read_len, log_match: float,
                        log_mismatch: float):
    """log(mm^errs * m^(read_len - errs)) per alignment, float64."""
    e = errs.to(torch.float64)
    return e * log_mismatch + (read_len.to(torch.float64) - e) * log_match


def alignment_probs(errs, read_len, log_match: float, log_mismatch: float):
    """mm^errs * m^(read_len - errs) per alignment, float64."""
    return torch.exp(alignment_log_probs(errs, read_len, log_match,
                                         log_mismatch))


def reduce_read_probs(read_probs: torch.Tensor, lens: torch.Tensor,
                      total_len: int, min_prob_per_base: float,
                      min_prob_start: float):
    """Floored mean log of read_prob / (2 * total_len) over all reads.

    read_probs: float64 [n_reads]; lens: each read's (or pair's) length
    (reads with no alignment still need one for the floor).  The score is
    log(read_prob) - log(2 * total_len), floored at min_prob_start +
    min_prob_per_base * len in log space (in linear float32 the floor is
    0 from len ~135 at the default floors, where the JAX reduction counts
    no floored read and scores -inf, ROADMAP C10), summed in float64.  A
    total at or below zero (a running total that an erase left at 0, or a
    rounding step under it) has log -inf and floors, as on the host
    (scoring/paired.py::_state_log_probs), where torch.log would give NaN.
    Returns 0-dim tensors (score, zero_reads) and read_probs."""
    tl = max(int(total_len), 1)
    p = read_probs.to(torch.float64)
    log_probs = torch.where(p > 0, torch.log(p), -math.inf) \
        - math.log(2 * tl)
    log_floor = min_prob_start + min_prob_per_base * lens.to(torch.float64)
    floored = log_probs < log_floor
    zero_reads = floored.sum()
    score = torch.where(floored, log_floor, log_probs).sum() \
        / max(read_probs.shape[0], 1)
    return score, zero_reads, read_probs


def single_end_forward(read_f, rlen_f, gwin_f, glen_f,
                       read_b, rlen_b, gwin_b, glen_b,
                       g0, r0, valid, read_id, read_len, at_start,
                       read_lens_all, log_match, log_mismatch, total_len,
                       min_prob_per_base, min_prob_start,
                       rmax: int, n_reads: int):
    """Single-chip forward step: extension + dedup + reduction, on the
    staged dict's tensors (ops.extend.stage_candidates; candidate-major
    views, rmax rows).  On CUDA tensors the extension is one launch of
    extend_exact_staged (both directions and the epilogue, the views read
    where they lie); on CPU tensors its plain version.  Returns (score,
    zero_reads, read_probs)."""
    if read_f.shape[1] != rmax:
        raise ValueError(f"read_f has {read_f.shape[1]} rows, rmax {rmax}")
    ok, errs, begin = extend_exact_staged({
        "read_f": read_f, "gwin_f": gwin_f, "rlen_f": rlen_f,
        "glen_f": glen_f, "read_b": read_b, "gwin_b": gwin_b,
        "rlen_b": rlen_b, "glen_b": glen_b, "g0": g0, "r0": r0,
        "at_start": at_start})
    return candidates_to_score(
        ok, errs, begin, valid, read_id, read_len, read_lens_all,
        log_match, log_mismatch, total_len, min_prob_per_base,
        min_prob_start, n_reads)
