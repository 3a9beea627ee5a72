"""Device likelihood pipeline (single-end model) and GetTotalProb.

Port of gaml_tpu/ops/score.py, in float32 as there: a batch of seed
candidates runs through the two-direction extension (one exact launch,
K4), alignment probabilities mm^ed * m^(L-ed) are deduplicated by
(read, begin) (set<Aligment>, graph.cc:895-897) and summed per read,
and the per-read sums reduce to the floored mean-log score
(graph.cc:1482-1537).

The JAX package has two forward steps (single_end_forward on
candidate-major views, single_end_forward_pallas on the TPU kernel's
transposed int32 views); the port has one, ``single_end_forward``, with
the first one's positional signature.  Dedup is one stable sort on an
int64 (read_id, begin) key with invalid entries last, keeping the first
of each run: the order of the JAX two-key sort.
"""
from __future__ import annotations

import torch

from .extend import extend_epilogue
from .extend_cuda import extend_kernel_exact

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
    alignment).  Returns 0-dim (score, zero_reads) and read_probs."""
    good = ok & valid
    rid_s, keep, (errs_s, rlen_s) = dedup_sort_payload(
        read_id, begin, good, (errs, read_len))
    e = errs_s.to(torch.float32)
    p = torch.exp(e * log_mismatch + (rlen_s.to(torch.float32) - e)
                  * log_match)
    read_probs = torch.zeros(n_reads, dtype=torch.float32,
                             device=ok.device)
    read_probs.index_add_(0, rid_s[keep].to(torch.int64), p[keep])
    return reduce_read_probs(read_probs, read_lens_all, total_len,
                             min_prob_per_base, min_prob_start)


def reduce_read_probs(read_probs: torch.Tensor, lens: torch.Tensor,
                      total_len: int, min_prob_per_base: float,
                      min_prob_start: float):
    """Floored mean log of read_prob / (2 * total_len) over all reads.

    read_probs: float32 [n_reads]; lens: each read's (or pair's) length
    (reads with no alignment still need one for the floor).  The floor
    exp(min_prob_start + min_prob_per_base * len) is applied in log
    space: in float32 it underflows to 0 from len ~135 at the default
    floors (a pair of 100 bp mates), where the JAX reduction then counts
    no floored read and scores -inf (ROADMAP C10).  Returns 0-dim tensors
    (score, zero_reads) and read_probs."""
    tl = max(int(total_len), 1)
    log_probs = torch.log(read_probs / (2.0 * tl))
    log_floor = min_prob_start + min_prob_per_base * lens.to(torch.float32)
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
    views, rmax rows).  On CUDA tensors the extension is one
    dp_rows_exact launch of both directions; on CPU tensors its plain
    version.  Returns (score, zero_reads, read_probs)."""
    if read_f.shape[1] != rmax:
        raise ValueError(f"read_f has {read_f.shape[1]} rows, rmax {rmax}")
    ok, errs, d_back = extend_kernel_exact({
        "read_f": read_f, "rlen_f": rlen_f, "gwin_f": gwin_f,
        "glen_f": glen_f, "read_b": read_b, "rlen_b": rlen_b,
        "gwin_b": gwin_b, "glen_b": glen_b})
    ok, errs, begin = extend_epilogue(ok, errs, d_back, g0, r0, at_start)
    return candidates_to_score(
        ok, errs, begin, valid, read_id, read_len, read_lens_all,
        log_match, log_mismatch, total_len, min_prob_per_base,
        min_prob_start, n_reads)
