"""Device-resident incremental scoring state, on one device.

Port of gaml_tpu/parallel/device_state.py.  The host incremental scorer
(scoring/paired.py, reference ScoringState graph.h:612-619) keeps each
read's running pair probability in a numpy array and reduces it on every
move; this state keeps the running totals on the device:

- ``apply``: add a (read_id, delta) chunk, the add/erase output of the
  incremental scorer, into the totals;
- ``reduce``: the floored mean-log reduction (reference GetTotalProb,
  graph.cc:1495-1516), float64, floored in log space
  (ops/score.py::reduce_read_probs), where a total at or below zero floors
  as on the host.

The order of addition is fixed.  ``index_add_`` on CUDA float64 adds with
atomics, in an order that changes from run to run, and a total one ulp
off can flip an accept.  A chunk's entries are ranked within their read
in the order they came (``segment_ranks``) and added one rank at a time
(``fold_segments``, the one ordered sum of the port's device scorers):
the order of the host's ``np.add.at``, so the device totals equal the
host's bit for bit.

Left behind from the JAX state, which needed them for a sharded mesh and
for XLA's compile count: the mesh and its padding of the reads axis, the
reads mask, the power-of-two chunk buckets and the float32 option.  A10b
brings the process group.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.score import reduce_read_probs


def segment_ranks(ids):
    """(distinct ids ascending, the segment of each entry (its id's index
    there), its rank among its segment's entries in the order they come),
    on ids' device."""
    uniq, seg = torch.unique(ids, return_inverse=True)
    order = torch.argsort(seg, stable=True)
    counts = torch.bincount(seg, minlength=len(uniq))
    first = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(seg)
    rank[order] = torch.arange(len(seg), device=seg.device) - first[seg[order]]
    return uniq, seg, rank


def fold_segments(start, values, seg, rank):
    """start [U] plus the values of each segment (``seg``), added one at a
    time in ``rank`` order (0, 1, ... within a segment): as np.add.at adds
    a segment's values in the order they come.  Step s adds the s-th value
    of every segment that has one.  The values are laid out step by step,
    each step's segments in the order of their counts (descending), so a
    step is one add over a prefix of the segments: no padding, and one
    launch per step, as many as the largest count of one segment."""
    if values.numel() == 0:
        return start
    n = start.shape[0]
    counts = torch.bincount(seg, minlength=n)
    by_count = torch.argsort(counts, descending=True, stable=True)
    place = torch.empty_like(by_count)
    place[by_count] = torch.arange(n, device=start.device)
    vals = values[torch.argsort(rank * n + place[seg])]
    out = start[by_count]
    at = 0
    for width in torch.bincount(rank).tolist():
        out[:width] += vals[at:at + width]
        at += width
    res = torch.empty_like(out)
    res[by_count] = out
    return res


def floored_mean_log(probs, lens, total_len: int, min_prob_per_base: float,
                     min_prob_start: float):
    """(score, zero_reads) as Python numbers, one transfer: GetTotalProb
    of float64 per-read totals (ops/score.py::reduce_read_probs)."""
    score, zeros, _ = reduce_read_probs(probs, lens, total_len,
                                        min_prob_per_base, min_prob_start)
    s, z = torch.stack([score, zeros.to(torch.float64)]).tolist()
    return s, int(z)


class DeviceScoringState:
    """Per-read running totals (float64 ``probs``) and the pair lengths
    of the floor (``lens``) on ``device``, with the floored-log
    reduction."""

    def __init__(self, n_reads: int, read_lens, device="cuda"):
        self.device = torch.device(device)
        self.n_reads = n_reads
        self.probs = torch.zeros(n_reads, dtype=torch.float64,
                                 device=self.device)
        self.lens = torch.tensor(np.asarray(read_lens, dtype=np.float64),
                                 device=self.device)

    def apply(self, rid_arr, p_arr, sign: int = 1) -> None:
        """Add one delta chunk, ``sign * p_arr``, into the totals of reads
        ``rid_arr`` (ids may repeat), in the chunk's order."""
        if len(rid_arr) == 0:
            return
        deltas = np.asarray(p_arr, dtype=np.float64)
        # ids and deltas in one transfer
        both = torch.from_numpy(np.stack([
            np.asarray(rid_arr, dtype=np.int64),
            (deltas if sign > 0 else -deltas).view(np.int64)])).to(self.device)
        uniq, seg, rank = segment_ranks(both[0])
        self.probs[uniq] = fold_segments(
            self.probs[uniq], both[1].view(torch.float64), seg, rank)

    def reduce(self, total_len: int, min_prob_per_base: float,
               min_prob_start: float):
        """(score, zero_reads): reference GetTotalProb semantics."""
        return floored_mean_log(self.probs, self.lens, total_len,
                                min_prob_per_base, min_prob_start)

    def to_host(self) -> np.ndarray:
        """The running totals as a float64 numpy array (checkpointing)."""
        return self.probs.cpu().numpy().astype(np.float64)

    def from_host(self, probs) -> None:
        self.probs = torch.tensor(np.asarray(probs, dtype=np.float64),
                                  device=self.device)
