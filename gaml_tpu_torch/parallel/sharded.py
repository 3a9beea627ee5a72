"""Data-parallel single-end scoring, one reads shard per process.

Port of gaml_tpu/parallel/sharded.py.  The JAX package maps reads and
alignment candidates onto a 2-D mesh: axis "reads" shards the reads and
their per-read totals, axis "cand" splits the candidates of the same
reads.  The port's world is (NR, NC): NR processes
(parallel/distributed.py), each holding one reads shard (its row, a
contiguous range of reads_for_process), and NC cells per row.  A process
stages only its own row, [1, NC, nb, ...] (``nb`` its own: a CUDA kernel
takes any shape, so the processes agree on none), and
``sharded_single_end_score`` runs the port's single-chip forward
(ops/score.py::single_end_read_probs: one launch of extend_exact_staged
per cell, the float64 dedup and per-read sums) on its cells.  split_cells
keeps a read's candidates in one cell, so the cells' sum is exact; the
per-read totals are gathered in rank order and every process runs the
one-process reduction (ops/score.py::reduce_read_probs, floored in log
space) on the full vector: the score of a world of one, on every rank.
The JAX step compares the floor in float32 linear space (ROADMAP C10);
this one does not.  There is no make_mesh: the process group is the
world.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops.extend import stage_candidates
from ..ops.score import reduce_read_probs, single_end_read_probs
from . import distributed

STAGED_KEYS = ("read_f", "rlen_f", "gwin_f", "glen_f", "read_b", "rlen_b",
               "gwin_b", "glen_b", "g0", "r0", "valid", "read_id",
               "read_len", "at_start")


def sharded_single_end_score(staged, read_lens_all, log_match: float,
                             log_mismatch: float, total_len: int,
                             min_prob_per_base: float, min_prob_start: float,
                             rmax: int, n_reads_local: int, n_reads: int):
    """The forward scoring step of this process's stage_sharded arrays
    (leading dims [1, NC, nb, ...], read ids local to its reads shard;
    read_lens_all the (lens, mask) pair, [1, n_reads_local]).  Returns
    0-dim tensors (score, zero_reads), the same on every process."""
    lo, hi = distributed.read_range(n_reads)
    if staged["read_f"].shape[0] != 1 or n_reads_local < hi - lo:
        raise ValueError(f"staged rows {tuple(staged['read_f'].shape[:2])} "
                         f"with {n_reads_local} local reads: a process "
                         f"holds one reads shard, reads [{lo}, {hi})")
    lens, _mask = read_lens_all
    probs = None
    for c in range(staged["read_f"].shape[1]):
        cell = single_end_read_probs(
            *(staged[k][0, c] for k in STAGED_KEYS), log_match,
            log_mismatch, rmax=rmax, n_reads=hi - lo)
        probs = cell if probs is None else probs + cell
    probs = distributed.gather_read_values(probs, n_reads)
    all_lens = distributed.gather_read_values(lens[0, :hi - lo], n_reads)
    score, zeros, _ = reduce_read_probs(probs, all_lens, total_len,
                                        min_prob_per_base, min_prob_start)
    return score, zeros


def split_cells(cand_by_read_shard: List[list], nc: int):
    """Split each reads-shard's candidates round-robin by read id across
    the cand axis (duplicate alignments of one read stay in one cell — the
    (read, begin) dedup is per-shard).  Returns (per_cell, local_nb)."""
    per_cell: List[List[list]] = [[[] for _ in range(nc)]
                                  for _ in cand_by_read_shard]
    for ri, cands in enumerate(cand_by_read_shard):
        for c in cands:
            per_cell[ri][c[0] % nc].append(c)
    nb = max(1, max((len(cell) for row in per_cell for cell in row),
                    default=1))
    return per_cell, nb


def stage_rows(seq: np.ndarray, per_cell: List[List[list]], nc: int,
               rmax: int, nb: int, read_lens: Sequence[np.ndarray],
               n_reads_local: int, device="cuda"):
    """Stage a set of reads-shard rows into [n_rows, NC, nb, ...] tensors
    on ``device`` (one row per reads shard).  ``nb`` is the per-cell
    capacity shared by every cell.  Returns (staged, (lens, mask))."""
    cells = []
    for ri in range(len(per_cell)):
        row = []
        for ci in range(nc):
            cell = per_cell[ri][ci]
            row.append(stage_candidates(
                seq, np.array([c[1] for c in cell], dtype=np.int32),
                np.array([c[2] for c in cell], dtype=np.int32),
                [c[3] for c in cell], rmax=rmax, nb=nb,
                read_ids=np.array([c[0] for c in cell], dtype=np.int32),
                device=device))
        cells.append(row)
    staged = {k: torch.stack([torch.stack([c[k] for c in row])
                              for row in cells]) for k in STAGED_KEYS}
    lens = np.zeros((len(per_cell), n_reads_local), dtype=np.int32)
    mask = np.zeros((len(per_cell), n_reads_local), dtype=bool)
    for ri, rl in enumerate(read_lens):
        lens[ri, :len(rl)] = rl
        mask[ri, :len(rl)] = True
    return staged, (torch.from_numpy(lens).to(device),
                    torch.from_numpy(mask).to(device))


def stage_sharded(seq: np.ndarray, cand_by_read_shard: List[list],
                  rmax: int, read_lens: Sequence[np.ndarray],
                  world: Tuple[int, int] = (1, 1), device="cuda"):
    """This process's [1, NC, nb, ...] staged tensors, for a world of
    (NR, NC) = ``world`` whose NR is the process group's size:
    ``cand_by_read_shard`` holds one list, the candidates of this
    process's reads shard, each (read_id_local, genome_pos, read_pos,
    read), and ``read_lens`` its reads' lengths.  Returns (staged, (lens,
    mask), n_reads_local)."""
    nr, nc = world
    if nr != distributed.world()[1] or len(cand_by_read_shard) != 1:
        raise ValueError(f"{len(cand_by_read_shard)} reads shards for a "
                         f"world of {world} in a process group of "
                         f"{distributed.world()[1]}: a process stages its "
                         "own shard")
    per_cell, nb = split_cells(cand_by_read_shard, nc)
    n_reads_local = max(len(rl) for rl in read_lens)
    staged, lens_mask = stage_rows(seq, per_cell, nc, rmax, nb, read_lens,
                                   n_reads_local, device)
    return staged, lens_mask, n_reads_local
