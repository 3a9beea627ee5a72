"""Data-parallel single-end scoring, on one device.

Port of gaml_tpu/parallel/sharded.py.  The JAX package maps reads and
alignment candidates onto a 2-D mesh: axis "reads" shards the reads and
their per-read totals, axis "cand" splits the candidates of the same
reads.  The staged arrays keep that layout here, with leading axes [NR,
NC, nb, ...], so ROADMAP A10b can shard them over processes; on one
device the world is (NR, NC) = (1, 1), and ``sharded_single_end_score``
runs the port's single-chip forward (ops/score.py::single_end_forward:
one launch of extend_exact_staged, the float64 dedup and reduction,
floored in log space) on the one cell.  The JAX step compares the floor
in float32 linear space (ROADMAP C10); this one does not.  There is no
make_mesh: one device is the world.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops.extend import stage_candidates
from ..ops.score import single_end_forward

STAGED_KEYS = ("read_f", "rlen_f", "gwin_f", "glen_f", "read_b", "rlen_b",
               "gwin_b", "glen_b", "g0", "r0", "valid", "read_id",
               "read_len", "at_start")


def sharded_single_end_score(staged, read_lens_all, log_match: float,
                             log_mismatch: float, total_len: int,
                             min_prob_per_base: float, min_prob_start: float,
                             rmax: int, n_reads_local: int, n_reads: int):
    """The forward scoring step of stage_sharded's arrays (leading dims
    [NR, NC, nb, ...]; read_lens_all the (lens, mask) pair, [NR,
    n_reads_local]).  One device runs a world of (1, 1).  Returns 0-dim
    tensors (score, zero_reads)."""
    world = tuple(staged["read_f"].shape[:2])
    if world != (1, 1):
        raise ValueError(f"staged for a world of {world}: one device runs "
                         "(1, 1); more is ROADMAP A10b")
    lens, _mask = read_lens_all
    if n_reads_local != n_reads:
        raise ValueError(f"{n_reads_local} local reads of {n_reads}: one "
                         "reads shard holds them all")
    score, zeros, _ = single_end_forward(
        *(staged[k][0, 0] for k in STAGED_KEYS), lens[0, :n_reads],
        log_match, log_mismatch, total_len, min_prob_per_base,
        min_prob_start, rmax=rmax, n_reads=n_reads)
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
    """[NR, NC, nb, ...] staged tensors from per-reads-shard candidate
    lists, for a world of (NR, NC) = ``world``; each candidate is
    (read_id_local, genome_pos, read_pos, read).  Returns (staged, (lens,
    mask), n_reads_local)."""
    nr, nc = world
    if len(cand_by_read_shard) != nr:
        raise ValueError(f"{len(cand_by_read_shard)} reads shards for a "
                         f"world of {world}")
    per_cell, nb = split_cells(cand_by_read_shard, nc)
    n_reads_local = max(len(rl) for rl in read_lens)
    staged, lens_mask = stage_rows(seq, per_cell, nc, rmax, nb, read_lens,
                                   n_reads_local, device)
    return staged, lens_mask, n_reads_local
