"""Plain reference of the program's hybrid anneal: a paired library and a
long-read (PacBio) library scored in one likelihood, every scoring call
of a run followed (numpy and plain torch, TF32 off; nothing of the
program is imported).  For the comparison that decides ``correct`` in the
``pacbio.anneal`` cell and for the tests.

The paired library is ``reference/shortread.py``'s ``PairedLibrary``,
whose ``replay`` follows the incremental scorer from an empty state.  The
long-read library is ``reference/pacbio.py``'s ``Reference`` with its
alignment cache kept across calls (``LongReadCache``): each fill of the
program's cache (``PacbioReadSet.precompute_ranges_for_paths``, from a
scoring call or from a move's prefetch) is planned on the host from the
reference's own cache, in the program's order: each distinct walk's
missing windows, merged into ranges, each range's windows reserved (or
found reserved by an earlier fill), its anchored reads chained against
the range's spelling into jobs with their guides.  A window's hits come
only from the fill that reserved it, so the banded forward of every
fill's jobs runs once, in float64 blocks on the device, whatever order
the calls came in; then each judged call is assigned and scored from the
whole cache (a call reads only windows reserved by then).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from reference import pacbio as P

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class LongReadCache(P.Reference):
    """``pacbio.Reference`` whose cache persists across fills: ``reserved``
    holds every window in the order the fills reserved them, ``fills``
    and ``jobs`` every range and forward job so far."""

    def __init__(self, nodes, reads, mismatch_prob: float):
        super().__init__(nodes, reads, mismatch_prob)
        self.reserved: Dict[Tuple[int, ...], None] = {}
        self.fills: List[P.Fill] = []
        self.jobs: List[P.Job] = []
        # walks whose every window is reserved: no later fill misses one
        self.complete = set()

    def fill(self, walks):
        """One fill of ``walks``: (the missing (i, j) windows each distinct
        walk found, the windows it reserved in order, its jobs)."""
        n_res, n_fill = len(self.reserved), len(self.fills)
        missing_n = 0
        seen = set()
        for walk in walks:
            walk = tuple(walk)
            if walk in seen:
                continue
            seen.add(walk)
            if walk in self.complete:
                continue
            missing = [(i, j) for i, j in self.windows(walk)
                       if walk[i:j + 1] not in self.reserved]
            missing_n += len(missing)
            for a, b in P.merge(missing):
                path = walk[a:b + 1]
                starts, taken = {}, set()
                for i, j in self.windows(path):
                    key = path[i:j + 1]
                    if key in self.reserved:
                        taken.add(key)
                    else:
                        self.reserved[key] = None
                    starts[key] = i
                begins, ends = self.bounds(path)
                self.fills.append(P.Fill(path, begins, ends,
                                         self.spell(path), starts, taken))
            self.complete.add(walk)
        jobs = []
        for f in range(n_fill, len(self.fills)):
            jobs += self.chain_jobs(self.fills[f], f)
        self.jobs += jobs
        return missing_n, list(self.reserved)[n_res:], len(jobs)

    def plan_of(self, walks) -> P.Plan:
        """Every fill so far, scored as ``walks``."""
        return P.Plan([list(w) for w in walks], self.fills,
                      list(self.reserved), self.jobs)

    def forward_all(self, device, dtype=torch.float64) -> np.ndarray:
        """Every job's log-probability, computed in ``dtype``."""
        return self.forward([self.plan_of([])], device, dtype)[0]

    def answer(self, walks, lps, **params) -> P.Answer:
        """The long-read library's answer for a call of ``walks``: the
        whole cache's hits assigned (``windows``), the score, zero reads,
        bad bases and total length."""
        return self.finish(self.plan_of(walks), lps, **params)
