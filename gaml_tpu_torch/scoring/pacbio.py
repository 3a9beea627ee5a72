"""Adopt a gaml_tpu PacbioReadSet into the port: its forward-DP batches
run on the port's engine (ops/forward_device.py, kernel K5).

Everything above the forward DP is gaml_tpu's: anchors, chaining, guide
paths, the alignment cache and the scorer.  ``_forward_batch`` routes a
batch by its size in DP cells (sum of read lengths x band width):

- below GAML_PB_DEVICE_MIN_CELLS, to the native host kernel
  (gaml_tpu.native.banded_forward_host, float64), where it is built;
- otherwise to the engine on the adopted device: the CUDA kernel on a
  CUDA device, its plain torch version on the CPU.

Every route runs at the read set's own ``forward_width`` (ROADMAP C5:
the JAX device route runs at 128 whatever the width).  Cells are counted
in ``dp_cells`` under "cuda", "torch" and "native".  Left behind from the
JAX read set: the warm-up router and the prewarm ladder (they hid XLA
compiles), the chunking to one executable shape, and the fallback to
native on a device error (a device error raises).
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from gaml_tpu.scoring.pacbio import PacbioReadSet

from ..ops.forward_device import ForwardDeviceEngine, guide_steps

# GAML_PB_DEVICE_MIN_CELLS default: the native-vs-card crossover in DP
# cells, measured by chip_smoke.py phase 6 on an NVIDIA H100 80GB HBM3
# (700 W) against the native kernel on its host's 8 cores: one job of
# 1024 bases at width 64 (65536 cells) took 1.69 ms native and 1.71 ms on
# the card, one of 2048 bases 6.6 ms and 3.1 ms
DEVICE_MIN_CELLS = 131072
RESIDENT_MAX = 4_000_000_000  # GAML_PB_RESIDENT_MAX default, bytes


def job_arrays(seq, jobs, extents):
    """The batch arrays of gaml_tpu's PacbioReadSet._forward_batch: rmax
    (the longest job rounded up to 128), reads [b, rmax] uint8 padded with
    6, rlens, centers [b, rmax + 1] (the last center repeated), the
    targets' gstarts/glens (default: the whole buffer) and each job's
    (rid, strand), rid -1 where the job has none."""
    rmax = max(len(j[0]) for j in jobs)
    rmax = ((rmax + 127) // 128) * 128
    b = len(jobs)
    reads = np.full((b, rmax), 6, dtype=np.uint8)
    rlens = np.zeros(b, dtype=np.int32)
    centers = np.zeros((b, rmax + 1), dtype=np.int32)
    job_rid = np.full(b, -1, dtype=np.int32)
    job_strand = np.zeros(b, dtype=np.uint8)
    for i, (r, c, *extra) in enumerate(jobs):
        reads[i, :len(r)] = r
        rlens[i] = len(r)
        centers[i, :len(c)] = c
        centers[i, len(c):] = c[-1]
        if extra:
            job_rid[i] = extra[0]
            job_strand[i] = extra[1]
    if extents is None:
        gstarts = np.zeros(b, dtype=np.int32)
        glens = np.full(b, len(seq), dtype=np.int32)
    else:
        gstarts = np.array([e[0] for e in extents], dtype=np.int32)
        glens = np.array([e[1] for e in extents], dtype=np.int32)
    return rmax, reads, rlens, centers, gstarts, glens, job_rid, job_strand


class TorchPacbioReadSet(PacbioReadSet):
    """A PacbioReadSet whose forward-DP batches run on the port."""

    def prewarm_device(self, clear_metrics: bool = True) -> None:
        """No-op: the port has nothing to compile ahead of the anneal."""

    def prewarm_device_async(self):
        """No-op: the port has nothing to compile ahead of the anneal."""
        return None

    def _ensure_fwd_engine(self):
        """The engine with this read set's resident rows on the adopted
        device, or an engine without them (dense staging) when the rows
        would exceed GAML_PB_RESIDENT_MAX bytes."""
        eng = getattr(self, "_fwd_engine", None)
        if eng is not None:
            return eng
        rmax_cls = max((len(r) for r in self.read_seq), default=0)
        need = ForwardDeviceEngine.resident_bytes(self.reads_num, rmax_cls)
        cap = int(os.environ.get("GAML_PB_RESIDENT_MAX", RESIDENT_MAX))
        if need > cap:
            print(f"[pb.forward] resident read rows would be "
                  f"{need / 1e9:.1f} GB > cap {cap / 1e9:.1f} GB; using "
                  f"dense staging", file=sys.stderr, flush=True)
            eng = ForwardDeviceEngine(None, self.torch_device)
        else:
            eng = ForwardDeviceEngine(self.read_seq, self.torch_device)
        self._fwd_engine = eng
        return eng

    def _forward_batch(self, seq: np.ndarray, jobs, extents=None):
        """jobs: list of (read codes, centers[, rid, strand]); returns the
        logprobs list.  ``extents`` gives each job's (gstart, glen) in
        ``seq``; default the whole buffer."""
        if not jobs:
            return []
        if getattr(self, "forward_dispatch", None) is not None:
            raise NotImplementedError(
                "the PacBio mesh scorer is not ported to gaml_tpu_torch "
                "yet: ROADMAP A10 (parallel/pacbio_sharded.py)")
        (rmax, reads, rlens, centers, gstarts, glens, job_rid,
         job_strand) = job_arrays(seq, jobs, extents)
        width = self.forward_width or 64
        cells = int(rlens.sum()) * width
        prof = getattr(self, "dp_cells", None)
        if prof is None:
            prof = self.dp_cells = {}
        lm = float(np.log(self.match_prob))
        lmm = float(np.log(self.mismatch_prob))

        if cells < int(os.environ.get("GAML_PB_DEVICE_MIN_CELLS",
                                      DEVICE_MIN_CELLS)):
            from gaml_tpu.native import banded_forward_host, get_lib

            if get_lib() is not None:
                out = banded_forward_host(seq, reads, rlens, centers,
                                          gstarts, glens, lm, lmm, width)
                prof["native"] = prof.get("native", 0) + cells
                return [float(x) for x in out]

        eng = self._ensure_fwd_engine()
        resident = eng.rows is not None and bool((job_rid >= 0).all())
        out = eng.forward(
            seq, guide_steps(centers), centers[:, 0], gstarts, glens, rlens,
            lm, lmm, width,
            rid=job_rid if resident else None,
            strand=job_strand if resident else None,
            reads=None if resident else reads)
        key = "cuda" if eng.device.type == "cuda" else "torch"
        prof[key] = prof.get(key, 0) + cells
        return [float(x) for x in out]


def adopt_pacbio_readset(rs: PacbioReadSet, device) -> TorchPacbioReadSet:
    """Route the forward-DP batches of ``rs`` (reads loaded) to the port's
    engine on ``device``.  Returns ``rs`` itself."""
    rs.torch_device = torch.device(device)
    rs._fwd_engine = None
    rs.__class__ = TorchPacbioReadSet
    return rs
