"""Device staging + two-direction extension: the resident engine and the
batch entry points.

Port of gaml_tpu/ops/extend_device.py and of the dispatch helpers of
gaml_tpu/ops/extend.py:

- DeviceExtender (uniform-length read sets with a native bundle) keeps
  the read-code matrices resident on the device as uint8 [rows, L]
  (forward rows, then reverse-complement rows); a batch ships only the
  window bytes and per-candidate (window, g0, r0, row, orient), and runs
  in one launch of the fused extension kernel (both directions, gathers
  and epilogue inside).  Under GAML_SWAR_BACKWARD=0 it stages with
  ops.extend.stage_views and runs K1 forward and dp_rows_exact backward
  (the K3 route).
- extend_staged, batch_extend_arrays, batch_extend_multi and
  batch_extend_host (explicit reads of any lengths: read sets without a
  native bundle) stage a dict with ops.extend.stage_candidates and run
  both directions in one stacked exact launch (K4, extend_kernel_exact).

Outputs (ok, errs, begin) are bit-equal to the JAX path wherever
consumed: ok everywhere, errs and begin wherever ok.
"""
from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np
import torch

from .extend import ERROR_LIMIT, K, extend_epilogue, stage_candidates, \
    stage_views
from .extend_cuda import (dp_rows_exact, extend_fused, extend_kernel_exact,
                          swar_cost, swar_cost_accept)


def extend_candidates(codes, read_len, buf, base, glen, g0, r0, row,
                      rmax: int, exact_backward: bool = False):
    """The staged route: stage (ops.extend.stage_views), run K1 forward
    and K2 backward (or dp_rows_exact backward, the K3 route), apply the
    epilogue.  Returns (ok bool, errs int32, begin int32), each [n], on
    the codes' device.  errs and begin are defined where ok."""
    fwd, bwd = stage_views(codes, read_len, buf, base, glen, g0, r0, row,
                           rmax)
    cf = swar_cost(*fwd)
    cb, ab = dp_rows_exact(*bwd) if exact_backward else \
        swar_cost_accept(*bwd)
    ok = (cf <= ERROR_LIMIT) & (cb <= ERROR_LIMIT)
    return extend_epilogue(ok, cf + cb, ab, g0, r0, g0 == 0)


def _i64(a, device):
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


class DeviceExtender:
    """Per-read-set extension engine with resident read-code matrices."""

    def __init__(self, codes_fwd: np.ndarray, codes_rc: np.ndarray,
                 device="cuda"):
        self.device = torch.device(device)
        self.L = int(codes_fwd.shape[1])
        self.n_rows = int(codes_fwd.shape[0])
        self.rmax = max(self.L - K, 1)
        both = np.ascontiguousarray(
            np.concatenate([codes_fwd, codes_rc]), dtype=np.uint8)
        self.codes = torch.as_tensor(both, device=self.device)

    def extend(self, buf, base, glen, g0, r0, rows, orient):
        """Tensor form: buf uint8 [G]; the rest int64 [n] on the device.
        Returns device tensors (ok, errs, begin): one launch of the fused
        kernel.  GAML_SWAR_BACKWARD=0 takes the staged route with the
        backward direction through dp_rows_exact (K3), as the JAX engine
        does."""
        row = rows + orient * self.n_rows
        if os.environ.get("GAML_SWAR_BACKWARD", "1") == "0":
            return extend_candidates(self.codes, torch.full_like(g0, self.L),
                                     buf, base, glen, g0, r0, row, self.rmax,
                                     exact_backward=True)
        return extend_fused(self.codes, buf,
                            *(x.to(torch.int32) for x in
                              (base, glen, g0, r0, row)), self.rmax)

    def run(self, seq_buf: np.ndarray, seq_base: np.ndarray,
            seq_lens: np.ndarray, seq_idx: np.ndarray, g0: np.ndarray,
            r0: np.ndarray, rows: np.ndarray, orient: np.ndarray,
            defer: bool = False):
        """Numpy in, numpy (ok, errs, begin) out for the N candidates;
        with ``defer`` the kernels are queued and the returned zero-arg
        closure fetches the results."""
        dev = self.device
        seq_idx = np.asarray(seq_idx, dtype=np.int64)
        out = self.extend(
            torch.as_tensor(np.ascontiguousarray(seq_buf, dtype=np.uint8),
                            device=dev),
            _i64(np.asarray(seq_base)[seq_idx], dev),
            _i64(np.asarray(seq_lens)[seq_idx], dev), _i64(g0, dev),
            _i64(r0, dev), _i64(rows, dev), _i64(orient, dev))

        def fetch():
            return tuple(t.cpu().numpy() for t in out)

        return fetch if defer else fetch()


def extend_staged(st):
    """Both directions of a staged dict in one exact launch, then the
    epilogue; numpy (ok, errs, begin) for the n real candidates."""
    n = st["n"]
    ok, errs, d_back = extend_kernel_exact(st)
    out = extend_epilogue(ok[:n], errs[:n], d_back[:n], st["g0"][:n],
                          st["r0"][:n], st["at_start"][:n])
    return tuple(t.cpu().numpy() for t in out)


def _empty():
    return (np.zeros(0, bool), np.zeros(0, np.int32), np.zeros(0, np.int32))


def batch_extend_arrays(seq: np.ndarray, g0s, r0s, reads, device="cuda"):
    """Extension of explicit (g0, r0, oriented read) candidates against
    one window (reads may differ in length).  Returns numpy (ok, errs,
    begin)."""
    if len(reads) == 0:
        return _empty()
    return extend_staged(stage_candidates(seq, g0s, r0s, reads,
                                          device=device))


def batch_extend_multi(seqs: List[np.ndarray], seq_idx, g0s, r0s, reads,
                       device="cuda"):
    """Extension across many windows in one staging and one launch:
    candidate i runs against seqs[seq_idx[i]].  Returns numpy (ok, errs,
    begin) over all candidates."""
    if len(reads) == 0:
        return _empty()
    return extend_staged(stage_candidates(seqs, g0s, r0s, reads,
                                          seq_idx=seq_idx, device=device))


def batch_extend_host(seq: np.ndarray, cands,
                      device="cuda") -> List[Tuple[bool, int, int]]:
    """The aligner's per-window form: cands is [(Candidate,
    oriented_read)]; returns [(ok, errs, begin)] aligned with cands."""
    ok, errs, begin = batch_extend_arrays(
        seq, [c.genome_pos for c, _ in cands],
        [c.read_pos for c, _ in cands], [r for _, r in cands], device)
    return list(zip(ok.tolist(), errs.tolist(), begin.tolist()))
