"""Device two-direction extension: the resident engine and the batch entry
points.

Port of gaml_tpu/ops/extend_device.py and of the dispatch helpers of
gaml_tpu/ops/extend.py:

- DeviceExtender keeps a read set's codes resident on the device as uint8
  [2R, L] (forward rows, then reverse-complement rows) with each row's
  read length, for a uniform read set such as a native bundle's or one
  of mixed lengths (DeviceExtender.from_reads); a batch ships only the
  window bytes and per-candidate (window, g0, r0, row, orient) and runs
  in one launch of the exact extension (extend_exact).  The JAX engine
  runs the same function through its K1 + K2 kernels or, under
  GAML_SWAR_BACKWARD=0, dp_rows_pallas_reg_dyn (K3).
- batch_extend_arrays, batch_extend_multi and batch_extend_host extend
  explicit candidates (reads of any lengths) against windows: one read
  matrix, one window buffer, one exact launch.
- extend_staged runs a staged dict (ops.extend.stage_candidates' or the
  JAX package's) through extend_exact_staged.
- extend_candidates is the staged route that the one-launch extension
  replaced (stage_views, K1, K2, the epilogue), kept as its yardstick.

Outputs (ok, errs, begin) are bit-equal to the JAX path wherever
consumed: ok everywhere, errs and begin wherever ok.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..core.dna import _COMP_LUT
from .extend import (ERROR_LIMIT, K, SENT_READ, extend_epilogue, read_matrix,
                     stage_views, window_buffer)
from .extend_cuda import (STAGED, extend_exact, extend_exact_staged,
                          swar_cost, swar_cost_accept)


def extend_candidates(codes, read_len, buf, base, glen, g0, r0, row,
                      rmax: int):
    """The staged route: stage (ops.extend.stage_views), run K1 forward
    and K2 backward, apply the epilogue.  Returns (ok bool, errs int32,
    begin int32), each [n], on the codes' device.  errs and begin are
    defined where ok."""
    fwd, bwd = stage_views(codes, read_len, buf, base, glen, g0, r0, row,
                           rmax)
    cf = swar_cost(*fwd)
    cb, ab = swar_cost_accept(*bwd)
    ok = (cf <= ERROR_LIMIT) & (cb <= ERROR_LIMIT)
    return extend_epilogue(ok, cf + cb, ab, g0, r0, g0 == 0)


def _i32(a, device):
    return torch.as_tensor(np.asarray(a, dtype=np.int32), device=device)


def reverse_complements(mat: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Row i of ``mat`` (its first lens[i] codes) reverse-complemented,
    SENT_READ past its end: dna.revcomp of every row of a ragged read
    matrix at once."""
    src = lens[:, None] - 1 - np.arange(mat.shape[1])
    live = src >= 0
    codes = np.take_along_axis(mat, np.maximum(src, 0), axis=1)
    return np.where(live, _COMP_LUT[np.minimum(codes, 4)], SENT_READ) \
        .astype(np.uint8)


class DeviceExtender:
    """Per-read-set extension engine with resident read-code matrices."""

    def __init__(self, codes_fwd: np.ndarray, codes_rc: np.ndarray,
                 device="cuda", lens: np.ndarray = None):
        """codes_fwd/codes_rc: [R, L] uint8 read codes and their reverse
        complements, row i of each the same read; lens: each read's length
        (<= L), None for a uniform read set of length L."""
        self.device = torch.device(device)
        self.L = int(codes_fwd.shape[1])
        self.n_rows = int(codes_fwd.shape[0])
        self.rmax = max(self.L - K, 1)
        if lens is None:
            lens = np.full(self.n_rows, self.L)
        both = np.ascontiguousarray(
            np.concatenate([codes_fwd, codes_rc]), dtype=np.uint8)
        self.codes = torch.as_tensor(both, device=self.device)
        self.lens = _i32(np.concatenate([lens, lens]), self.device)

    @classmethod
    def from_reads(cls, reads, device="cuda"):
        """A read set of any read lengths: ``reads`` (code arrays) as rows
        in their order."""
        mat, lens = read_matrix(reads)
        return cls(mat, reverse_complements(mat, lens), device, lens)

    def extend(self, buf, base, glen, g0, r0, rows, orient):
        """Tensor form: buf uint8 [G]; the rest int64 [n] on the device.
        Returns device tensors (ok, errs, begin) of one exact launch."""
        meta = [x.to(torch.int32) for x in
                (base, glen, g0, r0, rows + orient * self.n_rows)]
        return extend_exact(self.codes, self.lens, buf, *meta, self.rmax)

    def run(self, seq_buf: np.ndarray, seq_base: np.ndarray,
            seq_lens: np.ndarray, seq_idx: np.ndarray, g0: np.ndarray,
            r0: np.ndarray, rows: np.ndarray, orient: np.ndarray,
            defer: bool = False):
        """Numpy in, numpy (ok, errs, begin) out for the N candidates;
        with ``defer`` the kernels are queued and the returned zero-arg
        closure fetches the results."""
        dev = self.device
        seq_idx = np.asarray(seq_idx, dtype=np.int64)

        def i64(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64), device=dev)

        out = self.extend(
            torch.as_tensor(np.ascontiguousarray(seq_buf, dtype=np.uint8),
                            device=dev),
            i64(np.asarray(seq_base)[seq_idx]),
            i64(np.asarray(seq_lens)[seq_idx]), i64(g0), i64(r0), i64(rows),
            i64(orient))

        def fetch():
            return tuple(t.cpu().numpy() for t in out)

        return fetch if defer else fetch()


def extend_staged(st):
    """Both directions of a staged dict in one exact launch, with the
    epilogue; numpy (ok, errs, begin) for the n real candidates."""
    n = st["n"]
    out = extend_exact_staged({k: torch.as_tensor(st[k]) for k in STAGED})
    return tuple(t[:n].cpu().numpy() for t in out)


def _empty():
    return (np.zeros(0, bool), np.zeros(0, np.int32), np.zeros(0, np.int32))


def batch_extend_arrays(seq: np.ndarray, g0s, r0s, reads, device="cuda"):
    """Extension of explicit (g0, r0, oriented read) candidates against
    one window, as batch_extend_multi.  Returns numpy (ok, errs, begin)."""
    return batch_extend_multi([seq], np.zeros(len(reads), np.int64), g0s,
                              r0s, reads, device)


def batch_extend_multi(seqs: List[np.ndarray], seq_idx, g0s, r0s, reads,
                       device="cuda"):
    """Extension across many windows in one launch: candidate i runs
    against seqs[seq_idx[i]] from its seed (g0s[i] in the window, r0s[i]
    in the read).  ``reads`` are the oriented reads (code arrays of any
    lengths), staged as one read matrix on ``device``.  Returns numpy
    (ok, errs, begin) over all candidates."""
    if len(reads) == 0:
        return _empty()
    dev = torch.device(device)
    mat, lens = read_matrix(reads)
    buf, seq_base, seq_lens = window_buffer(seqs)
    idx = np.asarray(seq_idx, dtype=np.int64)
    out = extend_exact(torch.as_tensor(mat, device=dev), _i32(lens, dev),
                       torch.as_tensor(buf, device=dev),
                       _i32(seq_base[idx], dev), _i32(seq_lens[idx], dev),
                       _i32(g0s, dev), _i32(r0s, dev),
                       _i32(np.arange(len(reads)), dev),
                       max(mat.shape[1] - K, 1))
    return tuple(t.cpu().numpy() for t in out)


def batch_extend_host(seq: np.ndarray, cands,
                      device="cuda") -> List[Tuple[bool, int, int]]:
    """The aligner's per-window form: cands is [(Candidate,
    oriented_read)]; returns [(ok, errs, begin)] aligned with cands."""
    ok, errs, begin = batch_extend_arrays(
        seq, [c.genome_pos for c, _ in cands],
        [c.read_pos for c, _ in cands], [r for _, r in cands], device)
    return list(zip(ok.tolist(), errs.tolist(), begin.tolist()))
