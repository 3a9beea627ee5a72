"""Device staging + two-direction extension (K1 forward, K2 backward).

Port of gaml_tpu/ops/extend_device.py.  The read-code matrices stay
resident on the device as uint8 [rows, L] (forward rows, then reverse-
complement rows); a batch ships only the window bytes and per-candidate
(window, g0, r0, row, orient).  Staging builds the kernels' candidate-
minor views with torch gathers:

- forward: the read suffix after the seed against the genome from the
  seed end;
- backward: the reversed read prefix against the reversed genome prefix
  (skipped for seeds at genome position 0, which accept iff r0 < 6 with
  r0 errors and begin -1, graph.cc:797-798).

The window buffer is padded with sentinels on both sides instead of
clamping gather indices, so windows that end near the buffer end stage
their own bytes (the JAX staging clamps, ROADMAP C1).  Outputs
(ok, errs, begin) are bit-equal to the JAX path wherever consumed: ok
everywhere, errs and begin wherever ok.
"""
from __future__ import annotations

import numpy as np
import torch

from .extend import ERROR_LIMIT, K, PAD, SENT_GEN, SENT_READ
from .extend_cuda import swar_cost, swar_cost_accept


def stage_candidates(codes, read_len, buf, base, glen, g0, r0, row,
                     rmax: int):
    """Kernel inputs for both directions, candidate-minor.

    codes: [rows, Lc] uint8 read codes; row: per-candidate row of codes
    (orientation already folded in); read_len: per-candidate read length
    (<= Lc); buf: [G] uint8 concatenated windows; base/glen: per-candidate
    window offset and length in buf; g0/r0: seed start in the window and
    in the oriented read.  All per-candidate tensors are int64 [n].
    Returns ((read_f, gwin_f, rlen_f, glen_f), (read_b, gwin_b, rlen_b,
    glen_b)) with reads [rmax, n] and windows [rmax + 2*PAD, n] uint8 and
    lengths int32 [n]."""
    dev = codes.device
    lc = codes.shape[1]
    wlen = rmax + 2 * PAD
    j = torch.arange(rmax, device=dev).unsqueeze(1)
    jj = torch.arange(wlen, device=dev).unsqueeze(1)
    flat = codes.reshape(-1)
    rowoff = row * lc
    sent = torch.full((wlen,), SENT_GEN, dtype=torch.uint8, device=dev)
    bufp = torch.cat([sent, buf, sent])  # index = buffer position + wlen

    # forward: read suffix after the seed vs genome from the seed end
    cols = r0 + K + j
    read_f = torch.where(cols < read_len,
                         flat[rowoff + cols.clamp(max=lc - 1)], SENT_READ)
    rlen_f = read_len - r0 - K
    glen_f = glen - g0 - K
    p = g0 + K - PAD + jj
    inb = (p >= 0) & (p < glen)
    gwin_f = torch.where(inb, bufp[base + p + wlen], SENT_GEN)

    # backward: reversed read prefix vs reversed genome prefix
    live = g0 > 0
    cols_b = r0 - 1 - j
    read_b = torch.where((cols_b >= 0) & live,
                         flat[rowoff + cols_b.clamp(min=0)], SENT_READ)
    rlen_b = torch.where(live, r0, 0)
    glen_b = torch.where(live, g0, 0)
    pb = g0 - 1 - (jj - PAD)
    inb_b = (jj >= PAD) & (pb >= 0) & live
    gwin_b = torch.where(inb_b, bufp[base + pb + wlen], SENT_GEN)

    def i32(x):
        return x.to(torch.int32).contiguous()

    return ((read_f.contiguous(), gwin_f.contiguous(), i32(rlen_f),
             i32(glen_f)),
            (read_b.contiguous(), gwin_b.contiguous(), i32(rlen_b),
             i32(glen_b)))


def extend_candidates(codes, read_len, buf, base, glen, g0, r0, row,
                      rmax: int):
    """Stage, run K1 (forward) and K2 (backward), apply the epilogue.
    Returns (ok bool, errs int32, begin int32), each [n], on the codes'
    device.  errs and begin are defined where ok."""
    fwd, bwd = stage_candidates(codes, read_len, buf, base, glen, g0, r0,
                                row, rmax)
    cf = swar_cost(*fwd)
    cb, ab = swar_cost_accept(*bwd)
    ok = (cf <= ERROR_LIMIT) & (cb <= ERROR_LIMIT)
    errs = (cf + cb).to(torch.int64)
    begin = g0 - r0 - ab
    at_start = g0 == 0
    ok = ok & (~at_start | (r0 < 6))
    errs = torch.where(at_start, errs + r0, errs)
    begin = torch.where(at_start, -1, begin)
    return ok, errs.to(torch.int32), begin.to(torch.int32)


def _i64(a, device):
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


class DeviceExtender:
    """Per-read-set extension engine with resident read-code matrices."""

    def __init__(self, codes_fwd: np.ndarray, codes_rc: np.ndarray,
                 device="cpu"):
        self.device = torch.device(device)
        self.L = int(codes_fwd.shape[1])
        self.n_rows = int(codes_fwd.shape[0])
        self.rmax = max(self.L - K, 1)
        both = np.ascontiguousarray(
            np.concatenate([codes_fwd, codes_rc]), dtype=np.uint8)
        self.codes = torch.as_tensor(both, device=self.device)

    def extend(self, buf, base, glen, g0, r0, rows, orient):
        """Tensor form: buf uint8 [G]; the rest int64 [n] on the device.
        Returns device tensors (ok, errs, begin)."""
        read_len = torch.full_like(g0, self.L)
        return extend_candidates(self.codes, read_len, buf, base, glen, g0,
                                 r0, rows + orient * self.n_rows, self.rmax)

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


def extend_reads(seq: np.ndarray, g0s, r0s, reads, device="cpu"):
    """Extension of explicit (g0, r0, oriented read) candidates against
    one window — the per-window aligner form (reads may differ in
    length).  Returns numpy (ok, errs, begin)."""
    dev = torch.device(device)
    n = len(reads)
    lens = np.array([len(r) for r in reads], dtype=np.int64)
    lc = int(lens.max(initial=1))
    mat = np.full((n, lc), SENT_READ, dtype=np.uint8)
    for i, r in enumerate(reads):
        mat[i, :len(r)] = r
    zero = torch.zeros(n, dtype=torch.int64, device=dev)
    out = extend_candidates(
        torch.as_tensor(mat, device=dev), _i64(lens, dev),
        torch.as_tensor(np.ascontiguousarray(seq, dtype=np.uint8),
                        device=dev),
        zero, zero + len(seq), _i64(g0s, dev), _i64(r0s, dev),
        torch.arange(n, device=dev), max(lc - K, 1))
    return tuple(t.cpu().numpy() for t in out)
