"""Banded short-read extension: constants, the exact torch DP, staging.

Torch twin of gaml_tpu/ops/extend.py (the reference ProcessHit 0-1 BFS,
graph.cc:753-837, collapsed into a 7-diagonal min-plus DP):

- ``dp_rows`` is _dp_rows, the exact oracle of the CUDA kernels K1-K4
  (ops.extend_cuda) and of their plain versions;
- ``extend_kernel`` is the plain two-direction DP with the JAX signature;
- ``stage_views`` builds both directions' kernel inputs with torch
  gathers from a read-code matrix and a window buffer (the one staging
  code path of the port); ``stage_candidates`` wraps it into the JAX
  package's staged dict;
- ``extend_epilogue`` turns direction costs into (ok, errs, begin).
"""
from __future__ import annotations

import numpy as np
import torch

PAD = 4          # gwin padding; diagonal drift is at most 3
BAND = 7         # offsets d in [-3, 3]
INF = 100
INVALID_A = 100  # accept offset of a cell with no preferred accept edge
ERROR_LIMIT = 3
K = 15
SENT_READ = 6    # read padding sentinel
SENT_GEN = 8     # out-of-genome sentinel (never equals any read code)


def dp_rows(read: torch.Tensor, rlen: torch.Tensor, gwin: torch.Tensor,
            glen: torch.Tensor, rmax: int):
    """Cost-to-accept DP with accept-offset propagation.

    read: [N, rmax] direction-view read codes; rlen: [N];
    gwin: [N, rmax + 2*PAD] with gwin[n, j] = genome_view[j - PAD];
    glen: [N].  Rows run from rmax-1 down to 0; rows >= rlen accept at
    cost 0.  Per row the moves are: match on the diagonal (the last
    genome char only if it ends the read), substitution, read-skip to
    d-1, and genome-skip to d+1 (relaxed 3x).  The accept offset follows
    the BFS tie-break: match keeps, then substitution, then genome-skip,
    then read-skip.  Returns (c0, a0), int32 [N, BAND] at row 0; the
    start state is d = 0 (index 3).
    """
    n = read.shape[0]
    dev = read.device
    d_off = torch.arange(-3, 4, dtype=torch.int32, device=dev)
    rlen = rlen.to(torch.int32).unsqueeze(1)
    glen = glen.to(torch.int32).unsqueeze(1)
    inf = torch.full((n, 1), INF, dtype=torch.int32, device=dev)
    invalid = torch.full((n, 1), INVALID_A, dtype=torch.int32, device=dev)
    c = torch.zeros((n, BAND), dtype=torch.int32, device=dev)
    a = d_off.expand(n, BAND).clone()
    for r in range(rmax - 1, -1, -1):
        # chars on diagonals d=-3..3 at row r: j = r + d + PAD
        chars = gwin[:, r + PAD - 3:r + PAD + 4]
        match = chars == read[:, r:r + 1]
        nomatch = ~match
        g_plus_in = (r + d_off + 1) < glen
        last_row = (r + 1) == rlen

        diag = torch.where(match & (g_plus_in | last_row), c, INF)
        sub = torch.where(nomatch & g_plus_in, c + 1, INF)
        c_dm1 = torch.cat([inf, c[:, :-1]], dim=1)
        rskip = torch.where(nomatch, c_dm1 + 1, INF)
        c_row = torch.minimum(torch.minimum(diag, sub), rskip)
        gskip_ok = nomatch & g_plus_in
        for _ in range(3):
            up = torch.cat([c_row[:, 1:], inf], dim=1)
            c_row = torch.where(gskip_ok, torch.minimum(c_row, up + 1),
                                c_row)
        in_accept = r >= rlen
        c_row = torch.where(in_accept, 0, c_row)

        take_sub = nomatch & g_plus_in & (c == c_row - 1)
        up = torch.cat([c_row[:, 1:], inf], dim=1)
        take_gskip = nomatch & ~take_sub & gskip_ok & (up == c_row - 1)
        take_rskip = nomatch & ~take_sub & ~take_gskip & \
            (c_dm1 == c_row - 1)
        a_dm1 = torch.cat([invalid, a[:, :-1]], dim=1)
        a_row = torch.where(match | take_sub, a,
                            torch.where(take_rskip, a_dm1, INVALID_A))
        for _ in range(4):
            a_up = torch.cat([a_row[:, 1:], invalid], dim=1)
            a_row = torch.where(take_gskip, a_up, a_row)
        a_row = torch.where(in_accept, d_off, a_row)
        c, a = c_row, a_row
    return c, a


def extend_kernel(read_f, rlen_f, gwin_f, glen_f, read_b, rlen_b, gwin_b,
                  glen_b, rmax: int):
    """Plain two-direction extension (gaml_tpu.ops.extend.extend_kernel)
    on candidate-major views [N, rmax] / [N, rmax + 2*PAD].  Returns (ok,
    errs, d_back): ok = both costs <= ERROR_LIMIT, errs their sum, d_back
    the backward accept offset."""
    cf, _ = dp_rows(read_f, rlen_f, gwin_f, glen_f, rmax)
    cb, ab = dp_rows(read_b, rlen_b, gwin_b, glen_b, rmax)
    ok = (cf[:, 3] <= ERROR_LIMIT) & (cb[:, 3] <= ERROR_LIMIT)
    return ok, cf[:, 3] + cb[:, 3], ab[:, 3]


def extend_epilogue(ok, errs, d_back, g0, r0, at_start):
    """begin = g0 - r0 - d_back, and the genome-start rule: a seed at
    genome position 0 (``at_start``) accepts iff r0 < 6, with r0 more
    errors and begin -1 (graph.cc:797-798).  Returns (ok, errs, begin),
    int32 where not bool."""
    begin = g0 - r0 - d_back
    ok = ok & (~at_start | (r0 < 6))
    errs = torch.where(at_start, errs + r0, errs)
    begin = torch.where(at_start, -1, begin)
    return ok, errs.to(torch.int32), begin.to(torch.int32)


def stage_views(codes, read_len, buf, base, glen, g0, r0, row, rmax: int):
    """Kernel inputs for both directions, candidate-minor.

    codes: [rows, Lc] uint8 read codes; row: per-candidate row of codes
    (orientation already folded in); read_len: per-candidate read length
    (<= Lc); buf: [G] uint8 concatenated windows; base/glen: per-candidate
    window offset and length in buf; g0/r0: seed start in the window and
    in the oriented read.  All per-candidate tensors are int64 [n].
    Returns ((read_f, gwin_f, rlen_f, glen_f), (read_b, gwin_b, rlen_b,
    glen_b)) with reads [rmax, n] and windows [rmax + 2*PAD, n] uint8 and
    lengths int32 [n]:

    - forward: the read suffix after the seed against the genome from the
      seed end;
    - backward: the reversed read prefix against the reversed genome
      prefix (empty for seeds at genome position 0).

    The window buffer is padded with sentinels on both sides instead of
    clamping gather indices, so windows that end near the buffer end
    stage their own bytes (the JAX device staging clamps, ROADMAP C1)."""
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


def stage_candidates(seq, g0s, r0s, reads, rmax: int = None,
                     nb: int = None, read_ids=None, seq_idx=None,
                     device="cuda"):
    """The JAX package's staged dict (gaml_tpu.ops.extend.
    stage_candidates) as torch tensors on ``device``, built by
    stage_views.

    ``seq`` is one genome window shared by all candidates, or a list of
    windows with per-candidate ``seq_idx``; ``reads`` are the oriented
    reads (any lengths).  rmax defaults to the rows the candidates need
    and nb to n (the JAX package rounds both up for the TPU's tiles; pass
    them to match its shapes).  Views are candidate-major like the JAX
    dict's: read_* [nb, rmax] and gwin_* [nb, rmax + 2*PAD] uint8,
    padding rows sentinel-filled with zero lengths."""
    dev = torch.device(device)
    n = len(reads)
    seqs = list(seq) if seq_idx is not None else [seq]
    idx = np.asarray(seq_idx if seq_idx is not None else np.zeros(n),
                     dtype=np.int64)
    g0s = np.asarray(g0s, dtype=np.int64)
    r0s = np.asarray(r0s, dtype=np.int64)
    rlens = np.array([len(r) for r in reads], dtype=np.int64)
    if rmax is None:
        rmax = max(int((rlens - r0s - K).max(initial=1)),
                   int(r0s.max(initial=1)), 1)
    nb = n if nb is None else nb
    mat = np.full((n, int(rlens.max(initial=1))), SENT_READ, dtype=np.uint8)
    for i, r in enumerate(reads):
        mat[i, :len(r)] = r
    seq_lens = np.array([len(s) for s in seqs], dtype=np.int64)
    seq_base = np.zeros(len(seqs), dtype=np.int64)
    np.cumsum(seq_lens[:-1], out=seq_base[1:])
    buf = np.concatenate([np.asarray(s, dtype=np.uint8) for s in seqs])

    def t(x):
        return torch.as_tensor(x, device=dev)

    g0, r0 = t(g0s), t(r0s)
    views = stage_views(t(mat), t(rlens), t(buf), t(seq_base[idx]),
                        t(seq_lens[idx]), g0, r0,
                        torch.arange(n, device=dev), rmax)

    def pad(x, fill):
        out = torch.full((nb,) + x.shape[1:], fill, dtype=x.dtype,
                         device=dev)
        out[:n] = x
        return out

    st = {}
    for sfx, (read, gwin, rlen, glen) in zip("fb", views):
        st["read_" + sfx] = pad(read.t(), SENT_READ)
        st["gwin_" + sfx] = pad(gwin.t(), SENT_GEN)
        st["rlen_" + sfx] = pad(rlen, 0)
        st["glen_" + sfx] = pad(glen, 0)
    i32 = torch.int32
    rid = t(np.zeros(n) if read_ids is None else np.asarray(read_ids))
    st.update(g0=pad(g0.to(i32), 0), r0=pad(r0.to(i32), 0),
              read_len=pad(t(rlens).to(i32), 0),
              valid=pad(torch.ones(n, dtype=torch.bool, device=dev), False),
              read_id=pad(rid.to(i32), 0), rmax=rmax, n=n)
    st["at_start"] = (st["g0"] == 0) & (n > 0)  # padding too, as in JAX
    return st
