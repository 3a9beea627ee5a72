"""Plain torch version of kernel K5: the banded log-space forward DP.

Torch twin of gaml_tpu/ops/forward.py::banded_forward (the model of the
reference's AligmentProbability, graph.cc:2175-2297): the total mass of
all alignments of a read against a genome target inside a ``width``-lane
band that follows a guide path, with a free start and the mass summed
over the last read row.  Same layout as the JAX function: reads
[B, rmax] uint8, centers [B, rmax + 1] guide columns (absolute in the
genome buffer), rlens/gstarts/glens [B]; result [B].

The within-row gap chain x[o] = logaddexp(b[o], x[o-1] + gap[o]) is
solved exactly, by a Hillis-Steele scan of (gap, value) affine pairs
over ceil(log2(width)) steps (the JAX function's associative scan; the
Pallas kernel instead truncates the chain at 15 gaps).  It computes in
``dtype``, so tests can run it in float64 against the unbanded oracle
gaml_tpu.ops.forward.forward_full_numpy.  The CUDA kernel
(csrc/banded_forward.cu, wrapper ops/forward_cuda.py) computes the same
in float32.
"""
from __future__ import annotations

import torch

NEG = -1e30


def _affine_scan(gap, val):
    """Inclusive scan along dim 1 of x[o] = logaddexp(val[o], x[o-1] +
    gap[o]), x[-1] = NEG, by doubling steps over (gap, value) pairs."""
    b, w = val.shape
    k = 1
    while k < w:
        val_l = torch.cat([val.new_full((b, k), NEG), val[:, :-k]], 1)
        gap_l = torch.cat([gap.new_zeros((b, k)), gap[:, :-k]], 1)
        val = torch.logaddexp(val, val_l + gap)
        gap = gap + gap_l
        k *= 2
    return val


def banded_forward(genome, reads, rlens, centers, gstarts, glens,
                   log_match: float, log_mismatch: float, rmax: int,
                   width: int, dtype=torch.float32):
    """Log-probability [B] of each read against its target (NEG where
    rlens <= 0).  genome: [G] uint8 buffer; steps are clip(diff(centers),
    0, 2) and the band advances only while the row is <= rlen."""
    dev = reads.device
    b = reads.shape[0]
    glen_total = genome.shape[0]
    gen = genome.to(torch.int64)
    steps = torch.clamp(centers[:, 1:rmax + 1].to(torch.int64)
                        - centers[:, :rmax].to(torch.int64), 0, 2)
    rl = rlens.to(torch.int64)
    gst = gstarts.to(torch.int64)[:, None]
    gend = gst + glens.to(torch.int64)[:, None]
    offs = torch.arange(width, device=dev)
    base = centers[:, 0].to(torch.int64) - width // 2
    g = base[:, None] + offs
    m = torch.where((g >= gst) & (g < gend),
                    torch.zeros((), dtype=dtype, device=dev),
                    torch.full((), NEG, dtype=dtype, device=dev))
    neg = torch.full((), NEG, dtype=dtype, device=dev)
    lm = torch.full((), log_match, dtype=dtype, device=dev)
    lmm = torch.full((), log_mismatch, dtype=dtype, device=dev)
    n_rows = min(rmax, int(rl.max())) if b else 0
    for j in range(1, n_rows + 1):
        active = j <= rl
        delta = torch.where(active, steps[:, j - 1], 0)
        base = base + delta
        g = base[:, None] + offs
        in_t = (g >= gst) & (g < gend)
        gi = g - 1
        if glen_total:
            cw = torch.where((gi >= 0) & (gi < glen_total),
                             gen[gi.clamp(0, glen_total - 1)], 9)
        else:
            cw = torch.full_like(gi, 9)
        # previous row at lanes o + delta - 1 (diag) and o + delta (up):
        # mp[k] = m[k - 1], NEG outside the band
        mp = torch.cat([neg.expand(b, 1), m, neg.expand(b, 2)], 1)
        diag = mp.gather(1, offs + delta[:, None])
        up = mp.gather(1, offs + delta[:, None] + 1)
        rchar = reads[:, j - 1].to(torch.int64)[:, None]
        s = torch.where(cw >= 8, neg, torch.where(cw == rchar, lm, lmm))
        val = torch.where(in_t, torch.logaddexp(diag + s, up + lmm), neg)
        gap = torch.where(in_t & (cw < 8), lmm, neg)
        m = torch.where(active[:, None], _affine_scan(gap, val), m)
    out = torch.logsumexp(m, dim=1)
    return torch.where(rl > 0, out, neg)
