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
in scaled linear space (float64 probabilities with a per-job binary
exponent): ``banded_forward_scaled`` is the CPU twin of that arithmetic,
which the tests hold against this function in float64, against the
oracle and against the JAX function.
"""
from __future__ import annotations

import math

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


def _linear_scan(gap, val):
    """Inclusive scan along dim 1 of x[o] = val[o] + gap[o] x[o-1],
    x[-1] = 0, by doubling steps over (factor, value) pairs."""
    b, w = val.shape
    k = 1
    while k < w:
        val_l = torch.cat([val.new_zeros((b, k)), val[:, :-k]], 1)
        gap_l = torch.cat([gap.new_ones((b, k)), gap[:, :-k]], 1)
        val = val + gap * val_l
        gap = gap * gap_l
        k *= 2
    return val


def _rows(genome, reads, rlens, centers, gstarts, glens, rmax, width):
    """Per band row j = 1 .. n: (active [B], in_t, cw, read char [B, 1],
    the offsets of the previous row's diag and up lanes [B, W]), the
    geometry shared by both forms."""
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
    n_rows = min(rmax, int(rl.max())) if b else 0
    for j in range(1, n_rows + 1):
        active = j <= rl
        delta = torch.where(active, steps[:, j - 1], 0)
        base = base + delta
        g = base[:, None] + offs
        gi = g - 1
        if glen_total:
            cw = torch.where((gi >= 0) & (gi < glen_total),
                             gen[gi.clamp(0, glen_total - 1)], 9)
        else:
            cw = torch.full_like(gi, 9)
        # previous row at lanes o + delta - 1 (diag) and o + delta (up),
        # as indices into it padded by one lane left and two right
        diag = offs + delta[:, None]
        yield (active, (g >= gst) & (g < gend), cw,
               reads[:, j - 1].to(torch.int64)[:, None], diag, diag + 1)


def _first_row(centers, gstarts, glens, width):
    """[B, W] bool: band lanes of row 0 inside the target."""
    offs = torch.arange(width, device=centers.device)
    g = (centers[:, 0].to(torch.int64) - width // 2)[:, None] + offs
    gst = gstarts.to(torch.int64)[:, None]
    return (g >= gst) & (g < gst + glens.to(torch.int64)[:, None])


def banded_forward(genome, reads, rlens, centers, gstarts, glens,
                   log_match: float, log_mismatch: float, rmax: int,
                   width: int, dtype=torch.float32):
    """Log-probability [B] of each read against its target (NEG where
    rlens <= 0).  genome: [G] uint8 buffer; steps are clip(diff(centers),
    0, 2) and the band advances only while the row is <= rlen."""
    dev = reads.device
    b = reads.shape[0]
    neg = torch.full((), NEG, dtype=dtype, device=dev)
    lm = torch.full((), log_match, dtype=dtype, device=dev)
    lmm = torch.full((), log_mismatch, dtype=dtype, device=dev)
    m = torch.where(_first_row(centers, gstarts, glens, width),
                    torch.zeros((), dtype=dtype, device=dev), neg)
    for active, in_t, cw, rchar, diag, up in _rows(
            genome, reads, rlens, centers, gstarts, glens, rmax, width):
        mp = torch.cat([neg.expand(b, 1), m, neg.expand(b, 2)], 1)
        s = torch.where(cw >= 8, neg, torch.where(cw == rchar, lm, lmm))
        val = torch.where(in_t, torch.logaddexp(mp.gather(1, diag) + s,
                                                mp.gather(1, up) + lmm), neg)
        gap = torch.where(in_t & (cw < 8), lmm, neg)
        m = torch.where(active[:, None], _affine_scan(gap, val), m)
    out = torch.logsumexp(m, dim=1)
    return torch.where(rlens.to(torch.int64) > 0, out, neg)


def banded_forward_scaled(genome, reads, rlens, centers, gstarts, glens,
                          log_match: float, log_mismatch: float, rmax: int,
                          width: int, dtype=torch.float64):
    """``banded_forward`` in the CUDA kernel's arithmetic: ``dtype``
    (float64 as the kernel; float32 shows why not) probabilities
    p = exp(m - E ln 2) with one integer exponent E per job,
    start 1 inside the target; per row b = diag S + up PMM, the chain
    x = b + G x_prev; after every 32nd row of a job (the kernel's
    kRenormRows) its lanes are scaled by 2^(bias - ex), ex the exponent
    field of their max, and E grows by ex - bias (the scale taken from a
    row applies to the next; power-of-two scaling is linear and exact).
    Result log(sum of
    the last row) + E ln 2, NEG where rlens <= 0 or the sum is 0.  For
    tests and chip_smoke.py; the log-space function stays the kernel's
    reference."""
    dev = reads.device
    b = reads.shape[0]
    # the float format's exponent bits: (mantissa bits, bias, int type)
    mant, bias, ity = {torch.float32: (23, 127, torch.int32),
                       torch.float64: (52, 1023, torch.int64)}[dtype]
    pm = torch.exp(torch.tensor(log_match, dtype=dtype, device=dev))
    pmm = torch.exp(torch.tensor(log_mismatch, dtype=dtype, device=dev))
    zero = torch.zeros((), dtype=dtype, device=dev)
    p = _first_row(centers, gstarts, glens, width).to(dtype)
    e = torch.zeros(b, dtype=torch.int64, device=dev)
    # a renormalisation's exponent field, taken from a row's max and
    # applied to the job's next row (or after its last), as the kernel
    # does to keep the warp reduction off its row chain
    ex = torch.full((b,), bias, dtype=torch.int64, device=dev)
    pending = torch.zeros(b, dtype=torch.bool, device=dev)

    def scale(x, where):
        sc = ((2 * bias - ex) << mant).to(ity).view(dtype)
        return (torch.where(where[:, None], x * sc[:, None], x),
                torch.where(where, e + ex - bias, e))

    for j, (active, in_t, cw, rchar, diag, up) in enumerate(_rows(
            genome, reads, rlens, centers, gstarts, glens, rmax, width), 1):
        pp = torch.cat([zero.expand(b, 1), p, zero.expand(b, 2)], 1)
        s = torch.where(cw >= 8, zero, torch.where(cw == rchar, pm, pmm))
        val = torch.where(in_t, pp.gather(1, diag) * s
                          + pp.gather(1, up) * pmm, zero)
        gap = torch.where(in_t & (cw < 8), pmm, zero)
        x, e = scale(_linear_scan(gap, val), active & pending)
        pending = pending & ~active
        p = torch.where(active[:, None], x, p)
        if j % 32 == 0:
            ex = torch.where(active, (p.amax(1).view(ity) >> mant)
                             .to(torch.int64), ex)
            pending = pending | active
    p, e = scale(p, pending)
    total = p.sum(1)
    out = torch.log(total).double() + e.double() * math.log(2.0)
    return torch.where((rlens.to(torch.int64) > 0) & (total > 0),
                       out.float(), torch.full((), NEG, device=dev))
