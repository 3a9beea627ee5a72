"""Kernels K1-K4 and the fused extension (csrc/band_dp.cu): wrappers,
plain versions, launch counts.

K1 ``swar_cost`` replaces gaml_tpu/ops/extend_pallas.py::swar_cost_pallas
(forward direction: the d=0 cost saturated at 7).  K2
``swar_cost_accept`` replaces ::swar_cost_accept_pallas (backward
direction: that cost plus the preferred accept offset, INVALID_A where
none).  ``dp_rows_exact`` replaces K3 ::dp_rows_pallas_reg_dyn, K4a
::dp_rows_pallas and K4b ::dp_rows_pallas_reg: the exact, unsaturated
(cost, offset) of the start state.  ``extend_kernel_exact`` replaces
::extend_kernel_pallas: both directions of a staged dict in one launch.
``extend_fused`` replaces K1 + K2 on the rescore's path: both directions
of each candidate of a resident read set, gathered in the kernel from the
read codes and the window buffer, and the epilogue (ok, errs, begin).
Inputs follow the JAX kernels' candidate-minor layout:
read_t [rmax, n] uint8 (codes 0-4, sentinel 6), gwin_t [rmax + 2*PAD, n]
uint8 (codes 0-4, sentinel 8), rlen/glen [n] int32.  Unlike the TPU
kernels there is no block row bound and no layout permutation: the
kernels bound rows per candidate and take any n.

Contract (from the JAX kernels): K1 c == min(c_exact, 7); K2 the same c
and a == a_exact wherever c_exact <= 6; dp_rows_exact c == c_exact and
a == a_exact everywhere.  The CUDA kernels return the exact a everywhere.

On a CPU tensor the wrappers run the plain versions; on a CUDA tensor
they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from .extend import ERROR_LIMIT, PAD, dp_rows, extend_epilogue, stage_views

SAT = 7

# launches of each kernel by its wrapper (plain-version calls not counted)
LAUNCHES = {"swar_cost": 0, "swar_cost_accept": 0, "dp_rows_exact": 0,
            "extend_fused": 0}


def dp_rows_exact_ref(read_t, gwin_t, rlen, glen):
    """Plain torch version of K3/K4: dp_rows' exact (cost, accept offset)
    of the start state d = 0."""
    rmax = read_t.shape[0]
    c, a = dp_rows(read_t.t(), rlen, gwin_t.t(), glen, rmax)
    return c[:, 3], a[:, 3]


def swar_cost_ref(read_t, gwin_t, rlen, glen):
    """Plain torch version of K1: dp_rows' d=0 cost, saturated at 7."""
    return torch.clamp(dp_rows_exact_ref(read_t, gwin_t, rlen, glen)[0],
                       max=SAT)


def swar_cost_accept_ref(read_t, gwin_t, rlen, glen):
    """Plain torch version of K2: (cost saturated at 7, accept offset)."""
    c, a = dp_rows_exact_ref(read_t, gwin_t, rlen, glen)
    return torch.clamp(c, max=SAT), a


def _check(read_t, gwin_t, rlen, glen):
    if read_t.dim() != 2:
        raise ValueError(f"read_t must be [rmax, n], got {tuple(read_t.shape)}")
    rmax, n = read_t.shape
    want = {"read_t": (read_t, torch.uint8, (rmax, n)),
            "gwin_t": (gwin_t, torch.uint8, (rmax + 2 * PAD, n)),
            "rlen": (rlen, torch.int32, (n,)),
            "glen": (glen, torch.int32, (n,))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != read_t.device:
            raise ValueError(f"{name} is on {t.device}, read_t on "
                             f"{read_t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return rmax, n


def _call(name, device, tensors, ints, outs):
    """Launch ``gaml_<name>`` on ``device``'s current stream with the
    tensors' pointers, the ints and the outputs' pointers; count it."""
    from .build import load

    lib = load()
    ptr = ctypes.c_void_p
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        args = [ptr(t.data_ptr()) for t in tensors] + list(ints)
        args += [ptr(o.data_ptr()) for o in outs]
        err = getattr(lib, "gaml_" + name)(*args, ptr(stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _launch(name, read_t, gwin_t, rlen, glen, outs):
    rmax, n = read_t.shape
    _call(name, read_t.device, (read_t, gwin_t, rlen, glen), (n, rmax), outs)


def swar_cost(read_t, gwin_t, rlen, glen):
    """K1: forward-direction cost per candidate, int32 [n] in 0..7."""
    rmax, n = _check(read_t, gwin_t, rlen, glen)
    if read_t.device.type == "cpu":
        return swar_cost_ref(read_t, gwin_t, rlen, glen)
    if read_t.device.type != "cuda":
        raise ValueError(f"unsupported device {read_t.device}")
    c = torch.empty(n, dtype=torch.int32, device=read_t.device)
    if n:
        _launch("swar_cost", read_t, gwin_t, rlen, glen, [c])
    return c


def swar_cost_accept(read_t, gwin_t, rlen, glen):
    """K2: backward-direction (cost 0..7, accept offset in -3..3 or
    INVALID_A) per candidate, both int32 [n]."""
    rmax, n = _check(read_t, gwin_t, rlen, glen)
    if read_t.device.type == "cpu":
        return swar_cost_accept_ref(read_t, gwin_t, rlen, glen)
    if read_t.device.type != "cuda":
        raise ValueError(f"unsupported device {read_t.device}")
    c = torch.empty(n, dtype=torch.int32, device=read_t.device)
    a = torch.empty(n, dtype=torch.int32, device=read_t.device)
    if n:
        _launch("swar_cost_accept", read_t, gwin_t, rlen, glen, [c, a])
    return c, a


def dp_rows_exact(read_t, gwin_t, rlen, glen):
    """K3/K4: exact (cost, accept offset) of the start state per
    candidate, both int32 [n]; the cost is at most INF."""
    rmax, n = _check(read_t, gwin_t, rlen, glen)
    if read_t.device.type == "cpu":
        return dp_rows_exact_ref(read_t, gwin_t, rlen, glen)
    if read_t.device.type != "cuda":
        raise ValueError(f"unsupported device {read_t.device}")
    c = torch.empty(n, dtype=torch.int32, device=read_t.device)
    a = torch.empty(n, dtype=torch.int32, device=read_t.device)
    if n:
        _launch("dp_rows_exact", read_t, gwin_t, rlen, glen, [c, a])
    return c, a


def extend_kernel_exact(st):
    """Both directions of a staged dict (ops.extend.stage_candidates or
    the JAX package's; candidate-major read_*/gwin_* [nb, *] uint8,
    lengths [nb]) stacked into one dp_rows_exact launch of 2*nb
    candidates, on the device of st["read_f"].  Returns (ok, errs,
    d_back) over the padded batch: ok = both costs <= ERROR_LIMIT, errs
    their sum, d_back the backward accept offset."""
    t = {k: torch.as_tensor(st[k]) for k in
         ("read_f", "gwin_f", "rlen_f", "glen_f",
          "read_b", "gwin_b", "rlen_b", "glen_b")}
    nb = t["read_f"].shape[0]
    c, a = dp_rows_exact(
        torch.cat([t["read_f"].t(), t["read_b"].t()], dim=1),
        torch.cat([t["gwin_f"].t(), t["gwin_b"].t()], dim=1),
        torch.cat([t["rlen_f"], t["rlen_b"]]).to(torch.int32),
        torch.cat([t["glen_f"], t["glen_b"]]).to(torch.int32))
    cf, cb = c[:nb], c[nb:]
    ok = (cf <= ERROR_LIMIT) & (cb <= ERROR_LIMIT)
    return ok, cf + cb, a[nb:]


def extend_fused_ref(codes, buf, base, glen, g0, r0, row, rmax: int):
    """Plain torch version of the fused extension: ops.extend.stage_views,
    dp_rows in each direction and extend_epilogue.  Returns (ok bool,
    errs int32, begin int32), each [n]."""
    i64 = [x.to(torch.int64) for x in (base, glen, g0, r0, row)]
    base, glen, g0, r0, row = i64
    read_len = torch.full_like(g0, codes.shape[1])
    fwd, bwd = stage_views(codes, read_len, buf, base, glen, g0, r0, row,
                           rmax)
    cf, _ = dp_rows_exact_ref(*fwd)
    cb, ab = dp_rows_exact_ref(*bwd)
    ok = (cf <= ERROR_LIMIT) & (cb <= ERROR_LIMIT)
    return extend_epilogue(ok, cf + cb, ab, g0, r0, g0 == 0)


def extend_fused(codes, buf, base, glen, g0, r0, row, rmax: int):
    """K1 + K2 fused: both directions of each candidate and the epilogue.

    codes: [rows, L] uint8 read codes (orientation folded into ``row``);
    buf: [G] uint8 window buffer; base/glen: each candidate's window
    offset and length in buf; g0/r0: the seed start in the window and in
    the oriented read; row: its row of codes; all int32 [n].  rmax is the
    band's row bound (L - K on the rescore's path).  Returns (ok bool,
    errs int32, begin int32), each [n]: errs and begin are meaningful
    where ok."""
    n = base.shape[0]
    meta = {"base": base, "glen": glen, "g0": g0, "r0": r0, "row": row}
    if codes.dim() != 2 or codes.dtype != torch.uint8:
        raise ValueError(f"codes must be uint8 [rows, L], got {codes.dtype} "
                         f"{tuple(codes.shape)}")
    if buf.dim() != 1 or buf.dtype != torch.uint8:
        raise ValueError(f"buf must be uint8 [G], got {buf.dtype} "
                         f"{tuple(buf.shape)}")
    for name, t in meta.items():
        if t.dtype != torch.int32 or tuple(t.shape) != (n,):
            raise ValueError(f"{name}: want int32 ({n},), got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t in [*meta.items(), ("codes", codes), ("buf", buf)]:
        if t.device != codes.device:
            raise ValueError(f"{name} is on {t.device}, codes on "
                             f"{codes.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if codes.device.type == "cpu":
        return extend_fused_ref(codes, buf, base, glen, g0, r0, row, rmax)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    dev = codes.device
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    errs = torch.empty(n, dtype=torch.int32, device=dev)
    begin = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        _call("extend_fused", dev, (codes, buf, base, glen, g0, r0, row),
              (n, codes.shape[1], rmax), (ok, errs, begin))
    return ok, errs, begin
