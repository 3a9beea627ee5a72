"""Kernels K1-K4 and the exact two-direction extension (csrc/band_dp.cu):
wrappers, plain versions, launch counts (in utils.metrics.LAUNCHES).

K1 ``swar_cost`` replaces gaml_tpu/ops/extend_pallas.py::swar_cost_pallas
(forward direction: the d=0 cost saturated at 7).  K2
``swar_cost_accept`` replaces ::swar_cost_accept_pallas (backward
direction: that cost plus the preferred accept offset, INVALID_A where
none).  ``dp_rows_exact`` keeps the contract of K3
::dp_rows_pallas_reg_dyn, K4a ::dp_rows_pallas and K4b
::dp_rows_pallas_reg: the exact, unsaturated (cost, offset) of the start
state of one direction, on candidate-minor inputs read_t [rmax, n] uint8
(codes 0-4, sentinel 6), gwin_t [rmax + 2*PAD, n] uint8 (codes 0-4,
sentinel 8), rlen/glen [n] int32.  Unlike the TPU kernels there is no
block row bound and no layout permutation: the kernels bound rows per
candidate and take any n.

What the JAX package computes with K3/K4 (both directions of each seed
candidate and the epilogue, ::extend_kernel_pallas and
gaml_tpu/ops/score.py), and with K1 + K2 on its rescore path, is
``extend_exact``: both directions and the epilogue (ok, errs, begin) in
one launch, with the gathers inside, from a resident read-code matrix of
any read lengths and a window buffer, or ``extend_exact_staged`` on a
staged dict's candidate-major views, read where they lie.  Each launch
first orders its candidates by their row counts on the card (a counting
sort; the kernel runs them in that order and writes each result in
place).

Contract (from the JAX kernels): K1 c == min(c_exact, 7); K2 the same c
and a == a_exact wherever c_exact <= 6; dp_rows_exact c == c_exact and
a == a_exact everywhere; the two-direction entries ok everywhere, errs
and begin wherever ok (the CUDA kernels are exact everywhere).

On a CPU tensor the wrappers run the plain versions; on a CUDA tensor
they launch the kernel or raise.
"""
from __future__ import annotations

import torch

from ..utils.metrics import LAUNCHES
from .build import launch, load
from .extend import ERROR_LIMIT, PAD, dp_rows, extend_epilogue, stage_views

SAT = 7


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


def _launch(name, read_t, gwin_t, rlen, glen, outs):
    rmax, n = read_t.shape
    launch(name, read_t.device, read_t, gwin_t, rlen, glen, n, rmax, *outs)
    LAUNCHES[name] += 1


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


def extend_exact_ref(codes, lens, buf, base, glen, g0, r0, row, rmax: int):
    """Plain torch version of the exact extension (resident loader):
    ops.extend.stage_views with each candidate's read length lens[row],
    dp_rows in each direction and extend_epilogue.  Returns (ok bool, errs
    int32, begin int32), each [n]."""
    base, glen, g0, r0, row = (x.to(torch.int64)
                               for x in (base, glen, g0, r0, row))
    fwd, bwd = stage_views(codes, lens.to(torch.int64)[row], buf, base, glen,
                           g0, r0, row, rmax)
    cf, _ = dp_rows_exact_ref(*fwd)
    cb, ab = dp_rows_exact_ref(*bwd)
    ok = (cf <= ERROR_LIMIT) & (cb <= ERROR_LIMIT)
    return extend_epilogue(ok, cf + cb, ab, g0, r0, g0 == 0)


def _check_resident(codes, lens, buf, meta):
    """Input checks of the resident entry: codes uint8 [rows, L], lens
    int32 [rows], buf uint8 [G] and the int32 [n] tensors of ``meta``
    (name -> tensor), all contiguous on one device."""
    if codes.dim() != 2 or codes.dtype != torch.uint8:
        raise ValueError(f"codes must be uint8 [rows, L], got {codes.dtype} "
                         f"{tuple(codes.shape)}")
    if buf.dim() != 1 or buf.dtype != torch.uint8:
        raise ValueError(f"buf must be uint8 [G], got {buf.dtype} "
                         f"{tuple(buf.shape)}")
    n = meta["g0"].shape[0]
    want = {k: (n,) for k in meta}
    meta = dict(meta, lens=lens)
    want["lens"] = (codes.shape[0],)
    for name, t in meta.items():
        if t.dtype != torch.int32 or tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: want int32 {want[name]}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in [*meta.items(), ("codes", codes), ("buf", buf)]:
        if t.device != codes.device:
            raise ValueError(f"{name} is on {t.device}, codes on "
                             f"{codes.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if codes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {codes.device}")
    return n


def _outputs(n, device):
    return (torch.empty(n, dtype=torch.bool, device=device),
            torch.empty(n, dtype=torch.int32, device=device),
            torch.empty(n, dtype=torch.int32, device=device))


def _exact_scratch(n: int, rmax: int, device):
    """The int32 scratch of an exact launch (the candidates' order)."""
    return torch.empty(load().gaml_exact_scratch(n, rmax), dtype=torch.int32,
                       device=device)


def extend_exact(codes, lens, buf, base, glen, g0, r0, row, rmax: int):
    """The exact two-direction extension of a resident read set of any
    read lengths (K3/K4, and K1 + K2 on the rescore's path).

    codes: [rows, L] uint8 read codes (orientation folded into ``row``);
    lens: int32 [rows], each row's read length (<= L); buf: [G] uint8
    window buffer; base/glen: each candidate's window offset and length in
    buf; g0/r0: the seed start in the window and in the oriented read;
    row: its row of codes; all int32 [n].  rmax is the band's row bound
    (L - K on the rescore's path).  One launch, the candidates run in the
    order of a counting sort by their (rows_b, rows_f) on the card.
    Returns (ok bool, errs int32, begin int32), each [n]: errs and begin
    are meaningful where ok."""
    meta = {"base": base, "glen": glen, "g0": g0, "r0": r0, "row": row}
    n = _check_resident(codes, lens, buf, meta)
    if codes.device.type == "cpu":
        return extend_exact_ref(codes, lens, buf, base, glen, g0, r0, row,
                                rmax)
    out = _outputs(n, codes.device)
    if n:
        launch("extend_exact", codes.device, codes, lens, buf, base, glen,
               g0, r0, row, _exact_scratch(n, rmax, codes.device), n,
               codes.shape[1], rmax, *out)
        LAUNCHES["extend_exact"] += 1
    return out


STAGED = ("read_f", "gwin_f", "rlen_f", "glen_f", "read_b", "gwin_b",
          "rlen_b", "glen_b", "g0", "r0", "at_start")


def extend_exact_staged_ref(st):
    """Plain torch version of the exact extension on a staged dict:
    dp_rows in each direction and extend_epilogue."""
    cf, _ = dp_rows_exact_ref(st["read_f"].t(), st["gwin_f"].t(),
                              st["rlen_f"], st["glen_f"])
    cb, ab = dp_rows_exact_ref(st["read_b"].t(), st["gwin_b"].t(),
                               st["rlen_b"], st["glen_b"])
    ok = (cf <= ERROR_LIMIT) & (cb <= ERROR_LIMIT)
    return extend_epilogue(ok, cf + cb, ab, st["g0"], st["r0"],
                           st["at_start"])


def extend_exact_staged(st):
    """The exact two-direction extension of a staged dict
    (ops.extend.stage_candidates or the JAX package's, as tensors):
    candidate-major views read_f/read_b [nb, rmax] and gwin_f/gwin_b
    [nb, rmax + 2*PAD] uint8, rlen_*/glen_*/g0/r0 int32 [nb] and at_start
    bool [nb], each read where it lies.  One launch, the candidates run in
    the order of a counting sort by their (rows_b, rows_f) on the card.
    Returns (ok bool, errs int32, begin int32) over the nb candidates."""
    nb, rmax = st["read_f"].shape
    dev = st["read_f"].device
    want = {"read_f": (torch.uint8, (nb, rmax)),
            "gwin_f": (torch.uint8, (nb, rmax + 2 * PAD)),
            "at_start": (torch.bool, (nb,))}
    for name in STAGED:
        t = st[name]
        dtype, shape = want.get(name.replace("_b", "_f"),
                                (torch.int32, (nb,)))
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, read_f on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type == "cpu":
        return extend_exact_staged_ref(st)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = _outputs(nb, dev)
    if nb:
        launch("extend_exact_staged", dev, *(st[k] for k in STAGED),
               _exact_scratch(nb, rmax, dev), nb, rmax, *out)
        LAUNCHES["extend_exact_staged"] += 1
    return out
