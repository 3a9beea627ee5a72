"""Kernel K5 (csrc/banded_forward.cu): wrapper, plain version, launch count.

K5 ``banded_forward`` replaces gaml_tpu/ops/forward_pallas.py::
banded_forward_pallas_call: the banded log-space forward DP of a batch of
long-read jobs along their guide paths, one log-probability per job.
Inputs are what the device engine keeps or ships (ops/forward_device.py):

- reads [n_rows, stride] uint8: read codes, one read per row (a read
  set's resident forward and reverse-complement rows, or a batch's dense
  rows); row [B] int32 picks each job's row;
- seq [S] uint8: the batch's walk buffer (concatenated targets);
- steps [B, rmax] uint8: guide steps, clipped to 0..2;
- c0, gstart, glen, rlen [B] int32: the guide's first column, the job's
  target extent in seq, and the read length.

A job's rows are 1 .. min(rlen, rmax, stride).  The band width is 64 or
128 on the card; the plain version takes any width.  On a CPU tensor the
wrapper runs the plain version; on a CUDA tensor it launches the kernel
or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .forward import banded_forward as _plain_forward
from .forward import banded_forward_scaled

WIDTHS = (64, 128)

# launches of the kernel by its wrapper (plain-version calls not counted)
LAUNCHES = {"banded_forward": 0}


def banded_forward_ref(reads, row, seq, steps, c0, gstart, glen, rlen,
                       log_match: float, log_mismatch: float, width: int,
                       dtype=None, scaled: bool = False):
    """Plain torch version of K5: the dense rows and guide centers of the
    jobs, then gaml_tpu_torch.ops.forward.banded_forward in ``dtype``
    (default float32), or with ``scaled`` the twin of the kernel's
    arithmetic, banded_forward_scaled (default float64, the kernel's)."""
    b, rmax = steps.shape
    k = min(rmax, reads.shape[1])
    dense = torch.full((b, rmax), 6, dtype=torch.uint8, device=reads.device)
    dense[:, :k] = reads[row.to(torch.int64), :k]
    centers = torch.cat([c0[:, None].to(torch.int64),
                         c0[:, None].to(torch.int64)
                         + torch.cumsum(steps.to(torch.int64), 1)], 1)
    args = (seq, dense, rlen.clamp(max=k), centers, gstart, glen, log_match,
            log_mismatch, rmax, width)
    if scaled:
        return banded_forward_scaled(*args, dtype=dtype or torch.float64)
    return _plain_forward(*args, dtype=dtype or torch.float32)


def _check(reads, row, seq, steps, c0, gstart, glen, rlen):
    if reads.dim() != 2 or steps.dim() != 2 or seq.dim() != 1:
        raise ValueError("reads and steps must be 2-D and seq 1-D, got "
                         f"{tuple(reads.shape)}, {tuple(steps.shape)}, "
                         f"{tuple(seq.shape)}")
    b = steps.shape[0]
    want = {"reads": (reads, torch.uint8, tuple(reads.shape)),
            "row": (row, torch.int32, (b,)),
            "seq": (seq, torch.uint8, tuple(seq.shape)),
            "steps": (steps, torch.uint8, tuple(steps.shape)),
            "c0": (c0, torch.int32, (b,)),
            "gstart": (gstart, torch.int32, (b,)),
            "glen": (glen, torch.int32, (b,)),
            "rlen": (rlen, torch.int32, (b,))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != steps.device:
            raise ValueError(f"{name} is on {t.device}, steps on "
                             f"{steps.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return b


def banded_forward(reads, row, seq, steps, c0, gstart, glen, rlen,
                   log_match: float, log_mismatch: float, width: int):
    """K5: log-probability per job, float32 [B] (-1e30 where the job has
    no rows)."""
    b = _check(reads, row, seq, steps, c0, gstart, glen, rlen)
    if steps.device.type == "cpu":
        return banded_forward_ref(reads, row, seq, steps, c0, gstart, glen,
                                  rlen, log_match, log_mismatch, width)
    if steps.device.type != "cuda":
        raise ValueError(f"unsupported device {steps.device}")
    if width not in WIDTHS:
        raise ValueError(f"the K5 kernel takes width 64 or 128, got {width}")
    out = torch.empty(b, dtype=torch.float32, device=steps.device)
    if b == 0:
        return out
    from .build import load

    lib = load()
    ptr = ctypes.c_void_p
    with torch.cuda.device(steps.device):
        stream = torch.cuda.current_stream(steps.device).cuda_stream
        err = lib.gaml_banded_forward(
            ptr(reads.data_ptr()), reads.shape[0], reads.shape[1],
            ptr(row.data_ptr()), ptr(seq.data_ptr()), seq.shape[0],
            ptr(steps.data_ptr()), steps.shape[1], ptr(c0.data_ptr()),
            ptr(gstart.data_ptr()), ptr(glen.data_ptr()),
            ptr(rlen.data_ptr()), b, width, log_match, log_mismatch,
            ptr(out.data_ptr()), ptr(stream))
    if err != 0:
        raise RuntimeError(f"banded_forward kernel launch failed: CUDA "
                           f"error {err}")
    LAUNCHES["banded_forward"] += 1
    return out
