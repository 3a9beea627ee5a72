"""Kernel K5 (csrc/banded_forward.cu) and the staging kernel that feeds it:
wrappers, plain versions, launch counts (``banded_forward`` and
``forward_stage`` in utils.metrics.LAUNCHES).

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
wrapper runs the plain version in the kernel's precision (float64, the
result rounded to float32 as the kernel returns it); on a CUDA tensor it
launches the kernel or raises.

``forward_stage`` writes K5's steps and c0 from a batch's guide centers
staged raggedly (one flat int32 buffer with per-job offsets, each job's
centers in the frame of its target); on a CPU tensor its plain version.
"""
from __future__ import annotations

import torch

from ..utils import metrics
from .build import launch
from .forward import banded_forward as _plain_forward
from .forward import banded_forward_scaled

WIDTHS = (64, 128)

# the package's one launch-count store under this module's name, which
# the benchmark's PacBio rescore reads K5's launches from
LAUNCHES = metrics.LAUNCHES


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
                                  rlen, log_match, log_mismatch, width,
                                  dtype=torch.float64).float()
    if steps.device.type != "cuda":
        raise ValueError(f"unsupported device {steps.device}")
    if width not in WIDTHS:
        raise ValueError(f"the K5 kernel takes width 64 or 128, got {width}")
    out = torch.empty(b, dtype=torch.float32, device=steps.device)
    if b == 0:
        return out
    launch("banded_forward", steps.device, reads, reads.shape[0],
           reads.shape[1], row, seq, seq.shape[0], steps, steps.shape[1], c0,
           gstart, glen, rlen, b, width, log_match, log_mismatch, out)
    LAUNCHES["banded_forward"] += 1
    return out


def forward_stage_ref(centers, offsets, gstart, rmax: int):
    """Plain torch version of the staging kernel: (steps [B, rmax] uint8,
    c0 [B] int32) of job j's centers c = centers[offsets[j]:offsets[j +
    1]]: steps[j, r] = clamp(c[r + 1] - c[r], 0, 2) for r < min(len(c) -
    1, rmax), else 0; c0[j] = c[0] + gstart[j] (gstart[j] where c is
    empty)."""
    dev = centers.device
    off = offsets.to(torch.int64)
    b = off.shape[0] - 1
    n = off[1:] - off[:-1]
    c = centers.to(torch.int64)
    steps = torch.zeros((b, rmax), dtype=torch.uint8, device=dev)
    if c.numel() > 1:
        job = torch.repeat_interleave(torch.arange(b, device=dev), n)[:-1]
        r = torch.arange(c.numel() - 1, device=dev) - off[job]
        keep = r < (n[job] - 1).clamp(max=rmax)
        steps[job[keep], r[keep]] = (c[1:] - c[:-1]).clamp(0, 2)[keep].to(
            torch.uint8)
    first = torch.zeros(b, dtype=torch.int64, device=dev)
    has = n > 0
    first[has] = c[off[:-1][has]]
    return steps, (first + gstart.to(torch.int64)).to(torch.int32)


def forward_stage(centers, offsets, gstart, rmax: int):
    """K5's (steps [B, rmax] uint8, c0 [B] int32) from the ragged centers
    (int32 [N]), their offsets (int64 [B + 1], offsets[B] = N) and the
    jobs' gstart (int32 [B]): one launch of the staging kernel on a CUDA
    tensor (rmax a multiple of 4), the plain version on a CPU one."""
    b = gstart.shape[0]
    want = {"centers": (centers, torch.int32, (centers.shape[0],)),
            "offsets": (offsets, torch.int64, (b + 1,)),
            "gstart": (gstart, torch.int32, (b,))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != gstart.device:
            raise ValueError(f"{name} is on {t.device}, gstart on "
                             f"{gstart.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if gstart.device.type == "cpu":
        return forward_stage_ref(centers, offsets, gstart, rmax)
    if gstart.device.type != "cuda":
        raise ValueError(f"unsupported device {gstart.device}")
    if rmax < 0 or rmax % 4:
        raise ValueError(f"the staging kernel takes rmax a multiple of 4, "
                         f"got {rmax}")
    steps = torch.empty((b, rmax), dtype=torch.uint8, device=gstart.device)
    c0 = torch.empty(b, dtype=torch.int32, device=gstart.device)
    if b == 0:
        return steps, c0
    launch("forward_stage", gstart.device, centers, offsets, gstart, b, rmax,
           steps, c0)
    LAUNCHES["forward_stage"] += 1
    return steps, c0
