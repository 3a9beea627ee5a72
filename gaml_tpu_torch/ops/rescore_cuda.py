"""The rescore's stages after the extension on the card (csrc/rescore.cu):
the wrapper, its launch counts (in utils.metrics.LAUNCHES) and the numpy
twin of its algorithm.

``score_kernel`` computes what ``rescore_device.score_plain`` computes
(the first-wins dedup of the extension's alignments, graph.cc:895-897;
their float64 sums per (job, read); the floored mean-log reduction of
each job, graph.cc:1482-1537) with two hand-written kernels and one
read-back where the torch chain has about 55 launches and three host
synchronisations: ``rescore_dedup_sums`` (a block per tile of candidates
owns the (segment, read) runs that start there and deduplicates each
longer run in a table of its own by begin, then adds the kept
alignments' probabilities into the bins) and ``rescore_reduce`` (the
floored logs summed in a fixed tree, each job's score, zero reads and the
kept count in one small buffer, copied to pinned host memory).  It
replaces the JAX package's XLA graph (gaml_tpu/ops/rescore_device.py,
gaml_tpu/ops/score.py; no Pallas kernel).

The dedup is run-local: it needs candidates in runs of equal (segment,
read), as candgen emits them.  The callers whose candidates are ordered
otherwise (ops/pair.py, parallel/) keep ops/score.py's sort.

The kernels keep state between calls in a ``Workspace`` on the rescorer
(the bins, zeroed behind the reduction; the runs' tables, cleared behind
the dedup; the kept and finished-block counters, reset by the reduction's
last block), so that a call launches nothing else.  ``score_twin`` writes
the kernels' algorithm once more in numpy, step for step, with the tile
and the reduction's widths as parameters; the CPU tests hold it to the
torch chain at tiny tiles, so that runs cross tile edges.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from ..utils.metrics import LAUNCHES, count, span
from .build import check_tiles, launch

TILE = 1024  # candidates a block of the dedup pass (kTile in rescore.cu)
REDUCE_THREADS = 256  # threads a block of the reduction (kRThreads)
REDUCE_TILE = 2048  # bins a block of the reduction (kRTile)
_EMPTY = -1  # a free table slot (kEmpty: all bits set)
_NO_IDX = 2**31 - 1  # a slot's index, unclaimed (kNoIdx)
# the constants csrc/rescore.cu must share, by their entry points
_TILES = {"rescore_tile": TILE, "rescore_reduce_tile": REDUCE_TILE,
          "rescore_reduce_threads": REDUCE_THREADS}


class Workspace:
    """What the kernels keep on the card between calls of one rescorer:
    ``bins`` float64 (all zero between calls), the runs' tables ``tkey``
    (int64, all -1) and ``tidx`` (int32, all 2^31 - 1) of two slots a
    candidate, ``ctl`` (the kept and finished-block counters, zero),
    ``part`` (the reduction's partials) and the result ``out`` with its
    pinned host copy ``host``.  Each grows to the largest call; ``clean``
    is False from a launch until the reduction behind it is queued, and a
    call that finds it False starts the arrays afresh."""

    def __init__(self, device):
        self.device = device
        self.bins = self.tkey = self.tidx = self.part = self.out = None
        self.host = self.upload = None
        self.ctl = torch.zeros(2, dtype=torch.int64, device=device)
        self.clean = True

    def ready(self, n_bins: int, n_cands: int, n_part: int, n_out: int):
        """Arrays large enough for one call, zeroed and cleared if the last
        call did not finish."""
        dev = self.device
        if not self.clean:
            for t in (self.bins, self.ctl):
                if t is not None:
                    t.zero_()
            for t, v in ((self.tkey, _EMPTY), (self.tidx, _NO_IDX)):
                if t is not None:
                    t.fill_(v)
        if self.bins is None or self.bins.shape[0] < n_bins:
            self.bins = torch.zeros(n_bins, dtype=torch.float64, device=dev)
        if n_cands and (self.tkey is None or
                        self.tkey.shape[0] < 2 * n_cands):
            size = 2 * (1 << max(n_cands - 1, 0).bit_length())
            self.tkey = torch.full((size,), _EMPTY, dtype=torch.int64,
                                   device=dev)
            self.tidx = torch.full((size,), _NO_IDX, dtype=torch.int32,
                                   device=dev)
        if self.part is None or self.part.shape[0] < n_part:
            self.part = torch.empty(n_part, dtype=torch.int64, device=dev)
        if self.out is None or self.out.shape[0] < n_out:
            self.out = torch.empty(n_out, dtype=torch.int64, device=dev)
            self.host = torch.empty(n_out, dtype=torch.int64,
                                    pin_memory=True)
        self.clean = True

    def job_map(self, seg_job, n_seg: int, log_tot: np.ndarray):
        """(job of each segment int32 [n_seg], segments past ``seg_job``'s
        end job 0; each job's log(2 total_len) float64) on the card, from
        one pinned buffer in one copy that does not block the host (the
        buffer is free again once the call has read its result)."""
        h = (n_seg + 1) // 2  # int64 words of the job map
        words = h + len(log_tot)
        if self.upload is None or self.upload.shape[0] < words:
            self.upload = torch.empty(words, dtype=torch.int64,
                                      pin_memory=True)
        buf = self.upload.numpy()[:words]
        jobs = buf[:h].view(np.int32)[:n_seg]
        jobs[:] = 0
        given = np.asarray(seg_job)[:n_seg]
        jobs[:len(given)] = given
        buf[h:].view(np.float64)[:] = log_tot
        dev = self.upload[:words].to(self.device, non_blocking=True)
        return dev[:h].view(torch.int32)[:n_seg], dev[h:].view(torch.float64)


def _check(name, t, dtype, n):
    if t.dtype != dtype or t.dim() != 1 or t.shape[0] != n or \
            not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype} [{n}], got "
                         f"{t.dtype} {tuple(t.shape)}")


def score_kernel(resc, c, ext, log_match: float, log_mismatch: float,
                 total_len, min_prob_per_base: float, min_prob_start: float,
                 seg_job=None, n_jobs: int = 1):
    """DeviceRescorer.score on a card: (scores float64 [n_jobs], zero
    reads int64 [n_jobs], alignments kept) of the candidates ``c`` and
    the extension's ``ext`` = (ok, errs, begin) (None: no candidates), by
    two launches and one read-back into ``resc``'s Workspace.  Traced as
    ``rescore.sums`` (the first launch) and ``rescore.reduce`` (the second
    and the read-back, its wait under ``sync``); counters
    ``rescore.fused`` (one a call) and ``rescore.kept``."""
    dev = resc.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n_reads, lens = resc.n_reads, resc.lens
    _check("lens", lens, torch.int32, n_reads)
    if n_jobs < 1 or n_jobs * n_reads >= 2**62:
        raise ValueError(f"{n_jobs} jobs of {n_reads} reads")
    n = c.n_total if ext is not None else 0
    if ext is not None:
        if n >= _NO_IDX:
            raise ValueError(f"{n} candidates: the tables' indices are "
                             f"below 2^31 - 1")
        for name, t, dtype in zip(("ok", "errs", "begin", "seg", "rid"),
                                  (*ext, c.seg, c.rid),
                                  (torch.bool, torch.int32, torch.int32,
                                   torch.int64, torch.int64)):
            _check(name, t, dtype, n)
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, the rescorer "
                                 f"on {dev}")
    if seg_job is None:
        tl = np.array([math.log(2 * max(int(total_len), 1))])
    else:
        tl = np.array([math.log(2 * max(int(t), 1)) for t in np.asarray(
            total_len, dtype=np.int64).reshape(-1)])
        if len(tl) != n_jobs:
            raise ValueError(f"{len(tl)} totals for {n_jobs} jobs")
    count("rescore.fused")
    check_tiles("rescore.cu", _TILES)
    ws = getattr(resc, "_score_ws", None)
    if ws is None:
        ws = resc._score_ws = Workspace(dev)
    per_job = max(-(-n_reads // REDUCE_TILE), 1)
    here = dev.index is None or dev.index == torch.cuda.current_device()
    with contextlib.nullcontext() if here else torch.cuda.device(dev):
        ws.ready(n_jobs * n_reads, n, 2 * n_jobs * per_job, 2 * n_jobs + 1)
        jobs = log_tot = None
        if seg_job is not None:
            jobs, log_tot = ws.job_map(seg_job, len(c.seg_len), tl)
        ws.clean = False
        with span("rescore.sums"):
            if n:
                ok, errs, begin = ext
                launch("rescore_dedup_sums", dev, ok, errs, begin, c.seg,
                       c.rid, lens, jobs, n, n_reads, float(log_match),
                       float(log_mismatch), ws.tkey, ws.tidx, ws.bins, ws.ctl)
                LAUNCHES["rescore_dedup_sums"] += 1
        with span("rescore.reduce"):
            launch("rescore_reduce", dev, ws.bins, lens, n_reads, n_jobs,
                   log_tot, float(tl[0]), float(min_prob_start),
                   float(min_prob_per_base), ws.part, ws.ctl, ws.out, ws.host)
            LAUNCHES["rescore_reduce"] += 1
            ws.clean = True
            with span("sync"):  # the stage's one read-back
                torch.cuda.current_stream(dev).synchronize()
            out = ws.host.numpy()[:2 * n_jobs + 1].copy()
    kept = int(out[2 * n_jobs])
    count("rescore.kept", kept)
    return out[:n_jobs].view(np.float64), out[n_jobs:2 * n_jobs], kept


# ------------------------------------------------------------ the twin
def _warp_sum(v):
    """The kernel's warp butterfly over the last axis (32 lanes): every
    lane ends with the same sum; lane 0's."""
    lanes = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lanes ^ o]
    return v[..., 0]


def _block_sum(v, threads):
    """The kernel's block_sum over the last axis (``threads`` values):
    each warp's butterfly, then one over the warps' sums, zeros past
    them."""
    w = _warp_sum(v.reshape(*v.shape[:-1], threads // 32, 32))
    pad = np.zeros((*w.shape[:-1], 32), w.dtype)
    pad[..., :w.shape[-1]] = w
    return _warp_sum(pad)


def _thread_then_block(x, per, threads):
    """Sums of ``x`` [..., m] the way a reduction block takes its share:
    blocks of per * threads values, a thread's ``per`` values (strided by
    ``threads``) in order from 0, then the block tree.  [..., blocks]."""
    tile = per * threads
    blocks = max(-(-x.shape[-1] // tile), 1)
    pad = np.zeros((*x.shape[:-1], blocks * tile), x.dtype)
    pad[..., :x.shape[-1]] = x
    pad = pad.reshape(*x.shape[:-1], blocks, per, threads)
    acc = np.zeros(pad.shape[:-2] + (threads,), x.dtype)
    for k in range(per):
        acc = acc + pad[..., k, :]
    return _block_sum(acc, threads)


def dedup_twin(seg, rid, ok, begin, tile=TILE):
    """The dedup pass's keep mask over candidates in (seg, rid) runs, the
    kernel's way: per tile of ``tile`` candidates the runs that start in
    it (the heads' positions, and the end of the last run, searched past
    the tile where it goes on); a run of one keeps its candidate if ok;
    a longer run keeps each ok candidate that holds the least index of its
    begin in the run's table."""
    n = len(seg)
    head = np.ones(n, bool)
    head[1:] = (seg[1:] != seg[:-1]) | (rid[1:] != rid[:-1])
    heads = np.nonzero(head)[0]
    keep = np.zeros(n, bool)
    for t0 in range(0, n, tile):
        tile_end = min(t0 + tile, n)
        pos = heads[(heads >= t0) & (heads < tile_end)].tolist()
        if not pos:
            continue  # inside a run an earlier tile owns
        if tile_end == n or head[tile_end]:
            pos.append(tile_end)
        else:  # the last run goes on: the block's search forward
            later = heads[heads > tile_end]
            pos.append(int(later[0]) if len(later) else n)
        for s, e in zip(pos, pos[1:]):
            if e - s == 1:
                keep[s] = ok[s]
                continue
            table = {}
            for q in range(s, e):  # the claims: the least index stays
                if ok[q]:
                    b = int(begin[q])
                    table[b] = min(table.get(b, q), q)
            for q in range(s, e):
                keep[q] = ok[q] and table[int(begin[q])] == q
    return keep


def score_twin(n_reads, lens, c, ext, log_match, log_mismatch, total_len,
               min_prob_per_base, min_prob_start, seg_job=None, n_jobs=1,
               tile=TILE, reduce_threads=REDUCE_THREADS,
               reduce_per=REDUCE_TILE // REDUCE_THREADS):
    """score_kernel's algorithm in numpy, dedup tiles of ``tile``
    candidates, reduction blocks of ``reduce_threads`` threads with
    ``reduce_per`` bins each: (scores float64 [n_jobs], zero reads int64
    [n_jobs], keep mask [n_total], bins float64 [n_jobs * n_reads])."""
    lens_np = lens.cpu().numpy().astype(np.int64)
    bins = np.zeros(n_jobs * n_reads)
    keep = np.zeros(0, bool)
    if ext is not None and c.n_total:
        ok, errs, begin = (t.cpu().numpy() for t in ext)
        seg, rid = c.seg.cpu().numpy(), c.rid.cpu().numpy()
        keep = dedup_twin(seg, rid, ok, begin, tile)
        job = np.zeros(len(c.seg_len), np.int64)
        if seg_job is not None:
            given = np.asarray(seg_job)[:len(job)]
            job[:len(given)] = given
        q = np.nonzero(keep)[0]
        e = errs[q].astype(np.float64)
        lp = e * log_mismatch + (lens_np[rid[q]] - e) * log_match
        np.add.at(bins, job[seg[q]] * n_reads + rid[q], np.exp(lp))
    tls = np.asarray(total_len, dtype=np.int64).reshape(-1)
    scores, zeros = np.zeros(n_jobs), np.zeros(n_jobs, np.int64)
    floor = min_prob_start + min_prob_per_base * lens_np.astype(np.float64)
    for j in range(n_jobs):
        p = bins[j * n_reads:(j + 1) * n_reads]
        lt = math.log(2 * max(int(tls[j if seg_job is not None else 0]), 1))
        with np.errstate(divide="ignore"):
            lp = np.where(p > 0, np.log(np.where(p > 0, p, 1.0)) - lt,
                          -np.inf)
        floored = lp < floor
        parts = _thread_then_block(np.where(floored, floor, lp), reduce_per,
                                   reduce_threads)
        total = _thread_then_block(parts, -(-len(parts) // reduce_threads),
                                   reduce_threads)
        scores[j] = total[0] / max(n_reads, 1)
        zeros[j] = int(floored.sum())
    return scores, zeros, keep, bins
