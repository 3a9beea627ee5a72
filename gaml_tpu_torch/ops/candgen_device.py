"""Device candidate generation: the max-hash window query.

Port of gaml_tpu/ops/candgen_device.py, same semantics (all bit-exact
against the native C++ query, tests/test_torch_candgen.py).  On a card
``DeviceCandGen.query`` runs the hand-written kernels of csrc/candgen.cu
(ops/candgen_cuda.py: the runs pass, one host synchronisation, then one
block or the radix sort's passes); ``query_plain``, the same query as a
chain of torch operations, is its plain version and the CPU route.  What
both compute:

- GetMinHashWithPoses (graph.cc:1289-1323): slide a read-length window
  over each segment, take the max k-mer hash per window with the first
  k-mer winning ties, collapse runs of equal fingerprints;
- GetReadCandsWithPoses (graph.cc:1325-1348): the reverse-complemented
  segment is queried the same way;
- expansion through the resident fingerprint CSR with the per-read seed
  positions, emitted in the reference order: per segment, stable by read
  id over (forward hits in window order, then reverse hits).

The resident index comes from a NativeAlignBundle (``DeviceCandGen``:
uniform read lengths) or from a max-hash index over reads of any lengths
(``DeviceCandGen.from_index``: a quality-trimmed library, whose rows
are the ragged extension's).  Either way the seed of a candidate is a
per-(read, orientation) constant: the window's fingerprint k-mer is the
read's own.

Shapes follow the data: the run table and the candidate arrays are sized
by what the batch holds, so no table can overflow (the JAX run table could
and its retry never ended, ROADMAP C3).  Sort keys are int64 (the JAX
int32 keys overflow at 2048 segments, C2).  ``cap`` bounds the candidate
arrays a query may allocate; a larger count comes back as ``n_total``
without candidates, and a retry with cap >= n_total succeeds.
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..index.maxhash import (HASH_XOR, K_INDEX_KMER, index_csr,
                             pack_kmers_batch)
from ..utils.metrics import LAUNCHES, span
from .candgen_cuda import fp_buckets

K = K_INDEX_KMER
_POS_MASK = (1 << 32) - 1
_FP_PAD = 1 << 62  # sentinel above every 30-bit fingerprint


class Candidates(NamedTuple):
    """One query's result.  Per-candidate tensors are int64 [n_total] in
    the reference emission order; g0 is in window-local coordinates.
    ``codes`` is the batch's window buffer (uint8 [g_total]) and
    seg_base/seg_len locate each window in it."""
    n_total: int
    rid: Optional[torch.Tensor]
    g0: Optional[torch.Tensor]
    r0: Optional[torch.Tensor]
    orient: Optional[torch.Tensor]
    seg: Optional[torch.Tensor]
    codes: torch.Tensor
    seg_base: torch.Tensor
    seg_len: torch.Tensor

    @property
    def overflow(self) -> bool:
        """True when n_total exceeded the query's cap (no candidates)."""
        return self.rid is None


def _shift_left(a: torch.Tensor, sh: int, fill: int) -> torch.Tensor:
    return torch.cat([a[sh:], a.new_full((sh,), fill)])


def stage_marker(split: Optional[list], device: torch.device):
    """mark(stage): appends (stage, a CUDA event recorded now on the
    current stream, or the host clock on the CPU) to ``split``; a no-op
    when ``split`` is None.  ``stage_ms`` reads the list."""
    if split is None:
        return lambda stage: None

    def mark(stage):
        if device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            split.append((stage, ev))
        else:
            split.append((stage, time.perf_counter()))

    mark("start")
    return mark


def indexed_device(device) -> torch.device:
    """``device`` as a torch.device, a bare "cuda" given the current
    card's index: the device of the tensors made there, which the kernels'
    checks compare with."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def stage_ms(split: list) -> dict:
    """{stage: ms} of a ``split`` list filled by one or more queries (the
    same stage's spans summed), the span from the mark before each mark
    to it; synchronises on the last event."""
    out = {}
    for (_a, t0), (stage, t1) in zip(split, split[1:]):
        if stage == "start":
            continue
        if hasattr(t1, "elapsed_time"):
            t1.synchronize()
            ms = t0.elapsed_time(t1)
        else:
            ms = (t1 - t0) * 1e3
        out[stage] = out.get(stage, 0.0) + ms
    return out


def read_seeds(read_seqs: Dict[int, np.ndarray], rids: np.ndarray,
               fps: np.ndarray, n_rows: int, rows: np.ndarray) -> np.ndarray:
    """Seed positions int64 [n_rows, 2] of the reads ``rids`` (at rows
    ``rows``) whose fingerprints are ``fps``: the first k-mer of the read
    equal to its fingerprint k-mer (fps ^ HASH_XOR), and the first k-mer of
    its reverse complement equal to that k-mer's reverse complement, i.e.
    the last forward occurrence counted from the read's other end (the
    rule of find_seed_in_read and _ReadCache.build_precomputes).  One
    vectorised pass a read length; -1 where a read holds no such k-mer
    (reads shorter than K) and on rows of no read in ``rids``."""
    seed2 = np.full((n_rows, 2), -1, np.int64)
    lens = np.fromiter((len(read_seqs[r]) for r in rids.tolist()), np.int64,
                       len(rids))
    for L in np.unique(lens[lens >= K]).tolist():
        sel = np.nonzero(lens == L)[0]
        kmers = pack_kmers_batch(np.stack([read_seqs[r]
                                           for r in rids[sel].tolist()]))
        target = (fps[sel] ^ int(HASH_XOR)).astype(np.uint32)
        hit = kmers == target[:, None]
        found = hit.any(axis=1)
        seed2[rows[sel[found]], 0] = hit[found].argmax(axis=1)
        seed2[rows[sel[found]], 1] = hit[found, ::-1].argmax(axis=1)
    return seed2


class DeviceCandGen:
    """Per-read-set candidate generator over the resident fingerprint
    index (sorted fingerprints, CSR offsets, read ids, seed positions,
    rid -> row map), built from a NativeAlignBundle's arrays or, by
    ``from_index``, from a max-hash index."""

    def __init__(self, bundle, device="cuda"):
        self._place(device, bundle.read_len, np.asarray(bundle.fp_sorted),
                    np.asarray(bundle.fp_off), np.asarray(bundle.fp_rids),
                    np.asarray(bundle.seed_pos), np.asarray(bundle.row_of))

    def _place(self, device, read_len, fp, off, rids, seed2, row_of):
        """The resident arrays on ``device``, int64: ``sf`` the sorted
        fingerprints with _FP_PAD after them, ``off`` the CSR offsets
        with the last repeated, ``rids``, ``seed2`` [rows, 2] and
        ``row_of``; and the kernel's lookup table ``bucket`` (int32,
        candgen_cuda.fp_buckets)."""
        dev = self.device = indexed_device(device)
        self.read_len = int(read_len)
        fp, off = fp.astype(np.int64), off.astype(np.int64)
        self.bucket = torch.as_tensor(fp_buckets(fp), device=dev)
        self.sf = torch.as_tensor(np.append(fp, _FP_PAD), device=dev)
        self.off = torch.as_tensor(np.append(off, off[-1]), device=dev)
        self.rids, self.seed2, self.row_of = (
            torch.as_tensor(np.ascontiguousarray(a, dtype=np.int64),
                            device=dev) for a in (rids, seed2, row_of))

    @classmethod
    def from_index(cls, index, read_seqs: Dict[int, np.ndarray],
                   row_of: np.ndarray, device="cuda") -> "DeviceCandGen":
        """The generator of a read set of any read lengths: ``index`` a
        ReadIndexMaxHash (its dict as the CSR, queried at its read_len),
        ``read_seqs`` rid -> codes, ``row_of`` rid -> row of the ragged
        extension's read matrix (-1 for none), whose rows the seeds
        take.  Raises ValueError when an indexed read has no row, or no
        seed where a query could emit it: reads shorter than K sit under
        fingerprint 0 (index.maxhash.maxhash_of_reads_batch) with seed -1,
        which only a query at read_len == K can reach (a window of two or
        more k-mers has a maximum hash of 0 only if every k-mer is
        HASH_XOR's, which no two consecutive k-mers can both be)."""
        sf, off, rids = index_csr(index.index)
        row_of = np.asarray(row_of, dtype=np.int64)
        if len(rids) and (rids.max() >= len(row_of) or
                          row_of[rids].min() < 0):
            raise ValueError("an indexed read has no row in the read matrix")
        rows = row_of[rids]
        fps = np.repeat(sf, np.diff(off))
        seed2 = read_seeds(read_seqs, rids, fps,
                           int(row_of.max(initial=-1)) + 1, rows)
        bad = (seed2[rows] < 0).any(axis=1)
        if bad.any() and (index.read_len == K or fps[bad].any()):
            r = int(rids[np.nonzero(bad)[0][0]])
            raise ValueError(f"read {r} (fingerprint {int(fps[bad][0])}, "
                             f"{len(read_seqs[r])} bp) has no seed a query "
                             f"at read length {index.read_len} could emit")
        gen = cls.__new__(cls)
        gen._place(device, index.read_len, sf, off, rids, seed2, row_of)
        return gen

    def upload(self, seqs: List[np.ndarray]):
        """Window batch -> (codes uint8 [g_total], every non-ACGT code as
        4; seg_base, seg_len int64 [n_seg]) on the device: the codes and
        the segment table in one pinned host buffer, one copy that does
        not block the host.  (The JAX package packs 2 bits a code to
        spare the TPU's remote link; here that packing cost more host
        time than the copy it saved.)"""
        n = len(seqs)
        seg_len = np.fromiter((len(x) for x in seqs), np.int64, n)
        g = int(seg_len.sum())
        g8 = -(-g // 8) * 8
        host = torch.empty(g8 + 16 * n, dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        buf = host.numpy()
        if g:
            np.concatenate(seqs, out=buf[:g])
        meta = buf[g8:].view(np.int64).reshape(2, n)
        meta[1] = seg_len
        if n:
            meta[0, 0] = 0
            np.cumsum(seg_len[:-1], out=meta[0, 1:])
        dev = host.to(self.device, non_blocking=True)
        seg = dev[g8:].view(torch.int64).view(2, n)
        # clamped on the device: numpy's uint8 minimum cost more host time
        # than the copy
        return dev[:g].clamp_(max=4), seg[0], seg[1]

    def query(self, seqs: List[np.ndarray] = None, cap: Optional[int] = None,
              staged=None, split: Optional[list] = None) -> Candidates:
        """Candidates of a window batch (``cap`` None: unbounded);
        ``staged``: an ``upload`` result to use instead of ``seqs``.  On a
        CUDA device the hand-written kernels (ops.candgen_cuda, one host
        synchronisation), on the CPU ``query_plain``.  ``split``: a list
        that receives (stage, mark) at the end of each stage (a CUDA event
        on the card, a host clock reading on the CPU).  Traced as the spans
        ``candgen.upload``, ``candgen.runs`` (with the count's ``sync``)
        and ``candgen.sort``, on both routes."""
        if self.device.type == "cpu":
            return self.query_plain(seqs, cap, staged, split)
        from .candgen_cuda import query_kernel

        mark = stage_marker(split, self.device)
        with span("candgen.upload"):
            batch = staged if staged is not None else self.upload(seqs)
        mark("upload")
        return query_kernel(self, *batch, cap, mark)

    def _empty(self, codes_u8, seg_base, seg_len) -> Candidates:
        return Candidates(0, *(torch.zeros(0, dtype=torch.int64,
                                           device=self.device)
                               for _ in range(5)), codes_u8, seg_base,
                          seg_len)

    def query_plain(self, seqs: List[np.ndarray] = None,
                    cap: Optional[int] = None, staged=None,
                    split: Optional[list] = None) -> Candidates:
        """``query`` as a chain of torch operations: the kernel's plain
        version (the CPU route, and the card's yardstick).  Three host
        synchronisations on the card (two ``nonzero``, the count)."""
        # counted: on a card every query runs the kernel, so a card's main
        # path leaves query_plain at 0
        LAUNCHES["query_plain"] += 1
        mark = stage_marker(split, self.device)
        with span("candgen.upload"):
            codes_u8, seg_base, seg_len = staged if staged is not None else \
                self.upload(seqs)
        mark("upload")
        dev = self.device
        g = codes_u8.shape[0]
        L = self.read_len
        w = L - K + 1  # k-mers per window
        none = self._empty(codes_u8, seg_base, seg_len)
        if w <= 0 or g < L:
            return none
        codes = codes_u8.to(torch.int64)
        j = torch.arange(g, device=dev)
        pid = torch.repeat_interleave(
            torch.arange(len(seg_len), device=dev), seg_len, output_size=g)
        segb = seg_base[pid]
        segl = seg_len[pid]
        comp = torch.where(codes < 4, 3 - codes, codes)
        rc_codes = comp[segb + segl - 1 - (j - segb)]
        # window [s, s+L) lies inside one segment
        end = (j + L - 1).clamp(max=g - 1)
        wv = (j + L - 1 < g) & (pid[end] == pid) & (segl >= L)
        prev_pid = torch.cat([pid.new_full((1,), -1), pid[:-1]])
        mark("segments")

        def runs(buf):
            """(s, fingerprint k-mer start, CSR count, CSR start) per
            fingerprint run of valid windows."""
            v = torch.where(buf < 4, buf, 0)
            v = torch.cat([v, v.new_zeros(K)])
            h = torch.zeros_like(buf)
            for i in range(K):
                h = (h << 2) | v[i:i + g]
            h = h ^ int(HASH_XOR)
            mark("hash")
            # max over k-mer starts [s, s+w), first start wins ties: the
            # low half of the key is the complemented position
            key = (h << 32) | (_POS_MASK - j)
            size = 1
            while size * 2 <= w:
                key = torch.maximum(key, _shift_left(key, size, -1))
                size *= 2
            if size < w:
                key = torch.maximum(key, _shift_left(key, w - size, -1))
            mark("window_max")
            fp = key >> 32
            prev_fp = torch.cat([fp.new_full((1,), -1), fp[:-1]])
            newrun = wv & ((pid != prev_pid) | (fp != prev_fp))
            s = torch.nonzero(newrun).squeeze(1)
            mark("runs_nonzero")
            fp_c = fp[s]
            kp_c = _POS_MASK - (key[s] & _POS_MASK)
            idx = torch.searchsorted(self.sf, fp_c)
            found = self.sf[idx] == fp_c
            cnt = torch.where(found, self.off[idx + 1] - self.off[idx], 0)
            mark("searchsorted")
            return s, kp_c, cnt, self.off[idx]

        with span("candgen.runs"):
            s_f, kp_f, cnt_f, lo_f = runs(codes)
            s_r, kp_r, cnt_r, lo_r = runs(rc_codes)
            counts = torch.cat([cnt_f, cnt_r])
            with span("sync"):
                n_total = int(counts.sum())
        mark("count_sync")
        if cap is not None and n_total > cap:
            return Candidates(n_total, None, None, None, None, None,
                              codes_u8, seg_base, seg_len)
        if n_total == 0:
            return none
        with span("candgen.sort"):
            n_runs = counts.shape[0]
            rix = torch.repeat_interleave(torch.arange(n_runs, device=dev),
                                          counts, output_size=n_total)
            start = torch.cumsum(counts, 0) - counts
            kk = torch.arange(n_total, device=dev) - start[rix]
            rid = self.rids[torch.cat([lo_f, lo_r])[rix] + kk]
            orient = (rix >= cnt_f.shape[0]).to(torch.int64)
            s = torch.cat([s_f, s_r])[rix]
            seg = pid[s]
            loc = torch.cat([kp_f, kp_r])[rix] - seg_base[seg]
            g0 = torch.where(orient == 1, seg_len[seg] - loc - K, loc)
            r0 = self.seed2[self.row_of[rid], orient]
            mark("expand")
            order = torch.sort((seg << 32) | rid, stable=True).indices
            out = Candidates(n_total, rid[order], g0[order], r0[order],
                             orient[order], seg[order], codes_u8, seg_base,
                             seg_len)
            mark("sort")
        return out

    def query_host(self, seqs: List[np.ndarray], cap: Optional[int] = None):
        """Blocking host view for tests: a list of (rid, g0, r0, orient)
        int32 arrays per window, the native query layout.  A cap overflow
        retries once with cap = n_total."""
        c = self.query(seqs, cap)
        if c.overflow:
            c = self.query(seqs, c.n_total)
        cols = [t.cpu().numpy() for t in (c.rid, c.g0, c.r0, c.orient)]
        seg = c.seg.cpu().numpy()
        return [tuple(x[seg == i].astype(np.int32) for x in cols)
                for i in range(len(seqs))]
