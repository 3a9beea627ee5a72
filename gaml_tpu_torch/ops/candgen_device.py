"""Device candidate generation: the max-hash window query in torch.

Port of gaml_tpu/ops/candgen_device.py, same semantics (all bit-exact
against the native C++ query, tests/test_torch_candgen.py):

- GetMinHashWithPoses (graph.cc:1289-1323): slide a read-length window
  over each segment, take the max k-mer hash per window with the first
  k-mer winning ties, collapse runs of equal fingerprints;
- GetReadCandsWithPoses (graph.cc:1325-1348): the reverse-complemented
  segment is queried the same way;
- expansion through the resident fingerprint CSR with the per-read seed
  positions, emitted in the reference order: per segment, stable by read
  id over (forward hits in window order, then reverse hits).

Shapes follow the data: the run table and the candidate arrays are sized
by what the batch holds, so no table can overflow (the JAX run table could
and its retry never ended, ROADMAP C3).  Sort keys are int64 (the JAX
int32 keys overflow at 2048 segments, C2).  ``cap`` bounds the candidate
arrays a query may allocate; a larger count comes back as ``n_total``
without candidates, and a retry with cap >= n_total succeeds.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..index.maxhash import HASH_XOR, K_INDEX_KMER

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


def pack_windows(seqs: List[np.ndarray]):
    """A window batch as one 2-bit packed buffer, for the upload: (packed2
    uint8 [ceil(g_total / 4)], fixpos int64 positions of the non-ACGT
    codes, seg_base and seg_len int64 [n_seg], g_total)."""
    seg_len = np.array([len(s) for s in seqs], dtype=np.int64)
    g_total = int(seg_len.sum())
    buf = np.zeros(4 * -(-g_total // 4), dtype=np.uint8)
    if g_total:
        buf[:g_total] = np.concatenate(seqs)
    fixpos = np.flatnonzero(buf >= 4)
    c = np.where(buf < 4, buf, 0).astype(np.uint8)
    packed2 = c[0::4] | (c[1::4] << 2) | (c[2::4] << 4) | (c[3::4] << 6)
    seg_base = np.zeros(len(seqs), dtype=np.int64)
    np.cumsum(seg_len[:-1], out=seg_base[1:])
    return packed2, fixpos, seg_base, seg_len, g_total


def _shift_left(a: torch.Tensor, sh: int, fill: int) -> torch.Tensor:
    return torch.cat([a[sh:], a.new_full((sh,), fill)])


class DeviceCandGen:
    """Per-read-set candidate generator over the resident fingerprint
    index (sorted fingerprints, CSR offsets, read ids, seed positions,
    rid -> row map), built from a NativeAlignBundle's arrays."""

    def __init__(self, bundle, device="cuda"):
        dev = self.device = torch.device(device)
        self.read_len = int(bundle.read_len)
        fp = np.asarray(bundle.fp_sorted).astype(np.int64)
        off = np.asarray(bundle.fp_off).astype(np.int64)
        self.sf = torch.as_tensor(np.append(fp, _FP_PAD), device=dev)
        self.off = torch.as_tensor(np.append(off, off[-1]), device=dev)
        self.rids = torch.as_tensor(
            np.asarray(bundle.fp_rids).astype(np.int64), device=dev)
        self.seed2 = torch.as_tensor(
            np.asarray(bundle.seed_pos).astype(np.int64), device=dev)
        self.row_of = torch.as_tensor(
            np.asarray(bundle.row_of).astype(np.int64), device=dev)

    def upload(self, seqs: List[np.ndarray]):
        """Window batch -> (codes uint8 [g_total], seg_base, seg_len int64
        [n_seg]) on the device.  Ships the 2-bit packed buffer of
        pack_windows and restores the non-ACGT codes on the device."""
        dev = self.device
        packed2, fixpos, seg_base, seg_len, g_total = pack_windows(seqs)
        p2 = torch.as_tensor(packed2, device=dev).to(torch.int64)
        shifts = torch.arange(0, 8, 2, device=dev)
        codes = ((p2.unsqueeze(1) >> shifts) & 3).reshape(-1)[:g_total]
        codes[torch.as_tensor(fixpos, device=dev)] = 4
        return (codes.to(torch.uint8), torch.as_tensor(seg_base, device=dev),
                torch.as_tensor(seg_len, device=dev))

    def query(self, seqs: List[np.ndarray] = None, cap: Optional[int] = None,
              staged=None) -> Candidates:
        """Candidates of a window batch (``cap`` None: unbounded);
        ``staged``: an ``upload`` result to use instead of ``seqs``."""
        codes_u8, seg_base, seg_len = staged if staged is not None else \
            self.upload(seqs)
        dev = self.device
        g = codes_u8.shape[0]
        L = self.read_len
        w = L - K + 1  # k-mers per window
        none = Candidates(0, *(torch.zeros(0, dtype=torch.int64, device=dev)
                               for _ in range(5)), codes_u8, seg_base,
                          seg_len)
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

        def runs(buf):
            """(s, fingerprint k-mer start, CSR count, CSR start) per
            fingerprint run of valid windows."""
            v = torch.where(buf < 4, buf, 0)
            v = torch.cat([v, v.new_zeros(K)])
            h = torch.zeros_like(buf)
            for i in range(K):
                h = (h << 2) | v[i:i + g]
            h = h ^ int(HASH_XOR)
            # max over k-mer starts [s, s+w), first start wins ties: the
            # low half of the key is the complemented position
            key = (h << 32) | (_POS_MASK - j)
            size = 1
            while size * 2 <= w:
                key = torch.maximum(key, _shift_left(key, size, -1))
                size *= 2
            if size < w:
                key = torch.maximum(key, _shift_left(key, w - size, -1))
            fp = key >> 32
            prev_fp = torch.cat([fp.new_full((1,), -1), fp[:-1]])
            newrun = wv & ((pid != prev_pid) | (fp != prev_fp))
            s = torch.nonzero(newrun).squeeze(1)
            fp_c = fp[s]
            kp_c = _POS_MASK - (key[s] & _POS_MASK)
            idx = torch.searchsorted(self.sf, fp_c)
            found = self.sf[idx] == fp_c
            cnt = torch.where(found, self.off[idx + 1] - self.off[idx], 0)
            return s, kp_c, cnt, self.off[idx]

        s_f, kp_f, cnt_f, lo_f = runs(codes)
        s_r, kp_r, cnt_r, lo_r = runs(rc_codes)
        counts = torch.cat([cnt_f, cnt_r])
        n_total = int(counts.sum())
        if cap is not None and n_total > cap:
            return Candidates(n_total, None, None, None, None, None,
                              codes_u8, seg_base, seg_len)
        if n_total == 0:
            return none
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
        order = torch.sort((seg << 32) | rid, stable=True).indices
        return Candidates(n_total, rid[order], g0[order], r0[order],
                          orient[order], seg[order], codes_u8, seg_base,
                          seg_len)

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
