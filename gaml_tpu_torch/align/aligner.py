"""Subpath aligner whose device backend runs on torch.

TorchSubpathAligner overrides the device seams of
gaml_tpu.align.aligner.SubpathAligner, so that no gaml_tpu.ops (JAX)
import is reached: the device engines (ensure_device_rescorer,
ensure_device_extender), the batch entry points and the per-window
extension (_extend_all).  The first-wins (position, read) dedup per
window is the same numpy code as the JAX route's.

- With a native bundle (uniform read lengths), candidate generation and
  extension (K1/K2) run in gaml_tpu_torch.ops.  A batch whose candidate
  count exceeds the cap is redone on the device with the cap raised to
  the count (the JAX route hands it to the native aligner instead).
- Without one (mixed read lengths, e.g. quality-trimmed libraries),
  candidates come from the host index window by window, and the whole
  batch is extended in one batch_extend_multi call (one exact launch of
  both directions, K4), as in gaml_tpu/align/aligner.py:286-331.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from gaml_tpu.align.aligner import (_EMPTY_COLUMNS_ALIGNER, AlignmentColumns,
                                    SubpathAligner, gen_candidates,
                                    spell_subpath)

from ..ops.extend_device import (DeviceExtender, batch_extend_host,
                                 batch_extend_multi)
from ..ops.rescore_device import DeviceRescorer


def window_columns(ok, errs, begin, rid, orient, seg, offsets):
    """Per-window alignment columns from per-candidate results in
    emission order (grouped by window): keep ok candidates, position =
    begin + 1 + window offset, first-wins (position, read) dedup, output
    sorted by (position, read) — set<Aligment> semantics."""
    off_arr = np.asarray(offsets, dtype=np.int64)
    pos_all = begin.astype(np.int64) + 1 + off_arr[seg]
    spans = np.searchsorted(seg, np.arange(len(offsets) + 1))
    out = []
    for w in range(len(offsets)):
        a, b = int(spans[w]), int(spans[w + 1])
        m = ok[a:b]
        if not m.any():
            out.append(_EMPTY_COLUMNS_ALIGNER)
            continue
        pos_w = pos_all[a:b][m].astype(np.int32)
        rid_w = rid[a:b][m].astype(np.int32)
        ed_w = errs[a:b][m].astype(np.int32)
        or_w = orient[a:b][m].astype(np.int32)
        order = np.lexsort((np.arange(len(pos_w)), rid_w, pos_w))
        ps, rs = pos_w[order], rid_w[order]
        first = np.ones(len(ps), dtype=bool)
        first[1:] = (ps[1:] != ps[:-1]) | (rs[1:] != rs[:-1])
        sel = order[first]
        out.append(AlignmentColumns(pos_w[sel], ed_w[sel], rid_w[sel],
                                    or_w[sel]))
    return out


class TorchSubpathAligner(SubpathAligner):
    """Device-backend aligner on a torch device.  Counts the window
    batches and candidates it sends to the device."""

    def __init__(self, index, read_seqs, device="cpu"):
        super().__init__(index, read_seqs, backend="device")
        self.device = torch.device(device)
        self.device_batches = 0
        self.device_candidates = 0

    def _extend_all(self, seq: np.ndarray, cands):
        if not cands:
            return []
        return batch_extend_host(seq, cands, self.device)

    def align_subpaths_batch(self, graph, paths: List, defer: bool = False):
        bundle = getattr(self, "native_bundle", None)
        if bundle is not None:
            return self._align_subpaths_batch_native(graph, paths, bundle,
                                                     defer=defer)
        # no native bundle (mixed read lengths, trivial index): candidates
        # on the host per window, one device extension for the batch
        rl = self.index.read_len
        out: List[AlignmentColumns] = [_EMPTY_COLUMNS_ALIGNER] * len(paths)
        seqs, offsets, keep = [], [], []
        seq_idx, g0s, r0s, reads, rid, orient = [], [], [], [], [], []
        for si, path in enumerate(paths):
            seq, offset = spell_subpath(graph, path)
            if len(seq) < rl or rl == 0:
                continue
            cands = gen_candidates(self.index, self.read_seqs, seq,
                                   self._read_cache)
            for c, read in cands:
                seq_idx.append(len(seqs))
                g0s.append(c.genome_pos)
                r0s.append(c.read_pos)
                reads.append(read)
                rid.append(c.read_id)
                orient.append(c.orientation)
            keep.append(si)
            seqs.append(seq)
            offsets.append(offset)
        if reads:
            ok, errs, begin = batch_extend_multi(seqs, seq_idx, g0s, r0s,
                                                 reads, self.device)
            self.device_batches += 1
            self.device_candidates += len(reads)
            for si, cols in zip(keep, window_columns(
                    ok, errs, begin, np.asarray(rid), np.asarray(orient),
                    np.asarray(seq_idx), offsets)):
                out[si] = cols
        return (lambda: out) if defer else out

    def _align_subpaths_batch_native(self, graph, paths, bundle,
                                     defer: bool = False):
        rl = self.index.read_len
        out: List[AlignmentColumns] = [None] * len(paths)
        seqs: List[np.ndarray] = []
        offsets: List[int] = []
        keep: List[int] = []
        for si, path in enumerate(paths):
            seq, offset = spell_subpath(graph, path)
            if len(seq) < rl or rl == 0:
                out[si] = _EMPTY_COLUMNS_ALIGNER
                continue
            keep.append(si)
            seqs.append(np.ascontiguousarray(seq, dtype=np.uint8))
            offsets.append(offset)
        if not keep:
            return (lambda: out) if defer else out
        resc = self.ensure_device_rescorer()
        # the cap bounds one batch's candidate arrays on the device
        cap = max(4096, sum(len(s) for s in seqs) // 2)
        fetch = resc.extend(seqs, cap)

        def postprocess():
            res, n = fetch()
            if res is None:
                res, n = resc.extend(seqs, n)()
            self.device_batches += 1
            self.device_candidates += n
            for si, cols in zip(keep, window_columns(*res, offsets)):
                out[si] = cols
            return out

        return postprocess if defer else postprocess()

    def ensure_device_rescorer(self):
        """The candgen + extension engine; None until the native bundle
        exists."""
        resc = getattr(self, "_device_rescorer", None)
        if resc is None:
            bundle = getattr(self, "native_bundle", None)
            if bundle is None:
                return None
            resc = self._device_rescorer = DeviceRescorer(
                bundle, ext=self.ensure_device_extender(),
                device=self.device)
        return resc

    def ensure_device_extender(self):
        """The resident read-code extension engine; None until the native
        bundle exists."""
        ext = getattr(self, "_device_extender", None)
        if ext is None:
            bundle = getattr(self, "native_bundle", None)
            if bundle is None:
                return None
            ext = self._device_extender = DeviceExtender(
                bundle.codes_fwd, bundle.codes_rc, self.device)
        return ext
