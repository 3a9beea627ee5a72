"""Subpath alignment: candidate generation + extension backend dispatch.

Mirrors the reference's internal aligner (AlignSubpathInternal,
graph.cc:839-899):

1. spell the node-window sequence, trimming long first/last nodes to the
   300 bp that can overlap a junction (offset bookkeeping, graph.cc:846-857);
2. query the max-hash index for candidate (read, signed seed pos) pairs;
3. for each candidate, locate the seed 15-mer in the (possibly
   reverse-complemented) read and run the banded extension;
4. collect alignments, dedup by (position, read_id) keeping the first
   (reference: set<Aligment> insert, graph.cc:895-897), sorted output.

The extension step is pluggable: the "bfs" backend is the exact host oracle
(align.bfs, or the native C++ aligner); the "device" backend runs the
port's torch ops on ``device`` (the CUDA kernels on a CUDA device, their
plain versions on the CPU):

- with a max-hash index, candidate generation (ops.candgen_device) and
  the exact two-direction extension run in gaml_tpu_torch.ops, one
  batch of windows at a time, over a resident index and read matrix
  built once per read set: a native bundle's for uniform read lengths,
  else the index's own CSR over a ragged read matrix (mixed read
  lengths, e.g. quality-trimmed libraries: DeviceCandGen.from_index); a
  batch whose candidate count exceeds the cap is redone on the device
  with the cap raised to the count;
- with the trivial index (no fingerprint CSR), candidates come from the
  host index window by window (gen_candidates), and the whole batch is
  extended on a resident ragged DeviceExtender of the read set
  (DeviceExtender.run): one launch of the exact extension.

The device modules (and torch) load on the first device call, so the bfs
backend runs without them.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np

from ..core import dna
from ..index.maxhash import K_INDEX_KMER, ReadIndexMaxHash
from ..utils.metrics import LAUNCHES
from . import bfs

K_MIN_SUBPATH_LENGTH = 300  # reference kMinSubpathLength (graph.cc:27)


class Alignment(NamedTuple):
    position: int
    edit_dist: int
    read_id: int
    orientation: int  # 0 = forward, 1 = reverse-complement hit


class AlignmentColumns(NamedTuple):
    """Column-array form of a sorted alignment list — the cache value type
    (native-kernel friendly; python code iterates via .tolist())."""
    position: np.ndarray   # int32
    edit_dist: np.ndarray  # int32
    read_id: np.ndarray    # int32
    orientation: np.ndarray  # int32

    def __len__(self):
        return len(self.position)

    def tuples(self) -> List[Alignment]:
        return [Alignment(p, e, r, o) for p, e, r, o in
                zip(self.position.tolist(), self.edit_dist.tolist(),
                    self.read_id.tolist(), self.orientation.tolist())]

    @staticmethod
    def from_tuples(als: List[Alignment]) -> "AlignmentColumns":
        return AlignmentColumns(
            np.array([a.position for a in als], dtype=np.int32),
            np.array([a.edit_dist for a in als], dtype=np.int32),
            np.array([a.read_id for a in als], dtype=np.int32),
            np.array([a.orientation for a in als], dtype=np.int32))

    def __eq__(self, other):
        return (isinstance(other, AlignmentColumns) and
                all(np.array_equal(a, b) for a, b in zip(self, other)))

    def __ne__(self, other):
        return not self.__eq__(other)


_EMPTY_COLUMNS_ALIGNER = AlignmentColumns(
    np.zeros(0, np.int32), np.zeros(0, np.int32),
    np.zeros(0, np.int32), np.zeros(0, np.int32))


class Candidate(NamedTuple):
    read_id: int
    genome_pos: int  # seed k-mer start in window coordinates
    read_pos: int    # seed k-mer start in (oriented) read coordinates
    orientation: int


def spell_subpath(graph, path: Sequence[int]) -> Tuple[np.ndarray, int]:
    """Window sequence + coordinate offset (graph.cc:846-857)."""
    parts = []
    offset = 0
    n = len(path)
    for i, e in enumerate(path):
        s = graph.seqs[e]
        if i == 0 and n > 1 and len(s) > K_MIN_SUBPATH_LENGTH:
            offset = len(s) - K_MIN_SUBPATH_LENGTH
            parts.append(s[offset:])
        elif i > 0 and len(s) > K_MIN_SUBPATH_LENGTH and i + 1 == n:
            parts.append(s[:K_MIN_SUBPATH_LENGTH])
        else:
            parts.append(s)
    return (np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint8)), offset


def find_seed_in_read(read: np.ndarray, seq: np.ndarray, genome_pos: int,
                      read_kmers: np.ndarray = None,
                      target_kmer: int = None) -> int:
    """First read position whose 15-mer equals the window 15-mer at
    genome_pos (reference scan, graph.cc:873-884), vectorized over packed
    k-mers."""
    from ..index.maxhash import pack_kmers

    k = K_INDEX_KMER
    if target_kmer is None:
        packed = pack_kmers(seq[genome_pos:genome_pos + k], k)
        if len(packed) == 0:
            return -1
        target_kmer = packed[0]
    kmers = read_kmers if read_kmers is not None else pack_kmers(read, k)
    if len(kmers) == 0:
        return -1
    hits = kmers == target_kmer
    idx = int(np.argmax(hits))
    return idx if hits[idx] else -1


class _ReadCache:
    """Oriented read codes + packed k-mers, cached per (read_id, orient).
    With a prebuilt uniform-length k-mer matrix (ReadSet.prepare_read_index)
    forward rows are views, the reverse matrix is one batched bit transform,
    and the seed read-positions are precomputed: with the max-hash index the
    matching k-mer is always the read's fingerprint k-mer, so the seed
    position is a per-(read, orient) constant."""

    def __init__(self, read_seqs: Dict[int, np.ndarray],
                 kmer_matrix: np.ndarray = None,
                 matrix_rids: Dict[int, int] = None):
        self.read_seqs = read_seqs
        self.kmer_matrix = kmer_matrix
        self.matrix_rids = matrix_rids or {}
        self._rc_matrix: np.ndarray = None
        self.seed_kmer_pos: np.ndarray = None  # [n_rows, 2] fwd/rc first-max
        self._cache: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]] = {}

    def build_precomputes(self) -> None:
        """Batch rc k-mer matrix + per-orientation fingerprint k-mer
        positions."""
        from ..index.maxhash import HASH_XOR, revcomp_kmers

        if self.kmer_matrix is None or self.seed_kmer_pos is not None:
            return
        fwd = self.kmer_matrix
        rc = revcomp_kmers(fwd)[:, ::-1]
        self._rc_matrix = np.ascontiguousarray(rc)
        hashes_f = fwd ^ np.uint32(HASH_XOR)
        fp = hashes_f.max(axis=1)
        target = fp ^ np.uint32(HASH_XOR)  # fingerprint k-mer value
        # the rc read matches the genome's *revcomp* of the fingerprint k-mer
        target_rc = revcomp_kmers(target)
        pos_f = np.argmax(fwd == target[:, None], axis=1)
        pos_r = np.argmax(rc == target_rc[:, None], axis=1)
        self.seed_kmer_pos = np.stack([pos_f, pos_r], axis=1).astype(np.int32)

    def seed_pos(self, rid: int, orient: int):
        """Precomputed seed read-position, or None if unavailable."""
        row = self.matrix_rids.get(rid)
        if row is None or self.seed_kmer_pos is None:
            return None
        return int(self.seed_kmer_pos[row, orient])

    def get(self, rid: int, orient: int):
        key = (rid, orient)
        hit = self._cache.get(key)
        if hit is None:
            read = self.read_seqs[rid]
            if orient:
                read = dna.revcomp(read)
            row = self.matrix_rids.get(rid)
            if self.kmer_matrix is not None and row is not None:
                kmers = self.kmer_matrix[row] if not orient else \
                    self._rc_matrix[row]
            else:
                from ..index.maxhash import pack_kmers

                kmers = pack_kmers(read, K_INDEX_KMER)
            hit = (read, kmers)
            self._cache[key] = hit
        return hit


def gen_candidates(index: ReadIndexMaxHash, read_seqs: Dict[int, np.ndarray],
                   seq: np.ndarray,
                   read_cache: "_ReadCache" = None) -> List[Tuple[Candidate, np.ndarray]]:
    """Candidates in deterministic order (read_id asc, hit order).  The
    reference iterates an unordered_map (platform-defined order) — order only
    affects which duplicate wins the (position, read_id) dedup."""
    from ..index.maxhash import ReadIndexMaxHash as _MH, pack_kmers

    # counted: the device backend runs the host candidate pass only for
    # the trivial index and align_seq, so a max-hash read set's batches
    # leave gen_candidates at 0
    LAUNCHES["gen_candidates"] += 1
    cands = index.get_read_cands_with_poses(seq)
    if not cands:
        return []
    cache = read_cache or _ReadCache(read_seqs)
    # with the max-hash index the matching k-mer is always the read's
    # fingerprint k-mer, so the seed read-position is a per-(read, orient)
    # constant (precomputed); other index kinds fall back to the scan
    use_precomputed = isinstance(index, _MH) and cache.kmer_matrix is not None
    if use_precomputed:
        cache.build_precomputes()
    seq_kmers = None
    out: List[Tuple[Candidate, np.ndarray]] = []
    for rid in sorted(cands):
        for e2 in cands[rid]:
            if e2 > 0:
                genome_pos = e2 - K_INDEX_KMER + 1
                read, kmers = cache.get(rid, 0)
                orient = 0
            else:
                genome_pos = len(seq) + e2 - 1
                read, kmers = cache.get(rid, 1)
                orient = 1
            read_pos = cache.seed_pos(rid, orient) if use_precomputed else None
            if read_pos is None:
                if seq_kmers is None:
                    seq_kmers = pack_kmers(seq)  # packed once per window
                read_pos = find_seed_in_read(read, seq, genome_pos, kmers,
                                             seq_kmers[genome_pos])
                assert read_pos != -1, "max-hash candidate without exact seed"
            out.append((Candidate(rid, genome_pos, read_pos, orient), read))
    return out


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


class SubpathAligner:
    """Alignment engine over node-window subpaths.  The device backend
    runs on ``device`` and counts the window batches and candidates it
    sends there."""

    def __init__(self, index: ReadIndexMaxHash, read_seqs: Dict[int, np.ndarray],
                 backend: str = "bfs", device="cuda"):
        self.index = index
        self.read_seqs = read_seqs
        self.backend = backend
        self.device = device
        self.device_batches = 0
        self.device_candidates = 0
        self._read_cache = _ReadCache(read_seqs)

    def _extend_all(self, seq: np.ndarray,
                    cands: List[Tuple[Candidate, np.ndarray]]):
        """Run the banded extension for every candidate; returns a list of
        (ok, errs, begin_pos) aligned with cands."""
        if self.backend == "device" and cands:
            from ..ops.extend_device import batch_extend_host

            return batch_extend_host(seq, cands, self.device)
        from ..native import get_lib

        if get_lib() is not None and cands:
            from ..native import process_hit_batch

            triples = [(c.genome_pos, c.read_pos, read) for c, read in cands]
            results = process_hit_batch(seq, triples)
            return [(False, -1, -1) if r is None else (True, r[0], r[1])
                    for r in results]
        out = []
        for cand, read in cands:
            res = bfs.process_hit(cand.genome_pos, cand.read_pos, read, seq)
            if res is None:
                out.append((False, -1, -1))
            else:
                errs, begin, _end = res
                out.append((True, errs, begin))
        return out

    def align_subpath(self, graph, path: Sequence[int]) -> List[Alignment]:
        seq, offset = spell_subpath(graph, path)
        return self.align_seq(seq, offset)

    def align_subpaths_batch(self, graph, paths: List[Sequence[int]],
                             defer: bool = False):
        """Device backend: align many subpaths in one batch on
        ``self.device``.  Returns a list of AlignmentColumns parallel to
        ``paths`` — or, with ``defer``, a zero-arg closure producing it
        after the (already queued) device work completes, so callers can
        queue several read sets' batches before blocking on any result."""
        resc = self.ensure_device_rescorer()
        if resc is not None:
            return self._align_subpaths_batch_device(graph, paths, resc,
                                                     defer=defer)
        # the trivial index: candidates on the host per window, one
        # device extension for the batch
        rl = self.index.read_len
        out: List[AlignmentColumns] = [_EMPTY_COLUMNS_ALIGNER] * len(paths)
        seqs, offsets, keep = [], [], []
        seq_idx, g0s, r0s, rid, orient = [], [], [], [], []
        for si, path in enumerate(paths):
            seq, offset = spell_subpath(graph, path)
            if len(seq) < rl or rl == 0:
                continue
            cands = gen_candidates(self.index, self.read_seqs, seq,
                                   self._read_cache)
            seq_idx += [len(seqs)] * len(cands)
            for c, _read in cands:
                g0s.append(c.genome_pos)
                r0s.append(c.read_pos)
                rid.append(c.read_id)
                orient.append(c.orientation)
            keep.append(si)
            seqs.append(seq)
            offsets.append(offset)
        if not rid:
            return (lambda: out) if defer else out
        from ..ops.extend import window_buffer

        ext, row_of = self.ensure_ragged_extender()
        rid, orient = np.asarray(rid), np.asarray(orient)
        fetch = ext.run(*window_buffer(seqs), seq_idx, g0s, r0s, row_of[rid],
                        orient, defer=True)

        def postprocess():
            ok, errs, begin = fetch()
            self.device_batches += 1
            self.device_candidates += len(rid)
            for si, cols in zip(keep, window_columns(
                    ok, errs, begin, rid, orient, np.asarray(seq_idx),
                    offsets)):
                out[si] = cols
            return out

        return postprocess if defer else postprocess()

    def ensure_ragged_extender(self):
        """The resident extension engine of a read set without a native
        bundle (reads of any lengths), built once from ``read_seqs``, and
        the row of each read id (-1 for none)."""
        if getattr(self, "_ragged_extender", None) is None:
            from ..ops.extend_device import DeviceExtender

            rids = sorted(self.read_seqs)
            row_of = np.full(max(rids, default=-1) + 1, -1, dtype=np.int64)
            row_of[rids] = np.arange(len(rids))
            self._ragged_extender = (DeviceExtender.from_reads(
                [self.read_seqs[r] for r in rids], self.device), row_of)
        return self._ragged_extender

    def _align_subpaths_batch_device(self, graph, paths, resc,
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
        """The candgen + extension engine, built once: from the native
        bundle (uniform read lengths), else, for a max-hash index, from
        the index's CSR over the ragged read matrix of
        ensure_ragged_extender (DeviceCandGen.from_index); None for the
        trivial index."""
        resc = getattr(self, "_device_rescorer", None)
        if resc is None:
            bundle = getattr(self, "native_bundle", None)
            if bundle is None and not isinstance(self.index,
                                                 ReadIndexMaxHash):
                return None
            from ..ops.rescore_device import DeviceRescorer

            if bundle is not None:
                resc = DeviceRescorer(bundle,
                                      ext=self.ensure_device_extender(),
                                      device=self.device)
            else:
                from ..ops.candgen_device import DeviceCandGen

                ext, row_of = self.ensure_ragged_extender()
                n = len(self.read_seqs)
                lens = np.zeros(len(row_of), np.int32)
                lens[np.fromiter(self.read_seqs, np.int64, n)] = np.fromiter(
                    map(len, self.read_seqs.values()), np.int64, n)
                resc = DeviceRescorer(
                    read_lens_all=lens, ext=ext, device=self.device,
                    gen=DeviceCandGen.from_index(self.index, self.read_seqs,
                                                 row_of, self.device))
            self._device_rescorer = resc
        return resc

    def ensure_device_extender(self):
        """The resident read-code extension engine; None until the native
        bundle exists."""
        ext = getattr(self, "_device_extender", None)
        if ext is None:
            bundle = getattr(self, "native_bundle", None)
            if bundle is None:
                return None
            from ..ops.extend_device import DeviceExtender

            ext = self._device_extender = DeviceExtender(
                bundle.codes_fwd, bundle.codes_rc, self.device)
        return ext

    def align_seq(self, seq: np.ndarray, offset: int = 0) -> AlignmentColumns:
        """Align all candidate reads against an arbitrary sequence; returns
        the sorted column-array form.  With the C++ bundle attached
        (ReadSet._build_native_bundle) the whole window — query, candidate
        expansion, BFS extension, dedup — runs in one native call."""
        if len(seq) < self.index.read_len or self.index.read_len == 0:
            return AlignmentColumns.from_tuples([])
        bundle = getattr(self, "native_bundle", None)
        if bundle is not None and self.backend == "bfs":
            from ..native import align_window

            pos, ed, rid, orient = align_window(bundle, seq, offset)
            return AlignmentColumns(pos, ed, rid, orient)
        cands = gen_candidates(self.index, self.read_seqs, seq,
                               self._read_cache)
        results = self._extend_all(seq, cands)
        current: Dict[Tuple[int, int], Alignment] = {}
        for (cand, _read), (ok, errs, begin) in zip(cands, results):
            if not ok:
                continue
            al = Alignment(begin + 1 + offset, errs, cand.read_id, cand.orientation)
            key = (al.position, al.read_id)
            if key not in current:  # set<Aligment>: first insert wins
                current[key] = al
        return AlignmentColumns.from_tuples(
            [current[k] for k in sorted(current)])
