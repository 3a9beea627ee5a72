"""PacBio (long-read) read set.

Replaces the reference's BLASR subprocess pipeline (graph.h:444-593,
graph.cc:2299-3038) with the internal minimizer-chain aligner
(align.longread) and the banded log-space forward kernel (ops.forward):

- anchors: every graph node >= 80 bp is k-mer-indexed in one concatenated
  buffer; each read is scanned once and chained per (node, strand); chains
  whose projected extent covers the node start/end within 10 bp populate
  anchors_begin/anchors_end (reference ComputeAnchors semantics,
  graph.cc:2505-2576);
- walk scoring: reads filtered by anchors on the walk's nodes are chained
  against the spelled walk; each chain's guide band is integrated by the
  forward DP into an alignment log-probability, cached per node-window
  subpath exactly like the reference cache (graph.cc:2724-2785);
- gap estimation between two flanking nodes from one spanning read
  (reference GetGap, graph.cc:2578-2648).

Probabilities use the reference model (match/mismatch/indel =
match_prob/mismatch_prob, free start, full-read consumption); band
construction is internal instead of BLASR CIGARs, so values are
semantically equivalent rather than bit-identical (SURVEY.md section 7,
"Banded DP on TPU").

The forward DP of a batch is routed by its size in DP cells (sum of read
lengths x band width): below GAML_PB_DEVICE_MIN_CELLS to the native host
kernel (float64), where it is built; otherwise to the port's engine on
the read set's ``device`` (ops/forward_device.py: the CUDA kernel on a
CUDA device, its plain torch version on the CPU).  Every route runs at
the read set's own ``forward_width``.  Cells are counted in ``dp_cells``
under "cuda", "torch" and "native".  With ``forward_dispatch`` set on
the read set (ProbCalculator.enable_sharded_pacbio, the JAX package's
mesh forward) every batch, whatever its size, runs on the same engine and
its cells count under "mesh", as in the JAX package.

The seed lookup of a precompute's ranges is routed by the same device:
on a CUDA device whose engine holds the resident read rows, every
(range, read, strand) query of the batch runs in the seed kernels
(ops/seeds_device.py, csrc/seeds.cu), read from those rows; on the CPU,
or where the rows are staged densely, each range runs through its host
index (align/longread.py::SortedKmerIndex).  Both give the same hits.
"""
from __future__ import annotations

import os
import pickle
import sys
from typing import Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from ..align.longread import SEED_K, align_long_read, chain_hits, guide_path
from ..core import dna
from ..core.io import iter_fastq
from ..ops.forward_device import ForwardDeviceEngine
from ..utils.metrics import count, span

K_MIN_ANCHOR_LEN = 80  # reference kMinAnchorLen (graph.cc:31)

# GAML_PB_DEVICE_MIN_CELLS default: the native-vs-card crossover in DP
# cells, measured by chip_smoke.py phase 6 (two runs in one call) on an
# NVIDIA H100 80GB HBM3 (700 W) against the native kernel on its host's
# 8 cores: one job of 128 bases
# at width 64 (8192 cells) took 0.42 / 0.56 ms native and 0.58 / 0.58 ms
# on the card, one of 256 bases (16384 cells) 0.65 / 1.04 ms and 0.60 /
# 0.64 ms, one of 1024 bases 1.85 / 2.68 ms and 0.89 / 1.07 ms
DEVICE_MIN_CELLS = 16384
RESIDENT_MAX = 4_000_000_000  # GAML_PB_RESIDENT_MAX default, bytes


def job_arrays(seq, jobs, extents):
    """The arrays of one forward-DP batch: rmax
    (the longest job rounded up to 128), reads [b, rmax] uint8 padded with
    6, rlens, centers [b, rmax + 1] (the last center repeated), the
    targets' gstarts/glens (default: the whole buffer) and each job's
    (rid, strand), rid -1 where the job has none."""
    rmax = max(len(j[0]) for j in jobs)
    rmax = ((rmax + 127) // 128) * 128
    b = len(jobs)
    reads = np.full((b, rmax), 6, dtype=np.uint8)
    rlens = np.zeros(b, dtype=np.int32)
    centers = np.zeros((b, rmax + 1), dtype=np.int32)
    job_rid = np.full(b, -1, dtype=np.int32)
    job_strand = np.zeros(b, dtype=np.uint8)
    for i, (r, c, *extra) in enumerate(jobs):
        reads[i, :len(r)] = r
        rlens[i] = len(r)
        centers[i, :len(c)] = c
        centers[i, len(c):] = c[-1]
        if extra:
            job_rid[i] = extra[0]
            job_strand[i] = extra[1]
    if extents is None:
        gstarts = np.zeros(b, dtype=np.int32)
        glens = np.full(b, len(seq), dtype=np.int32)
    else:
        gstarts = np.array([e[0] for e in extents], dtype=np.int32)
        glens = np.array([e[1] for e in extents], dtype=np.int32)
    return rmax, reads, rlens, centers, gstarts, glens, job_rid, job_strand


def walk_bounds(graph, path) -> Tuple[List[int], List[int]]:
    """Each entry's begin and end in the spelled walk (a gap entry -g
    spans g bases)."""
    begins, ends = [], []
    pos = 0
    for e in path:
        begins.append(pos)
        pos += -e if e < 0 else graph.node_len(e)
        ends.append(pos)
    return begins, ends


def merge_ranges(missing) -> List[Tuple[int, int]]:
    """Overlapping missing (i, j) windows merged into ranges (reference
    graph.cc:2456-2476)."""
    ranges = []
    last_end = -47
    last_begin = -47
    for a, b in sorted(missing):
        if a > last_end:
            if last_end != -47:
                ranges.append((last_begin, last_end))
            last_begin, last_end = a, b
        last_end = max(last_end, b)
    if last_end != -47:
        ranges.append((last_begin, last_end))
    return ranges


class PacbioAlignment(NamedTuple):
    position: int
    position_end: int
    read_id: int
    logprob: float


class PacbioReadSet:
    def __init__(self, name: str, filename: str, match_prob: float,
                 mismatch_prob: float, forward_width: int = 64,
                 device="cuda"):
        self.name = name
        self.filename = filename
        self.match_prob = match_prob
        self.mismatch_prob = mismatch_prob
        self.min_match_prob = 1 - 2 * (1 - match_prob)
        self.forward_width = forward_width
        self.device = torch.device(device)

        self.reads_num = 0
        self.read_map: Dict[str, int] = {}
        self.read_map_inv: Dict[int, str] = {}
        self.read_seq: List[np.ndarray] = []
        self.read_lens: List[int] = []
        self.max_read_len = 0
        self.load_success = False

        self.aligment_cache: Dict[Tuple[int, ...], List[PacbioAlignment]] = {}
        self.anchors_cache: Dict[int, Set[int]] = {}
        self.anchors_begin: Dict[int, Set[int]] = {}
        self.anchors_end: Dict[int, Set[int]] = {}
        self.anchors_reverse: Dict[int, Set[int]] = {}
        self.positions2: List[List[Tuple[Tuple[int, int], float]]] = []

    # ------------------------------------------------------------- ingestion
    def get_read_id(self, name: str) -> int:
        if name not in self.read_map:
            assert not self.load_success, f"missing read {name}"
            rid = self.reads_num
            self.read_map[name] = rid
            self.read_map_inv[rid] = name
            self.reads_num += 1
            self.read_lens.append(0)
            self.read_seq.append(np.zeros(0, dtype=np.uint8))
        return self.read_map[name]

    def preprocess_reads(self) -> None:
        """Reference graph.cc:1417-1441 (native FASTQ parser when built)."""
        if self.load_success:
            return
        from ..native import read_fastq_arrays

        res = read_fastq_arrays(self.filename)
        if res is None:
            items = ((name, dna.encode_seq(seq))
                     for name, seq in iter_fastq(self.filename))
        else:
            buf, off, names = res
            items = ((names[i], buf[off[i]:off[i + 1]])
                     for i in range(len(names)))
        for name, codes in items:
            rid = self.get_read_id(name)
            self.read_seq[rid] = codes
            self.read_lens[rid] = len(codes)
        self.max_read_len = max(self.read_lens) if self.read_lens else 0
        self.load_success = True

    def get_number_of_reads(self) -> int:
        return self.reads_num

    def get_read_len(self, rid: int) -> int:
        return self.read_lens[rid]

    def get_read_name(self, rid: int) -> str:
        return self.read_map_inv[rid]

    def get_min_read_prob(self, rid: int) -> float:
        """log of mismatch^(0.25 L) * match^(0.75 L)
        (reference GetMinReadProb, graph.h:478-481)."""
        L = self.read_lens[rid]
        return (0.25 * L * np.log(self.mismatch_prob) +
                0.75 * L * np.log(self.match_prob))

    def min_read_probs_array(self) -> np.ndarray:
        """Cached per-read get_min_read_prob values (read lengths are
        fixed after ingestion; hot in the scorer's position filter)."""
        arr = getattr(self, "_min_read_probs", None)
        if arr is None or len(arr) != self.reads_num:
            lens = np.asarray(self.read_lens, dtype=np.float64)
            arr = (0.25 * lens * np.log(self.mismatch_prob) +
                   0.75 * lens * np.log(self.match_prob))
            self._min_read_probs = arr
        return arr

    # ----------------------------------------------------------- persistence
    def save_alignments(self, path: Optional[str] = None) -> None:
        with open(path or self.name, "wb") as f:
            pickle.dump({
                "cache": self.aligment_cache,
                "read_lens": self.read_lens,
                "read_seq": self.read_seq,
                "reads_num": self.reads_num,
                "read_map": self.read_map,
            }, f)

    def load_alignments(self, path: Optional[str] = None) -> bool:
        try:
            with open(path or self.name, "rb") as f:
                data = pickle.load(f)
        except (OSError, pickle.PickleError):
            return False
        self.aligment_cache = data["cache"]
        self.read_lens = data["read_lens"]
        self.read_seq = data["read_seq"]
        self.reads_num = data["reads_num"]
        self.read_map = data["read_map"]
        self.read_map_inv = {v: k for k, v in self.read_map.items()}
        self.max_read_len = max(self.read_lens) if self.read_lens else 0
        self.load_success = True
        return True

    def normalize_cache(self, graph) -> None:
        """Rewrite cache keys through the node-dedup map
        (reference NormalizeCache, graph.cc:1102-1113)."""
        for key in list(self.aligment_cache.keys()):
            npath = tuple(graph.normalize_path(list(key)))
            self.aligment_cache[npath] = self.aligment_cache[key]

    # --------------------------------------------------------------- anchors
    def compute_anchors(self, graph, persist: bool = True) -> None:
        """Reference ComputeAnchors (graph.cc:2505-2576): node -> reads
        aligning to it, plus begin/end-touching subsets and the read ->
        begin-anchored-nodes reverse index."""
        anchors_path = self.name + ".anchors"
        loaded = False
        if persist:
            try:
                with open(anchors_path, "rb") as f:
                    data = pickle.load(f)
                self.anchors_cache = data["cache"]
                self.anchors_begin = data["begin"]
                self.anchors_end = data["end"]
                loaded = True
            except (OSError, pickle.PickleError):
                pass
        if not loaded:
            self._compute_anchors_fresh(graph)
            if persist:
                with open(anchors_path, "wb") as f:
                    pickle.dump({"cache": self.anchors_cache,
                                 "begin": self.anchors_begin,
                                 "end": self.anchors_end}, f)
        self.anchors_reverse = {}
        for node, reads in self.anchors_begin.items():
            for r in reads:
                self.anchors_reverse.setdefault(r, set()).add(node)

    def _compute_anchors_fresh(self, graph) -> None:
        # one concatenated buffer of all anchor-eligible nodes + a single
        # sorted k-mer index; each read queried once per strand, hits
        # grouped by node (fully vectorized, no per-k-mer Python)
        from ..align.longread import SortedKmerIndex

        node_ids = [i for i in range(graph.num_nodes)
                    if graph.node_len(i) >= K_MIN_ANCHOR_LEN]
        if not node_ids or self.reads_num == 0:
            return
        starts = np.zeros(len(node_ids) + 1, dtype=np.int64)
        for i, nid in enumerate(node_ids):
            starts[i + 1] = starts[i] + graph.node_len(nid)
        buffer = np.concatenate([graph.seqs[nid] for nid in node_ids])
        index = SortedKmerIndex(buffer, SEED_K)

        for rid in range(self.reads_num):
            for strand, q in ((0, self.read_seq[rid]),
                              (1, dna.revcomp(self.read_seq[rid]))):
                if len(q) < SEED_K:
                    continue
                tpos, qpos = index.hits(q)
                if len(tpos) == 0:
                    continue
                node_i = np.searchsorted(starts, tpos, "right") - 1
                valid = tpos + SEED_K <= starts[node_i + 1]
                tpos, qpos, node_i = tpos[valid], qpos[valid], node_i[valid]
                off = tpos - starts[node_i]
                order = np.argsort(node_i, kind="stable")
                node_s = node_i[order]
                off_s = off[order]
                qpos_s = qpos[order]
                bounds = np.nonzero(np.concatenate(
                    [[True], node_s[1:] != node_s[:-1]]))[0]
                bounds = np.concatenate([bounds, [len(node_s)]])
                for bi in range(len(bounds) - 1):
                    a, bnd = bounds[bi], bounds[bi + 1]
                    if bnd - a < 3:
                        continue
                    nid = node_ids[int(node_s[a])]
                    hits = list(zip(off_s[a:bnd].tolist(),
                                    qpos_s[a:bnd].tolist()))
                    chains = chain_hits(hits, min_seeds=3)
                    if not chains:
                        continue
                    ch = chains[0]
                    nlen = graph.node_len(nid)
                    rlen = len(q)
                    cov_start = ch.tstart - min(ch.tstart, ch.qstart)
                    cov_end = ch.tend + min(nlen - ch.tend, rlen - ch.qend)
                    self.anchors_cache.setdefault(nid, set()).add(rid)
                    if cov_start <= 10:
                        self.anchors_begin.setdefault(nid, set()).add(rid)
                    if cov_end >= nlen - 10:
                        self.anchors_end.setdefault(nid, set()).add(rid)

    # ----------------------------------------------------- alignment (slow)
    def _ensure_fwd_engine(self):
        """The engine with this read set's resident rows on its
        device, or an engine without them (dense staging) when the rows
        would exceed GAML_PB_RESIDENT_MAX bytes."""
        eng = getattr(self, "_fwd_engine", None)
        if eng is not None:
            return eng
        rmax_cls = max((len(r) for r in self.read_seq), default=0)
        need = ForwardDeviceEngine.resident_bytes(self.reads_num, rmax_cls)
        cap = int(os.environ.get("GAML_PB_RESIDENT_MAX", RESIDENT_MAX))
        if need > cap:
            print(f"[pb.forward] resident read rows would be "
                  f"{need / 1e9:.1f} GB > cap {cap / 1e9:.1f} GB; using "
                  f"dense staging", file=sys.stderr, flush=True)
            eng = ForwardDeviceEngine(None, self.device)
        else:
            eng = ForwardDeviceEngine(self.read_seq, self.device)
        self._fwd_engine = eng
        return eng

    def _forward_batch(self, seq: np.ndarray, jobs, extents=None):
        """jobs: list of (read codes, centers[, rid, strand]); returns the
        logprobs list.  ``extents`` gives each job's (gstart, glen) in
        ``seq``; default the whole buffer.  Traced as the spans
        ``pacbio.stage`` (the job arrays, and on the engine the guide
        steps and uploads) and ``pacbio.forward`` (the native kernel, or
        the engine's launch and its ``sync`` read-back), and the counters
        ``pacbio.jobs``, ``pacbio.cells`` and ``pacbio.native_batches`` or
        ``pacbio.device_batches``."""
        if not jobs:
            return []
        with span("pacbio.stage"):
            (rmax, reads, rlens, centers, gstarts, glens, job_rid,
             job_strand) = job_arrays(seq, jobs, extents)
            width = self.forward_width or 64
            cells = int(rlens.sum()) * width
            prof = getattr(self, "dp_cells", None)
            if prof is None:
                prof = self.dp_cells = {}
            lm = float(np.log(self.match_prob))
            lmm = float(np.log(self.mismatch_prob))
            # forward_dispatch (enable_sharded_pacbio): every batch,
            # whatever its size, on the engine, counted under "mesh"
            mesh = getattr(self, "forward_dispatch", False)
            native = None
            if not mesh and cells < int(os.environ.get(
                    "GAML_PB_DEVICE_MIN_CELLS", DEVICE_MIN_CELLS)):
                from ..native import banded_forward_host, get_lib

                if get_lib() is not None:
                    native = banded_forward_host
            if native is None:
                eng = self._ensure_fwd_engine()
                staged = eng.stage_jobs(seq, reads, rlens, centers, gstarts,
                                        glens, job_rid, job_strand)
        count("pacbio.jobs", len(jobs))
        count("pacbio.cells", cells)
        if native is not None:
            count("pacbio.native_batches")
            with span("pacbio.forward"):
                out = native(seq, reads, rlens, centers, gstarts, glens, lm,
                             lmm, width)
            prof["native"] = prof.get("native", 0) + cells
            return [float(x) for x in out]

        count("pacbio.device_batches")
        with span("pacbio.forward"):
            out = eng.run(staged, lm, lmm, width)
        key = "mesh" if mesh else \
            "cuda" if eng.device.type == "cuda" else "torch"
        prof[key] = prof.get(key, 0) + cells
        return [float(x) for x in out]

    def _spell(self, graph, path: Sequence[int]) -> np.ndarray:
        """Spell a sub-walk, gaps as N (reference graph.cc:2662-2681; the
        entries' positions are ``walk_bounds``)."""
        parts = [np.full(-e, dna.CODE_N, dtype=np.uint8) if e < 0
                 else graph.seqs[e] for e in path]
        return np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint8)

    def _reserve_windows(self, graph, path: Sequence[int],
                         save_to_cache: bool = True) -> dict:
        """The window half of GetReadProbabilitiesSlow's front
        (graph.cc:2724-2742): reserve the sub-walk's cache windows, noting
        those another fill reserved first (dont_save).  Returns the prep
        that ``_chain_preps`` completes."""
        path = list(path)
        begins, ends = walk_bounds(graph, path)
        subpath_starts: Dict[Tuple[int, ...], int] = {}
        dont_save: Set[Tuple[int, ...]] = set()
        if save_to_cache:
            for i in range(len(path)):
                subpath = []
                for j in range(i, len(path)):
                    subpath.append(path[j])
                    key = tuple(subpath)
                    if key in self.aligment_cache:
                        dont_save.add(key)
                    else:
                        self.aligment_cache[key] = []
                    subpath_starts[key] = i
                    if ends[j] - begins[i] - (ends[i] - begins[i]) > self.max_read_len:
                        break
        return dict(begins=begins, ends=ends, path=path,
                    subpath_starts=subpath_starts, dont_save=dont_save,
                    save_to_cache=save_to_cache)

    def _read_filter(self, path) -> List[int]:
        """The reads anchored on the walk's nodes, ascending (every read
        where none is)."""
        read_filter: Set[int] = set()
        for e in path:
            if e >= 0:
                read_filter.update(self.anchors_cache.get(e, ()))
        if not read_filter:
            return list(range(self.reads_num))
        return sorted(read_filter)

    def _chain_preps(self, graph, preps) -> list:
        """The aligner half of GetReadProbabilitiesSlow's front for several
        reserved ranges: spell each sub-walk, look up its anchored reads'
        seed hits on both strands (``_seed_hits``, every range in one
        batch), chain them and build the forward-DP job list, everything
        but the device call, so the ranges can share one batch.  Fills each
        prep's seq, jobs and meta; chain emission order matches
        align_long_read exactly."""
        # a process of a group runs only its own reads' jobs
        # (parallel/pacbio_sharded.py)
        lo, hi = getattr(self, "read_range", (0, self.reads_num))
        seqs, rids = [], []
        for prep in preps:
            seq = self._spell(graph, prep["path"])
            seqs.append(seq)
            rids.append([rid for rid in self._read_filter(prep["path"])
                         if lo <= rid < hi and
                         len(self.read_seq[rid]) >= SEED_K]
                        if len(seq) >= SEED_K else [])
        with span("pacbio.seeds"):
            hits = self._seed_hits(seqs, rids)
        for prep, seq, range_rids, range_hits in zip(preps, seqs, rids, hits):
            jobs = []
            meta = []
            for rid, strands in zip(range_rids, range_hits):
                read, rc = self._strands(rid)
                chains = []
                for strand, (tpos, qpos) in enumerate(strands):
                    hits_rs = list(zip(tpos.tolist(), qpos.tolist()))
                    for ch in chain_hits(hits_rs, min_seeds=3):
                        chains.append(ch._replace(strand=strand))
                chains.sort(key=lambda c: -c.n_seeds)
                for chain in chains:
                    q = read if chain.strand == 0 else rc
                    centers = guide_path(chain, len(q), len(seq))
                    # (rid, strand) lets the device route read q from its
                    # RESIDENT packed row instead of shipping the bytes
                    jobs.append((q, centers, rid, chain.strand))
                    meta.append((rid, chain))
            prep.update(seq=seq, jobs=jobs, meta=meta)
        return preps

    def _strands(self, rid: int):
        """(read, reverse complement) of ``rid``, kept across rescores."""
        cache = getattr(self, "_strand_cache", None)
        if cache is None:
            cache = self._strand_cache = {}
        entry = cache.get(rid)
        if entry is None:
            read = self.read_seq[rid]
            entry = cache[rid] = (read, dna.revcomp(read))
        return entry

    def _seed_engine(self):
        """The forward engine whose resident read rows the seed kernels
        read: on a CUDA device when the rows are resident; else None (the
        host index)."""
        if self.device.type != "cuda":
            return None
        eng = self._ensure_fwd_engine()
        return eng if eng.rows is not None else None

    def _seed_hits(self, seqs, rids) -> list:
        """Exact k-mer seed hits of each range's reads on both strands:
        out[i][k] = ((tpos, qpos) forward, (tpos, qpos) reverse complement)
        of read rids[i][k] against seqs[i], as
        SortedKmerIndex(seqs[i]).hits would give them.  On a CUDA device
        with resident read rows every range's queries run as one batch of
        the seed kernels (ops/seeds_device.py), read from the rows; else
        each range through the host index, its reads' packed k-mers cached
        across rescores.  Counters ``pacbio.seed_queries`` (query k-mers),
        ``pacbio.seed_hits`` and ``pacbio.seed_device_batches`` or
        ``pacbio.seed_native_batches`` (one a batch with any query)."""
        n_q = 2 * sum(len(self.read_seq[rid]) - SEED_K + 1
                      for range_rids in rids for rid in range_rids)
        if not n_q:
            return [[] for _ in seqs]
        eng = self._seed_engine()
        if eng is None:
            count("pacbio.seed_native_batches")
            out, n_hits = self._seed_hits_host(seqs, rids)
        else:
            from ..ops.seeds_device import Workspace, seed_hits

            count("pacbio.seed_device_batches")
            segs = [(rid + strand * eng.n_reads, i,
                     len(self.read_seq[rid]))
                    for i, range_rids in enumerate(rids)
                    for rid in range_rids for strand in (0, 1)]
            seg_row, seg_range, seg_len = (np.array(c, dtype=np.int64)
                                           for c in zip(*segs))
            ws = getattr(self, "_seed_ws", None)
            if ws is None:
                ws = self._seed_ws = Workspace()
            seg_off, hits = seed_hits(
                eng.rows, np.concatenate(seqs), [len(s) for s in seqs],
                seg_row, seg_range, seg_len, ws)
            n_hits = len(hits)
            tpos, qpos = hits[:, 0], hits[:, 1]
            bounds = seg_off.tolist()
            out, s = [], 0  # segments in (range, read, strand) order
            for range_rids in rids:
                per_read = []
                for _rid in range_rids:
                    fwd, rev = (slice(bounds[j], bounds[j + 1])
                                for j in (s, s + 1))
                    per_read.append(((tpos[fwd], qpos[fwd]),
                                     (tpos[rev], qpos[rev])))
                    s += 2
                out.append(per_read)
        count("pacbio.seed_queries", n_q)
        count("pacbio.seed_hits", n_hits)
        return out

    def _seed_hits_host(self, seqs, rids):
        """``_seed_hits`` through one SortedKmerIndex a range (one batched
        query for all its (read, strand) pairs): (hits, their number)."""
        from ..align.longread import SortedKmerIndex
        from ..index.maxhash import pack_kmers

        kcache = getattr(self, "_seed_kmer_cache", None)
        if kcache is None:
            kcache = self._seed_kmer_cache = {}
        out, n_hits = [], 0
        for seq, range_rids in zip(seqs, rids):
            if not range_rids:
                out.append([])
                continue
            qks = []
            for rid in range_rids:
                entry = kcache.get(rid)
                if entry is None:
                    read, rc = self._strands(rid)
                    entry = kcache[rid] = (pack_kmers(read, SEED_K),
                                           pack_kmers(rc, SEED_K))
                qks.extend(entry)
            batch = SortedKmerIndex(seq).hits_batch_kmers(qks)
            n_hits += sum(len(t) for t, _q in batch)
            out.append([(batch[2 * k], batch[2 * k + 1])
                        for k in range(len(range_rids))])
        return out, n_hits

    def _slow_prepare(self, graph, path: Sequence[int],
                      save_to_cache: bool = True):
        """First half of GetReadProbabilitiesSlow (graph.cc:2650-2795):
        reserve the sub-walk's cache windows, then seed and chain its
        anchored reads into forward-DP jobs."""
        return self._chain_preps(
            graph, [self._reserve_windows(graph, path, save_to_cache)])[0]

    def _slow_apply(self, prep, logprobs):
        """Second half of GetReadProbabilitiesSlow: record positions and
        append the cached per-subpath alignments."""
        import bisect

        path = prep["path"]
        begins, ends = prep["begins"], prep["ends"]
        total_len = len(prep["seq"])
        positions: List[List[Tuple[int, float]]] = \
            [[] for _ in range(self.reads_num)]
        for (rid, chain), lp in zip(prep["meta"], logprobs):
            tstart = max(0, chain.tstart - chain.qstart)
            tend = min(total_len,
                       chain.tend + (self.read_lens[rid] - chain.qend))
            positions[rid].append((tstart, lp))
            if prep["save_to_cache"]:
                it_begin = bisect.bisect_left(ends, max(0, tstart - 5))
                it_end = bisect.bisect_left(ends, min(tend + 5, total_len))
                it_begin = min(it_begin, len(path) - 1)
                it_end = min(it_end, len(path) - 1)
                key = tuple(path[it_begin:it_end + 1])
                pos_begin = begins[it_begin]
                if prep["subpath_starts"].get(key) == it_begin and \
                        key not in prep["dont_save"]:
                    self.aligment_cache[key].append(PacbioAlignment(
                        tstart - pos_begin, tend - pos_begin, rid, lp))
        return positions, total_len

    def _prep_ranges(self, graph, path, missing) -> list:
        """Merge overlapping missing (i, j) windows into ranges and build
        their slow-path preps (cache keys reserved, jobs chained) without
        running the forward DP.  Traced as the spans ``pacbio.windows``
        and ``pacbio.chain``."""
        with span("pacbio.windows"):
            reserved = [self._reserve_windows(graph, path[a:b + 1])
                        for a, b in merge_ranges(missing)]
        with span("pacbio.chain"):
            return self._chain_preps(graph, reserved)

    def _run_preps(self, preps) -> None:
        """Run every prep's forward-DP jobs in ONE device batch (the kernel
        takes concatenated targets with per-job extents, so a call's
        launch and read-back are paid once), then apply (span
        ``pacbio.apply``)."""
        if not preps:
            return
        if len(preps) == 1:
            prep = preps[0]
            logprobs = self._forward_batch(prep["seq"], prep["jobs"])
            with span("pacbio.apply"):
                self._slow_apply(prep, logprobs)
            return
        with span("pacbio.stage"):
            bufs, all_jobs, extents, counts = [], [], [], []
            off = 0
            for prep in preps:
                seq = prep["seq"]
                for q, centers, *extra in prep["jobs"]:
                    all_jobs.append((q, [c + off for c in centers], *extra))
                    extents.append((off, len(seq)))
                counts.append(len(prep["jobs"]))
                bufs.append(seq)
                off += len(seq)
            buf = np.concatenate(bufs) if bufs else \
                np.zeros(0, dtype=np.uint8)
        logprobs = self._forward_batch(buf, all_jobs, extents)
        with span("pacbio.apply"):
            at = 0
            for prep, k in zip(preps, counts):
                self._slow_apply(prep, logprobs[at:at + k])
                at += k

    def _fill_missing_ranges(self, graph, path, missing) -> None:
        self._run_preps(self._prep_ranges(graph, path, missing))

    def _missing_windows(self, graph, path) -> list:
        """The (i, j) node-window indexes of ``path`` absent from the
        alignment cache (the window enumeration of GetReadProbabilities,
        graph.cc:2438-2454)."""
        begins, ends = walk_bounds(graph, path)
        missing = []
        for i in range(len(path)):
            subpath = []
            for j in range(i, len(path)):
                subpath.append(path[j])
                if tuple(subpath) not in self.aligment_cache:
                    missing.append((i, j))
                if ends[j] - begins[i] - (ends[i] - begins[i]) > \
                        self.max_read_len:
                    break
        return missing

    def precompute_ranges_for_paths(self, graph, paths) -> None:
        """Fill every walk's missing cache windows in ONE forward-DP batch
        (the PacBio analogue of the short-read bulk precompute): a full
        rescore over N walks pays one device dispatch instead of N, which
        is what pushes the bulk batch over the device-routing threshold
        (VERDICT r2 item 2).  Cache evolution is identical to the
        sequential per-walk fills: every range reserves its windows, walk
        by walk, before the next walk's missing windows are found, as
        interleaved prep/apply would (the chaining touches no window).
        Traced as the spans ``pacbio.windows`` (the missing windows, their
        ranges and reservations) and ``pacbio.chain``."""
        with span("pacbio.windows"):
            reserved = []
            seen = set()
            for path in paths:
                path = graph.normalize_path(list(path))
                key = tuple(path)
                if key in seen:
                    continue
                seen.add(key)
                missing = self._missing_windows(graph, path)
                reserved.extend(self._reserve_windows(graph, path[a:b + 1])
                                for a, b in merge_ranges(missing))
        with span("pacbio.chain"):
            preps = self._chain_preps(graph, reserved)
        self._run_preps(preps)

    # --------------------------------------------------- cached positions
    def get_read_probabilities(self, graph, path: Sequence[int]):
        """Assemble cached per-subpath alignments over a walk, filling
        missing cache ranges via the slow path (reference
        GetReadProbabilities, graph.cc:2410-2503).  Returns
        (positions2, total_len): positions2[rid] = [((start, end), logprob)].
        """
        path = list(path)
        begins, ends = walk_bounds(graph, path)
        total_len = ends[-1] if ends else 0

        subpaths = []
        missing = []
        for i in range(len(path)):
            subpath = []
            for j in range(i, len(path)):
                subpath.append(path[j])
                key = tuple(subpath)
                if key not in self.aligment_cache:
                    missing.append((i, j))
                subpaths.append((key, i))
                if ends[j] - begins[i] - (ends[i] - begins[i]) > self.max_read_len:
                    break
        if missing:
            self._fill_missing_ranges(graph, path, missing)

        self.positions2 = [[] for _ in range(self.reads_num)]
        for key, i in subpaths:
            pos_begin = begins[i]
            for al in self.aligment_cache.get(key, ()):
                self.positions2[al.read_id].append(
                    ((pos_begin + al.position, pos_begin + al.position_end),
                     al.logprob))
        return self.positions2, total_len

    def get_exact_read_probabilities(self, graph, path: Sequence[int],
                                     ps: int):
        """Positions from subpaths starting before index ``ps`` only
        (reference GetExactReadProbabilities, graph.cc:2299-2408; caller
        CalcExactScoreForPacbio is commented out there but the method is
        live surface).  Returns (positions, total_len, total_len2);
        positions carry *subpath-local* start positions, faithfully to the
        reference (no pos_begin offset there)."""
        path = list(path)
        begins, ends = [], []
        seq_len = 0
        back_length = 0
        total_len2 = 0
        for idx, e in enumerate(path):
            begins.append(seq_len)
            ln = graph.node_len(e)
            if idx == 0 or idx < ps:
                total_len2 += ln
            else:
                back_length += ln
            seq_len += ln
            ends.append(seq_len)
        total_len = seq_len
        total_len2 += min(self.max_read_len // 3, back_length)

        missing = []
        for i in range(len(path)):
            subpath = []
            for j in range(i, len(path)):
                subpath.append(path[j])
                if tuple(subpath) not in self.aligment_cache:
                    missing.append((i, j))
                if ends[j] - begins[i] - (ends[i] - begins[i]) > self.max_read_len:
                    break
        if missing:
            self._fill_missing_ranges(graph, path, missing)

        positions: List[List[Tuple[int, float]]] = \
            [[] for _ in range(self.reads_num)]
        for i in range(min(len(path), ps)):
            subpath = []
            for j in range(i, len(path)):
                subpath.append(path[j])
                key = tuple(subpath)
                for al in self.aligment_cache.get(key, ()):
                    positions[al.read_id].append((al.position, al.logprob))
                if ends[j] - begins[i] - (ends[i] - begins[i]) > self.max_read_len:
                    break
        return positions, total_len, total_len2

    # ------------------------------------------------------------------ gaps
    def get_gap(self, graph, first: int, second: int, read_id: int) -> int:
        """Implied gap length between two nodes from one spanning read
        (reference GetGap, graph.cc:2578-2648), with its negative error
        codes: -1 no alignments, -2 strand mismatch, -3 second not at its
        start, -4 first not at its end, -5 read-coordinate overlap."""
        read = self.read_seq[read_id]
        flen = graph.node_len(first)

        def best(node, pick):
            chains = align_long_read(graph.seqs[node], read, min_seeds=3)
            if not chains:
                return None
            return pick(chains)

        fa = best(first, lambda cs: max(cs, key=lambda c: c.tend))
        sa = best(second, lambda cs: min(cs, key=lambda c: c.tstart))
        if fa is None or sa is None:
            return -1
        if fa.strand != sa.strand:
            return -2
        if sa.tstart > 10:
            return -3
        if fa.tend < flen - 10:
            return -4
        if fa.qend > sa.qstart:
            return -5
        return flen - fa.tend + sa.tstart + sa.qstart - fa.qend
