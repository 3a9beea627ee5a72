"""Short-read set: FASTQ ingestion, max-hash index, subpath alignment cache,
position assembly over walks.

Mirrors the reference ``ReadSet`` (graph.h:344-442, graph.cc:316-1113) with
the subprocess aligner replaced by the internal banded extension engine
(pluggable host-oracle / device backends, see align.aligner; the
device backend runs the port's torch ops on ``device``).

Coordinate conventions (critical for parity):
- alignments in the cache are in *subpath-window* coordinates, 1-based via
  the ``begin_pos + 1 + offset`` rule (graph.cc:890);
- walks are chopped into windows: node i plus following nodes until the
  cumulative length of the *following* nodes exceeds 300 (graph.cc:499-517);
  only windows whose end index differs from the previous window's are
  precomputed — later windows sharing an end contribute nothing, which is
  the dedup mechanism;
- assembled positions are window position + the node's running offset.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..align.aligner import (
    Alignment,
    AlignmentColumns,
    K_MIN_SUBPATH_LENGTH,
    SubpathAligner,
)

_EMPTY_COLUMNS = AlignmentColumns.from_tuples([])
from ..core import dna
from ..core.io import iter_fastq
from ..core.paths import invert_path
from ..utils.metrics import count, span

Subpath = Tuple[int, ...]

# segment size (in nodes) for content-keyed staging/precompute memos on
# long walks; proposals touching a small region of a megabase walk then
# only rescan/restage the touched segments
_STAGE_SEG = 128


class ReadSet:
    def __init__(self, name: str, filename: str, match_prob: float,
                 mismatch_prob: float, backend: str = "bfs",
                 index_kind: str = "maxhash", device="cuda"):
        self.name = name
        self.filename = filename
        self.match_prob = match_prob
        self.mismatch_prob = mismatch_prob
        self.backend = backend
        self.index_kind = index_kind
        self.device = device
        # device-backend latency hybrid: miss batches whose estimated
        # window bases fall below this go to the native aligner instead of
        # paying a device round trip
        self._dev_min_bases = int(os.environ.get("GAML_DEV_MIN_BASES",
                                                 "200000"))

        self.reads_num = 0
        self.read_map: Dict[str, int] = {}
        self.read_map_inv: Dict[int, str] = {}
        self.read_seqs: Dict[int, np.ndarray] = {}
        self.read_lens: List[int] = []
        self.max_read_len = 0
        self.match_probs = np.zeros(0)
        self.mismatch_probs = np.zeros(0)

        self.index = None  # ReadIndexMaxHash, built by prepare_read_index
        self.aligner: Optional[SubpathAligner] = None
        self.aligment_cache: Dict[Subpath, List[Alignment]] = {}
        self.cache_version = 0  # bumped on every alignment-cache insert wave
        self.positions: List[List[Tuple[int, Tuple[int, int]]]] = []
        self.load_success = False

        self.advice_index: Dict[int, List[int]] = {}
        self.advice_index1: Dict[int, List[int]] = {}
        self._advice_index_built = False

    # ------------------------------------------------------------- ingestion
    def get_read_id(self, name: str) -> int:
        if name not in self.read_map:
            assert not self.load_success
            rid = self.reads_num
            self.read_map[name] = rid
            self.read_map_inv[rid] = name
            self.reads_num += 1
            self.read_lens.append(0)
        return self.read_map[name]

    def _load_fastq(self):
        """(names, codes) via the native parser when built; memoized until
        the index is ready."""
        cached = getattr(self, "_fastq_cache", None)
        if cached is not None:
            return cached
        from ..native import read_fastq_arrays

        res = read_fastq_arrays(self.filename)
        if res is None:
            names, codes = [], []
            for name, seq in iter_fastq(self.filename):
                names.append(name)
                codes.append(dna.encode_seq(seq))
        else:
            buf, off, names = res
            codes = [buf[off[i]:off[i + 1]] for i in range(len(names))]
        self._fastq_cache = (names, codes)
        return self._fastq_cache

    def preprocess_reads(self) -> None:
        """Record read names/lengths (reference graph.cc:1386-1415)."""
        if self.load_success:
            return
        names, codes = self._load_fastq()
        if not self.read_map:
            # bulk path for the common case: fresh map, unique names
            m = dict(zip(names, range(len(names))))
            if len(m) == len(names):
                self.read_map = m
                self.read_map_inv = dict(zip(range(len(names)), names))
                self.reads_num = len(names)
                self.read_lens = [len(c) for c in codes]
                self.calc_max_read_len()
                self.load_success = True
                return
        for name, c in zip(names, codes):
            rid = self.get_read_id(name)
            self.read_lens[rid] = len(c)
        self.calc_max_read_len()
        self.load_success = True

    def prepare_read_index(self) -> None:
        """Load sequences and build the read index
        (reference graph.cc:1366-1384); index_kind selects the max-hash
        fingerprint index (reference default) or the every-k-mer trivial
        index (reference alternate, graph.h:437-438)."""
        if self.index_kind == "trivial":
            from ..index.trivial import ReadIndexTrivial

            self.index = ReadIndexTrivial()
        else:
            from ..index.maxhash import ReadIndexMaxHash

            self.index = ReadIndexMaxHash()
        names, codes_all = self._load_fastq()
        codes_list = list(codes_all)
        try:
            rid_list = list(map(self.read_map.__getitem__, names))
        except KeyError:
            rid_list = [self.get_read_id(name) for name in names]
        self.read_seqs.update(zip(rid_list, codes_list))
        self._fastq_cache = None
        if self._prepare_index_native(codes_list, rid_list):
            return
        if hasattr(self.index, "add_reads_batch"):
            self.index.add_reads_batch(codes_list, rid_list)
        else:
            for codes, rid in zip(codes_list, rid_list):
                self.index.add_read(codes, rid)
        self.aligner = SubpathAligner(self.index, self.read_seqs, self.backend,
                                      self.device)
        # batch-pack a k-mer matrix for the uniform-length majority so the
        # aligner's read cache avoids per-read packing
        from ..index.maxhash import pack_kmers_batch

        by_len: Dict[int, List[int]] = {}
        for codes, rid in zip(codes_list, rid_list):
            by_len.setdefault(len(codes), []).append(rid)
        if by_len:
            main_len = max(by_len, key=lambda L: len(by_len[L]))
            rids = by_len[main_len]
            if main_len > 15 and rids:
                codes_fwd = np.stack([self.read_seqs[r] for r in rids])
                mat = pack_kmers_batch(codes_fwd)
                self.aligner._read_cache.kmer_matrix = mat
                self.aligner._read_cache.matrix_rids = {
                    r: i for i, r in enumerate(rids)}
                self._build_native_bundle(codes_fwd, rids, main_len)

    def _prepare_index_native(self, codes_list, rid_list) -> bool:
        """One-call native ingestion (max-hash index, uniform read length):
        fingerprints, k-mer matrices, rc matrix, and seed positions from a
        single OpenMP pass (bit-identical to the numpy pipeline).  Returns
        False when the preconditions don't hold (caller falls back)."""
        from ..native import get_lib

        from ..index.maxhash import K_INDEX_KMER

        if (get_lib() is None or self.index_kind != "maxhash"
                or not codes_list):
            return False
        L = len(codes_list[0])
        if L <= K_INDEX_KMER or any(len(c) != L for c in codes_list):
            return False
        from ..core.dna import _COMP_LUT
        from ..native import NativeAlignBundle, read_index_build

        codes_fwd = np.stack(codes_list)
        fp, ok, kmers, rc, seed = read_index_build(codes_fwd, K_INDEX_KMER)

        okb = ok.astype(bool)
        rids_arr = np.asarray(rid_list, dtype=np.int64)[okb]
        fps_ok = fp[okb]
        order = np.argsort(fps_ok, kind="stable")
        sf = fps_ok[order]
        sr = rids_arr[order]
        index = self.index.index
        if len(sf):
            bounds = np.nonzero(np.diff(sf))[0] + 1
            starts = np.concatenate(([0], bounds))
            ends = np.concatenate((bounds, [len(sf)]))
            for s, e in zip(starts.tolist(), ends.tolist()):
                index[int(sf[s])] = sr[s:e].tolist()
            self.index.read_len = L

        self.aligner = SubpathAligner(self.index, self.read_seqs,
                                      self.backend, self.device)
        cache = self.aligner._read_cache
        cache.kmer_matrix = kmers
        cache.matrix_rids = {r: i for i, r in enumerate(rid_list)}
        cache._rc_matrix = rc
        cache.seed_kmer_pos = seed
        codes_rc = _COMP_LUT[codes_fwd][:, ::-1]
        row_of = np.full(self.reads_num, -1, dtype=np.int32)
        for i, r in enumerate(rid_list):
            row_of[r] = i
        self.aligner.native_bundle = NativeAlignBundle(
            index, L, codes_fwd, codes_rc, seed, row_of)
        return True

    def _build_native_bundle(self, codes_fwd, rids, main_len) -> None:
        """Attach the native window-aligner bundle when the C++ library is
        built, the index is max-hash, and the matrices cover every indexed
        read."""
        from ..native import get_lib

        if get_lib() is None or self.index_kind != "maxhash":
            return
        covered = set(rids)
        for lst in self.index.index.values():
            for rid in lst:
                if rid not in covered:
                    return  # mixed read lengths: python path handles them
        from ..core.dna import _COMP_LUT
        from ..native import NativeAlignBundle

        self.aligner._read_cache.build_precomputes()
        seed_pos = self.aligner._read_cache.seed_kmer_pos
        if seed_pos is None:
            return
        codes_rc = _COMP_LUT[codes_fwd][:, ::-1]
        row_of = np.full(self.reads_num, -1, dtype=np.int32)
        for i, r in enumerate(rids):
            row_of[r] = i
        self.aligner.native_bundle = NativeAlignBundle(
            self.index.index, main_len, codes_fwd, codes_rc, seed_pos, row_of)

    def calc_max_read_len(self) -> None:
        """Precompute match/mismatch power tables (graph.cc:1443-1454)."""
        self.max_read_len = max(self.read_lens) if self.read_lens else 0
        n = self.max_read_len + 7
        exps = np.arange(n, dtype=np.float64)
        self.match_probs = np.power(self.match_prob, exps)
        self.mismatch_probs = np.power(self.mismatch_prob, exps)

    def get_number_of_reads(self) -> int:
        return self.reads_num

    def get_read_len(self, rid: int) -> int:
        return self.read_lens[rid]

    def read_lens_array(self) -> np.ndarray:
        """Cached numpy view of per-read lengths (hot in the reductions)."""
        arr = getattr(self, "_read_lens_np", None)
        if arr is None or len(arr) != self.reads_num:
            arr = np.asarray(self.read_lens, dtype=np.int64)
            self._read_lens_np = arr
        return arr

    def read_lens_i32(self) -> np.ndarray:
        """Cached contiguous int32 read lengths (native-kernel argument)."""
        arr = getattr(self, "_read_lens_i32", None)
        if arr is None or len(arr) != self.reads_num:
            arr = np.ascontiguousarray(self.read_lens_array(),
                                       dtype=np.int32)
            self._read_lens_i32 = arr
        return arr

    # ---------------------------------------------------------------- caches
    def save_alignments(self, path: Optional[str] = None) -> None:
        """Persist the alignment cache.  (The reference's short-read save is
        dead code behind an early return, graph.cc:1035-1036; we make it
        real.)"""
        with open(path or self.name, "wb") as f:
            pickle.dump({
                "cache": self.aligment_cache,
                "read_lens": self.read_lens,
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
        self.cache_version += 1
        for attr in ("_stage_memo", "_stage_memo_simple", "_walk_stage_memo",
                     "_precompute_memo", "_inc_contrib_memo"):
            if hasattr(self, attr):
                getattr(self, attr).clear()
        self.read_lens = data["read_lens"]
        self.reads_num = data["reads_num"]
        self.read_map = data["read_map"]
        self.read_map_inv = {v: k for k, v in self.read_map.items()}
        self.calc_max_read_len()
        self.load_success = True
        return True

    def clear_positions(self) -> None:
        self.positions = [[] for _ in range(self.reads_num)]

    # ----------------------------------------------------------- subpathing
    @staticmethod
    def _window_at(path: Sequence[int], i: int, graph, stop_at_gap: bool) -> Tuple[List[int], int]:
        """Window starting at index i: [path[i]] plus following nodes until
        the cumulative length of the *following* nodes exceeds 300
        (graph.cc:499-517).  Returns (window, end_index)."""
        cur_seq = [path[i]]
        cur_end = i
        cur_seq_len = 0
        for j in range(i + 1, len(path)):
            if stop_at_gap and path[j] < 0:
                break
            cur_seq_len += graph.node_len(path[j])
            cur_seq.append(path[j])
            cur_end = j
            if cur_seq_len > K_MIN_SUBPATH_LENGTH:
                break
        return cur_seq, cur_end

    def get_subpaths_from_path(self, path: Sequence[int], graph,
                               out: Set[Subpath]) -> None:
        """Windows needing alignment (reference GetSubpathsFromPath,
        graph.cc:495-533)."""
        last_end = -1
        for i in range(len(path)):
            if path[i] < 0:
                continue
            cur_seq, cur_end = self._window_at(path, i, graph, stop_at_gap=True)
            if cur_end != last_end:
                key = tuple(cur_seq)
                if key not in self.aligment_cache:
                    out.add(key)
            last_end = cur_end

    def precompute_alignment_for_paths(self, paths: Sequence[Sequence[int]],
                                       graph, keys=None,
                                       collect_into: Optional[Set[Subpath]]
                                       = None) -> None:
        """Batch precompute for every window of every walk, plus inverted
        windows and long single nodes (reference graph.cc:447-493; note
        ``last_end`` deliberately carries across walks as in the C++).
        ``keys`` optionally supplies pre-built walk tuples (parallel to
        ``paths``) so hot callers tuple-ize the walk set only once.

        Memoization: a walk can be skipped on later calls iff re-scanning
        it could never insert a window under ANY incoming carry.  Inserts
        happen only for uncached windows passing the carry test; after this
        call's insert wave every insertable window of a scanned walk is
        cached, and windows skipped by the *internal* carry (same cur_end
        as the previous in-walk window) can never be inserted from this
        walk.  The only carry-dependent decision is the walk's FIRST
        window: if it was skipped while uncached (external carry happened
        to equal its cur_end), a future call with a different predecessor
        would insert it — such walks are not memoized.  This is exactly
        the cache evolution of the unmemoized loop.

        ``collect_into``: defer the insert wave — add the windows this
        call WOULD align to the set instead (the multi-candidate prefetch:
        the union over candidates is aligned in one batch, which is the
        exact set sequential scoring of all candidates would insert, so
        cache evolution — and therefore every later score — is unchanged).
        The caller MUST align the collected set before any scoring runs
        (the memos updated here assume it)."""
        subpaths: Set[Subpath] = set()
        last_end = -1
        memo = getattr(self, "_precompute_memo", None)
        if memo is None:
            memo = self._precompute_memo = {}
        if len(memo) > 200_000:
            memo.clear()
        cache = self.aligment_cache
        node_len = graph.node_len
        scanned = []
        for pi, path in enumerate(paths):
            pkey = keys[pi] if keys is not None else tuple(path)
            done = memo.get(pkey)
            if done is not None:
                # no inserts possible; thread the exact last_end carry
                last_end = done
                continue
            if len(path) >= 2 * _STAGE_SEG:
                last_end, memoizable = self._precompute_walk_segmented(
                    graph, path, pkey, last_end, collect_into=collect_into)
                if memoizable:
                    scanned.append((pkey, last_end))
                continue
            memoizable = False  # needs >= 1 non-gap entry (else the
            # stored last_end would be the carried-in one — content-free)
            first = True
            for i in range(len(path)):
                if path[i] < 0:
                    continue
                cur_seq, cur_end = self._window_at(path, i, graph, stop_at_gap=True)
                key = tuple(cur_seq)
                if key not in cache:
                    if (last_end != cur_end or
                            (len(cur_seq) == 1 and
                             node_len(cur_seq[0]) > 150)):
                        subpaths.add(key)
                        subpaths.add(tuple(invert_path(cur_seq)))
                    elif first:
                        memoizable = None  # carry-skipped uncached first window
                if node_len(path[i]) > K_MIN_SUBPATH_LENGTH:
                    if (path[i],) not in cache:
                        subpaths.add((path[i],))
                        subpaths.add((path[i] ^ 1,))
                last_end = cur_end
                if memoizable is False:
                    memoizable = True
                first = False
            if memoizable:
                scanned.append((pkey, last_end))
        if subpaths:
            if collect_into is not None:
                collect_into.update(subpaths)
            else:
                self.precompute_alignment_for_subpaths(graph,
                                                       sorted(subpaths))
        for pkey, le in scanned:
            memo[pkey] = le

    def _precompute_walk_segmented(self, graph, path, pkey, carry_in,
                                   collect_into=None):
        """Segmented equivalent of the per-walk precompute scan for long
        walks: each 512-node segment's insertion scan is memoized on
        (content incl. window spillover, whether the incoming window-end
        carry equals the first window's end) — the only two ways its
        insertion decisions can depend on context.  Inserts happen per
        segment (idempotent: alignments are content-deterministic, so the
        end-of-call cache state matches the unsegmented scan).  Returns
        (outgoing last_end carry, memoizable flag for the walk memo)."""
        SEG = _STAGE_SEG
        pmemo = getattr(self, "_seg_pre_memo", None)
        if pmemo is None:
            pmemo = self._seg_pre_memo = set()
        if len(pmemo) > 20_000:
            pmemo.clear()
        cache = self.aligment_cache
        node_len = graph.node_len
        n = len(path)
        last_out = carry_in
        memoizable = False
        first = True
        for s in range(0, n, SEG):
            e = min(s + SEG, n)
            i_last = e - 1
            while i_last >= s and path[i_last] < 0:
                i_last -= 1
            if i_last < s:
                continue  # all gaps: no windows, carry unchanged
            _w, ext_end = self._window_at(path, i_last, graph,
                                          stop_at_gap=True)
            i_first = s
            while path[i_first] < 0:
                i_first += 1
            seq0, end0 = self._window_at(path, i_first, graph,
                                         stop_at_gap=True)
            carry_hit = last_out == end0
            if first:
                # the walk memo's first-window quirk: an uncached first
                # window skipped only because of the incoming carry makes
                # the walk unmemoizable (a different predecessor would
                # insert it)
                rule150 = len(seq0) == 1 and node_len(seq0[0]) > 150
                if carry_hit and not rule150 and tuple(seq0) not in cache:
                    memoizable = None
                elif memoizable is False:
                    memoizable = True
                first = False
            skey = (pkey[s:ext_end + 1], carry_hit)
            if skey not in pmemo:
                out: Set[Subpath] = set()
                last_end = last_out
                for i in range(s, e):
                    if path[i] < 0:
                        continue
                    cur_seq, cur_end = self._window_at(path, i, graph,
                                                       stop_at_gap=True)
                    key = tuple(cur_seq)
                    if key not in cache:
                        if (last_end != cur_end or
                                (len(cur_seq) == 1 and
                                 node_len(cur_seq[0]) > 150)):
                            out.add(key)
                            out.add(tuple(invert_path(cur_seq)))
                    if node_len(path[i]) > K_MIN_SUBPATH_LENGTH:
                        if (path[i],) not in cache:
                            out.add((path[i],))
                            out.add((path[i] ^ 1,))
                    last_end = cur_end
                if out:
                    if collect_into is not None:
                        collect_into.update(out)
                    else:
                        self.precompute_alignment_for_subpaths(graph,
                                                               sorted(out))
                pmemo.add(skey)
            last_out = ext_end
        return last_out, bool(memoizable)

    def precompute_alignment_for_subpaths(self, graph,
                                          subpaths: Sequence[Subpath],
                                          defer: bool = False):
        """Reference PrecomputeAligmentForSubpaths (graph.cc:911-922,
        internal-aligner branch).  The device backend batches every window
        into one kernel call.

        ``defer``: on the device bulk path, dispatch the kernel work and
        return a zero-arg closure that blocks on the results and fills the
        cache — callers pipelining several read sets dispatch all batches
        before fetching any (ProbCalculator.prefetch_alignments).  Paths
        that complete synchronously return None.

        Traced on the device backend: the native route as the span
        ``align.native`` and the counters ``align.native_batches`` and
        ``align.native_windows``, the device route (its finish too) as
        ``align.device``."""
        if subpaths:
            self.cache_version += 1
        for sp in subpaths:
            self.aligment_cache[sp] = _EMPTY_COLUMNS
        bundle = getattr(self.aligner, "native_bundle", None)
        if self.backend == "device" and len(subpaths) >= 1:
            # latency hybrid: tiny miss batches — whose native cost is
            # far below one device round trip — route to the native
            # aligner; bulk batches go to the kernels.
            # GAML_DEV_MIN_BASES=0 forces all-device.
            if bundle is not None and self._dev_min_bases > 0:
                node_len = graph.node_len
                est = sum(min(node_len(e), 300) for sp in subpaths
                          for e in sp)
                if est < self._dev_min_bases:
                    with span("align.native"):
                        self._precompute_native_batch(graph, subpaths,
                                                      bundle)
                    count("align.native_batches")
                    count("align.native_windows", len(subpaths))
                    return None
            with span("align.device"):
                fin_align = self.aligner.align_subpaths_batch(
                    graph, list(subpaths), defer=defer)

            def finish(results=None):
                with span("align.device"):
                    if results is None:
                        results = fin_align()
                    for sp, als in zip(subpaths, results):
                        self.aligment_cache[sp] = als

            if defer:
                return finish
            finish(fin_align)
            return None
        if bundle is not None and self.backend == "bfs" and len(subpaths) > 1:
            self._precompute_native_batch(graph, subpaths, bundle)
            return None
        for sp in subpaths:
            self.aligment_cache[sp] = self.aligner.align_subpath(graph, sp)
        return None

    def _precompute_native_batch(self, graph, subpaths, bundle) -> None:
        """One native call, OpenMP-parallel across windows."""
        from ..align.aligner import spell_subpath
        from ..native import align_windows_batch

        rl = self.aligner.index.read_len
        todo = []
        for sp in subpaths:
            seq, offset = spell_subpath(graph, sp)
            if rl > 0 and len(seq) >= rl:
                todo.append((sp, seq, offset))
        for (sp, _s, _o), res in zip(
                todo, align_windows_batch(bundle,
                                          [t[1] for t in todo],
                                          [t[2] for t in todo])):
            self.aligment_cache[sp] = AlignmentColumns(*res)

    def get_alignment_for_subpath(self, subpath: Subpath) -> AlignmentColumns:
        """Cache lookup; empty on miss (reference graph.cc:1463-1480)."""
        return self.aligment_cache.get(tuple(subpath), _EMPTY_COLUMNS)

    # ----------------------------------------------------- position assembly
    def add_positions(self, graph, path: Sequence[int], st: int) -> int:
        """Append alignments of a gap-free contig to ``self.positions`` at
        scaffold offset ``st``; returns the contig's spelled length
        (reference AddPositions, graph.cc:600-649 — note it looks up only
        the plain window, deduping by exact position with overwrite)."""
        subpaths: Set[Subpath] = set()
        self.get_subpaths_from_path(path, graph, subpaths)
        if subpaths:
            self.precompute_alignment_for_subpaths(graph, sorted(subpaths))

        cur_pos = st
        added_len = 0
        for i in range(len(path)):
            added_len += graph.node_len(path[i])
            cur_seq, _ = self._window_at(path, i, graph, stop_at_gap=False)
            for al in self.get_alignment_for_subpath(tuple(cur_seq)).tuples():
                plist = self.positions[al.read_id]
                pos = al.position + cur_pos
                for j, (p, _) in enumerate(plist):
                    if p == pos:
                        plist[j] = (p, (al.edit_dist, al.orientation))
                        break
                else:
                    plist.append((pos, (al.edit_dist, al.orientation)))
            cur_pos += graph.node_len(path[i])
        return added_len

    def get_positions(self, graph, path: Sequence[int]):
        """Positions over a single walk (may contain gaps) — reference
        GetPositions (graph.cc:651-728).  Returns (positions, total_len)."""
        self.positions = [[] for _ in range(self.reads_num)]
        subpaths: Set[Subpath] = set()
        self.get_subpaths_from_path(path, graph, subpaths)
        if subpaths:
            self.precompute_alignment_for_subpaths(graph, sorted(subpaths))

        cur_pos = 0
        total_len = 0
        for i in range(len(path)):
            if path[i] < 0:
                cur_pos += -path[i]
                continue
            total_len += graph.node_len(path[i])
            cur_seq, _ = self._window_at(path, i, graph, stop_at_gap=True)
            seqs = [cur_seq]
            if graph.node_len(cur_seq[0]) > K_MIN_SUBPATH_LENGTH:
                seqs.append([cur_seq[0]])
            for seq in seqs:
                for al in self.get_alignment_for_subpath(tuple(seq)).tuples():
                    plist = self.positions[al.read_id]
                    pos = al.position + cur_pos
                    for j, (p, _) in enumerate(plist):
                        if p == pos:
                            plist[j] = (p, (al.edit_dist, al.orientation))
                            break
                    else:
                        plist.append((pos, (al.edit_dist, al.orientation)))
            cur_pos += graph.node_len(path[i])
        return self.positions, total_len

    def get_positions_only_path(self, graph, path: Sequence[int], st: int,
                                current: Dict[int, List[Alignment]]) -> None:
        """Positions of one gap-free contig collected into a read->alignments
        map, with the trailing-window duplicate filter (``position <
        max_pos - 5`` skip) — reference GetPositionsOnlyPath
        (graph.cc:535-598)."""
        subpaths: Set[Subpath] = set()
        self.get_subpaths_from_path(path, graph, subpaths)
        if subpaths:
            self.precompute_alignment_for_subpaths(graph, sorted(subpaths))

        cur_pos = st
        max_pos = 0
        for i in range(len(path)):
            cur_max_pos = 0
            cur_seq, _ = self._window_at(path, i, graph, stop_at_gap=False)
            seqs = [cur_seq]
            if graph.node_len(cur_seq[0]) > K_MIN_SUBPATH_LENGTH:
                seqs.append([cur_seq[0]])
            for seq in seqs:
                for al in self.get_alignment_for_subpath(tuple(seq)).tuples():
                    pos = al.position + cur_pos
                    if pos < max_pos - 5:
                        continue
                    cur_max_pos = max(pos, cur_max_pos)
                    moved = Alignment(pos, al.edit_dist, al.read_id, al.orientation)
                    lst = current.setdefault(al.read_id, [])
                    for j, existing in enumerate(lst):
                        if existing.position == pos:
                            lst[j] = moved
                            break
                    else:
                        lst.append(moved)
            cur_pos += graph.node_len(path[i])
            max_pos = max(max_pos, cur_max_pos)

    def _memo_lookup(self, memo, key):
        """Validated lookup for cache-derived memo entries
        ``[result, version, missing_keys]``: a stream built while some
        windows were uncached stays correct exactly until one of those
        windows becomes cached (cache values are immutable and the cache
        only grows).  Same-version hits are O(1); after an insert wave the
        (usually tiny) missing list is rechecked and the stamp refreshed."""
        entry = memo.get(key)
        if entry is None:
            return None
        if entry[1] != self.cache_version:
            cache = self.aligment_cache
            for k in entry[2]:
                if k in cache:
                    del memo[key]
                    return None
            entry[1] = self.cache_version
        return entry[0]

    def _col_ptrs(self, ac):
        """Raw data pointers of an AlignmentColumns value, cached per
        object (the cache value arrays are immutable owned copies, so the
        addresses are stable for the object's lifetime — the keepalive
        lists in the stage memos hold the refs)."""
        d = getattr(self, "_colptr_cache", None)
        if d is None:
            d = self._colptr_cache = {}
        ent = d.get(id(ac))
        if ent is None:
            if len(d) > 500_000:
                d.clear()
            ent = (ac.position.ctypes.data, ac.edit_dist.ctypes.data,
                   ac.read_id.ctypes.data, ac.orientation.ctypes.data, ac)
            d[id(ac)] = ent
        return ent

    def _stage_ctg(self, graph, ctg, simple: bool = False):
        """Per-contig window stream (relative coordinates) for the native
        pointer-based collect kernel; memoized with missing-window
        validation (_memo_lookup).  simple=True stages the
        AddPositions-style stream (one plain window per node, no seqs
        trick — reference graph.cc:600-649); simple=False the
        GetPositionsOnlyPath stream.  Returns (p_pos, p_ed, p_rid, p_or,
        w_len, w_curpos, w_group, total, keepalive).

        Long contigs stage per 512-node segment with content-keyed
        segment memos, so a proposal that changes a small region of a
        megabase walk restages only the touched segments."""
        attr = "_stage_memo_simple" if simple else "_stage_memo"
        memo = getattr(self, attr, None)
        if memo is None:
            memo = {}
            setattr(self, attr, memo)
        if len(memo) > 100_000:
            memo.clear()
        ckey = tuple(ctg)
        hit = self._memo_lookup(memo, ckey)
        if hit is not None:
            return hit
        if len(ctg) >= 2 * _STAGE_SEG:
            result, missing = self._stage_ctg_segmented(graph, ctg, ckey,
                                                        simple)
        else:
            subpaths: Set[Subpath] = set()
            self.get_subpaths_from_path(ctg, graph, subpaths)
            if subpaths:
                self.precompute_alignment_for_subpaths(graph,
                                                       sorted(subpaths))
            result, missing = self._stage_span(graph, ctg, 0, len(ctg),
                                               simple)
        memo[ckey] = [result, self.cache_version, missing]
        return result

    def _stage_span(self, graph, ctg, s, e, simple):
        """Window stream of ctg[s:e) in span-relative coordinates
        (w_curpos from 0 at node s, w_group = i - s).  Pure read of the
        alignment cache — callers run the insertion scan first."""
        p_pos: List[int] = []
        p_ed: List[int] = []
        p_rid: List[int] = []
        p_or: List[int] = []
        w_len: List[int] = []
        w_curpos: List[int] = []
        w_group: List[int] = []
        keep: List = []
        missing: List[Subpath] = []
        total = 0
        cur_pos = 0
        cache = self.aligment_cache
        col_ptrs = self._col_ptrs
        for i in range(s, e):
            cur_seq, _ = self._window_at(ctg, i, graph, stop_at_gap=False)
            if simple:
                seqs = [cur_seq]
            else:
                seqs = [cur_seq]
                if graph.node_len(cur_seq[0]) > K_MIN_SUBPATH_LENGTH:
                    seqs.append([cur_seq[0]])
            for seq in seqs:
                key = tuple(seq)
                ac = cache.get(key)
                if ac is None:
                    missing.append(key)
                    ac = _EMPTY_COLUMNS
                pp, pe, pr, po, _ref = col_ptrs(ac)
                p_pos.append(pp)
                p_ed.append(pe)
                p_rid.append(pr)
                p_or.append(po)
                n = len(ac.position)
                w_len.append(n)
                w_curpos.append(cur_pos)
                w_group.append(i - s)
                keep.append(ac)
                total += n
            cur_pos += graph.node_len(ctg[i])
        result = (np.array(p_pos, dtype=np.int64),
                  np.array(p_ed, dtype=np.int64),
                  np.array(p_rid, dtype=np.int64),
                  np.array(p_or, dtype=np.int64),
                  np.array(w_len, dtype=np.int32),
                  np.array(w_curpos, dtype=np.int32),
                  np.array(w_group, dtype=np.int32),
                  total, keep)
        return result, missing

    def _stage_ctg_segmented(self, graph, ctg, ckey, simple):
        """Segmented staging of a long gap-free contig.  Each 512-node
        segment's stream is memoized on its content (including the
        following nodes its last window spills into), and the
        get_subpaths insertion scan is memoized on (content, whether the
        incoming window-end carry suppresses the first window) — exactly
        the two ways a segment's behavior can depend on its context."""
        SEG = _STAGE_SEG
        sattr = "_seg_stage_memo_simple" if simple else "_seg_stage_memo"
        smemo = getattr(self, sattr, None)
        if smemo is None:
            smemo = {}
            setattr(self, sattr, smemo)
        if len(smemo) > 10_000:
            smemo.clear()
        scanmemo = getattr(self, "_seg_scan_memo", None)
        if scanmemo is None:
            scanmemo = self._seg_scan_memo = set()
        if len(scanmemo) > 20_000:
            scanmemo.clear()
        cache = self.aligment_cache
        n = len(ctg)
        parts = []
        all_missing: List[Subpath] = []
        carry_end = -1  # window-end index of ctg[s-1]'s window
        for s in range(0, n, SEG):
            e = min(s + SEG, n)
            _w, ext_end = self._window_at(ctg, e - 1, graph,
                                          stop_at_gap=False)
            skey = ckey[s:ext_end + 1]
            seq0, end0 = self._window_at(ctg, s, graph, stop_at_gap=False)
            # insertion scan (reference GetSubpathsFromPath restricted to
            # [s, e) with the exact incoming carry)
            scan_key = (skey, carry_end == end0)
            if scan_key not in scanmemo:
                out: Set[Subpath] = set()
                last_end = carry_end
                for i in range(s, e):
                    cur_seq, cur_end = self._window_at(ctg, i, graph,
                                                       stop_at_gap=True)
                    if cur_end != last_end:
                        k = tuple(cur_seq)
                        if k not in cache:
                            out.add(k)
                    last_end = cur_end
                if out:
                    self.precompute_alignment_for_subpaths(graph,
                                                           sorted(out))
                scanmemo.add(scan_key)
            carry_end = ext_end
            # stream
            ent = self._memo_lookup(smemo, skey)
            if ent is None:
                ent = self._stage_span(graph, ctg, s, e, simple)
                smemo[skey] = [ent, self.cache_version, list(ent[1])]
            parts.append((ent[0], s))
            all_missing.extend(ent[1])
        # assemble: offset each segment's relative coords
        lens = graph.lens_np()
        ctg_arr = np.asarray(ctg, dtype=np.int64)
        seg_starts = np.zeros(n, dtype=np.int64)
        np.cumsum(lens[ctg_arr[:-1]], out=seg_starts[1:])
        result = (
            np.concatenate([r[0] for r, _s in parts]),
            np.concatenate([r[1] for r, _s in parts]),
            np.concatenate([r[2] for r, _s in parts]),
            np.concatenate([r[3] for r, _s in parts]),
            np.concatenate([r[4] for r, _s in parts]),
            np.concatenate([r[5] + np.int32(seg_starts[s])
                            for r, s in parts]),
            np.concatenate([r[6] + np.int32(s) for r, s in parts]),
            sum(r[7] for r, _s in parts),
            [r[8] for r, _s in parts],
        )
        return result, all_missing

    def _stage_ctg_simple(self, graph, ctg):
        return self._stage_ctg(graph, ctg, simple=True)

    def stage_position_windows(self, graph, ctgs_with_st, simple: bool = False):
        """Native fast path staging: the exact window stream of
        get_positions_only_path (simple=False) or AddPositions
        (simple=True) over a walk's contigs (with their scaffold offsets),
        as a pointer-per-window bundle for the C++ collect_positions_ptr
        kernel: (p_pos, p_ed, p_rid, p_or, w_len, w_curpos, w_group,
        w_ctg, total, keepalive).  The window columns are read in place
        from the alignment cache — no per-move concatenation of megabase
        flat streams.  Runs the same cache precompute.

        Whole-walk bundles are memoized (keyed on the contig/offset
        layout) with missing-window validation (_memo_lookup)."""
        wkey = (simple, tuple((tuple(c), st) for c, st in ctgs_with_st))
        wmemo = getattr(self, "_walk_stage_memo", None)
        if wmemo is None:
            wmemo = self._walk_stage_memo = {}
        hit = self._memo_lookup(wmemo, wkey)
        if hit is not None:
            return hit
        parts = []
        group_base = 0
        version_at_start = self.cache_version
        for ci, (ctg, st) in enumerate(ctgs_with_st):
            r = self._stage_ctg(graph, ctg, simple=simple)
            parts.append((r, st, ci, group_base))
            w_group = r[6]
            group_base += int(w_group[-1]) + 1 if len(w_group) else 0
        if not parts:
            z32 = np.zeros(0, np.int32)
            z64 = np.zeros(0, np.int64)
            return (z64, z64, z64, z64, z32, z32, z32, z32, 0, [])
        staged = (
            np.concatenate([r[0] for r, _s, _c, _g in parts]),
            np.concatenate([r[1] for r, _s, _c, _g in parts]),
            np.concatenate([r[2] for r, _s, _c, _g in parts]),
            np.concatenate([r[3] for r, _s, _c, _g in parts]),
            np.concatenate([r[4] for r, _s, _c, _g in parts]),
            np.concatenate([r[5] + np.int32(st)
                            for r, st, _c, _g in parts]),
            np.concatenate([r[6] + np.int32(gb)
                            for r, _s, _c, gb in parts]),
            np.concatenate([np.full(len(r[4]), ci, dtype=np.int32)
                            for r, _s, ci, _g in parts]),
            sum(r[7] for r, _s, _c, _g in parts),
            [r[8] for r, _s, _c, _g in parts],
        )
        # memoize the assembled bundle, carrying the union of the contig
        # streams' missing windows for validation
        ctg_memo = getattr(self,
                           "_stage_memo_simple" if simple else "_stage_memo",
                           None) or {}
        # an insert wave during staging could have invalidated an
        # earlier contig's already-read stream — don't memoize then
        if self.cache_version == version_at_start:
            missing: List[Subpath] = []
            for c, _ in ctgs_with_st:
                entry = ctg_memo.get(tuple(c))
                if entry is None:
                    break  # contig stream not memoized (shouldn't happen)
                missing.extend(entry[2])
            else:
                budget = getattr(self, "_walk_stage_elems", 0)
                if budget > 40_000_000:
                    wmemo.clear()
                    budget = 0
                self._walk_stage_elems = budget + 8 * len(staged[0])
                wmemo[wkey] = [staged, self.cache_version, missing]
        return staged

    def get_positions_grouped(self, graph, path: Sequence[int]):
        """Native grouped-array variant of get_positions (same windows and
        dedup, no trailing filter — reference GetPositions semantics,
        graph.cc:651-728).  Returns (rids, starts, cnts, pos, ed, orient,
        total_len) or None when the native library is unavailable."""
        from ..native import get_lib

        if get_lib() is None:
            return None
        from ..core.paths import path_len as _plen, split_at_gaps
        from ..native import collect_positions_ptr

        ctgs, gaps = split_at_gaps(list(path))
        ctgs_with_st = []
        cur = 0
        total_len = 0
        for i, ctg in enumerate(ctgs):
            if i > 0:
                cur += gaps[i - 1]
            ctgs_with_st.append((ctg, cur))
            ln = _plen(graph, ctg)
            cur += ln
            total_len += ln
        out = collect_positions_ptr(
            self.stage_position_windows(graph, ctgs_with_st),
            use_filter=False, n_reads=self.get_number_of_reads())
        return out + (total_len,)

    def fwd_first_rids(self, graph, path: Sequence[int]):
        """Read ids whose FIRST position on the walk is forward-oriented —
        the advice move's mate-1 filter (reference moves.cc:956-963, where
        every proposal re-aligns the whole walk).  Memoized per walk
        content with missing-window validation: the result is a pure
        function of walk content for a fixed alignment-cache view, and the
        view only changes when one of the walk's missing windows becomes
        cached."""
        key = tuple(path)
        memo = getattr(self, "_advice_pos_memo", None)
        if memo is None:
            memo = self._advice_pos_memo = {}
        if len(memo) > 100_000:
            memo.clear()
        hit = self._memo_lookup(memo, key)
        if hit is not None:
            return hit
        grouped = self.get_positions_grouped(graph, path)
        if grouped is not None:
            rids_g, starts_g, _cnts, _pos, _ed, or_g, _tl = grouped
            res = [int(r) for r, s in zip(rids_g, starts_g) if or_g[s] == 0]
        else:
            positions1, _tl = self.get_positions(graph, path)
            res = [i for i in range(self.get_number_of_reads())
                   if positions1[i] and positions1[i][0][1][1] == 0]
        # per-contig missing-window lists for future validation
        from ..core.paths import path_len as _plen, split_at_gaps

        ctgs, gaps = split_at_gaps(list(path))
        ctgs_with_st = []
        cur = 0
        for i, ctg in enumerate(ctgs):
            if i > 0:
                cur += gaps[i - 1]
            ctgs_with_st.append((ctg, cur))
            cur += _plen(graph, ctg)
        stage_memo = getattr(self, "_stage_memo", None)
        missing: Optional[List] = []
        if stage_memo is None:
            missing = None
        else:
            for ctg, _st in ctgs_with_st:
                entry = stage_memo.get(tuple(ctg))
                if entry is None:
                    missing = None
                    break
                missing.extend(entry[2])
        if missing is not None:
            memo[key] = [res, self.cache_version, missing]
        return res

    # --------------------------------------------------------------- advice
    def build_advice_index(self, graph, threshold: int) -> None:
        """read -> long nodes it aligns to (reference BuildAdviceIndex,
        graph.cc:323-342)."""
        if self._advice_index_built:
            return
        self._advice_index_built = True
        # batch-precompute every long node's window in one aligner call
        # (otherwise each node pays its own dispatch — ruinous on the
        # device backend where a call is a chip round trip)
        todo = [(i,) for i in range(graph.num_nodes)
                if graph.node_len(i) > threshold
                and (i,) not in self.aligment_cache]
        if todo:
            self.precompute_alignment_for_subpaths(graph, todo)
        for i in range(graph.num_nodes):
            if graph.node_len(i) > threshold:
                positions: Dict[int, List[Alignment]] = {}
                self.get_positions_only_path(graph, [i], 0, positions)
                for rid, als in positions.items():
                    self.advice_index.setdefault(rid, []).append(i)
                    if als[0].orientation == 1:
                        self.advice_index1.setdefault(rid, []).append(i)
