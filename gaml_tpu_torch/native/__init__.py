"""ctypes bindings for the native host kernels, with build-on-demand.

``get_lib()`` returns the loaded library or None (callers fall back to the
Python implementations, which are bit-identical but slower).

The library is host C++ (``gaml_tpu_torch/csrc/gaml_native.cc``), built
with g++ into the port's build directory: under a file lock, into a
temporary file renamed into place, under a name derived from the source
and the command.  Processes that start at once (test workers, the CLI's
subprocesses) therefore never load a partly written file.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

from ..index.maxhash import index_csr
from ..ops.build import BUILD_DIR, CSRC

_SRC = os.path.join(CSRC, "gaml_native.cc")
GXX = ("g++", "-O3", "-march=native", "-funroll-loops", "-fopenmp",
       "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> str:
    """The build's path: keyed by the g++ command and the source."""
    h = hashlib.sha1(" ".join(GXX).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libgaml_native_{h.hexdigest()[:16]}.so")


def build() -> Optional[str]:
    """Compile the shared library unless it exists; its path, or None
    when g++ fails (with and without OpenMP)."""
    so = library_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so):
            return so
        tmp = f"{so}.{os.getpid()}.tmp"
        # toolchains without OpenMP: serial batch loop
        for cmd in (GXX, tuple(c for c in GXX if c != "-fopenmp")):
            try:
                subprocess.run([*cmd, "-o", tmp, _SRC], check=True,
                               capture_output=True)
            except (subprocess.CalledProcessError, OSError):
                continue
            os.replace(tmp, so)
            return so
        return None


def get_lib():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("GAML_TPU_NO_NATIVE") == "1":
            return None
        so = build()
        if so is None:
            return None
        # OpenMP workers must sleep between batch calls: spin-waiting
        # steals cores from the Python thread between native regions
        os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
        os.environ.setdefault("GOMP_SPINCOUNT", "0")
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.maxhash_window_query.restype = ctypes.c_int64
        lib.maxhash_window_query.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.process_hit_batch.restype = None
        lib.process_hit_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.paired_inc_pairs.restype = ctypes.c_int64
        lib.paired_inc_pairs.argtypes = [ctypes.c_void_p, ctypes.c_int32] + \
            [ctypes.c_void_p] * 12 + \
            [ctypes.c_void_p] * 4 + \
            [ctypes.c_void_p, ctypes.c_int64, ctypes.c_double,
             ctypes.c_double, ctypes.c_double, ctypes.c_double,
             ctypes.c_int32] + [ctypes.c_void_p] * 5
        lib.align_window.restype = ctypes.c_int64
        lib.align_window.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64]
        lib.align_windows_batch.restype = None
        lib.align_windows_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.query_window.restype = ctypes.c_int64
        lib.query_window.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64]
        lib.query_windows_batch.restype = None
        lib.query_windows_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.coverage_sweep.restype = ctypes.c_int64
        lib.coverage_sweep.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_double, ctypes.c_double]
        lib.collect_positions.restype = ctypes.c_int64
        lib.collect_positions.argtypes = [ctypes.c_int32] + \
            [ctypes.c_void_p] * 9 + [ctypes.c_int32] + \
            [ctypes.c_void_p] * 6 + [ctypes.c_void_p]
        lib.collect_positions_ptr.restype = ctypes.c_int64
        lib.collect_positions_ptr.argtypes = [ctypes.c_int32] + \
            [ctypes.c_void_p] * 8 + [ctypes.c_int32, ctypes.c_int32] + \
            [ctypes.c_void_p] * 6 + [ctypes.c_void_p]
        lib.paired_inc_pairs2.restype = ctypes.c_int64
        lib.paired_inc_pairs2.argtypes = \
            [ctypes.c_void_p] * 3 + [ctypes.c_int32] + [ctypes.c_void_p] * 3 + \
            [ctypes.c_void_p] * 3 + [ctypes.c_int32] + [ctypes.c_void_p] * 3 + \
            [ctypes.c_void_p] * 2 + [ctypes.c_void_p] * 4 + \
            [ctypes.c_void_p, ctypes.c_int64, ctypes.c_double,
             ctypes.c_double, ctypes.c_double, ctypes.c_double,
             ctypes.c_int32] + [ctypes.c_void_p] * 5
        lib.fastq_parse.restype = ctypes.c_void_p
        lib.fastq_parse.argtypes = [ctypes.c_char_p]
        for nm in ("fastq_num_reads", "fastq_codes_size", "fastq_names_size"):
            fn = getattr(lib, nm)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p]
        lib.fastq_copy.restype = None
        lib.fastq_copy.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 4
        lib.fastq_free.restype = None
        lib.fastq_free.argtypes = [ctypes.c_void_p]
        lib.read_index_build.restype = None
        lib.read_index_build.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.kmer_db_build.restype = ctypes.c_void_p
        lib.kmer_db_build.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int32, ctypes.c_int32]
        lib.kmer_db_n_ids.restype = ctypes.c_int64
        lib.kmer_db_n_ids.argtypes = [ctypes.c_void_p]
        lib.kmer_db_stream_size.restype = ctypes.c_int64
        lib.kmer_db_stream_size.argtypes = [ctypes.c_void_p]
        lib.kmer_db_copy.restype = None
        lib.kmer_db_copy.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 3
        lib.kmer_db_free.restype = None
        lib.kmer_db_free.argtypes = [ctypes.c_void_p]
        lib.banded_forward_host.restype = None
        lib.banded_forward_host.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_double, ctypes.c_double,
            ctypes.c_void_p]
        lib.reduce_floored_logs.restype = ctypes.c_double
        lib.reduce_floored_logs.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_double,
            ctypes.c_int64, ctypes.c_void_p]
        for name in ("reach_limit_compute", "reach_big_compute"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_void_p
            fn.argtypes = [ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int32]
        lib.reach_result_size.restype = ctypes.c_int64
        lib.reach_result_size.argtypes = [ctypes.c_void_p]
        lib.reach_result_copy.restype = None
        lib.reach_result_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.reach_free.restype = None
        lib.reach_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def _ptr(arr: np.ndarray):
    # c_void_p argtypes accept the raw address int; avoids a ctypes cast
    # object per call (hot: dozens of pointers per score call)
    return arr.ctypes.data


def maxhash_window_query(seq: np.ndarray, read_len: int) -> List[Tuple[int, int]]:
    lib = get_lib()
    assert lib is not None
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    cap = max(16, len(seq))
    out_hash = np.zeros(cap, dtype=np.uint64)
    out_pos = np.zeros(cap, dtype=np.int32)
    n = lib.maxhash_window_query(_ptr(seq), len(seq), read_len,
                                 _ptr(out_hash), _ptr(out_pos), cap)
    return [(int(out_hash[i]), int(out_pos[i])) for i in range(n)]


def process_hit_batch(genome: np.ndarray, cands) -> List[Optional[Tuple[int, int]]]:
    """cands: [(g0, r0, read_codes)].  Returns [(errs, begin) or None]."""
    lib = get_lib()
    assert lib is not None
    n = len(cands)
    if n == 0:
        return []
    genome = np.ascontiguousarray(genome, dtype=np.uint8)
    reads_buf = np.concatenate([np.ascontiguousarray(c[2], dtype=np.uint8)
                                for c in cands])
    offsets = np.zeros(n, dtype=np.int64)
    rlens = np.zeros(n, dtype=np.int32)
    acc = 0
    for i, c in enumerate(cands):
        offsets[i] = acc
        rlens[i] = len(c[2])
        acc += len(c[2])
    g0s = np.array([c[0] for c in cands], dtype=np.int32)
    r0s = np.array([c[1] for c in cands], dtype=np.int32)
    out_errs = np.zeros(n, dtype=np.int32)
    out_begin = np.zeros(n, dtype=np.int32)
    lib.process_hit_batch(_ptr(genome), len(genome), _ptr(reads_buf),
                          _ptr(offsets), _ptr(rlens), _ptr(g0s), _ptr(r0s),
                          n, _ptr(out_errs), _ptr(out_begin))
    return [None if out_errs[i] < 0 else (int(out_errs[i]), int(out_begin[i]))
            for i in range(n)]


def paired_inc_pairs(rids, p1_start, p1_cnt, pos1, ed1, or1,
                     p2_start, p2_cnt, pos2, ed2, or2, rlen1, rlen2,
                     match_pow1, mismatch_pow1, match_pow2, mismatch_pow2,
                     ins_table, ins_mean, ins_std, min_prob_start,
                     min_prob_per_base, use_all_to_cov, total_pairs):
    """Native pair-product loop; returns (p [np], rid [np], ev_pos, ev_typ)."""
    lib = get_lib()
    assert lib is not None
    out_p = np.zeros(max(total_pairs, 1), dtype=np.float64)
    out_rid = np.zeros(max(total_pairs, 1), dtype=np.int32)
    cap_ev = 2 * max(total_pairs, 1)
    out_ev_pos = np.zeros(cap_ev, dtype=np.int32)
    out_ev_typ = np.zeros(cap_ev, dtype=np.int32)
    out_ev_cnt = np.zeros(1, dtype=np.int64)
    n = lib.paired_inc_pairs(
        _ptr(rids), len(rids),
        _ptr(p1_start), _ptr(p1_cnt), _ptr(pos1), _ptr(ed1), _ptr(or1),
        _ptr(p2_start), _ptr(p2_cnt), _ptr(pos2), _ptr(ed2), _ptr(or2),
        _ptr(rlen1), _ptr(rlen2),
        _ptr(match_pow1), _ptr(mismatch_pow1),
        _ptr(match_pow2), _ptr(mismatch_pow2),
        _ptr(ins_table), len(ins_table), ins_mean, ins_std,
        min_prob_start, min_prob_per_base, int(use_all_to_cov),
        _ptr(out_p), _ptr(out_rid), _ptr(out_ev_pos), _ptr(out_ev_typ),
        _ptr(out_ev_cnt))
    ne = int(out_ev_cnt[0])
    return out_p[:n], out_rid[:n], out_ev_pos[:ne], out_ev_typ[:ne]


def read_fastq_arrays(path: str):
    """Native FASTQ parse: (codes buffer uint8, read_offsets int64,
    names list[str]).  Returns None when the library is unavailable or the
    file cannot be read."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.fastq_parse(path.encode())
    if not h:
        return None
    n = lib.fastq_num_reads(h)
    codes = np.empty(lib.fastq_codes_size(h), dtype=np.uint8)
    read_off = np.empty(n + 1, dtype=np.int64)
    names_buf = np.empty(lib.fastq_names_size(h), dtype=np.uint8)
    name_off = np.empty(n + 1, dtype=np.int64)
    lib.fastq_copy(h, _ptr(codes), _ptr(read_off), _ptr(names_buf),
                   _ptr(name_off))
    lib.fastq_free(h)
    raw = names_buf.tobytes()
    names = [raw[name_off[i]:name_off[i + 1]].decode()
             for i in range(n)]
    return codes, read_off, names


class NativeAlignBundle:
    """Prepared arrays for the native window aligner: sorted fingerprint
    index, contiguous read-code matrices (fwd + rc), per-read seed
    positions, and the rid->row map."""

    def __init__(self, index_dict, read_len, codes_fwd, codes_rc,
                 seed_pos, row_of):
        fps, self.fp_off, rids = index_csr(index_dict)
        self.fp_sorted = fps.astype(np.uint64)
        self.fp_rids = rids.astype(np.int32)
        self.read_len = read_len
        self.codes_fwd = np.ascontiguousarray(codes_fwd)
        self.codes_rc = np.ascontiguousarray(codes_rc)
        self.seed_pos = np.ascontiguousarray(seed_pos.astype(np.int32))
        self.row_of = np.ascontiguousarray(row_of.astype(np.int32))


def align_window(bundle: NativeAlignBundle, seq: np.ndarray, offset: int):
    """Native full window alignment; returns (pos, ed, rid, orient) sorted
    column arrays."""
    lib = get_lib()
    assert lib is not None
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    cap = 4 * len(seq) + 1024
    while True:
        out_pos = np.empty(cap, dtype=np.int32)
        out_ed = np.empty(cap, dtype=np.int32)
        out_rid = np.empty(cap, dtype=np.int32)
        out_or = np.empty(cap, dtype=np.int32)
        n = lib.align_window(
            seq.ctypes.data, len(seq), bundle.read_len, offset,
            bundle.fp_sorted.ctypes.data, bundle.fp_off.ctypes.data, bundle.fp_rids.ctypes.data,
            len(bundle.fp_sorted),
            bundle.codes_fwd.ctypes.data, bundle.codes_rc.ctypes.data,
            bundle.codes_fwd.shape[1] if bundle.codes_fwd.ndim == 2 else 0,
            bundle.seed_pos.ctypes.data, bundle.row_of.ctypes.data,
            out_pos.ctypes.data, out_ed.ctypes.data, out_rid.ctypes.data, out_or.ctypes.data, cap)
        if n <= cap:
            break
        cap = int(n) + 64
    return (out_pos[:n].copy(), out_ed[:n].copy(), out_rid[:n].copy(),
            out_or[:n].copy())


def query_window_native(bundle: NativeAlignBundle, seq: np.ndarray):
    """Native candidate query for one window (no extension): returns
    (rid, g0, r0, orient) int32 arrays in the aligner's candidate order."""
    lib = get_lib()
    assert lib is not None
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    cap = 4 * len(seq) + 1024
    while True:
        out = [np.empty(cap, dtype=np.int32) for _ in range(4)]
        n = lib.query_window(
            seq.ctypes.data, len(seq), bundle.read_len,
            bundle.fp_sorted.ctypes.data, bundle.fp_off.ctypes.data,
            bundle.fp_rids.ctypes.data, len(bundle.fp_sorted),
            bundle.seed_pos.ctypes.data, bundle.row_of.ctypes.data,
            out[0].ctypes.data, out[1].ctypes.data, out[2].ctypes.data,
            out[3].ctypes.data, cap)
        if n <= cap:
            break
        cap = int(n) + 64
    return tuple(o[:n].copy() for o in out)


_QUERY_POOL = None


def query_windows_batch(bundle: NativeAlignBundle, seqs: List[np.ndarray]):
    """Candidate queries for many windows in one native call
    (OpenMP-parallel).  Returns a list of (rid, g0, r0, orient) tuples
    parallel to ``seqs`` — the device backend's host-side candidate
    generation."""
    lib = get_lib()
    assert lib is not None
    n_win = len(seqs)
    if n_win == 0:
        return []
    seq_buf = np.concatenate([np.ascontiguousarray(s, dtype=np.uint8)
                              for s in seqs])
    seq_len = np.array([len(s) for s in seqs], dtype=np.int64)
    seq_off = np.zeros(n_win, dtype=np.int64)
    np.cumsum(seq_len[:-1], out=seq_off[1:])
    caps = 4 * seq_len + 1024
    out_off = np.zeros(n_win + 1, dtype=np.int64)
    np.cumsum(caps, out=out_off[1:])
    total = int(out_off[-1])
    pool = _QUERY_POOL
    if pool is None or len(pool[0]) < total:
        pool = tuple(np.empty(total, dtype=np.int32) for _ in range(4))
        globals()["_QUERY_POOL"] = pool
    out_rid, out_g0, out_r0, out_or = pool
    out_ns = np.zeros(n_win, dtype=np.int64)
    lib.query_windows_batch(
        seq_buf.ctypes.data, seq_off.ctypes.data, seq_len.ctypes.data,
        n_win, bundle.read_len,
        bundle.fp_sorted.ctypes.data, bundle.fp_off.ctypes.data,
        bundle.fp_rids.ctypes.data, len(bundle.fp_sorted),
        bundle.seed_pos.ctypes.data, bundle.row_of.ctypes.data,
        out_off.ctypes.data, out_rid.ctypes.data, out_g0.ctypes.data,
        out_r0.ctypes.data, out_or.ctypes.data, out_ns.ctypes.data)
    results = []
    for i in range(n_win):
        n = int(out_ns[i])
        if n > int(caps[i]):  # overflow: redo this window alone
            results.append(query_window_native(bundle, seqs[i]))
            continue
        a, b = int(out_off[i]), int(out_off[i]) + n
        results.append((out_rid[a:b].copy(), out_g0[a:b].copy(),
                        out_r0[a:b].copy(), out_or[a:b].copy()))
    return results


_BATCH_POOL = None
_EV_POOL = None


def align_windows_batch(bundle: NativeAlignBundle, seqs: List[np.ndarray],
                        offsets: List[int]):
    """Align many windows in one native call (OpenMP-parallel across
    windows; bit-identical to serial align_window per window).  Returns a
    list of (pos, ed, rid, orient) tuples parallel to ``seqs``."""
    lib = get_lib()
    assert lib is not None
    n_win = len(seqs)
    if n_win == 0:
        return []
    seq_buf = np.concatenate([np.ascontiguousarray(s, dtype=np.uint8)
                              for s in seqs])
    seq_len = np.array([len(s) for s in seqs], dtype=np.int64)
    seq_off = np.zeros(n_win, dtype=np.int64)
    np.cumsum(seq_len[:-1], out=seq_off[1:])
    off32 = np.asarray(offsets, dtype=np.int32)
    caps = 4 * seq_len + 1024
    out_off = np.zeros(n_win + 1, dtype=np.int64)
    np.cumsum(caps, out=out_off[1:])
    total = int(out_off[-1])
    # persistent output pool: big batches would otherwise page-fault
    # hundreds of MB of fresh pages every call
    pool = _BATCH_POOL
    if pool is None or len(pool[0]) < total:
        pool = (np.empty(total, dtype=np.int32),
                np.empty(total, dtype=np.int32),
                np.empty(total, dtype=np.int32),
                np.empty(total, dtype=np.int32))
        globals()["_BATCH_POOL"] = pool
    out_pos, out_ed, out_rid, out_or = pool
    out_ns = np.zeros(n_win, dtype=np.int64)
    lib.align_windows_batch(
        seq_buf.ctypes.data, seq_off.ctypes.data, seq_len.ctypes.data,
        off32.ctypes.data, n_win, bundle.read_len,
        bundle.fp_sorted.ctypes.data, bundle.fp_off.ctypes.data,
        bundle.fp_rids.ctypes.data, len(bundle.fp_sorted),
        bundle.codes_fwd.ctypes.data, bundle.codes_rc.ctypes.data,
        bundle.codes_fwd.shape[1] if bundle.codes_fwd.ndim == 2 else 0,
        bundle.seed_pos.ctypes.data, bundle.row_of.ctypes.data,
        out_off.ctypes.data, out_pos.ctypes.data, out_ed.ctypes.data,
        out_rid.ctypes.data, out_or.ctypes.data, out_ns.ctypes.data)
    results = []
    for i in range(n_win):
        n = int(out_ns[i])
        if n > int(caps[i]):  # overflow: redo this window alone
            results.append(align_window(bundle, seqs[i], int(offsets[i])))
            continue
        a, b = int(out_off[i]), int(out_off[i]) + n
        results.append((out_pos[a:b].copy(), out_ed[a:b].copy(),
                        out_rid[a:b].copy(), out_or[a:b].copy()))
    return results


def read_index_build(codes_mat: np.ndarray, k: int = 15):
    """One-pass ingestion over a [n, L] uniform-length code matrix:
    returns (fp u64[n], ok u8[n], kmers u32[n,m], rc_kmers u32[n,m],
    seed_pos i32[n,2]) — bit-identical to the numpy pipeline
    (pack_kmers_batch / revcomp_kmers / maxhash_of_reads_batch /
    _ReadCache.build_precomputes)."""
    lib = get_lib()
    assert lib is not None
    codes_mat = np.ascontiguousarray(codes_mat, dtype=np.uint8)
    n, L = codes_mat.shape
    m = max(L - k + 1, 0)
    fp = np.zeros(n, dtype=np.uint64)
    ok = np.zeros(n, dtype=np.uint8)
    kmers = np.empty((n, m), dtype=np.uint32)
    rc = np.empty((n, m), dtype=np.uint32)
    seed = np.zeros((n, 2), dtype=np.int32)
    if m:
        lib.read_index_build(_ptr(codes_mat), n, L, k, _ptr(fp), _ptr(ok),
                             _ptr(kmers), _ptr(rc), _ptr(seed))
    return fp, ok, kmers, rc, seed


def kmer_db_build(codes: np.ndarray, ctg_off: np.ndarray, k: int):
    """Native k-mer DB for the assembly->graph bootstrap.  Returns
    (streams int32 — concatenated per-contig id streams, char_of uint8
    per id, ignored uint8 per id).  Requires odd k (2-bit palindromes are
    impossible then, matching the reference db's overwrite quirk only in
    the case that cannot occur)."""
    lib = get_lib()
    assert lib is not None
    assert k % 2 == 1
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    ctg_off = np.ascontiguousarray(ctg_off, dtype=np.int64)
    h = lib.kmer_db_build(_ptr(codes), _ptr(ctg_off), len(ctg_off) - 1, k)
    n_ids = lib.kmer_db_n_ids(h)
    streams = np.empty(lib.kmer_db_stream_size(h), dtype=np.int32)
    char_of = np.empty(max(n_ids, 1), dtype=np.uint8)
    ignored = np.empty(max(n_ids, 1), dtype=np.uint8)
    lib.kmer_db_copy(h, _ptr(streams), _ptr(char_of), _ptr(ignored))
    lib.kmer_db_free(h)
    return streams, char_of[:n_ids], ignored[:n_ids]


def banded_forward_host(genome: np.ndarray, reads: np.ndarray,
                        rlens: np.ndarray, centers: np.ndarray,
                        gstarts: np.ndarray, glens: np.ndarray,
                        log_match: float, log_mismatch: float,
                        width: int) -> np.ndarray:
    """Host banded forward DP (same band semantics as ops.forward.
    banded_forward; double accumulation).  Returns logprob [B]."""
    lib = get_lib()
    assert lib is not None
    genome = np.ascontiguousarray(genome, dtype=np.uint8)
    reads = np.ascontiguousarray(reads, dtype=np.uint8)
    rlens = np.ascontiguousarray(rlens, dtype=np.int32)
    centers = np.ascontiguousarray(centers, dtype=np.int32)
    gstarts = np.ascontiguousarray(gstarts, dtype=np.int32)
    glens = np.ascontiguousarray(glens, dtype=np.int32)
    b, rmax = reads.shape
    out = np.zeros(b, dtype=np.float64)
    lib.banded_forward_host(_ptr(genome), len(genome), _ptr(reads), rmax,
                            _ptr(rlens), _ptr(centers), _ptr(gstarts),
                            _ptr(glens), b, int(width), float(log_match),
                            float(log_mismatch), _ptr(out))
    return out


def reduce_floored_logs(logp: np.ndarray, logt: np.ndarray,
                        log2len: float):
    """Native floored mean-log reduction: returns (sum of per-read floored
    logs, zero_reads)."""
    lib = get_lib()
    assert lib is not None
    zeros = np.zeros(1, dtype=np.int64)
    s = lib.reduce_floored_logs(_ptr(logp), _ptr(logt), float(log2len),
                                len(logp), _ptr(zeros))
    return float(s), int(zeros[0])


def coverage_sweep(ev_pos: np.ndarray, ev_typ: np.ndarray,
                   exp_cov_move: float, span_limit: float) -> int:
    """Native event sort + coverage-gap sweep."""
    lib = get_lib()
    assert lib is not None
    ev_pos = np.ascontiguousarray(ev_pos, dtype=np.int32)
    ev_typ = np.ascontiguousarray(ev_typ, dtype=np.int32)
    return int(lib.coverage_sweep(ev_pos.ctypes.data, ev_typ.ctypes.data,
                                  len(ev_pos), float(exp_cov_move),
                                  float(span_limit)))


def collect_positions(meta, flat, use_filter: bool = True, pool=None):
    """Run the native position collection; returns grouped arrays
    (rids, starts, cnts, pos, ed, orient).  use_filter selects the
    GetPositionsOnlyPath trailing-duplicate filter; off = AddPositions
    semantics.  ``pool``: an optional caller-owned single-slot buffer pool
    (a one-element list) reused across calls — the returned arrays are
    views into it, valid only until the caller's next call with the same
    pool."""
    lib = get_lib()
    assert lib is not None
    w_off, w_len, w_curpos, w_group, w_ctg = meta
    a_pos, a_ed, a_rid, a_or = flat
    n_windows = len(w_off)
    cap = max(1, len(a_pos))
    bufs = pool[0] if pool is not None and pool[0] is not None else None
    if bufs is None or len(bufs[0]) < cap:
        bufs = (np.empty(cap, dtype=np.int32), np.empty(cap, dtype=np.int64),
                np.empty(cap, dtype=np.int32), np.empty(cap, dtype=np.int32),
                np.empty(cap, dtype=np.int32), np.empty(cap, dtype=np.int32))
        if pool is not None:
            pool[0] = bufs
    out_rid, out_start, out_cnt, out_pos, out_ed, out_or = bufs
    out_nreads = np.zeros(1, dtype=np.int32)
    lib.collect_positions(
        n_windows, w_off.ctypes.data, w_len.ctypes.data, w_curpos.ctypes.data, w_group.ctypes.data,
        w_ctg.ctypes.data, a_pos.ctypes.data, a_ed.ctypes.data, a_rid.ctypes.data, a_or.ctypes.data,
        int(use_filter),
        out_rid.ctypes.data, out_start.ctypes.data, out_cnt.ctypes.data, out_pos.ctypes.data,
        out_ed.ctypes.data, out_or.ctypes.data, out_nreads.ctypes.data)
    nr = int(out_nreads[0])
    return (out_rid[:nr], out_start[:nr], out_cnt[:nr],
            out_pos, out_ed, out_or)


def collect_positions_ptr(staged, use_filter: bool = True, pool=None,
                          n_reads: int = 0):
    """Pointer-per-window native position collection — same output as
    collect_positions but the window columns are read in place from the
    alignment cache (no flat concatenation).  ``staged`` is the bundle
    from ReadSet.stage_position_windows: (ptr_pos, ptr_ed, ptr_rid,
    ptr_or, w_len, w_curpos, w_group, w_ctg, total, keepalive).
    ``n_reads`` > 0 promises every rid is below it (skips a pre-pass)."""
    lib = get_lib()
    assert lib is not None
    (p_pos, p_ed, p_rid, p_or, w_len, w_curpos, w_group, w_ctg,
     total, _keep) = staged
    n_windows = len(w_len)
    cap = max(1, int(total))
    bufs = pool[0] if pool is not None and pool[0] is not None else None
    if bufs is None or len(bufs[0]) < cap:
        bufs = (np.empty(cap, dtype=np.int32), np.empty(cap, dtype=np.int64),
                np.empty(cap, dtype=np.int32), np.empty(cap, dtype=np.int32),
                np.empty(cap, dtype=np.int32), np.empty(cap, dtype=np.int32))
        if pool is not None:
            pool[0] = bufs
    out_rid, out_start, out_cnt, out_pos, out_ed, out_or = bufs
    out_nreads = np.zeros(1, dtype=np.int32)
    lib.collect_positions_ptr(
        n_windows, p_pos.ctypes.data, p_ed.ctypes.data, p_rid.ctypes.data,
        p_or.ctypes.data, w_len.ctypes.data, w_curpos.ctypes.data,
        w_group.ctypes.data, w_ctg.ctypes.data, int(use_filter),
        int(n_reads),
        out_rid.ctypes.data, out_start.ctypes.data, out_cnt.ctypes.data,
        out_pos.ctypes.data, out_ed.ctypes.data, out_or.ctypes.data,
        out_nreads.ctypes.data)
    nr = int(out_nreads[0])
    return (out_rid[:nr], out_start[:nr], out_cnt[:nr],
            out_pos, out_ed, out_or)


def paired_inc_pairs2(g1, g2, rlen1_all, rlen2_all, match_pow1,
                      mismatch_pow1, match_pow2, mismatch_pow2, ins_table,
                      ins_mean, ins_std, min_prob_start, min_prob_per_base,
                      use_all_to_cov):
    """Two-sided native pair loop on grouped position sets."""
    lib = get_lib()
    assert lib is not None
    rid1, st1, cnt1, pos1, ed1, or1 = g1
    rid2, st2, cnt2, pos2, ed2, or2 = g2
    # pair capacity: match rids via searchsorted
    idx = np.searchsorted(rid2, rid1)
    idx = np.clip(idx, 0, max(len(rid2) - 1, 0))
    common = len(rid2) > 0 and len(rid1) > 0
    total_pairs = 0
    if common:
        match_mask = (idx < len(rid2)) & (rid2[idx] == rid1)
        total_pairs = int(np.sum(cnt1[match_mask].astype(np.int64) *
                                 cnt2[idx[match_mask]]))
    # out_p / out_rid may be retained by the caller (contribution memos):
    # fresh allocations.  The event buffers are consumed immediately, so
    # they come from a module pool.
    out_p = np.zeros(max(total_pairs, 1), dtype=np.float64)
    out_rid = np.zeros(max(total_pairs, 1), dtype=np.int32)
    ev_cap = 2 * max(total_pairs, 1)
    evp = _EV_POOL
    if evp is None or len(evp[0]) < ev_cap:
        evp = (np.empty(ev_cap, dtype=np.int32),
               np.empty(ev_cap, dtype=np.int32))
        globals()["_EV_POOL"] = evp
    out_ev_pos, out_ev_typ = evp
    out_ev_cnt = np.zeros(1, dtype=np.int64)
    n = lib.paired_inc_pairs2(
        rid1.ctypes.data, st1.ctypes.data, cnt1.ctypes.data, len(rid1),
        pos1.ctypes.data, ed1.ctypes.data, or1.ctypes.data,
        rid2.ctypes.data, st2.ctypes.data, cnt2.ctypes.data, len(rid2),
        pos2.ctypes.data, ed2.ctypes.data, or2.ctypes.data,
        rlen1_all.ctypes.data, rlen2_all.ctypes.data,
        match_pow1.ctypes.data, mismatch_pow1.ctypes.data,
        match_pow2.ctypes.data, mismatch_pow2.ctypes.data,
        ins_table.ctypes.data, len(ins_table), ins_mean, ins_std,
        min_prob_start, min_prob_per_base, int(use_all_to_cov),
        out_p.ctypes.data, out_rid.ctypes.data, out_ev_pos.ctypes.data, out_ev_typ.ctypes.data,
        out_ev_cnt.ctypes.data)
    ne = int(out_ev_cnt[0])
    return out_p[:n], out_rid[:n], out_ev_pos[:ne], out_ev_typ[:ne]


def _decode_reach(handle, lib):
    size = lib.reach_result_size(handle)
    buf = np.zeros(size, dtype=np.int32)
    if size:
        lib.reach_result_copy(handle, _ptr(buf))
    lib.reach_free(handle)
    out = {}
    i = 0
    while i < size:
        frm, to, ln = int(buf[i]), int(buf[i + 1]), int(buf[i + 2])
        out.setdefault(frm, {})[to] = [int(x) for x in buf[i + 3:i + 3 + ln]]
        i += 3 + ln
    return out


def _csr(graph):
    starts = np.zeros(graph.num_nodes + 1, dtype=np.int32)
    idx = []
    for i in range(graph.num_nodes):
        starts[i + 1] = starts[i] + len(graph.next[i])
        idx.extend(graph.next[i])
    return starts, np.array(idx, dtype=np.int32)


def reach_limit(graph, max_dist: int):
    lib = get_lib()
    assert lib is not None
    starts, idx = _csr(graph)
    lens = np.array([graph.node_len(i) for i in range(graph.num_nodes)],
                    dtype=np.int32)
    handle = lib.reach_limit_compute(graph.num_nodes, _ptr(starts), _ptr(idx),
                                     _ptr(lens), max_dist)
    return _decode_reach(handle, lib)


def reach_big(graph, threshold: int):
    lib = get_lib()
    assert lib is not None
    starts, idx = _csr(graph)
    lens = np.array([graph.node_len(i) for i in range(graph.num_nodes)],
                    dtype=np.int32)
    handle = lib.reach_big_compute(graph.num_nodes, _ptr(starts), _ptr(idx),
                                   _ptr(lens), threshold)
    return _decode_reach(handle, lib)
