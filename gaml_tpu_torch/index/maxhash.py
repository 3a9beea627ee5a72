"""Max-hash read fingerprint index.

Despite the reference's "MinHash" naming, the fingerprint is the *maximum*
over a read's 2-bit-packed 15-mers of ``kmer ^ 0x2204abcd``
(reference: graph.cc:1243-1269).  The hash is injective, so fingerprint
equality implies the two sequences share that exact k-mer.

Index build: fingerprint(read) -> [read ids]  (graph.cc:1280-1287; reads
containing non-ACGT are skipped, and the uniform read length is remembered).

Query: slide a read-length window over the genome; for each window take the
max hash and its (first-on-tie) k-mer end position via a monotonic deque;
collapse runs of equal fingerprints (graph.cc:1289-1323).  Hits against the
reverse-complement strand are queried on the reverse-complemented genome and
reported as negative positions (graph.cc:1338-1347).

This module is the numpy implementation; ``gaml_tpu.native`` provides a C++
drop-in used when built (same outputs, bit-for-bit).
"""
from __future__ import annotations

import itertools
from typing import Dict, List, Tuple

import numpy as np

from ..core import dna

K_INDEX_KMER = 15  # reference kIndexKmer (graph.cc:33)
HASH_XOR = np.uint64(0x2204ABCD)  # reference Hash (graph.cc:1243-1252)

_KMER_MASK = np.uint64((1 << (2 * K_INDEX_KMER)) - 1)


def pack_kmers(codes: np.ndarray, k: int = K_INDEX_KMER) -> np.ndarray:
    """2-bit pack every k-mer of an encoded sequence (big-endian in the low
    2k bits, first base most significant) — matching the reference's rolling
    ``curhash = curhash<<2 | trans[c]``.

    Non-ACGT codes (CODE_N=4) contribute bits of 0 (= 'G'), which is what the
    reference's trans table does for any byte it never initialized to a
    nonzero value; reads with Ns never enter the index anyway
    (graph.cc:1280-1283).
    """
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint64)
    vals = np.where(codes < 4, codes, 0).astype(np.uint64)
    # rolling 2-bit pack with in-place ops (hot path: called per read and
    # per subpath window)
    acc = vals[:n].copy()
    two = np.uint64(2)
    for j in range(1, k):
        acc <<= two
        np.bitwise_or(acc, vals[j:j + n], out=acc)
    acc &= _KMER_MASK
    return acc


def hash_kmers(kmers: np.ndarray) -> np.ndarray:
    return kmers ^ HASH_XOR


def maxhash_of_read(codes: np.ndarray) -> int:
    """Fingerprint of a full read (reference GetMinHashForSeq,
    graph.cc:1254-1269).  Note the reference seeds its running max with 0, so
    the result is max(0, max hashes) — hashes are always > 0 in practice."""
    h = hash_kmers(pack_kmers(codes))
    if len(h) == 0:
        return 0
    return int(max(np.uint64(0), h.max()))


def window_max_fingerprints(codes: np.ndarray, read_len: int) -> List[Tuple[int, int]]:
    """All (fingerprint, kmer_end_pos) for read-length windows of a genome,
    with runs of equal fingerprints collapsed (reference GetMinHashWithPoses,
    graph.cc:1289-1323).  Position is the *end* index of the max k-mer; on
    ties the earliest k-mer wins (strict-less pop in the reference deque).

    Dispatches to the C++ monotonic-deque kernel when built (bit-identical;
    see gaml_tpu/native)."""
    from ..native import get_lib

    if get_lib() is not None:
        from ..native import maxhash_window_query

        return maxhash_window_query(np.ascontiguousarray(codes), read_len)
    k = K_INDEX_KMER
    if len(codes) < k or len(codes) < read_len:
        return []
    h = hash_kmers(pack_kmers(codes, k))  # h[j] is kmer ending at j+k-1
    w = read_len - k + 1  # kmers per window
    if w <= 0:
        return []
    # window ending at genome index i covers kmer-end positions [i-w+1 .. i]
    # -> kmer array slice [i-read_len+1 .. i-k+1] (0-based kmer start idx)
    from numpy.lib.stride_tricks import sliding_window_view

    wins = sliding_window_view(h, w)  # wins[s] = h[s:s+w]
    maxv = wins.max(axis=1)
    argm = wins.argmax(axis=1)  # first max on ties — matches deque
    out: List[Tuple[int, int]] = []
    last = None
    for s in range(len(wins)):
        mh = int(maxv[s])
        if last is None or mh != last:
            # kmer index s+argm -> end position s+argm+k-1
            out.append((mh, int(s + argm[s] + k - 1)))
            last = mh
    return out


def pack_kmers_batch(codes_2d: np.ndarray, k: int = K_INDEX_KMER) -> np.ndarray:
    """Packed k-mers for a [n_reads, read_len] code matrix -> [n, m] uint32
    (2k <= 32 bits).  One vectorized pass for all reads."""
    n, L = codes_2d.shape
    m = L - k + 1
    if m <= 0:
        return np.zeros((n, 0), dtype=np.uint32)
    vals = np.where(codes_2d < 4, codes_2d, 0).astype(np.uint32)
    acc = vals[:, :m].copy()
    two = np.uint32(2)
    for j in range(1, k):
        acc <<= two
        np.bitwise_or(acc, vals[:, j:j + m], out=acc)
    acc &= np.uint32(_KMER_MASK)
    return acc


def revcomp_kmers(kmers: np.ndarray, k: int = K_INDEX_KMER) -> np.ndarray:
    """Reverse-complement packed k-mer values (complement = per-base XOR 3,
    then reverse the 2-bit groups)."""
    v = (kmers.astype(np.uint32) ^ np.uint32((1 << (2 * k)) - 1))
    r = np.zeros_like(v)
    tmp = np.empty_like(v)
    two = np.uint32(2)
    three = np.uint32(3)
    for _ in range(k):
        r <<= two
        np.bitwise_and(v, three, out=tmp)
        np.bitwise_or(r, tmp, out=r)
        v >>= two
    return r


def maxhash_of_reads_batch(codes_2d: np.ndarray) -> np.ndarray:
    """Fingerprints of a [n_reads, read_len] code matrix in one pass."""
    kmers = pack_kmers_batch(codes_2d)
    if kmers.shape[1] == 0:
        return np.zeros(codes_2d.shape[0], dtype=np.uint64)
    hashes = kmers ^ np.uint32(HASH_XOR)
    return hashes.max(axis=1).astype(np.uint64)


def index_csr(index: Dict[int, List[int]]):
    """A max-hash index dict (fingerprint -> read ids) as a CSR sorted by
    fingerprint: (fingerprints int64 [n_fp], offsets int64 [n_fp + 1],
    read ids int64 [offsets[-1]]), each list in its own order."""
    n = len(index)
    keys = np.fromiter(index.keys(), np.int64, n)
    counts = np.fromiter(map(len, index.values()), np.int64, n)
    flat = np.fromiter(itertools.chain.from_iterable(index.values()),
                       np.int64, int(counts.sum()))
    order = np.argsort(keys, kind="stable")
    cnt = counts[order]
    off = np.zeros(n + 1, np.int64)
    np.cumsum(cnt, out=off[1:])
    start = (np.cumsum(counts) - counts)[order]
    rids = flat[np.repeat(start - off[:-1], cnt) + np.arange(len(flat))]
    return keys[order], off, rids


class ReadIndexMaxHash:
    """Fingerprint -> read-id lists, plus the query machinery."""

    def __init__(self):
        self.index: Dict[int, List[int]] = {}
        self.read_len: int = 0

    def add_read(self, codes: np.ndarray, read_id: int) -> None:
        if not dna.is_acgt(codes):
            return
        self.index.setdefault(maxhash_of_read(codes), []).append(read_id)
        self.read_len = len(codes)

    def add_reads_batch(self, codes_list, read_ids) -> None:
        """Bulk insertion; uniform-length ACGT reads take the vectorized
        path, the rest fall back to add_read."""
        uniform = {}
        for codes, rid in zip(codes_list, read_ids):
            if dna.is_acgt(codes):
                uniform.setdefault(len(codes), []).append((codes, rid))
        for L, group in uniform.items():
            mat = np.stack([c for c, _ in group])
            fps = maxhash_of_reads_batch(mat)
            for (c, rid), fp in zip(group, fps):
                self.index.setdefault(int(fp), []).append(rid)
            self.read_len = L

    def get_read_cands_with_poses(self, seq_codes: np.ndarray) -> Dict[int, List[int]]:
        """read_id -> list of signed seed positions (k-mer end index;
        negative = hit against the reverse-complement strand, in
        reverse-strand coordinates) — reference GetReadCandsWithPoses
        (graph.cc:1325-1348)."""
        cands: Dict[int, List[int]] = {}
        for mh, pos in window_max_fingerprints(seq_codes, self.read_len):
            for rid in self.index.get(mh, ()):
                cands.setdefault(rid, []).append(pos)
        rc = dna.revcomp(seq_codes)
        for mh, pos in window_max_fingerprints(rc, self.read_len):
            for rid in self.index.get(mh, ()):
                cands.setdefault(rid, []).append(-pos)
        return cands

    def size_info(self) -> Tuple[int, int]:
        return len(self.index), sum(1 + len(v) for v in self.index.values())
