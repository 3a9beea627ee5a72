"""The long-read seed lookup on the card (csrc/seeds.cu): the wrapper, its
launch counts, its plain torch version and the numpy twin of its
algorithm.

One batch is every (range, read, strand) query of one precompute: the
ranges' spelled sub-walks concatenated in ``seq`` (``range_len`` each),
and segments, each a read row of the resident matrix
(ops/forward_device.py: row = rid + strand * n_reads), the range it is
looked up in and the read's length (at least SEED_K).  The answer is,
segment by segment, exactly what
``SortedKmerIndex(range).hits_kmers(pack_kmers(read row))`` gives
(align/longread.py): the hits (tpos, qpos), tpos in the range, in qpos
order and within a qpos in ascending position, at most MAX_KMER_OCC a
k-mer.  ``seed_hits`` returns them as (seg_off int64 [n_seg + 1], hits
int32 [total, 2]): segment s's hits are hits[seg_off[s]:seg_off[s + 1]].

``seed_hits`` runs the kernels, on rows on a CUDA device only (three
entry points, 2 x passes + 3 launches: 11 for up to 64 ranges, whose keys
take four 8-bit passes, 13 for up to 16384; two waits: the total, then the
one read-back of offsets and hits).  ``seed_hits_plain`` is the same
function in torch (a stable sort, two searchsorted) on the rows' own
device; the read set's CPU route is the host index, not this.
``seed_hits_twin`` writes the kernels' algorithm once more in numpy, step
for step, with the sort's and the query's tiles as parameters; the CPU
tests hold it to the host index at tiny tiles, so that keys, ranges and
segments cross tile edges.  The kernels replace no TPU kernel (the JAX
package looks seeds up in numpy, gaml_tpu/align/longread.py); csrc/seeds.cu
says what bounds them.
"""
from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

from ..align.longread import MAX_KMER_OCC, SEED_K
from ..utils.metrics import span

K_BITS = 2 * SEED_K  # bits of a packed k-mer (the key's low bits)
SORT_TILE = 4096  # keys a block of the radix sort (kSortTile in seeds.cu)
QUERY_TILE = 2048  # query k-mers a block of the count pass (kQTile)
QUERY_PER = 8  # consecutive query k-mers a thread (kQPer)
DIGIT_BITS = 8

# launches of each kernel by seed_hits
LAUNCHES = {"seeds_keys": 0, "seeds_hist": 0, "seeds_scatter": 0,
            "seeds_count": 0, "seeds_scan": 0, "seeds_expand": 0}


def _lib():
    """The kernel library, its seed constants checked on first load."""
    from .build import load

    lib = load()
    if not getattr(lib, "seeds_checked", False):
        if (lib.gaml_seeds_sort_tile(), lib.gaml_seeds_query_tile()) != \
                (SORT_TILE, QUERY_TILE):
            raise RuntimeError("csrc/seeds.cu's tiles differ from the "
                               "wrapper's")
        lib.seeds_checked = True
    return lib


def _call(name, stream, args):
    """Call ``gaml_<name>`` with ``args`` (tensors as their pointers, the
    rest as they are) on the CUDA stream ``stream``; raise on a CUDA
    error."""
    ptr = ctypes.c_void_p
    cargs = [ptr(a.data_ptr()) if isinstance(a, torch.Tensor) else a
             for a in args]
    err = getattr(_lib(), "gaml_" + name)(*cargs, ptr(stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def layout(range_len, seg_len):
    """(kstart int64 [n_ranges + 1]: each range's first walk k-mer in the
    sorted index; rbase int64 [n_ranges]: each range's start in seq;
    qstart int64 [n_seg + 1]: each segment's first query k-mer)."""
    range_len = np.asarray(range_len, dtype=np.int64)
    seg_len = np.asarray(seg_len, dtype=np.int64)
    kstart = np.zeros(len(range_len) + 1, dtype=np.int64)
    np.cumsum(np.maximum(range_len - SEED_K + 1, 0), out=kstart[1:])
    rbase = np.zeros(len(range_len), dtype=np.int64)
    np.cumsum(range_len[:-1], out=rbase[1:])
    qstart = np.zeros(len(seg_len) + 1, dtype=np.int64)
    np.cumsum(seg_len - SEED_K + 1, out=qstart[1:])
    return kstart, rbase, qstart


def _check(rows, seq, range_len, seg_row, seg_range, seg_len):
    """The batch's arrays as numpy, checked against each other and the
    rows."""
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    range_len = np.asarray(range_len, dtype=np.int64)
    seg_row = np.asarray(seg_row, dtype=np.int64)
    seg_range = np.asarray(seg_range, dtype=np.int64)
    seg_len = np.asarray(seg_len, dtype=np.int64)
    if rows.dtype != torch.uint8 or rows.dim() != 2 or \
            not rows.is_contiguous():
        raise ValueError(f"rows must be contiguous uint8 [n, width], got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    if int(range_len.sum()) != len(seq) or (range_len < 0).any():
        raise ValueError(f"{len(seq)} bases for ranges of {range_len}")
    if not len(seg_row) == len(seg_range) == len(seg_len):
        raise ValueError("segments' rows, ranges and lengths differ in "
                         "number")
    if len(seg_len) and (
            seg_len.min() < SEED_K or seg_len.max() > rows.shape[1] or
            seg_row.min() < 0 or seg_row.max() >= rows.shape[0] or
            seg_range.min() < 0 or seg_range.max() >= len(range_len)):
        raise ValueError("a segment's length, row or range is outside the "
                         "rows and ranges")
    if int(np.maximum(range_len - SEED_K + 1, 0).sum()) >= 2**31:
        raise ValueError("a batch's walk index holds at most 2^31 - 1 "
                         "k-mers")
    return seq, range_len, seg_row, seg_range, seg_len


def seed_hits(rows, seq, range_len, seg_row, seg_range, seg_len, ws=None):
    """(seg_off int64 [n_seg + 1], hits int32 [total, 2]) of one batch
    from the kernels, for rows on a CUDA device (``ws``: a Workspace kept
    by the caller)."""
    args = _check(rows, seq, range_len, seg_row, seg_range, seg_len)
    if rows.device.type != "cuda":
        raise ValueError(f"the seed kernels need rows on a CUDA device, "
                         f"got {rows.device}")
    return _seed_hits_kernel(rows, *args, ws or Workspace())


# ------------------------------------------------------------ the kernels
class Workspace:
    """Pinned int64 host buffers of one caller's batches by name (the
    batch's upload, the count's total, the read-back), each grown to the
    largest batch."""

    def __init__(self):
        self.bufs = {}

    def pinned(self, name: str, words: int) -> torch.Tensor:
        buf = self.bufs.get(name)
        if buf is None or buf.shape[0] < words:
            buf = self.bufs[name] = torch.empty(max(words, 1),
                                                dtype=torch.int64,
                                                pin_memory=True)
        return buf


def _seed_hits_kernel(rows, seq, range_len, seg_row, seg_range, seg_len,
                      ws):
    dev = rows.device
    n_ranges, n_seg = len(range_len), len(seg_len)
    kstart, rbase, qstart = layout(range_len, seg_len)
    n_t, n_q = int(kstart[-1]), int(qstart[-1])
    if n_seg == 0 or n_t == 0:
        return np.zeros(n_seg + 1, np.int64), np.zeros((0, 2), np.int32)
    here = dev.index is None or dev.index == torch.cuda.current_device()
    with contextlib.nullcontext() if here else torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        # one upload: kstart, rbase, qstart, (row << 32 | range), the bases
        parts = (kstart, rbase, qstart, (seg_row << 32) | seg_range)
        at = np.cumsum([0] + [len(p) for p in parts])
        words = int(at[-1]) + -(-len(seq) // 8)
        up_h = ws.pinned("upload", words)[:words]
        host = up_h.numpy()
        for p, a in zip(parts, at):
            host[a:a + len(p)] = p
        host[at[-1]:].view(np.uint8)[:len(seq)] = seq
        up = up_h.to(dev, non_blocking=True)
        kstart_d, rbase_d, qstart_d, seg_d = (
            up[at[i]:at[i + 1]] for i in range(4))
        seq_d = up[at[-1]:].view(torch.uint8)

        bits = K_BITS + max(n_ranges - 1, 0).bit_length()
        passes = -(-bits // DIGIT_BITS)
        tiles = -(-n_t // SORT_TILE)
        i64, i32 = torch.int64, torch.int32
        key = [torch.empty(n_t, dtype=i64, device=dev) for _ in range(2)]
        val = [torch.empty(n_t, dtype=i32, device=dev) for _ in range(2)]
        counts = torch.empty(tiles * (1 << DIGIT_BITS), dtype=i32,
                             device=dev)
        done = torch.empty(8, dtype=i64, device=dev)
        skm = torch.empty(n_t, dtype=i32, device=dev)
        spos = torch.empty(n_t, dtype=i32, device=dev)
        _call("seeds_index", stream.cuda_stream, (
            seq_d, kstart_d, rbase_d, n_ranges, n_t, bits, key[0], key[1],
            val[0], val[1], counts, done, skm, spos))
        LAUNCHES["seeds_keys"] += 1
        LAUNCHES["seeds_hist"] += passes - 1
        LAUNCHES["seeds_scatter"] += passes

        blocks = -(-n_q // QUERY_TILE)
        qleft = torch.empty(n_q, dtype=i32, device=dev)
        qcnt = torch.empty(n_q, dtype=torch.uint8, device=dev)
        bsum = torch.empty(blocks, dtype=i64, device=dev)
        boff = torch.empty(blocks, dtype=i64, device=dev)
        ctl = torch.empty(1, dtype=i64, device=dev)
        total_h = ws.pinned("total", 1)
        _call("seeds_count", stream.cuda_stream, (
            rows, ctypes.c_longlong(rows.shape[1]), kstart_d, qstart_d,
            seg_d, n_seg, ctypes.c_longlong(n_q), skm, qleft, qcnt, bsum,
            boff, ctl, total_h))
        LAUNCHES["seeds_count"] += 1
        LAUNCHES["seeds_scan"] += 1
        with span("sync"):  # the total sizes the output
            stream.synchronize()
        total = int(total_h[0])

        words = n_seg + 1 + total
        out = torch.empty(words, dtype=i64, device=dev)
        out_h = ws.pinned("out", words)
        _call("seeds_expand", stream.cuda_stream, (
            qstart_d, n_seg, ctypes.c_longlong(n_q), qleft, qcnt, boff, ctl,
            spos, ctypes.c_longlong(total), out, out_h))
        LAUNCHES["seeds_expand"] += 1
        with span("sync"):  # the one read-back
            stream.synchronize()
        res = out_h.numpy()[:words]
        return (res[:n_seg + 1].copy(),
                res[n_seg + 1:].view(np.int32).reshape(total, 2).copy())


# ------------------------------------------------------- the plain version
def _pack(codes_at, n, device):
    """Packed k-mers [n] int64: ``codes_at(j)`` gives every k-mer's j-th
    base (codes >= 4 pack as 0), first base most significant."""
    km = torch.zeros(n, dtype=torch.int64, device=device)
    for j in range(SEED_K):
        c = codes_at(j).to(torch.int64)
        km = km * 4 + torch.where(c < 4, c, torch.zeros_like(c))
    return km


def seed_hits_plain(rows, seq, range_len, seg_row, seg_range, seg_len):
    """seed_hits in torch on ``rows``' device: the walk keys (range << 26
    | k-mer) sorted stably, each query key's bounds by searchsorted,
    capped at MAX_KMER_OCC, expanded.  Returns (seg_off int64 [n_seg + 1],
    hits int32 [total, 2]) as numpy, as seed_hits does."""
    seq, range_len, seg_row, seg_range, seg_len = _check(
        rows, seq, range_len, seg_row, seg_range, seg_len)
    dev = rows.device
    kstart, rbase, qstart = layout(range_len, seg_len)
    n_t, n_q = int(kstart[-1]), int(qstart[-1])
    i64 = torch.int64

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    seq_d = torch.as_tensor(seq, device=dev)
    r_of = torch.repeat_interleave(
        torch.arange(len(range_len), device=dev),
        t(np.maximum(np.asarray(range_len) - SEED_K + 1, 0)))
    p = torch.arange(n_t, dtype=i64, device=dev) - t(kstart)[r_of]
    g = t(rbase)[r_of] + p
    wkey = (r_of << K_BITS) | _pack(lambda j: seq_d[g + j], n_t, dev)
    skey, order = torch.sort(wkey, stable=True)
    spos = p[order]

    s_of = torch.repeat_interleave(torch.arange(len(seg_len), device=dev),
                                   t(np.asarray(seg_len) - SEED_K + 1))
    q = torch.arange(n_q, dtype=i64, device=dev) - t(qstart)[s_of]
    row = t(seg_row)[s_of]
    qkey = (t(seg_range)[s_of] << K_BITS) | _pack(
        lambda j: rows[row, q + j], n_q, dev)
    left = torch.searchsorted(skey, qkey)
    cnt = (torch.searchsorted(skey, qkey, right=True) - left).clamp(
        max=MAX_KMER_OCC)
    excl = torch.cumsum(cnt, 0) - cnt
    total = int(cnt.sum())
    hq = torch.repeat_interleave(torch.arange(n_q, device=dev), cnt)
    idx = torch.arange(total, dtype=i64, device=dev) - excl[hq] + left[hq]
    hits = torch.stack([spos[idx], q[hq]], 1).to(torch.int32)
    seg_off = torch.cat([excl[t(qstart[:-1])], t([total])])
    return seg_off.cpu().numpy(), hits.cpu().numpy()


# ------------------------------------------------------------ the twin
def _packed(codes, starts):
    """Packed k-mers (uint32) of ``codes`` at ``starts`` (numpy)."""
    km = np.zeros(len(starts), np.uint32)
    for j in range(SEED_K):
        c = codes[starts + j].astype(np.uint32)
        km = (km << np.uint32(2)) | np.where(c < 4, c, 0).astype(np.uint32)
    return km


def radix_pass(key, val, shift, tile):
    """One stable LSD pass the kernels' way: each tile's digit counts,
    every (tile, digit)'s offset (the digits before it over all tiles,
    then the same digit in the tiles before), a key's slot that offset
    plus its rank among its tile's keys of its digit."""
    n = len(key)
    d = ((key >> np.uint64(shift)) & np.uint64(255)).astype(np.int64)
    tl = np.arange(n) // tile
    n_tiles = max(-(-n // tile), 1)
    counts = np.bincount(tl * 256 + d, minlength=n_tiles * 256).reshape(
        n_tiles, 256)
    off = (np.cumsum(counts.T.reshape(-1)) - counts.T.reshape(-1)).reshape(
        256, n_tiles).T
    group = tl * 256 + d
    order = np.argsort(group, kind="stable")
    first = np.searchsorted(group[order], group[order], "left")
    rank = np.empty(n, np.int64)
    rank[order] = np.arange(n) - first
    slot = off[tl, d] + rank
    out_k, out_v = np.empty_like(key), np.empty_like(val)
    out_k[slot], out_v[slot] = key, val
    return out_k, out_v


def seed_hits_twin(rows, seq, range_len, seg_row, seg_range, seg_len,
                   sort_tile=SORT_TILE, query_tile=QUERY_TILE,
                   query_per=QUERY_PER):
    """The kernels' algorithm in numpy on ``rows`` (numpy uint8 [n, w]):
    the keys in (range, position) order, the LSD passes by tiles of
    ``sort_tile`` keys, each query k-mer's lower bound by binary search in
    its range's slice and its count up to MAX_KMER_OCC, the tiles' sums of
    ``query_tile`` k-mers scanned, each thread's ``query_per`` k-mers
    offset by the block scan, the hits written at their offsets.  Returns
    (seg_off, hits, counts) as seed_hits does, with the query k-mers'
    counts."""
    seq, range_len, seg_row, seg_range, seg_len = (
        np.asarray(a) for a in (seq, range_len, seg_row, seg_range,
                                seg_len))
    kstart, rbase, qstart = layout(range_len, seg_len)
    n_t, n_q, n_seg = int(kstart[-1]), int(qstart[-1]), len(seg_len)
    # the index
    r_of = np.repeat(np.arange(len(range_len)), np.diff(kstart))
    p = np.arange(n_t) - kstart[r_of]
    key = (r_of.astype(np.uint64) << np.uint64(K_BITS)) | \
        _packed(seq, rbase[r_of] + p).astype(np.uint64)
    val = p.astype(np.int32)
    bits = K_BITS + max(len(range_len) - 1, 0).bit_length()
    for shift in range(0, bits, DIGIT_BITS):
        key, val = radix_pass(key, val, shift, sort_tile)
    skm = (key & np.uint64((1 << K_BITS) - 1)).astype(np.uint32)
    # the count pass
    s_of = np.repeat(np.arange(n_seg), np.diff(qstart))
    q = np.arange(n_q) - qstart[s_of]
    km = _packed(rows.reshape(-1), seg_row[s_of] * rows.shape[1] + q)
    lo, hi = kstart[seg_range[s_of]], kstart[seg_range[s_of] + 1]
    a, b = lo.copy(), hi.copy()
    while (a < b).any():  # every query's binary search, step by step
        go = a < b
        mid = (a + b) >> 1
        less = np.zeros(n_q, bool)
        less[go] = skm[mid[go]] < km[go]
        a = np.where(go & less, mid + 1, a)
        b = np.where(go & ~less, mid, b)
    cnt = np.zeros(n_q, np.int64)
    live = np.ones(n_q, bool)
    for c in range(MAX_KMER_OCC):  # the equal values after the bound
        at = a + c
        live &= at < hi
        live[live] = skm[at[live]] == km[live]
        cnt += live
    # the tiles' sums, their scan, each thread's offset in its tile
    tiles = max(-(-n_q // query_tile), 1)
    bsum = np.bincount(np.arange(n_q) // query_tile, weights=cnt,
                       minlength=tiles).astype(np.int64)
    boff = np.cumsum(bsum) - bsum
    thread = np.arange(n_q) // query_per
    tsum = np.bincount(thread, weights=cnt).astype(np.int64)
    tile_of = np.arange(len(tsum)) * query_per // query_tile
    t_excl = np.cumsum(tsum) - tsum  # the block scan: from the tile's
    t_off = boff[tile_of] + t_excl - t_excl[tile_of * (query_tile //
                                                       query_per)]
    excl = np.cumsum(cnt) - cnt  # a thread's k-mers, in order
    k_off = t_off[thread] + excl - excl[thread * query_per]
    total = int(bsum.sum())
    hits = np.zeros((total, 2), np.int32)
    for i in np.nonzero(cnt)[0]:
        o, c = int(k_off[i]), int(cnt[i])
        hits[o:o + c, 0] = val[a[i]:a[i] + c]
        hits[o:o + c, 1] = q[i]
    seg_off = np.append(k_off[qstart[:-1]], total).astype(np.int64)
    return seg_off, hits, cnt
