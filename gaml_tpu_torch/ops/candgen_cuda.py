"""Candidate generation on the card (csrc/candgen.cu): the wrapper, its
launch counts (in utils.metrics.LAUNCHES) and the numpy twin of its
algorithm.

``query_kernel`` computes what ``DeviceCandGen.query_plain`` computes
(the reference's GetMinHashWithPoses / GetReadCandsWithPoses,
graph.cc:1289-1348) with hand-written kernels only and one host
synchronisation (the candidate count) where the torch chain has three:
the runs pass with its chained tile scan, then either one block that
expands, sorts and finishes (up to ``BLOCK_MAX`` candidates with
32-bit keys) or the expansion and the passes of a multi-block stable LSD
radix sort on the compact key (segment << rid_bits | read id), its last
pass writing the five outputs.  Both sorts take 8-bit digits.  It
replaces the JAX package's XLA graph
gaml_tpu/ops/candgen_device.py:91-278 (no Pallas kernel).

The kernels cannot run without a card, so ``query_twin`` writes their
algorithm once more in numpy, step for step, with the tile sizes, the
thread count of the window max, the digit width and the one-block
threshold as parameters: per tile of window starts and strand, the codes
staged in pieces (mirrored on the reverse strand) with each code's
segment from flagged segment starts and a max-scan, the rolling hashes,
the window max by van Herk/Gil-Werman over the threads' chunks (segmented
carries between them), the run flags (the tile's first start recomputes
its predecessor), the CSR lookup from the fingerprint's bucket, the
compaction in window order; the decoupled look-back over tiles, the
compact run table; the expansion; the radix passes (``radix_order``)
and the finish.  The CPU tests hold it bit-equal to query_plain at tiny
tiles, so that windows, runs, segments and sort tiles cross tile edges.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..index.maxhash import HASH_XOR, K_INDEX_KMER
from ..utils.metrics import LAUNCHES, span
from .build import check_tiles, launch, load

K = K_INDEX_KMER
L_MAX = 4096  # longest read length the runs pass holds in shared memory
TILE = 1024  # window starts a block of the runs pass (kTile in candgen.cu)
THREADS = 128  # threads of the runs pass, each a chunk of the window max
SORT_TILE = 4096  # candidates a block of the multi-block sort (kSortTile)
WARP_ITEMS = 256  # consecutive candidates a warp ranks there (kWarpItems)
BLOCK_MAX = 10240  # most candidates the one-block route holds (kBlockMax)
BLOCK_WARPS = 32  # warps of the one-block route (kBlockWarps)
DIGIT_BITS = 8  # digit width of both sort routes (kDigitBits)
BUCKET_SHIFT = 12  # 30-bit fingerprints in 2^18 buckets (kBucketShift)
N_BUCKETS = 1 << (30 - BUCKET_SHIFT)
WAVE = 40  # tiles in flight at once in the twin's look-back
_POS_MASK = (1 << 32) - 1
# the constants csrc/candgen.cu must share, by their entry points
_TILES = {"candgen_tile": TILE, "candgen_sort_tile": SORT_TILE,
          "candgen_block_max": BLOCK_MAX}


def fp_buckets(fp: np.ndarray) -> np.ndarray:
    """int32 [N_BUCKETS + 1]: the lower bound in the sorted fingerprints
    ``fp`` of each bucket's first fingerprint (bucket = fp >> BUCKET_SHIFT),
    where the kernel's CSR lookup starts."""
    if len(fp) and (fp.min() < 0 or fp.max() >> 30):
        raise ValueError("fingerprints must be 30-bit")
    edges = np.arange(N_BUCKETS + 1, dtype=np.int64) << BUCKET_SHIFT
    return np.searchsorted(fp, edges, side="left").astype(np.int32)


def key_bits(n_seg: int, n_rows: int):
    """(seg_bits, rid_bits) of the compact sort key seg << rid_bits | rid
    over ``n_seg`` segments and read ids below ``n_rows``."""
    return max(n_seg - 1, 0).bit_length(), max(n_rows - 1, 0).bit_length()


def check_batch(gen, codes, seg_base, seg_len):
    """Shape, type and device checks of a window batch for ``gen`` and of
    ``gen``'s resident arrays (a bundle's or a max-hash index's; checked
    again only when one of them is replaced)."""
    if codes.dim() != 1 or codes.dtype != torch.uint8:
        raise ValueError(f"codes must be uint8 [g], got {codes.dtype} "
                         f"{tuple(codes.shape)}")
    for name, t in (("seg_base", seg_base), ("seg_len", seg_len)):
        if t.dim() != 1 or t.dtype != torch.int64 or \
                t.shape != seg_base.shape:
            raise ValueError(f"{name} must be int64 [n_seg], got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t in (("codes", codes), ("seg_base", seg_base),
                    ("seg_len", seg_len)):
        if t.device != gen.device:
            raise ValueError(f"{name} is on {t.device}, the index on "
                             f"{gen.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if codes.shape[0] + 2 * L_MAX + 2048 >= 2 ** 31:
        raise ValueError("the kernel takes positions below 2^31")
    resident = tuple(getattr(gen, name) for name in (
        "sf", "off", "rids", "seed2", "row_of", "bucket"))
    if getattr(gen, "_checked", None) == (tuple(map(id, resident)),
                                          gen.read_len):
        return
    for name, t in zip(("sf", "off", "rids", "seed2", "row_of"), resident):
        if t.dtype != torch.int64 or t.device != gen.device or \
                not t.is_contiguous():
            raise ValueError(f"the index's {name} must be contiguous int64 "
                             f"on {gen.device}")
    b = gen.bucket
    if b.dtype != torch.int32 or b.shape != (N_BUCKETS + 1,) or \
            b.device != gen.device or not b.is_contiguous():
        raise ValueError(f"the index's bucket must be contiguous int32 "
                         f"[{N_BUCKETS + 1}] on {gen.device}")
    if gen.seed2.dim() != 2 or gen.seed2.shape[1] != 2:
        raise ValueError(f"seed2 must be [rows, 2], got "
                         f"{tuple(gen.seed2.shape)}")
    if gen.read_len > L_MAX:
        raise ValueError(f"read length {gen.read_len} above the kernel's "
                         f"{L_MAX}")
    if gen.rids.shape[0] >= 2 ** 31 or gen.row_of.shape[0] > 2 ** 32:
        raise ValueError("the kernel takes CSR entries below 2^31 and read "
                         "ids below 2^32")
    gen._checked = (tuple(map(id, resident)), gen.read_len)


def query_kernel(gen, codes, seg_base, seg_len, cap, mark,
                 one_block_max=BLOCK_MAX):
    """DeviceCandGen.query on a card: the Candidates of the batch
    (codes, seg_base, seg_len) on ``gen``'s device; ``mark(stage)`` is
    called at the end of each stage.  Up to ``one_block_max`` candidates
    (at most BLOCK_MAX; lower it to force the radix route) take the
    one-block route."""
    from .candgen_device import Candidates

    check_batch(gen, codes, seg_base, seg_len)
    dev = gen.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    g, L = codes.shape[0], gen.read_len
    if L < K or g < L:
        return gen._empty(codes, seg_base, seg_len)
    check_tiles("candgen.cu", _TILES)
    lib = load()
    n_tiles = -(-g // TILE)
    here = dev.index is None or dev.index == torch.cuda.current_device()
    with contextlib.nullcontext() if here else torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        ws = torch.empty(lib.gaml_candgen_ws_words(n_tiles),
                         dtype=torch.int64, device=dev)
        count = getattr(gen, "_count", None)  # pinned, one a generator
        if count is None:
            count = gen._count = torch.empty(1, dtype=torch.int64,
                                             pin_memory=True)
        with span("candgen.runs"):
            launch("candgen_runs", dev, codes, seg_base, seg_len,
                   seg_len.shape[0], g, L, gen.sf, gen.off, gen.bucket,
                   n_tiles, ws, count)
            LAUNCHES["candgen_runs"] += 1
            mark("runs")
            with span("sync"):  # the query's one host synchronisation
                stream.synchronize()
                n_total = int(count.numpy()[0])
            mark("sync")
        if cap is not None and n_total > cap:
            return Candidates(n_total, None, None, None, None, None, codes,
                              seg_base, seg_len)
        if n_total == 0:
            return gen._empty(codes, seg_base, seg_len)
        if n_total >= 2 ** 31:
            raise ValueError(f"{n_total} candidates: the sort's indices are "
                             f"below 2^31")
        with span("candgen.sort"):
            seg_bits, rid_bits = key_bits(seg_len.shape[0],
                                          gen.row_of.shape[0])
            bits = seg_bits + rid_bits
            # five rows of n_total, each 64-byte aligned
            out = torch.empty((5, -(-n_total // 8) * 8), dtype=torch.int64,
                              device=dev)
            args = (ws, n_tiles, gen.rids, gen.seed2, gen.row_of, n_total,
                    rid_bits, bits)
            if bits <= 32 and n_total <= min(one_block_max, BLOCK_MAX):
                launch("candgen_sort", dev, *args, 0, None, out)
                LAUNCHES["candgen_block"] += 1
                mark("block")
            else:
                scratch = torch.empty(
                    lib.gaml_candgen_scratch_bytes(n_total, int(bits > 32)),
                    dtype=torch.uint8, device=dev)
                launch("candgen_sort", dev, *args, 1, scratch, out)
                passes = max(1, -(-bits // DIGIT_BITS))
                LAUNCHES["candgen_expand"] += 1
                LAUNCHES["candgen_hist"] += passes - 1
                LAUNCHES["candgen_scatter"] += passes
                mark("sort")
    return Candidates(n_total, *out[:, :n_total], codes, seg_base, seg_len)


# ------------------------------------------------------------ the twin
def _look_back(agg, wave):
    """Exclusive prefixes of ``agg`` (one value a tile) as the kernel's
    decoupled look-back makes them: tiles in ticket order, ``wave`` in
    flight at once; each publishes its aggregate, then reads its
    predecessors 32 at a time (nearest first), summing aggregates up to
    the nearest inclusive prefix, then publishes its own."""
    n = len(agg)
    inc = np.zeros(n, bool)
    word = np.zeros(n, np.int64)
    excl = np.zeros(n, np.int64)
    for w0 in range(0, n, wave):
        ts = range(w0, min(w0 + wave, n))
        for t in ts:
            word[t], inc[t] = agg[t], t == 0
        for t in ts:
            e, j = 0, t - 1
            while j >= 0:
                q = np.arange(j, max(j - 32, -1), -1)
                hit = np.nonzero(inc[q])[0]
                stop = hit[0] + 1 if len(hit) else len(q)
                e += int(word[q[:stop]].sum())
                if len(hit):
                    break
                j -= 32
            excl[t] = e
        for t in ts:
            word[t], inc[t] = excl[t] + agg[t], True
    return excl


def _window_max(key, w, threads):
    """(suffix maxes, prefix maxes) of ``key`` [tiles, nk] in blocks of
    ``w`` as the runs pass makes them: each of ``threads`` threads owns a
    chunk of ceil(nk / threads) starts, summarises it (the max after its
    last block start, the max up to its first block end), takes its
    carries from the segmented scans over the threads' summaries (left to
    right, right to left) and writes its chunk."""
    n_t, nk = key.shape
    ck = -(-nk // threads)
    i = np.arange(threads * ck).reshape(threads, ck)
    r = i % w
    valid = i < nk
    kp = np.zeros((n_t, threads * ck), np.int64)
    kp[:, :nk] = key
    kp = kp.reshape(n_t, threads, ck)
    start = valid & (r == 0)
    end = valid & (r == w - 1)
    pf, sfl = start.any(1), end.any(1)
    last_start = np.where(pf, ck - 1 - np.argmax(start[:, ::-1], 1), 0)
    first_end = np.where(sfl, np.argmax(end, 1), ck - 1)
    col = np.arange(ck)
    pv = np.where(valid & (col >= last_start[:, None]), kp, 0).max(2)
    sv = np.where(valid & (col <= first_end[:, None]), kp, 0).max(2)
    pc, sc = np.zeros((n_t, threads), np.int64), np.zeros((n_t, threads),
                                                            np.int64)
    cur = np.zeros(n_t, np.int64)
    for th in range(threads):
        pc[:, th] = cur
        cur = pv[:, th] if pf[th] else np.maximum(cur, pv[:, th])
    cur = np.zeros(n_t, np.int64)
    for th in range(threads - 1, -1, -1):
        sc[:, th] = cur
        cur = sv[:, th] if sfl[th] else np.maximum(cur, sv[:, th])
    pre, suf = np.zeros_like(kp), np.zeros_like(kp)
    run = sc
    for j in range(ck - 1, -1, -1):
        run = np.where(end[:, j], kp[:, :, j], np.maximum(run, kp[:, :, j]))
        suf[:, :, j] = run
    run = pc
    for j in range(ck):
        run = np.where(start[:, j], kp[:, :, j], np.maximum(run, kp[:, :, j]))
        pre[:, :, j] = run
    return (suf.reshape(n_t, -1)[:, :nk], pre.reshape(n_t, -1)[:, :nk])


def radix_order(key, bits, digit_bits, tile, warp_items):
    """The order (emission indices) in which the kernels' stable LSD radix
    sort leaves ``key`` (int64, non-negative, ``bits`` bits used), digits
    of ``digit_bits``: per pass each tile of ``tile`` candidates counts
    its digits, the offsets of each (tile, digit) are the digits before it
    over all tiles plus the same digit in the tiles before, and each warp
    of ``warp_items`` consecutive candidates of the tile ranks its
    candidates in rounds of 32 lanes (the lanes below with the same digit,
    plus the warp's counter of that digit before the round) after the
    warps before it.  The one-block route is one tile of all candidates."""
    key = np.asarray(key, np.int64)
    n, D = len(key), 1 << digit_bits
    pos = np.arange(n)
    t, in_tile = pos // tile, pos % tile
    wl, lane = in_tile // warp_items, in_tile % warp_items % 32
    rnd = in_tile % warp_items // 32
    n_t, n_w = -(-n // tile), -(-tile // warp_items)
    group = t * n_w + wl
    below = np.arange(32)[None, :] < np.arange(32)[:, None]  # [lane, lane']
    k, idx = key.copy(), pos.copy()
    for shift in range(0, max(bits, 1), digit_bits):
        d = (k >> shift) & (D - 1)
        counts = np.zeros((n_t, D), np.int64)
        np.add.at(counts, (t, d), 1)
        tot = counts.sum(0)
        off = np.cumsum(counts, 0) - counts + (np.cumsum(tot) - tot)
        cnt = np.zeros((n_t * n_w, D), np.int64)
        rank = np.zeros(n, np.int64)
        for r in range(-(-warp_items // 32)):
            sel = np.nonzero(rnd == r)[0]
            lanes = np.full((n_t * n_w, 32), -1, np.int64)
            lanes[group[sel], lane[sel]] = d[sel]
            peers = (lanes[:, :, None] == lanes[:, None, :]) & below
            rank[sel] = cnt[group[sel], d[sel]] + \
                peers.sum(2)[group[sel], lane[sel]]
            np.add.at(cnt, (group[sel], d[sel]), 1)
        cnt = cnt.reshape(n_t, n_w, D)
        wpre = np.cumsum(cnt, 1) - cnt
        dest = off[t, d] + wpre[t, wl, d] + rank
        k[dest], idx[dest] = k.copy(), idx.copy()
    return idx


def query_twin(gen, codes, seg_base, seg_len, cap=None, tile=TILE,
               threads=THREADS, one_block_max=BLOCK_MAX,
               digit_bits=DIGIT_BITS, sort_tile=SORT_TILE,
               warp_items=WARP_ITEMS, wave=WAVE):
    """query_kernel's algorithm in numpy on a CPU DeviceCandGen, tiles of
    ``tile`` window starts, ``threads`` chunks of the window max, the
    one-block route up to ``one_block_max`` candidates (32-bit keys), the
    multi-block route in tiles of ``sort_tile`` candidates and warps of
    ``warp_items``, both with digits of ``digit_bits``: Candidates with
    CPU tensors."""
    from .candgen_device import Candidates

    cb = codes.numpy().astype(np.int64)
    sb, sl = seg_base.numpy(), seg_len.numpy()
    sf, off, rids = gen.sf.numpy(), gen.off.numpy(), gen.rids.numpy()
    bucket = gen.bucket.numpy().astype(np.int64)
    g, L = len(cb), gen.read_len
    w = L - K + 1
    if L < K or g < L:
        return gen._empty(codes, seg_base, seg_len)
    n_tiles = -(-g // tile)
    nk, nc = tile + w, tile + L
    base = np.arange(n_tiles, dtype=np.int64) * tile - 1
    lo, hi = np.maximum(base, 0), np.minimum(base + nc, g)
    s_lo = np.searchsorted(sb, lo, side="right") - 1
    s_hi = np.searchsorted(sb, hi - 1, side="right") - 1
    # each held code's segment: the first at lo, later starts flagged,
    # a max-scan, -1 outside the batch
    mark = np.full((n_tiles, nc), -1, np.int64)
    mark[np.arange(n_tiles), lo - base] = s_lo
    tt, ss = np.nonzero((sb[None, :] > lo[:, None]) &
                        (sb[None, :] < hi[:, None]))
    np.maximum.at(mark, (tt, sb[ss] - base[tt]), ss)
    pid = np.maximum.accumulate(mark, 1)
    pos = base[:, None] + np.arange(nc)
    pid[pos >= g] = -1
    inside = (pos >= lo[:, None]) & (pos < hi[:, None])
    ps_ = np.maximum(pid, 0)
    tables, run_n, cand_n = [], [], []
    for strand in (0, 1):
        # the staged pieces: [lo, hi) forward; on the reverse strand the
        # mirror of s_lo's part, the segments between, the mirror of
        # s_hi's part, each placed at 16-byte alignment plus its offset
        raw = np.zeros((n_tiles, nc + 96), np.int64)
        dst = np.zeros((n_tiles, 3), np.int64)
        srcs = np.zeros((n_tiles, 3), np.int64)
        for t in range(n_tiles):
            src, ln = [lo[t], 0, 0], [hi[t] - lo[t], 0, 0]
            if strand:
                a, e = sb[s_lo[t]], sb[s_lo[t]] + sl[s_lo[t]]
                x1 = min(hi[t], e)
                src[0], ln[0] = a + e - x1, x1 - lo[t]
                if s_hi[t] > s_lo[t]:
                    h0 = sb[s_hi[t]]
                    src[1], ln[1] = e, h0 - e
                    src[2], ln[2] = 2 * h0 + sl[s_hi[t]] - hi[t], hi[t] - h0
            cur = 0
            for k in range(3):
                dst[t, k] = (-(-cur // 16)) * 16 + src[k] % 16
                raw[t, dst[t, k]:dst[t, k] + ln[k]] = cb[src[k]:src[k] + ln[k]]
                srcs[t, k] = src[k]
                cur = dst[t, k] + ln[k]
        rows = np.arange(n_tiles)[:, None]
        if strand:
            src = 2 * sb[ps_] + sl[ps_] - 1 - pos
            piece = np.where(pid == s_lo[:, None], 0,
                             np.where(pid == s_hi[:, None], 2, 1))
            c = raw[rows, np.clip(dst[rows, piece] + src - srcs[rows, piece],
                                  0, nc + 95)]
            c = np.where(c < 4, 3 - c, c)
        else:
            c = raw[rows, np.clip(dst[:, :1] + pos - lo[:, None], 0, nc + 95)]
        v = np.where(inside & (c < 4), c, 0)
        h = np.zeros((n_tiles, nk), dtype=np.int64)
        for j in range(K):  # the rolling hash's value at each start
            h = (h << 2) | v[:, j:j + nk]
        h ^= int(HASH_XOR)
        key = (h << 32) | ((_POS_MASK - (base[:, None] + np.arange(nk)))
                           & _POS_MASK)
        suf, pre = _window_max(key, w, threads)
        i = 1 + np.arange(tile)
        wm = np.maximum(suf[:, i], pre[:, i + w - 1])
        wp = np.maximum(suf[:, i - 1], pre[:, i + w - 2])
        s = base[:, None] + i
        ps = pid[:, i]
        valid = (s < g) & (ps >= 0) & (pid[:, i + L - 1] == ps)
        fp = wm >> 32
        new = valid & ((pid[:, i - 1] != ps) | ((wp >> 32) != fp))
        # lower bound of fp in sf inside its bucket
        b = fp >> BUCKET_SHIFT
        lo2, hi2 = bucket[b], bucket[b + 1]
        while (lo2 < hi2).any():
            mid = (lo2 + hi2) >> 1
            less = (lo2 < hi2) & (sf[np.minimum(mid, len(sf) - 1)] < fp)
            more = (lo2 < hi2) & ~less
            lo2 = np.where(less, mid + 1, lo2)
            hi2 = np.where(more, mid, hi2)
        cnt = np.where(sf[lo2] == fp, off[lo2 + 1] - off[lo2], 0)
        hit = new & (cnt > 0)
        kp = _POS_MASK - (wm & _POS_MASK)
        loc = kp - sb[np.maximum(ps, 0)]
        g0 = sl[np.maximum(ps, 0)] - loc - K if strand else loc
        run_n.append(hit.sum(1))
        cand_n.append(np.where(hit, cnt, 0).sum(1))
        # each tile's runs, compacted in window order
        tables += [np.stack([(g0[t] << 1 | strand)[hit[t]], ps[t][hit[t]],
                             off[lo2][t][hit[t]], cnt[t][hit[t]]], 1)
                   for t in range(n_tiles)]
    run_n, cand_n = np.concatenate(run_n), np.concatenate(cand_n)
    run0, cand0 = _look_back(run_n, wave), _look_back(cand_n, wave)
    n_total = int(cand0[-1] + cand_n[-1])
    if cap is not None and n_total > cap:
        return Candidates(n_total, None, None, None, None, None, codes,
                          seg_base, seg_len)
    if n_total == 0:
        return gen._empty(codes, seg_base, seg_len)
    table = np.full((int(run0[-1] + run_n[-1]), 4), -1, np.int64)
    start = np.full(len(table), -1, np.int64)
    for t, rec in enumerate(tables):  # the compact run table
        table[run0[t]:run0[t] + len(rec)] = rec
        start[run0[t]:run0[t] + len(rec)] = cand0[t] + np.cumsum(
            rec[:, 3]) - rec[:, 3]
    assert (start >= 0).all(), "a run slot left unwritten"
    # the expansion: each candidate's run is the last starting at or below
    k = np.arange(n_total)
    j = np.searchsorted(start, k, side="right") - 1
    seg_bits, rid_bits = key_bits(len(sb), gen.row_of.shape[0])
    bits = seg_bits + rid_bits
    key = (table[j, 1] << rid_bits) | rids[table[j, 2] + k - start[j]]
    val = table[j, 0]
    if bits <= 32 and n_total <= min(one_block_max, BLOCK_MAX):
        per_warp = -(-n_total // (32 * BLOCK_WARPS)) * 32  # C, 32 | C
        order = radix_order(key, bits, digit_bits, n_total, per_warp)
    else:
        order = radix_order(key, bits, digit_bits, sort_tile, warp_items)
    skey, v = key[order], val[order]
    rid = skey & ((1 << rid_bits) - 1)
    orient = v & 1
    r0 = gen.seed2.numpy()[gen.row_of.numpy()[rid], orient]
    return Candidates(n_total, *(torch.as_tensor(x) for x in (
        rid, v >> 1, r0, orient, skey >> rid_bits)), codes, seg_base,
        seg_len)
