"""Candidate generation on the card (csrc/candgen.cu): the wrapper, its
launch counts and the numpy twin of its tiled algorithm.

``query_kernel`` computes what ``DeviceCandGen.query_plain`` computes
(the reference's GetMinHashWithPoses / GetReadCandsWithPoses,
graph.cc:1289-1348) with four launches of hand-written kernels and one
torch sort, and one host synchronisation (the candidate count) where the
torch chain has three.  It replaces the JAX package's XLA graph
gaml_tpu/ops/candgen_device.py:91-278 (no Pallas kernel).

The kernel cannot run without a card, so ``query_twin`` writes its
algorithm once more in numpy, step for step and with the tile size as a
parameter: per tile of window starts and strand, the codes with their
halo and segments, the hashes, the window max by doubling, the run flags
(the tile's first start recomputes its predecessor), the compaction in
window order and the CSR lookup; the scan over tiles; the expansion into
each tile's slots; the stable sort and the finish.  The CPU tests hold it
bit-equal to query_plain at tiny tiles, so that windows, runs and
segments cross tile edges.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..index.maxhash import HASH_XOR, K_INDEX_KMER

K = K_INDEX_KMER
L_MAX = 4096  # longest read length the runs pass holds in shared memory
TILE = 1024  # window starts a block of the runs pass (kTile in candgen.cu)
_POS_MASK = (1 << 32) - 1

# launches of each kernel by query_kernel
LAUNCHES = {"candgen_runs": 0, "candgen_scan": 0, "candgen_expand": 0,
            "candgen_finish": 0}


def _lib():
    from .build import load

    return load()


def _call(name, device, args):
    """Launch ``gaml_<name>`` with ``args`` (tensors as their pointers,
    ints as they are) on ``device``'s current stream; count it."""
    ptr = ctypes.c_void_p
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        cargs = [ptr(a.data_ptr()) if isinstance(a, torch.Tensor) else a
                 for a in args]
        err = getattr(_lib(), "gaml_" + name)(*cargs, ptr(stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def check_batch(gen, codes, seg_base, seg_len):
    """Shape, type and device checks of a window batch for ``gen`` and of
    ``gen``'s resident arrays (a bundle's or a max-hash index's)."""
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
    for name in ("sf", "off", "rids", "seed2", "row_of"):
        t = getattr(gen, name)
        if t.dtype != torch.int64 or t.device != gen.device or \
                not t.is_contiguous():
            raise ValueError(f"the index's {name} must be contiguous int64 "
                             f"on {gen.device}")
    if gen.seed2.dim() != 2 or gen.seed2.shape[1] != 2:
        raise ValueError(f"seed2 must be [rows, 2], got "
                         f"{tuple(gen.seed2.shape)}")
    if gen.read_len > L_MAX:
        raise ValueError(f"read length {gen.read_len} above the kernel's "
                         f"{L_MAX}")
    if codes.shape[0] + 2 * L_MAX + 2048 >= 2 ** 31 or \
            gen.rids.shape[0] >= 2 ** 31 or gen.row_of.shape[0] > 2 ** 32:
        raise ValueError("the kernel takes positions and CSR entries below "
                         "2^31 and read ids below 2^32")


def query_kernel(gen, codes, seg_base, seg_len, cap, mark):
    """DeviceCandGen.query on a card: the Candidates of the batch
    (codes, seg_base, seg_len) on ``gen``'s device; ``mark(stage)`` is
    called at the end of each stage."""
    from .candgen_device import Candidates

    check_batch(gen, codes, seg_base, seg_len)
    dev = gen.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    g, L = codes.shape[0], gen.read_len
    if L < K or g < L:
        return gen._empty(codes, seg_base, seg_len)
    if _lib().gaml_candgen_tile() != TILE:
        raise RuntimeError("csrc/candgen.cu's tile differs from TILE")
    n_tiles = -(-g // TILE)
    runs = torch.empty((2 * n_tiles * TILE, 4), dtype=torch.int32, device=dev)
    tile_runs = torch.empty(2 * n_tiles, dtype=torch.int32, device=dev)
    tile_cands = torch.empty(2 * n_tiles, dtype=torch.int64, device=dev)
    _call("candgen_runs", dev, (codes, seg_base, seg_len, seg_len.shape[0],
                                g, L, gen.sf, gen.sf.shape[0] - 1, gen.off,
                                n_tiles, runs, tile_runs, tile_cands))
    mark("runs")
    cand_off = torch.empty(2 * n_tiles, dtype=torch.int64, device=dev)
    total = torch.empty(1, dtype=torch.int64, device=dev)
    _call("candgen_scan", dev, (tile_cands, 2 * n_tiles, cand_off, total))
    host = torch.empty(1, dtype=torch.int64, pin_memory=True)
    host.copy_(total, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev))
    done.synchronize()  # the query's one host synchronisation
    n_total = int(host[0])
    mark("scan_sync")
    if cap is not None and n_total > cap:
        return Candidates(n_total, None, None, None, None, None, codes,
                          seg_base, seg_len)
    if n_total == 0:
        return gen._empty(codes, seg_base, seg_len)
    key = torch.empty(n_total, dtype=torch.int64, device=dev)
    val = torch.empty(n_total, dtype=torch.int64, device=dev)
    _call("candgen_expand", dev, (runs, tile_runs, cand_off, gen.rids,
                                  n_tiles, key, val))
    mark("expand")
    skey, order = torch.sort(key, stable=True)
    mark("sort")
    out = [torch.empty(n_total, dtype=torch.int64, device=dev)
           for _ in range(5)]
    _call("candgen_finish", dev, (skey, order, val, gen.seed2, gen.row_of,
                                  ctypes.c_longlong(n_total), *out))
    mark("finish")
    return Candidates(n_total, *out, codes, seg_base, seg_len)


def query_twin(gen, codes, seg_base, seg_len, cap=None, tile=TILE):
    """query_kernel's algorithm in numpy on a CPU DeviceCandGen, tiles of
    ``tile`` window starts: Candidates with CPU tensors."""
    from .candgen_device import Candidates

    cb = codes.numpy().astype(np.int64)
    sb, sl = seg_base.numpy(), seg_len.numpy()
    sf, off, rids = gen.sf.numpy(), gen.off.numpy(), gen.rids.numpy()
    g, L = len(cb), gen.read_len
    w = L - K + 1
    if L < K or g < L:
        return gen._empty(codes, seg_base, seg_len)
    n_tiles = -(-g // tile)
    nk, nc = tile + w, tile + L
    base = np.arange(n_tiles, dtype=np.int64)[:, None] * tile - 1
    pos = base + np.arange(nc)                       # [n_tiles, nc]
    inside = (pos >= 0) & (pos < g)
    pid = np.where(inside, np.searchsorted(sb, pos, side="right") - 1, -1)
    tile_cands, tables = [], []
    for strand in (0, 1):
        p = np.clip(pos, 0, g - 1)
        if strand:
            s0 = sb[np.maximum(pid, 0)]
            src = np.clip(s0 + sl[np.maximum(pid, 0)] - 1 - (p - s0), 0,
                          g - 1)
            c = cb[src]
            c = np.where(c < 4, 3 - c, c)
        else:
            c = cb[p]
        v = np.where(inside & (c < 4), c, 0)
        h = np.zeros((n_tiles, nk), dtype=np.int64)
        for j in range(K):
            h = (h << 2) | v[:, j:j + nk]
        h ^= int(HASH_XOR)
        a = (h << 32) | ((_POS_MASK - (base + np.arange(nk))) & _POS_MASK)
        size = 1
        while True:  # the kernel's doubling passes, ping-pong
            if size * 2 <= w:
                d, size = size, size * 2
            elif size < w:
                d, size = w - size, w
            else:
                break
            b = a.copy()
            b[:, :nk - d] = np.maximum(a[:, :nk - d], a[:, d:])
            a = b
        i = 1 + np.arange(tile)
        s = base + i
        ps = pid[:, i]
        valid = (s < g) & (ps >= 0) & (pid[:, i + L - 1] == ps)
        fp = a[:, i] >> 32
        new = valid & ((pid[:, i - 1] != ps) | ((a[:, i - 1] >> 32) != fp))
        idx = np.searchsorted(sf, fp, side="left")
        cnt = np.where(sf[idx] == fp, off[idx + 1] - off[idx], 0)
        hit = new & (cnt > 0)
        kp = _POS_MASK - (a[:, i] & _POS_MASK)
        loc = kp - sb[np.maximum(ps, 0)]
        g0 = sl[np.maximum(ps, 0)] - loc - K if strand else loc
        tile_cands.append(np.where(hit, cnt, 0).sum(1))
        # each tile's runs, compacted in window order
        tables += [np.stack([g0[t][hit[t]], ps[t][hit[t]], off[idx][t][hit[t]],
                             cnt[t][hit[t]], np.full(hit[t].sum(), strand)],
                            1) for t in range(n_tiles)]
    tile_cands = np.concatenate(tile_cands)
    cand_off = np.cumsum(tile_cands) - tile_cands  # the scan over tiles
    n_total = int(tile_cands.sum())
    if cap is not None and n_total > cap:
        return Candidates(n_total, None, None, None, None, None, codes,
                          seg_base, seg_len)
    if n_total == 0:
        return gen._empty(codes, seg_base, seg_len)
    key = np.full(n_total, -1, dtype=np.int64)
    val = np.full(n_total, -1, dtype=np.int64)
    for t, rec in enumerate(tables):  # the expansion, a tile's slots
        if not len(rec):
            continue
        pre = np.cumsum(rec[:, 3]) - rec[:, 3]
        k = np.arange(tile_cands[t])
        j = np.searchsorted(pre, k, side="right") - 1
        slot = cand_off[t] + k
        key[slot] = (rec[j, 1] << 32) | rids[rec[j, 2] + k - pre[j]]
        val[slot] = (rec[j, 0] << 1) | rec[j, 4]
    assert (key >= 0).all() and (val >= 0).all(), "a slot left unwritten"
    order = np.argsort(key, kind="stable")
    skey = key[order]
    v = val[order]
    rid = skey & _POS_MASK
    orient = v & 1
    r0 = gen.seed2.numpy()[gen.row_of.numpy()[rid], orient]
    return Candidates(n_total, *(torch.as_tensor(x) for x in (
        rid, v >> 1, r0, orient, skey >> 32)), codes, seg_base, seg_len)
