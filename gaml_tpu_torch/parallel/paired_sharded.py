"""Paired-end likelihood scoring on one device (live-path semantics).

Port of gaml_tpu/parallel/paired_sharded.py.  The production paired
scorer is the incremental one (reference CalcScoreForPathsNew,
graph.cc:1952-1989): per-walk position collection via
GetPositionsOnlyPath (graph.cc:535-598), the innie pair products with
the rs2-length-twice event threshold quirk (graph.cc:1855-1857), per-walk
coverage sweeps, and the floored mean-log reduction over per-read totals
(GetTotalProb, graph.cc:1495-1516).  This module computes those exact
semantics with the O(rows * K^2) pair products and the O(n_reads)
reduction on a device, as a full rescore and as an incremental rescore
over device-resident totals:

- host: window precompute and per-walk position collection (the code
  paths of scoring/paired.py), staged into count-class buckets of pair
  rows (the JAX package's staging and buckets, plus the split rows'
  position offsets, with one ragged fill per bucket where JAX fills walk
  by walk), and the per-walk event sweeps;
- device: each bucket's pair products in float64, in the native pair
  loop's arithmetic (the mates' power tables and the insert table, one
  product), the geometry mask, the per-position event flags, and the
  pairs added into per-read totals one at a time in the host's order
  (ShardedPairedScorer), then the reduction, floored in log space.

The JAX package computes in float32 on the TPU, floors in linear space
(ROADMAP C10, C12) and sums each walk's pairs per read before adding
them to the running totals; the port is float64 only, and its totals
equal the host incremental scorer's bit for bit.  A read whose total is
the rounding residue of an erased walk's contribution keeps the host's
residue: summed per walk, such a read floored on the card where the host
kept it (phase 11 of chip_smoke.py, an anneal's move 326).

Under a process group (parallel/distributed.py) each process stages only
the pair rows of its own reads [lo, hi) (their ids rebased to lo) and
keeps only their totals; the totals are gathered in rank order and every
process reduces the full vector, so the score is a world of one's on
every rank.  The coverage sweeps need every read's pairs: each process's
event positions are OR-merged (``merge_walk_events``: all_reduce MAX of
one flag per walk position) before the sweeps.  The buckets' row padding
(``row_align``) is the world's size; padded rows add nothing.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.logprob import insert_prob_table
from . import distributed
from .device_state import (DeviceScoringState, floored_mean_log,
                           fold_segments, segment_ranks)

_BUCKET_KS = (4, 16, 64)  # position-count classes; above the last, K = max
# rows with more positions than this are split into sub-rows (grid chunks
# over the two mates' position lists — an exact partition of the K x K pair
# products), so no bucket is ever wider than this
_SPLIT_K = 128
# cap on rows_pad * K * K cells per bucket: wide classes are chunked along
# the row axis, bounding the float64 [rows, K, K] products of one bucket
_MAX_CELLS = 1 << 22


def _read_slice(grouped, reads):
    """A grouped position set (rids ascending, starts, counts, then the
    flat pos/ed/orient it indexes) cut to the reads in [lo, hi): views of
    the three per-read arrays, the flat arrays as they are."""
    if reads is None:
        return grouped
    rids = grouped[0]
    a, b = np.searchsorted(rids, reads)
    return (rids[a:b], grouped[1][a:b], grouped[2][a:b]) + tuple(grouped[3:])


def _collect_walk_rows(graph, path, read_set1, read_set2, reads=None):
    """One walk's (rid, plist1, plist2) rows + host scaffold events,
    exactly as calc_score_for_path_inc collects them (reference
    graph.cc:1794-1853), of the reads in ``reads`` = [lo, hi) (all when
    None).  The collection's trailing-duplicate filter reads every read's
    positions (its running max), so it runs over all of them; its output
    is grouped by read and cut to the range."""
    from ..core.paths import path_len, split_at_gaps
    from ..native import get_lib

    events: List[Tuple[int, int]] = [(0, 1)]
    ctgs, gaps = split_at_gaps(list(path))
    ctgs_with_st = []
    cur_len = 0
    for i, ctg in enumerate(ctgs):
        if i > 0:
            cur_len += gaps[i - 1]
            events.append((cur_len, 1))
        ctgs_with_st.append((ctg, cur_len))
        cur_len += path_len(graph, ctg)

    if get_lib() is not None:
        from ..native import collect_positions_ptr

        g1 = collect_positions_ptr(
            read_set1.stage_position_windows(graph, ctgs_with_st),
            n_reads=read_set1.get_number_of_reads())
        g2 = collect_positions_ptr(
            read_set2.stage_position_windows(graph, ctgs_with_st),
            n_reads=read_set2.get_number_of_reads())
        return _read_slice(g1, reads), _read_slice(g2, reads), events

    positions1: Dict[int, list] = {}
    positions2: Dict[int, list] = {}
    for ctg, st in ctgs_with_st:
        read_set1.get_positions_only_path(graph, ctg, st, positions1)
        read_set2.get_positions_only_path(graph, ctg, st, positions2)

    def grouped(positions):
        rids = np.array(sorted(positions), dtype=np.int32)
        cnts = np.array([len(positions[r]) for r in rids.tolist()],
                        dtype=np.int32)
        starts = np.zeros(len(rids), dtype=np.int64)
        if len(rids):
            starts[1:] = np.cumsum(cnts[:-1])
        total = int(cnts.sum()) if len(rids) else 0
        pos = np.zeros(total, np.int32)
        ed = np.zeros(total, np.int32)
        orient = np.zeros(total, np.int32)
        k = 0
        for r in rids.tolist():
            for al in positions[r]:
                pos[k] = al.position
                ed[k] = al.edit_dist
                orient[k] = al.orientation
                k += 1
        return rids, starts, cnts, pos, ed, orient

    return (_read_slice(grouped(positions1), reads),
            _read_slice(grouped(positions2), reads), events)


def _ragged_fill(dense, starts, cnts, flat):
    """dense[row, :cnts[row]] = flat[starts[row] : starts[row]+cnts[row]]."""
    if len(cnts) == 0 or cnts.sum() == 0:
        return
    rows_idx = np.repeat(np.arange(len(cnts)), cnts)
    cum = np.zeros(len(cnts), dtype=np.int64)
    cum[1:] = np.cumsum(cnts[:-1])
    cols = np.arange(int(cnts.sum())) - np.repeat(cum, cnts)
    src = np.repeat(starts, cnts) + cols
    dense[rows_idx, cols] = flat[src]


def stage_paired_rows(graph, paths, read_set1, read_set2,
                      row_align: int = 8, reads=None):
    """Stage every walk's pair rows into count-class buckets.

    Returns (buckets, walk_events, total_len).  Each bucket: dense
    [rows_pad, K] int32 arrays pos1/ed1/or1/pos2/ed2/or2 plus per-row
    rid / walk / len1 / len2 / mask.  Every (walk, read-in-both-mates)
    row appears in exactly one bucket with ALL its positions.  The port
    adds per-row off1 / off2 / n2 (the JAX buckets' other keys are equal):
    a sub-row's first position in each mate's list and the mate-2 count
    of its whole row (0, 0, the row's count where not split), from which
    the scorer adds a split row's pairs in the host's order.  With
    ``reads`` = (lo, hi) only the rows of reads lo to hi - 1 are staged,
    their "rid" rebased to lo (0 is the first read of the range)."""
    from ..core.paths import path_len

    read_set1.precompute_alignment_for_paths(paths, graph)
    read_set2.precompute_alignment_for_paths(paths, graph)

    lens1 = read_set1.read_lens_array().astype(np.int32)
    lens2 = read_set2.read_lens_array().astype(np.int32)
    per_walk = []
    walk_events = []
    total_len = 0
    for w, path in enumerate(paths):
        g1, g2, events = _collect_walk_rows(graph, path, read_set1, read_set2,
                                            reads)
        walk_events.append(events)
        total_len += path_len(graph, path)
        rid1, st1, ct1 = g1[0], g1[1], g1[2]
        rid2, st2, ct2 = g2[0], g2[1], g2[2]
        common, i1, i2 = np.intersect1d(rid1, rid2, assume_unique=True,
                                        return_indices=True)
        per_walk.append((w, common, st1[i1], ct1[i1], g1[3], g1[4], g1[5],
                         st2[i2], ct2[i2], g2[3], g2[4], g2[5]))

    # global sub-row table.  A row is (walk, rid, mate-1 slice, mate-2
    # slice); rows with more than _SPLIT_K positions in either mate are
    # split into grid sub-rows — chunks over the two position lists whose
    # cartesian products exactly partition the full K1 x K2 pair set, so
    # segment-summing sub-row products by rid reproduces the unsplit sums
    # and the per-position event flags are unchanged.
    walk_idx: List[np.ndarray] = []  # index into per_walk, per sub-row
    rid_l: List[np.ndarray] = []
    st1_l: List[np.ndarray] = []
    ct1_l: List[np.ndarray] = []
    st2_l: List[np.ndarray] = []
    ct2_l: List[np.ndarray] = []
    off1_l: List[np.ndarray] = []
    off2_l: List[np.ndarray] = []
    n2_l: List[np.ndarray] = []
    for pw in per_walk:
        (w, common, st1, ct1, _p1, _e1, _o1, st2, ct2, _p2, _e2, _o2) = pw
        big = np.nonzero((ct1 > _SPLIT_K) | (ct2 > _SPLIT_K))[0]
        if len(big) == 0:
            walk_idx.append(np.full(len(common), w, np.int32))
            rid_l.append(common.astype(np.int32))
            st1_l.append(st1.astype(np.int64))
            ct1_l.append(ct1.astype(np.int32))
            st2_l.append(st2.astype(np.int64))
            ct2_l.append(ct2.astype(np.int32))
            off1_l.append(np.zeros(len(common), np.int32))
            off2_l.append(np.zeros(len(common), np.int32))
            n2_l.append(ct2.astype(np.int32))
            continue
        keep = np.ones(len(common), bool)
        keep[big] = False
        walk_idx.append(np.full(int(keep.sum()), w, np.int32))
        rid_l.append(common[keep].astype(np.int32))
        st1_l.append(st1[keep].astype(np.int64))
        ct1_l.append(ct1[keep].astype(np.int32))
        st2_l.append(st2[keep].astype(np.int64))
        ct2_l.append(ct2[keep].astype(np.int32))
        off1_l.append(np.zeros(int(keep.sum()), np.int32))
        off2_l.append(np.zeros(int(keep.sum()), np.int32))
        n2_l.append(ct2[keep].astype(np.int32))
        for r in big.tolist():
            n1 = -(-int(ct1[r]) // _SPLIT_K)
            n2 = -(-int(ct2[r]) // _SPLIT_K)
            a = np.repeat(np.arange(n1), n2)
            bo = np.tile(np.arange(n2), n1)
            walk_idx.append(np.full(n1 * n2, w, np.int32))
            rid_l.append(np.full(n1 * n2, common[r], np.int32))
            st1_l.append(st1[r] + a * _SPLIT_K)
            ct1_l.append(np.minimum(_SPLIT_K,
                                    ct1[r] - a * _SPLIT_K).astype(np.int32))
            st2_l.append(st2[r] + bo * _SPLIT_K)
            ct2_l.append(np.minimum(_SPLIT_K,
                                    ct2[r] - bo * _SPLIT_K).astype(np.int32))
            off1_l.append((a * _SPLIT_K).astype(np.int32))
            off2_l.append((bo * _SPLIT_K).astype(np.int32))
            n2_l.append(np.full(n1 * n2, ct2[r], np.int32))

    def cat(parts, dtype):
        return np.concatenate(parts).astype(dtype) if parts else \
            np.zeros(0, dtype)

    walk_all = cat(walk_idx, np.int32)
    rid_all = cat(rid_l, np.int32)
    st1_all = cat(st1_l, np.int64)
    ct1_all = cat(ct1_l, np.int32)
    st2_all = cat(st2_l, np.int64)
    ct2_all = cat(ct2_l, np.int32)
    offs_all = {"off1": cat(off1_l, np.int32), "off2": cat(off2_l, np.int32),
                "n2": cat(n2_l, np.int32)}
    counts = np.maximum(ct1_all, ct2_all)
    kmax = int(counts.max()) if len(counts) else 0

    classes: List[Tuple[int, np.ndarray]] = []
    prev = 0
    for k in _BUCKET_KS:
        ids = np.nonzero((counts > prev) & (counts <= k))[0]
        if len(ids):
            classes.append((k, ids))
        prev = k
    if kmax > prev:
        classes.append((kmax, np.nonzero(counts > prev)[0]))

    # every walk's flat position arrays end to end, per mate, and where
    # each walk's begin: one ragged fill per bucket and mate
    flat = {}
    for mate, cols in (("1", (4, 5, 6)), ("2", (9, 10, 11))):
        base = np.zeros(len(per_walk) + 1, np.int64)
        base[1:] = np.cumsum([len(pw[cols[0]]) for pw in per_walk])
        flat[mate] = (base, [np.concatenate([pw[c] for pw in per_walk])
                             if per_walk else np.zeros(0, np.int32)
                             for c in cols])

    buckets = []
    for k, all_ids in classes:
        # chunk the class so one dispatch never materializes more than
        # _MAX_CELLS K x K cells; all chunks share one padded shape so the
        # class costs a single compile
        rows_cap = max(row_align, (_MAX_CELLS // max(k * k, 1))
                       // row_align * row_align)
        n_chunks = max(1, -(-len(all_ids) // rows_cap))
        r_pad = min(rows_cap,
                    ((len(all_ids) - 1) // (n_chunks * row_align) + 1)
                    * row_align) if n_chunks > 1 else \
            ((len(all_ids) + row_align - 1) // row_align) * row_align
        for c0 in range(0, len(all_ids), r_pad):
            ids = all_ids[c0:c0 + r_pad]
            r = len(ids)
            b = {"pos1": np.full((r_pad, k), -1, np.int32),
                 "ed1": np.zeros((r_pad, k), np.int32),
                 "or1": np.zeros((r_pad, k), np.int32),
                 "pos2": np.full((r_pad, k), -1, np.int32),
                 "ed2": np.zeros((r_pad, k), np.int32),
                 "or2": np.zeros((r_pad, k), np.int32),
                 "rid": np.full(r_pad, 0, np.int32),
                 "walk": np.full(r_pad, -1, np.int32),
                 "len1": np.zeros(r_pad, np.int32),
                 "len2": np.zeros(r_pad, np.int32),
                 "mask": np.zeros(r_pad, bool)}
            for key, col in offs_all.items():
                b[key] = np.zeros(r_pad, np.int32)
                b[key][:r] = col[ids]
            b["rid"][:r] = rid_all[ids] - (reads[0] if reads else 0)
            b["walk"][:r] = walk_all[ids]
            b["len1"][:r] = lens1[rid_all[ids]]
            b["len2"][:r] = lens2[rid_all[ids]]
            b["mask"][:r] = True
            # scatter the ragged position lists of the selected rows
            for mate, st_a, ct_a in (("1", st1_all, ct1_all),
                                     ("2", st2_all, ct2_all)):
                base, arrays = flat[mate]
                sts = base[walk_all[ids]] + st_a[ids]
                for name, flat_a in zip(("pos", "ed", "or"), arrays):
                    _ragged_fill(b[name + mate], sts, ct_a[ids], flat_a)
            buckets.append(b)
    return buckets, walk_events, total_len


def pack_bucket(bucket) -> np.ndarray:
    """One-transfer bucket layout: [rows, 6K + 4] int32 — the six
    [rows, K] blocks (pos1, ed1, or1, pos2, ed2, or2) then the
    rid/len1/len2/mask columns (mask as 0/1).  The reads axis stays the
    leading dimension, so the packed array shards over the mesh "reads"
    axis exactly like the ten arrays it replaces; multiprocess callers
    pack their local row block and build one global array from it."""
    return np.concatenate(
        [np.asarray(bucket[k], dtype=np.int32)
         for k in ("pos1", "ed1", "or1", "pos2", "ed2", "or2")]
        + [np.asarray(bucket["rid"], dtype=np.int32)[:, None],
           np.asarray(bucket["len1"], dtype=np.int32)[:, None],
           np.asarray(bucket["len2"], dtype=np.int32)[:, None],
           np.asarray(bucket["mask"]).astype(np.int32)[:, None]],
        axis=1)


def _flag_event_positions(bucket, flags: np.ndarray,
                          use_all_to_cov: bool) -> np.ndarray:
    """Qualifying-pair event positions from one bucket's per-position flag
    bits (deduplicated; the sweep treats duplicate positions as gap-0
    no-ops).  Bits: 0 = pos1 is a qualifying pair's max, 1 = its min,
    2 = pos2 max, 3 = pos2 min (incremental semantics graph.cc:1885-1890)."""
    bits = (1, 4) if not use_all_to_cov else (1, 2, 4, 8)
    mates = {1: "pos1", 2: "pos1", 4: "pos2", 8: "pos2"}
    parts = []
    for bit in bits:
        rows, cols = np.nonzero(flags & bit)
        if len(rows):
            parts.append(bucket[mates[bit]][rows, cols])
    if not parts:
        return np.zeros(0, np.int32)
    return np.unique(np.concatenate(parts))


def unpack_bucket(packed):
    """pack_bucket's layout, on the device, back to (pos1, ed1, or1, pos2,
    ed2, or2, rid, len1, len2, mask)."""
    kk = (packed.shape[1] - 4) // 6
    parts = [packed[:, i * kk:(i + 1) * kk] for i in range(6)]
    return parts + [packed[:, 6 * kk + i] for i in range(3)] \
        + [packed[:, 6 * kk + 3] == 1]


def fetch_flags(flags: List[torch.Tensor]) -> List[np.ndarray]:
    """Several [rows, K] uint8 flag tensors to numpy in one transfer."""
    if not flags:
        return []
    flat = torch.cat([f.reshape(-1) for f in flags]).cpu().numpy()
    out, at = [], 0
    for f in flags:
        out.append(flat[at:at + f.numel()].reshape(tuple(f.shape)))
        at += f.numel()
    return out


def insert_table(insert_mean: float, insert_std: float) -> np.ndarray:
    """The insert pdf at every distance below mean + 40 sd, then one 0:
    core/logprob.py's table up to mean + 5 sd, beyond it the native pair
    loop's tail formula with the C library's exp (``math.exp``), so each
    value is the host scorer's bit for bit.  From 40 sd on the pdf is 0
    in float64, as on the host."""
    head = insert_prob_table(insert_mean, insert_std)
    n = int(np.ceil(insert_mean + 40 * insert_std))
    denom = math.sqrt(2.0 * math.pi) * insert_std
    tail = []
    for dist in range(len(head), n):
        z = (float(dist) - insert_mean) / insert_std
        tail.append(math.exp(-z * z / 2.0) / denom)
    return np.concatenate([head, np.asarray(tail, dtype=np.float64), [0.0]])


class ShardedPairedScorer:
    """Pair products, event flags and the floored reduction on one
    device, in float64 and in the host scorer's arithmetic.

    Each pair's probability is the native pair loop's (csrc/
    gaml_native.cc ``paired_inc_pairs2``): the mates' power tables
    (ReadSet.match_probs / mismatch_probs) and the insert table, one
    product, not the JAX shard_fn's exp of summed logs.  A set of buckets
    adds its pairs into per-read totals one at a time, each read's pairs
    in the host's order (walks as staged, then x-major over the read's
    positions of the whole row, also where it was split over more than
    _SPLIT_K positions), so an incremental device total equals the host's
    running total bit for bit (a read whose total is the rounding residue
    of an erased walk's contribution keeps the host's residue)."""

    def __init__(self, match_pow1, mismatch_pow1, match_pow2, mismatch_pow2,
                 insert_mean: float, insert_std: float,
                 collect_events: bool = True, device="cuda"):
        self.device = torch.device(device)

        def t(a):
            return torch.tensor(np.asarray(a, dtype=np.float64),
                                device=self.device)

        self.pow1 = (t(match_pow1), t(mismatch_pow1))
        self.pow2 = (t(match_pow2), t(mismatch_pow2))
        self.ins = t(insert_table(insert_mean, insert_std))
        self.collect_events = collect_events

    def _pairs(self, bucket, min_prob_per_base: float, min_prob_start: float):
        """One bucket (one packed upload): its pair probabilities [rows, K,
        K] (0 where a position is missing or the innie geometry rejects
        the pair) and the event flags [rows, K] uint8 or None."""
        packed = torch.from_numpy(pack_bucket(bucket)).to(self.device)
        pos1, ed1, or1, pos2, ed2, or2, _rid, len1, len2, mask = \
            unpack_bucket(packed)
        x_pos = pos1[:, :, None].to(torch.int64)
        y_pos = pos2[:, None, :].to(torch.int64)
        x_first = x_pos < y_pos
        geom_ok = torch.where(
            x_first, (or1[:, :, None] == 0) & (or2[:, None, :] == 1),
            (or1[:, :, None] == 1) & (or2[:, None, :] == 0))
        valid = (pos1 >= 0)[:, :, None] & (pos2 >= 0)[:, None, :] & \
            geom_ok & mask[:, None, None]
        dist = torch.where(x_first, y_pos - x_pos + len2[:, None, None],
                           x_pos - y_pos + len1[:, None, None])
        ins = self.ins[dist.clamp(0, self.ins.shape[0] - 1)]
        (m1, mm1), (m2, mm2) = self.pow1, self.pow2
        e1, e2 = ed1.to(torch.int64), ed2.to(torch.int64)
        p1 = mm1[e1] * m1[(len1[:, None] - e1).clamp(min=0)]
        p2 = mm2[e2] * m2[(len2[:, None] - e2).clamp(min=0)]
        p = torch.where(valid, p1[:, :, None] * p2[:, None, :] * ins, 0.0)
        if not self.collect_events:
            return p, None
        # incremental event-threshold quirk: rs2's length twice
        # (reference graph.cc:1855-1857), with the C library's exp
        lens2 = np.asarray(bucket["len2"], dtype=np.int64)
        uniq, inv = np.unique(lens2, return_inverse=True)
        thr = np.array([math.exp(min_prob_start + min_prob_per_base
                                 * float(2 * n)) for n in uniq.tolist()])
        thr_ev = torch.from_numpy(thr[inv]).to(self.device)
        qual = valid & (p > thr_ev[:, None, None])
        # the coverage sweep consumes only the SET of qualifying event
        # positions per walk, and every event value is one of the row's
        # own positions, so the K x K event matrix compresses to per-
        # position bits: "this position is the max / min of some
        # qualifying pair"
        x_is_max = x_pos >= y_pos
        bits = ((qual & x_is_max).any(2), (qual & ~x_is_max).any(2),
                (qual & ~x_is_max).any(1), (qual & x_is_max).any(1))
        flags = torch.zeros_like(pos1, dtype=torch.uint8)
        for i, b in enumerate(bits):
            flags |= b.to(torch.uint8) << i
        return p, flags

    def _fold(self, buckets, start, sign: float, min_prob_per_base: float,
              min_prob_start: float):
        """Add ``sign`` * every pair of ``buckets`` into per-read totals,
        one pair at a time in the host's order: a read's walks as staged,
        and in each the pairs x-major over the whole row's positions.
        ``start(ids)`` gives the totals the adds start from, for the
        distinct read ids (device int64).  One bucket's [rows, K, K]
        products (at most _MAX_CELLS) live at a time: only its non-zero
        pairs are kept (adding 0 changes no total), keyed by their place
        in that order, then all are sorted, ranked within their read and
        folded (device_state.segment_ranks, fold_segments).  Returns (ids, totals, flags of each bucket or
        None)."""
        dev = self.device
        rows = [np.flatnonzero(b["mask"]) for b in buckets]
        rid = np.concatenate([b["rid"][r] for b, r in zip(buckets, rows)])
        walk = np.concatenate([b["walk"][r] for b, r in zip(buckets, rows)])
        uniq, u_of = np.unique(rid, return_inverse=True)
        # one rank per (read, walk) row, shared by the sub-rows of a split
        # row; within it a pair's place is x * n2 + y over the whole row
        _w, g_of = np.unique(rid.astype(np.int64) * (int(walk.max()) + 1)
                             + walk, return_inverse=True)
        span = max(int(((b["off1"][r].astype(np.int64) + b["pos1"].shape[1])
                        * b["n2"][r]).max(initial=1))
                   for b, r in zip(buckets, rows))
        keys, vals, segs, flags = [], [], [], []
        at = 0
        for b, r in zip(buckets, rows):
            per_row = np.zeros((5, len(b["mask"])), np.int64)
            per_row[0, r] = g_of[at:at + len(r)]
            per_row[1, r] = u_of[at:at + len(r)]
            for i, key in enumerate(("off1", "off2", "n2"), 2):
                per_row[i, r] = b[key][r]
            at += len(r)
            g, u, off1, off2, n2 = torch.from_numpy(per_row).to(dev)
            p, fl = self._pairs(b, min_prob_per_base, min_prob_start)
            k = torch.arange(p.shape[1], device=dev)
            key = (g * span)[:, None, None] + n2[:, None, None] * (
                off1[:, None, None] + k[None, :, None]) \
                + off2[:, None, None] + k[None, None, :]
            live = p != 0
            keys.append(key[live])
            vals.append(p[live])
            segs.append(u[:, None, None].expand_as(p)[live])
            flags.append(fl)
        _key, order = torch.sort(torch.cat(keys), stable=True)
        live_u, seg, rank = segment_ranks(torch.cat(segs)[order])
        v = torch.cat(vals)[order]
        ids = torch.from_numpy(uniq).to(dev)
        totals = start(ids)
        totals[live_u] = fold_segments(totals[live_u],
                                       v if sign > 0 else -v, seg, rank)
        return ids, totals, flags

    def read_totals(self, buckets, n_reads: int, min_prob_per_base: float,
                    min_prob_start: float):
        """Per-read pair totals, float64 [n_reads], of a set of buckets
        (from zero, in the host's order: equal to the host incremental
        scorer's totals from a fresh state), and each bucket's event flags
        [rows, K] or None.  Flag bits per (row, position): 0 = pos1 is the
        max of a qualifying pair, 1 = pos1 is the min, 2 = pos2 is the
        max, 3 = pos2 is the min."""
        out = torch.zeros(n_reads, dtype=torch.float64, device=self.device)
        if buckets:
            ids, totals, flags = self._fold(
                buckets, lambda i: out[i], 1.0, min_prob_per_base,
                min_prob_start)
            out[ids] = totals
            return out, flags
        return out, []

    def bucket_products(self, bucket, n_reads: int,
                        min_prob_per_base: float, min_prob_start: float):
        """(read_probs float64 [n_reads], event_flags or None) of one
        bucket (read_totals)."""
        out, flags = self.read_totals([bucket], n_reads, min_prob_per_base,
                                      min_prob_start)
        return out, flags[0]

    def apply_buckets(self, probs, sign: float, buckets,
                      min_prob_per_base: float, min_prob_start: float):
        """The incremental delta: probs += sign * each pair of ``buckets``
        (one walk's), pair by pair in the host's order, in place on
        ``probs`` (DeviceScoringState.probs).  Returns the buckets' event
        flags (each None unless collect_events)."""
        if not buckets:
            return []
        ids, totals, flags = self._fold(buckets, lambda i: probs[i], sign,
                                        min_prob_per_base, min_prob_start)
        probs[ids] = totals
        return flags

    def bucket_apply(self, probs, sign: float, bucket,
                     min_prob_per_base: float, min_prob_start: float):
        """apply_buckets of one bucket; returns its flags or None."""
        return self.apply_buckets(probs, sign, [bucket], min_prob_per_base,
                                  min_prob_start)[0]

    def reduce(self, read_probs, lens, total_len, min_prob_per_base,
               min_prob_start):
        """(score, zero_reads) of per-read totals and pair lengths (float64
        tensors on the device), floored in log space."""
        return floored_mean_log(read_probs, lens, total_len,
                                min_prob_per_base, min_prob_start)


def paired_scorer(read_set1, read_set2, insert_mean, insert_std,
                  collect_events, device):
    """The scorer of one paired library (its mates' power tables)."""
    return ShardedPairedScorer(
        read_set1.match_probs, read_set1.mismatch_probs,
        read_set2.match_probs, read_set2.mismatch_probs,
        insert_mean, insert_std, collect_events=collect_events,
        device=device)


def _event_positions_by_walk(buckets, flags, use_all_to_cov):
    """{walk: sorted distinct qualifying event positions} from the
    buckets' flag bits (several walks' buckets at once): each flagged
    position tagged with its row's walk, through _flag_event_positions."""
    parts = []
    for b, fl in zip(buckets, flags):
        w = b["walk"].astype(np.int64)[:, None] << 32
        parts.append(_flag_event_positions(
            {m: w + b[m] for m in ("pos1", "pos2")}, fl, use_all_to_cov))
    out: Dict[int, List[int]] = {}
    if parts:
        both = np.unique(np.concatenate(parts))
        w_arr = both >> 32
        cuts = np.nonzero(np.diff(w_arr))[0] + 1
        for w_grp, p_grp in zip(np.split(w_arr, cuts),
                                np.split(both - (w_arr << 32), cuts)):
            if len(w_grp):
                out[int(w_grp[0])] = p_grp.tolist()
    return out


def merge_walk_events(ev_by_walk, walk_lens) -> Dict[int, List[int]]:
    """Every process's event positions, OR-merged: {walk: sorted distinct
    positions} of each process's ``ev_by_walk`` (keys index
    ``walk_lens``), through one flag per walk position (uint8, all walks
    end to end) and one all_reduce MAX.  ``ev_by_walk`` itself without a
    process group."""
    if not torch.distributed.is_initialized():
        return ev_by_walk
    offs = np.zeros(len(walk_lens) + 1, np.int64)
    offs[1:] = np.cumsum(walk_lens)
    flags = np.zeros(int(offs[-1]), np.uint8)
    for w, pos in ev_by_walk.items():
        p = np.asarray(pos, dtype=np.int64)
        if len(p) and (p.min() < 0 or p.max() >= walk_lens[w]):
            raise ValueError(f"walk {w}: event positions "
                             f"[{p.min()}, {p.max()}] outside its "
                             f"{walk_lens[w]} bases")
        flags[offs[w] + p] = 1
    merged = distributed.all_reduce_max(torch.from_numpy(flags)).numpy()
    at = np.flatnonzero(merged)
    walk = np.searchsorted(offs, at, side="right") - 1
    out: Dict[int, List[int]] = {}
    for w in np.unique(walk).tolist():
        out[w] = (at[walk == w] - offs[w]).tolist()
    return out


def calc_score_for_paths_paired_sharded(
        graph, paths, read_set1, read_set2, insert_mean: float,
        insert_std: float, no_cov_penalty: float = 0.0,
        exp_cov_move: float = 0.75, use_all_to_cov: bool = False,
        min_prob_per_base: float = -0.7, min_prob_start: float = -10.0,
        scorer: Optional[ShardedPairedScorer] = None, device="cuda"):
    """Full paired rescore with live incremental-path semantics, pair
    products and reduction on ``device`` (the scorer's, when given).
    Returns (score, zero_reads, total_len): equal to
    calc_score_for_paths_incremental from a fresh ScoringState up to
    float reassociation (its per-read totals equal the host's from a
    fresh state bit for bit).  Every bucket's flags come back in one
    transfer."""
    from ..scoring.paired import _coverage_sweep, _pair_lens

    from ..core.paths import path_len

    assert read_set1.get_number_of_reads() == read_set2.get_number_of_reads()
    n = read_set1.get_number_of_reads()
    if scorer is None:
        scorer = paired_scorer(read_set1, read_set2, insert_mean, insert_std,
                             True, device)
    lo, hi = distributed.read_range(n)
    buckets, walk_events, total_len = stage_paired_rows(
        graph, paths, read_set1, read_set2,
        row_align=distributed.world()[1], reads=(lo, hi))
    local, flags = scorer.read_totals(buckets, hi - lo, min_prob_per_base,
                                      min_prob_start)
    read_probs = distributed.gather_read_values(local, n)
    ev_by_walk = _event_positions_by_walk(
        buckets, fetch_flags(flags) if scorer.collect_events else [],
        use_all_to_cov)
    if scorer.collect_events:
        ev_by_walk = merge_walk_events(
            ev_by_walk, [path_len(graph, p) for p in paths])
    lens = torch.tensor(_pair_lens(read_set1, read_set2),
                        dtype=torch.float64, device=scorer.device)
    score, zero_reads = scorer.reduce(read_probs, lens, total_len,
                                      min_prob_per_base, min_prob_start)
    bad_bases = 0
    for w, events in enumerate(walk_events):
        ev = events + [(p, 3) for p in ev_by_walk.get(w, [])]
        bad_bases += _coverage_sweep(ev, insert_mean, insert_std,
                                     exp_cov_move)
    return score - bad_bases * no_cov_penalty, zero_reads, total_len


def calc_score_for_paths_incremental_sharded(
        graph, paths, read_set1, read_set2, insert_mean: float,
        insert_std: float, scoring_state, no_cov_penalty: float = 0.0,
        exp_cov_move: float = 0.75, use_all_to_cov: bool = False,
        min_prob_per_base: float = -0.7, min_prob_start: float = -10.0,
        scorer: Optional[ShardedPairedScorer] = None, keys=None,
        device="cuda"):
    """Device-backed incremental paired rescore.

    Reference CalcScoreForPathsNew semantics (graph.cc:1952-1989): the
    walk multiset is diffed on the host (GetChanges, graph.cc:1745-1764);
    the changed walks' pair products run on the device and their signed
    per-read totals are added into the device-resident running totals
    (DeviceScoringState.probs, made on the scorer's device at the first
    call).  Per-move cost is O(changed walks), independent of the total
    walk count.

    Determinism contract: each changed walk is staged ALONE (its bucket
    decomposition depends only on its own rows), so an added walk's later
    erase replays bit-identical bucket totals with the opposite sign, the
    same cancellation class as the reference's sequential
    ``probs[read] += p`` / ``-= p``; and every sum runs in a fixed order,
    so two runs print the same trace.  A walk's flags come back in one
    transfer.

    Returns (score, zero_reads, total_len): the running totals equal the
    host incremental scorer's bit for bit (ShardedPairedScorer), the
    score to the reduction's rounding."""
    from ..scoring.paired import _coverage_sweep, _pair_lens, _state_derived

    assert read_set1.get_number_of_reads() == read_set2.get_number_of_reads()
    n = read_set1.get_number_of_reads()
    state = scoring_state
    if scorer is None:
        scorer = paired_scorer(read_set1, read_set2, insert_mean, insert_std,
                             no_cov_penalty != 0.0, device)
    dev = getattr(state, "device", None)
    if dev is None:
        dev = DeviceScoringState(n, _pair_lens(read_set1, read_set2),
                                 device=scorer.device)
        if len(state.probs):
            dev.from_host(state.probs)
        state.device = dev

    new_tuples = keys if keys is not None else \
        [p if type(p) is tuple else tuple(p) for p in paths]
    counter, old_total = _state_derived(state, graph)
    remaining = counter.copy()
    added: List[tuple] = []
    get = remaining.get
    for key in new_tuples:
        c = get(key, 0)
        if c > 0:
            remaining[key] = c - 1
        else:
            added.append(key)
    erased = [key for key, cnt in remaining.items() for _ in range(cnt)]

    total = old_total
    if added or erased:
        lens_np = graph.lens_np()

        def plen(t):
            a = np.asarray(t, dtype=np.int64)
            return int(np.where(a >= 0, lens_np[np.maximum(a, 0)],
                                -a).sum()) if len(a) else 0

        for p in added:
            total += plen(p)
        for p in erased:
            total -= plen(p)

    # one batched miss-fill for the whole new walk set (erased walks'
    # windows are already cached: they were precomputed when added)
    read_set1.precompute_alignment_for_paths(paths, graph, keys=new_tuples)
    read_set2.precompute_alignment_for_paths(paths, graph, keys=new_tuples)

    # each changed walk staged and applied alone; then every walk's event
    # positions (merged over processes in one collective) and its sweep
    swept = []  # (sign, walk, scaffold events, event positions)
    for group, sign in ((erased, -1.0), (added, +1.0)):
        for walk in group:
            buckets, walk_events, _wl = stage_paired_rows(
                graph, [list(walk)], read_set1, read_set2,
                row_align=distributed.world()[1], reads=(dev.lo, dev.hi))
            flags = scorer.apply_buckets(dev.probs, sign, buckets,
                                         min_prob_per_base, min_prob_start)
            if scorer.collect_events:
                ev_pos = _event_positions_by_walk(
                    buckets, fetch_flags(flags), use_all_to_cov)
                swept.append((sign, walk, walk_events[0],
                              ev_pos.get(0, [])))
    if swept:
        merged = merge_walk_events(
            {i: sw[3] for i, sw in enumerate(swept)},
            [plen(sw[1]) for sw in swept])
        for i, (sign, _walk, events, _pos) in enumerate(swept):
            ev = events + [(p, 3) for p in merged.get(i, [])]
            state.bad_bases += int(sign) * _coverage_sweep(
                ev, insert_mean, insert_std, exp_cov_move)

    score, zero_reads = dev.reduce(total, min_prob_per_base, min_prob_start)

    for key in added:
        counter[key] += 1
    for key in erased:
        c = counter[key] - 1
        if c:
            counter[key] = c
        else:
            del counter[key]
    state.old_paths = new_tuples
    state._counter = counter
    state._total_len = total
    state._derived_tag = state.old_paths
    return score - state.bad_bases * no_cov_penalty, zero_reads, total
