"""Walk (path) utilities.

A walk is a list of ints: node ids >= 0; a negative entry ``-g`` is a
scaffold gap of ``g`` unknown bases (reference convention, graph.cc:676-680).
Reverse-complementing a walk reverses the order and xors each node id with 1
(reference InvertPath/ReversePath, utility.h:28-47).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

Path = List[int]


def invert_path(path: Sequence[int]) -> Path:
    """Copying reverse-complement (reference utility.h:28-38)."""
    return [(x ^ 1) if x >= 0 else x for x in reversed(path)]


def reverse_path(path: List[int]) -> None:
    """In-place reverse-complement (reference utility.h:40-47)."""
    path.reverse()
    for i, x in enumerate(path):
        if x >= 0:
            path[i] = x ^ 1


def path_len(graph, path: Sequence[int]) -> int:
    """Total spelled length including gaps (reference GetPathLen,
    graph.cc:1766-1773).  Vectorized for long walks."""
    if len(path) > 64:
        a = np.asarray(path, dtype=np.int64)
        neg = a < 0
        return int(np.where(neg, -a,
                            graph.lens_np()[np.where(neg, 0, a)]).sum())
    total = 0
    for e in path:
        total += -e if e < 0 else graph.node_len(e)
    return total


def total_len(graph, paths: Sequence[Sequence[int]]) -> int:
    """Reference GetTotalLen (graph.cc:1775-1781).  Vectorized over the
    flattened walk set (hot: called once per scored state)."""
    flat = [e for p in paths for e in p]
    if not flat:
        return 0
    a = np.asarray(flat, dtype=np.int64)
    neg = a < 0
    vals = graph.lens_np()[np.where(neg, 0, a)]
    return int(np.where(neg, -a, vals).sum())


def split_at_gaps(path: Sequence[int]):
    """Split a walk into (contigs, gaps) at negative entries
    (reference pattern, e.g. graph.cc:1665-1676).

    Returns (list of contig node-lists, list of gap lengths); there is always
    exactly one more contig than gaps (contigs may be empty lists at the
    walk's edges if the walk starts/ends with a gap, matching the reference's
    ``vector(path.begin()+last, ...)`` slicing)."""
    ctgs = []
    gaps = []
    last = 0
    path = list(path)
    for i, e in enumerate(path):
        if e < 0:
            gaps.append(-e)
            ctgs.append(path[last:i])
            last = i + 1
    ctgs.append(path[last:])
    return ctgs, gaps
