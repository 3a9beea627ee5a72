"""World maker ``trimmed``: ``worlds/paired.py``'s world with every mate
file quality-trimmed, made from the seed and written as LastGraph and
FASTQ of mixed read lengths under a run directory, with the CLI's config
file.  Vectorised numpy; nothing of the program is imported.  A
configuration names it under ``world.maker``.

The graph and the pairs are ``paired.py``'s (``chain_graph``,
``innie_pairs``), drawn from the seed in the same order.  Then, in each
mate file of each library in turn, a share of the reads (``trim.share``)
is cut at the 3' end to a length uniform in ``trim.min_bp`` to
``trim.max_bp``: each read is cut or not, and gets its length, from the
same generator, independently per mate and per file.  The reference gets
the same reads in memory, as lists of arrays.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

from harness import common

paired = common.load_module("worlds", "paired")
revcomp = paired.revcomp
write_cli_config = paired.write_cli_config


def trim(rng, reads: np.ndarray, share: float, lo: int,
         hi: int) -> List[np.ndarray]:
    """The reads [n, L] with ``share`` of them cut at the 3' end to a
    length uniform in [lo, hi]."""
    n, L = reads.shape
    cut = rng.random(n) < share
    lens = np.where(cut, rng.integers(lo, hi + 1, n), L)
    return [reads[i, :lens[i]] for i in range(n)]


def write_fastq(path: str, name: str, reads: List[np.ndarray]) -> None:
    """Reads of any lengths as FASTQ, quality I."""
    pre = name.encode()
    with open(path, "wb") as f:
        f.write(b"".join(b"@%s%d\n%s\n+\n%s\n" % (
            pre, i, paired.LETTERS[r].tobytes(), b"I" * len(r))
            for i, r in enumerate(reads)))


def make(cfg: dict, seed_seq: np.random.SeedSequence,
         root: str) -> paired.World:
    """The configuration's world (``cfg["world"]``) from the seed."""
    w = cfg["world"]
    t = w["trim"]
    rng = np.random.default_rng(seed_seq)
    genome, nodes, arcs, n_chain = paired.chain_graph(rng, w)
    paired.write_lastgraph(os.path.join(root, "LastGraph"), nodes, arcs)
    libs = {}
    for name, lib in w["libraries"].items():
        libs[name] = paired.innie_pairs(
            rng, genome, int(lib["pairs"]), int(w["read_bp"]),
            float(lib["insert_mean"]), float(lib["insert_std"]),
            float(w["substitution_rate"]))
    for name in libs:
        libs[name] = tuple(
            trim(rng, m, float(t["share"]), int(t["min_bp"]),
                 int(t["max_bp"])) for m in libs[name])
        for mate, reads in enumerate(libs[name], 1):
            write_fastq(os.path.join(root, f"{name}_{mate}.fq"),
                        f"{name}_{mate}_", reads)
    return paired.World(root, genome, nodes, arcs, n_chain, libs)
