"""World maker ``pacbio``: a genome cut into a Velvet-style chain of
nodes and a long-read library sampled from it, made from the seed and
written as LastGraph and FASTQ under a run directory, with the CLI's
config file and the walk sets the rescore traffic scores.  Vectorised
numpy; nothing of the program is imported.  A configuration names it
under ``world.maker``.

The graph is ``worlds/paired.py``'s chain (``chain_graph``: long nodes
alternating with short ones, one set of sizes for every seed).  Reads:
lengths log-normal (``read_median_bp``, ``read_sigma``) clipped to
``read_bp``, also one set for every seed (the law's quantiles at the
midpoints of n equal strata, in the seed's order), so the longest read,
which sets the padded batch and K5's longest warp, is the same in every
run; each cut from a template at a uniform position with
substitutions, insertions and deletions at the configuration's rates,
half of them reverse-complemented.

Walk entries are the program's node ids: LastGraph node k (1-based) is
2(k - 1) forward and 2(k - 1) + 1 its reverse complement (its twin); a
negative entry -g is a gap of g bases.
"""
from __future__ import annotations

import os
from statistics import NormalDist
from typing import List

import numpy as np

from harness import common

paired = common.load_module("worlds", "paired")
revcomp = paired.revcomp


class World:
    """What a run's set-up made: files under ``root``, and the same data
    in memory for the reference (``nodes``: the chain's forward codes in
    LastGraph order; ``reads``: the library's reads as written)."""

    def __init__(self, root, genome, nodes, n_chain, reads):
        self.root = root
        self.genome = genome
        self.nodes = nodes
        self.n_chain = n_chain
        self.reads: List[np.ndarray] = reads
        self.graph_path = os.path.join(root, "LastGraph")
        self.fastq_path = os.path.join(root, "pb.fq")


def read_lengths(rng, w: dict, n: int) -> np.ndarray:
    lo, hi = w["read_bp"]
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    lens = float(w["read_median_bp"]) * np.exp(float(w["read_sigma"]) * z)
    return rng.permutation(np.clip(np.rint(lens), lo, hi).astype(np.int64))


def long_read(rng, template: np.ndarray, length: int, err: dict):
    """``template`` read with substitutions, insertions (the base, then a
    random one) and deletions at ``err``'s rates, cut to ``length``."""
    u = rng.random(len(template))
    sub = u < err["substitution"]
    ins = (u >= err["substitution"]) & \
        (u < err["substitution"] + err["insertion"])
    dele = (u >= err["substitution"] + err["insertion"]) & \
        (u < err["substitution"] + err["insertion"] + err["deletion"])
    base = template.copy()
    base[sub] = (base[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    out = np.repeat(base, np.where(dele, 0, np.where(ins, 2, 1)))
    # each insertion's second base: after its own base in the output
    at = np.cumsum(np.where(dele, 0, np.where(ins, 2, 1)))[ins] - 1
    out[at] = rng.integers(0, 4, len(at))
    return out[:length].astype(np.uint8)


def write_fastq(path: str, reads: List[np.ndarray]) -> None:
    with open(path, "wb") as f:
        f.write(b"".join(
            b"@pb%d\n%s\n+\n%s\n" % (i, paired.LETTERS[r].tobytes(),
                                     b"I" * len(r))
            for i, r in enumerate(reads)))


def make(cfg: dict, seed_seq: np.random.SeedSequence, root: str) -> World:
    """The configuration's world (``cfg["world"]``) from the seed."""
    w = cfg["world"]
    rng = np.random.default_rng(seed_seq)
    genome, nodes, arcs, n_chain = paired.chain_graph(rng, w)
    paired.write_lastgraph(os.path.join(root, "LastGraph"), nodes, arcs)
    n = int(w["reads"])
    lens = read_lengths(rng, w, n)
    # a template longer than any read it gives (net +3.5 % bases)
    span = lens + lens // 4 + 64
    starts = rng.integers(0, len(genome) - span)
    flip = rng.random(n) < float(w["reverse_share"])
    reads = []
    for i in range(n):
        r = long_read(rng, genome[starts[i]:starts[i] + span[i]],
                      int(lens[i]), w["errors"])
        reads.append(np.ascontiguousarray(revcomp(r)) if flip[i] else r)
    world = World(root, genome, nodes, n_chain, reads)
    write_fastq(world.fastq_path, reads)
    return world


def write_cli_config(cfg: dict, world: World, anneal_seed: int,
                     prefix: str) -> str:
    """The CLI's config file for the world: the configuration's global
    keys and its one long-read library section (``cfg["cli"]``)."""
    cli = cfg["cli"]
    lines = [f"graph={world.graph_path}", f"seed={anneal_seed}",
             f"output_prefix={prefix}"]
    lines += [f"{k}={v}" for k, v in cli["global"].items()]
    for name, keys in cli["libraries"].items():
        lines += ["", f"[{name}]",
                  f"cache_prefix={os.path.join(world.root, name)}",
                  f"filename={world.fastq_path}"]
        lines += [f"{k}={v}" for k, v in keys.items()]
    path = os.path.join(world.root, "run.cfg")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def node_len(world: World, e: int) -> int:
    return -e if e < 0 else len(world.nodes[e // 2])


def chain_walks(rng, world: World, n_walks: int) -> List[List[int]]:
    """The chain cut at node borders into ``n_walks`` walks of forward
    ids."""
    cuts = np.sort(rng.choice(np.arange(1, world.n_chain), n_walks - 1,
                              replace=False))
    return [[2 * int(k) for k in piece]
            for piece in np.split(np.arange(world.n_chain), cuts)]


def misassembly(rng, world: World, n_walks: int, edits: int,
                run_nodes) -> List[List[int]]:
    """The chain as ``n_walks`` walks with ``edits`` runs of
    ``run_nodes`` nodes inside them, each deleted (a gap entry of its
    length in its place) or inverted (the run's twins in reverse
    order)."""
    walks = chain_walks(rng, world, n_walks)
    for _ in range(edits):
        r = int(rng.integers(run_nodes[0], run_nodes[1] + 1))
        fits = [i for i, wk in enumerate(walks) if len(wk) >= r + 2]
        if not fits:
            continue
        wk = walks[int(rng.choice(fits))]
        s = int(rng.integers(1, len(wk) - r))
        run = wk[s:s + r]
        if rng.random() < 0.5:
            wk[s:s + r] = [-sum(node_len(world, e) for e in run)]
        else:
            wk[s:s + r] = [e if e < 0 else e ^ 1 for e in reversed(run)]
    return walks


def walk_pool(rng, world: World, start_walks, tr: dict):
    """The traffic's pool: the start walks, the true chain as walks, then
    ``tr["misassemblies"]`` misassemblies of it."""
    pool = [[list(w) for w in start_walks],
            chain_walks(rng, world, int(tr["walks"]))]
    pool += [misassembly(rng, world, int(tr["walks"]), int(tr["edits"]),
                         tr["run_nodes"])
             for _ in range(int(tr["misassemblies"]))]
    return pool
