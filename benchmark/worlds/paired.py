"""World maker ``paired``: a genome cut into a Velvet-style graph and
paired read libraries sampled from it, made from the seed and written as
LastGraph and FASTQ under a run directory, with the CLI's config file
and, for the rescore traffic, misassemblies of the genome.  Vectorised
numpy; nothing of the program is imported.  A configuration names it
under ``world.maker``.

DNA codes are the program's: G=0, A=1, T=2, C=3 (N=4).
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

LETTERS = np.frombuffer(b"GATCN", np.uint8)
COMP = np.array([3, 2, 1, 0, 4], np.uint8)


def revcomp(codes: np.ndarray) -> np.ndarray:
    return COMP[codes][..., ::-1]


SIZES_SEED = 20121  # every run's graph takes its node sizes from one set


def node_lengths(rng, total: int, long_bp, short_bp) -> np.ndarray:
    """Lengths alternating long and short that sum to ``total`` (the last
    one cut to fit): one fixed set of sizes, drawn once, in an order of
    ``rng``'s (long among long, short among short), so that every seed
    gets a graph of the same node sizes."""
    fixed = np.random.default_rng(SIZES_SEED)
    n = total // long_bp[0] + 2
    lens = np.empty(2 * n, np.int64)
    lens[0::2] = fixed.integers(long_bp[0], long_bp[1], n)
    lens[1::2] = fixed.integers(short_bp[0], short_bp[1], n)
    ends = np.cumsum(lens)
    k = int(np.searchsorted(ends, total)) + 1
    lens = lens[:k].copy()
    lens[-1] -= int(ends[k - 1]) - total
    lens[0::2] = rng.permutation(lens[0::2])
    lens[1::2] = rng.permutation(lens[1::2])
    return lens


def write_lastgraph(path: str, nodes: List[np.ndarray], arcs) -> None:
    lines = [f"{len(nodes)}\t0\t0\t1".encode()]
    for i, s in enumerate(nodes):
        lines += [b"NODE\t%d" % (i + 1), LETTERS[s].tobytes(),
                  LETTERS[revcomp(s)].tobytes()]
    lines += [b"ARC\t%d\t%d" % (a, b) for a, b in arcs]
    with open(path, "wb") as f:
        f.write(b"\n".join(lines) + b"\n")


def write_fastq(path: str, name: str, reads: np.ndarray) -> None:
    """Uniform-length reads [n, L] as FASTQ, quality I."""
    n, L = reads.shape
    qual = b"I" * L
    seqs = LETTERS[reads]
    pre = name.encode()
    with open(path, "wb") as f:
        f.write(b"".join(b"@%s%d\n%s\n+\n%s\n" % (pre, i, seqs[i].tobytes(),
                                                   qual)
                         for i in range(n)))


def substitute(rng, reads: np.ndarray, rate: float) -> None:
    """Replace each base with probability ``rate`` by one of the other
    three, in place."""
    hit = rng.random(reads.shape) < rate
    reads[hit] = (reads[hit] + rng.integers(1, 4, int(hit.sum()))) % 4


def chain_graph(rng, w: dict):
    """The genome and its graph: a chain of nodes alternating long and
    short, plus short side branches off random chain nodes.  Returns
    (genome, nodes, arcs, chain node count)."""
    lens = node_lengths(rng, int(w["genome_bp"]), w["long_node_bp"],
                        w["short_node_bp"])
    genome = rng.integers(0, 4, int(lens.sum())).astype(np.uint8)
    cuts = np.cumsum(lens)[:-1]
    nodes = np.split(genome, cuts)
    arcs = [(i + 1, i + 2) for i in range(len(nodes) - 1)]
    n_side = int(len(nodes) * float(w.get("side_share", 0.0)))
    src = rng.integers(0, len(nodes) - 1, n_side)
    side = rng.integers(0, 4, (n_side, int(w.get("side_node_bp", 90))))
    n_chain = len(nodes)
    for j in range(n_side):
        nodes.append(side[j].astype(np.uint8))
        arcs.append((int(src[j]) + 1, n_chain + j + 1))
    return genome, nodes, arcs, n_chain


def innie_pairs(rng, genome, n, read_bp, insert_mean, insert_std, err):
    """n innie pairs: mate 1 forward at p, mate 2 the reverse complement
    of the read that ends the insert; substitutions at ``err``."""
    ins = np.clip(rng.normal(insert_mean, insert_std, n).astype(np.int64),
                  2 * read_bp, len(genome) - 1)
    p = rng.integers(0, len(genome) - ins)
    col = np.arange(read_bp)
    m1 = genome[p[:, None] + col]
    m2 = revcomp(genome[(p + ins - read_bp)[:, None] + col])
    m2 = np.ascontiguousarray(m2)
    substitute(rng, m1, err)
    substitute(rng, m2, err)
    return m1, m2


class World:
    """What a run's set-up made: files under ``root``, and the same data
    in memory for the reference (``nodes``, ``genome``, ``libraries``:
    name -> (mate 1 reads, mate 2 reads))."""

    def __init__(self, root, genome, nodes, arcs, n_chain, libraries):
        self.root = root
        self.genome = genome
        self.nodes = nodes
        self.arcs = arcs
        self.n_chain = n_chain
        self.libraries: Dict[str, tuple] = libraries
        self.graph_path = os.path.join(root, "LastGraph")


def make(cfg: dict, seed_seq: np.random.SeedSequence,
                      root: str) -> World:
    """The configuration's world (``cfg["world"]``) from the seed."""
    w = cfg["world"]
    rng = np.random.default_rng(seed_seq)
    genome, nodes, arcs, n_chain = chain_graph(rng, w)
    write_lastgraph(os.path.join(root, "LastGraph"), nodes, arcs)
    libs = {}
    for name, lib in w["libraries"].items():
        m1, m2 = innie_pairs(rng, genome, int(lib["pairs"]),
                             int(w["read_bp"]), float(lib["insert_mean"]),
                             float(lib["insert_std"]),
                             float(w["substitution_rate"]))
        for mate, reads in ((1, m1), (2, m2)):
            write_fastq(os.path.join(root, f"{name}_{mate}.fq"),
                        f"{name}_{mate}_", reads)
        libs[name] = (m1, m2)
    return World(root, genome, nodes, arcs, n_chain, libs)


def write_cli_config(cfg: dict, world: World, anneal_seed: int,
                     prefix: str) -> str:
    """The CLI's config file for the world: the configuration's global
    keys and library sections (``cfg["cli"]``), with the world's paths."""
    cli = cfg["cli"]
    lines = [f"graph={world.graph_path}", f"seed={anneal_seed}",
             f"output_prefix={prefix}"]
    lines += [f"{k}={v}" for k, v in cli["global"].items()]
    for name, keys in cli["libraries"].items():
        lines += ["", f"[{name}]",
                  f"cache_prefix={os.path.join(world.root, name)}",
                  f"filename1={os.path.join(world.root, name + '_1.fq')}",
                  f"filename2={os.path.join(world.root, name + '_2.fq')}"]
        lines += [f"{k}={v}" for k, v in keys.items()]
    path = os.path.join(world.root, "run.cfg")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def misassemblies(rng, world: World, n: int, ops: dict) -> List[List]:
    """``n`` assemblies of the chain: the true one, then seeded
    misassemblies of it, each a list of contigs (uint8 codes).  An
    assembly cuts the chain into ``ops["contigs"]`` contigs at node
    borders and applies ``ops["edits"]`` edits, each a swap of two runs
    of nodes, an inversion of a run, or the deletion of a run, of
    ``ops["run_nodes"]`` nodes."""
    chain = world.nodes[:world.n_chain]
    out = []
    for a in range(n):
        order = [(i, 0) for i in range(len(chain))]
        if a:
            for _ in range(int(ops["edits"])):
                kind = rng.integers(0, 3)
                r = int(rng.integers(ops["run_nodes"][0],
                                     ops["run_nodes"][1]))
                s = int(rng.integers(0, len(order) - 2 * r))
                if kind == 0:
                    t = int(rng.integers(s + r, len(order) - r))
                    order[s:s + r], order[t:t + r] = (order[t:t + r],
                                                      order[s:s + r])
                elif kind == 1:
                    order[s:s + r] = [(i, 1 - o) for i, o in
                                      reversed(order[s:s + r])]
                else:
                    del order[s:s + r]
        cuts = np.sort(rng.choice(np.arange(1, len(order)),
                                  int(ops["contigs"]) - 1, replace=False))
        contigs = []
        for piece in np.split(np.arange(len(order)), cuts):
            segs = [chain[order[j][0]] if order[j][1] == 0 else
                    revcomp(chain[order[j][0]]) for j in piece]
            contigs.append(np.ascontiguousarray(np.concatenate(segs)))
        out.append(contigs)
    return out
