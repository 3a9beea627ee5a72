"""World maker ``hybrid``: one genome cut into a Velvet-style graph, a
paired (frag) library and a long-read (PacBio) library sampled from it,
made from the seed and written as LastGraph and FASTQ under a run
directory, with one CLI config file holding both libraries' sections.
Vectorised numpy; nothing of the program is imported.  A configuration
names it under ``world.maker``.

The graph is ``worlds/paired.py``'s chain with its side branches
(``chain_graph``); the paired libraries are its ``innie_pairs``; the long
reads follow ``worlds/pacbio.py``'s law (``read_lengths``, ``long_read``:
one set of lengths for every seed, errors at the configuration's rates,
half reverse-complemented), their lengths clipped to ``long_read_bp``.
"""
from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from harness import common

paired = common.load_module("worlds", "paired")
pacbio = common.load_module("worlds", "pacbio")
revcomp = paired.revcomp


class World:
    """What a run's set-up made: files under ``root``, and the same data
    in memory for the reference (``nodes``: the graph's forward codes in
    LastGraph order; ``libraries``: paired name -> (mate 1 reads, mate 2
    reads); ``reads``: the long-read library's reads as written)."""

    def __init__(self, root, genome, nodes, arcs, n_chain, libraries, reads):
        self.root = root
        self.genome = genome
        self.nodes = nodes
        self.arcs = arcs
        self.n_chain = n_chain
        self.libraries: Dict[str, tuple] = libraries
        self.reads: List[np.ndarray] = reads
        self.graph_path = os.path.join(root, "LastGraph")
        self.fastq_path = os.path.join(root, "pb.fq")


def long_reads(rng, w: dict, genome: np.ndarray) -> List[np.ndarray]:
    """``w["reads"]`` long reads of ``genome`` by ``worlds/pacbio.py``'s
    law, lengths clipped to ``w["long_read_bp"]``."""
    n = int(w["reads"])
    lens = pacbio.read_lengths(rng, dict(w, read_bp=w["long_read_bp"]), n)
    # a template longer than any read it gives (net +3.5 % bases)
    span = lens + lens // 4 + 64
    starts = rng.integers(0, len(genome) - span)
    flip = rng.random(n) < float(w["reverse_share"])
    reads = []
    for i in range(n):
        r = pacbio.long_read(rng, genome[starts[i]:starts[i] + span[i]],
                             int(lens[i]), w["errors"])
        reads.append(np.ascontiguousarray(revcomp(r)) if flip[i] else r)
    return reads


def make(cfg: dict, seed_seq: np.random.SeedSequence, root: str) -> World:
    """The configuration's world (``cfg["world"]``) from the seed."""
    w = cfg["world"]
    rng = np.random.default_rng(seed_seq)
    genome, nodes, arcs, n_chain = paired.chain_graph(rng, w)
    paired.write_lastgraph(os.path.join(root, "LastGraph"), nodes, arcs)
    libs = {}
    for name, lib in w["libraries"].items():
        m1, m2 = paired.innie_pairs(rng, genome, int(lib["pairs"]),
                                    int(w["read_bp"]),
                                    float(lib["insert_mean"]),
                                    float(lib["insert_std"]),
                                    float(w["substitution_rate"]))
        for mate, reads in ((1, m1), (2, m2)):
            paired.write_fastq(os.path.join(root, f"{name}_{mate}.fq"),
                               f"{name}_{mate}_", reads)
        libs[name] = (m1, m2)
    reads = long_reads(rng, w, genome)
    world = World(root, genome, nodes, arcs, n_chain, libs, reads)
    pacbio.write_fastq(world.fastq_path, reads)
    return world


def write_cli_config(cfg: dict, world: World, anneal_seed: int,
                     prefix: str) -> str:
    """The CLI's config file for the world: the configuration's global
    keys, then a section for each library (``cfg["cli"]``): a paired one
    reads its two mate files, a ``type=pacbio`` one the long reads."""
    cli = cfg["cli"]
    lines = [f"graph={world.graph_path}", f"seed={anneal_seed}",
             f"output_prefix={prefix}"]
    lines += [f"{k}={v}" for k, v in cli["global"].items()]
    for name, keys in cli["libraries"].items():
        lines += ["", f"[{name}]",
                  f"cache_prefix={os.path.join(world.root, name)}"]
        if keys["type"] == "pacbio":
            lines.append(f"filename={world.fastq_path}")
        else:
            lines += [
                f"filename1={os.path.join(world.root, name + '_1.fq')}",
                f"filename2={os.path.join(world.root, name + '_2.fq')}"]
        lines += [f"{k}={v}" for k, v in keys.items()]
    path = os.path.join(world.root, "run.cfg")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path
