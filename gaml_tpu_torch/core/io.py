"""IO: FASTA/FASTQ parsers, Velvet LastGraph loader, assembly writers.

Output formats match the reference byte-for-byte:
- ``<prefix>.walks``: walk-coordinate trace (reference OutputPathC,
  graph.cc:277-290);
- ``<prefix>.fasta``: spelled walks with gaps as N (OutputPathA,
  graph.cc:292-314);
- ``<prefix>.onlylarge.fasta``: short nodes masked to N (OutputPathAT,
  graph.cc:254-275).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple

from . import dna
from .graph import Graph, convert_node_id


# ------------------------------------------------------------------ readers
def read_fasta(path: str) -> Dict[str, str]:
    """Name (first whitespace-token) -> sequence (reference GetPaths contig
    reader, gaml.cc:530-553)."""
    out: Dict[str, str] = {}
    name = None
    buf: List[str] = []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if name is not None and buf:
                    out[name] = "".join(buf)
                name = line[1:].split()[0] if len(line) > 1 else ""
                buf = []
            else:
                buf.append(line)
    if name is not None and buf:
        out[name] = "".join(buf)
    return out


def iter_fastq(path: str) -> Iterator[Tuple[str, str]]:
    """Yield (name, seq) from a 4-line FASTQ (reference PreprocessReads,
    graph.cc:1386-1415: name is the first whitespace-token of the @ line)."""
    with open(path) as f:
        while True:
            header = f.readline()
            if not header:
                return
            seq = f.readline().rstrip("\n")
            f.readline()
            f.readline()
            name = header[1:].split()[0]
            yield name, seq


def write_fasta(path: str, records: Sequence[Tuple[str, str]]) -> None:
    with open(path, "w") as f:
        for name, seq in records:
            f.write(f">{name}\n{seq}\n")


# ---------------------------------------------------------------- LastGraph
def load_lastgraph(path: str) -> Graph:
    """Parse a Velvet LastGraph file (reference LoadGraph, graph.cc:52-106).

    Layout: a header line whose first tab-field is the node count; per node a
    NODE header line followed by two sequence lines (forward, reverse); then
    ``ARC\\tsrc\\tdst`` lines with signed 1-based Velvet ids."""
    gr = Graph()
    with open(path) as f:
        header = f.readline().rstrip("\n")
        n = int(header.split("\t")[0])
        for _ in range(n):
            f.readline()  # NODE header line
            s_fwd = f.readline().rstrip("\n")
            s_rev = f.readline().rstrip("\n")
            gr.add_node_pair(dna.encode_seq(s_fwd), dna.encode_seq(s_rev))
        for line in f:
            if line.startswith("ARC"):
                parts = line.rstrip("\n").split("\t")
                src = convert_node_id(int(parts[1]))
                dst = convert_node_id(int(parts[2]))
                gr.add_arc(src, dst)
    gr.calc_prob_sums()
    gr.calc_normalize_map()
    return gr


# ------------------------------------------------------------------ writers
def walk_coord_line(gr: Graph, path: Sequence[int], cid: int) -> str:
    """One record of the .walks file (reference OutputPathC, graph.cc:277-290)."""
    pieces = [f">tmp{cid}-"]
    pos = 0
    for i, e in enumerate(path):
        sep = "\n" if i + 1 == len(path) else "-"
        pieces.append(f"{e}({pos}){sep}")
        pos += gr.node_len(e) if e >= 0 else -e
    return "".join(pieces)


def output_paths_to_console(paths: Sequence[Sequence[int]], gr: Graph,
                            threshold: int, color: bool = True) -> str:
    """Pretty-print walks with long nodes highlighted (reference
    OutputPathsToConsole, input_output.cc:11-20).  Returns the string and
    prints it."""
    green, reset = ("\x1b[32m", "\x1b[0m") if color else ("", "")
    parts = []
    for p in paths:
        bits = []
        for j, e in enumerate(p):
            txt = f"{e}"
            if e >= 0 and gr.node_len(e) > threshold:
                txt = f"{green}{e}{reset}"
            bits.append(txt)
        parts.append("(" + ",".join(bits) + ")")
    out = " ".join(parts)
    print(out)
    return out


def output_paths_to_file(paths: Sequence[Sequence[int]], gr: Graph,
                         kmer: int, threshold: int, prefix: str) -> None:
    """Write <prefix>.walks / .fasta / .onlylarge.fasta
    (reference OutputPathsToFile, input_output.cc:22-45)."""
    with open(prefix + ".walks", "w") as fw, open(prefix + ".fasta", "w") as ff:
        for i, p in enumerate(paths):
            fw.write(walk_coord_line(gr, p, i))
            ff.write(f">tmp{i}\n{dna.decode_seq(gr.spell(p))}\n")
    with open(prefix + ".onlylarge.fasta", "w") as fl:
        for i, p in enumerate(paths):
            fl.write(f">tmp{i}\n{dna.decode_seq(gr.spell_long_masked(p, threshold))}\n")
