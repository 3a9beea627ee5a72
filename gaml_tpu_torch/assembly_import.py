"""Starting-assembly ingestion: place graph nodes in assembly contigs and
stitch them into walks (reference GetPaths, gaml.cc:345-735).

The reference shells out to MUMmer nucmer for the node-in-contig
placements; here an internal seed-and-verify matcher does the same job
(>= 99% identity, partial matches allowed near contig N-edges with the
reference's tolerance rules), and the inter-node stitching reuses the
reference's contig-through-graph 0-1 BFS (AlignContig, gaml.cc:401-465)
with IUPAC-aware base matching.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from .core import dna
from .core.graph import Graph
from .core.io import read_fasta

PLACEMENT_SEED_K = 31
MAX_ALIGN_ERRORS = 10  # reference max_dist (gaml.cc:409)

_IUPAC = {
    "R": "AG", "Y": "CT", "K": "GT", "M": "AC", "S": "CG", "W": "AT",
}


def base_eq(a: str, b: str) -> bool:
    """Reference BaseEq (gaml.cc:375-384): b may be an IUPAC ambiguity
    code matching a concrete base a."""
    if a == b:
        return True
    return a in _IUPAC.get(b, "")


# --------------------------------------------------------------- placements
def find_node_placements(graph: Graph, ctgs: Dict[str, str],
                         min_node_len: int = 50,
                         min_identity: float = 0.99):
    """contig name -> sorted [(place, node_id)] placements, 1-based place
    (matching nucmer's coordinate convention the reference consumes).

    A placement is a seed 31-mer hit extended to the whole node with
    mismatch counting; accepted if the full node matches at >= 99%
    identity, or a node prefix/suffix hangs over a contig edge/N-run per
    the reference's tolerance checks (gaml.cc:598-637)."""
    index: Dict[bytes, List[Tuple[str, int]]] = {}
    k = PLACEMENT_SEED_K
    enc_ctgs = {}
    for name, seq in ctgs.items():
        up = seq.upper()
        enc_ctgs[name] = up
        bs = up.encode()
        for i in range(0, max(0, len(bs) - k + 1), 7):
            index.setdefault(bs[i:i + k], []).append((name, i))

    als: Dict[str, List[Tuple[int, int]]] = {}
    for nid in range(graph.num_nodes):
        node_seq = dna.decode_seq(graph.seqs[nid])
        nlen = len(node_seq)
        if nlen < min_node_len or nlen < k:
            continue
        nb = node_seq.encode()
        seen = set()
        # probe several seed offsets to survive scattered mismatches
        for off in range(0, nlen - k + 1, max(1, (nlen - k) // 6 or 1)):
            for probe in range(off, min(off + 7, nlen - k + 1)):
                hits = index.get(nb[probe:probe + k])
                if hits:
                    break
            else:
                continue
            for cname, cpos in hits:
                place0 = cpos - probe  # 0-based contig start of the node
                if (cname, place0) in seen:
                    continue
                seen.add((cname, place0))
                res = _verify_placement(enc_ctgs[cname], node_seq, place0,
                                        min_identity)
                if res is not None:
                    als.setdefault(cname, []).append((place0 + 1, nid))
    for lst in als.values():
        lst.sort()
    # dedup identical placements
    for name in list(als):
        seenp = set()
        out = []
        for p in als[name]:
            if p not in seenp:
                seenp.add(p)
                out.append(p)
        als[name] = out
    return als


def _verify_placement(ctg: str, node: str, place0: int,
                      min_identity: float) -> Optional[Tuple[int, int]]:
    """Check the node against the contig at place0.  Full-node overlap must
    reach >= min_identity over aligned columns; overhangs beyond the contig
    or into N-runs are tolerated within 20 bp like the reference's edge
    checks (gaml.cc:603-633).  Returns (start, end) node coords aligned."""
    nlen = len(node)
    start = max(0, -place0)
    end = min(nlen, len(ctg) - place0)
    if end - start < min(nlen, 30):
        return None
    seg = ctg[place0 + start:place0 + end]
    nseg = node[start:end]
    matches = sum(1 for a, b in zip(nseg, seg) if base_eq(a, b) or b == "N")
    if matches < min_identity * (end - start):
        return None
    # overhang tolerance: missing head/tail must be near an edge or N-run
    head = start
    tail = nlen - end
    if head > 20 or tail > 20:
        return None
    for i in range(head):
        cpos = place0 + i
        if 0 <= cpos < len(ctg) and ctg[cpos] != "N":
            return None
    for i in range(tail):
        cpos = place0 + end + i
        if 0 <= cpos < len(ctg) and ctg[cpos] != "N":
            return None
    return (start, end)


# ------------------------------------------------------------- 0-1 BFS glue
def align_contig(graph: Graph, start: int, target: int, contig: str) -> Optional[List[int]]:
    """Thread a contig gap sequence through the graph from the end of
    ``start`` to the start of ``target`` with <= 10 errors (reference
    AlignContig, gaml.cc:401-465).  Returns the inner node path or None."""
    node_strs = {}

    def nstr(nid):
        if nid not in node_strs:
            node_strs[nid] = dna.decode_seq(graph.seqs[nid])
        return node_strs[nid]

    clen = len(contig)
    fr = deque()
    visited = set()
    start_state = (0, len(nstr(start)), start, 0)
    fr.append((start_state, ()))
    visited.add(start_state)
    while fr:
        (cpos, npos, node, distv), pathv = fr.popleft()
        if cpos > clen:
            continue
        if distv < MAX_ALIGN_ERRORS:
            st = (cpos + 1, npos, node, distv + 1)
            if st not in visited:
                visited.add(st)
                fr.append((st, pathv))
        if target == -1 and cpos == clen:
            return list(pathv)
        if npos == len(nstr(node)):
            for nnode in graph.next[node]:
                if nnode == target and cpos == clen:
                    return list(pathv)
                if cpos >= clen:
                    continue
                if base_eq(nstr(nnode)[0], contig[cpos]):
                    st = (cpos + 1, 1, nnode, distv)
                    if st not in visited:
                        visited.add(st)
                        fr.appendleft((st, pathv + (nnode,)))
                elif distv < MAX_ALIGN_ERRORS:
                    for st in ((cpos + 1, 1, nnode, distv + 1),
                               (cpos, 1, nnode, distv + 1)):
                        if st not in visited:
                            visited.add(st)
                            fr.append((st, pathv + (nnode,)))
        else:
            if cpos >= clen:
                continue
            if base_eq(nstr(node)[npos], contig[cpos]):
                st = (cpos + 1, npos + 1, node, distv)
                if st not in visited:
                    visited.add(st)
                    fr.appendleft((st, pathv))
            elif distv < MAX_ALIGN_ERRORS:
                for st in ((cpos + 1, npos + 1, node, distv + 1),
                           (cpos, npos + 1, node, distv + 1)):
                    if st not in visited:
                        visited.add(st)
                        fr.append((st, pathv))
    return None


def alignment_to_path(graph: Graph, als: List[Tuple[int, int]],
                      paths: List[List[int]], contig: str) -> None:
    """Stitch sorted (place, node) placements into a walk, aligning the
    inter-node contig sequence through the graph or inserting a gap
    (reference AligmentToPath, gaml.cc:468-527)."""
    cur_path = [als[0][1]]
    last = als[0][0] + graph.node_len(als[0][1])
    for i in range(1, len(als)):
        cur = als[i][0]
        if last < cur:
            runs = []
            current = 0
            beg = 0
            for j in range(last, cur):
                if j < len(contig) and contig[j] == "N":
                    if current == 0:
                        beg = j
                    current += 1
                else:
                    if current > 4:
                        runs.append((beg, j))
                    current = 0
            if current > 4:
                runs.append((beg, cur))
            if not runs:
                found = align_contig(graph, cur_path[-1], als[i][1],
                                     contig[last - 1:cur - 1])
                if found is None:
                    cur_path.append(-(cur - last))
                else:
                    cur_path.extend(found)
            else:
                cur_path.append(-(cur - last))
        last = als[i][0] + graph.node_len(als[i][1])
        cur_path.append(als[i][1])
    paths.append(cur_path)


def get_paths(graph: Graph, contigs_file: str) -> List[List[int]]:
    """Reference GetPaths (gaml.cc:530-697) with the internal matcher."""
    ctgs = read_fasta(contigs_file)
    als = find_node_placements(graph, ctgs)
    paths: List[List[int]] = []
    for name in sorted(als):
        alignment_to_path(graph, als[name], paths, ctgs[name])
    return paths


def clip_paths(paths: List[List[int]], graph: Graph,
               threshold: int = 500) -> List[List[int]]:
    """Trim walks to their long-node spans (reference ClipPaths,
    gaml.cc:699-714; note the reference hardcodes 500 here regardless of
    the configured threshold)."""
    out = []
    for p in paths:
        b = e = -1
        for i, x in enumerate(p):
            if x < 0:
                continue
            if graph.node_len(x) > threshold:
                e = i
                if b == -1:
                    b = i
        if b == -1:
            continue
        out.append(p[b:e + 1])
    return out


def add_missing_big_nodes(paths: List[List[int]], graph: Graph,
                          threshold: int = 500) -> None:
    """Append singleton walks for absent long nodes (reference
    AddMissingBigNodes, gaml.cc:716-735; threshold hardcoded 500)."""
    found = set()
    for p in paths:
        for e in p:
            found.add(e)
            if e >= 0:
                found.add(e ^ 1)
    for i in range(0, graph.num_nodes, 2):
        if graph.node_len(i) <= threshold:
            continue
        if i in found:
            continue
        paths.append([i])
