"""Build a de-Bruijn-style graph (k=101) directly from a scaffold FASTA
when no Velvet graph is given (reference GetGraphFromAssembly,
graph_from_assembly.cc:131-351).

Pipeline: scaffolds split at N-runs into contigs (IUPAC codes normalized:
R,M->A; Y,S->C; K->G; W->T; anything else dropped), k-mers registered in
rc-paired ids, unbranched interior k-mers collapsed into intervals, the
intervals renumbered into rc-paired graph nodes whose sequences are the
per-k-mer last characters, and scaffold walks emitted with gap entries
-(gap + k - 1).

Faithful quirk: the reference never populates graph *edges* on this path
(big_cons is collected but unused), so reroute moves have nothing to
sample; pass connect=True to also wire edges from the interval adjacency
(an opt-in improvement over the reference).
"""
from __future__ import annotations

from typing import Dict, List, Set, Tuple


from .core import dna
from .core.graph import Graph

K_ASSEMBLY = 101

_NORM = {"A": "A", "C": "C", "G": "G", "T": "T",
         "R": "A", "M": "A", "Y": "C", "S": "C", "K": "G", "W": "T"}


# contig normalization: mapped IUPAC codes kept, everything else dropped
# (reference behavior: only _NORM keys survive, graph_from_assembly.cc:51-63)
_NORM_TRANS = {i: None for i in range(256)}
_NORM_TRANS.update({ord(c): v for c, v in _NORM.items()})

_RC_TRANS = str.maketrans("ACGT", "TGCA")


def _rc_str(s: str) -> str:
    """Reverse complement of a normalized (ACGT-only) string."""
    return s.translate(_RC_TRANS)[::-1]


class Scaffold:
    """Reference Scaffold (graph_from_assembly.cc:15-78)."""

    def __init__(self, scf: str):
        self.sc_size = len(scf)
        assert scf[0] not in "Nn"
        self.contigs: List[str] = []
        self.gaps: List[int] = []
        # split at N-runs (a run of g Ns yields g-1 empty split segments),
        # then normalize each contig via translate — same contigs/gaps as
        # the reference's per-char loop, including its asserts (non-empty
        # normalized contigs; scaffolds may not end in N)
        segs = scf.replace("n", "N").split("N")
        assert segs[-1] != ""  # reference: `assert buf` at scaffold end
        empties = 0
        first = True
        for seg in segs:
            if seg == "":
                empties += 1
                continue
            if not first:
                self.gaps.append(empties + 1)
            empties = 0
            first = False
            contig = seg.translate(_NORM_TRANS)
            assert contig
            self.contigs.append(contig)
        assert len(self.gaps) + 1 == len(self.contigs)
        self.contig_paths: List[List[int]] = [[] for _ in self.contigs]


class KmerDB:
    """Reference KmerDB (graph_from_assembly.cc:86-129): string k-mer ->
    rc-paired int ids, adjacency with dedup."""

    def __init__(self):
        self.db: Dict[str, int] = {}
        self.coords: Dict[int, Tuple[int, int, int]] = {}
        self.cons: Dict[int, List[int]] = {}
        self.big_cons: Dict[int, List[int]] = {}

    def get(self, x: str, coord=None) -> int:
        if x not in self.db:
            assert coord is not None
            new_id = len(self.db)
            self.db[x] = new_id
            self.coords[new_id] = coord
            self.db[dna.revcomp_str(x)] = new_id + 1
        return self.db[x]

    def add_con_checked(self, frm: int, to: int) -> None:
        lst = self.cons.setdefault(frm, [])
        if to not in lst:
            lst.append(to)

    def add_con(self, frm: int, to: int) -> None:
        self.add_con_checked(frm, to)
        self.add_con_checked(to ^ 1, frm ^ 1)

    def add_big_con(self, frm: int, to: int) -> None:
        self.big_cons.setdefault(frm, []).append(to)


def _kmer_db_python(scaffolds, k: int):
    """Python fallback of the native kmer_db_build: per-contig id streams,
    per-id spelled base, ignored mask (reference KmerDB + the ignored rule,
    graph_from_assembly.cc:86-129, 206-222)."""
    import numpy as np

    kmerdb = KmerDB()
    end_markers: Set[int] = set()
    kid_streams: List[List[List[int]]] = []
    db = kmerdb.db
    coords = kmerdb.coords
    for si, sc in enumerate(scaffolds):
        sc_streams: List[List[int]] = []
        kid_streams.append(sc_streams)
        for ci, c in enumerate(sc.contigs):
            prev = -1
            kids: List[int] = []
            sc_streams.append(kids)
            n = len(c) - k + 1
            get = db.get
            for i in range(n):
                x = c[i:i + k]
                kid = get(x)
                if kid is None:
                    kid = len(db)
                    db[x] = kid
                    coords[kid] = (si, ci, i)
                    db[_rc_str(x)] = kid + 1
                    kid = db[x]  # palindrome quirk: rc insert overwrites
                if prev != -1:
                    kmerdb.add_con(prev, kid)
                if i == 0 or i == n - 1:
                    end_markers.add(kid)
                    end_markers.add(kid ^ 1)
                prev = kid
                kids.append(kid)

    n_ids = len(db)
    ignored_mask = np.zeros(max(n_ids, 1), dtype=bool)
    for i in range(n_ids):
        cons_i = kmerdb.cons.get(i, [])
        if len(cons_i) == 1 and i not in end_markers:
            nxt = cons_i[0]
            if nxt == (i ^ 1):
                continue
            if len(kmerdb.cons.get(nxt ^ 1, [])) == 1 and \
                    nxt not in end_markers:
                ignored_mask[nxt] = True

    code = {"G": 0, "A": 1, "T": 2, "C": 3}
    char_of = np.zeros(max(n_ids, 1), dtype=np.uint8)
    for even, (si, ci, pos) in coords.items():
        c = scaffolds[si].contigs[ci]
        char_of[even] = code[c[pos + k - 1]]
        if even + 1 < n_ids:
            char_of[even + 1] = 3 - code[c[pos]]
    return kid_streams, char_of[:max(n_ids, 1)], ignored_mask


def get_graph_from_assembly(filename: str, gr: Graph,
                            k: int = K_ASSEMBLY,
                            connect: bool = False) -> List[List[int]]:
    """Populate ``gr`` and return the scaffold walks."""
    scfs: List[str] = []
    buf: List[str] = []
    with open(filename) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith(">"):
                if buf:
                    scfs.append("".join(buf))
                buf = []
            else:
                buf.append(line)
    if buf:
        scfs.append("".join(buf))

    scaffolds = [Scaffold(s) for s in scfs]

    import numpy as np

    # ---- phase 1: k-mer id streams + per-id spelled base + ignored mask
    from .native import get_lib

    if get_lib() is not None and k % 2 == 1:
        from .native import kmer_db_build

        contig_codes = []
        lens = []
        for sc in scaffolds:
            for c in sc.contigs:
                contig_codes.append(dna.encode_seq(c))
                lens.append(len(c))
        ctg_off = np.zeros(len(lens) + 1, dtype=np.int64)
        np.cumsum(lens, out=ctg_off[1:])
        buf = (np.concatenate(contig_codes) if contig_codes
               else np.zeros(0, dtype=np.uint8))
        streams_flat, char_of, ignored_mask = kmer_db_build(buf, ctg_off, k)
        ignored_mask = ignored_mask.astype(bool)
        kid_streams = []
        at = 0
        it = iter(lens)
        for sc in scaffolds:
            row = []
            kid_streams.append(row)
            for _c in sc.contigs:
                n = max(next(it) - k + 1, 0)
                row.append(streams_flat[at:at + n])
                at += n
    else:
        kid_streams, char_of, ignored_mask = _kmer_db_python(scaffolds, k)

    # ---- phase 2: collapse ignored interiors into intervals (reference
    # scan loops, graph_from_assembly.cc:241-279) — vectorized: runs are
    # the stream slices between consecutive non-ignored positions
    intervals: Dict[int, np.ndarray] = {}
    big_cons: List[tuple] = []

    def scan_ids(kids: np.ndarray, record_path: List[int] = None):
        if len(kids) == 0:
            return
        starts = np.nonzero(~ignored_mask[kids])[0]
        if len(starts) == 0:
            return  # all ignored: reference's cur never starts
        firsts = kids[starts].tolist()
        bounds = starts.tolist() + [len(kids)]
        for j, f in enumerate(firsts):
            s, e = bounds[j], bounds[j + 1]
            old = intervals.get(f)
            if old is None or e - s > len(old):
                intervals[f] = kids[s:e]
        if record_path is not None:
            record_path.extend(firsts[:-1])
        for j in range(len(firsts) - 1):
            big_cons.append((firsts[j], firsts[j + 1]))

    for si, sc in enumerate(scaffolds):
        for ci, _c in enumerate(sc.contigs):
            kids = np.asarray(kid_streams[si][ci], dtype=np.int32)
            scan_ids(kids, sc.contig_paths[ci])
            # rc contig's i-th k-mer is the revcomp of the forward contig's
            # k-mer at (n-1-i), whose id is the rc-paired id
            scan_ids(kids[::-1] ^ 1)

    # interval invariants (graph_from_assembly.cc:281-287)
    for first, inter in intervals.items():
        inv = inter[::-1] ^ 1
        assert int(inv[0]) in intervals
        assert np.array_equal(intervals[int(inv[0])], inv)

    renumber: Dict[int, int] = {}
    for first, inter in intervals.items():
        a, b = int(inter[0]), int(inter[-1]) ^ 1
        if a not in renumber:
            assert b not in renumber
            assert a != b
            new_id = len(renumber)
            renumber[a] = new_id
            renumber[b] = new_id + 1

    n_nodes = len(renumber)
    gr.seqs = [None] * n_nodes
    gr.next = [[] for _ in range(n_nodes)]
    gr.next_prob = [[] for _ in range(n_nodes)]
    gr.next_sum = [0.0] * n_nodes
    assert n_nodes == len(intervals)
    for first, inter in intervals.items():
        nid = renumber[int(inter[0])]
        assert gr.seqs[nid] is None
        gr.seqs[nid] = char_of[inter]

    if connect:
        seen = set()
        for frm, to in big_cons:
            if (frm, to) in seen:
                continue
            seen.add((frm, to))
            if frm in renumber and to in renumber:
                a, b = renumber[frm], renumber[to]
                if not gr.has_next(a, b):
                    gr.add_arc(a, b)

    gr.calc_prob_sums()
    gr.calc_normalize_map()

    paths: List[List[int]] = []
    for sc in scaffolds:
        path: List[int] = []
        for i, _c in enumerate(sc.contigs):
            for kid in sc.contig_paths[i]:
                assert kid in renumber
                path.append(renumber[kid])
            if i + 1 < len(sc.contigs):
                path.append(-(sc.gaps[i] + k - 1))
        paths.append(path)
    return paths
