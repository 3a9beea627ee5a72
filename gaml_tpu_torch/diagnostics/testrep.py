"""Repeat diagnostic tool (reference testrep.cc:99-147): hash all 500-mers
of the input scaffold contigs and report duplicated windows.  Everything
after the reference's ``return 0`` is dead code and intentionally omitted.

Usage: python -m gaml_tpu_torch.diagnostics.testrep <scaffolds.fasta> [k]
"""
from __future__ import annotations

import sys
from typing import Dict, List, Tuple

from ..core.io import read_fasta

DEFAULT_K = 500


def find_repeats(ctgs: Dict[str, str], k: int = DEFAULT_K):
    """Returns [(window_seq_hash_key, [(contig, pos), ...])] for windows
    occurring more than once."""
    seen: Dict[int, List[Tuple[str, int]]] = {}
    for name, seq in ctgs.items():
        for i in range(len(seq) - k + 1):
            h = hash(seq[i:i + k])
            seen.setdefault(h, []).append((name, i))
    return [(h, locs) for h, locs in seen.items() if len(locs) > 1]


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: testrep <scaffolds.fasta> [k]", file=sys.stderr)
        return 1
    k = int(argv[1]) if len(argv) > 1 else DEFAULT_K
    ctgs = read_fasta(argv[0])
    reps = find_repeats(ctgs, k)
    for _h, locs in sorted(reps, key=lambda e: e[1]):
        locs_str = " ".join(f"{n}:{p}" for n, p in locs)
        print(f"repeat x{len(locs)}: {locs_str}")
    print(f"total repeated {k}-mers: {len(reps)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
