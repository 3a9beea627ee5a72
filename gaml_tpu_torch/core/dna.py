"""DNA sequence encoding.

Bases are stored as uint8 codes chosen to match the reference's 2-bit k-mer
packing table (reference: graph.h:311-314, graph.h:327-330 — trans['G']=0,
trans['A']=1, trans['T']=2, trans['C']=3), so packed k-mers and hence max-hash
fingerprints are bit-identical to the reference index.  A pleasant consequence
of this table: the Watson-Crick complement of code ``x`` is ``3 - x``.

Anything that is not an upper-case ACGT maps to ``CODE_N`` (=4) and never
matches anything in alignment kernels.
"""
from __future__ import annotations

import numpy as np

CODE_G = 0
CODE_A = 1
CODE_T = 2
CODE_C = 3
CODE_N = 4

_ENCODE_LUT = np.full(256, CODE_N, dtype=np.uint8)
_ENCODE_LUT[ord("G")] = CODE_G
_ENCODE_LUT[ord("A")] = CODE_A
_ENCODE_LUT[ord("T")] = CODE_T
_ENCODE_LUT[ord("C")] = CODE_C

_DECODE_LUT = np.frombuffer(b"GATCN", dtype=np.uint8)

# complement(x) = 3-x for ACGT; N stays N.
_COMP_LUT = np.array([3, 2, 1, 0, CODE_N], dtype=np.uint8)


def encode_seq(s: str | bytes) -> np.ndarray:
    """Encode an ASCII DNA string into uint8 codes."""
    if isinstance(s, str):
        s = s.encode()
    raw = np.frombuffer(s, dtype=np.uint8)
    return _ENCODE_LUT[raw]


def decode_seq(codes: np.ndarray) -> str:
    """Decode uint8 codes back into an ACGTN string."""
    return _DECODE_LUT[np.asarray(codes, dtype=np.uint8)].tobytes().decode()


def complement(codes: np.ndarray) -> np.ndarray:
    return _COMP_LUT[codes]


def revcomp(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of an encoded sequence.

    Matches reference ``ReverseSeq`` (graph.h:66-72): non-ACGT characters are
    kept as-is (here: CODE_N maps to CODE_N) while ACGT complement.
    """
    return _COMP_LUT[codes[::-1]]


def revcomp_str(s: str) -> str:
    return decode_seq(revcomp(encode_seq(s)))


def is_acgt(codes: np.ndarray) -> bool:
    """True iff every base is an unambiguous ACGT (reference CheckRead,
    graph.cc:1271-1278)."""
    return bool(np.all(codes < 4))
