"""Nucleotide codec.

Mirrors the reference 8-bit "mangled" encoding (sequence.c:287-318,
make3BitMangledCodec): bits 0-2 hold a 3-bit alphabet code over
"ACGTXN" (A=0 C=1 G=2 T=3, X=4, N=5; 7 = termination), bit 2 doubles
as the non-standard-nucleotide flag, and bits 3-7 hold the original
(upper-cased) ASCII letter as offset from 'A' plus 1.  'U' is read as
'T'; any character that is not A/C/G/T becomes code 5 ('N' class) but
keeps its letter when in 'A'..'A'+30; everything else decodes to 'N'.

The 2-bit standard code has the property complement(x) = ~x & 3.
Non-standard codes are left unchanged under reverse complement
(sequence.c:1009-1031).

All tables are NumPy arrays so whole reads/references encode in one
vectorized gather.
"""
from __future__ import annotations

import numpy as np

CODE_A, CODE_C, CODE_G, CODE_T = 0, 1, 2, 3
CODE_X, CODE_N = 4, 5
CODE_TERM = 7
ALPHA_MASK = 0x07
STDNT_MASK = 0x03
STDNT_TESTBIT = 0x04
QVAL_OFFS = 0x21  # '!' (sequence.h:102)

_STD = b"ACGT"


def _build_tables():
    codtab = np.zeros(256, dtype=np.uint8)
    codtab[0] = CODE_TERM
    n_offs = ord("N") - ord("A") + 1
    for i in range(1, 256):
        cu = ord(chr(i).upper()) if i < 128 else i
        if cu == ord("U"):
            cu = ord("T")
        offs = cu - ord("A") + 1
        if 0 < offs < 32:
            try:
                a = _STD.index(cu)
            except ValueError:
                a = CODE_N
            codtab[i] = a + (offs << 3)
        else:
            codtab[i] = CODE_N + (n_offs << 3)
    decodtab = np.full(256, ord("N"), dtype=np.uint8)
    for c in range(256):
        offs = c >> 3
        if 0 < offs < 32:
            decodtab[c] = ord("A") + offs - 1
    decodtab[CODE_TERM] = 0
    # complement: comp_full[x] = full code of the base whose 2-bit code is
    # (~x)&3 (sequence.c:305)
    comp_full = np.zeros(4, dtype=np.uint8)
    for a, ch in enumerate(_STD):
        comp_full[(~a) & 3] = codtab[ch]
    return codtab, decodtab, comp_full


CODTAB, DECODTAB, COMP_FULL = _build_tables()


def encode(seq: bytes | np.ndarray) -> np.ndarray:
    """ASCII bytes -> mangled uint8 codes."""
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, (bytes, bytearray)) else np.asarray(seq, dtype=np.uint8)
    return CODTAB[arr]


def decode(codes: np.ndarray) -> bytes:
    """Mangled uint8 codes -> ASCII bytes."""
    return DECODTAB[np.asarray(codes, dtype=np.uint8)].tobytes()


def alpha(codes: np.ndarray) -> np.ndarray:
    """3-bit alphabet code (0-5) used by scoring and hashing."""
    return codes & ALPHA_MASK


def is_nonstd(codes: np.ndarray) -> np.ndarray:
    return (codes & STDNT_TESTBIT) != 0


def revcomp_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of a mangled code array; non-standard bases are
    reversed but not complemented (sequence.c:1021-1030)."""
    rev = codes[::-1].copy()
    std = (rev & STDNT_TESTBIT) == 0
    rev[std] = COMP_FULL[rev[std] & STDNT_MASK]
    return rev
