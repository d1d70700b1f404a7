"""Plain NumPy Smith-Waterman with affine gaps, and the score of an
alignment written as a CIGAR.  Imports nothing of the program.

Scores: a match `match`, a substitution `subst`; a gap of length n costs
gapopen + (n - 1) * gapext (both given as positive costs).  Codes 0..3 are
A, C, G, T; PAD (4) scores PAD_SCORE against everything, so no alignment
runs into the padding of a batch.
"""
from __future__ import annotations

import re

import numpy as np

PAD = 4
PAD_SCORE = -1000
_CIGAR = re.compile(r"(\d+)([MIDNSHP=X])")


def score_table(match: int, subst: int) -> np.ndarray:
    t = np.full((5, 5), subst, np.int32)
    np.fill_diagonal(t, match)
    t[PAD, :] = t[:, PAD] = PAD_SCORE
    return t


def local_best(q: np.ndarray, s: np.ndarray, table: np.ndarray,
               gapopen: int, gapext: int) -> np.ndarray:
    """Best local alignment score of each query q [B, Q] against its
    subject s [B, S] (codes 0..4), by rows of the subject: H the best
    score ending at a cell, E a gap along the subject (from the row
    above), F a gap along the query (within the row, by a running max)."""
    B, Q = q.shape
    S = s.shape[1]
    H = np.zeros((B, Q + 1), np.int32)
    E = np.full((B, Q + 1), -(1 << 20), np.int32)
    best = np.zeros(B, np.int32)
    j = np.arange(Q + 1, dtype=np.int32)
    for i in range(S):
        w = table[s[:, i][:, None], q]                        # [B, Q]
        E = np.maximum(E - gapext, H - gapopen)
        Hn = np.zeros_like(H)
        Hn[:, 1:] = np.maximum(np.maximum(H[:, :-1] + w, E[:, 1:]), 0)
        # F[j] = max over k < j of Hn[k] - gapopen - (j - 1 - k) * gapext
        run = np.maximum.accumulate(Hn + j * gapext, axis=1)
        F = np.full_like(Hn, -(1 << 20))
        F[:, 1:] = run[:, :-1] - gapopen - (j[1:] - 1) * gapext
        H = np.maximum(Hn, F)
        H[:, 0] = 0
        best = np.maximum(best, H.max(axis=1))
    return best


def parse_cigar(cigar: str):
    return [(int(n), op) for n, op in _CIGAR.findall(cigar)]


def cigar_score(cigar, read: np.ndarray, genome: np.ndarray, pos0: int,
                match: int, subst: int, gapopen: int, gapext: int):
    """(score, edit distance, reference span) of the alignment `cigar`
    (parse_cigar's list) of `read` (codes, as printed in SEQ) placed at
    0-based `pos0`; None where it runs off the genome or has an op this
    check does not know."""
    q, r, score, nm = 0, pos0, 0, 0
    for n, op in cigar:
        if op == "S":
            q += n
        elif op in "M=X":
            if r < 0 or r + n > len(genome):
                return None
            same = read[q:q + n] == genome[r:r + n]
            k = int(same.sum())
            score += k * match + (n - k) * subst
            nm += n - k
            q, r = q + n, r + n
        elif op == "I":
            score -= gapopen + (n - 1) * gapext
            nm += n
            q += n
        elif op == "D":
            score -= gapopen + (n - 1) * gapext
            nm += n
            r += n
        else:
            return None
    if q != len(read):
        return None
    return score, nm, r - pos0
