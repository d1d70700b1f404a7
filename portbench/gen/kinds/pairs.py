"""FR pairs: chip_smoke.py's make_pairs with its rates as the traffic's
parameters (gen/reads.py): fragments of insert_mean +- insert_sd bases
(at least the longer mate + 10), mate lengths and errors as the traffic
states; in half of the pairs the fragment comes from the reverse strand
(mate 1 reads its right end reverse-complemented)."""
from __future__ import annotations

import numpy as np

from portbench.gen.reads import PAD, Mate, lengths, mutate, revcomp, slack

MATES = 2


def _width(code: np.ndarray, L: int) -> np.ndarray:
    if code.shape[1] == L:
        return code
    return np.pad(code, ((0, 0), (0, L - code.shape[1])),
                  constant_values=PAD)


def make(rng, genome: np.ndarray, traffic: dict, n: int) -> list:
    l1, l2 = lengths(rng, traffic, n), lengths(rng, traffic, n)
    L = int(max(l1.max(), l2.max()))
    flen = np.clip(np.rint(rng.normal(traffic["insert_mean"],
                                      traffic["insert_sd"], n)),
                   np.maximum(l1, l2) + 10, None).astype(np.int64)
    start = rng.integers(0, len(genome) - flen - slack(traffic, L))
    lc, ls = mutate(rng, genome, start, l1, traffic)
    rpos = start + flen - l2
    rc, rs = mutate(rng, genome, rpos, l2, traffic)
    rc = revcomp(rc, l2)
    lc, rc = _width(lc, L), _width(rc, L)
    swap = rng.random(n) < 0.5
    pick = (lambda a, b: np.where(swap.reshape((-1,) + (1,) * (a.ndim - 1)),
                                  b, a))
    m1 = Mate(pick(lc, rc), pick(l1, l2), pick(start, rpos), pick(ls, rs),
              swap)
    m2 = Mate(pick(rc, lc), pick(l2, l1), pick(rpos, start), pick(rs, ls),
              ~swap)
    return [m1, m2]
