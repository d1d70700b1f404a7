"""Single-end reads: chip_smoke.py's make_reads with its rates as the
traffic's parameters (gen/reads.py): origins uniform over the genome,
the traffic's lengths and error model, a share `reverse_share`
reverse-complemented."""
from __future__ import annotations

import numpy as np

from portbench.gen.reads import Mate, lengths, mutate, revcomp, slack

MATES = 1


def make(rng, genome: np.ndarray, traffic: dict, n: int) -> list:
    lens = lengths(rng, traffic, n)
    L = int(lens.max())
    pos = rng.integers(0, len(genome) - L - slack(traffic, L), n)
    code, span = mutate(rng, genome, pos, lens, traffic)
    rev = rng.random(n) < traffic["reverse_share"]
    code[rev] = revcomp(code[rev], lens[rev])
    return [Mate(code, lens, pos, span, rev)]
