"""Read simulator — equivalent of misc/simread.c.

Simulates single or paired reads from a reference with substitutions
and optional indels.  Read names encode the truth for downstream
evaluation:  <prefix>_<number>_<seqname>_<position>_<seqidx>_<F|R>_<varspec>
where varspec is the per-read variation layout as match/substitution/
insert/delete run lengths (e.g. "51s49m" = 51 matches, substitution,
49 matches), matching the reference's naming scheme.

usage: simread <index_or_fasta> <readlen> <nreads> <err%> <indels y|n>
               <insert (0=single)> <insert_std> <seed> <prefix> <out>
Paired output goes to <out>_1.fq / <out>_2.fq.
"""
from __future__ import annotations

import math
import os
import sys

import numpy as np

from ..seq import codec
from ..seq.refset import RefSet

COMP = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}
QUAL_CHAR = "5"  # constant phred-20 qualities, like the bundled fixtures


def _revcomp(s: str) -> str:
    return "".join(COMP.get(c, "N") for c in reversed(s))


def _load_ref(path: str) -> RefSet:
    if os.path.exists(path + ".smt.npz"):
        return RefSet.load(path)
    return RefSet.from_fasta(path)


def _mutate(rng, seq: str, err_frac: float, with_indels: bool):
    """Apply substitutions (and geometric-length indels when enabled) at
    an expected per-base rate err_frac.  Returns (read, varspec)."""
    out = []
    spec = []
    run = 0

    def flush(code):
        nonlocal run
        if run or code == "m":
            spec.append(f"{run}{code}" if code == "m" else
                        (f"{run}{code}" if run else code))
        run = 0

    i = 0
    bases = "ACGT"
    while i < len(seq):
        r = rng.random()
        if r < err_frac:
            kind = rng.random()
            if with_indels and kind < 0.1:
                ln = 1 + int(min(rng.geometric(0.5) - 1, 3))
                if kind < 0.05:   # insertion into the read
                    spec.append(f"{run}i" if run else "i")
                    run = 0
                    out.append("".join(rng.choice(list(bases))
                                       for _ in range(1)))
                    i += 0
                    # consume nothing from reference; keep read length by
                    # dropping a trailing base later
                    out.append(seq[i])
                    i += 1
                    continue
                else:             # deletion from the read
                    spec.append(f"{run}d" if run else "d")
                    run = 0
                    i += 1
                    continue
            # substitution
            orig = seq[i]
            alt = bases[(bases.index(orig) + 1 + int(rng.random() * 3)) % 4] \
                if orig in bases else "A"
            out.append(alt)
            spec.append(f"{run}s" if run else "s")
            run = 0
            i += 1
        else:
            out.append(seq[i])
            run += 1
            i += 1
    spec.append(f"{run}m")
    return "".join(out), "".join(spec)


def main(argv):
    if len(argv) != 10:
        print(__doc__, file=sys.stderr)
        return 1
    (refnam, readlen, nreads, errpct, indels, insert, insert_std, seed,
     prefix, outnam) = argv
    readlen = int(readlen)
    nreads = int(nreads)
    err_frac = float(errpct) / 100.0
    with_indels = indels.lower().startswith("y")
    insert = int(insert)
    insert_std = int(insert_std)
    seed = int(seed)
    rng = np.random.default_rng(seed if seed > 0 else None)

    refset = _load_ref(refnam)
    print(f"total length of reference sequences: {refset.total_len} bp",
          file=sys.stderr)
    decoded = codec.decode(refset.codes).decode("ascii")

    def draw_read(n, pair_no=None):
        while True:
            sidx = int(rng.integers(0, refset.nseq))
            slen = refset.seq_len(sidx)
            if slen >= readlen:
                break
        pos = int(rng.integers(0, slen - readlen + 1))
        off = int(refset.offsets[sidx])
        raw = decoded[off + pos : off + pos + readlen]
        is_rev = bool(rng.integers(0, 2))
        read, spec = _mutate(rng, raw, err_frac, with_indels)
        read = read[:readlen].ljust(readlen, "A")
        if is_rev:
            read = _revcomp(read)
        name = (f"{prefix}_{n:09d}_{refset.sam_name(sidx)}_{pos:09d}_"
                f"{sidx}_{'R' if is_rev else 'F'}_{spec}")
        if pair_no is not None:
            name += f"/{pair_no}"
        return name, read

    if insert == 0:
        with open(outnam if outnam.endswith(".fq") else outnam + ".fq",
                  "w") as f:
            for n in range(nreads):
                name, read = draw_read(n)
                f.write(f"@{name}\n{read}\n+\n{QUAL_CHAR * len(read)}\n")
    else:
        base = outnam[:-3] if outnam.endswith(".fq") else outnam
        with open(base + "_1.fq", "w") as f1, open(base + "_2.fq", "w") as f2:
            npairs = nreads // 2
            for n in range(npairs):
                while True:
                    sidx = int(rng.integers(0, refset.nseq))
                    slen = refset.seq_len(sidx)
                    isz = (int(rng.normal(insert, insert_std))
                           if insert > 0 else readlen * 2)
                    if isz >= 2 * readlen and slen >= isz:
                        break
                pos = int(rng.integers(0, slen - isz + 1))
                off = int(refset.offsets[sidx])
                fwd_raw = decoded[off + pos : off + pos + readlen]
                rev_raw = decoded[off + pos + isz - readlen : off + pos + isz]
                r1, spec1 = _mutate(rng, fwd_raw, err_frac, with_indels)
                r2, spec2 = _mutate(rng, rev_raw, err_frac, with_indels)
                r1 = r1[:readlen].ljust(readlen, "A")
                r2 = _revcomp(r2[:readlen].ljust(readlen, "A"))
                nm = refset.sam_name(sidx)
                f1.write(f"@{prefix}_{n:09d}_{nm}_{pos:09d}_{sidx}_F_{spec1}/1\n"
                         f"{r1}\n+\n{QUAL_CHAR * readlen}\n")
                f2.write(f"@{prefix}_{n:09d}_{nm}_{pos + isz - readlen:09d}_"
                         f"{sidx}_R_{spec2}/2\n"
                         f"{r2}\n+\n{QUAL_CHAR * readlen}\n")
    return 0
