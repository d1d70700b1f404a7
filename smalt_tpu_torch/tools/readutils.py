"""Small read-set utilities — equivalents of the reference misc/ tools:

  mixreads    mix reads from two FASTQ files (misc/mixreads.c)
  splitmates  split an interleaved FASTQ into /1 and /2 files
              (misc/splitmates.c)
  splitreads  extract a range of reads (misc/splitreads.c)
  readstats   read count / length statistics (misc/readstats.c)
  trunkreads  truncate reads to a maximum length (misc/trunkreads.c)
  fetchseq    fetch a segment from a stored reference set
              (misc/fetchseq.c)
  simqual     impose sampled base-quality values + quality-driven
              errors on reads (misc/simqual.c)
  basqcol     collect base-quality statistics (misc/basqcol.c)
"""
from __future__ import annotations

import sys

import numpy as np

from ..seq import codec
from ..seq.io import FastqReader
from ..seq.refset import RefSet


def _emit(f, read, seq=None, qual=None):
    seq = seq if seq is not None else codec.decode(read.seq).decode()
    q = qual if qual is not None else (
        read.qual.decode() if read.qual else "5" * len(seq))
    f.write(f"@{read.name}\n{seq}\n+\n{q}\n")


def mixreads(argv):
    """usage: mixreads <a.fq> <b.fq> <out.fq> [fraction_a=0.5] [seed=11]"""
    a, b, out = argv[:3]
    frac = float(argv[3]) if len(argv) > 3 else 0.5
    seed = int(argv[4]) if len(argv) > 4 else 11
    rng = np.random.default_rng(seed)
    ita, itb = iter(FastqReader(a)), iter(FastqReader(b))
    with open(out, "w") as f:
        while True:
            src = ita if rng.random() < frac else itb
            r = next(src, None)
            if r is None:
                rest = itb if src is ita else ita
                for r in rest:
                    _emit(f, r)
                return 0
            _emit(f, r)


def splitmates(argv):
    """usage: splitmates <interleaved.fq> <out_prefix>"""
    src, pref = argv[:2]
    with open(pref + "_1.fq", "w") as f1, open(pref + "_2.fq", "w") as f2:
        for r in FastqReader(src):
            n = r.name.split()[0]
            if n.endswith("/2"):
                _emit(f2, r)
            else:
                _emit(f1, r)
    return 0


def splitreads(argv):
    """usage: splitreads <in.fq> <from> <to> <out.fq>  (0-based, to excl.)"""
    src, lo, hi, out = argv[0], int(argv[1]), int(argv[2]), argv[3]
    with open(out, "w") as f:
        for i, r in enumerate(FastqReader(src)):
            if i >= hi:
                break
            if i >= lo:
                _emit(f, r)
    return 0


def readstats(argv):
    """usage: readstats <in.fq>"""
    lens = [len(r.seq) for r in FastqReader(argv[0])]
    arr = np.asarray(lens)
    print(f"reads: {len(arr)}")
    if len(arr):
        print(f"min/median/max length: {arr.min()}/{int(np.median(arr))}/"
              f"{arr.max()}")
        print(f"total bases: {arr.sum()}")
    return 0


def trunkreads(argv):
    """usage: trunkreads <in.fq> <maxlen> <out.fq>"""
    src, maxlen, out = argv[0], int(argv[1]), argv[2]
    with open(out, "w") as f:
        for r in FastqReader(src):
            seq = codec.decode(r.seq).decode()[:maxlen]
            q = (r.qual.decode()[:maxlen] if r.qual else "5" * len(seq))
            _emit(f, r, seq, q)
    return 0


def fetchseq(argv):
    """usage: fetchseq <index_prefix> <seqname|seqidx> <start> <end>
    (0-based, end inclusive; prints FASTA to stdout)"""
    pref, which, start, end = argv[0], argv[1], int(argv[2]), int(argv[3])
    rs = RefSet.load(pref)
    try:
        sidx = int(which)
    except ValueError:
        sidx = [rs.sam_name(i) for i in range(rs.nseq)].index(which)
    seg = rs.fetch_by_seq(sidx, start, end - start + 1)
    s = codec.decode(seg).decode()
    print(f">{rs.sam_name(sidx)}:{start}-{end}")
    for i in range(0, len(s), 60):
        print(s[i : i + 60])
    return 0


def basqcol(argv):
    """usage: basqcol <in.fq>  — per-position base-quality statistics"""
    tot = None
    cnt = None
    for r in FastqReader(argv[0]):
        if r.qual is None:
            continue
        q = np.frombuffer(r.qual, np.uint8).astype(np.int64) - 33
        if tot is None:
            tot = np.zeros(len(q), np.int64)
            cnt = np.zeros(len(q), np.int64)
        n = min(len(q), len(tot))
        tot[:n] += q[:n]
        cnt[:n] += 1
    if tot is None:
        print("no quality data")
        return 1
    for i, (t, c) in enumerate(zip(tot, cnt)):
        if c:
            print(f"{i}\t{t / c:.2f}")
    return 0


def simqual(argv):
    """usage: simqual <in.fq> <out.fq> <profile.tsv|flat:Q> [seed=17]
    Impose base qualities (flat or per-position profile file of
    'pos<TAB>meanQ' lines) and inject errors at rate 10^(-Q/10)."""
    src, out = argv[0], argv[1]
    spec = argv[2]
    seed = int(argv[3]) if len(argv) > 3 else 17
    rng = np.random.default_rng(seed)
    if spec.startswith("flat:"):
        flatq = int(spec.split(":")[1])
        profile = None
    else:
        profile = {}
        for ln in open(spec):
            p, q = ln.split()
            profile[int(p)] = float(q)
        flatq = None
    bases = "ACGT"
    with open(out, "w") as f:
        for r in FastqReader(src):
            seq = list(codec.decode(r.seq).decode())
            quals = []
            for i in range(len(seq)):
                q = flatq if flatq is not None else profile.get(i, 20)
                quals.append(int(q))
                if seq[i] in bases and rng.random() < 10 ** (-q / 10):
                    seq[i] = bases[(bases.index(seq[i]) +
                                    1 + int(rng.random() * 3)) % 4]
            _emit(f, r, "".join(seq),
                  "".join(chr(33 + min(q, 60)) for q in quals))
    return 0
