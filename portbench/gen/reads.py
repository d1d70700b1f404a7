"""Reads made from a seed, by the traffic file's parameters.

The traffic's `reads` names the kind of reads, a module of its own,
`portbench/gen/kinds/<reads>.py`, found by that name: `MATES` (1 or 2) and
`make(rng, genome, traffic, n)`, the n reads (pairs) of one chunk as a
list of `Mate`s.  What the kinds share is here: the lengths, the error
model and the FASTQ text.

  read_len        a length (every read that long), or a law of lengths:
                  {"law": "uniform", "min": a, "max": b} or
                  {"law": "lognormal", "median": m, "sigma": s,
                   "min": a, "max": b} (drawn, then clipped to [a, b]);
  substitutions   share of bases changed, never to the same base;
  indels          share of read positions holding an inserted base, and
                  the same share of deletions (one genome base skipped
                  before a read base); 0 or absent: none;
  reverse_share   (single reads) share reverse-complemented.

These are chip_smoke.py's laws (1% substitutions, half the reads
reverse-complemented, FR pairs of insert_mean +- insert_sd) with their
draws made in bulk, so that one core makes reads several times faster
than the port maps them: the same laws, not the same random streams.
Fixed-length reads without indels draw exactly what they drew before
indels and laws of lengths were added.

Reads are made in chunks of `chunk` reads (pairs count both mates);
chunk c of seed s always holds the same reads, so the reference makes
again just the chunks it checks.  Read serial r is named `r%010d` (pairs:
both mates carry the pair's name).
"""
from __future__ import annotations

import importlib
import re
from dataclasses import dataclass

import numpy as np

ACGT = np.frombuffer(b"ACGTN", np.uint8)
PAD = 4                     # past a read's length in a row of codes
NAME_DIGITS = 10
KIND_NAME = re.compile(r"^[a-z][a-z0-9_]{0,63}$")


@dataclass
class Mate:
    """The reads of one mate of a chunk (all reads, for single reads):
    codes [n, Lmax] (0..3, PAD past each read's length) as the read is
    sequenced, lens [n], and the read's origin in the genome: its first
    base `truth`, the `span` of genome bases it covers, and whether the
    read is its reverse complement (`rev`)."""
    codes: np.ndarray
    lens: np.ndarray
    truth: np.ndarray
    span: np.ndarray
    rev: np.ndarray


def kind(traffic: dict):
    """The module of the traffic's kind of reads."""
    name = traffic["reads"]
    if not KIND_NAME.match(name):
        raise ValueError(f"no kind of reads {name!r}")
    return importlib.import_module(f"portbench.gen.kinds.{name}")


def paired(traffic: dict) -> bool:
    return kind(traffic).MATES == 2


def substitute(rng, code: np.ndarray, rate: float) -> np.ndarray:
    """Codes 0..3 with each base changed with probability `rate`, never
    to the same base: a binomial count of positions drawn uniformly (a
    position drawn twice changes once), the law of a draw per base at a
    hundredth of the random numbers.  Changes `code` in place."""
    flat = code.reshape(-1)
    k = rng.binomial(flat.size, rate)
    at = np.unique(rng.integers(0, flat.size, k))
    flat[at] = (flat[at] + 1 + rng.integers(0, 3, len(at), dtype=np.uint8)) % 4
    return code


def _rows(genome: np.ndarray, start: np.ndarray, L: int) -> np.ndarray:
    """genome[s : s + L] for each s, a copy [n, L]."""
    return np.lib.stride_tricks.sliding_window_view(genome, L)[start]


def lengths(rng, traffic: dict, n: int) -> np.ndarray:
    """n read lengths by the traffic's `read_len` (no draw for a fixed
    length)."""
    law = traffic["read_len"]
    if not isinstance(law, dict):
        return np.full(n, int(law), np.int64)
    if law["law"] == "uniform":
        out = rng.integers(law["min"], law["max"] + 1, n)
    elif law["law"] == "lognormal":
        out = np.rint(rng.lognormal(np.log(law["median"]), law["sigma"], n))
    else:
        raise ValueError(f"no law of lengths {law['law']!r}")
    return np.clip(out, law["min"], law["max"]).astype(np.int64)


def nominal_len(traffic: dict) -> int:
    """A read's length as the traffic states it: the fixed length, or the
    law's mean (lognormal: clipped to its range)."""
    law = traffic["read_len"]
    if not isinstance(law, dict):
        return int(law)
    if law["law"] == "uniform":
        return (law["min"] + law["max"]) // 2
    mean = law["median"] * np.exp(law["sigma"] ** 2 / 2)
    return int(min(max(mean, law["min"]), law["max"]))


def slack(traffic: dict, L: int) -> int:
    """Genome bases past a read's length that its deletions may take."""
    rate = float(traffic.get("indels", 0))
    return 0 if rate <= 0 else int(8 + 4 * rate * L + 4 * np.sqrt(rate * L))


def mutate(rng, genome: np.ndarray, pos: np.ndarray, lens: np.ndarray,
           traffic: dict):
    """Reads of `lens` bases sequenced from the genome at `pos` (forward
    strand) under the traffic's error model: (codes [n, Lmax], span [n]).

    With indels each read position holds an inserted (random) base with
    probability `indels`, and is preceded by a deleted genome base with
    the same probability: read base i comes from genome base pos + i -
    (insertions up to i) + (deletions up to i)."""
    L = int(lens.max()) if len(lens) else 0
    rate = float(traffic.get("indels", 0))
    sub = float(traffic["substitutions"])
    if rate <= 0:
        code = substitute(rng, _rows(genome, pos, L), sub)
        span = lens.copy()
    else:
        ins = rng.random((len(pos), L)) < rate
        dele = rng.random((len(pos), L)) < rate
        src = (pos[:, None] + np.arange(L) - np.cumsum(ins, 1) +
               np.cumsum(dele, 1))
        src = np.minimum(src, len(genome) - 1)
        code = genome[src]
        code[ins] = rng.integers(0, 4, int(ins.sum()), dtype=np.uint8)
        code = substitute(rng, code, sub)
        last = src[np.arange(len(pos)), lens - 1]
        span = last + 1 - pos
    if (lens != L).any():
        code[np.arange(L) >= lens[:, None]] = PAD
    return code, span


def revcomp(code: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """The reverse complement of each row's first lens[i] codes, PAD
    after them."""
    n, L = code.shape
    if (lens == L).all():
        return (3 - code[:, ::-1]).astype(np.uint8)
    j = np.arange(L)
    src = np.clip(lens[:, None] - 1 - j, 0, L - 1)
    out = 3 - np.take_along_axis(code, src, 1)
    out[j >= lens[:, None]] = PAD
    return out.astype(np.uint8)


def chunk_rng(seed: int, c: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 63), 2, c])


def make_chunk(traffic: dict, genome: np.ndarray, seed: int, c: int):
    """Chunk c: its list of `Mate`s and the serial of its first read (or
    pair)."""
    k = kind(traffic)
    n = traffic["chunk"] // k.MATES
    return k.make(chunk_rng(seed, c), genome, traffic, n), c * n


def record_len(L) -> int:
    """Bytes of one FASTQ record of L bases: @name, sequence, +,
    qualities."""
    return (2 + NAME_DIGITS + 1) + (L + 1) + 2 + (L + 1)


def fastq(codes: np.ndarray, first: int, lens=None) -> bytes:
    """FASTQ records of codes [n, Lmax] (each row's first lens[i] codes)
    named r<serial> from `first` on, formatted in one array."""
    n, L = codes.shape
    serial = first + np.arange(n, dtype=np.int64)
    if lens is None or (lens == L).all():
        rec = np.empty((n, record_len(L)), np.uint8)
        rec[:] = np.frombuffer(b"@r" + b"0" * NAME_DIGITS + b"\n" + b"A" * L +
                               b"\n+\n" + b"I" * L + b"\n", np.uint8)
        for k in range(NAME_DIGITS):
            rec[:, 2 + k] += ((serial // 10 ** (NAME_DIGITS - 1 - k)) % 10
                              ).astype(np.uint8)
        a = 3 + NAME_DIGITS
        rec[:, a: a + L] = ACGT[codes]
        return rec.tobytes()
    size = record_len(lens)
    end = np.cumsum(size)
    start = end - size
    out = np.full(int(end[-1]), ord("I"), np.uint8)
    out[start], out[start + 1] = ord("@"), ord("r")
    for k in range(NAME_DIGITS):
        out[start + 2 + k] = 48 + (serial // 10 ** (NAME_DIGITS - 1 - k)) % 10
    s0 = start + 3 + NAME_DIGITS
    out[s0 - 1] = ord("\n")
    keep = np.arange(L) < lens[:, None]
    out[(s0[:, None] + np.arange(L))[keep]] = ACGT[codes[keep]]
    sep = s0 + lens
    out[sep], out[sep + 1], out[sep + 2] = ord("\n"), ord("+"), ord("\n")
    out[end - 1] = ord("\n")
    return out.tobytes()


def serial_of(name: str) -> int:
    return int(name[1:])
