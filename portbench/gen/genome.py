"""Reference genomes made from a seed, by a repeat model read from the
configuration file.

A genome is uniform random bases with repeat families written over it.
Each family in `genome.families` is one of:

  {"kind": "dispersed", "unit_len": [lo, hi], "units": n,
   "share": f | "copies": c, "fragment": [lo, hi] | null,
   "divergence": [lo, hi]}
      `units` consensus sequences of a length drawn from [lo, hi]; copies
      of them (or, with `fragment`, a random stretch of that length of
      one) on either strand at uniform positions, each with its own
      substitution rate drawn from `divergence`, until the copies hold a
      share `share` of the genome's bases (or there are `copies`).
  {"kind": "tandem", "unit_len": [lo, hi], "array_units": [lo, hi],
   "share": f | "copies": c, "divergence": [lo, hi]}
      arrays of a random unit repeated a drawn number of times.

Copies that land on each other overwrite: the later one wins, so the
shares are upper bounds.  Everything is vectorised: a 64 Mb genome with
a few ten thousand copies takes a few seconds.
"""
from __future__ import annotations

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)


def genome_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 63), 1])


def _substitute(rng, code: np.ndarray, rate) -> np.ndarray:
    """Codes 0..3 with a share `rate` (a scalar or one a base) changed,
    never to the same base."""
    mut = rng.random(code.shape) < rate
    return np.where(mut, (code + 1 + rng.integers(0, 3, code.shape)) % 4,
                    code).astype(np.uint8)


def _segments(lens: np.ndarray):
    """(segment id, offset in the segment) of every base of segments of
    lengths `lens`, laid end to end."""
    total = int(lens.sum())
    seg = np.repeat(np.arange(len(lens)), lens)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return seg, np.arange(total) - np.repeat(starts, lens)


def _draw(rng, lohi, n: int) -> np.ndarray:
    lo, hi = lohi
    return rng.integers(lo, hi + 1, n)


def _copies_needed(fam: dict, n: int, mean_len: float) -> int:
    if "copies" in fam:
        return int(fam["copies"])
    return max(1, int(round(fam["share"] * n / mean_len)))


def _dispersed(rng, g: np.ndarray, mask: np.ndarray, fam: dict) -> None:
    n = len(g)
    ulen = _draw(rng, fam["unit_len"], int(fam["units"]))
    cons = rng.integers(0, 4, int(ulen.sum()), dtype=np.uint8)
    cstart = np.concatenate([[0], np.cumsum(ulen)[:-1]])
    frag = fam.get("fragment")
    mean = np.mean(frag) if frag else float(ulen.mean())
    nc = _copies_needed(fam, n, min(mean, float(ulen.mean())))
    unit = rng.integers(0, len(ulen), nc)
    if frag:
        clen = np.minimum(_draw(rng, frag, nc), ulen[unit])
        off = (rng.random(nc) * (ulen[unit] - clen + 1)).astype(np.int64)
    else:
        clen, off = ulen[unit], np.zeros(nc, np.int64)
    rev = rng.random(nc) < 0.5
    div = rng.uniform(*fam["divergence"], nc)
    at = (rng.random(nc) * (n - clen)).astype(np.int64)
    seg, k = _segments(clen)
    src = np.where(rev[seg], clen[seg] - 1 - k, k) + off[seg] + \
        cstart[unit][seg]
    code = cons[src]
    code = np.where(rev[seg], 3 - code, code).astype(np.uint8)
    g[at[seg] + k] = _substitute(rng, code, div[seg])
    mask[at[seg] + k] = True


def _tandem(rng, g: np.ndarray, mask: np.ndarray, fam: dict) -> None:
    n = len(g)
    mean = np.mean(fam["unit_len"]) * np.mean(fam["array_units"])
    na = _copies_needed(fam, n, mean)
    ulen = _draw(rng, fam["unit_len"], na)
    alen = ulen * _draw(rng, fam["array_units"], na)
    ucode = rng.integers(0, 4, int(ulen.sum()), dtype=np.uint8)
    ustart = np.concatenate([[0], np.cumsum(ulen)[:-1]])
    div = rng.uniform(*fam["divergence"], na)
    at = (rng.random(na) * (n - alen)).astype(np.int64)
    seg, k = _segments(alen)
    code = ucode[ustart[seg] + k % ulen[seg]]
    g[at[seg] + k] = _substitute(rng, code, div[seg])
    mask[at[seg] + k] = True


def make_genome(genome: dict, seed: int, with_mask: bool = False):
    """Codes 0..3 (uint8) of the configuration's `genome` section; with
    `with_mask`, also the bases that a repeat copy covers (bool)."""
    rng = genome_rng(seed)
    g = rng.integers(0, 4, int(genome["length"]), dtype=np.uint8)
    mask = np.zeros(len(g), bool)
    for fam in genome.get("families", []):
        {"dispersed": _dispersed, "tandem": _tandem}[fam["kind"]](
            rng, g, mask, fam)
    return (g, mask) if with_mask else g


def write_fasta(path: str, codes: np.ndarray, name: str = "chr") -> None:
    """One sequence, 80 bases a line."""
    n = len(codes)
    full = n // 80
    body = np.empty((full, 81), np.uint8)
    body[:, :80] = ACGT[codes[: full * 80]].reshape(full, 80)
    body[:, 80] = ord("\n")
    with open(path, "wb") as f:
        f.write(b">%s\n" % name.encode())
        f.write(body.tobytes())
        if n > full * 80:
            f.write(ACGT[codes[full * 80:]].tobytes() + b"\n")
