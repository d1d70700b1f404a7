"""The comparison that decides `correct`, over the batches of SAM records
the run kept, against the genome and the reads the benchmark made.

Every read of a kept batch is made again from the seed (gen/reads.py),
and its records are held to:

  missing          reads of the batch with no record, or with more than
                   one (pairs: one a mate), and records of no read of it;
  record_mismatch  mapped records whose SEQ is not the read (reverse-
                   complemented on 0x10), or whose CIGAR at POS, scored
                   again against the genome, does not give their AS and NM;
  pair_fields      (pairs) mates whose flags 0x1/0x40/0x80/0x2, RNEXT,
                   PNEXT, 0x20/0x8 or TLEN do not match the other mate's
                   record;
  below_local_pct  share of mapped reads whose AS is below the best local
                   score (reference/sw.py) of the read in the genome
                   around the alignment (its reference span, LOCAL_MARGIN
                   either side): the window's score and end cell, and the
                   tail's traceback;
  missed_unique_pct share of the reads (mates) from unique sequence (no
                   base of their origin under a repeat copy) whose best
                   local score at their true origin (TRUTH_MARGIN either
                   side) is above their AS (0 when unmapped): a window or a
                   placement missed;
  missed_repeat_pct the same share over the reads whose origin touches a
                   repeat copy.  A copy a few % diverged can hold the best
                   seeds; --fast is allowed to take it (placed_pct bounds
                   that), the exact search is held to it where the cell's
                   limits name this number.

Reads may differ in length (gen/reads.py): each is judged at its own
length, and the reference's windows are as wide as the read's span.

(the harness adds `lost`: how far the records the port wrote in all
differ from the reads fed to it), and `placed_pct` is the share of reads whose record lies on the right
strand within PLACED_BP of the origin.  Nothing here imports the program;
its records are read only to be judged.
"""
from __future__ import annotations

import numpy as np

from portbench.gen.reads import make_chunk, paired, revcomp, serial_of
from portbench.reference.sw import (PAD, cigar_score, local_best,
                                    parse_cigar, score_table)

LOCAL_MARGIN = 4
TRUTH_MARGIN = 8
PLACED_BP = 8
_CODE = np.full(256, PAD, np.uint8)
_CODE[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)


def windows(genome: np.ndarray, start: np.ndarray,
            width: np.ndarray) -> np.ndarray:
    """genome[start : start + width] for each start (and its width), PAD
    outside it; rows as wide as the widest."""
    width = np.broadcast_to(width, start.shape)
    idx = start[:, None] + np.arange(int(width.max()) if len(start) else 0)
    ok = (idx >= 0) & (idx < len(genome)) & (idx < (start + width)[:, None])
    return np.where(ok, genome[np.clip(idx, 0, len(genome) - 1)],
                    PAD).astype(np.uint8)


class Records:
    """The SAM records of the kept batches, split into columns."""

    def __init__(self, texts):
        rows = [ln.split("\t") for t in texts for ln in t.splitlines() if ln]
        self.n = len(rows)
        self.name = [r[0] for r in rows]
        self.flag = np.array([int(r[1]) for r in rows], np.int64)
        self.rname = [r[2] for r in rows]
        self.pos = np.array([int(r[3]) for r in rows], np.int64)
        self.cigar = [r[5] for r in rows]
        self.rnext = [r[6] for r in rows]
        self.pnext = np.array([int(r[7]) for r in rows], np.int64)
        self.tlen = np.array([int(r[8]) for r in rows], np.int64)
        self.seq = [r[9] for r in rows]
        tags = [dict(t.split(":", 1) for t in r[11:]) for r in rows]
        self.AS = np.array([int(t.get("AS", "i:0")[2:]) for t in tags])
        self.NM = np.array([int(t.get("NM", "i:0")[2:]) for t in tags])
        self.serial = np.array([serial_of(x) for x in self.name], np.int64)
        self.mate = np.where(self.flag & 0x80, 1, 0)


def expected_reads(rec: Records, batch: int, total: int) -> np.ndarray:
    """The read (pair) serials of the batches the kept records fall in."""
    firsts = np.unique(rec.serial // batch) * batch
    return np.concatenate([np.arange(f, min(f + batch, total))
                           for f in firsts]) if len(firsts) else \
        np.zeros(0, np.int64)


def truth_reads(traffic, genome, seed, serials):
    """codes [n, m, Lmax] (PAD past each read), and lens, truth, span,
    is_reverse [n, m] of the serials (m mates), made again chunk by
    chunk."""
    per = traffic["chunk"] // (2 if paired(traffic) else 1)
    got = {}
    for c in np.unique(serials // per):
        got[int(c)] = make_chunk(traffic, genome, seed, int(c))[0]
    L = max(m.codes.shape[1] for ms in got.values() for m in ms)
    picks = [(int(s % per), got[int(s // per)]) for s in serials]

    def col(f):
        return np.array([[getattr(m, f)[i] for m in ms] for i, ms in picks])
    codes = np.full((len(serials), len(picks[0][1]), L), PAD, np.uint8)
    for k, (i, ms) in enumerate(picks):
        for j, m in enumerate(ms):
            codes[k, j, :m.codes.shape[1]] = m.codes[i]
    return codes, col("lens"), col("truth"), col("span"), col("rev")


def judge(texts, traffic: dict, scores: dict, genome: np.ndarray, seed: int,
          total_serials: int, batch: int, repeats: np.ndarray) -> dict:
    """Readings of the kept batches `texts` (each `batch` reads or pairs
    from a multiple of it) against the genome and its repeat mask:
    {name: value} for the numbers above and placed_pct, with `reads` the
    reads judged."""
    rec = Records(texts)
    pe = paired(traffic)
    nm = 2 if pe else 1
    match, subst = scores["match"], scores["subst"]
    go, ge = scores["gapopen"], scores["gapext"]
    table = score_table(match, subst)
    want = expected_reads(rec, batch, total_serials)
    if len(want) == 0:
        return {"reads": 0}
    # one record a read (mate): index [serial, mate] -> record
    slot = {int(s): i for i, s in enumerate(want)}
    at = np.full((len(want), nm), -1, np.int64)
    missing = 0
    for i in range(rec.n):
        k = slot.get(int(rec.serial[i]))
        if k is None or at[k, rec.mate[i]] >= 0:
            missing += 1
            continue
        at[k, rec.mate[i]] = i
    missing += int((at < 0).sum())
    codes, lens, truth, span, rev = truth_reads(traffic, genome, seed, want)
    L = codes.shape[2]
    flat_lens = lens.reshape(-1)
    have = at >= 0
    ri = np.where(have, at, 0)
    flag = rec.flag[ri]
    mapped = have & ((flag & 4) == 0)
    AS = np.where(mapped, rec.AS[ri], 0)
    # reads as printed (forward strand of the genome) on 0x10
    back = revcomp(codes.reshape(-1, L), flat_lens).reshape(codes.shape)
    shown = np.where(((flag & 0x10) != 0)[..., None], back, codes)
    mismatch = 0
    diag = np.zeros(at.shape, np.int64)
    ref_span = np.zeros(at.shape, np.int64)
    for k, m in zip(*np.nonzero(mapped)):
        i = at[k, m]
        n = int(lens[k, m])
        seq = _CODE[np.frombuffer(rec.seq[i].encode(), np.uint8)]
        cig = parse_cigar(rec.cigar[i])
        got = cigar_score(cig, shown[k, m, :n], genome, int(rec.pos[i]) - 1,
                          match, subst, go, ge)
        lead = cig[0][0] if cig and cig[0][1] == "S" else 0
        diag[k, m] = rec.pos[i] - 1 - lead
        # the read's extent on the genome, clips included
        ref_span[k, m] = n if got is None else max(n, got[2] + n -
                                                   _aligned(cig))
        if (len(seq) != n or not np.array_equal(seq, shown[k, m, :n]) or
                got is None or got[0] != rec.AS[i] or got[1] != rec.NM[i]):
            mismatch += 1
    mk, mm = np.nonzero(mapped)
    local = local_best(shown[mk, mm], windows(
        genome, diag[mk, mm] - LOCAL_MARGIN,
        ref_span[mk, mm] + 2 * LOCAL_MARGIN), table, go, ge)
    below = int((local > AS[mk, mm]).sum())
    fwd = np.where(rev[..., None], back, codes).reshape(-1, L)
    t = truth.reshape(-1)
    sp = span.reshape(-1)
    tb = local_best(fwd, windows(genome, t - TRUTH_MARGIN,
                                 sp + 2 * TRUTH_MARGIN), table, go, ge)
    cover = np.concatenate([[0], np.cumsum(repeats, dtype=np.int64)])
    unique = cover[np.minimum(t + sp, len(genome))] == cover[t]
    missed = (tb > AS.reshape(-1))
    n_repeat = int((~unique).sum())
    strand_ok = ((flag & 0x10) != 0) == rev
    placed = mapped & strand_ok & (np.abs(rec.pos[ri] - 1 - truth) <=
                                   PLACED_BP)
    n_reads = at.size
    out = {"reads": n_reads, "missing": missing, "record_mismatch": mismatch,
           "below_local_pct": 100.0 * below / max(1, len(mk)),
           "missed_unique_pct": 100.0 * int((missed & unique).sum()) /
           max(1, int(unique.sum())),
           "missed_repeat_pct": 100.0 * int((missed & ~unique).sum()) /
           max(1, n_repeat),
           "repeat_reads": n_repeat,
           "placed_pct": 100.0 * int(placed.sum()) / n_reads}
    if pe:
        out["pair_fields"] = pair_fields(rec, at)
    return out


def _aligned(cig) -> int:
    """Read bases a CIGAR aligns (M, =, X, I): the read less its
    clips."""
    return sum(n for n, op in cig if op in "M=XI")


def pair_fields(rec: Records, at: np.ndarray) -> int:
    """Mates whose pair fields disagree with the other mate's record."""
    bad = 0
    for a, b in at:
        if a < 0 or b < 0:
            continue
        fa, fb = int(rec.flag[a]), int(rec.flag[b])
        ok = (fa & 0xC1) == 0x41 and (fb & 0xC1) == 0x81 and \
            (fa & 2) == (fb & 2) and rec.tlen[a] == -rec.tlen[b]
        for x, y, fx, fy in ((a, b, fa, fb), (b, a, fb, fa)):
            if fy & 4:
                ok &= bool(fx & 8) and rec.pnext[x] == 0 and \
                    rec.tlen[x] == 0 and not (fx & 2)
            else:
                ok &= not (fx & 8) and rec.rnext[x] in (rec.rname[y], "=") \
                    and rec.pnext[x] == rec.pos[y] and \
                    bool(fx & 0x20) == bool(fy & 0x10)
        bad += 0 if ok else 2
    return bad


def control_texts(texts, genome: np.ndarray, scores: dict):
    """The control: the program's records, each mapped read re-rendered
    by this module with the local-alignment guarantee broken: the whole
    read scored on its alignment's diagonal, no gap and no clip (a later
    change that swapped the Smith-Waterman kernel and traceback for an
    ungapped diagonal score would print this)."""
    out = []
    for t in texts:
        lines = []
        for ln in t.splitlines():
            f = ln.split("\t")
            if int(f[1]) & 4:
                lines.append(ln)
                continue
            seq = _CODE[np.frombuffer(f[9].encode(), np.uint8)]
            cig = parse_cigar(f[5])
            lead = cig[0][0] if cig and cig[0][1] == "S" else 0
            d = int(f[3]) - 1 - lead
            if d < 0 or d + len(seq) > len(genome):
                lines.append(ln)
                continue
            same = int((genome[d:d + len(seq)] == seq).sum())
            sc = same * scores["match"] + (len(seq) - same) * scores["subst"]
            f[3], f[5] = str(d + 1), f"{len(seq)}M"
            tags = [x for x in f[11:] if not x.startswith(("AS:", "NM:"))]
            f[11:] = tags + [f"NM:i:{len(seq) - same}", f"AS:i:{sc}"]
            lines.append("\t".join(f))
        out.append("\n".join(lines) + "\n")
    return out
