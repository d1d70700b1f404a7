"""Per-read report collection and output writers.

Replicates report.c: the Report gathers REPALI records for read (A)
and mate (B) with duplicate folding (findREPALI, report.c:554-586),
REPPAIR records linking mates, multi-primary fixup (report.c:1719),
and the writers: SAM lines (fprintREPALIsam, report.c:762-906), SAM
header (report.c:1266), CIGAR lines (report.c:591-646).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, TextIO

import numpy as np

from ..seq import codec
from ..seq.io import Read
from ..align import diffstr as ds


class REPMATEFLG:
    MAPPED = 0x01
    REVERSE = 0x02
    PAIRED = 0x04
    MATE2 = 0x08
    PRIMARY = 0x10
    PARTIAL = 0x20
    MULTI = 0x40


class REPPAIR:
    MAPPED = 0x01
    CONTIG = 0x02
    PROPER = 0x04
    WITHIN = 0x08


class SAMFLAG:
    PAIRED = 0x0001
    PROPER = 0x0002
    NOMAP = 0x0004
    MATENOMAP = 0x0008
    STRAND = 0x0010
    MATESTRAND = 0x0020
    MATE1 = 0x0040
    MATE2 = 0x0080
    NOTPRIMARY = 0x0100


@dataclass
class RepAli:
    status: int = 0
    swatscor: int = 0
    mapscor: int = 0
    q_start: int = 0
    q_end: int = 0
    s_start: int = 0
    s_end: int = 0
    s_idx: int = 0
    diff: List[int] = field(default_factory=list)
    was_output: bool = False


@dataclass
class RepPair:
    pairflg: int = 0
    isize: int = 0
    iA: int = -1
    iB: int = -1


class Report:
    def __init__(self):
        self.arA: List[RepAli] = []
        self.arB: List[RepAli] = []
        self.pairs: List[RepPair] = []

    def blank(self):
        self.__init__()

    def next_pair_id(self) -> int:
        """reportNextPairID (report.c:1581-1594)."""
        self.pairs.append(RepPair())
        return len(self.pairs) - 1

    def _find(self, arr: List[RepAli], q_start, q_end, mateflg,
              s_start, s_end, s_idx) -> int:
        mask = REPMATEFLG.REVERSE | REPMATEFLG.MATE2
        for i in range(len(arr) - 1, -1, -1):
            r = arr[i]
            if (s_start == r.s_start and s_end == r.s_end and
                    s_idx == r.s_idx and q_start == r.q_start and
                    q_end == r.q_end and
                    (mateflg & mask) == (r.status & mask)):
                return i
        return -1

    def add_map(self, pairid: int, swatscor: int, mapscor: int,
                q_start: int, q_end: int, s_start: int, s_end: int,
                s_idx: int, diff: Optional[List[int]], insiz: int,
                mateflg: int, pairflg: int):
        """reportAddMap (report.c:1596-1717)."""
        if diff is None or len(diff) < 1:
            mateflg &= ~REPMATEFLG.MAPPED

        pp = None
        if (mateflg & REPMATEFLG.PAIRED) and pairid >= 0:
            pp = self.pairs[pairid]
            if pp.pairflg == 0:
                pp.pairflg = pairflg
            elif pp.pairflg != pairflg:
                raise AssertionError("inconsistent pair flags")

        rp = None
        if pp is not None and (mateflg & REPMATEFLG.MATE2):
            if pp.iA >= 0:
                if insiz != pp.isize:
                    raise AssertionError("inconsistent insert size")
                idx = self._find(self.arB, q_start, q_end, mateflg,
                                 s_start, s_end, s_idx)
                if idx < 0:
                    pp.iB = len(self.arB)
                    rp = RepAli()
                    self.arB.append(rp)
                else:
                    pp.iB = idx
                    rp = self.arB[idx]
            else:
                pp.isize = insiz
        else:
            arr = self.arA
            if pp is None:
                if mateflg & REPMATEFLG.MATE2:
                    arr = self.arB
            else:
                if pp.iB >= 0:
                    if insiz != pp.isize:
                        raise AssertionError("inconsistent insert size")
                else:
                    pp.isize = insiz
            idx = self._find(arr, q_start, q_end, mateflg,
                             s_start, s_end, s_idx)
            if idx < 0:
                if pp is not None:
                    pp.iA = len(self.arA)
                rp = RepAli()
                arr.append(rp)
            else:
                if pp is None:
                    rp = None  # known single mapping -> ignore
                else:
                    pp.iA = idx
                    rp = arr[idx]

        if rp is not None:
            rp.status = mateflg
            if mateflg & REPMATEFLG.MAPPED:
                rp.swatscor = swatscor
                rp.mapscor = mapscor
                rp.q_start = q_start
                rp.q_end = q_end
                rp.s_start = s_start
                rp.s_end = s_end
                rp.s_idx = s_idx
                rp.diff = list(diff)
            else:
                rp.swatscor = rp.mapscor = 0
                rp.q_start = rp.q_end = rp.s_start = rp.s_end = rp.s_idx = 0
                rp.diff = []

    def fix_multiple_primary(self):
        """reportFixMultiplePrimary (report.c:1719-1757)."""
        npA = npB = 0
        for pp in self.pairs:
            if npA >= 2 and npB >= 2:
                break
            if self.arA[pp.iA].status & REPMATEFLG.PRIMARY:
                npA += 1
            # reference quirk: tests arAr[pp->iB] (report.c:1731)
            if self.arA[pp.iB].status & REPMATEFLG.PRIMARY:
                npB += 1
        if npA < 2:
            if npA > 0:
                npA = 0
            for r in self.arA:
                if npA >= 2:
                    break
                if r.status & REPMATEFLG.PRIMARY:
                    npA += 1
        if npB < 2:
            if npB > 0:
                npB = 0
            for r in self.arB:
                if npB >= 2:
                    break
                if r.status & REPMATEFLG.PRIMARY:
                    npB += 1
        if npA > 1:
            for r in self.arA:
                r.status &= ~REPMATEFLG.PRIMARY
        if npB > 1:
            for r in self.arB:
                r.status &= ~REPMATEFLG.PRIMARY


# ---------------------------------------------------------------------------


class ReportWriter:
    """SAM/CIGAR stream writer (ReportWriter, report.c:1350-1500)."""

    def __init__(self, fp: TextIO, refset, fmt: str = "sam",
                 soft_clip: bool = True, x_mismatch: bool = False,
                 header: bool = True, prog_args: Optional[List[str]] = None,
                 version: str = "0.7.6", ali_out: bool = False):
        self.fp = fp
        self.refset = refset
        self.fmt = fmt
        self.soft_clip = soft_clip
        self.x_mismatch = x_mismatch
        self.ali_out = ali_out  # -a: explicit alignment display
        if fmt == "sam" and header:
            self._write_sam_header(prog_args or [], version)

    def _write_sam_header(self, args: List[str], version: str):
        fp = self.fp
        fp.write("@HD\tVN:1.3\tSO:unknown\n")
        for s in range(self.refset.nseq):
            fp.write(f"@SQ\tSN:{self.refset.sam_name(s)}\tLN:{self.refset.seq_len(s)}\n")
        fp.write(f"@PG\tID:smalt\tPN:smalt\tVN:{version}\tCL:")
        fp.write(" ".join(args))
        fp.write("\n")

    # --- per-read output (reportWrite, report.c:1758-1864) ---

    def write(self, report: Report, read: Read, mate: Optional[Read]):
        for r in report.arA:
            r.was_output = False
        for r in report.arB:
            r.was_output = False
        for pp in report.pairs:
            ap = report.arA[pp.iA]
            bp = report.arB[pp.iB]
            ap.was_output = True
            bp.was_output = True
            self._write_one(ap, read, bp, pp.isize, pp.pairflg)
            self._write_one(bp, mate, ap, pp.isize, pp.pairflg)
        pairflg = report.pairs[0].pairflg if report.pairs else 0
        for ap in report.arA:
            if not ap.was_output:
                self._write_one(ap, read, None, 0, pairflg)
        for bp in report.arB:
            if not bp.was_output:
                self._write_one(bp, mate, None, 0, pairflg)

    def _write_one(self, rp: RepAli, read: Read, mp: Optional[RepAli],
                   isize: int, pairflg: int):
        if rp is not None and (rp.status & REPMATEFLG.MAPPED) and \
           mp is not None and rp.s_idx == mp.s_idx:
            pairflg |= REPPAIR.CONTIG
        if self.fmt == "sam":
            self._write_sam(rp, read, mp, isize, pairflg)
        elif self.fmt == "cigar":
            self._write_cigar(rp, read, pairflg)
        elif self.fmt == "ssaha":
            self._write_ssaha(rp, read, pairflg)
        elif self.fmt == "gff":
            self._write_gff2(rp, read, pairflg)
        elif self.fmt == "bam":
            raise ValueError(
                "BAM output requires an external BAM codec (the reference "
                "gates this on the optional bambamc library, "
                "configure.ac:103-128); write SAM and convert")
        else:
            raise ValueError(f"unsupported output format {self.fmt}")
        if self.ali_out and rp is not None and \
           (rp.status & REPMATEFLG.MAPPED):
            print_alignment(self.fp, self.refset, rp, read)

    def _write_sam(self, rp: RepAli, read: Read, mp: Optional[RepAli],
                   isize: int, pairflg: int):
        """fprintREPALIsam (report.c:762-906)."""
        qlen = len(read.seq)
        samflg = 0
        s_nam = self.refset.sam_name(rp.s_idx) if (rp.status & REPMATEFLG.MAPPED) else "*"
        ms_nam = "*"
        pos = 0
        mpos = 0
        if rp.status & REPMATEFLG.PAIRED:
            samflg |= SAMFLAG.PAIRED
            if rp.status & REPMATEFLG.MATE2:
                samflg |= SAMFLAG.MATE2
                isize = -isize
            else:
                samflg |= SAMFLAG.MATE1
            if mp is not None and (mp.status & REPMATEFLG.MAPPED):
                mpos = mp.s_start
                ms_nam = self.refset.sam_name(mp.s_idx)
                if mp.status & REPMATEFLG.REVERSE:
                    samflg |= SAMFLAG.MATESTRAND
            else:
                samflg |= SAMFLAG.MATENOMAP
                isize = 0
                mpos = 0
                ms_nam = "*"

        editdist = 0
        swatscor = 0
        clip_start = clip_end = 0
        cigar = "*"
        if rp.status & REPMATEFLG.MAPPED:
            is_rev = bool(rp.status & REPMATEFLG.REVERSE)
            if self.soft_clip:
                qseg = read.seq
                qual = read.qual
            else:
                qseg = read.seq[rp.q_start - 1 : rp.q_end]
                qual = read.qual[rp.q_start - 1 : rp.q_end] if read.qual else None
            if is_rev:
                qseg = codec.revcomp_codes(qseg)
                qual = qual[::-1] if qual else None
                samflg |= SAMFLAG.STRAND
                clip_start = qlen - rp.q_end
                clip_end = rp.q_start - 1
            else:
                clip_start = rp.q_start - 1
                clip_end = qlen - rp.q_end
            seqstr = codec.decode(qseg).decode("ascii")
            qualstr = qual.decode("ascii") if qual else "*"
            pos = rp.s_start
            if (pairflg & REPPAIR.PROPER) and (pairflg & REPPAIR.WITHIN):
                samflg |= SAMFLAG.PROPER
            if rp.status & REPMATEFLG.PARTIAL:
                samflg |= SAMFLAG.NOTPRIMARY
            swatscor = rp.swatscor
            cigar = ds.diffstr_to_cigar(rp.diff, extended=True,
                                        silent_mismatch=not self.x_mismatch,
                                        clip_start=clip_start, clip_end=clip_end,
                                        soft_clip=self.soft_clip)
            editdist = ds.levenshtein(rp.diff)
        else:
            samflg |= SAMFLAG.NOMAP
            s_nam = "*"
            isize = 0
            if self.soft_clip:
                seqstr = codec.decode(read.seq).decode("ascii")
                qualstr = read.qual.decode("ascii") if read.qual else "*"
            else:
                seqstr = "*"
                qualstr = "*"
        if not qualstr:
            qualstr = "*"
        self.fp.write(f"{read.sam_name}\t{samflg}\t{s_nam}\t{pos}\t{rp.mapscor}\t"
                      f"{cigar}\t{ms_nam}\t{mpos}\t{isize}\t{seqstr}\t{qualstr}\t"
                      f"NM:i:{editdist}\tAS:i:{swatscor}\n")

    @staticmethod
    def _map_label(mateflg: int, pairflg: int) -> str:
        """getMapLabelFromFlag (report.c:215-246)."""
        if mateflg & REPMATEFLG.MAPPED:
            if mateflg & REPMATEFLG.PARTIAL:
                return "P"
            if pairflg & REPPAIR.MAPPED:
                if pairflg & REPPAIR.CONTIG:
                    if pairflg & REPPAIR.PROPER:
                        return "A" if (pairflg & REPPAIR.WITHIN) else "B"
                    return "C"
                return "D"
            return "S"
        if mateflg & REPMATEFLG.MULTI:
            return "R"
        return "N"

    @staticmethod
    def _qname(read: Read) -> str:
        """copyReadNamStrToREPSTR with is_stripped=0: name cut at
        whitespace, /1 /2 kept (cigar/ssaha/gff writers)."""
        return read.name.split()[0] if read.name else "*"

    def _write_cigar(self, rp: RepAli, read: Read, pairflg: int):
        """fprintREPALIcigar (report.c:712-760)."""
        mapscor = rp.mapscor if rp is not None else 0
        if rp is not None and (rp.status & REPMATEFLG.MAPPED):
            if rp.status & REPMATEFLG.REVERSE:
                qs, qe = rp.q_end, rp.q_start
                dirc = "-"
            else:
                qs, qe = rp.q_start, rp.q_end
                dirc = "+"
            rs, re_ = rp.s_start, rp.s_end
            swatscor = rp.swatscor
            s_nam = self.refset.sam_name(rp.s_idx)
            flagchr = self._map_label(rp.status, pairflg)
            cig = ds.diffstr_to_cigar(rp.diff, extended=False,
                                      silent_mismatch=True)
        else:
            qs = qe = rs = re_ = 0
            dirc = "*"
            s_nam = "*"
            swatscor = 0
            mapscor = 0
            flagchr = "R" if (rp is not None and
                              rp.status & REPMATEFLG.MULTI) else "N"
            cig = "*"
        mapscor = min(mapscor, 99)
        self.fp.write(
            f"cigar:{flagchr}:{mapscor:02d} {self._qname(read)} {qs} {qe} {dirc} "
            f"{s_nam} {rs} {re_} + {swatscor} {cig}\n")

    def _write_ssaha(self, rp: RepAli, read: Read, pairflg: int):
        """fprintREPALIssaha (report.c:579-648); line format report.c:204."""
        qlen = len(read.seq)
        mapscor = rp.mapscor if rp is not None else 0
        if rp is not None and (rp.status & REPMATEFLG.MAPPED):
            if rp.status & REPMATEFLG.REVERSE:
                qs, qe = rp.q_end, rp.q_start
                sensechr = "C"
            else:
                qs, qe = rp.q_start, rp.q_end
                sensechr = "F"
            rs, re_ = rp.s_start, rp.s_end
            swatscor = rp.swatscor
            s_nam = self.refset.sam_name(rp.s_idx)
            s_len = self.refset.seq_len(rp.s_idx)
            flagchr = self._map_label(rp.status, pairflg)
            alilen, matchlen = ds.ali_len(rp.diff)
            idfrac = 100.0 * matchlen / alilen if alilen > 0 else 0.0
        else:
            qs = qe = rs = re_ = 0
            sensechr = "*"
            s_nam = "*"
            s_len = 0
            swatscor = 0
            mapscor = 0
            matchlen = 0
            idfrac = 0.0
            flagchr = "R" if (rp is not None and
                              rp.status & REPMATEFLG.MULTI) else "N"
        mapscor = min(mapscor, 99)
        # OUFMT_SSAHA (report.c:204):
        # "alignment:%c:%2.2d %-5d %s%s %s %8u %8u %9u %9u   %c %7d %5.2f %u %u\n"
        self.fp.write(
            f"alignment:{flagchr}:{mapscor:02d} {swatscor:<5d} "
            f"{self._qname(read)} {s_nam} {qs:8d} {qe:8d} {rs:9d} {re_:9d}   "
            f"{sensechr} {matchlen:7d} {idfrac:5.2f} {qlen} {s_len}\n")

    def _write_gff2(self, rp: RepAli, read: Read, pairflg: int):
        """fprintREPALIgff2 (report.c:648-711) with diffStrFindBlocks
        (diffstr.c:664) block decomposition."""
        is_rev = bool(rp is not None and (rp.status & REPMATEFLG.REVERSE))
        if rp is not None and (rp.status & REPMATEFLG.MAPPED):
            if is_rev:
                qs, qe = rp.q_end, rp.q_start
                sensechr = "-"
            else:
                qs, qe = rp.q_start, rp.q_end
                sensechr = "+"
            rs, re_ = rp.s_start, rp.s_end
            swatscor = rp.swatscor
            s_nam = self.refset.sam_name(rp.s_idx)
            blocks = self._diff_blocks(rp.diff)
        else:
            qs = qe = rs = re_ = 0
            sensechr = "*"
            s_nam = "-"
            swatscor = 0
            blocks = []
        # OUFMT_GFF2 (report.c:205-208)
        self.fp.write(
            f"gff: {self._qname(read)}\tSMALT\tsimilarity\t{qs}\t{qe}\t"
            f"{swatscor}\t{sensechr}\t.\tSubject \"{s_nam}\" {rs} {re_};\t")
        n = 0
        for (u0, p0, length) in blocks:
            if length < 1:
                break
            q0 = p0
            if is_rev:
                q0 = rp.q_end - rp.q_start - p0
            self.fp.write(f" Align {q0 + 1} {u0 + 1} {length};")
            n += 1
        if n == 0:
            self.fp.write(" Align 0 0 0;")
        self.fp.write("\n")

    @staticmethod
    def _diff_blocks(diff):
        """diffStrFindBlocks (diffstr.c:664-707): maximal gap-free blocks
        as (unprof_start, prof_start, len)."""
        blocks = []
        u = p = l = 0
        typ = ds.DIFFCOD_M
        for b in diff:
            if not b:
                break
            count, typ = ds.diffstr_get(b)
            l += count
            if typ == ds.DIFFCOD_I:
                if l > 0:
                    blocks.append((u, p, l))
                    u += l
                    p += l
                    l = 0
                p += 1
            elif typ == ds.DIFFCOD_D:
                if l > 0:
                    blocks.append((u, p, l))
                    u += l
                    p += l
                    l = 0
                u += 1
            else:
                l += 1
        l -= 1
        if l > 0:
            blocks.append((u, p, l))
        return blocks


def print_alignment(fp, refset, rp: RepAli, read: Read, linwidth: int = 60):
    """fprintAlignment (report.c:248-420): explicit alignment display after
    a SAM line (-a).  Middle line marks transitions 'i', transversions 'v',
    non-standard '!' and gaps '-'."""
    if rp is None or not (rp.status & REPMATEFLG.MAPPED):
        return
    is_rev = bool(rp.status & REPMATEFLG.REVERSE)
    qseg = read.seq[rp.q_start - 1 : rp.q_end]
    if is_rev:
        qseg = codec.revcomp_codes(qseg)
    q_str = codec.decode(qseg).decode()
    sseg = refset.fetch_by_seq(rp.s_idx, rp.s_start - 1,
                               rp.s_end - rp.s_start + 1)
    s_str = codec.decode(sseg).decode()

    def base_class(ch):
        if ch in "AG":
            return 1  # purine
        if ch in "CT":
            return 2  # pyrimidine
        return 0

    cols = []  # (qchar, dchar, schar, dq, ds_)
    q = s = 0
    diff = rp.diff
    for i, b in enumerate(diff):
        if not b:
            break
        count, typ = ds.diffstr_get(b)
        for _ in range(count):
            cols.append((q_str[q], " ", s_str[s], 1, 1))
            q += 1
            s += 1
        if typ == ds.DIFFCOD_M:
            cols.append((q_str[q], " ", s_str[s], 1, 1))
            q += 1
            s += 1
        elif typ == ds.DIFFCOD_S:
            if i + 1 < len(diff) and diff[i + 1]:
                qc, sc = q_str[q], s_str[s]
                qb, sb = base_class(qc), base_class(sc)
                if qb == 0 or sb == 0:
                    d = "!"
                elif qb == sb:
                    d = "i"
                else:
                    d = "v"
                cols.append((qc, d, sc, 1, 1))
                q += 1
                s += 1
        elif typ == ds.DIFFCOD_D:
            cols.append(("-", "-", s_str[s], 0, 1))
            s += 1
        else:  # I
            cols.append((q_str[q], "-", "-", 1, 0))
            q += 1

    # the reference's line loop (report.c:319-385) consumes one extra
    # column slot for the diff-string terminator; when the real columns
    # exactly fill the 60-wide rows that slot lands on a fresh row and
    # prints an EMPTY block (q/s ranges of zero length)
    offs = list(range(0, len(cols), linwidth))
    if cols and len(cols) % linwidth == 0:
        offs.append(len(cols))
    q0 = s0 = 0
    for off in offs:
        chunk = cols[off : off + linwidth]
        qline = "".join(c[0] for c in chunk)
        dline = "".join(c[1] for c in chunk).rstrip() or ""
        sline = "".join(c[2] for c in chunk)
        dq = sum(c[3] for c in chunk)
        dsu = sum(c[4] for c in chunk)
        if is_rev:
            qa = rp.q_end - q0
            qb = rp.q_end - (q0 + dq) + 1
        else:
            qa = rp.q_start + q0
            qb = rp.q_start + q0 + dq - 1
        sa = rp.s_start + s0
        sb = rp.s_start + s0 + dsu - 1
        # OUFMT_ALIGN (report.c:209-211)
        fp.write(f"    QUERY: {qa:10d} {qline} {qb:<10d}\n")
        fp.write(f"                      "
                 f"{''.join(c[1] for c in chunk)}\n")
        fp.write(f"REFERENCE: {sa:10d} {sline} {sb:<10d}\n\n\n")
        q0 += dq
        s0 += dsu
