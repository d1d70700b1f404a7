"""Native BAM output: BGZF container + BAM record encoding (SAM spec
v1.6, section 4), plus a BGZF/BAM reader for `-F bam` input.

The reference gates BAM entirely on the optional bambamc library
(configure.ac:103-128, report.c:917 writeREPALIbam); here both
directions are implemented natively on zlib — no external codec.

Field semantics mirror the SAM writer (report.py _write_sam,
fprintREPALIsam report.c:762-906); tests/test_bam.py round-trips a
mapping run through BAM and asserts record-for-record equality with
the SAM text output.
"""
from __future__ import annotations

import re
import struct
import zlib
from typing import List, Optional

from ..seq import codec
from ..seq.io import Read
from .report import REPMATEFLG, REPPAIR, SAMFLAG, RepAli, Report
from ..align import diffstr as ds

_CIGAR_OPS = "MIDNSHP=X"
_SEQ_NIBBLE = {"=": 0, "A": 1, "C": 2, "M": 3, "G": 4, "R": 5, "S": 6,
               "V": 7, "T": 8, "W": 9, "Y": 10, "H": 11, "K": 12,
               "D": 13, "B": 14, "N": 15}
_NIBBLE_SEQ = "=ACMGRSVTWYHKDBN"
_CIG_RE = re.compile(r"(\d+)([MIDNSHP=X])")

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


class BgzfWriter:
    """BGZF: gzip members of <=64 KiB with a BC extra field carrying
    the compressed block size (SAM spec 4.1)."""

    MAX_BLOCK = 0xFF00

    def __init__(self, fp):
        self.fp = fp
        self.buf = bytearray()

    def write(self, data: bytes):
        self.buf += data
        while len(self.buf) >= self.MAX_BLOCK:
            self._flush_block(self.buf[: self.MAX_BLOCK])
            del self.buf[: self.MAX_BLOCK]

    def _flush_block(self, chunk: bytes):
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        cdata = co.compress(bytes(chunk)) + co.flush()
        crc = zlib.crc32(bytes(chunk)) & 0xFFFFFFFF
        # BSIZE field = total block size MINUS ONE (SAM spec 4.1); total =
        # header(12) + extra(6) + cdata + footer(8).
        bsize = len(cdata) + 25
        header = struct.pack("<BBBBIBBHBBHH",
                             31, 139, 8, 4,      # magic, CM, FLG=FEXTRA
                             0, 0, 255,          # MTIME, XFL, OS
                             6,                  # XLEN
                             66, 67, 2,          # 'B','C', SLEN
                             bsize)
        self.fp.write(header + cdata +
                      struct.pack("<II", crc, len(chunk) & 0xFFFFFFFF))

    def close(self):
        if self.buf:
            self._flush_block(bytes(self.buf))
            self.buf.clear()
        self.fp.write(BGZF_EOF)
        self.fp.flush()


def _reg2bin(beg: int, end: int) -> int:
    """SAM spec 4.2.1."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


class BamRecordEncoder:
    """Encodes reports into raw (uncompressed) BAM record bytes — the
    per-worker half of BAM output; the parent BGZF-compresses.  Same
    walk as ReportWriter (report.c reportWrite)."""

    def __init__(self, refset, soft_clip: bool = True,
                 x_mismatch: bool = False):
        self.refset = refset
        self.soft_clip = soft_clip
        self.x_mismatch = x_mismatch
        self._sink = bytearray()

    def take(self) -> bytes:
        out = bytes(self._sink)
        self._sink.clear()
        return out

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
        """Mirrors report.py _write_sam field-for-field."""
        if rp is not None and (rp.status & REPMATEFLG.MAPPED) and \
           mp is not None and rp.s_idx == mp.s_idx:
            pairflg |= REPPAIR.CONTIG
        qlen = len(read.seq)
        samflg = 0
        ref_id = rp.s_idx if (rp.status & REPMATEFLG.MAPPED) else -1
        mref_id = -1
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
                mref_id = mp.s_idx
                if mp.status & REPMATEFLG.REVERSE:
                    samflg |= SAMFLAG.MATESTRAND
            else:
                samflg |= SAMFLAG.MATENOMAP
                isize = 0
                mpos = 0
                mref_id = -1

        editdist = 0
        swatscor = 0
        cigar_ops: List[tuple] = []
        if rp.status & REPMATEFLG.MAPPED:
            is_rev = bool(rp.status & REPMATEFLG.REVERSE)
            if self.soft_clip:
                qseg = read.seq
                qual = read.qual
            else:
                qseg = read.seq[rp.q_start - 1 : rp.q_end]
                qual = read.qual[rp.q_start - 1 : rp.q_end] if read.qual \
                    else None
            if is_rev:
                qseg = codec.revcomp_codes(qseg)
                qual = qual[::-1] if qual else None
                samflg |= SAMFLAG.STRAND
                clip_start = qlen - rp.q_end
                clip_end = rp.q_start - 1
            else:
                clip_start = rp.q_start - 1
                clip_end = qlen - rp.q_end
            pos = rp.s_start
            if (pairflg & REPPAIR.PROPER) and (pairflg & REPPAIR.WITHIN):
                samflg |= SAMFLAG.PROPER
            if rp.status & REPMATEFLG.PARTIAL:
                samflg |= SAMFLAG.NOTPRIMARY
            swatscor = rp.swatscor
            cig = ds.diffstr_to_cigar(rp.diff, extended=True,
                                      silent_mismatch=not self.x_mismatch,
                                      clip_start=clip_start,
                                      clip_end=clip_end,
                                      soft_clip=self.soft_clip)
            cigar_ops = [(int(n), c) for n, c in _CIG_RE.findall(cig)]
            editdist = ds.levenshtein(rp.diff)
            seqstr = codec.decode(qseg).decode("ascii")
            qualstr = qual.decode("ascii") if qual else ""
        else:
            samflg |= SAMFLAG.NOMAP
            isize = 0
            if self.soft_clip:
                seqstr = codec.decode(read.seq).decode("ascii")
                qualstr = read.qual.decode("ascii") if read.qual else ""
            else:
                seqstr = ""
                qualstr = ""

        name = read.sam_name.encode() + b"\x00"
        l_seq = len(seqstr)
        seq4 = bytearray((l_seq + 1) // 2)
        for i, ch in enumerate(seqstr):
            nib = _SEQ_NIBBLE.get(ch, 15)
            if i % 2 == 0:
                seq4[i // 2] = nib << 4
            else:
                seq4[i // 2] |= nib
        if qualstr:
            qarr = bytes(max(0, min(93, ord(c) - 33)) for c in qualstr)
        else:
            qarr = b"\xff" * l_seq

        pos0 = pos - 1 if pos > 0 else -1
        reflen = sum(n for n, c in cigar_ops if c in "MDN=X")
        bam_bin = _reg2bin(max(pos0, 0), max(pos0, 0) + max(reflen, 1))
        rec = struct.pack("<iiBBHHHiiii",
                          ref_id, pos0,
                          len(name), rp.mapscor & 0xFF, bam_bin,
                          len(cigar_ops), samflg,
                          l_seq, mref_id, mpos - 1 if mpos > 0 else -1,
                          isize)
        rec += name
        for n, c in cigar_ops:
            rec += struct.pack("<I", (n << 4) | _CIGAR_OPS.index(c))
        rec += bytes(seq4) + qarr
        rec += b"NMi" + struct.pack("<i", editdist)
        rec += b"ASi" + struct.pack("<i", swatscor)
        self._sink += struct.pack("<i", len(rec)) + rec


class SamTextEncoder:
    """Re-encodes SAM text lines (the C exact lane's output) into raw
    BAM records, byte-identical to BamRecordEncoder on the same
    mapping: -f bam keeps the native mapping speed and only pays a
    cheap per-line re-encode (the reference's writeREPALIbam is the
    same record assembly, report.c:917)."""

    def __init__(self, refset):
        names = [refset.sam_name(i) for i in range(refset.nseq)]
        self._ref_id = {n: i for i, n in enumerate(names)}
        self._dup = len(self._ref_id) != len(names)

    @classmethod
    def make(cls, refset) -> Optional["SamTextEncoder"]:
        """None when whitespace-truncated reference names collide —
        RNAME would be ambiguous, the Report-object path must run."""
        enc = cls(refset)
        return None if enc._dup else enc

    def encode_text(self, text: str,
                    star_qual_literal: bool = False) -> bytes:
        """star_qual_literal resolves the one ambiguous SAM token: a
        1-base record whose QUAL column is "*" can mean either a
        missing quality or a literal Q9 ('*') character.  True (the
        strict-FASTQ raw path, where every record carries a quality
        string) decodes it as the literal; False treats it as missing,
        matching BamRecordEncoder for quality-less reads."""
        sink = bytearray()
        ref_id_of = self._ref_id
        for line in text.splitlines():
            if not line or line.startswith("@"):
                continue
            f = line.split("\t")
            qname, flag, rname, pos, mapq = \
                f[0], int(f[1]), f[2], int(f[3]), int(f[4])
            cigar, rnext, pnext, tlen = f[5], f[6], int(f[7]), int(f[8])
            seqstr = "" if f[9] == "*" else f[9]
            if f[10] == "*" and not (star_qual_literal and
                                     len(seqstr) == 1):
                qualstr = ""
            else:
                qualstr = f[10]
            editdist = swatscor = 0
            for tag in f[11:]:
                if tag.startswith("NM:i:"):
                    editdist = int(tag[5:])
                elif tag.startswith("AS:i:"):
                    swatscor = int(tag[5:])
            ref_id = ref_id_of[rname] if rname != "*" else -1
            if rnext == "=":
                mref_id = ref_id
            elif rnext == "*":
                mref_id = -1
            else:
                mref_id = ref_id_of[rnext]
            cigar_ops = ([] if cigar == "*" else
                         [(int(n), c) for n, c in _CIG_RE.findall(cigar)])
            name = qname.encode() + b"\x00"
            l_seq = len(seqstr)
            seq4 = bytearray((l_seq + 1) // 2)
            for i, ch in enumerate(seqstr):
                nib = _SEQ_NIBBLE.get(ch, 15)
                if i % 2 == 0:
                    seq4[i // 2] = nib << 4
                else:
                    seq4[i // 2] |= nib
            if qualstr:
                qarr = bytes(max(0, min(93, ord(c) - 33))
                             for c in qualstr)
            else:
                qarr = b"\xff" * l_seq
            pos0 = pos - 1 if pos > 0 else -1
            reflen = sum(n for n, c in cigar_ops if c in "MDN=X")
            bam_bin = _reg2bin(max(pos0, 0), max(pos0, 0) + max(reflen, 1))
            rec = struct.pack("<iiBBHHHiiii",
                              ref_id, pos0,
                              len(name), mapq & 0xFF, bam_bin,
                              len(cigar_ops), flag,
                              l_seq, mref_id,
                              pnext - 1 if pnext > 0 else -1,
                              tlen)
            rec += name
            for n, c in cigar_ops:
                rec += struct.pack("<I", (n << 4) | _CIGAR_OPS.index(c))
            rec += bytes(seq4) + qarr
            rec += b"NMi" + struct.pack("<i", editdist)
            rec += b"ASi" + struct.pack("<i", swatscor)
            sink += struct.pack("<i", len(rec)) + rec
        return bytes(sink)


class BamWriter:
    """Full BAM writer: header + BGZF container around the encoder.
    Accepts a BINARY file object."""

    def __init__(self, fp, refset, soft_clip: bool = True,
                 x_mismatch: bool = False, prog_args: Optional[list] = None,
                 version: str = ""):
        self.bgzf = BgzfWriter(fp)
        self.refset = refset
        self.enc = BamRecordEncoder(refset, soft_clip, x_mismatch)
        text = "@HD\tVN:1.3\tSO:unknown\n"
        for s in range(refset.nseq):
            text += (f"@SQ\tSN:{refset.sam_name(s)}"
                     f"\tLN:{refset.seq_len(s)}\n")
        text += (f"@PG\tID:smalt\tPN:smalt\tVN:{version}\tCL:"
                 + " ".join(prog_args or []) + "\n")
        tb = text.encode()
        out = b"BAM\x01" + struct.pack("<i", len(tb)) + tb
        out += struct.pack("<i", refset.nseq)
        for s in range(refset.nseq):
            nm = refset.sam_name(s).encode() + b"\x00"
            out += struct.pack("<i", len(nm)) + nm
            out += struct.pack("<i", refset.seq_len(s))
        self.bgzf.write(out)

    def write(self, report, read, mate):
        self.enc.write(report, read, mate)
        self.bgzf.write(self.enc.take())

    def write_raw(self, data: bytes):
        self.bgzf.write(data)

    def close(self):
        self.bgzf.close()


# ------------------------------------------------------------------
# reader
# ------------------------------------------------------------------

class BamRecord:
    __slots__ = ("name", "flag", "ref_id", "pos", "mapq", "cigar",
                 "seq", "qual", "tags")


def read_bam(path):
    """Iterate BamRecord from a BGZF BAM file (gzip handles the
    concatenated members).  Returns (header_text, ref_names, records
    iterator materialized as list)."""
    import gzip
    with gzip.open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"BAM\x01":
        raise ValueError("not a BAM file")
    off = 4
    (l_text,) = struct.unpack_from("<i", data, off); off += 4
    text = data[off : off + l_text].decode(); off += l_text
    (n_ref,) = struct.unpack_from("<i", data, off); off += 4
    names = []
    for _ in range(n_ref):
        (ln,) = struct.unpack_from("<i", data, off); off += 4
        names.append(data[off : off + ln - 1].decode()); off += ln
        off += 4  # l_ref
    recs = []
    while off < len(data):
        (bs,) = struct.unpack_from("<i", data, off); off += 4
        end = off + bs
        (ref_id, pos0, l_name, mapq, _bin, n_cig, flag, l_seq,
         mref, mpos, tlen) = struct.unpack_from("<iiBBHHHiiii", data, off)
        p = off + 32
        r = BamRecord()
        r.name = data[p : p + l_name - 1].decode(); p += l_name
        r.flag = flag
        r.ref_id = ref_id
        r.pos = pos0 + 1
        r.mapq = mapq
        r.cigar = []
        for _ in range(n_cig):
            (v,) = struct.unpack_from("<I", data, p); p += 4
            r.cigar.append((v >> 4, _CIGAR_OPS[v & 15]))
        nseq = (l_seq + 1) // 2
        sq = []
        for i in range(l_seq):
            b = data[p + i // 2]
            sq.append(_NIBBLE_SEQ[(b >> 4) if i % 2 == 0 else (b & 15)])
        r.seq = "".join(sq)
        p += nseq
        q = data[p : p + l_seq]; p += l_seq
        r.qual = ("" if (l_seq and q[0] == 0xFF)
                  else "".join(chr(c + 33) for c in q))
        r.tags = {}
        while p < end:
            tag = data[p : p + 2].decode(); typ = chr(data[p + 2]); p += 3
            if typ == "i":
                (v,) = struct.unpack_from("<i", data, p); p += 4
            elif typ in "cC":
                v = data[p]; p += 1
            elif typ in "sS":
                (v,) = struct.unpack_from("<h", data, p); p += 2
            elif typ == "Z":
                e = data.index(0, p)
                v = data[p:e].decode(); p = e + 1
            elif typ == "A":
                v = chr(data[p]); p += 1
            elif typ == "f":
                (v,) = struct.unpack_from("<f", data, p); p += 4
            else:
                break
            r.tags[tag] = v
        recs.append(r)
        off = end
    return text, names, recs
