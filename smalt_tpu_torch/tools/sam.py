"""SAM parsing library for tests and tooling — equivalent of misc/SAM.py
(line/flag parser + pair iterator)."""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, TextIO, Tuple

FLAG_PAIRED = 0x0001
FLAG_PROPER = 0x0002
FLAG_UNMAPPED = 0x0004
FLAG_MATE_UNMAPPED = 0x0008
FLAG_REVERSE = 0x0010
FLAG_MATE_REVERSE = 0x0020
FLAG_MATE1 = 0x0040
FLAG_MATE2 = 0x0080
FLAG_NOT_PRIMARY = 0x0100

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


@dataclass
class SamLine:
    qname: str
    flag: int
    rname: str
    pos: int
    mapq: int
    cigar: str
    mrnm: str
    mpos: int
    isize: int
    seq: str
    qual: str
    tags: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def parse(cls, line: str) -> "SamLine":
        f = line.rstrip("\n").split("\t")
        tags = {}
        for t in f[11:]:
            k, typ, v = t.split(":", 2)
            tags[k] = v
        return cls(qname=f[0], flag=int(f[1]), rname=f[2], pos=int(f[3]),
                   mapq=int(f[4]), cigar=f[5], mrnm=f[6], mpos=int(f[7]),
                   isize=int(f[8]), seq=f[9], qual=f[10], tags=tags)

    @property
    def is_mapped(self) -> bool:
        return not (self.flag & FLAG_UNMAPPED)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FLAG_REVERSE)

    @property
    def mate_no(self) -> int:
        if self.flag & FLAG_MATE2:
            return 2
        if self.flag & FLAG_MATE1:
            return 1
        return 0

    def cigar_ops(self) -> List[Tuple[int, str]]:
        return [(int(n), op) for n, op in _CIGAR_RE.findall(self.cigar)]

    def aligned_ref_len(self) -> int:
        return sum(n for n, op in self.cigar_ops() if op in "MD=XN")


def read_sam(fp: TextIO) -> Iterator[SamLine]:
    for line in fp:
        if line.startswith("@") or not line.strip():
            continue
        yield SamLine.parse(line)


def read_pairs(fp: TextIO) -> Iterator[Tuple[SamLine, SamLine]]:
    """Pair up successive primary records by qname (the reference's pair
    iterator semantics)."""
    pending: Dict[str, SamLine] = {}
    for rec in read_sam(fp):
        if rec.flag & FLAG_NOT_PRIMARY:
            continue
        other = pending.pop(rec.qname, None)
        if other is None:
            pending[rec.qname] = rec
        else:
            if rec.mate_no == 1:
                yield rec, other
            else:
                yield other, rec
