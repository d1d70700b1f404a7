"""FASTA/FASTQ input.

Equivalent of the reference SeqIO reader (sequence.c:1960 seqFastqRead):
gzip-aware, format auto-detected from the first prompt character
('>' FASTA, '@' FASTQ), multi-line sequences, quality strings read
until they match the sequence length.
"""
from __future__ import annotations

import gzip
import io
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np

from . import codec


def open_maybe_gzip(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return io.BufferedReader(gzip.GzipFile(fileobj=f))
    return f


@dataclass
class Read:
    name: str                 # full header line (w/o prompt char)
    seq: np.ndarray           # mangled uint8 codes
    qual: Optional[bytes]     # raw ASCII quality bytes (None for FASTA)

    @property
    def sam_name(self) -> str:
        """Name stripped at whitespace and of a trailing /1 or /2
        (report.c copyReadNamStrToREPSTR)."""
        n = self.name.split()[0] if self.name else ""
        if len(n) > 2 and n[-2] == "/" and n[-1] in "12":
            n = n[:-2]
        return n

    def __len__(self):
        return len(self.seq)


class FastqReader:
    """Iterates FASTA or FASTQ records from a (possibly gzipped) file."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open_maybe_gzip(path)
        self._peek: Optional[bytes] = None

    def close(self):
        self._fh.close()

    def _readline(self) -> bytes:
        if self._peek is not None:
            ln, self._peek = self._peek, None
            return ln
        return self._fh.readline()

    def _pushback(self, ln: bytes):
        self._peek = ln

    def __iter__(self) -> Iterator[Read]:
        while True:
            r = self.next_read()
            if r is None:
                return
            yield r

    def next_read(self) -> Optional[Read]:
        ln = self._readline()
        while ln and not ln.strip():
            ln = self._readline()
        if not ln:
            return None
        ln = ln.rstrip(b"\r\n")
        if ln.startswith(b">"):
            name = ln[1:].decode("ascii", "replace")
            parts = []
            while True:
                ln = self._readline()
                if not ln or ln.startswith(b">") or ln.startswith(b"@"):
                    if ln:
                        self._pushback(ln)
                    break
                parts.append(ln.strip())
            seq = b"".join(parts)
            return Read(name=name, seq=codec.encode(seq), qual=None)
        if ln.startswith(b"@"):
            name = ln[1:].decode("ascii", "replace")
            parts = []
            while True:
                ln = self._readline()
                if not ln:
                    break
                if ln.startswith(b"+"):
                    break
                parts.append(ln.rstrip(b"\r\n"))
            seq = b"".join(parts)
            quals = []
            qlen = 0
            while qlen < len(seq):
                ln = self._readline()
                if not ln:
                    break
                q = ln.rstrip(b"\r\n")
                quals.append(q)
                qlen += len(q)
            qual = b"".join(quals)
            return Read(name=name, seq=codec.encode(seq), qual=qual or None)
        raise ValueError(f"unrecognized record prompt in {self.path}: {ln[:20]!r}")


class PairedReader:
    """Two-file paired iterator (infmt.c:197 infmtRead, FASTQ 2-file mode)."""

    def __init__(self, path1: str, path2: str):
        self.r1 = FastqReader(path1)
        self.r2 = FastqReader(path2)

    def __iter__(self):
        while True:
            a = self.r1.next_read()
            b = self.r2.next_read()
            if a is None and b is None:
                return
            if (a is None) != (b is None):
                raise ValueError("paired files have different read counts")
            yield a, b


class SamReader:
    """SAM text input (infmt.c SAM/BAM path, sans the external bambamc
    dependency): yields reads in their original orientation (sequences
    stored reverse-complemented in the SAM are flipped back)."""

    FLAG_PAIRED = 0x1
    FLAG_REVERSE = 0x10
    FLAG_MATE1 = 0x40
    FLAG_MATE2 = 0x80
    FLAG_SECONDARY = 0x100

    def __init__(self, path: str):
        self._fh = open_maybe_gzip(path)

    def _records(self):
        from . import codec as _codec
        for line in self._fh:
            if line.startswith(b"@") or not line.strip():
                continue
            f = line.rstrip(b"\n").split(b"\t")
            flag = int(f[1])
            if flag & self.FLAG_SECONDARY:
                continue
            seq = f[9]
            qual = f[10] if f[10] != b"*" else None
            codes = _codec.encode(seq)
            if flag & self.FLAG_REVERSE:
                codes = _codec.revcomp_codes(codes)
                qual = qual[::-1] if qual else None
            yield flag, Read(name=f[0].decode("ascii", "replace"),
                             seq=codes, qual=qual)

    def __iter__(self) -> Iterator[Read]:
        for _, r in self._records():
            yield r

    def pairs(self):
        """Pair mate1/mate2 records with matching names (adjacent or
        name-grouped, like the reference's temp-dir staging)."""
        pending = {}
        for flag, r in self._records():
            key = r.sam_name
            other = pending.pop(key, None)
            if other is None:
                pending[key] = (flag, r)
                continue
            oflag, oread = other
            if flag & self.FLAG_MATE1:
                yield r, oread
            else:
                yield oread, r
        for flag, r in pending.values():
            yield (r, None)


class BamReader(SamReader):
    """BAM input via the native BGZF/BAM codec (report/bam.py) — the
    reference needs bambamc for this (infmt.c:42-127); here it is
    built in.  Loads the file into memory (read staging, like the
    reference's temp-dir approach)."""

    def __init__(self, path: str):  # noqa: super not useful here
        self._path = path
        self._cached = None

    def _records(self):
        # decode once and cache: read_bam materializes the whole file
        # anyway, and callers iterate twice (paired probe + mapping)
        if self._cached is None:
            from . import codec as _codec
            from ..report.bam import read_bam
            _, _, recs = read_bam(self._path)
            out = []
            for r in recs:
                if r.flag & self.FLAG_SECONDARY:
                    continue
                codes = _codec.encode(r.seq.encode())
                qual = r.qual.encode() if r.qual else None
                if r.flag & self.FLAG_REVERSE:
                    codes = _codec.revcomp_codes(codes)
                    qual = qual[::-1] if qual else None
                out.append((r.flag, Read(name=r.name, seq=codes, qual=qual)))
            self._cached = out
        return iter(self._cached)
