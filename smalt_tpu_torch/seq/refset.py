"""Reference sequence set.

Equivalent of the reference SeqSet (sequence.c:2281-2460): all
reference sequences concatenated, with per-sequence offsets and
names.  Offsets are cumulative lengths with no separator characters
(smalt.c:59 uses SEQSET_COMPRESSED only, no SEQSET_TERMCHAR), so
offsets[i+1]-offsets[i] == len(seq_i) and global coordinates of
sequence i start at offsets[i].

Stored on disk as an .smt.npz artifact (our own format — the goal is
output parity, not .sma byte parity).  Device side, the packed 2-bit
code array + non-standard mask upload as flat uint32/uint8 arrays.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List

import numpy as np

from . import codec
from .io import FastqReader


@dataclass
class RefSet:
    codes: np.ndarray          # uint8 mangled codes, concatenated
    offsets: np.ndarray        # uint64 [nseq+1]
    names: List[str]           # full header strings

    @property
    def nseq(self) -> int:
        return len(self.names)

    @property
    def total_len(self) -> int:
        return int(self.offsets[-1])

    def seq_len(self, i: int) -> int:
        return int(self.offsets[i + 1] - self.offsets[i])

    def sam_name(self, i: int) -> str:
        """Name truncated at first whitespace (report.c:1276-1280)."""
        return self.names[i].split()[0]

    def fetch_global(self, start: int, end: int) -> np.ndarray:
        """Codes for global range [start, end] inclusive."""
        return self.codes[start : end + 1]

    def fetch_by_seq(self, sidx: int, start: int, length: int) -> np.ndarray:
        off = int(self.offsets[sidx])
        return self.codes[off + start : off + start + length]

    # ---------------- construction / io ----------------

    @classmethod
    def from_fasta(cls, path: str) -> "RefSet":
        names: List[str] = []
        chunks: List[np.ndarray] = []
        offsets = [0]
        for read in FastqReader(path):
            names.append(read.name)
            chunks.append(read.seq)
            offsets.append(offsets[-1] + len(read.seq))
        if not names:
            raise ValueError(f"no sequences in {path}")
        return cls(
            codes=np.concatenate(chunks),
            offsets=np.asarray(offsets, dtype=np.uint64),
            names=names,
        )

    def save(self, prefix: str) -> None:
        # uncompressed npz (ZIP store): deflate saved ~3x disk but cost
        # ~0.2 s decompress at every mapping run's startup — artifact
        # load time is part of the end-to-end number that competes with
        # the reference's raw binary reads (old compressed artifacts
        # still load)
        np.savez(
            prefix + ".smt.npz",
            codes=self.codes,
            offsets=self.offsets,
            names=json.dumps(self.names),
        )

    @classmethod
    def load(cls, prefix: str) -> "RefSet":
        with np.load(prefix + ".smt.npz", allow_pickle=False) as z:
            return cls(
                codes=z["codes"],
                offsets=z["offsets"],
                names=json.loads(str(z["names"])),
            )

    def find_seqidx(self, gpos: np.ndarray) -> np.ndarray:
        """Sequence index containing each global position."""
        return np.searchsorted(self.offsets, np.asarray(gpos, dtype=np.uint64), side="right") - 1
