"""Sampled k-mer index of the reference.

Functional equivalent of the reference hash index (hashidx.c): k-mer
words of length `wordlen` (<= 20 bases) sampled every `nskip` bases
along the concatenated reference; positions stored as k-tuple serial
numbers (serial * nskip = global base offset, hashidx.c:70-107).

The observable contract of the reference's perfect/hash32mix table is
simply: for an exact 2k-bit query word, the ascending list of sampled
positions (hashidx.c:1147 hashTableGetKtupleHits).  We therefore use a
TPU-friendly layout with no hashing at all:

    words:  uint64 [nwords]   sorted distinct k-mer words
    starts: int64  [nwords+1] CSR offsets into pos
    pos:    uint32 [npos]     tuple serial numbers, ascending per word

Lookup is a binary search (searchsorted) — O(log nwords) gathers,
which vectorizes over a whole batch of query words on TPU.

Sampling rules replicated from doWordsInSeq (hashidx.c:465-531):
  - tuple starts are global multiples of nskip that fall fully inside
    one sequence: ceil(soffs/nskip)*nskip <= g <= soffs+len-wordlen;
  - windows containing any non-ACGT base are skipped;
  - word packs bases 2 bits each, first base most significant.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..seq import codec
from ..seq.refset import RefSet

MAX_WORDLEN = 20  # menu.c:595 MENU_KMERLEN_MAX


@dataclass
class KmerIndex:
    wordlen: int
    nskip: int
    words: np.ndarray    # uint64 [nwords]
    starts: np.ndarray   # int64  [nwords+1]
    pos: np.ndarray      # uint32 [npos]
    maxpos: int          # max tuple serial + 1 (hashidx.c maxpos)

    @property
    def npos(self) -> int:
        return len(self.pos)

    HOST_DIRECT_BITS = 26   # build the O(1) table up to k=13 (268 MB)
    HOST_DIRECT_MIN_WORDS = 1 << 16  # below this, C binary search wins

    @property
    def host_table(self):
        """Direct-address cumulative-offset table (int32 [4^k+1]) for
        O(1) host lookups — the cost model of the reference's hash
        table.  None when 2k exceeds HOST_DIRECT_BITS, or for small
        word lists where the native binary-search path is just as fast
        and the 4^k-entry cumsum would dominate startup.  `load` maps
        the table straight from the .smh.npy artifact when present
        (written by save/build), skipping the build entirely."""
        t = getattr(self, "_host_table", None)
        if t is None and 2 * self.wordlen <= self.HOST_DIRECT_BITS and \
                self.nwords >= self.HOST_DIRECT_MIN_WORDS:
            nw = 1 << (2 * self.wordlen)
            # int32 end to end: the int64 intermediate + astype cost
            # ~4.5 s at k=13 (npos < 2^31 always, hashidx.c:110-147)
            counts = np.zeros(nw + 1, np.int32)
            counts[self.words.astype(np.int64) + 1] = \
                np.diff(self.starts).astype(np.int32)
            t = np.cumsum(counts, dtype=np.int32)
            self._host_table = t
        return t

    @property
    def addrs(self):
        """Cached raw data addresses (words, starts, pos, table) for the
        native core (table address 0 when no direct table).  Arrays are
        replaced never, only whole indexes rebuilt."""
        a = getattr(self, "_addrs", None)
        if a is None:
            self.words = np.ascontiguousarray(self.words, dtype=np.uint64)
            self.starts = np.ascontiguousarray(self.starts, dtype=np.int64)
            self.pos = np.ascontiguousarray(self.pos, dtype=np.uint32)
            t = self.host_table
            a = (self.words.ctypes.data, self.starts.ctypes.data,
                 self.pos.ctypes.data,
                 t.ctypes.data if t is not None else 0)
            self._addrs = a
        return a

    @property
    def nwords(self) -> int:
        return len(self.words)

    # ---------------- lookup ----------------

    def lookup_counts(self, qwords: np.ndarray):
        """For each query word: (nhits, pos_base) where pos_base is the
        offset of the word's first position in pos[] (-1 on miss)."""
        qwords = np.asarray(qwords, dtype=np.uint64)
        ix = np.searchsorted(self.words, qwords)
        ix_c = np.minimum(ix, self.nwords - 1) if self.nwords else np.zeros_like(ix)
        hit = (self.nwords > 0) & (self.words[ix_c] == qwords)
        base = np.where(hit, self.starts[ix_c], -1)
        counts = np.where(hit, self.starts[ix_c + 1] - self.starts[ix_c], 0)
        return counts.astype(np.int64), base.astype(np.int64)

    def fetch_positions(self, base: int, count: int) -> np.ndarray:
        """Ascending tuple serial numbers for a word (by pos offset)."""
        return self.pos[base : base + count]

    # ---------------- persistence ----------------

    def save(self, prefix: str) -> None:
        # uncompressed npz (ZIP store): deflate saved ~3x disk but cost
        # ~0.2 s decompress at every mapping run's startup — artifact
        # load time is part of the end-to-end number that competes with
        # the reference's raw binary reads (old compressed artifacts
        # still load)
        np.savez(
            prefix + ".smx.npz",
            meta=json.dumps({"wordlen": self.wordlen, "nskip": self.nskip,
                             "maxpos": self.maxpos}),
            words=self.words, starts=self.starts, pos=self.pos,
        )
        # big-genome direct table as a raw .npy sidecar: `load` memory-maps
        # it, so mapping runs skip the 4^k cumsum (multi-second startup)
        t = self.host_table
        if t is not None:
            np.save(prefix + ".smh.npy", t)

    @classmethod
    def load(cls, prefix: str) -> "KmerIndex":
        import os
        with np.load(prefix + ".smx.npz", allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            idx = cls(wordlen=meta["wordlen"], nskip=meta["nskip"],
                      maxpos=meta["maxpos"],
                      words=z["words"], starts=z["starts"], pos=z["pos"])
        sidecar = prefix + ".smh.npy"
        if os.path.exists(sidecar):
            t = np.load(sidecar, mmap_mode="r")
            if t.dtype == np.int32 and len(t) == (1 << (2 * idx.wordlen)) + 1:
                idx._host_table = t
        return idx

    def print_stats(self, fp) -> None:
        """Occupancy statistics (hashTablePrintStats, hashidx.c:1030)."""
        print(f"# k-mer index: wordlen={self.wordlen} nskip={self.nskip}", file=fp)
        print(f"# distinct words: {self.nwords}", file=fp)
        print(f"# stored positions: {self.npos}", file=fp)
        if self.nwords:
            counts = np.diff(self.starts)
            print(f"# max positions/word: {int(counts.max())}", file=fp)
            print(f"# mean positions/word: {counts.mean():.2f}", file=fp)


def _words_for_seq(codes: np.ndarray, soffs: int, wordlen: int, nskip: int):
    """Sampled (word, serial) pairs for one sequence at global offset soffs."""
    slen = len(codes)
    g0 = -(-soffs // nskip) * nskip  # first multiple of nskip >= soffs
    if g0 + wordlen > soffs + slen:
        return None
    starts_local = np.arange(g0 - soffs, slen - wordlen + 1, nskip, dtype=np.int64)
    serial = (starts_local + soffs) // nskip
    a = codec.alpha(codes)
    bad = (a & codec.STDNT_TESTBIT) != 0
    # window validity: no bad base in [s, s+wordlen)
    cbad = np.concatenate([[0], np.cumsum(bad, dtype=np.int64)])
    ok = (cbad[starts_local + wordlen] - cbad[starts_local]) == 0
    if not ok.any():
        return None
    starts_local = starts_local[ok]
    serial = serial[ok]
    # pack words: first base most significant (hashidx.c MAKE_NEXT_WORD fwd)
    w = np.zeros(len(starts_local), dtype=np.uint64)
    two = np.uint64(2)
    std = (a & codec.STDNT_MASK).astype(np.uint64)
    for k in range(wordlen):
        w = (w << two) | std[starts_local + k]
    return w, serial.astype(np.uint32)


def build_index(refset: RefSet, wordlen: int, nskip: int,
                restrict: Optional[list] = None) -> KmerIndex:
    """Build the sampled k-mer index.

    `restrict`: optional list of (lo, hi, seqidx) base intervals used for
    on-the-fly fine rehashing of mate windows (hashidx.c doAllWordsInSeqSet
    interval path); None indexes the whole reference.
    """
    if not (3 <= wordlen <= MAX_WORDLEN):
        raise ValueError(f"wordlen must be in [3,{MAX_WORDLEN}]")
    if nskip < 1:
        nskip = 1
    all_w = []
    all_p = []
    if restrict is None:
        for s in range(refset.nseq):
            soffs = int(refset.offsets[s])
            r = _words_for_seq(refset.codes[soffs : soffs + refset.seq_len(s)],
                               soffs, wordlen, nskip)
            if r is not None:
                all_w.append(r[0])
                all_p.append(r[1])
    else:
        for (lo, hi, sidx) in restrict:
            soffs = int(refset.offsets[sidx]) + int(lo)
            seg = refset.fetch_by_seq(sidx, int(lo), int(hi) - int(lo) + 1)
            r = _words_for_seq(seg, soffs, wordlen, nskip)
            if r is not None:
                all_w.append(r[0])
                all_p.append(r[1])
    if all_w:
        w = np.concatenate(all_w)
        p = np.concatenate(all_p)
        order = np.lexsort((p, w))
        w = w[order]
        p = p[order]
        uwords, starts_first, counts = np.unique(w, return_index=True, return_counts=True)
        starts = np.concatenate([starts_first, [len(w)]]).astype(np.int64)
    else:
        uwords = np.zeros(0, dtype=np.uint64)
        starts = np.zeros(1, dtype=np.int64)
        p = np.zeros(0, dtype=np.uint32)
    maxpos = int(p.max()) + 1 if len(p) else 0
    return KmerIndex(wordlen=wordlen, nskip=nskip, words=uwords,
                     starts=starts, pos=p, maxpos=maxpos)
