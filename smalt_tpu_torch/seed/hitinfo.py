"""Per-read k-mer hit statistics.

Equivalent of HashHitInfo (hashhit.c:482-657 collectHitInfo,
hashhit.c:1007-1082 hashCollectHitInfoShort / hashSortHitInfo,
hashhit.c:769-900 getHitInfoMaxRank, hashhit.c:1096-1171
hashCalcHitInfoCoverDeficit).

Every read position t in [seq_start, seq_end-k+1] yields a k-mer word
(forward, or its reverse complement for the reverse strand — query
offsets stay in forward-read coordinates, hashhit.c:254-259).  Each
position gets a qualifier in `qmask`:

  0 TERM, 1 NORMHIT, 2 MULTIHIT, 3 REPEAT, 4 NOHIT, 5 NONSTDNT

The tandem-repeat filter drops a word equal to any of the previous 4
*checked* words (hashhit.c:325-345, NREPEATS=4).  "Short" collection
additionally sorts seeds by ascending genome hit count with the
reference's exact (unstable) quicksort and derives `seed_rank`, the
number of rarest seeds to use (budget HASH_MAXNHITS=16384, cover
thresholds hashhit.c:1059-1065).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..seq import codec
from ..index.table import KmerIndex
from ..sort_nr import paired_sort
from ..native import get_lib as _get_native

HITQUAL_TERM = 0
HITQUAL_NORMHIT = 1
HITQUAL_MULTIHIT = 2
HITQUAL_REPEAT = 3
HITQUAL_NOHIT = 4
HITQUAL_NONSTDNT = 5

NREPEATS = 4                  # hashhit.c:42
HASH_MAXNHITS = 16 * 1024     # rmap.c:50 (budget for hit info)
HITINFO_MINSEEDNUM = 3        # hashhit.c:54
HITINFO_MINCOVER_KMER = 2     # hashhit.c:55
HITINFO_MAXCOVER_PERCENT = 80 # hashhit.c:53


@dataclass
class HitInfo:
    qlen: int
    ktup: int
    nskip: int
    is_reverse: bool
    qmask: np.ndarray          # uint8 [qlen]
    qoffs: np.ndarray          # int64 [n_seeds] query offsets (fwd coords)
    nhits: np.ndarray          # int64 [n_seeds] genome hit counts
    slot: np.ndarray           # int64 [n_seeds] word slot in index
    sidx: np.ndarray           # uint32 [n_seeds] sorted-rank -> seed index
    sorted: bool = False
    seed_rank: int = 0
    has_rank: bool = False

    @property
    def n_seeds(self) -> int:
        return len(self.qoffs)

    def sortkey(self) -> np.ndarray:
        return self.nhits.astype(np.uint32)


def _window_words(a_std: np.ndarray, valid_base: np.ndarray, k: int,
                  is_reverse: bool, t0: int, t1: int):
    """(words, window_ok) for window starts t in [t0, t1]."""
    n = t1 - t0 + 1
    w = np.zeros(n, dtype=np.uint64)
    two = np.uint64(2)
    src = a_std.astype(np.uint64)
    if is_reverse:
        comp = (src ^ np.uint64(3)) & np.uint64(3)
        for j in range(k):
            # base t+j contributes complement at bit position 2*j
            w |= comp[t0 + j : t0 + j + n] << np.uint64(2 * j)
    else:
        for j in range(k):
            w = (w << two) if j == 0 else w
            w |= src[t0 + j : t0 + j + n] << np.uint64(2 * (k - 1 - j))
    cbad = np.concatenate([[0], np.cumsum(~valid_base, dtype=np.int64)])
    ok = (cbad[t0 + k : t0 + k + n] - cbad[t0 : t0 + n]) == 0
    return w, ok


def _repeat_filter(words: np.ndarray, ok: np.ndarray) -> np.ndarray:
    """True where a window word equals one of the previous NREPEATS checked
    (i.e. non-NONSTD) window words."""
    rep = np.zeros(len(words), dtype=bool)
    idx = np.flatnonzero(ok)
    if len(idx) == 0:
        return rep
    wv = words[idx]
    for j in range(1, NREPEATS + 1):
        if j >= len(wv):
            break
        rep[idx[j:]] |= wv[j:] == wv[:-j]
    return rep


from ..native import GrowBuf as _GrowBuf

_scr_qoffs = _GrowBuf(np.int64)
_scr_nhits = _GrowBuf(np.int64)
_scr_slot = _GrowBuf(np.int64)
_scr_qbuf = _GrowBuf(np.uint8)


def _collect_hit_info_native(lib, read_codes, qual, is_reverse, idx,
                             maxhit_per_tuple, basq_thresh,
                             seq_start, seq_end) -> HitInfo:
    qlen = len(read_codes)
    codes = np.ascontiguousarray(read_codes, dtype=np.uint8)
    qaddr = 0
    if qual is not None:
        qarr = np.frombuffer(qual, dtype=np.uint8)
        qaddr = qarr.ctypes.data
    qmask = np.empty(qlen, dtype=np.uint8)
    _scr_qoffs.ensure(qlen)
    _scr_nhits.ensure(qlen)
    _scr_slot.ensure(qlen)
    wa, sa, _, ta = idx.addrs
    n = lib.mc_hitinfo_collect(
        wa, sa, idx.nwords, ta, idx.wordlen, idx.nskip,
        codes.ctypes.data, qaddr,
        qlen, 1 if is_reverse else 0, maxhit_per_tuple, basq_thresh,
        seq_start, seq_end,
        qmask.ctypes.data, _scr_qoffs.addr, _scr_nhits.addr, _scr_slot.addr)
    if n < 0:
        raise ShortSeqError(qlen)
    return HitInfo(
        qlen=qlen, ktup=idx.wordlen, nskip=idx.nskip, is_reverse=is_reverse,
        qmask=qmask, qoffs=_scr_qoffs.arr[:n].copy(),
        nhits=_scr_nhits.arr[:n].copy(), slot=_scr_slot.arr[:n].copy(),
        sidx=np.arange(n, dtype=np.uint32))


def collect_hit_info(read_codes: np.ndarray,
                     qual: Optional[bytes],
                     is_reverse: bool,
                     idx: KmerIndex,
                     maxhit_per_tuple: int = 0,
                     basq_thresh: int = 0,
                     seq_start: int = 0,
                     seq_end: int = 0) -> HitInfo:
    """collectHitInfo (hashhit.c:482).  seq_start/seq_end restrict to a read
    segment; seq_end < seq_start+k-1 means the whole read."""
    lib = _get_native()
    if lib is not None:
        return _collect_hit_info_native(lib, read_codes, qual, is_reverse,
                                        idx, maxhit_per_tuple, basq_thresh,
                                        seq_start, seq_end)
    qlen = len(read_codes)
    k = idx.wordlen
    nskip = idx.nskip
    if qlen < k:
        raise ShortSeqError(qlen)

    if seq_end >= qlen:
        seq_end = qlen - 1
    if seq_end < seq_start + k - 1:
        seq_start, seq_end = 0, qlen - 1

    qmask = np.zeros(qlen, dtype=np.uint8)
    qmask[:seq_start] = HITQUAL_NOHIT

    a = codec.alpha(read_codes)
    valid = (a & codec.STDNT_TESTBIT) == 0
    if qual is not None:
        minqval = basq_thresh + codec.QVAL_OFFS
        q = np.frombuffer(qual, dtype=np.uint8)
        valid = valid & (q >= minqval)

    t0, t1 = seq_start, seq_end - k + 1
    if t1 < t0:
        raise ShortSeqError(qlen)
    words, ok = _window_words(a & codec.STDNT_MASK, valid, k, is_reverse, t0, t1)
    rep = _repeat_filter(words, ok)

    n = t1 - t0 + 1
    quals = np.full(n, HITQUAL_NONSTDNT, dtype=np.uint8)
    check = ok & ~rep
    quals[ok & rep] = HITQUAL_REPEAT

    counts = np.zeros(n, dtype=np.int64)
    slots = np.full(n, -1, dtype=np.int64)
    if check.any():
        c, s = idx.lookup_counts(words[check])
        counts[check] = c
        slots[check] = s
    quals[check & (counts < 1)] = HITQUAL_NOHIT
    is_seed = check & (counts >= 1)
    if maxhit_per_tuple > 0:
        multi = is_seed & (counts > maxhit_per_tuple)
        quals[multi] = HITQUAL_MULTIHIT
        is_seed &= ~multi
    quals[is_seed] = HITQUAL_NORMHIT

    qmask[t0 : t1 + 1] = quals
    # positions past the last full window stay TERM (hashhit.c:652-653)

    seed_ix = np.flatnonzero(is_seed)
    qoffs = (seed_ix + t0).astype(np.int64)
    return HitInfo(
        qlen=qlen, ktup=k, nskip=nskip, is_reverse=is_reverse,
        qmask=qmask, qoffs=qoffs,
        nhits=counts[seed_ix], slot=slots[seed_ix],
        sidx=np.arange(len(seed_ix), dtype=np.uint32),
    )


class ShortSeqError(Exception):
    """read shorter than the k-mer word (ERRCODE_SHORTSEQ)"""


def _max_rank(hi: HitInfo, mincover: int, maxcover: int, maxhit: int) -> int:
    """getHitInfoMaxRank (hashhit.c:769-900), literal replica."""
    lib = _get_native()
    if lib is not None:
        _scr_qbuf.ensure(hi.qlen)
        return int(lib.mc_max_rank(
            hi.qoffs.ctypes.data, hi.nhits.ctypes.data, hi.sidx.ctypes.data,
            hi.n_seeds, hi.qlen, hi.ktup, hi.nskip,
            mincover, maxcover, maxhit, _scr_qbuf.addr))
    n_seeds = hi.n_seeds
    nskip = hi.nskip
    ktup = hi.ktup
    key = hi.nhits  # sorted ascending by rank via hi.sidx ordering of seeds
    # after sorting, hi.nhits/qoffs are rank-ordered? No: we keep seeds in
    # qoffs order; hi.sidx maps rank -> seed index and key_by_rank below.
    key_by_rank = hi.nhits[hi.sidx]
    frames = [[] for _ in range(nskip)]
    for rank in range(n_seeds):
        ix = hi.sidx[rank]
        f = int(hi.qoffs[ix]) % nskip
        frames[f].append(rank)
    ntot = int(key_by_rank[0])
    i = 1
    while i <= n_seeds and ntot <= maxhit:
        if i < n_seeds:
            ntot += int(key_by_rank[i])
        i += 1
    n = nmax = i - 1

    qbuf = np.zeros(hi.qlen, dtype=bool)
    for f in range(nskip):
        ixp = frames[f]
        if not ixp:
            continue
        qbuf[:] = False
        cover = 0
        i = 0
        while i < len(ixp) and cover <= maxcover and (cover < mincover or ixp[i] <= n):
            ix = hi.sidx[ixp[i]]
            qo = int(hi.qoffs[ix])
            seg = qbuf[qo : qo + ktup - 1]
            cover += int((~seg).sum())
            seg[:] = True
            i += 1
        if i > 0 and ixp[i - 1] > nmax:
            nmax = ixp[i - 1]

    if nmax < HITINFO_MINSEEDNUM:
        return HITINFO_MINSEEDNUM if HITINFO_MINSEEDNUM < n_seeds else n_seeds
    return nmax


def sort_hit_info(hi: HitInfo) -> None:
    """hashSortHitInfo (hashhit.c:1082): sort seed ranks by ascending hit
    count with the reference's exact quicksort permutation."""
    if hi.n_seeds > 1 and not hi.sorted:
        key, sidx = paired_sort(hi.sortkey(), hi.sidx)
        hi.sidx = sidx
        hi._key_by_rank = key
    hi.sorted = True


_scr_qoffs2 = _GrowBuf(np.int64)
_scr_nhits2 = _GrowBuf(np.int64)
_scr_slot2 = _GrowBuf(np.int64)
_scr_sidx = _GrowBuf(np.uint32)
_scr_sidx2 = _GrowBuf(np.uint32)
_scr_key = _GrowBuf(np.uint32)
_scr_short_out = np.zeros(4, dtype=np.int64)


def collect_hit_info_short_pair(read_codes: np.ndarray,
                                qual: Optional[bytes],
                                idx: KmerIndex,
                                maxhit_per_tuple: int,
                                maxhit_total: int = HASH_MAXNHITS,
                                basq_thresh: int = 0):
    """Both strands' short hit info in one native call; falls back to
    two collect_hit_info_short calls without the C core."""
    lib = _get_native()
    if lib is None:
        return (collect_hit_info_short(read_codes, qual, False, idx,
                                       maxhit_per_tuple, maxhit_total,
                                       basq_thresh),
                collect_hit_info_short(read_codes, qual, True, idx,
                                       maxhit_per_tuple, maxhit_total,
                                       basq_thresh))
    qlen = len(read_codes)
    codes = np.ascontiguousarray(read_codes, dtype=np.uint8)
    qaddr = 0
    if qual is not None:
        qarr = np.frombuffer(qual, dtype=np.uint8)
        qaddr = qarr.ctypes.data
    qmaskF = np.empty(qlen, dtype=np.uint8)
    qmaskR = np.empty(qlen, dtype=np.uint8)
    for b in (_scr_qoffs, _scr_nhits, _scr_slot, _scr_qoffs2, _scr_nhits2,
              _scr_slot2):
        b.ensure(qlen)
    for b in (_scr_sidx, _scr_sidx2, _scr_key):
        b.ensure(qlen)
    _scr_qbuf.ensure(qlen)
    wa, sa, _, ta = idx.addrs
    rc = lib.mc_hitinfo_short2(
        wa, sa, idx.nwords, ta, idx.wordlen, idx.nskip,
        codes.ctypes.data, qaddr, qlen,
        maxhit_per_tuple, maxhit_total, basq_thresh,
        qmaskF.ctypes.data, _scr_qoffs.addr, _scr_nhits.addr,
        _scr_slot.addr, _scr_sidx.addr,
        qmaskR.ctypes.data, _scr_qoffs2.addr, _scr_nhits2.addr,
        _scr_slot2.addr, _scr_sidx2.addr,
        _scr_qbuf.addr, _scr_key.addr,
        _scr_short_out.ctypes.data)
    if rc != 0:
        raise ShortSeqError(qlen)
    nF, rankF, nR, rankR = (int(v) for v in _scr_short_out)
    hf = HitInfo(qlen=qlen, ktup=idx.wordlen, nskip=idx.nskip,
                 is_reverse=False, qmask=qmaskF,
                 qoffs=_scr_qoffs.arr[:nF].copy(),
                 nhits=_scr_nhits.arr[:nF].copy(),
                 slot=_scr_slot.arr[:nF].copy(),
                 sidx=_scr_sidx.arr[:nF].copy(),
                 sorted=True, seed_rank=rankF, has_rank=nF > 1)
    hr = HitInfo(qlen=qlen, ktup=idx.wordlen, nskip=idx.nskip,
                 is_reverse=True, qmask=qmaskR,
                 qoffs=_scr_qoffs2.arr[:nR].copy(),
                 nhits=_scr_nhits2.arr[:nR].copy(),
                 slot=_scr_slot2.arr[:nR].copy(),
                 sidx=_scr_sidx2.arr[:nR].copy(),
                 sorted=True, seed_rank=rankR, has_rank=nR > 1)
    return hf, hr


def collect_hit_info_short(read_codes: np.ndarray,
                           qual: Optional[bytes],
                           is_reverse: bool,
                           idx: KmerIndex,
                           maxhit_per_tuple: int,
                           maxhit_total: int = HASH_MAXNHITS,
                           basq_thresh: int = 0) -> HitInfo:
    """hashCollectHitInfoShort (hashhit.c:1007)."""
    hi = collect_hit_info(read_codes, qual, is_reverse, idx,
                          maxhit_per_tuple=maxhit_per_tuple,
                          basq_thresh=basq_thresh)
    if hi.n_seeds <= 1:
        hi.sorted = True
        hi.seed_rank = hi.n_seeds
        return hi
    sort_hit_info(hi)
    slen = hi.qlen
    mincover = HITINFO_MINCOVER_KMER * hi.ktup + hi.nskip
    maxcover = slen * HITINFO_MAXCOVER_PERCENT // 100
    if maxcover < hi.ktup + hi.nskip:
        maxcover = hi.ktup + hi.nskip
    elif maxcover > slen - hi.nskip:
        maxcover = slen - hi.nskip
    if mincover > maxcover:
        mincover, maxcover = 0, slen
    hi.seed_rank = _max_rank(hi, mincover, maxcover, maxhit_total)
    hi.has_rank = True
    return hi


def cover_deficit(hi: HitInfo) -> int:
    """hashCalcHitInfoCoverDeficit (hashhit.c:1096-1171)."""
    lib = _get_native()
    if lib is not None:
        _scr_qbuf.ensure(hi.qlen)
        return int(lib.mc_cover_deficit(
            hi.qoffs.ctypes.data, hi.sidx.ctypes.data,
            hi.n_seeds, 1 if hi.has_rank else 0, hi.seed_rank,
            hi.qmask.ctypes.data, hi.qlen, hi.ktup, hi.nskip,
            _scr_qbuf.addr))
    nskip = hi.nskip
    ktup = hi.ktup
    if hi.has_rank:
        d = hi.qlen
        maxcover = 0
        frames = [[] for _ in range(nskip)]
        for rank in range(hi.n_seeds):
            ix = hi.sidx[rank]
            f = int(hi.qoffs[ix]) % nskip
            frames[f].append(rank)
        qbuf = np.zeros(hi.qlen, dtype=bool)
        for f in range(nskip):
            ixp = frames[f]
            if not ixp:
                continue
            qbuf[:] = False
            cover = 0
            for rank in ixp:
                if rank >= hi.seed_rank:
                    break
                ix = hi.sidx[rank]
                qo = int(hi.qoffs[ix])
                seg = qbuf[qo : qo + ktup]
                cover += int((~seg).sum())
                seg[:] = True
            if cover < d:
                d = cover
            if cover > maxcover:
                maxcover = cover
        return maxcover - d + 1
    # qmask-based fallback (no rank assigned)
    k = ktup // nskip
    if k > 0:
        k -= 1
    deficit = 0
    qm = hi.qmask
    for s in range(nskip):
        d = 0
        ctr = 0
        for i in range(s, hi.qlen, nskip):
            if qm[i] == HITQUAL_NORMHIT:
                ctr = k
            elif ctr:
                ctr -= 1
            else:
                d += nskip
        if d > deficit:
            deficit = d
    return deficit


def total_hits(hi: HitInfo, maxhit_per_tuple: int) -> int:
    """hashCalcHitInfoNumberOfHits (hashhit.c:1173-1199)."""
    if maxhit_per_tuple >= 1:
        return int(hi.nhits[hi.nhits <= maxhit_per_tuple].sum())
    return int(hi.nhits.sum())


def hit_numbers(hi: HitInfo):
    """hashHitInfoCalcHitNumbers: (total, within-rank) hit counts."""
    tot = int(hi.nhits.sum())
    if hi.seed_rank > 0:
        rank_ix = hi.sidx[: hi.seed_rank]
        nrank = int(hi.nhits[rank_ix].sum())
    else:
        nrank = tot
    return tot, nrank
