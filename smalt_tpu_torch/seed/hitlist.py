"""Packed k-mer hit lists.

Equivalent of HashHitList (hashhit.c:1224-1770).  Each hit packs into
a uint64 sorted key (hashhit.h:67-72):

  forward:  ((pos | 2^32) - qoffs//nskip) << 31  +  qoffs
  reverse:  ((pos + qoffs//nskip)        << 31)  +  qoffs

where pos is the k-tuple serial number in the reference and qoffs the
query offset in forward-read coordinates.  The upper 33 bits are the
diagonal "shift"; one ascending sort makes equal-shift runs contiguous
(the reference's sortUINT64arrayByQuickSort hot spot,
hashhit.c:1685/1763 — keys are unique so any sort is equivalent).

The list budget is qlen*ln(qlen)*32 clamped to [8192, 2^31-1]
(hashhit.c:1266-1273); on overflow the per-word cutoff halves and
collection restarts (hashhit.c:1593-1688), or words are dropped as
MULTIHIT in segment mode with cutoff 0.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..index.table import KmerIndex
from .hitinfo import (HitInfo, HITQUAL_NORMHIT, HITQUAL_MULTIHIT)
from ..native import get_lib as _get_native, GrowBuf as _GrowBuf

_scr_sqdat = _GrowBuf(np.uint64, 8192)

HITLST_MINSIZ = 8192          # hashhit.c:45
HITLST_MAXSIZ = 2**31 - 1     # hashhit.c:49
HITLST_LOGQLENSIZ_FACT = 32   # hashhit.c:48
MINHIT_PER_TUPLE = 16         # hashhit.c:43
HALFBIT = 31
HALFMASK = 0x7FFFFFFF
OFFBIT = np.uint64(1) << np.uint64(HALFBIT + 1)


@dataclass
class HitList:
    qlen: int
    ktup: int
    nskip: int
    is_reverse: bool
    sqdat: np.ndarray     # uint64 sorted packed hits
    qmask: np.ndarray     # uint8 [qlen] per-position qualifiers

    @property
    def nhits(self) -> int:
        return len(self.sqdat)


def _budget(qlen: int) -> int:
    t = int(qlen * math.log(qlen) * HITLST_LOGQLENSIZ_FACT) if qlen > 1 else 0
    return max(HITLST_MINSIZ, min(t, HITLST_MAXSIZ))


def _pack(pos: np.ndarray, qoffs: int, nskip: int, is_reverse: bool) -> np.ndarray:
    p = pos.astype(np.uint64)
    qo = np.uint64(qoffs // nskip)
    q = np.uint64(qoffs)
    if is_reverse:
        return ((p + qo) << np.uint64(HALFBIT)) + q
    return (((p | OFFBIT) - qo) << np.uint64(HALFBIT)) + q


def collect_hits_using_cutoff(hi: HitInfo, max_nhit_per_tup: int,
                              idx: KmerIndex) -> HitList:
    """hashCollectHitsUsingCutoff (hashhit.c:1593): whole-genome collection
    over the rank-selected seeds, with ceiling-halving retry."""
    lib = _get_native()
    if lib is not None:
        n_seeds = hi.seed_rank if hi.seed_rank else hi.n_seeds
        budget = _budget(hi.qlen)
        _scr_sqdat.ensure(budget)
        qm = np.empty(hi.qlen, dtype=np.uint8)
        _, sa, pa, _ = idx.addrs
        n = lib.mc_collect_cutoff(
            sa, pa,
            hi.qoffs.ctypes.data, hi.nhits.ctypes.data,
            hi.slot.ctypes.data, hi.sidx.ctypes.data,
            n_seeds, hi.qlen, hi.nskip, 1 if hi.is_reverse else 0,
            max_nhit_per_tup, budget,
            _scr_sqdat.addr, qm.ctypes.data)
        return HitList(qlen=hi.qlen, ktup=hi.ktup, nskip=hi.nskip,
                       is_reverse=hi.is_reverse,
                       sqdat=_scr_sqdat.arr[:n].copy(), qmask=qm)
    qmask = np.full(hi.qlen, 4, dtype=np.uint8)  # blankHitList: HITQUAL_NOHIT
    n_seeds = hi.seed_rank if hi.seed_rank else hi.n_seeds
    budget = _budget(hi.qlen)

    while True:
        chunks = []
        total = 0
        reached_ceiling = False
        qm = qmask.copy()
        for rank in range(n_seeds):
            ix = int(hi.sidx[rank])
            nh = int(hi.nhits[ix])
            if nh < 1:
                continue
            q = int(hi.qoffs[ix])
            if max_nhit_per_tup > 0 and nh > max_nhit_per_tup:
                qm[q] = HITQUAL_MULTIHIT
                continue
            if total + nh > budget:
                reached_ceiling = True
                break
            qm[q] = HITQUAL_NORMHIT
            pos = idx.fetch_positions(int(hi.slot[ix]), int(hi.nhits[ix]))
            chunks.append(_pack(pos, q, hi.nskip, hi.is_reverse))
            total += nh
        max_nhit_per_tup //= 2
        if not (reached_ceiling and max_nhit_per_tup > MINHIT_PER_TUPLE):
            break

    sqdat = np.sort(np.concatenate(chunks)) if chunks else np.zeros(0, dtype=np.uint64)
    return HitList(qlen=hi.qlen, ktup=hi.ktup, nskip=hi.nskip,
                   is_reverse=hi.is_reverse, sqdat=sqdat, qmask=qm)


def collect_hits_for_segment(hi: HitInfo,
                             seg_lo: int, seg_hi: int,
                             nhit_max: int,
                             use_short_hitinfo: bool,
                             idx: KmerIndex) -> HitList:
    """hashCollectHitsForSegment (hashhit.c:1691): hits restricted to base
    range [seg_lo, seg_hi) of the concatenated reference; bounds convert to
    tuple serials by integer division (hashhit.c:1712-1717): positions p
    with seg_lo//nskip <= p < seg_hi//nskip."""
    lib = _get_native()
    if lib is not None:
        n_seeds = (hi.seed_rank if (use_short_hitinfo and hi.seed_rank > 0)
                   else hi.n_seeds)
        budget = _budget(hi.qlen)
        _scr_sqdat.ensure(budget)
        qm = np.empty(hi.qlen, dtype=np.uint8)
        _, sa, pa, _ = idx.addrs
        n = lib.mc_collect_segment(
            sa, pa,
            hi.qoffs.ctypes.data, hi.nhits.ctypes.data,
            hi.slot.ctypes.data, hi.sidx.ctypes.data,
            n_seeds, 1 if use_short_hitinfo else 0,
            hi.qlen, hi.nskip, 1 if hi.is_reverse else 0,
            seg_lo, seg_hi, nhit_max, budget,
            _scr_sqdat.addr, qm.ctypes.data)
        return HitList(qlen=hi.qlen, ktup=hi.ktup, nskip=hi.nskip,
                       is_reverse=hi.is_reverse,
                       sqdat=_scr_sqdat.arr[:n].copy(), qmask=qm)
    lo_t = seg_lo // hi.nskip
    hi_t = seg_hi // hi.nskip
    qmask0 = np.full(hi.qlen, 4, dtype=np.uint8)
    n_seeds = (hi.seed_rank if (use_short_hitinfo and hi.seed_rank > 0)
               else hi.n_seeds)
    budget = _budget(hi.qlen)

    while True:
        chunks = []
        total = 0
        alloc_boundary = False
        qm = qmask0.copy()
        for n in range(n_seeds):
            ix = int(hi.sidx[n]) if use_short_hitinfo else n
            nh_all = int(hi.nhits[ix])
            key_n = int(hi.nhits[int(hi.sidx[n])] if use_short_hitinfo else hi.nhits[n])
            q = int(hi.qoffs[ix])
            if nhit_max > 0 and key_n > nhit_max:
                qm[q] = HITQUAL_MULTIHIT
                continue
            pos = idx.fetch_positions(int(hi.slot[ix]), int(hi.nhits[ix]))
            sel = pos[(pos >= lo_t) & (pos < hi_t)]
            nh = len(sel)
            if total + nh > budget:
                if nhit_max > 0:
                    alloc_boundary = True
                    break
                qm[q] = HITQUAL_MULTIHIT
                continue
            chunks.append(_pack(sel, q, hi.nskip, hi.is_reverse))
            total += nh
        nhit_max //= 2
        if not (alloc_boundary and nhit_max > MINHIT_PER_TUPLE):
            break

    sqdat = np.sort(np.concatenate(chunks)) if chunks else np.zeros(0, dtype=np.uint64)
    return HitList(qlen=hi.qlen, ktup=hi.ktup, nskip=hi.nskip,
                   is_reverse=hi.is_reverse, sqdat=sqdat, qmask=qm)
