"""Seed collation: hits -> hit regions -> seeds -> constant-shift
segments -> banded-alignment candidates.

Replicates segment.c semantics exactly:
  - defineHitRegions (segment.c:396): split the shift-sorted hit list
    where the shift difference between successive hits exceeds
    min(ktup*3//nskip, (qlen-ktup)//nskip+1); keep regions with at
    least min_ktup hits.
  - makeSeedsFromHits (segment.c:455): merge same-shift, in-register,
    overlapping hits into maximal exact runs (SEEDs).
  - makeSegmentsFromSeeds (segment.c:535): group same-shift in-register
    seeds into SEGMENTs with summed coverage.
  - addCandsFast (segment.c:1140): within each region, greedily join
    neighbouring segments while the added non-overlapping query
    coverage is not negligible; emit a candidate once cover >=
    mincover, with band geometry from derriveSEGCAND (segment.c:929).
  - segAliCandsStats (segment.c:1616): depth selection sorted by
    coverage-below-max (exact NR quicksort), target 512 / max 2048.
  - segAliCandsCalcSegmentOffsets (segment.c:1861): final reference
    window, band edges and direct-match offsets for the DP.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..sort_nr import paired_sort
from ..native import get_lib as _get_native, GrowBuf as _GrowBuf

HALFBIT = 31
HALFMASK = 0x7FFFFFFF
SOFFSMASK = 0xFFFFFFFF
OFFBIT = 1 << (HALFBIT + 1)

SEGMENTING_DIFFSHIFT = 3   # segment.c:126
MAXIMUM_DEPTH = 8000       # segment.c:133
DEFAULT_TARGET_DEPTH = 200 # segment.c:135
EDGE_BAND_FACTOR = 4       # segment.c:137
MAX_BANDEDGE_2POW = 4      # segment.c:142

FLAG_REVERSE = 0x01        # SEGCANDFLG_REVERSE
FLAG_MMALI = 0x02          # SEGCANDFLG_MMALI
FLAG_MATEDIST = 0x04       # SEGCANDFLG_MATEDIST
UNKNOWN_SEQIDX = -1


@dataclass
class SegLst:
    """Seeds and constant-shift segments for one strand's hit list."""
    is_reverse: bool
    ktup: int
    nskip: int
    qlen: int
    # seeds
    seed_sqo: np.ndarray   # uint64 packed shift|qoffs
    seed_len: np.ndarray   # int64 covered bases
    # segments (constant shift)
    seg_ix: np.ndarray     # first seed index
    seg_nseed: np.ndarray  # int64 (sign flags "used")
    seg_cover: np.ndarray  # int64
    # hit regions over segments: [idx, num] pairs
    hreg_idx: np.ndarray
    hreg_num: np.ndarray
    maxcover: int = 0


_scr_seed_sqo = _GrowBuf(np.uint64)
_scr_seed_len = _GrowBuf(np.int64)
_scr_seg_ix = _GrowBuf(np.int64)
_scr_seg_nseed = _GrowBuf(np.int64)
_scr_seg_cover = _GrowBuf(np.int64)
_scr_hreg_idx = _GrowBuf(np.int64)
_scr_hreg_num = _GrowBuf(np.int64)
_scr_counts = np.zeros(4, dtype=np.int64)
_scr_mask = _GrowBuf(np.uint8)
_scr_out = _GrowBuf(np.int64)
_scr_maxcov = np.zeros(2, dtype=np.int64)


def _seg_lst_fill_hits_native(lib, hitlist, min_ktup: int) -> SegLst:
    shdat = np.ascontiguousarray(hitlist.sqdat, dtype=np.uint64)
    nhits = len(shdat)
    cap = max(nhits, 1)
    for b in (_scr_seed_sqo, _scr_seed_len, _scr_seg_ix, _scr_seg_nseed,
              _scr_seg_cover, _scr_hreg_idx, _scr_hreg_num):
        b.ensure(cap)
    ca = _scr_counts.ctypes.data
    lib.mc_seg_fill(
        shdat.ctypes.data, nhits,
        hitlist.qmask.ctypes.data, min_ktup,
        hitlist.ktup, hitlist.nskip, hitlist.qlen,
        _scr_seed_sqo.addr, _scr_seed_len.addr,
        _scr_seg_ix.addr, _scr_seg_nseed.addr, _scr_seg_cover.addr,
        _scr_hreg_idx.addr, _scr_hreg_num.addr,
        ca, ca + 8, ca + 16, ca + 24)
    n_seed, n_seg, n_reg, maxcover = (int(v) for v in _scr_counts)
    return SegLst(
        is_reverse=hitlist.is_reverse, ktup=hitlist.ktup,
        nskip=hitlist.nskip, qlen=hitlist.qlen,
        seed_sqo=_scr_seed_sqo.arr[:n_seed].copy(),
        seed_len=_scr_seed_len.arr[:n_seed].copy(),
        seg_ix=_scr_seg_ix.arr[:n_seg].copy(),
        seg_nseed=_scr_seg_nseed.arr[:n_seg].copy(),
        seg_cover=_scr_seg_cover.arr[:n_seg].copy(),
        hreg_idx=_scr_hreg_idx.arr[:n_reg].copy(),
        hreg_num=_scr_hreg_num.arr[:n_reg].copy(),
        maxcover=maxcover)


def seg_lst_fill_hits(hitlist, min_ktup: int) -> SegLst:
    """segLstFillHits (segment.c:763)."""
    lib = _get_native()
    if lib is not None:
        return _seg_lst_fill_hits_native(lib, hitlist, min_ktup)
    shdat = hitlist.sqdat
    nhits = len(shdat)
    ktup, nskip, qlen = hitlist.ktup, hitlist.nskip, hitlist.qlen

    # min_ktup reduction over the hit-list qmask (segment.c:778-785):
    # scan until the first 0 byte; every non-NORMHIT position decrements
    # min_ktup down to 1.
    qm = hitlist.qmask
    for v in qm:
        if v == 0:
            break
        if v == 1:
            continue
        if min_ktup < 2:
            break
        min_ktup -= 1

    # --- defineHitRegions ---
    max_dshift = ktup * SEGMENTING_DIFFSHIFT // nskip
    ds = (qlen - ktup) // nskip + 1
    if ds < max_dshift:
        max_dshift = ds
    dsthresh = np.uint64(max_dshift) << np.uint64(HALFBIT)

    regions = []  # (hit_start, hit_count)
    if nhits > 0:
        gaps = np.flatnonzero((shdat[1:] - shdat[:-1]) >= dsthresh)
        starts = np.concatenate([[0], gaps + 1])
        ends = np.concatenate([gaps + 1, [nhits]])
        for a, b in zip(starts, ends):
            if b - a >= min_ktup:
                regions.append((int(a), int(b - a)))

    # --- makeSeedsFromHits ---
    seed_sqo: List[int] = []
    seed_len: List[int] = []
    reg_seed = []  # per region: (seed_start, seed_count)
    shift_of = (shdat >> np.uint64(HALFBIT)).astype(np.uint64)
    qoffs_of = (shdat & np.uint64(HALFMASK)).astype(np.int64)
    for (a, num) in regions:
        s0 = len(seed_sqo)
        i = a
        end = a + num
        while i < end:
            sqo = int(shdat[i])
            shift = sqo >> HALFBIT
            qoffs = int(qoffs_of[i])
            lastq = qoffs + ktup
            j = i + 1
            while j < end:
                if int(shift_of[j]) != shift:
                    break
                qo = int(qoffs_of[j])
                if qo > lastq or ((qo - qoffs) % nskip):
                    break
                lastq = qo + ktup
                j += 1
            seed_sqo.append(sqo)
            seed_len.append(lastq - qoffs)
            i = j
        reg_seed.append((s0, len(seed_sqo) - s0))

    seed_sqo_a = np.asarray(seed_sqo, dtype=np.uint64)
    seed_len_a = np.asarray(seed_len, dtype=np.int64)

    # --- makeSegmentsFromSeeds ---
    seg_ix: List[int] = []
    seg_nseed: List[int] = []
    seg_cover: List[int] = []
    hreg_idx: List[int] = []
    hreg_num: List[int] = []
    maxcover = 0
    for (s0, ns) in reg_seed:
        hreg_idx.append(len(seg_ix))
        cnt = 0
        i = s0
        end = s0 + ns
        while i < end:
            shift = int(seed_sqo_a[i]) >> HALFBIT
            qoffs = int(seed_sqo_a[i]) & HALFMASK
            cover = int(seed_len_a[i])
            j = i + 1
            while j < end:
                if (int(seed_sqo_a[j]) >> HALFBIT) != shift or \
                   ((int(seed_sqo_a[j]) & HALFMASK) - qoffs) % nskip:
                    break
                cover += int(seed_len_a[j])
                j += 1
            seg_ix.append(i)
            seg_nseed.append(j - i)
            seg_cover.append(cover)
            if cover > maxcover:
                maxcover = cover
            cnt += 1
            i = j
        hreg_num.append(cnt)

    return SegLst(
        is_reverse=hitlist.is_reverse, ktup=ktup, nskip=nskip, qlen=qlen,
        seed_sqo=seed_sqo_a, seed_len=seed_len_a,
        seg_ix=np.asarray(seg_ix, dtype=np.int64),
        seg_nseed=np.asarray(seg_nseed, dtype=np.int64),
        seg_cover=np.asarray(seg_cover, dtype=np.int64),
        hreg_idx=np.asarray(hreg_idx, dtype=np.int64),
        hreg_num=np.asarray(hreg_num, dtype=np.int64),
        maxcover=maxcover,
    )


@dataclass
class Cand:
    """SEGCAND (segment.c:239)."""
    qs: int
    qe: int
    rs: int      # k-tuple serial of first word
    re: int      # k-tuple serial of last word
    shiftoffs: int
    shift2mm: int
    srange: int
    cover: int
    flag: int
    nseg: int
    seqidx: int


def _segment_boundaries(sgl: SegLst, seg: int):
    """calcSegmentBoundaries (segment.c:637-668)."""
    ktup, nskip = sgl.ktup, sgl.nskip
    i0 = int(sgl.seg_ix[seg])
    n = abs(int(sgl.seg_nseed[seg]))
    sp = int(sgl.seed_sqo[i0])
    ep = int(sgl.seed_sqo[i0 + n - 1])
    ep_len = int(sgl.seed_len[i0 + n - 1])
    qs = sp & HALFMASK
    qe = (ep & HALFMASK) + ep_len - 1
    if sgl.is_reverse:
        rs = ((ep >> HALFBIT) - (ep & HALFMASK) // nskip) & SOFFSMASK
        rs -= (ep_len - ktup) // nskip
        re = ((sp >> HALFBIT) - qs // nskip) & SOFFSMASK
    else:
        rs = ((sp >> HALFBIT) + qs // nskip) & SOFFSMASK
        re = ((ep >> HALFBIT) + (ep & HALFMASK) // nskip) & SOFFSMASK
        re += (ep_len - ktup) // nskip
    return qs, qe, rs, re


def _derrive_cand(sgl: SegLst, seg_start: int, nseg: int, cover: int,
                  mincover_noindel: int, seqidx: int) -> Cand:
    """derriveSEGCAND (segment.c:929-1057)."""
    nskip, ktup = sgl.nskip, sgl.ktup
    is_rev = sgl.is_reverse
    qs, qe, rs, re = _segment_boundaries(sgl, seg_start)
    shift_2mm = shift_min = int(sgl.seed_sqo[int(sgl.seg_ix[seg_start])]) >> HALFBIT
    maxcover = int(sgl.seg_cover[seg_start])
    last_shift = shift_min
    for n in range(1, nseg):
        seg = seg_start + n
        q1, q2, r1, r2 = _segment_boundaries(sgl, seg)
        if int(sgl.seg_cover[seg]) > maxcover:
            shift_2mm = int(sgl.seed_sqo[int(sgl.seg_ix[seg])]) >> HALFBIT
            maxcover = int(sgl.seg_cover[seg])
        qs = min(qs, q1)
        qe = max(qe, q2)
        rs = min(rs, r1)
        re = max(re, r2)
        last_shift = int(sgl.seed_sqo[int(sgl.seg_ix[seg])]) >> HALFBIT

    flag = 0
    if is_rev:
        flag |= FLAG_REVERSE
        shift_start = rs + (qe - ktup + 1) // nskip
    else:
        shift_start = (rs | OFFBIT) - qs // nskip

    shift_range = last_shift - shift_min
    diff_shift = shift_min - shift_start

    c = Cand(qs=qs, qe=qe, rs=rs, re=re,
             shiftoffs=diff_shift, shift2mm=0,
             srange=shift_range, cover=cover, flag=flag,
             nseg=nseg, seqidx=seqidx)
    if maxcover >= mincover_noindel:
        c.flag |= FLAG_MMALI
        c.shift2mm = shift_2mm - shift_start
    return c


@dataclass
class SegAliCands:
    """Accumulator of alignment candidates (SegAliCands, segment.c:1475)."""
    cands: List[Cand] = field(default_factory=list)
    max_cover: int = 0
    max2nd_cover: int = 0
    ktup: int = 0
    nskip: int = 0
    cover_deficit: tuple = (0, 0)
    sort_idx: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    sort_keys: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    n_sort: int = 0
    n_mincover: int = 0

    def blank(self):
        self.cands = []
        self.max_cover = 0
        self.max2nd_cover = 0
        self.n_sort = 0
        self.n_mincover = 0
        self.ktup = 0
        self.nskip = 0
        self.cover_deficit = (0, 0)


def seg_cands_add_fast(sac: SegAliCands, sgl: SegLst, mincover: int,
                       seqidx: int) -> None:
    """segAliCandsAddFast -> addCandsFast (segment.c:1530, 1140).
    mincover doubles as mincover_noindel (segment.c:1550-1553)."""
    if not sac.cands:
        sac.ktup = sgl.ktup
        sac.nskip = sgl.nskip
    lib = _get_native()
    if lib is not None and len(sgl.hreg_idx):
        nseg = len(sgl.seg_ix)
        nseed_state = np.array(sgl.seg_nseed, dtype=np.int64)  # private copy
        _scr_out.ensure(max(nseg, 1) * 10)
        _scr_mask.ensure(sgl.qlen)
        _scr_maxcov[0] = sac.max_cover
        _scr_maxcov[1] = sac.max2nd_cover
        n = lib.mc_cands_add(
            sgl.seed_sqo.ctypes.data, sgl.seed_len.ctypes.data,
            sgl.seg_ix.ctypes.data, nseed_state.ctypes.data,
            sgl.seg_cover.ctypes.data,
            sgl.hreg_idx.ctypes.data, sgl.hreg_num.ctypes.data,
            len(sgl.hreg_idx),
            sgl.ktup, sgl.nskip, sgl.qlen, 1 if sgl.is_reverse else 0,
            mincover, _scr_mask.addr,
            _scr_out.addr, _scr_maxcov.ctypes.data)
        out = _scr_out.arr
        for r in range(n):
            o = r * 10
            sac.cands.append(Cand(
                qs=int(out[o]), qe=int(out[o + 1]), rs=int(out[o + 2]),
                re=int(out[o + 3]), shiftoffs=int(out[o + 4]),
                shift2mm=int(out[o + 5]), srange=int(out[o + 6]),
                cover=int(out[o + 7]), flag=int(out[o + 8]),
                nseg=int(out[o + 9]), seqidx=seqidx))
        sac.max_cover = int(_scr_maxcov[0])
        sac.max2nd_cover = int(_scr_maxcov[1])
        return
    mask = np.zeros(sgl.qlen, dtype=bool)
    nreg = len(sgl.hreg_idx)
    nseed_state = sgl.seg_nseed.copy()

    def seed_cover_init(seg):
        mask[:] = False
        i0 = int(sgl.seg_ix[seg])
        for l in range(abs(int(nseed_state[seg]))):
            qo = int(sgl.seed_sqo[i0 + l]) & HALFMASK
            mask[qo : qo + int(sgl.seed_len[i0 + l])] = True

    def seed_cover_new(seg) -> int:
        i0 = int(sgl.seg_ix[seg])
        new = 0
        for l in range(abs(int(nseed_state[seg]))):
            qo = int(sgl.seed_sqo[i0 + l]) & HALFMASK
            seg_m = mask[qo : qo + int(sgl.seed_len[i0 + l])]
            new += int((~seg_m).sum())
            seg_m[:] = True
        return new

    for r in range(nreg):
        base = int(sgl.hreg_idx[r])
        num = int(sgl.hreg_num[r])
        i = 0
        while i < num:
            seg = base + i
            seed_cover_init(seg)
            cover = int(sgl.seg_cover[seg])
            j = i + 1
            while j < num:
                sj = base + j
                if nseed_state[sj] < 0:
                    break
                cover_new = seed_cover_new(sj)
                if (cover_new << 1) < int(sgl.seg_cover[sj]) and cover >= mincover:
                    break
                cover += cover_new
                j += 1
            if cover >= mincover:
                c = _derrive_cand(sgl, seg, j - i, cover, mincover, seqidx)
                # flag out the segments consumed (derriveSEGCAND negates)
                for t in range(i, j):
                    nseed_state[base + t] = -abs(int(nseed_state[base + t]))
                sac.cands.append(c)
                if cover > sac.max2nd_cover:
                    if cover > sac.max_cover:
                        sac.max2nd_cover = sac.max_cover
                        sac.max_cover = cover
                    elif cover != sac.max_cover:
                        sac.max2nd_cover = cover
            i = j


def seg_cands_stats(sac: SegAliCands,
                    min_cover_below_max: int,
                    deficit_f: int, deficit_r: int,
                    target_depth: int, max_depth: int,
                    is_sensitive: bool) -> None:
    """segAliCandsStats (segment.c:1616-1786)."""
    nskip = sac.nskip
    if max_depth < 1 or max_depth > MAXIMUM_DEPTH:
        max_depth = MAXIMUM_DEPTH
    if target_depth < 1:
        target_depth = DEFAULT_TARGET_DEPTH
    if target_depth > max_depth:
        target_depth = max_depth

    cdf = 0
    min_cover = 0 if min_cover_below_max > sac.max_cover else sac.max_cover - min_cover_below_max
    if min_cover > sac.max2nd_cover:
        cdf = min_cover - sac.max2nd_cover
        min_cover = sac.max2nd_cover

    sac.cover_deficit = (deficit_f, deficit_r)
    cda = []
    for d in (deficit_f, deficit_f):  # sic: reference uses cover_deficit[0]
        # for both strands (segment.c:1676 "cover_deficit_adjusted[i] =
        # sacp->cover_deficit[0]")
        cda.append(d - cdf if d > cdf else 0)

    rows = getattr(sac, "rows_arr", None)
    if rows is not None:
        covers = rows[:, 7]
        flags = rows[:, 8]
    else:
        covers = np.fromiter((c.cover for c in sac.cands), np.int64,
                             len(sac.cands))
        flags = np.fromiter((c.flag for c in sac.cands), np.int64,
                            len(sac.cands))
    cda_vec = np.where((flags & FLAG_REVERSE) != 0, cda[1], cda[0])
    mask = covers + cda_vec >= min_cover
    idxs_a = np.flatnonzero(mask).astype(np.uint32)
    keys_a = (sac.max_cover - covers[mask]).astype(np.uint32)
    keys_a, idxs_a = paired_sort(keys_a, idxs_a)
    sac.sort_keys = keys_a
    sac.sort_idx = idxs_a
    sac.n_mincover = j = len(idxs_a)

    if j > target_depth:
        maxj = j if j < max_depth else max_depth
        if is_sensitive:
            jj = target_depth
            while jj < maxj:
                # NB: indexes the UNSORTED candidate order here, exactly
                # like the replica always has (segment.c semantics)
                is_rev = 1 if (int(flags[jj]) & FLAG_REVERSE) else 0
                if int(keys_a[jj]) >= cda[is_rev]:
                    break
                jj += 1
            while jj < sac.n_mincover and int(keys_a[jj]) < nskip:
                jj += 1
            j = jj
        else:
            cov = int(keys_a[j // 2])
            if cov < nskip:
                cov = nskip
            jj = target_depth
            while jj < maxj and int(keys_a[jj]) < cov:
                jj += 1
            j = jj
    sac.n_sort = j


@dataclass
class CandWindow:
    """Output of calc_segment_offsets: what the DP pass needs."""
    qs: int
    qe: int
    rs: int          # base offset (within sequence seqidx, or global)
    re: int
    band_l: int
    band_r: int
    qs_direct: int
    ro_direct: int
    seqidx: int
    flag: int
    cover: int


def calc_segment_offsets(sac: SegAliCands, scidx: int, qlen: int,
                         ref_offsets: np.ndarray, edgelen: int) -> CandWindow:
    """segAliCandsCalcSegmentOffsets (segment.c:1861-1985)."""
    nskip, ktup = sac.nskip, sac.ktup
    c = sac.cands[int(sac.sort_idx[scidx])]
    nseq = len(ref_offsets) - 1
    if c.seqidx < 0 or c.seqidx >= nseq:
        roffs = 0
        rlen = int(ref_offsets[nseq])
    else:
        roffs = int(ref_offsets[c.seqidx])
        rlen = int(ref_offsets[c.seqidx + 1]) - roffs

    rs = c.rs * nskip
    re = c.re * nskip + ktup - 1
    if rs < roffs or re < rs:
        raise AssertionError("candidate window before sequence start")
    rs -= roffs
    re -= roffs
    if re >= rlen:
        raise AssertionError("candidate window past sequence end")
    if c.qe < c.qs or c.qs >= qlen:
        raise AssertionError("bad query segment")

    if c.flag & FLAG_REVERSE:
        qs = qlen - c.qe - 1
        qe = qlen - c.qs - 1
    else:
        qs, qe = c.qs, c.qe

    edge_band = (qlen - c.cover) // EDGE_BAND_FACTOR
    if edge_band > nskip:
        if edge_band > (qlen >> MAX_BANDEDGE_2POW):
            edge_band = qlen >> MAX_BANDEDGE_2POW
        edge_band -= nskip - 1
    else:
        edge_band = 0

    br = (-c.shiftoffs + 1) * nskip + edge_band + 1
    bl = br - (c.srange + 2) * nskip - 2 * edge_band - 2

    q_edge_l = edgelen if (qs >= edgelen and edgelen > 0) else qs
    q_edge_r = edgelen if (qe + edgelen + 1 <= qlen and edgelen > 0) else qlen - qe - 1
    qs -= q_edge_l
    qe += q_edge_r

    r_edge_l = q_edge_l + br
    r_edge_r = q_edge_r - bl

    if r_edge_l > 0 and rs < r_edge_l:
        r_edge_l = rs
        rs = 0
    else:
        rs -= r_edge_l

    if re + r_edge_r >= rlen:
        r_edge_r = rlen - re - 1
        re = rlen - 1
    else:
        re += r_edge_r
    if re < rs:
        raise AssertionError("window collapsed")

    band_offs = q_edge_l - r_edge_l
    ds = c.shift2mm * nskip + band_offs
    band_l = bl + band_offs + qs
    band_r = br + band_offs + qs
    if ds < 0:
        qs_direct = qs - ds
        ro_direct = 0
    else:
        qs_direct = qs
        ro_direct = ds

    return CandWindow(qs=qs, qe=qe, rs=rs, re=re, band_l=band_l, band_r=band_r,
                      qs_direct=qs_direct, ro_direct=ro_direct,
                      seqidx=c.seqidx, flag=c.flag, cover=c.cover)
