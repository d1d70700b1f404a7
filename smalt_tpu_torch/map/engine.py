"""Per-read mapping engine.

Replicates rmap.c's orchestration:

  rmap_single   rmapSingle  (rmap.c:1648-1743)
  rmap_pair     rmapPair    (rmap.c:1744-2112): map the rare mate first,
                restrict the other to insert windows, rescue via
                unrestricted + fine-hash re-mapping when unconvincing
  map_single_read            (rmap.c:1228-1433): seed -> candidates ->
                two-pass DP (score-only, then banded with traceback)
  _score_cands  scoreRMAPCAND (rmap.c:588-788): full-matrix kernel for
                full-length reads in wide bands, banded-fast otherwise
  _align_full   alignRMAPCANDFull (rmap.c:790-928): dynamic min-score
                raising and band widening

Default knobs: TARGET_DEPTH=512, MAX_DEPTH=2048 (smalt.c:60-61),
edgelen=0 because the SIMD kernel is full-matrix (rmap.c:549-553),
SIMD eligibility qlen>=32 and band*48>qlen with a full-read segment
(rmap.c:714-718).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..seq import codec
from ..seq.io import Read
from ..seq.refset import RefSet
from ..index.table import KmerIndex, build_index
from ..seed import hitinfo as hi_mod
from ..seed import hitlist as hl_mod
from ..segment import collate as seg_mod
from ..align import core as ali_mod
from ..results.result import Result, ResultSet, ResultFilter
from ..results import pairs as pairs_mod

# smalt.c:57-89
SMALT_TARGET_DEPTH = 512
SMALT_MAX_DEPTH = 2048
SMALT_MAX_REFSEQ_NUM = 512

# rmap.c:49-99
HASH_MAXNHITS = 16 * 1024
EDGELEN_MAX = 500
MINLEN_QUERY_STRIPED = 32
BWSCAL_QLEN = 48
MAPSCORE_UNIQUE_MAPPED_1ST = 20
MAXNUM_PAIRS_TOTAL = 1028
FILTERIVALEXT = 30
MINFRACT_MAXSCOR_2ND = 0.8
FINEHASH_WORDLEN = 5
FINEHASH_SKIPSTEP = 1
FINEHASH_MAXKTUPPOS = 128 * 1024 * 1024
MINSCOR_BELOW_MAX_BEST = 0

# RMAP_FLAGS (rmap.h:53-65)
RMAPFLG_CMPLXW = 0x01
RMAPFLG_BEST = 0x02
RMAPFLG_SEQBYSEQ = 0x04
RMAPFLG_ALLPAIR = 0x08
RMAPFLG_PAIRED = 0x10
RMAPFLG_SENSITIVE = 0x20
RMAPFLG_NOSHRTINFO = 0x40
RMAPFLG_SPLIT = 0x80


class ShortSeq(Exception):
    pass


import os as _os
import sys as _sys

_TRACE_READ = _os.environ.get("SMALT_TRACE_READ")


def _trace(read, phase: str, msg: str) -> None:
    """Read-fate tracing (the RESULTS_TRACKER analogue, hashhit.h:46-48):
    set SMALT_TRACE_READ=<name substring> to follow named reads through
    seeding, collation, both DP passes and result assignment on stderr."""
    if _TRACE_READ and _TRACE_READ in read.sam_name:
        print(f"#TRACE {read.sam_name} [{phase}] {msg}", file=_sys.stderr)


@dataclass
class MapParams:
    ktuple_maxhit: int = 10000          # -c ncut (menu.c:603)
    min_cover_frac: float = 0.0         # -y/-c style min cover (tupcovmin)
    min_swatscor: Optional[int] = None  # None: derive ktup+nskip-1 from
                                        # the index; an explicit -m value
                                        # (even 0) is used verbatim
                                        # (smalt.c:608 MENUFLAG_MINSCOR)
    filter_minscor: int = 18            # output filter keeps the raw menu
                                        # default MENU_DEFAULTS_MINSCOR=18
                                        # (smalt.c:484 passes the menu value
                                        # to the filter BEFORE the engine
                                        # minimum is derived from the index)
    min_swatscor_below_max: int = 0     # -d scorediff (0 = best only)
    min_basq: int = 0
    insert_min: int = 0
    insert_max: int = 500
    pairtyp: int = pairs_mod.LIB_PAIREDEND
    rmapflg: int = RMAPFLG_BEST
    rsltouflg: int = (pairs_mod.RESULTFLG_BEST | pairs_mod.RESULTFLG_SINGLE |
                      pairs_mod.RESULTFLG_RANDSEL)
    target_depth: int = SMALT_TARGET_DEPTH
    max_depth: int = SMALT_MAX_DEPTH
    use_cplx: bool = False


@dataclass
class _Cand:
    qs: int
    qe: int
    rs: int
    re: int
    band_l: int
    band_r: int
    sqidx: int
    is_rev: bool
    swscor: int = 0
    scored: bool = False


class MapEngine:
    def __init__(self, refset: RefSet, index: KmerIndex, params: MapParams,
                 penalties=(1, -2, -4, -3)):
        self.refset = refset
        self.index = index
        self.params = params
        # native core reads these raw: pin dtypes/contiguity once
        refset.offsets = np.ascontiguousarray(refset.offsets, np.int64)
        refset.codes = np.ascontiguousarray(refset.codes, np.uint8)
        match, mismatch, gapopen, gapext = penalties
        self.matrix, self.gapopen, self.gapext = ali_mod.make_score_matrix(
            match, mismatch, gapopen, gapext)
        self.lam = ali_mod.matrix_lambda(self.matrix)
        if refset.nseq < SMALT_MAX_REFSEQ_NUM:
            params.rmapflg |= RMAPFLG_SEQBYSEQ
        if params.min_swatscor is None:
            params.min_swatscor = index.wordlen + index.nskip - 1
        self.filter = ResultFilter(params.filter_minscor,
                                   params.min_swatscor_below_max, 0.0)

    # ---------------- profiles ----------------

    def _profiles(self, read: Read):
        fwd = ali_mod.ScoreProfile.from_read(read.seq, self.matrix,
                                             self.gapopen, self.gapext, self.lam)
        rc = ali_mod.ScoreProfile.from_read(codec.revcomp_codes(read.seq),
                                            self.matrix, self.gapopen,
                                            self.gapext, self.lam)
        return fwd, rc

    # ---------------- hit info ----------------

    def _hitinfo(self, read: Read, idx: KmerIndex, short: bool,
                 seq_start=0, seq_end=0):
        try:
            if short:
                hf, hr = hi_mod.collect_hit_info_short_pair(
                    read.seq, read.qual, idx,
                    self.params.ktuple_maxhit, HASH_MAXNHITS,
                    self.params.min_basq)
            else:
                hf = hi_mod.collect_hit_info(read.seq, read.qual, False, idx,
                                             0, self.params.min_basq,
                                             seq_start, seq_end)
                hr = hi_mod.collect_hit_info(read.seq, read.qual, True, idx,
                                             0, self.params.min_basq,
                                             seq_start, seq_end)
        except hi_mod.ShortSeqError:
            raise ShortSeq()
        return hf, hr

    # ---------------- candidate collection ----------------

    @property
    def _seq_ivals(self) -> np.ndarray:
        """[nseq, 3] {start, end, seqidx} base intervals (seq-by-seq)."""
        iv = getattr(self, "_seq_ivals_cache", None)
        if iv is None:
            offs = self.refset.offsets
            n = self.refset.nseq
            iv = np.empty((n, 3), np.int64)
            iv[:, 0] = offs[:n]
            iv[:, 1] = offs[1 : n + 1]
            iv[:, 2] = np.arange(n)
            self._seq_ivals_cache = iv
        return iv

    def _collect_native(self, lib, hf, hr, idx, min_ktup, min_cover,
                        intervals) -> Optional[seg_mod.SegAliCands]:
        """Fused C path of _collect: one mc_collect_all call per strand."""
        import ctypes
        from ..seed.hitlist import _budget
        from ..native import GrowBuf
        p = self.params
        scr = getattr(self, "_collect_scr", None)
        if scr is None:
            scr = self._collect_scr = {
                "sqdat": GrowBuf(np.uint64, 8192),
                "qm": GrowBuf(np.uint8), "seed_sqo": GrowBuf(np.uint64),
                "seed_len": GrowBuf(np.int64), "seg_ix": GrowBuf(np.int64),
                "seg_nseed": GrowBuf(np.int64),
                "seg_cover": GrowBuf(np.int64),
                "hreg_idx": GrowBuf(np.int64), "hreg_num": GrowBuf(np.int64),
                "mask": GrowBuf(np.uint8), "rows10": GrowBuf(np.int64),
                "out11": GrowBuf(np.int64),
            }
        budget = _budget(hf.qlen)
        scr["sqdat"].ensure(budget)
        scr["qm"].ensure(hf.qlen)
        scr["mask"].ensure(hf.qlen)
        for k in ("seed_sqo", "seed_len", "seg_ix", "seg_nseed",
                  "seg_cover", "hreg_idx", "hreg_num"):
            scr[k].ensure(budget)
        scr["rows10"].ensure(budget * 10)
        scr["out11"].ensure(budget * 11)

        if intervals is not None:
            mode, use_short = 1, 0
            offs = self.refset.offsets
            iv = np.empty((max(len(intervals), 1), 3), np.int64)
            for n, (lo, hi_b, sx) in enumerate(intervals):
                o = int(offs[sx])
                iv[n] = (o + lo, o + hi_b + 1, sx)
            nivals = len(intervals)
        elif p.rmapflg & RMAPFLG_SEQBYSEQ:
            mode, use_short = 1, 1
            iv = self._seq_ivals
            nivals = len(iv)
        else:
            mode, use_short = 0, 0
            iv = np.zeros((1, 3), np.int64)
            nivals = 0

        sac = seg_mod.SegAliCands()
        sac.blank()
        sac.ktup, sac.nskip = idx.wordlen, idx.nskip
        maxcov = np.zeros(2, np.int64)
        row_parts = []
        _, sa, pa, _ = idx.addrs
        for hi in (hf, hr):
            n = lib.mc_collect_all(
                sa, pa,
                hi.qoffs.ctypes.data, hi.nhits.ctypes.data,
                hi.slot.ctypes.data, hi.sidx.ctypes.data,
                hi.n_seeds, hi.seed_rank,
                hi.qlen, hi.ktup, hi.nskip, 1 if hi.is_reverse else 0,
                mode, use_short, iv.ctypes.data, nivals,
                p.ktuple_maxhit, budget, min_ktup, min_cover,
                scr["sqdat"].addr, scr["qm"].addr,
                scr["seed_sqo"].addr, scr["seed_len"].addr,
                scr["seg_ix"].addr, scr["seg_nseed"].addr,
                scr["seg_cover"].addr,
                scr["hreg_idx"].addr, scr["hreg_num"].addr,
                scr["mask"].addr,
                scr["rows10"].addr, budget,
                scr["out11"].addr, budget,
                maxcov.ctypes.data)
            if n < 0:
                return None     # capacity overflow: unfused fallback
            out = scr["out11"].arr
            row_parts.append(out[: n * 11].reshape(n, 11).copy())
        sac.max_cover = int(maxcov[0])
        sac.max2nd_cover = int(maxcov[1])
        sac.rows_arr = (np.concatenate(row_parts) if row_parts
                        else np.zeros((0, 11), np.int64))
        return sac

    def _collect(self, hf, hr, idx: KmerIndex, min_ktup: int, min_cover: int,
                 intervals) -> seg_mod.SegAliCands:
        """fillRMAPBUFF (rmap.c:1153-1227)."""
        from ..native import get_lib
        lib = get_lib()
        if lib is not None:
            sac = self._collect_native(lib, hf, hr, idx, min_ktup,
                                       min_cover, intervals)
            if sac is not None:
                return sac
        sac = seg_mod.SegAliCands()
        sac.blank()
        p = self.params
        offs = self.refset.offsets
        for hi in (hf, hr):
            if intervals is not None:
                # collectHitsFromInterVal (rmap.c:438-492)
                for (lo, hi_b, sx) in intervals:
                    o = int(offs[sx])
                    hl = hl_mod.collect_hits_for_segment(
                        hi, o + lo, o + hi_b + 1, p.ktuple_maxhit, False, idx)
                    sgl = seg_mod.seg_lst_fill_hits(hl, min_ktup)
                    seg_mod.seg_cands_add_fast(sac, sgl, min_cover, sx)
            elif p.rmapflg & RMAPFLG_SEQBYSEQ:
                for s in range(self.refset.nseq):
                    hl = hl_mod.collect_hits_for_segment(
                        hi, int(offs[s]), int(offs[s + 1]),
                        p.ktuple_maxhit, True, idx)
                    sgl = seg_mod.seg_lst_fill_hits(hl, min_ktup)
                    seg_mod.seg_cands_add_fast(sac, sgl, min_cover, s)
            else:
                hl = hl_mod.collect_hits_using_cutoff(hi, p.ktuple_maxhit, idx)
                sgl = seg_mod.seg_lst_fill_hits(hl, min_ktup)
                seg_mod.seg_cands_add_fast(sac, sgl, min_cover,
                                           seg_mod.UNKNOWN_SEQIDX)
        return sac

    # ---------------- DP passes ----------------

    def _make_cand(self, sac, i, qlen) -> Tuple[_Cand, int, np.ndarray]:
        """makeRMAPCANDfromSegment (rmap.c:535-587); edgelen=0 (SIMD build)."""
        w = seg_mod.calc_segment_offsets(sac, i, qlen, self.refset.offsets,
                                         edgelen=0)
        if w.seqidx == seg_mod.UNKNOWN_SEQIDX:
            subj = self.refset.fetch_global(w.rs, w.re)
        else:
            subj = self.refset.fetch_by_seq(w.seqidx, w.rs, w.re - w.rs + 1)
        c = _Cand(qs=w.qs, qe=w.qe, rs=w.rs, re=w.re,
                  band_l=w.band_l, band_r=w.band_r, sqidx=w.seqidx,
                  is_rev=bool(w.flag & seg_mod.FLAG_REVERSE))
        return c, w.cover, subj

    def _score_cands_native(self, lib, sac, prof_f, prof_r, qlen,
                            rmapflg, deficit, nskip):
        """Fused C pass 1 (mc_score_cands)."""
        from ..native import GrowBuf
        n_sort = sac.n_sort
        scr = getattr(self, "_score_scr", None)
        if scr is None:
            scr = self._score_scr = {
                "out": GrowBuf(np.int64), "H": GrowBuf(np.int32),
                "E": GrowBuf(np.int32),
                "max": np.zeros(3, np.int64),
            }
        scr["out"].ensure(max(n_sort, 1) * 10)
        scr["H"].ensure(qlen + 1)
        scr["E"].ensure(qlen + 1)
        rows = sac.rows_arr
        offsets = self.refset.offsets
        rc = lib.mc_score_cands(
            rows.ctypes.data, sac.sort_idx.ctypes.data, n_sort,
            sac.ktup, nskip,
            self.refset.codes.ctypes.data, offsets.ctypes.data,
            self.refset.nseq, qlen,
            prof_f.W_addr, prof_r.W_addr,
            prof_f.gap_init_pos, prof_f.gap_ext_pos,
            prof_f.match_avg, prof_f.mismatch_avg,
            1 if (rmapflg & RMAPFLG_BEST) else 0,
            deficit[0], deficit[1],
            scr["H"].addr, scr["E"].addr,
            scr["out"].addr, scr["max"].ctypes.data)
        if rc != 0:
            raise AssertionError("candidate window geometry")
        max1, max2, n_out = (int(v) for v in scr["max"])
        out = scr["out"].arr
        cands = []
        for r in range(n_out):
            o = r * 10
            cands.append(_Cand(
                qs=int(out[o]), qe=int(out[o + 1]), rs=int(out[o + 2]),
                re=int(out[o + 3]), band_l=int(out[o + 4]),
                band_r=int(out[o + 5]), sqidx=int(out[o + 6]),
                is_rev=bool(out[o + 7]), swscor=int(out[o + 8]),
                scored=True))
        return cands, max1, max2

    def _score_cands(self, sac, prof_f, prof_r, qlen, rmapflg,
                     deficit, nskip) -> Tuple[List[_Cand], int, int]:
        """scoreRMAPCAND (rmap.c:588-788).  nskip is the active index's
        skip step (differs from the main index during fine-hash rescue)."""
        from ..native import get_lib
        lib = get_lib()
        if lib is not None and getattr(sac, "rows_arr", None) is not None \
                and len(sac.sort_idx):
            return self._score_cands_native(lib, sac, prof_f, prof_r, qlen,
                                            rmapflg, deficit, nskip)
        n_candseg = sac.n_sort
        mmscordiff = prof_f.match_avg - prof_f.mismatch_avg
        max1 = max2 = 0
        min_cover = 0
        max_cover = 0
        cands: List[_Cand] = []
        for i in range(n_candseg):
            c, cover, subj = self._make_cand(sac, i, qlen)
            prof = prof_r if c.is_rev else prof_f
            is_simd = (qlen >= MINLEN_QUERY_STRIPED and
                       (c.band_r - c.band_l) * BWSCAL_QLEN > qlen and
                       c.qs == 0 and c.qe >= qlen - 1)
            if is_simd:
                c.swscor = ali_mod.sw_full_score(prof, subj)
            else:
                c.swscor = ali_mod.align_band_fast(
                    prof, subj, c.band_l, c.band_r, c.qs, c.qe,
                    0, len(subj) - 1)
            c.scored = True
            cdf = deficit[1 if c.is_rev else 0]
            if (rmapflg & RMAPFLG_BEST) and cover + cdf < min_cover:
                # reference truncates the candidate array at the break index
                # (ARRLEN(*csr) = i, rmap.c:783), excluding this candidate
                # from pass 2 and from the running maxima.
                break
            cands.append(c)
            if c.swscor > max2:
                if c.swscor > max1:
                    max2 = max1
                    max1 = c.swscor
                    if cover + cdf > max_cover:
                        max_cover = cover - cdf if cover > cdf else 0
                else:
                    max2 = c.swscor
                dcov = ((max1 - max2) // mmscordiff + 1) * nskip
                if dcov + cdf + min_cover < max_cover:
                    min_cover = max_cover - dcov
        return cands, max1, max2

    def _align_full(self, rs: ResultSet, cands: List[_Cand],
                    prof_f, prof_r, min_swatscor, scorlen_min,
                    bandwidth_min, rmapflg):
        """alignRMAPCANDFull (rmap.c:790-928)."""
        for c in cands:
            if c.scored and c.swscor < min_swatscor:
                continue
            if c.sqidx == seg_mod.UNKNOWN_SEQIDX:
                subj = self.refset.fetch_global(c.rs, c.re)
            else:
                subj = self.refset.fetch_by_seq(c.sqidx, c.rs, c.re - c.rs + 1)
            prof = prof_r if c.is_rev else prof_f
            if rmapflg & RMAPFLG_BEST:
                if rs.swatscor_2ndmax > min_swatscor:
                    min_swatscor = rs.swatscor_2ndmax
            bw = c.band_r - c.band_l
            if bw < bandwidth_min:
                ext = (bandwidth_min - bw + 1) // 2
                band_l = c.band_l - ext
                band_r = c.band_r + ext
            else:
                band_l, band_r = c.band_l, c.band_r
            ali = ali_mod.align_band_recursive(
                prof, subj, band_l, band_r, c.qs, c.qe, 0, len(subj) - 1,
                min_swatscor, scorlen_min, use_cplx=self.params.use_cplx)
            rs.add_from_ali(ali, c.rs, 0, prof.qlen,
                            -1 if c.sqidx == seg_mod.UNKNOWN_SEQIDX else c.sqidx,
                            c.is_rev)

    # ---------------- mapSingleRead ----------------

    def map_single_read(self, rs: ResultSet, hf, hr, prof_f, prof_r,
                        read: Read, min_cover: int, min_swatscor: int,
                        min_swatscor_below_max: int, rmapflg: int,
                        idx: Optional[KmerIndex] = None, intervals=None):
        """mapSingleRead (rmap.c:1228-1433)."""
        if idx is None:
            idx = self.index
        p = self.params
        ktup, nskip = idx.wordlen, idx.nskip
        scorlen_min = ktup + nskip
        matchscor = prof_f.match_avg
        mismatchdiff = matchscor - prof_f.mismatch_avg
        qlen = len(read.seq)
        if qlen < ktup:
            raise ShortSeq()
        maxscor_perfect = qlen * matchscor
        # min cover -> min ktup (calcMinKtup, rmap.c:240-247)
        if min_cover >= ktup + nskip:
            min_ktup = (min_cover - ktup) // nskip
        else:
            min_ktup = 1
        min_cover = (min_ktup - 1) * nskip + ktup

        if min_swatscor_below_max < 0:
            mincov_below_max = qlen - 1
        else:
            mincov_below_max = (min_swatscor_below_max // mismatchdiff) * nskip
            if mincov_below_max < ktup or (rmapflg & RMAPFLG_BEST):
                mincov_below_max = ktup + 2 * (nskip - 1)

        if _TRACE_READ:
            _trace(read, "seed", f"seeds F={hf.n_seeds} R={hr.n_seeds} "
                   f"rankF={hf.seed_rank} rankR={hr.seed_rank} "
                   f"min_ktup={min_ktup} min_cover={min_cover}")
        sac = self._collect(hf, hr, idx, min_ktup, min_cover, intervals)

        deficit = (hi_mod.cover_deficit(hf), hi_mod.cover_deficit(hr))
        seg_mod.seg_cands_stats(sac, mincov_below_max, deficit[0], deficit[1],
                                p.target_depth, p.max_depth,
                                bool(rmapflg & RMAPFLG_SENSITIVE))
        if _TRACE_READ:
            _trace(read, "collate", f"cands={len(sac.cands)} "
                   f"selected={sac.n_sort} mincover_ok={sac.n_mincover} "
                   f"maxcov={sac.max_cover}/{sac.max2nd_cover} "
                   f"deficit={deficit}")

        nseg = sac.n_sort
        nseg_tot = sac.n_mincover
        totF, rankF = hi_mod.hit_numbers(hf)
        totR, rankR = hi_mod.hit_numbers(hr)
        rs.set_alignment_stats(nseg, nseg_tot, p.max_depth,
                               rankF + rankR, totF + totR)

        cands, max1, max2 = self._score_cands(sac, prof_f, prof_r, qlen,
                                              rmapflg, deficit, nskip)
        if _TRACE_READ:
            _trace(read, "pass1", f"scored={len(cands)} "
                   f"max1={max1} max2={max2}")
        if max1 < 1:
            return
        bandwidth_min = (maxscor_perfect - max1) // (-prof_f.gap_ext)

        if min_swatscor_below_max >= max1:
            min_swatscor_below_max = max1
        if min_swatscor > max2 > 0:
            min_swatscor = max2
        if min_swatscor_below_max >= 0:
            minswc = max2 if max2 > 0 else max1
            if rmapflg & RMAPFLG_BEST:
                if minswc > min_swatscor:
                    min_swatscor = minswc
            elif min_swatscor + min_swatscor_below_max < max1:
                min_swatscor = max1 - min_swatscor_below_max
                if min_swatscor > minswc:
                    min_swatscor = minswc
        if min_swatscor > scorlen_min * matchscor and matchscor > 0:
            scorlen_min = min_swatscor // matchscor

        self._align_full(rs, cands, prof_f, prof_r, min_swatscor,
                         scorlen_min, bandwidth_min, rmapflg)
        rs.sort_and_assign(read.qual, qlen,
                           search_split=bool(rmapflg & RMAPFLG_SPLIT),
                           refset=self.refset, prof_f=prof_f, prof_r=prof_r)
        if _TRACE_READ:
            tops = [(r.swatscor, r.mapscor, r.sidx, r.s_start, r.s_end,
                     r.q_start, r.q_end) for r in rs.sortr[:3]]
            _trace(read, "pass2", f"results={len(rs.results)} "
                   f"min_swatscor={min_swatscor} band_min={bandwidth_min} "
                   f"top(sw,mapq,sidx,s,e,qs,qe)={tops}")

    # ---------------- single-read entry ----------------

    def rmap_single(self, read: Read) -> ResultSet:
        """rmapSingle (rmap.c:1648-1743)."""
        p = self.params
        rs = ResultSet()
        prof_f, prof_r = self._profiles(read)
        try:
            hf, hr = self._hitinfo(read, self.index,
                                   short=not (p.rmapflg & RMAPFLG_NOSHRTINFO))
        except ShortSeq:
            return rs
        min_cover = self._covermin(read)
        try:
            self.map_single_read(rs, hf, hr, prof_f, prof_r, read,
                                 min_cover, p.min_swatscor,
                                 p.min_swatscor_below_max,
                                 p.rmapflg & ~RMAPFLG_ALLPAIR)
        except ShortSeq:
            return rs
        if p.rmapflg & RMAPFLG_SPLIT:
            self._map_secondary(rs, read, prof_f, prof_r, min_cover)
        rs.filter_results(self.filter, len(read.seq))
        return rs

    def _covermin(self, read: Read) -> int:
        """processMapArgs cover threshold (smalt.c:1115-1127)."""
        t = self.params.min_cover_frac
        if t < 1.01:
            c = int(t * len(read.seq))
            return min(c, len(read.seq))
        return int(t)

    def _map_secondary(self, rs: ResultSet, read: Read, prof_f, prof_r,
                       min_cover: int):
        """mapSecondary (rmap.c:1435-1505)."""
        p = self.params
        ktup, nskip = self.index.wordlen, self.index.nskip
        qlen = len(read.seq)
        if not rs.segsrtr or rs.qsegno < 1:
            return
        top = rs._seg_slice(0)[0] if rs.segnor else None
        if top is None:
            return
        qs, qe = top.q_start, top.q_end
        if qs + qe > qlen:
            qe = qs - 2 if qs > 1 else 0
            qs = 0
        else:
            qs = qe
            qe = qlen - 1
        if qs + ktup + nskip > qe + 1:
            return
        try:
            hf = hi_mod.collect_hit_info(read.seq, read.qual, False,
                                         self.index, 0, p.min_basq, qs, qe)
            hr = hi_mod.collect_hit_info(read.seq, read.qual, True,
                                         self.index, 0, p.min_basq, qs, qe)
            self.map_single_read(rs, hf, hr, prof_f, prof_r, read, min_cover,
                                 p.min_swatscor, p.min_swatscor_below_max,
                                 p.rmapflg)
        except ShortSeq:
            return

    # ---------------- paired-read entry ----------------

    # ---------------- native single-read mapping (C fast-lane) --------

    def _native_pair_ctx(self):
        """Cached context for the C single-read mapper (fl_single_rs),
        None when the mode is uncovered or the lane is disabled."""
        import os
        ctx = getattr(self, "_npctx", None)
        if ctx is not None:
            return ctx or None
        if os.environ.get("SMALT_TPU_NO_FASTLANE") or \
                os.environ.get("SMALT_TPU_NO_PAIRNATIVE"):
            self._npctx = False
            return None
        from ..native import get_lib, GrowBuf
        lib = get_lib()
        if lib is None or not hasattr(lib, "fl_single_rs"):
            self._npctx = False
            return None
        p = self.params
        need = RMAPFLG_BEST | RMAPFLG_SEQBYSEQ
        block = RMAPFLG_SPLIT | RMAPFLG_NOSHRTINFO
        if (p.rmapflg & need) != need or (p.rmapflg & block):
            self._npctx = False
            return None
        wa, sa, pa, ta = self.index.addrs
        from ..align import core as ali_mod
        ma, mm = ali_mod.avg_penalties(self.matrix)
        ctx = {
            "lib": lib,
            "idx": (wa, sa, self.index.nwords, ta, pa,
                    self.index.wordlen, self.index.nskip),
            "matrix": np.ascontiguousarray(self.matrix, np.int32),
            "ivals": np.ascontiguousarray(self._seq_ivals, np.int64),
            "offsets": np.ascontiguousarray(self.refset.offsets, np.int64),
            "refcodes": np.ascontiguousarray(self.refset.codes, np.uint8),
            "avgs": (ma, mm),
            "rows": GrowBuf(np.int64, 4096 * 12),
            "diff": GrowBuf(np.uint8, 1 << 20),
            "sortr": GrowBuf(np.int64, 4096),
            "seg": GrowBuf(np.int64, 8192),
            "stats": np.zeros(12, np.int64),
            "scratch": lib.fl_scratch_new(2048),
        }
        self._npctx = ctx
        return ctx

    def _map_single_native(self, rs: ResultSet, read: Read,
                           min_swatscor: int, min_swatscor_below_max: int,
                           intervals=None):
        """C path of map_single_read: fills `rs` from fl_single_rs.
        Returns the cutoff-limited hit count, or None when the native
        lane is unavailable/errored (caller uses the Python oracle)."""
        ctx = self._native_pair_ctx()
        if ctx is None:
            return None
        lib = ctx["lib"]
        p = self.params
        wa, sa, nwords, ta, pa = ctx["idx"][:5]
        seq = read.seq
        if seq.dtype != np.uint8 or not seq.flags.c_contiguous:
            seq = np.ascontiguousarray(seq, np.uint8)
        qual = read.qual
        qptr = None
        qarr = None
        if qual is not None:
            if len(qual) != len(seq):
                return None
            qarr = np.frombuffer(qual, np.uint8)
            qptr = qarr.ctypes.data
        iv_ptr, niv = None, 0
        iv_arr = None
        if intervals is not None:
            offs = self.refset.offsets
            iv_arr = np.empty((max(len(intervals), 1), 3), np.int64)
            for n, (lo, hi_b, sx) in enumerate(intervals):
                o = int(offs[sx])
                iv_arr[n] = (o + lo, o + hi_b + 1, sx)
            iv_ptr = iv_arr.ctypes.data
            niv = len(intervals)
        stats = ctx["stats"]
        n = lib.fl_single_rs(
            wa, sa, nwords, ta, pa,
            self.index.wordlen, self.index.nskip,
            ctx["refcodes"].ctypes.data, ctx["offsets"].ctypes.data,
            self.refset.nseq, ctx["ivals"].ctypes.data,
            iv_ptr, niv,
            ctx["matrix"].ctypes.data, -self.gapopen, -self.gapext,
            ctx["avgs"][0], ctx["avgs"][1],
            p.ktuple_maxhit, HASH_MAXNHITS, p.min_cover_frac,
            min_swatscor, min_swatscor_below_max, p.min_basq,
            p.target_depth, p.max_depth,
            (p.rmapflg | RMAPFLG_PAIRED) & ~RMAPFLG_ALLPAIR,
            seq.ctypes.data, qptr, len(seq),
            ctx["rows"].addr, len(ctx["rows"].arr) // 12,
            ctx["diff"].addr, len(ctx["diff"].arr),
            ctx["sortr"].addr, ctx["seg"].addr, stats.ctypes.data,
            ctx["scratch"], float(self.lam))
        if n < 0:
            return None
        rows = ctx["rows"].arr
        diff = ctx["diff"].arr
        results = []
        for i in range(int(n)):
            o = rows[i * 12 : (i + 1) * 12]
            r = Result(q_start=int(o[0]), q_end=int(o[1]),
                       s_start=int(o[2]), s_end=int(o[3]),
                       sidx=int(o[4]), swatscor=int(o[5]),
                       mapscor=int(o[6]), status=int(o[7]),
                       diff=diff[int(o[8]) : int(o[8]) + int(o[9])]
                       .tolist(),
                       qsegx=int(o[10]), swrank=int(o[11]))
            results.append(r)
        rs.results = results
        rs.sortr = [results[int(x)]
                    for x in ctx["sortr"].arr[: int(stats[7])]]
        qsegno = int(stats[8])
        seg = ctx["seg"].arr
        rs.qsegno = qsegno
        rs.segnor = [int(x) for x in seg[: qsegno + 1]] if qsegno else []
        nseg = int(stats[9])
        rs.segsrtr = [results[int(seg[qsegno + 1 + j])]
                      for j in range(nseg)]
        rs.swatscor_max = int(stats[0])
        rs.swatscor_2ndmax = int(stats[1])
        rs.n_ali_done = int(stats[2])
        rs.n_ali_tot = int(stats[3])
        rs.n_ali_max = int(stats[4])
        rs.n_hits_used = int(stats[5])
        rs.n_hits_tot = int(stats[6])
        # the C lane skips mapq->probability propagation (irrelevant for
        # single-end output); the pair probability model reads
        # Result.prob, so run it here (results.c:1354-1413)
        for qsegx in range(rs.qsegno):
            rs._propagate_prob(qsegx)
        if stats[10]:
            raise ShortSeq()
        return int(stats[11])

    def _rmap_pair_native(self, read: Read, mate: Read):
        """rmapPair fast path: hit-count probes + the two single-read
        mappings run in C (fl_hit_count / fl_single_rs); interval
        setup and the pair search stay in Python.  Covers the COMMON
        flow (rare mate unrestricted, other mate restricted to the
        implied windows, restriction accepted); any branch that would
        append/remap result sets (no proper pair, weak first mapping,
        fine-rehash rescue) returns None and the caller reruns the
        pure-Python oracle for the whole pair — nothing (including the
        drand48 stream) has been consumed by then, so output is
        byte-identical either way."""
        ctx = self._native_pair_ctx()
        if ctx is None:
            return None
        lib = ctx["lib"]
        p = self.params
        rsr = ResultSet()
        rsm = ResultSet()
        rpairs = pairs_mod.ResultPairs()
        pairflg = pairs_mod.PAIRFLG_PAIRED
        wa, sa, nwords, ta, pa = ctx["idx"][:5]

        def probe(rd):
            seq = rd.seq
            if seq.dtype != np.uint8 or not seq.flags.c_contiguous:
                seq = np.ascontiguousarray(seq, np.uint8)
            q = rd.qual
            qarr = np.frombuffer(q, np.uint8) if q is not None else None
            qptr = qarr.ctypes.data if qarr is not None else None
            return lib.fl_hit_count(
                wa, sa, nwords, ta, pa,
                self.index.wordlen, self.index.nskip,
                p.ktuple_maxhit, HASH_MAXNHITS, p.min_basq,
                seq.ctypes.data, qptr, len(seq), ctx["scratch"])

        nhit_read = probe(read)
        nhit_mate = probe(mate)
        err_read = nhit_read < 0
        err_mate = nhit_mate < 0
        if err_read and err_mate:
            return rsr, rsm, rpairs, pairflg
        if err_read or err_mate:
            target, rs_t = (mate, rsm) if err_read else (read, rsr)
            try:
                if self._map_single_native(rs_t, target, p.min_swatscor,
                                           MINSCOR_BELOW_MAX_BEST) is None:
                    return None
            except ShortSeq:
                pass
            return rsr, rsm, rpairs, pairflg

        if nhit_read > nhit_mate:
            pairflg |= pairs_mod.PAIRFLG_RAREMATE
            rare_is_mate = True
            read1, read2 = mate, read
            rs1, rs2 = rsm, rsr
        else:
            rare_is_mate = False
            read1, read2 = read, mate
            rs1, rs2 = rsr, rsm

        try:
            if self._map_single_native(rs1, read1, p.min_swatscor,
                                       MINSCOR_BELOW_MAX_BEST) is None:
                return None
        except ShortSeq:
            return None          # probe said ok; let the oracle decide
        mapq1, swscor1 = rs1.get_mapping_score()

        ivr = self._intervals_from_results(read1, read2, rs1)
        try:
            if self._map_single_native(rs2, read2, p.min_swatscor,
                                       MINSCOR_BELOW_MAX_BEST,
                                       intervals=ivr) is None:
                return None
        except ShortSeq:
            return None
        rpairs.find_proper_pairs(p.insert_min, p.insert_max,
                                 MAXNUM_PAIRS_TOTAL, 0, p.pairtyp,
                                 rsr, rsm)
        _, swscor2_restricted = rs2.get_mapping_score()

        if ((p.rmapflg & RMAPFLG_ALLPAIR) or rpairs.n_proper < 1 or
                mapq1 < MAPSCORE_UNIQUE_MAPPED_1ST or
                not self._above_fract_max(swscor2_restricted, swscor1,
                                          read2, read1)):
            return None          # remap/rescue branch: run the oracle

        pairflg |= (pairs_mod.PAIRFLG_RESTRICT_1st if rare_is_mate
                    else pairs_mod.PAIRFLG_RESTRICT_2nd)
        rpairs.find_pairs(pairflg, p.pairtyp, p.insert_min, p.insert_max,
                          rsr, rsm)
        rsr.filter_results(self.filter, len(read.seq))
        rsm.filter_results(self.filter, len(mate.seq))
        return rsr, rsm, rpairs, pairflg

    def rmap_pair(self, read: Read, mate: Read):
        """rmapPair (rmap.c:1744-2112).
        Returns (rs_read, rs_mate, ResultPairs, pairflg)."""
        out = None
        if self._native_pair_ctx() is not None:
            out = self._rmap_pair_native(read, mate)
        if out is not None:
            return out
        return self._rmap_pair_py(read, mate)

    def _rmap_pair_py(self, read: Read, mate: Read):
        """Pure-Python rmapPair — the oracle the native path falls
        back to and is differential-tested against."""
        p = self.params
        rsr = ResultSet()
        rsm = ResultSet()
        rpairs = pairs_mod.ResultPairs()
        pairflg = pairs_mod.PAIRFLG_PAIRED
        prof_rf, prof_rr = self._profiles(read)
        prof_mf, prof_mr = self._profiles(mate)
        rmapflg = p.rmapflg | RMAPFLG_PAIRED
        short = not (rmapflg & RMAPFLG_NOSHRTINFO)
        err_read = err_mate = False
        hfr = hrr = hfm = hrm = None
        try:
            hfr, hrr = self._hitinfo(read, self.index, short)
        except ShortSeq:
            err_read = True
        try:
            hfm, hrm = self._hitinfo(mate, self.index, short)
        except ShortSeq:
            err_mate = True
        if err_read and err_mate:
            return rsr, rsm, rpairs, pairflg
        mincov_read = self._covermin(read)
        mincov_mate = self._covermin(mate)
        if err_read or err_mate:
            # The reference does NOT return after the one-sided-ShortSeq
            # single mapping (rmap.c:1836-2110): the good mate's results
            # flow through the remaining pair logic — a restricted pass
            # over the errored mate's (empty) intervals, a blank +
            # unrestricted remap (output-equivalent to this one
            # unrestricted map; drand48 is only consumed at report-time
            # selection), the split-mode secondary pass, findPairs, and
            # crucially resultSetFilterResults.  The early return this
            # replaces skipped the OUTPUT FILTER, whose default
            # threshold is the raw menu constant 18 while the engine
            # maps down to ktup+nskip-1 (smalt.c:490 sets the filter
            # before smalt.c:608 lowers the engine default), so
            # sub-threshold mappings leaked into the report as mapped
            # records the reference suppresses
            # (tests/test_golden_sam.py::test_golden_shortmate_pairs).
            if err_read:
                self.map_single_read(rsm, hfm, hrm, prof_mf, prof_mr,
                                     mate, mincov_mate, p.min_swatscor,
                                     MINSCOR_BELOW_MAX_BEST, rmapflg)
            else:
                self.map_single_read(rsr, hfr, hrr, prof_rf, prof_rr,
                                     read, mincov_read, p.min_swatscor,
                                     MINSCOR_BELOW_MAX_BEST, rmapflg)
            if rmapflg & RMAPFLG_SPLIT:
                self._map_secondary(rsr, read, prof_rf, prof_rr,
                                    mincov_read)
                self._map_secondary(rsm, mate, prof_mf, prof_mr,
                                    mincov_mate)
            rpairs.find_pairs(pairflg, p.pairtyp, p.insert_min,
                              p.insert_max, rsr, rsm)
            rsr.filter_results(self.filter, len(read.seq))
            rsm.filter_results(self.filter, len(mate.seq))
            return rsr, rsm, rpairs, pairflg

        nhit_read = (hi_mod.total_hits(hfr, p.ktuple_maxhit) +
                     hi_mod.total_hits(hrr, p.ktuple_maxhit))
        nhit_mate = (hi_mod.total_hits(hfm, p.ktuple_maxhit) +
                     hi_mod.total_hits(hrm, p.ktuple_maxhit))
        if nhit_read > nhit_mate:
            pairflg |= pairs_mod.PAIRFLG_RAREMATE
            rare_is_mate = True
            read1, read2 = mate, read
            h1, h2 = (hfm, hrm), (hfr, hrr)
            p1, p2 = (prof_mf, prof_mr), (prof_rf, prof_rr)
            rs1, rs2 = rsm, rsr
            mc1, mc2 = mincov_mate, mincov_read
        else:
            rare_is_mate = False
            read1, read2 = read, mate
            h1, h2 = (hfr, hrr), (hfm, hrm)
            p1, p2 = (prof_rf, prof_rr), (prof_mf, prof_mr)
            rs1, rs2 = rsr, rsm
            mc1, mc2 = mincov_read, mincov_mate

        # the first two mappings start from BLANK result sets, where the
        # C single-read stage is interchangeable with the Python one —
        # the oracle (reached on native-path fallback) only keeps the
        # append/remap/fine branches in Python
        def _map_blank(rs, rd, minsw, intervals=None):
            if self._native_pair_ctx() is not None:
                try:
                    if self._map_single_native(
                            rs, rd, minsw, MINSCOR_BELOW_MAX_BEST,
                            intervals=intervals) is not None:
                        return
                except ShortSeq:
                    return
                rs.blank()
            hh = h1 if rd is read1 else h2
            pp = p1 if rd is read1 else p2
            mc = mc1 if rd is read1 else mc2
            self.map_single_read(rs, hh[0], hh[1], pp[0], pp[1], rd, mc,
                                 minsw, MINSCOR_BELOW_MAX_BEST, rmapflg,
                                 intervals=intervals)

        _map_blank(rs1, read1, p.min_swatscor)
        mapq1, swscor1 = rs1.get_mapping_score()

        ivr = self._intervals_from_results(read1, read2, rs1)
        _map_blank(rs2, read2, p.min_swatscor, intervals=ivr)
        rpairs.find_proper_pairs(p.insert_min, p.insert_max,
                                 MAXNUM_PAIRS_TOTAL, 0, p.pairtyp, rsr, rsm)
        _, swscor2_restricted = rs2.get_mapping_score()
        n_proper = rpairs.n_proper

        if ((rmapflg & RMAPFLG_ALLPAIR) or n_proper < 1 or
                mapq1 < MAPSCORE_UNIQUE_MAPPED_1ST or
                not self._above_fract_max(swscor2_restricted, swscor1,
                                          read2, read1)):
            if n_proper < 1:
                rs2.blank()
            self.map_single_read(rs2, h2[0], h2[1], p2[0], p2[1], read2, mc2,
                                 p.min_swatscor, MINSCOR_BELOW_MAX_BEST,
                                 rmapflg)
            mapq2, swscor2 = rs2.get_mapping_score()
            if (mapq2 > MAPSCORE_UNIQUE_MAPPED_1ST or
                    swscor2 > swscor2_restricted or swscor2 > swscor1):
                swscor1_2ndbest = rs1.swatscor_2ndmax
                ivr1 = self._intervals_from_results(read2, read1, rs2)
                fine = self._fine_index(ivr1)
                min_sw1 = swscor1_2ndbest  # passed verbatim (rmap.c:2031)
                if fine is not None and self.index.wordlen <= len(read1.seq):
                    try:
                        hf1 = hi_mod.collect_hit_info(read1.seq, read1.qual,
                                                      False, fine, 0, p.min_basq)
                        hr1 = hi_mod.collect_hit_info(read1.seq, read1.qual,
                                                      True, fine, 0, p.min_basq)
                        self.map_single_read(rs1, hf1, hr1, p1[0], p1[1],
                                             read1, mc1, min_sw1,
                                             MINSCOR_BELOW_MAX_BEST, rmapflg,
                                             idx=fine, intervals=ivr1)
                    except ShortSeq:
                        pass
                else:
                    self.map_single_read(rs1, h1[0], h1[1], p1[0], p1[1],
                                         read1, mc1, min_sw1,
                                         MINSCOR_BELOW_MAX_BEST, rmapflg,
                                         intervals=ivr1)
        else:
            pairflg |= (pairs_mod.PAIRFLG_RESTRICT_1st if rare_is_mate
                        else pairs_mod.PAIRFLG_RESTRICT_2nd)

        if rmapflg & RMAPFLG_SPLIT:
            self._map_secondary(rsr, read, prof_rf, prof_rr, mincov_read)
            self._map_secondary(rsm, mate, prof_mf, prof_mr, mincov_mate)

        rpairs.find_pairs(pairflg, p.pairtyp, p.insert_min, p.insert_max,
                          rsr, rsm)
        rsr.filter_results(self.filter, len(read.seq))
        rsm.filter_results(self.filter, len(mate.seq))
        return rsr, rsm, rpairs, pairflg

    def _above_fract_max(self, scor_read, scor_mate, readp, matep) -> bool:
        """scorIsAboveFractMax (rmap.c:176-186)."""
        rlen = len(readp.seq)
        mlen = len(matep.seq)
        return scor_read >= scor_mate * rlen * MINFRACT_MAXSCOR_2ND / mlen

    def _intervals_from_results(self, readp: Read, matep: Read,
                                rs: ResultSet):
        """setupInterValFromResultSet + interValPrune (rmap.c:354-436)."""
        p = self.params
        ktup = self.index.wordlen
        readlen = len(readp.seq)
        matelen = len(matep.seq)
        delta = matelen * FILTERIVALEXT // 100
        dmin, dmax = p.insert_min, p.insert_max
        _, n, _ = rs.get_scor_stats()
        ivr = []
        offs = self.refset.offsets
        for i in range(min(n, len(rs.sortr))):
            rp = rs.sortr[i]
            if rp.sidx < 0 or rp.sidx >= self.refset.nseq:
                raise AssertionError("interval setup needs seq indices")
            rlen = self.refset.seq_len(rp.sidx)

            def adj(t):
                if t >= rlen:
                    t = rlen - 1
                if t < 1:
                    t = 0
                return t

            lo = adj(rp.s_end + readlen - rp.q_end - dmax)
            hi = adj(rp.s_end + readlen + matelen + delta - rp.q_end - dmin - ktup)
            if lo <= hi:
                ivr.append((lo, hi, rp.sidx))
            lo = adj(rp.s_start - rp.q_start + dmin - matelen)
            hi = adj(rp.s_start - rp.q_start + dmax - ktup + delta)
            if lo <= hi:
                ivr.append((lo, hi, rp.sidx))
        # interValPrune (interval.c): sort by (sx, lo) and merge overlaps
        ivr.sort(key=lambda t: (t[2], t[0]))
        merged = []
        for iv in ivr:
            if merged and merged[-1][2] == iv[2] and iv[0] <= merged[-1][1]:
                if iv[1] > merged[-1][1]:
                    merged[-1] = (merged[-1][0], iv[1], iv[2])
            else:
                merged.append(list(iv) if False else iv)
                merged[-1] = iv
        return merged

    def _fine_index(self, intervals) -> Optional[KmerIndex]:
        """setupFineHashTable (rmap.c:495-517): on-the-fly fine index of the
        mate windows, stride auto-raised to fit FINEHASH_MAXKTUPPOS."""
        if not intervals:
            return None
        nskip = FINEHASH_SKIPSTEP
        total = sum(hi - lo + 1 for (lo, hi, _) in intervals)
        if total // nskip > FINEHASH_MAXKTUPPOS:
            s = total // FINEHASH_MAXKTUPPOS + 1
            if s > self.index.wordlen or s < nskip:
                return None
            nskip = s
        return build_index(self.refset, FINEHASH_WORDLEN, nskip,
                           restrict=[(lo, hi, sx) for (lo, hi, sx) in intervals])


