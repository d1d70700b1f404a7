"""Read-pair enumeration, classification and probability model.

Replicates resultpairs.c: insert-size/orientation classification per
library type (testProperPair, resultpairs.c:135-186), the fast proper-
pair search over sorted offset intervals (resultpairs.c:445-560,
1162-1216), full pair enumeration (resultpairs.c:1116-1160), the pair
probability model P(a,b) = Pa*Pb*Iab with insert-histogram likelihood
(assignProbabilityToPairs, resultpairs.c:753-826), pair selection with
marginal per-mate mapping qualities (scorePairsSimple,
resultpairs.c:828-952), and report feeding (resultpairs.c:1008-1311).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .. import rand
from .result import (Result, ResultSet, RSLTFLAG_REVERSE, RSLTFLAG_SELECT,
                     RSLTFLAG_SINGLE, RSLTFLAG_NOOUTPUT,
                     convert_prob_to_mapscor)
from .insert import InsHist
from ..report.report import Report, REPMATEFLG, REPPAIR

# library types (resultpairs.h:67-85)
LIB_PAIREDALL = 0
LIB_PAIREDEND = 1
LIB_MATEPAIR = 2
LIB_SAMESTRAND = 3

# pair map flags (results.h)
PMF_REVERSE_1st = 0x01
PMF_REVERSE_2nd = 0x02
PMF_LEFTMOST2nd = 0x04
PMF_SAMECONTIG = 0x08
PMF_NOCONTIG = 0x10

# mate map flags (resultpairs.c MAP_FLAGS)
MAPFLG_WITHIN = 0x01
MAPFLG_PROPER = 0x02
MAPFLG_PAIRED = 0x04
MAPFLG_CONTIG = 0x08
MAPFLG_MULT1ST = 0x10
MAPFLG_MULT2ND = 0x20

# pair flags (resultpairs.h RSLTPAIR_FLAGS)
PAIRFLG_PAIRED = 0x01
PAIRFLG_RAREMATE = 0x02
PAIRFLG_RESTRICT_2nd = 0x04
PAIRFLG_RESTRICT_1st = 0x08
PAIRFLG_INSERTSIZ = 0x10

MAXPAIRNUM = 1028 * 16  # resultpairs.c MAXPAIRNUM guard
MINLOGARG = 1e-7
CUMULPROB_PROPER_OUTSIDE = 3e-3
CUMULPROB_IMPROPER = 1e-4

# output flags (results.h:56-63)
RESULTFLG_BEST = 0x01
RESULTFLG_SINGLE = 0x02
RESULTFLG_RANDSEL = 0x04
RESULTFLG_SPLIT = 0x08


@dataclass
class MatePair:
    ap: Result
    bp: Result
    ins: int = 0
    flag: int = 0
    mapflg: int = 0
    pbf: float = 0.0


def calc_insert_size(ap: Result, bp: Result) -> Tuple[int, int]:
    """resultCalcInsertSize, SAM spec 1.4 (results.c:938-982).
    Returns (isiz, flag)."""
    flag = 0
    if ap.status & RSLTFLAG_REVERSE:
        flag |= PMF_REVERSE_1st
    if bp.status & RSLTFLAG_REVERSE:
        flag |= PMF_REVERSE_2nd
    if bp.s_start < ap.s_start:
        flag |= PMF_LEFTMOST2nd
    if ap.sidx < 0 or bp.sidx < 0:
        flag |= PMF_NOCONTIG
    elif ap.sidx == bp.sidx:
        flag |= PMF_SAMECONTIG
    rA = min(ap.s_start, bp.s_start)
    rB = max(ap.s_end, bp.s_end)
    isiz = rB - rA + 1
    if flag & PMF_LEFTMOST2nd:
        isiz = -isiz
    return isiz, flag


def test_proper_pair(isize: int, iflag: int, dmin: int, dmax: int,
                     libcode: int) -> int:
    """testProperPair (resultpairs.c:135-186)."""
    mapflg = 0
    if isize < 0:
        if -dmax <= isize <= -dmin:
            mapflg |= MAPFLG_WITHIN
        if libcode == LIB_PAIREDALL:
            mapflg |= MAPFLG_PROPER
        elif libcode == LIB_PAIREDEND:
            if (iflag & PMF_REVERSE_1st) and not (iflag & PMF_REVERSE_2nd) \
               and (iflag & PMF_LEFTMOST2nd):
                mapflg |= MAPFLG_PROPER
        elif libcode == LIB_MATEPAIR:
            if not (iflag & PMF_REVERSE_1st) and (iflag & PMF_REVERSE_2nd) \
               and (iflag & PMF_LEFTMOST2nd):
                mapflg |= MAPFLG_PROPER
        elif libcode == LIB_SAMESTRAND:
            if (iflag & PMF_REVERSE_1st) and (iflag & PMF_REVERSE_2nd) \
               and (iflag & PMF_LEFTMOST2nd):
                mapflg |= MAPFLG_PROPER
    else:
        if dmin <= isize <= dmax:
            mapflg |= MAPFLG_WITHIN
        if libcode == LIB_PAIREDALL:
            mapflg |= MAPFLG_PROPER
        elif libcode == LIB_PAIREDEND:
            if not (iflag & PMF_REVERSE_1st) and (iflag & PMF_REVERSE_2nd) \
               and not (iflag & PMF_LEFTMOST2nd):
                mapflg |= MAPFLG_PROPER
        elif libcode == LIB_MATEPAIR:
            if (iflag & PMF_REVERSE_1st) and not (iflag & PMF_REVERSE_2nd) \
               and not (iflag & PMF_LEFTMOST2nd):
                mapflg |= MAPFLG_PROPER
        elif libcode == LIB_SAMESTRAND:
            if not (iflag & PMF_REVERSE_1st) and not (iflag & PMF_REVERSE_2nd) \
               and not (iflag & PMF_LEFTMOST2nd):
                mapflg |= MAPFLG_PROPER
    return mapflg


class ResultPairs:
    def __init__(self):
        self.pairs: List[MatePair] = []
        self.n_proper = 0
        self.n_within = 0
        self.dmin = 0
        self.dmax = 0

    def blank(self):
        self.__init__()

    # ---------------- fast proper-pair search ----------------

    def find_proper_pairs(self, dmin: int, dmax: int, maxnum: int,
                          swscor_min: int, libcode: int,
                          rsA: ResultSet, rsB: ResultSet):
        """resultSetFindProperPairs (resultpairs.c:1162-1216)."""
        self.blank()
        if not rsA.segsrtr or not rsB.segsrtr:
            return
        ivals = self._generate_offsival(dmin, dmax, rsA)
        if swscor_min < 1:
            sw2nd = rsB.swatscor_2ndmax
            swscor_min = sw2nd if sw2nd > 0 else rsB.swatscor_max
        self.dmin, self.dmax = (dmax, dmin) if dmin > dmax else (dmin, dmax)
        if maxnum < 1:
            maxnum = 1
        if swscor_min > rsB.swatscor_max:
            return
        # iterate results of B in segment/SW order with max_rank 0
        ivalx = 0
        nival = len(ivals)
        stop = False
        for qsegx in range(rsB.qsegno):
            if stop:
                break
            for rp in rsB._seg_slice(qsegx):
                if rp.swrank > 0:
                    break
                if rp.swatscor < swscor_min:
                    break
                if ivalx >= nival:
                    ivalx = 0
                while ivalx < nival:
                    iv = ivals[ivalx]
                    if rp.sidx < iv[2]:
                        break
                    if rp.sidx > iv[2]:
                        ivalx += 1
                        continue
                    if rp.status & RSLTFLAG_REVERSE:
                        if iv[3] & RSLTFLAG_REVERSE:
                            ivalx += 1
                            continue
                        r0 = rp.s_end + rp.q_start - 2
                    else:
                        if not (iv[3] & RSLTFLAG_REVERSE):
                            ivalx += 1
                            continue
                        r0 = rp.s_start - rp.q_start
                    if r0 > iv[1]:
                        ivalx += 1
                        continue
                    if r0 < iv[0]:
                        break
                    mp = MatePair(ap=iv[4], bp=rp)
                    mp.ins, mp.flag = calc_insert_size(iv[4], rp)
                    mp.mapflg = test_proper_pair(mp.ins, mp.flag, self.dmin,
                                                 self.dmax, libcode)
                    mp.mapflg |= MAPFLG_PAIRED | MAPFLG_CONTIG
                    isiz = abs(mp.ins)
                    if self.dmin <= isiz <= self.dmax:
                        self.pairs.append(mp)
                    if len(self.pairs) >= maxnum:
                        stop = True
                        break
                    ivalx += 1
                if stop:
                    break
        self.n_proper = len(self.pairs)

    def _generate_offsival(self, dmin: int, dmax: int, rsA: ResultSet):
        """generateOFFSIVAL + setupOFFSIVALcbf (resultpairs.c:196-280,445)."""
        dmin = max(dmin, 0)
        dmax = max(dmax, 0)
        ivals = []  # (lower, upper, sidx, status, result)
        if rsA.qsegno < 1:
            return ivals
        for qsegx in range(rsA.qsegno):
            for rp in rsA._seg_slice(qsegx):
                if rp.swrank > 0:
                    break
                if rp.status & RSLTFLAG_REVERSE:
                    r0 = rp.s_end + rp.q_start - 2
                else:
                    r0 = rp.s_start - rp.q_start
                if r0 >= dmax:
                    iv1 = (r0 - dmax, r0 - dmin, rp.sidx, rp.status, rp)
                else:
                    iv1 = (0, r0 - dmin if r0 > dmin else 0, rp.sidx,
                           rp.status, rp)
                iv2 = (r0 + dmin, r0 + dmax, rp.sidx, rp.status, rp)
                if iv2[0] <= iv1[1]:
                    ivals.append((iv1[0], iv2[1], rp.sidx, rp.status, rp))
                else:
                    ivals.append(iv1)
                    ivals.append(iv2)
        # cmpOFFSIVAL: sidx asc, reverse DESC, lower asc (resultpairs.c:432)
        ivals.sort(key=lambda iv: (iv[2], -(iv[3] & RSLTFLAG_REVERSE), iv[0]))
        return ivals

    # ---------------- full enumeration ----------------

    def find_pairs(self, pairflg: int, libcode: int, dmin: int, dmax: int,
                   rsA: ResultSet, rsB: ResultSet):
        """resultSetFindPairs (resultpairs.c:1116-1160)."""
        self.blank()
        self.dmin, self.dmax = (dmax, dmin) if dmin > dmax else (dmin, dmax)
        isSingleA, _, max_rankA = rsA.get_rank_depth()
        isSingleB, _, max_rankB = rsB.get_rank_depth()
        if (pairflg & PAIRFLG_RESTRICT_2nd) and isSingleA:
            max_rankA = 0
        elif (pairflg & PAIRFLG_RESTRICT_1st) and isSingleB:
            max_rankB = 0
        stop = False
        for qsegxA in range(rsA.qsegno):
            if stop:
                break
            for ap in rsA._seg_slice(qsegxA):
                if ap.swrank > max_rankA:
                    break
                for qsegxB in range(rsB.qsegno):
                    if stop:
                        break
                    for bp in rsB._seg_slice(qsegxB):
                        if bp.swrank > max_rankB:
                            break
                        mp = MatePair(ap=ap, bp=bp, mapflg=MAPFLG_PAIRED)
                        mp.ins, mp.flag = calc_insert_size(ap, bp)
                        if mp.flag & PMF_SAMECONTIG:
                            mp.mapflg |= test_proper_pair(
                                mp.ins, mp.flag, self.dmin, self.dmax, libcode)
                            if mp.mapflg & MAPFLG_WITHIN:
                                self.n_within += 1
                                if mp.mapflg & MAPFLG_PROPER:
                                    self.n_proper += 1
                            mp.mapflg |= MAPFLG_CONTIG
                        self.pairs.append(mp)
                        if len(self.pairs) >= MAXPAIRNUM:
                            stop = True
                            break
                if stop:
                    break


# ---------------- probability model ----------------


def _assign_probabilities(pairs: List[MatePair], pairflg: int,
                          ihist: Optional[InsHist]):
    """assignProbabilityToPairs (resultpairs.c:753-826).
    Returns (psum, marga, margb)."""
    prob_improper = CUMULPROB_IMPROPER
    prob_proper = 1.0 - CUMULPROB_IMPROPER
    prob_out = CUMULPROB_PROPER_OUTSIDE
    prob_in = 1.0 - CUMULPROB_PROPER_OUTSIDE
    prob_allout = prob_improper + prob_proper * prob_out

    psum = MINLOGARG
    marga = margb = 0.0
    n_pairs = len(pairs)
    for mp in pairs:
        pa = mp.ap.prob
        pb = mp.bp.prob
        flga = mp.ap.status
        flgb = mp.bp.status
        if pairflg & PAIRFLG_RESTRICT_1st:
            if pa > pb:
                pa = pb
        elif pairflg & PAIRFLG_RESTRICT_2nd:
            if pb > pa:
                pb = pa
        if mp.mapflg & MAPFLG_PROPER:
            iab = prob_proper
            if mp.mapflg & MAPFLG_WITHIN:
                if ihist is None or n_pairs < 2:
                    iab *= prob_in
                else:
                    count, totnum = ihist.count_cumulative(abs(mp.ins), True)
                    if totnum < 1:
                        totnum = 1
                        count = 1
                    p = count / totnum
                    if p >= 0.5:
                        iab = 0.5 - p / 2
                    iab *= p * prob_in + prob_out
            else:
                iab *= prob_out
        else:
            iab = prob_improper
        mp.pbf = pa * pb * iab
        psum += mp.pbf
        if flga & RSLTFLAG_SINGLE:
            s = (1.0 - pa) * prob_allout * pb
            margb += s
            psum += s
        if flgb & RSLTFLAG_SINGLE:
            s = pa * prob_allout * (1.0 - pb)
            marga += s
            psum += s
    return psum, marga, margb


def _draw_pair_at_random(pairs: List[MatePair]) -> Optional[MatePair]:
    """drawPairAtRandomByProbability (resultpairs.c:726-752)."""
    s = sum(mp.pbf for mp in pairs)
    pthresh = rand.randraw_uniform_1() * s
    s = 0.0
    for mp in pairs:
        s += mp.pbf
        if s + MINLOGARG > pthresh:
            return mp
    return pairs[-1] if pairs else None


def score_pairs_simple(rp: ResultPairs, pairflg: int, ihist: Optional[InsHist],
                       rsltouflg: int, rsA: ResultSet, rsB: ResultSet):
    """scorePairsSimple (resultpairs.c:828-952).
    Returns (ap, bp, mapqA, mapqB, mapflg, n_max)."""
    pairs = rp.pairs
    n_pairs = len(pairs)
    mapflg = 0
    if n_pairs == 0:
        randsel = bool(rsltouflg & RESULTFLG_RANDSEL)
        ap, multiA = rsA.get_top_result(randsel)
        bp, multiB = rsB.get_top_result(randsel)
        if multiA or multiB:
            mapflg = 0  # reference overwrites mapflg via pointer both calls
        return ap, bp, 0, 0, mapflg, 0

    psum, marga, margb = _assign_probabilities(pairs, pairflg, ihist)
    if psum < MINLOGARG:
        psum = MINLOGARG
    pairs.sort(key=lambda mp: -mp.pbf)
    i = 1
    while i < n_pairs and pairs[i].pbf + MINLOGARG >= pairs[0].pbf:
        i += 1
    n_max = i
    mp = pairs[0]
    maxprob = mp.pbf / psum
    if maxprob <= 0.6 and n_pairs > 1:
        mapflg = MAPFLG_MULT1ST | MAPFLG_MULT2ND
        if rsltouflg & RESULTFLG_RANDSEL:
            mp = _draw_pair_at_random(pairs)
        elif not (rsltouflg & RESULTFLG_SINGLE):
            mp = pairs[0]
        else:
            mp = None
    if mp is None:
        return None, None, 0, 0, mapflg, n_max
    ap, bp = mp.ap, mp.bp
    mapflg |= mp.mapflg
    for q in pairs:
        if q.ap is ap:
            marga += q.pbf
        if q.bp is bp:
            margb += q.pbf
    mapqA = convert_prob_to_mapscor(marga / psum)
    mapqB = convert_prob_to_mapscor(margb / psum)
    return ap, bp, mapqA, mapqB, mapflg, n_max


# ---------------- report feeding ----------------


def _add_result_to_report(rep: Report, pairid: int, mapscor: int,
                          mateflg: int, pairflg: int, isize: int,
                          rp: Optional[Result], rsp: Optional[ResultSet]):
    """resultSetAddResultToReport (results.c:2209-2248)."""
    if rp is None or (rp.status & RSLTFLAG_NOOUTPUT):
        rep.add_map(pairid, 0, 0, 0, 0, 0, 0, 0, None, 0, mateflg, pairflg)
    else:
        mateflg |= REPMATEFLG.MAPPED
        if rp.status & RSLTFLAG_REVERSE:
            mateflg |= REPMATEFLG.REVERSE
        ms = rp.mapscor if pairid < 0 else mapscor
        rep.add_map(pairid, rp.swatscor, ms, rp.q_start, rp.q_end,
                    rp.s_start, rp.s_end, rp.sidx, rp.diff, isize,
                    mateflg, pairflg)


def _add_pair_results_to_report(rep: Report, mapflg: int, repmateflg: int,
                                ap, mapqA, rsA, bp, mapqB, rsB):
    """addPairResultsToReport (resultpairs.c:1008-1068)."""
    isize = 0
    pair_id = rep.next_pair_id()
    reppairflg = 0
    repmateflg |= REPMATEFLG.PAIRED
    if (mapflg & MAPFLG_PAIRED) and ap is not None and bp is not None and \
       not (ap.status & RSLTFLAG_NOOUTPUT) and not (bp.status & RSLTFLAG_NOOUTPUT):
        reppairflg |= REPPAIR.MAPPED
        if mapflg & MAPFLG_CONTIG:
            reppairflg |= REPPAIR.CONTIG
            isize, _ = calc_insert_size(ap, bp)
            if mapflg & MAPFLG_WITHIN:
                reppairflg |= REPPAIR.WITHIN
            if mapflg & MAPFLG_PROPER:
                reppairflg |= REPPAIR.PROPER
    rmA = repmateflg & ~REPMATEFLG.MATE2
    if mapflg & MAPFLG_MULT1ST:
        rmA |= REPMATEFLG.MULTI
    _add_result_to_report(rep, pair_id, mapqA, rmA, reppairflg, isize, ap, rsA)
    rmB = repmateflg | REPMATEFLG.MATE2
    if mapflg & MAPFLG_MULT2ND:
        rmB |= REPMATEFLG.MULTI
    _add_result_to_report(rep, pair_id, mapqB, rmB, reppairflg, isize, bp, rsB)


def _add_2ndary_to_report(rep: Report, mateflg: int, rsltflg: int,
                          rsp: Optional[ResultSet]):
    """resultSetAdd2ndaryResultsToReport (results.c:2249-2280)."""
    if rsp is None:
        return
    from .result import RSLTFLAG_REPORTED, RSLTFLAG_BELOWRELSW
    for qsegx in range(rsp.qsegno):
        swscor = 0
        for r in rsp._seg_slice(qsegx):
            if r.status & RSLTFLAG_NOOUTPUT:
                continue
            if (r.status & RSLTFLAG_REPORTED) or \
               (r.swatscor < swscor and
                ((rsltflg & RESULTFLG_BEST) or (r.status & RSLTFLAG_BELOWRELSW))):
                break
            _add_result_to_report(rep, -1, 0, mateflg, 0, 0, r, rsp)
            r.status |= RSLTFLAG_REPORTED
            swscor = r.swatscor


def add_pair_to_report(rep: Report, ihist: Optional[InsHist],
                       rp: ResultPairs, pairflg: int, rsltouflg: int,
                       rsA: ResultSet, rsB: ResultSet):
    """resultSetAddPairToReport (resultpairs.c:1222-1311)."""
    ap, bp, mapqA, mapqB, mapflg, n_max = score_pairs_simple(
        rp, pairflg, ihist, rsltouflg, rsA, rsB)

    if n_max > 1 and not (rsltouflg & RESULTFLG_RANDSEL) and \
       (rsltouflg & RESULTFLG_SINGLE):
        apx, multiA = rsA.get_top_result(False)
        bpx, multiB = rsB.get_top_result(False)
        ap, bp = apx, bpx
        if not multiA:
            bp = None
            mapflg |= MAPFLG_MULT2ND
        elif not multiB:
            ap = None
            mapflg |= MAPFLG_MULT1ST
        else:
            mapflg |= MAPFLG_MULT1ST | MAPFLG_MULT2ND
            ap = None
            bp = None

    _add_pair_results_to_report(rep, mapflg,
                                REPMATEFLG.PAIRED | REPMATEFLG.PRIMARY,
                                ap, mapqA, rsA, bp, mapqB, rsB)

    if (mapflg & (MAPFLG_MULT1ST | MAPFLG_MULT2ND)) and \
       not (rsltouflg & RESULTFLG_RANDSEL) and \
       not (rsltouflg & RESULTFLG_SINGLE):
        for i in range(n_max):
            mp = rp.pairs[i]
            if mp.ap is not ap or mp.bp is not bp:
                mflg = mp.mapflg | (mapflg & (MAPFLG_MULT1ST | MAPFLG_MULT2ND))
                _add_pair_results_to_report(
                    rep, mflg, REPMATEFLG.PAIRED | REPMATEFLG.PRIMARY,
                    mp.ap, mapqA, rsA, mp.bp, mapqB, rsB)

    if (rsltouflg & RESULTFLG_BEST) and (rsltouflg & RESULTFLG_SPLIT):
        _add_2ndary_to_report(rep, REPMATEFLG.PAIRED | REPMATEFLG.PARTIAL,
                              rsltouflg, rsA)
        _add_2ndary_to_report(rep, REPMATEFLG.PAIRED | REPMATEFLG.PARTIAL |
                              REPMATEFLG.MATE2, rsltouflg, rsB)


def add_single_to_report(rep: Report, rsltouflg: int, rsp: ResultSet):
    """resultSetAddToReport (results.c:2282-2345)."""
    from .result import (RSLTFLAG_REPORTED, RSLTFLAG_BELOWRELSW,
                         mapscor_random_draw)
    nsort = len(rsp.sortr)
    r = rsp.sortr[0] if nsort else None
    mateflg = 0
    if r is not None:
        is_single, ns = rsp._top_count()
        if r.mapscor == 0 and not is_single and ns > 1 and \
           (rsltouflg & RESULTFLG_BEST) and not (rsltouflg & RESULTFLG_SPLIT):
            mateflg |= REPMATEFLG.MULTI
            if rsltouflg & RESULTFLG_RANDSEL:
                ri = int(rand.randraw_uniform_1() * ns)
                r = rsp.sortr[ri]
                if r is not None:
                    r.mapscor = mapscor_random_draw(ns)
            elif rsltouflg & RESULTFLG_SINGLE:
                r = None
    _add_result_to_report(rep, -1, 0, mateflg | REPMATEFLG.PRIMARY, 0, 0,
                          r, rsp)
    if r is not None:
        r.status |= RSLTFLAG_REPORTED

    if (rsltouflg & RESULTFLG_SINGLE) and not (rsltouflg & RESULTFLG_SPLIT):
        return
    for i in range(1, nsort):
        r = rsp.sortr[i]
        if (rsltouflg & RESULTFLG_BEST) and \
           r.swatscor < rsp.sortr[i - 1].swatscor:
            break
        if not (r.status & (RSLTFLAG_NOOUTPUT | RSLTFLAG_BELOWRELSW)):
            _add_result_to_report(rep, -1, 0, mateflg, 0, 0, r, rsp)
            r.status |= RSLTFLAG_REPORTED
    if (rsltouflg & RESULTFLG_BEST) and (rsltouflg & RESULTFLG_SPLIT):
        _add_2ndary_to_report(rep, mateflg | REPMATEFLG.PARTIAL, rsltouflg, rsp)
