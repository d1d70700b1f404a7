"""Alignment result sets and Phred-scaled mapping quality.

Replicates results.c: Result records (1-based query/subject ranges),
duplicate pruning and output ordering (cmpRes/cmpResOutput,
results.c:456-556), per-query-segment grouping
(labelComplementarySegments, results.c:707), the mapq formulas
(calcPhredScaledMappingQuality, results.c:1143-1352), probability
propagation (results.c:1354), split-read linking (results.c:1436),
filters (results.c:2592) and report feeding (results.c:2282-2345).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..align import diffstr as ds
from .. import rand

# flags (results.h:66-113)
RSLTFLAG_REVERSE = 0x01
RSLTFLAG_RAW = 0x02
RSLTFLAG_NOSEQID = 0x04
RSLTFLAG_SELECT = 0x08
RSLTFLAG_NOOUTPUT = 0x10
RSLTFLAG_BELOWRELSW = 0x20
RSLTFLAG_SINGLE = 0x40
RSLTFLAG_HASSECOND = 0x80
RSLTFLAG_REPORTED = 0x100

MAPSCOR_MAX = 60                 # results.c:55
MAPSCOR_DUMMY_COUNT = 3          # results.c:56
MAPSCOR_MAX_RANDOM = 3           # results.c:57
MAPSCOR_MIN_UNIQ = 4             # results.c:58
MAPSCOR_EXPFAC = 10              # results.c:62 (results_mapscor_exp)
MAPSCOR_THRESH_CONFIDENT = 20    # results.c:69
QUALSCOR_SCAL = 10               # results.c:73
QUALSCOR_LOGBASE = np.float32(2.30259)  # results.c:104 (float!)
MINLOGARG = 1e-7
SAMPLESIZ_MAPQ_RANDOM = 9        # results.c:81
MIN_QSEGOVERLAP_PERCENT = 80     # results.c:92
QVAL_OFFS = 0x21


@dataclass
class Result:
    q_start: int = 0   # 1-based
    q_end: int = 0
    s_start: int = 0   # 1-based (within sequence once sidx assigned)
    s_end: int = 0
    sidx: int = -1
    swatscor: int = 0
    mapscor: int = 0
    prob: float = 0.0
    status: int = 0
    diff: List[int] = field(default_factory=list)
    swrank: int = 0
    qsegx: int = -1
    rsltx: int = -1
    serialno: int = 0


def convert_prob_to_mapscor(p: float) -> int:
    """resultConvertProbabilityToMappingScore (results.c:292-306)."""
    isc = 1.0 - p
    if isc < MINLOGARG:
        isc = MINLOGARG
    m = -QUALSCOR_SCAL * math.log10(isc)
    if m > MAPSCOR_MAX:
        return MAPSCOR_MAX
    if m < 0:
        return 0
    return int(m)


def mapscor_random_draw(samplesiz: int) -> int:
    """assignPhredScaledMappingScoreToRandomDraw (results.c:214-230)."""
    if samplesiz < 1 or samplesiz > SAMPLESIZ_MAPQ_RANDOM:
        return 0
    if samplesiz == 1:
        return MAPSCOR_MAX_RANDOM + 1
    mapq = int(-QUALSCOR_SCAL * math.log10((samplesiz - 1) / samplesiz) + 0.499)
    if mapq > MAPSCOR_MAX_RANDOM:
        mapq = MAPSCOR_MAX_RANDOM
    elif mapq < 0:
        mapq = 0
    return mapq


def sum_qual_over_mismatch(qual: bytes, pos_start: int, pos_end: int,
                           diff: List[int]) -> int:
    """sumQualOverMisMatch (results.c:232-286), with_nonali=0."""
    qs = 0
    spos = pos_start - 1 if pos_start > 0 else 0
    for i, b in enumerate(diff):
        if not b:
            break
        gap, typ = ds.diffstr_get(b)
        spos += gap
        if typ == ds.DIFFCOD_D:
            continue
        if typ == ds.DIFFCOD_S:
            if i + 1 >= len(diff) or not diff[i + 1]:
                continue
            q = qual[spos]
            if q < QVAL_OFFS:
                raise ValueError("bad quality value")
            qs += q - QVAL_OFFS
        spos += 1
    if spos != pos_end:
        raise AssertionError("diff string inconsistent with segment")
    return qs


def _cmp_key_res(r: Result):
    """cmpRes (results.c:456-482) as a sort key (stable sorted())."""
    da = r.q_end - r.q_start
    return (r.sidx, r.status & RSLTFLAG_REVERSE, r.s_start, -da)


def _cmp_key_output(r: Result):
    """cmpResOutput (results.c:478-516)."""
    da = r.q_end - r.q_start
    return (-r.swatscor, r.status & RSLTFLAG_REVERSE, r.sidx, r.s_start, -da)


def _cmp_key_seglen(r: Result):
    """cmpResSegLen (results.c:525-556)."""
    da = r.q_end - r.q_start
    return (-r.swatscor, -da, r.status & RSLTFLAG_REVERSE, r.sidx, r.s_start)


def _cmp_key_seg_sw(r: Result):
    """cmpResSegSW (results.c:517-524)."""
    return (r.qsegx, -r.swatscor)


class ResultSet:
    def __init__(self):
        self.results: List[Result] = []
        self.sortr: List[Result] = []       # output-ordered selected results
        self.segsrtr: List[Result] = []     # per-segment, SW-ordered
        self.segnor: List[int] = []         # segment boundaries into segsrtr
        self.qsegno = 0
        self.swatscor_max = 0
        self.swatscor_2ndmax = 0
        self.n_ali_done = 0
        self.n_ali_tot = 0
        self.n_ali_max = 0
        self.n_hits_used = 0
        self.n_hits_tot = 0

    def blank(self):
        self.__init__()

    # ------------- accumulation -------------

    def _update_swatmax(self, sw: int):
        """UPDATE_SWATSCORMAX (results.h macro semantics)."""
        if sw > self.swatscor_2ndmax:
            if sw > self.swatscor_max:
                self.swatscor_2ndmax = self.swatscor_max
                self.swatscor_max = sw
            elif sw != self.swatscor_max:
                self.swatscor_2ndmax = sw

    def add_from_ali(self, ali_results, soffs: int, qoffs: int, qlen: int,
                     seqidx: int, is_reverse: bool):
        """resultSetAddFromAli (results.c:1852-1942).

        Replicates the reference's slot/ARRLEN dance VERBATIM, including
        its observable bugs: after a duplicate is dropped (--ARRLEN) the
        next result is written into the REUSED slot without re-counting
        it, so it only becomes a real result if a further result follows
        in the same batch — a new result that immediately follows a
        duplicate at the END of a batch is silently lost (it still bumps
        swatscor_max/2ndmax, which pass-2 min-score dynamics read).  The
        duplicate compare is against the PHYSICAL previous slot, which
        after consecutive drops can itself be an uncounted zombie, and is
        skipped entirely while fewer than two slots are counted."""
        if not ali_results:
            return
        phys = self.results          # physical slots; ARRLEN = arrlen
        arrlen = len(phys)
        rp = arrlen                  # preloop ARRNEXTP
        phys.append(None)
        arrlen += 1
        is_new = False
        for a in ali_results:
            if is_new:
                rp = arrlen
                if len(phys) <= rp:
                    phys.append(None)
                arrlen += 1
                is_new = False
            r = Result()
            if is_reverse:
                r.q_start = qoffs + qlen - a.qe
                r.q_end = qoffs + qlen - a.qs
            else:
                r.q_start = a.qs + qoffs + 1
                r.q_end = a.qe + qoffs + 1
            r.s_start = soffs + a.rs + 1
            r.s_end = soffs + a.re + 1
            r.sidx = seqidx
            r.swatscor = a.score
            if seqidx < 0:
                r.status |= RSLTFLAG_NOSEQID
            phys[rp] = r
            prev = phys[rp - 1] if rp >= 1 else None
            is_new = (arrlen < 2 or
                      not (prev.s_start == r.s_start and
                           prev.s_end == r.s_end and
                           prev.q_start == r.q_start and
                           prev.q_end == r.q_end and
                           prev.swatscor == r.swatscor and
                           prev.sidx == r.sidx))
            if is_new:
                r.diff = list(a.diff)
                self._update_swatmax(r.swatscor)
                r.status |= RSLTFLAG_SELECT
                if is_reverse:
                    r.status |= RSLTFLAG_REVERSE
            else:
                arrlen -= 1
        del phys[arrlen:]            # orphan slots die with the batch

    def set_alignment_stats(self, n_ali_done, n_ali_tot, max_depth,
                            n_hits_used, n_hits_tot):
        self.n_ali_done = n_ali_done
        self.n_ali_tot = n_ali_tot
        self.n_ali_max = max_depth
        self.n_hits_used = n_hits_used
        self.n_hits_tot = n_hits_tot

    # ------------- sorting / segments / mapq -------------

    def sort_and_assign(self, qual: Optional[bytes], qlen: int,
                        search_split: bool = False,
                        refset=None, prof_f=None, prof_r=None):
        """resultSetSortAndAssignSequence (results.c:2022-2064).  In
        whole-genome mode (refset given) sequence indices are resolved
        first and alignments spanning concatenated-sequence boundaries
        are split (assignSequenceIndex + splitMultiSpan,
        results.c:1474-1695)."""
        self._qlen = qlen
        if refset is not None:
            self._assign_sequence_index(refset, prof_f, prof_r)
        self._sort_and_prune()
        self.qsegno = 0
        if self.sortr:
            self._label_segments()
            for qsegx in range(self.qsegno):
                self._calc_mapq(qsegx, qual)
                self._propagate_prob(qsegx)
            if search_split:
                self._find_split_reads()

    def _assign_sequence_index(self, refset, prof_f, prof_r):
        """assignSequenceIndex (results.c:1695-1780): resolve global
        offsets to (sidx, within-sequence offsets), splitting alignments
        that span multiple concatenated sequences."""
        from ..sort_nr import paired_sort

        ofp = refset.offsets
        nseq = refset.nseq
        cand = [(i, r) for i, r in enumerate(self.results)
                if (r.status & RSLTFLAG_SELECT) and r.sidx < 0]
        if not cand:
            return
        keys = np.asarray([r.s_start for _, r in cand], dtype=np.uint64)
        idxs = np.asarray([i for i, _ in cand], dtype=np.uint32)
        _, order = paired_sort(keys.astype(np.uint64), idxs)
        s = 0
        for ri in order:
            r = self.results[int(ri)]
            if not (r.status & (RSLTFLAG_NOSEQID | RSLTFLAG_SELECT)):
                continue
            while s < nseq and r.s_start > int(ofp[s + 1]):
                s += 1
            e = s + 1
            while e < nseq and r.s_end > int(ofp[e]):
                e += 1
            if r.s_end > int(ofp[e]):
                raise AssertionError("result beyond reference end")
            if e > s + 1:
                self._split_multi_span(r, s, e, refset, prof_f, prof_r)
                r.status &= ~RSLTFLAG_SELECT
            else:
                r.sidx = s
                r.s_start -= int(ofp[s])
                r.s_end -= int(ofp[s])
                r.status &= ~RSLTFLAG_NOSEQID

    def _split_multi_span(self, r: Result, so: int, eo: int, refset,
                          prof_f, prof_r):
        """splitMultiSpan (results.c:1474-1694): split an alignment spanning
        sequences [so, eo) into per-sequence results, re-scoring each."""
        from ..align import diffstr as dsm
        from ..align import core as ali_core

        ofp = refset.offsets
        is_rev = bool(r.status & RSLTFLAG_REVERSE)
        prof = prof_r if is_rev else prof_f
        qlen = prof.qlen
        for idx in range(so, eo):
            if r.s_start > int(ofp[idx]):
                curr_start = 0
            else:
                curr_start = int(ofp[idx]) - r.s_start + 1
            curr_end = (min(r.s_end, int(ofp[idx + 1]))) - r.s_start
            try:
                sub, su, eu, sp, ep = dsm.segment(r.diff, curr_start, curr_end)
            except dsm.NoMatch:
                continue
            hp = Result()
            hp.__dict__.update({k: v for k, v in r.__dict__.items()
                                if k != "diff"})
            hp.diff = sub
            if is_rev:
                hp.q_start = r.q_end - ep
                hp.q_end = r.q_end - sp
                q0 = qlen - hp.q_end
            else:
                hp.q_start = r.q_start + sp
                hp.q_end = r.q_start + ep
                q0 = hp.q_start - 1
            hp.s_start = r.s_start + su - int(ofp[idx])
            hp.s_end = r.s_start + eu - int(ofp[idx])
            hp.sidx = idx
            hp.status &= ~RSLTFLAG_NOSEQID
            hp.status |= RSLTFLAG_SELECT
            seg = refset.fetch_by_seq(idx, hp.s_start - 1,
                                      hp.s_end - hp.s_start + 1)
            hp.swatscor = ali_core.score_diff_str(prof, seg, q0, sub)
            # note: the reference does NOT refresh swatscor_max here — the
            # unsplit alignment's score stays recorded (results.c:1688)
            self.results.append(hp)

    def _sort_and_prune(self):
        """sortAndPrune (results.c:759-837)."""
        for i, r in enumerate(self.results):
            r.serialno = i
            r.swrank = 0
        sel = [r for r in self.results if r.status & RSLTFLAG_SELECT]
        if len(sel) < 2:
            self.sortr = sel
            return
        sel.sort(key=_cmp_key_res)
        out = [sel[0]]
        prev = sel[0]
        for r in sel[1:]:
            if (r.s_end > prev.s_end or r.swatscor > prev.swatscor or
                    r.q_start < prev.q_start or r.q_end > prev.q_end or
                    r.sidx != prev.sidx or
                    (r.status & RSLTFLAG_REVERSE) != (prev.status & RSLTFLAG_REVERSE)):
                out.append(r)
                prev = r
            else:
                r.status &= ~RSLTFLAG_SELECT
        out.sort(key=_cmp_key_output)
        self.sortr = out
        out[0].swrank = 0
        for i in range(1, len(out)):
            if out[i].swatscor < out[i - 1].swatscor:
                out[i].swrank = out[i - 1].swrank + 1
            else:
                out[i].swrank = out[i - 1].swrank

    def _label_segments(self):
        """labelComplementarySegments (results.c:707-757)."""
        rspp = self.sortr
        n = len(rspp)
        for r in rspp:
            r.qsegx = -1
        i_start = 0
        self.qsegno = 0
        while True:
            r1 = rspp[i_start]
            l1 = r1.q_end - r1.q_start
            r1.qsegx = self.qsegno
            i = i_start + 1
            i_start = 0
            while i < n:
                r2 = rspp[i]
                if r2.qsegx < 0:
                    l2 = r2.q_end - r2.q_start
                    min_ovl = int(min(l1, l2) * (MIN_QSEGOVERLAP_PERCENT / 100.0))
                    if (r1.q_start + min_ovl < r2.q_end and
                            r2.q_start + min_ovl < r1.q_end):
                        r2.qsegx = self.qsegno
                    elif i_start == 0:
                        i_start = i
                i += 1
            self.qsegno += 1
            if i_start == 0:
                break
        # sortBySegmentAndSWscor (results.c:668-706)
        self.segsrtr = sorted(rspp, key=_cmp_key_seg_sw)
        self.segnor = [0]
        for i in range(1, len(self.segsrtr)):
            if self.segsrtr[i].qsegx > self.segsrtr[i - 1].qsegx:
                self.segnor.append(i)
        self.segnor.append(len(self.segsrtr))

    def _seg_slice(self, qsegx: int) -> List[Result]:
        return self.segsrtr[self.segnor[qsegx]: self.segnor[qsegx + 1]]

    def _calc_mapq(self, qsegx: int, qual: Optional[bytes]):
        """calcPhredScaledMappingQuality (results.c:1143-1352)."""
        rspp = self._seg_slice(qsegx)
        n = len(rspp)
        if n < 1:
            return
        sw1 = rspp[0].swatscor
        if sw1 < 1:
            rspp[0].mapscor = 0
            return

        fs = self.n_hits_used / (self.n_hits_tot + MAPSCOR_DUMMY_COUNT)
        fa = self.n_ali_done / (self.n_ali_tot + MAPSCOR_DUMMY_COUNT)
        if fs > fa:
            fs = fa
        fs = (-QUALSCOR_SCAL * math.log(fs) / QUALSCOR_LOGBASE
              if fs > MINLOGARG else MAPSCOR_MAX)
        maxmapscor = MAPSCOR_MAX - int(fs) if fs < MAPSCOR_MAX else 0

        if n > 1:
            sw2 = rspp[1].swatscor
            i = 2
            while i < n and rspp[i].swatscor == sw2:
                i += 1
            n2 = i - 1
            qn = int(QUALSCOR_SCAL * math.log(n2) / QUALSCOR_LOGBASE)
        else:
            sw2 = 0
            n2 = 0
            qn = 0

        if sw2 == sw1 and n > 1:
            # multiple best mappings: longest query segment, then lowest
            # base-quality sum over mismatches (results.c:1228-1294)
            head = sorted(rspp[: n2 + 1], key=_cmp_key_seglen)
            rspp[: n2 + 1] = head
            seglen_1st = head[0].q_end - head[0].q_start
            seglen = head[1].q_end - head[1].q_start
            if seglen_1st == seglen and qual is not None:
                qv1 = sum_qual_over_mismatch(qual, head[0].q_start,
                                             head[0].q_end, head[0].diff)
                qv2 = sum_qual_over_mismatch(qual, head[1].q_start,
                                             head[1].q_end, head[1].diff)
                i_min = 1
                i = 2
                while i < n and rspp[i].swatscor == sw1:
                    sl = rspp[i].q_end - rspp[i].q_start
                    if sl < seglen_1st:
                        break
                    qv = sum_qual_over_mismatch(qual, rspp[i].q_start,
                                                rspp[i].q_end, rspp[i].diff)
                    if qv < qv2:
                        qv2 = qv
                        i_min = i
                    i += 1
                if qv1 > qv2:
                    rspp[i_min], rspp[0] = rspp[0], rspp[i_min]
                    mapscor = MAPSCOR_MIN_UNIQ
                else:
                    mapscor = 0 if qv1 == qv2 else MAPSCOR_MIN_UNIQ
            elif seglen_1st == seglen:
                mapscor = 0
            else:
                mapscor = MAPSCOR_MIN_UNIQ
            if mapscor < 1:
                head = sorted(rspp[: n2 + 1], key=_cmp_key_output)
                rspp[: n2 + 1] = head
        else:
            # results_mapscor_exp is defined (results.h:40): exponential
            # scaling of the score difference (results.c:1310-1315)
            qlen = self._qlen  # read length
            mapscor = int(MAPSCOR_MAX *
                          (1 - math.exp((sw2 - sw1) * MAPSCOR_EXPFAC / qlen))
                          - qn)
            if mapscor >= 0:
                mapscor += MAPSCOR_MIN_UNIQ
            if mapscor > maxmapscor:
                mapscor = maxmapscor

        if mapscor > MAPSCOR_MAX:
            mapscor = MAPSCOR_MAX
        elif mapscor < 0:
            mapscor = 0
        rspp[0].mapscor = mapscor
        for r in rspp[1:]:
            r.mapscor = 0
        # write the permutation back into segsrtr
        self.segsrtr[self.segnor[qsegx]: self.segnor[qsegx + 1]] = rspp

    _qlen = 0  # set by engine before sort_and_assign

    def _propagate_prob(self, qsegx: int):
        """propagateMapQualAsProb (results.c:1354-1413)."""
        rspp = self._seg_slice(qsegx)
        nn = len(rspp)
        if nn < 1:
            return
        i = 1
        while i < nn and rspp[i].swatscor == rspp[0].swatscor:
            i += 1
        n1 = i
        n2 = 0
        if i < nn:
            i += 1
            while i < nn and rspp[i].swatscor == rspp[n1].swatscor:
                i += 1
            n2 = i - n1
        p1 = p2 = 0.0
        if n1 == 1:
            isc = max(rspp[0].mapscor, 0)
            p2 = math.exp(float(-QUALSCOR_LOGBASE * isc) / QUALSCOR_SCAL)
            p1 = 1.0 - p2
            if n2 > 1:
                p2 /= n2
        elif n1 > 1:
            p1 = 1.0 / n1
            p2 = p1
        for i in range(n1):
            rspp[i].prob = p1
        for i in range(n1, n1 + n2):
            rspp[i].prob = p2
        for i in range(n1 + n2, nn):
            rspp[i].prob = 0.0
        if n1 == 1 and n2 == 0:
            rspp[0].status |= RSLTFLAG_SINGLE

    def _find_split_reads(self):
        """findSplitReads (results.c:1436-1472)."""
        rspp = self.sortr
        n = len(rspp)
        if n < 1:
            return
        sw1 = rspp[0].swatscor
        for i in range(n):
            a = rspp[i]
            if a.swatscor < sw1:
                break
            for j in range(i + 1, n):
                b = rspp[j]
                if b.rsltx >= 0:
                    continue
                if a.q_end < b.q_start or a.q_start > b.q_end:
                    b.rsltx = i
                    a.status |= RSLTFLAG_HASSECOND
                    break

    # ------------- queries -------------

    def get_scor_stats(self):
        """resultSetGetScorStats: (nres, num_max, num_2ndmax)."""
        nsort = len(self.sortr)
        i = 0
        while i < nsort and self.sortr[i].swatscor >= self.swatscor_max:
            i += 1
        num_max = i
        # reference quirk (results.c:2386-2390): the second loop tests
        # sortr[i] (a fixed element) rather than sortr[j], so num_2ndmax is
        # either all remaining results or none.
        if i < nsort and self.sortr[i].swatscor >= self.swatscor_2ndmax:
            num_2ndmax = nsort - i
        else:
            num_2ndmax = 0
        return len(self.results), num_max, num_2ndmax

    def get_rank_depth(self) -> Tuple[bool, int, int]:
        """resultSetGetRankDepth: (is_unique_best, depth, max_rank)."""
        _, n_max, n_2nd = self.get_scor_stats()
        if n_max < 2:
            return n_max == 1, n_max + n_2nd, 1
        return False, n_max, 0

    def get_mapping_score(self) -> Tuple[int, int]:
        """resultSetGetMappingScore: (mapq, swscor) of the top result."""
        if not self.sortr:
            return 0, 0
        return self.sortr[0].mapscor, self.sortr[0].swatscor

    def get_top_result(self, is_randsel: bool):
        """resultSetGetTopResult (results.c:2516-2540).
        Returns (result_or_None, is_multi)."""
        is_single, ntop = self._top_count()
        top = None
        is_multi = False
        if ntop > 0:
            if is_single:
                top = self.sortr[0]
                if top.mapscor < 1:
                    is_multi = True
            else:
                is_multi = True
            if is_multi and is_randsel:
                rsltx = int(rand.randraw_uniform_1() * ntop)
                top = self.sortr[rsltx]
                top.mapscor = mapscor_random_draw(ntop)
        return top, is_multi

    def _top_count(self) -> Tuple[bool, int]:
        """getNumberOfTopSwatRESULTs (results.c:839-871)."""
        rspp = self.sortr
        n = len(rspp)
        nb = n
        if n < 2 or rspp[1].swatscor != rspp[0].swatscor:
            rv = True
        else:
            rv = False
        if n > 2:
            thresh = rspp[1].swatscor
            i = 2
            while i < n and rspp[i].swatscor == thresh:
                i += 1
            nb = i
        return rv, nb

    # ------------- filter -------------

    def filter_results(self, filt: "ResultFilter", qlen: int):
        """resultSetFilterResults (results.c:2592-2626)."""
        n = len(self.sortr)
        if n < 1:
            return
        if filt.min_identity <= 1.0:
            minid = int(filt.min_identity * qlen)
        else:
            minid = int(filt.min_identity)
        maxsw = self.sortr[0].swatscor
        minabs = filt.min_swscor
        minrel = 0
        if filt.min_swscor_below_max >= 0 and \
           minabs + filt.min_swscor_below_max < maxsw:
            minrel = maxsw - filt.min_swscor_below_max
        for r in self.sortr:
            _, matchnum = ds.ali_len(r.diff)
            if r.swatscor < minabs or matchnum < minid:
                r.status |= RSLTFLAG_NOOUTPUT
            elif r.swatscor < minrel:
                r.status |= RSLTFLAG_BELOWRELSW


@dataclass
class ResultFilter:
    min_swscor: int = 0
    min_swscor_below_max: int = 0
    min_identity: float = 0.0
