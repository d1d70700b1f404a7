"""Alignment engine: score profiles, banded affine-gap Smith-Waterman
with traceback, score-only variants, and the recursive multi-alignment
driver.

Replicates:
  setScoreMatrix            score.c:138-173   (N scores 0, X scores xmatch)
  scoreMakeProfileFromSequence score.c:~380   (per-read profile)
  scoreMatrixCalcLambda     score.c:253-277   (complexity lambda)
  alignSmiWatBand           alignment.c:788   (banded DP, direction bits)
  alignSmiWatBandFast       alignment.c:1029  (score only)
  makeMetaFromTrack         alignment.c:628   (traceback -> diff string)
  scaleALICPLX              alignment.c:268   (complexity-weighted score)
  alignSmiWatBandRecursive  alignment.c:1300  (secondary alignments)
  swSIMDAlignStriped maths  swsimd.c:443-660  (full-matrix score pass)

Penalties follow the reference sign conventions: the profile stores
signed scores, the DP uses positive gap penalties (score.c:680-681).
The reference recurrence refreshes gap-open states and the running
maximum only on diagonal moves with H > gap_init — kept verbatim.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..seq import codec
from .band import AliBand, BandError
from . import diffstr as ds
from ..native import get_lib

ALILEN_MIN = 5  # alignment.c:50

# default penalties (score.c:41-47 / menu.c:399-406)
DEFAULT_MATCH = 1
DEFAULT_MISMATCH = -2
DEFAULT_GAPOPEN = -4
DEFAULT_GAPEXT = -3

_MAXNUM_3BIT = 7
_MINALPHABET = 4
_ALPHABET = "ACGTXN"


def make_score_matrix(match=DEFAULT_MATCH, mismatch=DEFAULT_MISMATCH,
                      gapopen=DEFAULT_GAPOPEN, gapext=DEFAULT_GAPEXT):
    """ScoreMatrix over the 3-bit alphabet (setScoreMatrix, score.c:138)."""
    xmatch = mismatch - match
    m = np.zeros((_MAXNUM_3BIT + 1, _MAXNUM_3BIT + 1), dtype=np.int32)
    for i in range(_MAXNUM_3BIT + 1):
        for j in range(_MAXNUM_3BIT + 1):
            if i >= len(_ALPHABET) or j >= len(_ALPHABET) or \
               _ALPHABET[i] == "N" or _ALPHABET[j] == "N":
                m[i, j] = 0
            elif _ALPHABET[i] == "X" or _ALPHABET[j] == "X":
                m[i, j] = xmatch
            elif i == j:
                m[i, j] = match
            else:
                m[i, j] = mismatch
    return m, gapopen, gapext


def matrix_lambda(m: np.ndarray) -> float:
    """scoreMatrixCalcLambda (score.c:253): solve
    (1/16) sum_{a,b<4} exp(lambda*s_ab) = 1 by the reference's bisection."""
    def getsum(lam):
        return float(np.exp(lam * m[:4, :4].astype(np.float64)).sum()) * 0.0625

    lam_lo = 0.0
    lam = 0.5
    while getsum(lam) < 1.0:
        lam_lo = lam
        lam *= 2.0
    lam_hi = lam
    while lam_hi - lam_lo > 1e-5:
        lam = (lam_lo + lam_hi) / 2.0
        if getsum(lam) >= 1.0:
            lam_hi = lam
        else:
            lam_lo = lam
    return lam


def avg_penalties(m: np.ndarray) -> Tuple[int, int]:
    """scoreMatrixGetAvgSubstScores (C truncating division)."""
    diag = [int(m[i, i]) for i in range(_MINALPHABET) if m[i, i] != 0]
    off = [int(m[i, j]) for i in range(_MINALPHABET) for j in range(_MINALPHABET)
           if i != j and m[i, j] != 0]
    match = int(sum(diag) / len(diag))
    mism = int(sum(off) / len(off))  # truncation toward zero as in C
    return match, mism


@dataclass
class ScoreProfile:
    """Per-read score profile: W[a, j] = matrix[a][alpha(query[j])]."""
    qcodes: np.ndarray       # mangled codes of the (possibly RC'd) read
    W: np.ndarray            # int32 [8, qlen] C-contiguous
    gap_init_pos: int        # positive penalties for the DP
    gap_ext_pos: int
    match_avg: int           # signed averages (scoreProfileGetAvgPenalties)
    mismatch_avg: int
    gap_init: int            # signed
    gap_ext: int
    lam: float               # complexity lambda

    @property
    def qlen(self) -> int:
        return self.W.shape[1]

    @property
    def W_addr(self) -> int:
        a = getattr(self, "_W_addr", None)
        if a is None:
            a = self.W.ctypes.data
            self._W_addr = a
        return a

    @classmethod
    def from_read(cls, qcodes: np.ndarray, matrix, gapopen: int, gapext: int,
                  lam: float) -> "ScoreProfile":
        qa = codec.alpha(qcodes)
        W = np.ascontiguousarray(matrix[:, qa], dtype=np.int32)
        match_avg, mismatch_avg = avg_penalties(matrix)
        return cls(qcodes=qcodes, W=W,
                   gap_init_pos=-gapopen, gap_ext_pos=-gapext,
                   match_avg=match_avg, mismatch_avg=mismatch_avg,
                   gap_init=gapopen, gap_ext=gapext, lam=lam)


@dataclass
class AliResult:
    """One alignment from the recursive driver (ALIRESULT)."""
    score: int
    qs: int    # profiled (query) start, 0-based
    qe: int
    rs: int    # unprofiled (subject) start, 0-based
    re: int
    diff: List[int]  # forward diff string incl. terminator


# ------------------------------------------------------------------
# DP kernels (C extension with exact reference recurrence)
# ------------------------------------------------------------------
# Per-module reusable scratch: H/E rows, the traceback matrix, and the
# subject-alpha conversion buffer.  One mapping worker is one process,
# so module-level scratch is safe.

from ..native import GrowBuf as _GrowBuf

_scr_H = _GrowBuf(np.int32)
_scr_E = _GrowBuf(np.int32)
_scr_dirm = _GrowBuf(np.uint8, 4096)
_scr_salpha = _GrowBuf(np.uint8, 1024)


def _subj_alpha_addr(subj_codes: np.ndarray):
    """(addr, len) of the subject's 3-bit codes.  The DP kernels mask
    with &7 internally, so any contiguous uint8 code array works
    as-is; otherwise convert into the reusable scratch buffer."""
    n = len(subj_codes)
    if subj_codes.dtype == np.uint8 and subj_codes.flags.c_contiguous:
        return subj_codes.ctypes.data, n
    buf = _scr_salpha.ensure(n)
    np.bitwise_and(subj_codes[:n], 7, out=buf[:n], casting="unsafe")
    return _scr_salpha.addr, n


def _he_addrs(qlen: int):
    _scr_H.ensure(qlen + 1)
    _scr_E.ensure(qlen + 1)
    return _scr_H.addr, _scr_E.addr


def align_band_fast(prof: ScoreProfile, subj_codes: np.ndarray,
                    l_edge: int, r_edge: int,
                    q_left: int, q_right: int,
                    s_left: int, s_right: int) -> int:
    """aliSmiWatInBandFast (alignment.c:1603): banded score-only pass."""
    slen = len(subj_codes)
    try:
        band = AliBand.make(l_edge, r_edge, q_left, q_right, prof.qlen,
                            s_left, s_right, slen)
    except BandError:
        return 0
    lib = get_lib()
    sp, _ = _subj_alpha_addr(subj_codes)
    Ha, Ea = _he_addrs(prof.qlen)
    return lib.sw_band_fast(prof.W_addr, prof.qlen, sp,
                            band.l_edge, band.r_edge, band.q_left, band.q_len,
                            band.s_left, band.s_len,
                            prof.gap_init_pos, prof.gap_ext_pos, Ha, Ea)


def sw_full_score(prof: ScoreProfile, subj_codes: np.ndarray) -> int:
    """Full-matrix local SW score (the reference's SIMD pass-1 kernel)."""
    lib = get_lib()
    sp, slen = _subj_alpha_addr(subj_codes)
    Ha, Ea = _he_addrs(prof.qlen)
    return lib.sw_full(prof.W_addr, prof.qlen, sp, slen,
                       prof.gap_init_pos, prof.gap_ext_pos, Ha, Ea)


def _align_band_track(prof: ScoreProfile, subj_alpha: np.ndarray,
                      band: AliBand):
    """alignSmiWatBand: returns (max_scor, max_i, max_j, dir)."""
    lib = get_lib()
    import ctypes
    nrows = band.s_len - band.s_left
    ndir = max(band.band_width * nrows, 1)
    dirm = _scr_dirm.ensure(ndir)
    dirm[:ndir] = 0
    mi = ctypes.c_int(0)
    mj = ctypes.c_int(0)
    sp, _ = _subj_alpha_addr(subj_alpha)
    Ha, Ea = _he_addrs(prof.qlen)
    sc = lib.sw_band_track(prof.W_addr, prof.qlen, sp,
                           band.l_edge, band.r_edge, band.q_left, band.q_len,
                           band.s_left, band.s_len,
                           prof.gap_init_pos, prof.gap_ext_pos,
                           band.band_width,
                           _scr_dirm.addr,
                           ctypes.byref(mi), ctypes.byref(mj), Ha, Ea)
    return sc, mi.value, mj.value, dirm


class CplxCounter:
    """ALICPLX (alignment.c:81-305): letter counts over matched/mismatched
    subject positions, used to complexity-weight the SW score."""

    def __init__(self, lam: float, n_types: int = 8):
        self.lam = lam
        self.n_types = n_types

    def scale(self, counts: np.ndarray, orig_score: int) -> Tuple[int, bool]:
        t_factor = 0.0
        t_sum = 0.0
        t_counts = 0
        for c in counts:
            c = int(c)
            if c:
                t_factor += c * math.log(c)
                t_sum += c * (-1.386294)  # LN0P25, alignment.c:71
                t_counts += c
        if t_counts == 0:
            return orig_score, False
        t_factor -= t_counts * math.log(t_counts)
        t_sum -= t_factor
        adj = int(orig_score + t_sum / self.lam + 0.999)
        if adj > orig_score:
            return adj, True  # ERRCODE_CPLXSCOR path
        if adj < 0:
            adj = 0
        return adj, False


_scr_back = _GrowBuf(np.uint8, 4096)
_scr_tbout = np.zeros(6, dtype=np.int64)
_scr_tbcnt = np.zeros(8, dtype=np.int64)


def _make_meta_from_track(prof: ScoreProfile, subj_alpha: np.ndarray,
                          band: AliBand, max_i: int, max_j: int,
                          max_scor: int, dirm: np.ndarray,
                          cplx: Optional[CplxCounter]):
    """makeMetaFromTrack (alignment.c:628-784).  Returns
    (score, prof_start, prof_end, nonprof_start, nonprof_end, back_diff)
    or raises ValueError on checksum mismatch."""
    lib = get_lib()
    if lib is not None:
        cap = 2 * (prof.qlen + len(subj_alpha)) + 8
        _scr_back.ensure(cap)
        sp, _ = _subj_alpha_addr(subj_alpha)
        rc = lib.mc_traceback(
            prof.W_addr, prof.qlen, sp,
            band.s_left, band.q_left, band.l_edge, band.band_width,
            max_i, max_j, max_scor,
            dirm.ctypes.data,
            prof.gap_init_pos, prof.gap_ext_pos,
            1 if cplx is not None else 0,
            _scr_back.addr, cap,
            _scr_tbout.ctypes.data, _scr_tbcnt.ctypes.data)
        if rc != 0:
            raise ValueError("traceback checksum mismatch")
        nback, ps, pe, ss, se, checksum = (int(v) for v in _scr_tbout)
        back = _scr_back.arr[:nback].tolist()
        score = checksum
        cplx_exceeded = False
        if cplx is not None:
            score, cplx_exceeded = cplx.scale(_scr_tbcnt.copy(), max_scor)
        return score, ps, pe, ss, se, back, cplx_exceeded
    W = prof.W
    gi, ge = prof.gap_init_pos, prof.gap_ext_pos
    bw = band.band_width
    back: List[int] = []
    nmatch = 0
    counts = np.zeros(8, dtype=np.int64)

    i = max_i
    j = max_j
    dpos = (max_i - band.s_left) * (bw - 1) + max_j - band.l_edge
    checksum = 0
    is_gap_open = False
    while i >= band.s_left and j >= band.q_left and dirm[dpos]:
        d = dirm[dpos]
        if d == 3:  # DIA
            s = int(W[subj_alpha[i], j])
            if s > 0:
                if nmatch > ds.MAXMISMATCH:
                    back.append(ds.setdiff(ds.MAXMISMATCH, ds.DIFFCOD_M))
                    nmatch -= ds.MAXMISMATCH
                else:
                    nmatch += 1
            else:
                back.append(ds.setdiff(nmatch, ds.DIFFCOD_S))
                nmatch = 0
            checksum += s
            if cplx is not None:
                counts[subj_alpha[i]] += 1
            is_gap_open = False
            dpos -= bw
            i -= 1
            j -= 1
            continue
        if is_gap_open:
            checksum -= ge
        else:
            checksum -= gi
            is_gap_open = True
        if d & 1:  # COL: gap in profiled sequence (deletion)
            back.append(ds.setdiff(nmatch, ds.DIFFCOD_D))
            nmatch = 0
            dpos -= bw - 1
            i -= 1
            continue
        if not (d & 2):
            raise ValueError("bad traceback code")
        back.append(ds.setdiff(nmatch, ds.DIFFCOD_I))
        nmatch = 0
        dpos -= 1
        j -= 1

    back.append(ds.setdiff(nmatch, ds.DIFFCOD_S))
    back.append(ds.setdiff(0, ds.DIFFCOD_M))

    nonprof_start = i + 1
    nonprof_end = max_i
    prof_start = j + 1
    prof_end = max_j

    if checksum != max_scor:
        raise ValueError(f"traceback checksum {checksum} != {max_scor}")
    score = checksum
    cplx_exceeded = False
    if cplx is not None:
        score, cplx_exceeded = cplx.scale(counts, max_scor)
    return score, prof_start, prof_end, nonprof_start, nonprof_end, back, cplx_exceeded


def align_band_recursive(prof: ScoreProfile, subj_codes: np.ndarray,
                         l_edge: int, r_edge: int,
                         q_left: int, q_right: int,
                         s_left: int, s_right: int,
                         minscore: int, minscorlen: int,
                         use_cplx: bool = False) -> List[AliResult]:
    """aliSmiWatInBand -> alignSmiWatBandRecursive (alignment.c:1300,1548)."""
    matchscor = prof.match_avg
    if minscore < 1 or matchscor <= 0:
        raise ValueError("bad minscore")
    if minscorlen * matchscor < minscore:
        minscorlen = minscore // matchscor
    if minscorlen < ALILEN_MIN:
        raise ValueError("minscorlen too small")
    subj_alpha = np.ascontiguousarray(codec.alpha(subj_codes), dtype=np.uint8)
    slen = len(subj_alpha)
    lib = get_lib()
    if lib is not None:
        r = _align_band_recursive_native(
            lib, prof, subj_alpha, slen, l_edge, r_edge, q_left, q_right,
            s_left, s_right, minscore, minscorlen, use_cplx)
        if r is not None:
            return r
    cplx = CplxCounter(prof.lam) if use_cplx else None
    out: List[AliResult] = []
    _recurse(prof, subj_alpha, prof.qlen, slen, l_edge, r_edge,
             q_left, q_right, s_left, s_right, minscore, minscorlen,
             cplx, out)
    return out


_scr_res = _GrowBuf(np.int64, 7 * 64)
_scr_diffpool = _GrowBuf(np.uint8, 4096)


def _align_band_recursive_native(lib, prof, subj_alpha, slen,
                                 l_edge, r_edge, q_left, q_right,
                                 s_left, s_right, minscore, minscorlen,
                                 use_cplx=False):
    qlen = prof.qlen
    ndir_cap = (qlen + slen + 2) * (slen + 1)
    _scr_dirm.ensure(ndir_cap)
    back_cap = 2 * (qlen + slen) + 8
    _scr_back.ensure(back_cap)
    diff_cap = 4 * (qlen + slen) + 1024
    _scr_diffpool.ensure(diff_cap)
    res_cap = slen // ALILEN_MIN + 4
    _scr_res.ensure(res_cap * 7)
    Ha, Ea = _he_addrs(qlen)
    sp, _ = _subj_alpha_addr(subj_alpha)
    n = lib.mc_align_recursive(
        prof.W_addr, qlen, sp, slen,
        l_edge, r_edge, q_left, q_right, s_left, s_right,
        minscore, minscorlen,
        prof.gap_init_pos, prof.gap_ext_pos,
        Ha, Ea,
        _scr_dirm.addr, ndir_cap,
        _scr_back.addr, back_cap,
        _scr_diffpool.addr, diff_cap,
        _scr_res.addr, res_cap,
        1 if use_cplx else 0, float(prof.lam))
    if n == -1:
        return None          # scratch overflow: Python fallback
    if n == -2:
        raise ValueError("traceback checksum mismatch")
    res = _scr_res.arr
    pool = _scr_diffpool.arr
    out: List[AliResult] = []
    for r in range(int(n)):
        o = r * 7
        off, dn = int(res[o + 5]), int(res[o + 6])
        out.append(AliResult(
            score=int(res[o]), qs=int(res[o + 1]), qe=int(res[o + 2]),
            rs=int(res[o + 3]), re=int(res[o + 4]),
            diff=pool[off : off + dn].tolist()))
    return out


def _recurse(prof, subj_alpha, q_len, s_len, l_edge, r_edge,
             q_left, q_right, s_left, s_right, minscore, minscorlen,
             cplx, out: List[AliResult]):
    if minscorlen < 2:
        raise ValueError("minscorlen < 2")
    try:
        band = AliBand.make(l_edge, r_edge, q_left, q_right, q_len,
                            s_left, s_right, s_len)
    except BandError:
        return
    max_scor, max_i, max_j, dirm = _align_band_track(prof, subj_alpha, band)
    if max_scor < minscore:
        return
    (score, prof_start, prof_end, nonprof_start, nonprof_end,
     back, _) = _make_meta_from_track(prof, subj_alpha, band, max_i, max_j,
                                      max_scor, dirm, cplx)
    if prof_start + minscorlen > prof_end + 1:
        return
    s_start, s_end = nonprof_start, nonprof_end
    if score >= minscore:
        fwd = ds.diffstr_reverse(back)
        out.append(AliResult(score=score, qs=prof_start, qe=prof_end,
                             rs=nonprof_start, re=nonprof_end, diff=fwd))
    if s_left + minscorlen < s_start:
        _recurse(prof, subj_alpha, q_len, s_len, l_edge, r_edge,
                 q_left, q_right, s_left, s_start - 1, minscore, minscorlen,
                 cplx, out)
    if s_right > s_end + minscorlen:
        _recurse(prof, subj_alpha, q_len, s_len, l_edge, r_edge,
                 q_left, q_right, s_end + 1, s_right, minscore, minscorlen,
                 cplx, out)


def score_diff_str(prof: ScoreProfile, subj_codes: np.ndarray,
                   prof_offs: int, diff) -> int:
    """aliScoreDiffStr (alignment.c:179-232): recompute the SW score of an
    alignment given as a diff string over a fetched subject segment."""
    from . import diffstr as _ds
    W = prof.W
    sa = codec.alpha(subj_codes)
    gi, ge = prof.gap_init_pos, prof.gap_ext_pos
    sw = 0
    rs = 0
    po = prof_offs
    is_open = False
    for i, b in enumerate(diff):
        if not b:
            break
        count, typ = _ds.diffstr_get(b)
        if typ == _ds.DIFFCOD_M or (typ == _ds.DIFFCOD_S and
                                    i + 1 < len(diff) and diff[i + 1]):
            count += 1
        if count > 0:
            is_open = False
            for _ in range(count):
                sw += int(W[sa[rs], po])
                rs += 1
                po += 1
        if typ in (_ds.DIFFCOD_I, _ds.DIFFCOD_D):
            if is_open:
                sw -= ge
            else:
                sw -= gi
                is_open = True
            if typ == _ds.DIFFCOD_I:
                po += 1
            else:
                rs += 1
    return sw
