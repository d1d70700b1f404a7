"""Compressed alignment strings ("diff strings") and CIGAR emission.

Format (diffstr.h:28-72): each byte = 2-bit op in the top bits
{M=0, D=1, I=2, S=3} plus a 6-bit count of exact matches preceding the
op.  M carries an implicit extra match (m+1 matches); the string ends
with S:m followed by the 0 terminator M:0.  D = deletion in the query
(extra reference base), I = insertion in the query.
"""
from __future__ import annotations

from typing import List, Tuple

DIFFCOD_M = 0
DIFFCOD_D = 1
DIFFCOD_I = 2
DIFFCOD_S = 3
MAXMISMATCH = 61          # diffstr.h DIFFSTR_MAXMISMATCH
TYPSHIFT = 6
COUNTMASK = 0x3F

SYMBOLS = "MDIS"
SYMBOLS_X = "MDIX"


def setdiff(count: int, typ: int) -> int:
    return (count & COUNTMASK) + (typ << TYPSHIFT)


def diffstr_get(b: int) -> Tuple[int, int]:
    return b & COUNTMASK, b >> TYPSHIFT


def diffstr_reverse(back: List[int]) -> List[int]:
    """diffStrReverse (diffstr.c): convert a backward-walk string (already
    terminated with S:m, M:0) into the canonical forward string."""
    l = 0
    while l < len(back) and back[l]:
        l += 1
    l -= 1
    count_prev, typ = diffstr_get(back[l])
    if typ != DIFFCOD_S:
        raise ValueError("backward diff string must end in S")
    out: List[int] = []
    for i in range(l - 1, -1, -1):
        count, typ = diffstr_get(back[i])
        if typ == DIFFCOD_M:
            count_prev = (count_prev + count + 1) & 0xFF
            if count_prev > MAXMISMATCH:
                out.append(setdiff(MAXMISMATCH, DIFFCOD_M))
                count_prev -= MAXMISMATCH + 1
        else:
            out.append(setdiff(count_prev, typ))
            count_prev = count
    out.append(setdiff(count_prev, DIFFCOD_S))
    out.append(setdiff(0, DIFFCOD_M))
    return out


def diffstr_to_cigar(diff: List[int], extended: bool, silent_mismatch: bool,
                     clip_start: int = 0, clip_end: int = 0,
                     soft_clip: bool = False) -> str:
    """writeDiffStrCIGAR (diffstr.c): emit CIGAR text.

    extended => SAM style "<count><op>"; plain CIGAR is "<op> <count> ".
    silent_mismatch folds S into M ('M'); otherwise mismatches print 'X'.
    """
    clipchar = "S" if soft_clip else "H"
    parts: List[str] = []

    def emit(ch: str, ctr: int):
        if ctr > 0:
            parts.append(f"{ctr}{ch}" if extended else f"{ch} {ctr} ")

    if not diff:
        return "*"
    if clip_start > 0 and extended:
        emit(clipchar, clip_start)

    prev_count = 0
    prev_typ = DIFFCOD_M
    typ = DIFFCOD_M
    i = 0
    while i < len(diff) and diff[i]:
        count, typ = diffstr_get(diff[i])
        i += 1
        if prev_typ == DIFFCOD_M:
            prev_count += count
            if typ == DIFFCOD_M or (typ == DIFFCOD_S and silent_mismatch):
                prev_count += 1
                continue
        elif typ == prev_typ and count < 1:
            prev_count += 1
            continue
        if prev_count > 0:
            emit(SYMBOLS_X[prev_typ], prev_count)
        if typ == DIFFCOD_M or (typ == DIFFCOD_S and silent_mismatch):
            prev_count = count + 1
            prev_typ = DIFFCOD_M
        else:
            if count > 0 and prev_typ != DIFFCOD_M:
                emit(SYMBOLS_X[DIFFCOD_M], count)
            prev_count = 1
            prev_typ = typ
    if typ != DIFFCOD_S:
        raise ValueError("diff string must terminate with S, M:0")
    if prev_count > 1:  # may end with mismatch
        emit(SYMBOLS_X[DIFFCOD_M if silent_mismatch else DIFFCOD_S], prev_count - 1)
    if clip_end > 0 and extended:
        emit(clipchar, clip_end)
    return "".join(parts)


def levenshtein(diff: List[int]) -> int:
    """diffStrGetLevenshteinDistance (diffstr.c:1496): NM edit distance."""
    ed = 0
    typ = DIFFCOD_M
    for b in diff:
        if not b:
            break
        typ = b >> TYPSHIFT
        if typ != DIFFCOD_M:
            ed += 1
    if ed > 0 and typ == DIFFCOD_S:
        ed -= 1  # terminating S is not an edit
    return ed


def ali_len(diff: List[int]) -> Tuple[int, int]:
    """diffStrCalcAliLen (diffstr.c:932): (alignment_length, match_count)."""
    alilen = 0
    matchnum = 0
    typ = DIFFCOD_M
    for b in diff:
        if not b:
            break
        count, typ = diffstr_get(b)
        alilen += count + 1
        matchnum += count
        if typ == DIFFCOD_M:
            matchnum += 1
    if typ == DIFFCOD_S:
        alilen -= 1
    return alilen, matchnum


def seq_lens(diff: List[int]) -> Tuple[int, int]:
    """diffStrCalcSeqLen: (profiled/query length, unprofiled/subject length)
    spanned by the alignment."""
    pl = ul = 0
    typ = DIFFCOD_M
    for b in diff:
        if not b:
            break
        count, typ = diffstr_get(b)
        if typ == DIFFCOD_I:
            ul += count
            pl += count + 1
        elif typ == DIFFCOD_D:
            ul += count + 1
            pl += count
        else:
            ul += count + 1
            pl += count + 1
    if typ == DIFFCOD_S:
        pl -= 1
        ul -= 1
    return pl, ul


def scroll_start_end(diff: List[int], start_u: int, end_u: int):
    """scrollDIFFSTRStartEnd (diffstr.c): locate the sub-alignment covering
    unprofiled positions [start_u, end_u], snapping into exact matches.
    Returns (su, eu, sp, ep, count_start, count_end, typ_start,
    idx_start, idx_end) or raises NoMatch."""
    shift = 0
    shift_last = 0
    pos = 0
    count = 0
    count_add = 0
    typ = 0
    i = 0
    n = len(diff)
    while i < n and diff[i]:
        count, typ = diffstr_get(diff[i])
        shift_last = shift
        if typ == DIFFCOD_M:
            count += 1
            count_add = 0
        elif typ == DIFFCOD_S:
            count_add = 1
        elif typ == DIFFCOD_I:
            shift += 1
            count_add = 0
        else:
            count_add = 1
            shift -= 1
        pos += count
        if pos > start_u and count > 0:
            break
        pos += count_add
        i += 1
    if i >= n or not diff[i]:
        raise ValueError("scroll past end of diff string")
    idx_last = i
    count_start = pos - start_u
    if count_start > count:
        count_start = count
    su = pos - count_start
    sp = su + shift_last
    pos_last = pos
    pos += count_add
    idx_start = i
    typ_start = typ

    if su > end_u:
        raise NoMatch()
    if pos <= end_u:
        i += 1
        while i < n and diff[i]:
            count, typ = diffstr_get(diff[i])
            if count > 0:
                shift_last = shift
            if typ == DIFFCOD_M:
                count += 1
                count_add = 0
            elif typ == DIFFCOD_S:
                count_add = 1
            elif typ == DIFFCOD_I:
                count_add = 0
                shift += 1
            else:
                count_add = 1
                shift -= 1
            pos += count
            if count > 0:
                pos_last = pos
                idx_last = i
            pos += count_add
            if pos > end_u:
                break
            i += 1
        if i >= n or not diff[i]:
            i -= 1
    if pos_last > end_u:
        count_end = pos_last - end_u - 1
        if count_end > count:
            raise AssertionError("scroll inconsistency")
        count_end = count - count_end
        eu = end_u
        idx_end = i
    else:
        count, typ = diffstr_get(diff[idx_last])
        if typ == DIFFCOD_M:
            count += 1
        count_end = count
        eu = pos_last - 1
        idx_end = idx_last
    ep = eu + shift_last
    return su, eu, sp, ep, count_start, count_end, typ_start, idx_start, idx_end


class NoMatch(Exception):
    """segment contains no exact match (ERRCODE_NOMATCH)"""


def segment(diff: List[int], start_u: int, end_u: int):
    """diffStrSegment (diffstr.c): extract the sub-diff-string covering
    unprofiled range [start_u, end_u].
    Returns (subdiff, su, eu, sp, ep)."""
    (su, eu, sp, ep, nm_start, nm_end, typ_start,
     idx_start, idx_end) = scroll_start_end(diff, start_u, end_u)
    out: List[int] = []
    nmatch = 0
    if idx_start == idx_end:
        count, typ = diffstr_get(diff[idx_start])
        if typ == DIFFCOD_M:
            count += 1
        nm_end = (nm_end + nm_start - count) & 0xFF
    else:
        if typ_start == DIFFCOD_M:
            nmatch = nm_start
        elif nm_start > 0:
            out.append(setdiff(nm_start, typ_start))
            nmatch = 0
        for i in range(idx_start + 1, idx_end):
            if not diff[i]:
                break
            count, typ = diffstr_get(diff[i])
            nmatch += count
            if typ == DIFFCOD_M:
                nmatch += 1
                continue
            while nmatch > MAXMISMATCH:
                out.append(setdiff(MAXMISMATCH, DIFFCOD_M))
                nmatch -= MAXMISMATCH + 1
            out.append(setdiff(nmatch, typ))
            nmatch = 0
    nmatch += nm_end
    while nmatch > MAXMISMATCH + 1:
        out.append(setdiff(MAXMISMATCH, DIFFCOD_M))
        nmatch -= MAXMISMATCH + 1
    out.append(setdiff(nmatch, DIFFCOD_S))
    out.append(setdiff(0, DIFFCOD_M))
    return out, su, eu, sp, ep
