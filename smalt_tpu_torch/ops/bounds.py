"""The work of the Smith-Waterman kernels and the least time an H100
could take for it.

For each kernel (ops/csrc/sw_full.cu, sw_band.cu, swq.cu; segcand.cu
below) a function
counts, from the inputs of one call, the DP cells those inputs need and
the bytes the function must move, and `bound` turns the two into the
kernel's roofline bound:

    bound = max(cells * OPS_PER_CELL / INT_OPS_PER_S, bytes / MEM_BYTES_PER_S)

Only what the data needs is counted: subject rows below `slen`, for the
banded kernels the cells inside the band and inside the query, and no
dummy windows.  Each input is read once and each output written once,
whatever the kernel reads again; scratch buffers do not count.

What is assumed, written out:
  - OPS_PER_CELL = 5 instructions a cell on the integer ALU.  It is the
    affine-gap recurrence's own count of max operations when Hopper's
    3-input integer instructions are used: H0 = max(T, E, 0); the
    running prefix max r = max(r, H0 + j*ge); its merge with the lanes
    to the left; H = max(H0, F); E = max(E - ge, H - go).  A max runs
    only on the integer ALU.  The plain add T = H' + w is left out,
    because the card can run it on its FMA pipe as an integer
    multiply-add beside the ALU; so are the score lookup, argmax
    tracking, pass 2's direction codes and everything a kernel does once
    a row.  So no kernel can beat the bound, and a share of it never
    reads over 100%.
  - INT_OPS_PER_S: an SM starts 64 int32 lane-instructions a clock (16
    lanes in each of its 4 sub-partitions), the card has 132 SMs, and
    the clock is taken at the H100 SXM's maximum of 1.98 GHz:
    132 * 64 * 1.98e9 = 1.673e13 a second, i.e. 3,345 G cells a second.
  - MEM_BYTES_PER_S = 3.35e12, the card's published memory rate.
Both rates assume the full 700 W power limit; print the limit of the
card beside any share (chip_smoke.py does).

No single PyTorch call computes any of these functions (a Smith-Waterman
score is a scan over rows with a prefix max inside), so there is no
library time to hold beside a kernel's.
"""
from __future__ import annotations

import numpy as np

SMS = 132
INT_LANES_PER_SM = 64
CLOCK_HZ = 1.98e9
INT_OPS_PER_S = SMS * INT_LANES_PER_SM * CLOCK_HZ
MEM_BYTES_PER_S = 3.35e12
OPS_PER_CELL = 5


def _np(x) -> np.ndarray:
    """A tensor (any device) or array as an int64 numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x).astype(np.int64)


def bound(cells: int, nbytes: int) -> dict:
    """The roofline bound of `cells` DP cells and `nbytes` bytes moved:
    {"cells", "bytes", "ops_ms", "bytes_ms", "bound_ms", "bound_by"}."""
    ops_ms = cells * OPS_PER_CELL / INT_OPS_PER_S * 1e3
    bytes_ms = nbytes / MEM_BYTES_PER_S * 1e3
    return {"cells": int(cells), "bytes": int(nbytes), "ops_ms": ops_ms,
            "bytes_ms": bytes_ms, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def share(bound_ms: float, measured_ms: float) -> float:
    """The share of its bound a kernel reached (1.0 = at the bound)."""
    return bound_ms / measured_ms


def query_ends(q) -> np.ndarray:
    """Each window's qend: one past its last query column whose code is
    not 7 (the pad code, which scores 0 against every code), 0 for a
    window of pad code only.  sw_full's strip path runs only the columns
    below it."""
    real = (_np(q) & 7) != 7
    if real.shape[1] == 0:
        return np.zeros(len(real), np.int64)
    return np.where(real.any(axis=1),
                    real.shape[1] - np.argmax(real[:, ::-1], axis=1), 0)


def sw_full_work(Q: int, S: int, slens, track: bool, q=None) -> dict:
    """sw_score_batch on q [B, Q], subj [B, S], slens [B] (int32 in,
    int32 out): every query column of every subject row below slen, or,
    given the query codes `q`, only the columns below each window's qend
    (query_ends: the cells inside the query, which the strip path runs);
    then "cells_all" and "bound_all_ms" keep the count over every column."""
    rows = np.minimum(_np(slens), S).clip(min=0)
    B = len(rows)
    cells = int(rows.sum()) * Q
    nbytes = 4 * (B * Q + int(rows.sum()) + B + 64) + \
        4 * B * (3 if track else 1)
    if q is None:
        return bound(cells, nbytes)
    out = bound(int((rows * query_ends(q)).sum()), nbytes)
    out.update(cells_all=cells, bound_all_ms=bound(cells, nbytes)["bound_ms"])
    return out


def band_cells(Q: int, S: int, W: int, prepad: int, rows) -> int:
    """Cells of a band of W lanes that lie inside the query: band lane t
    of subject row i is query column i - prepad + t, and a window runs
    its first rows[b] rows."""
    i = np.arange(S, dtype=np.int64)
    per_row = (np.minimum(Q, i - prepad + W) -
               np.maximum(0, i - prepad)).clip(min=0)
    upto = np.concatenate([[0], np.cumsum(per_row)])
    return int(upto[np.minimum(_np(rows), S).clip(min=0)].sum())


def sw_band_work(Q: int, S: int, W: int, pad: int, slens,
                 track: bool) -> dict:
    """sw_band_score_batch at band width W (as clamped) and window pad
    `pad`: the band's cells that fall inside the query, rows below slen.
    Of the subject a window reads its rows below slen, of the query all."""
    rows = np.minimum(_np(slens), S).clip(min=0)
    B = len(rows)
    cells = band_cells(Q, S, W, pad + W // 2, rows)
    nbytes = 4 * (B * Q + int(rows.sum()) + B + 64) + \
        4 * B * (3 if track else 1)
    return bound(cells, nbytes)


def swq_work(Qp: int, Sp: int, par) -> dict:
    """swq_fill_walk on par [W, 8] = {l_edge, r_edge, q_left, q_len,
    slen, valid, s_left, 0}: the in-band cells of the valid windows'
    rows [s_left, slen).  Inputs of dummy windows are not read (their
    par is); the int16 records are written for every window."""
    par = _np(par)
    le, re_, ql, qn, sn, vd, sl = (par[:, k] for k in range(7))
    W = len(par)
    valid = (vd != 0) & (sn > sl)
    start_lo = np.maximum(ql, le)
    lead = (ql - le).clip(min=0)
    i = np.arange(Sp, dtype=np.int64)[None, :]
    t_rel = i - sl[:, None]
    lo = (start_lo[:, None] + (t_rel - lead[:, None]).clip(min=0)).clip(0, Qp)
    hi = np.minimum(qn[:, None], re_[:, None] + 1 + t_rel).clip(0, Qp)
    live = valid[:, None] & (i >= sl[:, None]) & (i < sn[:, None])
    cells = int(np.where(live, (hi - lo).clip(min=0), 0).sum())
    nv = int(valid.sum())
    rows = int(np.where(valid, np.minimum(sn, Sp) - sl, 0).sum())
    nbytes = 4 * (nv * Qp + rows + 8 * W + 64) + 12 * W + 2 * W * Sp
    return bound(cells, nbytes)


# segcand.cu, the exact lane's seed / segment / candidate scan, is no
# Smith-Waterman kernel: its "cells" are the hits it walks, and a hit's
# step is counted at OPS_PER_HIT integer instructions, a floor (its
# compares and selects; the dependent chain a hit is some 100)
OPS_PER_HIT = 20


def segcand_work(tot, counts, C: int, ivl: bool) -> dict:
    """segcand_scan on lanes of tot [R] hits: each hit's keys read once
    (k1, k2 and, with sequence ids, ivl; 4 bytes each), each lane's
    first C candidate rows of 7 int32 written, its tot, mdsh and
    mincover read and its count and bad flag written."""
    t = _np(tot)
    hits = int(t.sum())
    rows = int(np.minimum(_np(counts), C).sum())
    nbytes = hits * (12 if ivl else 8) + 28 * rows + 20 * len(t)
    out = bound(hits * OPS_PER_HIT // OPS_PER_CELL, nbytes)
    out["cells"] = hits
    return out
