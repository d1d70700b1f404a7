"""Device-resident index and the fast mapping step, on one torch device.

Counterpart of the single-device half of smalt_tpu/parallel/mesh.py.
`device_map_step` is the device pass of `map --fast`: k-mer words ->
index lookup -> rarest+common seed selection -> hit expansion ->
densest-diagonal vote per strand -> three reference windows per read ->
tracked Smith-Waterman (the Hopper kernels in ops/sw.py: full-matrix for
reads padded to at most LONG_READ_Q, banded above) -> best and runner-up
window per read.  The host then runs the traceback tail and writes SAM
(map/fastmode.py FastTail).

Everything here is plain torch on int32 tensors, held to the JAX step
value for value.  Places where torch would otherwise drift from JAX:
selections that JAX makes with `lax.top_k` or a stable `argsort` use
stable torch sorts (torch.topk orders ties differently); the int32
shifts and sentinel subtractions stay in int32 so that they wrap as in
JAX; every gather index is clipped as the JAX code clips it, since an
out-of-range index is a device-side fault on CUDA.

Word lengths up to 15 look words up in a direct-addressed offset table
(k <= 14) or by binary search over the sorted words (k = 15); k = 16..20
split each word into a 12-base prefix, direct-addressed, and a suffix
found by a fixed number of binary-search steps in its prefix's bucket
(`_lookup_hilo`), as the JAX index does.  The sharded steps are not
ported yet.
"""
from __future__ import annotations

import math
import os
import sys
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..index.table import KmerIndex
from ..ops.sw import (band_width_for, device_matrix, sw_band_score_batch,
                      sw_score_batch)
from ..seq import codec
from ..seq.refset import RefSet

# Re-declared from smalt_tpu/parallel/mesh.py (which imports jax); a
# test holds them equal.
LONG_READ_Q = 512  # reads padded longer run the banded kernel
NSEED = 16         # rarest query k-mers expanded per strand
NSEED_COMMON = 4   # highest-count query k-mers expanded per strand
MAXC = 6           # positions expanded per k-mer word
WIN_PAD = 16       # reference window padding around the seed diagonal

_I32 = torch.int32
_NO_SHIFT = -(1 << 30)   # expanded-hit sentinel: sorts first, never votes


def window_len(Q: int) -> int:
    """Subject-window length for query length Q (mesh.py:72)."""
    slack = max(8, Q // 8)
    return max(128, -(-(Q + slack) // 128) * 128)


def window_pad(Q: int) -> int:
    """Left backoff of the gathered window before the seed diagonal."""
    return min((window_len(Q) - Q) // 2, max(2 * WIN_PAD, Q // 16))


@dataclass
class DeviceIndex:
    """A KmerIndex and the reference codes as int32 tensors on one device.

    With 2k <= DIRECT_BITS, `table` is the direct-addressed offset table
    int32 [4^k, 2] (table[w] = {starts[w], starts[w+1]}, 512 MiB at
    k = 13) and a lookup is one gather.  For k = 15 lookups binary-search
    the sorted `words`.  For k = 16..20 (2k > 31: a packed word no longer
    fits int32) the word splits into a HI_BASES-base prefix, whose
    `hi_table` [4^12, 2] int32 holds the extent of its bucket in the
    sorted word list (128 MiB), and a (k - 12)-base suffix in `words_lo`;
    a lookup is one hi gather and `lo_steps` = ceil(log2(largest bucket +
    1)) binary-search gathers (mesh.py:85-99)."""
    wordlen: int
    nskip: int
    words: torch.Tensor      # [W] int32 packed 2k-bit words (k <= 15)
    starts: torch.Tensor     # [W+1] int32 CSR offsets into pos
    pos: torch.Tensor        # [Npos] int32 tuple serial numbers
    ref_alpha: torch.Tensor  # [L] int32 3-bit reference codes
    ref_len: int
    table: Optional[torch.Tensor] = None  # [4^k, 2] int32 offset pairs
    hi_table: Optional[torch.Tensor] = None  # [4^12, 2] int32 extents
    words_lo: Optional[torch.Tensor] = None  # [W] int32 low suffixes
    lo_steps: int = 0

    DIRECT_BITS = 28
    HI_BASES = 12

    @classmethod
    def build(cls, refset: RefSet, idx: KmerIndex,
              device) -> "DeviceIndex":
        """Upload a host index (mesh.py:125) to `device`."""
        k = idx.wordlen
        if k > 20:
            raise ValueError("device path supports wordlen<=20 "
                             "(the reference's own max, menu.c:595)")
        arrays = {
            "starts": idx.starts.astype(np.int32),
            "pos": idx.pos.astype(np.int32),
            "ref_alpha": codec.alpha(refset.codes).astype(np.int32),
        }
        meta = {"wordlen": k, "nskip": idx.nskip,
                "ref_len": refset.total_len}
        if 2 * k <= 31:
            arrays["words"] = idx.words.astype(np.int64).astype(np.int32)
            if 2 * k <= cls.DIRECT_BITS:
                counts = np.zeros((1 << (2 * k)) + 1, np.int64)
                counts[idx.words.astype(np.int64) + 1] = np.diff(idx.starts)
                t32 = np.cumsum(counts).astype(np.int32)
                del counts
                arrays["table"] = np.stack([t32[:-1], t32[1:]], axis=1)
        else:
            lo_bits = 2 * (k - cls.HI_BASES)
            w = idx.words.astype(np.int64)       # sorted ascending
            hi = w >> lo_bits
            nhi = np.arange(1 << (2 * cls.HI_BASES))
            bstart = np.searchsorted(hi, nhi, side="left").astype(np.int32)
            bend = np.searchsorted(hi, nhi, side="right").astype(np.int32)
            del nhi, hi
            arrays["hi_table"] = np.stack([bstart, bend], axis=1)
            arrays["words_lo"] = (w & ((1 << lo_bits) - 1)).astype(np.int32)
            arrays["words"] = np.zeros(1, np.int32)   # unused in hi/lo mode
            big = int((bend.astype(np.int64) - bstart).max()) if len(w) else 1
            meta["lo_steps"] = max(1, int(np.ceil(np.log2(max(big, 1) + 1))))
        return cls.from_numpy(arrays, meta, device)

    @classmethod
    def build_ref_only(cls, refset: RefSet, idx: KmerIndex,
                       device) -> "DeviceIndex":
        """The reference codes only (mesh.py:178), for the host-hits
        regime of `--device-exact`, whose device step never reads the
        k-mer table: no table or positions upload, and no k limit."""
        z = np.zeros(1, np.int32)
        return cls.from_numpy(
            {"words": z, "starts": z, "pos": z,
             "ref_alpha": codec.alpha(refset.codes).astype(np.int32)},
            {"wordlen": idx.wordlen, "nskip": idx.nskip,
             "ref_len": refset.total_len}, device)

    @classmethod
    def from_numpy(cls, arrays: dict, meta: dict, device) -> "DeviceIndex":
        """Carry an index across from numpy arrays named after the
        fields (words, starts, pos, ref_alpha, optional table, hi_table
        and words_lo) and `meta` = {wordlen, nskip, ref_len, lo_steps (0
        if absent)} — e.g. the fields of the JAX package's DeviceIndex."""

        def up(name):
            a = arrays.get(name)
            if a is None:
                return None
            a = np.ascontiguousarray(a, dtype=np.int32)
            if not a.flags.writeable:     # e.g. a view of a JAX array
                a = a.copy()
            return torch.from_numpy(a).to(device)

        return cls(wordlen=int(meta["wordlen"]), nskip=int(meta["nskip"]),
                   words=up("words"), starts=up("starts"), pos=up("pos"),
                   ref_alpha=up("ref_alpha"), ref_len=int(meta["ref_len"]),
                   table=up("table"), hi_table=up("hi_table"),
                   words_lo=up("words_lo"),
                   lo_steps=int(meta.get("lo_steps", 0)))

    @property
    def device(self) -> torch.device:
        return self.pos.device


def _rev_groups2(x):
    """Reverse the sixteen 2-bit groups of an int32 lane-wise (4 masked
    butterfly steps; shifts wrap and sign-extend as in int32 JAX)."""
    x = ((x & 0x33333333) << 2) | ((x >> 2) & 0x33333333)
    x = ((x & 0x0F0F0F0F) << 4) | ((x >> 4) & 0x0F0F0F0F)
    x = ((x & 0x00FF00FF) << 8) | ((x >> 8) & 0x00FF00FF)
    return ((x & 0xFFFF) << 16) | ((x >> 16) & 0xFFFF)


def _query_words(reads, k: int):
    """Forward and reverse-complement k-mer words per query position.
    reads: [B, Q] int32 3-bit codes.  Returns (fwd, rc, valid): [B, P]."""
    B, Q = reads.shape
    P_ = Q - k + 1
    std = reads & 3
    fwd = torch.zeros((B, P_), dtype=_I32, device=reads.device)
    for j in range(k):
        fwd = (fwd << 2) | std[:, j : j + P_]
    # mask after the shift: the reversed value can carry the sign bit
    # and int32 >> sign-extends
    mask = (1 << (2 * k)) - 1
    rc = (_rev_groups2(fwd ^ mask) >> (2 * (16 - k))) & mask
    bad = (reads & 4) >> 2
    cbad = torch.cumsum(bad, dim=1, dtype=_I32)
    prev = torch.nn.functional.pad(cbad[:, : Q - k], (1, 0))
    nbad = cbad[:, k - 1 :] - prev
    return fwd, rc, nbad == 0


def _pack_window(std, off: int, width: int, P_: int):
    """Pack `width` 2-bit codes starting at query offset `off` for all P_
    window positions: [B, P_] int32, MSB-first (mesh.py:228)."""
    acc = torch.zeros((std.shape[0], P_), dtype=_I32, device=std.device)
    for j in range(width):
        acc = (acc << 2) | std[:, off + j : off + j + P_]
    return acc


def _rev_groups_w(x, w: int):
    """Reverse the first w 2-bit groups of a packed value (width 2w)."""
    return (_rev_groups2(x) >> (2 * (16 - w))) & ((1 << (2 * w)) - 1)


def _query_words_hilo(reads, k: int):
    """Query words for k in 16..20 as (hi, lo) int32 pairs per strand
    (mesh.py:245): hi = the first HI_BASES bases (24 bits), lo = the
    remaining k - 12.  Returns (fwd_hi, fwd_lo, rc_hi, rc_lo, valid),
    each [B, P]."""
    HB = DeviceIndex.HI_BASES
    B, Q = reads.shape
    P_ = Q - k + 1
    wlo = k - HB
    std = reads & 3
    fwd_hi = _pack_window(std, 0, HB, P_)
    fwd_lo = _pack_window(std, HB, wlo, P_)
    # the rc word of window [p, p+k): its first 12 bases are the revcomp
    # of the window's LAST 12, its low suffix the revcomp of the FIRST k-12
    tail12 = _pack_window(std, k - HB, HB, P_)
    head_lo = _pack_window(std, 0, wlo, P_)
    rc_hi = _rev_groups_w(tail12 ^ ((1 << (2 * HB)) - 1), HB)
    rc_lo = _rev_groups_w(head_lo ^ ((1 << (2 * wlo)) - 1), wlo)
    bad = (reads & 4) >> 2
    cbad = torch.cumsum(bad, dim=1, dtype=_I32)
    prev = torch.nn.functional.pad(cbad[:, : Q - k], (1, 0))
    nbad = cbad[:, k - 1 :] - prev
    return fwd_hi, fwd_lo, rc_hi, rc_lo, nbad == 0


def _lookup_hilo(di: DeviceIndex, qhi, qlo, valid):
    """(counts, pos_base, hit) for the split-word index (mesh.py:270):
    one hi-table gather for the bucket extent, then `lo_steps` unrolled
    lower-bound gathers over the sorted low suffixes."""
    ext = di.hi_table[qhi.long()]                # [..., 2]
    lo_arr = di.words_lo
    n_lo = lo_arr.shape[0]
    lo_s = ext[..., 0]
    hi_s = ext[..., 1]
    end = ext[..., 1]
    for _ in range(di.lo_steps):
        active = lo_s < hi_s
        mid = (lo_s + hi_s) >> 1
        mv = lo_arr[mid.clamp(0, n_lo - 1).long()]
        go_right = active & (mv < qlo)
        lo_s = torch.where(go_right, mid + 1, lo_s)
        hi_s = torch.where(active & ~go_right, mid, hi_s)
    slot = lo_s.clamp(0, n_lo - 1).long()
    hit = valid & (lo_s < end) & (lo_arr[slot] == qlo)
    counts = torch.where(hit, di.starts[slot + 1] - di.starts[slot], 0)
    base = di.starts[torch.where(hit, slot, 0)]
    return counts, base, hit


def _lookup(di: DeviceIndex, qwords, valid):
    """Index lookup: (counts, pos_base, hit) with miss -> count 0.
    pos_base is the offset of the word's first position in di.pos."""
    if di.table is not None:
        pair = di.table[qwords.long()]           # [..., 2]: one gather
        s0 = pair[..., 0]
        counts = torch.where(valid, pair[..., 1] - s0, 0)
        return counts, s0, counts > 0
    nw = di.words.shape[0]
    ix = torch.searchsorted(di.words, qwords.contiguous()).to(_I32)
    ixc = torch.clamp(ix, 0, nw - 1).long()
    hit = (di.words[ixc] == qwords) & valid
    counts = torch.where(hit, di.starts[ixc + 1] - di.starts[ixc], 0)
    base = di.starts[torch.where(hit, ixc, 0)]
    return counts, base, hit


def _expand_hits(di: DeviceIndex, base, counts, qoffs, is_reverse: bool):
    """Expand up to MAXC positions per selected seed into diagonal shifts
    (tuple units): forward pos - qoffs//nskip, reverse pos + qoffs//nskip.
    base: [B, NSEED] offsets of each word's first position in di.pos.
    Returns (shift, ok): [B, NSEED*MAXC]."""
    B = base.shape[0]
    offs = torch.arange(MAXC, dtype=_I32, device=base.device)
    pidx = torch.clamp(base[:, :, None] + offs, 0, di.pos.shape[0] - 1)
    pos = di.pos[pidx.long()]                    # [B, NSEED, MAXC]
    ok = offs < counts[:, :, None]
    qo = (qoffs // di.nskip)[:, :, None]
    shift = pos + qo if is_reverse else pos - qo
    shift = torch.where(ok, shift, _NO_SHIFT)
    return shift.reshape(B, -1), ok.reshape(B, -1)


def _take(x, ix):
    """x[b, ix[b]] for a [B] index."""
    return torch.gather(x, 1, ix[:, None])[:, 0]


def _best_diagonal(shift, ok, tol: int):
    """Densest diagonal run per read (mesh.py:351).  Returns
    (best_shift, votes, second_shift, second_votes, n2nd_est)."""
    B, N = shift.shape
    s = torch.sort(shift, dim=1).values
    votes = torch.zeros((B, N), dtype=_I32, device=s.device)
    for d in range(1, min(N, 16)):
        nb = torch.cat([s[:, d:], torch.full((B, d), 1 << 30, dtype=_I32,
                                             device=s.device)], dim=1)
        # wraps to negative for the sentinels, which `valid` then masks
        votes = votes + ((nb - s) <= tol).to(_I32)
    valid = s > -(1 << 29)
    votes = torch.where(valid, votes + 1, 0)
    b1 = torch.argmax(votes, dim=1)              # first maximum, as JAX
    best = _take(s, b1)
    v1 = _take(votes, b1)
    far = (s - best[:, None]).abs() > 2 * tol
    votes2 = torch.where(far, votes, 0)
    b2 = torch.argmax(votes2, dim=1)
    second = _take(s, b2)
    v2 = _take(votes2, b2)
    # cluster starts: first sorted entry, or a jump > tol from the left
    # neighbour; a start's vote count covers its whole cluster
    starts_ = torch.cat(
        [valid[:, :1], (s[:, 1:] - s[:, :-1] > tol) & valid[:, 1:]], dim=1)
    n2nd = (starts_ & far & (votes == v2[:, None]) &
            (v2[:, None] > 0)).sum(dim=1).to(_I32)
    return best, v1, second, v2, torch.clamp_min(n2nd, 1)


def _gather_windows(di: DeviceIndex, shifts, S: int, origin_off):
    """Reference windows [B, S] starting at shift*nskip + origin_off."""
    start = shifts * di.nskip + origin_off       # int32, wraps as in JAX
    start = torch.clamp(start, 0, max(di.ref_len - S, 0))
    offs = torch.arange(S, dtype=_I32, device=shifts.device)
    gidx = torch.clamp(start[:, None] + offs, 0, di.ref_len - 1)
    return di.ref_alpha[gidx.long()], start


def _topk_first(key, n: int):
    """Indices of the n largest keys per row, ties to the lower index
    first, in descending key order: what `jax.lax.top_k` returns."""
    return torch.sort(-key, dim=1, stable=True).indices[:, :n]


def _seed_stride(P_avail: int, nskip: int) -> int:
    """Query-side seed sampling stride: table gathers dominate seeding,
    so skip query positions when there are plenty, with a stride that
    is coprime with the index stride (else only alignments in matching
    phase keep any seeds), keeping >= ~12 phase-matching positions."""
    for c in (2, 3):
        if math.gcd(c, nskip) == 1 and P_avail >= 12 * c * nskip:
            return c
    return 0


def device_seed_votes(di: DeviceIndex, reads):
    """Seeding + diagonal voting half of the step (mesh.py:400).
    Returns (outs, hits_used, hits_tot) with outs = [(b1, v1, b2, v2,
    nc2) for fwd, rev]."""
    B, Q = reads.shape
    k = di.wordlen
    hilo = di.words_lo is not None
    if hilo:
        fh, fl, rh, rl, valid = _query_words_hilo(reads, k)
        fwd = torch.stack([fh, fl])              # [2, B, P]
        rc = torch.stack([rh, rl])
    else:
        fwd, rc, valid = _query_words(reads, k)
    stride = _seed_stride(valid.shape[1], di.nskip)
    if stride:
        # report the sensitivity trade once per process
        if os.environ.get("SMALT_TIMING") and \
                not getattr(device_map_step, "_stride_noted", False):
            device_map_step._stride_noted = True
            print(f"# device seeding: query positions sampled at "
                  f"stride {stride} (coprime with nskip={di.nskip}; "
                  f">= {valid.shape[1] // (stride * di.nskip)} "
                  f"phase-matching seeds kept per read)",
                  file=sys.stderr)
        fwd = fwd[..., ::stride]
        rc = rc[..., ::stride]
        valid = valid[:, ::stride]
    qoffs = (max(stride, 1) * torch.arange(
        valid.shape[1], dtype=_I32, device=reads.device)).expand(
            valid.shape)

    tol = max(k * 3 // di.nskip, 1)
    outs = []
    hits_used = torch.zeros(B, dtype=_I32, device=reads.device)
    hits_tot = torch.zeros(B, dtype=_I32, device=reads.device)
    for is_reverse, words in ((False, fwd), (True, rc)):
        if hilo:
            counts, base, hit = _lookup_hilo(di, words[0], words[1], valid)
        else:
            counts, base, hit = _lookup(di, words, valid)
        P_avail = valid.shape[1]
        # rarest seeds first (0 = miss sorts last)
        sel = _topk_first(-torch.where(hit, counts, 1 << 30),
                          min(NSEED, P_avail))
        if P_avail > NSEED:
            # common pool: the most repeated words that still hit
            selc = _topk_first(torch.where(hit, counts, 0),
                               min(NSEED_COMMON, P_avail))
            sel = torch.cat([sel, selc], dim=1)
        sel_base = torch.gather(base, 1, sel)
        sel_true = torch.gather(counts, 1, sel)
        sel_qoffs = torch.gather(qoffs, 1, sel)
        sel_hit = torch.gather(hit, 1, sel)
        # search-completeness bookkeeping (results.c n_hits_used/tot);
        # the per-word clamp bounds a single megarepeat word
        sel_true = torch.where(sel_hit, torch.clamp_max(sel_true, 1 << 14),
                               0)
        hits_tot = hits_tot + sel_true.sum(dim=1).to(_I32)
        sel_counts = torch.clamp_max(sel_true, MAXC)
        hits_used = hits_used + sel_counts.sum(dim=1).to(_I32)
        shift, ok = _expand_hits(di, sel_base, sel_counts, sel_qoffs,
                                 is_reverse)
        outs.append(_best_diagonal(shift, ok, tol))
    return outs, hits_used, hits_tot


def _revcomp_batch(reads):
    """Reverse complement [B, Q] alpha codes (nonstd codes unchanged)."""
    rev = torch.flip(reads, dims=[1])
    return torch.where((rev & 4) == 0, rev ^ 3, rev)


def device_map_step(di: DeviceIndex, reads, matrix, gapopen_pos: int,
                    gapext_pos: int):
    """Fast mapping step for a padded read batch on di's device.

    reads: [B, Q] integer alpha codes (0..7), padded reads all-7, any
    integer dtype.  matrix: [8, 8] score matrix (tensor on di.device).
    Returns the per-read dict of OUT_KEYS, int32 [B] tensors."""
    reads = reads.to(_I32)
    B, Q = reads.shape
    k = di.wordlen
    S = window_len(Q)
    pad = window_pad(Q)
    outs, hits_used, hits_tot = device_seed_votes(di, reads)

    # three windows per read: the best diagonal of each strand plus the
    # better (by votes) of the two second diagonals.  forward: the
    # alignment starts near diag*nskip; reverse: the RC read's window
    # ends at the last seed, so the origin backs off by Q-k.
    (b1f, v1f, b2f, v2f, nc2f), (b1r, v1r, b2r, v2r, nc2r) = outs
    org_f = -pad
    org_r = -(Q - k) - pad
    sel_rev = v2r > v2f
    b2 = torch.where(sel_rev, b2r, b2f)
    v2 = torch.where(sel_rev, v2r, v2f)
    nc2 = torch.where(sel_rev, nc2r, nc2f)
    org2 = org_f + (org_r - org_f) * sel_rev.to(_I32)

    win_f, start_f = _gather_windows(di, b1f, S, org_f)
    win_r, start_r = _gather_windows(di, b1r, S, org_r)
    win_2, start_2 = _gather_windows(di, b2, S, org2)

    qc_r = _revcomp_batch(reads)
    qc_2 = torch.where(sel_rev[:, None], qc_r, reads)
    wins = torch.cat([win_f, win_r, win_2])                  # [3B, S]
    starts = torch.cat([start_f, start_r, start_2])
    votes = torch.cat([v1f, v1r, v2])
    strands = torch.cat([torch.zeros(B, dtype=_I32, device=reads.device),
                         torch.ones(B, dtype=_I32, device=reads.device),
                         sel_rev.to(_I32)])
    qcs = torch.cat([reads, qc_r, qc_2])
    slens = torch.full((3 * B,), S, dtype=_I32, device=reads.device)
    if Q > LONG_READ_Q:
        # kilobase reads: banded scoring around the seed diagonal, which
        # the window gather placed `pad` columns in; the tracked anchor
        # centres the host tail's narrow traceback band (mesh.py:663)
        scores, tis, tjs = sw_band_score_batch(
            qcs, wins, slens, matrix, gapopen_pos, gapext_pos, pad=pad,
            W=band_width_for(Q, pad), device=reads.device, track=True)
    else:
        scores, tis, tjs = sw_score_batch(qcs, wins, slens, matrix,
                                          gapopen_pos, gapext_pos,
                                          device=reads.device, track=True)
    scores = torch.where(votes > 0, scores, 0)
    v1 = torch.where(sel_rev, v1r, v1f)
    return _pick_best(scores.reshape(3, B), starts.reshape(3, B),
                      strands.reshape(3, B), tis.reshape(3, B),
                      tjs.reshape(3, B), nc2, v1, v2, hits_used, hits_tot)


def _pick_best(sc, st, sd, ti3, tj3, nc2, v1, v2, hits_used, hits_tot):
    """Rank the (3, B) scored windows into the per-read output dict."""
    order = torch.argsort(-sc, dim=0, stable=True)

    def first(x, r):
        return torch.gather(x, 0, order[r : r + 1])[0]

    best = first(sc, 0)
    second = first(sc, 1)
    # results.c's n_swatscor_2nd analogue: window-level runner-up
    # multiplicity, widened by the cluster estimate
    n2nd = (sc == second[None, :]).sum(dim=0).to(_I32) - \
        (best == second).to(_I32)
    n2nd = torch.maximum(n2nd, nc2)
    # multi-copy ambiguity: several distinct far diagonal clusters tie
    # near the winner's vote count (MAPSCOR_MAX_RANDOM cap in the tail)
    ambig = (nc2 >= 2) & (v2 * 4 >= v1 * 3)
    return {
        "score": best,
        "score2": second,
        "start": first(st, 0),
        "strand": first(sd, 0),
        "start2": first(st, 1),
        "strand2": first(sd, 1),
        "hits_used": hits_used,
        "hits_tot": hits_tot,
        "n2nd": torch.clamp_min(n2nd, 1),
        "ambig": ambig.to(_I32),
        "tb_i": first(ti3, 0),
        "tb_j": first(tj3, 0),
    }


OUT_KEYS = ("score", "score2", "start", "strand", "start2", "strand2",
            "hits_used", "hits_tot", "n2nd", "ambig", "tb_i", "tb_j")


def pack_outputs(out):
    """Stack the per-read output dict into ONE [len(OUT_KEYS), B] int32
    tensor on the device: one device-to-host copy per batch."""
    return torch.stack([out[k].to(_I32) for k in OUT_KEYS])


def make_device_step(di: DeviceIndex, matrix, gapopen_pos: int,
                     gapext_pos: int, pack: bool = False):
    """The mapping step bound to `di` (mesh.py:1084): reads -> the
    output dict, or with pack=True the packed [len(OUT_KEYS), B]
    tensor.  The score matrix moves to di's device once."""
    mat = device_matrix(matrix, di.device)

    def step(reads):
        out = device_map_step(di, reads, mat, gapopen_pos, gapext_pos)
        return pack_outputs(out) if pack else out

    return step
