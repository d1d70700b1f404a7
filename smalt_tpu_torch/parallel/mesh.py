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
(`_lookup_hilo`), as the JAX index does.

The mesh steps (`make_sharded_step`, `make_index_sharded_step`) run the
same step over a dp x ip `spmd.Mesh`: reads split over dp; over ip the
index is replicated (every member runs the whole step and the results
combine) or range-sharded (`ShardedDeviceIndex`: each member seeds on its
slice, the global seed votes come from exchanged counts and shifts, and
each window is scored once, by one member, from window bytes exchanged
among them).  Both give the single-device step's outputs, except that the
index-sharded step scores every window full-matrix, as the JAX one does,
where the single-device step scores reads padded past LONG_READ_Q banded.
"""
from __future__ import annotations

import math
import os
import sys
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ..index.table import KmerIndex
from ..ops.sw import (band_width_for, device_matrix, sw_band_score_batch,
                      sw_score_batch)
from ..seq import codec
from ..seq.refset import RefSet
from .spmd import Mesh

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

    def copy_to(self, device) -> "DeviceIndex":
        """A copy of its own on `device` (a new tensor for every field,
        on the same device too): one mesh member's index."""
        def cp(t):
            return None if t is None else t.to(device, copy=True)
        return replace(
            self, words=cp(self.words), starts=cp(self.starts),
            pos=cp(self.pos), ref_alpha=cp(self.ref_alpha),
            table=cp(self.table), hi_table=cp(self.hi_table),
            words_lo=cp(self.words_lo))


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


def _best_diagonal(shift, ok, tol: int, presorted: bool = False):
    """Densest diagonal run per read (mesh.py:351).  Returns
    (best_shift, votes, second_shift, second_votes, n2nd_est).
    presorted: `shift` is already ascending (invalid -2^30 first)."""
    B, N = shift.shape
    s = shift if presorted else torch.sort(shift, dim=1).values
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


def _seed_words(di: DeviceIndex, reads):
    """Both strands' query words at the sampled query positions
    (mesh.py:407-449): (fwd, rc, valid, qoffs, stride), fwd and rc [B, P]
    words, or [2, B, P] (hi, lo) pairs for the split-word index."""
    k = di.wordlen
    if di.words_lo is not None:
        fh, fl, rh, rl, valid = _query_words_hilo(reads, k)
        fwd = torch.stack([fh, fl])              # [2, B, P]
        rc = torch.stack([rh, rl])
    else:
        fwd, rc, valid = _query_words(reads, k)
    stride = _seed_stride(valid.shape[1], di.nskip)
    if stride:
        fwd = fwd[..., ::stride]
        rc = rc[..., ::stride]
        valid = valid[:, ::stride]
    qoffs = (max(stride, 1) * torch.arange(
        valid.shape[1], dtype=_I32, device=reads.device)).expand(
            valid.shape)
    return fwd, rc, valid, qoffs, stride


def _lookup_words(di: DeviceIndex, words, valid):
    """_lookup_hilo for the split-word index, else _lookup."""
    if di.words_lo is not None:
        return _lookup_hilo(di, words[0], words[1], valid)
    return _lookup(di, words, valid)


def _select_seeds(counts, hit):
    """Seed selection, [B, NSEED (+ NSEED_COMMON)] query positions: the
    rarest hitting words first (0 = miss sorts last), then, with more
    than NSEED positions, the common pool: the most repeated words that
    still hit, which carry the other copies of a repeat."""
    P_avail = counts.shape[1]
    sel = _topk_first(-torch.where(hit, counts, 1 << 30), min(NSEED, P_avail))
    if P_avail > NSEED:
        selc = _topk_first(torch.where(hit, counts, 0),
                           min(NSEED_COMMON, P_avail))
        sel = torch.cat([sel, selc], dim=1)
    return sel


def device_seed_votes(di: DeviceIndex, reads):
    """Seeding + diagonal voting half of the step (mesh.py:400).
    Returns (outs, hits_used, hits_tot) with outs = [(b1, v1, b2, v2,
    nc2) for fwd, rev]."""
    B, Q = reads.shape
    fwd, rc, valid, qoffs, stride = _seed_words(di, reads)
    if stride and os.environ.get("SMALT_TIMING") and \
            not getattr(device_map_step, "_stride_noted", False):
        # report the sensitivity trade once per process
        device_map_step._stride_noted = True
        print(f"# device seeding: query positions sampled at "
              f"stride {stride} (coprime with nskip={di.nskip}; "
              f">= {valid.shape[1] // (stride * di.nskip)} "
              f"phase-matching seeds kept per read)",
              file=sys.stderr)

    tol = max(di.wordlen * 3 // di.nskip, 1)
    outs = []
    hits_used = torch.zeros(B, dtype=_I32, device=reads.device)
    hits_tot = torch.zeros(B, dtype=_I32, device=reads.device)
    for is_reverse, words in ((False, fwd), (True, rc)):
        counts, base, hit = _lookup_words(di, words, valid)
        sel = _select_seeds(counts, hit)
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


def pad_read_slens(reads, S: int):
    """Subject lengths of the three windows of each read, [3B] int32: 0
    for a pad read (a row that is all code 7, as a batch pads its last
    rows), else S.  Code 7 scores 0, so such a window returns (0, 0,
    -prepad) over any number of rows, and at 0 rows no kernel runs its
    band."""
    pad = (reads == 7).all(dim=1).repeat(3)
    return torch.where(pad, 0, S).to(_I32)


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
        # centres the host tail's narrow traceback band (mesh.py:663).
        # Pad reads' windows take no rows (the reference runs them all).
        slens = pad_read_slens(reads, S)
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
    """The mapping step bound to `di` (mesh.py:1084): reads (on any
    device; a pinned host tensor copies without blocking) -> the output
    dict, or with pack=True the packed [len(OUT_KEYS), B] tensor.  The
    score matrix moves to di's device once."""
    mat = device_matrix(matrix, di.device)

    def step(reads):
        reads = reads.to(di.device, non_blocking=True)
        out = device_map_step(di, reads, mat, gapopen_pos, gapext_pos)
        return pack_outputs(out) if pack else out

    return step


# ------------------------------------------------------------------
# the mesh steps (mesh.py:491-615, 757-1151)
# ------------------------------------------------------------------

def _merge_sorted_asc(runs):
    """The ascending merge of ascending [B, n] rows: the one sorted array
    the JAX step's bitonic cascade (mesh.py:332, 598-611) makes of the
    same runs, since only the int32 values come out."""
    return torch.sort(torch.cat(runs, dim=1), dim=1).values


def device_seed_votes_sharded(mesh: Mesh, dis, reads, gbs):
    """device_seed_votes over a range-sharded index (mesh.py:491), bit
    for bit the single device's seed votes on every ip member.

    dis[j], reads[j], gbs[j]: member j's shard-local DeviceIndex, the
    (replicated) reads on its device and its first global tuple serial.
    Per strand: the members' hit counts psum into the global counts, and
    seed selection runs replicated on them; each member expands its
    slice of a selected word's positions under the global MAXC budget
    (an all_gather of the local counts gives each its prefix); the sorted
    local shifts, made global, are all_gathered and merged, and the vote
    runs on the last N lanes of the union, which hold exactly the single
    device's valid shifts.  Returns, for each member, (outs, hits_used,
    hits_tot) as device_seed_votes, diagonals global."""
    ip = mesh.ip
    words = [_seed_words(di, r) for di, r in zip(dis, reads)]
    tol = max(dis[0].wordlen * 3 // dis[0].nskip, 1)
    B = reads[0].shape[0]
    outs = [[] for _ in range(ip)]
    used = [torch.zeros(B, dtype=_I32, device=r.device) for r in reads]
    tot = [torch.zeros(B, dtype=_I32, device=r.device) for r in reads]
    for strand, is_reverse in ((0, False), (1, True)):
        looked = [_lookup_words(di, w[strand], w[2])
                  for di, w in zip(dis, words)]
        counts_g = mesh.psum([c for c, _, _ in looked])
        local, caps = [], []
        for j, (di, w) in enumerate(zip(dis, words)):
            counts, base, _ = looked[j]
            valid, qoffs = w[2], w[3]
            hit_g = valid & (counts_g[j] > 0)
            sel = _select_seeds(counts_g[j], hit_g)
            sel_true = torch.gather(counts_g[j], 1, sel)
            sel_true = torch.where(torch.gather(hit_g, 1, sel),
                                   torch.clamp_max(sel_true, 1 << 14), 0)
            tot[j] = tot[j] + sel_true.sum(dim=1).to(_I32)
            cap = torch.clamp_max(sel_true, MAXC)
            used[j] = used[j] + cap.sum(dim=1).to(_I32)
            local.append((torch.gather(base, 1, sel),
                          torch.gather(counts, 1, sel),
                          torch.gather(qoffs, 1, sel)))
            caps.append(cap)
        lc = mesh.all_gather([cnt for _, cnt, _ in local])   # [ip, B, NSEL]
        runs = []
        for j, (di, (sel_base, sel_cnt_l, sel_qoffs)) in enumerate(
                zip(dis, local)):
            # my slice of the global first-`cap` positions of each word
            before = lc[j][:j].sum(dim=0).to(_I32)
            quota = torch.minimum(torch.clamp_min(caps[j] - before, 0),
                                  sel_cnt_l)
            shift, ok = _expand_hits(di, sel_base, quota, sel_qoffs,
                                     is_reverse)
            shift = torch.where(ok, shift + gbs[j], _NO_SHIFT)
            runs.append(torch.sort(shift, dim=1).values)
        n_l = runs[0].shape[1]
        for j, sh_all in enumerate(mesh.all_gather(runs)):
            s_u = _merge_sorted_asc(list(sh_all))[:, -n_l:]
            outs[j].append(_best_diagonal(s_u, None, tol, presorted=True))
    return [(outs[j], used[j], tot[j]) for j in range(ip)]


INT32_BASES = 1 << 31


@dataclass
class ShardedDeviceIndex:
    """Range-sharded index + reference (mesh.py:757), host arrays stacked
    on a leading shard axis as the JAX build stacks them: shard s holds
    the reference bases [shard_base[s], shard_base[s] + local_len[s])
    (its range and a right halo of `halo` bases) and the index entries
    whose sampled position falls in its range, rebased to shard-local
    tuple serials; words padded with WORD_SENTINEL so that lookups miss
    on pad rows.  `member(s, device)` puts shard s on a device.

    A window the index-sharded step gathers must lie whole inside its
    owner's slice, so the step refuses a window longer than `halo`
    (the JAX build's default halo of 640 covers reads padded to 512 bp
    only, and the JAX step then gathers clamped, wrong bases)."""
    wordlen: int
    nskip: int
    n_shards: int
    words: np.ndarray       # [ip, Wmax] int32, sentinel-padded
    starts: np.ndarray      # [ip, Wmax+1] int32
    pos: np.ndarray         # [ip, Pmax] int32 shard-local tuple serials
    ref_alpha: np.ndarray   # [ip, Lmax] int32, pad code 7 (scores 0)
    shard_base: np.ndarray  # [ip] int32 global base offset of the slice
    local_len: np.ndarray   # [ip] int32 valid bases in the slice
    ref_len: int            # global reference length
    halo: int
    hi_table: Optional[np.ndarray] = None  # [ip, 4^12, 2] (k = 16..20)
    words_lo: Optional[np.ndarray] = None  # [ip, Wmax] int32
    lo_steps: int = 0

    WORD_SENTINEL = np.int32(0x7FFFFFFF)
    DEFAULT_HALO = 640

    @classmethod
    def build(cls, refset: RefSet, idx: KmerIndex, n_shards: int,
              halo: int = DEFAULT_HALO) -> "ShardedDeviceIndex":
        if idx.wordlen > 20:
            raise ValueError("device path supports wordlen<=20")
        L = refset.total_len
        if L >= INT32_BASES:
            raise ValueError(
                f"the range-sharded index keeps int32 shard bases and "
                f"window starts: a reference of {L} bases reaches 2^31")
        nskip = idx.nskip
        chunk = -(-L // n_shards)
        chunk = -(-chunk // nskip) * nskip          # multiple of nskip
        alpha = codec.alpha(refset.codes).astype(np.int32)
        words_np = idx.words.astype(np.int64)
        starts_np = idx.starts.astype(np.int64)
        pos_np = idx.pos.astype(np.int64)

        hilo = 2 * idx.wordlen > 31
        lo_bits = 2 * (idx.wordlen - DeviceIndex.HI_BASES) if hilo else 0

        shards = []
        for s in range(n_shards):
            lo_b = min(s * chunk, L)
            hi_b = min((s + 1) * chunk, L)
            lo_t, hi_t = lo_b // nskip, -(-hi_b // nskip)
            sel = (pos_np >= lo_t) & (pos_np < hi_t)
            # word slots with at least one position in range
            pidx = np.flatnonzero(sel)
            wslot = np.searchsorted(starts_np, pidx, side="right") - 1
            uw, first, counts = np.unique(wslot, return_index=True,
                                          return_counts=True)
            w64 = words_np[uw]
            w = np.zeros(1, np.int32) if hilo else w64.astype(np.int32)
            st = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
            p_local = (pos_np[pidx] - lo_t).astype(np.int32)
            sl_end = min(hi_b + halo, L)
            ref_slice = alpha[lo_b:sl_end]
            shards.append((w, st, p_local, ref_slice, lo_b, sl_end - lo_b,
                           w64))

        Wmax = max(max(len(s[1]) - 1 for s in shards), 1)
        Pmax = max(max(len(s[2]) for s in shards), 1)
        Lmax = max(max(len(s[3]) for s in shards), 1)
        words = np.full((n_shards, Wmax), cls.WORD_SENTINEL, np.int32)
        starts = np.zeros((n_shards, Wmax + 1), np.int32)
        pos = np.zeros((n_shards, Pmax), np.int32)
        refa = np.full((n_shards, Lmax), 7, np.int32)
        base = np.zeros(n_shards, np.int32)
        llen = np.zeros(n_shards, np.int32)
        hi_tables = lo_arrs = None
        lo_steps = 0
        if hilo:
            nhi = 1 << (2 * DeviceIndex.HI_BASES)
            hi_tables = np.zeros((n_shards, nhi, 2), np.int32)
            lo_arrs = np.zeros((n_shards, Wmax), np.int32)
        for s, (w, st, p, r, lo_b, ln, w64) in enumerate(shards):
            nW = len(st) - 1
            if hilo:
                hi = (w64 >> lo_bits)
                lo = (w64 & ((1 << lo_bits) - 1)).astype(np.int32)
                hi_tables[s, :, 0] = np.searchsorted(
                    hi, np.arange(nhi), side="left").astype(np.int32)
                hi_tables[s, :, 1] = np.searchsorted(
                    hi, np.arange(nhi), side="right").astype(np.int32)
                lo_arrs[s, : nW] = lo
                mb = int((hi_tables[s, :, 1].astype(np.int64) -
                          hi_tables[s, :, 0]).max()) if nW else 1
                lo_steps = max(lo_steps, max(
                    1, int(np.ceil(np.log2(max(mb, 1) + 1)))))
            else:
                words[s, : nW] = w
            starts[s, : len(st)] = st
            starts[s, len(st):] = st[-1] if len(st) else 0
            pos[s, : len(p)] = p
            refa[s, : len(r)] = r
            base[s] = lo_b
            llen[s] = ln
        return cls(wordlen=idx.wordlen, nskip=nskip, n_shards=n_shards,
                   words=words, starts=starts, pos=pos, ref_alpha=refa,
                   shard_base=base, local_len=llen, ref_len=L, halo=halo,
                   hi_table=hi_tables, words_lo=lo_arrs, lo_steps=lo_steps)

    def member(self, s: int, device) -> DeviceIndex:
        """Shard s as a DeviceIndex on `device` (no direct table: the
        lookups binary-search the shard's sorted words, or its split
        words), ref_len its slice's valid bases."""
        arrays = {"words": self.words[s], "starts": self.starts[s],
                  "pos": self.pos[s], "ref_alpha": self.ref_alpha[s]}
        if self.hi_table is not None:
            arrays["hi_table"] = self.hi_table[s]
            arrays["words_lo"] = self.words_lo[s]
        return DeviceIndex.from_numpy(
            arrays, {"wordlen": self.wordlen, "nskip": self.nskip,
                     "ref_len": int(self.local_len[s]),
                     "lo_steps": self.lo_steps}, device)


def _combine_over_ip(mesh: Mesh, outs, hits_mode: str = "sum"):
    """Combine the ip members' per-read winners (mesh.py:874); outs[j] is
    member j's OUT_KEYS dict.  The runner-up considers each member's own
    second AND every other member's best: a repeat whose copies land on
    different members has score2 == score globally.  A best-score member
    whose placement differs from the picked primary is a genuine tie; one
    at the same start is a duplicate sighting.  hits_mode "sum": disjoint
    position slices (range-sharded index), else "max" (replicated).
    Returns each member's combined dict."""
    NEG = -(1 << 30)
    ip = mesh.ip

    def col(key):
        return [o[key] for o in outs]

    def pickmax(xs, ms):
        return mesh.pmax([torch.where(m, x, NEG) for x, m in zip(xs, ms)])

    score, start, strand = col("score"), col("start"), col("strand")
    best = mesh.pmax(score)
    is_best = [score[j] == best[j] for j in range(ip)]
    out_start = pickmax(start, is_best)
    out_strand = pickmax(strand, is_best)
    genuine = [is_best[j] & (start[j] != out_start[j]) for j in range(ip)]
    tie = [t > 0 for t in mesh.psum([g.to(_I32) for g in genuine])]
    v = [torch.where(is_best[j], outs[j]["score2"], score[j])
         for j in range(ip)]
    l2 = [torch.where(is_best[j], outs[j]["start2"], start[j])
          for j in range(ip)]
    d2 = [torch.where(is_best[j], outs[j]["strand2"], strand[j])
          for j in range(ip)]
    v2max = mesh.pmax(v)
    is2 = [v[j] == v2max[j] for j in range(ip)]
    s_tie, s_2 = pickmax(start, genuine), pickmax(l2, is2)
    t_tie, t_2 = pickmax(strand, genuine), pickmax(d2, is2)
    is_pick = [is_best[j] & (start[j] == out_start[j]) for j in range(ip)]
    tb_i, tb_j = pickmax(col("tb_i"), is_pick), pickmax(col("tb_j"), is_pick)
    red = mesh.psum if hits_mode == "sum" else mesh.pmax
    hu, ht = red(col("hits_used")), red(col("hits_tot"))
    n2nd, ambig = mesh.pmax(col("n2nd")), mesh.pmax(col("ambig"))
    return [{"score": best[j],
             "score2": torch.where(tie[j], best[j], v2max[j]),
             "start": out_start[j], "strand": out_strand[j],
             "start2": torch.where(tie[j], s_tie[j], s_2[j]),
             "strand2": torch.where(tie[j], t_tie[j], t_2[j]),
             "hits_used": hu[j], "hits_tot": ht[j], "n2nd": n2nd[j],
             "ambig": ambig[j], "tb_i": tb_i[j], "tb_j": tb_j[j]}
            for j in range(ip)]


def _dp_rows(reads, dp: int):
    """The dp row slices of a batch (its row count a multiple of dp)."""
    B = reads.shape[0]
    if B % dp:
        raise ValueError(f"a batch of {B} rows does not split over dp={dp}")
    n = B // dp
    return [reads[i * n:(i + 1) * n] for i in range(dp)]


def _matrices(mesh: Mesh, matrix) -> dict:
    """The score matrix on every member's device, by device name."""
    return {str(d): device_matrix(matrix, d)
            for row in mesh.devices for d in row}


def join_parts(parts):
    """The mesh steps' per-dp-row outputs joined on the CPU: one packed
    [len(OUT_KEYS), B] tensor, or one OUT_KEYS dict of [B] tensors."""
    if isinstance(parts[0], dict):
        return {k: torch.cat([p[k].cpu() for p in parts]) for k in OUT_KEYS}
    return torch.cat([p.cpu() for p in parts], dim=1)


def make_sharded_step(di: DeviceIndex, mesh: Mesh, matrix, gapopen_pos: int,
                      gapext_pos: int, pack: bool = False):
    """The step over a mesh with the index replicated (mesh.py:1117):
    every member holds its own copy of `di`, dp row i maps its B/dp rows
    of the batch, and with ip > 1 the row's members all run the whole
    step and combine over ip (hits_mode "max").  reads -> a list of dp
    row results (OUT_KEYS dicts, or with pack=True packed tensors), row
    i's on its first member's device; join_parts joins them."""
    members = [[di.copy_to(d) for d in row] for row in mesh.devices]
    mats = _matrices(mesh, matrix)

    def step(reads):
        parts = []
        for i, part in enumerate(_dp_rows(reads, mesh.dp)):
            outs = [device_map_step(members[i][j],
                                    part.to(d, non_blocking=True),
                                    mats[str(d)], gapopen_pos, gapext_pos)
                    for j, d in enumerate(mesh.devices[i])]
            if mesh.ip > 1:
                outs = _combine_over_ip(mesh, outs, hits_mode="max")
            parts.append(pack_outputs(outs[0]) if pack else outs[0])
        return parts

    return step


def _owned_windows(di: DeviceIndex, base: int, starts, mine, S: int):
    """Member's gather of the windows it owns (mesh.py:1019-1025):
    [N, S] codes of its slice at global `starts` where `mine`, 0
    elsewhere.  A window it owns lies whole inside its slice (the halo
    is at least S), so the clip below only keeps the other rows' reads
    in bounds."""
    offs = torch.arange(S, dtype=_I32, device=starts.device)
    gidx = torch.clamp((starts - base)[:, None] + offs, 0,
                       di.ref_alpha.shape[0] - 1)
    return torch.where(mine[:, None], di.ref_alpha[gidx.long()], 0)


def make_index_sharded_step(sdi: ShardedDeviceIndex, mesh: Mesh, matrix,
                            gapopen_pos: int, gapext_pos: int,
                            pack: bool = False):
    """The step over a mesh with the index range-sharded over ip
    (mesh.py:932): shard j on member (i, j) of every dp row i.  Per dp
    row: seed votes by device_seed_votes_sharded (global, replicated);
    the three windows a read selected as the single device selects
    them; the member whose range holds a window's start gathers it and
    the window bytes psum to every member; member j scores the balanced
    j::ip slice of the 3B windows full-matrix (sw_score_batch, at any Q,
    as the JAX step does: the strip path past MAX_Q columns) and the
    scores scatter into place and psum; then _pick_best.  reads -> the
    list of dp row results, as make_sharded_step.  A batch whose windows
    are longer than the index's halo raises: its windows could leave
    their owner's slice."""
    ip = mesh.ip
    if ip != sdi.n_shards:
        raise ValueError(f"mesh ip={ip} but the index has {sdi.n_shards} "
                         f"shards")
    members = [[sdi.member(j, d) for j, d in enumerate(row)]
               for row in mesh.devices]
    mats = _matrices(mesh, matrix)
    nskip, k, REF = sdi.nskip, sdi.wordlen, sdi.ref_len
    base = [int(b) for b in sdi.shard_base]

    def row_step(dis, devs, part):
        B, Q = part.shape
        S = window_len(Q)
        pad = window_pad(Q)
        N3 = 3 * B
        reads = [part.to(d, non_blocking=True).to(_I32) for d in devs]
        votes = device_seed_votes_sharded(mesh, dis, reads,
                                          [b // nskip for b in base])
        sel = []
        contents = []
        for j, ((fw, rv), hu, ht) in enumerate(votes):
            bfd, vfg, b2fd, v2fg, nc2f = fw
            brd, vrg, b2rd, v2rg, nc2r = rv
            sel_rev = v2rg > v2fg
            org_f = -pad
            org_r = -(Q - k) - pad
            org2 = org_f + (org_r - org_f) * sel_rev.to(_I32)

            def gstart(diag, org):
                return torch.clamp(diag * nskip + org, 0, max(REF - S, 0))

            starts3 = torch.stack([
                gstart(bfd, org_f), gstart(brd, org_r),
                gstart(torch.where(sel_rev, b2rd, b2fd), org2)])  # [3, B]
            v2g = torch.where(sel_rev, v2rg, v2fg)
            has = torch.stack([vfg, vrg, v2g]).reshape(N3) > 0
            # the owner: the last member whose base is <= the start
            owner = torch.zeros_like(starts3)
            for b in base[1:]:
                owner = owner + (starts3 >= b).to(_I32)
            mine = (owner.reshape(N3) == j) & has
            contents.append(_owned_windows(dis[j], base[j],
                                           starts3.reshape(N3), mine, S))
            sel.append((sel_rev, starts3, has, v2g, nc2f, nc2r, vfg, vrg,
                        hu, ht))
        contents = mesh.psum(contents)            # every member's windows
        scat = []
        for j, d in enumerate(devs):
            sel_rev = sel[j][0]
            qc_f = reads[j]
            qc_r = _revcomp_batch(qc_f)
            qc3 = torch.stack([qc_f, qc_r, torch.where(
                sel_rev[:, None], qc_r, qc_f)]).reshape(N3, Q)
            NR = -(-N3 // ip)
            ridx = torch.arange(NR, dtype=_I32, device=d) * ip + j
            pad_row = ridx >= N3
            rows = torch.clamp_max(ridx, N3 - 1).long()
            slens = torch.where(pad_row, 0, pad_read_slens(reads[j], S)[rows])
            sc, ti, tj = sw_score_batch(qc3[rows], contents[j][rows], slens,
                                        mats[str(d)], gapopen_pos,
                                        gapext_pos, device=d, track=True)
            # my slice into place (+1 dump slot for the pad rows); each
            # window is scored by exactly one member
            dump = torch.where(pad_row, N3, rows)
            scat.append([torch.zeros(N3 + 1, dtype=_I32, device=d)
                         .index_add_(0, dump, torch.where(pad_row, 0, x))[:N3]
                         for x in (sc, ti, tj)])
        sc3, ti3, tj3 = (mesh.psum([s[t] for s in scat]) for t in range(3))
        outs = []
        for j in range(ip):
            sel_rev, starts3, has, v2g, nc2f, nc2r, vfg, vrg, hu, ht = sel[j]
            strands3 = torch.stack([torch.zeros_like(sel_rev, dtype=_I32),
                                    torch.ones_like(sel_rev, dtype=_I32),
                                    sel_rev.to(_I32)])
            outs.append(_pick_best(
                torch.where(has, sc3[j], 0).reshape(3, B), starts3, strands3,
                ti3[j].reshape(3, B), tj3[j].reshape(3, B),
                torch.where(sel_rev, nc2r, nc2f),
                torch.where(sel_rev, vrg, vfg), v2g, hu, ht))
        return outs

    def step(reads):
        S = window_len(reads.shape[1])
        if S > sdi.halo:
            raise ValueError(
                f"windows of {S} bases (reads padded to {reads.shape[1]}) "
                f"need a sharded index with a halo of at least {S}; this "
                f"one has {sdi.halo}")
        parts = []
        for i, part in enumerate(_dp_rows(reads, mesh.dp)):
            out = row_step(members[i], mesh.devices[i], part)[0]
            parts.append(pack_outputs(out) if pack else out)
        return parts

    return step
