"""Batched Smith-Waterman scores: the Hopper kernels and their plain versions.

Counterpart of smalt_tpu/ops/sw.py: the full-matrix Pallas kernel
(`sw_score_batch`, oracle `sw_score_ref`) and the banded one for long
reads (`sw_band_score_batch`, oracle `sw_band_score_ref`).  Affine-gap
local alignment in int32, with the score taken over the diagonal values
T = H[i-1,j-1] + W[i,j] and F from the prefix-max identity (exact
whenever gapopen >= gapext):

    F[j] = cummax(H0[j'] + j'*ge)[j-1] - gapopen - (j-1)*ge

`sw_score_batch` and `sw_band_score_batch` are the public functions.
On a CPU tensor each runs its plain torch version; on a CUDA tensor it
launches its hand-written kernel (`csrc/sw_full.cu`, `csrc/sw_band.cu`,
built at first use) and raises if that fails.  Both return what the
Pallas wrappers return: max(best, 0) and, with `track`, the
row-major-first argmax cell (ti, tj).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

NEG = -(1 << 28)
MAX_Q = 512        # widest query sw_full keeps in registers (16 a lane)
# Queries past MAX_Q run sw_full's strip path (strips of MAX_Q columns on
# a wavefront of warps a window, or a warp a window for a large int8
# batch: strip_warps), which has no limit on Q, and bands past
# CLUSTER_BAND_W run sw_band's strip kernel, which has no limit on W.
# Their scratch (int32 [windows, S, 2] of strip carry, and for the band
# its flags, band_strip_flag_words) is kept within this many bytes by
# launching groups of windows (scratch_groups).
SCRATCH_BYTES = 1 << 30
STRIP_WARPS = 16     # most warps a window of sw_full's strip wavefront
# windows from which sw_full's strip path runs a warp a window on an int8
# matrix (strip_warps): where the one-warp kernel measured faster than the
# wavefront (PERF.md: both timed at 1,024, 1,536, 2,112 and 3,072 windows)
STRIP_ONE_WARP_B = 1536
WARP_BAND_W = 512    # widest band of sw_band_warp_kernel (one warp a window)
# sw_band_multi_kernel, the several-warps kernel, runs every wider band up
# to TILED_BAND_W: on 12 or 20 lanes a thread (whichever pads the band
# less) up to MULTI_BAND_W, on 20 ("_many") past it
MULTI_BAND_W = 3072
# widest band of the several-warps kernel (20 warps of 20 lanes: reads up
# to ~68 kb), which beats the cluster kernel there 2.5x, tracked and
# score-only (PERF.md).  Wider bands run sw_band_strips_kernel, the band
# as column strips of BAND_STRIP_W across many CTAs a window, past
# CLUSTER_BAND_W; sw_band_cluster_kernel, a thread-block cluster a window
# (CLUSTER_MAX CTAs of up to 512 threads of 16 lanes: CLUSTER_MAX_W, reads
# up to ~700 kb), takes TILED_BAND_W < W <= CLUSTER_BAND_W, which is no
# band: the strip kernel measured faster at every width past 12,800 (from
# 14,336 to 131,072 lanes, PERF.md).
TILED_BAND_W = 12800
CLUSTER_MAX = 16            # CTAs a cluster (past 8: a non-portable size)
CLUSTER_C = 16              # band lanes a thread
CLUSTER_MAX_W = CLUSTER_MAX * 512 * CLUSTER_C   # the widest band it holds
CLUSTER_BAND_W = TILED_BAND_W
CLUSTER_CTA_LANES = 2048    # band lanes a CTA holds where the band allows
BAND_STRIP_W = 256          # query columns a strip of sw_band's strip kernel
# strips (warps) a CTA of the strip kernel (its launch takes 1 to 4): 2
# measured the fastest tracked, or within 5% of it, among 2, 4 and 8 on the
# 6 windows of 2 x 100 kb, the 3 of 700 kb and of 1 Mb, and 132 windows at
# W 32,768 (PERF.md)
BAND_STRIP_WARPS = 2
# The tracking key T * 256 + 255 - c (sw_full.cu, sw_band.cu's one-warp
# kernel) holds |T| < 2^23; a window can score no more than max|entry| *
# (query columns or subject rows, the fewer), and a tracked launch that
# reaches KEY_CAP that way runs the instances whose record keeps the
# value and the column apart (sw_full's _rec kernels; for bands up to
# WARP_BAND_W, sw_band's several-warps kernel, which serves every wider
# band anyway).
KEY_CAP = 1 << 23
# What every kernel, and the Pallas kernels whose arithmetic they share,
# holds in int32: H and E up to the window's best score plus a gap
# extension a column or row (the prefix max H0 + j*ge, E kept as
# E + i*ge), and NEG-based sentinels down to NEG less go and a gap
# extension a column.  Both stay inside int32 when
# max|entry| * min(Q, S) + (go + ge) * (Q + S + W) < DP_CAP = 2^30
# (W the band width, 0 for sw_full): the positive side below 2^30, the
# negative above -(2^28 + 2^30).  check_score_cap refuses the rest.
DP_CAP = 1 << 30

# launches of the CUDA kernels by instance; each wrapper adds one per
# launch and nowhere else (callers reset and read these).  "_wide": a
# matrix outside int8 (sw_full's WIDE instances), or that or a tracked
# band of up to WARP_BAND_W lanes that could score KEY_CAP (sw_band's
# several-warps kernel, int16 or int32 scores for such a matrix, at any
# width up to MULTI_BAND_W); "_rec": a tracked sw_full window that could
# score KEY_CAP (the WIDE instance of sw_full_rec_kernel or
# sw_wave_rec_kernel); "_strip": sw_full's path for queries past MAX_Q on
# the wavefront (sw_wave_kernel), "_warp": that path on the one-warp
# kernel (sw_strip_kernel, int8 only), as strip_warps chooses;
# "_many": sw_band_multi_kernel past MULTI_BAND_W (20 lanes a thread);
# "_cluster":
# sw_band_cluster_kernel, bands past TILED_BAND_W; "_strips":
# sw_band_strips_kernel, bands past CLUSTER_BAND_W.  The names are what
# sw_full_instance and sw_band_instance return.
launches = {"sw_full_track": 0, "sw_full": 0, "sw_band_track": 0,
            "sw_band": 0, "sw_full_track_wide": 0, "sw_full_wide": 0,
            "sw_band_track_wide": 0, "sw_band_wide": 0, "swq": 0,
            "sw_full_track_strip": 0, "sw_full_strip": 0,
            "sw_full_track_strip_wide": 0, "sw_full_strip_wide": 0,
            "sw_full_track_warp": 0, "sw_full_warp": 0,
            "sw_band_track_many": 0, "sw_band_many": 0,
            "sw_full_track_rec": 0, "sw_full_track_strip_rec": 0,
            "sw_band_track_strips": 0, "sw_band_strips": 0,
            "sw_band_track_cluster": 0, "sw_band_cluster": 0}

_libs: dict = {}


def _as_i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int32).contiguous()


class DeviceMatrix(NamedTuple):
    """An [8, 8] int32 score matrix on a device, with its (min, max)
    entry taken on the host before the upload: the kernel wrappers read
    the range here and never read the matrix back from the card."""
    t: torch.Tensor
    lo: int
    hi: int

    @property
    def wide(self) -> bool:
        """An entry outside int8: sw_full.cu then runs its WIDE instance (a
        lookup a cell, no int8 profile) and sw_band.cu its several-warps
        kernel (an int16 profile, or int32 lookups past int16)."""
        return self.lo < -128 or self.hi > 127

    @property
    def amax(self) -> int:
        return max(-self.lo, self.hi)


def device_matrix(matrix, device) -> DeviceMatrix:
    """The [8, 8] score matrix (a host array) as a contiguous int32
    tensor on `device`, in its DeviceMatrix record.  Any int32 entries
    are taken."""
    m = np.ascontiguousarray(matrix, dtype=np.int32)
    if m.shape != (8, 8):
        raise ValueError(f"score matrix must be [8, 8], got {m.shape}")
    return DeviceMatrix(torch.from_numpy(m.copy()).to(device), int(m.min()),
                        int(m.max()))


def dp_extent(amax: int, Q: int, S: int, go: int, ge: int,
              W: int = 0) -> int:
    """max|entry| * min(Q, S) + (go + ge) * (Q + S + W): what the int32 DP
    of a window of Q query columns and S subject rows (a band of W lanes)
    must hold below DP_CAP."""
    return amax * min(Q, S) + (abs(go) + abs(ge)) * (Q + S + W)


def check_score_cap(kname: str, matrix: DeviceMatrix, Q: int, S: int,
                    go: int, ge: int, W: int = 0) -> None:
    """Raise ValueError unless dp_extent(...) < DP_CAP: the int32 DP of
    every kernel (and of the Pallas kernels) holds such a window."""
    if not isinstance(matrix, DeviceMatrix):
        raise TypeError(f"{kname}: the score matrix must be the DeviceMatrix "
                        f"device_matrix makes, got {type(matrix).__name__}")
    ext = dp_extent(matrix.amax, Q, S, go, ge, W)
    if ext >= DP_CAP:
        raise ValueError(
            f"{kname}: max |score matrix entry| {matrix.amax} on a window of "
            f"{Q} x {S} (gap penalties {abs(go)}, {abs(ge)}) reaches 2^30, "
            f"the int32 DP's limit (max|entry| * min(Q, S) + (go + ge) * "
            f"(Q + S + W) < 2^30)")


def key_over(matrix: DeviceMatrix, Q: int, S: int) -> bool:
    """Whether a window of Q x S could score KEY_CAP (the int8
    instances' tracking key does not hold it)."""
    return matrix.amax * min(Q, S) >= KEY_CAP


def sw_full_instance(B: int, Q: int, S: int, matrix: DeviceMatrix,
                     track: bool) -> str:
    """The sw_full.cu instance a launch of B windows of Q x S runs, by its
    name in `launches`: past MAX_Q columns the strip path, "_strip" on the
    wavefront and "_warp" on the one-warp kernel (strip_warps); "_rec",
    the two-part record, for a tracked window that could score KEY_CAP,
    whatever the matrix (the score-only instances keep no key); else
    "_wide" for a matrix outside int8.  Only "_rec" launches pay for the
    record's longer row."""
    rec = track and key_over(matrix, Q, S)
    strip = "" if Q <= MAX_Q else \
        "_warp" if strip_warps(B, Q, S, rec or matrix.wide) == 1 else "_strip"
    return ("sw_full_track" if track else "sw_full") + strip + \
        ("_rec" if rec else "_wide" if matrix.wide else "")


def strip_warps(B: int, Q: int, S: int, wide: bool = False) -> int:
    """The warps a window of sw_full.cu's strip path (Q > MAX_Q) for B
    windows of Q x S, on a WIDE instance (a matrix outside int8 or the
    two-part record) or not.  1 runs the one-warp kernel, a warp a window
    and its strips one after another: from B = STRIP_ONE_WARP_B windows
    on an int8 matrix it beats the wavefront (PERF.md), and it has no
    WIDE instance.  Else NW >= 2 runs the wavefront: a warp a strip of
    MAX_Q columns and a chunk of 32 subject rows at most (more would
    idle), up to STRIP_WARPS.  Never one warp there: on one warp the
    wavefront's schedule is the one-warp kernel's (each strip over all
    rows, one after another), paying a block barrier a chunk and a block
    a window, which the one-warp kernel runs without."""
    if B >= STRIP_ONE_WARP_B and not wide:
        return 1
    return max(2, min(STRIP_WARPS, -(-Q // MAX_Q), -(-S // 32)))


def _wide_code(name: str) -> int:
    """The `wide` argument of sw_full.cu's launches for an instance name:
    0 int8, 1 WIDE, 2 WIDE with the two-part record."""
    return 2 if name.endswith("_rec") else int(name.endswith("_wide"))


def scratch_groups(B: int, per_window: int):
    """[(first, end)) groups of B windows whose scratch (`per_window`
    bytes each: 8 * S for sw_full's strip carry, band_strip_bytes(S) for
    sw_band's strip kernel) fits SCRATCH_BYTES, at least one window a
    group."""
    per = max(1, SCRATCH_BYTES // max(per_window, 1))
    return [(g, min(B, g + per)) for g in range(0, B, per)]


def sw_band_instance(Q: int, S: int, W: int, matrix: DeviceMatrix,
                     track: bool) -> str:
    """The sw_band.cu instance a launch runs, by its name in `launches`:
    "_strips" (sw_band_strips_kernel: no packed key, any width, an int8
    profile or int32 lookups by the matrix) past CLUSTER_BAND_W lanes;
    "_cluster" (sw_band_cluster_kernel: int32 lookups, no packed key)
    past TILED_BAND_W; "_many" (the
    several-warps kernel on 20 lanes a thread) past MULTI_BAND_W; "_wide"
    (the several-warps kernel, on its int16 profile or int32 lookups) for
    a matrix outside int8, or a tracked band of up to WARP_BAND_W lanes
    that could score KEY_CAP (the one-warp kernel's key does not hold
    it); else the int8 route (one warp a window to WARP_BAND_W lanes,
    sw_band_multi_kernel above, or where the one-warp kernel's profile
    does not fit).  No several-warps instance keeps a key: KEY_CAP names
    nothing past WARP_BAND_W."""
    name = "sw_band_track" if track else "sw_band"
    if W > CLUSTER_BAND_W:
        return name + "_strips"
    if W > TILED_BAND_W:
        return name + "_cluster"
    if W > MULTI_BAND_W:
        return name + "_many"
    wide = matrix.wide or (track and W <= WARP_BAND_W and
                           key_over(matrix, Q, S))
    return name + ("_wide" if wide else "")


def band_wide_code(matrix: DeviceMatrix, several: bool = False) -> int:
    """The `wide` argument of sw_band_launch: the several-warps kernel's
    score entries, 2 int16 and 3 int32 for a matrix outside int8 (either
    runs that kernel at any width); else 1 where `several` (a tracked
    band that could score KEY_CAP: that kernel, int8) and 0 (int8, the
    one-warp kernel where it takes the band)."""
    if not matrix.wide:
        return int(several)
    return 2 if matrix.lo >= -(1 << 15) and matrix.hi < 1 << 15 else 3


def cluster_shape(W: int):
    """(CTAs, threads a CTA) of sw_band_cluster_kernel for a band of W <=
    CLUSTER_MAX_W lanes, CLUSTER_C a thread: CTAs of about
    CLUSTER_CTA_LANES lanes, so that a few windows spread over many SMs,
    up to CLUSTER_MAX of them (then up to 512 threads a CTA), in whole
    warps."""
    if not 1 <= W <= CLUSTER_MAX_W:
        raise ValueError(f"sw_band_cluster: band width {W} outside "
                         f"1..{CLUSTER_MAX_W}")
    ncta = min(CLUSTER_MAX, -(-W // CLUSTER_CTA_LANES))
    return ncta, 32 * -(-W // (32 * ncta * CLUSTER_C))


def band_strip_flag_words(B: int, S: int) -> int:
    """int32 words of sw_band_strips_launch's flags for B windows of S
    subject rows (sw_band_strips.cuh strips_flag_words): the ticket and
    padding (8), then per window its record chain (8) and a flag for each
    chunk of 32 rows (S // 32 + 2)."""
    return 8 + B * (8 + S // 32 + 2)


def band_strip_bytes(S: int) -> int:
    """Scratch bytes a window of sw_band_strips_kernel takes: its carry
    column (int32 [S, 2]) and its flag words."""
    return 8 * S + 4 * (8 + S // 32 + 2)


def cluster_occupancy(ncta: int, nthreads: int, track: bool) -> int:
    """How many clusters of sw_band_cluster_kernel in this shape the card
    holds at once (cudaOccupancyMaxActiveClusters, through sw_band.cu's
    sw_band_cluster_occupancy): 0 where it cannot place one.  Needs the
    card; raises on an error of the query."""
    fn = _kernel_lib("sw_band").sw_band_cluster_occupancy
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    n = ctypes.c_int(-1)
    rc = fn(ncta, nthreads, int(track), ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"sw_band_cluster_occupancy({ncta}, {nthreads}) "
                           f"failed (code {rc})")
    return n.value


def _matrix_on(matrix, device) -> DeviceMatrix:
    """A host score matrix through device_matrix; a DeviceMatrix on
    `device` as it is."""
    if isinstance(matrix, DeviceMatrix):
        if matrix.t.device == device:
            return matrix
        matrix = matrix.t.cpu()
    return device_matrix(matrix, device)


def sw_score_ref(qcodes, subj, slens, matrix, gapopen_pos: int,
                 gapext_pos: int, track: bool = False):
    """Plain torch version of the kernel: an int32 scan over subject
    rows with F by prefix max.  Tensors on any device, all on one.

    qcodes [B, Q] codes 0..7, subj [B, S], slens [B], matrix [8, 8].
    Returns best [B] (>= 0) or, with track, (best, ti, tj).  As the
    kernel does, it spends no step on a row at or past a window's slen:
    empty windows (best 0 at (0, 0)) are left out and the scan stops at
    the longest slen."""
    device = qcodes.device
    B, Q = qcodes.shape
    live = slens > 0
    if not bool(live.all()):
        at = torch.nonzero(live).squeeze(1)
        got = sw_score_ref(qcodes[at], subj[at], slens[at], matrix,
                           gapopen_pos, gapext_pos, track=track)
        got = got if track else (got,)
        full = tuple(torch.zeros(B, dtype=torch.int32, device=device)
                     .index_copy_(0, at, x.to(torch.int32)) for x in got)
        return full if track else full[0]
    S = min(subj.shape[1], int(slens.max())) if B else 0
    go, ge = int(gapopen_pos), int(gapext_pos)
    i32 = torch.int32
    jidx = torch.arange(Q, dtype=i32, device=device)
    qlong = qcodes.long()
    H = torch.zeros((B, Q), dtype=i32, device=device)
    E = torch.zeros((B, Q), dtype=i32, device=device)
    vmax = torch.zeros(B, dtype=i32, device=device)
    bi = torch.zeros(B, dtype=i32, device=device)
    bj = torch.zeros(B, dtype=i32, device=device)
    zcol = torch.zeros((B, 1), dtype=i32, device=device)
    negcol = torch.full((B, 1), NEG, dtype=i32, device=device)
    big = torch.full((B, Q), 1 << 28, dtype=i32, device=device)
    for i in range(S):
        Wrow = matrix[subj[:, i].long()[:, None], qlong]          # [B, Q]
        T = torch.cat([zcol, H[:, :-1]], dim=1) + Wrow
        keep = i < slens
        rowmax = T.amax(dim=1)
        upd = keep & (rowmax > vmax)
        minlane = torch.where(T == rowmax[:, None], jidx, big).amin(dim=1)
        vmax = torch.where(upd, rowmax, vmax)
        bi = torch.where(upd, i, bi).to(i32)
        bj = torch.where(upd, minlane, bj)
        H0 = torch.clamp_min(torch.maximum(T, E), 0)
        cm = torch.cummax(H0 + jidx * ge, dim=1).values
        F = torch.cat([negcol, cm[:, :-1]], dim=1) - go - (jidx - 1) * ge
        Hn = torch.maximum(H0, F)
        En = torch.maximum(E - ge, Hn - go)
        H = torch.where(keep[:, None], Hn, H)
        E = torch.where(keep[:, None], En, E)
    if track:
        return vmax, bi, bj
    return vmax


def tie_windows(rng, B: int, Q: int, S: int):
    """B windows full of tied maxima, for holding a tracked kernel's
    first-argmax rule against sw_score_ref: each query is a repeat unit
    of 1 to 4 bases tiled to its length (pad code 7 behind it) and its
    subject the same unit tiled from a random phase, so the maximum of T
    is reached again every unit along a diagonal, on many diagonals, in
    several rows and in distant columns of one row.  One window in eight
    scores nothing (its subject avoids the query's bases: best 0 and
    cell (0, 0)), one in eight has a 1% sprinkling of N (5), and subject
    lengths vary.  Returns int32 numpy (q [B, Q], subj [B, S], slens
    [B])."""
    unit = rng.integers(1, 5, B)
    k = np.arange(max(Q, S), dtype=np.int64)[None, :]
    base = rng.integers(0, 4, (B, 4))
    q = np.take_along_axis(base, k[:, :Q] % unit[:, None], 1)
    phase = rng.integers(0, 4, B)[:, None]
    s = np.take_along_axis(base, (k[:, :S] + phase) % unit[:, None], 1)
    kind = np.arange(B) % 8
    # no base in common: the query holds one base, the subject the next
    q[kind == 3] = base[kind == 3, :1]
    s[kind == 3] = (base[kind == 3, :1] + 1) % 4
    noisy = (kind == 5)[:, None]
    q = np.where(noisy & (rng.random((B, Q)) < 0.01), 5, q)
    s = np.where(noisy & (rng.random((B, S)) < 0.01), 5, s)
    qlen = np.where(rng.random(B) < 0.5, Q, rng.integers(Q // 2, Q + 1, B))
    q[k[:, :Q] >= qlen[:, None]] = 7
    slens = np.where(rng.random(B) < 0.5, S, rng.integers(S // 2, S + 1, B))
    s[k[:, :S] >= slens[:, None]] = 7
    return q.astype(np.int32), s.astype(np.int32), slens.astype(np.int32)


def band_geometry(Q: int):
    """(S, pad, W) of the long-read windows the mapping step builds for
    reads padded to Q: S = window_len, pad = window_pad, W as the wrapper
    clamps it."""
    from ..parallel.mesh import window_len, window_pad
    S, pad = window_len(Q), window_pad(Q)
    return S, pad, clamp_band_width(Q, pad)


def band_windows(rng, B: int, Q: int):
    """Long-read windows as the main path builds them (band_geometry):
    each query follows its window from column pad + a shift (within W/8
    for most, up to W either way for a tenth: partly or wholly outside
    the band) with an indel random walk, 2% substitutions and N codes;
    one in twenty is unrelated noise, half are shorter than Q (pad code
    7), and subject lengths vary.  Returns (q, s, slens, pad, W, S)."""
    S, pad, W = band_geometry(Q)
    s = rng.integers(0, 4, (B, S), dtype=np.int32)
    off = rng.integers(-(W // 8), W // 8 + 1, B)
    far = rng.random(B) < 0.1
    off[far] = rng.integers(-W, W + 1, int(far.sum()))
    step = (rng.random((B, Q)) < 0.0075).astype(np.int32) - \
        (rng.random((B, Q)) < 0.0075)
    idx = pad + off[:, None] + np.arange(Q, dtype=np.int32) + \
        np.cumsum(step, axis=1, dtype=np.int32)
    q = np.take_along_axis(s, np.clip(idx, 0, S - 1), 1)
    noise = ((idx < 0) | (idx >= S) | (rng.random((B, Q)) < 0.02) |
             (rng.random(B) < 0.05)[:, None])
    q = np.where(noise, rng.integers(0, 4, (B, Q), dtype=np.int32), q)
    del idx, noise, step
    q[rng.random((B, Q)) < 0.005] = 5
    qlen = np.where(rng.random(B) < 0.5, Q, rng.integers(Q * 3 // 4, Q + 1, B))
    q[np.arange(Q)[None, :] >= qlen[:, None]] = 7
    s[rng.random((B, S)) < 0.003] = 5
    slens = np.where(rng.random(B) < 0.7, S,
                     rng.integers(S // 2, S + 1, B)).astype(np.int32)
    s[np.arange(S)[None, :] >= slens[:, None]] = 7
    return q, s, slens, pad, W, S


def band_tie_windows(rng, B: int, Q: int):
    """tie_windows at the long-read geometry (band_geometry), for holding
    the tracked banded kernel's first-argmax rule against
    sw_band_score_ref: a unit of 1 to 4 bases repeats along the query and
    the subject, so every band diagonal whose offset is a multiple of the
    unit matches end to end, and the maximum of T is reached in many band
    lanes of one row and again in later rows.  Returns (q, s, slens, pad,
    W, S)."""
    S, pad, W = band_geometry(Q)
    return tie_windows(rng, B, Q, S) + (pad, W, S)


def eterm_windows(rng, B: int, Q: int, S: int, pad: int, W: int, edges,
                  match: int, go: int, ge: int, cross=()):
    """B band windows whose best path crosses a band kernel's boundary
    lane on the E of the row before (for holding the several-warps and
    the cluster kernel's exchange: a warp's posted total lacks its last
    lane's Ein, and the E of the next warp's first lane from the row
    before corrects it).  `edges` are first lanes a of warps or CTAs (0 <
    a < W), cycled over the windows.  Each window holds two runs of n
    matches on band lane l = a - 1 + k, k subject rows of X between
    them: the best path leaves the first run down a vertical gap of k rows
    into lane a - 1, the warp's last lane, and takes a horizontal gap of
    k columns from there back to lane l.  The other two-gap path, right
    first, would pass lane l + k >= W, outside the band; every other path
    opens a third gap or scores X, and costs more when go > ge and X
    (mismatch - match) costs more than 2 * ge.  So the best score is 2 * n *
    match - 2 * go - 2 * (k - 1) * ge (or a little more, from the random
    bases around the runs), and a kernel that drops the correction scores
    less: its best path avoids the boundary and opens a third gap.
    `cross`, query columns cycled over the windows: the runs are placed so
    that the horizontal gap steps from column c - 1 into column c (for
    sw_band's strip kernel, whose edges are query columns: F then comes
    from the carry of the strip or the group to the left).
    Returns int32 numpy (q [B, Q], subj [B, S], slens [B]) and the planted
    scores [B]."""
    prepad = pad + W // 2
    q = rng.integers(0, 4, (B, Q)).astype(np.int32)
    s = rng.integers(0, 4, (B, S)).astype(np.int32)
    want = np.zeros(B, np.int64)
    for b in range(B):
        a = int(edges[b % len(edges)])
        kmin = (W - a + 2) // 2          # lane + k >= W
        k = kmin + int(rng.integers(0, max(0, min(8, W - a - kmin)) + 1))
        lane = a - 1 + k
        n = -(-2 * (go + k * ge) // match) + 32   # a run outscores it
        r0 = max(1, prepad - lane + 1) + int(rng.integers(0, 8))
        if len(cross):                   # the gap spans columns (c_v, c_v + k]
            c = int(cross[b % len(cross)])
            r0 = c - int(rng.integers(0, k)) - n + prepad - lane
        rows = np.arange(r0 - 1, r0 + 2 * n + k + 1)
        cols = rows + lane - prepad
        if not 0 < a < lane < W or rows[0] < 0 or rows[-1] >= S or \
                cols[0] < 0 or cols[-1] >= Q:
            raise ValueError(f"eterm_windows: no room for edge {a}, k {k} "
                             f"at Q={Q} S={S} W={W}")
        mid = (rows >= r0 + n) & (rows < r0 + n + k)
        run = (rows >= r0) & ~mid
        # a mismatch before and after the runs; between them X (4), which
        # scores mismatch - match against every code but N
        s[b, rows] = np.where(run, q[b, cols], np.where(
            mid, 4, (q[b, cols] + 1) % 4))
        want[b] = 2 * n * match - 2 * go - 2 * (k - 1) * ge
    return q, s, np.full(B, S, np.int32), want


# ctypes signatures of the kernels' plain C entry points (p pointer, i int),
# by entry point less its "_launch"; sw_full's and sw_band's `wide` comes
# last, so that earlier versions of those sources (which take none) can be
# timed beside them (ops/time_sw.py).  sw_full_strip is sw_full.cu's entry
# for queries past MAX_Q: sw_full's arguments, the carry scratch and the
# warps a window (strip_warps; last, as `wide` is, for the same reason);
# sw_band_cluster and sw_band_strips are sw_band.cu's entries for bands
# past TILED_BAND_W and CLUSTER_BAND_W: sw_band's arguments less `wide`,
# then the cluster's shape (cluster_shape), or the carry and flag
# scratch, the warps a CTA (BAND_STRIP_WARPS) and the matrix's `wide`.
_SIGS = {"sw_full": "ppppiiiiiippppi", "sw_band": "ppppiiiiiiiippppi",
         "swq": "ppppiiiiiippppp", "sw_full_strip": "ppppiiiiiippppipi",
         "sw_band_strips": "ppppiiiiiiiippppppii",
         "sw_band_cluster": "ppppiiiiiiiippppii"}


def bind(lib, entry: str):
    """Set the ctypes signature of lib's `<entry>_launch` (_SIGS)."""
    fn = getattr(lib, entry + "_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int
                   for c in _SIGS[entry]]


def _kernel_lib(name: str):
    """Build (at first use) and bind csrc/<name>.cu: every entry point
    of _SIGS the source has."""
    lib = _libs.get(name)
    if lib is None:
        from .build import load
        lib = load(name)
        for entry in _SIGS:
            if entry == name or entry.startswith(name + "_"):
                bind(lib, entry)
        _libs[name] = lib
    return lib


def _check_args(kname: str, qcodes, subj, slens, matrix):
    """What every kernel wrapper takes: contiguous int32 tensors on one
    CUDA device, q [B, Q], subj [B, S], slens [B], matrix [8, 8]."""
    dev = qcodes.device
    for name, t in (("qcodes", qcodes), ("subj", subj), ("slens", slens),
                    ("matrix", matrix)):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{kname}: {name} must be on {dev} (cuda), "
                             f"got {t.device}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{kname}: {name} must be contiguous int32")
    B = qcodes.shape[0]
    if qcodes.dim() != 2 or subj.dim() != 2 or subj.shape[0] != B or \
            slens.shape != (B,) or matrix.shape != (8, 8):
        raise ValueError(f"{kname}: shapes q {tuple(qcodes.shape)} subj "
                         f"{tuple(subj.shape)} slens {tuple(slens.shape)} "
                         f"matrix {tuple(matrix.shape)}")


def sw_full_cuda(qcodes, subj, slens, matrix, gapopen_pos: int,
                 gapext_pos: int, track: bool = False):
    """Launch csrc/sw_full.cu on the current stream.  Same arguments
    and results as sw_score_ref; every tensor contiguous int32 on one
    CUDA device, the matrix a DeviceMatrix; the instance as
    sw_full_instance names it.  A query past MAX_Q columns runs the strip
    path (sw_full_strip_launch, strip_warps(B, Q, S) warps a window) over
    the groups of windows scratch_groups makes, one launch a group, with an
    int32 carry scratch for one group made here."""
    B, Q = qcodes.shape
    if Q < 1:
        raise ValueError("sw_full: empty query")
    S = subj.shape[1]
    check_score_cap("sw_full", matrix, Q, S, gapopen_pos, gapext_pos)
    _check_args("sw_full", qcodes, subj, slens, matrix.t)
    dev = qcodes.device
    name = sw_full_instance(B, Q, S, matrix, track)
    strip = Q > MAX_Q
    lib = _kernel_lib("sw_full")
    outs = [torch.empty(B, dtype=torch.int32, device=dev)
            for _ in range(3 if track else 1)]
    groups = scratch_groups(B, 8 * S) if strip else [(0, B)]
    tail = ()                          # the strip path's carry and warps
    if strip and groups:
        g = groups[0][1] - groups[0][0]
        carry = torch.empty((g, S, 2), dtype=torch.int32, device=dev)
        tail = (carry.data_ptr(), strip_warps(B, Q, S, _wide_code(name) > 0))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        launch = lib.sw_full_strip_launch if strip else lib.sw_full_launch
        for lo, hi in groups:          # pointers at the group's first window
            outp = [o.data_ptr() + 4 * lo for o in outs] + \
                [None] * (3 - len(outs))
            rc = launch(
                qcodes.data_ptr() + 4 * lo * Q, subj.data_ptr() + 4 * lo * S,
                slens.data_ptr() + 4 * lo, matrix.t.data_ptr(), hi - lo, Q, S,
                int(gapopen_pos), int(gapext_pos), 1 if track else 0, *outp,
                stream, _wide_code(name), *tail)
            if rc != 0:
                raise RuntimeError(f"sw_full launch failed (code {rc})")
            launches[name] += 1
    return tuple(outs) if track else outs[0]


def sw_score_batch(qcodes, subj, slens, matrix, gapopen_pos: int,
                   gapext_pos: int, device, track: bool = False):
    """Batched full-matrix SW scores on `device`.

    qcodes: [B, Q] query codes 0..7 (on CUDA: Q <= MAX_Q in registers,
            longer queries in column strips)
    subj:   [B, S] subject codes; rows at or past slens are ignored
    slens:  [B]    valid subject lengths
    matrix: [8, 8] score matrix (code 7 must score 0: it pads): a host
            array, or the DeviceMatrix device_matrix made of one;
            any int32 entries within the int32 DP's bound
            (check_score_cap, on every device)

    Returns best [B] int32, or (best, ti, tj) with track=True: the
    row-major-first argmax cell of each window's DP (subject row ti,
    query lane tj), the anchor of the host traceback."""
    assert gapopen_pos >= gapext_pos, "prefix-scan F requires go >= ge"
    device = torch.device(device)
    args = [_as_i32(x, device) for x in (qcodes, subj, slens)]
    mat = _matrix_on(matrix, device)
    check_score_cap("sw_full", mat, args[0].shape[1], args[1].shape[1],
                    gapopen_pos, gapext_pos)
    if device.type == "cpu":
        return sw_score_ref(*args, mat.t, gapopen_pos, gapext_pos,
                            track=track)
    if device.type == "cuda":
        return sw_full_cuda(*args, mat, gapopen_pos, gapext_pos, track=track)
    raise ValueError(f"sw_score_batch: no kernel for device {device}")


def band_width_for(Q: int, pad: int) -> int:
    """Band width for a long-read window (smalt_tpu/ops/sw.py:417): wide
    enough for the window pad plus ~3% indel drift each way, rounded up
    to 128.  Part of the contract: W and the centre pad + W//2 decide
    which cells lie in the band, and the host tail's drift band is
    W // 2 of the same formula (native/fastlane.c fl_band_width_for)."""
    need = 2 * pad + 2 * max(32, Q // 32)
    return max(128, -(-need // 128) * 128)


def sw_band_score_ref(qcodes, subj, slens, matrix, gapopen_pos: int,
                      gapext_pos: int, pad: int, W: int,
                      track: bool = False):
    """Plain torch version of the banded kernel (the jnp oracle of
    smalt_tpu/ops/sw.py:475): band lane t of subject row i holds query
    column i - prepad + t (prepad = pad + W//2; code 7 outside the
    query), the diagonal predecessor stays in its lane and E comes from
    lane t + 1.  Returns best [B] (>= 0) or, with track, (best, ti, tj):
    the row-major-first argmax cell in (subject row, query column)."""
    device = qcodes.device
    B, Q = qcodes.shape
    S = subj.shape[1]
    go, ge = int(gapopen_pos), int(gapext_pos)
    i32 = torch.int32
    prepad = pad + W // 2
    tidx = torch.arange(W, dtype=i32, device=device)
    qlong = qcodes.long()
    H = torch.zeros((B, W), dtype=i32, device=device)
    E = torch.full((B, W), NEG, dtype=i32, device=device)
    vmax = torch.zeros(B, dtype=i32, device=device)
    bi = torch.zeros(B, dtype=i32, device=device)
    bl = torch.zeros(B, dtype=i32, device=device)
    negcol = torch.full((B, 1), NEG, dtype=i32, device=device)
    big = torch.full((B, W), 1 << 28, dtype=i32, device=device)
    for i in range(S):
        j = i - prepad + tidx
        inq = (j >= 0) & (j < Q)
        qc = torch.where(inq, qlong[:, j.clamp(0, Q - 1).long()], 7)
        T = H + matrix[subj[:, i].long()[:, None], qc]
        E_in = torch.cat([E[:, 1:], negcol], dim=1)
        H0 = torch.clamp_min(torch.maximum(T, E_in), 0)
        cm = torch.cummax(H0 + tidx * ge, dim=1).values
        F = torch.cat([negcol, cm[:, :-1]], dim=1) - go - (tidx - 1) * ge
        Hn = torch.maximum(H0, F)
        En = torch.maximum(E_in - ge, Hn - go)
        keep = i < slens
        H = torch.where(keep[:, None], Hn, H)
        E = torch.where(keep[:, None], En, E)
        rowmax = T.amax(dim=1)
        upd = keep & (rowmax > vmax)
        minlane = torch.where(T == rowmax[:, None], tidx, big).amin(dim=1)
        vmax = torch.where(upd, rowmax, vmax)
        bi = torch.where(upd, i, bi).to(i32)
        bl = torch.where(upd, minlane, bl)
    if track:
        return vmax, bi, bi + bl - prepad
    return vmax


def clamp_band_width(Q: int, pad: int, W: int = 0) -> int:
    """The band width the Pallas wrapper runs (sw.py:449-451): W, or
    band_width_for when 0, clamped to the query rounded up to 128 plus
    128.  The band is then centred pad + W//2 columns left of the
    window start."""
    return min(W or band_width_for(Q, pad), -(-Q // 128) * 128 + 128)


def sw_band_cuda(qcodes, subj, slens, matrix, gapopen_pos: int,
                 gapext_pos: int, pad: int, W: int, track: bool = False):
    """Launch csrc/sw_band.cu on the current stream.  Same arguments
    and results as sw_band_score_ref (W as given, >= 1); every tensor
    contiguous int32 on one CUDA device, the matrix a DeviceMatrix; the
    instance as sw_band_instance names it.  A band past TILED_BAND_W runs
    the cluster kernel (sw_band_cluster_launch, one launch in the shape
    cluster_shape gives), and one past CLUSTER_BAND_W the strip kernel
    (sw_band_strips_launch, BAND_STRIP_WARPS strips a CTA) over the groups
    of windows scratch_groups makes, one launch a group, with the int32
    carry and flag scratch for one group made here."""
    if W < 1:
        raise ValueError(f"sw_band: band width {W} < 1")
    B, Q = qcodes.shape
    S = subj.shape[1]
    check_score_cap("sw_band", matrix, Q, S, gapopen_pos, gapext_pos, W)
    _check_args("sw_band", qcodes, subj, slens, matrix.t)
    name = sw_band_instance(Q, S, W, matrix, track)
    dev = qcodes.device
    if Q < 1:
        raise ValueError("sw_band: empty query")
    lib = _kernel_lib("sw_band")
    outs = [torch.empty(B, dtype=torch.int32, device=dev)
            for _ in range(3 if track else 1)]
    strips = name.endswith("_strips")
    groups = scratch_groups(B, band_strip_bytes(S)) if strips else [(0, B)]
    tail = ()                          # the strip kernel's scratch and shape
    if strips and groups:
        g = groups[0][1] - groups[0][0]
        carry = torch.empty((g, S, 2), dtype=torch.int32, device=dev)
        flags = torch.empty(band_strip_flag_words(g, S), dtype=torch.int32,
                            device=dev)
        tail = (carry.data_ptr(), flags.data_ptr(), BAND_STRIP_WARPS,
                int(matrix.wide))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lo, hi in groups:          # pointers at the group's first window
            outp = [o.data_ptr() + 4 * lo for o in outs] + \
                [None] * (3 - len(outs))
            args = (qcodes.data_ptr() + 4 * lo * Q,
                    subj.data_ptr() + 4 * lo * S, slens.data_ptr() + 4 * lo,
                    matrix.t.data_ptr(), hi - lo, Q, S, W, pad + W // 2,
                    int(gapopen_pos), int(gapext_pos), 1 if track else 0,
                    *outp, stream)
            if strips:
                rc = lib.sw_band_strips_launch(*args, *tail)
            elif name.endswith("_cluster"):
                rc = lib.sw_band_cluster_launch(*args, *cluster_shape(W))
            else:
                rc = lib.sw_band_launch(*args, band_wide_code(
                    matrix, name.endswith("_wide")))
            if rc != 0:
                raise RuntimeError(f"sw_band launch failed (code {rc})")
            launches[name] += 1
    return tuple(outs) if track else outs[0]


def sw_band_score_batch(qcodes, subj, slens, matrix, gapopen_pos: int,
                        gapext_pos: int, pad: int, W: int = 0, *, device,
                        track: bool = False):
    """Banded batched SW scores for long reads on `device`, cost O(W*S)
    instead of O(Q*S) (sw.py:425).  Subject row i covers query columns
    [i - pad - W/2, i - pad + W/2): `pad` is the window's left backoff,
    so the seed diagonal sits mid-band.  W defaults to band_width_for
    and is clamped as the Pallas wrapper clamps it (clamp_band_width).
    The matrix is a host array or the DeviceMatrix device_matrix made of
    one, within the int32 DP's bound (check_score_cap).

    Returns best [B] int32, or (best, ti, tj) with track=True: the
    row-major-first argmax cell in (subject row, query column)."""
    assert gapopen_pos >= gapext_pos, "prefix-scan F requires go >= ge"
    device = torch.device(device)
    W = clamp_band_width(int(qcodes.shape[1]), pad, W)
    args = [_as_i32(x, device) for x in (qcodes, subj, slens)]
    mat = _matrix_on(matrix, device)
    check_score_cap("sw_band", mat, args[0].shape[1], args[1].shape[1],
                    gapopen_pos, gapext_pos, W)
    if device.type == "cpu":
        return sw_band_score_ref(*args, mat.t, gapopen_pos, gapext_pos, pad,
                                 W, track=track)
    if device.type == "cuda":
        return sw_band_cuda(*args, mat, gapopen_pos, gapext_pos, pad, W,
                            track=track)
    raise ValueError(f"sw_band_score_batch: no kernel for device {device}")
