"""Device-exact collation on one torch device: the exact engine's front
half for a block of reads.

Counterpart of smalt_tpu/parallel/exact_collate.py's two steps.  In the
host-hits step (`_step_hh`, :695) the host C pre block
(fl_exact_pre_block) ships each (read, strand) lane's hit keys.  In the
device-hit step (`_step`, :637; the regime where the host cannot expand
the hits, e.g. nskip > wordlen) the host ships only the selected-seed
mask, and the device re-derives the hit info from the resident index
(rolling words, the ring repeat filter, the direct-table lookup, with a
checksum the host verifies), then, for each of the V reference
intervals, finds each seed's in-interval slice of its positions by binary
search and expands it into hit keys.  Both steps then sort the keys,
form seeds, constant-shift segments, regions and candidates in one
sequential scan (segment.c semantics; `segcand_scan`: csrc/segcand.cu
on CUDA, one thread a lane), compact the candidate rows into one pool in
per-read (strand, interval, emission) order, compute each candidate's
pass-1 window (mc_calc_seg_offsets) and score the SIMD-eligible windows
with the score-only full-matrix kernel (ops/sw.py `sw_score_batch`,
`track=False`: csrc/sw_full.cu on CUDA).  The host then verifies and
finishes byte-identically; any read the device cannot serve exactly is
flagged and re-staged on the host.

Everything else here is plain torch on int32 tensors, held to the JAX
step value for value; the scan's plain torch version (`_segcand_scan` +
`_compact_rows`) is the reference the tests hold segcand_scan to.  Where torch would drift from JAX: JAX's multi-key
`lax.sort` becomes chained stable sorts (least significant key first);
cumulative sums and reductions name int32, which torch would otherwise
widen to int64; the int32 shifts and the BIG-pad sums wrap as in JAX;
every gather index is clipped as JAX clips it, since an out-of-range
index is a device-side fault on CUDA; `.at[].max()` is `scatter_reduce`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.sw import device_matrix, sw_score_batch

# Re-declared from smalt_tpu/parallel/exact_collate.py (whose package
# imports jax); a test holds them equal.
NREPEATS = 4           # hashhit.c:42 ring size
SEG_DIFFSHIFT = 3      # segment.c SEGMENTING_DIFFSHIFT
EDGE_BAND_FACTOR = 4   # segment.c:137
MAX_BANDEDGE_2POW = 4  # segment.c:142
MINLEN_QUERY_STRIPED = 32
BWSCAL_QLEN = 48
BIG = 0x7FFFFFF0
MMALI_BIT = -(1 << 31)
# pass-1 window cells (rows x SPAD) a scoring group: with the gather's
# int64 indices some 1.2 GB of scratch a group
SCORE_GROUP_CELLS = 1 << 26

_I32 = torch.int32


@dataclass(frozen=True)
class CollateCfg:
    """The collate step's static shape (exact_collate.py:78)."""
    wordlen: int
    nskip: int
    maxhit: int            # ktuple_maxhit (per-word cutoff)
    B: int                 # reads per block
    Q: int                 # padded read length (<= 255)
    H: int = 512           # hits cap per (read, strand, interval)
    C: int = 16            # candidate cap per (read, strand, interval)
    P: int = 0             # pool cap (default 6*B)
    V: int = 1             # interval slots of the device V loop
    host_hits: bool = False  # host ships padded (k1, k2) hit keys
    NS: int = 1            # reference sequences; > 1: per-hit seq ids
    SPAD: int = 128        # pass-1 window pad (oversize -> restage)

    @property
    def pool(self):
        return self.P or 6 * self.B


def _shift_right(x, fill: int = 0):
    """x[:, :-1] moved one column right, column 0 = fill (jnp.pad)."""
    return torch.nn.functional.pad(x[:, :-1], (1, 0), value=fill)


def _hitinfo_device(cfg: CollateCfg, codes, qbad, qlens, table):
    """Per-strand device hit info (exact_collate.py:100, mc_hitinfo_collect
    semantics): lane t = the k-mer starting at query position t.
    codes [B, Q] mangled codes, qbad [B, Q] bool (quality below the
    floor), qlens [B], table the [4^k, 2] direct offset table.  Returns
    (is_seed [B, 2, Q] bool, cnt [B, 2, Q] int32, base [B, 2, Q] int32)."""
    k = cfg.wordlen
    B, Q = cfg.B, cfg.Q
    dev = codes.device
    c2 = (codes & 3).to(_I32)
    bad = qbad | ((codes & 4) != 0)
    t_iota = torch.arange(Q, dtype=_I32, device=dev)[None, :]

    # rolling words, both strands (fwd: base j at bit 2*(k-1-j); rev: its
    # complement at bit 2*j), over the lanes c2[t+j] (0 past the end)
    wf = torch.zeros((B, Q), dtype=_I32, device=dev)
    wr = torch.zeros((B, Q), dtype=_I32, device=dev)
    for j in range(k):
        col = torch.nn.functional.pad(c2[:, j:], (0, j))
        wf = wf | (col << (2 * (k - 1 - j)))
        wr = wr | ((col ^ 3) << (2 * j))

    # window validity: t <= qlen-k and no bad base inside [t, t+k)
    badc = torch.nn.functional.pad(torch.cumsum(bad.to(_I32), dim=1,
                                                dtype=_I32), (1, 0))
    hi = torch.clamp_max(t_iota + k, Q).expand(B, Q).long()
    nbad = torch.gather(badc, 1, hi) - badc[:, :Q]
    ok = (nbad == 0) & (t_iota <= (qlens[:, None] - k))

    # ring repeat filter (hashhit.c:325-342): a word equal to one of the
    # previous NREPEATS OK windows' words; okpos[r] = the r-th OK window
    okrank = torch.cumsum(ok.to(_I32), dim=1, dtype=_I32) - 1
    okpos = torch.sort(torch.where(ok, t_iota, BIG), dim=1).values
    words2 = torch.stack([wf, wr], dim=1)              # [B, 2, Q]
    rep = torch.zeros((B, 2, Q), dtype=torch.bool, device=dev)
    for d in range(1, NREPEATS + 1):
        r_prev = okrank - d
        has = ok & (r_prev >= 0)
        pidx = torch.gather(okpos, 1, torch.clamp_min(r_prev, 0).long())
        pidx = torch.clamp_max(pidx, Q - 1).long()
        pw = torch.gather(words2, 2, pidx[:, None, :].expand(B, 2, Q))
        rep = rep | (has[:, None, :] & (pw == words2))

    # direct-address lookup: the pair {starts[w], starts[w+1]}
    keep = ok[:, None, :] & ~rep
    pair = table[torch.where(keep, words2, 0).long()]  # [B, 2, Q, 2]
    base = pair[..., 0]
    cnt = pair[..., 1] - base
    is_seed = keep & (cnt >= 1)
    if cfg.maxhit > 0:
        is_seed = is_seed & (cnt <= cfg.maxhit)
    return is_seed, torch.where(is_seed, cnt, 0), torch.where(is_seed, base, 0)


def _lower_bound(arr, lo0, hi0, target: int, steps: int):
    """Lane-parallel lower_bound over slices [lo0, hi0) of the 1-D arr
    (exact_collate.py:165): the smallest i with arr[i] >= target."""
    n = arr.shape[0]
    lo, hi = lo0, hi0
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        v = arr[mid.clamp(0, n - 1).long()]
        go = active & (v < target)
        lo = torch.where(go, mid + 1, lo)
        hi = torch.where(active & ~go, mid, hi)
    return lo


def _expand_hits(cfg: CollateCfg, pos, a, nh, strand_is_rev):
    """The selected seeds' in-interval hits as packed sort keys
    (exact_collate.py:180): k1 = p -/+ q/nskip, k2 = q, the seed's query
    offset, BIG past each lane's `total`.  a, nh [R, Q]: each seed's slice
    start in pos and its length (0 for non-seeds).  Hit slot h belongs to
    the smallest seed s with cum[s] > h (a 9-step binary search: 2^9 >
    Q).  Returns (k1, k2, valid [R, H], total [R])."""
    R = a.shape[0]
    H, Q = cfg.H, cfg.Q
    dev = a.device
    npos = pos.shape[0]
    cum = torch.cumsum(nh, dim=1, dtype=_I32)          # inclusive [R, Q]
    total = cum[:, -1]
    cum_ex = _shift_right(cum)                         # exclusive
    h_iota = torch.arange(H, dtype=_I32, device=dev)[None, :]
    lo = torch.zeros((R, H), dtype=_I32, device=dev)
    hi = torch.full((R, H), Q - 1, dtype=_I32, device=dev)
    for _ in range(9):
        mid = (lo + hi) >> 1
        go = torch.gather(cum, 1, mid.clamp(0, Q - 1).long()) <= h_iota
        lo = torch.where(go, mid + 1, lo)
        hi = torch.where(go, hi, mid)
    sid = torch.clamp_max(lo, Q - 1)                   # [R, H]
    valid = h_iota < total[:, None]
    sidl = sid.long()
    pidx = torch.gather(a, 1, sidl) + (h_iota - torch.gather(cum_ex, 1, sidl))
    p = pos[pidx.clamp(0, npos - 1).long()]
    qd = sid // cfg.nskip                              # lane t == qoffs
    k1 = torch.where(strand_is_rev[:, None], p + qd, p - qd)
    return (torch.where(valid, k1, BIG), torch.where(valid, sid, BIG), valid,
            total)


def lexsort_rows(keys):
    """Sort each row of the [R, H] int32 tensors in `keys` together,
    lexicographically with keys[0] leading: jax.lax.sort(keys,
    num_keys=len(keys)).  Chained stable sorts, least significant key
    first.  Returns the sorted keys."""
    perm = None
    for key in reversed(keys):
        k = key if perm is None else torch.gather(key, 1, perm)
        order = torch.sort(k, dim=1, stable=True).indices
        perm = order if perm is None else torch.gather(perm, 1, order)
    return [torch.gather(key, 1, perm) for key in keys]


def _segcand_scan(cfg: CollateCfg, k1, k2, valid, mdsh, mincover,
                  strand_is_rev, ivl=None):
    """The sequential scan over each lane's sorted hits
    (exact_collate.py:203): seeds (segment.c:455), constant-shift
    segments (:535), regions (:396) and the greedy candidate merge
    (:1140, derriveSEGCAND :929), up to two packed rows a step.  A Python
    loop of H + 1 steps of lane-parallel torch ops: the plain version of
    segcand_scan, which the steps run.

    k1, k2, valid [R, H]; mdsh, mincover [R]; strand_is_rev [R] bool;
    ivl [R, H] interval id per sorted hit (None: one interval).
    Returns (emit flags [R, 2H+2], rows [R, 2H+2, 7], bad [R]); row
    field 6 is the candidate's interval id."""
    R, H = k1.shape
    k, nskip, Q = cfg.wordlen, cfg.nskip, cfg.Q
    dev = k1.device
    pos_iota = torch.arange(Q, dtype=_I32, device=dev)[None, :]

    d1 = k1 - _shift_right(k1)
    prev_k2 = _shift_right(k2)
    e_iota = torch.arange(H, dtype=_I32, device=dev)[None, :]
    same_region = (d1 < mdsh[:, None]) | \
        ((d1 == mdsh[:, None]) & (k2 < prev_k2))
    same_shift = (d1 == 0) & (e_iota > 0)
    if ivl is not None:
        ivl_change = (ivl != _shift_right(ivl)) & (e_iota > 0)
        same_region = same_region & ~ivl_change
        same_shift = same_shift & ~ivl_change
    region_start = (e_iota == 0) | ~same_region

    zeros = torch.zeros(R, dtype=_I32, device=dev)
    fal = torch.zeros(R, dtype=torch.bool, device=dev)
    zrow = torch.zeros((R, 7), dtype=_I32, device=dev)
    mmali_bit = torch.full((R,), MMALI_BIT, dtype=_I32, device=dev)

    def seg_bounds(st):
        """calcSegmentBoundaries (segment.c:637-668)."""
        seed_len = st["seed_lastq"] - st["seed_q0"]
        qs = st["seg_q0first"]
        qe = st["seed_q0"] + seed_len - 1
        sh = st["seg_shift"]
        ext = (seed_len - k) // nskip
        rs = torch.where(strand_is_rev, sh - st["seed_q0"] // nskip - ext,
                         sh + qs // nskip)
        re = torch.where(strand_is_rev, sh - qs // nskip,
                         sh + st["seed_q0"] // nskip + ext)
        return qs, qe, rs, re

    def pack_row(c, reg_ivl):
        """derriveSEGCAND final fields from candidate accumulators."""
        qs, qe, rs, re = c["qs"], c["qe"], c["rs"], c["re"]
        sh_start = torch.where(strand_is_rev, rs + (qe - k + 1) // nskip,
                               rs - qs // nskip)
        diff_shift = c["shiftmin"] - sh_start
        srange = c["lastshift"] - c["shiftmin"]
        mmali = c["maxcovseg"] >= mincover
        sh2mm = torch.where(mmali, c["shift2mm"] - sh_start, 0)
        w0 = (qs | (qe << 8) | (c["cover"] << 16) |
              (torch.clamp_max(c["nseg"], 255) << 24))
        w5 = (srange & 0x3FFFFF) | torch.where(mmali, mmali_bit, 0)
        bad = ((c["nseg"] > 255) | (srange < 0) | (srange >= (1 << 22)) |
               (c["cover"] > 255) | (qs < 0) | (qe > 255))
        return torch.stack([w0, rs, re, diff_shift, sh2mm, w5, reg_ivl],
                           dim=1), bad

    def step(st, xs):
        k1e, k2e, val, rstart, sshift, ivl_e = xs
        force = st["force"]
        open_seed = st["open_seed"]

        # classify the incoming hit
        merge = (val & ~rstart & sshift & open_seed &
                 (k2e <= st["seed_lastq"]) &
                 ((k2e - st["seed_q0"]) % nskip == 0))
        new_seed = val & ~merge
        seg_cont = (new_seed & ~rstart & open_seed &
                    (k1e == st["seg_shift"]) &
                    ((k2e - st["seg_q0first"]) % nskip == 0))
        close_seg = open_seed & ((new_seed & ~seg_cont) | force)
        close_cand = open_seed & ((val & rstart) | force)

        # ---- segment completion + greedy candidate decision ----
        seed_len = st["seed_lastq"] - st["seed_q0"]
        seg_cover = st["seg_cover_done"] + seed_len
        qs_s, qe_s, rs_s, re_s = seg_bounds(st)
        cand_open = st["cand_open"]
        c = st["c"]
        brk = (close_seg & cand_open & (2 * st["seg_covernew"] < seg_cover)
               & (c["cover"] >= mincover))
        fresh = (close_seg & ~cand_open) | brk

        row_b, bad_b = pack_row(c, st["reg_ivl"])
        emit0 = torch.where(brk[:, None], row_b, zrow)   # break always emits
        bad = st["bad"] | (brk & bad_b)

        upd_max = seg_cover > c["maxcovseg"]
        cn = dict(
            cover=torch.where(fresh, seg_cover,
                              c["cover"] + st["seg_covernew"]),
            qs=torch.where(fresh, qs_s, torch.minimum(c["qs"], qs_s)),
            qe=torch.where(fresh, qe_s, torch.maximum(c["qe"], qe_s)),
            rs=torch.where(fresh, rs_s, torch.minimum(c["rs"], rs_s)),
            re=torch.where(fresh, re_s, torch.maximum(c["re"], re_s)),
            shiftmin=torch.where(fresh, st["seg_shift"], c["shiftmin"]),
            maxcovseg=torch.where(fresh | upd_max, seg_cover,
                                  c["maxcovseg"]),
            shift2mm=torch.where(fresh | upd_max, st["seg_shift"],
                                 c["shift2mm"]),
            lastshift=torch.where(close_seg, st["seg_shift"],
                                  c["lastshift"]),
            nseg=torch.where(fresh, 1, torch.where(close_seg, c["nseg"] + 1,
                                                   c["nseg"])),
        )
        c = {kk: torch.where(close_seg, cn[kk], c[kk]) for kk in cn}
        cand_open = cand_open | close_seg
        smask = st["seg_mask"]
        cmask = torch.where(close_seg[:, None],
                            torch.where(fresh[:, None], smask,
                                        st["cand_mask"] | smask),
                            st["cand_mask"])

        # region close: emit the (possibly just-integrated) candidate
        row_r, bad_r = pack_row(c, st["reg_ivl"])
        emit_r = close_cand & cand_open & (c["cover"] >= mincover)
        emit1 = torch.where(emit_r[:, None], row_r, zrow)
        bad = bad | (emit_r & bad_r)
        cand_open = cand_open & ~close_cand
        cmask = cmask & ~close_cand[:, None]

        # ---- start / extend structures with the incoming hit ----
        lo = torch.where(merge, st["seed_lastq"], k2e)
        hi_b = torch.where(val, k2e + k, k2e)            # empty if !val
        bits = ((pos_iota >= lo[:, None]) & (pos_iota < hi_b[:, None]) &
                val[:, None])
        covnew_add = (bits & ~cmask).sum(dim=1, dtype=_I32)
        reset_seg = close_seg | ~open_seed
        smask = (smask & ~reset_seg[:, None]) | bits
        covnew = torch.where(reset_seg, 0, st["seg_covernew"]) + \
            torch.where(val, covnew_add, 0)
        scover_done = torch.where(reset_seg, 0, st["seg_cover_done"]) + \
            torch.where(new_seed & open_seed & ~close_seg, seed_len, 0)

        ns = dict(
            open_seed=(open_seed & ~force) | new_seed,
            force=force,
            seed_q0=torch.where(new_seed, k2e, st["seed_q0"]),
            seed_lastq=torch.where(val, k2e + k, st["seed_lastq"]),
            seg_shift=torch.where(new_seed & ~seg_cont, k1e,
                                  st["seg_shift"]),
            seg_q0first=torch.where(new_seed & ~seg_cont, k2e,
                                    st["seg_q0first"]),
            seg_cover_done=scover_done,
            seg_covernew=covnew,
            seg_mask=smask,
            cand_mask=cmask,
            cand_open=cand_open,
            c=c,
            bad=bad,
            reg_ivl=torch.where(val & rstart, ivl_e, st["reg_ivl"]),
        )
        return ns, (brk, emit0, emit_r, emit1)

    st = dict(
        open_seed=fal, force=fal,
        seed_q0=zeros, seed_lastq=zeros,
        seg_shift=zeros, seg_q0first=zeros,
        seg_cover_done=zeros, seg_covernew=zeros,
        seg_mask=torch.zeros((R, Q), dtype=torch.bool, device=dev),
        cand_mask=torch.zeros((R, Q), dtype=torch.bool, device=dev),
        cand_open=fal,
        c={kk: zeros for kk in ("cover", "qs", "qe", "rs", "re", "shiftmin",
                                "maxcovseg", "shift2mm", "lastshift",
                                "nseg")},
        bad=fal,
        reg_ivl=zeros,
    )
    ivl_x = torch.zeros_like(k1) if ivl is None else ivl
    flags, rows = [], []
    for e in range(H):
        st, (f0, r0, f1, r1) = step(st, (k1[:, e], k2[:, e], valid[:, e],
                                         region_start[:, e],
                                         same_shift[:, e], ivl_x[:, e]))
        flags += [f0, f1]
        rows += [r0, r1]
    # epilogue: close everything still open
    st = dict(st, force=torch.ones(R, dtype=torch.bool, device=dev))
    st, (f0, r0, f1, r1) = step(st, (zeros, zeros, fal, fal, fal, zeros))
    flags += [f0, f1]
    rows += [r0, r1]
    return torch.stack(flags, dim=1), torch.stack(rows, dim=1), st["bad"]


def _compact_rows(cfg: CollateCfg, ef, er):
    """Per-lane compaction of the scan emissions in emission order
    (exact_collate.py:419): [R, E(, F)] -> rows [R, C, F], counts [R],
    overflow [R]."""
    R, E = ef.shape
    C, F = cfg.C, er.shape[2]
    key = torch.where(ef, torch.arange(E, dtype=_I32, device=ef.device),
                      BIG)
    order = torch.sort(key, dim=1, stable=True).indices[:, :C]
    rows = torch.gather(er, 1, order[:, :, None].expand(R, C, F))
    counts = ef.sum(dim=1, dtype=_I32)
    slot_ok = torch.arange(C, dtype=_I32, device=ef.device) < counts[:, None]
    return torch.where(slot_ok[:, :, None], rows, 0), counts, counts > C


_segcand_libs: dict = {}
# launches of csrc/segcand.cu, calls of its host build
launches = {"segcand": 0, "segcand_host": 0}


def segcand_scan(cfg: CollateCfg, k1s, k2s, ivl, tot, mdsh, mincover):
    """_segcand_scan + _compact_rows as csrc/segcand.cuh's code, one
    thread a lane: on CUDA one launch of csrc/segcand.cu on the current
    stream, on the CPU the header's host build.  k1s, k2s (ivl or None)
    [R, H] int32 sorted as the host-hits step sorts them, tot [R] each
    lane's hits, mdsh, mincover [R], all contiguous int32 on one device.
    Returns what the plain version's pair returns, (rows [R, C, 7],
    counts [R], overflow [R]), and its bad [R]."""
    import ctypes
    dev = k1s.device
    R, H = k1s.shape
    for t in [k1s, k2s, tot, mdsh, mincover] + ([] if ivl is None
                                                else [ivl]):
        if t.device != dev or t.dtype != _I32 or not t.is_contiguous():
            raise ValueError("segcand: contiguous int32 tensors on one "
                             "device")
    cuda = dev.type == "cuda"
    lib = _segcand_libs.get(cuda)
    if lib is None:
        from ..ops import build
        lib = build.load("segcand") if cuda else build.load_host("segcand")
        fn = lib.segcand_launch if cuda else lib.segcand_host
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p] * (4 if cuda else 3)
        lib = _segcand_libs[cuda] = lib
    rows = torch.zeros((R, cfg.C, 7), dtype=_I32, device=dev)
    counts = torch.empty(R, dtype=_I32, device=dev)
    bad = torch.empty(R, dtype=_I32, device=dev)
    args = (k1s.data_ptr(), k2s.data_ptr(),
            None if ivl is None else ivl.data_ptr(), tot.data_ptr(),
            mdsh.data_ptr(), mincover.data_ptr(), R, H, cfg.C, cfg.wordlen,
            cfg.nskip, cfg.Q, rows.data_ptr(), counts.data_ptr(),
            bad.data_ptr())
    if cuda:
        with torch.cuda.device(dev):
            rc = lib.segcand_launch(
                *args, torch.cuda.current_stream(dev).cuda_stream)
        launches["segcand"] += 1
    else:
        rc = lib.segcand_host(*args)
        launches["segcand_host"] += 1
    if rc != 0:
        raise RuntimeError(f"segcand failed (code {rc})")
    return rows, counts, counts > cfg.C, bad != 0


def build_exact_collate(di, ivals_np, matrix_np, go: int, ge: int,
                        cfg: CollateCfg):
    """The collation + pass-1 scoring step on di's device
    (exact_collate.py:434).

    di: parallel.mesh.DeviceIndex (build_ref_only suffices for
    cfg.host_hits; the device-hit step needs the direct-address table)
    ivals_np: [V, 3] int64 {start, end, seqidx} global base intervals
    (the engine's seq-by-seq `_seq_ivals`).

    cfg.host_hits:
      step([ks,] k1 [R,H] i32, k2u8 [R,H] u8, tot [R] i32, codes [B,Q]
           u8 mangled, qlens [B] i32, min_cover [B] i32)
    with ks [R,H] i32 the per-hit sequence ids, given only when
    cfg.NS > 1; else the device-hit step:
      step(codes [B,Q] u8 mangled, qbad [B,Q] bool, selmask [B,2,Q] u8,
           qlens [B] i32, min_cover [B] i32)
    R = 2B lanes (read-major, strand-minor).  Both return
      pool      [P, 6] i32  packed candidate rows, per-read contiguous
                            in (strand, interval, emission) order
      counts2   [B, 2] i32  rows per read per strand (F, R)
      scores    [P] i32     pass-1 window score, -1 = not SIMD-eligible
    then, from the device-hit step only,
      cksum     [B, 2, 2]   the device's hit-info checksum per strand
    and last
      fallback  [B] bool    device-side per-read fallback flags.

    Both steps scan each lane's sorted hits with segcand_scan (one
    kernel launch on CUDA, the host build of its code on the CPU)."""
    if not cfg.host_hits and di.table is None:
        raise ValueError("device-exact hit expansion needs the "
                         "direct-address table (host_hits does not)")
    dev = di.device
    k, nskip = cfg.wordlen, cfg.nskip
    B, Q, H, C, V = cfg.B, cfg.Q, cfg.H, cfg.C, cfg.V
    P = cfg.pool
    R = 2 * B
    if not cfg.host_hits and V != len(ivals_np):
        raise ValueError(f"the device-hit step needs one interval slot a "
                         f"sequence interval: V = {V}, {len(ivals_np)} "
                         f"intervals")
    iv_lo = [int(x) for x in ivals_np[:, 0]]
    iv_hi = [int(x) for x in ivals_np[:, 1]]
    ref_len = int(di.ref_len)
    if cfg.host_hits and not (
            V == 1 and nskip <= k and iv_lo[0] == 0
            and iv_hi[-1] >= ref_len
            and all(iv_lo[v + 1] == iv_hi[v]
                    for v in range(len(iv_lo) - 1))):
        raise ValueError("host_hits needs contiguous full-cover "
                         "intervals (seq-by-seq regime)")
    matrix = device_matrix(matrix_np, dev)
    nseq_s = int(ivals_np[:, 2].max()) + 1
    offs_np = np.zeros(nseq_s + 1, np.int64)
    for lo_, hi_, sq_ in ivals_np:
        offs_np[int(sq_)] = lo_
        offs_np[int(sq_) + 1] = hi_
    offs_seq = torch.from_numpy(offs_np.astype(np.int32)).to(dev)
    ref_alpha = di.ref_alpha
    L = ref_alpha.shape[0]
    SPAD = (cfg.SPAD + 127) // 128 * 128
    G = max(1, min(P, SCORE_GROUP_CELLS // SPAD))   # pass-1 rows a group
    bsteps = int(np.ceil(np.log2(max(B, 2)))) + 1
    mdsh_cap = k * SEG_DIFFSHIFT // nskip
    strand_is_rev = (torch.arange(R, dtype=_I32, device=dev) % 2) == 1
    h_iota = torch.arange(H, dtype=_I32, device=dev)[None, :]
    g_iota = torch.arange(P, dtype=_I32, device=dev)
    c_iota = torch.arange(C, dtype=_I32, device=dev)
    # the pool's slots a read: (strand, interval slot, candidate)
    S2 = 2 * V * C
    s2_iota = torch.arange(S2, dtype=_I32, device=dev)[None, :]
    rev_slot = (s2_iota >= V * C).to(_I32).expand(B, S2)
    sq_arr = torch.tensor([int(x) for x in ivals_np[:, 2]], dtype=_I32,
                          device=dev)
    sq_slot = sq_arr[((s2_iota // C) % V).long()].expand(B, S2)
    q_iota = torch.arange(Q, dtype=_I32, device=dev)[None, :]
    w_iota = torch.arange(SPAD, dtype=_I32, device=dev)[None, :]
    t1 = (torch.arange(Q, dtype=_I32, device=dev) + 1)[None, None, :]

    def pool_geom_score(rows_v, counts_v, fallback, codes, qlens,
                        sq_from_rows: bool):
        """exact_collate.py:497: global pool compaction in per-read
        (strand, interval, emission) order, geometry (mc_calc_seg_offsets)
        + is_simd, and the pass-1 scores of the SIMD-eligible windows.
        rows_v / counts_v: each interval slot's rows [B, 2, C, 7] and
        counts [B, 2].  sq_from_rows: each candidate's interval id is its
        row field 6 (the host-hits step's one combined slot), else its
        slot's."""
        # ---- global pool compaction, (strand, interval, slot) order --
        rows_flat = torch.stack(rows_v, dim=2).reshape(B, S2, 7)
        cnts = torch.stack(counts_v, dim=2)                  # [B, 2, V]
        slot_ok = (c_iota < cnts[..., None]).reshape(B, S2)
        counts2 = cnts.sum(dim=2, dtype=_I32)                # [B, 2]
        read_counts = counts2.sum(dim=1, dtype=_I32)
        cum_read = torch.cumsum(read_counts, dim=0, dtype=_I32)  # inclusive
        npool = cum_read[-1]
        lo = torch.zeros(P, dtype=_I32, device=dev)
        hi = torch.full((P,), B, dtype=_I32, device=dev)
        for _ in range(bsteps):
            mid = (lo + hi) >> 1
            gohi = cum_read[mid.clamp(0, B - 1)] <= g_iota
            lo = torch.where(gohi, mid + 1, lo)
            hi = torch.where(gohi, hi, mid)
        rd = torch.clamp_max(lo, B - 1).long()
        within = g_iota - (cum_read[rd] - read_counts[rd])
        slot_sorted = torch.sort(torch.where(slot_ok, s2_iota, BIG),
                                 dim=1).values
        fs = slot_sorted[rd, within.clamp(0, S2 - 1).long()]
        fs = fs.clamp(0, S2 - 1).long()
        pool_ok = g_iota < npool
        pool7 = torch.where(pool_ok[:, None], rows_flat[rd, fs], 0)
        pool_rev = torch.where(pool_ok, rev_slot[rd, fs], 0)
        if sq_from_rows:
            pool_sq = pool7[:, 6]
        else:
            pool_sq = torch.where(pool_ok, sq_slot[rd, fs], 0)
        pool_read = torch.where(pool_ok, rd, 0)
        pool = torch.cat([pool7[:, :5], (pool7[:, 5] | (pool_sq << 22))
                          [:, None]], dim=1)
        # reads whose rows spill past the pool cap fall back
        # individually (the host skips flagged reads)
        fallback = fallback | (cum_read > P)

        # ---- geometry (mc_calc_seg_offsets) + is_simd + windows ----
        w0 = pool[:, 0]
        c_qs = w0 & 0xFF
        c_qe = (w0 >> 8) & 0xFF
        cover = (w0 >> 16) & 0xFF
        c_rs, c_re = pool[:, 1], pool[:, 2]
        shiftoffs = pool[:, 3]
        srange = pool[:, 5] & 0x3FFFFF
        qlen_p = qlens[pool_read]
        sqc = pool_sq.clamp(0, nseq_s - 1).long()
        ro = offs_seq[sqc]
        rlen = offs_seq[sqc + 1] - ro
        rs_b = c_rs * nskip - ro
        re_b = c_re * nskip + (k - 1) - ro
        geom_ok = ((rs_b >= 0) & (re_b >= rs_b) & (re_b < rlen) &
                   (c_qe >= c_qs) & (c_qs < qlen_p))
        rev = pool_rev == 1
        qs_b = torch.where(rev, qlen_p - c_qe - 1, c_qs)
        qe_b = torch.where(rev, qlen_p - c_qs - 1, c_qe)
        edge = (qlen_p - cover) // EDGE_BAND_FACTOR
        edge = torch.where(
            edge > nskip,
            torch.minimum(edge, qlen_p >> MAX_BANDEDGE_2POW) - (nskip - 1),
            0)
        br = (-shiftoffs + 1) * nskip + edge + 1
        bl = br - (srange + 2) * nskip - 2 * edge - 2
        q_edge_l = qs_b
        q_edge_r = qlen_p - qe_b - 1
        qe2 = qe_b + q_edge_r                 # qs2 = qs - q_edge_l = 0
        r_edge_l = q_edge_l + br
        r_edge_r = q_edge_r - bl
        hit_l = (r_edge_l > 0) & (rs_b < r_edge_l)
        r_edge_l2 = torch.where(hit_l, rs_b, r_edge_l)
        rs2 = torch.where(hit_l, 0, rs_b - r_edge_l)
        re2 = torch.where(re_b + r_edge_r >= rlen, rlen - 1,
                          re_b + r_edge_r)
        geom_ok = geom_ok & (re2 >= rs2)
        band_offs = q_edge_l - r_edge_l2
        bl2 = bl + band_offs
        br2 = br + band_offs
        is_simd = (geom_ok & pool_ok &
                   (qlen_p >= MINLEN_QUERY_STRIPED) &
                   ((br2 - bl2) * BWSCAL_QLEN > qlen_p) &
                   (qe2 >= qlen_p - 1))
        slen = re2 - rs2 + 1
        fit = slen <= SPAD
        bad_geom = pool_ok & (~geom_ok | (is_simd & ~fit))
        fallback = fallback | (torch.zeros(B, dtype=_I32, device=dev)
                               .scatter_reduce(0, pool_read, bad_geom.to(
                                   _I32), "amax") > 0)

        # ---- pass-1 scoring of the SIMD-eligible pool rows ----
        do_sc = is_simd & fit
        slen_sc = torch.where(do_sc, slen, 0)
        reads32 = codes.to(_I32)
        src = qlens[:, None] - 1 - q_iota
        gq = torch.gather(reads32, 1, src.clamp(0, Q - 1).long())
        rcq = torch.where(src >= 0,
                          torch.where((gq & 4) == 0, gq ^ 3, gq) & 7, 7)
        fwdq = torch.where(q_iota < qlens[:, None], reads32 & 7, 7)
        sc = torch.empty(P, dtype=_I32, device=dev)
        # in groups of G rows: a window's [SPAD] subject and [Q] query
        # are made for a group at a time, so the step's memory does not
        # grow as P * SPAD (a repeat tier's pool of 2^21 rows)
        for g0 in range(0, P, G):
            g1 = min(g0 + G, P)
            sl = slen_sc[g0:g1]
            gidx = ((ro + rs2)[g0:g1, None] + w_iota).clamp(0, L - 1)
            wins = torch.where(w_iota >= sl[:, None], 7,
                               ref_alpha[gidx.long()])
            pr = pool_read[g0:g1]
            qcs = torch.where(rev[g0:g1, None], rcq[pr], fwdq[pr])
            sc[g0:g1] = sw_score_batch(qcs, wins, sl, matrix, go, ge,
                                       device=dev, track=False)
        scores = torch.where(do_sc, sc, -1)
        return pool, counts2, scores, fallback

    def lane_inputs(qlens, min_cover):
        """Per-lane (read, strand) query length, cover floor and the
        region-break shift limit."""
        qlenR = qlens.repeat_interleave(2)
        mincovR = min_cover.repeat_interleave(2)
        mdsh = torch.clamp_max((qlenR - k) // nskip + 1, mdsh_cap)
        return mincovR, mdsh

    def step_hh(ks, k1, k2u8, tot, codes, qlens, min_cover):
        mincovR, mdsh = lane_inputs(qlens, min_cover)
        valid = h_iota < tot[:, None]
        k1v = torch.where(valid, k1, BIG)
        k2v = torch.where(valid, k2u8.to(_I32), BIG)
        if ks is None:
            k1s, k2s = lexsort_rows([k1v, k2v])
            ivl = None
        else:
            ivl, k1s, k2s = lexsort_rows([torch.where(valid, ks, BIG), k1v,
                                          k2v])
        rows, counts, overC, badscan = segcand_scan(
            cfg, k1s, k2s, ivl, tot, mdsh, mincovR)
        fallback = (badscan | overC).reshape(B, 2).any(dim=1)
        return pool_geom_score([rows.reshape(B, 2, C, 7)],
                               [counts.reshape(B, 2)], fallback, codes,
                               qlens, sq_from_rows=True)

    if cfg.host_hits:
        if cfg.NS > 1:
            return step_hh

        def step(k1, k2u8, tot, codes, qlens, min_cover):
            return step_hh(None, k1, k2u8, tot, codes, qlens, min_cover)

        return step

    table, pos = di.table, di.pos
    # the single interval spans every indexed position (max tuple serial
    # = (ref_len-k)//nskip < hi//nskip when nskip <= wordlen): its
    # in-range slice is the seed's whole position run
    identity = V == 1 and iv_lo[0] == 0 and iv_hi[0] >= ref_len and \
        nskip <= k

    def step_dev(codes, qbad, selmask, qlens, min_cover):
        """exact_collate.py:637 (_step): the device's own hit info and
        its checksum, then one expansion, sort and scan a interval slot."""
        is_seed, cnt, base = _hitinfo_device(cfg, codes, qbad, qlens, table)
        # the checksum of the device's hit-info view, verified by the host
        # post block: {n_seeds, sum cnt*(t+1) mod 2^31}
        cksum = torch.stack(
            [is_seed.sum(dim=2, dtype=_I32),
             torch.where(is_seed, cnt * t1, 0).sum(dim=2, dtype=_I32)
             & 0x7FFFFFFF], dim=2)                        # [B, 2, 2]
        selR = (is_seed & (selmask > 0)).reshape(R, Q)
        cntR = torch.where(selR, cnt.reshape(R, Q), 0)
        baseR = base.reshape(R, Q)
        mincovR, mdsh = lane_inputs(qlens, min_cover)
        fallback = torch.zeros(B, dtype=torch.bool, device=dev)
        rows_v, counts_v = [], []
        for v in range(V):
            if identity:
                a, b = baseR, baseR + cntR
            else:
                a = _lower_bound(pos, baseR, baseR + cntR, iv_lo[v] // nskip,
                                 31)
                b = _lower_bound(pos, baseR, baseR + cntR, iv_hi[v] // nskip,
                                 31)
            nh = torch.where(selR, b - a, 0)
            k1, k2, _, total = _expand_hits(cfg, pos, a, nh, strand_is_rev)
            k1s, k2s = lexsort_rows([k1, k2])
            rows, counts, overC, badscan = segcand_scan(
                cfg, k1s, k2s, None, total.contiguous(), mdsh, mincovR)
            lane_bad = (total > H) | badscan | overC
            fallback = fallback | lane_bad.reshape(B, 2).any(dim=1)
            rows_v.append(rows.reshape(B, 2, C, 7))
            counts_v.append(counts.reshape(B, 2))
        pool, counts2, scores, fallback = pool_geom_score(
            rows_v, counts_v, fallback, codes, qlens, sq_from_rows=False)
        return pool, counts2, scores, cksum, fallback

    return step_dev
