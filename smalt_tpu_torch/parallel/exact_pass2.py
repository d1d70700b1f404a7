"""Device pass 2 of the exact lane on one torch device: the banded TRACK
fill and its reverse traceback walk, one window per candidate.

Counterpart of smalt_tpu/parallel/exact_pass2.py.  The recurrence is the
reference's alignSmiWatBand (alignment.c:788-1027) in the unskewed
full-query frame, exactly as that module's docstring sets it out:

    cell = max(diag, e, f, 0); e and f decay by gap_ext;
    iff diag strictly beats e, f and 0 and diag > gap_init, both gap
    states rise to >= diag - gap_init ("reseed");
    the running best takes diag at strict wins with diag > gap_init
    (row-major first);
    direction code 3 on strict wins, else (e >= f ? 1 : 2) when cell > 0.

Out-of-band cells keep their H and E from the rows above: the plain
version keeps the whole query frame and reproduces them; the kernel
computes only the band (csrc/swq.cu says why no stale value outside it
is ever read).  The walk then runs from the best cell (mi, mj) up the
subject rows and writes one int16 per row, (nins << 2) | typ with typ 3
DIA, 1 COL, 2 clean stop, 0 SUSPECT, and 0 on every row where it is not
active.

`swq_fill_walk_ref` is the plain torch version; `swq_cuda` launches the
hand-written kernel (csrc/swq.cu); `build_pass2_step` is the step of the
`--device-exact` lane, which picks one by the tensor's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import sw as sw_ops

NEG = -(1 << 28)
MAX_QP = 256       # widest query frame swq.cu takes (8 tiles of 32 columns)

_I32 = torch.int32


def swq_fill_walk_ref(qalpha, subj, par, matrix, go: int, ge: int):
    """Plain torch version of the banded fill + walk (the jnp oracle of
    smalt_tpu/parallel/exact_pass2.py:68).  Tensors on one device.

    qalpha: [W, Qp] query alpha codes (strand-resolved)
    subj:   [W, Sp] subject alpha codes
    par:    [W, 8]  {l_edge, r_edge, q_left, q_len, slen, valid, s_left,
            0}; rows run i in [s_left, slen)
    Returns int32 (best [W] (>= 0), mi [W], mj [W], rec [W, Sp])."""
    dev = qalpha.device
    qalpha, subj, par, matrix = (torch.as_tensor(x, device=dev).to(_I32)
                                 for x in (qalpha, subj, par, matrix))
    W, Qp = qalpha.shape
    Sp = subj.shape[1]
    go, ge = int(go), int(ge)
    le, re_, ql, qn, sn, vd, sl = (par[:, k] for k in range(7))
    start_lo = torch.maximum(ql, le)
    lead = torch.clamp_min(ql - le, 0)
    lane = torch.arange(Qp, dtype=_I32, device=dev)[None, :]
    qlong = qalpha.long()
    zcol = torch.zeros((W, 1), dtype=_I32, device=dev)
    negcol = torch.full((W, 1), NEG, dtype=_I32, device=dev)
    big = torch.full((W, Qp), 1 << 28, dtype=_I32, device=dev)
    H = torch.zeros((W, Qp), dtype=_I32, device=dev)
    E = torch.zeros((W, Qp), dtype=_I32, device=dev)
    best = torch.zeros(W, dtype=_I32, device=dev)
    bi = torch.zeros(W, dtype=_I32, device=dev)
    bj = torch.zeros(W, dtype=_I32, device=dev)
    dirm = torch.empty((Sp, W, Qp), dtype=torch.int8, device=dev)
    for i in range(Sp):
        t_rel = i - sl
        band_lo = start_lo + torch.clamp_min(t_rel - lead, 0)
        band_hi = torch.minimum(qn, re_ + 1 + t_rel)
        in_band = ((lane >= band_lo[:, None]) & (lane < band_hi[:, None])
                   & ((i >= sl) & (i < sn) & (vd != 0))[:, None])
        Wrow = matrix[subj[:, i].long()[:, None], qlong]
        diag = torch.cat([zcol, H[:, :-1]], dim=1) + Wrow
        pre = in_band & (diag > 0) & (diag > E)
        g = torch.where(pre & (diag > go), diag - go, NEG)
        cm = torch.cummax(g + lane * ge, dim=1).values
        # g embeds -gapopen already: F*(j) = max(g' + j'*ge) - (j-1)*ge
        F = torch.cat([negcol, cm[:, :-1]], dim=1) - (lane - 1) * ge
        won = pre & (diag > F)
        cell = torch.maximum(torch.maximum(diag, E), torch.clamp_min(F, 0))
        dirm[i] = torch.where(won, 3, torch.where(
            in_band & (cell > 0), torch.where(E >= F, 1, 2), 0))
        H = torch.where(in_band, cell, H)
        reseed = torch.where(won & (diag > go), diag - go, NEG)
        E = torch.where(in_band, torch.maximum(E - ge, reseed), E)
        elig = won & (diag > go)
        dv = torch.where(elig, diag, NEG)
        rowmax = dv.amax(dim=1)
        upd = rowmax > best
        minlane = torch.where(elig & (dv == rowmax[:, None]), lane,
                              big).amin(dim=1)
        best = torch.where(upd, rowmax, best)
        bi = torch.where(upd, i, bi).to(_I32)
        bj = torch.where(upd, minlane, bj)

    j = bj.clone()
    done = torch.zeros(W, dtype=torch.bool, device=dev)
    rec = torch.zeros((W, Sp), dtype=_I32, device=dev)
    for i in range(Sp - 1, -1, -1):
        code = dirm[i].to(_I32)
        active = ~done & (i <= bi) & (i >= sl)
        band_lo = start_lo + torch.clamp_min(i - sl - lead, 0)
        band_hi = torch.minimum(qn, re_ + 1 + i - sl)
        mask2 = (code == 2) & (lane >= ql[:, None])
        hi = torch.cummax(torch.where(mask2, -1, lane), dim=1).values
        hi_at_j = torch.where(lane == j[:, None], hi, 0).sum(dim=1,
                                                            dtype=_I32)
        hi_at_j = torch.maximum(hi_at_j, ql - 1)
        nins = torch.clamp_min(j - hi_at_j, 0)
        j2 = j - nins
        code2 = torch.where(lane == j2[:, None], code, 0).sum(dim=1,
                                                             dtype=_I32)
        stop = (j2 < ql) | (code2 == 0)
        suspect = stop & (j2 >= ql) & ((j2 >= band_hi) | (j2 < band_lo))
        typ = torch.where(suspect, 0, torch.where(stop, 2, code2))
        rec[:, i] = torch.where(active, (nins << 2) | typ, 0)
        j = torch.where(active & ~stop,
                        torch.where(code2 == 3, j2 - 1, j2), j)
        done = done | (active & stop)
    return torch.clamp_min(best, 0), bi, bj, rec


def band_widths(le, re_, ql, qn, valid, Qp: int) -> np.ndarray:
    """The widest band of each window in columns (0 for a dummy): a band
    is at most r_edge + 1 - l_edge columns wide, and lies in
    [max(q_left, l_edge), min(q_len, Qp)).  Host arrays."""
    le, re_, ql, qn, valid = (np.asarray(x, np.int64)
                              for x in (le, re_, ql, qn, valid))
    width = np.minimum(re_ + 1 - le, np.minimum(qn, Qp) - np.maximum(ql, le))
    return np.where(valid != 0, width, 0)


def band_tiles(le, re_, ql, qn, valid, Qp: int) -> int:
    """The 32-column tiles the widest band of these windows takes, at
    least 1 (band_widths)."""
    width = band_widths(le, re_, ql, qn, valid, Qp)
    widest = int(width.max()) if len(width) else 0
    return min(max(1, -(-widest // 32)), Qp // 32)


def swq_cuda(qalpha, subj, par, matrix, go: int, ge: int, tiles: int):
    """Launch csrc/swq.cu on the current stream.  Same arguments as
    swq_fill_walk_ref, every tensor contiguous int32 on one CUDA device,
    Qp a multiple of 32 up to MAX_QP, Sp even, the matrix a DeviceMatrix
    (ops/sw.py) within the int32 DP's bound (check_score_cap; swq keeps
    its best as a (value, row, column) record, no packed key).  `tiles`
    bounds every band of the launch (band_tiles, from the host's copy of
    the windows).  Returns int32 best, mi, mj [W] and int16 rec [W, Sp]."""
    sw_ops.check_score_cap("swq", matrix, qalpha.shape[1], subj.shape[1],
                           go, ge)
    dev = qalpha.device
    for name, t in (("qalpha", qalpha), ("subj", subj), ("par", par),
                    ("matrix", matrix.t)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"swq: {name} must be on {dev} (cuda), got "
                             f"{t.device}")
        if t.dtype != _I32 or not t.is_contiguous():
            raise ValueError(f"swq: {name} must be contiguous int32")
    W, Qp = qalpha.shape
    Sp = subj.shape[1]
    if subj.shape[0] != W or par.shape != (W, 8):
        raise ValueError(f"swq: shapes qalpha {tuple(qalpha.shape)} subj "
                         f"{tuple(subj.shape)} par {tuple(par.shape)}")
    if Qp % 32 or not 32 <= Qp <= MAX_QP or Sp < 2 or Sp % 2:
        raise ValueError(f"swq: Qp {Qp} must be a multiple of 32 in "
                         f"32..{MAX_QP} and Sp {Sp} even")
    lib = sw_ops._kernel_lib("swq")
    if lib.swq_window_bytes(Qp, Sp, tiles) < 0:
        raise ValueError(f"swq: {Sp} rows of {tiles} band tiles pass the "
                         f"kernel's 200 KB of shared memory a window")
    best = torch.empty(W, dtype=_I32, device=dev)
    mi = torch.empty(W, dtype=_I32, device=dev)
    mj = torch.empty(W, dtype=_I32, device=dev)
    rec = torch.empty((W, Sp), dtype=torch.int16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.swq_launch(qalpha.data_ptr(), subj.data_ptr(),
                            par.data_ptr(), matrix.t.data_ptr(), W, Qp, Sp,
                            int(go), int(ge), int(tiles), best.data_ptr(),
                            mi.data_ptr(), mj.data_ptr(), rec.data_ptr(),
                            stream)
    if rc != 0:
        raise RuntimeError(f"swq launch failed (code {rc})")
    sw_ops.launches["swq"] += 1
    return best, mi, mj, rec


def _pack(best, mi, mj, rec):
    """One int32 [W, 3 + Sp/2]: (best, mi, mj), then the int16 records
    two to an int32 (exact_pass2.py:421)."""
    head = torch.stack([best, mi, mj], dim=1)
    tail = rec.to(torch.int16).contiguous().view(_I32)
    return torch.cat([head, tail], dim=1)


def pass2_inputs(ref_alpha, reads, qlens, wd, Sp: int):
    """The kernel's inputs for the pass-2 windows wd (exact_pass2.py:
    436-468): strand-resolved queries, subject windows gathered from the
    resident reference (code 7 past win_len) and par in the plain
    version's layout, where a window with win_len <= 0 is a dummy
    (slen -1, valid 0).  Returns contiguous int32 (qalpha [W, Qp],
    subj [W, Sp], par [W, 8]) on the tensors' device."""
    dev = reads.device
    reads = reads.to(_I32)
    n, Qp = reads.shape
    j = torch.arange(Qp, dtype=_I32, device=dev)[None, :]
    src = qlens[:, None] - 1 - j
    g = torch.gather(reads, 1, src.clamp(0, Qp - 1).long())
    # codec bytes carry flag bits above the 3-bit alpha code: the
    # complement trick, then & 7 (exact_pass2.py:443-447)
    rcq = torch.where(src >= 0, torch.where((g & 4) == 0, g ^ 3, g) & 7, 7)
    fwd = torch.where(j < qlens[:, None], reads & 7, 7)
    ridx = wd[:, 2].clamp(0, n - 1).long()
    qalpha = torch.where((wd[:, 3] == 1)[:, None], rcq[ridx], fwd[ridx])
    wlen = wd[:, 9]
    offs = torch.arange(Sp, dtype=_I32, device=dev)[None, :]
    gidx = (wd[:, 0:1] + offs).clamp(0, ref_alpha.shape[0] - 1)
    subj = torch.where(offs >= wlen[:, None], 7,
                       ref_alpha[gidx.long()].to(_I32))
    snm = torch.where(wlen > 0, wd[:, 1], -1)
    par = torch.stack([wd[:, 4], wd[:, 5], wd[:, 6], wd[:, 7], snm,
                       (wlen > 0).to(_I32), wd[:, 8], wd[:, 10]], dim=1)
    return qalpha.contiguous(), subj.contiguous(), par.contiguous()


def mark_edge_windows(rng, subj, par):
    """Make some pass-2 windows the edge cases a kernel must keep, in
    place (subj [W, Sp] and par [W, 8] int32 numpy, par in
    swq_fill_walk_ref's layout): one in eight starts at s_left > 0 (the
    rows before it frozen), one in sixteen is a dummy (slen -1, valid 0)
    and one in sixteen has an all-pad subject (best 0)."""
    kind = np.arange(len(par)) % 16
    late = kind % 8 == 2
    par[late, 6] = rng.integers(1, np.maximum(par[late, 4] // 2, 1) + 1)
    par[kind == 5, 4:6] = (-1, 0)
    subj[kind == 3] = 7


def synth_windows(rng, W: int, Qp: int, Sp: int):
    """W pass-2 windows as the exact lane builds them, for holding a
    kernel against swq_fill_walk_ref: each subject holds its query from a
    random offset with 3% substitutions and an indel random walk (one in
    ten is unrelated), and the band follows that diagonal, 8 to 64
    columns wide, starting left of column 0 (lead-pinned rows); q_left >
    0 in one window in four, then mark_edge_windows.  Returns int32 numpy
    (qalpha [W, Qp], subj [W, Sp], par [W, 8])."""
    qlen = rng.integers(Qp // 2, min(Qp, 255) + 1, W)
    q = rng.integers(0, 4, (W, Qp), dtype=np.int32)
    q[rng.random((W, Qp)) < 0.01] = 4
    q[np.arange(Qp)[None, :] >= qlen[:, None]] = 7
    slen = rng.integers(np.minimum(qlen + 8, Sp), Sp + 1)
    off = rng.integers(0, np.maximum(slen - qlen, 0) + 1)
    step = (rng.random((W, Sp)) < 0.02).astype(np.int32) - \
        (rng.random((W, Sp)) < 0.02)
    src = np.arange(Sp, dtype=np.int32)[None, :] - off[:, None] + \
        np.cumsum(step, axis=1, dtype=np.int32)
    inq = (src >= 0) & (src < qlen[:, None])
    s = np.take_along_axis(q, np.clip(src, 0, Qp - 1), 1) & 3
    noise = ~inq | (rng.random((W, Sp)) < 0.03) | \
        (rng.random(W) < 0.1)[:, None]
    s = np.where(noise, rng.integers(0, 4, (W, Sp), dtype=np.int32), s)
    s[np.arange(Sp)[None, :] >= slen[:, None]] = 7
    bw = rng.integers(8, 65, W)
    le = -off - bw // 2 + rng.integers(-4, 5, W)
    ql = np.where(np.arange(W) % 4 == 1, rng.integers(1, qlen // 4 + 2), 0)
    par = np.stack([le, le + bw, ql, qlen, slen, np.ones(W, np.int64),
                    np.zeros(W, np.int64), np.zeros(W, np.int64)],
                   axis=1).astype(np.int32)
    s = s.astype(np.int32)
    mark_edge_windows(rng, s, par)
    return q, s, par


_steps: dict = {}


def build_pass2_step(matrix, go: int, ge: int, device):
    """step(ref_alpha, reads, qlens, wd, Sp, tiles) -> int32
    [W, 3 + Sp/2], the pass-2 step of exact_pass2.py:404 on `device`:
    pass2_inputs, then swq_cuda on CUDA or swq_fill_walk_ref on the CPU,
    then the packing.  The int32 DP's bound on every device
    (check_score_cap); `tiles` as swq_cuda takes it (the CPU needs none).

    ref_alpha: [L] resident reference alpha codes; reads: [B, Qp] uint8
    mangled codes; qlens: [B] int32; wd: [W, 12] int32 {gstart, slen,
    read_idx, is_rev, l_edge, r_edge, q_left, q_len, s_left, win_len, 0,
    0} (win_len <= 0 marks a dummy window).  Cached per (matrix,
    penalties, device)."""
    device = torch.device(device)
    mat_np = np.ascontiguousarray(matrix, dtype=np.int32)
    key = (mat_np.tobytes(), mat_np.shape, int(go), int(ge), str(device))
    step = _steps.get(key)
    if step is not None:
        return step
    mat = sw_ops.device_matrix(mat_np, device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"build_pass2_step: no kernel for device {device}")

    def step(ref_alpha, reads, qlens, wd, Sp: int, tiles: int):
        sw_ops.check_score_cap("swq", mat, reads.shape[1], Sp, go, ge)
        args = pass2_inputs(ref_alpha, reads, qlens, wd, Sp)
        if device.type == "cpu":
            return _pack(*swq_fill_walk_ref(*args, mat.t, go, ge))
        return _pack(*swq_cuda(*args, mat, go, ge, tiles))

    _steps[key] = step
    return step


def unpack_pass2(flat, nw: int, Sp: int):
    """Host-side split of the step's output (exact_pass2.py:475,
    re-declared because that module's package imports jax; a test holds
    the two equal): int64 best, mi, mj [nw] and int16 rec [nw, Sp]."""
    flat = np.ascontiguousarray(flat[:nw])
    best = flat[:, 0].astype(np.int64)
    mi = flat[:, 1].astype(np.int64)
    mj = flat[:, 2].astype(np.int64)
    rec = np.ascontiguousarray(flat[:, 3:]).view(np.int16)
    return best, mi, mj, np.ascontiguousarray(rec.reshape(nw, Sp))
