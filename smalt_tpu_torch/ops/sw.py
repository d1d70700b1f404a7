"""Batched Smith-Waterman scores: the Hopper kernel and its plain version.

Counterpart of smalt_tpu/ops/sw.py (the full-matrix Pallas kernel,
`sw_score_batch`, and the `sw_score_ref` oracle).  Full-matrix
affine-gap local alignment in int32, with the score taken over the
diagonal values T = H[i-1,j-1] + W[i,j] and F from the prefix-max
identity (exact whenever gapopen >= gapext):

    F[j] = cummax(H0[j'] + j'*ge)[j-1] - gapopen - (j-1)*ge

`sw_score_batch` is the public function.  On a CPU tensor it runs the
plain torch version `sw_score_ref`; on a CUDA tensor it launches the
hand-written kernel `csrc/sw_full.cu` (built at first use) and raises if
that fails.  Both return what the Pallas wrapper returns: max(best, 0)
and, with `track`, the row-major-first argmax cell (ti, tj).
"""
from __future__ import annotations

import ctypes

import torch

NEG = -(1 << 28)
MAX_Q = 512        # widest query the kernel keeps in registers (16 a lane)

# launches of the CUDA kernel by instance; the wrapper adds one per
# launch and nowhere else (callers reset and read these)
launches = {"sw_full_track": 0, "sw_full": 0}

_lib = None


def _as_i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int32).contiguous()


def sw_score_ref(qcodes, subj, slens, matrix, gapopen_pos: int,
                 gapext_pos: int, track: bool = False):
    """Plain torch version of the kernel: an int32 scan over subject
    rows with F by prefix max.  Tensors on any device, all on one.

    qcodes [B, Q] codes 0..7, subj [B, S], slens [B], matrix [8, 8].
    Returns best [B] (>= 0) or, with track, (best, ti, tj)."""
    device = qcodes.device
    B, Q = qcodes.shape
    S = subj.shape[1]
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


def _kernel_lib():
    global _lib
    if _lib is None:
        from .build import load
        lib = load("sw_full")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.sw_full_launch.restype = ci
        lib.sw_full_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                       ci, vp, vp, vp, vp]
        _lib = lib
    return _lib


def sw_full_cuda(qcodes, subj, slens, matrix, gapopen_pos: int,
                 gapext_pos: int, track: bool = False):
    """Launch csrc/sw_full.cu on the current stream.  Same arguments
    and results as sw_score_ref; every tensor contiguous int32 on one
    CUDA device."""
    dev = qcodes.device
    for name, t in (("qcodes", qcodes), ("subj", subj), ("slens", slens),
                    ("matrix", matrix)):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"sw_full: {name} must be on {dev} (cuda), "
                             f"got {t.device}")
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"sw_full: {name} must be contiguous int32")
    B, Q = qcodes.shape
    if subj.dim() != 2 or subj.shape[0] != B or slens.shape != (B,) or \
            matrix.shape != (8, 8):
        raise ValueError(f"sw_full: shapes q {tuple(qcodes.shape)} subj "
                         f"{tuple(subj.shape)} slens {tuple(slens.shape)} "
                         f"matrix {tuple(matrix.shape)}")
    if not 1 <= Q <= MAX_Q:
        raise ValueError(f"sw_full: query length {Q} outside 1..{MAX_Q}")
    S = subj.shape[1]
    lib = _kernel_lib()
    best = torch.empty(B, dtype=torch.int32, device=dev)
    ti = torch.empty(B, dtype=torch.int32, device=dev) if track else None
    tj = torch.empty(B, dtype=torch.int32, device=dev) if track else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.sw_full_launch(
            qcodes.data_ptr(), subj.data_ptr(), slens.data_ptr(),
            matrix.data_ptr(), B, Q, S, int(gapopen_pos), int(gapext_pos),
            1 if track else 0, best.data_ptr(),
            ti.data_ptr() if track else None,
            tj.data_ptr() if track else None, stream)
    if rc != 0:
        raise RuntimeError(f"sw_full launch failed (code {rc})")
    launches["sw_full_track" if track else "sw_full"] += 1
    return (best, ti, tj) if track else best


def sw_score_batch(qcodes, subj, slens, matrix, gapopen_pos: int,
                   gapext_pos: int, device, track: bool = False):
    """Batched full-matrix SW scores on `device`.

    qcodes: [B, Q] query codes 0..7 (Q <= 512 on CUDA)
    subj:   [B, S] subject codes; rows at or past slens are ignored
    slens:  [B]    valid subject lengths
    matrix: [8, 8] score matrix (code 7 must score 0: it pads)

    Returns best [B] int32, or (best, ti, tj) with track=True: the
    row-major-first argmax cell of each window's DP (subject row ti,
    query lane tj), the anchor of the host traceback."""
    assert gapopen_pos >= gapext_pos, "prefix-scan F requires go >= ge"
    device = torch.device(device)
    args = [_as_i32(x, device) for x in (qcodes, subj, slens, matrix)]
    if device.type == "cpu":
        return sw_score_ref(*args, gapopen_pos, gapext_pos, track=track)
    if device.type == "cuda":
        return sw_full_cuda(*args, gapopen_pos, gapext_pos, track=track)
    raise ValueError(f"sw_score_batch: no kernel for device {device}")
