"""Time ops/csrc/sw_full.cu, sw_band.cu or swq.cu on one GPU, beside
earlier versions of the source.

    python3 -m smalt_tpu_torch.ops.time_sw [--kernel sw_full|sw_band|swq]
        [--baseline old.cu]... [--rounds 5] [--reps 20] [--wide]
        [--shapes REGEX] [--strip-warps 2,4,8] [--out build/time_sw.json]

Builds the kernel as shipped and, for each --baseline, another version of
the source (same C interface, or for swq the earlier full-frame one,
which takes a (W, Sp, 32) int16 scratch; labelled by its file name) side
by side.  Each must equal the kernel's plain version (sw_score_ref,
sw_band_score_ref, swq_fill_walk_ref) exactly on a head of every input
(all of it for swq), and every baseline must equal the shipped kernel on
all of it, before anything is timed.  sw_band's bands past 512 lanes
(BAND_WIDE) are timed through each entry point a version has and the
shape names (sw_band_launch's one-block kernels, "many"; the cluster
kernel; the strip kernel, "strips", or in an earlier source the tiled
kernel, "tiled"), each labelled "<version> <route>", with one launch a
timing, a warm-up launch in the first round only, and at most 3 rounds;
there the plain version holds every route on the windows' first rows and
the routes hold each other on all.
--strip-warps runs the strip kernel at each of those warps a CTA
("strips<NW>", 1 to 4) in place of the routed count (ops/sw.py
BAND_STRIP_WARPS).
For sw_band the shipped sw_full.cu is built too, and the row loops
(innermost loops of 16 or more 3-input add-max instructions) of the
strip kernel's instances are printed, opcode by opcode, beside those of
sw_full's strip wavefront.
The versions are then timed in turns (CUDA events over --reps launches,
--rounds rounds, each round in the opposite order of the last), at the
shapes the mapping paths use, on random windows and on tie-heavy ones
(swq: chip_smoke.py phase 3c's windows; the lane's own pass-2 windows
are timed by chip_smoke.py phase 7).  --wide scores with a matrix outside
int8 (WIDE_PEN: sw_full's WIDE instances, sw_band's several-warps
kernel) in place of the default one.  sw_full's strip shapes run as
routed (ops/sw.py strip_warps: the one-warp kernel for a large int8
batch, else the wavefront; a baseline from before the wavefront ignores
the warps argument), their bound over the cells inside
the query with the share over every column beside it; at STRIP_ROUTES,
batches around ops/sw.py STRIP_ONE_WARP_B, both kernels run, labelled
"<version> wave" and "<version> warp" (int8 alone: the one-warp kernel
has no WIDE instance).  --shapes times only the shapes
whose label (as printed, e.g. "Q=2048 S=2304 B=1536") the pattern finds.
Prints, for each baseline, how many of the kernels it shares with the
shipped source compile to the same SASS (cuobjdump), then one line a
version and shape with the median and the minimum over the rounds, the
share of the roofline bound (ops/bounds.py) and the card's name and
power limit; writes the same as JSON.  Fails without a GPU, and on the
first difference.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..align import core as ali
from . import bounds, build, sw

# sw_full, (Q, S, B): single-end and paired `map --fast`; the pass-1
# pools of `map --device-exact` for 100 bp and 150 bp reads; the widest
# query in registers; then the strip path (Q > 512): `map --device-pass1`
# on reads of 513-1,024 bp, up to 2 kb and up to 4 kb, and past 16 kb (Q
# 32,768 on a batch of 64, the lane's batch there).  Every shape runs
# tracked and score-only; a baseline source without the strip path skips
# the strip shapes.
FULL_SHAPES = [(112, 128, 12288), (160, 256, 24576), (128, 128, 24576),
               (256, 384, 24576), (512, 640, 1024), (1024, 1152, 4096),
               (2048, 2304, 4096), (4096, 4352, 1024), (32768, 2048, 64)]
# the strip path on reads shorter than their bucket, (Q, S, B, qend): every
# column from qend on is pad code 7 (20 kb reads in Q 32,768, 1,500 bp
# reads in Q 2,048), which the strip path does not run
FULL_QEND = [(32768, 2048, 64, 20000), (2048, 2304, 4096, 1500)]
# the strip path's two kernels side by side, (Q, S, B), on batches around
# the one where strip_warps turns from the wavefront ("wave", on the warps
# it gives a small batch) to the one-warp kernel ("warp", int8 only)
STRIP_ROUTES = [(Q, S, B) for Q, S in ((1024, 1152), (2048, 2304),
                                       (4096, 4352))
                for B in (1024, 1536, 2112, 3072)]
# sw_band, (Q, B); S, pad and W follow from Q (sw.band_geometry):
# 1,500 bp reads (the long-read path of `map --fast`) and 640 bp reads
# (W = 384, 256); 2,560 bp (W = 512, the widest band of the one-warp kernel)
BAND_SHAPES = [(1504, 12288), (640, 12288), (2560, 4096)]
# sw_band past 512 lanes, (Q, B, subject rows kept or 0 for all, routes):
# the several-warps kernel at the default batch's 12,288 windows for reads
# of 4, 10 and 16 kb (W = 768, 1,920, 3,072); 20 kb reads (W = 3,840)
# there too, beside the cluster kernel; W = 3,840, 6,144, 8,192, 12,288,
# 12,416, 12,800 (the one-block kernels' widest), 14,336 and 16,384 (87
# kb reads) on 132 windows of 4,096 rows, where the one-block kernels and
# the cluster kernel meet, and from W 12,416 on the strip kernel; the 6
# windows of 2 reads of 100 kb (W = 18,816: the cluster and the strip
# kernel, and an earlier source's tiled kernel), and W = 32,768 and 65,536
# (Q 174,096 and 348,864) on 132 windows of 4,096 rows; the 3 windows of
# a read of 700 kb (W = 131,328, the strip kernel's own route) on their
# first 65,536 rows, with the tiled kernel, and in full; and of a read of
# 1 Mb (W = 187,520) in full
BAND_WIDE = [(Q, 12288, 0, ("many",)) for Q in (4096, 10000, 16384)] + \
    [(20000, 12288, 0, ("many", "cluster"))] + \
    [(Q, 132, 4096, ("many", "cluster"))
     for Q in (20000, 32768, 43520, 65280)] + \
    [(Q, 132, 4096, ("many", "cluster", "strips"))
     for Q in (65552, 67600, 75792, 87040)] + \
    [(100_000, 6, 0, ("cluster", "strips", "tiled"))] + \
    [(Q, 132, 4096, ("cluster", "strips")) for Q in (174_096, 348_864)] + \
    [(700_000, 3, 65536, ("strips", "tiled")), (700_000, 3, 0, ("strips",)),
     (1_000_000, 3, 0, ("strips",))]
WIDE_HEAD_ROWS = 2048      # subject rows the plain version holds there
ENTRY = {"many": "sw_band_launch", "cluster": "sw_band_cluster_launch",
         "strips": "sw_band_strips_launch", "tiled": "sw_band_tiled_launch"}
# the C signature of an earlier sw_band.cu's tiled kernel (one block a window):
# sw_band's arguments less `wide`, then its row-state scratch [B, W, 2]
TILED_SIG = "ppppiiiiiiiippppp"
# swq, (Qp, Sp, W): chip_smoke.py phase 3c's synth_windows (bands 8-64
# columns wide) at the 100 bp lane's shape and at Qp256; then bands of
# 70-250 columns (3-8 tiles a row)
SWQ_SHAPES = [(128, 256, 8192), (256, 512, 8192)]
SWQ_WIDE = (256, 320, 2048)
HEAD = {"sw_full": 512, "sw_band": 128, "swq": None}  # held against plain
WIDE_PEN = (200, -200)     # --wide: match, mismatch (X -400), as chip_smoke.py
OUTS = {"sw_full": ("best", "ti", "tj"), "sw_band": ("best", "ti", "tj"),
        "swq": ("best", "mi", "mj", "rec")}


def random_windows(rng, B: int, Q: int, S: int):
    """Windows with planted similarity: each subject holds three quarters
    of its query at a random offset with 4% substitutions; N (5) and pad
    (7) codes; half of the subject lengths below S."""
    q = rng.integers(0, 4, (B, Q)).astype(np.int32)
    q[rng.random((B, Q)) < 0.02] = 5
    qlen = rng.integers(Q * 3 // 4, Q + 1, B)
    q[np.arange(Q)[None, :] >= qlen[:, None]] = 7
    s = rng.integers(0, 4, (B, S)).astype(np.int32)
    n = np.minimum(qlen, S) * 3 // 4
    off = rng.integers(0, S - n + 1)
    col = np.arange(S)[None, :] - off[:, None]
    planted = (col >= 0) & (col < n[:, None])
    s = np.where(planted, np.take_along_axis(q, col.clip(0, Q - 1), 1), s)
    mut = rng.random((B, S)) < 0.04
    s[mut] = rng.integers(0, 4, int(mut.sum()))
    slens = np.where(rng.random(B) < 0.5, S,
                     rng.integers(S // 2, S + 1, B)).astype(np.int32)
    s[np.arange(S)[None, :] >= slens[:, None]] = 7
    return q, s.astype(np.int32), slens


def load(kernel: str, src: str = ""):
    """The shipped csrc/<kernel>.cu, or the source `src`, built and bound.
    A swq source without swq_window_bytes is the earlier full-frame
    kernel: its launch takes the codes scratch and no band tiles."""
    lib = build.load(kernel, src)
    fn = getattr(lib, kernel + "_launch")
    fn.restype = ctypes.c_int
    sig = sw._SIGS[kernel]
    if kernel == "swq" and not hasattr(lib, "swq_window_bytes"):
        sig = "ppppiiiiipppppp"
    fn.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int
                   for c in sig]
    for entry in ("sw_full_strip", "sw_band_strips", "sw_band_cluster"):
        if hasattr(lib, entry + "_launch"):
            sw.bind(lib, entry)
    if hasattr(lib, "sw_band_tiled_launch"):
        fn = lib.sw_band_tiled_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p if c == "p" else ctypes.c_int
                       for c in TILED_SIG]
    return lib


def takes(kernel: str, lib, Q: int) -> bool:
    """Whether `lib` runs this query length (an sw_full source from before
    the strip path stops at sw.MAX_Q)."""
    return kernel != "sw_full" or Q <= sw.MAX_Q or \
        hasattr(lib, "sw_full_strip_launch")


def takes_band(lib, W: int) -> bool:
    """Whether `lib`'s sw_band_launch takes a band of W lanes: on 0
    windows it returns 0, or -1 past its widest band."""
    return lib.sw_band_launch(None, None, None, None, 0, 1, 0, W, 0, 0, 0,
                              0, None, None, None, None, 0) == 0


def swq_launcher(lib, qa, sj, par, mat, go: int, ge: int, tiles: int):
    """fn() launches `lib`'s swq on these windows into outputs made once
    and returns (best, mi, mj, rec)."""
    W, Qp = qa.shape
    Sp = sj.shape[1]
    out = [torch.empty(W, dtype=torch.int32, device=qa.device)
           for _ in range(3)]
    out.append(torch.empty((W, Sp), dtype=torch.int16, device=qa.device))
    ptrs = [o.data_ptr() for o in out]
    stream = torch.cuda.current_stream().cuda_stream
    if hasattr(lib, "swq_window_bytes"):
        head, tail = (W, Qp, Sp, go, ge, tiles), ()
    else:
        codes = torch.empty((W, Sp, 32), dtype=torch.int16, device=qa.device)
        head, tail = (W, Qp, Sp, go, ge), (codes.data_ptr(),)

    def fn():
        rc = lib.swq_launch(qa.data_ptr(), sj.data_ptr(), par.data_ptr(),
                            mat.t.data_ptr(), *head, *ptrs, *tail, stream)
        if rc != 0:
            raise RuntimeError(f"swq launch failed (code {rc})")
        return out
    return fn


def launcher(kernel: str, lib, q, s, sl, mat, go: int, ge: int, track: bool,
             band=(), route: str = ""):
    """fn() launches `lib`'s kernel on these tensors into outputs made
    once, and returns them: (best, ti, tj), or (best,) without track.
    band = (W, prepad) for sw_band; route "cluster", "strips" (or
    "strips<NW>", at NW warps a CTA) or "tiled" takes that entry point of
    sw_band.cu (its shape, or its scratch, made here), any other
    sw_band_launch; sw_full's strip path runs as routed, or on route
    "wave" the wavefront, on "warp" the one-warp kernel."""
    if kernel == "swq":
        return swq_launcher(lib, q, s, sl, mat, go, ge, *band)
    B, Q = q.shape
    out = [torch.empty(B, dtype=torch.int32, device=q.device)
           for _ in range(3 if track else 1)]
    ptrs = [o.data_ptr() for o in out] + [None] * (3 - len(out))
    stream = torch.cuda.current_stream().cuda_stream
    launch = getattr(lib, kernel + "_launch")
    # sw_band's `wide` names its several-warps profile (an earlier source
    # takes any value but 0 as a matrix outside int8)
    wide = sw.band_wide_code(mat) if kernel == "sw_band" else int(mat.wide)
    scratch, nw = [], []
    if kernel == "sw_full" and Q > sw.MAX_Q:     # the strip path
        launch = lib.sw_full_strip_launch
        scratch.append(torch.empty((B, s.shape[1], 2), dtype=torch.int32,
                                   device=q.device))
        # the warps a window (a source from before the wavefront takes none)
        nw = [1 if route == "warp" else
              sw.strip_warps(1 if route == "wave" else B, Q, s.shape[1],
                             wide > 0)]
    tail = [wide]
    if route == "tiled":
        launch = lib.sw_band_tiled_launch
        scratch.append(torch.empty((B, band[0], 2), dtype=torch.int32,
                                   device=q.device))
        tail = []
    elif route.startswith("strips"):
        launch = lib.sw_band_strips_launch
        S = s.shape[1]
        scratch += [torch.empty((B, S, 2), dtype=torch.int32,
                                device=q.device),
                    torch.empty(sw.band_strip_flag_words(B, S),
                                dtype=torch.int32, device=q.device)]
        nw = [int(route[6:] or sw.BAND_STRIP_WARPS), int(mat.wide)]
        tail = []
    elif route == "cluster":
        launch = lib.sw_band_cluster_launch
        tail = list(sw.cluster_shape(band[0]))
    carry = [x.data_ptr() for x in scratch]

    def fn(scratch=scratch):                     # holds the carry buffer
        rc = launch(q.data_ptr(), s.data_ptr(), sl.data_ptr(),
                    mat.t.data_ptr(), B, Q, s.shape[1], *band, go, ge,
                    int(track), *ptrs, stream, *tail, *carry, *nw)
        if rc != 0:
            raise RuntimeError(f"{kernel} launch failed (code {rc})")
        return out
    return fn


ADDR = re.compile(r"/\*([0-9a-f]{4,})\*/")


def _sass(path: str) -> dict:
    """{kernel's mangled name: its cuobjdump -sass text} of a built
    library (cuobjdump, from the CUDA toolkit beside nvcc).  The anonymous
    namespace's part of a name, which carries the source file's name and a
    hash, is dropped."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", path], capture_output=True,
                         text=True, check=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", out)
    anon = re.compile(r"^_ZN\d+_GLOBAL__N__\w+?_[0-9a-f]{8}(?=\d)")
    return {anon.sub("_ZN", name): body
            for name, body in zip(parts[1::2], parts[2::2])}


def sass_by_kernel(path: str) -> dict:
    """{kernel's mangled name: its SASS instructions, addresses and
    encodings dropped} of a built library."""
    return {name: [ADDR.sub("", ln).split(";")[0].strip()
                   for ln in body.splitlines() if ADDR.search(ln)]
            for name, body in _sass(path).items()}


def row_loops(body: str, least: int = 16) -> list:
    """The innermost loops of a kernel's SASS that hold at least `least`
    VIADDMNMX (3-input add-max) instructions, the row loops of the SW
    kernels: for each, {opcode: count} over the instructions from a
    backward branch's target to the branch, largest loop first."""
    ins = []                              # (address, opcode, text)
    for ln in body.splitlines():
        m = ADDR.search(ln)
        if not m:
            continue
        text = ln[m.end():].split(";")[0].strip()
        toks = [x for x in text.split() if not x.startswith("@")]
        if toks:
            ins.append((int(m.group(1), 16), toks[0].split(".")[0], text))
    at = {a: n for n, (a, _, _) in enumerate(ins)}
    loops = []
    for n, (a, op, text) in enumerate(ins):
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
        if op == "BRA" and m and int(m.group(1), 16) in at and \
                int(m.group(1), 16) < a:
            lo = at[int(m.group(1), 16)]
            ops = [o for _, o, _ in ins[lo:n + 1]]
            if ops.count("VIADDMNMX") >= least:
                loops.append((lo, n, ops))
    inner = [x for x in loops if not any(
        y is not x and x[0] <= y[0] and y[1] <= x[1] for y in loops)]
    out = []
    for _, _, ops in sorted(inner, key=lambda x: -len(x[2])):
        hist = {}
        for o in ops:
            hist[o] = hist.get(o, 0) + 1
        out.append(hist)
    return out


def loop_line(hist: dict) -> str:
    """A row loop's instruction count and its commonest opcodes."""
    top = sorted(hist.items(), key=lambda kv: -kv[1])[:9]
    return f"{sum(hist.values())} instructions (" + \
        ", ".join(f"{k} {v}" for k, v in top) + ")"


def compare_row_loops(band_path: str, full_path: str):
    """Print the row loops of sw_band's strip kernel instances beside
    those of the sw_full.cu strip wavefront instance with the same
    record: the keyed sw_wave_kernel for the int8 and score-only ones,
    sw_wave_rec_kernel (the two-part record) for the tracked WIDE ones."""
    band = {short_name(k): v for k, v in _sass(band_path).items()}
    full = {short_name(k): v for k, v in _sass(full_path).items()}
    for name in sorted(band):
        if not name.startswith("sw_band_strips_kernel"):
            continue
        track, wide, maxw = name.split()[1].split(",")
        twin = ("sw_wave_rec_kernel" if track == "1" and wide == "1"
                else "sw_wave_kernel") + f" {track},{wide},{maxw}"
        for label, loops in ((name, row_loops(band[name])),
                             (twin, row_loops(full.get(twin, "")))):
            for k, hist in enumerate(loops):
                print(f"# row loop [{label}] {k}: {loop_line(hist)}",
                      flush=True)


def short_name(mangled: str) -> str:
    """A kernel's mangled name as <name> <template arguments>, e.g.
    'sw_full_kernel 16,32,1,1' (the arguments' values in order)."""
    m = re.search(r"\d+(\w+?_kernel)I(\w+?)EEv", mangled)
    if not m:
        return mangled
    return m.group(1) + " " + ",".join(re.findall(r"L[ib](\d+)E", m.group(2)))


def event_ms(fn, reps: int) -> float:
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def must_equal(got, want, label: str, what: str, where: str, sl,
               names=OUTS["sw_full"]):
    for name, g, w in zip(names, got, want):
        ne = g.to(torch.int32) != w.to(torch.int32)
        bad = (ne.any(dim=1) if ne.dim() == 2 else ne).nonzero().flatten()
        if len(bad):
            i = int(bad[0])
            sys.exit(f"time_sw: FAIL: {label} differs from {what} at "
                     f"{where}: {name} of {len(bad)} windows, first {i}: "
                     f"{g[i].tolist()} vs {w[i].tolist()} "
                     f"({sl[i].tolist()})")


class Case(NamedTuple):
    """One input of a kernel: its label, the windows on the card, what the
    launch adds for a band (W, prepad), the plain version on a head of n
    windows, the roofline work, and whether it is timed or only checked;
    for sw_band past 512 lanes the routes timed and the subject rows
    (head_rows, 0 for all) on which the plain version holds them."""
    shape: str
    kind: str
    tensors: tuple
    band: tuple
    plain: Callable
    work: Callable
    timed: bool
    routes: tuple = ("",)
    head_rows: int = 0


def cases(kernel: str, rng, dev, mat, go: int, ge: int):
    """Every Case of `kernel`, random and tie-heavy windows a shape (made
    once a shape, so the tracked and the score-only run see the same)."""
    def cuda(*xs):
        return tuple(torch.from_numpy(x).to(dev) for x in xs)

    if kernel == "swq":
        from ..parallel import exact_pass2 as p2
        for Qp, Sp, W in SWQ_SHAPES + [SWQ_WIDE]:
            qa, sj, par = p2.synth_windows(rng, W, Qp, Sp)
            kind = "synth"
            if (Qp, Sp, W) == SWQ_WIDE:
                par[:, 1] = par[:, 0] + rng.integers(70, 251, W)
                kind = "wide"
            t = cuda(qa, sj, par)
            tiles = p2.band_tiles(*(par[:, k] for k in (0, 1, 2, 3, 5)), Qp)
            yield Case(
                f"Qp={Qp} Sp={Sp} W={W} tiles={tiles}", kind, t, (tiles,),
                lambda n, t=t: p2.swq_fill_walk_ref(*t, mat.t, go, ge),
                lambda track, a=(Qp, Sp, t[2]): bounds.swq_work(*a), True)
        return
    if kernel == "sw_full":
        for Q, S, B, qend, routes in \
                [x + (0, ("",)) for x in FULL_SHAPES] + \
                [x + (("",),) for x in FULL_QEND] + \
                [x + (0, ("wave", "warp")) for x in STRIP_ROUTES]:
            for kind, gen in (("random", random_windows),
                              ("ties", sw.tie_windows)):
                q, s, sl = gen(rng, B, Q, S)
                if qend:
                    q[:, qend:] = 7
                t = cuda(q, s, sl)
                # the strip path's bound counts the cells inside the query
                yield Case(
                    f"Q={Q} S={S} B={B}" + (f" qend={qend}" if qend else ""),
                    kind, t, (),
                    lambda n, t=t: sw.sw_score_ref(
                        *(x[:n] for x in t), mat.t, go, ge, track=True),
                    lambda track, a=(Q, S, t[2], t[0] if Q > sw.MAX_Q
                                     else None): bounds.sw_full_work(
                        *a[:3], track, a[3]),
                    kind == "random" or Q <= 160, routes)
        return
    for Q, B in BAND_SHAPES:
        for kind, gen in (("random", sw.band_windows),
                          ("ties", sw.band_tie_windows)):
            q, s, sl, pad, W, S = gen(rng, B, Q)
            t = cuda(q, s, sl)
            yield Case(
                f"Q={Q} W={W} S={S} B={B}", kind, t, (W, pad + W // 2),
                lambda n, t=t, g=(pad, W): sw.sw_band_score_ref(
                    *(x[:n] for x in t), mat.t, go, ge, *g, track=True),
                lambda track, a=(Q, S, W, pad, t[2]): bounds.sw_band_work(
                    *a, track),
                kind == "random" or Q <= 1504)
    for Q, B, rows, routes in BAND_WIDE:
        # planted windows, their first WIDE_HEAD_ROWS rows held by the
        # plain version (a row a step: a minute for all of 100 kb)
        q, s, sl, pad, W, S = sw.band_windows(rng, B, Q)
        if rows:
            S = rows
            s = np.ascontiguousarray(s[:, :S])
            sl = np.minimum(sl, S).astype(np.int32)
        t = cuda(q, s, sl)
        h = min(S, WIDE_HEAD_ROWS)
        yield Case(
            f"Q={Q} W={W} S={S} B={B}", "random", t, (W, pad + W // 2),
            lambda n, t=t, g=(pad, W), h=h: sw.sw_band_score_ref(
                t[0][:n], t[1][:n, :h].contiguous(),
                torch.clamp_max(t[2][:n], h), mat.t, go, ge, *g,
                track=True),
            lambda track, a=(Q, S, W, pad, t[2]): bounds.sw_band_work(
                *a, track),
            True, routes, h)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="time_sw")
    ap.add_argument("--kernel", choices=("sw_full", "sw_band", "swq"),
                    default="sw_full")
    ap.add_argument("--baseline", action="append", default=[],
                    help="another version of the kernel's source to time "
                         "beside the shipped one (may be repeated)")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--wide", action="store_true",
                    help="score with a matrix outside int8 (match 200, "
                         "mismatch -200)")
    ap.add_argument("--shapes", default="",
                    help="time only the shapes whose label this regular "
                         "expression finds")
    ap.add_argument("--strip-warps", default="",
                    help="sw_band: run the strip kernel at each of these "
                         "warps a CTA (comma-separated) in place of the "
                         "routed count")
    ap.add_argument("--out", default="build/time_sw.json")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_sw: no CUDA device visible", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    srcs = {"shipped": ""}
    for path in a.baseline:
        srcs[os.path.splitext(os.path.basename(path))[0]] = path
    with ThreadPoolExecutor(len(srcs) + 1) as pool:     # one nvcc each
        twin = pool.submit(build.load, "sw_full") \
            if a.kernel == "sw_band" else None
        libs = dict(zip(srcs, pool.map(lambda p: load(a.kernel, p),
                                       srcs.values())))
        if twin:
            twin.result()
    for ident, info in build.build_info.items():
        worst = max((int(x) for x in re.findall(r"Used (\d+) registers",
                                                info["log"])), default=0)
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill",
                                                info["log"]))
        stack = max((int(x) for x in re.findall(r"(\d+) bytes stack frame",
                                                info["log"])), default=0)
        print(f"# build [{ident}]: {info['seconds']:.1f} s, most registers "
              f"{worst}, spill bytes {spills}, largest stack frame {stack}",
              flush=True)

    shipped = sass_by_kernel(build.build_info[a.kernel]["path"])
    for label, path in srcs.items():
        if path:
            base = sass_by_kernel(build.build_info[f"{a.kernel} {path}"]
                                  ["path"])
            both = sorted(set(shipped) & set(base))
            same = sum(shipped[k] == base[k] for k in both)
            print(f"# SASS [{label}]: {len(base)} kernels, {len(shipped)} "
                  f"shipped; of the {len(both)} both have, {same} identical "
                  f"instruction for instruction; only shipped: "
                  f"{len(set(shipped) - set(base))}", flush=True)
            for k in both:
                if shipped[k] != base[k]:
                    print(f"#   differs: {short_name(k)} ({len(base[k])} -> "
                          f"{len(shipped[k])} instructions)", flush=True)
    if a.kernel == "sw_band":
        compare_row_loops(build.build_info["sw_band"]["path"],
                          build.build_info["sw_full"]["path"])
    warps = [int(x) for x in a.strip_warps.split(",") if x]

    m, go, ge = ali.make_score_matrix(*(WIDE_PEN if a.wide else ()))
    go, ge = -go, -ge
    dev = torch.device("cuda")
    mat = sw.device_matrix(m, dev)
    print(f"# matrix entries {int(m.min())}..{int(m.max())} "
          f"({'WIDE' if mat.wide else 'int8'})", flush=True)
    rng = np.random.default_rng(20240601)
    head = HEAD[a.kernel]
    results = []
    names = OUTS[a.kernel]
    tracks = (True,) if a.kernel == "swq" else (True, False)
    last = None
    for case, track in ((c, t) for c in cases(a.kernel, rng, dev, mat, go, ge)
                        for t in tracks if re.search(a.shapes, c.shape)):
        q, s, sl = case.tensors
        where = f"{case.shape} track={track} ({case.kind})"
        if case is not last:          # the plain version once a case
            want, last = case.plain(head), case
        routed = case.routes != ("",)
        wide_band = routed and a.kernel == "sw_band"
        fns = {}
        routes = [x for r in case.routes for x in (
            [f"strips{n}" for n in warps] if r == "strips" and warps
            else [r])]
        for label, lib in libs.items():
            for route in routes:
                if route == "warp" and mat.wide:
                    continue          # the one-warp kernel is int8 only
                entry = ENTRY.get(re.sub(r"\d+$", "", route),
                                  a.kernel + "_launch")
                if not takes(a.kernel, lib, q.shape[1]) or \
                        not hasattr(lib, entry):
                    continue
                if route == "many" and not takes_band(lib, case.band[0]):
                    print(f"# {where}: {label} has no one-block kernel for "
                          f"W={case.band[0]}", flush=True)
                    continue
                fns[f"{label} {route}" if routed else label] = \
                    launcher(a.kernel, lib, q, s, sl, mat, go, ge, track,
                             case.band, route)
        first = next(iter(fns))
        ship = [o.clone() for o in fns[first]()]
        for label, fn in fns.items():
            got = fn()
            if case.head_rows:        # the plain version on the first rows
                h = case.head_rows
                cut = [q[:head], s[:head, :h].contiguous(),
                       torch.clamp_max(sl[:head], h)]
                got_h = launcher(a.kernel, libs[label.split()[0]], *cut,
                                 mat, go, ge, track, case.band,
                                 label.split()[1])()
                must_equal(got_h, want, label, "the plain version",
                           where + f" (first {h} rows)", cut[2], names)
            else:
                must_equal([g[:head] for g in got], want, label,
                           "the plain version", where, sl, names)
            must_equal(got, ship, label, first, where, sl, names)
        if not case.timed:
            continue                  # checked; timed on random only
        work = case.work(track)
        times = {label: [] for label in fns}
        order = list(fns)
        rounds, reps = (min(a.rounds, 3), 1) if wide_band else \
            (a.rounds, a.reps)
        for r in range(rounds):
            for label in (order if r % 2 == 0 else order[::-1]):
                if r == 0 or not wide_band:   # a launch of seconds: once
                    fns[label]()
                times[label].append(event_ms(fns[label], reps))
        for label in fns:
            med = statistics.median(times[label])
            row = {"kernel": a.kernel, "version": label, "shape": case.shape,
                   "wide": mat.wide,
                   "track": track, "windows": case.kind, "median_ms": med,
                   "min_ms": min(times[label]), "rounds": times[label],
                   "bound_ms": work["bound_ms"],
                   "bound_by": work["bound_by"], "cells": work["cells"],
                   "share_of_bound": bounds.share(work["bound_ms"], med),
                   "card": card}
            if "bound_all_ms" in work:    # the strip path: every column too
                row["bound_all_ms"] = work["bound_all_ms"]
                row["share_of_bound_all"] = bounds.share(
                    work["bound_all_ms"], med)
            results.append(row)
            print(f"# {a.kernel} {case.shape} "
                  f"{'track' if track else 'score'} {case.kind:6s} "
                  f"{label:19s} median {med:.4f} ms, min "
                  f"{row['min_ms']:.4f} ms, {work['cells'] / med / 1e6:.0f} "
                  f"GCUPS, bound {work['bound_ms']:.4f} ms "
                  f"({work['bound_by']}), share "
                  f"{100 * row['share_of_bound']:.1f}%" +
                  (f" (every column {work['bound_all_ms']:.4f} ms, "
                   f"{100 * row['share_of_bound_all']:.1f}%)"
                   if "bound_all_ms" in work and
                   work["cells_all"] != work["cells"] else "") +
                  f" | {card}", flush=True)
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"# wrote {a.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
