"""Time ops/csrc/sw_full.cu on one GPU, beside an earlier version of it.

    python3 -m smalt_tpu_torch.ops.time_sw_full [--baseline old_sw_full.cu]
        [--rounds 5] [--reps 20] [--out build/time_sw_full.json]

Builds the kernel as shipped and, with --baseline, an earlier version of
the source (same C interface) side by side.  Each must equal
sw_score_ref exactly on a head of every input, and the baseline must
equal the shipped kernel on all of it, before anything is timed.  The
two are then timed in turns (CUDA events over --reps launches, --rounds
rounds, each round in the opposite order of the last), at the shapes the
mapping paths use, on random windows and on tie-heavy ones.  Prints one
line a version and shape with the median and the minimum over the
rounds, the share of the roofline bound (ops/bounds.py) and the card's
name and power limit; writes the same as JSON.  Fails without a GPU, and
on the first difference.
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

import numpy as np
import torch

from ..align import core as ali
from . import bounds, build, sw

# (Q, S, B, track): single-end and paired `map --fast`; the pass-1 pools
# of `map --device-exact` for 100 bp and 150 bp reads; the widest query
SHAPES = [(112, 128, 12288, True), (160, 256, 24576, True),
          (112, 128, 12288, False), (128, 128, 24576, False),
          (256, 384, 24576, False), (512, 640, 1024, True)]
HEAD = 512     # windows of each input also held against sw_score_ref


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


def load(src: str = ""):
    """The shipped sw_full.cu, or the source `src`, built and bound."""
    lib = build.load("sw_full", src)
    lib.sw_full_launch.restype = ctypes.c_int
    lib.sw_full_launch.argtypes = [
        ctypes.c_void_p if c == "p" else ctypes.c_int
        for c in sw._SIGS["sw_full"]]
    return lib


def launcher(lib, q, s, sl, mat, go: int, ge: int, track: bool):
    """fn() launches `lib`'s kernel on these tensors into outputs made
    once, and returns them: (best, ti, tj), or (best,) without track."""
    B, Q = q.shape
    out = [torch.empty(B, dtype=torch.int32, device=q.device)
           for _ in range(3 if track else 1)]
    ptrs = [o.data_ptr() for o in out] + [None] * (3 - len(out))
    stream = torch.cuda.current_stream().cuda_stream

    def fn():
        rc = lib.sw_full_launch(q.data_ptr(), s.data_ptr(), sl.data_ptr(),
                                mat.data_ptr(), B, Q, s.shape[1], go, ge,
                                int(track), *ptrs, stream)
        if rc != 0:
            raise RuntimeError(f"sw_full launch failed (code {rc})")
        return out
    return fn


def event_ms(fn, reps: int) -> float:
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def must_equal(got, want, label: str, what: str, where: str, sl):
    for name, g, w in zip(("best", "ti", "tj"), got, want):
        bad = (g != w).nonzero().flatten()
        if len(bad):
            i = int(bad[0])
            sys.exit(f"time_sw_full: FAIL: {label} differs from {what} at "
                     f"{where}: {name} of {len(bad)} windows, first {i}: "
                     f"{int(g[i])} vs {int(w[i])} (slen {int(sl[i])})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="time_sw_full")
    ap.add_argument("--baseline", default="",
                    help="an earlier sw_full.cu to time beside the shipped")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default="build/time_sw_full.json")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_sw_full: no CUDA device visible", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    srcs = {"shipped": ""}
    if a.baseline:
        srcs["baseline"] = a.baseline
    with ThreadPoolExecutor(len(srcs)) as pool:         # one nvcc each
        libs = dict(zip(srcs, pool.map(load, srcs.values())))
    for ident, info in build.build_info.items():
        worst = max((int(x) for x in re.findall(r"Used (\d+) registers",
                                                info["log"])), default=0)
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill",
                                                info["log"]))
        print(f"# build [{ident}]: {info['seconds']:.1f} s, most registers "
              f"{worst}, spill bytes {spills}", flush=True)

    m, go, ge = ali.make_score_matrix()
    go, ge = -go, -ge
    dev = torch.device("cuda")
    mat = sw.device_matrix(m, dev)
    rng = np.random.default_rng(20240601)
    results = []
    for Q, S, B, track in SHAPES:
        for kind, gen in (("random", random_windows),
                          ("ties", sw.tie_windows)):
            q, s, sl = (torch.from_numpy(x).to(dev) for x in gen(rng, B, Q, S))
            where = f"Q={Q} S={S} track={track} ({kind})"
            want = sw.sw_score_ref(q[:HEAD], s[:HEAD], sl[:HEAD], mat, go, ge,
                                   track=True)
            fns = {label: launcher(lib, q, s, sl, mat, go, ge, track)
                   for label, lib in libs.items()}
            ship = [o.clone() for o in fns["shipped"]()]
            for label, fn in fns.items():
                got = fn()
                must_equal([g[:HEAD] for g in got], want, label,
                           "sw_score_ref", where, sl)
                must_equal(got, ship, label, "the shipped kernel", where, sl)
            if kind == "ties" and Q > 160:
                continue                  # checked; timed on random only
            work = bounds.sw_full_work(Q, S, sl, track)
            times = {label: [] for label in fns}
            order = list(fns)
            for r in range(a.rounds):
                for label in (order if r % 2 == 0 else order[::-1]):
                    fns[label]()
                    times[label].append(event_ms(fns[label], a.reps))
            for label in fns:
                med = statistics.median(times[label])
                row = {"version": label, "Q": Q, "S": S, "B": B,
                       "track": track, "windows": kind, "median_ms": med,
                       "min_ms": min(times[label]), "rounds": times[label],
                       "bound_ms": work["bound_ms"],
                       "bound_by": work["bound_by"], "cells": work["cells"],
                       "share_of_bound": bounds.share(work["bound_ms"], med),
                       "card": card}
                results.append(row)
                print(f"# Q={Q} S={S} B={B} {'track' if track else 'score'} "
                      f"{kind:6s} {label:9s} median {med:.4f} ms, min "
                      f"{row['min_ms']:.4f} ms, {work['cells'] / med / 1e6:.0f} "
                      f"GCUPS, bound {work['bound_ms']:.4f} ms "
                      f"({work['bound_by']}), share "
                      f"{100 * row['share_of_bound']:.1f}% | {card}",
                      flush=True)
    os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"# wrote {a.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
