#!/usr/bin/env python3
"""Smoke run of the PyTorch port (smalt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one GPU

1. Prints the toolchain (card, power limit, CUDA, nvcc); fails without
   a GPU.
2. Builds the CUDA kernel ops/csrc/sw_full.cu from the checkout.
3. Holds the kernel against its plain torch version (sw_score_ref) on
   the card: exact equality of (best, ti, tj) and of the score-only
   instance at the main-path shape Q=112 / S=128 / B=12,288 and at the
   edge shapes Q=80 / S=128 and Q=512 / S=640; times both.
4. Drives `map --fast` through the port's CLI at E. coli scale (4.6 Mb
   genome with ~5% planted repeats, 100,000 reads of 100 bp, k13 s2):
   one SAM record per read, >= 95% placed within 8 bp on the right
   strand, the kernel launched, and the first 4,096 reads' packed step
   output and SAM byte-identical to the port's `--device cpu` run.
5. Prints the kernels' JSON line, the card's name and power limit, and
   as the last line {"ok": true, "device": {...}}.

Any failed check exits non-zero without the last line.  Data is made
from a fixed seed under build/smoke/ and removed at the end.
"""
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 20240601
GENOME_LEN = 4_600_000
READLEN = 100
N_READS = 100_000
KMER, NSKIP = 13, 2
BATCH = 4096                      # the CLI's default batch
PLACE_TOL = 8
MIN_PLACED = 0.95
KERNEL_SHAPES = [(112, 128, 3 * BATCH), (80, 128, 4096), (512, 640, 1024)]


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def make_genome(rng, n: int) -> np.ndarray:
    """Uniform random bases with ~5% planted repeats: dispersed
    near-identical copies of three units and a tandem array (the
    workload of bench.py:38)."""
    bases = np.frombuffer(b"ACGT", np.uint8)
    g = rng.choice(bases, n)
    for ulen, nc in ((800, 60), (1500, 40), (3000, 25)):
        unit = rng.choice(bases, ulen)
        for _ in range(nc):
            cp = unit.copy()
            cp[rng.integers(0, ulen, max(1, ulen // 100))] = \
                rng.choice(bases, max(1, ulen // 100))
            at = int(rng.integers(0, n - ulen))
            g[at : at + ulen] = cp
    tandem = rng.choice(bases, 500)
    at = int(rng.integers(0, n - 20 * 500))
    g[at : at + 20 * 500] = np.tile(tandem, 20)
    return g


def make_reads(rng, genome: np.ndarray, n: int, qlen: int):
    """n reads of qlen with 1% substitutions (never to the same base),
    half reverse-complemented.  Returns (codes [n, qlen] ASCII, truth
    positions, is_reverse)."""
    pos = rng.integers(0, len(genome) - qlen, n)
    reads = genome[pos[:, None] + np.arange(qlen)]
    idx = np.frombuffer(b"ACGT", np.uint8)
    code = np.searchsorted(idx, reads)
    mut = rng.random((n, qlen)) < 0.01
    code = np.where(mut, (code + 1 + rng.integers(0, 3, (n, qlen))) % 4,
                    code)
    rev = rng.random(n) < 0.5
    code[rev] = 3 - code[rev, ::-1]
    return idx[code], pos, rev


def write_inputs(d: str, genome, reads):
    fa = os.path.join(d, "genome.fa")
    with open(fa, "wb") as f:
        f.write(b">chr\n")
        g = genome.tobytes()
        for i in range(0, len(g), 80):
            f.write(g[i : i + 80] + b"\n")
    fq = os.path.join(d, "reads.fq")
    fq_head = os.path.join(d, "reads_head.fq")
    qual = b"I" * reads.shape[1]
    with open(fq, "wb") as f, open(fq_head, "wb") as h:
        for i, r in enumerate(reads):
            rec = b"@r%d\n%s\n+\n%s\n" % (i, r.tobytes(), qual)
            f.write(rec)
            if i < BATCH:
                h.write(rec)
    return fa, fq, fq_head


def sam_body(path: str):
    with open(path) as f:
        return [ln for ln in f.read().splitlines()
                if ln and not ln.startswith("@")]


def placement(body, truth, rev):
    """Reads placed within PLACE_TOL of the truth on the right strand."""
    ok = 0
    for ln in body:
        f = ln.split("\t", 4)
        flag = int(f[1])
        i = int(f[0][1:])
        if flag & 4:
            continue
        if abs(int(f[3]) - 1 - truth[i]) <= PLACE_TOL and \
                bool(flag & 16) == bool(rev[i]):
            ok += 1
    return ok


def kernel_windows(rng, B: int, Q: int, S: int):
    """Seeded windows with planted similarity, N (5) and pad (7) codes,
    and varied subject lengths."""
    q = rng.integers(0, 4, (B, Q)).astype(np.int32)
    q[rng.random((B, Q)) < 0.02] = 5
    qlen = rng.integers(Q * 3 // 4, Q + 1, B)
    q[np.arange(Q)[None, :] >= qlen[:, None]] = 7
    s = rng.integers(0, 4, (B, S)).astype(np.int32)
    n = np.minimum(qlen, S) * 3 // 4
    off = rng.integers(0, S - n + 1)
    for b in range(B):
        s[b, off[b] : off[b] + n[b]] = q[b, : n[b]]
    mut = rng.random((B, S)) < 0.04
    s[mut] = rng.integers(0, 4, int(mut.sum()))
    s[rng.random((B, S)) < 0.01] = 5
    slens = np.where(rng.random(B) < 0.5, S,
                     rng.integers(S // 2, S + 1, B)).astype(np.int32)
    s[np.arange(S)[None, :] >= slens[:, None]] = 7
    return q, s, slens


def time_ms(fn, reps: int) -> float:
    """Mean time of fn() on the stream over reps calls (CUDA events,
    after three warm-up calls)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def check_kernel(rng, card: str):
    """Phase 3: the kernel against its plain version, on the card.
    Returns (max_abs_err, kernel ms, plain ms) at the main-path shape."""
    import torch
    from smalt_tpu.align import core as ali
    from smalt_tpu_torch.ops import sw
    m, go, ge = ali.make_score_matrix()
    go, ge = -go, -ge
    dev = torch.device("cuda")
    mat = torch.from_numpy(m).to(dev)
    worst = 0
    main = None
    for Q, S, B in KERNEL_SHAPES:
        q, s, sl = (torch.from_numpy(x).to(dev)
                    for x in kernel_windows(rng, B, Q, S))
        got = sw.sw_full_cuda(q, s, sl, mat, go, ge, track=True)
        got0 = sw.sw_full_cuda(q, s, sl, mat, go, ge, track=False)
        want = sw.sw_score_ref(q, s, sl, mat, go, ge, track=True)
        torch.cuda.synchronize()
        errs = [int((g - w).abs().max()) for g, w in zip(got, want)]
        err0 = int((got0 - want[0]).abs().max())
        worst = max(worst, *errs, err0)
        if max(errs + [err0]) != 0:
            fail(f"sw_full differs from sw_score_ref at Q={Q} S={S}: "
                 f"max |diff| best/ti/tj {errs}, score-only {err0}")
        if int(want[0].max()) <= 0:
            fail(f"degenerate test windows at Q={Q} S={S}")
        k_ms = time_ms(lambda: sw.sw_full_cuda(q, s, sl, mat, go, ge,
                                               track=True), 20)
        k0_ms = time_ms(lambda: sw.sw_full_cuda(q, s, sl, mat, go, ge,
                                                track=False), 20)
        p_ms = time_ms(lambda: sw.sw_score_ref(q, s, sl, mat, go, ge,
                                               track=True), 3)
        cells = B * Q * S
        print(f"# sw_full Q={Q} S={S} B={B}: equal to sw_score_ref "
              f"(best, ti, tj and score-only); track {k_ms:.4f} ms "
              f"({cells / k_ms / 1e6:.1f} GCUPS), score-only "
              f"{k0_ms:.4f} ms ({cells / k0_ms / 1e6:.1f} GCUPS), plain "
              f"{p_ms:.3f} ms ({cells / p_ms / 1e6:.2f} GCUPS) | {card}",
              flush=True)
        if main is None:
            main = (k_ms, p_ms)
    return worst, main[0], main[1]


def run_main_path(d: str, device: str, n_reads: int, genome_len: int,
                  card: str = "n/a"):
    """Phase 4: `map --fast` through the CLI on `device`, checked.
    Returns the kernel launch counts of the main-path run."""
    import torch
    from smalt_tpu.index.table import KmerIndex
    from smalt_tpu.map.fastmode import RawBatch, encode_batch, iter_fastq_hybrid
    from smalt_tpu.seq.refset import RefSet
    from smalt_tpu_torch import cli
    from smalt_tpu_torch.map.fastmode import get_device_step
    from smalt_tpu_torch.ops import sw

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    genome = make_genome(rng, genome_len)
    reads, truth, rev = make_reads(rng, genome, n_reads, READLEN)
    fa, fq, fq_head = write_inputs(d, genome, reads)
    idx_name = os.path.join(d, "idx")
    if cli.main(["index", "-k", str(KMER), "-s", str(NSKIP), idx_name,
                 fa]) != 0:
        fail("index build")
    print(f"# data + index: {time.perf_counter() - t0:.2f} s "
          f"({genome_len} bp genome, {n_reads} reads of {READLEN} bp, "
          f"k{KMER} s{NSKIP})", flush=True)

    sam = os.path.join(d, f"out_{device}.sam")
    is_cuda = device == "cuda"
    if is_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    os.environ["SMALT_TIMING"] = "1"
    err = io.StringIO()
    for k in sw.launches:
        sw.launches[k] = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["map", "--fast", "-f", "sam", "-o", sam,
                       "--device", device, idx_name, fq])
    wall = time.perf_counter() - t0
    launches = dict(sw.launches)
    sys.stderr.write(err.getvalue())
    if rc != 0:
        fail(f"map --fast on {device} exited {rc}")
    m = re.search(r"fast pipeline: (\d+) reads in (\d+) batches, "
                  r"([\d.]+) s \((\d+) reads/s\)", err.getvalue())
    peak = torch.cuda.max_memory_allocated() if is_cuda else 0
    body = sam_body(sam)
    if len(body) != n_reads:
        fail(f"{len(body)} SAM records for {n_reads} reads")
    placed = placement(body, truth, rev)
    print(f"# map --fast on {device}: {n_reads} reads in {wall:.3f} s "
          f"end to end ({n_reads / wall:.1f} reads/s incl. index load "
          f"and upload); pipeline {m.group(4) if m else '?'} reads/s "
          f"({m.group(3) if m else '?'} s, {m.group(2) if m else '?'} "
          f"batches); placed {placed}/{n_reads} "
          f"({placed / n_reads:.4f}) within {PLACE_TOL} bp; peak device "
          f"memory {peak / 2**20:.1f} MiB; launches {launches} | {card}",
          flush=True)
    if placed < MIN_PLACED * n_reads:
        fail(f"only {placed}/{n_reads} reads placed within {PLACE_TOL} bp")
    if not is_cuda:
        return launches

    # the first batch on the card against the port's CPU path
    refset, idx = RefSet.load(idx_name), KmerIndex.load(idx_name)
    first = next(iter(iter_fastq_hybrid(fq_head, BATCH)))
    Q = max(32, -(-READLEN // 16) * 16)
    arr = torch.from_numpy(first.encode(Q) if isinstance(first, RawBatch)
                           else encode_batch(first[1], Q))
    step_gpu = get_device_step(refset, idx, "cuda", (1, -2, -4, -3))
    reads_gpu = arr.to("cuda")
    packed_gpu = step_gpu(reads_gpu).cpu()
    step_ms = time_ms(lambda: step_gpu(reads_gpu), 20)
    packed_cpu = get_device_step(refset, idx, "cpu", (1, -2, -4, -3))(arr)
    if not torch.equal(packed_gpu, packed_cpu):
        bad = (packed_gpu != packed_cpu).any(dim=1).nonzero().flatten()
        fail(f"packed step output differs from the CPU path in rows "
             f"{bad.tolist()} (OUT_KEYS order)")
    print(f"# device step, one batch of {BATCH} reads (Q={Q}): "
          f"{step_ms:.3f} ms; packed [12, {BATCH}] output equal to the "
          f"CPU path | {card}", flush=True)
    sam_cpu = os.path.join(d, "out_head_cpu.sam")
    t0 = time.perf_counter()
    if cli.main(["map", "--fast", "-f", "sam", "-o", sam_cpu, "--device",
                 "cpu", idx_name, fq_head]) != 0:
        fail("map --fast --device cpu on the first batch")
    if sam_body(sam_cpu) != body[:BATCH]:
        fail(f"SAM of the first {BATCH} reads differs from the CPU path")
    print(f"# SAM of the first {BATCH} reads byte-identical to --device "
          f"cpu ({time.perf_counter() - t0:.1f} s on the CPU)", flush=True)
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from smalt_tpu_torch.ops import build, sw

    card = card_line()
    nv = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                        text=True).stdout.strip().splitlines()
    print(f"# toolchain: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | nvcc: {nv[-1] if nv else '?'} | "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    sw._kernel_lib()
    info = build.build_info["sw_full"]
    print(f"# build sw_full.cu: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {info['seconds']:.2f} s)", flush=True)
    for ln in info["log"].splitlines():
        if "registers" in ln or "spill" in ln:
            print(f"#   {ln.strip()}")

    rng = np.random.default_rng(SEED)
    err, k_ms, p_ms = check_kernel(rng, card)

    d = os.path.join(ROOT, "build", "smoke")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    try:
        launches = run_main_path(d, "cuda", N_READS, GENOME_LEN, card)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if launches["sw_full_track"] < 1:
        fail("the main path never launched the sw_full kernel")
    if "jax" in sys.modules:
        fail("jax was imported")

    print(json.dumps({"kernels": [{
        "name": "sw_full_track", "route": "cuda",
        "source": "smalt_tpu_torch/ops/csrc/sw_full.cu",
        "replaces": "smalt_tpu/ops/sw.py:60",
        "launches": launches["sw_full_track"], "max_abs_err": err,
        "ms": k_ms, "plain_ms": p_ms}]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
