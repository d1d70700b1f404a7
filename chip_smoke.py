#!/usr/bin/env python3
"""Smoke run of the PyTorch port (smalt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one GPU
    python3 chip_smoke.py --long-fast 720000 2
        # only `map --fast` on 2 reads of 720 kb (below), no phase
    python3 chip_smoke.py --repeat-tier
        # only phase 7c (below), then segcand's kernels-line entry

1. Prints the toolchain (card, power limit, CUDA, nvcc); fails without
   a GPU.
2. Builds the CUDA kernels ops/csrc/sw_full.cu, ops/csrc/sw_band.cu and
   ops/csrc/swq.cu from the checkout, one nvcc each, side by side; fails
   if ptxas reports a spill in sw_band's several-warps kernel or in
   sw_full's strip kernels.  The --device-pass1 runs of phases 10 and 11
   print the time of the lane's strip calls on the card (CUDA events).
3. Holds sw_full against its plain torch version (sw_score_ref) on
   the card: exact equality of (best, ti, tj) and of the score-only
   instance at the single-end shape Q=112 / S=128 / B=12,288, the
   paired shape Q=160 / S=256 / B=24,576, the edge shapes Q=80 /
   S=128 and Q=512 / S=640, and the device-exact pass-1 pool shapes
   Q=128 / S=128 and Q=256 / S=384 on 6 x 4,096 windows; times both.
   Then the same on tie-heavy windows (a low-complexity query against
   a repeat of itself: the maximum is reached in many rows and lanes)
   at the single-end, the pool and the paired shape.  Then the WIDE
   instances (a score matrix outside int8: match 200, mismatch -200, X
   -400), tracked and score-only, at Q=112 / S=128 and Q=160 / S=256 on
   planted and tie-heavy windows.  Then the strip path (queries past 512
   columns), tracked and score-only, int8 and WIDE, at Q=640 / S=768,
   Q=1,024 / S=1,152, Q=2,048 / S=2,304 and Q=4,096 / S=4,352 on 64
   planted and 64 tie-heavy windows each, through both of its kernels
   (the wavefront at its route, the one-warp kernel with ops/sw.py
   STRIP_ONE_WARP_B lowered to 0), every call launching the instance
   sw_full_instance names ("_strip" the wavefront, "_warp" the one-warp
   kernel, int8 only), and timed at Q=2,048 / S=2,304 on 4,096 tie-heavy
   windows (the one-warp kernel's route on int8, the wavefront beside it;
   WIDE and the two-part record on the wavefront; the plain version once);
   a batch of 64 windows whose query ends
   cycle over STRIP_QENDS (512 k and 512 k + 1, a window of pad code
   only), int8, WIDE and the two-part record, both kernels; 1,500 bp
   reads in Q=2,048 (4,096 windows) and 20 kb reads in Q=32,768 (64)
   timed, with the bound over the cells inside the query.  Then
   the strip path past 16,384 columns: Q=32,768 / S=2,048 on 64 windows
   planted past column 16,384 and 64 tie-heavy ones, int8 and WIDE, with
   the carry scratch budget (ops/sw.py SCRATCH_BYTES) lowered so
   that each call runs in 4 launches, then every wavefront instance but
   the record's timed there in one launch; and the two-part record (the
   _rec kernels) on 16 windows that score past 2^23 (S = 16,384; Q = 16,384
   with entries of +-1,000, and their first 512 columns with entries of
   +-24,000), timed on 1,056 copies of them.
   Phases 3, 3b and 3c print each kernel's roofline bound at each shape
   (smalt_tpu_torch/ops/bounds.py: the cells and bytes these inputs
   need), which of operations and bytes bounds it, and the share of the
   bound the kernel reached.
3b. Holds sw_band (tracked and score-only) against sw_band_score_ref
   the same way, at the long-read windows of Q = 640, 1504 (the main
   path) on 12,288 windows each, 4096 (W = 768, two warps a window) on
   4,096 and Q = 16,384 (W = 3,072, 12 lanes a thread's widest band) on
   32;
   times both (the plain version over 2 calls after one warm-up, one
   call at the two widest shapes) and prints GCUPS over the band's
   cells.  Then
   tie-heavy band windows (a short unit repeated along the query and
   the subject: the maximum is reached in many band lanes and rows, and
   some windows score nothing) at Q = 640 and 1504, and the band widths
   W = 200 and 330 at Q = 640 on 1,024 windows of both kinds (no
   multiple of 32: threads hold padding lanes past W), and 8 windows
   with a subject of 26,000 rows at W = 256 (no room for the one-warp
   kernel's shared-memory profile), and 16 windows of Q = 256 / S =
   2,048 / W = 256 with gap penalties of 140,000 ((S + 1) * ge >= 2^28,
   past the one-warp kernel's stand-in for NEG): both run the
   several-warps kernel.  Then Q = 1504 / W = 384
   on 4,096 windows with the matrix outside int8 of phase 3, which runs
   the several-warps kernel's int16 profile.  Then the several-warps
   kernel, sw_band_multi_kernel (bands past 512 lanes; 12 lanes a thread
   to 3,072, 20 above), at the bands of reads of 4, 10 and 20 kb (Q =
   4,096, 10,000 and 20,000: W = 768, 1,920 and 3,840) on 12 planted and
   12 tie-heavy windows each, a seventh of them with slen 0 (the plain
   version timed on the planted ones), then timed on copies of the
   planted windows (4,096 windows at W = 768, 12,288, the default
   batch's, at 1,920 and 3,840; each copy equal to its original), with
   the bound; at W = 1,000 and 3,100 (Q = 4,096, 64 windows of each kind:
   a thread's and a warp's lanes past W); and at its widest routed band,
   W = TILED_BAND_W = 12,800 (Q = 67,600), on 4 windows of 8,192
   subject rows.
   Every sw_band call of phase 3b must launch exactly the instance
   ops/sw.py sw_band_instance names.  Then the kernels of bands past
   12,800 lanes (ops/sw.py TILED_BAND_W):
   sw_band_cluster_kernel with ops/sw.py TILED_BAND_W lowered to 0 and
   CLUSTER_BAND_W raised to its widest band (CLUSTER_MAX_W), so that
   every band takes it, and sw_band_strips_kernel with CLUSTER_BAND_W
   lowered to 0, at W = 768 (Q = 4,096, 512 windows) and W = 3,840
   (Q = 20,000, 12 windows) on the first 4,096 subject rows of planted
   and tie-heavy windows (a seventh of them with slen 0; both also with
   the matrix outside int8), and at W = 200 and 330 (Q = 640); the
   cluster kernel on 7 CTAs (W = 12,928, the first width past
   TILED_BAND_W) and 16 CTAs (W = 32,768, 40,000 and 131,072, its
   widest), on their first rows; then both on the 6 windows of 2 reads of
   100 kb (W = 18,816, S = 112,512: the cluster kernel on 10 CTAs), timed,
   with their bound.  Then sw_band_strips_kernel at its own route (W past
   CLUSTER_BAND_W): the 3 windows of a read of 700 kb (W = 131,328,
   S = 787,584) on their first 4,096 subject rows, planted and
   tie-heavy (most band lanes there lie left of column 0: the skipped
   strips, the edge rows), and the first with pad 0 (prepad W / 2) on its
   first 69,760 rows, whose last 4,096 lie wholly inside the query (every
   strip's middle rows), against the plain version, exactly; then timed
   on all their rows, with the bound.  Then the one-row-old E term:
   ops/sw.py eterm_windows (the best path takes a vertical gap into a
   warp's or a CTA's last lane and a horizontal gap from it) through the
   several-warps kernel at W = 768 and 3,840 and the cluster kernel
   (TILED_BAND_W lowered to 0) at the same widths, and through the strip
   kernel (CLUSTER_BAND_W lowered to 0) with its horizontal gap planted
   across a strip edge inside a group and across a group edge (query
   columns 256 (2 NW + 1) and 512 NW, NW the warps a CTA), against the
   plain version; and
   cudaOccupancyMaxActiveClusters for every shape cluster_shape returns
   (fails where the card cannot place one).
3c. Holds swq (device pass 2: banded fill + walk) against its plain
   version swq_fill_walk_ref, exactly (best, mi, mj and every record
   row), on 8,192 pass-2-style windows at Qp=128 / Sp=256 (the main
   path) and Qp=256 / Sp=512 with lead-pinned, s_left > 0, dummy and
   best-0 windows, then 2,048 windows at Qp=256 / Sp=320 with bands of
   70-250 columns (up to 8 tiles of 32 a row); times both.  Phase 7 adds
   the windows of its first pass-2 batch.
4. Drives `map --fast` through the port's CLI at E. coli scale (4.6 Mb
   genome with ~5% planted repeats, 100,000 reads of 100 bp, k13 s2):
   one SAM record per read, >= 95% placed within 8 bp on the right
   strand, the kernel launched, and the first 4,096 reads' packed step
   output and SAM byte-identical to the port's `--device cpu` run.
5. Long reads on the same genome and index: 8,192 reads of 1,500 bp
   with 1% substitutions and 1.5% indels, half reverse-complemented
   (bench.py:771), batch 4,096: one record per read, >= 85% placed
   within 150 bp on the right strand, sw_band_track launched and
   sw_full_track not, the first 256 reads' SAM equal to `--device cpu`;
   the device step's and the host tail's time for one batch.  Then the
   same reads with the tail pool (-n min(8, cores), spawned workers): SAM
   byte-identical to -n 1, both rates and their ratio.
5b. Reads whose band passes 512 lanes, on the same genome and index:
   256 reads of 10 kb (phase 5's generator; W = 1,920: the several-warps
   kernel on 12 lanes a thread) through `map --fast -n 8` on the card at
   the default batch, the first 4 records byte-identical to `--device
   cpu` on those 4 reads, placement within 150 bp printed, the batch's
   device step (on the 256 reads and padded to 4,096 rows) beside its
   host tail.
6. Pairs on the same genome and index: 50,000 pairs of 2 x 150 bp,
   inserts 300 +- 30 in FR orientation, 1% substitutions, batch 4,096
   pairs: one record per mate, >= 95% of mates within 8 bp on the right
   strand, the share flagged proper pair, the first batch's packed
   [12, 8,192] step output and its 4,096 pairs' SAM equal to
   `--device cpu`; the tail pool as in phase 5.
6b. `map --fast --resume` on phase 4's first 4,096 reads in batches of
   512, killed after two checkpoints and run again: SAM byte-identical to
   the uninterrupted run; `--profile DIR` on the same reads: a torch
   profiler trace under DIR (its device kernel events counted), same SAM.
7. `map --device-exact` on the same genome and index: 20,480 reads of
   100 bp (five batches of 4,096) through the host C lane (`map`, no
   device flag), then `map --device-exact` on the card with SMALT_DX_P2
   unset and with SMALT_DX_P2=1: both SAMs byte-identical to the host
   lane's (the @PG line aside), no batch rendered on the host, the
   score-only sw_full launched in both runs and swq in the second with
   p2_hit > 0; reads/s of the three runs, the lane's counters, and one
   batch's collate step and pass-2 step (CUDA events).  Then the host
   lane and `--device-exact` with `-f bam`: the records, read back with
   report/bam.py read_bam, equal (the header names the command).  That batch's
   collate outputs (pool, counts2, scores, fallback) and packed pass-2
   output must equal the port's CPU steps on the same batch (the SAM
   alone cannot show a wrong device step: the lane re-stages what it
   flags), and its pass-2 windows go through the swq check of phase 3c.
7b. The pass-2 band widths of the same lane on 4,096 reads of 150 bp,
   of 250 bp with indels, and of 250 bp with indels under the phase-8
   matrix (first batch each, outside the CLI): widths by 32-column tile,
   swq held against its plain version on those windows and timed.
7c. The exact lane's repeat tier: `map --device-exact` on 8,192 reads
   of 100 bp from a 3 Mb genome of dispersed repeat copies (1,200 of a
   300 bp unit, 150 of a 1 kb unit, diverged up to 12% / 10%; k 13,
   step 13): SAM byte-identical to the host C lane, tier rows in each
   batch and none re-staged for its hits, segcand launched once a step.
   The first batch's two scans (the tier's, the main step's), as that
   run gave them, through segcand.cu and the plain scan on the card: rows,
   counts and flags bit for bit; both timed, beside segcand's bound
   (ops/bounds.py segcand_work).  Then the tier's step at its ceilings
   (4,096 rows, 16,384 hits and candidates a lane, a pool of 2,097,152
   rows, Q = 256) on lanes of 16,384 hits: its peak device memory.
8. `-S match=200,subst=-2` (a matrix outside int8) on the same genome
   and index: `map --fast` on 4,096 reads, SAM equal to `--device cpu`,
   through the WIDE tracked sw_full; `map --device-exact` with
   SMALT_DX_P2=1 and `map --device-pass1` on 4,096 reads, SAM equal to
   the host C lane, through the WIDE score-only sw_full (and swq,
   p2_hit > 0).
9. Paired `map --device-exact` on the same genome and index: 10,240
   pairs of 2 x 150 bp (five batches of 2,048 pairs, 20,480 mates),
   inserts 300 +- 30 FR, 1% substitutions, mate B random bases in every
   tenth pair (the rescue path), through the host C pair lane (`map`, no
   device flag) and `map --device-exact` on the card: SAM byte-identical
   (the @PG line aside), no batch rendered on the host, the score-only
   sw_full launched and swq not; pairs/s of the lane (`# dxp-total`) and
   reads/s of the CLI for both runs, the stages' seconds, n_restaged.
   A first paired batch of 512 pairs: its collate outputs must equal the CPU
   step's on that batch, and its collate step is timed.
10. `map --device-pass1` on the same genome and index: (a) phase 7's
   20,480 reads, SAM byte-identical to phase 7's host C lane, no batch
   rendered on the host, the lane's reads/s (`# dp1-total`) beside the
   host lane's; (b) 1,024 reads of 1,500 bp with 1.5% indels (phase 5's
   generator) through the host C lane and `--device-pass1`: SAM
   byte-identical, through sw_full's strip path; (c) `--device-exact` on
   a k15 s16 index of the genome, which DeviceExact.make refuses: the
   pass-1 lane runs (stderr says so), SAM equal to the host C lane on
   4,096 reads; (d) the pass-1 step alone on a resident reference of
   2^31 + 2^24 random codes with windows below 2^31, straddling it,
   above it and at its end, equal to its plain version built from an
   int64 gather.
11. Reads over 16 kb on the same genome and index: 512 reads of 20
   kb (phase 5's generator) through `map --fast -n 8` on the card at the
   default batch (1,536 windows through the several-warps kernel on 20
   lanes a thread), the first
   2 records byte-identical to --device cpu on those 2 reads; the 2
   through `map --device-pass1` against the host C lane (SAM
   byte-identical, the strip path at Q = 32,768), again with the strip
   scratch budget lowered (the windows in groups, SAM unchanged); then
   2 reads of 9 kb under -S KEY_SPEC (the default penalties times
   1,000), whose windows score past 2^23, through both lanes the same
   way; then 4,096 reads of 100 bp through `map --fast -S
   KEY_SHORT_SPEC` (the penalties times 40,000: sw_full's two-part
   record), SAM byte-identical to --device cpu; then 2 reads of 100 kb
   through `map --fast` on the card at the default batch
   (sw_band_cluster_kernel; the batch's 4,094 pad reads give their
   windows no rows), both placed within 150 bp, and that batch's device
   step timed on the 2 reads and padded to 4,096 rows (the real reads'
   output unchanged by the padding) beside its host tail.  Reads this
   long are not mapped with `--device cpu`: its plain versions take
   minutes a batch (phase 3b holds the kernel against its plain version
   on windows of this shape instead).
12. `map --fast` on split-word indexes (k16 s13 and k20 s13) of the same
   genome: 4,096 reads of 100 bp and 256 of 1,500 bp, SAM byte-identical
   to `--device cpu`, placement printed.
13. `map --device-exact` on a k13 s16 index of the same genome (nskip >
   wordlen: the collate step expands the hits on the device): 4,096
   reads of 150 bp through the host C lane and the lane with SMALT_DX_P2
   unset and =1, and 2,048 pairs of 2 x 150 bp through the host C pair
   lane and the lane, SAM byte-identical with no batch rendered on the
   host; n_restaged and p2_hit printed; the five collate outputs (the
   hit-info checksum included) of a first single-end batch of 1,024 reads
   equal to the port's CPU step's.
14. `map --fast` over device meshes (smalt_tpu_torch/parallel/spmd.py),
   every member on cuda:0 (a Mesh's explicit device list: one card holds
   every shape; members that share it measure the cost of the replicated
   work and of the collectives, not a scaling), on the same genome and
   index: (a) the replicated-index step on 2x1, 4x1 and 1x2 and the
   range-sharded one on 1x2, 2x2 and 1x3, on phase 4's first batch: all
   12 OUT_KEYS equal to the single-device CUDA step and to the same
   mesh's CPU step, each step's time beside the single device's (CUDA
   events), the bytes its collectives moved, each member's resident
   index and the card's peak; (b) run_fast_pipeline on 2x2 over phase
   4's first 20,480 reads, on 1x2 over phase 6's first 4,096 pairs and
   over phase 12's k16 s13 index: SAM byte-identical to those phases'
   single-device runs; (c) 256 reads of 1,500 bp on 1x2, a quarter
   starting within a window (1,792 bases) before the ip cut: SAM equal
   to the same mesh's --device cpu run, through sw_full's strip path
   (the range-sharded step scores full-matrix), the records that differ
   from the single-device (banded) run counted, and on 2x1 (the index
   replicated: sw_band) equal to the single device; sw_full's strips at Q =
   1,504 (last strip 480 columns) held against the plain version and
   timed beside their bound; (d) __graft_entry__.py's corpus oracle (1
   Mb repeat-planted genome, 10,000 reads, k13 s2, batches of 1,024) on
   4x1 and 2x2, byte-identical to the single device; (e) two processes
   through the CLI under SMALT_TPU_COORD / _NPROCS / _PROCID (gloo on
   127.0.0.1), each mapping its stripe on cuda:0, then merge-shards: the
   single-host SAM; (f) --mesh 2,2 with fewer cards visible exits
   non-zero naming their count.
15. Prints each kernel's launches by path (and per 4,096 reads), the
   kernels' JSON line (time, plain version's time, bound; no PyTorch
   call computes a Smith-Waterman score, so library_ms is null), the
   card's name and power limit, and as the last line
   {"ok": true, "device": {...}}.

Kernel launch counts are set to 0 just before each mapping run (4, 5,
6 and their -n runs, 6b's, 7's three device runs, 7c's two, 8's three,
9's, 10's,
11's, 12's and 13's device runs, 14's mesh runs) and read just after it;
the comparisons with the plain versions do not count (14(e)'s two host
processes count their own).  Any failed check exits non-zero
without the last line.  Data is made from a fixed seed under
build/smoke/ and removed at the end.  Nothing of smalt_tpu or jax is
imported: the script fails if either is in sys.modules at the end.
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
from concurrent.futures import ThreadPoolExecutor

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
# full-matrix kernel: (Q, S, windows).  The first is the single-end
# path's shape; (160, 256) is the paired path's (both mates in one step);
# the last two are the device-exact pass-1 pools of 100 bp and 150 bp
# reads (score-only).
KERNEL_SHAPES = [(112, 128, 3 * BATCH), (80, 128, 4096), (512, 640, 1024),
                 (160, 256, 6 * BATCH), (128, 128, 6 * BATCH),
                 (256, 384, 6 * BATCH)]
POOL_SHAPE = (128, 128, 6 * BATCH)    # the score-only main-path shape
# banded kernel: (Q, windows); S, pad and W follow from Q as on the main
# path.  Q = 1504 (1,500 bp reads) is the main-path shape.
BAND_SHAPES = [(640, 3 * BATCH), (1504, 3 * BATCH), (4096, BATCH),
               (16384, 32)]
BAND_MAIN_Q = 1504
BAND_TIE_SHAPES = [(640, 3 * BATCH), (1504, 3 * BATCH)]
# band widths that are no multiple of 32, at Q = 640 on 1,024 windows
ODD_BAND_Q, ODD_BAND_B, ODD_BAND_WIDTHS = 640, 1024, (200, 330)
LONG_SUBJ_S, LONG_SUBJ_B = 26_000, 8   # 8 * (S + W) bytes > 200 KB
LONG_READLEN, N_LONG, LONG_HEAD = 1500, 8192, 256
LONG_TOL, MIN_LONG = 150, 0.85    # tests/test_longread_concordance.py:110
# phase 5b: reads whose band (W = 1,920) takes the several-warps kernel
N_MID, MID_READLEN, MID_HEAD = 256, 10_000, 4
PAIR_READLEN, N_PAIRS, PAIR_HEAD = 150, 50_000, 4096
INSERT_MEAN, INSERT_SD = 300, 30
# device pass 2: (Qp, Sp, windows); the first is the 100 bp lane's shape;
# then Qp256 with bands of 70-250 columns (3 to 8 tiles of 32 a row)
SWQ_SHAPES = [(128, 256, 8192), (256, 512, 8192)]
SWQ_WIDE = (256, 320, 2048)
# score matrices outside int8: phase 3 and 3b hold the WIDE sw_full
# instances and sw_band's several-warps route with entries of +-200 (X
# -400), phase 8 maps with -S WIDE_SPEC
WIDE_PEN = (200, -200)
WIDE_FULL_SHAPES = [(112, 128, 3 * BATCH), (160, 256, 6 * BATCH)]
# sw_full's strip path (queries past 512 columns): (Q, S) held exactly on
# STRIP_CHECK_B windows of each kind, int8 and WIDE; timed at STRIP_TIME.
# --device-pass1 pads 513-1,024 bp reads to Q = 1,024, up to 2 kb to 2,048
STRIP_SHAPES = [(640, 768), (1024, 1152), (2048, 2304), (4096, 4352)]
STRIP_CHECK_B = 64
STRIP_TIME = (2048, 2304, BATCH)
# the strip path past 16,384 columns (the pass-1 lane pads reads over 16 kb
# to 32,768): (Q, S, windows), the carry scratch split into
# STRIP_FAR_GROUPS launches by a lowered ops/sw.py SCRATCH_BYTES
STRIP_FAR = (32768, 2048, 64)
STRIP_FAR_GROUPS = 4
# the strip path skips strips of pad code alone: (Q, S, windows) of a batch
# whose query ends (qend: one past the last column not of code 7) cycle
# over STRIP_QENDS, checked on int8, WIDE and the two-part record (entries
# of +-STRIP_REC_ENTRY: Q * entry >= 2^23); then timed on reads shorter than
# their bucket, (Q, S, windows, qend): 1,500 bp reads in Q 2,048 and 20 kb
# reads in Q 32,768, as the pass-1 lane pads them
STRIP_QEND_SHAPE = (2048, 2304, 64)
STRIP_QENDS = (512, 513, 1024, 1025, 1536, 1537, 2048, 0, 511, 700, 1500,
               1999)
STRIP_REC_ENTRY = 5000
STRIP_QEND_TIME = [(2048, 2304, BATCH, 1500), (32768, 2048, 64, 20000)]
# scores past 2^23 (the tracking key's limit): the two-part record (the
# _rec kernels) on planted Q = S = 16,384 windows with entries of +-1000,
# and on their first 512 columns with entries of +-24,000 (in registers),
# checked on KEY_SHAPE's 16 windows and timed on KEY_FULL_B copies of them
KEY_PEN, KEY_REG_PEN = (1000, -1000), (24000, -24000)
KEY_SHAPE = (16384, 16384, 16)
KEY_FULL_B = 66 * 16                  # 8 warps a SM
# the several-warps kernel (W > 512): (Q, windows timed) at the bands of
# 4, 10 and 20 kb reads (W = 768, 1,920, 3,840; 3 windows a read), each
# checked on BAND_MULTI_B planted and BAND_MULTI_B tie-heavy windows
# (every seventh with slen 0) and timed on copies of the planted ones; the
# band widths BAND_MULTI_ODD at BAND_MULTI_ODD_Q on 64 windows of each
# kind; the widest band ops/sw.py routes to it, W = TILED_BAND_W = 12,800
# (Q = 67,600), on its first BAND_WIDEST[1] subject rows; and
# BAND_BIG_GE windows with a gap extension past (S + 1) * ge >= 2^28
BAND_MULTI = [(4096, BATCH), (10000, 3 * BATCH), (20000, 3 * BATCH)]
BAND_MULTI_B = 12
BAND_MANY_Q = 20000                   # the "_many" line of the JSON
BAND_MULTI_ODD_Q, BAND_MULTI_ODD = 4096, (1000, 3100)
BAND_WIDEST = (67600, 8192, 4)        # Q, subject rows, windows
# Q, S, W, pad, gap open = extension, windows
BAND_BIG_GE = (256, 2048, 256, 128, 140_000, 16)
# the one-row-old E term of the several-warps and the cluster kernel's row
# exchange: ops/sw.py eterm_windows under ETERM_PEN (match, mismatch, gap
# open, gap extension), ETERM_B windows a case, at the band geometry of
# Q (subject rows cut to the first `rows`), planted at the first lanes of
# warps (the several-warps kernel: 384 and 640 lanes a warp at W 768 and
# 3,840) and of warps and CTAs (the cluster kernel, TILED_BAND_W lowered
# to 0: warps of 512 lanes, CTAs of 2,048 at W 3,840)
ETERM_PEN = (1, -6, -8, -1)
ETERM = [(4096, 4608, (384,), (512,)),
         (20000, 5120, (3200, 2560), (3584, 2048))]
ETERM_B = 8
# bands past TILED_BAND_W: sw_band_cluster_kernel (to CLUSTER_MAX_W =
# 131,072 lanes) with ops/sw.py TILED_BAND_W lowered to 0 and
# CLUSTER_BAND_W raised to CLUSTER_MAX_W (every band on it), and
# sw_band_strips_kernel with CLUSTER_BAND_W lowered to 0, held at the
# band geometry of BIG_SMALL (Q, windows: W = 768 and 3,840: the cluster
# kernel on 1 and 2 CTAs, the strip kernel on bands of 2 and 8 strips'
# width) on planted and tie-heavy windows, a seventh of them with slen 0,
# and at ODD_BAND_WIDTHS; both also with WIDE_PEN; the cluster kernel on
# CLUSTER_WIDE (W, windows, subject rows: 7 CTAs at the first width past
# TILED_BAND_W, then 16 CTAs of 128, 160 and 512 threads); then both at
# the windows of R100K_N reads of R100K_LEN bp (W = 18,816, three windows
# a read: the cluster kernel on 10 CTAs), timed there.  The strip kernel
# at its own route: the STRIPS_B windows of a read of STRIPS_READLEN bp,
# their first STRIPS_ROWS rows (planted and tie-heavy) and, with pad 0,
# the first STRIPS_PAD0_B's first STRIPS_PAD0_ROWS; timed on all their
# rows.  Its E-term
# windows: STRIPS_ETERM (Q, band lanes a), the horizontal gap across
# query columns 256 (2 NW + 1) (a strip edge inside a group) and 512 NW
# (a group edge), NW the warps a CTA
BIG_SMALL = [(4096, 512), (20000, 12)]
BIG_SMALL_ROWS = 4096               # subject rows held at those widths
CLUSTER_WIDE = [(12928, 8, 2048), (32768, 2, 384), (40000, 2, 256),
                (131072, 2, 128)]
R100K_LEN, R100K_N = 100_000, 2
STRIPS_READLEN, STRIPS_B, STRIPS_ROWS = 700_000, 3, 4096
# (the plain version takes ~40 s on this set, at 1 window as at 3: its
# row steps, not the windows, set its time)
STRIPS_PAD0_ROWS, STRIPS_PAD0_B = 69_760, 1
STRIPS_ETERM = (8192, (1500, 1480, 1460))
WIDE_SPEC = "match=200,subst=-2"
# phase 12: the split-word index, (k, step) each, on the phase-4 genome:
# BATCH reads of READLEN bp and N_BIGK_LONG of LONG_READLEN bp
BIGK = ((16, 13), (20, 13))
N_BIGK_LONG = 256
# phase 13: the device hit expansion of --device-exact (nskip > wordlen)
# on a k13 s16 index of the phase-4 genome
DXH_INDEX = (13, 16)
DXH_CHECK_B = 1024    # reads in the batch held against the CPU step
# phase 14: the device mesh of --fast, every member on cuda:0.  (a) the
# mesh steps, (kind, dp, ip), on phase 4's first batch; (b) MESH_SE_READS
# of phase 4's reads through run_fast_pipeline on MESH_SE; (c)
# N_MESH_LONG reads of LONG_READLEN bp on 1 x 2, every MESH_CUT_EVERY-th
# starting within window_len(1504) bases before the cut; (d) the corpus
# oracle of __graft_entry__.py:149-234 (CORPUS: genome bp, reads, batch)
# on CORPUS_MESHES; (e) MESH_HOSTS processes through the CLI
MESH_STEPS = (("replicated", 2, 1), ("replicated", 4, 1),
              ("replicated", 1, 2), ("range-sharded", 1, 2),
              ("range-sharded", 2, 2), ("range-sharded", 1, 3))
MESH_SE, MESH_SE_READS = (2, 2), 5 * BATCH
N_MESH_LONG, MESH_CUT_EVERY = 256, 4
STRIP_Q1504 = (1504, 1792, BATCH)     # sw_full's strips, last one 480 columns
CORPUS = (1_000_000, 10_000, 1024)
CORPUS_MESHES = ((4, 1), (2, 2))
MESH_HOSTS = 2
N_EXACT = 5 * BATCH               # phase 7: five batches of 100 bp reads
N_PE_EXACT = 5 * BATCH // 2       # phase 9: five batches of 2,048 pairs
PE_CHECK_B = 1024                 # phase 9: mate rows held against the CPU
N_DP1_LONG = 1024                 # phase 10b: reads of LONG_READLEN
FAR_REF = (1 << 31) + (1 << 24)   # phase 10d: codes of the resident reference
# phase 7b: (read length, indels, -S) of the lane's band-width cases
LANE_BANDS = [(150, False, None), (250, True, None), (250, True, WIDE_SPEC)]
# phases 5 and 6 also map with the tail pool of this many processes
POOL_N = min(8, os.cpu_count() or 1)
# phase 6b: --resume killed after RESUME_TICKS batches of RESUME_BATCH
# reads of phase 4's head, and restarted; --profile on the same reads
RESUME_BATCH, RESUME_TICKS = 512, 2
# phase 11: reads over 16 kb (phase 5's generator), one batch; then
# KEY_READLEN reads under -S KEY_SPEC, whose scores pass 2^23: the
# default penalties times 1,000 (a match of 1,000 alone makes gaps so
# cheap that the host C pass-2 block refuses every batch: its direction
# matrix grows past its cap, and the lane renders the batch on the host)
VLONG_READLEN, N_VLONG, VLONG_DP1_BATCH = 20_000, 2, 64
N_VLONG_FAST = 512                # --fast on the card: 1,536 windows
KEY_READLEN = 9_000
KEY_SPEC = "match=1000,subst=-2000,gapopen=-4000,gapext=-3000"
# the default penalties times 40,000: a 100 bp window could score 2^23
KEY_SHORT_SPEC = "match=40000,subst=-80000,gapopen=-160000,gapext=-120000"


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


ACGT = np.frombuffer(b"ACGT", np.uint8)


def substitute(rng, code: np.ndarray, rate: float) -> np.ndarray:
    """Codes 0..3 with a share `rate` changed, never to the same base."""
    mut = rng.random(code.shape) < rate
    return np.where(mut, (code + 1 + rng.integers(0, 3, code.shape)) % 4,
                    code)


def make_reads(rng, genome: np.ndarray, n: int, qlen: int):
    """n reads of qlen with 1% substitutions (never to the same base),
    half reverse-complemented.  Returns (codes [n, qlen] ASCII, truth
    positions, is_reverse)."""
    pos = rng.integers(0, len(genome) - qlen, n)
    reads = genome[pos[:, None] + np.arange(qlen)]
    code = substitute(rng, np.searchsorted(ACGT, reads), 0.01)
    rev = rng.random(n) < 0.5
    code[rev] = 3 - code[rev, ::-1]
    return ACGT[code], pos, rev


def make_long_reads(rng, genome: np.ndarray, n: int, rl: int, pos=None):
    """bench.py:771's kilobase reads, vectorised: from a source of rl +
    100 bases (at `pos`, or at random), each event deletes a base
    (0.75%), inserts a random one (0.75%), substitutes (1%) or copies,
    until rl bases are out; half reverse-complemented.  Returns (ASCII
    [n, rl], positions, is_reverse)."""
    K = rl + max(200, rl // 100)     # deletions leave ~0.75% of events
    if pos is None:
        pos = rng.integers(0, len(genome) - rl - 100, n)
    src = np.searchsorted(ACGT, genome[pos[:, None] + np.arange(rl + 100)])
    r = rng.random((n, K))
    dele, ins, sub = r < 0.0075, (r >= 0.0075) & (r < 0.015), \
        (r >= 0.015) & (r < 0.025)
    adv = ~ins
    j = np.minimum(np.cumsum(adv, axis=1) - adv, rl + 99)
    base = np.take_along_axis(src, j, 1)
    code = np.where(ins, rng.integers(0, 4, (n, K)),
                    np.where(sub, (base + 1 + rng.integers(0, 3, (n, K))) % 4,
                             base))
    emit = ~dele
    if int(emit.sum(axis=1).min()) < rl:
        fail("long-read generator ran out of events")
    first = np.argsort(dele, axis=1, kind="stable")[:, :rl]
    code = np.take_along_axis(code, first, 1)
    rev = rng.random(n) < 0.5
    code[rev] = 3 - code[rev, ::-1]
    return ACGT[code], pos, rev


def make_pairs(rng, genome: np.ndarray, n: int, rl: int):
    """n FR pairs of rl bp from fragments of INSERT_MEAN +- INSERT_SD,
    1% substitutions; in half of them the fragment comes from the reverse
    strand (mate 1 reads its right end reverse-complemented).  Returns
    (mate1, mate2 ASCII [n, rl], truth positions [2, n], is_reverse
    [2, n])."""
    flen = np.clip(np.rint(rng.normal(INSERT_MEAN, INSERT_SD, n)),
                   rl + 10, None).astype(np.int64)
    start = rng.integers(0, len(genome) - flen)
    left = start[:, None] + np.arange(rl)
    right = (start + flen - rl)[:, None] + np.arange(rl)
    lc = substitute(rng, np.searchsorted(ACGT, genome[left]), 0.01)
    rc = 3 - substitute(rng, np.searchsorted(ACGT, genome[right]),
                        0.01)[:, ::-1]
    swap = rng.random(n) < 0.5
    m1 = np.where(swap[:, None], rc, lc)
    m2 = np.where(swap[:, None], lc, rc)
    lpos, rpos = start, start + flen - rl
    truth = np.stack([np.where(swap, rpos, lpos), np.where(swap, lpos, rpos)])
    rev = np.stack([swap, ~swap])
    return ACGT[m1], ACGT[m2], truth, rev


def write_fastq(path: str, reads, prefix: bytes = b"r", head=None):
    """reads [n, L] ASCII as FASTQ named prefix + index; the first `head`
    records also go to path's `_head` twin.  Returns (path, head path)."""
    qual = b"I" * reads.shape[1]
    hp = path.replace(".fq", "_head.fq")
    with open(path, "wb") as f, open(hp, "wb") as h:
        for i, r in enumerate(reads):
            rec = b"@%s%d\n%s\n+\n%s\n" % (prefix, i, r.tobytes(), qual)
            f.write(rec)
            if head is not None and i < head:
                h.write(rec)
    return path, hp


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


def placement(body, truth, rev, tol: int = PLACE_TOL):
    """Reads placed within tol of the truth on the right strand.  With
    truth and rev of shape [2, n], records are mates, told apart by
    their 0x40 / 0x80 flags."""
    truth, rev = np.asarray(truth), np.asarray(rev)
    ok = 0
    for ln in body:
        f = ln.split("\t", 4)
        flag = int(f[1])
        i = int(f[0][1:])
        if flag & 4:
            continue
        if truth.ndim == 2:
            t, r = truth[0 if flag & 0x40 else 1, i], \
                rev[0 if flag & 0x40 else 1, i]
        else:
            t, r = truth[i], rev[i]
        if abs(int(f[3]) - 1 - t) <= tol and bool(flag & 16) == bool(r):
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


def time_ms(fn, reps: int, warm: int = 3) -> float:
    """Mean time of fn() on the stream over reps calls (CUDA events,
    after `warm` warm-up calls)."""
    import torch
    for _ in range(warm):
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


def bound_line(what: str, work: dict, ms: float, card: str) -> str:
    """One '# bound' line: the least time the card could take for this
    call's work (ops/bounds.py), what bounds it, and the share reached."""
    from smalt_tpu_torch.ops import bounds
    sh = bounds.share(work["bound_ms"], ms)
    if sh > 1:
        fail(f"{what}: {ms} ms is below its bound {work['bound_ms']} ms")
    return (f"# bound {what}: {work['cells']} cells, {work['bytes']} bytes; "
            f"bound {work['bound_ms']:.4f} ms by {work['bound_by']} "
            f"(operations {work['ops_ms']:.4f} ms at {bounds.OPS_PER_CELL} "
            f"ALU instructions a cell, {bounds.SMS} SMs x "
            f"{bounds.INT_LANES_PER_SM} lanes x {bounds.CLOCK_HZ / 1e9:.2f} GHz;"
            f" bytes {work['bytes_ms']:.4f} ms at "
            f"{bounds.MEM_BYTES_PER_S / 1e12:.2f} TB/s); kernel {ms:.4f} ms, "
            f"bound / kernel = {100 * sh:.1f}%, "
            f"{work['cells'] / ms / 1e6:.0f} GCUPS over these cells" +
            (f"; over every query column ({work['cells_all']} cells) bound "
             f"{work['bound_all_ms']:.4f} ms, "
             f"{100 * bounds.share(work['bound_all_ms'], ms):.1f}%"
             if work.get("cells_all", work["cells"]) != work["cells"]
             else "") + f" | {card}")


TIE_SHAPES = [(112, 128, 3 * BATCH), (128, 128, 6 * BATCH),
              (160, 256, 6 * BATCH)]


def check_ties(mat, go: int, ge: int, card: str):
    """Phase 3, tie-heavy windows: the tracked sw_full's first-argmax
    rule against sw_score_ref where the maximum is reached many times."""
    import torch
    from smalt_tpu_torch.ops import bounds, sw
    rng = np.random.default_rng(SEED + 7)
    for Q, S, B in TIE_SHAPES:
        q, s, sl = (torch.from_numpy(x).cuda()
                    for x in sw.tie_windows(rng, B, Q, S))
        got = sw.sw_full_cuda(q, s, sl, mat, go, ge, track=True)
        got0 = sw.sw_full_cuda(q, s, sl, mat, go, ge, track=False)
        want = sw.sw_score_ref(q, s, sl, mat.t, go, ge, track=True)
        torch.cuda.synchronize()
        errs = [int((g - w).abs().max()) for g, w in zip(got, want)]
        err0 = int((got0 - want[0]).abs().max())
        if max(errs + [err0]) != 0:
            bad = ((got[1] != want[1]) | (got[2] != want[2]) |
                   (got[0] != want[0])).nonzero().flatten()[:8].tolist()
            fail(f"sw_full differs from sw_score_ref on tie-heavy windows "
                 f"at Q={Q} S={S}: max |diff| best/ti/tj {errs}, score-only "
                 f"{err0}; windows {bad}")
        zero = int((want[0] == 0).sum())
        if zero < B // 16 or zero > B // 4:
            fail(f"degenerate tie windows at Q={Q} S={S}: {zero} score 0")
        k_ms = time_ms(lambda: sw.sw_full_cuda(q, s, sl, mat, go, ge,
                                               track=True), 20)
        print(f"# sw_full Q={Q} S={S} B={B}, tie-heavy windows: equal to "
              f"sw_score_ref (best, ti, tj and score-only; {zero} windows "
              f"score 0); track {k_ms:.4f} ms | {card}", flush=True)
        print(bound_line(f"sw_full_track Q={Q} S={S} B={B} ties",
                         bounds.sw_full_work(Q, S, sl, True), k_ms, card),
              flush=True)


def check_kernel(rng, card: str):
    """Phase 3: the kernel against its plain version, on the card.
    Returns (max_abs_err, tracked, score-only): for the tracked instance
    at the fast path's shape (the first) and the score-only one at the
    device-exact pool's (POOL_SHAPE), a dict of ms, plain_ms, bound_ms
    and bound_by."""
    import torch
    from smalt_tpu_torch.align import core as ali
    from smalt_tpu_torch.ops import bounds, sw
    m, go, ge = ali.make_score_matrix()
    go, ge = -go, -ge
    dev = torch.device("cuda")
    mat = sw.device_matrix(m, dev)
    worst = 0
    main = None
    for Q, S, B in KERNEL_SHAPES:
        q, s, sl = (torch.from_numpy(x).to(dev)
                    for x in kernel_windows(rng, B, Q, S))
        got = sw.sw_full_cuda(q, s, sl, mat, go, ge, track=True)
        got0 = sw.sw_full_cuda(q, s, sl, mat, go, ge, track=False)
        want = sw.sw_score_ref(q, s, sl, mat.t, go, ge, track=True)
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
        p_ms = time_ms(lambda: sw.sw_score_ref(q, s, sl, mat.t, go, ge,
                                               track=True), 3)
        cells = B * Q * S
        print(f"# sw_full Q={Q} S={S} B={B}: equal to sw_score_ref "
              f"(best, ti, tj and score-only); track {k_ms:.4f} ms "
              f"({cells / k_ms / 1e6:.1f} GCUPS), score-only "
              f"{k0_ms:.4f} ms ({cells / k0_ms / 1e6:.1f} GCUPS), plain "
              f"{p_ms:.3f} ms ({cells / p_ms / 1e6:.2f} GCUPS) | {card}",
              flush=True)
        wt, w0 = (bounds.sw_full_work(Q, S, sl, t) for t in (True, False))
        print(bound_line(f"sw_full_track Q={Q} S={S} B={B}", wt, k_ms, card))
        print(bound_line(f"sw_full Q={Q} S={S} B={B}", w0, k0_ms, card),
              flush=True)
        if (Q, S) in ((112, 128), (160, 256)):
            # as the mapping paths give it: every window at full length
            full = torch.full_like(sl, S)
            f_ms = time_ms(lambda: sw.sw_full_cuda(q, s, full, mat, go, ge,
                                                   track=True), 20)
            print(bound_line(f"sw_full_track Q={Q} S={S} B={B}, all {S} rows",
                             bounds.sw_full_work(Q, S, full, True), f_ms,
                             card), flush=True)
        if main is None:
            main = dict(ms=k_ms, plain_ms=p_ms, bound_ms=wt["bound_ms"],
                        bound_by=wt["bound_by"])
        if (Q, S, B) == POOL_SHAPE:
            pool = dict(ms=k0_ms, plain_ms=time_ms(
                lambda: sw.sw_score_ref(q, s, sl, mat.t, go, ge), 3),
                bound_ms=w0["bound_ms"], bound_by=w0["bound_by"])
    check_ties(mat, go, ge, card)
    return worst, main, pool


def check_wide_full(rng, card: str):
    """Phase 3, a matrix outside int8 (WIDE_PEN): the WIDE sw_full
    instances, tracked and score-only, against sw_score_ref, exactly, at
    WIDE_FULL_SHAPES on planted and tie-heavy windows.  Returns
    (max_abs_err, tracked, score-only) at the first shape, as
    check_kernel does."""
    import torch
    from smalt_tpu_torch.align import core as ali
    from smalt_tpu_torch.ops import bounds, sw
    m, go, ge = ali.make_score_matrix(*WIDE_PEN)
    go, ge = -go, -ge
    mat = sw.device_matrix(m, "cuda")
    if not mat.wide:
        fail(f"the matrix of {WIDE_PEN} fits int8")
    worst, main = 0, None
    for Q, S, B in WIDE_FULL_SHAPES:
        for kind, gen in (("planted", kernel_windows),
                          ("tie-heavy", sw.tie_windows)):
            q, s, sl = (torch.from_numpy(x).cuda() for x in gen(rng, B, Q, S))
            got = sw.sw_full_cuda(q, s, sl, mat, go, ge, track=True)
            got0 = sw.sw_full_cuda(q, s, sl, mat, go, ge, track=False)
            want = sw.sw_score_ref(q, s, sl, mat.t, go, ge, track=True)
            torch.cuda.synchronize()
            errs = [int((g - w).abs().max()) for g, w in zip(got, want)]
            err0 = int((got0 - want[0]).abs().max())
            worst = max(worst, *errs, err0)
            if max(errs + [err0]) != 0:
                fail(f"WIDE sw_full differs from sw_score_ref at Q={Q} S={S} "
                     f"({kind}): max |diff| best/ti/tj {errs}, score-only "
                     f"{err0}")
            if int(want[0].max()) <= 127:
                fail(f"degenerate wide-matrix windows at Q={Q} S={S}")
            k_ms = time_ms(lambda: sw.sw_full_cuda(q, s, sl, mat, go, ge,
                                                   track=True), 20)
            k0_ms = time_ms(lambda: sw.sw_full_cuda(q, s, sl, mat, go, ge,
                                                    track=False), 20)
            print(f"# sw_full WIDE Q={Q} S={S} B={B}, {kind} windows, "
                  f"entries {int(m.min())}..{int(m.max())}: equal to "
                  f"sw_score_ref (best, ti, tj and score-only; best up to "
                  f"{int(want[0].max())}); track {k_ms:.4f} ms, score-only "
                  f"{k0_ms:.4f} ms | {card}", flush=True)
            if main is None:
                wt, w0 = (bounds.sw_full_work(Q, S, sl, t)
                          for t in (True, False))
                print(bound_line(f"sw_full_track_wide Q={Q} S={S} B={B}", wt,
                                 k_ms, card))
                print(bound_line(f"sw_full_wide Q={Q} S={S} B={B}", w0,
                                 k0_ms, card), flush=True)
                main = (dict(ms=k_ms, plain_ms=time_ms(
                    lambda: sw.sw_score_ref(q, s, sl, mat.t, go, ge,
                                            track=True), 3),
                    bound_ms=wt["bound_ms"], bound_by=wt["bound_by"]),
                    dict(ms=k0_ms, plain_ms=time_ms(
                        lambda: sw.sw_score_ref(q, s, sl, mat.t, go, ge), 3),
                        bound_ms=w0["bound_ms"], bound_by=w0["bound_by"]))
    return (worst,) + main


def strip_mats():
    """{instance tag: (DeviceMatrix, go, ge)} of the strip path's matrices:
    int8, WIDE_PEN (WIDE)."""
    from smalt_tpu_torch.align import core as ali
    from smalt_tpu_torch.ops import sw
    mats = {}
    for tag, pen in (("", ()), ("_wide", WIDE_PEN)):
        m, go, ge = ali.make_score_matrix(*pen)
        mats[tag] = (sw.device_matrix(m, "cuda"), -go, -ge)
    if not mats["_wide"][0].wide:
        fail(f"the matrix of {WIDE_PEN} fits int8")
    return mats


@contextlib.contextmanager
def strip_route(one_warp_b: int):
    """ops/sw.py STRIP_ONE_WARP_B set to one_warp_b while open: 0 sends
    every strip call to the one-warp kernel, a number past any batch to the
    wavefront."""
    from smalt_tpu_torch.ops import sw
    kept = sw.STRIP_ONE_WARP_B
    sw.STRIP_ONE_WARP_B = one_warp_b
    try:
        yield
    finally:
        sw.STRIP_ONE_WARP_B = kept


STRIP_KERNELS = (("the wavefront", 1 << 40), ("the one-warp kernel", 0))


def strip_equal(q, s, sl, mat, go: int, ge: int, what: str):
    """full_equal on a strip call: the two calls must launch, once each,
    exactly the instances sw_full_instance names.  Returns the plain
    version's result."""
    from smalt_tpu_torch.ops import sw
    B, Q = q.shape
    S = s.shape[1]
    n, want, _ = full_equal(q, s, sl, mat, go, ge, what)
    names = {sw.sw_full_instance(B, Q, S, mat, t) for t in (True, False)}
    if n != {k: 1 for k in names}:
        fail(f"sw_full strips at {what}: launches {n}, one each of "
             f"{sorted(names)} expected")
    return want


def strip_launched(n: dict, want: str, what: str, least: int = 1) -> None:
    """Fail unless the launch counts n hold at least `least` launches of
    the strip instance `want` ("_strip" the wavefront, "_warp" the
    one-warp kernel, as sw_full_instance names them) and none of another
    strip instance."""
    other = {k: v for k, v in n.items()
             if v and k != want and ("_strip" in k or "_warp" in k)}
    if n[want] < least or other:
        fail(f"{what}: launched {n}; {least} or more of {want} and no other "
             f"strip instance expected")


def check_strip(rng, card: str):
    """Phase 3, queries past 512 columns: sw_full's strip wavefront,
    tracked and score-only, int8 and WIDE (WIDE_PEN), against
    sw_score_ref, exactly, at STRIP_SHAPES on STRIP_CHECK_B planted and
    tie-heavy windows, through the wavefront (its route at these batches)
    and, int8, the one-warp kernel (ops/sw.py STRIP_ONE_WARP_B lowered to
    0), each call launching the instance sw_full_instance names; then
    timed at STRIP_TIME (a full batch: the one-warp kernel's route on
    int8, the wavefront timed beside it; the wavefront's on WIDE and on
    the two-part record, entries of +-STRIP_REC_ENTRY, held equal to the
    plain version there), the plain version once on the same windows.
    Returns (max_abs_err, {instance: dict of ms, plain_ms, bound_ms,
    bound_by at STRIP_TIME, as routed})."""
    import torch
    from smalt_tpu_torch.align import core as ali
    from smalt_tpu_torch.ops import bounds, sw
    mats = strip_mats()
    for Q, S in STRIP_SHAPES:
        past = 0                      # best cells past the first strip
        for tag, (mat, go, ge) in mats.items():
            for kind, gen in (("planted", kernel_windows),
                              ("tie-heavy", sw.tie_windows)):
                q, s, sl = (torch.from_numpy(x).cuda()
                            for x in gen(rng, STRIP_CHECK_B, Q, S))
                # the one-warp kernel is int8 only
                for kernel, one_warp_b in STRIP_KERNELS[:1 + (not tag)]:
                    with strip_route(one_warp_b):
                        want = strip_equal(q, s, sl, mat, go, ge,
                                           f"Q={Q} S={S} ({kind}{tag}, "
                                           f"{kernel})")
                past += int((want[2] >= sw.MAX_Q).sum())
        if past == 0:
            fail(f"degenerate strip windows at Q={Q} S={S}: no best cell "
                 f"past the first strip")
        print(f"# sw_full strips Q={Q} S={S}, {STRIP_CHECK_B} windows each "
              f"of planted and tie-heavy, int8 and entries of {WIDE_PEN}, "
              f"the wavefront on {sw.strip_warps(STRIP_CHECK_B, Q, S)} warps "
              f"a window and the one-warp kernel (int8): equal to "
              f"sw_score_ref "
              f"(best, ti, tj and score-only; {past} best cells past column "
              f"512) | {card}", flush=True)
    Q, S, B = STRIP_TIME
    q, s, sl = (torch.from_numpy(x).cuda() for x in sw.tie_windows(rng, B, Q,
                                                                   S))
    out = {}
    m, go, ge = ali.make_score_matrix(STRIP_REC_ENTRY, -STRIP_REC_ENTRY)
    mats["_rec"] = (sw.device_matrix(m, "cuda"), -go, -ge)
    for tag, (mat, go, ge) in mats.items():
        for track in (True, False) if tag != "_rec" else (True,):
            name = sw.sw_full_instance(B, Q, S, mat, track)
            suffix = "_warp" if not tag else "_strip" + tag
            if name != "sw_full" + ("_track" if track else "") + suffix:
                fail(f"a batch of {B} windows at Q={Q} routed to {name}")
            if tag:
                got = sw.sw_full_cuda(q, s, sl, mat, go, ge, track=track)
                want = sw.sw_score_ref(q, s, sl, mat.t, go, ge, track=True)
                if not (all(torch.equal(a, b) for a, b in zip(got, want))
                        if track else torch.equal(got, want[0])):
                    fail(f"{name} Q={Q} S={S} B={B}: differs from "
                         f"sw_score_ref")
            k_ms = time_ms(lambda: sw.sw_full_cuda(q, s, sl, mat, go, ge,
                                                   track=track), 5)
            beside = ""
            if not tag:                 # the wavefront, not routed here
                with strip_route(1 << 40):
                    w_ms = time_ms(lambda: sw.sw_full_cuda(
                        q, s, sl, mat, go, ge, track=track), 5)
                beside = (f"; the wavefront on {sw.strip_warps(1, Q, S)} "
                          f"warps, not routed here, {w_ms:.4f} ms")
            p_ms = time_ms(lambda: sw.sw_score_ref(q, s, sl, mat.t, go, ge,
                                                   track=track), 1, warm=0)
            work = bounds.sw_full_work(Q, S, sl, track, q)
            print(bound_line(f"{name} Q={Q} S={S} B={B}, "
                             f"{sw.strip_warps(B, Q, S, bool(tag))} warp(s) "
                             f"a window (tie-heavy windows; plain "
                             f"{p_ms:.1f} ms{beside})", work, k_ms, card),
                  flush=True)
            out[name] = dict(shape=f"Q={Q} S={S} B={B}", ms=k_ms,
                             plain_ms=p_ms, bound_ms=work["bound_ms"],
                             bound_by=work["bound_by"])
    return 0, out


def qend_windows(rng, B: int, Q: int, S: int):
    """kernel_windows whose query ends (qend) cycle over STRIP_QENDS (pad
    code 7 from there on), each subject holding the query's last 3/4 of
    min(S, qend) real columns (the best cells near qend)."""
    q, s, sl = kernel_windows(rng, B, Q, S)
    ends = np.resize(np.minimum(STRIP_QENDS, Q), B)
    for b, e in enumerate(ends):
        q[b, e:] = 7
        q[b, :e][q[b, :e] == 7] = 1
        n = min(S, int(e)) * 3 // 4
        s[b, :n] = np.where(q[b, e - n: e] < 4, q[b, e - n: e], 2)
    sl = np.maximum(sl, np.minimum(S, ends * 3 // 4)).astype(np.int32)
    return q, s, sl, ends


def check_strip_qend(rng, card: str):
    """Phase 3, the strips of pad code alone: a batch of STRIP_QEND_SHAPE
    whose query ends cycle over STRIP_QENDS (512 k and 512 k + 1 among
    them, a window of pad code only), tracked and score-only, int8, WIDE
    (WIDE_PEN) and the two-part record (entries of +-STRIP_REC_ENTRY),
    against sw_score_ref exactly, each call launching the instance
    sw_full_instance names; then the int8 instances timed at
    STRIP_QEND_TIME, where the bound counts the cells inside the query
    (and the share over every column is printed beside it).  Returns (the
    max |diff| (0), {instance: dict of ms and bound_ms, bound_by over the
    cells inside the query, of the wavefront on 20 kb reads in Q 32,768})."""
    import torch
    from smalt_tpu_torch.align import core as ali
    from smalt_tpu_torch.ops import bounds, sw
    mats = strip_mats()
    m, go, ge = ali.make_score_matrix(STRIP_REC_ENTRY, -STRIP_REC_ENTRY)
    mats["_rec"] = (sw.device_matrix(m, "cuda"), -go, -ge)
    Q, S, B = STRIP_QEND_SHAPE
    if sw.sw_full_instance(B, Q, S, mats["_rec"][0], True) != \
            "sw_full_track_strip_rec":
        fail(f"entries of {STRIP_REC_ENTRY} at Q={Q} B={B} do not route to "
             f"the wavefront's _rec")
    q, s, sl, ends = qend_windows(rng, B, Q, S)
    if not np.array_equal(bounds.query_ends(q), ends):
        fail("qend_windows: the query ends are not the ones asked for")
    q, s, sl = (torch.from_numpy(x).cuda() for x in (q, s, sl))
    for tag, (mat, go, ge) in mats.items():
        # the one-warp kernel is int8 only
        for kernel, one_warp_b in STRIP_KERNELS[:1 + (not tag)]:
            with strip_route(one_warp_b):
                want = strip_equal(q, s, sl, mat, go, ge,
                                   f"Q={Q} S={S}, mixed query ends "
                                   f"({tag or 'int8'}, {kernel})")
        empty = want[0].cpu().numpy()[ends == 0]
        if empty.any():
            fail(f"a window of pad code only scored {empty}")
    print(f"# sw_full strips Q={Q} S={S} B={B}, query ends {STRIP_QENDS} "
          f"(a window runs ceil(qend / 512) strips): equal to sw_score_ref "
          f"(best, ti, tj and score-only), int8, entries of {WIDE_PEN} and "
          f"the two-part record (entries of +-{STRIP_REC_ENTRY}), the "
          f"wavefront, and the one-warp kernel on int8 | {card}", flush=True)
    mat, go, ge = mats[""]
    out = {}
    for Q, S, B, qend in STRIP_QEND_TIME:
        q, s, sl = kernel_windows(rng, B, Q, S)
        q[:, qend:] = 7
        q, s, sl = (torch.from_numpy(x).cuda() for x in (q, s, sl))
        for track in (True, False):
            k_ms = time_ms(lambda: sw.sw_full_cuda(q, s, sl, mat, go, ge,
                                                   track=track), 3)
            name = sw.sw_full_instance(B, Q, S, mat, track)
            work = bounds.sw_full_work(Q, S, sl, track, q)
            print(bound_line(f"{name} Q={Q} S={S} B={B}, reads of {qend} "
                             f"bp ({-(-qend // sw.MAX_Q)} of "
                             f"{-(-Q // sw.MAX_Q)} strips), "
                             f"{sw.strip_warps(B, Q, S)} warp(s) a window",
                             work, k_ms, card), flush=True)
            if name.endswith("_strip"):
                out[name] = dict(shape=f"Q={Q} S={S} B={B} qend={qend}",
                                 ms=k_ms, bound_ms=work["bound_ms"],
                                 bound_by=work["bound_by"])
    return 0, out


def far_windows(rng, B: int, Q: int, S: int):
    """Windows whose subject is a stretch of the query starting past its
    first half (4% substitutions, one indel run in four windows), so that
    the best cells, and the carry that reaches them, lie in the query's
    far strips; half the subject lengths below S."""
    q = rng.integers(0, 4, (B, Q)).astype(np.int32)
    off = rng.integers(Q // 2, Q - S + 1, B)
    s = np.take_along_axis(q, off[:, None] + np.arange(S)[None, :], 1)
    gap = (np.arange(B) % 4 == 0)[:, None] & (np.arange(S)[None, :] >=
                                              S // 2)
    s = np.where(gap, np.roll(s, 7, axis=1), s)
    mut = rng.random((B, S)) < 0.04
    s[mut] = rng.integers(0, 4, int(mut.sum()))
    slens = np.where(rng.random(B) < 0.5, S,
                     rng.integers(S // 2, S + 1, B)).astype(np.int32)
    s[np.arange(S)[None, :] >= slens[:, None]] = 7
    return q, s.astype(np.int32), slens


def full_equal(q, s, sl, mat, go: int, ge: int, what: str):
    """sw_full_cuda, tracked and score-only, against sw_score_ref on the
    same windows, exactly.  Returns (the launches the two calls made, the
    plain version's result, its time in ms)."""
    import torch
    from smalt_tpu_torch.ops import sw
    before = dict(sw.launches)
    got = sw.sw_full_cuda(q, s, sl, mat, go, ge, track=True)
    got0 = sw.sw_full_cuda(q, s, sl, mat, go, ge, track=False)
    n = {k: sw.launches[k] - before[k] for k in sw.launches
         if sw.launches[k] != before[k]}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = sw.sw_score_ref(q, s, sl, mat.t, go, ge, track=True)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    errs = [int((g - w).abs().max()) for g, w in zip(got, want)]
    err0 = int((got0 - want[0]).abs().max())
    if max(errs + [err0]) != 0:
        bad = ((got[0] != want[0]) | (got[1] != want[1]) |
               (got[2] != want[2]) | (got0 != want[0])).nonzero().flatten()
        fail(f"sw_full differs from sw_score_ref at {what}: max |diff| "
             f"best/ti/tj {errs}, score-only {err0}; windows "
             f"{bad[:8].tolist()}")
    return n, want, plain_ms


def check_strip_far(rng, card: str):
    """Phase 3, past 16,384 columns and past 2^23: the strip path at
    STRIP_FAR (int8 and WIDE_PEN, tracked and score-only, far-planted and
    tie-heavy windows) with ops/sw.py SCRATCH_BYTES lowered so that
    a call runs STRIP_FAR_GROUPS launches, then each instance timed with
    the module's budget (one launch) on the far-planted windows, the
    plain version once; then the two-part record (sw_full_track_rec,
    sw_full_track_strip_rec) at KEY_SHAPE, whose best scores pass 2^23,
    in registers (Q <= 512 windows cut from the same, under KEY_REG_PEN)
    and in strips (under KEY_PEN), timed on KEY_FULL_B copies of the
    windows.  All against
    sw_score_ref, exactly.  Returns (the max |diff| (0), {instance: its
    kernels-line entry})."""
    import torch
    from smalt_tpu_torch.align import core as ali
    from smalt_tpu_torch.ops import bounds, sw
    Q, S, B = STRIP_FAR
    budget = sw.SCRATCH_BYTES
    recs = {}
    for tag, pen in (("", ()), ("_wide", WIDE_PEN)):
        m, go, ge = ali.make_score_matrix(*pen)
        mat, go, ge = sw.device_matrix(m, "cuda"), -go, -ge
        for kind, gen in (("far-planted", far_windows),
                          ("tie-heavy", sw.tie_windows)):
            q, s, sl = (torch.from_numpy(x).cuda() for x in gen(rng, B, Q, S))
            sw.SCRATCH_BYTES = 8 * S * (B // STRIP_FAR_GROUPS)
            try:
                n, want, _ = full_equal(q, s, sl, mat, go, ge,
                                        f"Q={Q} S={S} ({kind}{tag})")
            finally:
                sw.SCRATCH_BYTES = budget
            if n != {f"sw_full_track_strip{tag}": STRIP_FAR_GROUPS,
                     f"sw_full_strip{tag}": STRIP_FAR_GROUPS}:
                fail(f"strips at Q={Q}: launches {n}, {STRIP_FAR_GROUPS} "
                     f"groups of each instance expected")
            far = int((want[2] >= 16384).sum())
            if kind == "far-planted" and far < B // 2:
                fail(f"degenerate far windows at Q={Q}: {far} best cells "
                     f"past column 16,384")
            print(f"# sw_full strips Q={Q} S={S} B={B}, {kind} windows"
                  f"{', entries ' + str(WIDE_PEN) if tag else ''}: equal to "
                  f"sw_score_ref (best, ti, tj and score-only; {far} best "
                  f"cells past column 16,384) in {STRIP_FAR_GROUPS} launches "
                  f"of {B // STRIP_FAR_GROUPS} windows each | {card}",
                  flush=True)
            if kind != "far-planted":
                continue
            for track in (True, False):
                name = sw.sw_full_instance(B, Q, S, mat, track)
                k_ms = time_ms(lambda: sw.sw_full_cuda(q, s, sl, mat, go, ge,
                                                       track=track), 3)
                p_ms = time_ms(lambda: sw.sw_score_ref(
                    q, s, sl, mat.t, go, ge, track=track), 1, warm=0)
                work = bounds.sw_full_work(Q, S, sl, track, q)
                print(bound_line(f"{name} Q={Q} S={S} B={B} (one launch, "
                                 f"{sw.strip_warps(B, Q, S)} warps a "
                                 f"window; plain {p_ms:.1f} ms)", work,
                                 k_ms, card), flush=True)
                recs[name] = dict(shape=f"Q={Q} S={S} B={B}", ms=k_ms,
                                  plain_ms=p_ms, bound_ms=work["bound_ms"],
                                  bound_by=work["bound_by"])
    Q, S, B = KEY_SHAPE
    q, s, sl = (torch.from_numpy(x).cuda() for x in
                kernel_windows(rng, B, Q, S))
    sl.fill_(S)
    for cut, pen in ((sw.MAX_Q, KEY_REG_PEN), (Q, KEY_PEN)):
        m, go, ge = ali.make_score_matrix(*pen)   # in registers, in strips
        mat, go, ge = sw.device_matrix(m, "cuda"), -go, -ge
        qc = q[:, :cut].contiguous()
        n, want, p_ms = full_equal(qc, s, sl, mat, go, ge,
                                   f"Q={cut} S={S}, entries {pen}")
        best = int(want[0].max())
        if best < sw.KEY_CAP:
            fail(f"degenerate key windows at Q={cut}: best {best} below "
                 f"2^23")
        name = next(k for k in n if "track" in k)
        if not name.endswith("_rec"):
            fail(f"Q={cut} S={S} under entries {pen} ran {name}, not the "
                 f"two-part record")
        # timed on copies of the windows, enough to fill the card
        rep = KEY_FULL_B // B
        qf, sf, slf = qc.repeat(rep, 1), s.repeat(rep, 1), sl.repeat(rep)
        got = sw.sw_full_cuda(qf, sf, slf, mat, go, ge, track=True)
        if not all(torch.equal(g, w.repeat(rep)) for g, w in zip(got, want)):
            fail(f"{name} Q={cut}: the {rep} copies of {B} windows differ "
                 f"from the plain version's result")
        k_ms = time_ms(lambda: sw.sw_full_cuda(qf, sf, slf, mat, go, ge,
                                               track=True), 2, warm=1)
        work = bounds.sw_full_work(cut, S, slf, True,
                                   qf if cut > sw.MAX_Q else None)
        print(f"# {name} Q={cut} S={S} B={B}, entries {pen}: equal to "
              f"sw_score_ref (best, ti, tj and score-only; best up to "
              f"{best}, 2^23 = {sw.KEY_CAP}), plain {p_ms:.1f} ms; repeated "
              f"to B={B * rep}: each copy equal | {card}", flush=True)
        print(bound_line(f"{name} Q={cut} S={S} B={B * rep} (scores past "
                         f"2^23)", work, k_ms, card), flush=True)
        # ms and bound_ms on the copies, plain_ms on the first B windows
        recs[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=work["bound_ms"],
                          bound_by=work["bound_by"], windows=B * rep,
                          plain_windows=B)
        del qf, sf, slf, got
    return 0, recs


def check_band_multi(rng, mat, go: int, ge: int, card: str):
    """Phase 3b, bands past 512 lanes: sw_band_multi_kernel against
    sw_band_score_ref at each BAND_MULTI band on BAND_MULTI_B planted and
    BAND_MULTI_B tie-heavy windows (every seventh with slen 0; the plain
    version timed on the planted ones), then those planted windows
    repeated to the shape's timed count, each copy's result equal to its
    original's, timed tracked and score-only beside the bound; the band
    widths BAND_MULTI_ODD; and the widest band routed to the kernel, W =
    TILED_BAND_W, on BAND_WIDEST.  Returns (max_abs_err, {W: (tracked,
    score-only)}) with dicts as check_band_kernel's, the kernel's times
    those of the timed batch."""
    import torch
    from smalt_tpu_torch.ops import bounds, sw
    err, recs = 0, {}
    for Q, Bt in BAND_MULTI:
        B = BAND_MULTI_B
        for kind, gen in (("tie-heavy", sw.band_tie_windows),
                          ("planted", sw.band_windows)):
            q, s, sl, pad, W, S = gen(rng, B, Q)
            sl[::7] = 0
            q, s, sl = (torch.from_numpy(x).cuda() for x in (q, s, sl))
            times = {}
            e, want = band_equal(q, s, sl, mat, go, ge, pad, W,
                                 f"Q={Q} W={W} S={S}, {kind}", times)
            err = max(err, e)
            if int(want[0].max()) <= (0 if kind == "tie-heavy" else Q // 4):
                fail(f"degenerate {kind} band windows at Q={Q}")
            print(f"# sw_band Q={Q} W={W} S={S} B={B}, {kind} windows, "
                  f"{(B + 6) // 7} with slen 0 "
                  f"({sw.sw_band_instance(Q, S, W, mat, True)}): equal to "
                  f"sw_band_score_ref (best, ti, tj and score-only); plain "
                  f"{times['plain']:.1f} ms tracked | {card}", flush=True)
        p_ms = times["plain"]
        rows = S // 8          # the score-only plain version on these rows
        p0_ms = time_ms(lambda: sw.sw_band_score_ref(
            q, s[:, :rows].contiguous(), torch.clamp_max(sl, rows), mat.t,
            go, ge, pad, W), 1, warm=0)
        rep = Bt // B
        qf, sf, slf = q.repeat(rep, 1), s.repeat(rep, 1), sl.repeat(rep)
        got = sw.sw_band_cuda(qf, sf, slf, mat, go, ge, pad, W, track=True)
        got0 = sw.sw_band_cuda(qf, sf, slf, mat, go, ge, pad, W, track=False)
        if not all(torch.equal(g, w.repeat(rep)) for g, w in zip(got, want)) \
                or not torch.equal(got0, want[0].repeat(rep)):
            fail(f"sw_band at Q={Q} W={W}: the {rep} copies of {B} windows "
                 f"differ from the plain version's result")
        k_ms = time_ms(lambda: sw.sw_band_cuda(qf, sf, slf, mat, go, ge, pad,
                                               W, track=True), 2, warm=1)
        k0_ms = time_ms(lambda: sw.sw_band_cuda(qf, sf, slf, mat, go, ge,
                                                pad, W, track=False), 2,
                        warm=1)
        Bf = B * rep
        print(f"# sw_band Q={Q} W={W} S={S}, the {B} planted windows repeated "
              f"to B={Bf}: each copy equal; track {k_ms:.4f} ms, score-only "
              f"{k0_ms:.4f} ms (tracked / score-only {k_ms / k0_ms:.3f}); "
              f"plain {p_ms:.1f} ms tracked on {B}, {p0_ms:.1f} ms "
              f"score-only on their first {rows} rows | {card}", flush=True)
        wt, w0 = (bounds.sw_band_work(Q, S, W, pad, slf, t)
                  for t in (True, False))
        names = [sw.sw_band_instance(Q, S, W, mat, t) for t in (True, False)]
        print(bound_line(f"{names[0]} Q={Q} W={W} S={S} B={Bf}", wt, k_ms,
                         card))
        print(bound_line(f"{names[1]} Q={Q} W={W} S={S} B={Bf}", w0, k0_ms,
                         card), flush=True)
        recs[W] = (dict(ms=k_ms, plain_ms=p_ms, bound_ms=wt["bound_ms"],
                        bound_by=wt["bound_by"], windows=Bf, plain_windows=B),
                   dict(ms=k0_ms, plain_ms=p0_ms, bound_ms=w0["bound_ms"],
                        bound_by=w0["bound_by"], windows=Bf, plain_windows=B,
                        plain_rows=rows))
        del qf, sf, slf, got, got0
    Q = BAND_MULTI_ODD_Q
    for kind, gen in (("planted", sw.band_windows),
                      ("tie-heavy", sw.band_tie_windows)):
        q, s, sl, pad, _, S = gen(rng, 64, Q)
        sl[::7] = 0
        q, s, sl = (torch.from_numpy(x).cuda() for x in (q, s, sl))
        for W in BAND_MULTI_ODD:
            err = max(err, band_equal(q, s, sl, mat, go, ge, pad, W,
                                      f"Q={Q} W={W} S={S}, {kind}")[0])
            print(f"# sw_band Q={Q} W={W} S={S} B=64, {kind} windows "
                  f"({sw.sw_band_instance(Q, S, W, mat, True)}): equal to "
                  f"sw_band_score_ref | {card}", flush=True)
    Qw, Sw, Bw = BAND_WIDEST
    q, s, sl, pad, W, _ = sw.band_windows(rng, Bw, Qw)
    s = np.ascontiguousarray(s[:, :Sw])
    sl = np.minimum(sl, Sw).astype(np.int32)
    q, s, sl = (torch.from_numpy(x).cuda() for x in (q, s, sl))
    if W != sw.TILED_BAND_W:
        fail(f"the band at Q={Qw} is {W} lanes, not {sw.TILED_BAND_W}")
    err = max(err, band_equal(q, s, sl, mat, go, ge, pad, W,
                              f"Q={Qw} W={W} S={Sw} (widest)")[0])
    print(f"# sw_band Q={Qw} W={W} (the widest band routed to the "
          f"several-warps kernel, {-(-W // 640)} warps of 20 lanes a "
          f"thread), first {Sw} subject rows, B={Bw}: equal to "
          f"sw_band_score_ref (best, ti, tj and score-only) | {card}",
          flush=True)
    return err, recs


def band_launched(before, names, what: str):
    """Fail unless the sw_band launches since `before` are exactly one of
    each name in `names`."""
    from smalt_tpu_torch.ops import sw
    n = {k: sw.launches[k] - before[k] for k in sw.launches
         if sw.launches[k] != before[k]}
    if n != {k: 1 for k in names}:
        fail(f"sw_band {what}: launches {n}")


def check_eterm(rng, card: str):
    """Phase 3b, the one-row-old E term of the band kernels' row exchange
    (a warp's posted total lacks its last lane's Ein; the E of the next
    warp's first lane from the row before corrects it): ops/sw.py
    eterm_windows at ETERM, whose best path takes a vertical gap into a
    warp's (or CTA's) last lane and a horizontal gap from it into the next
    warp, through sw_band_multi_kernel (its own route) and
    sw_band_cluster_kernel (TILED_BAND_W lowered to 0), tracked and
    score-only, against sw_band_score_ref, exactly; each window reaches
    its planted score.  Returns the max |diff| (0)."""
    import torch
    from smalt_tpu_torch.align import core as ali
    from smalt_tpu_torch.ops import sw
    m, go, ge = ali.make_score_matrix(*ETERM_PEN)
    go, ge = -go, -ge
    mat = sw.device_matrix(m, "cuda")
    tiled = sw.TILED_BAND_W
    for Q, rows, medges, cedges in ETERM:
        _, pad, W = sw.band_geometry(Q)
        for kernel, edges in (("sw_band_multi_kernel", medges),
                              ("sw_band_cluster_kernel", cedges)):
            q, s, sl, planted = sw.eterm_windows(
                rng, ETERM_B, Q, rows, pad, W, edges, ETERM_PEN[0], go, ge)
            t = [torch.from_numpy(x).cuda() for x in (q, s, sl)]
            if kernel == "sw_band_cluster_kernel":
                sw.TILED_BAND_W = 0
            try:
                _, want = band_equal(*t, mat, go, ge, pad, W,
                                     f"W={W}, E-term windows ({kernel})")
            finally:
                sw.TILED_BAND_W = tiled
            low = int((want[0].cpu().numpy() < planted).sum())
            if low:
                fail(f"E-term windows at W={W}: {low} below the planted "
                     f"score")
            print(f"# {kernel} W={W}, {ETERM_B} E-term windows (first lanes "
                  f"{edges}, penalties {ETERM_PEN}, {rows} rows): equal to "
                  f"sw_band_score_ref (best, ti, tj and score-only; best "
                  f"{want[0].min().item()}..{want[0].max().item()}, each at "
                  f"least its planted path's) | {card}", flush=True)
    return 0


def check_cluster_occupancy(card: str):
    """Phase 3b: cudaOccupancyMaxActiveClusters for every (CTAs, threads)
    shape ops/sw.py cluster_shape returns up to CLUSTER_MAX_W, tracked
    and score-only; fails where the card cannot place one."""
    from smalt_tpu_torch.ops import sw
    shapes = sorted({sw.cluster_shape(W)
                     for W in range(1, sw.CLUSTER_MAX_W + 1)})
    fewest = {}
    for ncta, nt in shapes:
        for track in (True, False):
            n = sw.cluster_occupancy(ncta, nt, track)
            if n < 1:
                fail(f"the card cannot place a cluster of {ncta} CTAs of "
                     f"{nt} threads (track {track})")
            fewest[ncta] = min(fewest.get(ncta, n), n)
    print(f"# sw_band_cluster_kernel: cudaOccupancyMaxActiveClusters over "
          f"the {len(shapes)} shapes cluster_shape returns, tracked and "
          f"score-only: every one placed; fewest clusters at once by CTAs "
          f"a cluster {fewest} | {card}", flush=True)


def check_band_past_16384(rng, mat, go: int, ge: int, card: str):
    """Phase 3b, bands past TILED_BAND_W: sw_band_cluster_kernel (a
    cluster of up to 16 CTAs a window, the row exchanged in distributed
    shared memory) and sw_band_strips_kernel (the band as column strips of
    512 across many CTAs a window) against sw_band_score_ref.  First with
    ops/sw.py TILED_BAND_W lowered to 0 and CLUSTER_BAND_W raised to
    CLUSTER_MAX_W, so that every band takes the cluster route, and then
    with CLUSTER_BAND_W lowered to 0, so that every band takes the strip
    route: the geometry of BIG_SMALL on planted and on tie-heavy windows
    and with the WIDE_PEN matrix (on their first BIG_SMALL_ROWS subject
    rows, a seventh of the windows with slen 0), and ODD_BAND_WIDTHS (a
    thread's or a strip's lanes past W); the cluster kernel also on
    CLUSTER_WIDE (16 CTAs, up to 512 threads).  Then the windows of
    R100K_N reads of R100K_LEN bp (band_windows: the mapping path's
    geometry, three windows a read) through both kernels (each route set
    as above), both timed beside the plain version (the score-only plain
    version on its first S / 16 rows: a minute a call at the full shape)
    and their bound.  Returns (max_abs_err, cluster tracked, cluster
    score-only, strips tracked, strips score-only) as check_band_kernel
    returns its kernel's, at that real shape."""
    import torch
    from smalt_tpu_torch.align import core as ali
    from smalt_tpu_torch.ops import bounds, sw
    err = 0
    thresh, cap = sw.TILED_BAND_W, sw.CLUSTER_BAND_W
    wm, wgo, wge = ali.make_score_matrix(*WIDE_PEN)
    wmat = sw.device_matrix(wm, "cuda")
    routes = (("cluster", "TILED_BAND_W lowered to 0", sw.CLUSTER_MAX_W),
              ("strips", "TILED_BAND_W and CLUSTER_BAND_W lowered to 0", 0))
    try:
        sw.TILED_BAND_W = 0
        for route, lowered, sw.CLUSTER_BAND_W in routes:
            names = ("sw_band_track_" + route, "sw_band_" + route)
            for Q, B in BIG_SMALL:
                kinds = (("planted", sw.band_windows, mat, go, ge),
                         ("tie-heavy", sw.band_tie_windows, mat, go, ge),
                         ("wide matrix", sw.band_windows, wmat, -wgo, -wge))
                for kind, gen, m, g_, e_ in kinds:
                    q, s, sl, pad, W, S = gen(rng, B, Q)
                    if S > BIG_SMALL_ROWS:  # the plain version: a row a step
                        S = BIG_SMALL_ROWS
                        s = np.ascontiguousarray(s[:, :S])
                        sl = np.minimum(sl, S).astype(np.int32)
                    sl[::7] = 0
                    q, s, sl = (torch.from_numpy(x).cuda() for x in (q, s, sl))
                    before = dict(sw.launches)
                    e, want = band_equal(q, s, sl, m, g_, e_, pad, W,
                                         f"Q={Q} W={W} S={S}, {kind} "
                                         f"({route})")
                    band_launched(before, names, f"with {lowered}")
                    if int(want[0].max()) <= 0:
                        fail(f"degenerate {kind} windows at Q={Q} ({route})")
                    err = max(err, e)
                    shape = (f"{sw.cluster_shape(W)} (CTAs, threads)"
                             if route == "cluster" else
                             f"{sw.BAND_STRIP_WARPS} strips of "
                             f"{sw.BAND_STRIP_W} columns a CTA")
                    print(f"# sw_band Q={Q} W={W} S={S} B={B}, {kind} "
                          f"windows, {B // 7 + 1} with slen 0, {lowered}, "
                          f"{shape}: sw_band_{route}_kernel equal to "
                          f"sw_band_score_ref (best, ti, tj and score-only) | "
                          f"{card}", flush=True)
            Q, B = ODD_BAND_Q, 256
            for kind, gen in (("planted", sw.band_windows),
                              ("tie-heavy", sw.band_tie_windows)):
                q, s, sl, pad, _, S = gen(rng, B, Q)
                q, s, sl = (torch.from_numpy(x).cuda() for x in (q, s, sl))
                for W in ODD_BAND_WIDTHS:
                    err = max(err, band_equal(q, s, sl, mat, go, ge, pad, W,
                                              f"Q={Q} W={W} S={S}, {kind} "
                                              f"({route})")[0])
                    print(f"# sw_band Q={Q} W={W} S={S} B={B}, {kind} "
                          f"windows, {lowered}: sw_band_{route}_kernel "
                          f"equal to sw_band_score_ref | {card}", flush=True)
            if route != "cluster":
                continue
            for W, B, rows in CLUSTER_WIDE:
                q, s, sl, pad, _, S = sw.band_windows(rng, B, W * 16 // 3)
                s = np.ascontiguousarray(s[:, :rows])
                sl = np.minimum(sl, rows).astype(np.int32)
                q, s, sl = (torch.from_numpy(x).cuda() for x in (q, s, sl))
                before = dict(sw.launches)
                err = max(err, band_equal(q, s, sl, mat, go, ge, pad, W,
                                          f"W={W}, first {rows} rows "
                                          f"(cluster)")[0])
                band_launched(before, names, f"at W={W}")
                print(f"# sw_band Q={q.shape[1]} W={W} B={B}, first {rows} "
                      f"subject rows, {sw.cluster_shape(W)} (CTAs, threads): "
                      f"sw_band_cluster_kernel equal to sw_band_score_ref | "
                      f"{card}", flush=True)
    finally:
        sw.TILED_BAND_W, sw.CLUSTER_BAND_W = thresh, cap
    Q = -(-R100K_LEN // 16) * 16
    B = 3 * R100K_N
    q, s, sl, pad, W, S = sw.band_windows(rng, B, Q)
    if not sw.TILED_BAND_W < W <= sw.CLUSTER_MAX_W:
        fail(f"the band of {R100K_LEN} bp reads is {W} lanes")
    q, s, sl = (torch.from_numpy(x).cuda() for x in (q, s, sl))
    times, ms = {}, {}
    want = None
    for route, _, sw.CLUSTER_BAND_W in routes:
        try:
            names = ("sw_band_track_" + route, "sw_band_" + route)
            before = dict(sw.launches)
            if want is None:
                e, want = band_equal(q, s, sl, mat, go, ge, pad, W,
                                     f"Q={Q} W={W} S={S} ({route})", times)
                err = max(err, e)
            else:
                got = sw.sw_band_cuda(q, s, sl, mat, go, ge, pad, W,
                                      track=True)
                got0 = sw.sw_band_cuda(q, s, sl, mat, go, ge, pad, W,
                                       track=False)
                if not all(torch.equal(g, w) for g, w in zip(got, want)) \
                        or not torch.equal(got0, want[0]):
                    fail(f"sw_band_{route}_kernel differs from "
                         f"sw_band_score_ref at Q={Q} W={W}")
            band_launched(before, names, f"at W={W} ({route})")
            ms[route] = [time_ms(lambda t=t: sw.sw_band_cuda(
                q, s, sl, mat, go, ge, pad, W, track=t), 3, warm=1)
                for t in (True, False)]
        finally:
            sw.CLUSTER_BAND_W = cap
    if int(want[0].max()) <= Q // 4:
        fail(f"degenerate band windows at Q={Q}")
    p_ms = times["plain"]
    rows = S // 16
    p0_ms = time_ms(lambda: sw.sw_band_score_ref(
        q, s[:, :rows].contiguous(), torch.clamp_max(sl, rows), mat.t, go,
        ge, pad, W), 1, warm=0)
    print(f"# sw_band Q={Q} W={W} S={S} B={B} (the windows of {R100K_N} "
          f"reads of {R100K_LEN} bp): sw_band_cluster_kernel "
          f"{sw.cluster_shape(W)} (CTAs, threads) and sw_band_strips_kernel "
          f"({sw.BAND_STRIP_WARPS} strips a CTA) equal to "
          f"sw_band_score_ref (best, ti, tj and score-only); cluster track "
          f"{ms['cluster'][0]:.1f} ms, score-only {ms['cluster'][1]:.1f} ms; "
          f"strips track {ms['strips'][0]:.1f} ms, score-only "
          f"{ms['strips'][1]:.1f} ms (3 calls each); plain {p_ms:.1f} ms "
          f"tracked, {p0_ms:.1f} ms score-only on the first {rows} rows | "
          f"{card}", flush=True)
    wt, w0 = (bounds.sw_band_work(Q, S, W, pad, sl, t) for t in (True, False))
    recs = []
    for route in ("cluster", "strips"):
        for k, (name, w) in enumerate(((f"sw_band_track_{route}", wt),
                                       (f"sw_band_{route}", w0))):
            print(bound_line(f"{name} Q={Q} W={W} S={S} B={B}", w,
                             ms[route][k], card), flush=True)
            rec = dict(ms=ms[route][k], plain_ms=p_ms, bound_ms=w["bound_ms"],
                       bound_by=w["bound_by"], windows=B)
            if "track" not in name:
                rec.update(plain_ms=p0_ms, plain_rows=rows)
            recs.append(rec)
    return (err, *recs)


def check_band_strips(rng, mat, go: int, ge: int, card: str):
    """Phase 3b, sw_band_strips_kernel at its own route (W past
    CLUSTER_BAND_W): the STRIPS_B windows of a read of STRIPS_READLEN bp
    (band_windows: W = 131,328), planted and tie-heavy, on their first
    STRIPS_ROWS subject rows (most band lanes there lie left of column 0:
    the strips not run, the first edge rows), and the first STRIPS_PAD0_B
    planted ones with pad 0 (prepad W / 2) on their first
    STRIPS_PAD0_ROWS rows, the last STRIPS_ROWS of which lie wholly inside
    the query (every strip's middle rows), each against
    sw_band_score_ref, exactly, tracked and
    score-only, each call launching the strip kernel alone; then the
    planted windows timed on all their rows (3 calls), with the bound.
    Then ops/sw.py eterm_windows at STRIPS_ETERM with CLUSTER_BAND_W
    lowered to 0 and the horizontal gap across query columns 256 (2 NW +
    1) (a strip edge inside a group: the ring) and 512 NW (a group edge:
    the carry in device memory), NW the warps a CTA.  Returns (max_abs_err, tracked, score-only) as
    check_band_kernel returns its kernel's: the time and bound on all
    rows, the plain version's on the pad-0 rows."""
    import torch
    from smalt_tpu_torch.align import core as ali
    from smalt_tpu_torch.ops import bounds, sw
    names = ("sw_band_track_strips", "sw_band_strips")
    err = 0
    full = None
    for kind, gen in (("planted", sw.band_windows),
                      ("tie-heavy", sw.band_tie_windows)):
        q, s, sl, pad, W, S = gen(rng, STRIPS_B, STRIPS_READLEN)
        if W <= sw.CLUSTER_BAND_W:
            fail(f"the band of {STRIPS_READLEN} bp reads is {W} lanes, not "
                 f"past CLUSTER_BAND_W")
        q, s, sl = (torch.from_numpy(x).cuda() for x in (q, s, sl))
        if kind == "planted":
            full = (q, s, sl, pad)
        cuts = [(pad, STRIPS_ROWS, STRIPS_B)]
        if kind == "planted":
            cuts.append((0, STRIPS_PAD0_ROWS, STRIPS_PAD0_B))
        for p_, rows, nb in cuts:
            sc = s[:nb, :rows].contiguous()
            slc = torch.clamp_max(sl[:nb], rows)
            times = {}
            before = dict(sw.launches)
            e, want = band_equal(q[:nb], sc, slc, mat, go, ge, p_, W,
                                 f"Q={STRIPS_READLEN} W={W}, first {rows} "
                                 f"rows, pad {p_}, {kind}", times)
            band_launched(before, names, f"at W={W}")
            if int(want[0].max()) <= 0:
                fail(f"degenerate {kind} windows at W={W}, pad {p_}")
            err = max(err, e)
            print(f"# sw_band Q={STRIPS_READLEN} W={W} S={S} B={nb}, "
                  f"{kind} windows, pad {p_} (prepad {p_ + W // 2}), first "
                  f"{rows} subject rows: sw_band_strips_kernel "
                  f"({sw.BAND_STRIP_WARPS} strips a CTA) equal "
                  f"to sw_band_score_ref (best, ti, tj and score-only; best "
                  f"{int(want[0].min())}..{int(want[0].max())}); plain "
                  f"{times['plain']:.1f} ms tracked | {card}", flush=True)
            if p_ == 0:
                p_ms, p_rows = times["plain"], rows
    q, s, sl, pad = full
    S = s.shape[1]
    k_ms = [time_ms(lambda t=t: sw.sw_band_cuda(
        q, s, sl, mat, go, ge, pad, W, track=t), 3, warm=1)
        for t in (True, False)]
    recs = []
    for k, name in enumerate(names):
        w = bounds.sw_band_work(STRIPS_READLEN, S, W, pad, sl, k == 0)
        print(bound_line(f"{name} Q={STRIPS_READLEN} W={W} S={S} "
                         f"B={STRIPS_B} (all rows)", w, k_ms[k], card),
              flush=True)
        recs.append(dict(ms=k_ms[k], plain_ms=p_ms, plain_rows=p_rows,
                         plain_pad=0, bound_ms=w["bound_ms"],
                         bound_by=w["bound_by"], windows=STRIPS_B))
    # the carry across a strip edge and a group edge
    m, ego, ege = ali.make_score_matrix(*ETERM_PEN)
    emat = sw.device_matrix(m, "cuda")
    Q, edges = STRIPS_ETERM
    S, pad, W = sw.band_geometry(Q)
    # a strip edge inside a group and a group edge, past the first strips
    # (the planted runs need room above them)
    nw, sw_ = sw.BAND_STRIP_WARPS, sw.BAND_STRIP_W
    cross = (sw_ * (2 * nw + 1), sw_ * 2 * nw)
    q, s, sl, planted = sw.eterm_windows(rng, ETERM_B, Q, S, pad, W, edges,
                                         ETERM_PEN[0], -ego, -ege, cross)
    t_ = [torch.from_numpy(x).cuda() for x in (q, s, sl)]
    cap = sw.CLUSTER_BAND_W
    sw.CLUSTER_BAND_W = 0
    try:
        before = dict(sw.launches)
        _, want = band_equal(*t_, emat, -ego, -ege, pad, W,
                             f"W={W}, E-term windows across query columns "
                             f"{cross} (strips)")
        band_launched(before, names, f"at W={W} (E-term windows)")
    finally:
        sw.CLUSTER_BAND_W = cap
    low = int((want[0].cpu().numpy() < planted).sum())
    if low:
        fail(f"E-term windows at W={W} (strips): {low} below the planted "
             f"score")
    print(f"# sw_band_strips_kernel W={W}, {ETERM_B} E-term windows (band "
          f"lanes {edges}, the horizontal gap across query columns {cross}: "
          f"a strip edge and a group edge at {nw} strips a CTA): equal to "
          f"sw_band_score_ref (best, ti, tj and score-only; best "
          f"{want[0].min().item()}..{want[0].max().item()}, each at least "
          f"its planted path's) | {card}", flush=True)
    return (err, *recs)


def check_wide_band(rng, card: str):
    """Phase 3b, a matrix outside int8 (WIDE_PEN): sw_band at the main
    path's Q = BAND_MAIN_Q, which sends such a matrix to the several-warps
    kernel (int32 lookups) at any band width, against sw_band_score_ref,
    exactly.  Returns (max_abs_err, tracked, score-only)."""
    import torch
    from smalt_tpu_torch.align import core as ali
    from smalt_tpu_torch.ops import bounds, sw
    m, go, ge = ali.make_score_matrix(*WIDE_PEN)
    go, ge = -go, -ge
    mat = sw.device_matrix(m, "cuda")
    Q, B = BAND_MAIN_Q, BATCH
    q, s, sl, pad, W, S = sw.band_windows(rng, B, Q)
    q, s, sl = (torch.from_numpy(x).cuda() for x in (q, s, sl))
    err, want = band_equal(q, s, sl, mat, go, ge, pad, W,
                           f"Q={Q} W={W} S={S}, entries {int(m.min())}.."
                           f"{int(m.max())}")
    if int(want[0].max()) <= 127:
        fail(f"degenerate wide-matrix band windows at Q={Q}")
    k_ms = time_ms(lambda: sw.sw_band_cuda(q, s, sl, mat, go, ge, pad, W,
                                           track=True), 5)
    k0_ms = time_ms(lambda: sw.sw_band_cuda(q, s, sl, mat, go, ge, pad, W,
                                            track=False), 5)
    p_ms = time_ms(lambda: sw.sw_band_score_ref(q, s, sl, mat.t, go, ge, pad,
                                                W, track=True), 1, warm=0)
    p0_ms = time_ms(lambda: sw.sw_band_score_ref(q, s, sl, mat.t, go, ge, pad,
                                                 W), 1, warm=0)
    print(f"# sw_band Q={Q} W={W} S={S} B={B}, entries {int(m.min())}.."
          f"{int(m.max())} (the several-warps kernel): equal to "
          f"sw_band_score_ref (best, ti, tj and score-only); track "
          f"{k_ms:.4f} ms, score-only {k0_ms:.4f} ms, plain {p_ms:.3f} ms | "
          f"{card}", flush=True)
    wt, w0 = (bounds.sw_band_work(Q, S, W, pad, sl, t) for t in (True, False))
    print(bound_line(f"sw_band_track_wide Q={Q} W={W} S={S} B={B}", wt, k_ms,
                     card))
    print(bound_line(f"sw_band_wide Q={Q} W={W} S={S} B={B}", w0, k0_ms,
                     card), flush=True)
    return (err, dict(ms=k_ms, plain_ms=p_ms, bound_ms=wt["bound_ms"],
                      bound_by=wt["bound_by"]),
            dict(ms=k0_ms, plain_ms=p0_ms, bound_ms=w0["bound_ms"],
                 bound_by=w0["bound_by"]))


def check_swq_pair(qa, sj, par, mat, go: int, ge: int, what: str,
                   tiles: int):
    """swq_cuda against swq_fill_walk_ref on the same windows, exactly.
    Returns the max |difference| over best, mi, mj and rec (0)."""
    import torch
    from smalt_tpu_torch.parallel import exact_pass2 as p2
    got = p2.swq_cuda(qa, sj, par, mat, go, ge, tiles)
    want = p2.swq_fill_walk_ref(qa, sj, par, mat.t, go, ge)
    torch.cuda.synchronize()
    errs = [int((g.to(torch.int32) - w).abs().max()) for g, w in
            zip(got, want)]
    if max(errs) != 0:
        bad = (got[3].to(torch.int32) != want[3]).any(dim=1)
        bad |= (got[0] != want[0]) | (got[1] != want[1]) | (got[2] != want[2])
        fail(f"swq differs from swq_fill_walk_ref on {what}: max |diff| "
             f"best/mi/mj/rec {errs}; windows "
             f"{bad.nonzero().flatten()[:8].tolist()}")
    return max(errs), want


def check_swq_kernel(rng, card: str):
    """Phase 3c: swq against its plain version on SWQ_SHAPES.  Returns
    (max_abs_err, dict of ms, plain_ms, bound_ms, bound_by at the
    main-path shape, the first)."""
    import torch
    from smalt_tpu_torch.align import core as ali
    from smalt_tpu_torch.ops import bounds, sw
    from smalt_tpu_torch.parallel import exact_pass2 as p2
    m, go, ge = ali.make_score_matrix()
    go, ge = -go, -ge
    dev = torch.device("cuda")
    mat = sw.device_matrix(m, dev)
    worst, main = 0, None
    for Qp, Sp, W in SWQ_SHAPES + [SWQ_WIDE]:
        qa, sj, par = p2.synth_windows(rng, W, Qp, Sp)
        if (Qp, Sp, W) == SWQ_WIDE:
            par[:, 1] = par[:, 0] + rng.integers(70, 251, W)
        tiles = p2.band_tiles(*(par[:, k] for k in (0, 1, 2, 3, 5)), Qp)
        qa, sj, par = (torch.from_numpy(x).to(dev) for x in (qa, sj, par))
        err, want = check_swq_pair(qa, sj, par, mat, go, ge,
                                   f"Qp={Qp} Sp={Sp} ({tiles} band tiles)",
                                   tiles)
        worst = max(worst, err)
        best = want[0]
        nz, n0 = int((best > 0).sum()), int((best == 0).sum())
        walked = int((want[3] != 0).any(dim=1).sum())
        if nz < W // 2 or n0 < W // 16:
            fail(f"degenerate swq windows at Qp={Qp} Sp={Sp}: {nz} with "
                 f"best > 0, {n0} with best 0")
        k_ms = time_ms(lambda: p2.swq_cuda(qa, sj, par, mat, go, ge, tiles),
                       20)
        p_ms = time_ms(lambda: p2.swq_fill_walk_ref(qa, sj, par, mat.t, go,
                                                    ge), 2, warm=1)
        cells = W * Qp * Sp
        print(f"# swq Qp={Qp} Sp={Sp} W={W}, bands up to {32 * tiles} "
              f"columns ({tiles} tiles): equal to swq_fill_walk_ref "
              f"(best, mi, mj, every rec row; {nz} windows with best > 0, "
              f"{n0} with best 0, {walked} with a record); kernel "
              f"{k_ms:.4f} ms ({cells / k_ms / 1e6:.1f} GCUPS over the full "
              f"frame), plain {p_ms:.3f} ms | {card}", flush=True)
        work = bounds.swq_work(Qp, Sp, par)
        print(bound_line(f"swq Qp={Qp} Sp={Sp} W={W} (in-band cells of the "
                         f"valid windows)", work, k_ms, card), flush=True)
        if main is None:
            main = dict(ms=k_ms, plain_ms=p_ms, bound_ms=work["bound_ms"],
                        bound_by=work["bound_by"])
        del qa, sj, par, want
    return worst, main


def timed(fn):
    """(fn(), the ms it took on the stream: CUDA events around one call)."""
    import torch
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def band_equal(q, s, sl, mat, go: int, ge: int, pad: int, W: int,
               what: str, times=None):
    """sw_band_cuda, tracked and score-only, against sw_band_score_ref on
    the same windows, exactly; the two calls must launch one each of the
    instances sw_band_instance names, and nothing else.  Returns (the max |difference| over best,
    ti, tj and the score-only best (0), the plain version's result).
    `times`, a dict, takes each call's ms ("track", "score", "plain"):
    where the plain version takes a minute, its one call is its timing."""
    from smalt_tpu_torch.ops import sw
    ms = {}
    before = dict(sw.launches)
    got, ms["track"] = timed(lambda: sw.sw_band_cuda(
        q, s, sl, mat, go, ge, pad, W, track=True))
    got0, ms["score"] = timed(lambda: sw.sw_band_cuda(
        q, s, sl, mat, go, ge, pad, W, track=False))
    band_launched(before, {sw.sw_band_instance(q.shape[1], s.shape[1], W,
                                               mat, t) for t in (True, False)},
                  f"at {what}")
    want, ms["plain"] = timed(lambda: sw.sw_band_score_ref(
        q, s, sl, mat.t, go, ge, pad, W, track=True))
    if times is not None:
        times.update(ms)
    errs = [int((g - w).abs().max()) for g, w in zip(got, want)]
    err0 = int((got0 - want[0]).abs().max())
    if max(errs + [err0]) != 0:
        bad = ((got[0] != want[0]) | (got[1] != want[1]) |
               (got[2] != want[2]) | (got0 != want[0])).nonzero().flatten()
        fail(f"sw_band differs from sw_band_score_ref at {what}: max |diff| "
             f"best/ti/tj {errs}, score-only {err0}; windows "
             f"{bad[:8].tolist()}")
    return max(errs + [err0]), want


def check_band_ties(rng, mat, go: int, ge: int, card: str):
    """Phase 3b, tie-heavy band windows: the tracked sw_band's
    first-argmax rule against sw_band_score_ref where the maximum is
    reached in many band lanes and rows."""
    import torch
    from smalt_tpu_torch.ops import bounds, sw
    for Q, B in BAND_TIE_SHAPES:
        q, s, sl, pad, W, S = sw.band_tie_windows(rng, B, Q)
        q, s, sl = (torch.from_numpy(x).cuda() for x in (q, s, sl))
        err, want = band_equal(q, s, sl, mat, go, ge, pad, W,
                               f"Q={Q} W={W} S={S}, tie-heavy windows")
        zero = int((want[0] == 0).sum())
        if zero < B // 16 or zero > B // 4:
            fail(f"degenerate band tie windows at Q={Q}: {zero} score 0")
        if not bool(((want[2] == -(pad + W // 2)) | (want[0] > 0)).all()):
            fail(f"a band tie window at Q={Q} scores 0 off (0, -prepad)")
        k_ms = time_ms(lambda: sw.sw_band_cuda(q, s, sl, mat, go, ge, pad, W,
                                               track=True), 20)
        print(f"# sw_band Q={Q} W={W} S={S} B={B}, tie-heavy windows: equal "
              f"to sw_band_score_ref (best, ti, tj and score-only; {zero} "
              f"windows score 0); track {k_ms:.4f} ms | {card}", flush=True)
        print(bound_line(f"sw_band_track Q={Q} W={W} S={S} B={B} ties",
                         bounds.sw_band_work(Q, S, W, pad, sl, True), k_ms,
                         card), flush=True)
    return err


def check_band_odd_widths(rng, mat, go: int, ge: int, card: str):
    """Phase 3b, band widths that are no multiple of 32 (through
    sw_band_cuda directly: the wrapper above it only makes multiples of
    128), where threads hold padding lanes past W."""
    import torch
    from smalt_tpu_torch.ops import sw
    Q, B = ODD_BAND_Q, ODD_BAND_B
    for kind, gen in (("planted", sw.band_windows),
                      ("tie-heavy", sw.band_tie_windows)):
        q, s, sl, pad, _, S = gen(rng, B, Q)
        q, s, sl = (torch.from_numpy(x).cuda() for x in (q, s, sl))
        for W in ODD_BAND_WIDTHS:
            err, want = band_equal(q, s, sl, mat, go, ge, pad, W,
                                   f"Q={Q} W={W} S={S}, {kind} windows")
            if int(want[0].max()) <= Q // 4:
                fail(f"degenerate {kind} windows at Q={Q} W={W}")
            print(f"# sw_band Q={Q} W={W} S={S} B={B}, {kind} windows: equal "
                  f"to sw_band_score_ref (best, ti, tj and score-only) | "
                  f"{card}", flush=True)
    return err


def check_band_long_subject(rng, mat, go: int, ge: int, card: str):
    """Phase 3b, a subject too long for the one-warp kernel's
    shared-memory profile (8 * (S + W) bytes a window): sw_band_launch
    hands such windows to the several-warps kernel, whose rolling profile
    does not grow with S; then a gap extension with (S + 1) * ge >= 2^28
    (BAND_BIG_GE), which it hands there too."""
    import torch
    from smalt_tpu_torch.ops import sw
    Q = ODD_BAND_Q
    q, s, sl, pad, W, S = sw.band_windows(rng, LONG_SUBJ_B, Q)
    tail = rng.integers(0, 4, (LONG_SUBJ_B, LONG_SUBJ_S - S), dtype=np.int32)
    s = np.concatenate([np.where(s == 7, 0, s), tail], axis=1)
    sl = np.full(LONG_SUBJ_B, LONG_SUBJ_S, np.int32)
    sl[0] = LONG_SUBJ_S // 2
    q, s, sl = (torch.from_numpy(x).cuda() for x in (q, s, sl))
    err, want = band_equal(q, s, sl, mat, go, ge, pad, W,
                           f"Q={Q} W={W} S={LONG_SUBJ_S}")
    if int(want[0].max()) <= Q // 4:
        fail(f"degenerate windows at Q={Q} S={LONG_SUBJ_S}")
    print(f"# sw_band Q={Q} W={W} S={LONG_SUBJ_S} B={LONG_SUBJ_B} (no room "
          f"for the one-warp kernel's profile: the several-warps kernel): "
          f"equal to sw_band_score_ref (best, ti, tj and score-only) | "
          f"{card}", flush=True)
    Q, S, W, pad, bge, B = BAND_BIG_GE
    bgo = bge
    # each query a stretch of its subject (2% substituted) on a diagonal
    # inside the band (prepad - W < row - column <= prepad)
    s = rng.integers(0, 4, (B, S), dtype=np.int32)
    off = rng.integers(pad + W // 2 - W + 16, pad + W // 2 - 16, B)
    q = np.stack([s[b, off[b]:off[b] + Q] for b in range(B)])
    q = np.where(rng.random((B, Q)) < 0.02, rng.integers(0, 4, (B, Q)), q)
    sl = np.full(B, S, np.int32)
    sl[1::2] = rng.integers(Q, S, B // 2)
    if (S + 1) * bge < 1 << 28:
        fail(f"(S + 1) * ge = {(S + 1) * bge} is below 2^28")
    q, s, sl = (torch.from_numpy(np.ascontiguousarray(x, np.int32)).cuda()
                for x in (q, s, sl))
    e, want = band_equal(q, s, sl, mat, bgo, bge, pad, W,
                         f"Q={Q} W={W} S={S}, go {bgo} ge {bge}")
    if int(want[0].max()) <= Q // 4:
        fail(f"degenerate windows at Q={Q} with ge {bge}")
    print(f"# sw_band Q={Q} W={W} S={S} B={B}, gap open {bgo}, extension "
          f"{bge} ((S + 1) * ge = {(S + 1) * bge} >= 2^28: the several-warps "
          f"kernel): equal to sw_band_score_ref (best, ti, tj and "
          f"score-only) | {card}", flush=True)
    return max(err, e)


def check_band_kernel(rng, card: str):
    """Phase 3b: sw_band (tracked and score-only) against its plain
    version sw_band_score_ref, on the card.  Returns (max_abs_err,
    tracked, score-only, many tracked, many score-only): dicts of ms,
    plain_ms, bound_ms and bound_by at the main-path shape Q =
    BAND_MAIN_Q, and at BAND_MANY_Q's band (check_band_multi)."""
    import torch
    from smalt_tpu_torch.align import core as ali
    from smalt_tpu_torch.ops import bounds, sw
    m, go, ge = ali.make_score_matrix()
    go, ge = -go, -ge
    dev = torch.device("cuda")
    mat = sw.device_matrix(m, dev)
    worst = 0
    main = None
    for Q, B in BAND_SHAPES:
        q, s, sl, pad, W, S = sw.band_windows(rng, B, Q)
        q, s, sl = (torch.from_numpy(x).to(dev) for x in (q, s, sl))
        err, want = band_equal(q, s, sl, mat, go, ge, pad, W,
                               f"Q={Q} W={W} S={S}")
        worst = max(worst, err)
        if int(want[0].max()) <= 0:
            fail(f"degenerate band windows at Q={Q}")
        reps = 5 if B * W * S > 2e10 else 20
        k_ms = time_ms(lambda: sw.sw_band_cuda(q, s, sl, mat, go, ge, pad, W,
                                               track=True), reps)
        k0_ms = time_ms(lambda: sw.sw_band_cuda(q, s, sl, mat, go, ge, pad,
                                                W, track=False), reps)
        # the plain version takes seconds a call: one call (it ran once
        # already, for `want`)
        p_ms = time_ms(lambda: sw.sw_band_score_ref(
            q, s, sl, mat.t, go, ge, pad, W, track=True), 1, warm=0)
        cells = B * W * S
        print(f"# sw_band Q={Q} W={W} S={S} B={B}: equal to "
              f"sw_band_score_ref (best, ti, tj and score-only); track "
              f"{k_ms:.4f} ms ({cells / k_ms / 1e6:.1f} GCUPS), score-only "
              f"{k0_ms:.4f} ms ({cells / k0_ms / 1e6:.1f} GCUPS), plain "
              f"{p_ms:.3f} ms ({cells / p_ms / 1e6:.2f} GCUPS) | {card}",
              flush=True)
        wt, w0 = (bounds.sw_band_work(Q, S, W, pad, sl, t)
                  for t in (True, False))
        print(bound_line(f"sw_band_track Q={Q} W={W} S={S} B={B} (band cells "
                         f"inside the query)", wt, k_ms, card))
        print(bound_line(f"sw_band Q={Q} W={W} S={S} B={B}", w0, k0_ms, card),
              flush=True)
        if Q == BAND_MAIN_Q:
            main = (dict(ms=k_ms, plain_ms=p_ms, bound_ms=wt["bound_ms"],
                         bound_by=wt["bound_by"]),
                    dict(ms=k0_ms, plain_ms=time_ms(
                        lambda: sw.sw_band_score_ref(q, s, sl, mat.t, go, ge,
                                                     pad, W), 1, warm=0),
                         bound_ms=w0["bound_ms"], bound_by=w0["bound_by"]))
        del q, s, sl, want
    worst = max(worst, check_band_ties(rng, mat, go, ge, card),
                check_band_odd_widths(rng, mat, go, ge, card),
                check_band_long_subject(rng, mat, go, ge, card))
    merr, multi = check_band_multi(rng, mat, go, ge, card)
    W = sw.band_geometry(BAND_MANY_Q)[2]
    return (max(worst, merr),) + main + multi[W]


def run_main_path(d: str, device: str, n_reads: int, genome_len: int,
                  card: str = "n/a"):
    """Phase 4: `map --fast` through the CLI on `device`, checked.
    Returns the kernel launch counts of the main-path run."""
    import torch
    from smalt_tpu_torch import cli
    from smalt_tpu_torch.index.table import KmerIndex
    from smalt_tpu_torch.map.fastmode import (RawBatch, encode_batch,
                                              get_device_step,
                                              iter_fastq_hybrid)
    from smalt_tpu_torch.seq.refset import RefSet

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
    launches, wall, m = map_cli(device, idx_name, sam, [fq], BATCH)
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


def ptxas_summary(log: str, kernel: str = "") -> str:
    """ptxas -v output as 'registers per instance <template args>' and the
    spill bytes over all instances (of `kernel` alone, where given)."""
    regs, spills, cur = [], 0, "?"
    for ln in log.splitlines():
        m = re.search(r"\d([a-z_]+)_kernelI(\w+?)EEv", ln)
        if "Compiling entry function" in ln:
            cur = m.group(1) + " " + ",".join(
                re.findall(r"L[ib](\d+)", m.group(2))) if m else "?"
        if not cur.startswith(kernel):
            continue
        if "registers" in ln:
            regs.append(f"<{cur}>:{re.search(r'Used (\d+) reg', ln).group(1)}")
        elif "spill" in ln:
            spills += sum(int(x) for x in re.findall(r"(\d+) bytes spill", ln))
    return f"registers {' '.join(regs)}; spill bytes {spills}"


def cli_run(argv, **env):
    """The port's CLI in this process with `env` set (a value of None
    unsets) and stderr caught, the launch counts set to 0 just before and
    read just after (ops/sw.py's and segcand's).  Returns (exit code,
    stderr text, launches, wall seconds)."""
    from smalt_tpu_torch import cli
    from smalt_tpu_torch.ops import sw
    from smalt_tpu_torch.parallel import exact_collate as ec
    saved = {k: os.environ.get(k) for k in env}
    err = io.StringIO()
    try:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for k in sw.launches:
            sw.launches[k] = 0
        ec.launches["segcand"] = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        wall = time.perf_counter() - t0
        launches = dict(sw.launches, segcand=ec.launches["segcand"])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return rc, err.getvalue(), launches, wall


def map_cli(device: str, idx_name: str, sam: str, reads, batch: int,
            extra=()):
    """`map --fast` through the port's CLI with the launch counts set to
    0 just before and read just after.  reads: [fq] or [fq, mates];
    extra: more options (-S).  Returns (launches, wall seconds, the
    SMALT_TIMING match, whose .string is the run's stderr)."""
    rc, err, launches, wall = cli_run(
        ["map", "--fast", "-f", "sam", "-o", sam, "--device", device] +
        list(extra) + [idx_name] + list(reads), SMALT_TIMING="1",
        SMALT_FAST_BATCH=str(batch))
    sys.stderr.write(err)
    if rc != 0:
        fail(f"map --fast on {device} ({reads}) exited {rc}")
    m = re.search(r"fast pipeline: (\d+) reads in (\d+) batches, "
                  r"([\d.]+) s \((\d+) reads/s\)", err)
    return launches, wall, m


def batch_split(what: str, idx_name: str, item, paired: bool, device: str,
                card: str, check_cpu: bool = False, pad_to: int = 0,
                reps: int = 5):
    """One batch of a mapping phase, outside the CLI run (so its launches
    are not counted there): the device step's time (CUDA events over
    `reps` calls) against the host tail's (one call of the pipeline's
    tail).  With check_cpu, the packed step output must also equal the CPU
    step's on the same batch.  pad_to: the step also timed on the batch
    padded to that many rows with all-7 pad reads, as the pipeline pads
    its last batch.  Returns (step ms, padded step ms or None, tail ms)."""
    import torch
    from smalt_tpu_torch.index.table import KmerIndex
    from smalt_tpu_torch.map.fastmode import (RawBatch, _tail_init,
                                              _tail_render, encode_batch,
                                              get_device_step)
    from smalt_tpu_torch.parallel.mesh import (OUT_KEYS, window_len,
                                               window_pad)
    from smalt_tpu_torch.seq.refset import RefSet
    refset, idx = RefSet.load(idx_name), KmerIndex.load(idx_name)
    raw = isinstance(item, RawBatch)
    n = item.n if raw else len(item[0])
    qmax = int(item.seq_len.max()) if raw else max(len(x) for x in item[1])
    Q = max(32, -(-qmax // 16) * 16)
    arr = torch.from_numpy(item.encode(Q) if raw
                           else encode_batch(item[1], Q)).to(device)
    step = get_device_step(refset, idx, device, (1, -2, -4, -3))
    step_ms = time_ms(lambda: step(arr), reps)
    pad_ms = None
    if pad_to > n:
        padded = torch.full((pad_to, Q), 7, dtype=arr.dtype, device=device)
        padded[:n] = arr
        pad_ms = time_ms(lambda: step(padded), reps, warm=1)
        if not torch.equal(step(padded)[:, :n].cpu(), step(arr).cpu()):
            fail(f"{what}: the step's output on the real reads changes with "
                 f"{pad_to - n} pad reads in the batch")
        del padded
    packed = step(arr).cpu()
    if check_cpu:
        packed_cpu = get_device_step(refset, idx, "cpu", (1, -2, -4, -3))(
            arr.cpu())
        if not torch.equal(packed, packed_cpu):
            bad = (packed != packed_cpu).any(dim=1).nonzero().flatten()
            fail(f"{what}: packed step output differs from the CPU path in "
                 f"rows {bad.tolist()} (OUT_KEYS order)")
        print(f"# {what}: packed [12, {n}] step output equal to the CPU "
              f"path", flush=True)
    packed = packed.numpy()
    outs = {k: packed[i, :n] for i, k in enumerate(OUT_KEYS)}
    _tail_init(refset, (1, -2, -4, -3), 18, (True, False))
    t0 = time.perf_counter()
    _tail_render((paired, item, outs, window_len(Q), window_pad(Q), Q, 0))
    tail_ms = 1e3 * (time.perf_counter() - t0)
    padded = "" if pad_ms is None else \
        f", {pad_ms:.3f} ms padded to {pad_to} rows"
    print(f"# {what}, one batch of {n} reads (Q={Q}): device step "
          f"{step_ms:.3f} ms{padded} (CUDA events, {reps} calls), host tail "
          f"{tail_ms:.1f} ms (one call) | {card}", flush=True)
    return step_ms, pad_ms, tail_ms


def import_seconds(module: str) -> float:
    """Seconds a fresh interpreter takes to import `module`."""
    r = subprocess.run(
        [sys.executable, "-c", "import time; t = time.perf_counter(); "
         f"import {module}; print(time.perf_counter() - t)"],
        capture_output=True, text=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT))
    if r.returncode != 0:
        fail(f"import {module} in a fresh process: {r.stderr[-300:]}")
    return float(r.stdout)


def pool_run(what: str, device: str, idx_name: str, reads, body, n: int,
             wall1: float, m1, card: str):
    """The mapping run of a phase again with the tail pool (-n POOL_N):
    SAM byte-identical to the -n 1 run's `body`; both runs' reads/s (CLI
    and pipeline) and their ratio, which compare only inside one call,
    and the pool's own timing line.  Returns the pooled run's
    launches."""
    sam = os.path.join(os.path.dirname(idx_name), f"{what[:4]}_n{POOL_N}.sam")
    launches, wall, m = map_cli(device, idx_name, sam, reads, BATCH,
                                ["-n", str(POOL_N)])
    if sam_body(sam) != body:
        fail(f"{what}: SAM of -n {POOL_N} differs from -n 1")
    p1, pn = (int(x.group(4)) if x else 0 for x in (m1, m))
    pool = re.search(r"tail pool: .*", m.string) if m else None
    print(f"# map --fast, {what}, -n {POOL_N} (spawned tail workers): SAM "
          f"byte-identical to -n 1; CLI {n / wall:.1f} reads/s against "
          f"{n / wall1:.1f} at -n 1 ({wall1 / wall:.2f}x), pipeline {pn} "
          f"reads/s against {p1} ({pn / max(p1, 1):.2f}x); "
          f"{pool.group(0) if pool else 'no tail pool line'}; launches "
          f"{launches} | {card}", flush=True)
    return launches


def run_long_reads(d: str, genome, card: str, device: str = "cuda"):
    """Phase 5: kilobase reads on the phase-4 genome and index."""
    from smalt_tpu_torch.map.fastmode import iter_fastq_hybrid
    idx_name = os.path.join(d, "idx")
    rng = np.random.default_rng(SEED + 1)
    t0 = time.perf_counter()
    reads, truth, rev = make_long_reads(rng, genome, N_LONG, LONG_READLEN)
    fq, fq_head = write_fastq(os.path.join(d, "long.fq"), reads, b"L",
                              LONG_HEAD)
    print(f"# long-read data: {time.perf_counter() - t0:.2f} s ({N_LONG} "
          f"reads of {LONG_READLEN} bp, 1% substitutions + 1.5% indels)",
          flush=True)
    sam = os.path.join(d, f"long_{device}.sam")
    launches, wall, m = map_cli(device, idx_name, sam, [fq], BATCH)
    body = sam_body(sam)
    if len(body) != N_LONG:
        fail(f"{len(body)} SAM records for {N_LONG} long reads")
    placed = placement(body, truth, rev, LONG_TOL)
    print(f"# map --fast, long reads on {device}: {N_LONG} reads in {wall:.3f} s "
          f"end to end ({N_LONG / wall:.1f} reads/s incl. index load and "
          f"upload); pipeline {m.group(4) if m else '?'} reads/s "
          f"({m.group(3) if m else '?'} s, {m.group(2) if m else '?'} "
          f"batches); placed {placed}/{N_LONG} ({placed / N_LONG:.4f}) "
          f"within {LONG_TOL} bp; launches {launches} | {card}", flush=True)
    if device == "cuda" and launches["sw_band_track"] < 1:
        fail("the long-read path never launched the sw_band kernel")
    if launches["sw_full_track"] != 0:
        fail("the long-read path launched sw_full")
    if placed < MIN_LONG * N_LONG:
        fail(f"only {placed}/{N_LONG} long reads placed within {LONG_TOL} bp")
    # what a tail worker's start costs: it imports map/fastmode.py (and
    # the host layers), not torch
    print(f"# import in a fresh process: smalt_tpu_torch.map.fastmode (a "
          f"tail worker's) {import_seconds('smalt_tpu_torch.map.fastmode'):.2f}"
          f" s, torch {import_seconds('torch'):.2f} s | {card}", flush=True)
    pooled = pool_run("long reads", device, idx_name, [fq], body, N_LONG,
                      wall, m, card)

    batch_split("long reads", idx_name, next(iter(iter_fastq_hybrid(
        fq, BATCH))), False, device, card)
    sam_cpu = os.path.join(d, "long_head_cpu.sam")
    t0 = time.perf_counter()
    map_cli("cpu", idx_name, sam_cpu, [fq_head], LONG_HEAD)
    if sam_body(sam_cpu) != body[:LONG_HEAD]:
        fail(f"SAM of the first {LONG_HEAD} long reads differs from the "
             f"CPU path")
    print(f"# SAM of the first {LONG_HEAD} long reads byte-identical to "
          f"--device cpu ({time.perf_counter() - t0:.1f} s on the CPU)",
          flush=True)
    return launches, pooled


def run_mid_reads(d: str, genome, card: str):
    """Phase 5b, on the phase-4 genome and index: N_MID reads of
    MID_READLEN bp (phase 5's generator; the several-warps kernel's band)
    through `map --fast -n POOL_N` on the card at the default batch, the
    first MID_HEAD records byte-identical to `--device cpu` on those reads,
    placement printed, and that batch's device step (on the reads and
    padded to BATCH rows) beside its host tail.  Returns the launches of
    the card's run."""
    from smalt_tpu_torch.map.fastmode import iter_fastq_hybrid
    from smalt_tpu_torch.ops import sw
    idx_name = os.path.join(d, "idx")
    rng = np.random.default_rng(SEED + 5)
    reads, truth, rev = make_long_reads(rng, genome, N_MID, MID_READLEN)
    fq, fq_head = write_fastq(os.path.join(d, "mid.fq"), reads, b"m",
                              MID_HEAD)
    del reads
    sams = [os.path.join(d, f"mid_{dev}.sam") for dev in ("cuda", "cpu")]
    t0 = time.perf_counter()
    launches, wall, m = map_cli("cuda", idx_name, sams[0], [fq], BATCH,
                                ["-n", str(POOL_N)])
    t1 = time.perf_counter()
    map_cli("cpu", idx_name, sams[1], [fq_head], MID_HEAD)
    body = sam_body(sams[0])
    if len(body) != N_MID or body[:MID_HEAD] != sam_body(sams[1]):
        fail(f"--fast on {MID_READLEN} bp reads: SAM differs from --device "
             f"cpu")
    Q = -(-MID_READLEN // 16) * 16
    W = sw.band_geometry(Q)[2]
    if not sw.WARP_BAND_W < W <= sw.MULTI_BAND_W or \
            launches["sw_band_track"] < 1 or \
            sum(launches.values()) != launches["sw_band_track"]:
        fail(f"--fast on {MID_READLEN} bp reads (W = {W}) launched "
             f"{launches}")
    placed = placement(body, truth, rev, LONG_TOL)
    print(f"# map --fast -n {POOL_N} on {N_MID} reads of {MID_READLEN} bp "
          f"(W = {W}, batch {BATCH}): the first {MID_HEAD} records "
          f"byte-identical to --device cpu ({t1 - t0:.1f} s on the card, "
          f"{N_MID / wall:.1f} CLI reads/s, pipeline "
          f"{m.group(4) if m else '?'} reads/s; "
          f"{time.perf_counter() - t1:.1f} s on the CPU for {MID_HEAD}); "
          f"placed {placed}/{N_MID} within {LONG_TOL} bp; launches "
          f"{launches} | {card}", flush=True)
    batch_split(f"--fast {N_MID} x {MID_READLEN} bp", idx_name,
                next(iter(iter_fastq_hybrid(fq, BATCH))), False, "cuda", card,
                pad_to=BATCH, reps=3)
    return launches


def run_pairs(d: str, genome, card: str, device: str = "cuda"):
    """Phase 6: paired reads on the phase-4 genome and index."""
    from smalt_tpu_torch.map.fastmode import iter_fastq_batches
    idx_name = os.path.join(d, "idx")
    rng = np.random.default_rng(SEED + 2)
    t0 = time.perf_counter()
    m1, m2, truth, rev = make_pairs(rng, genome, N_PAIRS, PAIR_READLEN)
    fq1, h1 = write_fastq(os.path.join(d, "pairs_1.fq"), m1, b"p",
                          PAIR_HEAD)
    fq2, h2 = write_fastq(os.path.join(d, "pairs_2.fq"), m2, b"p",
                          PAIR_HEAD)
    print(f"# pair data: {time.perf_counter() - t0:.2f} s ({N_PAIRS} pairs "
          f"of 2 x {PAIR_READLEN} bp, inserts {INSERT_MEAN} +- {INSERT_SD}, "
          f"FR, 1% substitutions)", flush=True)
    sam = os.path.join(d, f"pairs_{device}.sam")
    launches, wall, m = map_cli(device, idx_name, sam, [fq1, fq2], BATCH)
    body = sam_body(sam)
    nm = 2 * N_PAIRS
    if len(body) != nm:
        fail(f"{len(body)} SAM records for {nm} mates")
    placed = placement(body, truth, rev)
    proper = sum(1 for ln in body if int(ln.split("\t", 2)[1]) & 2)
    print(f"# map --fast, pairs on {device}: {N_PAIRS} pairs in {wall:.3f} s end "
          f"to end ({nm / wall:.1f} reads/s incl. index load and upload); "
          f"pipeline {m.group(4) if m else '?'} reads/s "
          f"({m.group(3) if m else '?'} s, {m.group(2) if m else '?'} "
          f"batches); mates placed {placed}/{nm} ({placed / nm:.4f}) within "
          f"{PLACE_TOL} bp; proper pair {proper}/{nm} ({proper / nm:.4f}); "
          f"launches {launches} | {card}", flush=True)
    if device == "cuda" and launches["sw_full_track"] < 1:
        fail("the paired path never launched the sw_full kernel")
    if placed < MIN_PLACED * nm:
        fail(f"only {placed}/{nm} mates placed within {PLACE_TOL} bp")
    pooled = pool_run("pairs", device, idx_name, [fq1, fq2], body, nm, wall,
                      m, card)
    (n1, s1, q1), (n2, s2, q2) = (next(iter_fastq_batches(f, BATCH))
                                  for f in (fq1, fq2))
    batch_split("pairs", idx_name, (n1 + n2, s1 + s2, q1 + q2), True,
                device, card, check_cpu=True)
    sam_cpu = os.path.join(d, "pairs_head_cpu.sam")
    t0 = time.perf_counter()
    map_cli("cpu", idx_name, sam_cpu, [h1, h2], BATCH)
    if sam_body(sam_cpu) != body[: 2 * PAIR_HEAD]:
        fail(f"SAM of the first {PAIR_HEAD} pairs differs from the CPU path")
    print(f"# SAM of the first {PAIR_HEAD} pairs byte-identical to --device "
          f"cpu ({time.perf_counter() - t0:.1f} s on the CPU)", flush=True)
    return launches, pooled


def lane_pass2_batch(dev, raw):
    """One batch `raw` through a DeviceExact lane with pass 2 on, up to
    its pass-2 step: (host, dargs, collate outputs, wd, Sp, nw, tiles)."""
    host, dargs = dev._prepare(*raw)
    outs = dev._collate_outputs(dargs)
    item, _ = dev._post_batch(host, outs)
    wd, _, Sp, nw, tiles = dev._p2_args(item[-1][2])
    return host, dargs, outs, wd, Sp, nw, tiles


COLLATE_OUTS = ("pool", "counts2", "scores", "fallback")
DEVICE_HIT_OUTS = ("pool", "counts2", "scores", "cksum", "fallback")


def collate_equal(outs, cpu_outs, what: str):
    """The CUDA collate step's outputs (host arrays) against the port's CPU
    step's on the same batch: equal dtypes and values, every output (the
    device-hit step's checksum included)."""
    names = DEVICE_HIT_OUTS if len(outs) == 5 else COLLATE_OUTS
    if len(cpu_outs) != len(outs):
        fail(f"{what}: {len(outs)} CUDA outputs, {len(cpu_outs)} CPU ones")
    for name, g, w in zip(names, outs, cpu_outs):
        if g.dtype != w.dtype or not np.array_equal(g, w):
            fail(f"the CUDA collate step's {name} differs from the CPU "
                 f"step's on {what}")


def exact_batch_split(idx_name: str, fq: str, card: str):
    """Phase 7, one batch outside the CLI runs (so its launches are not
    counted there): the collate step and the pass-2 step of the first
    batch, timed with CUDA events; both held against the port's CPU
    steps on the same batch (equal outputs), and swq against its plain
    version on that batch's pass-2 windows.  Returns (max_abs_err,
    collate ms, pass-2 ms)."""
    import torch
    from smalt_tpu_torch.index.table import KmerIndex
    from smalt_tpu_torch.map.engine import MapEngine, MapParams
    from smalt_tpu_torch.map.fastlane import DeviceExact
    from smalt_tpu_torch.map.fastmode import iter_fastq_batches
    from smalt_tpu_torch.ops import bounds, sw
    from smalt_tpu_torch.parallel import exact_pass2 as p2
    from smalt_tpu_torch.seq.refset import RefSet
    refset, idx = RefSet.load(idx_name), KmerIndex.load(idx_name)
    eng = MapEngine(refset, idx, MapParams())
    dev = DeviceExact.make(eng, "sam", True, False, False, False,
                           device="cuda")
    cpu = DeviceExact.make(eng, "sam", True, False, False, False,
                           device="cpu")
    dev._p2_on = True
    raw = next(iter(iter_fastq_batches(fq, dev.batch)))
    host, dargs, outs, wd, Sp, nw, tiles = lane_pass2_batch(dev, raw)
    step = dev._collate_fn()
    col_ms = time_ms(lambda: step(*dargs), 3, warm=1)
    # the exactness protocol re-stages what a wrong device step flags, so
    # the SAM alone cannot show a collate fault: hold the CUDA step
    # against the port's CPU step on the same batch
    t0 = time.perf_counter()
    chost, cargs = cpu._prepare(*raw)
    collate_equal(outs, cpu._collate_outputs(cargs),
                  "the first batch of phase 7")
    cpu_col_s = time.perf_counter() - t0
    p2_step = dev._pass2_step()
    p2_ms = time_ms(lambda: p2_step(dev._di.ref_alpha, host[10], host[11], wd,
                                    Sp, tiles), 10)
    # how long the host takes to enqueue the step's ops, the device idle
    # at the start: where this is the step's time, the host bounds it
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        p2_step(dev._di.ref_alpha, host[10], host[11], wd, Sp, tiles)
    p2_enq_ms = (time.perf_counter() - t0) * 100
    torch.cuda.synchronize()
    # and the whole pass-2 step (gather, strands, dummies, packing)
    t0 = time.perf_counter()
    p2_got = p2_step(dev._di.ref_alpha, host[10], host[11], wd, Sp,
                     tiles).cpu()
    p2_cpu = cpu._pass2_step()(cpu._di.ref_alpha, chost[10], chost[11],
                               wd.cpu(), Sp, tiles)
    if not torch.equal(p2_got, p2_cpu):
        fail("the CUDA pass-2 step differs from the CPU step on the first "
             "batch of phase 7")
    cpu_p2_s = time.perf_counter() - t0
    qa, sj, par = p2.pass2_inputs(dev._di.ref_alpha, host[10], host[11], wd,
                                  Sp)
    mat = sw.device_matrix(np.asarray(eng.matrix, np.int32), "cuda")
    err, want = check_swq_pair(qa, sj, par, mat, -eng.gapopen, -eng.gapext,
                               "the first pass-2 batch of phase 7", tiles)
    W, Qp = qa.shape
    q_ms = time_ms(lambda: p2.swq_cuda(qa, sj, par, mat, -eng.gapopen,
                                       -eng.gapext, tiles), 20)
    print(bound_line(f"swq Qp={Qp} Sp={Sp} W={W}, the {nw} pass-2 windows of "
                     f"a real batch and {W - nw} dummies",
                     bounds.swq_work(Qp, Sp, par), q_ms, card), flush=True)
    print(f"# device-exact, one batch of {dev.batch} reads: collate step "
          f"{col_ms:.3f} ms (CUDA events, 3 calls; H={dev._cfg.H}, pool "
          f"{dev._cfg.pool}), pass-2 step {p2_ms:.3f} ms (10 calls, "
          f"enqueued by the host in {p2_enq_ms:.3f} ms each; {nw} "
          f"windows padded to W={W}, Qp={Qp}, Sp={Sp}, band tiles "
          f"{tiles}); swq {q_ms:.4f} ms, equal to "
          f"swq_fill_walk_ref on them ({int((want[0][:nw] > 0).sum())} with "
          f"best > 0); collate outputs (pool, counts2, scores, fallback: "
          f"{int(outs[3][:len(raw[0])].sum())} reads flagged) and the packed "
          f"pass-2 output equal to the port's CPU steps ({cpu_col_s:.1f} s "
          f"and {cpu_p2_s:.1f} s on the host) | {card}", flush=True)
    return err, col_ms, p2_ms


def exact_lane_runs(d: str, idx_name: str, fq: str, n_reads: int,
                    card: str, tag: str = ""):
    """`map -r 1` on `fq` through the host C lane, then `map
    --device-exact` with SMALT_DX_P2 unset and =1: each device run's SAM
    byte-identical to the host lane's (the @PG line aside), no batch
    rendered on the host, the score-only sw_full launched, swq launched
    with p2_hit > 0 exactly when SMALT_DX_P2=1.  Returns (SAM bodies,
    launches, `# dx-total` matches, each by label, the host lane's CLI
    seconds)."""
    bodies, launches, totals = {}, {}, {}
    for label, flags, p2 in (("host C lane", [], None),
                             ("--device-exact", ["--device-exact"], None),
                             ("--device-exact SMALT_DX_P2=1",
                              ["--device-exact"], "1")):
        sam = os.path.join(d, f"exact{tag}_{len(bodies)}.sam")
        rc, err, launches[label], wall = cli_run(
            ["map", "-r", "1", "-f", "sam", "-o", sam] + flags +
            [idx_name, fq], SMALT_DP1_TIMING="1", SMALT_DX_P2=p2)
        if rc != 0:
            sys.stderr.write(err)
            fail(f"map {' '.join(flags)} (SMALT_DX_P2={p2}) exited {rc}")
        with open(sam) as f:
            bodies[label] = [ln for ln in f.read().splitlines()
                             if not ln.startswith("@PG")]
        n = sum(1 for ln in bodies[label] if not ln.startswith("@"))
        if n != n_reads:
            fail(f"{label}: {n} SAM records for {n_reads} reads")
        m = re.search(r"# dx-total ([\d.]+)s n_restaged=(\d+) p2_used=(\d+) "
                      r"p2_fb=(\d+) p2_hit=(\d+) host_batches=(\d+)", err)
        totals[label] = m
        stages = {}
        for st, sec in re.findall(r"# dx-(prep|dev|post|pass2) ([\d.]+)s",
                                  err):
            stages[st] = stages.get(st, 0.0) + float(sec)
        lane = "" if m is None else (
            f"; lane {m.group(1)} s ({n_reads / float(m.group(1)):.1f} "
            f"reads/s), n_restaged {m.group(2)}, p2_used {m.group(3)}, "
            f"p2_fb {m.group(4)}, p2_hit {m.group(5)}, host_batches "
            f"{m.group(6)}; seconds summed over batches: " + ", ".join(
                f"{k} {v:.3f}" for k, v in stages.items()) +
            " (dev: collate step + copy back, on the worker thread)")
        print(f"# map {label}: {n_reads} reads in {wall:.3f} "
              f"s through the CLI ({n_reads / wall:.1f} reads/s incl. index "
              f"load){lane}; launches {launches[label]} | {card}", flush=True)
        if not flags:
            host_wall = wall
        if flags:
            if m is None:
                fail(f"{label}: no dx-total line")
            if int(m.group(6)) != 0:
                fail(f"{label}: {m.group(6)} batches rendered on the host")
            if bodies[label] != bodies["host C lane"]:
                diff = next(i for i, (a, b) in enumerate(zip(
                    bodies[label], bodies["host C lane"])) if a != b)
                fail(f"{label}: SAM differs from the host C lane at line "
                     f"{diff}: {bodies[label][diff][:120]!r} vs "
                     f"{bodies['host C lane'][diff][:120]!r}")
            if launches[label]["sw_full"] < 1:
                fail(f"{label}: the score-only sw_full was never launched")
            if p2 and (launches[label]["swq"] < 1 or int(m.group(5)) < 1):
                fail(f"{label}: swq launched {launches[label]['swq']} "
                     f"times, p2_hit {m.group(5)}")
            if not p2 and launches[label]["swq"] != 0:
                fail(f"{label}: swq launched without SMALT_DX_P2=1")
    return bodies, launches, totals, host_wall


def run_exact(d: str, genome, card: str):
    """Phase 7: `map --device-exact` against the host C lane on the
    phase-4 genome and index.  Returns (launches of the SMALT_DX_P2=1
    run, launches of the run without, swq max_abs_err on the first
    pass-2 batch)."""
    idx_name = os.path.join(d, "idx")
    rng = np.random.default_rng(SEED + 3)
    reads, _, _ = make_reads(rng, genome, N_EXACT, READLEN)
    fq, _ = write_fastq(os.path.join(d, "exact.fq"), reads, b"x")
    bodies, launches, _, host_wall = exact_lane_runs(d, idx_name, fq,
                                                     N_EXACT, card)
    print(f"# device-exact SAM (SMALT_DX_P2 unset and =1) byte-identical to "
          f"the host C lane on {N_EXACT} reads", flush=True)
    from smalt_tpu_torch.report.bam import BamRecord, read_bam
    bams = {}
    for label, flags in (("host C lane -f bam", []),
                         ("--device-exact -f bam", ["--device-exact"])):
        out = os.path.join(d, f"exact_{len(bams)}.bam")
        rc, text, launches[label], wall = cli_run(
            ["map", "-r", "1", "-f", "bam", "-o", out] + flags +
            [idx_name, fq])
        if rc != 0:
            sys.stderr.write(text)
            fail(f"map {' '.join(flags)} -f bam exited {rc}")
        _, names, recs = read_bam(out)
        bams[label] = (names, [tuple(getattr(r, k) for k in
                                     BamRecord.__slots__) for r in recs])
        print(f"# map {label}: {N_EXACT} reads in {wall:.3f} s through the "
              f"CLI ({N_EXACT / wall:.1f} reads/s incl. index load); "
              f"launches {launches[label]} | {card}", flush=True)
    host_bam, dx_bam = bams.values()
    if len(dx_bam[1]) != N_EXACT or dx_bam != host_bam:
        fail(f"--device-exact -f bam: {len(dx_bam[1])} records, equal to the "
             f"host lane's {dx_bam == host_bam}")
    if launches["--device-exact -f bam"]["sw_full"] < 1:
        fail("--device-exact -f bam: the score-only sw_full was never "
             "launched")
    print(f"# device-exact -f bam: the {N_EXACT} records read back equal the "
          f"host lane's -f bam records", flush=True)
    err, _, _ = exact_batch_split(idx_name, fq, card)
    return (launches["--device-exact SMALT_DX_P2=1"],
            launches["--device-exact"], launches["--device-exact -f bam"],
            err, (bodies["host C lane"], host_wall))


# phase 7c: the exact lane's repeat tier.  A genome of random bases with
# dispersed copies of two units (Alu- and L1-like: length, copies, most
# divergence of a copy), indexed k 13, step 13 as the chr20 cells are:
# reads from a copy pass the main step's 128 hits a lane
TIER_GENOME_LEN = 3_000_000
TIER_UNITS = ((300, 1_200, 0.12), (1_000, 150, 0.10))
N_TIER = 2 * BATCH


def repeat_genome(rng, n: int) -> np.ndarray:
    """n uniform random bases (ASCII) with TIER_UNITS's copies planted at
    random, each on either strand and diverged by a share drawn up to its
    unit's."""
    g = rng.choice(ACGT, n)
    for ulen, copies, div in TIER_UNITS:
        unit = rng.integers(0, 4, ulen)
        for _ in range(copies):
            cp = substitute(rng, unit, rng.uniform(0, div))
            if rng.random() < 0.5:
                cp = 3 - cp[::-1]
            at = int(rng.integers(0, n - ulen))
            g[at:at + ulen] = ACGT[cp]
    return g


def scan_equal(cfg, args, what: str, card: str):
    """segcand_scan (the kernel) against the plain scan (_segcand_scan +
    _compact_rows) on the card, on one step's lanes as that step gave
    them: rows, counts, overflow and bad flags bit for bit.  The plain
    scan runs over the lanes' most hits (its H + 1 steps).  Returns the
    kernels-line entry: kernel ms (CUDA events), plain ms, bound."""
    import dataclasses
    import torch
    from smalt_tpu_torch.ops import bounds
    from smalt_tpu_torch.parallel import exact_collate as ec
    k1s, k2s, ivl, tot, mdsh, minc = args
    R = k1s.shape[0]
    m = max(1, int(tot.max()))
    sync = torch.cuda.synchronize if k1s.is_cuda else (lambda: None)
    got = ec.segcand_scan(cfg, *args)
    sync()
    t0 = time.perf_counter()
    pcfg = dataclasses.replace(cfg, H=m)
    valid = torch.arange(m, device=k1s.device)[None, :] < tot[:, None]
    rev = (torch.arange(R, device=k1s.device) % 2) == 1
    ef, er, pbad = ec._segcand_scan(
        pcfg, k1s[:, :m], k2s[:, :m], valid, mdsh, minc, rev,
        ivl=None if ivl is None else ivl[:, :m])
    want = ec._compact_rows(pcfg, ef, er) + (pbad,)
    sync()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    lanes_off = torch.zeros(R, dtype=torch.bool, device=k1s.device)
    for g, w in zip(got, want):
        lanes_off |= (g != w).reshape(R, -1).any(dim=1)
    off = int(lanes_off.sum())
    if k1s.is_cuda:
        k_ms = time_ms(lambda: ec.segcand_scan(cfg, *args), 5)
    else:
        t0 = time.perf_counter()
        ec.segcand_scan(cfg, *args)
        k_ms = 1e3 * (time.perf_counter() - t0)
    work = bounds.segcand_work(tot, got[1], cfg.C, ivl is not None)
    cand = int(got[1].sum())
    print(f"# segcand, {what}: {R} lanes, {work['cells']} hits (most "
          f"{m} a lane), {cand} candidates, C {cfg.C}; lanes unequal to "
          f"the plain scan {off}; kernel {k_ms:.4f} ms (CUDA events, 5 "
          f"calls), plain {plain_ms:.1f} ms; bound {work['bound_ms']:.4f} "
          f"ms by {work['bound_by']} ({work['bytes']} bytes), bound / "
          f"kernel = {100 * bounds.share(work['bound_ms'], k_ms):.2f}% | "
          f"{card}", flush=True)
    if off:
        fail(f"segcand, {what}: {off} lanes differ from the plain scan")
    return off, dict(ms=k_ms, plain_ms=plain_ms, bound_ms=work["bound_ms"],
                     bound_by=work["bound_by"], lanes=R, hits=work["cells"],
                     candidates=cand)


def check_repeat_tier(d: str, card: str, device: str = "cuda"):
    """Phase 7c: `map --device-exact` on N_TIER 100 bp reads of
    repeat_genome (two batches) against the host C lane: SAM byte for
    byte, the repeat tier taking rows in every batch and none re-staged
    for its hits (rs_h), segcand launched once a step (the main step's
    and the tier's, each batch).  Then the first batch's two scans, as
    that run gave them, through segcand_scan and the plain scan on the
    card (scan_equal), and the tier's step at its ceilings (the batch's
    rows, HASH_MAXNHITS hits a lane and candidates, target_depth pool
    rows a row, Q = 256) on lanes of that many hits: its peak memory.
    Returns (the run's launches, lanes unequal (0), the kernels-line
    entry of segcand).  device: the lane's (the CPU runs a small copy of
    the phase in a test; peak memory is read on CUDA only)."""
    import torch
    from smalt_tpu_torch import cli
    from smalt_tpu_torch.index.table import KmerIndex
    from smalt_tpu_torch.map.engine import MapEngine, MapParams
    from smalt_tpu_torch.map.fastlane import DeviceExact
    from smalt_tpu_torch.parallel import exact_collate as ec
    from smalt_tpu_torch.seq.refset import RefSet
    td = os.path.join(d, "tier")
    os.makedirs(td, exist_ok=True)
    rng = np.random.default_rng(SEED + 11)
    genome = repeat_genome(rng, TIER_GENOME_LEN)
    fa, _, _ = write_inputs(td, genome, np.zeros((0, 1), np.uint8))
    idx_name = os.path.join(td, "idx")
    if cli.main(["index", "-k", "13", "-s", "13", idx_name, fa]) != 0:
        fail("repeat genome: index build")
    reads = make_reads(rng, genome, N_TIER, READLEN)[0]
    fq, _ = write_fastq(os.path.join(td, "tier.fq"), reads, b"t")
    # the first batch's scans (the tier's step goes first), copied as
    # the steps gave them
    seen, scan = [], ec.segcand_scan

    def keep(cfg, *args):
        if len(seen) < 2:
            seen.append((cfg, tuple(None if a is None else a.clone()
                                    for a in args)))
        return scan(cfg, *args)

    runs = {}
    for label, flags in (("host C lane", []),
                         ("--device-exact repeat tier",
                          ["--device-exact", "--device", device])):
        sam = os.path.join(td, f"tier_{len(runs)}.sam")
        ec.segcand_scan = keep if flags else scan
        try:
            rc, err, launches, wall = cli_run(
                ["map", "-r", "1", "-o", sam] + flags + [idx_name, fq],
                SMALT_DP1_TIMING="1", SMALT_DX_P2=None, SMALT_DX_H=None,
                SMALT_DX_POOL=None, SMALT_DX_BATCH=None)
        finally:
            ec.segcand_scan = scan
        if rc != 0:
            sys.stderr.write(err)
            fail(f"map {' '.join(flags)} on the repeat genome exited {rc}")
        runs[label] = (sam_body(sam), err, launches, wall)
    (host, _, _, host_wall), (body, err, launches, wall) = runs.values()
    lines = [{k: int(float(v)) for k, v in re.findall(r"(\w+)=([0-9.]+)", ln)}
             for ln in err.splitlines() if ln.startswith("# dx-batch ")]
    n = sum(b["n"] for b in lines)
    tier = sum(b["tier"] for b in lines)
    print(f"# map --device-exact on {N_TIER} reads of the repeat genome: "
          f"{len(body)} records, {wall:.2f} s (host C lane {host_wall:.2f} "
          f"s); batches {len(lines)}: tier rows {tier} of {n} "
          f"({100 * tier / max(n, 1):.2f}%), tier re-staged "
          f"{sum(b['tier_rs'] for b in lines)}, rs_h "
          f"{sum(b['rs_h'] for b in lines)}, re-staged "
          f"{sum(b['restaged'] for b in lines)}; launches {launches} | "
          f"{card}", flush=True)
    if body != host or len(body) != N_TIER:
        fail(f"repeat tier: {len(body)} records, equal to the host lane's "
             f"{body == host}")
    if len(lines) != N_TIER // BATCH or n != N_TIER or \
            any(b["tier"] < 1 or b["rs_h"] for b in lines):
        fail(f"repeat tier: batch lines {lines}")
    if launches["segcand"] != 2 * len(lines):
        fail(f"repeat tier: segcand launched {launches['segcand']} times "
             f"in {len(lines)} batches (one a step)")
    main_cfg = min((c for c, _ in seen), key=lambda c: c.H)
    tier_cfg = max((c for c, _ in seen), key=lambda c: c.H)
    if len(seen) != 2 or main_cfg.H == tier_cfg.H:
        fail(f"repeat tier: scans seen {[c.H for c, _ in seen]}")
    off_t, rec = scan_equal(tier_cfg, dict(seen)[tier_cfg],
                            "the repeat tier's lanes of the first batch",
                            card)
    off_m, rec_main = scan_equal(main_cfg, dict(seen)[main_cfg],
                                 "the main step's lanes of the first batch",
                                 card)
    rec["main_step"] = rec_main
    del seen[:]

    # the tier's step at its ceilings, at the paired cell's read cap
    eng = MapEngine(RefSet.load(idx_name), KmerIndex.load(idx_name),
                    MapParams())
    dev = DeviceExact.make(eng, "sam", True, False, False, False,
                           batch=BATCH, device=device)
    dev._qcap = 256
    dev._collate_fn()
    Bt, Ht, Pt = dev._tier_ceilings()
    dev._tier_B, dev._tier_H, dev._tier_C, dev._tier_P = Bt, Ht, Ht, Pt
    step = dev._tier_fn()
    cfg = None
    for key, fn in dev._dx_cache().items():
        if fn is step:
            cfg = key[0]
    R = 2 * Bt
    cuda = device == "cuda"
    # each lane's hits in runs of 8 on one shift, 13 query bases apart
    # (one seed of 104 bases, one candidate), the shifts rising by 8-99
    g = torch.Generator(device=device).manual_seed(SEED)
    gaps = torch.randint(8, 100, (R, Ht // 8), device=device,
                         dtype=torch.int32, generator=g)
    k1 = torch.cumsum(gaps, dim=1, dtype=torch.int32).repeat_interleave(
        8, dim=1)
    k2 = (13 * torch.arange(8, device=device, dtype=torch.int32)).repeat(
        Ht // 8)[None, :].expand(R, Ht).to(torch.uint8).contiguous()
    tot = torch.full((R,), Ht, dtype=torch.int32, device=device)
    codes = torch.randint(0, 4, (Bt, 256), device=device, dtype=torch.int32,
                          generator=g).to(torch.uint8)
    qlens = torch.full((Bt,), 250, dtype=torch.int32, device=device)
    minc = torch.full((Bt,), 20, dtype=torch.int32, device=device)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() if cuda else 0
    t0 = time.perf_counter()
    outs = step(k1, k2, tot, codes, qlens, minc)
    if cuda:
        torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    rec["ceiling"] = dict(B=cfg.B, H=cfg.H, C=cfg.C, P=cfg.P, Q=cfg.Q,
                          SPAD=cfg.SPAD, inputs_bytes=base,
                          peak_bytes=peak, step_s=step_s)
    print(f"# the repeat tier's step at its ceilings (B {cfg.B}, H {cfg.H}, "
          f"C {cfg.C}, P {cfg.P}, Q {cfg.Q}, SPAD {cfg.SPAD}) on lanes of "
          f"{Ht} hits: peak {peak} bytes allocated on the card ({base} "
          f"before the step, its inputs and the index), {step_s:.2f} s with "
          f"its first call | {card}", flush=True)
    rec["ceiling"]["candidates"] = int(outs[1].sum())
    del outs, k1, k2, gaps, tot, codes, step, dev
    if cuda:
        torch.cuda.empty_cache()
    return launches, off_t + off_m, rec


def check_lane_bands(d: str, genome, card: str):
    """Phase 7b: the band widths the `--device-exact` lane gives its pass-2
    windows on reads past 128 bp (the Qp256 frame, up to 8 tiles a row)
    and with the phase-8 matrix, outside the CLI: for each LANE_BANDS
    case, the first batch of BATCH reads through the CUDA lane up to its
    pass-2 step, the widths printed, swq held against its plain version
    on those windows and timed.  Returns the max |difference| (0)."""
    import torch
    from smalt_tpu_torch.cli import _parse_penalties
    from smalt_tpu_torch.index.table import KmerIndex
    from smalt_tpu_torch.map.engine import MapEngine, MapParams
    from smalt_tpu_torch.map.fastlane import DeviceExact
    from smalt_tpu_torch.map.fastmode import iter_fastq_batches
    from smalt_tpu_torch.ops import bounds, sw
    from smalt_tpu_torch.parallel import exact_pass2 as p2
    from smalt_tpu_torch.seq.refset import RefSet
    idx_name = os.path.join(d, "idx")
    refset, idx = RefSet.load(idx_name), KmerIndex.load(idx_name)
    rng = np.random.default_rng(SEED + 5)
    worst = 0
    for rl, indels, spec in LANE_BANDS:
        make = make_long_reads if indels else make_reads
        reads = make(rng, genome, BATCH, rl)[0]
        fq, _ = write_fastq(os.path.join(d, f"bands_{rl}.fq"), reads, b"b")
        eng = MapEngine(refset, idx, MapParams(),
                        penalties=_parse_penalties(spec))
        dev = DeviceExact.make(eng, "sam", True, False, False, False,
                               device="cuda")
        dev._p2_on = True
        raw = next(iter(iter_fastq_batches(fq, dev.batch)))
        host, _, _, wd, Sp, nw, tiles = lane_pass2_batch(dev, raw)
        qa, sj, par = p2.pass2_inputs(dev._di.ref_alpha, host[10], host[11],
                                      wd, Sp)
        W, Qp = qa.shape
        pc = par.cpu().numpy()
        width = p2.band_widths(*(pc[:, k] for k in (0, 1, 2, 3, 5)), Qp)
        width = width[pc[:, 5] != 0]
        mat = sw.device_matrix(np.asarray(eng.matrix, np.int32), "cuda")
        errs = "1% subs, 1.5% indels" if indels else "1% subs"
        what = f"{rl} bp reads ({errs}, -S {spec or 'default'})"
        err, want = check_swq_pair(qa, sj, par, mat, -eng.gapopen,
                                   -eng.gapext, f"the lane's windows of {what}",
                                   tiles)
        worst = max(worst, err)
        q_ms = time_ms(lambda: p2.swq_cuda(qa, sj, par, mat, -eng.gapopen,
                                           -eng.gapext, tiles), 20)
        hist = np.bincount(-(-width // 32), minlength=Qp // 32 + 1)[1:]
        print(f"# lane pass-2 bands, {what}: {len(width)} windows at "
              f"Qp={Qp} Sp={Sp} W={W}, band width max "
              f"{int(width.max()) if len(width) else 0}, 99th percentile "
              f"{int(np.percentile(width, 99)) if len(width) else 0}, "
              f"windows by tiles 1..{Qp // 32}: {hist.tolist()}, launch "
              f"tiles {tiles}; swq {q_ms:.4f} ms, equal to swq_fill_walk_ref "
              f"({int((want[0] > 0).sum())} with best > 0) | {card}",
              flush=True)
        print(bound_line(f"swq Qp={Qp} Sp={Sp} W={W}, the lane's windows of "
                         f"{what}", bounds.swq_work(Qp, Sp, par), q_ms, card),
              flush=True)
        del qa, sj, par, want, dev
        torch.cuda.empty_cache()
    return worst


def run_wide_matrix(d: str, genome, card: str):
    """Phase 8: -S WIDE_SPEC (a match of 200: entries outside int8) on the
    phase-4 genome and index.  `map --fast` on BATCH single-end reads,
    SAM equal to the --device cpu run's, through sw_full's WIDE tracked
    instance; `map --device-exact` with SMALT_DX_P2=1 on BATCH reads, SAM
    equal to the host C lane's (the @PG line aside), through the WIDE
    score-only instance and swq, p2_hit > 0.  Returns the launches of the
    two runs."""
    idx_name = os.path.join(d, "idx")
    rng = np.random.default_rng(SEED + 4)
    reads, truth, rev = make_reads(rng, genome, BATCH, READLEN)
    fq, _ = write_fastq(os.path.join(d, "wide.fq"), reads, b"w")
    spec = ["-S", WIDE_SPEC]
    sam = os.path.join(d, "wide_cuda.sam")
    fast, wall, _ = map_cli("cuda", idx_name, sam, [fq], BATCH, spec)
    body = sam_body(sam)
    placed = placement(body, truth, rev)
    # (no placement limit: against a match of 200, gaps cost next to
    # nothing, and alignment starts move)
    if len(body) != BATCH:
        fail(f"-S {WIDE_SPEC}: {len(body)} SAM records for {BATCH} reads")
    if fast["sw_full_track_wide"] < 1 or fast["sw_full_track"] != 0:
        fail(f"-S {WIDE_SPEC}: --fast launched {fast}")
    sam_cpu = os.path.join(d, "wide_cpu.sam")
    t0 = time.perf_counter()
    map_cli("cpu", idx_name, sam_cpu, [fq], BATCH, spec)
    if sam_body(sam_cpu) != body:
        fail(f"-S {WIDE_SPEC}: --fast SAM differs from --device cpu")
    print(f"# map --fast -S {WIDE_SPEC} on cuda: {BATCH} reads in {wall:.3f} "
          f"s, placed {placed}/{BATCH} within {PLACE_TOL} bp; SAM "
          f"byte-identical to --device cpu "
          f"({time.perf_counter() - t0:.1f} s on the CPU); launches {fast} | "
          f"{card}", flush=True)
    bodies, lanes = {}, {}
    for label, flags in (("--device-pass1", ["--device-pass1"]),
                         ("host C lane", []),
                         ("--device-exact SMALT_DX_P2=1", ["--device-exact"])):
        out = os.path.join(d, f"wide_exact_{len(bodies)}.sam")
        rc, err, lanes[label], _ = cli_run(
            ["map", "-r", "1", "-f", "sam", "-o", out] + spec + flags +
            [idx_name, fq], SMALT_DP1_TIMING="1", SMALT_DX_P2="1")
        if rc != 0:
            sys.stderr.write(err)
            fail(f"map -S {WIDE_SPEC} {' '.join(flags)} exited {rc}")
        with open(out) as f:
            bodies[label] = [ln for ln in f.read().splitlines()
                             if not ln.startswith("@PG")]
    exact, dp1 = lanes["--device-exact SMALT_DX_P2=1"], lanes["--device-pass1"]
    if bodies["--device-pass1"] != bodies["host C lane"]:
        fail(f"-S {WIDE_SPEC}: --device-pass1 SAM differs from the host C "
             f"lane")
    if dp1["sw_full_wide"] < 1 or dp1["sw_full"]:
        fail(f"-S {WIDE_SPEC}: --device-pass1 launched {dp1}")
    print(f"# map --device-pass1 -S {WIDE_SPEC}: SAM byte-identical to the "
          f"host C lane on {BATCH} reads; launches {dp1} | {card}",
          flush=True)
    m = re.search(r"# dx-total ([\d.]+)s n_restaged=(\d+) p2_used=(\d+) "
                  r"p2_fb=(\d+) p2_hit=(\d+) host_batches=(\d+)", err)
    if bodies["--device-exact SMALT_DX_P2=1"] != bodies["host C lane"]:
        fail(f"-S {WIDE_SPEC}: --device-exact SAM differs from the host C "
             f"lane")
    if m is None or int(m.group(5)) < 1 or int(m.group(6)) != 0:
        fail(f"-S {WIDE_SPEC}: --device-exact counters "
             f"{m.groups() if m else None}")
    if exact["sw_full_wide"] < 1 or exact["swq"] < 1 or exact["sw_full"]:
        fail(f"-S {WIDE_SPEC}: --device-exact launched {exact}")
    print(f"# map --device-exact -S {WIDE_SPEC} SMALT_DX_P2=1: SAM "
          f"byte-identical to the host C lane on {BATCH} reads; n_restaged "
          f"{m.group(2)}, p2_used {m.group(3)}, p2_fb {m.group(4)}, p2_hit "
          f"{m.group(5)}; launches {exact} | {card}", flush=True)
    return fast, exact, dp1


def exact_pairs_batch_split(idx_name: str, fq1: str, fq2: str, card: str):
    """Phase 9, a first paired batch of PE_CHECK_B mate rows outside the
    CLI run (so its launches are not counted there): both mates' rows
    through the CUDA collate step,
    timed with CUDA events, and its outputs held against the port's CPU
    step on the same batch (the lane re-stages what a wrong step flags, so
    the SAM alone cannot show a collate fault).  Returns the step's ms."""
    from smalt_tpu_torch.index.table import KmerIndex
    from smalt_tpu_torch.map.engine import MapEngine, MapParams
    from smalt_tpu_torch.map.fastlane import DeviceExact
    from smalt_tpu_torch.map.fastmode import iter_fastq_batches
    from smalt_tpu_torch.seq.refset import RefSet
    refset, idx = RefSet.load(idx_name), KmerIndex.load(idx_name)
    eng = MapEngine(refset, idx, MapParams())
    dev, cpu = (DeviceExact.make(eng, "sam", True, False, False, False,
                                 batch=PE_CHECK_B, device=x)
                for x in ("cuda", "cpu"))
    mates = (next(iter_fastq_batches(f, dev.batch // 2)) for f in (fq1, fq2))
    args = tuple(a + b for a, b in zip(*mates))     # mate A rows, then B
    host, dargs = dev._prepare(*args)
    outs = dev._collate_outputs(dargs)
    step = dev._collate_fn()
    col_ms = time_ms(lambda: step(*dargs), 3, warm=1)
    t0 = time.perf_counter()
    _, cargs = cpu._prepare(*args)
    collate_equal(outs, cpu._collate_outputs(cargs),
                  "the first paired batch of phase 9")
    print(f"# device-exact pairs, one batch of {len(args[0]) // 2} pairs "
          f"({len(args[0])} rows): collate step {col_ms:.3f} ms (CUDA "
          f"events, 3 calls; Q={dev._cfg.Q}, H={dev._cfg.H}, V="
          f"{dev._cfg.V}, pool {dev._cfg.pool}); outputs ("
          f"{', '.join(DEVICE_HIT_OUTS if len(outs) == 5 else COLLATE_OUTS)}"
          f": {int(outs[-1][:len(args[0])].sum())} mates flagged) equal to "
          f"the port's CPU step ({time.perf_counter() - t0:.1f} s on the "
          f"host) | {card}", flush=True)
    return col_ms


def exact_pair_runs(d: str, idx_name: str, fq1: str, fq2: str,
                    npairs: int, card: str, tag: str = ""):
    """Paired `map -r 1` through the host C pair lane, then `map
    --device-exact`: the device run's SAM byte-identical to the host
    lane's (the @PG line aside), no batch rendered on the host, every pair
    through the lane, the score-only sw_full launched and swq not.
    Returns (launches, `# dxp-total` match), each by label."""
    bodies, launches, totals = {}, {}, {}
    for label, flags in (("host C pair lane", []),
                         ("--device-exact", ["--device-exact"])):
        sam = os.path.join(d, f"pe_exact{tag}_{len(bodies)}.sam")
        rc, err, launches[label], wall = cli_run(
            ["map", "-r", "1", "-f", "sam", "-o", sam] + flags +
            [idx_name, fq1, fq2], SMALT_DP1_TIMING="1", SMALT_TIMING="1")
        if rc != 0:
            sys.stderr.write(err)
            fail(f"map {' '.join(flags)} on pairs exited {rc}")
        with open(sam) as f:
            bodies[label] = [ln for ln in f.read().splitlines()
                             if not ln.startswith("@PG")]
        n = sum(1 for ln in bodies[label] if not ln.startswith("@"))
        if n != 2 * npairs:
            fail(f"{label}: {n} SAM records for {2 * npairs} mates")
        t = re.search(r"mapping: ([\d.]+) s", err)
        m = re.search(r"# dxp-total ([\d.]+)s n_restaged=(\d+) "
                      r"host_batches=(\d+) npairs=(\d+)", err)
        totals[label] = m
        stages = {}
        for st, sec in re.findall(r"# dxp-(prep|dev|post|tail) ([\d.]+)s",
                                  err):
            stages[st] = stages.get(st, 0.0) + float(sec)
        lane = "" if m is None else (
            f"; lane {m.group(1)} s ({npairs / float(m.group(1)):.1f} "
            f"pairs/s, # dxp-total), n_restaged {m.group(2)} of "
            f"{2 * npairs} mates, host_batches {m.group(3)}, npairs "
            f"{m.group(4)}; seconds summed over batches: " + ", ".join(
                f"{k} {v:.3f}" for k, v in stages.items()) +
            " (dev: collate step + copy back, on the worker thread)")
        secs = float(t.group(1)) if t else float("nan")
        print(f"# map {label}: {npairs} pairs in {wall:.3f} s through the "
              f"CLI ({2 * npairs / wall:.1f} reads/s incl. index load); "
              f"mapping {secs:.2f} s ({npairs / secs:.1f} pairs/s, "
              f"SMALT_TIMING){lane}; launches {launches[label]} | {card}",
              flush=True)
        if flags:
            if m is None:
                fail(f"{label}: no dxp-total line")
            if int(m.group(3)) != 0:
                fail(f"{label}: {m.group(3)} batches rendered on the host")
            if int(m.group(4)) != npairs:
                fail(f"{label}: {m.group(4)} pairs through the lane")
            if bodies[label] != bodies["host C pair lane"]:
                diff = next(i for i, (a, b) in enumerate(zip(
                    bodies[label], bodies["host C pair lane"])) if a != b)
                fail(f"{label} on pairs: SAM differs from the host C pair "
                     f"lane at line {diff}: {bodies[label][diff][:120]!r} vs "
                     f"{bodies['host C pair lane'][diff][:120]!r}")
            if launches[label]["sw_full"] < 1 or launches[label]["swq"] != 0:
                fail(f"{label} on pairs: launched {launches[label]} (the "
                     f"score-only sw_full at least once, swq never)")
    return launches, totals


def run_exact_pairs(d: str, genome, card: str):
    """Phase 9: paired `map --device-exact` against the host C pair lane on
    the phase-4 genome and index.  Returns the launches of the device
    run."""
    idx_name = os.path.join(d, "idx")
    rng = np.random.default_rng(SEED + 6)
    m1, m2, _, _ = make_pairs(rng, genome, N_PE_EXACT, PAIR_READLEN)
    # every tenth pair: mate B random bases, which takes the rescue path
    m2[::10] = ACGT[rng.integers(0, 4, m2[::10].shape)]
    fq1, _ = write_fastq(os.path.join(d, "pe_exact_1.fq"), m1, b"e")
    fq2, _ = write_fastq(os.path.join(d, "pe_exact_2.fq"), m2, b"e")
    print(f"# paired device-exact data: {N_PE_EXACT} pairs of 2 x "
          f"{PAIR_READLEN} bp, inserts {INSERT_MEAN} +- {INSERT_SD} FR, 1% "
          f"substitutions, mate B random in every tenth pair", flush=True)
    launches, _ = exact_pair_runs(d, idx_name, fq1, fq2, N_PE_EXACT, card)
    print(f"# paired device-exact SAM byte-identical to the host C pair lane "
          f"on {N_PE_EXACT} pairs", flush=True)
    exact_pairs_batch_split(idx_name, fq1, fq2, card)
    return launches["--device-exact"]


@contextlib.contextmanager
def strip_timer(spans: list):
    """While open, every sw_full_cuda call on a query past MAX_Q (the strip
    path) records CUDA events before and after it, on the calling thread's
    stream, into `spans`."""
    import torch
    from smalt_tpu_torch.ops import sw
    real = sw.sw_full_cuda

    def timed_call(qcodes, *a, **k):
        if qcodes.shape[1] <= sw.MAX_Q:
            return real(qcodes, *a, **k)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = real(qcodes, *a, **k)
        ev[1].record()
        spans.append(ev)
        return out

    sw.sw_full_cuda = timed_call
    try:
        yield
    finally:
        sw.sw_full_cuda = real


def pass1_runs(cases, idx_name: str, fq: str, n: int, card: str, **env):
    """`map -r 1` through the port's CLI for each (label, flags) of cases,
    the launch counts set to 0 just before each run and read just after;
    every device run's SAM must equal the first (the host C lane's, the
    @PG line aside) with no batch rendered on the host (# dp1-total).
    The strip path's calls are timed on the card (strip_timer).
    `env`: more variables for the runs.  Returns {label: (launches, CLI
    wall s, lane s or None, stderr)}."""
    import torch
    bodies, runs = {}, {}
    for label, flags in cases:
        sam = os.path.join(os.path.dirname(fq), f"dp1_{len(bodies)}.sam")
        spans = []
        with strip_timer(spans):
            rc, err, launches, wall = cli_run(
                ["map", "-r", "1", "-f", "sam", "-o", sam] + flags +
                [idx_name, fq], SMALT_DP1_TIMING="1", **env)
        if rc != 0:
            sys.stderr.write(err)
            fail(f"map {' '.join(flags)} on {fq} exited {rc}")
        with open(sam) as f:
            bodies[label] = [ln for ln in f.read().splitlines()
                             if not ln.startswith("@PG")]
        if sum(1 for ln in bodies[label] if not ln.startswith("@")) != n:
            fail(f"{label}: SAM records for {n} reads expected")
        m = re.search(r"# dp1-total ([\d.]+)s host_batches=(\d+) "
                      r"nreads=(\d+)", err)
        if any(f.startswith("--device") for f in flags):
            if m is None or int(m.group(2)) != 0 or int(m.group(3)) != n:
                fail(f"{label}: # dp1-total {m.groups() if m else None}")
            host = next(iter(bodies.values()))
            if bodies[label] != host:
                diff = next(i for i, (a, b) in enumerate(zip(
                    bodies[label], host)) if a != b)
                fail(f"{label}: SAM differs from the host C lane at line "
                     f"{diff}: {bodies[label][diff][:120]!r} vs "
                     f"{host[diff][:120]!r}")
        stages = {}
        for sec in re.findall(r"# dp1-dev nw=\d+ call=([\d.]+)", err):
            stages["dev call"] = stages.get("dev call", 0.0) + float(sec)
        for sec in re.findall(r"# dp1-main stall=([\d.]+)", err):
            stages["stall"] = stages.get("stall", 0.0) + float(sec)
        lane = float(m.group(1)) if m else None
        torch.cuda.synchronize()
        strip_ms = sum(e0.elapsed_time(e1) for e0, e1 in spans)
        print(f"# map {label}: {n} reads in {wall:.3f} s through the CLI "
              f"({n / wall:.1f} reads/s incl. index load)" +
              (f"; lane {lane:.3f} s ({n / lane:.1f} reads/s, # dp1-total), "
               f"main thread stalled on the device {stages.get('stall', 0):.3f}"
               f" s" if lane else "") +
              (f"; the strip path's {len(spans)} calls {strip_ms:.3f} ms on "
               f"the card (CUDA events)" if spans else "") +
              f"; launches {launches} | {card}", flush=True)
        runs[label] = (launches, wall, lane, err)
    return runs


def check_far_windows(card: str):
    """Phase 10d: the pass-1 step alone on a reference of FAR_REF codes
    resident on the card, with windows below 2^31, straddling it, above
    it and at the end, reads planted in half of them (every other four
    windows): dp1_step (the
    sw_full kernel) equal to the plain version of the step built here
    from an int64 gather and sw_score_ref.  Returns the max |diff| (0)."""
    import torch
    from smalt_tpu_torch.align import core as ali
    from smalt_tpu_torch.map.fastlane import dp1_step
    from smalt_tpu_torch.ops import sw
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    ref = torch.randint(0, 4, (FAR_REF,), dtype=torch.uint8, device="cuda",
                        generator=gen)
    rng = np.random.default_rng(SEED + 10)
    n, Q, S, W = 1024, 128, 256, BATCH
    qlens = rng.integers(90, Q + 1, n).astype(np.int32)
    reads = rng.integers(0, 4, (n, Q)).astype(np.uint8)
    reads[rng.random((n, Q)) < 0.01] = 4
    reads[np.arange(Q)[None, :] >= qlens[:, None]] = 7
    rc = np.where(reads < 4, 3 - reads, reads)
    wd = np.zeros((W, 4), np.int64)
    two31 = 1 << 31
    part = np.arange(W) % 4
    wd[:, 0] = np.select(
        [part == 0, part == 1, part == 2],
        [rng.integers(0, two31 - S, W), two31 - rng.integers(1, S, W),
         rng.integers(two31, FAR_REF - S, W)],
        FAR_REF - rng.integers(1, S, W))
    wd[:, 1] = rng.integers(S // 2, S + 1, W)
    wd[5::16, 1] = 0                           # empty windows
    wd[:, 2] = rng.integers(0, n, W)
    wd[:, 3] = rng.integers(0, 2, W)
    qcs = np.full((W, Q), 7, np.int32)          # the windows' queries
    for w in range(W):
        r, L = int(wd[w, 2]), int(qlens[wd[w, 2]])
        qcs[w, :L] = rc[r, :L][::-1] if wd[w, 3] else reads[r, :L]
        at = int(wd[w, 0]) + 8
        if w // 4 % 2 == 0 and at + L <= FAR_REF:   # plant the query
            ref[at: at + L] = torch.from_numpy(
                np.where(qcs[w, :L] < 4, qcs[w, :L], 0).astype(np.uint8)
            ).cuda()
    m, go, ge = ali.make_score_matrix()
    mat = sw.device_matrix(m, "cuda")
    wd_t = torch.from_numpy(wd).cuda()
    got = dp1_step(ref, torch.from_numpy(reads).cuda(),
                   torch.from_numpy(qlens).cuda(), wd_t, S, mat, -go, -ge)

    def plain(starts):
        offs = torch.arange(S, dtype=torch.int64, device="cuda")[None, :]
        idx = (starts[:, None] + offs).clamp(0, FAR_REF - 1)
        slens = wd_t[:, 1].to(torch.int32)
        wins = torch.where(offs >= slens[:, None], 7,
                           ref[idx].to(torch.int32))
        return sw.sw_score_ref(torch.from_numpy(qcs).cuda(), wins, slens,
                               mat.t, -go, -ge)

    want = plain(wd_t[:, 0])
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    if int(((want.cpu().numpy() >= 80) & (part == 2)).sum()) < W // 16:
        fail("degenerate windows past 2^31: few planted reads score")
    if err:
        fail(f"the pass-1 step differs from its plain version on windows "
             f"past 2^31: {int((got != want).sum())} of {W} windows")
    # the reference's int32 descriptors: starts past 2^31 wrap (negative,
    # then clamped to 0)
    wrapped = plain(torch.from_numpy(wd[:, 0].astype(np.int32).astype(
        np.int64)).cuda())
    far = wd[:, 0] + S > two31
    moved = int((wrapped != want).cpu().numpy()[far].sum())
    high = (want.cpu().numpy() >= 80) & (np.arange(W) // 4 % 2 == 0)
    planted = [int(high[part == k].sum()) for k in range(4)]
    print(f"# pass-1 step on a resident reference of {FAR_REF} codes "
          f"({FAR_REF / 2**30:.2f} GiB): {W} windows (a quarter each below "
          f"2^31, straddling it, above it, at the end; one in 16 empty), "
          f"scores equal to the plain version from an int64 gather "
          f"(planted windows scoring >= 80, of {W // 8} a quarter: "
          f"{planted}); with int32 "
          f"starts {moved} of the {int(far.sum())} windows reaching past "
          f"2^31 would score otherwise; {time.perf_counter() - t0:.1f} s | "
          f"{card}", flush=True)
    del ref
    torch.cuda.empty_cache()
    return err


def run_pass1(d: str, genome, card: str, host):
    """Phase 10: `map --device-pass1` against the host C lane on the
    phase-4 genome and index.  host = (phase 7's host C lane SAM body,
    its CLI seconds).  Returns (launches of the 100 bp run, of the 1,500
    bp run, of the k15 s16 --device-exact run, the step's max |diff|
    past 2^31)."""
    idx_name = os.path.join(d, "idx")
    # (a) phase 7's reads against phase 7's host C lane
    fq = os.path.join(d, "exact.fq")
    runs = pass1_runs([("--device-pass1", ["--device-pass1"])], idx_name, fq,
                      N_EXACT, card)
    la, _, lane_a, _ = runs["--device-pass1"]
    body = [ln for ln in open(os.path.join(d, "dp1_0.sam")).read()
            .splitlines() if not ln.startswith("@PG")]
    if body != host[0]:
        fail("--device-pass1: SAM differs from phase 7's host C lane")
    print(f"# --device-pass1 on phase 7's {N_EXACT} reads: SAM "
          f"byte-identical to the host C lane; lane {N_EXACT / lane_a:.1f} "
          f"reads/s against the host C lane's {N_EXACT / host[1]:.1f} CLI "
          f"reads/s (phase 7) | {card}", flush=True)
    if la["sw_full"] < 1 or la["swq"] or \
            any(v for k, v in la.items() if "_strip" in k or "_warp" in k):
        fail(f"--device-pass1 on 100 bp reads launched {la}")
    # (b) kilobase reads: the strip path
    rng = np.random.default_rng(SEED + 8)
    reads, _, _ = make_long_reads(rng, genome, N_DP1_LONG, LONG_READLEN)
    fq, _ = write_fastq(os.path.join(d, "dp1_long.fq"), reads, b"k")
    runs = pass1_runs([("host C lane, 1,500 bp", []),
                       ("--device-pass1, 1,500 bp", ["--device-pass1"])],
                      idx_name, fq, N_DP1_LONG, card)
    lb = runs["--device-pass1, 1,500 bp"][0]
    # the lane's window batch (4 x SMALT_DP1_BATCH) fills the card: the
    # one-warp kernel
    if lb["sw_full"]:
        fail(f"--device-pass1 on 1,500 bp reads launched {lb}")
    strip_launched(lb, "sw_full_warp", "--device-pass1 on 1,500 bp reads")
    print(f"# --device-pass1 on {N_DP1_LONG} reads of {LONG_READLEN} bp "
          f"(1.5% indels): SAM byte-identical to the host C lane, through "
          f"sw_full's strip path (sw_full_warp, the one-warp kernel)",
          flush=True)
    # (c) an index DeviceExact.make refuses: k15 s16 (nskip > wordlen, k >
    # 14) on the same genome
    from smalt_tpu_torch import cli
    idx15 = os.path.join(d, "idx15")
    if cli.main(["index", "-k", "15", "-s", "16", idx15,
                 os.path.join(d, "genome.fa")]) != 0:
        fail("index -k 15 -s 16")
    rng = np.random.default_rng(SEED + 9)
    reads, _, _ = make_reads(rng, genome, BATCH, READLEN)
    fq, _ = write_fastq(os.path.join(d, "dp1_k15.fq"), reads, b"f")
    runs = pass1_runs([("host C lane, k15 s16", []),
                       ("--device-exact, k15 s16", ["--device-exact"])],
                      idx15, fq, BATCH, card)
    lc, _, _, err = runs["--device-exact, k15 s16"]
    if "the --device-pass1 lane maps" not in err:
        fail(f"--device-exact on k15 s16: stderr names no pass-1 lane: "
             f"{err[:300]!r}")
    if lc["sw_full"] < 1:
        fail(f"--device-exact on k15 s16 launched {lc}")
    print(f"# --device-exact on a k15 s16 index (DeviceExact.make refuses): "
          f"the --device-pass1 lane ran (stderr says so), SAM byte-identical "
          f"to the host C lane on {BATCH} reads", flush=True)
    # (d) the step alone, windows past 2^31
    return la, lb, lc, check_far_windows(card)


def run_fast_options(d: str, card: str):
    """Phase 6b: `map --fast --resume` on phase 4's first BATCH reads in
    batches of RESUME_BATCH, killed after RESUME_TICKS checkpoints (the
    ResumeLog's tick raises) and run again: SAM byte-identical to an
    uninterrupted run, the sidecar gone; then `--profile DIR` on the same
    reads: a torch profiler trace under DIR (its kernel events counted)
    and the same SAM.  Returns the launches of the restarted run and of
    the profiled one."""
    from smalt_tpu_torch import resume as rz
    idx_name, fq = os.path.join(d, "idx"), os.path.join(d, "reads_head.fq")
    full = os.path.join(d, "resume_full.sam")
    map_cli("cuda", idx_name, full, [fq], RESUME_BATCH)
    want = sam_body(full)

    class Killed(Exception):
        pass

    tick, every, ticks = rz.ResumeLog.tick, rz.CHECKPOINT_BATCHES, [0]

    def dying_tick(self, *a):
        tick(self, *a)
        ticks[0] += 1
        if ticks[0] >= RESUME_TICKS:
            raise Killed()

    out = os.path.join(d, "resume.sam")
    argv = ["map", "--fast", "-f", "sam", "-o", out, "--resume", idx_name, fq]
    rz.CHECKPOINT_BATCHES = 1
    rz.ResumeLog.tick = dying_tick
    try:
        cli_run(argv, SMALT_FAST_BATCH=str(RESUME_BATCH))
        fail("--resume: the run was not killed")
    except Killed:
        pass
    finally:
        rz.ResumeLog.tick = tick
    kept = len(sam_body(out))
    if not os.path.exists(out + ".resume") or not 0 < kept < len(want):
        fail(f"--resume: killed run left {kept} records and no checkpoint")
    try:
        rc, err, rs, wall = cli_run(argv, SMALT_FAST_BATCH=str(RESUME_BATCH))
    finally:
        rz.CHECKPOINT_BATCHES = every
    if rc != 0 or sam_body(out) != want or os.path.exists(out + ".resume"):
        fail(f"--resume: the restarted run (exit {rc}) does not write the "
             f"uninterrupted run's SAM")
    print(f"# map --fast --resume on {BATCH} reads, batches of "
          f"{RESUME_BATCH}: killed after {RESUME_TICKS} checkpoints "
          f"({kept} records on disk), restarted: SAM byte-identical to the "
          f"uninterrupted run, {wall:.3f} s; launches {rs} | {card}",
          flush=True)
    prof = os.path.join(d, "prof")
    sam = os.path.join(d, "profiled.sam")
    rc, err, pf, wall = cli_run(["map", "--fast", "-f", "sam", "-o", sam,
                                 "--profile", prof, idx_name, fq],
                                SMALT_FAST_BATCH=str(RESUME_BATCH))
    traces = [os.path.join(prof, f) for f in os.listdir(prof)
              if f.endswith(".pt.trace.json")] if os.path.isdir(prof) else []
    if rc != 0 or len(traces) != 1 or sam_body(sam) != want:
        fail(f"--profile: exit {rc}, traces {traces}, SAM equal "
             f"{sam_body(sam) == want}")
    with open(traces[0]) as f:
        events = json.load(f).get("traceEvents", [])
    kern = sum(1 for e in events if e.get("cat") == "kernel")
    print(f"# map --fast --profile: trace {os.path.basename(traces[0])} "
          f"({os.path.getsize(traces[0])} bytes, {len(events)} events, "
          f"{kern} of them device kernels), SAM byte-identical, {wall:.3f} "
          f"s; launches {pf} | {card}", flush=True)
    return rs, pf


def run_very_long(d: str, genome, card: str):
    """Phase 11, on the phase-4 genome and index: (a) N_VLONG_FAST reads of
    VLONG_READLEN bp (phase 5's generator) through `map --fast -n POOL_N`
    on the card at the default batch (three windows a read through
    sw_band_many_kernel), its first N_VLONG records byte-identical to
    `--device cpu` on those reads; (b) those N_VLONG reads through `map
    --device-pass1` against the host C lane, SAM byte-identical, through
    sw_full's strip path at Q = 32,768, then again with ops/sw.py
    SCRATCH_BYTES lowered so that the scratch runs in groups; then
    N_VLONG reads of KEY_READLEN bp under -S KEY_SPEC, whose windows score
    past 2^23: (c) `map --fast` (the several-warps kernel) against
    --device cpu and (d) `map --device-pass1` (the WIDE score-only strips)
    against the host C lane; (e) BATCH reads of READLEN bp through `map
    --fast -S KEY_SHORT_SPEC` (sw_full's two-part record) against --device
    cpu; (f) R100K_N reads of R100K_LEN bp through `map --fast` on
    the card at the default batch (sw_band_cluster_kernel; the batch's pad
    reads take no rows), placed within LONG_TOL bp: reads
    this long take the plain versions minutes a batch on the CPU, so they
    are not compared with `--device cpu` (phase 3b holds the kernel
    against its plain version on windows of this shape).  Returns the
    launches of each device run."""
    from smalt_tpu_torch.ops import sw
    idx_name = os.path.join(d, "idx")
    rng = np.random.default_rng(SEED + 11)
    runs = {}
    for rl, n, spec, tag in ((VLONG_READLEN, N_VLONG_FAST, [], ""),
                             (KEY_READLEN, N_VLONG, ["-S", KEY_SPEC], " key")):
        reads, truth, rev = make_long_reads(rng, genome, n, rl)
        fq, fq_head = write_fastq(os.path.join(d, f"vlong{rl}.fq"), reads,
                                  b"v", head=N_VLONG)
        del reads
        sams = [os.path.join(d, f"vlong{rl}_{dev}.sam")
                for dev in ("cuda", "cpu")]
        pool = ["-n", str(POOL_N)] if n > N_VLONG else []
        t0 = time.perf_counter()
        runs["fast" + tag], wall, m = map_cli("cuda", idx_name, sams[0], [fq],
                                              BATCH, spec + pool)
        t1 = time.perf_counter()
        map_cli("cpu", idx_name, sams[1], [fq_head], N_VLONG, spec)
        body = sam_body(sams[0])
        if len(body) != n or body[:N_VLONG] != sam_body(sams[1]):
            fail(f"--fast {' '.join(spec)} on {rl} bp reads: SAM differs "
                 f"from --device cpu")
        want = "sw_band_track_many" if not tag else "sw_band_track_wide"
        if runs["fast" + tag][want] < 1:
            fail(f"--fast on {rl} bp reads launched {runs['fast' + tag]}")
        placed = placement(body, truth, rev, LONG_TOL)
        print(f"# map --fast {' '.join(spec + pool)} on {n} reads of {rl} bp "
              f"(batch {BATCH}): the first {N_VLONG} records byte-identical "
              f"to --device cpu ({t1 - t0:.1f} s on the card, {n / wall:.1f} "
              f"CLI reads/s, pipeline {m.group(4) if m else '?'} reads/s; "
              f"{time.perf_counter() - t1:.1f} s on the CPU for "
              f"{N_VLONG}); placed {placed}/{n} within {LONG_TOL} bp; "
              f"launches {runs['fast' + tag]} | {card}", flush=True)
        cases = [(f"host C lane, {rl} bp", spec),
                 (f"--device-pass1, {rl} bp", spec + ["--device-pass1"])]
        got = pass1_runs(cases, idx_name, fq_head, N_VLONG, card,
                         SMALT_DP1_BATCH=str(VLONG_DP1_BATCH))
        runs["dp1" + tag] = got[cases[1][0]][0]
        # 4 x VLONG_DP1_BATCH windows: the wavefront
        want = "sw_full_strip" + ("_wide" if tag else "")
        strip_launched(runs["dp1" + tag], want,
                       f"--device-pass1 on {rl} bp reads")
        print(f"# --device-pass1 {' '.join(spec)} on {N_VLONG} reads of {rl} "
              f"bp: SAM byte-identical to the host C lane, through {want}",
              flush=True)
        if tag:
            continue
        budget = sw.SCRATCH_BYTES
        sw.SCRATCH_BYTES = 8 * 32768 * VLONG_DP1_BATCH
        try:
            got = pass1_runs([(f"--device-pass1, {rl} bp, scratch in groups",
                               ["--device-pass1"])], idx_name, fq_head,
                             N_VLONG, card,
                             SMALT_DP1_BATCH=str(VLONG_DP1_BATCH))
        finally:
            sw.SCRATCH_BYTES = budget
        # pass1_runs wrote this run's SAM over the host lane's (dp1_0.sam);
        # dp1_1.sam is the first --device-pass1 run's, equal to the host's
        same = sam_body(os.path.join(d, "dp1_0.sam")) == \
            sam_body(os.path.join(d, "dp1_1.sam"))
        runs["dp1 groups"] = next(iter(got.values()))[0]
        if not same:
            fail("--device-pass1 with the scratch in groups: SAM differs "
                 "from the first run")
        strip_launched(runs["dp1 groups"], "sw_full_strip",
                       "--device-pass1 with the scratch in groups", 2)
        print(f"# --device-pass1 on {rl} bp reads with the strip scratch "
              f"budget at {8 * 32768 * VLONG_DP1_BATCH} bytes: "
              f"{runs['dp1 groups']['sw_full_strip']} strip launches "
              f"(sw_full_strip), SAM byte-identical | {card}", flush=True)
    reads, truth, rev = make_reads(rng, genome, BATCH, READLEN)
    fq, _ = write_fastq(os.path.join(d, "keyshort.fq"), reads, b"k")
    spec = ["-S", KEY_SHORT_SPEC]
    sams = [os.path.join(d, f"keyshort_{dev}.sam") for dev in ("cuda", "cpu")]
    runs["fast key short"], wall, _ = map_cli("cuda", idx_name, sams[0],
                                              [fq], BATCH, spec)
    map_cli("cpu", idx_name, sams[1], [fq], BATCH, spec)
    body = sam_body(sams[0])
    if len(body) != BATCH or body != sam_body(sams[1]):
        fail(f"--fast -S {KEY_SHORT_SPEC}: SAM differs from --device cpu")
    if runs["fast key short"]["sw_full_track_rec"] < 1:
        fail(f"--fast -S {KEY_SHORT_SPEC} launched {runs['fast key short']}")
    print(f"# map --fast -S {KEY_SHORT_SPEC} on {BATCH} reads of {READLEN} "
          f"bp: SAM byte-identical to --device cpu, {wall:.3f} s on the card; "
          f"placed {placement(body, truth, rev)}/{BATCH} within {PLACE_TOL} "
          f"bp; launches {runs['fast key short']} | {card}", flush=True)
    # (f) reads whose band passes 16,384 lanes (the band kernel
    # sw_band_instance routes them to), at the default batch: the pipeline
    # pads the batch to its size, and the pad reads' windows take no rows
    # (mesh.py pad_read_slens)
    reads, truth, rev = make_long_reads(rng, genome, R100K_N,
                                        R100K_LEN)
    fq, _ = write_fastq(os.path.join(d, "vlong100k.fq"), reads, b"t")
    sam = os.path.join(d, "vlong100k.sam")
    runs["fast 100 kb"], wall, m = map_cli("cuda", idx_name, sam, [fq],
                                           BATCH)
    body = sam_body(sam)
    placed = placement(body, truth, rev, LONG_TOL)
    Q100 = max(len(r) for r in reads)
    Q100 = -(-Q100 // 16) * 16
    S100, _, W100 = sw.band_geometry(Q100)
    routed = sw.sw_band_instance(Q100, S100, W100, sw.device_matrix(
        np.eye(8, dtype=np.int32), "cpu"), True)
    if len(body) != R100K_N or placed != R100K_N or \
            runs["fast 100 kb"][routed] < 1:
        fail(f"--fast on {R100K_N} reads of {R100K_LEN} bp: "
             f"{len(body)} records, {placed} placed, launches "
             f"{runs['fast 100 kb']} ({routed} expected)")
    print(f"# map --fast on {R100K_N} reads of {R100K_LEN} bp (bands "
          f"past 16,384 lanes, {routed}) at the default batch ({BATCH}): "
          f"{wall:.1f} s on the card, pipeline {m.group(3) if m else '?'} s "
          f"(a one-block tiled kernel, PERF.md: 344.3 s at this batch, 10.1 s "
          f"at a batch of {R100K_N}), placed {placed}/{R100K_N} within "
          f"{LONG_TOL} bp; launches {runs['fast 100 kb']} | {card}",
          flush=True)
    # where that run's time goes: the step on the 2 reads alone and
    # padded to the batch, and the host tail
    from smalt_tpu_torch.map.fastmode import iter_fastq_hybrid
    batch_split(f"--fast {R100K_N} x {R100K_LEN} bp", idx_name,
                next(iter(iter_fastq_hybrid(fq, BATCH))), False, "cuda", card,
                pad_to=BATCH, reps=3)
    return runs


def run_bigk(d: str, genome, card: str):
    """Phase 12: `map --fast` on split-word indexes (BIGK: k = 16 and 20,
    step 13) of the phase-4 genome: BATCH reads of READLEN bp (sw_full)
    and N_BIGK_LONG reads of LONG_READLEN bp (sw_band), each run on the
    card byte-identical to `--device cpu`; placement printed.  Returns the
    launches of each card run, by (k, read length)."""
    from smalt_tpu_torch import cli
    rng = np.random.default_rng(SEED + 12)
    short = make_reads(rng, genome, BATCH, READLEN)
    long_ = make_long_reads(rng, genome, N_BIGK_LONG, LONG_READLEN)
    fq_s, _ = write_fastq(os.path.join(d, "bigk_short.fq"), short[0], b"b")
    fq_l, _ = write_fastq(os.path.join(d, "bigk_long.fq"), long_[0], b"l")
    runs = {}
    for k, step in BIGK:
        idx_name = os.path.join(d, f"idx{k}")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(["index", "-k", str(k), "-s", str(step), idx_name,
                           os.path.join(d, "genome.fa")])
        if rc != 0:
            fail(f"index -k {k} -s {step}")
        for rl, fq, (_, truth, rev), n, tol, want in (
                (READLEN, fq_s, short, BATCH, PLACE_TOL, "sw_full_track"),
                (LONG_READLEN, fq_l, long_, N_BIGK_LONG, LONG_TOL,
                 "sw_band_track")):
            sams = [os.path.join(d, f"bigk{k}_{rl}_{dev}.sam")
                    for dev in ("cuda", "cpu")]
            t0 = time.perf_counter()
            got, wall, _ = map_cli("cuda", idx_name, sams[0], [fq], BATCH)
            t1 = time.perf_counter()
            map_cli("cpu", idx_name, sams[1], [fq], n)     # no pad rows
            body = sam_body(sams[0])
            if len(body) != n or body != sam_body(sams[1]):
                fail(f"--fast on a k{k} s{step} index, {rl} bp reads: SAM "
                     f"differs from --device cpu")
            if got[want] < 1:
                fail(f"--fast on a k{k} index, {rl} bp reads: launched {got}")
            runs[(k, rl)] = got
            print(f"# map --fast, k{k} s{step} (split-word index) on {n} "
                  f"reads of {rl} bp: SAM byte-identical to --device cpu "
                  f"({t1 - t0:.1f} s on the card, "
                  f"{time.perf_counter() - t1:.1f} s on the CPU); placed "
                  f"{placement(body, truth, rev, tol)}/{n} within {tol} bp; "
                  f"launches {got} | {card}", flush=True)
    return runs


def run_exact_device_hits(d: str, genome, card: str):
    """Phase 13: `map --device-exact` on a DXH_INDEX (k13 s16) index of the
    phase-4 genome, nskip > wordlen, where the collate step expands the
    hits on the device: BATCH reads of PAIR_READLEN bp through the host C
    lane and the lane
    (SMALT_DX_P2 unset and =1), BATCH // 2 pairs through the host C pair
    lane and the lane, SAM byte-identical with no batch rendered on the
    host; the five collate outputs (the hit-info checksum included) of a
    first batch of DXH_CHECK_B reads held against the port's CPU step, and
    the step timed.
    Returns the launches of the three device runs."""
    from smalt_tpu_torch import cli
    from smalt_tpu_torch.index.table import KmerIndex
    from smalt_tpu_torch.map.engine import MapEngine, MapParams
    from smalt_tpu_torch.map.fastlane import DeviceExact
    from smalt_tpu_torch.map.fastmode import iter_fastq_batches
    from smalt_tpu_torch.seq.refset import RefSet
    k, step = DXH_INDEX
    idx_name = os.path.join(d, f"idx{k}s{step}")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["index", "-k", str(k), "-s", str(step), idx_name,
                       os.path.join(d, "genome.fa")])
    if rc != 0:
        fail(f"index -k {k} -s {step}")
    rng = np.random.default_rng(SEED + 13)
    # 150 bp reads: at nskip = 16 a 100 bp read's pass-1 window passes the
    # 128-column pad of reads up to 128 bp, and every read would re-stage
    reads, _, _ = make_reads(rng, genome, BATCH, PAIR_READLEN)
    fq, _ = write_fastq(os.path.join(d, "dxh.fq"), reads, b"h")
    _, launches, totals, _ = exact_lane_runs(d, idx_name, fq, BATCH, card,
                                             tag="dxh")
    for label, m in totals.items():
        if m is not None:
            print(f"# device hit expansion, {label}: n_restaged {m.group(2)} "
                  f"of {BATCH}, p2_hit {m.group(5)}", flush=True)
    refset, idx = RefSet.load(idx_name), KmerIndex.load(idx_name)
    eng = MapEngine(refset, idx, MapParams())
    dev, cpu = (DeviceExact.make(eng, "sam", True, False, False, False,
                                 batch=DXH_CHECK_B, device=x)
                for x in ("cuda", "cpu"))
    if dev is None or dev._host_hits:
        fail(f"--device-exact on k{k} s{step}: not the device hit expansion")
    raw = next(iter(iter_fastq_batches(fq, dev.batch)))
    host, dargs = dev._prepare(*raw)
    outs = dev._collate_outputs(dargs)
    col = dev._collate_fn()
    col_ms = time_ms(lambda: col(*dargs), 3, warm=1)
    t0 = time.perf_counter()
    _, cargs = cpu._prepare(*raw)
    collate_equal(outs, cpu._collate_outputs(cargs),
                  "the first batch of phase 13")
    print(f"# device hit expansion, one batch of {len(raw[0])} reads: "
          f"collate step {col_ms:.3f} ms (CUDA events, 3 calls; Q="
          f"{dev._cfg.Q}, H={dev._cfg.H}, V={dev._cfg.V}, pool "
          f"{dev._cfg.pool}); its five outputs (pool, counts2, scores, cksum, "
          f"fallback: {int(outs[4][:len(raw[0])].sum())} reads flagged) "
          f"equal to the port's CPU step ({time.perf_counter() - t0:.1f} s "
          f"on the host) | {card}", flush=True)
    npairs = BATCH // 2
    m1, m2, _, _ = make_pairs(rng, genome, npairs, PAIR_READLEN)
    m2[::10] = ACGT[rng.integers(0, 4, m2[::10].shape)]
    fq1, _ = write_fastq(os.path.join(d, "dxh_1.fq"), m1, b"p")
    fq2, _ = write_fastq(os.path.join(d, "dxh_2.fq"), m2, b"p")
    plaunch, ptotals = exact_pair_runs(d, idx_name, fq1, fq2, npairs, card,
                                       tag="dxh")
    m = ptotals["--device-exact"]
    print(f"# device hit expansion on {npairs} pairs: SAM byte-identical to "
          f"the host C pair lane, n_restaged {m.group(2)} of {2 * npairs} "
          f"mates", flush=True)
    return (launches["--device-exact"],
            launches["--device-exact SMALT_DX_P2=1"],
            plaunch["--device-exact"])


def mesh_pipe(what: str, mesh, refset, idx, reads, batch: int,
              device: str = "cuda"):
    """run_fast_pipeline over `mesh` (an spmd.Mesh, or None for one
    device) on reads ([fq] or [fq, mates]), the launch counts set to 0
    just before and read just after.  Returns (SAM records, launches,
    wall seconds)."""
    import torch
    from smalt_tpu_torch.map.fastmode import run_fast_pipeline
    from smalt_tpu_torch.ops import sw
    for k in sw.launches:
        sw.launches[k] = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    run_fast_pipeline(refset, idx, reads[0], buf, batch=batch, device=device,
                      mesh_spec=mesh, mates_path=(reads[1] if len(reads) > 1
                                                  else None))
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return buf.getvalue().splitlines(), dict(sw.launches), wall


def make_corpus(d: str):
    """__graft_entry__.py:149-234's corpus, made the same way (seed 11):
    a 1 Mb genome with 40 dispersed near-identical copies of a 700 bp
    unit, and 10,000 reads of 100 bp (1% substitutions, half
    reverse-complemented).  Returns (fasta, fastq)."""
    n_bp, n_reads, _ = CORPUS
    rng = np.random.default_rng(11)
    bases = np.array(list(b"ACGT"), np.uint8)
    g = rng.choice(bases, n_bp)
    unit = rng.choice(bases, 700)
    for _ in range(40):
        cp = unit.copy()
        for j in rng.integers(0, 700, 7):
            cp[j] = bases[int(rng.integers(0, 4))]
        at = int(rng.integers(0, len(g) - 700))
        g[at : at + 700] = cp
    gtxt = g.tobytes().decode()
    fa = os.path.join(d, "corpus.fa")
    with open(fa, "w") as f:
        f.write(">corpus\n")
        for i in range(0, len(gtxt), 80):
            f.write(gtxt[i : i + 80] + "\n")
    comp = str.maketrans("ACGT", "TGCA")
    recs = []
    for i in range(n_reads):
        st = int(rng.integers(0, len(gtxt) - 100))
        seg = list(gtxt[st : st + 100])
        for j in np.flatnonzero(rng.random(100) < 0.01):
            seg[j] = "ACGT"[int(rng.integers(0, 4))]
        seg = "".join(seg)
        if rng.random() < 0.5:
            seg = seg.translate(comp)[::-1]
        recs.append(f"@e{i}\n{seg}\n+\n{'5' * 100}\n")
    fq = os.path.join(d, "corpus.fq")
    with open(fq, "w") as f:
        f.write("".join(recs))
    return fa, fq


def mesh_steps(d: str, refset, idx, card: str):
    """Phase 14 (a) and (g): each MESH_STEPS step on phase 4's first
    batch, every member on cuda:0, all 12 OUT_KEYS equal to the
    single-device CUDA step and to the same mesh's CPU step; its time
    beside the single-device step's, the bytes its collectives moved and
    the card's memory."""
    import torch
    from smalt_tpu_torch.align import core as ali
    from smalt_tpu_torch.map.fastmode import (RawBatch, encode_batch,
                                              get_device_step,
                                              iter_fastq_hybrid)
    from smalt_tpu_torch.parallel import mesh as pm
    from smalt_tpu_torch.parallel.spmd import Mesh
    first = next(iter(iter_fastq_hybrid(os.path.join(d, "reads_head.fq"),
                                        BATCH)))
    Q = max(32, -(-READLEN // 16) * 16)
    arr = torch.from_numpy(first.encode(Q) if isinstance(first, RawBatch)
                           else encode_batch(first[1], Q))
    reads = arr.cuda()
    single = get_device_step(refset, idx, "cuda", (1, -2, -4, -3))
    want = single(reads).cpu()
    single_ms = time_ms(lambda: single(reads), 5)
    m, go, ge = ali.make_score_matrix()
    di = pm.DeviceIndex.build(refset, idx, "cpu")
    sdis = {}
    print(f"# phase 14 (a): members that share one card measure the cost of "
          f"the replicated work and of the collectives, not a scaling; the "
          f"single-device step {single_ms:.3f} ms a batch of {BATCH} reads "
          f"(Q={Q}, CUDA events, 5 calls) | {card}", flush=True)
    for kind, dp, ip in MESH_STEPS:
        if kind == "replicated":
            def make(mesh):
                return pm.make_sharded_step(di, mesh, m, -go, -ge, pack=True)
        else:
            if ip not in sdis:
                sdis[ip] = pm.ShardedDeviceIndex.build(refset, idx, ip)

            def make(mesh):
                return pm.make_index_sharded_step(sdis[ip], mesh, m, -go, -ge,
                                                  pack=True)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        cu = Mesh(dp, ip, ["cuda:0"] * (dp * ip))
        step = make(cu)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated() - before
        torch.cuda.reset_peak_memory_stats()
        got = pm.join_parts(step(reads))
        moved = cu.moved
        peak = torch.cuda.max_memory_allocated() - before
        ms = time_ms(lambda: step(reads), 5)
        t0 = time.perf_counter()
        got_cpu = pm.join_parts(make(Mesh(dp, ip, ["cpu"] * (dp * ip)))(arr))
        cpu_s = time.perf_counter() - t0
        for what, x in (("the single-device CUDA step", want),
                        ("the same mesh's CPU step", got_cpu)):
            if not torch.equal(got, x):
                bad = (got != x).any(dim=1).nonzero().flatten()
                fail(f"{kind} step on {dp}x{ip}: packed output differs from "
                     f"{what} in rows {bad.tolist()} (OUT_KEYS order)")
        print(f"# mesh step {kind} {dp}x{ip} (members on cuda:0), one batch "
              f"of {BATCH} reads: all 12 OUT_KEYS equal to the single-device "
              f"CUDA step and to its CPU step ({cpu_s:.1f} s on the host); "
              f"{ms:.3f} ms a batch (single device {single_ms:.3f} ms, "
              f"{ms / single_ms:.2f}x); collectives moved {moved} bytes a "
              f"batch; each member's index {resident // (dp * ip)} bytes "
              f"resident; the card's peak over the step {peak} bytes above "
              f"the resident ones | {card}", flush=True)
        del step
        torch.cuda.empty_cache()


def run_mesh(d: str, genome, card: str):
    """Phase 14: map --fast over device meshes with every member on cuda:0
    (spmd.Mesh's device list), on phase 4's genome and index.  (a) and (g)
    mesh_steps.  (b) MESH_SE_READS of phase 4's reads through
    run_fast_pipeline on MESH_SE, SAM byte-identical to phase 4's (the
    single device); phase 6's first 4,096 pairs on 1 x 2 == phase 6's
    records; phase 12's k16 s13 index on 1 x 2 == phase 12's SAM.  (c)
    N_MESH_LONG reads of LONG_READLEN bp on 1 x 2, every MESH_CUT_EVERY-th
    starting within a window (1,792 bases) before the cut: the SAM equals
    the same mesh's --device cpu run, sw_full's strip path launched
    (the index-sharded step scores full-matrix, as smalt_tpu's does), the
    records that differ from the single-device (banded) run counted; on
    2 x 1 (replicated, banded: sw_band) == the single device; the
    strip kernel at Q = 1,504 (STRIP_Q1504) held against its plain version
    and timed beside its bound.  (d) the corpus oracle on CORPUS_MESHES ==
    the single device.  (e) MESH_HOSTS processes through the CLI under
    SMALT_TPU_* (gloo on 127.0.0.1), then merge-shards == phase 4's SAM.
    (f) --mesh 2,2 with fewer than 4 cards visible exits non-zero naming
    the count.  Returns the launches of the mapping runs by label."""
    import torch
    from smalt_tpu_torch import cli
    from smalt_tpu_torch.align import core as ali
    from smalt_tpu_torch.index.table import KmerIndex
    from smalt_tpu_torch.ops import bounds, sw
    from smalt_tpu_torch.parallel.mesh import window_len
    from smalt_tpu_torch.parallel.spmd import Mesh
    from smalt_tpu_torch.seq.refset import RefSet
    idx_name = os.path.join(d, "idx")
    refset, idx = RefSet.load(idx_name), KmerIndex.load(idx_name)
    t0 = time.perf_counter()
    mesh_steps(d, refset, idx, card)
    print(f"# phase 14 (a): {time.perf_counter() - t0:.2f} s", flush=True)
    runs = {}

    def on_card(dp, ip):
        return Mesh(dp, ip, ["cuda:0"] * (dp * ip))

    # (b)
    fq = os.path.join(d, "mesh_se.fq")
    with open(os.path.join(d, "reads.fq"), "rb") as src, open(fq, "wb") as f:
        for _ in range(4 * MESH_SE_READS):
            f.write(src.readline())
    head = sam_body(os.path.join(d, "out_cuda.sam"))[:MESH_SE_READS]
    pairs = sam_body(os.path.join(d, "pairs_cuda.sam"))[: 2 * PAIR_HEAD]
    k16 = sam_body(os.path.join(d, "bigk16_100_cuda.sam"))
    idx16 = KmerIndex.load(os.path.join(d, "idx16"))
    for label, (dp, ip), ix, reads, want in (
            (f"{MESH_SE_READS} reads", MESH_SE, idx, [fq], head),
            (f"{PAIR_HEAD} pairs", (1, 2), idx,
             [os.path.join(d, f"pairs_{i}_head.fq") for i in (1, 2)], pairs),
            ("k16 s13", (1, 2), idx16, [os.path.join(d, "bigk_short.fq")],
             k16)):
        got, launches, wall = mesh_pipe(label, on_card(dp, ip), refset, ix,
                                        reads, BATCH)
        if got != want:
            fail(f"--fast over {dp}x{ip}, {label}: SAM differs from the "
                 f"single-device run")
        if launches["sw_full_track"] < 1:
            fail(f"--fast over {dp}x{ip}, {label}: launched {launches}")
        runs[f"--fast mesh {dp}x{ip} {label}"] = (launches, len(want))
        print(f"# map --fast over {dp}x{ip} (members on cuda:0), {label}: "
              f"SAM byte-identical to the single-device run; {len(want)} "
              f"records in {wall:.2f} s; launches {launches} | {card}",
              flush=True)

    # (c)
    L = refset.total_len
    chunk = -(-L // 2)
    cut = -(-chunk // NSKIP) * NSKIP
    S = window_len(-(-LONG_READLEN // 16) * 16)
    rng = np.random.default_rng(SEED + 14)
    pos = rng.integers(0, len(genome) - LONG_READLEN - 100, N_MESH_LONG)
    pos[::MESH_CUT_EVERY] = rng.integers(cut - S, cut,
                                         len(pos[::MESH_CUT_EVERY]))
    lreads, truth, rev = make_long_reads(rng, genome, N_MESH_LONG,
                                         LONG_READLEN, pos)
    lfq, _ = write_fastq(os.path.join(d, "mesh_long.fq"), lreads, b"x")
    got, launches, wall = mesh_pipe("long", on_card(1, 2), refset, idx,
                                    [lfq], N_MESH_LONG)
    t0 = time.perf_counter()
    cpu, _, _ = mesh_pipe("long cpu", Mesh(1, 2, ["cpu", "cpu"]), refset,
                          idx, [lfq], N_MESH_LONG, device="cpu")
    cpu_s = time.perf_counter() - t0
    one, _, _ = mesh_pipe("long single", None, refset, idx, [lfq],
                          N_MESH_LONG)
    dp_only, dl, dwall = mesh_pipe("long 2x1", on_card(2, 1), refset, idx,
                                   [lfq], N_MESH_LONG)
    if dp_only != one or dl["sw_band_track"] < 1:
        fail(f"--fast over 2x1 on kilobase reads: SAM differs from the "
             f"single-device run, or launched {dl}")
    runs[f"--fast mesh 2x1 {LONG_READLEN} bp"] = (dl, N_MESH_LONG)
    print(f"# map --fast over 2x1 (members on cuda:0, the index "
          f"replicated: banded), the same {N_MESH_LONG} reads: SAM "
          f"byte-identical to the single-device run; {dwall:.2f} s; "
          f"launches {dl} | {card}", flush=True)
    if got != cpu or len(got) != N_MESH_LONG:
        fail("--fast over 1x2 on kilobase reads: SAM differs from the same "
             "mesh's --device cpu run")
    # 3 x 256 windows over 2 members: the wavefront
    if launches["sw_band_track"]:
        fail(f"--fast over 1x2 on kilobase reads: launched {launches}")
    strip_launched(launches, "sw_full_track_strip",
                   "--fast over 1x2 on kilobase reads")
    runs[f"--fast mesh 1x2 {LONG_READLEN} bp"] = (launches, N_MESH_LONG)
    differ = sum(a != b for a, b in zip(got, one))
    near = sum(a != b for a, b in list(zip(got, one))[::MESH_CUT_EVERY])
    print(f"# map --fast over 1x2 (members on cuda:0), {N_MESH_LONG} reads of "
          f"{LONG_READLEN} bp ({len(pos[::MESH_CUT_EVERY])} starting within "
          f"{S} bases before the cut at {cut}): SAM byte-identical to the "
          f"same mesh's --device cpu run ({cpu_s:.1f} s on the host); "
          f"{differ} of {N_MESH_LONG} records differ from the single-device "
          f"(banded) run ({near} of the reads near the cut); placed "
          f"{placement(got, truth, rev, LONG_TOL)}/{N_MESH_LONG} within "
          f"{LONG_TOL} bp (single device "
          f"{placement(one, truth, rev, LONG_TOL)}); {wall:.2f} s; launches "
          f"{launches} | {card}", flush=True)
    Q, S, B = STRIP_Q1504
    m, go, ge = ali.make_score_matrix()
    mat = sw.device_matrix(m, "cuda")
    q, s, sl = (torch.from_numpy(x).cuda()
                for x in kernel_windows(rng, B, Q, S))
    got_k = sw.sw_full_cuda(q, s, sl, mat, -go, -ge, track=True)
    want_k = sw.sw_score_ref(q, s, sl, mat.t, -go, -ge, track=True)
    if any(not torch.equal(a, b) for a, b in zip(got_k, want_k)):
        fail(f"sw_full strips at Q={Q} S={S}: differ from sw_score_ref")
    k_ms = time_ms(lambda: sw.sw_full_cuda(q, s, sl, mat, -go, -ge,
                                           track=True), 5)
    print(bound_line(f"{sw.sw_full_instance(B, Q, S, mat, True)} Q={Q} "
                     f"S={S} B={B} (planted "
                     f"windows; 2 strips of 512 columns and a last one of "
                     f"{Q - 2 * sw.MAX_Q}, {sw.strip_warps(B, Q, S)} warp(s) "
                     f"a window; equal to sw_score_ref)",
                     bounds.sw_full_work(Q, S, sl, True, q), k_ms, card),
          flush=True)

    # (d)
    t0 = time.perf_counter()
    cfa, cfq = make_corpus(d)
    cidx = os.path.join(d, "corpus_idx")
    with contextlib.redirect_stdout(io.StringIO()):
        if cli.main(["index", "-k", "13", "-s", "2", cidx, cfa]) != 0:
            fail("index of the corpus")
    crs, cix = RefSet.load(cidx), KmerIndex.load(cidx)
    batch = CORPUS[2]
    single, _, wall1 = mesh_pipe("corpus", None, crs, cix, [cfq], batch)
    for dp, ip in CORPUS_MESHES:
        got, launches, wall = mesh_pipe("corpus", on_card(dp, ip), crs, cix,
                                        [cfq], batch)
        if got != single or len(got) != CORPUS[1]:
            fail(f"the corpus oracle over {dp}x{ip}: SAM differs from the "
                 f"single device")
        runs[f"--fast mesh {dp}x{ip} corpus"] = (launches, CORPUS[1])
        print(f"# the corpus oracle (__graft_entry__.py:149-234: {CORPUS[1]} "
              f"reads, repeat-planted {CORPUS[0]} bp genome, k13 s2, batch "
              f"{batch}) over {dp}x{ip} (members on cuda:0): SAM "
              f"byte-identical to the single device ({wall:.2f} s against "
              f"{wall1:.2f} s); {sum(1 for ln in got if int(ln.split(chr(9))[4]) > 6)}"
              f" records at mapq > 6; launches {launches} | {card}",
              flush=True)
    print(f"# phase 14 (d): {time.perf_counter() - t0:.2f} s", flush=True)

    # (e)
    t0 = time.perf_counter()
    out = os.path.join(d, "hosts.sam")
    with __import__("socket").socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = []
    try:
        for h in range(MESH_HOSTS):
            env = dict(os.environ, PYTHONPATH=ROOT,
                       SMALT_TPU_COORD=f"127.0.0.1:{port}",
                       SMALT_TPU_NPROCS=str(MESH_HOSTS),
                       SMALT_TPU_PROCID=str(h), SMALT_FAST_BATCH=str(BATCH))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "smalt_tpu_torch.cli", "map", "--fast",
                 "-o", out, idx_name, fq], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for h, p in enumerate(procs):
            _, err = p.communicate(timeout=300)
            if p.returncode != 0:
                fail(f"host {h} of {MESH_HOSTS} exited {p.returncode}: "
                     f"{err[-800:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    merged = os.path.join(d, "hosts_merged.sam")
    rc, err, _, _ = cli_run(["merge-shards", merged] +
                            [f"{out}.shard{h}" for h in range(MESH_HOSTS)])
    if rc != 0:
        fail(f"merge-shards exited {rc}: {err[-400:]}")

    def lines(p, n=None):
        with open(p) as f:
            return [ln for ln in f.read().splitlines()
                    if not ln.startswith("@PG")][:n]

    want = lines(os.path.join(d, "out_cuda.sam"))
    want = [ln for ln in want if ln.startswith("@")] + head
    if lines(merged) != want:
        fail(f"{MESH_HOSTS} hosts + merge-shards: SAM differs from the "
             f"single-host run")
    print(f"# {MESH_HOSTS} processes on cuda:0 through the CLI (SMALT_TPU_COORD"
          f" 127.0.0.1:{port}, gloo), {MESH_SE_READS} reads in batches of "
          f"{BATCH} striped over them, then merge-shards: {err.strip()}; SAM "
          f"byte-identical to the single-host run (@PG aside); "
          f"{time.perf_counter() - t0:.2f} s | {card}", flush=True)

    # (f)
    n_vis = torch.cuda.device_count()
    if n_vis < 4:
        rc, err, _, _ = cli_run(["map", "--fast", "--mesh", "2,2", "-o",
                                 os.path.join(d, "refused.sam"), idx_name,
                                 fq])
        if rc == 0 or f"{n_vis} visible" not in err:
            fail(f"--mesh 2,2 on {n_vis} visible cards: exit {rc}, {err!r}")
        print(f"# --mesh 2,2 with {n_vis} card(s) visible: exit {rc}, "
              f"{err.strip()}", flush=True)
    return runs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from smalt_tpu_torch.align import core as ali
    from smalt_tpu_torch.ops import build, sw

    card = card_line()
    nv = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                        text=True).stdout.strip().splitlines()
    print(f"# toolchain: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | nvcc: {nv[-1] if nv else '?'} | "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    names = ["sw_full", "sw_band", "swq"]
    with ThreadPoolExecutor(len(names)) as pool:    # one nvcc each, together
        list(pool.map(sw._kernel_lib, names))
    for name in names:
        info = build.build_info[name]
        print(f"# build {name}.cu: nvcc {info['seconds']:.2f} s; "
              f"{ptxas_summary(info['log'])}", flush=True)
    for src, kernel, what in (("sw_band", "sw_band_multi",
                               "the several-warps kernel"),
                              ("sw_full", "sw_strip", "the one-warp strip "
                               "kernel"),
                              ("sw_full", "sw_wave", "the strip wavefront"),
                              ("sw_band", "sw_band_strips",
                               "the band's strip kernel")):
        spilled = ptxas_summary(build.build_info[src]["log"], kernel)
        if not spilled.endswith("spill bytes 0"):
            fail(f"{what} spills: {spilled}")
    print(f"# phase 2 (build, side by side): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    err, k_full_t, k_full = check_kernel(rng, card)
    werr, k_wfull_t, k_wfull = check_wide_full(rng, card)
    serr, k_strip = check_strip(rng, card)
    ferr, k_far = check_strip_far(rng, card)
    qend_err, k_qend = check_strip_qend(rng, card)
    serr = max(serr, ferr, qend_err)
    # the wavefront's entries: at STRIP_FAR (the record at KEY_SHAPE), its
    # times on 20 kb reads and on a full batch (STRIP_TIME) beside them
    for name, at in k_qend.items():
        k_far[name]["qend"] = at
    for name, at in k_strip.items():
        if name in k_far:
            k_far[name]["full_batch"] = at
    print(f"# phase 3 (sw_full against plain): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    berr, k_band_t, k_band, k_many_t, k_many = check_band_kernel(rng, card)
    wberr, k_wband_t, k_wband = check_wide_band(rng, card)
    m_, go_, ge_ = ali.make_score_matrix()
    terr, k_clu_t, k_clu, k_s100_t, k_s100 = check_band_past_16384(
        rng, sw.device_matrix(m_, "cuda"), -go_, -ge_, card)
    serr_b, k_strips_t, k_strips = check_band_strips(
        rng, sw.device_matrix(m_, "cuda"), -go_, -ge_, card)
    # the strip kernel's entries: at its own route (700 kb windows), and on
    # the 100 kb windows beside the cluster kernel
    k_strips_t["at_100kb"], k_strips["at_100kb"] = k_s100_t, k_s100
    eerr = check_eterm(rng, card)
    berr, terr = max(berr, eerr), max(terr, eerr, serr_b)
    check_cluster_occupancy(card)
    print(f"# phase 3b (sw_band against plain): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    t0 = time.perf_counter()
    qerr, k_swq = check_swq_kernel(rng, card)
    print(f"# phase 3c (swq against plain): "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    d = os.path.join(ROOT, "build", "smoke")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    try:
        t0 = time.perf_counter()
        se = run_main_path(d, "cuda", N_READS, GENOME_LEN, card)
        print(f"# phase 4 (single-end): {time.perf_counter() - t0:.2f} s",
              flush=True)
        genome = make_genome(np.random.default_rng(SEED), GENOME_LEN)
        t0 = time.perf_counter()
        lr, lrn = run_long_reads(d, genome, card)
        print(f"# phase 5 (long reads): {time.perf_counter() - t0:.2f} s",
              flush=True)
        t0 = time.perf_counter()
        mid = run_mid_reads(d, genome, card)
        print(f"# phase 5b (reads of {MID_READLEN} bp): "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        t0 = time.perf_counter()
        pe, pen = run_pairs(d, genome, card)
        print(f"# phase 6 (pairs): {time.perf_counter() - t0:.2f} s",
              flush=True)
        t0 = time.perf_counter()
        rs, pf = run_fast_options(d, card)
        print(f"# phase 6b (--resume, --profile): "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        t0 = time.perf_counter()
        dx, dx0, dxb, qerr7, hostx = run_exact(d, genome, card)
        qerr = max(qerr, qerr7)
        print(f"# phase 7 (device-exact): {time.perf_counter() - t0:.2f} s",
              flush=True)
        t0 = time.perf_counter()
        qerr = max(qerr, check_lane_bands(d, genome, card))
        print(f"# phase 7b (lane band widths): "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        t0 = time.perf_counter()
        dxt, cerr, k_seg = check_repeat_tier(d, card)
        print(f"# phase 7c (the repeat tier, segcand): "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        t0 = time.perf_counter()
        wf, wx, wp = run_wide_matrix(d, genome, card)
        print(f"# phase 8 (-S {WIDE_SPEC}): {time.perf_counter() - t0:.2f} s",
              flush=True)
        t0 = time.perf_counter()
        pdx = run_exact_pairs(d, genome, card)
        print(f"# phase 9 (paired device-exact): "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        t0 = time.perf_counter()
        dp1, dp1l, dp1x, ferr = run_pass1(d, genome, card, hostx)
        err = max(err, ferr)
        print(f"# phase 10 (--device-pass1): {time.perf_counter() - t0:.2f} s",
              flush=True)
        t0 = time.perf_counter()
        vl = run_very_long(d, genome, card)
        print(f"# phase 11 (reads over 16 kb, scores past 2^23): "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        t0 = time.perf_counter()
        bk = run_bigk(d, genome, card)
        print(f"# phase 12 (k = 16 and 20): {time.perf_counter() - t0:.2f} s",
              flush=True)
        t0 = time.perf_counter()
        dxh, dxh2, dxhp = run_exact_device_hits(d, genome, card)
        print(f"# phase 13 (device hit expansion): "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        t0 = time.perf_counter()
        meshed = run_mesh(d, genome, card)
        print(f"# phase 14 (the device mesh, several hosts): "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if se["sw_full_track"] < 1:
        fail("the main path never launched the sw_full kernel")
    alien = sorted(m for m in sys.modules
                   if m.split(".")[0] in ("jax", "jaxlib", "smalt_tpu"))
    if alien:
        fail(f"imported from outside the port: {alien[:5]}")

    paths = (("single-end --fast", se, N_READS), ("long reads --fast", lr,
             N_LONG), (f"long reads --fast -n {POOL_N}", lrn, N_LONG),
             ("pairs --fast", pe, 2 * N_PAIRS),
             (f"{MID_READLEN} bp --fast -n {POOL_N}", mid, N_MID),
             (f"pairs --fast -n {POOL_N}", pen, 2 * N_PAIRS),
             ("--fast --resume (restarted)", rs, BATCH),
             ("--fast --profile", pf, BATCH),
             ("--device-exact", dx0, N_EXACT),
             ("--device-exact SMALT_DX_P2=1", dx, N_EXACT),
             ("--device-exact -f bam", dxb, N_EXACT),
             ("--device-exact repeat tier", dxt, N_TIER),
             (f"--fast -S {WIDE_SPEC}", wf, BATCH),
             (f"--device-exact -S {WIDE_SPEC} SMALT_DX_P2=1", wx, BATCH),
             (f"--device-pass1 -S {WIDE_SPEC}", wp, BATCH),
             ("--device-exact pairs", pdx, 2 * N_PE_EXACT),
             ("--device-pass1", dp1, N_EXACT),
             ("--device-pass1 1,500 bp", dp1l, N_DP1_LONG),
             ("--device-exact k15 s16 (the pass-1 lane)", dp1x, BATCH),
             (f"--fast -n {POOL_N} {VLONG_READLEN} bp", vl["fast"],
              N_VLONG_FAST),
             (f"--device-pass1 {VLONG_READLEN} bp", vl["dp1"], N_VLONG),
             (f"--device-pass1 {VLONG_READLEN} bp, scratch in groups",
              vl["dp1 groups"], N_VLONG),
             (f"--fast -S {KEY_SPEC} {KEY_READLEN} bp", vl["fast key"],
              N_VLONG),
             (f"--device-pass1 -S {KEY_SPEC} {KEY_READLEN} bp", vl["dp1 key"],
              N_VLONG),
             (f"--fast -S {KEY_SHORT_SPEC}", vl["fast key short"], BATCH),
             (f"--fast {R100K_LEN} bp", vl["fast 100 kb"], R100K_N)) + \
        tuple((f"--fast k{k} {rl} bp", n, BATCH if rl == READLEN
               else N_BIGK_LONG) for (k, rl), n in bk.items()) + \
        (("--device-exact k13 s16 (device hits)", dxh, BATCH),
         ("--device-exact k13 s16 SMALT_DX_P2=1", dxh2, BATCH),
         ("--device-exact k13 s16 pairs", dxhp, BATCH)) + \
        tuple((what, n, reads) for what, (n, reads) in meshed.items())
    kinds = list(sw.launches) + ["segcand"]
    for k in kinds:
        print(f"# launches {k}: " + "; ".join(
            f"{what} {n.get(k, 0)} ({n.get(k, 0) * BATCH / reads:.2f} per "
            f"{BATCH} reads)" for what, n, reads in paths), flush=True)
    launches = {k: sum(n.get(k, 0) for _, n, _ in paths) for k in kinds}
    full = {"route": "cuda", "source": "smalt_tpu_torch/ops/csrc/sw_full.cu",
            "replaces": "smalt_tpu/ops/sw.py:60"}
    band = {"route": "cuda", "source": "smalt_tpu_torch/ops/csrc/sw_band.cu",
            "replaces": "smalt_tpu/ops/sw.py:269"}
    swq = {"route": "cuda", "source": "smalt_tpu_torch/ops/csrc/swq.cu",
           "replaces": "smalt_tpu/parallel/exact_pass2.py:179"}
    seg = {"route": "cuda", "source": "smalt_tpu_torch/ops/csrc/segcand.cu",
           "replaces": "smalt_tpu/parallel/exact_collate.py:203"}
    # no single PyTorch call computes a Smith-Waterman score (a scan over
    # rows with a prefix max inside): there is no library time to take
    print(json.dumps({"kernels": [
        dict(name=name, **src, launches=launches[name], max_abs_err=e,
             library_ms=None, **k)
        for name, src, e, k in (
            ("sw_full_track", full, err, k_full_t),
            ("sw_full", full, err, k_full),
            ("sw_full_track_wide", full, werr, k_wfull_t),
            ("sw_full_wide", full, werr, k_wfull),
            ("sw_band_track", band, berr, k_band_t),
            ("sw_band", band, berr, k_band),
            ("sw_band_track_wide", band, wberr, k_wband_t),
            ("sw_band_wide", band, wberr, k_wband),
            ("sw_band_track_many", band, berr, k_many_t),
            ("sw_band_many", band, berr, k_many),
            ("swq", swq, qerr, k_swq),
            ("sw_full_track_warp", full, serr, k_strip["sw_full_track_warp"]),
            ("sw_full_warp", full, serr, k_strip["sw_full_warp"]),
            ("sw_full_track_strip", full, serr, k_far["sw_full_track_strip"]),
            ("sw_full_strip", full, serr, k_far["sw_full_strip"]),
            ("sw_full_track_strip_wide", full, serr,
             k_far["sw_full_track_strip_wide"]),
            ("sw_full_strip_wide", full, serr, k_far["sw_full_strip_wide"]),
            ("sw_full_track_rec", full, serr, k_far["sw_full_track_rec"]),
            ("sw_full_track_strip_rec", full, serr,
             k_far["sw_full_track_strip_rec"]),
            ("sw_band_track_strips", band, terr, k_strips_t),
            ("sw_band_strips", band, terr, k_strips),
            ("sw_band_track_cluster", band, terr, k_clu_t),
            ("sw_band_cluster", band, terr, k_clu),
            ("segcand", seg, cerr, k_seg))]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def long_fast_main(readlen: int, n: int) -> int:
    """`python3 chip_smoke.py --long-fast READLEN N`: no phase, only
    `map --fast` through the CLI on N reads of READLEN bp (phase 5's
    generator) against phase 4's genome and index, at a batch of N (the
    default batch would pad it with 4,094 pad reads, whose windows at this
    length alone take tens of GB), on the card: its SAM records and
    placement, its pipeline seconds (SMALT_TIMING), its launches, and the
    device step on the same batch timed alone (CUDA events, 3 calls), the
    rest of the pipeline (the host tail, parsing and writing) being the
    difference.  Run it under a time limit: the host tail grows as the
    square of the read length."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from smalt_tpu_torch import cli
    from smalt_tpu_torch.index.table import KmerIndex
    from smalt_tpu_torch.map.fastmode import (encode_batch, get_device_step,
                                              iter_fastq_hybrid)
    from smalt_tpu_torch.ops import sw
    from smalt_tpu_torch.parallel.mesh import window_len, window_pad
    from smalt_tpu_torch.seq.refset import RefSet
    card = card_line()
    print(f"# {card} | torch {torch.__version__}", flush=True)
    d = os.path.join(ROOT, "build", "smoke_long")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    genome = make_genome(rng, GENOME_LEN)
    fa, _, _ = write_inputs(d, genome, np.zeros((0, 1), np.uint8))
    idx_name = os.path.join(d, "idx")
    if cli.main(["index", "-k", str(KMER), "-s", str(NSKIP), idx_name,
                 fa]) != 0:
        fail("index build")
    reads, truth, rev = make_long_reads(rng, genome, n, readlen)
    fq, _ = write_fastq(os.path.join(d, "long.fq"), reads, b"L")
    Q = -(-reads.shape[1] // 16) * 16
    W = sw.clamp_band_width(Q, window_pad(Q))
    routed = sw.sw_band_instance(Q, window_len(Q), W, sw.device_matrix(
        np.eye(8, dtype=np.int32), "cpu"), True)
    print(f"# data + index: {time.perf_counter() - t0:.1f} s; {n} reads of "
          f"{readlen} bp (Q={Q}, S={window_len(Q)}, W={W}: {routed})",
          flush=True)
    sam = os.path.join(d, "long.sam")
    launches, wall, m = map_cli("cuda", idx_name, sam, [fq], n)
    body = sam_body(sam)
    placed = placement(body, truth, rev, LONG_TOL)
    ran = {k: v for k, v in launches.items() if v}
    print(f"# map --fast on {n} reads of {readlen} bp at a batch of {n}: "
          f"{len(body)} records, placed {placed}/{n} within {LONG_TOL} bp; "
          f"the CLI {wall:.1f} s, pipeline {m.group(3) if m else '?'} s; "
          f"launches {ran} | {card}", flush=True)
    refset, idx = RefSet.load(idx_name), KmerIndex.load(idx_name)
    item = next(iter(iter_fastq_hybrid(fq, n)))
    arr = torch.from_numpy(item.encode(Q) if hasattr(item, "encode")
                           else encode_batch(item[1], Q)).cuda()
    step = get_device_step(refset, idx, "cuda", (1, -2, -4, -3))
    step_ms = time_ms(lambda: step(arr), 3, warm=1)
    pipe_ms = 1e3 * float(m.group(3)) if m else float("nan")
    print(f"# the device step on that batch: {step_ms:.1f} ms (CUDA events, "
          f"3 calls); the rest of the pipeline (host tail, parse, write): "
          f"{pipe_ms - step_ms:.1f} ms of {pipe_ms:.1f} | {card}",
          flush=True)
    if len(body) != n:
        fail(f"--fast on {n} reads of {readlen} bp: {len(body)} records")
    return 0


def repeat_tier_main() -> int:
    """`python3 chip_smoke.py --repeat-tier`: phase 7c alone (segcand.cu
    and sw_full.cu built on the way), then segcand's entry of the kernels
    line and the last line."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    card = card_line()
    print(f"# {card} | torch {torch.__version__}", flush=True)
    d = os.path.join(ROOT, "build", "smoke_tier")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    try:
        t0 = time.perf_counter()
        launches, err, k_seg = check_repeat_tier(d, card)
        print(f"# phase 7c (the repeat tier, segcand): "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print(json.dumps({"kernels": [dict(
        name="segcand", route="cuda",
        source="smalt_tpu_torch/ops/csrc/segcand.cu",
        replaces="smalt_tpu/parallel/exact_collate.py:203",
        launches=launches["segcand"], max_abs_err=err, library_ms=None,
        **k_seg)]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--long-fast":
        sys.exit(long_fast_main(int(sys.argv[2]), int(sys.argv[3])))
    if len(sys.argv) == 2 and sys.argv[1] == "--repeat-tier":
        sys.exit(repeat_tier_main())
    sys.exit(main())
