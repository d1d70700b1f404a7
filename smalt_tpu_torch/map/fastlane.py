"""Python side of the C fast-lane (native/fastlane.c) and the
device-exact lane on one torch device.

Counterpart of smalt_tpu/map/fastlane.py.  `FastLane` and `PairLane` are
the reference's own, line for line: the fast-lane maps a whole block of
reads to final SAM text in one native call, replicating the exact
Python path (rmap_single -> add_single_to_report -> _write_sam)
byte-for-byte.  `FastLane.make` gates on the modes the lane covers;
`render_block` returns None on any native-side error, in which case the
caller reruns the block through the Python engine with the untouched
RNG state (the lane commits the drand48 state only on success).

`DevicePass1` is `map --device-pass1` for single-end FASTQ (fastlane.py:442
there): the reference's host halves (fl_pass1_block: seeding, collation
and the pass-1 window list; the padded read batch; fl_pass2_block: the
pass-1 replay on the device's scores, pass 2, report, SAM) around the
port's device leg, `dp1_step` (reverse complement, the window gather from
a reference resident on the device, score-only full-matrix SW, through
ops/csrc/sw_full.cu on a card), and the batch loop both lanes share
(`DevicePass1._drive`).  `DeviceExact` is `map --device-exact` for
single-end FASTQ and for read pairs in two FASTQ files (fastlane.py:796
there): the host halves are the reference's — the C pre block (hit
info, rank masks, hit-key expansion), the C post block (checksums, depth
sort, pass-2 state), the pass-2 window prep, fl_pass2_block (pass 1
replay, pass 2, report, SAM) and, for pairs, fl_map_pair_block on the
collate step's per-mate state — and the device steps are the port's: the collate step
(parallel/exact_collate.py), the pass-2 step (parallel/exact_pass2.py)
and the batch loop that feeds them.

Output of `DeviceExact` is the SAM of the host C lane, byte for byte, by
the reference's protocol: a read the device cannot serve exactly is
re-staged on the host (`n_restaged`), a pass-2 candidate whose walk
record the host decoder doubts is redone by the host DP (`p2_fb`), and a
batch the lane does not take at all (reads over QMAX, missing qualities,
a C block that refuses) is rendered by the host lane (`host_batches`).
A device, build or launch error raises: nothing turns it into host
output.

Per batch: host pre -> upload the padded reads once -> collate step on a
worker thread -> host post -> (SMALT_DX_P2=1) pass-2 step on the worker
-> fl_pass2_block, pipelined one batch deep as in the reference (pairs:
both mates in one collate step -> host post under the pair flow's
parameters -> fl_map_pair_block).  In
the host-hits regime (every seq-by-seq reference with nskip <= wordlen)
the C pre block expands the hit keys; elsewhere (nskip > wordlen, on at
most 8 sequences with k <= 14) the collate step expands them on the
device from the resident direct table, and its hit-info checksum goes to
the C post block in place of the host's.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import threading
import time
from collections import defaultdict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from .. import rand
from ..align import core as ali_mod
from ..native import (fl_prof_set, fl_prof_take, fl_restage_fetch,
                      get_lib)
from ..ops.sw import device_matrix, sw_score_batch
from ..parallel.exact_collate import CollateCfg, build_exact_collate
from ..parallel.exact_pass2 import (band_tiles, build_pass2_step,
                                   unpack_pass2)
from ..parallel.mesh import DeviceIndex
from ..results import pairs as pairs_mod
from ..seq import codec
from . import engine as eng_mod
from .fastmode import iter_fastq_batches


class FastLane:
    def __init__(self, engine, soft_clip: bool, x_mismatch: bool,
                 out_fmt: int = 0, ali_out: bool = False):
        lib = get_lib()
        p = engine.params
        refset = engine.refset
        idx = engine.index
        self.lib = lib
        self.engine = engine
        self.soft_clip = soft_clip
        self.x_mismatch = x_mismatch
        self.out_fmt = out_fmt       # 0 SAM, 1 cigar, 2 ssaha, 3 gff
        self.ali_out = ali_out       # -a explicit alignment display
        # pinned argument buffers
        self._matrix = np.ascontiguousarray(engine.matrix, dtype=np.int32)
        self._ivals = np.ascontiguousarray(engine._seq_ivals, dtype=np.int64)
        snames = []
        offs = [0]
        for s in range(refset.nseq):
            snames.append(refset.sam_name(s).encode())
            offs.append(offs[-1] + len(snames[-1]))
        self._snames = np.frombuffer(b"".join(snames) or b"\0",
                                     dtype=np.uint8).copy()
        self._sname_offs = np.asarray(offs, dtype=np.int64)
        self._offsets = np.ascontiguousarray(refset.offsets, np.int64)
        self._refcodes = np.ascontiguousarray(refset.codes, np.uint8)
        ma, mm = ali_mod.avg_penalties(engine.matrix)
        self._avgs = (ma, mm)
        wa, sa, pa, ta = idx.addrs
        self._idx_addrs = (wa, sa, idx.nwords, ta, pa)
        self._rng_io = np.zeros(1, dtype=np.uint64)

    @classmethod
    def make(cls, engine, fmt: str, soft_clip: bool, x_mismatch: bool,
             ali_out: bool, fix_primary: bool) -> Optional["FastLane"]:
        """Return a lane when the run's modes are covered, else None."""
        lib = get_lib()
        if lib is None or not hasattr(lib, "fl_map_block"):
            return None
        if fmt not in ("sam", "cigar", "ssaha", "gff"):
            return None
        # -a (explicit alignment display) emits via tx_align_display
        # fix_primary (set for -d runs on sam/bam) replays
        # reportFixMultiplePrimary, which only clears the PRIMARY
        # status bit — no writer consumes it (SAM NOTPRIMARY derives
        # from PARTIAL), so the lane's output is unaffected; goldens
        # golden_se_r1_d5/dm1 pin this.
        p = engine.params
        # -d (scorediff) clears RMAPFLG_BEST / RESULTFLG_SINGLE: the C
        # report stage replicates the non-BEST multi-report walk and
        # BELOWRELSW filtering (fl_add_single_to_report, rs_filter).
        # Both reference regimes run natively: seq-by-seq (< 512
        # sequences) and whole-genome cutoff collection with post-pass
        # sequence assignment (>= 512; boundary-spanning alignments
        # fall back per block/pair for splitMultiSpan).
        return cls(engine, soft_clip, x_mismatch,
                   out_fmt={"sam": 0, "cigar": 1, "ssaha": 2,
                            "gff": 3}[fmt],
                   ali_out=ali_out)

    def render_block(self, block) -> Optional[str]:
        """One native call for a block of Read objects."""
        n = len(block)
        read_offs = np.zeros(n + 1, dtype=np.int64)
        name_offs = np.zeros(n + 1, dtype=np.int64)
        has_qual = np.zeros(n, dtype=np.uint8)
        codes_parts = []
        qual_parts = []
        name_parts = []
        qmax = 1
        for i, read in enumerate(block):
            seq = read.seq
            if seq.dtype != np.uint8 or not seq.flags.c_contiguous:
                seq = np.ascontiguousarray(seq, dtype=np.uint8)
            codes_parts.append(seq)
            ql = len(seq)
            qmax = max(qmax, ql)
            if read.qual is not None:
                if len(read.qual) != ql:
                    return None
                qual_parts.append(read.qual)
                has_qual[i] = 1
            else:
                qual_parts.append(b"\x00" * ql)
            nm = read.name.encode()     # raw: the C side applies the
            name_parts.append(nm)       # format's own name cut
            read_offs[i + 1] = read_offs[i] + ql
            name_offs[i + 1] = name_offs[i] + len(nm)
        codes = np.concatenate(codes_parts) if codes_parts else \
            np.zeros(1, np.uint8)
        quals = np.frombuffer(b"".join(qual_parts) or b"\0", np.uint8)
        names = np.frombuffer(b"".join(name_parts) or b"\0", np.uint8)
        return self._call(n, qmax, codes, read_offs, quals, has_qual,
                          names, name_offs, ascii_codes=False,
                          names_raw=True)

    def render_raw_block(self, names, seqs, quals) -> Optional[str]:
        """One native call for raw bulk-reader output (bytes lists):
        encode + name-strip happen in C."""
        n = len(names)
        read_offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(s) for s in seqs], out=read_offs[1:])
        name_offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(x) for x in names], out=name_offs[1:])
        qmax = int((read_offs[1:] - read_offs[:-1]).max()) if n else 1
        has_qual = np.empty(n, dtype=np.uint8)
        qual_parts = []
        for i, q in enumerate(quals):
            if q is not None:
                if len(q) != len(seqs[i]):
                    return None     # malformed record: exact reader decides
                has_qual[i] = 1
                qual_parts.append(q)
            else:
                has_qual[i] = 0
                qual_parts.append(b"\x00" * len(seqs[i]))
        codes = np.frombuffer(b"".join(seqs) or b"\0", np.uint8)
        qarr = np.frombuffer(b"".join(qual_parts) or b"\0", np.uint8)
        narr = np.frombuffer(b"".join(names) or b"\0", np.uint8)
        return self._call(n, max(qmax, 1), codes, read_offs, qarr, has_qual,
                          narr, name_offs, ascii_codes=True, names_raw=True)

    def _call(self, n, qmax, codes, read_offs, quals, has_qual,
              names, name_offs, ascii_codes: bool,
              names_raw: bool) -> Optional[str]:
        p = self.engine.params
        filt = self.engine.filter
        wa, sa, nwords, ta, pa = self._idx_addrs
        idx = self.engine.index
        cap = int(name_offs[-1]) + n * (2 * qmax + 192)
        self._rng_io[0] = rand._global._x
        for _ in range(3):
            out = np.empty(cap, dtype=np.uint8)
            rc = self.lib.fl_map_block(
                wa, sa, nwords, ta, pa, idx.wordlen, idx.nskip,
                self._refcodes.ctypes.data, self._offsets.ctypes.data,
                self.engine.refset.nseq, self._ivals.ctypes.data,
                self._snames.ctypes.data, self._sname_offs.ctypes.data,
                self._matrix.ctypes.data,
                -self.engine.gapopen, -self.engine.gapext,
                self._avgs[0], self._avgs[1],
                p.ktuple_maxhit, eng_mod.HASH_MAXNHITS,
                p.min_cover_frac, p.min_swatscor,
                p.min_swatscor_below_max, p.min_basq,
                p.target_depth, p.max_depth,
                p.rmapflg & ~eng_mod.RMAPFLG_ALLPAIR, p.rsltouflg,
                filt.min_swscor, filt.min_swscor_below_max,
                filt.min_identity,
                1 if self.soft_clip else 0, 1 if self.x_mismatch else 0,
                self.out_fmt, 1 if self.ali_out else 0,
                1 if ascii_codes else 0, 1 if names_raw else 0,
                n, codes.ctypes.data, read_offs.ctypes.data,
                quals.ctypes.data, has_qual.ctypes.data,
                names.ctypes.data, name_offs.ctypes.data,
                self._rng_io.ctypes.data, out.ctypes.data, cap,
                float(self.engine.lam))
            if rc == -3:          # text buffer too small: grow and retry
                cap *= 4
                continue
            if rc < 0:
                self.last_rc = rc          # debugging/observability
                return None
            rand._global._x = int(self._rng_io[0])
            return out[:rc].tobytes().decode("ascii")
        return None


class PairLane:
    """Exact paired-end C lane: a whole block of read pairs maps and
    renders in ONE native call (fl_map_pair_block — the rmapPair
    common flow, rmap.c:1744-2112, plus the full pair layer,
    resultpairs.c:753-1311).  A pair hitting an uncovered branch
    (remap/rescue/fine-rehash, caps) stops the native call cleanly
    with nothing consumed for that pair; the caller replays exactly
    that pair through the Python oracle and resumes, so output is
    byte-identical to the pure-Python path for any mix."""

    def __init__(self, lane: FastLane, insert_min: int, insert_max: int,
                 pairtyp: int, ihist=None):
        self.lane = lane
        self.insert_min = insert_min
        self.insert_max = insert_max
        self.pairtyp = pairtyp
        # -g: precompute the inclusive cumulative bin counts the C
        # probability model looks up (insGetHistoCountCumulative,
        # insert.py:81-86); smooth counts when smoothing ran
        if ihist is not None:
            arr = ihist.smooth if ihist.smoothed else ihist.counts
            self._ih_cum = np.cumsum(np.asarray(arr, dtype=np.int64))
            self._ih_desc = (int(ihist.span), int(ihist.insizlo),
                             int(ihist.insizhi), int(ihist.scalfac),
                             int(ihist.num))
        else:
            self._ih_cum = None
            self._ih_desc = (0, 0, 0, 1, 0)

    @classmethod
    def make(cls, engine, fmt, soft_clip, x_mismatch, ali_out,
             fix_primary, ihist) -> Optional["PairLane"]:
        lane = FastLane.make(engine, fmt, soft_clip, x_mismatch, ali_out,
                             fix_primary)
        if lane is None:
            return None
        # paired -d: the reference supports only -d 0 for pairs
        # (map -H), i.e. RESULTFLG_BEST with SINGLE/RANDSEL cleared —
        # the pair report walk handles it (test_pair_lane d0 case);
        # anything without BEST keeps the Python oracle
        if not (engine.params.rsltouflg & pairs_mod.RESULTFLG_BEST):
            return None
        # paired split-read mode (-p): fl_map_pair runs the
        # mapSecondary pass on both mates and the report adds the
        # per-segment PARTIAL chain (flrep_add_2ndary), reference-
        # diffed in tests/test_ref_differential.py (pe -p)
        if not hasattr(lane.lib, "fl_map_pair_block"):
            return None
        p = engine.params
        return cls(lane, p.insert_min, p.insert_max, p.pairtyp, ihist)

    def _arrays(self, reads):
        n = len(reads)
        offs = np.zeros(n + 1, dtype=np.int64)
        name_offs = np.zeros(n + 1, dtype=np.int64)
        has_qual = np.zeros(n, dtype=np.uint8)
        codes_parts, qual_parts, name_parts = [], [], []
        for i, rd in enumerate(reads):
            seq = rd.seq
            if seq.dtype != np.uint8 or not seq.flags.c_contiguous:
                seq = np.ascontiguousarray(seq, dtype=np.uint8)
            codes_parts.append(seq)
            ql = len(seq)
            if rd.qual is not None:
                if len(rd.qual) != ql:
                    return None
                qual_parts.append(rd.qual)
                has_qual[i] = 1
            else:
                qual_parts.append(b"\x00" * ql)
            if self.lane.out_fmt == 0:
                nm = rd.sam_name.encode()           # SAM: /1 /2 stripped
            else:
                # cigar/ssaha qname keeps /1 /2 (report.py _qname)
                nm = (rd.name.split()[0] if rd.name else "").encode()
            name_parts.append(nm)
            offs[i + 1] = offs[i] + ql
            name_offs[i + 1] = name_offs[i] + len(nm)
        codes = np.concatenate(codes_parts) if codes_parts else \
            np.zeros(1, np.uint8)
        quals = np.frombuffer(b"".join(qual_parts) or b"\0", np.uint8)
        names = np.frombuffer(b"".join(name_parts) or b"\0", np.uint8)
        return codes, offs, quals, has_qual, names, name_offs

    @staticmethod
    def _raw_arrays(names, seqs, quals):
        """Concat arrays straight from bulk-reader bytes (no Read
        objects); encode + name cutting happen in C."""
        n = len(names)
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(s) for s in seqs], out=offs[1:])
        name_offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(x) for x in names], out=name_offs[1:])
        has_qual = np.empty(n, dtype=np.uint8)
        qual_parts = []
        for i, q in enumerate(quals):
            if q is not None:
                if len(q) != len(seqs[i]):
                    return None    # malformed record: exact reader decides
                has_qual[i] = 1
                qual_parts.append(q)
            else:
                has_qual[i] = 0
                qual_parts.append(b"\x00" * len(seqs[i]))
        codes = np.frombuffer(b"".join(seqs) or b"\0", np.uint8)
        qarr = np.frombuffer(b"".join(qual_parts) or b"\0", np.uint8)
        narr = np.frombuffer(b"".join(names) or b"\0", np.uint8)
        return codes, offs, qarr, has_qual, narr, name_offs

    def _call(self, readsA, readsB):
        """(text, n_done) for the leading pairs the C lane covered, or
        None on a hard error (caller renders the block in Python)."""
        arrA = self._arrays(readsA)
        arrB = self._arrays(readsB)
        if arrA is None or arrB is None:
            return None
        return self._call_arrays(len(readsA), arrA, arrB,
                                 ascii_codes=False, names_raw=False)

    def _call_raw(self, namesA, seqsA, qualsA, namesB, seqsB, qualsB):
        arrA = self._raw_arrays(namesA, seqsA, qualsA)
        arrB = self._raw_arrays(namesB, seqsB, qualsB)
        if arrA is None or arrB is None:
            return None
        return self._call_arrays(len(namesA), arrA, arrB,
                                 ascii_codes=True, names_raw=True)

    def _call_arrays(self, n, arrA, arrB, ascii_codes, names_raw,
                     dev=None):
        """dev (optional): (state, offs_A, offs_B, scores64) — the
        device-exact front half's per-mate state; the C block then
        consumes it for the pair flow's unrestricted mapping calls
        (fl_pair_map_single_dev) and keeps everything else on host."""
        lane = self.lane
        eng = lane.engine
        p = eng.params
        filt = eng.filter
        wa, sa, nwords, ta, pa = lane._idx_addrs
        idx = eng.index
        cA, oA, qA, hA, nA, noA = arrA
        cB, oB, qB, hB, nB, noB = arrB
        if n < 1:
            return "", 0
        if dev is not None:
            dstate, doffA, doffB, dscores = dev
            dev_args = (dstate.ctypes.data, doffA.ctypes.data,
                        doffB.ctypes.data, dscores.ctypes.data,
                        len(dscores))
        else:
            dev_args = (None, None, None, None, 0)
        qmax = int(max((oA[1:] - oA[:-1]).max(),
                       (oB[1:] - oB[:-1]).max(), 1))
        cap = int(noA[-1] + noB[-1]) + 2 * n * (2 * qmax + 224)
        done = np.zeros(1, dtype=np.int64)
        lane._rng_io[0] = rand._global._x
        for _ in range(3):
            out = np.empty(cap, dtype=np.uint8)
            rc = lane.lib.fl_map_pair_block(
                wa, sa, nwords, ta, pa, idx.wordlen, idx.nskip,
                lane._refcodes.ctypes.data, lane._offsets.ctypes.data,
                eng.refset.nseq, lane._ivals.ctypes.data,
                lane._snames.ctypes.data, lane._sname_offs.ctypes.data,
                lane._matrix.ctypes.data,
                -eng.gapopen, -eng.gapext,
                lane._avgs[0], lane._avgs[1],
                p.ktuple_maxhit, eng_mod.HASH_MAXNHITS,
                p.min_cover_frac, p.min_swatscor,
                p.min_swatscor_below_max, p.min_basq,
                p.target_depth, p.max_depth,
                p.rmapflg, p.rsltouflg,
                filt.min_swscor, filt.min_swscor_below_max,
                filt.min_identity,
                1 if lane.soft_clip else 0, 1 if lane.x_mismatch else 0,
                lane.out_fmt, 1 if lane.ali_out else 0,
                self.insert_min, self.insert_max, self.pairtyp,
                self._ih_cum.ctypes.data if self._ih_cum is not None
                else None, *self._ih_desc,
                1 if ascii_codes else 0, 1 if names_raw else 0,
                n, cA.ctypes.data, oA.ctypes.data,
                qA.ctypes.data, hA.ctypes.data,
                nA.ctypes.data, noA.ctypes.data,
                cB.ctypes.data, oB.ctypes.data,
                qB.ctypes.data, hB.ctypes.data,
                nB.ctypes.data, noB.ctypes.data,
                lane._rng_io.ctypes.data, out.ctypes.data, cap,
                done.ctypes.data, float(eng.lam), *dev_args)
            if rc == -3:                   # text buffer too small
                cap *= 4
                continue
            if rc < 0:
                return None
            rand._global._x = int(lane._rng_io[0])
            return out[:rc].tobytes().decode("ascii"), int(done[0])
        return None

    def render_block(self, block, oracle_one) -> Optional[str]:
        """SAM text for a block of (read, mate) tuples.  `oracle_one`
        renders a single pair through the Python engine (consuming its
        own RNG) — called only for pairs the C flow does not cover."""
        parts = []
        start = 0
        n = len(block)
        while start < n:
            readsA = [it[0] for it in block[start:]]
            readsB = [it[1] for it in block[start:]]
            res = self._call(readsA, readsB)
            if res is None:
                if start == 0:
                    return None        # whole block to the Python path
                # render the remainder in Python (RNG stream continuous)
                for it in block[start:]:
                    parts.append(oracle_one(it))
                return "".join(parts)
            text, ndone = res
            parts.append(text)
            start += ndone
            if start < n:
                parts.append(oracle_one(block[start]))
                start += 1
        return "".join(parts)

    def render_raw_pairs(self, namesA, seqsA, qualsA,
                         namesB, seqsB, qualsB,
                         oracle_one_raw) -> Optional[str]:
        """Same per-pair resume protocol as render_block, but fed
        straight from bulk-reader bytes (encode + name cutting in C);
        `oracle_one_raw(i)` renders pair i through the Python engine."""
        parts = []
        start = 0
        n = len(namesA)
        while start < n:
            res = self._call_raw(namesA[start:], seqsA[start:],
                                 qualsA[start:], namesB[start:],
                                 seqsB[start:], qualsB[start:])
            if res is None:
                if start == 0:
                    return None       # whole batch to the Python path
                for i in range(start, n):
                    parts.append(oracle_one_raw(i))
                return "".join(parts)
            text, ndone = res
            parts.append(text)
            start += ndone
            if start < n:
                parts.append(oracle_one_raw(start))
                start += 1
        return "".join(parts)


class _Span:
    """The context of DevicePass1._span: the block's seconds on
    perf_counter into rec[name] (and in `s`), and a record_function
    `<tag>.<name>` around it only while a torch profiler records."""
    __slots__ = ("rec", "name", "tag", "t0", "s", "rf")

    def __init__(self, rec, name: str, tag: str):
        self.rec, self.name, self.tag = rec, name, tag
        self.s = 0.0
        self.rf = None

    def __enter__(self):
        if getattr(torch.autograd.profiler, "_is_profiler_enabled", False):
            self.rf = torch.profiler.record_function(
                f"{self.tag}.{self.name}")
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.s = time.perf_counter() - self.t0
        self.rec[self.name] += self.s
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class DevicePass1:
    """Device-assisted exact mapping, `map --device-pass1`: the device
    scores the pass-1 full-matrix candidate windows of whole batches
    (the reference's SIMD kernel slot) while the host C lane does
    seeding, collation, the pass-1 replay and pass 2.  Output is the host
    lane's, byte for byte: sw_full computes the integer scores the C
    sw_full computes, and fl_pass2_block replays the early-break logic on
    the score stream.  Also the host halves DeviceExact builds on: phase
    A (fl_pass1_block), the fixed-shape padded read batch, phase B
    (fl_pass2_block) and the batch loop (`_drive`).

    Per batch: phase A on the main thread, the device leg (upload, step,
    copy back into pinned memory) on a worker thread, phase B two batches
    later, so the device and the copies overlap the host work of the
    neighbouring batches.  Three faults of the reference's loop
    (fastlane.py:604-606,772-773,784-786) are not copied: window starts
    stay int64 on their way to the device (the reference's int32 copy
    wraps past 2^31 reference bases), a batch refused in phase A is
    rendered on the host in its place in the output (the reference
    writes it ahead of the pending batches), and a device error raises
    (the reference renders the batch on the host)."""

    def __init__(self, lane: FastLane, batch: int = 0, device="cuda"):
        self.lane = lane
        self.batch = batch or int(os.environ.get("SMALT_DP1_BATCH", 8192))
        self.device = torch.device(device)
        eng = lane.engine
        if -eng.gapopen < -eng.gapext:
            raise ValueError("device kernel needs gapopen >= gapext")
        # sticky shape caps: every device call is padded to (batch, qcap)
        # reads and wcap windows of scap subject rows, as in the reference
        self._qcap = 128
        self._scap = 128
        self._wcap = 4 * self.batch
        self._ref_alpha = None          # the resident reference (lazily)
        self._mat = None
        self.host_batches = 0
        self.n_restaged = 0
        self._timing = False
        self._remap = False
        self._exec = None
        # the record of the batch each thread works on (_drive's; outside
        # a run, a scratch record that takes any span or counter)
        self._tag = "dp1"
        self._cur = threading.local()
        self._scratch = defaultdict(float)
        self._t_write = 0.0

    @classmethod
    def make(cls, engine, fmt, soft_clip, x_mismatch, ali_out, fix_primary,
             batch: int = 0, device="cuda") -> Optional["DevicePass1"]:
        """The lane for `engine`, or None where the engine is outside the
        lane's gates (the reference then runs its host lane)."""
        lane = FastLane.make(engine, fmt, soft_clip, x_mismatch, ali_out,
                             fix_primary)
        if lane is None:
            return None
        if engine.params.rmapflg & (eng_mod.RMAPFLG_SPLIT |
                                    eng_mod.RMAPFLG_NOSHRTINFO):
            # the two-phase block drivers (fl_pass1/2_block) have no
            # mapSecondary pass; -p runs through the one-phase C lane
            return None
        if not (engine.params.rmapflg & eng_mod.RMAPFLG_SEQBYSEQ):
            # fl_pass1/2_block drive seq-by-seq collection only; the
            # >= 512-sequence regime runs the one-phase C lane
            return None
        if -engine.gapopen < -engine.gapext:
            return None
        return cls(lane, batch=batch, device=device)

    # ---------------- phase A ----------------

    def _pass1(self, n, qmax, codes, read_offs, quals, has_qual,
               ascii_codes: bool):
        lane = self.lane
        p = lane.engine.params
        wa, sa, nwords, ta, pa = lane._idx_addrs
        idx = lane.engine.index
        state_cap = n * (8 + 64 * 12) + 4096
        win_cap = n * 8 + 64
        for _ in range(4):
            state = np.empty(state_cap, dtype=np.int64)
            state_offs = np.empty(n + 1, dtype=np.int64)
            win_desc = np.empty(win_cap * 4, dtype=np.int64)
            rc = lane.lib.fl_pass1_block(
                wa, sa, nwords, ta, pa, idx.wordlen, idx.nskip,
                lane._refcodes.ctypes.data, lane._offsets.ctypes.data,
                lane.engine.refset.nseq, lane._ivals.ctypes.data,
                lane._matrix.ctypes.data,
                -lane.engine.gapopen, -lane.engine.gapext,
                lane._avgs[0], lane._avgs[1],
                p.ktuple_maxhit, eng_mod.HASH_MAXNHITS,
                p.min_cover_frac, p.min_swatscor,
                p.min_swatscor_below_max, p.min_basq,
                p.target_depth, p.max_depth,
                p.rmapflg & ~eng_mod.RMAPFLG_ALLPAIR,
                1 if ascii_codes else 0,
                n, codes.ctypes.data, read_offs.ctypes.data,
                quals.ctypes.data, has_qual.ctypes.data,
                state.ctypes.data, state_cap, state_offs.ctypes.data,
                win_desc.ctypes.data, win_cap)
            if rc == -1:           # capacity: grow and retry
                state_cap *= 4
                win_cap *= 4
                continue
            if rc < 0:
                return None
            return state, state_offs, win_desc[: int(rc) * 4].reshape(-1, 4)
        return None

    # ---------------- device scoring ----------------

    def _padded_reads(self, codes, read_offs, n, qmax):
        """([batch, qcap] 3-bit codes padded with 7, [batch] int32
        lengths) — always the sticky fixed shape (trailing partial
        batches included)."""
        while self._qcap < qmax:
            self._qcap *= 2
        fwd = np.full((self.batch, self._qcap), 7, np.uint8)
        al = codes & 7
        qlens = np.zeros(self.batch, np.int32)
        qlens[:n] = (read_offs[1:] - read_offs[:-1]).astype(np.int32)
        if n and qlens[0] and (qlens[:n] == qlens[0]).all():
            L = int(qlens[0])
            fwd[:n, :L] = al[: n * L].reshape(n, L)
        else:
            for i in range(n):
                o, e = int(read_offs[i]), int(read_offs[i + 1])
                fwd[i, : e - o] = al[o:e]
        return fwd, qlens

    def _score_windows(self, win_desc, fwd, qlens):
        """Dispatch one batch of windows (fastlane.py:586-613): the read
        batch and the window descriptors go up, dp1_step scores the
        windows against the resident reference, and the scores come back
        into pinned host memory without blocking.  Returns (host scores
        [wcap], an event that completes with the copy or None on the CPU,
        nw)."""
        lane = self.lane
        dev = self.device
        if self._ref_alpha is None:
            eng = lane.engine
            self._ref_alpha = torch.from_numpy(
                (lane._refcodes & 7).astype(np.uint8)).to(dev)
            self._mat = device_matrix(np.asarray(eng.matrix, np.int32), dev)
        nw = len(win_desc)
        # S to the sticky power-of-two cap, the window count to the
        # sticky window cap (padded windows have slen 0: score 0)
        S = int(win_desc[:, 1].max()) if nw else 128
        while self._scap < S:
            self._scap *= 2
        while self._wcap < nw:
            self._wcap *= 2
        wd = np.zeros((self._wcap, 4), dtype=np.int64)
        wd[:nw] = win_desc
        cuda = dev.type == "cuda"
        args = [torch.from_numpy(x) for x in (fwd, qlens, wd)]
        if cuda:
            args = [x.pin_memory().to(dev, non_blocking=True) for x in args]
        eng = self.lane.engine
        out = dp1_step(self._ref_alpha, *args, self._scap, self._mat,
                       -eng.gapopen, -eng.gapext)
        if not cuda:
            return out, None, nw
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done, nw

    # ---------------- phase B ----------------

    def _pass2(self, n, qmax, codes, read_offs, quals, has_qual,
               names, name_offs, state, state_offs, scores,
               ascii_codes: bool, names_raw: bool,
               dev=None) -> Optional[str]:
        """dev: (pres, phdr, best, mi, mj, rec16, valid, sp, nwin)
        from the device pass-2 dispatch (exact_pass2.py), or None for
        the host pass-2."""
        lane = self.lane
        p = lane.engine.params
        filt = lane.engine.filter
        wa, sa, nwords, ta, pa = lane._idx_addrs
        idx = lane.engine.index
        scores64 = np.ascontiguousarray(scores, dtype=np.int64)
        cap = int(name_offs[-1]) + n * (2 * qmax + 192)
        lane._rng_io[0] = rand._global._x
        if dev is not None:
            pres, phdr, dbest, dmi, dmj, drec, dvalid, dsp, dnwin = dev
            self._dev_stats = np.zeros(3, np.int64)
            if os.environ.get("SMALT_DX_P2") == "prep":
                # bisect mode: prep-replay consume only, host decode
                dev_args = (pres.ctypes.data, phdr.ctypes.data,
                            None, None, None, None, None, 0, 0,
                            self._dev_stats.ctypes.data)
            else:
                dev_args = (pres.ctypes.data, phdr.ctypes.data,
                            dbest.ctypes.data, dmi.ctypes.data,
                            dmj.ctypes.data, drec.ctypes.data,
                            dvalid.ctypes.data, int(dsp), int(dnwin),
                            self._dev_stats.ctypes.data)
        else:
            dev_args = (None,) * 2 + (None,) * 5 + (0, 0, None)
        for _ in range(3):
            out = np.empty(cap, dtype=np.uint8)
            rc = lane.lib.fl_pass2_block(
                wa, sa, nwords, ta, pa, idx.wordlen, idx.nskip,
                lane._refcodes.ctypes.data, lane._offsets.ctypes.data,
                lane.engine.refset.nseq, lane._ivals.ctypes.data,
                lane._snames.ctypes.data, lane._sname_offs.ctypes.data,
                lane._matrix.ctypes.data,
                -lane.engine.gapopen, -lane.engine.gapext,
                lane._avgs[0], lane._avgs[1],
                p.ktuple_maxhit, eng_mod.HASH_MAXNHITS,
                p.min_cover_frac, p.min_swatscor,
                p.min_swatscor_below_max, p.min_basq,
                p.target_depth, p.max_depth,
                p.rmapflg & ~eng_mod.RMAPFLG_ALLPAIR, p.rsltouflg,
                filt.min_swscor, filt.min_swscor_below_max,
                filt.min_identity,
                1 if lane.soft_clip else 0, 1 if lane.x_mismatch else 0,
                lane.out_fmt, 1 if lane.ali_out else 0,
                1 if ascii_codes else 0, 1 if names_raw else 0,
                n, codes.ctypes.data, read_offs.ctypes.data,
                quals.ctypes.data, has_qual.ctypes.data,
                names.ctypes.data, name_offs.ctypes.data,
                state.ctypes.data, state_offs.ctypes.data,
                scores64.ctypes.data, len(scores64),
                lane._rng_io.ctypes.data, out.ctypes.data, cap,
                float(lane.engine.lam), *dev_args)
            if rc == -3:
                cap *= 4
                continue
            if rc < 0:
                return None
            rand._global._x = int(lane._rng_io[0])
            return out[:rc].tobytes().decode("ascii")
        return None

    # ---------------- batch loop ----------------

    # the spans of one batch, in the order its `# <tag>-batch` line gives
    # them: the main thread's, then the worker thread's; then the lane's
    # counters
    MAIN_SPANS = ("read", "pre", "stage", "wait", "post", "tail", "oracle",
                  "fallback", "write")
    WORKER_SPANS = ("score", "fetch")
    COUNTERS: tuple = ()

    def _log(self, msg: str) -> None:
        if self._timing:
            print(msg, file=sys.stderr, flush=True)

    def _record(self) -> dict:
        """The record of the batch this thread works on."""
        return getattr(self._cur, "rec", self._scratch)

    def _span(self, name: str) -> "_Span":
        """`with self._span(name):` adds the block's seconds to the record
        of the batch this thread works on and, while a torch profiler
        records, names the block `<tag>.<name>` in its trace."""
        return _Span(self._record(), name, self._tag)

    def _leg(self, rec: dict, fn, *args):
        """fn(*args) on the worker thread, for the batch of record rec."""
        self._cur.rec = rec
        return fn(*args)

    def _take_remap(self) -> None:
        """After a batch's tail: the seconds the C blocks spent mapping
        its re-staged reads again (SMALT_FL_TIMING's `remap` slot)."""
        if self._remap:
            self._record()["remap"] += fl_prof_take("remap")

    def _on_host(self, render, *args):
        """A batch the lane does not take, rendered on the host."""
        self.host_batches += 1
        with self._span("fallback"):
            return render(*args)

    def _batch_line(self, rec: dict) -> None:
        """The batch's `# <tag>-batch` line, once it is written: its
        rows, the seconds since the previous batch was written, its spans
        and its counters."""
        now = time.perf_counter()
        period, self._t_write = now - self._t_write, now
        if not self._timing:
            return
        fields = " ".join(f"{k}={v:.6f}" if isinstance(v, float) else
                          f"{k}={v}" for k, v in rec.items() if k != "n")
        sys.stderr.write(f"# {self._tag}-batch n={rec['n']} "
                         f"period={period:.6f} {fields}\n")
        sys.stderr.flush()

    def _drive(self, batches, tag: str, lane_args, mid, fin, write,
               counters: tuple = ()) -> float:
        """The lane's batch loop, pipelined one batch deep at each stage:
        _launch(lane_args(raw)) -> mid(item, raw) -> fin(item, raw) ->
        write(text, raw), in input order.  A batch the lane does not take
        goes through the queues as None and is rendered by fin(), so the
        output and the host RNG stream keep the input order.  Each batch
        carries a record of its spans and counters (with `counters`, the
        caller's own) to its `# <tag>-batch` line.  Returns the seconds
        the loop took."""
        self._timing = bool(os.environ.get("SMALT_DP1_TIMING"))
        self._remap = bool(os.environ.get("SMALT_FL_TIMING"))
        fl_prof_set(self._remap)
        self._tag = tag
        spans = self.MAIN_SPANS + self.WORKER_SPANS + \
            (("remap",) if self._remap else ())
        blank = dict.fromkeys(spans, 0.0)
        blank.update(dict.fromkeys(("n",) + self.COUNTERS + counters, 0))
        self._exec = ThreadPoolExecutor(max_workers=1)
        self.n_restaged = 0
        t_run = self._t_write = time.perf_counter()
        midq, finq = deque(), deque()
        batches = iter(batches)

        def land(entry):
            item, raw, rec = entry
            self._cur.rec = rec
            finq.append((mid(item, raw), raw, rec))

        def out(entry):
            item, raw, rec = entry
            self._cur.rec = rec
            text = fin(item, raw)
            with self._span("write"):
                write(text, raw)
            self._batch_line(rec)

        try:
            while True:
                rec = self._cur.rec = blank.copy()
                with self._span("read"):
                    raw = next(batches, None)
                if raw is None:
                    break
                with self._span("stage"):
                    args = lane_args(raw)
                rec["n"] = len(args[0])
                midq.append((self._launch(args, tag), raw, rec))
                while len(midq) > 1:
                    land(midq.popleft())
                while len(finq) > 1:
                    out(finq.popleft())
            while midq:
                land(midq.popleft())
            while finq:
                out(finq.popleft())
        finally:
            self._exec.shutdown(wait=True)
            self._cur.__dict__.pop("rec", None)
        return time.perf_counter() - t_run

    def _launch(self, args, tag: str):
        """Phase A for one batch (names, seqs, quals) and its device leg
        submitted to the worker thread (fastlane.py:710-757): (host
        state, future of the scores or None with no window), or None when
        the lane does not take the batch (a read without its quality
        string, fl_pass1_block refuses)."""
        names, seqs, quals = args
        with self._span("stage"):
            n = len(names)
            read_offs = np.zeros(n + 1, dtype=np.int64)
            np.cumsum([len(x) for x in seqs], out=read_offs[1:])
            name_offs = np.zeros(n + 1, dtype=np.int64)
            np.cumsum([len(x) for x in names], out=name_offs[1:])
            qmax = int((read_offs[1:] - read_offs[:-1]).max()) if n else 1
            has_qual = np.empty(n, dtype=np.uint8)
            for i, q in enumerate(quals):
                if q is None or len(q) != len(seqs[i]):
                    return None
                has_qual[i] = 1
            codes = np.frombuffer(b"".join(seqs) or b"\0", np.uint8)
            qarr = np.frombuffer(b"".join(quals) or b"\0", np.uint8)
            narr = np.frombuffer(b"".join(names) or b"\0", np.uint8)
        with self._span("pre"):
            st = self._pass1(n, qmax, codes, read_offs, qarr, has_qual,
                             ascii_codes=True)
        if st is None:
            return None
        state, state_offs, win_desc = st
        fut = None
        if len(win_desc):
            with self._span("stage"):
                fwd, qlens = self._padded_reads(
                    np.frombuffer(codec_encode_bulk(codes), np.uint8),
                    read_offs, n, qmax)
                fut = self._exec.submit(self._leg, self._record(),
                                        self._device_leg, win_desc, fwd,
                                        qlens)
        return (n, qmax, codes, read_offs, qarr, has_qual, narr, name_offs,
                state, state_offs), fut

    def _device_leg(self, win_desc, fwd, qlens):
        """The worker thread's part of a batch: the scores [nw] on the
        host.  A device error raises out of the future."""
        with self._span("score") as call:
            scores, done, nw = self._score_windows(win_desc, fwd, qlens)
        with self._span("fetch") as wait:
            if done is not None:
                done.synchronize()
        with self._span("fetch") as fetch:
            sc = scores[:nw].numpy()
        self._log(f"# dp1-dev nw={nw} call={call.s:.3f} wait={wait.s:.3f} "
                  f"fetch={fetch.s:.3f}")
        return sc

    def run_raw_fastq(self, path: str, out, fallback) -> None:
        """Map a strict FASTQ file, writing SAM records to `out` in input
        order (fastlane.py:690-793 of the reference): phase A -> device
        leg -> phase B.  fallback(names, seqs, quals) renders on the host
        a batch the lane does not take (counted in host_batches); a
        device error raises."""
        def fin(item, raw):
            if item is None:
                return self._on_host(fallback, *raw)
            host, fut = item
            with self._span("wait") as wait:
                sc = fut.result() if fut is not None else \
                    np.zeros(0, np.int32)
            self._log(f"# dp1-main stall={wait.s:.3f}")
            with self._span("tail"):
                text = self._pass2(*host, sc, ascii_codes=True,
                                   names_raw=True)
            self._take_remap()
            return self._on_host(fallback, *raw) if text is None else text

        nreads = [0]

        def write(text, raw):
            out.write(text)
            nreads[0] += len(raw[0])

        secs = self._drive(iter_fastq_batches(path, self.batch), "dp1",
                           lambda raw: raw, lambda item, raw: item, fin,
                           write)
        self._log(f"# dp1-total {secs:.3f}s host_batches={self.host_batches} "
                  f"nreads={nreads[0]}")


class DeviceExact(DevicePass1):
    """Device-exact mapping: the device carries the exact engine's FRONT
    HALF — hit collection, shift-sort, segment/candidate collation AND
    pass-1 window scoring — in one dispatch per block
    (parallel/exact_collate.py), while the host keeps hit-info rank
    selection, hit-key expansion, the NR depth sort, pass 2 and
    rendering.  Output stays byte-identical to the pure-C lane: any read
    the device cannot serve exactly (capacity overflow, checksum or
    geometry mismatch) is re-staged fully on host by fl_pass2_block."""

    QMAX = 255          # packed row fields gate (cover/qs/qe <= 255)
    WORKER_SPANS = ("collate", "fetch", "pass2")
    # the reads a batch re-staged, and their causes: the host hit
    # expansion overflowed the tier too (rs_h), the collate step flagged
    # the read (rs_dev), and the post block's four checks; then the rows
    # the repeat tier took (tier) and, of those, the re-staged (tier_rs)
    COUNTERS = ("restaged", "rs_h", "rs_dev", "rs_ck", "rs_stats",
                "rs_geom", "rs_simd", "tier", "tier_rs")
    # the repeat tier's first candidate cap a lane and pool rows a tier
    # row: chr20-exact's tier reads gave at most 2,253 (100 bp) and 2,900
    # (150 bp) candidates a lane, 1,160 and 1,672 rows a read on average
    # (PERF.md §6); both grow to fit what a batch shows
    TIER_C = 4096
    TIER_P_ROW = 1024

    def __init__(self, lane: FastLane, batch: int = 0, device="cuda"):
        super().__init__(lane, batch=batch or
                         int(os.environ.get("SMALT_DX_BATCH", 4096)),
                         device=device)
        self._collate = None
        self._di = None
        # device pass 2 (exact_pass2.py) is opt-in with SMALT_DX_P2=1, as
        # in the reference; sticky caps keep one window shape per run
        self._p2_on = os.environ.get("SMALT_DX_P2", "0") == "1"
        self._p2_wcap = 512
        self._p2_sp = 2 * self._qcap
        self._p2_fn = None
        self.p2_used = 0
        self.p2_fb = 0
        self.p2_hit = 0
        self.steps_built = 0            # collate and pass-2 step builds
        self._tag = "dx"
        # the repeat tier's sticky shape (rows, hits, candidates a lane,
        # pool rows; 0 rows: no tier step yet), grown by doubling to fit
        # what batches show, up to _tier_ceilings
        self._tier_B = self._tier_H = self._tier_P = 0
        self._tier_C = self.TIER_C
        self.n_tier = self.n_tier_rs = 0    # tier rows, re-staged of them

    @classmethod
    def make(cls, engine, fmt, soft_clip, x_mismatch, ali_out,
             fix_primary, batch: int = 0,
             device="cuda") -> Optional["DeviceExact"]:
        """The lane for `engine`, or None where the engine is outside
        the lane's gates (the reference then runs its host lane)."""
        base = DevicePass1.make(engine, fmt, soft_clip, x_mismatch,
                                ali_out, fix_primary, batch=batch,
                                device=device)
        if base is None:
            return None
        lane = base.lane
        lib = lane.lib
        if not hasattr(lib, "fl_exact_pre_block"):
            return None
        idx = engine.index
        if engine.refset.total_len >= (1 << 31):
            return None                 # int32 serial/base coords gate
        if not cls._host_hits_ok(engine):
            # device-side hit expansion: direct-address table + the
            # static interval loop (the pre-host_hits regime)
            if 2 * idx.wordlen > 28:
                return None
            if engine.refset.nseq > 8:
                return None
        return cls(lane, batch=batch, device=device)

    @staticmethod
    def _host_hits_ok(eng):
        """True when hit expansion can run on host (fl_exact_pre_block
        writes padded key arrays, so the device makes no random pos[]
        gathers).  Needs the seq-by-seq
        full-cover interval regime (contiguous intervals spanning the
        whole concatenated reference, one per sequence — the engine's
        SEQBYSEQ mode, nseq < 512): the union of in-range slices is
        then the seed's full position run, and the per-hit sequence
        ids the C pre-block ships let the device scan per interval.
        This regime has no k <= 14 gate (the device never touches the
        k-mer table) and no nseq <= 8 gate (no static V loop)."""
        if not (eng.params.rmapflg & eng_mod.RMAPFLG_SEQBYSEQ):
            return False                # whole-genome cutoff regime
        if eng.refset.nseq > 511:       # 9-bit seqidx field in w5
            return False
        idx = eng.index
        if idx.nskip > idx.wordlen:
            return False
        iv = eng._seq_ivals
        return (int(iv[0, 0]) == 0 and
                int(iv[-1, 1]) >= eng.refset.total_len and
                bool((iv[1:, 0] == iv[:-1, 1]).all()))

    @property
    def _host_hits(self):
        return self._host_hits_ok(self.lane.engine)

    # ---------------- device steps ----------------

    def _collate_fn(self):
        if self._collate is not None:
            return self._collate
        eng = self.lane.engine
        idx = eng.index
        host_hits = self._host_hits
        # the device index and built steps live on the shared KmerIndex
        # under a name of the port's own (the JAX lane caches its
        # objects there too)
        # (the host-hits step reads only the reference codes; the device
        # hit expansion reads the direct table and the positions too)
        cache = self._dx_cache()
        dkey = ("ref_only" if host_hits else "full", str(self.device))
        if dkey not in cache:
            build = (DeviceIndex.build_ref_only if host_hits
                     else DeviceIndex.build)
            cache[dkey] = build(eng.refset, idx, self.device)
        self._di = cache[dkey]
        p = eng.params
        # hit cap and pass-1 window pad scale with the read cap
        # (fastlane.py:918-945)
        qscale = max(1, self._qcap // 128)
        H = (int(os.environ.get("SMALT_DX_H", 128 * qscale))
             if host_hits else 512)
        cfg = CollateCfg(wordlen=idx.wordlen, nskip=idx.nskip,
                         maxhit=p.ktuple_maxhit, B=self.batch, Q=self._qcap,
                         H=H,
                         P=int(os.environ.get("SMALT_DX_POOL", 6)) *
                         self.batch,
                         V=1 if host_hits else eng.refset.nseq,
                         host_hits=host_hits,
                         NS=eng.refset.nseq if host_hits else 1,
                         SPAD=(128 if self._qcap <= 128
                               else self._qcap + 128))
        self._collate = self._step_for(cfg)
        self._cfg = cfg
        return self._collate

    def _dx_cache(self) -> dict:
        return self.lane.engine.index.__dict__.setdefault("_torch_dx_cache",
                                                          {})

    def _step_for(self, cfg: CollateCfg):
        """The collate step of shape cfg, built once for the index."""
        eng = self.lane.engine
        cache = self._dx_cache()
        matrix = np.asarray(eng.matrix, np.int32)
        key = (cfg, matrix.tobytes(), eng.gapopen, eng.gapext,
               str(self.device))
        if key not in cache:
            cache[key] = build_exact_collate(
                self._di, eng._seq_ivals, matrix, -eng.gapopen, -eng.gapext,
                cfg)
            self.steps_built += 1
        return cache[key]

    # ---------------- the repeat tier ----------------

    def _tier_ceilings(self):
        """The most the tier's shape grows to: (rows, hits a lane,
        pool rows).  Rows: the batch; hits: the engine's hit budget of a
        lane's selected seeds (HASH_MAXNHITS); pool: target_depth
        candidates a row of the batch.  A lane's candidates never
        outnumber its hits, so C never passes H."""
        return (self.batch, eng_mod.HASH_MAXNHITS,
                self.batch * self.lane.engine.params.target_depth)

    def _tier_fit(self, nrows: int, hits: int) -> bool:
        """Grow the tier's rows and hits a lane by doubling to fit a
        batch's nrows rows of at most `hits` hits a lane; True where
        either grew."""
        B0, H0 = self._tier_B, self._tier_H
        Bmax, Hmax, _ = self._tier_ceilings()
        B = max(B0, 64)
        while B < nrows:
            B *= 2
        H = max(H0, 2 * self._cfg.H)
        while H < hits:
            H *= 2
        self._tier_B = min(B, Bmax)
        self._tier_H = min(H, Hmax)
        return (self._tier_B, self._tier_H) != (B0, H0)

    def _tier_fn(self):
        """The tier's collate step: the main step's with the tier's
        rows, hits, candidates a lane and pool, and pass-1 windows 128
        columns past the main step's pad (a repeat read's candidates join
        segments of more shifts: at the main step's pad chr20's tier
        re-staged 1 read in 12, PERF.md §6)."""
        _, _, Pmax = self._tier_ceilings()
        P = max(self._tier_P, self.TIER_P_ROW * self._tier_B)
        self._tier_P = min(P, Pmax)
        cfg = dataclasses.replace(
            self._cfg, B=self._tier_B, H=self._tier_H,
            C=min(self._tier_C, self._tier_H), P=self._tier_P,
            SPAD=self._cfg.SPAD + 128)
        return self._step_for(cfg)

    def _tier_grow(self, tcounts2) -> None:
        """After a tier step: grow its candidate cap and pool by doubling
        to fit the rows it found (the reads past them re-staged)."""
        _, Hmax, Pmax = self._tier_ceilings()
        need_c = int(tcounts2.max()) if tcounts2.size else 0
        while self._tier_C < need_c and self._tier_C < Hmax:
            self._tier_C *= 2
        need_p = int(tcounts2.sum())
        while self._tier_P < need_p and self._tier_P < Pmax:
            self._tier_P *= 2
        self._tier_P = min(self._tier_P, Pmax)

    def _pass2_step(self):
        if self._p2_fn is None:
            eng = self.lane.engine
            self._p2_fn = build_pass2_step(np.asarray(eng.matrix, np.int32),
                                           -eng.gapopen, -eng.gapext,
                                           self.device)
            self.steps_built += 1
        return self._p2_fn

    def _p2_args(self, win):
        """The pass-2 step's window descriptors for the prep windows
        `win` (fastlane.py:1087-1112), padded to the sticky window cap:
        (wd [wcap, 12] int32 tensor on the device, valid [nw] uint8,
        Sp, nw, the band tiles of the widest window, from this host
        copy)."""
        nw = len(win)
        self._p2_sp = max(self._p2_sp, 2 * self._qcap)
        Sp = self._p2_sp
        valid = ((win[:, 10] == 1) & (win[:, 2] <= Sp) &
                 (win[:, 9] <= Sp)).astype(np.uint8)
        while self._p2_wcap < nw:
            self._p2_wcap *= 2
        wd = np.zeros((self._p2_wcap, 12), np.int32)
        if nw:
            wd[:nw, 0] = win[:, 1]            # gstart
            wd[:nw, 1] = win[:, 2]            # b_s_len
            wd[:nw, 2] = win[:, 0]            # read idx
            wd[:nw, 3] = win[:, 7]            # is_rev
            wd[:nw, 4] = win[:, 3]            # l_edge
            wd[:nw, 5] = win[:, 4]            # r_edge
            wd[:nw, 6] = win[:, 5]            # q_left
            wd[:nw, 7] = win[:, 6]            # q_len
            wd[:nw, 8] = win[:, 8]            # b_s_left
            wd[:nw, 9] = np.where(valid[:nw] != 0, win[:, 9], 0)
        tiles = band_tiles(*(wd[:, k] for k in (4, 5, 6, 7)), wd[:, 9] > 0,
                           self._qcap)
        return torch.from_numpy(wd).to(self.device), valid, Sp, nw, tiles

    def _dispatch_pass2(self, win, codes_pad, qlens):
        """One pass-2 step over the prep windows; codes_pad and qlens
        are the batch's tensors already on the device.  Returns (best64,
        mi64, mj64, rec16, valid, Sp, nw) on the host."""
        wd, valid, Sp, nw, tiles = self._p2_args(win)
        # the collate step's resident reference codes (refcodes & 7, the
        # array the reference uploads a second time for pass 2)
        flat = self._pass2_step()(self._di.ref_alpha, codes_pad, qlens, wd,
                                  Sp, tiles)
        best64, mi64, mj64, rec16 = unpack_pass2(flat.cpu().numpy(), nw, Sp)
        return best64, mi64, mj64, rec16, valid, Sp, nw

    # ---------------- host halves ----------------

    def _pre(self, n, codes, read_offs, quals, has_qual, Qcap,
             hits_B=0, hits_H=0, tier_B=0, tier_H=0):
        """hits_B > 0: also host-expand the packed hit keys into
        B-padded [B, 2, H] arrays (host_hits mode); a lane past H gets
        no keys there but its hit count in tot, and with tier_B > 0 the
        read's keys go to the next free row of the repeat tier's
        [tier_B, 2, tier_H] arrays where both lanes fit.  Returns
        (pre, selmask, k1, k2, tot, ks, tier), tier = (each read's tier
        row or -1, k1, k2, tot, ks) or None."""
        lane = self.lane
        p = lane.engine.params
        wa, sa, nwords, ta, pa = lane._idx_addrs
        idx = lane.engine.index
        pre = np.zeros((n, 12), np.int64)
        selmask = np.zeros((n, 2, Qcap), np.uint8)
        nseq = lane.engine.refset.nseq
        ks = tier = None
        targs = (0, 0, None, None, None, None, None)
        if hits_B and tier_B:
            # rows past a lane's count are never read: left unset
            tier = (np.empty(n, np.int32),
                    np.empty((tier_B, 2, tier_H), np.int32),
                    np.empty((tier_B, 2, tier_H), np.uint8),
                    np.zeros((tier_B, 2), np.int32),
                    np.empty((tier_B, 2, tier_H), np.int32)
                    if nseq > 1 else None)
            t_row, t_k1, t_k2, t_tot, t_ks = tier
            targs = (tier_H, tier_B, t_k1.ctypes.data, t_k2.ctypes.data,
                     None if t_ks is None else t_ks.ctypes.data,
                     t_tot.ctypes.data, t_row.ctypes.data)
        if hits_B:
            k1 = np.zeros((hits_B, 2, hits_H), np.int32)
            k2 = np.zeros((hits_B, 2, hits_H), np.uint8)
            tot = np.zeros((hits_B, 2), np.int32)
            if nseq > 1:        # per-hit sequence index (interval id)
                ks = np.zeros((hits_B, 2, hits_H), np.int32)
            args = (pa, hits_H, k1.ctypes.data, k2.ctypes.data,
                    tot.ctypes.data, lane._offsets.ctypes.data, nseq,
                    ks.ctypes.data if ks is not None else None)
        else:
            k1 = k2 = tot = None
            args = (None, 0, None, None, None, None, 0, None)
        rc = lane.lib.fl_exact_pre_block(
            wa, sa, nwords, ta, idx.wordlen, idx.nskip,
            p.ktuple_maxhit, eng_mod.HASH_MAXNHITS, p.min_basq,
            p.min_cover_frac, 1,
            n, codes.ctypes.data, read_offs.ctypes.data,
            quals.ctypes.data, has_qual.ctypes.data,
            Qcap, pre.ctypes.data, selmask.ctypes.data, *args, *targs)
        if rc != 0:
            return None
        return pre, selmask, k1, k2, tot, ks, tier

    def _post(self, n, read_offs, pre, pool, counts2, scores, cksum,
              fallback, pair=False):
        """pair=True: replay the depth sort under the PAIR flow's
        parameter mods (fl_pair_map_single: MINSCOR_BELOW_MAX_BEST=0,
        rmapflg|PAIRED&~ALLPAIR) so the state equals what the pair
        flow's unrestricted stage 1 would produce.  Returns (state,
        state_offs, reads re-staged, {cause: reads} of them:
        native RESTAGE_CAUSES), or None where the C block refuses."""
        lane = self.lane
        eng = lane.engine
        p = eng.params
        belowmax = 0 if pair else p.min_swatscor_below_max
        rflg = ((p.rmapflg | eng_mod.RMAPFLG_PAIRED)
                if pair else p.rmapflg) & ~eng_mod.RMAPFLG_ALLPAIR
        state_cap = n * 8 + int(counts2.sum()) * 12 + 64
        pool_c = np.ascontiguousarray(pool, np.int32)
        counts2_c = np.ascontiguousarray(counts2, np.int32)
        scores_c = np.ascontiguousarray(scores, np.int32)
        cksum_c = np.ascontiguousarray(cksum, np.int32)
        fb_c = np.ascontiguousarray(fallback, np.uint8)
        nrest = np.zeros(1, np.int64)
        state = np.empty(state_cap, np.int64)
        state_offs = np.empty(n + 1, np.int64)
        fl_restage_fetch()              # this call's causes alone
        rc = lane.lib.fl_exact_post_block(
            eng.index.wordlen, eng.index.nskip,
            lane._offsets.ctypes.data, eng.refset.nseq,
            belowmax,
            lane._avgs[0], lane._avgs[1],
            p.target_depth, p.max_depth,
            rflg,
            n, read_offs.ctypes.data, pre.ctypes.data,
            pool_c.ctypes.data, counts2_c.ctypes.data,
            scores_c.ctypes.data, len(scores_c),
            fb_c.ctypes.data, cksum_c.ctypes.data,
            state.ctypes.data, state_cap, state_offs.ctypes.data,
            nrest.ctypes.data)
        if rc != 0:
            return None
        return state, state_offs, int(nrest[0]), fl_restage_fetch()


    # ---------------- device pass 2: host window prep ----------------

    def _prep_windows(self, n, codes, read_offs, state, state_offs,
                      scores64):
        """fl_pass2_prep_block: replayed per-candidate scores + the
        pass-2 window descriptors.  Returns (pres, phdr, win[nw,12])
        or None (legacy host pass 2)."""
        lane = self.lane
        eng = lane.engine
        p = eng.params
        idx = eng.index
        n_rows = int((int(state_offs[n]) - 8 * n) // 12)
        pres = np.zeros(max(n_rows, 1), np.int64)
        phdr = np.zeros(max(n * 4, 4), np.int64)
        win_cap = max(n_rows, 64)
        for _ in range(3):
            win = np.empty(win_cap * 12, np.int64)
            rc = lane.lib.fl_pass2_prep_block(
                lane._matrix.ctypes.data, -eng.gapopen, -eng.gapext,
                lane._avgs[0], lane._avgs[1],
                lane._refcodes.ctypes.data, lane._offsets.ctypes.data,
                eng.refset.nseq, idx.wordlen, idx.nskip,
                p.min_swatscor, p.min_swatscor_below_max,
                p.rmapflg & ~eng_mod.RMAPFLG_ALLPAIR, 1,
                n, codes.ctypes.data, read_offs.ctypes.data,
                state.ctypes.data, state_offs.ctypes.data,
                scores64.ctypes.data, len(scores64),
                pres.ctypes.data, phdr.ctypes.data,
                win.ctypes.data, win_cap)
            if rc == -1:              # window capacity: grow and retry
                win_cap *= 4
                continue
            if rc < 0:
                return None
            return pres, phdr, win[: int(rc) * 12].reshape(-1, 12)
        return None

    # ---------------- one batch ----------------

    def _prepare(self, names, seqs, quals):
        """Host pre block and the collate step's inputs, on the device,
        for one batch (fastlane.py:1174-1255).  Returns None when the
        lane does not take the batch (the caller renders it on the
        host), else (host state, collate arguments)."""
        with self._span("stage"):
            n = len(names)
            read_offs = np.zeros(n + 1, dtype=np.int64)
            np.cumsum([len(s) for s in seqs], out=read_offs[1:])
            name_offs = np.zeros(n + 1, dtype=np.int64)
            np.cumsum([len(x) for x in names], out=name_offs[1:])
            qlens_n = (read_offs[1:] - read_offs[:-1]).astype(np.int32)
            qmax = int(qlens_n.max()) if n else 1
            if qmax > self.QMAX or n > self.batch:
                return None
            while self._qcap < qmax:
                self._qcap *= 2
                self._collate = None            # new shape: a new step
            Qcap = self._qcap
            has_qual = np.empty(n, dtype=np.uint8)
            for i, q in enumerate(quals):
                if q is None or len(q) != len(seqs[i]):
                    return None
                has_qual[i] = 1
            codes = np.frombuffer(b"".join(seqs) or b"\0", np.uint8)
            qarr = np.frombuffer(b"".join(quals) or b"\0", np.uint8)
            narr = np.frombuffer(b"".join(names) or b"\0", np.uint8)
            B = self.batch
            host_hits = self._host_hits
            self._collate_fn()                  # cfg (H) first
        with self._span("pre"):
            st = (self._pre_hits(n, codes, read_offs, qarr, has_qual, Qcap)
                  if host_hits else
                  self._pre(n, codes, read_offs, qarr, has_qual, Qcap))
        if st is None:
            return None
        pre, selmask, k1, k2, tot, ks, tier = st
        t_rows = None
        with self._span("stage"):
            codes_pad = np.zeros((B, Qcap), np.uint8)
            enc = np.frombuffer(codec_encode_bulk(codes), np.uint8)
            for i in range(n):
                o, e = int(read_offs[i]), int(read_offs[i + 1])
                codes_pad[i, : e - o] = enc[o:e]
            qlens = np.zeros(B, np.int32)
            qlens[:n] = qlens_n
            mincov = np.zeros(B, np.int32)
            mincov[:n] = pre[:, 5].astype(np.int32)
            dev = self.device
            # the padded batch goes up ONCE: the collate and the pass-2 step
            # both read it
            codes_t, qlens_t = (torch.from_numpy(x).to(dev)
                                for x in (codes_pad, qlens))
            mincov_t = torch.from_numpy(mincov).to(dev)
            if host_hits:
                # a read with a lane past H is not the main step's (which
                # still takes its other lane, as the reference's does): the
                # repeat tier's where it took the read, else re-staged on
                # the host
                R, H = 2 * B, self._cfg.H
                over = (tot > H).any(axis=1)
                tot[tot > H] = 0
                host_fb = over[:n]
                if tier is not None and (tier[0] >= 0).any():
                    t_rows = tier[0]
                    host_fb = host_fb & (t_rows < 0)
                    tier = self._tier_inputs(tier, codes_pad, qlens, mincov)
                else:
                    tier = None
                dargs = tuple(torch.from_numpy(x).to(dev) for x in (
                    k1.reshape(R, H), k2.reshape(R, H), tot.reshape(R))) + \
                    (codes_t, qlens_t, mincov_t)
                if ks is not None:
                    dargs = (torch.from_numpy(ks.reshape(R, H)).to(dev),
                             ) + dargs
            else:
                # the device derives the hits: it takes the bases under the
                # quality floor and the host's selected-seed mask
                host_fb = None
                minq = self.lane.engine.params.min_basq + 0x21
                qbad = np.zeros((B, Qcap), bool)
                for i in range(n):
                    o, e = int(read_offs[i]), int(read_offs[i + 1])
                    qbad[i, : e - o] = qarr[o:e] < minq
                selm = np.zeros((B, 2, Qcap), np.uint8)
                selm[:n] = selmask
                dargs = (codes_t, torch.from_numpy(qbad).to(dev),
                         torch.from_numpy(selm).to(dev), qlens_t, mincov_t)
            host = (n, qmax, codes, read_offs, qarr, has_qual, narr,
                    name_offs, pre, host_fb, codes_t, qlens_t, t_rows, tier)
            return host, dargs

    def _pre_hits(self, n, codes, read_offs, qarr, has_qual, Qcap):
        """The pre block with the host hit expansion, the reads past H
        routed to the repeat tier; run again where the tier's shape grows
        to fit the batch (a read past the tier's ceiling of hits stays
        out of it)."""
        H = self._cfg.H
        _, Hmax, _ = self._tier_ceilings()
        while True:
            st = self._pre(n, codes, read_offs, qarr, has_qual, Qcap,
                           hits_B=self.batch, hits_H=H,
                           tier_B=self._tier_B, tier_H=self._tier_H)
            if st is None:
                return None
            top = st[4][:n].max(axis=1)
            fits = (top > H) & (top <= Hmax)
            if not fits.any() or \
                    not self._tier_fit(int(fits.sum()), int(top[fits].max())):
                return st

    def _tier_inputs(self, tier, codes_pad, qlens, mincov):
        """The tier step and its arguments on the device: its rows' keys
        from the pre block, and their reads' codes, lengths and cover
        floors (the tier's rows hold its reads in read order)."""
        t_rows, t_k1, t_k2, t_tot, t_ks = tier
        src = np.nonzero(t_rows >= 0)[0]
        Bt, Ht = self._tier_B, self._tier_H
        Rt = 2 * Bt
        tc = np.zeros((Bt, codes_pad.shape[1]), np.uint8)
        tq = np.zeros(Bt, np.int32)
        tm = np.zeros(Bt, np.int32)
        tc[:len(src)] = codes_pad[src]
        tq[:len(src)] = qlens[src]
        tm[:len(src)] = mincov[src]
        args = (t_k1.reshape(Rt, Ht), t_k2.reshape(Rt, Ht),
                t_tot.reshape(Rt), tc, tq, tm)
        if t_ks is not None:
            args = (t_ks.reshape(Rt, Ht),) + args
        return self._tier_fn(), tuple(torch.from_numpy(x).to(self.device)
                                      for x in args)

    @staticmethod
    def _merge_tier(n, outs, touts, t_rows):
        """The main step's and the tier step's outputs as one collate
        step's over the batch's n reads, each read's from the step that
        took it: (pool, counts2, scores, fallback), the pools per-read
        contiguous in read order; a flagged read keeps no rows (the post
        block re-stages it unread)."""
        pool, counts2, scores, fb = outs
        tpool, tcounts2, tscores, tfb = touts
        src = np.nonzero(t_rows >= 0)[0]
        m = len(src)
        fb = fb[:n].copy()
        fb[src] = tfb[:m]
        c2 = counts2[:n].copy()
        c2[src] = tcounts2[:m]
        c2[fb != 0] = 0
        # each read's first row in the two pools laid end to end
        cm = counts2.sum(axis=1)
        first = (np.cumsum(cm) - cm)[:n]
        ct = tcounts2.sum(axis=1)
        first[src] = (np.cumsum(ct) - ct)[:m] + len(pool)
        cnt = c2.sum(axis=1)
        idx = np.repeat(first - (np.cumsum(cnt) - cnt), cnt) + \
            np.arange(int(cnt.sum()))
        return (np.concatenate([pool, tpool])[idx], c2,
                np.concatenate([scores, tscores])[idx], fb)

    def _post_batch(self, host, outs, pair: bool = False):
        """Host post block on the collate outputs (fastlane.py:1257-1297).
        Returns None when the C block refuses the batch, else (the
        batch's state for pass 2, whose last field is the pass-2 window
        prep or None, and the number of reads re-staged on the host).
        pair=True: the state of a paired batch (the pair flow's parameters,
        no pass-2 window prep: the C pair block runs pass 2)."""
        (n, qmax, codes, read_offs, qarr, has_qual, narr, name_offs, pre,
         host_fb, _, _, t_rows, _) = host
        if len(outs) == 5:          # the device-hit step: its own checksum
            pool, counts2, scores, cksum, fb = outs
        else:
            if t_rows is not None:
                self._tier_grow(outs[5])
                outs = self._merge_tier(n, outs[:4], outs[4:], t_rows)
            pool, counts2, scores, fb = outs
            cksum = np.ascontiguousarray(pre[:, 6:10].reshape(n, 2, 2),
                                         np.int32)
        fb = fb.copy()
        if host_fb is not None:
            fb[:n] |= host_fb
        st = self._post(n, read_offs, pre, pool, counts2[:n], scores,
                        cksum[:n], fb[:n], pair=pair)
        if st is None:
            return None
        state, state_offs, nrest, causes = st
        self.n_restaged += nrest
        # the post block sees a read whose host expansion overflowed as
        # flagged; a short read it skips before any check
        rs_h = 0 if host_fb is None else \
            int((host_fb & (pre[:n, 0] == 0)).sum())
        rec = self._record()
        rec["restaged"] += nrest
        rec["rs_h"] += rs_h
        rec["rs_dev"] += causes["dev"] - rs_h
        for k in ("ck", "stats", "geom", "simd"):
            rec[f"rs_{k}"] += causes[k]
        if t_rows is not None:
            took = np.nonzero(t_rows >= 0)[0]
            rs = int((state[state_offs[took] + 7] == 1).sum())
            rec["tier"] += len(took)
            rec["tier_rs"] += rs
            self.n_tier += len(took)
            self.n_tier_rs += rs
        scores64 = np.ascontiguousarray(scores, np.int64)
        prep = None
        if self._p2_on and not pair:
            prep = self._prep_windows(n, codes, read_offs, state, state_offs,
                                      scores64)
        return (n, qmax, codes, read_offs, qarr, has_qual, narr, name_offs,
                state, state_offs, scores64, prep), nrest

    def _finish(self, item, p2out):
        """fl_pass2_block for one batch, with the pass-2 step's output
        when there is one.  Returns the SAM text or None (the C block
        refused the batch)."""
        (n, qmax, codes, read_offs, qarr, has_qual, narr, name_offs, state,
         state_offs, scores64, prep) = item
        dev = None
        if p2out is not None:
            best64, mi64, mj64, rec16, valid, sp, nw = p2out
            dev = (prep[0], prep[1], best64, mi64, mj64, rec16, valid, sp, nw)
        text = self._pass2(n, qmax, codes, read_offs, qarr, has_qual, narr,
                           name_offs, state, state_offs, scores64,
                           ascii_codes=True, names_raw=True, dev=dev)
        if dev is not None:
            self.p2_used += int(self._dev_stats[0])
            self.p2_fb += int(self._dev_stats[1])
            self.p2_hit += int(self._dev_stats[2])
        return text

    # ---------------- batch loop ----------------

    def _launch(self, args, tag: str):
        """Host pre block for one batch (names, seqs, quals) and its
        collate step submitted to the worker thread: (host, future), or
        None when the lane does not take the batch."""
        t0 = time.perf_counter()
        got = self._prepare(*args)
        if got is None:
            return None
        host, dargs = got
        self._log(f"# {tag}-prep {time.perf_counter() - t0:.3f}s")

        def device_leg():
            t1 = time.perf_counter()
            # the repeat tier's step goes first: its kernels run while the
            # main step's launches are made, and its outputs are on the
            # host's side of the main step's fetch
            tier = None
            if host[13] is not None:
                fn, targs = host[13]
                with self._span("collate"):
                    tier = fn(*targs)
            outs = self._collate_outputs(dargs)
            if tier is not None:
                with self._span("fetch"):
                    outs = outs + [x.cpu().numpy() for x in tier]
            self._log(f"# {tag}-dev {time.perf_counter() - t1:.3f}s")
            return outs

        with self._span("stage"):
            return host, self._exec.submit(self._leg, self._record(),
                                           device_leg)

    def _collate_outputs(self, dargs):
        """The collate step on the device, its outputs on the host."""
        with self._span("collate"):
            outs = self._collate_fn()(*dargs)
        with self._span("fetch"):
            return [x.cpu().numpy() for x in outs]

    def _land(self, item, tag: str, pair: bool = False):
        """The collate step's outputs (a device error raises here) through
        the host post block: _post_batch's item, or None when the batch
        goes to the host (it did not launch, or the C block refused)."""
        if item is None:
            return None
        host, fut = item
        with self._span("wait"):
            outs = fut.result()
        with self._span("post") as post:
            got = self._post_batch(host, outs, pair=pair)
        if got is None:
            return None
        item2, nrest = got
        self._log(f"# {tag}-post {post.s:.3f}s restaged={nrest}")
        return item2

    def _pass2_leg(self, *args):
        """The worker thread's pass-2 step for one batch."""
        with self._span("pass2"):
            return self._dispatch_pass2(*args)

    def run_raw_fastq(self, path: str, out, fallback,
                      resume_log=None) -> None:
        """Map a strict FASTQ file, writing SAM records to `out` in input
        order.  fallback(names, seqs, quals) renders a batch on the host
        (a batch the lane does not take; counted in host_batches).

        resume_log: a ResumeLog.  Batches it checkpointed are skipped and
        the drand48 state restored (no RNG is consumed before pass 2, so
        the stream replays as the host loop's does); after each batch is
        written in order it ticks {reads written, output bytes, drand48
        state}, and the run ends with done()."""
        skip, written = 0, [0]
        if resume_log is not None:
            st = resume_log.load()
            if st:
                skip = st["reads_done"]
                rand._global._x = st["rng"]

        def batches():
            seen = 0
            for raw in iter_fastq_batches(path, self.batch):
                seen += len(raw[0])
                if seen <= skip:
                    written[0] = seen         # checkpointed: already written
                    continue
                yield raw

        def mid(item, raw):
            item2 = self._land(item, "dx")
            if item2 is None:
                return None
            prep, fut2 = item2[-1], None
            if prep is not None and len(prep[2]):
                host = item[0]
                with self._span("post"):
                    fut2 = self._exec.submit(self._leg, self._record(),
                                             self._pass2_leg, prep[2],
                                             host[10], host[11])
            return item2, fut2

        def fin(item, raw):
            if item is None:
                return self._on_host(fallback, *raw)
            item2, fut2 = item
            with self._span("wait"):
                p2out = None if fut2 is None else fut2.result()
            with self._span("tail") as tail:
                text = self._finish(item2, p2out)
            self._take_remap()
            self._log(f"# dx-pass2 {tail.s:.3f}s n={item2[0]} "
                      f"p2_used={self.p2_used} p2_fb={self.p2_fb} "
                      f"p2_hit={self.p2_hit}")
            return self._on_host(fallback, *raw) if text is None else text

        def write(text, raw):
            out.write(text)
            written[0] += len(raw[0])
            if resume_log is not None:
                out.flush()
                resume_log.tick(written[0], out.tell(), rand._global._x)

        secs = self._drive(batches(), "dx", lambda raw: raw, mid, fin, write)
        if resume_log is not None:
            resume_log.done()
        self._log(f"# dx-total {secs:.3f}s "
                  f"n_restaged={self.n_restaged} p2_used={self.p2_used} "
                  f"p2_fb={self.p2_fb} p2_hit={self.p2_hit} "
                  f"host_batches={self.host_batches} "
                  f"steps_built={self.steps_built}")

    def run_raw_pairs(self, plane, pathA: str, pathB: str, out,
                      oracle_one_pair, mk_pair) -> None:
        """Map two strict FASTQ files of mates, writing the pair records to
        `out` in input order (fastlane.py:1383-1612 of the reference).
        Both mates' front halves go through one collate step, mate A in
        rows 0..n-1 and mate B in rows n..2n-1, and the C pair block
        (`plane`, a PairLane) takes the resulting state for the pair
        flow's unrestricted mapping calls (fl_pair_map_single_dev); mate
        rescue, restricted remaps and the fine re-hash stay on the host.
        A pair the C block does not cover is rendered by
        oracle_one_pair(mk_pair(i, *raw)) on the same drand48 stream, as
        the host pair lane does; a batch the lane does not take, or the C
        block refuses, is rendered by the host pair lane in its place
        (counted in host_batches).  Pass 2 runs in the C pair block: the
        pass-2 step is not launched."""
        npairs = self.batch // 2

        def batches():
            itB = iter_fastq_batches(pathB, npairs)
            for nmA, sqA, qlA in iter_fastq_batches(pathA, npairs):
                nmB, sqB, qlB = next(itB, (None, None, None))
                if nmB is None or len(nmB) != len(nmA):
                    raise ValueError("paired files have different read "
                                     "counts")
                yield nmA, sqA, qlA, nmB, sqB, qlB
            if next(itB, None) is not None:
                raise ValueError("paired files have different read counts")

        def host_batch(raw):
            text = plane.render_raw_pairs(*raw, lambda i: oracle_one_pair(
                mk_pair(i, *raw)))
            if text is None:
                text = "".join(oracle_one_pair(mk_pair(i, *raw))
                               for i in range(len(raw[0])))
            return text

        def fin(item, raw):
            if item is None:
                return self._on_host(host_batch, raw)
            t0 = time.perf_counter()
            text = self._pair_tail(plane, raw, item[8], item[9], item[10],
                                   oracle_one_pair, mk_pair)
            self._take_remap()
            self._log(f"# dxp-tail {time.perf_counter() - t0:.3f}s "
                      f"npairs={len(raw[0])}")
            return self._on_host(host_batch, raw) if text is None else text

        npr = [0]

        def write(text, raw):
            out.write(text)
            npr[0] += len(raw[0])

        secs = self._drive(
            batches(), "dxp",
            lambda r: (r[0] + r[3], r[1] + r[4], r[2] + r[5]),
            lambda item, raw: self._land(item, "dxp", pair=True), fin, write,
            counters=("oracle_pairs",))
        self._log(f"# dxp-total {secs:.3f}s n_restaged={self.n_restaged} "
                  f"host_batches={self.host_batches} npairs={npr[0]} "
                  f"steps_built={self.steps_built}")

    def _pair_tail(self, plane, raw, state, state_offs, scores64,
                   oracle_one_pair, mk_pair) -> Optional[str]:
        """The C pair block on one batch with the collate step's per-mate
        state, the reference's per-pair protocol around it: the block maps
        the leading pairs it covers, the next pair goes to the oracle, and
        the block resumes after it.  None when the block refuses at the
        first pair (the batch goes to the host)."""
        nmA, sqA, qlA, nmB, sqB, qlB = raw
        npr = len(nmA)

        def oracle(lo, hi):
            self._record()["oracle_pairs"] += hi - lo
            with self._span("oracle"):
                return [oracle_one_pair(mk_pair(i, *raw))
                        for i in range(lo, hi)]

        doffA = np.ascontiguousarray(state_offs[:npr])
        doffB = np.ascontiguousarray(state_offs[npr:2 * npr])
        parts = []
        start = 0
        while start < npr:
            with self._span("tail"):
                arrA = plane._raw_arrays(nmA[start:], sqA[start:],
                                         qlA[start:])
                arrB = plane._raw_arrays(nmB[start:], sqB[start:],
                                         qlB[start:])
                if arrA is None or arrB is None:
                    return None
                dev = (state, np.ascontiguousarray(doffA[start:]),
                       np.ascontiguousarray(doffB[start:]), scores64)
                res = plane._call_arrays(npr - start, arrA, arrB,
                                         ascii_codes=True, names_raw=True,
                                         dev=dev)
            if res is None:
                if start == 0:
                    return None
                parts.extend(oracle(start, npr))
                break
            text, ndone = res
            parts.append(text)
            start += ndone
            if start < npr:
                parts.extend(oracle(start, start + 1))
                start += 1
        return "".join(parts)


def codec_encode_bulk(ascii_codes: np.ndarray) -> bytes:
    """ASCII read letters -> mangled codes (vectorized CODTAB gather)."""
    return codec.CODTAB[ascii_codes].tobytes()


def dp1_step(ref_alpha, reads, qlens, wd, S: int, mat, go: int, ge: int):
    """The device stage of `--device-pass1` (fastlane.py:1639-1664 of the
    reference, `_dp1_step_fn`'s step) on the device of its tensors:
    ref_alpha [N] uint8 reference codes (refcodes & 7, resident), reads
    [n, Q] uint8 alpha codes padded with 7, qlens [n] int32, wd [W, 4]
    int64 window descriptors {start, slen, read index, is_rev}, S the
    windows' padded subject length, mat the DeviceMatrix.  Returns the
    [W] int32 score-only full-matrix SW scores (sw_score_batch: sw_full.cu
    on a card, sw_score_ref on the CPU).

    Window starts are int64 end to end, so windows past 2^31 reference
    bases gather the right bases (the reference's int32 descriptors wrap
    there), and every gather index is clamped into range explicitly, as
    JAX clamps its gathers."""
    dev = reads.device
    reads = reads.to(torch.int32)
    n, Q = reads.shape
    starts, slens = wd[:, 0].to(torch.int64), wd[:, 1].to(torch.int32)
    ridx = wd[:, 2].to(torch.int64).clamp(0, n - 1)
    is_rev = wd[:, 3] == 1
    # reverse complement with each read's length (padding code 7; N and
    # the other codes with bit 2 set are their own complement)
    j = torch.arange(Q, dtype=torch.int64, device=dev)[None, :]
    src = qlens.to(torch.int64)[:, None] - 1 - j
    g = torch.gather(reads, 1, src.clamp(0, Q - 1))
    rcq = torch.where(src >= 0, torch.where((g & 4) == 0, g ^ 3, g), 7)
    qcs = torch.where(is_rev[:, None], rcq[ridx], reads[ridx])
    # the windows, gathered from the resident reference: code 7 at and
    # past each window's slen
    offs = torch.arange(S, dtype=torch.int64, device=dev)[None, :]
    gidx = (starts[:, None] + offs).clamp(0, ref_alpha.shape[0] - 1)
    wins = torch.where(offs >= slens[:, None], 7,
                       ref_alpha[gidx].to(torch.int32))
    return sw_score_batch(qcs, wins, slens, mat, go, ge, device=dev)
