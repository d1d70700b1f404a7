"""`map --fast` on one torch device: device pass + host traceback tail.

Counterpart of smalt_tpu/map/fastmode.py.  The host half is the
reference's own, line for line: the bulk FASTQ readers
(`iter_fastq_batches`, `iter_fastq_hybrid`, `RawBatch`), the batch
encoder, the mapq formula, and the traceback + SAM tail (`FastTail`,
`_tail_init` / `_tail_render`, with its native C renderers for single
reads and for pairs, and the exact-lane fallbacks).  The batch loop
(`run_fast_pipeline`, fastmode.py:1137 there) is the port's: its device
step is parallel/mesh.py, single-end and paired.  Paired runs put both
mates of a batch through one step of 2 x batch reads.  With nthreads > 1
the tails run on a pool of worker processes (`TailPool`), started fresh
(spawn) rather than forked, since a process forked after the parent made
a CUDA context may not use CUDA; no worker touches the device, each
builds its tail from picklable inputs (the name the index is saved
under, and for --fallback-exact its exact engine's engine_recipe),
and the output stays in input order and byte-identical to one process.
With a ResumeLog (nthreads = 1) the run ticks it after every batch it
writes (a checkpoint every CHECKPOINT_BATCHES ticks) and, restarted,
skips the batches a checkpoint recorded, whole.

Fast mode trades the exhaustive candidate search of the exact lane for
the device heuristic: output is reference-STYLE SAM (same fields, flags,
CIGAR/NM/AS conventions, mapq formula shape) but NOT bit-identical to
`map` — use the default exact mode for that.

Per batch: encode to uint8 [B, Q] on the host, copy to the device, run
the step on the current stream, and start a non-blocking copy of the
packed [12, B] result into pinned host memory behind a CUDA event.  Up
to PREFETCH batches are in flight; the tail waits on a batch's event
only when it renders that batch.  On the CPU the same code runs
synchronously (the tests' path).

Over a device mesh (`mesh_spec` "DP,IP", or all visible GPUs as pure dp
when there are several) the step is parallel/mesh.py's sharded step: the
batch pads to a multiple of dp, each dp row's part of the packed result
comes back behind an event of its own device.  With n_hosts > 1 the
input stripes by batch (batch b maps on host b % n_hosts), read serials
stay global, and each host writes its batches through a ShardWriter
(parallel/distributed.py) for merge_shards.
"""
from __future__ import annotations

import contextlib
import copy
import io
import multiprocessing as mp
import os
import sys
import time
import weakref
from collections import deque
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..seq import codec
from ..seq.io import Read, open_maybe_gzip
from ..seq.refset import RefSet
from ..index.table import KmerIndex

from ..align import core as ali_mod
from ..report.report import ReportWriter, RepAli, REPMATEFLG

# LONG_READ_Q is the kernel-selection boundary: reads padded above it use
# the banded device kernel and the banded/anchored host tail.  It MUST
# match the literal 512 in native/fastlane.c (fl_fast_tail_block /
# ft_map_one).  It is parallel/mesh.py's, declared again here (a test
# holds them equal) so that this module imports neither torch nor the
# device step: a tail worker (TailPool) imports it.
LONG_READ_Q = 512

MAPQ_MAX = 60           # results.c:70 MAPSCOR_MAX
MAPSCOR_MAX_RANDOM = 3  # results.c:57


# ------------------------------------------------------------------
# bulk FASTQ input
# ------------------------------------------------------------------

def iter_fastq_batches(path: str, batch: int) -> Iterator[
        Tuple[List[bytes], List[bytes], List[Optional[bytes]]]]:
    """Yield (names, seqs, quals) in batches of `batch` reads.
    C-speed parsing: chunked read + bytes.split, no per-line Python."""
    names: List[bytes] = []
    seqs: List[bytes] = []
    quals: List[Optional[bytes]] = []
    tail = b""
    with open_maybe_gzip(path) as f:
        while True:
            chunk = f.read(8 << 20)
            data = tail + chunk
            if not data:
                break
            lines = data.split(b"\n")
            if chunk:
                tail = lines.pop()           # partial last line
            else:
                tail = b""
                if lines and lines[-1] == b"":
                    lines.pop()
            nrec = len(lines) // 4
            for r in range(nrec):
                name = lines[4 * r]
                seq = lines[4 * r + 1]
                qual = lines[4 * r + 3]
                names.append(name[1:].split(b" ", 1)[0].split(b"\t", 1)[0])
                seqs.append(seq)
                quals.append(qual if qual else None)
                if len(names) == batch:
                    yield names, seqs, quals
                    names, seqs, quals = [], [], []
            rest = lines[4 * nrec:]
            tail = b"\n".join(rest + [tail]) if rest else tail
            if not chunk:
                break
    if names:
        yield names, seqs, quals


class RawBatch:
    """Zero-copy FASTQ batch: per-record extents into one raw chunk
    (fl_fastq_scan).  The C tail renders straight from `buf`; the
    list accessors materialize bytes only for the rare fallback
    paths (Python oracle, exact remap)."""

    def __init__(self, buf, n, name_off, name_len, seq_off, seq_len,
                 qual_off):
        self.buf = buf                  # np.uint8 array
        self.n = n
        self.name_off = name_off        # int64[n], absolute into buf
        self.name_len = name_len
        self.seq_off = seq_off
        self.seq_len = seq_len
        self.qual_off = qual_off

    def __len__(self):
        return self.n

    def name(self, i) -> bytes:
        o = int(self.name_off[i])
        return self.buf[o : o + int(self.name_len[i])].tobytes()

    def seq(self, i) -> bytes:
        o = int(self.seq_off[i])
        return self.buf[o : o + int(self.seq_len[i])].tobytes()

    def qual(self, i) -> bytes:
        o = int(self.qual_off[i])
        return self.buf[o : o + int(self.seq_len[i])].tobytes()

    def as_lists(self):
        idx = range(self.n)
        return ([self.name(i) for i in idx], [self.seq(i) for i in idx],
                [self.qual(i) for i in idx])

    def encode(self, Q: int) -> np.ndarray:
        """[n, Q] padded 3-bit alpha codes via the C encoder."""
        from ..native import get_lib
        enc = np.empty((self.n, Q), np.uint8)
        get_lib().fl_fastq_encode(self.buf.ctypes.data, self.n,
                                  self.seq_off.ctypes.data,
                                  self.seq_len.ctypes.data, Q,
                                  enc.ctypes.data)
        return enc


class _BytesThenStream:
    """Reads from a leading bytes buffer, then an open stream (the
    fallback arm of iter_fastq_hybrid resumes mid-file)."""

    def __init__(self, head: bytes, f):
        self._head = head
        self._f = f

    def read(self, sz):
        if self._head:
            r, self._head = self._head[:sz], self._head[sz:]
            return r
        return self._f.read(sz)


def iter_fastq_hybrid(path: str, batch: int) -> Iterator:
    """Yield RawBatch objects via the C scanner when the file is
    strict 4-line FASTQ, transparently degrading to the Python list
    parser ((names, seqs, quals) triples) on any shape the scanner
    rejects.  Consumers must accept both batch kinds."""
    from ..native import get_lib
    lib = get_lib()
    if lib is None or os.environ.get("SMALT_TPU_NO_FASTLANE"):
        yield from iter_fastq_batches(path, batch)
        return
    carry = b""
    with open_maybe_gzip(path) as f:
        eof = False
        while not eof:
            chunk = f.read(8 << 20)
            eof = not chunk
            data = carry + chunk if carry else chunk
            if not data:
                return
            buf = np.frombuffer(data, np.uint8)
            pos = 0
            while True:
                name_off = np.empty(batch, np.int64)
                name_len = np.empty(batch, np.int64)
                seq_off = np.empty(batch, np.int64)
                seq_len = np.empty(batch, np.int64)
                qual_off = np.empty(batch, np.int64)
                consumed = np.zeros(1, np.int64)
                n = int(lib.fl_fastq_scan(
                    buf.ctypes.data + pos, len(data) - pos, batch,
                    name_off.ctypes.data, name_len.ctypes.data,
                    seq_off.ctypes.data, seq_len.ctypes.data,
                    qual_off.ctypes.data, consumed.ctypes.data))
                if n < 0:
                    # unsupported shape: list-parse the rest of the file
                    yield from _parse_fastq_stream(
                        _BytesThenStream(data[pos:], f), batch)
                    return
                if n == batch or (eof and n > 0):
                    for a in (name_off, name_len, seq_off, seq_len,
                              qual_off):
                        a.resize(n, refcheck=False)
                    name_off += pos
                    seq_off += pos
                    qual_off += pos
                    yield RawBatch(buf, n, name_off, name_len,
                                   seq_off, seq_len, qual_off)
                    pos += int(consumed[0])
                    continue
                break       # mid-stream partial: carry into next chunk
            carry = data[pos:]


def _parse_fastq_stream(f, batch):
    """Python list parser over an open byte stream (fallback arm of
    iter_fastq_hybrid) — same record handling as iter_fastq_batches."""
    names: List[bytes] = []
    seqs: List[bytes] = []
    quals: List[Optional[bytes]] = []
    tail = b""
    while True:
        chunk = f.read(8 << 20)
        data = tail + chunk
        if not data:
            break
        lines = data.split(b"\n")
        if chunk:
            tail = lines.pop()
        else:
            tail = b""
            if lines and lines[-1] == b"":
                lines.pop()
        nrec = len(lines) // 4
        for r in range(nrec):
            name = lines[4 * r]
            seq = lines[4 * r + 1]
            qual = lines[4 * r + 3]
            names.append(name[1:].split(b" ", 1)[0].split(b"\t", 1)[0])
            seqs.append(seq)
            quals.append(qual if qual else None)
            if len(names) == batch:
                yield names, seqs, quals
                names, seqs, quals = [], [], []
        rest = lines[4 * nrec:]
        tail = b"\n".join(rest + [tail]) if rest else tail
        if not chunk:
            break
    if names:
        yield names, seqs, quals


def encode_batch(seqs: List[bytes], Q: int) -> np.ndarray:
    """[B, Q] uint8 alpha codes, padded with 7 (TERM: invalid words,
    zero scores).  uint8 keeps the host->device transfer small (the
    device step casts to int32 on chip)."""
    B = len(seqs)
    arr = np.full((B, Q), 7, np.uint8)
    flat = codec.alpha(codec.encode(b"".join(s[:Q] for s in seqs)))
    o = 0
    for i, s in enumerate(seqs):
        n = min(len(s), Q)
        arr[i, :n] = flat[o : o + n]
        o += n
    return arr


# ------------------------------------------------------------------
# lean host tail: one traceback + one SAM line per mapped read
# ------------------------------------------------------------------

_LOG10 = 2.302585092994046    # results.c:104 QUALSCOR_LOGBASE


def _batch_extents(names, seqs, quals):
    """Per-read (offset, length) extents for the C tails: zero-copy
    from a RawBatch, one concat from a list triple.  None when any
    qual is missing or length-mismatched (caller falls back)."""
    if isinstance(names, RawBatch):
        rb = names
        return (rb.n, rb.buf, rb.seq_off, rb.seq_len, rb.buf,
                rb.qual_off, np.ones(rb.n, np.uint8), rb.buf,
                rb.name_off, rb.name_len)
    n = len(names)
    seq_len = np.asarray([len(s) for s in seqs], np.int64)
    seq_off = np.zeros(n, np.int64)
    np.cumsum(seq_len[:-1], out=seq_off[1:])
    has_qual = np.empty(n, np.uint8)
    qp = []
    for i, q in enumerate(quals):
        if q is None or len(q) != seq_len[i]:
            return None
        has_qual[i] = 1
        qp.append(q)
    name_len = np.asarray([len(x) for x in names], np.int64)
    name_off = np.zeros(n, np.int64)
    np.cumsum(name_len[:-1], out=name_off[1:])
    seqs_buf = np.frombuffer(b"".join(seqs) or b"\0", np.uint8)
    quals_buf = np.frombuffer(b"".join(qp) or b"\0", np.uint8)
    names_buf = np.frombuffer(b"".join(names) or b"\0", np.uint8)
    return (n, seqs_buf, seq_off, seq_len, quals_buf, seq_off,
            has_qual, names_buf, name_off, name_len)


def fast_mapq(sw1: int, sw2: int, qlen: int, hits_used: int = 0,
              hits_tot: int = 0, n2nd: int = 1,
              ambig: bool = False) -> int:
    """The reference mapq core (results.c:1310-1334) fed by the device
    pass's own bookkeeping:

      base = 250*sw1/qlen*(sw1-sw2)/qlen - qn   (+4 when >= 0)
      qn   = 10*log10(n2nd)          runner-up multiplicity penalty
      cap  = 60 + 10*log10(used/(tot+3))        (results.c:1193-1197)

    `used`/`tot` are the seed placements the MAXC expansion kept vs all
    indexed placements of the selected seed words, so a read whose
    search was truncated (repeats) cannot report full confidence even
    when its runner-up window was never scored.  `ambig` marks a read
    with multiple equally-voted far diagonal clusters (unscored repeat
    copies): confidence is then at best a random pick among copies, so
    mapq caps at MAPSCOR_MAX_RANDOM (results.c:220-224).  Ties -> 0."""
    import math
    if sw2 >= sw1:
        return 0
    qn = int(10.0 * math.log(n2nd) / _LOG10) if n2nd > 1 else 0
    m = 250.0 * sw1 / qlen * (sw1 - sw2) / qlen - qn
    if m >= 0:
        m += 4.0               # MAPSCOR_MIN_UNIQ, results.c:58
    cap = MAPQ_MAX
    if hits_tot > 0:
        fs = hits_used / (hits_tot + 3.0)      # MAPSCOR_DUMMY_COUNT
        if fs <= 1e-7:                         # MINLOGARG
            cap = 0
        else:
            deficit = -10.0 * math.log(fs) / _LOG10
            cap = MAPQ_MAX - int(deficit) if deficit < MAPQ_MAX else 0
    if ambig and cap > 3:
        cap = 3                    # MAPSCOR_MAX_RANDOM
    if m > cap:
        m = cap
    if m > MAPQ_MAX:
        return MAPQ_MAX
    return int(m) if m > 0 else 0


class FastTail:
    """Per-worker traceback + SAM renderer."""

    def __init__(self, refset: RefSet, penalties=(1, -2, -4, -3),
                 minscor: int = 18):
        self.refset = refset
        self.minscor = minscor
        m, go, ge = ali_mod.make_score_matrix(*penalties)
        self.matrix, self.gapopen, self.gapext = m, go, ge
        self.lam = ali_mod.matrix_lambda(m)
        self.avgs = ali_mod.avg_penalties(m)
        self.ref_codes = refset.codes
        import numpy as _np
        self._mat32 = _np.ascontiguousarray(m, dtype=_np.int32)
        self._scr = None

    def _traceback(self, qcodes, is_rev, win_codes, l_edge, r_edge):
        """Best local alignment of the window band: revcomp + profile
        build + recursive driver fused into one native crossing; the
        pre-order first result is the whole-interval optimum."""
        from ..native import get_lib, GrowBuf
        import numpy as np
        lib = get_lib()
        qlen = len(qcodes)
        slen = len(win_codes)
        if slen < 1 or qlen < ali_mod.ALILEN_MIN:
            return None
        scr = self._scr
        if scr is None:
            scr = self._scr = {
                "W": GrowBuf(np.int32), "H": GrowBuf(np.int32),
                "E": GrowBuf(np.int32), "dirm": GrowBuf(np.uint8, 4096),
                "back": GrowBuf(np.uint8), "pool": GrowBuf(np.uint8),
                "res": GrowBuf(np.int64),
            }
        scr["W"].ensure(8 * qlen)
        scr["H"].ensure(qlen + 1)
        scr["E"].ensure(qlen + 1)
        ndir_cap = (qlen + slen + 2) * (slen + 1)
        scr["dirm"].ensure(ndir_cap)
        back_cap = 2 * (qlen + slen) + 8
        scr["back"].ensure(back_cap)
        diff_cap = 4 * (qlen + slen) + 1024
        scr["pool"].ensure(diff_cap)
        res_cap = slen // ali_mod.ALILEN_MIN + 4
        scr["res"].ensure(res_cap * 7)
        q = np.ascontiguousarray(qcodes, dtype=np.uint8)
        w = np.ascontiguousarray(win_codes, dtype=np.uint8)
        minscore = max(self.minscor, 1)
        minscorlen = ali_mod.ALILEN_MIN
        if minscorlen * self.avgs[0] < minscore:
            minscorlen = minscore // self.avgs[0]
        n = lib.mc_fast_align(
            q.ctypes.data, qlen, 1 if is_rev else 0,
            self._mat32.ctypes.data, w.ctypes.data, slen,
            l_edge, r_edge, minscore, minscorlen,
            -self.gapopen, -self.gapext,
            scr["W"].addr, scr["H"].addr, scr["E"].addr,
            scr["dirm"].addr, ndir_cap,
            scr["back"].addr, back_cap,
            scr["pool"].addr, diff_cap,
            scr["res"].addr, res_cap)
        if n <= 0:
            return None
        r = scr["res"].arr
        off, dn = int(r[5]), int(r[6])
        diff = scr["pool"].arr[off : off + dn].tolist()
        return (int(r[0]), int(r[1]), int(r[2]), int(r[3]), int(r[4]),
                diff)

    def _dev_align(self, qcodes, is_rev, win_codes, ti, tj, sc_hint):
        """Device-canonical tail (mc_dev_align): gapless shortcut from
        the device argmax (ti, tj in the clamped-window / raw-read
        frames; -1 = unknown), else the same standard-affine DP the
        device kernel runs, host-side.  Same result tuple as
        _traceback."""
        from ..native import get_lib, GrowBuf
        import numpy as np
        lib = get_lib()
        qlen = len(qcodes)
        slen = len(win_codes)
        if slen < 1 or qlen < ali_mod.ALILEN_MIN:
            return None
        scr = self._scr
        if scr is None:
            scr = self._scr = {
                "W": GrowBuf(np.int32), "H": GrowBuf(np.int32),
                "E": GrowBuf(np.int32), "dirm": GrowBuf(np.uint8, 4096),
                "back": GrowBuf(np.uint8), "pool": GrowBuf(np.uint8),
                "res": GrowBuf(np.int64),
            }
        scr["W"].ensure(8 * qlen)
        scr["H"].ensure(qlen + 1)
        scr["E"].ensure(qlen + 1)
        ndir_cap = qlen * slen + 1
        scr["dirm"].ensure(ndir_cap)
        back_cap = 2 * (qlen + slen) + 8
        scr["back"].ensure(back_cap)
        diff_cap = 4 * (qlen + slen) + 1024
        scr["pool"].ensure(diff_cap)
        scr["res"].ensure(7)
        q = np.ascontiguousarray(qcodes, dtype=np.uint8)
        w = np.ascontiguousarray(win_codes, dtype=np.uint8)
        n = lib.mc_dev_align(
            q.ctypes.data, qlen, 1 if is_rev else 0,
            self._mat32.ctypes.data, w.ctypes.data, slen,
            ti, tj, sc_hint, max(self.minscor, 1),
            -self.gapopen, -self.gapext,
            scr["W"].addr, scr["H"].addr, scr["E"].addr,
            scr["dirm"].addr, ndir_cap,
            scr["back"].addr, back_cap,
            scr["pool"].addr, diff_cap,
            scr["res"].addr)
        if n <= 0:
            return None
        r = scr["res"].arr
        off, dn = int(r[5]), int(r[6])
        diff = scr["pool"].arr[off : off + dn].tolist()
        return (int(r[0]), int(r[1]), int(r[2]), int(r[3]), int(r[4]),
                diff)

    def _finish(self, win_start, tb, is_rev, mapq, qlen) -> RepAli:
        sw, ps, pe, ss, se, diff = tb
        refset = self.refset
        g = win_start + ss
        sidx = int(refset.find_seqidx(np.asarray([g]))[0])
        local = g - int(refset.offsets[sidx]) + 1
        rp = RepAli()
        rp.status = REPMATEFLG.MAPPED | (REPMATEFLG.REVERSE if is_rev else 0)
        rp.swatscor = sw
        rp.mapscor = mapq
        if is_rev:
            # ps/pe are in the reverse-complemented query frame (the
            # profile mc_fast_align aligned); the writer expects
            # FORWARD-frame coordinates (result.py add_from_ali does the
            # same conversion) — without it the clip sides swap on
            # partially-aligned reverse reads
            rp.q_start = qlen - pe
            rp.q_end = qlen - ps
        else:
            rp.q_start = ps + 1
            rp.q_end = pe + 1
        rp.s_start = local
        rp.s_end = local + (se - ss)
        rp.s_idx = sidx
        rp.diff = diff
        return rp

    def map_one(self, read: Read, sc1: int, sc2: int, ws: int, is_rev: bool,
                win_len: int, pad: int, q_padded: int,
                hits_used: int = 0, hits_tot: int = 0,
                n2nd: int = 1, ambig: bool = False,
                tb_i: int = -1, tb_j: int = -1) -> Optional[RepAli]:
        """SE mapping tail for one read given its device-pass winner."""
        qlen = len(read.seq)
        if sc1 < self.minscor or qlen < 5:
            return None
        refset = self.refset
        # clamp the window to the contig containing the seed diagonal:
        # an unclamped window near a contig end lets the alignment run
        # into the next contig (POS+CIGAR past LN / straddling records)
        shift = (q_padded - qlen) if is_rev else 0
        anchor_g = min(max(ws + pad + shift + qlen // 2, 0),
                       refset.total_len - 1)
        sidx = int(refset.find_seqidx(np.asarray([anchor_g]))[0])
        c_lo = int(refset.offsets[sidx])
        c_hi = int(refset.offsets[sidx + 1])
        w0 = max(ws, c_lo)
        w1 = min(ws + win_len, c_hi)
        if w1 - w0 < 1:
            return None
        win = self.ref_codes[w0:w1]
        if tb_i >= 0 and q_padded <= LONG_READ_Q:
            # device-canonical tail (short-read batch): the kernel's
            # argmax anchors a gapless shortcut; gapped/clamped reads
            # replay the device DP host-side (mc_dev_align)
            ti_l = tb_i - (w0 - ws)
            tj_l = tb_j - shift
            if not (0 <= ti_l < (w1 - w0) and 0 <= tj_l < qlen):
                ti_l = tj_l = -1
            tb = self._dev_align(read.seq, is_rev, win, ti_l, tj_l, sc1)
            if tb is None:
                return None
            return self._finish(w0, tb, is_rev,
                                fast_mapq(sc1, sc2, qlen, hits_used,
                                          hits_tot, n2nd, ambig), qlen)
        # long-read path.  With a banded-kernel argmax anchor, a NARROW
        # band centred on the end diagonal tj - ti suffices (the path's
        # diagonal wander is bounded by its indels, not by the seed
        # placement slack); a result below the device score falls back
        # to the wide band.  Contract note: the anchored band accepts
        # the first alignment scoring >= the device score (the
        # device-canonical placement) — in the rare case the wide
        # band's extra +-24/48 margin holds a strictly better
        # alignment, the two paths may differ (fast mode is heuristic;
        # the score never drops below the device score).  Without an
        # anchor the host band must cover the DEVICE band (diag
        # offsets center +- W/2); short reads (legacy no-anchor
        # callers) keep the +-24/48 band.
        center = -(pad + shift) + (w0 - ws)
        drift = 0
        tb = None
        if q_padded > LONG_READ_Q:
            from ..ops.sw import band_width_for
            drift = band_width_for(q_padded, pad) // 2
            if tb_i >= 0:
                ti_l = tb_i - (w0 - ws)
                tj_l = tb_j - shift
                if 0 <= ti_l < (w1 - w0) and 0 <= tj_l < qlen:
                    d_end = tj_l - ti_l
                    margin = max(32, qlen // 48) + 16
                    tb = self._traceback(read.seq, is_rev, win,
                                         d_end - margin, d_end + margin)
                    if tb is not None and tb[0] < sc1:
                        tb = None
        if tb is None:
            tb = self._traceback(read.seq, is_rev, win,
                                 center - 24 - drift,
                                 center + 48 + drift)
            if tb is None or tb[0] < sc1:
                full = self._traceback(read.seq, is_rev, win,
                                       -(len(win) - 1), qlen - 1)
                if full is not None and (tb is None or full[0] > tb[0]):
                    tb = full
        if tb is None:
            return None
        return self._finish(w0, tb, is_rev,
                            fast_mapq(sc1, sc2, qlen, hits_used,
                                      hits_tot, n2nd, ambig), qlen)

    def rescue_mate(self, read: Read, anchor: RepAli,
                    insert_min: int, insert_max: int) -> Optional[RepAli]:
        """Mate rescue (the fast-mode analogue of rmap.c:1934-2060):
        full-band SW of the unmapped mate against the insert window on
        the proper-pair strand implied by the anchor.  The rescued
        mapq follows the reference's dependent-mapping rule
        (scorePairsSimple (ii), resultpairs.c:871-876): P_b cannot
        exceed P_a, so mapq_b = min(own-score mapq, anchor mapq)."""
        qlen = len(read.seq)
        if qlen < 5:
            return None
        refset = self.refset
        a_glob = int(refset.offsets[anchor.s_idx]) + anchor.s_start - 1
        anchor_rev = bool(anchor.status & REPMATEFLG.REVERSE)
        if anchor_rev:
            lo = a_glob + (anchor.s_end - anchor.s_start) - insert_max
            hi = a_glob + (anchor.s_end - anchor.s_start)
        else:
            lo = a_glob
            hi = a_glob + insert_max
        # rescue stays inside the anchor's contig (no straddling records)
        c_lo = int(refset.offsets[anchor.s_idx])
        c_hi = int(refset.offsets[anchor.s_idx + 1])
        lo = max(c_lo, lo - qlen)
        hi = min(c_hi, hi + qlen)
        if hi - lo < qlen:
            return None
        is_rev = not anchor_rev
        win = self.ref_codes[lo:hi]
        tb = self._traceback(read.seq, is_rev, win, -(len(win) - 1),
                             qlen - 1)
        if tb is None:
            return None
        rp = self._finish(lo, tb, is_rev, 0, qlen)
        rp.mapscor = min(fast_mapq(rp.swatscor, 0, qlen),
                         int(anchor.mapscor))
        return rp

    def render(self, names, seqs, quals, outs, win_len: int, pad: int,
               q_padded: int, writer: ReportWriter,
               exact_fallback=None, raw_out=None,
               base_idx: int = 0) -> None:
        score = outs["score"]
        score2 = outs["score2"]
        start = outs["start"]
        strand = outs["strand"]
        used = outs.get("hits_used")
        tot = outs.get("hits_tot")
        n2 = outs.get("n2nd")
        amb = outs.get("ambig")
        tbi = outs.get("tb_i")
        tbj = outs.get("tb_j")
        for i, name in enumerate(names):
            hu = int(used[i]) if used is not None else 0
            ht = int(tot[i]) if tot is not None else 0
            if exact_fallback is not None and ht > hu:
                # the MAXC expansion truncated this read's search: remap
                # it through the exact engine (the reference's exhaustive
                # candidate handling) instead of trusting the heuristic
                text = exact_fallback(names[i], seqs[i], quals[i],
                                      base_idx + i)
                if text is not None:
                    raw_out.write(text)
                    continue
            read = Read(name=name.decode(), seq=codec.encode(seqs[i]),
                        qual=quals[i])
            rp = self.map_one(read, int(score[i]), int(score2[i]),
                              int(start[i]), bool(strand[i]),
                              win_len, pad, q_padded, hu, ht,
                              int(n2[i]) if n2 is not None else 1,
                              bool(amb[i]) if amb is not None else False,
                              int(tbi[i]) if tbi is not None else -1,
                              int(tbj[i]) if tbj is not None else -1)
            if rp is None:
                rp = RepAli()   # unmapped record
            writer._write_one(rp, read, None, 0, 0)

    def render_native(self, names, seqs, quals, outs, win_len: int,
                      pad: int, q_padded: int, soft: bool, xmm: bool,
                      buf, exact_fallback=None,
                      base_idx: int = 0) -> bool:
        """One C call (fl_fast_tail_block) renders the whole SE batch:
        byte-identical to the Python render() path.  Returns False when
        the native lane is unavailable or errors (caller then runs the
        Python loop — the oracle)."""
        import os
        from ..native import get_lib
        if os.environ.get("SMALT_TPU_NO_FASTLANE"):
            return False
        lib = get_lib()
        if lib is None or not hasattr(lib, "fl_fast_tail_block"):
            return False
        refset = self.refset
        cache = getattr(self, "_nat", None)
        if cache is None:
            snames, offs = [], [0]
            for s in range(refset.nseq):
                snames.append(refset.sam_name(s).encode())
                offs.append(offs[-1] + len(snames[-1]))
            cache = self._nat = {
                "snames": np.frombuffer(b"".join(snames) or b"\0",
                                        np.uint8).copy(),
                "sname_offs": np.asarray(offs, np.int64),
                "offsets": np.ascontiguousarray(refset.offsets, np.int64),
                "refcodes": np.ascontiguousarray(refset.codes, np.uint8),
            }
        ext = _batch_extents(names, seqs, quals)
        if ext is None:
            return False
        (n, seqs_buf, seq_off, seq_len, quals_buf, qual_off, has_qual,
         names_buf, name_off, name_len) = ext

        def a32(k):
            return np.ascontiguousarray(outs[k], np.int32)

        sc, sc2 = a32("score"), a32("score2")
        st, sd = a32("start"), a32("strand")
        hu, ht = a32("hits_used"), a32("hits_tot")
        n2, am = a32("n2nd"), a32("ambig")
        assert len(sc) == n, (len(sc), n)   # the C tail reads n entries
        if "tb_i" in outs:
            tbi, tbj = a32("tb_i"), a32("tb_j")
        else:
            tbi = np.full(n, -1, np.int32)
            tbj = np.full(n, -1, np.int32)
        skip = None
        if exact_fallback is not None:
            skip = (ht > hu).astype(np.uint8)
        qmax = int(seq_len.max()) if n else 1
        cap = int(name_len.sum()) + n * (2 * qmax + 160)
        out_offs = np.zeros(n + 1, np.int64)
        ma, _ = self.avgs
        for _ in range(3):
            out = np.empty(cap, np.uint8)
            rc = lib.fl_fast_tail_block(
                cache["refcodes"].ctypes.data,
                cache["offsets"].ctypes.data, refset.nseq,
                cache["snames"].ctypes.data,
                cache["sname_offs"].ctypes.data,
                self._mat32.ctypes.data, -self.gapopen, -self.gapext,
                ma, self.minscor,
                1 if soft else 0, 1 if xmm else 0,
                win_len, pad, q_padded,
                n, seqs_buf.ctypes.data, seq_off.ctypes.data,
                seq_len.ctypes.data,
                quals_buf.ctypes.data, qual_off.ctypes.data,
                has_qual.ctypes.data,
                names_buf.ctypes.data, name_off.ctypes.data,
                name_len.ctypes.data,
                sc.ctypes.data, sc2.ctypes.data, st.ctypes.data,
                sd.ctypes.data, hu.ctypes.data, ht.ctypes.data,
                n2.ctypes.data, am.ctypes.data,
                tbi.ctypes.data, tbj.ctypes.data,
                skip.ctypes.data if skip is not None else None,
                out.ctypes.data, cap, out_offs.ctypes.data)
            if rc == -3:
                cap *= 4
                continue
            if rc < 0:
                return False
            text = out[:rc].tobytes().decode("ascii")
            if skip is None or not skip.any():
                buf.write(text)
                return True
            raw = isinstance(names, RawBatch)
            for i in range(n):
                if skip[i]:
                    if raw:
                        ft = exact_fallback(names.name(i), names.seq(i),
                                            names.qual(i), base_idx + i)
                    else:
                        ft = exact_fallback(names[i], seqs[i], quals[i],
                                            base_idx + i)
                    if ft is None:
                        return False
                    buf.write(ft)
                else:
                    buf.write(text[out_offs[i] : out_offs[i + 1]])
            return True
        return False

    def render_pairs_native(self, names, seqs, quals, outs, win_len: int,
                            pad: int, q_padded: int, insert_min: int,
                            insert_max: int, soft: bool, xmm: bool,
                            buf, libcode=None, ihist=None,
                            exact_fallback=None, base_idx: int = 0) -> bool:
        """One C call (fl_fast_tail_pairs) renders the whole PE batch,
        byte-identical to render_pairs — including the -g histogram
        weighting (cumulative bins passed through) and the exact-pair
        fallback for MAXC-truncated searches.  Returns False when the
        lane is unavailable (Python oracle runs)."""
        import os
        from ..native import get_lib
        from ..results.pairs import LIB_PAIREDEND
        if os.environ.get("SMALT_TPU_NO_FASTLANE"):
            return False
        lib = get_lib()
        if lib is None or not hasattr(lib, "fl_fast_tail_pairs"):
            return False
        refset = self.refset
        cache = getattr(self, "_nat", None)
        if cache is None:
            snames, offs = [], [0]
            for s in range(refset.nseq):
                snames.append(refset.sam_name(s).encode())
                offs.append(offs[-1] + len(snames[-1]))
            cache = self._nat = {
                "snames": np.frombuffer(b"".join(snames) or b"\0",
                                        np.uint8).copy(),
                "sname_offs": np.asarray(offs, np.int64),
                "offsets": np.ascontiguousarray(refset.offsets, np.int64),
                "refcodes": np.ascontiguousarray(refset.codes, np.uint8),
            }
        ext = _batch_extents(names, seqs, quals)
        if ext is None:
            return False
        (n, seqs_buf, seq_off, seq_len, quals_buf, qual_off, has_qual,
         names_buf, name_off, name_len) = ext

        def a32(k):
            return np.ascontiguousarray(outs[k], np.int32)

        sc, sc2 = a32("score"), a32("score2")
        st, sd = a32("start"), a32("strand")
        hu, ht = a32("hits_used"), a32("hits_tot")
        n2, am = a32("n2nd"), a32("ambig")
        assert len(sc) == n, (len(sc), n)   # the C tail reads n entries
        if "tb_i" in outs:
            tbi, tbj = a32("tb_i"), a32("tb_j")
        else:
            tbi = np.full(n, -1, np.int32)
            tbj = np.full(n, -1, np.int32)
        qmax = int(seq_len.max()) if n else 1
        cap = int(name_len.sum()) + n * (2 * qmax + 192)
        ma, _ = self.avgs
        lc = LIB_PAIREDEND if libcode is None else libcode
        if ihist is not None:
            harr = ihist.smooth if ihist.smoothed else ihist.counts
            hist_cum = np.cumsum(np.asarray(harr, np.int64))
            hist_args = (hist_cum.ctypes.data, ihist.span, ihist.insizlo,
                         ihist.insizhi, ihist.scalfac, ihist.num)
        else:
            hist_args = (None, 0, 0, 0, 0, 0)
        B = n // 2
        skip = None
        pair_offs = np.zeros(B + 1, np.int64)
        if exact_fallback is not None:
            trunc = ht > hu
            skip = (trunc[:B] | trunc[B:]).astype(np.uint8)
        for _ in range(3):
            out = np.empty(cap, np.uint8)
            rc = lib.fl_fast_tail_pairs(
                cache["refcodes"].ctypes.data,
                cache["offsets"].ctypes.data, refset.nseq,
                cache["snames"].ctypes.data,
                cache["sname_offs"].ctypes.data,
                self._mat32.ctypes.data, -self.gapopen, -self.gapext,
                ma, self.minscor,
                1 if soft else 0, 1 if xmm else 0,
                win_len, pad, q_padded,
                insert_min, insert_max, lc,
                n, seqs_buf.ctypes.data, seq_off.ctypes.data,
                seq_len.ctypes.data,
                quals_buf.ctypes.data, qual_off.ctypes.data,
                has_qual.ctypes.data,
                names_buf.ctypes.data, name_off.ctypes.data,
                name_len.ctypes.data,
                sc.ctypes.data, sc2.ctypes.data, st.ctypes.data,
                sd.ctypes.data, hu.ctypes.data, ht.ctypes.data,
                n2.ctypes.data, am.ctypes.data,
                tbi.ctypes.data, tbj.ctypes.data,
                *hist_args,
                skip.ctypes.data if skip is not None else None,
                pair_offs.ctypes.data,
                out.ctypes.data, cap)
            if rc == -3:
                cap *= 4
                continue
            if rc < 0:
                return False
            text = out[:rc].tobytes().decode("ascii")
            if skip is None or not skip.any():
                buf.write(text)
                return True
            raw = isinstance(names, RawBatch)
            for i in range(B):
                if skip[i]:
                    if raw:
                        args = (names.name(i), names.seq(i),
                                names.qual(i), names.name(B + i),
                                names.seq(B + i), names.qual(B + i))
                    else:
                        args = (names[i], seqs[i], quals[i],
                                names[B + i], seqs[B + i], quals[B + i])
                    ft = exact_fallback(*args, base_idx + i)
                    if ft is None:
                        return False
                    buf.write(ft)
                else:
                    buf.write(text[pair_offs[i] : pair_offs[i + 1]])
            return True
        return False

    # ---------------- paired-end ----------------

    def _glob(self, rp: RepAli) -> int:
        return int(self.refset.offsets[rp.s_idx]) + rp.s_start - 1

    def _pair_geometry(self, rpA, rpB, insert_min, insert_max,
                       libcode=None):
        """(pairflg, isizeA): the reference's proper-pair test
        (testProperPair, resultpairs.c:135-186 — shared with the exact
        path via results/pairs.py) for ANY library type (pe/mp/pp/all)
        and the SAM-spec TLEN for mate A."""
        from ..report.report import REPPAIR
        from ..results.pairs import (LIB_PAIREDEND, MAPFLG_PROPER,
                                     MAPFLG_WITHIN, PMF_LEFTMOST2nd,
                                     PMF_REVERSE_1st, PMF_REVERSE_2nd,
                                     test_proper_pair)
        if libcode is None:
            libcode = LIB_PAIREDEND
        pairflg = REPPAIR.MAPPED
        if rpA.s_idx != rpB.s_idx:
            return pairflg, 0
        pairflg |= REPPAIR.CONTIG
        iflag = 0
        if rpA.status & REPMATEFLG.REVERSE:
            iflag |= PMF_REVERSE_1st
        if rpB.status & REPMATEFLG.REVERSE:
            iflag |= PMF_REVERSE_2nd
        if rpB.s_start < rpA.s_start:
            iflag |= PMF_LEFTMOST2nd
        rA = min(rpA.s_start, rpB.s_start)
        rB = max(rpA.s_end, rpB.s_end)
        isiz = rB - rA + 1
        if iflag & PMF_LEFTMOST2nd:
            isiz = -isiz
        mapflg = test_proper_pair(isiz, iflag, insert_min, insert_max,
                                  libcode)
        if mapflg & MAPFLG_PROPER:
            pairflg |= REPPAIR.PROPER
        if mapflg & MAPFLG_WITHIN:
            pairflg |= REPPAIR.WITHIN
        return pairflg, isiz

    def _pair_elevate(self, rp, other, n2, ihist, isiz):
        """Marginal-probability elevation of a score-tied mate inside a
        proper pair (the fast-mode shape of assignProbabilityToPairs +
        marginal mapq, resultpairs.c:753-952): the mate's other
        (tie) placements would pair improperly, so its pair-marginal
        probability is p_in/(p_in + (N-1)*p_allout) with N tie
        placements; its mapq rises to that marginal, never above the
        anchor's."""
        import math
        from ..results.pairs import (CUMULPROB_IMPROPER,
                                     CUMULPROB_PROPER_OUTSIDE)
        if rp.mapscor > MAPSCOR_MAX_RANDOM or \
                other.mapscor <= MAPSCOR_MAX_RANDOM:
            return
        p_prop = 1.0 - CUMULPROB_IMPROPER
        p_in = p_prop * (1.0 - CUMULPROB_PROPER_OUTSIDE)
        if ihist is not None:
            count, totnum = ihist.count_cumulative(abs(isiz), True)
            if totnum > 0:
                p = count / totnum
                iab = p_prop
                if p >= 0.5:
                    iab = 0.5 - p / 2
                p_in = iab * (p * (1.0 - CUMULPROB_PROPER_OUTSIDE) +
                              CUMULPROB_PROPER_OUTSIDE)
        p_allout = CUMULPROB_IMPROPER + p_prop * CUMULPROB_PROPER_OUTSIDE
        n_other = max(int(n2), 1)
        marg = p_in / (p_in + n_other * p_allout)
        if marg >= 1.0:
            elev = MAPQ_MAX
        else:
            elev = int(-10.0 * math.log(1.0 - marg) / _LOG10)
        rp.mapscor = max(rp.mapscor,
                         min(elev, int(other.mapscor), MAPQ_MAX))

    def render_pairs(self, names, seqs, quals, outs, win_len: int,
                     pad: int, q_padded: int, insert_min: int,
                     insert_max: int, writer: ReportWriter,
                     libcode=None, ihist=None,
                     exact_fallback=None, raw_out=None,
                     base_idx: int = 0) -> None:
        from ..report.report import REPPAIR
        score = outs["score"]
        score2 = outs["score2"]
        start = outs["start"]
        strand = outs["strand"]
        used = outs.get("hits_used")
        tot = outs.get("hits_tot")
        n2 = outs.get("n2nd")
        amb = outs.get("ambig")
        tbi = outs.get("tb_i")
        tbj = outs.get("tb_j")

        def stats(j):
            if used is None:
                return 0, 0, 1, False
            return int(used[j]), int(tot[j]), int(n2[j]), bool(amb[j])

        B = len(names) // 2
        for i in range(B):
            ia, ib = i, B + i
            if exact_fallback is not None and used is not None and \
                    (int(tot[ia]) > int(used[ia]) or
                     int(tot[ib]) > int(used[ib])):
                # MAXC-truncated search on either mate: the whole pair
                # remaps through the exact engine
                ft = exact_fallback(names[ia], seqs[ia], quals[ia],
                                    names[ib], seqs[ib], quals[ib],
                                    base_idx + i)
                if ft is not None:
                    raw_out.write(ft)
                    continue
            readA = Read(name=names[ia].decode(),
                         seq=codec.encode(seqs[ia]), qual=quals[ia])
            readB = Read(name=names[ib].decode(),
                         seq=codec.encode(seqs[ib]), qual=quals[ib])
            rpA = self.map_one(readA, int(score[ia]), int(score2[ia]),
                               int(start[ia]), bool(strand[ia]),
                               win_len, pad, q_padded, *stats(ia),
                               tb_i=int(tbi[ia]) if tbi is not None else -1,
                               tb_j=int(tbj[ia]) if tbi is not None else -1)
            rpB = self.map_one(readB, int(score[ib]), int(score2[ib]),
                               int(start[ib]), bool(strand[ib]),
                               win_len, pad, q_padded, *stats(ib),
                               tb_i=int(tbi[ib]) if tbi is not None else -1,
                               tb_j=int(tbj[ib]) if tbi is not None else -1)
            if rpA is None and rpB is not None:
                rpA = self.rescue_mate(readA, rpB, insert_min, insert_max)
            elif rpB is None and rpA is not None:
                rpB = self.rescue_mate(readB, rpA, insert_min, insert_max)
            pairflg = 0
            isizeA = 0
            if rpA is not None and rpB is not None:
                pairflg, isizeA = self._pair_geometry(
                    rpA, rpB, insert_min, insert_max, libcode)
                if (pairflg & REPPAIR.PROPER) and \
                        (pairflg & REPPAIR.WITHIN):
                    # a score-tied mate inside a unique proper pair is
                    # pinned by its partner: raise it to the pair
                    # marginal (resultpairs.c prob model)
                    self._pair_elevate(rpA, rpB, stats(ia)[2], ihist,
                                       isizeA)
                    self._pair_elevate(rpB, rpA, stats(ib)[2], ihist,
                                       isizeA)
            if rpA is None:
                rpA = RepAli()
            if rpB is None:
                rpB = RepAli()
            rpA.status |= REPMATEFLG.PAIRED
            rpB.status |= REPMATEFLG.PAIRED | REPMATEFLG.MATE2
            writer._write_one(rpA, readA, rpB, isizeA, pairflg)
            writer._write_one(rpB, readB, rpA, isizeA, pairflg)


# ------------------------------------------------------------------
# driver
# ------------------------------------------------------------------

_g = {}


def _tail_init(refset, penalties, minscor, writer_args, inserts=(0, 500),
               exact_engine=None, seed: int = 1, libcode=None, ihist=None):
    _g["tail"] = FastTail(refset, penalties, minscor)
    _g["writer_args"] = writer_args
    _g["inserts"] = inserts
    _g["exact_engine"] = exact_engine
    _g["seed"] = seed
    _g["libcode"] = libcode
    _g["pair_ihist"] = ihist
    _g.pop("exact_lane", None)


def _exact_fallback(name, seq, qual, serial) -> Optional[str]:
    """Remap one truncated-search read through the exact C lane.
    The drand48 stream is reseeded per read serial so output does not
    depend on worker count or batch size."""
    engine = _g.get("exact_engine")
    if engine is None:
        return None
    lane = _g.get("exact_lane")
    if lane is None:
        from .fastlane import FastLane
        soft, xmm = _g["writer_args"]
        lane = FastLane.make(engine, "sam", soft, xmm, False, False)
        _g["exact_lane"] = lane if lane is not None else False
    if not lane:
        return None
    from .. import rand
    rand.ranseed((_g.get("seed") or 1) + serial * 7919)
    return lane.render_raw_block([name], [seq], [qual])


def _exact_fallback_pair(nameA, seqA, qualA, nameB, seqB, qualB,
                         serial) -> Optional[str]:
    """Remap one truncated-search PAIR through the exact engine (the
    fast-mode analogue of the SE exact fallback).  Reseeded per pair
    serial so output is independent of worker count / batch size."""
    engine = _g.get("exact_engine")
    if engine is None:
        return None
    from .. import rand
    from ..report.report import Report
    from ..results.pairs import add_pair_to_report
    soft, xmm = _g["writer_args"]
    rand.ranseed((_g.get("seed") or 1) + serial * 7919)
    readA = Read(name=nameA.decode(), seq=codec.encode(seqA), qual=qualA)
    readB = Read(name=nameB.decode(), seq=codec.encode(seqB), qual=qualB)
    buf = io.StringIO()
    writer = ReportWriter(buf, _g["tail"].refset, fmt="sam",
                          soft_clip=soft, x_mismatch=xmm, header=False)
    rep = Report()
    rsr, rsm, rpairs, pairflg = engine.rmap_pair(readA, readB)
    add_pair_to_report(rep, _g.get("pair_ihist"), rpairs, pairflg,
                       engine.params.rsltouflg, rsr, rsm)
    writer.write(rep, readA, readB)
    return buf.getvalue()


def _tail_render(args):
    paired, item, outs, win_len, pad, q_padded, base_idx = args
    if isinstance(item, RawBatch):
        names, seqs, quals = item, None, None
    else:
        names, seqs, quals = item
    tail = _g["tail"]
    soft, xmm = _g["writer_args"]
    buf = io.StringIO()
    writer = ReportWriter(buf, tail.refset, fmt="sam", soft_clip=soft,
                          x_mismatch=xmm, header=False)
    if paired:
        imin, imax = _g["inserts"]
        fbp = (_exact_fallback_pair
               if _g.get("exact_engine") is not None else None)
        if not tail.render_pairs_native(names, seqs, quals, outs,
                                        win_len, pad, q_padded,
                                        imin, imax, soft, xmm, buf,
                                        libcode=_g.get("libcode"),
                                        ihist=_g.get("pair_ihist"),
                                        exact_fallback=fbp,
                                        base_idx=base_idx):
            if isinstance(names, RawBatch):
                names, seqs, quals = names.as_lists()
            tail.render_pairs(names, seqs, quals, outs, win_len, pad,
                              q_padded, imin, imax, writer,
                              libcode=_g.get("libcode"),
                              ihist=_g.get("pair_ihist"),
                              exact_fallback=fbp, raw_out=buf,
                              base_idx=base_idx)
    else:
        fb = _exact_fallback if _g.get("exact_engine") is not None else None
        if not tail.render_native(names, seqs, quals, outs, win_len, pad,
                                  q_padded, soft, xmm, buf,
                                  exact_fallback=fb, base_idx=base_idx):
            if isinstance(names, RawBatch):
                names, seqs, quals = names.as_lists()
            tail.render(names, seqs, quals, outs, win_len, pad, q_padded,
                        writer, exact_fallback=fb, raw_out=buf,
                        base_idx=base_idx)
    return buf.getvalue()


# ------------------------------------------------------------------
# the tail pool (the port's own)
# ------------------------------------------------------------------

# How tail workers start: a fresh interpreter each.  The reference forks
# them (fastmode.py:1351); a process forked after its parent made a CUDA
# context cannot use CUDA and may hang on locks the context's threads
# held, and the port's parent may have made one (chip_smoke.py, repeated
# runs through get_device_step's cache) before a pool starts.  A worker
# imports this module and the host layers only, not torch, whose import
# alone takes seconds (chip_smoke.py phase 5 prints both).
TAIL_START_METHOD = "spawn"


def engine_recipe(engine) -> tuple:
    """What a tail worker rebuilds an exact engine from, beside the saved
    index it loads, as the CLI's _build_engine made it (the engine itself
    does not cross processes: its index and scratch buffers cache raw
    addresses of their arrays): a copy of its params, its penalties and
    its identity filter."""
    from ..map.engine import MapEngine
    m = engine.matrix                  # m[0, 0] the match, m[0, 1] mismatch
    pen = (int(m[0, 0]), int(m[0, 1]), engine.gapopen, engine.gapext)
    return (MapEngine, copy.copy(engine.params), pen,
            engine.filter.min_identity)


def _tail_worker_init(index_name, engine_src, penalties, minscor,
                      writer_args, inserts, seed, libcode, ihist):
    """_tail_init in a tail worker, from picklable inputs: the reference
    (and for an exact engine the index) saved under `index_name`, and
    engine_src, None or an engine_recipe."""
    refset = RefSet.load(index_name)
    engine = None
    if engine_src is not None:
        cls, params, pen, min_identity = engine_src
        engine = cls(refset, KmerIndex.load(index_name), params,
                     penalties=pen)
        engine.filter.min_identity = min_identity
    _tail_init(refset, penalties, minscor, writer_args, inserts, engine,
               seed, libcode, ihist)


def tail_worker_facts():
    """What a tail worker reports of itself: (pid, start method, whether
    it had imported torch, whether torch has initialised CUDA in it (torch
    is imported here to ask), whether smalt_tpu or jax is loaded)."""
    had_torch = "torch" in sys.modules
    alien = any(m.split(".")[0] in ("smalt_tpu", "jax", "jaxlib")
                for m in sys.modules)
    import torch
    return (os.getpid(), mp.get_start_method(allow_none=True), had_torch,
            torch.cuda.is_initialized(), alien)


def _tail_render_chunk(args):
    """_tail_render on a tail worker: (the text, the worker's seconds
    rendering it), so that a batch line can say how long its chunks
    took on the workers."""
    t = time.perf_counter()
    text = _tail_render(args)
    return text, time.perf_counter() - t


def _tail_worker_loop(conn, initargs: tuple) -> None:
    """A tail worker: _tail_worker_init(*initargs), then (fn, args)
    requests from `conn`, answered in order with (fn(*args), None), or
    (None, the exception).  A thread of its own takes the requests off
    the pipe as they come, so the caller's sends never wait on a
    render; a closed pipe or None ends the worker."""
    import queue
    import threading
    inbox = queue.SimpleQueue()

    def pull():
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                msg = None
            inbox.put(msg)
            if msg is None:
                return
    threading.Thread(target=pull, daemon=True).start()
    failed = None
    try:
        _tail_worker_init(*initargs)
    except Exception as e:      # told to the caller at its first request
        failed = e
    while True:
        msg = inbox.get()
        if msg is None:
            return
        fn, args = msg
        try:
            if failed is not None:
                raise failed
            reply = (fn(*args), None)
        except Exception as e:
            reply = (None, e)
        try:
            conn.send(reply)
        except (EOFError, OSError):
            return


def _compact(item):
    """A RawBatch over its own records' bytes (a view: pickling sends
    only those), so that a batch crosses to a worker without the rest of
    the 8 MB read chunk its buffer belongs to.  Other items as they are."""
    if not isinstance(item, RawBatch) or item.n == 0:
        return item
    lo = int(min(item.name_off.min(), item.seq_off.min(),
                 item.qual_off.min()))
    hi = int(max((item.name_off + item.name_len).max(),
                 (item.qual_off + item.seq_len).max()))
    return RawBatch(item.buf[lo:hi], item.n, item.name_off - lo,
                    item.name_len, item.seq_off - lo, item.seq_len,
                    item.qual_off - lo)


def _chunk(args, a: int, b: int):
    """_tail_render's args for reads (pairs) [a, b) of a batch's args.
    Each read's (pair's) serial, base_idx + its place in the batch, and
    with it its drand48 stream stay as they were, and the window geometry
    and padded query length are the batch's, so the text is the batch's
    text of those records: a batch renders in chunks on several workers,
    byte for byte as in one call."""
    paired, item, outs, wl, wp, Q, base = args
    if paired:                 # mates A in rows [0, n), B in [n, 2n)
        n = len(item[0]) // 2
        item = tuple(x[a:b] + x[n + a:n + b] for x in item)
        outs = {k: np.concatenate([v[a:b], v[n + a:n + b]])
                for k, v in outs.items()}
    else:
        if isinstance(item, RawBatch):
            item = _compact(RawBatch(
                item.buf, b - a, item.name_off[a:b], item.name_len[a:b],
                item.seq_off[a:b], item.seq_len[a:b], item.qual_off[a:b]))
        else:
            item = tuple(x[a:b] for x in item)
        outs = {k: v[a:b] for k, v in outs.items()}
    return (paired, item, outs, wl, wp, Q, base + a)


class TailPool:
    """n worker processes rendering batches with _tail_render, each batch
    in chunks of at least CHUNK_MIN reads (pairs) dealt to the workers in
    turn, the texts taken back in input order.  initargs are
    _tail_worker_init's.  The workers start when the pool is made (their
    start overlaps the caller's set-up); at most 2n chunks wait in the
    pool, so the device loop, which runs on the caller's thread, stays a
    bounded distance ahead of the tails.

    The caller's thread sends each chunk down its worker's pipe and
    takes each text off it itself: the pool starts no thread in the
    caller's process.  A helper thread there (concurrent.futures' pool
    runs two, to move every chunk and text) takes the GIL from the
    device loop between the ~500 torch calls of each step: on an H100
    host the step's enqueue then took 1.7 to 2 times its time without
    the pool, by a share that differed from run to run.  A worker that
    fails or dies fails the run (its exception, or a RuntimeError), it
    does not hang it.  ready_s (pool made to first text back) and wait_s
    (the caller's time blocked on texts) say where a run's time went;
    wrender is the workers' seconds on the chunk taken last."""

    CHUNK_MIN = 128

    def __init__(self, n: int, initargs: tuple):
        self.n = n
        self.ctx = mp.get_context(TAIL_START_METHOD)
        self.conns, self.procs = [], []
        for _ in range(n):
            mine, theirs = self.ctx.Pipe()
            p = self.ctx.Process(target=_tail_worker_loop,
                                 args=(theirs, initargs), daemon=True)
            p.start()
            theirs.close()       # so that a dead worker's pipe ends
            self.conns.append(mine)
            self.procs.append(p)
        self.t0 = time.perf_counter()
        self.ready_s = self.wait_s = self.wrender = 0.0
        self.chunks = 0
        self.turn = 0            # the worker the next chunk goes to

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for c in self.conns:
            if exc[0] is None:
                try:
                    c.send(None)
                except OSError:
                    pass
            c.close()
        for p in self.procs:
            if exc[0] is not None:
                p.terminate()
            p.join()

    def _send(self, w: int, fn, args) -> None:
        try:
            self.conns[w].send((fn, args))
        except OSError:
            self._died(w)

    def _recv(self, w: int):
        try:
            out, err = self.conns[w].recv()
        except (EOFError, OSError):
            self._died(w)
        if err is not None:
            raise err
        return out

    def _died(self, w: int):
        p = self.procs[w]
        p.join(1)
        raise RuntimeError(f"tail worker {p.pid} died (exit code "
                           f"{p.exitcode})")

    def facts(self):
        """tail_worker_facts of each worker."""
        for w in range(self.n):
            self._send(w, tail_worker_facts, ())
        return [self._recv(w) for w in range(self.n)]

    def _take(self, w: int) -> str:
        """The text of worker w's oldest chunk."""
        t = time.perf_counter()
        text, self.wrender = self._recv(w)
        self.wait_s += time.perf_counter() - t
        if not self.ready_s:
            self.ready_s = time.perf_counter() - self.t0
        return text

    def render(self, batches, write, spans: "FastSpans") -> None:
        """write(key, _tail_render(args)) for every (key, args) of
        `batches`, in order, the rendering on the workers: one write a
        batch, its chunks' texts joined; each batch's sends, waits,
        chunks and the workers' seconds go to its record in `spans`."""
        pending = deque()    # (key, whether the batch's last chunk, worker)
        done = []            # the texts of the batch being written
        for key, args in batches:
            rec = spans.rec(key)
            n = len(args[1][0]) // 2 if args[0] else _nreads(args[1])
            step = max(self.CHUNK_MIN, -(-n // self.n))
            for a in range(0, n, step):
                w, self.turn = self.turn, (self.turn + 1) % self.n
                with spans.span(rec, "submit"):
                    self._send(w, _tail_render_chunk,
                               (_chunk(args, a, min(n, a + step)),))
                pending.append((key, a + step >= n, w))
                spans.count(rec, "chunks", 1)
                self.chunks += 1
                if len(pending) >= 2 * self.n:
                    self._land(pending.popleft(), done, write, spans)
        while pending:
            self._land(pending.popleft(), done, write, spans)

    def _land(self, item, done: list, write, spans) -> None:
        key, last, w = item
        rec = spans.rec(key)
        with spans.span(rec, "pool_wait"):
            done.append(self._take(w))
        spans.count(rec, "wrender", self.wrender)
        if last:
            write(key, "".join(done))
            done.clear()


class FastSpans:
    """The per-batch account of run_fast_pipeline's loop (SMALT_TIMING):
    each batch a record of its spans (seconds on perf_counter, each put
    to the batch it works on) and counters, printed as one `# fx-batch`
    line when the batch is written: `n` (reads; mates for pairs), `rows`
    (the padded rows), `period` (seconds since the previous write), the
    spans, the counters.  A span is the exact lane's helper
    (fastlane._Span: a record_function `fx.<span>` around it while a
    torch profiler records).  Off, it keeps no record, times nothing,
    makes no torch call and prints nothing."""

    # the main thread's spans, in the line's order; `main` is all of
    # them but `write`.  With a tail pool the tail is `submit` and
    # `pool_wait`, and the counters `chunks` and `wrender` (the workers'
    # seconds on the batch's chunks); without one, `render`.
    STEP = ("read", "encode", "enqueue", "sync", "split")

    def __init__(self, on: bool, pool: bool = False):
        self.on = on
        tail = ("submit", "pool_wait") if pool else ("render",)
        self.blank = dict.fromkeys(self.STEP + tail + ("write",), 0.0)
        if pool:
            self.blank.update(chunks=0, wrender=0.0)
        self.recs: dict = {}
        if on:
            from .fastlane import _Span
            self.span_of = _Span
        self.t_write = time.perf_counter()

    def fresh(self) -> Optional[dict]:
        """A record for the batch about to be read (None when off)."""
        return dict(self.blank) if self.on else None

    def bind(self, key, rec: Optional[dict], n: int, rows: int) -> None:
        """rec, once read and encoded, is batch `key`'s."""
        if rec is not None:
            rec.update(n=n, rows=rows)
            self.recs[key] = rec

    def rec(self, key) -> Optional[dict]:
        return self.recs.get(key)

    def span(self, rec: Optional[dict], name: str):
        """`with spans.span(rec, name):` adds the block's seconds to
        rec[name]."""
        if rec is None:
            return _NO_SPAN
        return self.span_of(rec, name, "fx")

    def count(self, rec: Optional[dict], name: str, v) -> None:
        if rec is not None:
            rec[name] += v

    def written(self, key) -> None:
        """Batch `key` is written: its line."""
        rec = self.recs.pop(key, None)
        if rec is None:
            return
        now = time.perf_counter()
        period, self.t_write = now - self.t_write, now
        n, rows = rec.pop("n"), rec.pop("rows")
        fields = " ".join(f"{k}={v:.6f}" if isinstance(v, float) else
                          f"{k}={v}" for k, v in rec.items())
        sys.stderr.write(f"# fx-batch n={n} rows={rows} "
                         f"period={period:.6f} {fields}\n")
        sys.stderr.flush()


_NO_SPAN = contextlib.nullcontext()


# ------------------------------------------------------------------
# the device pass (the port's own)
# ------------------------------------------------------------------

PREFETCH = 4   # batches in flight on the device


class _InFlight:
    """One batch's packed step output on its way to the host.  The step
    takes the reads on the host (pinned on a card) and returns its packed
    [12, B] tensor, or a mesh step's list of dp row parts; each part is
    copied into pinned host memory behind an event recorded on its own
    device's stream (an event of one card does not order another's)."""

    def __init__(self, step, arr: np.ndarray, device):
        import torch
        reads = torch.from_numpy(arr)
        if device.type == "cuda":
            reads = reads.pin_memory()
        out = step(reads)
        self.parts = out if isinstance(out, list) else [out]
        self.events = []
        if device.type == "cuda":
            host = []
            for p in self.parts:
                h = torch.empty(p.shape, dtype=p.dtype, pin_memory=True)
                h.copy_(p, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(p.device))
                host.append(h)
                self.events.append(ev)
            self.parts = host

    def result(self) -> np.ndarray:
        for ev in self.events:
            ev.synchronize()
        return np.concatenate([p.numpy() for p in self.parts], axis=1)


def _nreads(item) -> int:
    """Read count of a batch item: a RawBatch or a (names, seqs, quals)
    list triple (whose len() is 3)."""
    return item.n if isinstance(item, RawBatch) else len(item[0])


_step_cache: dict = {}   # id(index) -> {key: step}


def _index_cache(idx: KmerIndex) -> dict:
    """The steps built for `idx`, kept for its life beside it, not on
    it, so that an index (or an exact engine holding it) pickles to a
    tail worker without them."""
    cache = _step_cache.get(id(idx))
    if cache is None:
        cache = _step_cache[id(idx)] = {}
        weakref.finalize(idx, _step_cache.pop, id(idx), None)
    return cache


def get_device_step(refset: RefSet, idx: KmerIndex, device, penalties):
    """The packed mapping step for (device, penalties), cached for the
    life of `idx`: repeated runs in one process upload the index once."""
    from ..parallel.mesh import DeviceIndex, make_device_step
    cache = _index_cache(idx)
    key = (str(device), tuple(penalties))
    step = cache.get(key)
    if step is None:
        m, go, ge = ali_mod.make_score_matrix(*penalties)
        di = DeviceIndex.build(refset, idx, device)
        step = cache[key] = make_device_step(di, m, -go, -ge, pack=True)
    return step


def mesh_shape(mesh_spec: Optional[str], device_type: str,
               n_visible: int) -> Tuple[int, int]:
    """(dp, ip) of a run: the "DP,IP" spec if given; else, on GPUs, all
    `n_visible` cards of this host as pure dp when there are more than
    one; else 1 x 1.  A spec needing more GPUs than are visible raises;
    on the CPU any shape runs, every member on the CPU."""
    if mesh_spec:
        try:
            dp, ip = (int(x) for x in mesh_spec.split(","))
        except ValueError:
            raise ValueError(f"--mesh takes DP,IP (two integers), got "
                             f"{mesh_spec!r}") from None
        if dp < 1 or ip < 1:
            raise ValueError(f"--mesh {mesh_spec}: DP and IP must be >= 1")
        if device_type == "cuda" and dp * ip > n_visible:
            raise ValueError(f"--mesh {dp},{ip} needs {dp * ip} GPUs; "
                             f"{n_visible} visible")
        return dp, ip
    if device_type == "cuda" and n_visible > 1:
        return n_visible, 1
    return 1, 1


def get_mesh_step(refset: RefSet, idx: KmerIndex, mesh, penalties,
                  Q: int):
    """The packed step over `mesh` (an spmd.Mesh) for reads padded to Q,
    cached for the life of `idx` on the mesh's devices and penalties:
    the replicated-index step for ip = 1, else the index-sharded step
    over a ShardedDeviceIndex whose halo covers Q's windows (at least
    DEFAULT_HALO), which the cache key also holds."""
    from ..parallel.mesh import (DeviceIndex, ShardedDeviceIndex,
                                 make_index_sharded_step, make_sharded_step,
                                 window_len)
    halo = 0
    if mesh.ip > 1:
        halo = max(ShardedDeviceIndex.DEFAULT_HALO, window_len(Q))
    cache = _index_cache(idx)
    key = ("mesh", mesh.key(), tuple(penalties), halo)
    step = cache.get(key)
    if step is None:
        m, go, ge = ali_mod.make_score_matrix(*penalties)
        if mesh.ip > 1:
            sdi = ShardedDeviceIndex.build(refset, idx, mesh.ip, halo=halo)
            step = make_index_sharded_step(sdi, mesh, m, -go, -ge, pack=True)
        else:
            # built on the host; every member takes a copy of its own
            di = DeviceIndex.build(refset, idx, "cpu")
            step = make_sharded_step(di, mesh, m, -go, -ge, pack=True)
        cache[key] = step
    return step


def resolve_mesh(mesh_spec, device):
    """The spmd.Mesh of a run on `device` (torch.device), or None for
    one device: `mesh_spec` as it is when it is a Mesh already, else
    mesh_shape's (dp, ip) over cuda:0.. (this host's cards) or the CPU."""
    import torch
    from ..parallel.spmd import Mesh
    if isinstance(mesh_spec, Mesh):
        return mesh_spec
    cuda = device.type == "cuda"
    dp, ip = mesh_shape(mesh_spec, device.type,
                        torch.cuda.device_count() if cuda else 0)
    if dp * ip == 1:
        return None
    devs = [torch.device("cuda", i) if cuda else device
            for i in range(dp * ip)]
    return Mesh(dp, ip, devs)


def run_fast_pipeline(refset: RefSet, idx: KmerIndex, reads_path: str,
                      out, penalties=(1, -2, -4, -3), minscor: int = 18,
                      nthreads: int = 1, batch: int = 4096,
                      device="cuda", mates_path: Optional[str] = None,
                      insert_min: int = 0, insert_max: int = 500,
                      exact_engine=None, seed: int = 1,
                      mesh_spec=None,
                      libcode=None, ihist=None,
                      host_id: int = 0, n_hosts: int = 1,
                      shard_writer=None, resume_log=None,
                      index_name: Optional[str] = None) -> None:
    """Map reads with the device pass + host traceback tail, writing
    headerless SAM records to `out` in input order.  With `mates_path`,
    pairs map together: both mates go through the device pass in one
    batch and the pair tail rescues, pairs and flags them.  With
    `exact_engine`, reads (or pairs) whose seed search the device pass
    truncated are remapped through the exact host lane
    (--fallback-exact).

    mesh_spec: "DP,IP" (mesh_shape; or an spmd.Mesh, an explicit device
    grid) runs the step over a device mesh; the output is the
    single-device run's for any shape (reads padded past LONG_READ_Q
    aside when IP > 1: that step scores them full-matrix, as smalt_tpu's
    does).  host_id / n_hosts / shard_writer: a multi-host run maps the
    batches b with b % n_hosts == host_id and writes them through the
    shard writer (no resume then).

    nthreads > 1 renders on a TailPool of that many processes, which
    load the reference and index saved under `index_name` (required
    then: `refset` and `idx` must be what it holds) and rebuild the
    exact engine from its engine_recipe.  resume_log (a ResumeLog;
    nthreads = 1 only, as in the reference) skips the batches a
    checkpoint recorded and ticks after each batch written."""
    import torch
    from ..parallel.mesh import OUT_KEYS, window_len, window_pad
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but no GPU is visible")
    mesh = resolve_mesh(mesh_spec, device)
    dp = mesh.dp if mesh is not None else 1
    writer_args = (True, False)   # soft_clip, x_mismatch
    inserts = (insert_min, insert_max)
    if shard_writer is not None:
        resume_log = None
    pool = None
    if nthreads > 1:
        if not index_name:
            raise ValueError("nthreads > 1 needs index_name, the name the "
                             "reference and index are saved under: the "
                             "tail workers load them from it")
        # started first: the workers load their tail while the index
        # goes up to the device
        pool = TailPool(nthreads, (
            index_name,
            None if exact_engine is None else engine_recipe(exact_engine),
            penalties, minscor, writer_args, inserts, seed, libcode, ihist))
        resume_log = None
    skip_reads = 0
    if resume_log is not None:
        st = resume_log.load()
        if st:
            skip_reads = st["reads_done"]

    def step_for(Q: int):
        if mesh is None:
            return get_device_step(refset, idx, device, penalties)
        return get_mesh_step(refset, idx, mesh, penalties, Q)

    try:
        if mesh is None:     # the index goes up while the workers start
            step_for(0)
    except BaseException:
        if pool is not None:
            pool.__exit__(*sys.exc_info())
        raise
    paired = mates_path is not None

    def raw_batches():
        if not paired:
            yield from iter_fastq_hybrid(reads_path, batch)
            return
        it2 = iter_fastq_batches(mates_path, batch)
        for n1, s1, q1 in iter_fastq_batches(reads_path, batch):
            n2, s2, q2 = next(it2)
            if len(n2) != len(n1):
                raise ValueError("mate files differ in read count")
            yield n1 + n2, s1 + s2, q1 + q2

    def force(work):
        bno, item, pend, wl, wp, Q, base = work
        rec = spans.rec(bno)
        with spans.span(rec, "sync"):
            arr = pend.result()
        with spans.span(rec, "split"):
            outs = {k: arr[i, : _nreads(item)]
                    for i, k in enumerate(OUT_KEYS)}
        return bno, (paired, item, outs, wl, wp, Q, base)

    def batches():
        """(global batch number, render args) of the batches this host
        maps, in order; read serials (`base`) stay global."""
        pending = deque()
        base = 0
        want = batch * (2 if paired else 1)   # PE: both mates
        items = enumerate(raw_batches())
        while True:
            rec = spans.fresh()     # the time to read a skipped batch too
            with spans.span(rec, "read"):
                bno, item = next(items, (None, None))
            while item is not None and (
                    (n_hosts > 1 and bno % n_hosts != host_id) or
                    base + _nreads(item) <= skip_reads):
                # another host's stripe, or checkpointed: already written
                base += _nreads(item)
                with spans.span(rec, "read"):
                    bno, item = next(items, (None, None))
            if item is None:
                break
            if isinstance(item, RawBatch):
                qmax = int(item.seq_len.max()) if item.n else 0
            else:
                qmax = max((len(s) for s in item[1]), default=0)
            # round Q to a small multiple, NOT to 128: the window formula
            # would jump S to the next 128 multiple and double the SW cost
            Q = max(32, -(-qmax // 16) * 16)
            with spans.span(rec, "encode"):
                if isinstance(item, RawBatch):
                    arr = item.encode(Q)
                else:
                    arr = encode_batch(item[1], Q)
                # keep ONE batch shape for the whole run, a multiple of
                # dp; pad rows are all-7 (no seeds -> score 0), force()
                # drops them
                rows = max(want, arr.shape[0])
                rows += -rows % dp
                if arr.shape[0] < rows:
                    arr = np.pad(arr, ((0, rows - arr.shape[0]), (0, 0)),
                                 constant_values=7)
            spans.bind(bno, rec, _nreads(item), rows)
            with spans.span(rec, "enqueue"):
                pend = _InFlight(step_for(Q), arr, device)
            pending.append((bno, item, pend, window_len(Q), window_pad(Q),
                            Q, base))
            base += _nreads(item)
            if len(pending) >= PREFETCH:
                yield force(pending.popleft())
        while pending:
            yield force(pending.popleft())

    def emit(bno, text):
        with spans.span(spans.rec(bno), "write"):
            if shard_writer is not None:
                shard_writer.write_batch(bno, text)
            else:
                out.write(text)
        spans.written(bno)

    timing = os.environ.get("SMALT_TIMING")
    t_start = time.time()
    n_done = n_batches = 0
    if pool is None:
        _tail_init(refset, penalties, minscor, writer_args, inserts,
                   exact_engine, seed, libcode, ihist)
    # after the tail's set-up, which no batch's period holds
    spans = FastSpans(bool(timing), pool is not None)

    def counted():
        nonlocal n_done, n_batches
        for bno, args in batches():
            n_done += _nreads(args[1])
            n_batches += 1
            yield bno, args

    if pool is not None:
        with pool:
            pool.render(counted(), emit, spans)
        if timing:
            print(f"# SMALT_TIMING tail pool: {nthreads} workers "
                  f"({TAIL_START_METHOD}), {pool.chunks} chunks, first text "
                  f"{pool.ready_s:.2f} s after the pool started, the device "
                  f"loop blocked on texts {pool.wait_s:.2f} s",
                  file=sys.stderr)
    else:
        for bno, args in counted():
            with spans.span(spans.rec(bno), "render"):
                text = _tail_render(args)
            emit(bno, text)
            if resume_log is not None:
                out.flush()
                resume_log.tick(args[6] + _nreads(args[1]), out.tell(), 0)
        if resume_log is not None:
            resume_log.done()
    if timing:
        dt = max(time.time() - t_start, 1e-9)
        print(f"# SMALT_TIMING fast pipeline: {n_done} reads in "
              f"{n_batches} batches, {dt:.2f} s "
              f"({n_done / dt:.0f} reads/s)", file=sys.stderr)
