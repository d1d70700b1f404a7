"""`map --device-exact` on one torch device (single-end FASTQ).

Counterpart of smalt_tpu.map.fastlane.DeviceExact (fastlane.py:796), and
a subclass of it: the host halves are the reference's own, unchanged —
the C pre block (hit info, rank masks, hit-key expansion), the C post
block (checksums, depth sort, pass-2 state), the pass-2 window prep and
fl_pass2_block (pass 1 replay, pass 2, report, SAM).  This class
replaces the methods that touch jax: the collate step
(parallel/exact_collate.py), the pass-2 step (parallel/exact_pass2.py)
and the batch loop that feeds them.

Output is the SAM of the host C lane, byte for byte, by the reference's
protocol: a read the device cannot serve exactly is re-staged on the
host (`n_restaged`), a pass-2 candidate whose walk record the host
decoder doubts is redone by the host DP (`p2_fb`), and a batch the lane
does not take at all (reads over QMAX, missing qualities, a C block that
refuses) is rendered by the host lane (`host_batches`).  A device,
build or launch error raises: nothing turns it into host output.

Per batch: host pre -> upload the padded reads once -> collate step on a
worker thread -> host post -> (SMALT_DX_P2=1) pass-2 step on the worker
-> fl_pass2_block, pipelined one batch deep as in the reference.  Only
the host-hits regime is ported (every seq-by-seq reference with
nskip <= wordlen); the device hit expansion raises NotImplementedError.
"""
from __future__ import annotations

import os
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from smalt_tpu.map import fastlane as ref_fastlane
from smalt_tpu.map.fastmode import iter_fastq_batches

from ..parallel.exact_collate import CollateCfg, build_exact_collate
from ..parallel.exact_pass2 import build_pass2_step, unpack_pass2
from ..parallel.mesh import DeviceIndex


class DeviceExact(ref_fastlane.DeviceExact):
    """The device-exact lane with its device steps on `device`."""

    def __init__(self, lane, batch: int = 0, device="cuda"):
        super().__init__(lane, batch=batch)
        self.device = torch.device(device)
        self.n_restaged = 0
        self.host_batches = 0

    @classmethod
    def make(cls, engine, fmt, soft_clip, x_mismatch, ali_out, fix_primary,
             batch: int = 0, device="cuda"):
        """The lane for `engine`, or None where the reference's make
        refuses (the same gates: its lane then runs the host)."""
        ref = ref_fastlane.DeviceExact.make(engine, fmt, soft_clip,
                                            x_mismatch, ali_out, fix_primary,
                                            batch=batch)
        if ref is None:
            return None
        return cls(ref.lane, batch=batch, device=device)

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
        cache = idx.__dict__.setdefault("_torch_dx_cache", {})
        dkey = ("ref_only", str(self.device))
        if dkey not in cache:
            cache[dkey] = DeviceIndex.build_ref_only(eng.refset, idx,
                                                     self.device)
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
        matrix = np.asarray(eng.matrix, np.int32)
        key = (cfg, matrix.tobytes(), eng.gapopen, eng.gapext,
               str(self.device))
        if key not in cache:
            cache[key] = build_exact_collate(self._di, eng._seq_ivals,
                                             matrix, -eng.gapopen,
                                             -eng.gapext, cfg)
        self._collate = cache[key]
        self._cfg = cfg
        return self._collate

    def _pass2_step(self):
        if self._p2_fn is None:
            eng = self.lane.engine
            self._p2_fn = build_pass2_step(np.asarray(eng.matrix, np.int32),
                                           -eng.gapopen, -eng.gapext,
                                           self.device)
        return self._p2_fn

    def _p2_args(self, win):
        """The pass-2 step's window descriptors for the prep windows
        `win` (fastlane.py:1087-1112), padded to the sticky window cap:
        (wd [wcap, 12] int32 tensor on the device, valid [nw] uint8,
        Sp, nw)."""
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
        return torch.from_numpy(wd).to(self.device), valid, Sp, nw

    def _dispatch_pass2(self, win, codes_pad, qlens):
        """One pass-2 step over the prep windows; codes_pad and qlens
        are the batch's tensors already on the device.  Returns (best64,
        mi64, mj64, rec16, valid, Sp, nw) on the host."""
        wd, valid, Sp, nw = self._p2_args(win)
        # the collate step's resident reference codes (refcodes & 7, the
        # array the reference uploads a second time for pass 2)
        flat = self._pass2_step()(self._di.ref_alpha, codes_pad, qlens, wd,
                                  Sp)
        best64, mi64, mj64, rec16 = unpack_pass2(flat.cpu().numpy(), nw, Sp)
        if os.environ.get("SMALT_DX_DEBUG"):
            v = valid[:nw] != 0
            print(f"# p2-dispatch nw={nw} valid={int(v.sum())} "
                  f"best>0={int((best64[v] > 0).sum())} "
                  f"best_mean={float(best64[v].mean()) if v.any() else 0:.1f}",
                  file=sys.stderr, flush=True)
        return best64, mi64, mj64, rec16, valid, Sp, nw

    # ---------------- one batch ----------------

    def _prepare(self, names, seqs, quals):
        """Host pre block and the collate step's inputs, on the device,
        for one batch (fastlane.py:1174-1255).  Returns None when the
        lane does not take the batch (the caller renders it on the
        host), else (host state, collate arguments)."""
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
        self._collate_fn()                  # cfg (H) first; raises if unported
        st = self._pre(n, codes, read_offs, qarr, has_qual, Qcap,
                       hits_B=B, hits_H=self._cfg.H)
        if st is None:
            return None
        pre, _, k1, k2, tot, ks = st
        codes_pad = np.zeros((B, Qcap), np.uint8)
        enc = np.frombuffer(ref_fastlane.codec_encode_bulk(codes), np.uint8)
        for i in range(n):
            o, e = int(read_offs[i]), int(read_offs[i + 1])
            codes_pad[i, : e - o] = enc[o:e]
        qlens = np.zeros(B, np.int32)
        qlens[:n] = qlens_n
        mincov = np.zeros(B, np.int32)
        mincov[:n] = pre[:, 5].astype(np.int32)
        # lanes the host expansion could not fit re-stage on the host
        host_fb = (tot[:n] < 0).any(axis=1)
        np.maximum(tot, 0, out=tot)
        R, H = 2 * B, self._cfg.H
        dev = self.device
        # the padded batch goes up ONCE: the collate and the pass-2 step
        # both read it
        codes_t, qlens_t = (torch.from_numpy(x).to(dev)
                            for x in (codes_pad, qlens))
        dargs = tuple(torch.from_numpy(x).to(dev) for x in (
            k1.reshape(R, H), k2.reshape(R, H), tot.reshape(R))) + \
            (codes_t, qlens_t, torch.from_numpy(mincov).to(dev))
        if ks is not None:
            dargs = (torch.from_numpy(ks.reshape(R, H)).to(dev),) + dargs
        host = (n, qmax, codes, read_offs, qarr, has_qual, narr, name_offs,
                pre, host_fb, codes_t, qlens_t)
        return host, dargs

    def _collate_outputs(self, dargs):
        """The collate step on the device, its outputs on the host."""
        return [x.cpu().numpy() for x in self._collate_fn()(*dargs)]

    def _post_batch(self, host, outs):
        """Host post block on the collate outputs (fastlane.py:1257-1297).
        Returns None when the C block refuses the batch, else (the
        batch's state for pass 2, whose last field is the pass-2 window
        prep or None, and the number of reads re-staged on the host)."""
        (n, qmax, codes, read_offs, qarr, has_qual, narr, name_offs, pre,
         host_fb, _, _) = host
        pool, counts2, scores, fb = outs
        cksum = np.ascontiguousarray(pre[:, 6:10].reshape(n, 2, 2), np.int32)
        fb = fb.copy()
        fb[:n] |= host_fb
        st = self._post(n, read_offs, pre, pool, counts2[:n], scores,
                        cksum[:n], fb[:n])
        if st is None:
            return None
        state, state_offs, nrest = st
        self.n_restaged += nrest
        scores64 = np.ascontiguousarray(scores, np.int64)
        prep = None
        if self._p2_on:
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

    def run_raw_fastq(self, path: str, out, fallback) -> None:
        """Map a strict FASTQ file, writing SAM records to `out` in input
        order.  fallback(names, seqs, quals) renders a batch on the host
        (a batch the lane does not take; counted in host_batches)."""
        timing = bool(os.environ.get("SMALT_DP1_TIMING"))
        pool_exec = ThreadPoolExecutor(max_workers=1)
        self.n_restaged = 0

        def log(msg):
            if timing:
                print(msg, file=sys.stderr, flush=True)

        def device_leg(dargs):
            t0 = time.time()
            outs = self._collate_outputs(dargs)
            log(f"# dx-dev {time.time() - t0:.3f}s")
            return outs

        def host_render(raw):
            self.host_batches += 1
            return fallback(*raw)

        # a batch the lane does not take goes through the queues as None
        # and is rendered by fin(), so the SAM and the host RNG stream
        # keep the input order
        def prepare(raw):
            t0 = time.time()
            got = self._prepare(*raw)
            if got is None:
                return None
            host, dargs = got
            log(f"# dx-prep {time.time() - t0:.3f}s")
            return host, pool_exec.submit(device_leg, dargs)

        def mid(item, raw):
            if item is None:
                return None
            host, fut = item
            outs = fut.result()
            t0 = time.time()
            got = self._post_batch(host, outs)
            if got is None:
                return None
            item2, nrest = got
            prep = item2[-1]
            fut2 = None
            if prep is not None and len(prep[2]):
                fut2 = pool_exec.submit(self._dispatch_pass2, prep[2],
                                        host[10], host[11])
            log(f"# dx-post {time.time() - t0:.3f}s restaged={nrest}")
            return item2, fut2

        def fin(item, raw):
            if item is None:
                return host_render(raw)
            item2, fut2 = item
            p2out = None if fut2 is None else fut2.result()
            t1 = time.time()
            text = self._finish(item2, p2out)
            log(f"# dx-pass2 {time.time() - t1:.3f}s n={item2[0]} "
                f"p2_used={self.p2_used} p2_fb={self.p2_fb} "
                f"p2_hit={self.p2_hit}")
            return host_render(raw) if text is None else text

        t_run = time.time()
        midq, finq = deque(), deque()
        try:
            for raw in iter_fastq_batches(path, self.batch):
                midq.append((prepare(raw), raw))
                while len(midq) > 1:
                    it, rw = midq.popleft()
                    finq.append((mid(it, rw), rw))
                while len(finq) > 1:
                    it, rw = finq.popleft()
                    out.write(fin(it, rw))
            while midq:
                it, rw = midq.popleft()
                finq.append((mid(it, rw), rw))
            while finq:
                it, rw = finq.popleft()
                out.write(fin(it, rw))
        finally:
            pool_exec.shutdown(wait=True)
        log(f"# dx-total {time.time() - t_run:.3f}s "
            f"n_restaged={self.n_restaged} p2_used={self.p2_used} "
            f"p2_fb={self.p2_fb} p2_hit={self.p2_hit} "
            f"host_batches={self.host_batches}")
