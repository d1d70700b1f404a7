"""`map --fast` on one torch device: device pass + host traceback tail.

Counterpart of the single-device pipeline in smalt_tpu/map/fastmode.py
(`run_fast_pipeline`, fastmode.py:1137), single-end and paired.  The
host layers are the reference's own and are imported, not copied: the
FASTQ readers (`iter_fastq_hybrid`, `iter_fastq_batches`), the batch
encoders, and the traceback + SAM tail (`_tail_init` / `_tail_render`,
FastTail, with its native C renderers for single reads and for pairs).
The device step is the port's (parallel/mesh.py).  Paired runs put both
mates of a batch through one step of 2 x batch reads.

Per batch: encode to uint8 [B, Q] on the host, copy to the device, run
the step on the current stream, and start a non-blocking copy of the
packed [12, B] result into pinned host memory behind a CUDA event.  Up
to PREFETCH batches are in flight; the tail waits on a batch's event
only when it renders that batch.  On the CPU the same code runs
synchronously (the tests' path).
"""
from __future__ import annotations

import os
import sys
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from smalt_tpu.align import core as ali_mod
from smalt_tpu.index.table import KmerIndex
from smalt_tpu.map.fastmode import (RawBatch, _tail_init, _tail_render,
                                    encode_batch, iter_fastq_batches,
                                    iter_fastq_hybrid)
from smalt_tpu.seq.refset import RefSet

from ..parallel.mesh import (OUT_KEYS, DeviceIndex, make_device_step,
                             window_len, window_pad)

PREFETCH = 4   # batches in flight on the device


class _InFlight:
    """One batch's packed step output on its way to the host."""

    def __init__(self, step, arr: np.ndarray, device: torch.device):
        reads = torch.from_numpy(arr)
        if device.type == "cuda":
            reads = reads.pin_memory().to(device, non_blocking=True)
        packed = step(reads)
        self.event = None
        if device.type == "cuda":
            self.host = torch.empty(packed.shape, dtype=packed.dtype,
                                    pin_memory=True)
            self.host.copy_(packed, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = packed

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def _nreads(item) -> int:
    """Read count of a batch item: a RawBatch or a (names, seqs, quals)
    list triple (whose len() is 3)."""
    return item.n if isinstance(item, RawBatch) else len(item[0])


def get_device_step(refset: RefSet, idx: KmerIndex, device, penalties):
    """The packed mapping step for (device, penalties), cached on `idx`:
    repeated runs in one process upload the index once."""
    cache = idx.__dict__.setdefault("_torch_step_cache", {})
    key = (str(device), tuple(penalties))
    step = cache.get(key)
    if step is None:
        m, go, ge = ali_mod.make_score_matrix(*penalties)
        di = DeviceIndex.build(refset, idx, device)
        step = cache[key] = make_device_step(di, m, -go, -ge, pack=True)
    return step


def run_fast_pipeline(refset: RefSet, idx: KmerIndex, reads_path: str,
                      out, penalties=(1, -2, -4, -3), minscor: int = 18,
                      nthreads: int = 1, batch: int = 4096,
                      device="cuda", mates_path: Optional[str] = None,
                      insert_min: int = 0, insert_max: int = 500,
                      exact_engine=None, seed: int = 1,
                      mesh_spec: Optional[str] = None,
                      libcode=None, ihist=None,
                      host_id: int = 0, n_hosts: int = 1,
                      shard_writer=None, resume_log=None) -> None:
    """Map reads with the device pass + host traceback tail, writing
    headerless SAM records to `out` in input order.  With `mates_path`,
    pairs map together: both mates go through the device pass in one
    batch and the pair tail rescues, pairs and flags them.  With
    `exact_engine`, reads (or pairs) whose seed search the device pass
    truncated are remapped through the exact host lane
    (--fallback-exact)."""
    unported = [
        (mesh_spec is not None or n_hosts > 1 or shard_writer is not None,
         "a device mesh or several hosts", "Queue 1 #8"),
        (nthreads > 1, "a forked tail pool (nthreads > 1)", "Queue 1 #11"),
        (resume_log is not None, "--resume", "Queue 1 #13"),
    ]
    for bad, what, item in unported:
        if bad:
            raise NotImplementedError(
                f"{what} in the torch fast path is not ported yet "
                f"(ROADMAP.md {item})")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but no GPU is visible")
    step = get_device_step(refset, idx, device, penalties)
    writer_args = (True, False)   # soft_clip, x_mismatch
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
        item, pend, wl, wp, Q, base = work
        arr = pend.result()
        outs = {k: arr[i, : _nreads(item)] for i, k in enumerate(OUT_KEYS)}
        return (paired, item, outs, wl, wp, Q, base)

    def batches():
        pending = deque()
        base = 0
        want = batch * (2 if paired else 1)   # PE: both mates
        for item in raw_batches():
            if isinstance(item, RawBatch):
                qmax = int(item.seq_len.max()) if item.n else 0
            else:
                qmax = max((len(s) for s in item[1]), default=0)
            # round Q to a small multiple, NOT to 128: the window formula
            # would jump S to the next 128 multiple and double the SW cost
            Q = max(32, -(-qmax // 16) * 16)
            if isinstance(item, RawBatch):
                arr = item.encode(Q)
            else:
                arr = encode_batch(item[1], Q)
            if arr.shape[0] < want:
                # keep ONE batch shape for the whole run; pad rows are
                # all-7 (no seeds -> score 0) and force() drops them
                arr = np.pad(arr, ((0, want - arr.shape[0]), (0, 0)),
                             constant_values=7)
            pending.append((item, _InFlight(step, arr, device),
                            window_len(Q), window_pad(Q), Q, base))
            base += _nreads(item)
            if len(pending) >= PREFETCH:
                yield force(pending.popleft())
        while pending:
            yield force(pending.popleft())

    timing = os.environ.get("SMALT_TIMING")
    t_start = time.time()
    n_done = n_batches = 0
    _tail_init(refset, penalties, minscor, writer_args,
               (insert_min, insert_max), exact_engine, seed, libcode, ihist)
    for args in batches():
        out.write(_tail_render(args))
        n_done += _nreads(args[1])
        n_batches += 1
    if timing:
        dt = max(time.time() - t_start, 1e-9)
        print(f"# SMALT_TIMING fast pipeline: {n_done} reads in "
              f"{n_batches} batches, {dt:.2f} s "
              f"({n_done / dt:.0f} reads/s)", file=sys.stderr)
