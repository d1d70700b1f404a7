"""Parallel read-mapping pipeline.

The reference parallelizes with a 4-task pthreads pipeline
(ARGBUF/INPUT/PROC/OUTPUT, threads.c:45-50) over blocks of 32 reads
(smalt.c:88) and an optional in-order output merge keyed on read
number (smalt.c:966-1000).  Here the same dataflow is a Python
multiprocessing pool of forked workers sharing the read-only engine
(copy-on-write), with blocks streamed through `imap` (ordered — the
-O semantics; the reference's unordered mode is nondeterministic by
design, so ordered is our default and only mode).

Each worker renders its block's SAM/CIGAR text; the parent writes
blocks in input order.  Per-worker drand48 streams are reseeded per
block from (seed, block number) so that the output is reproducible
for any worker count — stronger than the reference, whose threads
race for one process-global stream (mthread_test.py only requires
mapq>6 lines to match across thread counts).

Counterpart of smalt_tpu/map/pipeline.py, whose host paths it keeps
line for line.  The device lanes are entered apart from the host paths:
`device_lane` chooses the lane of a `--device-exact` or `--device-pass1`
run as the reference's run_pipeline_raw_fastq / run_pipeline_raw_pairs
choose it (DeviceExact, then DevicePass1, then the host lane), so that a
caller knows before any device call whether a device runs, and
`run_device_lane` maps through the lane chosen.  `run_device_fastq`,
`run_device_exact_fastq` and `run_device_exact_pairs` do both, and run
the host lane where the reference does.
"""
from __future__ import annotations

import io
import itertools
import multiprocessing as mp
import os
import sys
from typing import Iterable, Iterator, List, Optional, Tuple

from .. import rand
from ..report.report import Report, ReportWriter
from ..results.pairs import add_pair_to_report, add_single_to_report

BLOCK_READS = 32  # smalt.c:88 SMALT_BLOCKSIZ_IOBUF


_g = {}


def _init_worker(engine, writer_args, seed):
    _g["engine"] = engine
    _g["writer_args"] = writer_args
    _g["seed"] = seed
    _g.pop("lane", None)   # rebuilt per run: it pins engine + buffers
    _g.pop("pair_lane", None)
    _g.pop("bam_enc", None)
    _g.pop("bam_sam_lane", None)
    _g.pop("bam_pair_lane", None)


def _render_block(args):
    blockno, block = args
    engine = _g["engine"]
    fmt, soft, xmm, refset, ali_out = _g["writer_args"]
    if _g.get("reseed_per_block"):
        # parallel mode: deterministic per-block RNG streams (serial mode
        # keeps the single global drand48 stream for reference parity)
        rand.ranseed((_g["seed"] or 1) + blockno * 7919)
    if "lane" not in _g:
        if os.environ.get("SMALT_TPU_NO_FASTLANE"):
            _g["lane"] = None
            _g["pair_lane"] = None
        else:
            from .fastlane import FastLane, PairLane
            _g["lane"] = FastLane.make(engine, fmt, soft, xmm, ali_out,
                                       _g.get("fix_primary", False))
            _g["pair_lane"] = PairLane.make(engine, fmt, soft, xmm,
                                            ali_out,
                                            _g.get("fix_primary", False),
                                            _g.get("ihist"))
    lane = _g["lane"]
    if lane is not None and not any(isinstance(it, tuple) for it in block):
        text = lane.render_block(block)
        if text is not None:
            return text
    plane = _g.get("pair_lane")
    if plane is not None and \
            all(isinstance(it, tuple) for it in block) and block:
        text = plane.render_block(block, _oracle_one_pair)
        if text is not None:
            return text
    if fmt == "bam" and "bam_enc" not in _g:
        # BAM: the C lane maps + renders SAM text, a cheap re-encode
        # turns it into BAM records byte-identical to the Report path
        _g["bam_enc"] = _g["bam_sam_lane"] = _g["bam_pair_lane"] = None
        if not os.environ.get("SMALT_TPU_NO_FASTLANE"):
            from ..report.bam import SamTextEncoder
            enc = SamTextEncoder.make(refset)
            if enc is not None:
                from .fastlane import FastLane, PairLane
                fp = _g.get("fix_primary", False)
                _g["bam_enc"] = enc
                _g["bam_sam_lane"] = FastLane.make(engine, "sam", soft,
                                                   xmm, ali_out, fp)
                _g["bam_pair_lane"] = PairLane.make(engine, "sam", soft,
                                                    xmm, ali_out, fp,
                                                    _g.get("ihist"))
    if fmt == "bam" and _g.get("bam_enc") is not None:
        flat = [r for it in block
                for r in (it if isinstance(it, tuple) else (it,))]
        all_q = all(r.qual is not None for r in flat)
        # a 1-base read whose quality char is '*' prints a QUAL column
        # indistinguishable from a missing quality; with mixed qual
        # presence in the block the text can't be decoded faithfully —
        # the Report-object path below handles it
        ambiguous = (not all_q and
                     any(r.qual == b"*" for r in flat
                         if r.qual is not None and len(r.seq) == 1))
        text = None
        if not ambiguous and _g["bam_sam_lane"] is not None and \
                not any(isinstance(it, tuple) for it in block):
            text = _g["bam_sam_lane"].render_block(block)
        elif not ambiguous and _g["bam_pair_lane"] is not None and \
                all(isinstance(it, tuple) for it in block) and block:
            text = _g["bam_pair_lane"].render_block(
                block, _oracle_one_pair_sam)
        if text is not None:
            return _g["bam_enc"].encode_text(text,
                                             star_qual_literal=all_q)
    if fmt == "bam":
        from ..report.bam import BamRecordEncoder
        buf = None
        writer = BamRecordEncoder(refset, soft_clip=soft, x_mismatch=xmm)
    else:
        buf = io.StringIO()
        writer = ReportWriter(buf, refset, fmt=fmt, soft_clip=soft,
                              x_mismatch=xmm, header=False, ali_out=ali_out)
    fix_primary = _g.get("fix_primary", False)
    for item in block:
        rep = Report()
        if isinstance(item, tuple):
            read, mate = item
            rsr, rsm, rpairs, pairflg = engine.rmap_pair(read, mate)
            add_pair_to_report(rep, _g.get("ihist"), rpairs, pairflg,
                               engine.params.rsltouflg, rsr, rsm)
            if fix_primary:
                rep.fix_multiple_primary()
            writer.write(rep, read, mate)
        else:
            rs = engine.rmap_single(item)
            add_single_to_report(rep, engine.params.rsltouflg, rs)
            if fix_primary:
                rep.fix_multiple_primary()
            writer.write(rep, item, None)
    return writer.take() if buf is None else buf.getvalue()


def _oracle_one_pair_sam(item) -> str:
    """_oracle_one_pair pinned to SAM text — the fallback arm of the
    BAM path's pair lane (the SAM->BAM re-encode needs text)."""
    return _oracle_one_pair(item, force_fmt="sam")


def _oracle_one_pair(item, force_fmt=None) -> str:
    """Render ONE (read, mate) pair through the Python engine — the
    per-pair fallback arm of the C pair lane (fastlane.PairLane)."""
    engine = _g["engine"]
    fmt, soft, xmm, refset, ali_out = _g["writer_args"]
    if force_fmt is not None:
        fmt = force_fmt
    read, mate = item
    buf = io.StringIO()
    writer = ReportWriter(buf, refset, fmt=fmt, soft_clip=soft,
                          x_mismatch=xmm, header=False, ali_out=ali_out)
    rep = Report()
    rsr, rsm, rpairs, pairflg = engine.rmap_pair(read, mate)
    add_pair_to_report(rep, _g.get("ihist"), rpairs, pairflg,
                       engine.params.rsltouflg, rsr, rsm)
    if _g.get("fix_primary", False):
        rep.fix_multiple_primary()
    writer.write(rep, read, mate)
    return buf.getvalue()


def _blocks(it: Iterable, n: int) -> Iterator[Tuple[int, list]]:
    blockno = 0
    while True:
        block = list(itertools.islice(it, n))
        if not block:
            return
        yield blockno, block
        blockno += 1


def run_pipeline_raw_fastq(engine, path: str, out, refset,
                           fmt: str = "sam", soft_clip: bool = True,
                           x_mismatch: bool = False, seed: int = 1,
                           ihist=None, fix_primary: bool = False,
                           ali_out: bool = False,
                           resume_log=None) -> bool:
    """Serial single-end bulk path: C-speed FASTQ parsing feeding the C
    fast-lane with raw bytes (encode + name handling also native).
    Returns False when not applicable — the caller then runs the
    regular run_pipeline.  Output is byte-identical either way: blocks
    only batch work, the drand48 stream is sequential."""
    if os.environ.get("SMALT_TPU_NO_FASTLANE"):
        return False
    from .fastlane import FastLane
    lane = FastLane.make(engine, fmt, soft_clip, x_mismatch, ali_out,
                         fix_primary)
    if lane is None:
        return False
    # the bulk parser needs strict 4-line FASTQ
    if not _strict_fastq(path):
        return False

    from .fastmode import iter_fastq_batches
    writer_args = (fmt, soft_clip, x_mismatch, refset, ali_out)
    _init_worker(engine, writer_args, seed)
    _g["ihist"] = ihist
    _g["fix_primary"] = fix_primary
    _g["reseed_per_block"] = False
    _g["lane"] = lane

    fallback_batch = _host_batch_renderer(lane)

    skip_reads = 0
    if resume_log is not None:
        st = resume_log.load()
        if st:
            skip_reads = st["reads_done"]
            rand._global._x = st["rng"]
    reads_done = 0
    for names, seqs, quals in iter_fastq_batches(path, 1024):
        reads_done += len(names)
        if reads_done <= skip_reads:
            continue               # checkpointed batch: already written
        out.write(fallback_batch(names, seqs, quals))
        if resume_log is not None:
            out.flush()
            resume_log.tick(reads_done, out.tell(), rand._global._x)
    if resume_log is not None:
        resume_log.done()
    _fl_timing_line(f"exact lane ({reads_done} reads)")
    return True


def _fl_timing_line(what: str) -> None:
    """Under SMALT_FL_TIMING, the C lane's stage split since the last
    report (native fl_prof_report) as one `# SMALT_FL_TIMING` line."""
    if not os.environ.get("SMALT_FL_TIMING"):
        return
    from ..native import fl_prof_report
    prof = fl_prof_report()
    if not prof:
        return
    sub, counts = prof.pop("_sub"), prof.pop("_counts")
    tot = sum(prof.values()) or 1.0
    split = "  ".join(f"{k} {v:.2f}s ({100 * v / tot:.0f}%)"
                      for k, v in prof.items())
    if any(sub.values()):
        split += "  | sub: " + "  ".join(
            f"{k} {v:.2f}s" for k, v in sub.items())
    print(f"# SMALT_FL_TIMING {what}: {split}  [gapless shortcut "
          f"{counts['shortcut-hits']:.0f} / DP {counts['dp-runs']:.0f}]",
          file=sys.stderr)


def _host_batch_renderer(lane):
    """fallback(names, seqs, quals) -> text for one raw batch on the
    host: the C lane's block renderer, else the regular block renderer
    (which itself may fall back to the pure-Python engine).  Only for
    batches on which no RNG was consumed yet."""
    from ..seq import codec
    from ..seq.io import Read

    def fallback_batch(names, seqs, quals):
        text = lane.render_raw_block(names, seqs, quals)
        if text is not None:
            return text
        reads = [Read(name=n.decode(), seq=codec.encode(s), qual=q)
                 for n, s, q in zip(names, seqs, quals)]
        buf = []
        for args in _blocks(iter(reads), BLOCK_READS):
            buf.append(_render_block(args))
        return "".join(buf)

    return fallback_batch


def device_lane(engine, reads_path: str, fmt: str = "sam",
                soft_clip: bool = True, x_mismatch: bool = False,
                fix_primary: bool = False, ali_out: bool = False, *,
                exact: bool, mates_path: Optional[str] = None, ihist=None,
                resume: bool = False, device="cuda", batch: int = 0):
    """The device lane of `map --device-exact` (exact) or `map
    --device-pass1` on this engine and input, chosen in the reference's
    order (smalt_tpu/map/pipeline.py:205-249 for single-end reads,
    318-346 for pairs): DeviceExact under --device-exact; then, for
    single-end reads without checkpoints (`resume`: DevicePass1 keeps
    none), DevicePass1; else none, and the host lane maps.  Nothing here
    touches a device.  Returns (lane, plane, what): lane None where the
    host lane maps (also where the C lane does not take the options or
    the input is not strict FASTQ), plane the PairLane of a paired run,
    what the name of the lane that maps."""
    from .fastlane import DeviceExact, DevicePass1, FastLane, PairLane
    args = (engine, fmt, soft_clip, x_mismatch, ali_out, fix_primary)
    mk = dict(batch=batch, device=device)
    if os.environ.get("SMALT_TPU_NO_FASTLANE"):
        return None, None, "the host lane"
    if mates_path is not None:
        plane = PairLane.make(*args, ihist)
        if plane is not None and exact and _strict_fastq(reads_path) and \
                _strict_fastq(mates_path):
            dev = DeviceExact.make(*args, **mk)
            if dev is not None:
                return dev, plane, "the --device-exact lane"
        return None, None, "the host pair lane"
    if FastLane.make(*args) is None or not _strict_fastq(reads_path):
        return None, None, "the host lane"
    if exact:
        dev = DeviceExact.make(*args, **mk)
        if dev is not None:
            return dev, None, "the --device-exact lane"
    if not resume:
        dev = DevicePass1.make(*args, **mk)
        if dev is not None:
            return dev, None, "the --device-pass1 lane"
    return None, None, "the host lane"


def run_device_lane(lane, engine, reads_path: str, out, refset,
                    fmt: str = "sam", soft_clip: bool = True,
                    x_mismatch: bool = False, seed: int = 1,
                    fix_primary: bool = False, ali_out: bool = False, *,
                    mates_path: Optional[str] = None, plane=None, ihist=None,
                    resume_log=None):
    """Map through `lane` (device_lane's), writing headerless records to
    `out` in input order, with the worker state, host batch renderer and
    per-pair oracle of the reference's raw paths.  resume_log: the
    checkpoints of a single-end DeviceExact run.  Returns the lane, whose
    counters (host_batches; DeviceExact's n_restaged, p2_used, p2_fb,
    p2_hit) describe the run."""
    from .fastlane import DeviceExact
    _init_worker(engine, (fmt, soft_clip, x_mismatch, refset, ali_out), seed)
    _g["ihist"] = ihist
    _g["fix_primary"] = fix_primary
    _g["reseed_per_block"] = False
    if mates_path is not None:
        lane.run_raw_pairs(plane, reads_path, mates_path, out,
                           _oracle_one_pair, _mk_pair)
        return lane
    _g["lane"] = lane.lane
    fallback = _host_batch_renderer(lane.lane)
    if isinstance(lane, DeviceExact):
        lane.run_raw_fastq(reads_path, out, fallback, resume_log=resume_log)
    else:
        lane.run_raw_fastq(reads_path, out, fallback)
    return lane


def run_device_fastq(engine, path: str, out, refset, fmt: str = "sam",
                     soft_clip: bool = True, x_mismatch: bool = False,
                     seed: int = 1, fix_primary: bool = False,
                     ali_out: bool = False, *, exact: bool, device="cuda",
                     batch: int = 0, resume_log=None):
    """Map the single-end FASTQ `path` as `map --device-exact` (exact) or
    `map --device-pass1` does on `device`, writing headerless records to
    `out` in input order: through the lane device_lane chooses, or where
    it chooses none through the host lane, as the reference's
    run_pipeline_raw_fastq and its caller do.  Returns the device lane
    that ran, or None."""
    lane, _, _ = device_lane(engine, path, fmt, soft_clip, x_mismatch,
                             fix_primary, ali_out, exact=exact,
                             resume=resume_log is not None, device=device,
                             batch=batch)
    opts = dict(fmt=fmt, soft_clip=soft_clip, x_mismatch=x_mismatch,
                seed=seed, fix_primary=fix_primary, ali_out=ali_out)
    if lane is not None:
        return run_device_lane(lane, engine, path, out, refset,
                               resume_log=resume_log, **opts)
    if not run_pipeline_raw_fastq(engine, path, out, refset,
                                  resume_log=resume_log, **opts):
        from ..seq.io import FastqReader
        run_pipeline(engine, FastqReader(path), out, refset, **opts)
    return None


def run_device_exact_fastq(engine, path: str, out, refset, fmt: str = "sam",
                           soft_clip: bool = True, x_mismatch: bool = False,
                           seed: int = 1, fix_primary: bool = False,
                           ali_out: bool = False,
                           device="cuda", batch: int = 0, resume_log=None):
    """run_device_fastq for `map --device-exact`: DeviceExact, or where
    DeviceExact.make refuses the engine (a reference of 2^31 bases or
    more; nskip > wordlen with k > 14 or more than 8 sequences)
    DevicePass1 unless checkpoints are kept, or the host lane.  Returns
    the device lane that ran, or None."""
    return run_device_fastq(engine, path, out, refset, fmt, soft_clip,
                            x_mismatch, seed, fix_primary, ali_out,
                            exact=True, device=device, batch=batch,
                            resume_log=resume_log)


def run_device_exact_pairs(engine, reads_path: str, mates_path: str, out,
                           refset, fmt: str = "sam", soft_clip: bool = True,
                           x_mismatch: bool = False, seed: int = 1,
                           ihist=None, fix_primary: bool = False,
                           ali_out: bool = False, device="cuda",
                           batch: int = 0):
    """Map the read pairs of two FASTQ files as `map --device-exact` does
    on `device`, writing headerless records to `out` in input order:
    through DeviceExact where device_lane chooses it, else through the
    host pair lane, as the reference's run_pipeline_raw_pairs and its
    caller do (pipeline.py:299-346 there).  Returns the device lane that
    ran (counters n_restaged, host_batches), or None."""
    lane, plane, _ = device_lane(engine, reads_path, fmt, soft_clip,
                                 x_mismatch, fix_primary, ali_out,
                                 exact=True, mates_path=mates_path,
                                 ihist=ihist, device=device, batch=batch)
    opts = dict(fmt=fmt, soft_clip=soft_clip, x_mismatch=x_mismatch,
                seed=seed, fix_primary=fix_primary, ali_out=ali_out)
    if lane is not None:
        return run_device_lane(lane, engine, reads_path, out, refset,
                               mates_path=mates_path, plane=plane,
                               ihist=ihist, **opts)
    if not run_pipeline_raw_pairs(engine, reads_path, mates_path, out,
                                  refset, ihist=ihist, **opts):
        from ..seq.io import PairedReader
        run_pipeline(engine, PairedReader(reads_path, mates_path), out,
                     refset, ihist=ihist, **opts)
    return None


def _mk_pair(i, nA, sA, qA, nB, sB, qB):
    """Pair i of a raw batch of both mate files as (Read, Read)."""
    from ..seq import codec
    from ..seq.io import Read
    return (Read(name=nA[i].decode(), seq=codec.encode(sA[i]), qual=qA[i]),
            Read(name=nB[i].decode(), seq=codec.encode(sB[i]), qual=qB[i]))


def _strict_fastq(path: str) -> bool:
    """True when `path` looks like strict 4-line FASTQ (the bulk
    parser's contract); anything else goes to the record reader."""
    from ..seq.io import open_maybe_gzip
    with open_maybe_gzip(path) as f:
        head = [f.readline() for _ in range(4)]
    return not (len(head) < 4 or not head[0].startswith(b"@") or
                not head[2].startswith(b"+") or
                head[0].endswith(b"\r\n") or
                len(head[1].rstrip(b"\r\n")) != len(head[3].rstrip(b"\r\n")))


def run_pipeline_raw_pairs(engine, reads_path: str, mates_path: str,
                           out, refset, fmt: str = "sam",
                           soft_clip: bool = True,
                           x_mismatch: bool = False, seed: int = 1,
                           ihist=None, fix_primary: bool = False,
                           ali_out: bool = False) -> bool:
    """Serial paired-end bulk path: C-speed FASTQ parsing of both mate
    files feeding the C pair lane with raw bytes (base encoding + name
    cutting also native — no per-read Python objects on the covered
    flow).  Returns False when not applicable — the caller then runs
    the regular run_pipeline.  Output is byte-identical either way:
    the pair lane's per-pair resume protocol replays uncovered pairs
    through the Python oracle on the same sequential drand48 stream
    (threads.c:985-1014 serial order; rmap.c:1744-2112 pair flow)."""
    if os.environ.get("SMALT_TPU_NO_FASTLANE"):
        return False
    from .fastlane import PairLane
    plane = PairLane.make(engine, fmt, soft_clip, x_mismatch, ali_out,
                          fix_primary, ihist)
    if plane is None:
        return False
    if not (_strict_fastq(reads_path) and _strict_fastq(mates_path)):
        return False

    from .fastmode import iter_fastq_batches
    writer_args = (fmt, soft_clip, x_mismatch, refset, ali_out)
    _init_worker(engine, writer_args, seed)
    _g["ihist"] = ihist
    _g["fix_primary"] = fix_primary
    _g["reseed_per_block"] = False

    pairs_done = 0
    itB = iter_fastq_batches(mates_path, 1024)
    for nA, sA, qA in iter_fastq_batches(reads_path, 1024):
        nB, sB, qB = next(itB, (None, None, None))
        if nB is None or len(nB) != len(nA):
            raise ValueError("paired files have different read counts")
        def oracle_one_raw(i, nA=nA, sA=sA, qA=qA,
                           nB=nB, sB=sB, qB=qB):
            return _oracle_one_pair(_mk_pair(i, nA, sA, qA, nB, sB, qB))
        text = plane.render_raw_pairs(nA, sA, qA, nB, sB, qB,
                                      oracle_one_raw)
        if text is None:
            # no RNG consumed: replay the batch through the block
            # renderer (C pair lane again, then the Python engine)
            block = [_mk_pair(i, nA, sA, qA, nB, sB, qB)
                     for i in range(len(nA))]
            parts = []
            for args in _blocks(iter(block), BLOCK_READS):
                parts.append(_render_block(args))
            text = "".join(parts)
        out.write(text)
        pairs_done += len(nA)
    if next(itB, None) is not None:
        raise ValueError("paired files have different read counts")
    _fl_timing_line(f"exact pair lane ({pairs_done} pairs)")
    return True


def run_pipeline(engine, reads_iter: Iterable, out, refset,
                 fmt: str = "sam", soft_clip: bool = True,
                 x_mismatch: bool = False, nthreads: int = 1,
                 seed: int = 1, ihist=None, fix_primary: bool = False,
                 ali_out: bool = False):
    """Map all reads/pairs from `reads_iter`, writing rendered blocks to
    `out` in input order.  nthreads<=1 runs inline (serial fallback,
    threads.c:985-1014)."""
    writer_args = (fmt, soft_clip, x_mismatch, refset, ali_out)
    if nthreads <= 1:
        _init_worker(engine, writer_args, seed)
        _g["ihist"] = ihist
        _g["fix_primary"] = fix_primary
        _g["reseed_per_block"] = False
        for args in _blocks(iter(reads_iter), BLOCK_READS):
            out.write(_render_block(args))
        return

    ctx = mp.get_context("fork")
    extra = {"ihist": ihist, "fix_primary": fix_primary,
             "reseed_per_block": True}

    def init():
        _init_worker(engine, writer_args, seed)
        _g.update(extra)

    with ctx.Pool(processes=nthreads, initializer=init) as pool:
        for text in pool.imap(_render_block,
                              _blocks(iter(reads_iter), BLOCK_READS),
                              chunksize=1):
            out.write(text)
