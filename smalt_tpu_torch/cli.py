"""Command line of the PyTorch port, mirroring the reference `smalt`
surface (menu.c): subprograms index / map / sample / check / version /
help.

    python -m smalt_tpu_torch.cli index [-k wordlen] [-s stepsiz]
        <index_name> <ref.fa>
    python -m smalt_tpu_torch.cli map [options] <index_name> <reads>
        [<mates>] > out.sam
    python -m smalt_tpu_torch.cli map --fast [--device cuda|cpu] [options]
        <index_name> <reads.fq> [<mates.fq>] > out.sam
    python -m smalt_tpu_torch.cli map --device-exact [--device cuda|cpu]
        [options] <index_name> <reads.fq> [<mates.fq>] > out.sam
    python -m smalt_tpu_torch.cli sample [options] <index_name> <reads1>
        <reads2>
    python -m smalt_tpu_torch.cli check <reads> [<mates>]
    python -m smalt_tpu_torch.cli merge-shards <out.sam> <shard>...

Counterpart of smalt_tpu/cli.py; the host subcommands are the
reference's own code.  `map` without a device flag is the exact host
lane.  `map --fast` runs the port's device pass (single-end reads, or pairs
with a mates file; on one device, or over a device mesh with `--mesh
DP,IP`, or striped over several hosts by the SMALT_TPU_COORD /
SMALT_TPU_NPROCS / SMALT_TPU_PROCID variables, whose SAM shards
`merge-shards` joins) and writes the same SAM as `smalt_tpu map
--fast`.  `map --device-exact` runs the exact engine's
front half (and, with SMALT_DX_P2=1, its pass 2) on one device for
serial FASTQ, single-end or paired, and writes the output of the exact
host lane, byte for byte, in any output format and with `--resume`.
`--device` defaults to `cuda`; without a GPU that fails rather than
running on the CPU, and `--device cpu` exists for the tests.
"""
from __future__ import annotations

import argparse
import io
import os
import sys
from typing import List, Optional

from . import __version__, rand
from .seq.io import FastqReader, PairedReader
from .seq.refset import RefSet
from .index.table import KmerIndex, build_index
from .map.engine import MapEngine, MapParams, RMAPFLG_CMPLXW, RMAPFLG_SPLIT, \
    RMAPFLG_NOSHRTINFO, RMAPFLG_SENSITIVE, RMAPFLG_BEST, RMAPFLG_ALLPAIR
from .results import pairs as pairs_mod
from .results.insert import InsHist, InsSample
from .results.result import MAPSCOR_THRESH_CONFIDENT
from .report.report import Report, ReportWriter
from .results.pairs import add_pair_to_report

SMALT_VERSION = "0.7.6"  # behavioural parity target


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        _usage()
        return 1
    sub = argv[0]
    if sub in ("index", "map", "sample", "check", "merge-shards"):
        fn = {"index": cmd_index, "map": cmd_map, "sample": cmd_sample,
              "check": cmd_check, "merge-shards": cmd_merge_shards}[sub]
        try:
            return fn(argv[1:])
        except SystemExit as e:     # argparse --help / -H exit
            return int(e.code or 0)
    if sub == "version":
        print(f"smalt_tpu_torch {__version__} "
              f"(behavioural parity with SMALT {SMALT_VERSION})")
        return 0
    if sub == "help":
        # smalt help <subprog> (menu.h:42-50)
        target = argv[1] if len(argv) > 1 else None
        cmds = {"index": cmd_index, "map": cmd_map,
                "sample": cmd_sample, "check": cmd_check,
                "merge-shards": cmd_merge_shards}
        if target in cmds:
            try:
                return cmds[target](["--help"])
            except SystemExit as e:
                return int(e.code or 0)
        _usage()
        return 0
    _usage()
    return 1


def _usage():
    print(__doc__, file=sys.stderr)


class _HelpAction(argparse.Action):
    """Reference `-H`: print the task instructions and exit 0 —
    honored wherever getopt would see it, including clustered short
    flags like `-wH` (menu.c -H)."""

    def __init__(self, option_strings, dest, **kw):
        super().__init__(option_strings, dest, nargs=0, **kw)

    def __call__(self, parser, namespace, values, option_string=None):
        parser.print_help(sys.stderr)
        parser.exit(0)


def cmd_index(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(prog="smalt_tpu_torch index")
    ap.add_argument("-k", type=int, default=13, dest="wordlen",
                    help="k-mer word length (3..20, default 13)")
    ap.add_argument("-s", type=int, default=None, dest="skipstep",
                    help="sampling step: index every s-th k-mer word "
                         "along the reference (default: wordlen)")
    ap.add_argument("-H", action=_HelpAction, dest="printhelp",
                    help="print these instructions")
    ap.add_argument("index_name")
    ap.add_argument("reference")
    a = ap.parse_args(argv)
    nskip = a.skipstep if a.skipstep is not None else a.wordlen  # menu.c:1175
    print("# Reading sequences ...", file=sys.stderr)
    refset = RefSet.from_fasta(a.reference)
    print("# Writing sequence set ...", file=sys.stderr)
    refset.save(a.index_name)
    print(f"# word length = {a.wordlen} bases, skip step = {nskip} bases ...",
          file=sys.stderr)
    idx = build_index(refset, a.wordlen, nskip)
    idx.print_stats(sys.stderr)
    idx.save(a.index_name)
    return 0


def _map_argparser(prog):
    ap = argparse.ArgumentParser(prog=prog)
    ap.add_argument("-a", action="store_true", dest="aliout",
                    help="output explicit alignments along with the "
                         "mapping coordinates")
    ap.add_argument("-c", type=float, default=None, dest="mincover",
                    help="minimum k-mer seed coverage of the read: "
                         "bases if > 1.0, else fraction of read length "
                         "(requires -x)")
    ap.add_argument("-d", type=int, default=None, dest="scorediff",
                    help="report all alignments within this score of "
                         "the maximum (< 0: all above -m; paired reads "
                         "support only -d 0)")
    ap.add_argument("-f", default="sam", dest="oformat",
                    help="output format: sam (default), cigar, ssaha, "
                         "gff, or bam; modifiers e.g. sam:nohead,x,clip")
    ap.add_argument("-F", default=None, dest="informat",
                    choices=["fastq", "sam", "bam"],
                    help="input format (default fastq; sam/bam built "
                         "in — the reference needs bambamc)")
    ap.add_argument("-g", default=None, dest="insfil",
                    help="insert-size distribution file produced by "
                         "'smalt_tpu_torch sample'")
    ap.add_argument("-H", action=_HelpAction, dest="printhelp",
                    help="print these instructions")
    ap.add_argument("-i", type=int, default=500, dest="insertmax",
                    help="maximum insert size in paired-end mode "
                         "(default 500)")
    ap.add_argument("-j", type=int, default=0, dest="insertmin",
                    help="minimum insert size in paired-end mode "
                         "(default 0)")
    ap.add_argument("-l", default=None, dest="pairtyp",
                    choices=["pe", "mp", "pp"],
                    help="read-pair library type: pe |--> <--| "
                         "(default), mp <--| |-->, pp |--> |-->")
    ap.add_argument("-m", type=int, default=None, dest="minscor",
                    help="absolute Smith-Waterman score threshold "
                         "(default wordlen + stepsiz - 1)")
    ap.add_argument("-n", type=int, default=1, dest="nthreads",
                    help="number of worker processes (output stays in "
                         "input order and deterministic for any -n — "
                         "stronger than the reference, which needs -O)")
    ap.add_argument("-o", default=None, dest="oufilnam",
                    help="write mapping output to this file instead of "
                         "standard output")
    ap.add_argument("-O", action="store_true", dest="inorder",
                    help="accepted for reference compatibility: output "
                         "is always in input order here")
    ap.add_argument("-p", action="store_true", dest="splitread",
                    help="report partial alignments if they are "
                         "complementary on the read (split reads)")
    ap.add_argument("-q", type=int, default=0, dest="minbasq",
                    help="base-quality threshold for k-mer lookups "
                         "(0..10, default 0)")
    ap.add_argument("-r", type=int, default=None, dest="randseed",
                    help=">= 0: pick one of multiple best mappings at "
                         "random (0 seeds from the clock); < 0: report "
                         "multi-best reads as not mapped")
    ap.add_argument("-S", default=None, dest="scorspec",
                    help="alignment penalties, e.g. "
                         "'match=1,subst=-2,gapopen=-4,gapext=-3'")
    ap.add_argument("-T", default=None, dest="tmpdir",
                    help="write temporary files to this directory")
    ap.add_argument("-w", action="store_true", dest="complexw",
                    help="complexity-weighted Smith-Waterman scores")
    ap.add_argument("-x", action="store_true", dest="exhaustive",
                    help="more exhaustive search: in paired mode each "
                         "mate maps independently")
    ap.add_argument("-y", type=float, default=None, dest="minid",
                    help="identity threshold: exactly matching bases "
                         "as a count or fraction of read length")
    ap.add_argument("--profile", default=None, dest="profdir",
                    help="write a torch profiler trace of the device "
                         "mapping loop to this directory (--fast, "
                         "--device-exact, --device-pass1)")
    ap.add_argument("--device-pass1", action="store_true",
                    dest="device_pass1",
                    help="score the exact pass-1 candidate windows on "
                         "the device (batched Smith-Waterman kernel) "
                         "while the host runs seeding and the exact "
                         "pass-2; output stays bit-identical (extension "
                         "over the reference CLI)")
    ap.add_argument("--device-exact", action="store_true",
                    dest="device_exact",
                    help="run the exact engine's full front half "
                         "(seeding, hit collection, collation AND "
                         "pass-1 scoring) on the device in one dispatch "
                         "per block; host keeps rank selection, depth "
                         "sort, pass-2 and rendering; output stays "
                         "bit-identical (extension over the reference "
                         "CLI)")
    ap.add_argument("--fast", action="store_true", dest="fastmode",
                    help="device pass-1 + host traceback tail "
                         "(SAM; single or paired with mate rescue; "
                         "reference-style output, not bit-identical — "
                         "extension over the reference CLI)")
    ap.add_argument("--resume", action="store_true", dest="resume",
                    help="with -o: checkpoint progress every few "
                         "batches to OUT.resume and, on restart, "
                         "continue from the last checkpoint with "
                         "byte-identical output (single-end serial "
                         "exact runs and single-host --fast runs; "
                         "extension over the reference CLI)")
    ap.add_argument("--mesh", default=None, dest="mesh_spec",
                    metavar="DP,IP",
                    help="with --fast: run the mapping step over a "
                         "device mesh (reads data-parallel over DP "
                         "devices, index range-sharded over IP); "
                         "default: all visible GPUs as pure dp")
    ap.add_argument("--fallback-exact", action="store_true",
                    dest="fallback_exact",
                    help="with --fast: reads whose seed search the "
                         "device pass truncated (repeat words beyond "
                         "the expansion budget) are remapped through "
                         "the exact engine (single-end)")
    ap.add_argument("index_name")
    ap.add_argument("reads")
    ap.add_argument("mates", nargs="?", default=None)
    return ap


def _parse_penalties(spec: Optional[str]):
    pen = {"match": 1, "subst": -2, "gapopen": -4, "gapext": -3}
    if spec:
        for part in spec.split(","):
            k, v = part.split("=")
            pen[k.strip()] = int(v)
    return pen["match"], pen["subst"], pen["gapopen"], pen["gapext"]


def _build_engine(a, argv_full, default_pairtyp="pe"):
    refset = RefSet.load(a.index_name)
    idx = KmerIndex.load(a.index_name)
    params = MapParams()
    params.insert_min = a.insertmin
    params.insert_max = a.insertmax
    params.min_basq = a.minbasq
    if a.mincover is not None:
        params.min_cover_frac = a.mincover
    if a.minscor is not None:
        params.min_swatscor = a.minscor
        params.filter_minscor = a.minscor
    rsltouflg = 0
    rmapflg = 0
    scorediff = a.scorediff if a.scorediff is not None else 0
    params.min_swatscor_below_max = scorediff
    randsel = a.randseed is None or a.randseed >= 0
    relscor = a.scorediff is not None
    if not scorediff:
        rsltouflg |= pairs_mod.RESULTFLG_BEST
        rmapflg |= RMAPFLG_BEST
        if not relscor:
            rsltouflg |= pairs_mod.RESULTFLG_SINGLE
            if randsel:
                rsltouflg |= pairs_mod.RESULTFLG_RANDSEL
                rand.ranseed(a.randseed if a.randseed is not None else 0)
    if a.splitread:
        rmapflg |= RMAPFLG_SPLIT | RMAPFLG_NOSHRTINFO | RMAPFLG_SENSITIVE
        rsltouflg |= pairs_mod.RESULTFLG_SPLIT
    if a.complexw:
        rmapflg |= RMAPFLG_CMPLXW
    if a.exhaustive:
        rmapflg |= RMAPFLG_NOSHRTINFO | RMAPFLG_SENSITIVE | RMAPFLG_ALLPAIR
    params.rmapflg = rmapflg
    params.rsltouflg = rsltouflg
    params.use_cplx = a.complexw
    pairtyp = a.pairtyp if a.pairtyp is not None else default_pairtyp
    # sample leaves the library type UNKNOWN -> PAIREDALL (menu.c:1211 is
    # only applied by checkMapDefaults, not checkSampleDefaults)
    params.pairtyp = {"pe": pairs_mod.LIB_PAIREDEND,
                      "mp": pairs_mod.LIB_MATEPAIR,
                      "pp": pairs_mod.LIB_SAMESTRAND,
                      "all": pairs_mod.LIB_PAIREDALL}[pairtyp]
    engine = MapEngine(refset, idx, params,
                       penalties=_parse_penalties(a.scorspec))
    if a.minid is not None:
        engine.filter.min_identity = a.minid
    return engine, refset, idx


def _sam_is_paired(path: str) -> bool:
    from .seq.io import open_maybe_gzip
    with open_maybe_gzip(path) as f:
        for line in f:
            if line.startswith(b"@"):
                continue
            return bool(int(line.split(b"\t")[1]) & 0x1)
    return False


def _open_out(a):
    return open(a.oufilnam, "w") if a.oufilnam else sys.stdout


def _writer(a, refset, argv, out):
    fmt = a.oformat.split(":")[0]
    mods = a.oformat.split(":")[1].split(",") if ":" in a.oformat else []
    soft = "clip" not in mods
    x_mismatch = "x" in mods
    header = "nohead" not in mods
    return ReportWriter(out, refset, fmt=fmt, soft_clip=soft,
                        x_mismatch=x_mismatch, header=header,
                        prog_args=["smalt_tpu_torch", "map"] + argv,
                        version=SMALT_VERSION)


def _split_device(argv: List[str]):
    """Take `--device X` / `--device=X` out of argv: (device, rest)."""
    device, rest = "cuda", []
    i = 0
    while i < len(argv):
        x = argv[i]
        if x == "--device" and i + 1 < len(argv):
            device = argv[i + 1]
            i += 2
            continue
        if x.startswith("--device="):
            device = x.split("=", 1)[1]
        else:
            rest.append(x)
        i += 1
    return device, rest


def cmd_map(argv: List[str]) -> int:
    import time
    t_start = time.time()
    device, argv = _split_device(argv)
    a = _map_argparser("smalt_tpu_torch map").parse_args(argv)
    if a.fastmode:
        return _cmd_map_fast(a, argv, device)
    if a.device_pass1 or a.device_exact:
        # the reference's handoff (smalt_tpu/cli.py:379-385), decided from
        # the arguments before any device call: -n > 1 forks workers
        if _device_handoff(a):
            print("# --device-pass1/--device-exact apply to serial "
                  "FASTQ runs (--device-pass1: single-end only); ignored "
                  "(output is identical either way)", file=sys.stderr)
            a.device_pass1 = a.device_exact = False
        elif _score_cap_refused(a.scorspec, 128):
            return 2
    engine, refset, idx = _build_engine(a, argv)
    t_setup = time.time()
    ihist = InsHist.read(a.insfil) if a.insfil else None
    if ihist is not None:
        engine.params.insert_min = min(engine.params.insert_min, ihist.insizlo)
        engine.params.insert_max = max(engine.params.insert_max, ihist.insizhi)
    fix_primary = (a.scorediff is not None and
                   a.oformat.startswith(("sam", "bam")))
    lane = None
    if a.device_pass1 or a.device_exact:
        lane = _device_lane(a, engine, refset, ihist, fix_primary, device)
        if lane is not None and _no_gpu(device):
            return 1
    bam_writer = None
    resume_log = None
    if a.oformat.split(":")[0] == "bam":
        from .report.bam import BamWriter
        mods = a.oformat.split(":")[1].split(",") if ":" in a.oformat else []
        fp = (open(a.oufilnam, "wb") if a.oufilnam else sys.stdout.buffer)
        bam_writer = BamWriter(fp, refset, soft_clip="clip" not in mods,
                               x_mismatch="x" in mods,
                               prog_args=["smalt_tpu_torch", "map"] + argv,
                               version=SMALT_VERSION)

        class _BamSink:
            def write(self, b):
                bam_writer.write_raw(b)

        out = _BamSink()
    else:
        resume_log = resume_state = None
        serial_se_fastq = (a.mates is None and a.nthreads <= 1 and
                           a.informat not in ("sam", "bam") and
                           not a.reads.endswith((".sam", ".sam.gz",
                                                 ".bam")))
        if a.resume and a.oufilnam and serial_se_fastq:
            from .resume import ResumeLog
            resume_log = ResumeLog(a.oufilnam, ["map"] + argv)
            resume_state = resume_log.load()   # truncates OUT if found
        elif a.resume:
            print("# --resume needs -o and a serial single-end FASTQ "
                  "run; ignored", file=sys.stderr)
        if resume_state:
            out = open(a.oufilnam, "a")        # header already present
        else:
            out = _open_out(a)
            writer = _writer(a, refset, argv, out)  # emits the SAM header
    if a.informat == "bam" or a.reads.endswith(".bam"):
        from .seq.io import BamReader
        br = BamReader(a.reads)
        any_paired = any(f & 0x1 for f, _ in br._records())
        reads_iter = (pair for pair in br.pairs()) if any_paired \
            else iter(br)
    elif a.informat == "sam" or a.reads.endswith((".sam", ".sam.gz")):
        from .seq.io import SamReader
        sr = SamReader(a.reads)
        # paired SAM input iterates mate pairs from the single file
        probe = open_probe = None
        reads_iter = (pair for pair in sr.pairs()) if _sam_is_paired(a.reads) \
            else iter(sr)
    else:
        reads_iter = (PairedReader(a.reads, a.mates) if a.mates
                      else FastqReader(a.reads))
    from .map.pipeline import (run_pipeline, run_pipeline_raw_fastq,
                               run_pipeline_raw_pairs)
    fmt = a.oformat.split(":")[0]
    mods = a.oformat.split(":")[1].split(",") if ":" in a.oformat else []
    ran_raw = False
    rc = 0
    if (a.nthreads <= 1 and
            a.informat not in ("sam", "bam") and
            not a.reads.endswith((".sam", ".sam.gz", ".bam"))):
        # serial FASTQ (single-end or two-file paired): bulk parser +
        # C fast-lane end to end.
        # BAM rides the same lane: the C lane renders SAM text and a
        # cheap re-encode turns it into BAM records (report/bam.py
        # SamTextEncoder), byte-identical to the Report-object path.
        raw_out, raw_fmt, raw_ok = out, fmt, True
        if bam_writer is not None:
            from .report.bam import SamTextEncoder
            enc = SamTextEncoder.make(refset)
            if enc is None:
                raw_ok = False
            else:
                class _SamTextBamSink:
                    # strict-FASTQ input: every record carries a real
                    # quality string, so a 1-base '*' QUAL is literal
                    def write(self, text: str):
                        bam_writer.write_raw(
                            enc.encode_text(text, star_qual_literal=True))
                raw_out, raw_fmt = _SamTextBamSink(), "sam"
        if lane is not None:
            rc = _run_device_lane(a, lane, engine, raw_out, refset, raw_fmt,
                                  mods, ihist, fix_primary, resume_log)
            ran_raw = True
        elif raw_ok and a.mates is None:
            ran_raw = run_pipeline_raw_fastq(
                engine, a.reads, raw_out, refset, fmt=raw_fmt,
                soft_clip="clip" not in mods, x_mismatch="x" in mods,
                seed=(a.randseed if a.randseed is not None else 0),
                ihist=ihist, fix_primary=fix_primary, ali_out=a.aliout,
                resume_log=resume_log)
        elif raw_ok:
            ran_raw = run_pipeline_raw_pairs(
                engine, a.reads, a.mates, raw_out, refset, fmt=raw_fmt,
                soft_clip="clip" not in mods, x_mismatch="x" in mods,
                seed=(a.randseed if a.randseed is not None else 0),
                ihist=ihist, fix_primary=fix_primary, ali_out=a.aliout)
    if not ran_raw:
        run_pipeline(engine, reads_iter, out, refset, fmt=fmt,
                     soft_clip="clip" not in mods, x_mismatch="x" in mods,
                     nthreads=a.nthreads,
                     seed=(a.randseed if a.randseed is not None else 0),
                     ihist=ihist, fix_primary=fix_primary, ali_out=a.aliout)
    if bam_writer is not None:
        bam_writer.close()
    elif out is not sys.stdout:
        out.close()
    if os.environ.get("SMALT_TIMING"):
        # menuPrintWallClockTime analog (smalt.c:30,1342-1424)
        t_end = time.time()
        print(f"# SMALT_TIMING setup: {t_setup - t_start:.2f} s, "
              f"mapping: {t_end - t_setup:.2f} s", file=sys.stderr)
    return rc


def _no_gpu(device: str) -> bool:
    import torch
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print("smalt_tpu_torch: --device cuda but no GPU is visible "
              "(--device cpu runs the plain torch path, for tests)",
              file=sys.stderr)
        return True
    return False


def _score_cap_refused(spec: Optional[str], qmin: int) -> bool:
    """The device kernels take windows whose int32 DP stays within its
    bound (ops/sw.py check_score_cap).  Queries pad to at least `qmin`
    columns (--fast 32, --device-exact 128) against at least as many
    subject rows, so a matrix that fails there can score no read: say so
    and refuse before anything is loaded."""
    from .align.core import make_score_matrix
    from .ops.sw import check_score_cap, device_matrix
    m, go, ge = make_score_matrix(*_parse_penalties(spec))
    try:
        check_score_cap(f"-S {spec}", device_matrix(m, "cpu"), qmin, qmin,
                        -go, -ge)
    except ValueError as e:
        print(f"smalt_tpu_torch: {e}; `map` without a device flag takes any "
              f"matrix", file=sys.stderr)
        return True
    return False


def _device_handoff(a) -> bool:
    """True where the reference runs its host lane for a device flag from
    the arguments alone (smalt_tpu/cli.py:379-385): -n > 1, SAM/BAM input,
    --device-pass1 with mates."""
    sam_in = a.informat in ("sam", "bam") or \
        a.reads.endswith((".sam", ".sam.gz", ".bam"))
    return not ((a.mates is None or a.device_exact) and a.nthreads <= 1 and
                not sam_in)


def _device_lane(a, engine, refset, ihist, fix_primary: bool, device: str):
    """The lane a --device-exact / --device-pass1 run takes on this engine
    (map/pipeline.py device_lane, the reference's order), with a note on
    stderr where that is not the lane the flag names: None where the host
    lane maps.  `-f bam` with reference names that collide once cut at
    white space maps on the host too: the reference then writes BAM from
    report objects."""
    from .map.pipeline import device_lane
    flag = "--device-exact" if a.device_exact else "--device-pass1"
    fmt = a.oformat.split(":")[0]
    mods = a.oformat.split(":")[1].split(",") if ":" in a.oformat else []
    # cmd_map keeps checkpoints for a single-end run with -o (not BAM)
    resume = bool(a.resume and a.oufilnam and a.mates is None and
                  fmt != "bam")
    if fmt == "bam":
        from .report.bam import SamTextEncoder
        if SamTextEncoder.make(refset) is None:
            print(f"# {flag}: -f bam with reference names that collide once "
                  f"cut at white space; the host lane writes BAM from report "
                  f"objects (output is identical either way)",
                  file=sys.stderr)
            return None
        fmt = "sam"               # the lane's SAM text, re-encoded
    lane, plane, what = device_lane(
        engine, a.reads, fmt, "clip" not in mods, "x" in mods, fix_primary,
        a.aliout, exact=a.device_exact, mates_path=a.mates, ihist=ihist,
        resume=resume, device=device)
    if what != f"the {flag} lane":
        print(f"# {flag}: the engine or the input is outside the {flag} "
              f"lane's gates; {what} maps (output is identical either way)",
              file=sys.stderr)
    return None if lane is None else (lane, plane)


def _run_device_lane(a, lane, engine, out, refset, fmt: str, mods, ihist,
                     fix_primary: bool, resume_log) -> int:
    """map --device-exact / --device-pass1 through the lane _device_lane
    chose, after cmd_map's set-up (output sink, BAM re-encoder,
    checkpoints, insert histogram).  Returns the exit code."""
    from .map.pipeline import run_device_lane
    dev, plane = lane
    with _profiled(a.profdir, str(dev.device)):
        run_device_lane(dev, engine, a.reads, out, refset, fmt=fmt,
                        soft_clip="clip" not in mods, x_mismatch="x" in mods,
                        seed=(a.randseed if a.randseed is not None else 0),
                        fix_primary=fix_primary, ali_out=a.aliout,
                        mates_path=a.mates, plane=plane, ihist=ihist,
                        resume_log=resume_log)
    return 0


def _cmd_map_fast(a, argv: List[str], device: str) -> int:
    """map --fast: the port's device pass + the host traceback tail
    (with -n > 1 on that many worker processes, spawned: none of them
    touches the device), over a device mesh with --mesh, checkpoints
    with --resume, a torch profiler trace with --profile.  Under the
    SMALT_TPU_* variables of a multi-host run each host maps its stripe
    of batches into OUT.shard<host> (host 0 also writes OUT.header) for
    merge-shards, and --resume is off."""
    from .map.fastmode import mesh_shape, run_fast_pipeline
    if a.oformat.split(":")[0] != "sam":
        print("--fast emits SAM only", file=sys.stderr)
        return 1
    if _score_cap_refused(a.scorspec, 32):
        return 2
    if _no_gpu(device):
        return 1
    if a.mesh_spec is not None:
        import torch
        dev = torch.device(device)
        try:
            mesh_shape(a.mesh_spec, dev.type, torch.cuda.device_count()
                       if dev.type == "cuda" else 0)
        except ValueError as e:
            print(f"smalt_tpu_torch: {e}", file=sys.stderr)
            return 1
    refset = RefSet.load(a.index_name)
    idx = KmerIndex.load(a.index_name)
    exact_engine = None
    if a.fallback_exact:
        exact_engine, _, _ = _build_engine(a, argv)
    libcode = {"pe": pairs_mod.LIB_PAIREDEND,
               "mp": pairs_mod.LIB_MATEPAIR,
               "pp": pairs_mod.LIB_SAMESTRAND,
               None: pairs_mod.LIB_PAIREDEND}[a.pairtyp]
    ihist = InsHist.read(a.insfil) if a.insfil else None
    insert_min, insert_max = a.insertmin, a.insertmax
    if ihist is not None:
        insert_min = min(insert_min, ihist.insizlo)
        insert_max = max(insert_max, ihist.insizhi)
    from .parallel.distributed import (ShardWriter, end_distributed,
                                       maybe_init_distributed)
    host_id, n_hosts = maybe_init_distributed()
    shard_writer = resume_log = None
    try:
        if n_hosts > 1:
            # per-host SAM shard + batch sidecar; `merge-shards` restores
            # the single-host byte order afterwards
            base = a.oufilnam or "out.sam"
            shard_writer = ShardWriter(f"{base}.shard{host_id}", host_id,
                                       n_hosts)
            out = io.StringIO()     # header captured for the merge step
            _writer(a, refset, argv, out)
            if host_id == 0:
                with open(f"{base}.header", "w") as hf:
                    hf.write(out.getvalue())
        else:
            resume_state = None
            if a.resume and a.oufilnam and a.nthreads <= 1:
                from .resume import ResumeLog
                resume_log = ResumeLog(a.oufilnam, ["map-fast"] + argv)
                resume_state = resume_log.load()   # truncates OUT if found
            elif a.resume:
                print("# --resume needs -o and -n 1; ignored",
                      file=sys.stderr)
            if resume_state:
                out = open(a.oufilnam, "a")        # header already present
            else:
                out = _open_out(a)
                _writer(a, refset, argv, out)      # emits the SAM header
        batch = int(os.environ.get("SMALT_FAST_BATCH", "4096"))
        try:
            with _profiled(a.profdir, device):
                run_fast_pipeline(
                    refset, idx, a.reads, out, batch=batch,
                    penalties=_parse_penalties(a.scorspec),
                    minscor=(a.minscor if a.minscor is not None else 18),
                    nthreads=a.nthreads, device=device, mates_path=a.mates,
                    insert_min=insert_min, insert_max=insert_max,
                    exact_engine=exact_engine,
                    seed=(a.randseed if a.randseed is not None else 1),
                    mesh_spec=a.mesh_spec, libcode=libcode, ihist=ihist,
                    host_id=host_id, n_hosts=n_hosts,
                    shard_writer=shard_writer, resume_log=resume_log,
                    index_name=a.index_name)
        finally:
            if shard_writer is not None:
                shard_writer.close()
            elif out is not sys.stdout:
                out.close()
    finally:
        end_distributed()
    return 0


def cmd_merge_shards(argv: List[str]) -> int:
    """merge-shards OUT SHARD [SHARD...] (smalt_tpu/cli.py:520): join the
    per-host SAM shards of a multi-host `map --fast` run in global batch
    order (byte-identical to a single-host run), behind the OUT.header
    that host 0 wrote beside them."""
    ap = argparse.ArgumentParser(prog="smalt_tpu_torch merge-shards")
    ap.add_argument("-H", action=_HelpAction, dest="printhelp",
                    help="print these instructions")
    ap.add_argument("output")
    ap.add_argument("shards", nargs="+")
    a = ap.parse_args(argv)
    from .parallel.distributed import merge_shards
    header = None
    for s in a.shards:
        hdr_path = s.rsplit(".shard", 1)[0] + ".header"
        if os.path.exists(hdr_path):
            with open(hdr_path) as f:
                header = f.read()
            break
    with open(a.output, "w") as out:
        n = merge_shards(a.shards, out, header)
    print(f"# merged {n} batches from {len(a.shards)} shards",
          file=sys.stderr)
    return 0


def _profiled(profdir: Optional[str], device: str):
    """--profile DIR: torch.profiler over the block (the host's ops on
    every thread where this torch can record them all, the lanes' spans
    among them, and the card's kernels when the device is a card), its
    trace written under DIR as <host>_<pid>.<time>.pt.trace.json when the
    block ends.  Without DIR, a context that does nothing."""
    import contextlib
    if not profdir:
        return contextlib.nullcontext()
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(profdir, exist_ok=True)
    extra = {}
    try:
        extra["experimental_config"] = \
            torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        pass                    # this torch records the calling thread only
    return profile(activities=acts, on_trace_ready=(
        torch.profiler.tensorboard_trace_handler(profdir)), **extra)


def cmd_sample(argv: List[str]) -> int:
    """smalt sample (smalt.c:1253-1310): exhaustive-mode mapping of every
    readival-th pair (readival = nreads/4098 clamped by readskip,
    insert.c:192-205); SAM mappings of the sampled pairs stream to the
    output (headerless), followed by ASCII histograms and the text
    histogram that `map -g` reads back."""
    ap = _map_argparser("smalt_tpu_torch sample")
    ap.add_argument("-u", type=int, default=100, dest="readskip",
                    help="sample every u-th read pair (default 100)")
    a = ap.parse_args(argv)
    if not a.mates:
        print("sample requires paired reads", file=sys.stderr)
        return 1
    engine, refset, idx = _build_engine(a, argv, default_pairtyp="all")
    # checkSampleDefaults (menu.c:1231-1244): exhaustive mode
    engine.params.rmapflg |= (RMAPFLG_NOSHRTINFO | RMAPFLG_SENSITIVE |
                              RMAPFLG_ALLPAIR)
    nreads = sum(1 for _ in PairedReader(a.reads, a.mates))
    samp = InsSample()
    samp.set_read_interval(nreads, a.readskip)
    out = _open_out(a)
    writer = ReportWriter(out, refset, fmt="sam", soft_clip=True,
                          header=False)
    readno = 0
    for read, mate in PairedReader(a.reads, a.mates):
        if readno % samp.readival == 0:
            rep = Report()
            rsr, rsm, rpairs, pairflg = engine.rmap_pair(read, mate)
            add_pair_to_report(rep, None, rpairs, pairflg,
                               engine.params.rsltouflg, rsr, rsm)
            writer.write(rep, read, mate)
            isiz = _infer_insert(rsr, rsm)
            if isiz is not None:
                samp.add(isiz)
        readno += 1
    h = InsHist.from_sample(samp)
    if h is not None:
        out.write("# Sampled histogram\n")
        h.print_ascii(out, 80, is_smooth=False)
        out.write("# Smoothed histogram\n")
        h.print_ascii(out, 80, is_smooth=True)
        h.write(out, is_smooth=False)
    if out is not sys.stdout:
        out.close()
    return 0


def _infer_insert(rsr, rsm) -> Optional[int]:
    """resultSetInferInsertSize (results.c:2462-2489)."""
    if not rsr.sortr or not rsm.sortr:
        return None
    rp = rsr.sortr[0]
    mp = rsm.sortr[0]
    if rp.mapscor >= MAPSCOR_THRESH_CONFIDENT and \
       mp.mapscor >= MAPSCOR_THRESH_CONFIDENT and rp.sidx >= 0:
        isiz, flg = pairs_mod.calc_insert_size(rp, mp)
        # reference negates only when the flag is exactly REVERSE_1st
        # (results.c:2476)
        if flg == pairs_mod.PMF_REVERSE_1st:
            isiz = -isiz
        return isiz
    return None


def cmd_check(argv: List[str]) -> int:
    """smalt check (smalt.c:1432): validate read files, count reads."""
    ap = argparse.ArgumentParser(prog="smalt_tpu_torch check")
    ap.add_argument("-H", action=_HelpAction, dest="printhelp",
                    help="print these instructions")
    ap.add_argument("reads")
    ap.add_argument("mates", nargs="?", default=None)
    a = ap.parse_args(argv)
    n = 0
    if a.mates:
        for read, mate in PairedReader(a.reads, a.mates):
            n += 1
            if read.sam_name and mate.sam_name and \
               read.sam_name != mate.sam_name:
                print(f"WARNING: read names differ at pair {n}: "
                      f"{read.sam_name} vs {mate.sam_name}", file=sys.stderr)
        print(f"# {n} read pairs ok")
    else:
        for read in FastqReader(a.reads):
            n += 1
        print(f"# {n} reads ok")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
