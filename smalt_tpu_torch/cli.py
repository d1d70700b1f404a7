"""Command line of the PyTorch port.

    python -m smalt_tpu_torch.cli map --fast [--device cuda|cpu] [options]
        <index_name> <reads.fq> [<mates.fq>] > out.sam
    python -m smalt_tpu_torch.cli map --device-exact [--device cuda|cpu]
        [options] <index_name> <reads.fq> > out.sam
    python -m smalt_tpu_torch.cli index [-k wordlen] [-s step] <index_name>
        <ref.fa>

`map --fast` runs the port's device pass (one device; single-end reads,
or pairs with a mates file) and writes the same SAM as
`smalt_tpu map --fast`.  `map --device-exact` runs the exact engine's
front half (and, with SMALT_DX_P2=1, its pass 2) on one device for
serial single-end FASTQ and writes the SAM of the exact host lane, byte
for byte.  `--device` defaults to `cuda`; without a GPU that fails
rather than running on the CPU, and `--device cpu` exists for the
tests.  `map` without a device flag (the exact host lane) and the other
host-only subcommands run as smalt_tpu.cli runs them.  Options the port
does not take exit 2 naming their ROADMAP.md item.
"""
from __future__ import annotations

import os
import sys
from typing import List, Optional

from smalt_tpu import cli as ref_cli
from smalt_tpu.index.table import KmerIndex
from smalt_tpu.report.report import ReportWriter
from smalt_tpu.results import pairs as pairs_mod
from smalt_tpu.results.insert import InsHist
from smalt_tpu.seq.refset import RefSet


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "map":
        try:
            return cmd_map(argv[1:])
        except SystemExit as e:     # argparse --help / -H exit
            return int(e.code or 0)
    if argv and argv[0] == "merge-shards":
        return _unported("merge-shards (multi-host --fast)", "Queue 1 #8")
    return ref_cli.main(argv)


def _unported(what: str, item: str) -> int:
    print(f"smalt_tpu_torch: {what} is not ported yet (ROADMAP.md {item})",
          file=sys.stderr)
    return 2


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
    device, argv = _split_device(argv)
    a = ref_cli._map_argparser("smalt_tpu_torch map").parse_args(argv)
    if not a.fastmode:
        if a.device_pass1:
            return _unported("--device-pass1", "Queue 1 #5")
        if a.device_exact:
            return _cmd_map_device_exact(a, argv, device)
        return ref_cli.cmd_map(argv)
    return _cmd_map_fast(a, argv, device)


def _no_gpu(device: str) -> bool:
    import torch
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print("smalt_tpu_torch: --device cuda but no GPU is visible "
              "(--device cpu runs the plain torch path, for tests)",
              file=sys.stderr)
        return True
    return False


def _cmd_map_device_exact(a, argv: List[str], device: str) -> int:
    """map --device-exact: serial single-end FASTQ to SAM through the
    port's device-exact lane (smalt_tpu/cli.py:311-430 for that case)."""
    from .map.pipeline import run_device_exact_fastq
    fmt = a.oformat.split(":")[0]
    sam_in = a.informat in ("sam", "bam") or \
        a.reads.endswith((".sam", ".sam.gz", ".bam"))
    for bad, what, item in (
            (a.mates is not None, "--device-exact with a mates file",
             "Queue 1 #6a"),
            (fmt != "sam", f"--device-exact with -f {fmt}", "Queue 1 #6c"),
            (a.resume, "--resume with --device-exact", "Queue 1 #6d"),
            (a.nthreads > 1, "--device-exact with -n > 1", "Queue 1 #6e"),
            (sam_in, "--device-exact on SAM/BAM input", "Queue 1 #6e")):
        if bad:
            return _unported(what, item)
    if _no_gpu(device):
        return 1
    engine, refset, _ = ref_cli._build_engine(a, argv)
    out = ref_cli._open_out(a)
    try:
        mods = _sam_header(a, refset, argv, out)
        try:
            run_device_exact_fastq(
                engine, a.reads, out, refset, fmt="sam",
                soft_clip="clip" not in mods, x_mismatch="x" in mods,
                seed=(a.randseed if a.randseed is not None else 0),
                fix_primary=a.scorediff is not None, ali_out=a.aliout,
                device=device)
        except NotImplementedError as e:
            print(f"smalt_tpu_torch: {e}", file=sys.stderr)
            return 2
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def _sam_header(a, refset, argv: List[str], out) -> List[str]:
    """Write the SAM header of `map` to `out`; returns the -f modifiers."""
    mods = a.oformat.split(":")[1].split(",") if ":" in a.oformat else []
    ReportWriter(out, refset, fmt="sam", soft_clip="clip" not in mods,
                 x_mismatch="x" in mods, header="nohead" not in mods,
                 prog_args=["smalt_tpu_torch", "map"] + argv,
                 version=ref_cli.SMALT_VERSION)   # emits the SAM header
    return mods


def _cmd_map_fast(a, argv: List[str], device: str) -> int:
    """map --fast: the port's device pass + the host traceback tail."""
    from .map.fastmode import run_fast_pipeline
    if a.oformat.split(":")[0] != "sam":
        print("--fast emits SAM only", file=sys.stderr)
        return 1
    for bad, what, item in (
            (a.mesh_spec is not None, "--mesh", "Queue 1 #8"),
            (a.profdir is not None, "--profile", "Queue 1 #12"),
            (a.nthreads > 1, "-n > 1 with --fast", "Queue 1 #11"),
            (a.resume, "--resume with --fast", "Queue 1 #13")):
        if bad:
            return _unported(what, item)
    if _no_gpu(device):
        return 1
    refset = RefSet.load(a.index_name)
    idx = KmerIndex.load(a.index_name)
    exact_engine = None
    if a.fallback_exact:
        exact_engine, _, _ = ref_cli._build_engine(a, argv)
    libcode = {"pe": pairs_mod.LIB_PAIREDEND,
               "mp": pairs_mod.LIB_MATEPAIR,
               "pp": pairs_mod.LIB_SAMESTRAND,
               None: pairs_mod.LIB_PAIREDEND}[a.pairtyp]
    ihist = InsHist.read(a.insfil) if a.insfil else None
    insert_min, insert_max = a.insertmin, a.insertmax
    if ihist is not None:
        insert_min = min(insert_min, ihist.insizlo)
        insert_max = max(insert_max, ihist.insizhi)
    out = ref_cli._open_out(a)
    _sam_header(a, refset, argv, out)
    batch = int(os.environ.get("SMALT_FAST_BATCH", "4096"))
    try:
        run_fast_pipeline(refset, idx, a.reads, out, batch=batch,
                          penalties=ref_cli._parse_penalties(a.scorspec),
                          minscor=(a.minscor if a.minscor is not None
                                   else 18),
                          device=device, mates_path=a.mates,
                          insert_min=insert_min,
                          insert_max=insert_max, exact_engine=exact_engine,
                          seed=(a.randseed if a.randseed is not None else 1),
                          libcode=libcode, ihist=ihist)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
