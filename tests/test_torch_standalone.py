"""The port (smalt_tpu_torch) stands on its own: no file of it imports
smalt_tpu or jax, its host layers are byte-for-byte copies of the
reference's modules wherever nothing had to change, both packages read
and write the same index files, and the port's own CLI reproduces the
bundled SMALT 0.7.6 goldens with smalt_tpu and jax made unimportable.

Also the helpers the other tests/test_torch_*.py files use to hand the
same index to both packages (`port_refset`, `port_index`) and to run the
port's CLI in a process where smalt_tpu and jax cannot be imported
(`run_port_cli`)."""
import ast
import glob
import gzip
import io
import os
import subprocess
import sys

import numpy as np
import pytest

from smalt_tpu import rand as jrand
from smalt_tpu.index.table import KmerIndex as JKmerIndex
from smalt_tpu.map.engine import MapEngine as JMapEngine
from smalt_tpu.map.engine import MapParams as JMapParams
from smalt_tpu.map.pipeline import run_pipeline_raw_fastq as jrun_raw
from smalt_tpu.seq.refset import RefSet as JRefSet
from smalt_tpu_torch import rand as trand
from smalt_tpu_torch.index.table import KmerIndex as TKmerIndex
from smalt_tpu_torch.map.engine import MapEngine as TMapEngine
from smalt_tpu_torch.map.engine import MapParams as TMapParams
from smalt_tpu_torch.map.pipeline import run_pipeline_raw_fastq as trun_raw
from smalt_tpu_torch.seq.refset import RefSet as TRefSet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = os.path.join(REPO, "smalt_tpu"), os.path.join(REPO,
                                                          "smalt_tpu_torch")
DATA = os.path.join(REPO, "tests", "data")


# ------------------------------------------------------------------
# helpers shared with the other port tests
# ------------------------------------------------------------------

def port_refset(refset) -> TRefSet:
    """The port's RefSet over the arrays of a reference-package one."""
    return TRefSet(codes=refset.codes, offsets=refset.offsets,
                   names=list(refset.names))


def port_index(idx) -> TKmerIndex:
    """The port's KmerIndex over the arrays of a reference-package one."""
    return TKmerIndex(wordlen=idx.wordlen, nskip=idx.nskip, words=idx.words,
                      starts=idx.starts, pos=idx.pos, maxpos=idx.maxpos)


# Run before anything else in a child process: importing smalt_tpu or
# jax (or anything under them) raises, as if neither were installed.
BLOCK_REFERENCE = (
    "import sys\n"
    "class _NoReference:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in ('smalt_tpu', 'jax', 'jaxlib'):\n"
    "            raise ImportError(name + ' is blocked in this process')\n"
    "sys.meta_path.insert(0, _NoReference())\n")
# ... and after the run: neither got into the process another way.
ASSERT_NO_REFERENCE = (
    "bad = sorted(m for m in sys.modules\n"
    "             if m.split('.')[0] in ('smalt_tpu', 'jax', 'jaxlib'))\n"
    "assert not bad, bad\n")


def run_port_code(code: str, env_extra=None, argv=()):
    """`code` in a child process that can import the port only."""
    env = dict(os.environ, PYTHONPATH=REPO, **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "-c", BLOCK_REFERENCE + code + ASSERT_NO_REFERENCE,
         *argv], capture_output=True, text=True, env=env, cwd=REPO,
        timeout=600)


def run_port_cli(args, env_extra=None):
    """`python -m smalt_tpu_torch.cli <args>` in such a process."""
    return run_port_code(
        "from smalt_tpu_torch import cli\n"
        "rc = cli.main(sys.argv[1:])\n"
        "sys.stdout.flush()\n"
        + ASSERT_NO_REFERENCE + "sys.exit(rc)\n", env_extra, argv=args)


# ------------------------------------------------------------------
# (1) no import of smalt_tpu or jax, at any depth
# ------------------------------------------------------------------

PORT_FILES = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True)
) + ["chip_smoke.py"]


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call):
            # importlib.import_module("x") / __import__("x")
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else \
                getattr(f, "id", "")
            if name in ("import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


@pytest.mark.parametrize("rel", PORT_FILES)
def test_no_import_of_reference_or_jax(rel):
    with open(os.path.join(REPO, rel)) as f:
        tree = ast.parse(f.read(), rel)
    bad = [m for m in _imports(tree)
           if m.split(".")[0] in ("smalt_tpu", "jax", "jaxlib")]
    assert not bad, f"{rel} imports {bad}"


def test_static_check_sees_nested_imports():
    """The walker finds an import inside a function, a `from` import and
    an import by name."""
    src = ("def f():\n    import jax.numpy as jnp\n"
           "def g():\n    from smalt_tpu.seq import codec\n"
           "import importlib\nimportlib.import_module('smalt_tpu.cli')\n"
           "from . import rand\nimport smalt_tpu_torch.rand\n")
    assert sorted(_imports(ast.parse(src))) == [
        "importlib", "jax.numpy", "smalt_tpu.cli", "smalt_tpu.seq",
        "smalt_tpu_torch.rand"]


# ------------------------------------------------------------------
# (2) the copies are copies
# ------------------------------------------------------------------

VERBATIM = [
    "native/swdp.c", "native/mapcore.c",
    "seq/__init__.py", "seq/codec.py", "seq/io.py", "seq/refset.py",
    "rand.py", "sort_nr.py", "resume.py",
    "index/__init__.py", "index/table.py",
    "seed/__init__.py", "seed/hitinfo.py", "seed/hitlist.py",
    "segment/__init__.py", "segment/collate.py",
    "align/__init__.py", "align/core.py", "align/band.py",
    "align/diffstr.py",
    "results/__init__.py", "results/result.py", "results/pairs.py",
    "results/insert.py",
    "report/__init__.py", "report/report.py", "report/bam.py",
    "tools/__main__.py", "tools/readutils.py", "tools/sam.py",
    "tools/simread.py",
    "map/__init__.py", "map/engine.py",
]

# Modules of the same name that differ on purpose, and why.  Each keeps a
# part of the reference verbatim: (start marker, end marker) of a span of
# the reference's text that must appear unchanged in the port's file.
CHANGED = {
    "native/__init__.py": (
        "the library is built under a file lock to a temporary name and "
        "moved into place, so that processes importing the package at "
        "once never load a half-written file",
        ("def _declare(lib):", "def _load():")),
    "native/fastlane.c": (
        "the profiler's slots hold one quantity each, under names, and "
        "time the host re-mapping of re-staged reads; the post block "
        "counts each re-stage's cause where the lane fetches it, in "
        "place of a debug print; the pre block gives a read with a lane "
        "past H its lanes' hit counts, and its keys to the repeat "
        "tier's arrays where they fit",
        ("/* setupInterValFromResultSet", "int64_t fl_map_pair_block(")),
    "tools/__init__.py": (
        "the usage line names this package", ("tools: simread", "\"\"\"")),
    "map/pipeline.py": (
        "the device branches of run_pipeline_raw_fastq / _pairs move to "
        "device_lane (the reference's order of lanes, chosen before any "
        "device call) and run_device_lane / run_device_fastq / "
        "run_device_exact_pairs",
        ("def _render_block(args):", "def run_pipeline_raw_fastq(")),
    "map/fastmode.py": (
        "the host half is the reference's; run_fast_pipeline drives the "
        "port's torch step",
        ("def iter_fastq_batches(", "def run_fast_pipeline(")),
    "map/fastlane.py": (
        "FastLane and PairLane are the reference's; DevicePass1 keeps the "
        "host halves only; DeviceExact runs the port's torch steps",
        ("class FastLane:", "class DevicePass1:")),
    "cli.py": (
        "--device, the port's --fast (over a mesh, over several hosts), "
        "--device-exact and --device-pass1 lanes, the program's name",
        ("def _parse_penalties(", "def _sam_is_paired(")),
    "parallel/distributed.py": (
        "the rendezvous of a multi-host run joins a torch.distributed "
        "group (gloo) on the reference's SMALT_TPU_* variables in place "
        "of jax.distributed; the shard writer and the merge are the "
        "reference's",
        ("class ShardWriter:", "    return len(merged)")),
}


def _bytes(root, rel):
    with open(os.path.join(root, rel), "rb") as f:
        return f.read()


@pytest.mark.parametrize("rel", VERBATIM)
def test_copied_module_equals_reference(rel):
    assert _bytes(PORT, rel) == _bytes(REF, rel), (
        f"smalt_tpu_torch/{rel} differs from smalt_tpu/{rel}: copy it "
        "again, or list it in CHANGED with the reason")


@pytest.mark.parametrize("rel", sorted(CHANGED))
def test_changed_module_keeps_reference_span(rel):
    why, (start, end) = CHANGED[rel]
    assert why
    ref = _bytes(REF, rel).decode()
    a = ref.index(start)
    span = ref[a: ref.index(end, a + len(start))].rstrip()
    assert len(span) > 40
    assert span in _bytes(PORT, rel).decode(), (rel, start)


def test_every_shared_module_is_accounted_for():
    """Every file the two packages have under one name is either a
    verbatim copy or listed as changed on purpose (the device modules,
    whose counterparts are JAX code, aside)."""
    device = {"__init__.py", "parallel/__init__.py", "parallel/mesh.py",
              "parallel/exact_collate.py", "parallel/exact_pass2.py",
              "ops/__init__.py", "ops/sw.py"}
    shared = set()
    for ext in ("*.py", "*.c"):
        for p in glob.glob(os.path.join(PORT, "**", ext), recursive=True):
            rel = os.path.relpath(p, PORT)
            if os.path.exists(os.path.join(REF, rel)):
                shared.add(rel)
    assert shared - device == set(VERBATIM) | set(CHANGED)


# ------------------------------------------------------------------
# (3) one index format
# ------------------------------------------------------------------

@pytest.fixture(scope="module")
def reads_se(tmp_path_factory):
    fq = tmp_path_factory.mktemp("se") / "reads_se.fq"
    with gzip.open(os.path.join(DATA, "reads_se.fq.gz"), "rb") as f:
        # the first 300 reads keep the two host runs short
        fq.write_bytes(b"".join(f.readlines()[:1200]))
    return str(fq)


def _host_sam(which, refset, idx, fq):
    buf = io.StringIO()
    if which == "ref":
        jrand.ranseed(1)
        assert jrun_raw(JMapEngine(refset, idx, JMapParams()), fq, buf,
                        refset)
    else:
        trand.ranseed(1)
        assert trun_raw(TMapEngine(refset, idx, TMapParams()), fq, buf,
                        refset)
    return buf.getvalue()


@pytest.mark.parametrize("saver", ["ref", "port"])
def test_index_saved_by_one_loads_in_the_other(tmp_path, reads_se, saver):
    fa = os.path.join(DATA, "genome.fa")
    name = str(tmp_path / "idx")
    if saver == "ref":
        from smalt_tpu.index.table import build_index
        refset = JRefSet.from_fasta(fa)
        idx = build_index(refset, 13, 4)
        Other_R, Other_I, mine, other = TRefSet, TKmerIndex, "ref", "port"
    else:
        from smalt_tpu_torch.index.table import build_index
        refset = TRefSet.from_fasta(fa)
        idx = build_index(refset, 13, 4)
        Other_R, Other_I, mine, other = JRefSet, JKmerIndex, "port", "ref"
    refset.save(name)
    idx.save(name)
    r2, i2 = Other_R.load(name), Other_I.load(name)
    assert type(r2) is Other_R and type(i2) is Other_I
    assert r2.names == refset.names
    for a, b in ((r2.codes, refset.codes), (r2.offsets, refset.offsets),
                 (i2.words, idx.words), (i2.starts, idx.starts),
                 (i2.pos, idx.pos)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert (i2.wordlen, i2.nskip, i2.maxpos) == (idx.wordlen, idx.nskip,
                                                 idx.maxpos)
    want = _host_sam(mine, refset, idx, reads_se)
    got = _host_sam(other, r2, i2, reads_se)
    assert len(want.splitlines()) == 300
    assert got == want


# ------------------------------------------------------------------
# the port's own CLI against the SMALT 0.7.6 goldens, reference blocked
# ------------------------------------------------------------------

def _golden(name):
    path = os.path.join(DATA, name)
    opener = gzip.open if name.endswith(".gz") else open
    with opener(path, "rt") as f:
        return [ln for ln in f.read().splitlines() if not ln.startswith("@")]


@pytest.fixture(scope="module")
def port_index_prefix(tmp_path_factory):
    pref = str(tmp_path_factory.mktemp("pidx") / "idx")
    r = run_port_cli(["index", "-k", "13", "-s", "4", pref,
                      os.path.join(DATA, "genome.fa")])
    assert r.returncode == 0, r.stderr
    return pref


@pytest.mark.parametrize("opts,reads,golden", [
    ([], ["reads_se.fq.gz"], "golden_se_r1.sam.gz"),
    ([], ["reads_pe_1.fq", "reads_pe_2.fq"], "golden_pe_r1.sam"),
    (["-d", "5"], ["reads_se.fq.gz"], "golden_se_r1_d5.sam.gz"),
    (["-f", "cigar"], ["reads_se.fq.gz"], "golden_se_r1_cigar.out.gz"),
    (["-l", "mp"], ["reads_pe_1.fq", "reads_pe_2.fq"],
     "golden_pe_r1_mp.sam.gz"),
    (["-p"], ["reads_split.fq"], "golden_split.sam.gz"),
])
def test_port_cli_host_map_equals_golden(port_index_prefix, tmp_path, opts,
                                         reads, golden):
    out = str(tmp_path / "out.txt")
    r = run_port_cli(["map", "-r", "1", "-o", out] + opts +
                     [port_index_prefix] +
                     [os.path.join(DATA, x) for x in reads])
    assert r.returncode == 0, r.stderr
    with open(out) as f:
        got = [ln for ln in f.read().splitlines() if not ln.startswith("@")]
    want = _golden(golden)
    assert len(want) >= 200
    assert got == want


def test_port_cli_sample_and_check(port_index_prefix, tmp_path):
    out = str(tmp_path / "hist.txt")
    pe = [os.path.join(DATA, x) for x in ("reads_pe_1.fq", "reads_pe_2.fq")]
    r = run_port_cli(["sample", "-o", out, port_index_prefix] + pe)
    assert r.returncode == 0, r.stderr
    with open(out) as f, open(os.path.join(DATA, "golden_sample.txt")) as g:
        assert f.read().splitlines() == g.read().splitlines()
    r = run_port_cli(["check"] + pe)
    assert r.returncode == 0 and r.stdout.strip() == "# 120 read pairs ok"


def test_port_cli_version_and_merge_shards(tmp_path):
    """`version`, and `merge-shards` joining two hosts' shards behind the
    header host 0 wrote, in a process that cannot import smalt_tpu."""
    r = run_port_cli(["version"])
    assert r.returncode == 0 and r.stdout.startswith("smalt_tpu_torch ")
    from smalt_tpu_torch.parallel.distributed import ShardWriter
    paths = []
    for h in range(2):
        paths.append(str(tmp_path / f"o.sam.shard{h}"))
        sw = ShardWriter(paths[-1], h, 2)
        for b in range(h, 5, 2):
            sw.write_batch(b, f"r{b}\n")
        sw.close()
    (tmp_path / "o.sam.header").write_text("@HD\tVN:1.4\n")
    out = str(tmp_path / "merged.sam")
    r = run_port_cli(["merge-shards", out] + paths)
    assert r.returncode == 0, r.stderr
    assert "# merged 5 batches from 2 shards" in r.stderr
    with open(out) as f:
        assert f.read() == "@HD\tVN:1.4\n" + "".join(
            f"r{b}\n" for b in range(5))


def test_native_library_is_the_ports_own():
    """Each package loads the library built in its own directory."""
    from smalt_tpu import native as jn
    from smalt_tpu_torch import native as tn
    assert os.path.dirname(tn._SO) == os.path.join(PORT, "native")
    assert os.path.dirname(jn._SO) == os.path.join(REF, "native")
    lib = tn.get_lib()
    assert lib is not None and lib is not jn.get_lib()
    assert os.path.exists(tn._SO) and tn._fresh()


def test_native_build_replaces_atomically(tmp_path, monkeypatch):
    """_build compiles to a temporary name and moves it into place: a
    stale library is replaced, no temporary file stays behind, and a
    second call finds the library fresh and compiles nothing."""
    from smalt_tpu_torch import native as tn
    srcs = []
    for s in tn._SRCS:
        dst = tmp_path / os.path.basename(s)
        dst.write_bytes(open(s, "rb").read())
        srcs.append(str(dst))
    so = str(tmp_path / "_lib.so")
    monkeypatch.setattr(tn, "_SRCS", srcs)
    monkeypatch.setattr(tn, "_SO", so)
    assert not tn._fresh()
    tn._build()
    assert tn._fresh()
    assert sorted(os.listdir(tmp_path)) == sorted(
        [os.path.basename(s) for s in srcs] + ["_lib.so", "_lib.so.lock"])
    calls = []
    monkeypatch.setattr(tn.subprocess, "run",
                        lambda *a, **k: calls.append(a))
    tn._build()
    assert not calls
