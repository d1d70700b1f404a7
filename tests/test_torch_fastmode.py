"""`map --fast` through the port (smalt_tpu_torch) against smalt_tpu on the
CPU: byte-identical SAM from run_fast_pipeline and from the two CLIs,
for short single-end reads, kilobase reads (the banded kernel) and
pairs; unported options refused with their ROADMAP item, and neither
smalt_tpu nor jax in a process that runs the port.  Each package works
on objects of its own over the same arrays; every run of the port's CLI
is made in a process where smalt_tpu and jax cannot be imported."""
import io
import os
import subprocess
import sys

import numpy as np
import pytest

from smalt_tpu.index.table import build_index
from smalt_tpu.map import fastmode as jfast
from smalt_tpu.seq import codec
from smalt_tpu.seq.refset import RefSet
from smalt_tpu_torch.map import fastmode as tfast
from test_torch_mesh import jax_band_oracle  # noqa: F401  (fixture)
from test_torch_standalone import (port_index, port_refset, run_port_cli,
                                   run_port_code)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def simulated(tmp_path_factory, indexed):
    """The test_fastmode.py corpus: 200 reads of 80 bp, 2% substitutions,
    every second one reverse-complemented."""
    refset, idx = indexed
    rng = np.random.default_rng(5)
    n, qlen = 200, 80
    lines = []
    for i in range(n):
        st = int(rng.integers(0, refset.total_len - qlen))
        seg = list(codec.decode(refset.codes[st : st + qlen]).decode())
        for j in np.flatnonzero(rng.random(qlen) < 0.02):
            seg[j] = "ACGT"[int(rng.integers(0, 4))]
        s = "".join(seg)
        if i % 2 == 1:
            s = s.translate(str.maketrans("ACGT", "TGCA"))[::-1]
        lines.append(f"@r{i}\n{s}\n+\n{'I' * qlen}\n")
    d = tmp_path_factory.mktemp("tfast")
    fq = os.path.join(d, "reads.fq")
    with open(fq, "w") as f:
        f.write("".join(lines))
    return refset, idx, fq, d


def _port_run(refset, idx, fq, out, **kw):
    """The port's pipeline on its own RefSet / KmerIndex over the arrays
    of the reference package's (cached on `idx`, as the step is)."""
    own = idx.__dict__.setdefault(
        "_port_objects", (port_refset(refset), port_index(idx)))
    tfast.run_fast_pipeline(*own, fq, out, device="cpu", **kw)


def _both(refset, idx, fq, batch, exact=False, **kw):
    """SAM of the JAX pipeline and of the port's; `exact`: each with an
    exact engine of its own package for --fallback-exact."""
    want = io.StringIO()
    jkw, tkw = dict(kw), dict(kw)
    if exact:
        from smalt_tpu.map.engine import MapEngine, MapParams
        from smalt_tpu_torch.map import engine as teng
        jkw["exact_engine"] = MapEngine(refset, idx, MapParams())
        tkw["exact_engine"] = teng.MapEngine(
            port_refset(refset), port_index(idx), teng.MapParams())
    jfast.run_fast_pipeline(refset, idx, fq, want, nthreads=1, batch=batch,
                            interpret=True, **jkw)
    got = io.StringIO()
    _port_run(refset, idx, fq, got, nthreads=1, batch=batch, **tkw)
    return want.getvalue(), got.getvalue()


def test_pipeline_sam_identical(simulated):
    refset, idx, fq, _ = simulated
    want, got = _both(refset, idx, fq, 64)
    assert len(got.splitlines()) == 200
    assert got == want


def test_pipeline_fallback_exact_identical(simulated):
    """--fallback-exact is host-only: it passes straight to the tail."""
    refset, idx, fq, _ = simulated
    want, got = _both(refset, idx, fq, 64, exact=True)
    assert got == want


def test_contig_boundary_identical(tmp_path):
    """Reads at contig ends, both strands (test_fastmode.py:217): the
    clamped windows and SAM must match the JAX pipeline."""
    rng = np.random.default_rng(17)
    bases = np.array(list(b"ACGT"), np.uint8)
    contigs = [rng.choice(bases, n).tobytes().decode()
               for n in (3000, 2500, 3500)]
    fa = tmp_path / "g.fa"
    with open(fa, "w") as f:
        for i, c in enumerate(contigs):
            f.write(f">c{i}\n")
            for j in range(0, len(c), 60):
                f.write(c[j : j + 60] + "\n")
    refset = RefSet.from_fasta(str(fa))
    idx = build_index(refset, 11, 2)
    qlen = 80
    recs = []
    comp = str.maketrans("ACGT", "TGCA")
    for i, c in enumerate(contigs):
        for off in (0, 3, 7, 11):
            s = c[len(c) - qlen - off : len(c) - off]
            recs.append(f"@e{i}_{off}f\n{s}\n+\n{'I' * qlen}\n")
            recs.append(f"@e{i}_{off}r\n"
                        f"{s.translate(comp)[::-1]}\n+\n{'I' * qlen}\n")
            s2 = c[off : off + qlen]
            recs.append(f"@b{i}_{off}f\n{s2}\n+\n{'I' * qlen}\n")
    fq = tmp_path / "r.fq"
    fq.write_text("".join(recs))
    want, got = _both(refset, idx, str(fq), 32)
    assert sum(1 for ln in got.splitlines()
               if not int(ln.split("\t")[1]) & 4) >= 30
    assert got == want


@pytest.mark.parametrize("kw,item", [
    # explicit ids: the cases keep their names.  Every option is ported
    # (item None): two hosts (their shards merged), a mesh, the tail pool
    # and --resume each write the SAM of the plain run
    # (tests/test_torch_mesh_sharded.py, tests/test_torch_multihost.py and
    # tests/test_torch_fast_driver.py have the rest)
    pytest.param({"n_hosts": 2}, None, id="kw0-Queue 1 #8"),
    pytest.param({"mesh_spec": "2,1"}, None, id="kw1-Queue 1 #8"),
    pytest.param({"nthreads": 2}, None, id="kw2-Queue 1 #11"),
    pytest.param({"resume_log": "-o"}, None, id="kw3-Queue 1 #13"),
])
def test_pipeline_unported_options_raise(simulated, kw, item, tmp_path):
    refset, idx, fq, _ = simulated
    if "n_hosts" in kw:
        from smalt_tpu_torch.parallel.distributed import (ShardWriter,
                                                          merge_shards)
        want, got = io.StringIO(), io.StringIO()
        _port_run(refset, idx, fq, want, batch=64)
        paths = [str(tmp_path / f"o.sam.shard{h}") for h in range(2)]
        for h, p in enumerate(paths):
            sw = ShardWriter(p, h, 2)
            _port_run(refset, idx, fq, None, batch=64, host_id=h, n_hosts=2,
                      shard_writer=sw)
            sw.close()
        assert merge_shards(paths, got) == 4
        assert got.getvalue() == want.getvalue()
        return
    if item is None:
        if "resume_log" in kw:
            from smalt_tpu_torch.resume import ResumeLog
            kw = {"resume_log": ResumeLog(str(tmp_path / "o.sam"), ["map"])}
        elif "nthreads" in kw:  # the pool's workers load the index by name
            name = str(tmp_path / "idx")
            refset.save(name)
            idx.save(name)
            kw = dict(kw, index_name=name)
        want, got = io.StringIO(), io.StringIO()
        _port_run(refset, idx, fq, want, batch=64)
        _port_run(refset, idx, fq, got, batch=64, **kw)
        assert len(got.getvalue().splitlines()) == 200
        assert got.getvalue() == want.getvalue()
        return
    with pytest.raises(NotImplementedError, match=item):
        _port_run(refset, idx, fq, io.StringIO(), **kw)


@pytest.fixture(scope="module")
def kilobase(tmp_path_factory):
    """tests/test_longread_concordance.py:34-59's corpus: 16 reads of
    900-1,400 bp (2% substitutions, 1.5% indels) on a 200 kb genome,
    k13 s4."""
    d = tmp_path_factory.mktemp("tlong")
    rng = np.random.default_rng(19)
    L = 200_000
    g = rng.choice(np.array(list(b"ACGT"), np.uint8), L).tobytes().decode()
    fa = d / "g.fa"
    fa.write_text(">lg\n" + "\n".join(g[i:i + 60]
                                      for i in range(0, L, 60)) + "\n")
    comp = str.maketrans("ACGT", "TGCA")
    recs = []
    for i in range(16):
        RL = int(rng.integers(900, 1400))
        st = int(rng.integers(0, L - RL - 200))
        out = []
        for ch in g[st:st + RL]:
            r = rng.random()
            if r < 0.0075:
                continue
            if r < 0.015:
                out.append("ACGT"[int(rng.integers(0, 4))])
            if rng.random() < 0.02:
                ch = "ACGT"[int(rng.integers(0, 4))]
            out.append(ch)
        s = "".join(out)
        if i % 2:
            s = s.translate(comp)[::-1]
        recs.append(f"@L{i}\n{s}\n+\n{'I' * len(s)}\n")
    fq = d / "r.fq"
    fq.write_text("".join(recs))
    refset = RefSet.from_fasta(str(fa))
    return refset, build_index(refset, 13, 4), str(fq), d


def test_long_reads_sam_identical(kilobase, jax_band_oracle):
    refset, idx, fq, _ = kilobase
    want, got = _both(refset, idx, fq, 16)
    body = got.splitlines()
    assert len(body) == 16
    assert sum(1 for ln in body if not int(ln.split("\t")[1]) & 4) >= 14
    assert got == want


QLEN_PE, INSERT_PE = 80, 300


def _pe_world(d, seed=53, n=20, orient="pe"):
    """tests/test_fast_pe.py's corpus: a 20 kb genome (k11 s2) and n
    fragments of 300 bp read as 2 x 80 bp in pe (fwd + revcomp), mp
    (revcomp + fwd) or pp (fwd + fwd) orientation."""
    rng = np.random.default_rng(seed)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, 20000))
    fa = os.path.join(d, "g.fa")
    with open(fa, "w") as f:
        f.write(">g\n" + "".join(genome[j : j + 60] + "\n"
                                 for j in range(0, len(genome), 60)))
    refset = RefSet.from_fasta(fa)
    idx = build_index(refset, 11, 2)
    comp = str.maketrans("ACGT", "TGCA")
    r1, r2 = [], []
    for i in range(n):
        st = int(rng.integers(0, len(genome) - INSERT_PE))
        frag = genome[st : st + INSERT_PE]
        a, b = frag[:QLEN_PE], frag[-QLEN_PE:]
        if orient == "pe":
            b = b.translate(comp)[::-1]
        elif orient == "mp":
            a = a.translate(comp)[::-1]
        r1.append(f"@p{i}\n{a}\n+\n{'I' * QLEN_PE}\n")
        r2.append(f"@p{i}\n{b}\n+\n{'I' * QLEN_PE}\n")
    fq1, fq2 = os.path.join(d, f"{orient}_1.fq"), os.path.join(d, f"{orient}_2.fq")
    with open(fq1, "w") as f:
        f.write("".join(r1))
    with open(fq2, "w") as f:
        f.write("".join(r2))
    return refset, idx, fq1, fq2


@pytest.mark.parametrize("orient", ["pe", "mp", "pp"])
def test_pairs_sam_identical(tmp_path, orient):
    from smalt_tpu.results.pairs import (LIB_MATEPAIR, LIB_PAIREDEND,
                                         LIB_SAMESTRAND)
    libcode = {"pe": LIB_PAIREDEND, "mp": LIB_MATEPAIR,
               "pp": LIB_SAMESTRAND}[orient]
    refset, idx, fq1, fq2 = _pe_world(str(tmp_path), orient=orient)
    want, got = _both(refset, idx, fq1, 32, mates_path=fq2, insert_min=0,
                      insert_max=500, libcode=libcode)
    body = got.splitlines()
    assert len(body) == 40
    assert sum(1 for ln in body if int(ln.split("\t")[1]) & 2) >= 36
    assert got == want


def test_pairs_batch_split_identical(tmp_path):
    """Pairs split over several padded batches (batch 8 of 20 pairs)
    give the SAM of one batch: pairs are mapped independently."""
    refset, idx, fq1, fq2 = _pe_world(str(tmp_path))
    outs = []
    for batch in (8, 32):
        buf = io.StringIO()
        _port_run(refset, idx, fq1, buf, batch=batch, mates_path=fq2)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] and len(outs[0].splitlines()) == 40


def test_pairs_unequal_mate_files_raise(tmp_path):
    refset, idx, fq1, fq2 = _pe_world(str(tmp_path))
    short = tmp_path / "short.fq"
    short.write_text("".join(open(fq2).readlines()[:-8]))
    with pytest.raises(ValueError, match="mate files differ"):
        _port_run(refset, idx, fq1, io.StringIO(), batch=32,
                  mates_path=str(short))


def _run(args, env_extra=None, **kw):
    env = dict(os.environ, SMALT_FAST_BATCH="64", PYTHONPATH=REPO,
               JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=600, **kw)


@pytest.fixture(scope="module")
def saved_index(simulated):
    refset, idx, fq, d = simulated
    name = os.path.join(d, "idx")
    refset.save(name)
    idx.save(name)
    return name, fq


def _body(sam):
    return [ln for ln in sam.splitlines() if not ln.startswith("@PG")]


def test_cli_matches_jax_cli(saved_index):
    name, fq = saved_index
    got = run_port_cli(["map", "--fast", "--device", "cpu", name, fq],
                       {"SMALT_FAST_BATCH": "64"})
    assert got.returncode == 0, got.stderr
    want = _run(["-m", "smalt_tpu.cli", "map", "--fast", name, fq])
    assert want.returncode == 0, want.stderr
    assert got.stdout.startswith("@HD")
    assert len([ln for ln in got.stdout.splitlines()
                if not ln.startswith("@")]) == 200
    assert _body(got.stdout) == _body(want.stdout)


@pytest.fixture(scope="module")
def saved_pairs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tpe"))
    refset, idx, fq1, fq2 = _pe_world(d, seed=61, n=40)
    name = os.path.join(d, "idx")
    refset.save(name)
    idx.save(name)
    return name, fq1, fq2


def test_cli_pairs_match_jax_cli(saved_pairs):
    name, fq1, fq2 = saved_pairs
    got = run_port_cli(["map", "--fast", "--device", "cpu", name, fq1, fq2],
                       {"SMALT_FAST_BATCH": "64"})
    assert got.returncode == 0, got.stderr
    want = _run(["-m", "smalt_tpu.cli", "map", "--fast", name, fq1, fq2])
    assert want.returncode == 0, want.stderr
    assert len([ln for ln in got.stdout.splitlines()
                if not ln.startswith("@")]) == 80
    assert _body(got.stdout) == _body(want.stdout)


@pytest.mark.parametrize("extra,item", [
    # explicit ids: a case keeps its name when cases are added or removed
    # (--device-exact with mates maps: tests/test_torch_exact_pe.py).
    # Ported options map (item None): --mesh, --profile and -n 2 with
    # --fast write the SAM of `map --fast` without them
    # (tests/test_torch_mesh_sharded.py and tests/test_torch_fast_driver.py
    # have the rest; the trace goes to a directory of the test's), and
    # --device-pass1 the SAM of `map` without the flag
    # (tests/test_torch_pass1.py has the rest)
    pytest.param(["--fast", "--mesh", "2,1"], None, id="extra0-Queue 1 #8"),
    pytest.param(["--fast", "--profile", "PROFDIR"], None,
                 id="extra1-Queue 1 #12"),
    pytest.param(["--fast", "-n", "2"], None, id="extra2-Queue 1 #11"),
    pytest.param(["--device-pass1", "-r", "1"], None,
                 id="extra4-Queue 1 #5"),
])
def test_cli_unported_options_exit_nonzero(saved_index, extra, item, capsys,
                                           monkeypatch, tmp_path):
    from smalt_tpu_torch import cli
    name, fq = saved_index
    extra = [str(tmp_path / "prof") if x == "PROFDIR" else x for x in extra]
    fast = extra[0] == "--fast"
    if item is None:
        monkeypatch.setenv("SMALT_DP1_BATCH", "64")
        assert cli.main(["map", "-r", "1", name, fq] if not fast else
                        ["map", "--fast", "--device", "cpu", name, fq]) == 0
        want = _body(capsys.readouterr().out)
    rc = cli.main(["map"] + extra + ["--device", "cpu", name, fq])
    if item is None:
        got = capsys.readouterr()
        assert rc == 0 and _body(got.out) == want
        assert len([ln for ln in want if ln[:1] != "@"]) == 200
        if not fast:
            assert got.err == ""             # the lane the flag names ran
        return
    assert rc == 2
    assert f"ROADMAP.md {item})" in capsys.readouterr().err


@pytest.mark.parametrize("spec,rng", [("match=200", "-202..200"),
                                      ("subst=-129", "-130..1"),
                                      ("match=100,subst=-29", "-129..100")])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_cli_matrix_outside_int8_exits_2(simulated, saved_index, tmp_path,
                                         capsys, device, spec, rng):
    """A -S that gives the matrix an entry outside -128..127 maps as
    smalt_tpu maps it: on the CPU the port's CLI writes the SAM body of
    smalt_tpu's pipeline with the same penalties, byte for byte; on a
    card it writes the CPU run's SAM.  With no card visible the cuda
    case gets past every host check and stops at the device check
    (exit 1), as an int8 matrix does."""
    from smalt_tpu_torch import cli
    from smalt_tpu_torch.align.core import make_score_matrix
    refset, idx, reads, _ = simulated
    name, _ = saved_index
    fq = str(tmp_path / "head.fq")       # the corpus's first 64 reads
    with open(reads) as f, open(fq, "w") as g:
        g.writelines(f.readlines()[:4 * 64])
    pen = cli._parse_penalties(spec)
    m = make_score_matrix(*pen)[0]
    assert f"{int(m.min())}..{int(m.max())}" == rng
    os.environ["SMALT_FAST_BATCH"] = "64"
    try:
        out = str(tmp_path / f"{device}.sam")
        rc = cli.main(["map", "--fast", "--device", device, "-S", spec,
                       "-o", out, name, fq])
        if device == "cuda":
            import torch
            if not torch.cuda.is_available():
                assert rc == 1
                assert "no GPU is visible" in capsys.readouterr().err
                return
            want = str(tmp_path / "cpu.sam")
            assert cli.main(["map", "--fast", "--device", "cpu", "-S", spec,
                             "-o", want, name, fq]) == 0
            assert rc == 0 and _body(open(out).read()) == \
                _body(open(want).read())
            return
    finally:
        os.environ.pop("SMALT_FAST_BATCH")
    assert rc == 0
    buf = io.StringIO()
    jfast.run_fast_pipeline(refset, idx, fq, buf, penalties=pen, nthreads=1,
                            batch=64, interpret=True)
    got = [ln for ln in open(out).read().splitlines() if ln[:1] != "@"]
    assert len(got) == 64 and got == buf.getvalue().splitlines()


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_cli_matrix_past_score_cap_exits_2(tmp_path, capsys, device):
    """What stays refused: a matrix whose window of the shortest padded
    query (32 columns) would overflow the kernels' int32 DP (2^30, ops/sw.py
    check_score_cap) exits 2 with one line naming the limit, on every
    device and before the index is opened (none exists here).  (A match
    of 262,144 passes since windows that score 2^23 map.)"""
    from smalt_tpu_torch import cli
    rc = cli.main(["map", "--fast", "--device", device, "-S",
                   "match=33554432", str(tmp_path / "no_index"),
                   str(tmp_path / "no_reads.fq")])
    err = capsys.readouterr().err
    assert rc == 2
    assert err.count("\n") == 1 and "2^30" in err and "33554432" in err


def test_cli_matrix_at_int8_ends_maps(saved_index):
    """-128 and 127 themselves pass (match 127, subst -1: X scores -128)."""
    name, fq = saved_index
    r = run_port_cli(["map", "--fast", "--device", "cpu", "-S",
                      "match=127,subst=-1", name, fq])
    assert r.returncode == 0, r.stderr
    assert len([ln for ln in r.stdout.splitlines()
                if not ln.startswith("@")]) > 0


def test_cli_cuda_without_gpu_fails(saved_index):
    """--device cuda (the default) never falls back to the CPU."""
    name, fq = saved_index
    r = run_port_cli(["map", "--fast", name, fq],
                     {"SMALT_FAST_BATCH": "64", "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert not [ln for ln in r.stdout.splitlines()
                if ln and not ln.startswith("@")]


@pytest.mark.parametrize("what", ["single", "long", "pairs", "exact",
                                  "host"])
def test_port_never_imports_jax(saved_index, kilobase, saved_pairs, what,
                                tmp_path):
    """A run of the port imports only the port — no module named
    smalt_tpu or jax, or under them, is in sys.modules afterwards, and
    importing one would have raised: short single-end reads, kilobase
    reads (the banded path and the long-read host tail), pairs (the
    pair tail), the device-exact lane with device pass 2, and `index` +
    host `map` through the CLI against the SMALT 0.7.6 golden."""
    if what == "host":
        data = os.path.join(REPO, "tests", "data")
        name, out = str(tmp_path / "idx"), str(tmp_path / "se.sam")
        r = run_port_cli(["index", "-k", "13", "-s", "4", name,
                          os.path.join(data, "genome.fa")])
        assert r.returncode == 0, r.stderr
        r = run_port_cli(["map", "-f", "sam", "-r", "1", "-o", out, name,
                          os.path.join(data, "reads_se.fq.gz")])
        assert r.returncode == 0, r.stderr
        import gzip
        with gzip.open(os.path.join(data, "golden_se_r1.sam.gz"), "rt") as f:
            want = [ln for ln in f.read().splitlines()
                    if not ln.startswith("@")]
        with open(out) as f:
            got = [ln for ln in f.read().splitlines()
                   if not ln.startswith("@")]
        assert len(got) == 2000 and got == want
        return
    if what == "exact":
        name, fq = saved_index
        code = (
            "import io, os\n"
            "os.environ['SMALT_DX_P2'] = '1'\n"
            "from smalt_tpu_torch.seq.refset import RefSet\n"
            "from smalt_tpu_torch.index.table import KmerIndex\n"
            "from smalt_tpu_torch.map.engine import MapEngine, MapParams\n"
            "from smalt_tpu_torch.map.pipeline import run_device_exact_fastq\n"
            f"rs, ix = RefSet.load({name!r}), KmerIndex.load({name!r})\n"
            "buf = io.StringIO()\n"
            "dev = run_device_exact_fastq(MapEngine(rs, ix, MapParams()), "
            f"{fq!r}, buf, rs, batch=64, device='cpu')\n"
            "assert len(buf.getvalue().splitlines()) == 200\n"
            "assert dev.p2_used > 0 and dev.host_batches == 0\n"
            "print('ok')\n")
        r = run_port_code(code)
        assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
        return
    if what == "single":
        name, fq = saved_index
        reads, n = f"{fq!r}", 200
    elif what == "long":
        refset, idx, fq, d = kilobase
        name = os.path.join(d, "idx")
        refset.save(name)
        idx.save(name)
        reads, n = f"{fq!r}", 16
    else:
        name, fq1, fq2 = saved_pairs
        reads, n = f"{fq1!r}, mates_path={fq2!r}", 80
    code = (
        "import io\n"
        "from smalt_tpu_torch.seq.refset import RefSet\n"
        "from smalt_tpu_torch.index.table import KmerIndex\n"
        "import smalt_tpu_torch.cli, smalt_tpu_torch.ops.build\n"
        "from smalt_tpu_torch.map.fastmode import run_fast_pipeline\n"
        f"rs, ix = RefSet.load({name!r}), KmerIndex.load({name!r})\n"
        "buf = io.StringIO()\n"
        f"run_fast_pipeline(rs, ix, {reads}, out=buf, batch=16, "
        "device='cpu')\n"
        f"assert len(buf.getvalue().splitlines()) == {n}\n"
        "print('ok')\n")
    r = run_port_code(code)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_pipeline_sam_identical_k17(tmp_path):
    """k = 17 (the split-word device index): run_fast_pipeline writes the
    JAX pipeline's SAM byte for byte on tests/test_device_bigk.py's genome
    and reads (40 reads of 90 bp, 1% substitutions, half reverse
    complemented)."""
    rng = np.random.default_rng(67)
    g = rng.choice(list("ACGT"), 30000)
    g = "".join(g)
    fa = tmp_path / "g.fa"
    fa.write_text(">g\n" + g + "\n")
    refset = RefSet.from_fasta(str(fa))
    idx = build_index(refset, 17, 2)
    rng = np.random.default_rng(71)
    qlen = 90
    comp = str.maketrans("ACGT", "TGCA")
    recs = []
    for i in range(40):
        st = int(rng.integers(0, len(g) - qlen))
        s = list(g[st : st + qlen])
        for j in np.flatnonzero(rng.random(qlen) < 0.01):
            s[j] = "ACGT"[int(rng.integers(0, 4))]
        s = "".join(s)
        if i % 2:
            s = s.translate(comp)[::-1]
        recs.append(f"@k{i}\n{s}\n+\n{'I' * qlen}\n")
    fq = tmp_path / "bigk.fq"
    fq.write_text("".join(recs))
    want, got = _both(refset, idx, str(fq), 32)
    assert len(got.splitlines()) == 40
    assert got == want
