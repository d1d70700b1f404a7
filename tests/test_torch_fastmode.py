"""`map --fast` through the port (smalt_tpu_torch) against smalt_tpu on the
CPU: byte-identical SAM from run_fast_pipeline and from the two CLIs,
unported options refused with their ROADMAP item, and no jax in a
process that imports and runs the port."""
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


def _both(refset, idx, fq, batch, **kw):
    want = io.StringIO()
    jfast.run_fast_pipeline(refset, idx, fq, want, nthreads=1, batch=batch,
                            interpret=True, **kw)
    got = io.StringIO()
    tfast.run_fast_pipeline(refset, idx, fq, got, nthreads=1, batch=batch,
                            device="cpu", **kw)
    return want.getvalue(), got.getvalue()


def test_pipeline_sam_identical(simulated):
    refset, idx, fq, _ = simulated
    want, got = _both(refset, idx, fq, 64)
    assert len(got.splitlines()) == 200
    assert got == want


def test_pipeline_fallback_exact_identical(simulated):
    """--fallback-exact is host-only: it passes straight to the tail."""
    from smalt_tpu.map.engine import MapEngine, MapParams
    refset, idx, fq, _ = simulated
    eng = MapEngine(refset, idx, MapParams())
    want, got = _both(refset, idx, fq, 64, exact_engine=eng)
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
    ({"mates_path": "m.fq"}, "Queue 1 #3"),
    ({"mesh_spec": "2,1"}, "Queue 1 #8"),
    ({"nthreads": 2}, "Queue 1 #11"),
    ({"resume_log": object()}, "Queue 1 #13"),
])
def test_pipeline_unported_options_raise(simulated, kw, item):
    refset, idx, fq, _ = simulated
    with pytest.raises(NotImplementedError, match=item):
        tfast.run_fast_pipeline(refset, idx, fq, io.StringIO(),
                                device="cpu", **kw)


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
    got = _run(["-m", "smalt_tpu_torch.cli", "map", "--fast", "--device",
                "cpu", name, fq])
    assert got.returncode == 0, got.stderr
    want = _run(["-m", "smalt_tpu.cli", "map", "--fast", name, fq])
    assert want.returncode == 0, want.stderr
    assert got.stdout.startswith("@HD")
    assert len([ln for ln in got.stdout.splitlines()
                if not ln.startswith("@")]) == 200
    assert _body(got.stdout) == _body(want.stdout)


@pytest.mark.parametrize("extra,item", [
    (["--mesh", "2,1"], "Queue 1 #8"),
    (["--profile", "prof"], "Queue 1 #12"),
    (["-n", "2"], "Queue 1 #11"),
    (["--device-exact"], "Queue 1 #6"),
])
def test_cli_unported_options_exit_nonzero(saved_index, extra, item):
    from smalt_tpu_torch import cli
    name, fq = saved_index
    fast = [] if extra == ["--device-exact"] else ["--fast"]
    rc = cli.main(["map"] + fast + extra + ["--device", "cpu", name, fq])
    assert rc == 2


def test_cli_cuda_without_gpu_fails(saved_index):
    """--device cuda (the default) never falls back to the CPU."""
    name, fq = saved_index
    r = _run(["-m", "smalt_tpu_torch.cli", "map", "--fast", name, fq],
             env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert not [ln for ln in r.stdout.splitlines()
                if ln and not ln.startswith("@")]


def test_port_never_imports_jax(saved_index):
    name, fq = saved_index
    code = (
        "import io, sys\n"
        "from smalt_tpu.seq.refset import RefSet\n"
        "from smalt_tpu.index.table import KmerIndex\n"
        "import smalt_tpu_torch.cli, smalt_tpu_torch.ops.build\n"
        "from smalt_tpu_torch.map.fastmode import run_fast_pipeline\n"
        f"rs, ix = RefSet.load({name!r}), KmerIndex.load({name!r})\n"
        "buf = io.StringIO()\n"
        f"run_fast_pipeline(rs, ix, {fq!r}, buf, batch=16, device='cpu')\n"
        "assert len(buf.getvalue().splitlines()) == 200\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('ok')\n")
    r = _run(["-c", code])
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
