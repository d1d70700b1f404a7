"""The `map --fast` driver options of the port (smalt_tpu_torch) on the CPU:
the tail pool (-n > 1, worker processes started with spawn, never
forked), --resume and --profile.  Each writes the records of the plain
run: -n 2 as -n 1 for single-end reads, pairs and --fallback-exact (as
tests/test_fastmode.py:267-280 holds smalt_tpu's forked pool); a
--resume run killed after two checkpoints and restarted as an
uninterrupted run (tests/test_resume.py:91-105); --profile as a run
without it, with a torch profiler trace written.  The pool and a
restarted run with --fallback-exact are also held to smalt_tpu's own
`map --fast -n 2 --fallback-exact` on the same index and reads.  One
small genome and index for the module; the port's runs go through
run_fast_pipeline and its CLI in this process, on one torch thread."""
import glob
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from smalt_tpu_torch import cli
from smalt_tpu_torch import resume as rz
from smalt_tpu_torch.index.table import build_index
from smalt_tpu_torch.map import fastmode as tfast
from smalt_tpu_torch.map.engine import MapEngine, MapParams
from smalt_tpu_torch.seq.refset import RefSet

QLEN, N_READS, N_PAIRS, INSERT = 80, 600, 48, 300
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 30 kb genome with a 600 bp unit repeated 12 times (reads there
    truncate their seed search: the --fallback-exact arm), k11 s2, saved
    as an index; 600 reads of 80 bp (2% substitutions, every second one
    reverse-complemented) and 48 FR pairs of 2 x 80 bp."""
    rng = np.random.default_rng(71)
    d = tmp_path_factory.mktemp("fastdrv")
    g = rng.choice(np.frombuffer(b"ACGT", np.uint8), 30_000)
    unit = g[:600].copy()
    for k in range(12):
        at = 2_000 + 2_000 * k
        g[at: at + 600] = unit
    g = g.tobytes().decode()
    fa = os.path.join(d, "g.fa")
    with open(fa, "w") as f:
        f.write(">g\n" + "".join(g[i:i + 60] + "\n"
                                 for i in range(0, len(g), 60)))
    refset = RefSet.from_fasta(fa)
    idx = build_index(refset, 11, 2)
    name = os.path.join(d, "idx")
    refset.save(name)
    idx.save(name)
    comp = str.maketrans("ACGT", "TGCA")
    recs = []
    for i in range(N_READS):
        st = int(rng.integers(0, len(g) - QLEN))
        s = list(g[st: st + QLEN])
        for j in np.flatnonzero(rng.random(QLEN) < 0.02):
            s[j] = "ACGT"[int(rng.integers(0, 4))]
        s = "".join(s)
        if i % 2:
            s = s.translate(comp)[::-1]
        recs.append(f"@r{i}\n{s}\n+\n{'I' * QLEN}\n")
    fq = os.path.join(d, "r.fq")
    with open(fq, "w") as f:
        f.write("".join(recs))
    r1, r2 = [], []
    for i in range(N_PAIRS):
        st = int(rng.integers(0, len(g) - INSERT))
        a, b = g[st: st + QLEN], g[st + INSERT - QLEN: st + INSERT]
        r1.append(f"@p{i}\n{a}\n+\n{'I' * QLEN}\n")
        r2.append(f"@p{i}\n{b.translate(comp)[::-1]}\n+\n{'I' * QLEN}\n")
    fq1, fq2 = os.path.join(d, "p_1.fq"), os.path.join(d, "p_2.fq")
    for path, rs in ((fq1, r1), (fq2, r2)):
        with open(path, "w") as f:
            f.write("".join(rs))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield refset, idx, name, fq, fq1, fq2
    torch.set_num_threads(threads)


def _run(world, nthreads, what, **kw):
    refset, idx, name, fq, fq1, fq2 = world
    if what == "paired":
        kw["mates_path"] = fq2
    elif what == "fallback-exact":
        kw["exact_engine"] = MapEngine(refset, idx, MapParams())
    buf = io.StringIO()
    tfast.run_fast_pipeline(refset, idx, fq1 if what == "paired" else fq,
                            buf, nthreads=nthreads, batch=64, device="cpu",
                            index_name=name, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("what", ["single", "paired", "fallback-exact"])
def test_pool_output_equals_one_process(world, what, monkeypatch):
    """nthreads=2 (spawned tail workers, each batch cut in chunks of 16
    reads or pairs or more, texts merged in input order) gives the output
    of nthreads=1 byte for byte; the workers load the index by name and
    rebuild the exact engine from its recipe."""
    monkeypatch.setattr(tfast.TailPool, "CHUNK_MIN", 16)
    want = _run(world, 1, what)
    got = _run(world, 2, what)
    assert len(got.splitlines()) == (2 * N_PAIRS if what == "paired"
                                     else N_READS)
    assert got == want


def test_pool_needs_the_index_name(world):
    """The workers load the reference and index by name: nthreads > 1
    without one is refused before any work starts."""
    refset, idx, _, fq, _, _ = world
    with pytest.raises(ValueError, match="needs index_name"):
        tfast.run_fast_pipeline(refset, idx, fq, io.StringIO(), nthreads=2,
                                device="cpu")


def test_pool_workers_start_fresh_and_never_touch_cuda(world):
    """The pool's start method is not fork, and its workers (which load
    the index by name) have not imported torch (the tail needs none, and
    its import costs a worker seconds), have not initialised CUDA and hold
    nothing of smalt_tpu or jax.  fastmode's LONG_READ_Q is the device
    step's."""
    from smalt_tpu_torch.parallel import mesh
    refset, idx, name, fq, _, _ = world
    assert tfast.TAIL_START_METHOD != "fork"
    assert tfast.LONG_READ_Q == mesh.LONG_READ_Q
    with tfast.TailPool(2, (name, None, (1, -2, -4, -3), 18, (True, False),
                            (0, 500), 1, None, None)) as pool:
        assert pool.ctx.get_start_method() == tfast.TAIL_START_METHOD
        facts = pool.facts()
    assert len(facts) == 2
    for pid, method, had_torch, cuda_up, alien in facts:
        assert pid != os.getpid()
        assert method == tfast.TAIL_START_METHOD
        assert had_torch is False
        assert cuda_up is False and alien is False


def _body(path):
    """Records only: the @PG line names the command."""
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("@")]


def _map(args, capsys=None):
    rc = cli.main(["map", "--fast", "--device", "cpu"] + args)
    return rc, (capsys.readouterr() if capsys is not None else None)


def test_cli_pool_with_fallback_exact_equals_one_process(world, tmp_path,
                                                         monkeypatch):
    """`map --fast -n 2 --fallback-exact`: the workers load the index by
    name and rebuild the exact engine the CLI built (its engine_recipe);
    the records equal -n 1's."""
    _, _, name, fq, _, _ = world
    monkeypatch.setenv("SMALT_FAST_BATCH", "128")
    outs = [str(tmp_path / f"n{n}.sam") for n in (1, 2)]
    for n, out in zip((1, 2), outs):
        assert _map(["-n", str(n), "--fallback-exact", "-o", out, name,
                     fq])[0] == 0
    assert len(_body(outs[0])) == N_READS
    assert _body(outs[1]) == _body(outs[0])


def _interrupted(argv, ticks: int, monkeypatch) -> bool:
    """cmd_map killed after `ticks` checkpoint ticks (one a batch)."""
    class Boom(Exception):
        pass

    orig = rz.ResumeLog.tick
    calls = {"n": 0}

    def tick(self, reads_done, out_bytes, rng):
        orig(self, reads_done, out_bytes, rng)
        calls["n"] += 1
        if calls["n"] >= ticks:
            raise Boom()

    monkeypatch.setattr(rz.ResumeLog, "tick", tick)
    monkeypatch.setattr(rz, "CHECKPOINT_BATCHES", 1)
    try:
        cli.main(["map", "--fast", "--device", "cpu"] + argv)
        return False
    except Boom:
        return True
    finally:
        monkeypatch.setattr(rz.ResumeLog, "tick", orig)


def test_resume_killed_and_restarted_is_byte_identical(world, tmp_path,
                                                      monkeypatch):
    """--fast -o OUT --resume killed after two checkpoints (two batches
    written) and run again continues from the checkpoint: the records of
    an uninterrupted run, and the sidecar removed at the end."""
    _, _, name, fq, _, _ = world
    monkeypatch.setenv("SMALT_FAST_BATCH", "128")
    ref = str(tmp_path / "full.sam")
    assert _map(["-o", ref, name, fq])[0] == 0
    out = str(tmp_path / "resumed.sam")
    assert _interrupted(["-o", out, "--resume", name, fq], 2, monkeypatch)
    assert os.path.exists(out + ".resume")
    assert 0 < len(_body(out)) < N_READS
    monkeypatch.setattr(rz, "CHECKPOINT_BATCHES", 1)
    assert _map(["-o", out, "--resume", name, fq])[0] == 0
    assert not os.path.exists(out + ".resume")
    assert _body(out) == _body(ref)


def test_pool_and_resume_equal_smalt_tpu(world, tmp_path, monkeypatch):
    """smalt_tpu's own CLI, `map --fast -n 2 --fallback-exact` (its forked
    tail pool, the Pallas kernel in interpret mode), on the world's index
    and reads (the repeat sends some to the exact lane): the port's `-n 2
    --fallback-exact` records, and those of its `--resume --fallback-exact`
    run killed after two checkpoints and restarted, equal smalt_tpu's byte
    for byte."""
    _, _, name, fq, _, _ = world
    monkeypatch.setenv("SMALT_FAST_BATCH", "128")
    ref = str(tmp_path / "smalt_tpu.sam")
    r = subprocess.run(
        [sys.executable, "-m", "smalt_tpu.cli", "map", "--fast", "-n", "2",
         "--fallback-exact", "-o", ref, name, fq], capture_output=True,
        text=True, cwd=REPO, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr
    want = _body(ref)
    assert len(want) == N_READS
    pooled = str(tmp_path / "n2.sam")
    assert _map(["-n", "2", "--fallback-exact", "-o", pooled, name,
                 fq])[0] == 0
    assert _body(pooled) == want
    out = str(tmp_path / "resumed.sam")
    argv = ["--fallback-exact", "-o", out, "--resume", name, fq]
    assert _interrupted(argv, 2, monkeypatch)
    assert 0 < len(_body(out)) < N_READS
    monkeypatch.setattr(rz, "CHECKPOINT_BATCHES", 1)
    assert _map(argv)[0] == 0
    assert _body(out) == want


def test_resume_with_pool_is_ignored_as_the_reference_does(world, tmp_path,
                                                           capsys):
    """--resume with -n 2 prints smalt_tpu's note, keeps no checkpoints
    and maps."""
    _, _, name, fq, _, _ = world
    out = str(tmp_path / "o.sam")
    rc, cap = _map(["-n", "2", "--resume", "-o", out, name, fq], capsys)
    assert rc == 0
    assert "# --resume needs -o and -n 1; ignored" in cap.err
    assert len(_body(out)) == N_READS
    assert not os.path.exists(out + ".resume")


def test_profile_writes_a_trace(world, tmp_path, capsys):
    """--profile DIR wraps the run in torch.profiler and writes a Chrome
    trace under DIR; the records equal a run without it."""
    _, _, name, fq, _, _ = world
    prof = tmp_path / "prof"
    rc, want = _map([name, fq], capsys)
    assert rc == 0
    rc, got = _map(["--profile", str(prof), name, fq], capsys)
    assert rc == 0
    assert [ln for ln in got.out.splitlines() if ln[:1] != "@"] == \
        [ln for ln in want.out.splitlines() if ln[:1] != "@"]
    traces = glob.glob(str(prof / "*.pt.trace.json"))
    assert len(traces) == 1 and os.path.getsize(traces[0]) > 0
    with open(traces[0]) as f:
        assert '"traceEvents"' in f.read()


def test_help_describes_device_pass1_and_profile(capsys):
    """`map --help` describes --device-pass1 (the lane, as smalt_tpu's
    help does), --profile and --mesh; no option says it is not ported."""
    assert cli.main(["map", "--help"]) == 0
    text = " ".join(capsys.readouterr().out.split())
    assert "--device-pass1 score the exact pass-1 candidate windows on " \
        "the device" in text and "output stays bit-identical" in text
    assert "torch profiler trace of the device mapping loop" in text
    assert "--mesh DP,IP with --fast: run the mapping step over a device " \
        "mesh" in text
    assert "not ported" not in text
