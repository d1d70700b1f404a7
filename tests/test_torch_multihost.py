"""Several hosts, one `map --fast` run, on the port (smalt_tpu_torch):
batch-striped shards merge back byte-identical to the single-host run
(tests/test_multihost.py's checks), through run_fast_pipeline, the
merge-shards CLI and the CLI's own multi-host branch; and the rendezvous
on torch.distributed (gloo) under the reference's SMALT_TPU_* variables."""
import io
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from smalt_tpu_torch import cli
from smalt_tpu_torch.index.table import build_index
from smalt_tpu_torch.map.fastmode import run_fast_pipeline
from smalt_tpu_torch.parallel.distributed import (ShardWriter,
                                                  maybe_init_distributed,
                                                  merge_shards)
from smalt_tpu_torch.seq.refset import RefSet
from test_torch_standalone import REPO, run_port_code


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the test workers run other CPU lanes beside it,
    and a mesh step's many small ops stall on each other's threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """tests/test_multihost.py:14's corpus: a 15 kb genome, k11 s2, 70
    reads of 70 bp (several batches of 16, not a multiple), saved."""
    d = tmp_path_factory.mktemp("thosts")
    rng = np.random.default_rng(61)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, 15000))
    fa = os.path.join(d, "g.fa")
    with open(fa, "w") as f:
        f.write(">g\n" + genome + "\n")
    refset = RefSet.from_fasta(fa)
    idx = build_index(refset, 11, 2)
    name = os.path.join(d, "idx")
    refset.save(name)
    idx.save(name)
    comp = str.maketrans("ACGT", "TGCA")
    recs = []
    for i in range(70):
        st = int(rng.integers(0, len(genome) - 70))
        s = genome[st : st + 70]
        if i % 2:
            s = s.translate(comp)[::-1]
        recs.append(f"@s{i}\n{s}\n+\n{'I' * 70}\n")
    fq = os.path.join(d, "r.fq")
    with open(fq, "w") as f:
        f.write("".join(recs))
    return refset, idx, name, fq


def test_three_host_stripe_merge(world, tmp_path):
    """Three simulated hosts, each mapping its stripe through a
    ShardWriter (host 1 rendering on a tail pool of 2 workers, one write
    a batch): merged, the single-host run's SAM byte for byte."""
    refset, idx, name, fq = world
    single = io.StringIO()
    run_fast_pipeline(refset, idx, fq, single, batch=16, device="cpu")
    paths = []
    for h in range(3):
        paths.append(str(tmp_path / f"out.sam.shard{h}"))
        sw = ShardWriter(paths[-1], h, 3)
        run_fast_pipeline(refset, idx, fq, None, batch=16, device="cpu",
                          host_id=h, n_hosts=3, shard_writer=sw,
                          nthreads=2 if h == 1 else 1, index_name=name)
        sw.close()
    with open(paths[1] + ".batches.json") as f:
        assert [e[0] for e in json.load(f)["extents"]] == [1, 4]
    merged = io.StringIO()
    assert merge_shards(paths, merged) == 5      # ceil(70 / 16)
    assert merged.getvalue() == single.getvalue()
    assert single.getvalue().count("\n") == 70


def test_merge_shards_cli(tmp_path):
    """tests/test_multihost.py:57 on the port's merge-shards."""
    paths = []
    for h in range(2):
        p = str(tmp_path / f"x.sam.shard{h}")
        sw = ShardWriter(p, h, 2)
        for b in range(h, 4, 2):
            sw.write_batch(b, f"rec batch {b}\n")
        sw.close()
        paths.append(p)
    (tmp_path / "x.sam.header").write_text("@HD\tVN:1.4\n")
    out = str(tmp_path / "merged.sam")
    assert cli.cmd_merge_shards([out] + paths) == 0
    assert open(out).read() == "@HD\tVN:1.4\nrec batch 0\nrec batch 1\n" \
                               "rec batch 2\nrec batch 3\n"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _hosts(n, argv, cwd, **env_extra):
    """n Python processes with the SMALT_TPU_* variables of one run on
    127.0.0.1 (and env_extra), started together; returns their
    (returncode, stdout, stderr)."""
    port = _free_port()
    procs = []
    for h in range(n):
        env = dict(os.environ, PYTHONPATH=REPO,
                   SMALT_TPU_COORD=f"127.0.0.1:{port}",
                   SMALT_TPU_NPROCS=str(n), SMALT_TPU_PROCID=str(h),
                   OMP_NUM_THREADS="1", **env_extra)
        procs.append(subprocess.Popen(
            [sys.executable] + argv, env=env, cwd=cwd,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=240)
            outs.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def test_maybe_init_distributed_gloo(tmp_path):
    """Two processes join one gloo group on the SMALT_TPU_* variables and
    each gets (rank, 2); with the variables unset nothing is created and
    the answer is (0, 1)."""
    code = ("from smalt_tpu_torch.parallel.distributed import "
            "maybe_init_distributed, end_distributed\n"
            "import torch.distributed as dist\n"
            "r = maybe_init_distributed()\n"
            "t = __import__('torch').ones(1) * (r[0] + 1)\n"
            "dist.all_reduce(t)\n"
            "print(r[0], r[1], int(t.item()))\n"
            "end_distributed()\n")
    outs = _hosts(2, ["-c", code], str(tmp_path))
    for h, (rc, o, e) in enumerate(outs):
        assert rc == 0, e
        assert o.split() == [str(h), "2", "3"]
    for k in ("SMALT_TPU_COORD", "SMALT_TPU_NPROCS", "SMALT_TPU_PROCID"):
        assert k not in os.environ
    import torch.distributed as dist
    assert maybe_init_distributed() == (0, 1)
    assert not dist.is_initialized()


def test_cli_two_hosts_then_merge_shards(world, tmp_path):
    """The CLI's multi-host branch: two processes under the SMALT_TPU_*
    variables map their stripes into OUT.shard0 / OUT.shard1 (host 0
    also writes OUT.header); merge-shards gives the single-host SAM.
    Both runs in processes that cannot import smalt_tpu."""
    _, _, name, fq = world
    out = str(tmp_path / "o.sam")
    from test_torch_standalone import BLOCK_REFERENCE
    run = ("from smalt_tpu_torch import cli\n"
           "sys.exit(cli.main(sys.argv[1:]))\n")
    outs = _hosts(2, ["-c", BLOCK_REFERENCE + run, "map", "--fast",
                      "--device", "cpu", "-o", out, name, fq],
                  str(tmp_path), SMALT_FAST_BATCH="16")
    for rc, _, e in outs:
        assert rc == 0, e
    assert sorted(os.listdir(tmp_path)) == [
        "o.sam.header", "o.sam.shard0", "o.sam.shard0.batches.json",
        "o.sam.shard1", "o.sam.shard1.batches.json"]
    single = str(tmp_path / "single.sam")
    r = run_port_code("from smalt_tpu_torch import cli\n"
                      "assert cli.main(sys.argv[1:]) == 0\n",
                      {"SMALT_FAST_BATCH": "16"},
                      ["map", "--fast", "--device", "cpu", "-o", single,
                       name, fq])
    assert r.returncode == 0, r.stderr
    merged = str(tmp_path / "merged.sam")
    assert cli.main(["merge-shards", merged, out + ".shard0",
                     out + ".shard1"]) == 0

    def body(p):
        return [ln for ln in open(p) if not ln.startswith("@PG")]

    assert body(merged) == body(single) and len(body(single)) > 70
