"""What `map --device-exact` writes and how it resumes, through the port's
CLI on the CPU: every output format (-f bam, cigar, ssaha, gff) on
single-end reads and on pairs equals `smalt_tpu map --device-exact` with
that format; a run killed after two checkpoints and restarted with
--resume writes the host lane's records, byte for byte, with device pass
2 off and on (the port's copy of tests/test_resume.py's device-exact
case); --resume with a mates file says it is ignored and maps."""
import gzip
import os
import struct

import numpy as np
import pytest
import torch

from smalt_tpu import cli as jcli
from smalt_tpu.native import get_lib
from smalt_tpu_torch import cli as tcli
from smalt_tpu_torch import resume as trz
from test_device_exact_pe import _pe_world
from test_torch_exact import _corpus

pytestmark = pytest.mark.skipif(get_lib() is None,
                                reason="native lib required")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the test workers run other CPU lanes beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """{"se": (index, reads), "pe": (index, reads, mates)}: the
    one-sequence corpus of test_torch_exact.py and 120 pairs of the
    seed-41 corpus of test_device_exact_pe.py, indexed and saved."""
    worlds = {}
    d = tmp_path_factory.mktemp("se")
    refset, idx, fq = _corpus(d, "one_seq")
    worlds["se"] = (str(d / "idx"), fq)
    refset.save(worlds["se"][0])
    idx.save(worlds["se"][0])
    d = tmp_path_factory.mktemp("pe")
    refset, idx, fq1, fq2 = _pe_world(d, seed=41, nctg=2, k=11, npairs=120)
    worlds["pe"] = (str(d / "idx"), fq1, fq2)
    refset.save(worlds["pe"][0])
    idx.save(worlds["pe"][0])
    return worlds


def _bam_body(path):
    """A BAM file's bytes after its header text: the reference list and
    every record, mate fields included (the header's @PG line names the
    command)."""
    with gzip.open(path, "rb") as f:
        data = f.read()
    assert data[:4] == b"BAM\x01"
    (l_text,) = struct.unpack_from("<i", data, 4)
    return data[8 + l_text:]


def _text_body(path):
    return [ln for ln in open(path).read().splitlines()
            if not ln.startswith("@PG")]


@pytest.mark.parametrize("fmt", ["bam", "cigar", "ssaha", "gff"])
@pytest.mark.parametrize("reads", ["se", "pe"])
def test_output_format_matches_jax_cli(saved, tmp_path, monkeypatch, fmt,
                                       reads):
    """-f bam rides the lane's SAM text through the BAM re-encoder; cigar,
    ssaha and gff are the C lane's own formats.  Each equals smalt_tpu's
    --device-exact output with that format (BAM: every byte after the
    header text; text formats: every line but @PG)."""
    name, *files = saved[reads]
    monkeypatch.setenv("SMALT_DX_BATCH", "64")
    got, want = str(tmp_path / f"got.{fmt}"), str(tmp_path / f"want.{fmt}")
    assert tcli.main(["map", "--device-exact", "--device", "cpu", "-f", fmt,
                      "-r", "1", "-o", got, name] + files) == 0
    assert jcli.main(["map", "--device-exact", "-f", fmt, "-r", "1", "-o",
                      want, name] + files) == 0
    if fmt == "bam":
        body = _bam_body(got)
        assert body == _bam_body(want) and len(body) > 20000
    else:
        body = _text_body(got)
        assert body == _text_body(want)
        assert len(body) >= (204 if reads == "se" else 240)


@pytest.fixture(scope="module")
def resume_world(tmp_path_factory):
    """tests/test_resume.py's corpus, cut to 1,200 reads of 75 bp on a
    20 kb genome, k 11 s 2 (five batches of 256 reads), and the host
    lane's SAM of it."""
    rng = np.random.default_rng(73)
    bases = np.array(list(b"ACGT"), np.uint8)
    g = rng.choice(bases, 20000).tobytes().decode()
    d = tmp_path_factory.mktemp("resume")
    fa = os.path.join(d, "g.fa")
    open(fa, "w").write(">g\n" + g + "\n")
    idx = os.path.join(d, "idx")
    assert tcli.cmd_index(["-k", "11", "-s", "2", idx, fa]) == 0
    qlen = 75
    comp = str.maketrans("ACGT", "TGCA")
    recs = []
    for i in range(1200):
        st = int(rng.integers(0, len(g) - qlen))
        s = g[st: st + qlen]
        if i % 2:
            s = s.translate(comp)[::-1]
        recs.append(f"@r{i}\n{s}\n+\n{'I' * qlen}\n")
    fq = os.path.join(d, "r.fq")
    open(fq, "w").write("".join(recs))
    full = os.path.join(d, "full.sam")
    assert tcli.cmd_map(["-r", "1", "-o", full, idx, fq]) == 0
    return idx, fq, full


def _records(path):
    """Records only: the @PG header embeds the command line."""
    return [ln for ln in open(path) if not ln.startswith("@")]


@pytest.mark.parametrize("p2", [None, "1"])
def test_device_exact_resume_byte_identical(resume_world, tmp_path,
                                            monkeypatch, p2):
    """Kill a --device-exact --resume run after two checkpoints (one a
    batch), restart it with the same options: the output is the host
    lane's, byte for byte, and the sidecar is gone."""
    idx, fq, full = resume_world
    monkeypatch.setenv("SMALT_DX_BATCH", "256")
    if p2 is None:
        monkeypatch.delenv("SMALT_DX_P2", raising=False)
    else:
        monkeypatch.setenv("SMALT_DX_P2", p2)
    monkeypatch.setattr(trz, "CHECKPOINT_BATCHES", 1)
    out = str(tmp_path / "resumed.sam")
    argv = ["map", "--device-exact", "--device", "cpu", "-r", "1", "-o", out,
            "--resume", idx, fq]

    class Boom(Exception):
        pass

    tick = trz.ResumeLog.tick
    ticks = []

    def tick_then_die(self, reads_done, out_bytes, rng):
        tick(self, reads_done, out_bytes, rng)
        ticks.append(reads_done)
        if len(ticks) == 2:
            raise Boom()

    with monkeypatch.context() as mp:
        mp.setattr(trz.ResumeLog, "tick", tick_then_die)
        with pytest.raises(Boom):
            tcli.main(argv)
    assert ticks == [256, 512]
    assert os.path.exists(out + ".resume")
    assert tcli.main(argv) == 0
    assert not os.path.exists(out + ".resume")
    assert _records(out) == _records(full)


def test_resume_with_mates_is_ignored(saved, tmp_path, capsys, monkeypatch):
    """--resume needs single-end reads: with a mates file the run says so,
    maps without checkpoints, and writes the host pair lane's records."""
    name, fq1, fq2 = saved["pe"]
    monkeypatch.setenv("SMALT_DX_BATCH", "64")
    got, want = str(tmp_path / "got.sam"), str(tmp_path / "want.sam")
    assert tcli.main(["map", "--device-exact", "--device", "cpu", "--resume",
                      "-r", "1", "-o", got, name, fq1, fq2]) == 0
    assert "--resume needs -o and a serial single-end FASTQ run; ignored" \
        in capsys.readouterr().err
    assert not os.path.exists(got + ".resume")
    assert tcli.main(["map", "-r", "1", "-o", want, name, fq1, fq2]) == 0
    assert _records(got) == _records(want) and len(_records(got)) == 240
