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


def _sam_reads(fq: str, path: str) -> str:
    """The reads of a FASTQ file as unmapped SAM records (read input)."""
    lines = open(fq).read().splitlines()
    with open(path, "w") as f:
        for i in range(0, len(lines), 4):
            f.write(f"{lines[i][1:]}\t4\t*\t0\t0\t*\t*\t0\t0\t{lines[i + 1]}\t"
                    f"{lines[i + 3]}\n")
    return path


@pytest.mark.parametrize("case", ["sam-exact", "sam-pass1", "mates-pass1",
                                  "bam-collide", "crlf-exact"])
def test_device_flags_hand_off_to_the_host_lane(saved, tmp_path, capsys,
                                                monkeypatch, case):
    """Runs the reference hands to its host lane run there in the port too,
    with a note on stderr, and write the output of `map` without the flag:
    SAM input, --device-pass1 with mates (smalt_tpu/cli.py:379-385), -f
    bam where reference names collide once cut at white space (BAM from
    report objects), and FASTQ the bulk parser does not take (CRLF line
    ends: smalt_tpu/map/pipeline.py:211-213).  No card is needed: the handoff comes before
    any device check."""
    monkeypatch.setenv("SMALT_DX_BATCH", "64")
    name, *files = saved["pe" if case == "mates-pass1" else "se"]
    flag = "--device-pass1" if case.endswith("pass1") else "--device-exact"
    fmt, note = "sam", "apply to serial FASTQ runs"
    if case.startswith("sam"):
        files = [_sam_reads(files[0], str(tmp_path / "reads.sam"))]
    if case == "crlf-exact":
        crlf = tmp_path / "crlf.fq"
        crlf.write_bytes(open(files[0], "rb").read().replace(b"\n",
                                                             b"\r\n"))
        files = [str(crlf)]
        note = "lane's gates; the host lane maps"
    if case == "bam-collide":
        # the corpus's genome cut in two sequences, "ctg one", "ctg two"
        seq = "".join(ln.strip() for ln in open(os.path.join(
            os.path.dirname(name), "g.fa")) if not ln.startswith(">"))
        fa = str(tmp_path / "g.fa")
        half = len(seq) // 2
        open(fa, "w").write(f">ctg one\n{seq[:half]}\n>ctg two\n"
                            f"{seq[half:]}\n")
        name = str(tmp_path / "idx")
        assert tcli.cmd_index(["-k", "11", "-s", "2", name, fa]) == 0
        fmt, note = "bam", "the host lane writes BAM from report objects"
    outs = []
    for flags in ([flag, "--device", "cuda"], []):
        out = str(tmp_path / f"o{len(outs)}.{fmt}")
        capsys.readouterr()
        assert tcli.main(["map"] + flags + ["-f", fmt, "-r", "1", "-o", out,
                                            name] + files) == 0
        if flags:
            assert note in capsys.readouterr().err
        outs.append(_bam_body(out) if fmt == "bam" else _text_body(out))
    assert outs[0] == outs[1] and len(outs[1]) > 200
