"""`map --device-exact` on read pairs through the port (smalt_tpu_torch)
on the CPU: both mates' front halves in one collate step and the C pair
block on its state.  The SAM must equal the host C pair lane's and
smalt_tpu's paired device-exact lane's, byte for byte, with the JAX
lane's re-stage count, on the two corpora of tests/test_device_exact_pe.py
(repeats, discordant and repeat-unit pairs, a junk mate in every tenth
pair); a batch the lane does not take keeps its place; an insert
histogram (-g) passes through; a collate step that raises ends the run.
Each lane's output is built once per module, on one torch thread."""
import io

import pytest
import torch

from smalt_tpu import cli as jcli
from smalt_tpu import rand
from smalt_tpu.map import fastlane as jfl
from smalt_tpu.map.engine import MapEngine, MapParams
from smalt_tpu.map.pipeline import run_pipeline_raw_pairs as jax_raw_pairs
from smalt_tpu.native import get_lib
from smalt_tpu_torch import cli as tcli
from smalt_tpu_torch import rand as trand
from smalt_tpu_torch.map.fastlane import DeviceExact
from smalt_tpu_torch.map.pipeline import (run_device_exact_pairs,
                                          run_pipeline_raw_pairs)
from test_device_exact_pe import QLEN, _pe_world
from test_torch_exact import _port_engine
from test_torch_standalone import run_port_cli

BATCH = 128          # SMALT_DX_BATCH: 64 pairs a batch, five batches

pytestmark = pytest.mark.skipif(get_lib() is None,
                                reason="native lib required")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the test workers run other CPU lanes beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lanes(refset, idx, fq1, fq2, batch=BATCH, jax=False, tier_hits=0):
    """{lane: SAM text} for the port's host C pair lane, the port's
    device-exact lane on the CPU (tier_hits > 0: its repeat tier's
    ceiling of hits a lane, in place of the engine's) and (jax=True)
    smalt_tpu's paired device-exact lane, each from drand48 seed 1; and
    {lane: the device-exact lane object}."""
    outs, devs = {}, {}
    trand.ranseed(1)
    peng, prs = _port_engine(refset, idx)
    buf = io.StringIO()
    assert run_pipeline_raw_pairs(peng, fq1, fq2, buf, prs)
    outs["host"] = buf.getvalue()
    trand.ranseed(1)
    peng, prs = _port_engine(refset, idx)
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        if tier_hits:
            ceil = DeviceExact._tier_ceilings
            mp.setattr(DeviceExact, "_tier_ceilings", lambda self: (
                ceil(self)[0], tier_hits, ceil(self)[2]))
        devs["port"] = run_device_exact_pairs(peng, fq1, fq2, buf, prs,
                                              batch=batch, device="cpu")
    outs["port"] = buf.getvalue()
    if jax:
        made = []
        make = jfl.DeviceExact.make
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("SMALT_DX_BATCH", str(batch))
            mp.setattr(jfl.DeviceExact, "make", classmethod(
                lambda cls, *a, **k: made.append(make(*a, **k)) or made[-1]))
            rand.ranseed(1)
            buf = io.StringIO()
            assert jax_raw_pairs(MapEngine(refset, idx, MapParams()), fq1,
                                 fq2, buf, refset, device_exact=True)
        assert made and made[0] is not None
        devs["jax"] = made[0]
        outs["jax"] = buf.getvalue()
    return outs, devs


@pytest.fixture(scope="module")
def world41(tmp_path_factory):
    d = tmp_path_factory.mktemp("pe41")
    refset, idx, fq1, fq2 = _pe_world(d, seed=41, nctg=2, k=11)
    return (d, refset, idx, fq1, fq2) + _lanes(refset, idx, fq1, fq2,
                                               jax=True)


@pytest.fixture(scope="module")
def world42(tmp_path_factory):
    """Six contigs at k 13.  The repeat tier would take every mate past
    H: its ceiling is cut to 2,048 hits a lane so that the mates past it
    (78 of 141) re-stage, and the C pair block maps them on the host."""
    d = tmp_path_factory.mktemp("pe42")
    refset, idx, fq1, fq2 = _pe_world(d, seed=42, nctg=6, k=13)
    return (d, refset, idx, fq1, fq2) + _lanes(refset, idx, fq1, fq2,
                                               tier_hits=2048)


@pytest.fixture(scope="module")
def world43(tmp_path_factory):
    """Three contigs indexed at k 11, step 12 (nskip > wordlen): the lane
    expands the hits on the device."""
    d = tmp_path_factory.mktemp("pe43")
    refset, idx, fq1, fq2 = _pe_world(d, seed=43, nctg=3, k=11, nskip=12)
    return (d, refset, idx, fq1, fq2) + _lanes(refset, idx, fq1, fq2,
                                               jax=True)


def test_pairs_device_hits_match_host_and_jax(world43):
    """nskip > wordlen: both mates' hits expanded on the device (the
    collate step's own checksum): SAM == the host C pair lane == smalt_tpu's
    paired lane, with its re-stage count, no batch rendered on the host."""
    *_, outs, devs = world43
    assert not devs["port"]._host_hits and not devs["jax"]._host_hits
    assert len(outs["host"].splitlines()) == 600
    assert outs["port"] == outs["jax"] == outs["host"]
    assert devs["port"].host_batches == 0
    assert devs["port"].n_restaged == devs["jax"].n_restaged < 600


@pytest.mark.parametrize("world", ["world41", "world42"])
def test_pairs_byte_identical_to_host_pair_lane(request, world):
    """Seed 41 (two contigs, k 11) and seed 42 (six contigs, k 13): the
    port's lane == the host C pair lane, no batch rendered on the host,
    and the state served most mates (the lane did not re-stage them
    all), re-staged mates among them and the repeat tier serving the
    mates past H."""
    *_, outs, devs = request.getfixturevalue(world)
    assert len(outs["host"].splitlines()) == 600
    assert outs["port"] == outs["host"]
    dev = devs["port"]
    assert dev.host_batches == 0
    assert 0 < dev.n_restaged <= 300, dev.n_restaged
    assert dev.n_tier > dev.n_tier_rs, (dev.n_tier, dev.n_tier_rs)


def test_pairs_match_jax_lane(world41):
    """Seed 41: the port's lane == smalt_tpu's run_pipeline_raw_pairs(
    device_exact=True), SAM byte for byte and the same re-stage count but
    for the mates the port's repeat tier kept on the device."""
    *_, outs, devs = world41
    assert outs["port"] == outs["jax"] == outs["host"]
    port = devs["port"]
    assert port.n_restaged + port.n_tier - port.n_tier_rs == \
        devs["jax"].n_restaged


def _with_long_mate(src, dst, at, mate):
    """Copy of FASTQ `src` at `dst` with the record @long holding `mate`
    put before record `at`."""
    recs = open(src).read().splitlines(keepends=True)
    recs[4 * at:4 * at] = [f"@long\n{mate}\n+\n{'5' * len(mate)}\n"]
    with open(dst, "w") as f:
        f.write("".join(recs))
    return str(dst)


def test_refused_batch_keeps_input_order(world41):
    """A batch the lane does not take (a 300 bp mate A in the third of
    four batches of 80 pairs: over QMAX = 255 bp) is rendered by the host
    pair lane in its place: the SAM and the repeat placements drawn from
    the RNG equal the host C pair lane's, byte for byte."""
    d, refset, idx, fq1, fq2, _, _ = world41
    genome = (d / "g.fa").read_text().splitlines()[1]
    comp = str.maketrans("ACGT", "TGCA")
    at = 170                                     # pair 170: batch 3 of 4
    r1 = _with_long_mate(fq1, d / "long_1.fq", at, genome[5000:5300])
    r2 = _with_long_mate(fq2, d / "long_2.fq", at,
                         genome[5300:5300 + QLEN].translate(comp)[::-1])
    outs, devs = _lanes(refset, idx, r1, r2, batch=160)
    assert devs["port"].host_batches == 1
    lines = outs["port"].splitlines()
    assert len(lines) == 602 and lines[2 * at].startswith("long\t")
    assert outs["port"] == outs["host"]


def test_insert_histogram_passes_through(world41, tmp_path, monkeypatch):
    """-g with a histogram from `sample`: the CLI's paired device-exact
    run == its host pair lane with the same histogram."""
    d, refset, idx, fq1, fq2, _, _ = world41
    name = str(d / "idx")
    refset.save(name)
    idx.save(name)
    hist = str(tmp_path / "ins.txt")
    assert tcli.main(["sample", "-o", hist, name, fq1, fq2]) == 0
    monkeypatch.setenv("SMALT_DX_BATCH", str(BATCH))
    bodies = []
    for flags in ([], ["--device-exact", "--device", "cpu"]):
        out = str(tmp_path / f"g{len(bodies)}.sam")
        trand.ranseed(1)
        assert tcli.main(["map"] + flags + ["-r", "1", "-g", hist, "-o", out,
                                            name, fq1, fq2]) == 0
        bodies.append([ln for ln in open(out) if not ln.startswith("@PG")])
    assert len([ln for ln in bodies[0] if ln[:1] != "@"]) == 600
    assert bodies[1] == bodies[0]


def test_raising_collate_step_raises(world41, monkeypatch):
    """A collate step that raises (here on the second batch) ends the run
    with its error: the lane renders no batch on the host for it."""
    _, refset, idx, fq1, fq2, _, _ = world41
    calls = []
    real = DeviceExact._collate_outputs

    def collate(self, dargs):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("device fault")
        return real(self, dargs)

    monkeypatch.setattr(DeviceExact, "_collate_outputs", collate)
    trand.ranseed(1)
    peng, prs = _port_engine(refset, idx)
    buf = io.StringIO()
    with pytest.raises(RuntimeError, match="device fault"):
        run_device_exact_pairs(peng, fq1, fq2, buf, prs, batch=BATCH,
                               device="cpu")
    names = {ln.split("\t", 1)[0] for ln in buf.getvalue().splitlines()}
    assert not names & {f"p{i}" for i in range(64, 128)}


def test_cli_matches_jax_cli(world41, tmp_path, monkeypatch):
    """The port's CLI (`map --device-exact --device cpu idx r1 r2`, in a
    process where smalt_tpu and jax cannot be imported) == `smalt_tpu map
    --device-exact idx r1 r2`, the @PG line aside."""
    d, refset, idx, fq1, fq2, _, _ = world41
    name = str(d / "idx")
    refset.save(name)
    idx.save(name)
    got, want = str(tmp_path / "got.sam"), str(tmp_path / "want.sam")
    env = {"SMALT_DX_BATCH": str(BATCH)}
    r = run_port_cli(["map", "--device-exact", "--device", "cpu", "-r", "1",
                      "-o", got, name, fq1, fq2], env)
    assert r.returncode == 0, r.stderr
    monkeypatch.setenv("SMALT_DX_BATCH", str(BATCH))
    assert jcli.main(["map", "--device-exact", "-r", "1", "-o", want, name,
                      fq1, fq2]) == 0
    body = [[ln for ln in open(p).read().splitlines()
             if not ln.startswith("@PG")] for p in (got, want)]
    assert body[0][0].startswith("@HD")
    assert len([ln for ln in body[0] if not ln.startswith("@")]) == 600
    assert body[0] == body[1]
