"""`map --device-pass1` through the port (smalt_tpu_torch) on the CPU, and
the routing of the device flags among the pass-1 lane, the exact lane and
the host lane.

- The port's device stage (`dp1_step`) equals smalt_tpu's
  `_dp1_step_fn(..., on_tpu=False)` exactly: reverse-strand windows,
  reads with N, windows past the reference's end, windows of slen 0, and
  reads padded to Q = 640 (the sticky cap doubled past 512).
- A numpy rendering of sw_full.cu's column-strip path (queries past 512
  columns), lane for lane, equals sw_score_ref: scores and tracked cells,
  tie-heavy windows included.  It holds the carry algebra the kernel
  runs on the card, where chip_smoke.py holds the kernel itself.
- The port's `map --device-pass1 --device cpu` writes the SAM body of
  `smalt_tpu map --device-pass1` and of the host lane (`map`), on the
  bundled reads and on reads of 600-700 bp (Q = 1,024).
- A batch the lane does not take keeps its place in the output, and a
  device leg that raises ends the run (the reference writes the batch at
  once, and turns the error into host output).
- `--device-exact` on an engine DeviceExact.make refuses runs DevicePass1.

Each lane runs once per module, on one torch thread, at a small batch
(SMALT_DP1_BATCH)."""
import gzip
import io
import os

import numpy as np
import pytest
import torch

from smalt_tpu import cli as jcli
from smalt_tpu import rand
from smalt_tpu.map import fastlane as jfl
from smalt_tpu.native import get_lib
from smalt_tpu_torch import cli as tcli
from smalt_tpu_torch import rand as trand
from smalt_tpu_torch.align import core as tali
from smalt_tpu_torch.map import fastlane as tfl
from smalt_tpu_torch.map.pipeline import (device_lane, run_device_fastq,
                                          run_pipeline_raw_fastq)
from smalt_tpu_torch.ops import bounds
from smalt_tpu_torch.ops import sw as tsw
from test_torch_exact import _port_engine
from smalt_tpu.index.table import build_index
from smalt_tpu.seq.refset import RefSet

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
BATCH = 256          # SMALT_DP1_BATCH: four batches of the bundled head
N_HEAD = 4 * BATCH   # reads of tests/data/reads_se.fq.gz mapped here
NEG = -(1 << 28)

pytestmark = pytest.mark.skipif(get_lib() is None,
                                reason="native lib required")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the test workers run other CPU lanes beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------
# the device stage against the reference's
# ------------------------------------------------------------------

def _step_inputs(rng, n: int, Q: int, W: int, N: int, S: int):
    """Seeded inputs of the pass-1 step: a reference of N codes (N = 4 in
    places), n reads of random lengths up to Q (some with N, padded with
    7), and W windows: both strands, some of slen 0, some running past
    the reference's end, one starting at its last base."""
    ref = rng.integers(0, 4, N).astype(np.uint8)
    ref[rng.random(N) < 0.01] = 4
    qlens = rng.integers(Q // 2, Q + 1, n).astype(np.int32)
    qlens[0] = Q
    reads = rng.integers(0, 4, (n, Q)).astype(np.uint8)
    reads[rng.random((n, Q)) < 0.02] = 4
    reads[np.arange(Q)[None, :] >= qlens[:, None]] = 7
    wd = np.zeros((W, 4), np.int64)
    wd[:, 0] = rng.integers(0, N - S // 2, W)
    wd[:, 1] = rng.integers(S // 2, S + 1, W)
    wd[:, 2] = rng.integers(0, n, W)
    wd[:, 3] = rng.integers(0, 2, W)
    wd[::7, 1] = 0                              # empty windows
    wd[3::9, 0] = N - rng.integers(1, S // 2, len(wd[3::9]))   # past the end
    wd[-1, :2] = (N - 1, S)
    # plant each read (or its reverse complement) in its window
    for w in range(0, W, 3):
        r = int(wd[w, 2])
        L = min(int(qlens[r]), int(wd[w, 1]))
        seq = reads[r, :L] if wd[w, 3] == 0 else \
            np.where(reads[r, :L] < 4, 3 - reads[r, :L], reads[r, :L])[::-1]
        at = int(wd[w, 0])
        ref[at: at + L] = seq[: max(0, min(L, N - at))]
    return ref, reads, qlens, wd


@pytest.mark.parametrize("Q,S", [(128, 256), (640, 768)])
def test_step_matches_jax(Q, S):
    rng = np.random.default_rng(Q)
    ref, reads, qlens, wd = _step_inputs(rng, 24, Q, 64, 40_000, S)
    m, go, ge = tali.make_score_matrix()
    matrix = np.asarray(m, np.int32)
    jstep = jfl._dp1_step_fn(matrix.tobytes(), matrix.shape, -go, -ge,
                             on_tpu=False)
    want = np.asarray(jstep(ref, reads, qlens, wd.astype(np.int32), S))
    got = tfl.dp1_step(torch.from_numpy(ref), torch.from_numpy(reads),
                       torch.from_numpy(qlens), torch.from_numpy(wd), S,
                       tsw.device_matrix(matrix, "cpu"), -go, -ge)
    assert got.dtype == torch.int32 and got.shape == (64,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[wd[:, 1] == 0] == 0).all() and int(want.max()) > Q // 2


def test_step_gathers_int64_starts():
    """Window starts past 2^31 on a reference that long reach the bases
    there (the reference's int32 descriptors wrap): shown on a reference
    view whose gather would wrap in int32."""
    rng = np.random.default_rng(5)
    Q, S, W = 128, 192, 8
    ref, reads, qlens, wd = _step_inputs(rng, 4, Q, W, 4096, S)

    class Offset:
        """A reference of 2^31 + 4096 codes whose last 4096 are `ref`
        (and the rest code 7): indexing only touches the tail."""
        shape = ((1 << 31) + len(ref),)
        base = torch.from_numpy(ref)

        def __getitem__(self, idx):
            assert idx.dtype == torch.int64
            return torch.where(idx >= 1 << 31,
                               self.base[(idx - (1 << 31)).clamp(0, len(ref)
                                                                 - 1)], 7)

    m, go, ge = tali.make_score_matrix()
    mat = tsw.device_matrix(m, "cpu")
    far = wd.copy()
    far[:, 0] += 1 << 31
    args = (torch.from_numpy(reads), torch.from_numpy(qlens))
    got = tfl.dp1_step(Offset(), *args, torch.from_numpy(far), S, mat, -go,
                       -ge)
    want = tfl.dp1_step(torch.from_numpy(ref), *args, torch.from_numpy(wd), S,
                        mat, -go, -ge)
    assert torch.equal(got, want) and int(want.max()) > 0


# ------------------------------------------------------------------
# sw_full.cu's strip path, rendered lane for lane
# ------------------------------------------------------------------

def strip_render(q, s, slens, matrix, go: int, ge: int):
    """What sw_full.cu's sw_strip_kernel (the one-warp path) computes, in
    numpy, lane for lane: strips of 512 columns on 32 lanes of 16, strip k
    over every row of the window before strip k + 1, and only the strips
    below the window's qend (one past its last column not of code 7:
    strips of pad code alone are skipped); across a strip boundary a row
    hands on only {H of the last column, the running prefix max of H0 +
    j*ge}, lane 0 folds the latter into its total before the scan; each lane
    keeps a tracking record a strip (key T*256 + 255 - c, strictly
    greater) and merges it into its running one by highest T, lowest row,
    lowest column, as the warp's reduction does at the end.  (The kernel
    is built for int8 matrices alone; a wider one renders the same order
    of work.)  Returns ((best, ti, tj), score-only best) as int64
    arrays."""
    C, L = 16, 32
    q, s = np.asarray(q, np.int64), np.asarray(s, np.int64)
    matrix = np.asarray(matrix, np.int64)
    B, Q = q.shape
    S = s.shape[1]
    rows = np.minimum(np.asarray(slens, np.int64), S)
    nstrip = -(-bounds.query_ends(q) // (C * L))
    c = np.arange(C)
    carry_x = np.zeros((B, S), np.int64)
    carry_y = np.full((B, S), NEG, np.int64)
    bt, bi, bj = (np.zeros((B, L), np.int64) for _ in range(3))
    acc = np.zeros((B, L), np.int64)
    for k in range(-(-Q // (C * L))):
        j0 = k * C * L + np.arange(L) * C                    # [L]
        jj = j0[:, None] + c                                 # [L, C]
        qc = np.where(jj < Q, q[:, np.minimum(jj, Q - 1)], 7) & 7
        H = np.zeros((B, L, C), np.int64)
        Eh = np.zeros((B, L, C), np.int64)
        lthr = np.full((B, L), 255, np.int64)
        lkey = np.full((B, L), 255, np.int64)
        li = np.zeros((B, L), np.int64)
        nx = np.zeros((B, S), np.int64)
        ny = np.full((B, S), NEG, np.int64)
        hprev = np.zeros(B, np.int64)
        for i in range(int(rows.max(initial=0))):
            live = (i < rows) & (k < nstrip)
            w = matrix[(s[:, i] & 7)[:, None, None], qc]     # [B, L, C]
            hleft = np.concatenate([hprev[:, None], H[:, :-1, C - 1]], 1)
            if k > 0:
                hprev, pmc = carry_x[:, i], carry_y[:, i]
            else:
                pmc = np.full(B, NEG, np.int64)
            T = np.concatenate([hleft[..., None], H[..., :C - 1]], 2) + w
            H0 = np.maximum(np.maximum(Eh - i * ge, T), 0)
            run = np.maximum.accumulate(H0 + c * ge, axis=2)
            incl = run[..., -1] + j0 * ge
            incl[:, 0] = np.maximum(incl[:, 0], pmc)
            incl = np.maximum.accumulate(incl, axis=1)
            excl = np.concatenate([pmc[:, None], incl[:, :-1]], 1) - j0 * ge
            cm = np.concatenate([excl[..., None], np.maximum(
                excl[..., None], run[..., :-1])], 2)
            hn = np.maximum(cm - (go + (c - 1) * ge), H0)
            Ehn = np.maximum(hn + ((i + 1) * ge - go), Eh)
            H = np.where(live[:, None, None], hn, H)
            Eh = np.where(live[:, None, None], Ehn, Eh)
            nx[:, i], ny[:, i] = hn[:, L - 1, C - 1], incl[:, L - 1]
            key = (T * 256 + 255 - c).max(axis=2)
            assert np.abs(key).max() < 1 << 31 and np.abs(hn).max() < 1 << 31
            upd = live[:, None] & (key > lthr)
            lkey = np.where(upd, key, lkey)
            li = np.where(upd, i, li)
            lthr = np.where(upd, key | 255, lthr)
            acc = np.where(live[:, None], np.maximum(acc, T.max(axis=2)), acc)
        carry_x, carry_y = nx, ny
        st, sj = lkey >> 8, j0 + 255 - (lkey & 255)
        take = (st > bt) | ((st == bt) & ((li < bi) | ((li == bi) &
                                                       (sj < bj))))
        take &= (k < nstrip)[:, None]
        bt, bi, bj = (np.where(take, a, b) for a, b in ((st, bt), (li, bi),
                                                        (sj, bj)))
    lane = np.argmin(-bt * (1 << 32) + bi * (1 << 16) + bj, axis=1)
    pick = [x[np.arange(B), lane] for x in (bt, bi, bj)]
    hit = pick[0] > 0
    return tuple(np.where(hit, x, 0) for x in pick), acc.max(axis=1)


def _planted(rng, B: int, Q: int, S: int):
    """Windows whose subject starts with a stretch of the query, with 4%
    changes and a few N (5): in every other window the query's last
    columns (so the best cell lies in the last strip), elsewhere from a
    random column; query lengths down to 3/4 of Q (pad code 7)."""
    q = rng.integers(0, 4, (B, Q)).astype(np.int32)
    q[rng.random((B, Q)) < 0.02] = 5
    qlen = rng.integers(Q * 3 // 4, Q + 1, B)
    qlen[1::2] = Q
    q[np.arange(Q)[None, :] >= qlen[:, None]] = 7
    s = rng.integers(0, 4, (B, S)).astype(np.int32)
    n = np.minimum(S, qlen) * 3 // 4
    off = np.where(np.arange(B) % 2 == 1, qlen - n,
                   rng.integers(0, qlen - n + 1))
    for b in range(B):
        piece = q[b, off[b]: off[b] + n[b]]
        s[b, : n[b]] = np.where(piece < 4, piece, 1)
    s[rng.random((B, S)) < 0.04] = rng.integers(0, 4)
    slens = rng.integers(S // 2, S + 1, B).astype(np.int32)
    s[np.arange(S)[None, :] >= slens[:, None]] = 7
    return q, s, slens


@pytest.mark.parametrize("pen", [(1, -2), (200, -200)], ids=["int8", "wide"])
@pytest.mark.parametrize("Q,S", [(513, 96), (640, 160), (1024, 128),
                                 (1100, 144)])
def test_strip_rendering_matches_plain(Q, S, pen):
    rng = np.random.default_rng(Q + S)
    m, go, ge = tali.make_score_matrix(*pen)
    go, ge = -go, -ge
    for kind, gen in (("planted", _planted), ("ties", tsw.tie_windows)):
        q, s, sl = gen(rng, 24, Q, S)
        want = tsw.sw_score_ref(*(torch.from_numpy(x) for x in (q, s, sl)),
                                torch.from_numpy(np.asarray(m, np.int32)),
                                go, ge, track=True)
        (best, ti, tj), best0 = strip_render(q, s, sl, m, go, ge)
        for name, g, w in (("best", best, want[0]), ("ti", ti, want[1]),
                           ("tj", tj, want[2]), ("score-only", best0,
                                                 want[0])):
            np.testing.assert_array_equal(g, w.numpy(), err_msg=(kind, name))
        assert int(want[0].max()) > 0, kind
        if kind == "planted":
            assert (want[2] >= 512).any()


def test_sw_full_cuda_strip_limits():
    """The CUDA wrapper's strip path has no limit on the query (reads past
    16 kb pad to 32,768 columns and more): such a query gets past every
    check but the device's, and CPU tensors are refused (the wrapper never
    runs the plain version).  An empty query is refused."""
    m = tsw.device_matrix(tali.make_score_matrix()[0], "cpu")
    s = torch.zeros((2, 8), dtype=torch.int32)
    sl = torch.full((2,), 8, dtype=torch.int32)
    for Q in (640, 16385, 32768, 100_000):
        q = torch.zeros((2, Q), dtype=torch.int32)
        assert tsw.sw_full_instance(2, Q, 8, m, True) == "sw_full_track_strip"
        with pytest.raises(ValueError, match="cuda"):
            tsw.sw_full_cuda(q, s, sl, m, 2, 1)
    with pytest.raises(ValueError, match="empty query"):
        tsw.sw_full_cuda(torch.zeros((2, 0), dtype=torch.int32), s, sl, m,
                         2, 1)


# ------------------------------------------------------------------
# the lane through both CLIs and the host lane
# ------------------------------------------------------------------

def _long_reads(genome: str, rng, n: int):
    """n reads of 600-700 bp from `genome` with 1% substitutions and a few
    indels, every other one reverse-complemented, as FASTQ text."""
    comp = str.maketrans("ACGT", "TGCA")
    out = []
    for i in range(n):
        L = int(rng.integers(600, 701))
        at = int(rng.integers(0, len(genome) - L - 20))
        seq = list(genome[at: at + L + 20])
        for _ in range(3):
            p = int(rng.integers(20, len(seq) - 20))
            if rng.random() < 0.5:
                del seq[p]
            else:
                seq.insert(p, "ACGT"[int(rng.integers(0, 4))])
        for p in np.flatnonzero(rng.random(len(seq)) < 0.01):
            seq[p] = "ACGT"[("ACGT".index(seq[p]) + 1) % 4]
        r = "".join(seq[:L])
        if i % 2:
            r = r.translate(comp)[::-1]
        out.append(f"@long{i}\n{r}\n+\n{'I' * L}\n")
    return "".join(out)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """tests/data's genome indexed (k13 s4, as the goldens), the first
    N_HEAD of its reads, and 12 reads of 600-700 bp."""
    d = tmp_path_factory.mktemp("dp1")
    refset = RefSet.from_fasta(os.path.join(DATA, "genome.fa"))
    idx = build_index(refset, 13, 4)
    name = str(d / "idx")
    refset.save(name)
    idx.save(name)
    with gzip.open(os.path.join(DATA, "reads_se.fq.gz"), "rb") as f:
        (d / "head.fq").write_bytes(b"".join(f.readlines()[: 4 * N_HEAD]))
    genome = "".join(ln.strip() for ln in open(os.path.join(DATA, "genome.fa"))
                     if not ln.startswith(">"))
    (d / "long.fq").write_text(_long_reads(genome, np.random.default_rng(7),
                                           12))
    return d, refset, idx, name


def _body(path):
    return [ln for ln in open(path).read().splitlines()
            if not ln.startswith("@PG")]


@pytest.fixture(scope="module")
def cli_runs(world, tmp_path_factory):
    """{(reads, lane): SAM lines without @PG} for the host lane, the
    port's and smalt_tpu's `map --device-pass1`, on both read sets (the
    long reads at a batch of 8), and the port's stderr."""
    d, _, _, name = world
    out = tmp_path_factory.mktemp("dp1_out")
    runs, errs = {}, {}
    for reads, batch in (("head", BATCH), ("long", 8)):
        fq = str(d / f"{reads}.fq")
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("SMALT_DP1_BATCH", str(batch))
            mp.setenv("SMALT_DP1_TIMING", "1")
            for lane, main, flags in (
                    ("host", tcli.main, []),
                    ("port", tcli.main, ["--device-pass1", "--device", "cpu"]),
                    ("jax", jcli.main, ["--device-pass1"])):
                sam = str(out / f"{reads}_{lane}.sam")
                rand.ranseed(1)
                trand.ranseed(1)
                with io.StringIO() as err, \
                        pytest.MonkeyPatch.context() as mp2:
                    mp2.setattr("sys.stderr", err)
                    assert main(["map", "-r", "1", "-o", sam] + flags +
                                [name, fq]) == 0
                    errs[(reads, lane)] = err.getvalue()
                runs[(reads, lane)] = _body(sam)
    return runs, errs


@pytest.mark.parametrize("reads,n", [("head", N_HEAD), ("long", 12)])
def test_cli_device_pass1_matches_jax_and_host(cli_runs, reads, n):
    runs, errs = cli_runs
    host = runs[(reads, "host")]
    assert host[0].startswith("@HD")
    assert len([ln for ln in host if ln[:1] != "@"]) == n
    assert runs[(reads, "port")] == host
    assert runs[(reads, "jax")] == host
    total = [ln for ln in errs[(reads, "port")].splitlines()
             if ln.startswith("# dp1-total")]
    assert total and total[0].endswith(f"host_batches=0 nreads={n}")


def test_long_reads_reach_the_strip_shape(world, monkeypatch):
    """The 600-700 bp reads pad to Q = 1,024: the shape sw_full.cu runs in
    two strips on a card."""
    d, refset, idx, _ = world
    peng, _ = _port_engine(refset, idx)
    dev = tfl.DevicePass1.make(peng, "sam", True, False, False, False,
                               batch=8, device="cpu")
    seen = []
    real = tfl.dp1_step

    def spy(ref, reads, *a):
        seen.append(tuple(reads.shape))
        return real(ref, reads, *a)

    monkeypatch.setattr(tfl, "dp1_step", spy)
    dev.run_raw_fastq(str(d / "long.fq"), io.StringIO(),
                      lambda *raw: pytest.fail("host batch"))
    assert seen and all(sh == (8, 1024) for sh in seen)


# ------------------------------------------------------------------
# the batch loop: input order and device errors
# ------------------------------------------------------------------

def _host(refset, idx, fq):
    trand.ranseed(1)
    peng, prs = _port_engine(refset, idx)
    buf = io.StringIO()
    assert run_pipeline_raw_fastq(peng, fq, buf, prs)
    return buf.getvalue()


def test_refused_batch_keeps_input_order(world, monkeypatch):
    """A batch phase A refuses (here the third of four) is rendered on the
    host in its place: the SAM and the drand48 stream equal the host
    lane's (the reference writes it ahead of the two pending batches)."""
    d, refset, idx, _ = world
    fq = str(d / "head.fq")
    calls = []
    real = tfl.DevicePass1._pass1

    def pass1(self, *a, **k):
        calls.append(1)
        return None if len(calls) == 3 else real(self, *a, **k)

    monkeypatch.setattr(tfl.DevicePass1, "_pass1", pass1)
    trand.ranseed(1)
    peng, prs = _port_engine(refset, idx)
    buf = io.StringIO()
    dev = run_device_fastq(peng, fq, buf, prs, exact=False, batch=BATCH,
                           device="cpu")
    assert isinstance(dev, tfl.DevicePass1) and dev.host_batches == 1
    assert len(calls) == 4
    assert buf.getvalue() == _host(refset, idx, fq)


def test_raising_device_leg_raises(world, monkeypatch):
    """A device leg that raises (here on the second batch) ends the run
    with its error: no batch after the first is written, none on the
    host."""
    d, refset, idx, _ = world
    calls = []
    real = tfl.DevicePass1._score_windows

    def score(self, *a):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("device fault")
        return real(self, *a)

    monkeypatch.setattr(tfl.DevicePass1, "_score_windows", score)
    trand.ranseed(1)
    peng, prs = _port_engine(refset, idx)
    buf = io.StringIO()
    with pytest.raises(RuntimeError, match="device fault"):
        run_device_fastq(peng, str(d / "head.fq"), buf, prs, exact=False,
                         batch=BATCH, device="cpu")
    assert len(buf.getvalue().splitlines()) <= BATCH


# ------------------------------------------------------------------
# --device-exact where DeviceExact.make refuses
# ------------------------------------------------------------------

def test_device_exact_falls_back_to_pass1(world, tmp_path, capsys,
                                          monkeypatch):
    """k = 15, step 16 (nskip > wordlen, k > 14): DeviceExact.make refuses
    and DevicePass1 takes the engine, as in smalt_tpu; through the CLI the
    SAM equals the host lane's and stderr names the lane that ran."""
    refset = world[1]
    idx = build_index(refset, 15, 16)
    peng, _ = _port_engine(refset, idx)
    args = (peng, str(world[0] / "head.fq"))
    assert tfl.DeviceExact.make(peng, "sam", True, False, False, False,
                                device="cpu") is None
    lane, _, what = device_lane(*args, exact=True, device="cpu")
    assert isinstance(lane, tfl.DevicePass1) and \
        what == "the --device-pass1 lane"
    # with checkpoints DevicePass1 is skipped: the host lane maps
    assert device_lane(*args, exact=True, resume=True, device="cpu")[0] \
        is None
    name = str(tmp_path / "idx15")
    refset.save(name)
    idx.save(name)
    monkeypatch.setenv("SMALT_DP1_BATCH", str(BATCH))
    bodies = []
    for flags in ([], ["--device-exact", "--device", "cpu"]):
        out = str(tmp_path / f"o{len(bodies)}.sam")
        assert tcli.main(["map", "-r", "1", "-o", out] + flags +
                         [name, args[1]]) == 0
        bodies.append(_body(out))
    assert "--device-exact lane's gates; the --device-pass1 lane maps" in \
        capsys.readouterr().err
    assert len([ln for ln in bodies[0] if ln[:1] != "@"]) == N_HEAD
    assert bodies[1] == bodies[0]
