"""The exact lane's repeat tier (map/fastlane.py DeviceExact): reads whose
host hit expansion passes the main step's H go to a collate step of their
own shape (B, H, C, P of the tier).  Both steps scan with
csrc/segcand.cuh's code (parallel/exact_collate.py segcand_scan: one
kernel launch on CUDA, the header's host build on the CPU).

On the CPU: the host build equals the plain scan (_segcand_scan +
_compact_rows) value for value; `map --device-exact --device cpu` on
corpora of planted repeats, single-end and paired, gives the host lane's
SAM byte for byte with the tier taking every read past H, one scan a
step; on the bundled repeat-poor corpus the tier takes nothing and builds
no step, and the main step scans once a batch.  On a card: the kernel
equals the host build."""
import io
import re

import numpy as np
import pytest
import torch

from smalt_tpu_torch import cli as tcli
from smalt_tpu_torch.native import get_lib
from smalt_tpu_torch.parallel import exact_collate as ec

pytestmark = pytest.mark.skipif(get_lib() is None,
                                reason="native lib required")

FIELD = re.compile(r"(\w+)=([0-9.]+)")
CAUSES = ("rs_h", "rs_dev", "rs_ck", "rs_stats", "rs_geom", "rs_simd")
BASES = "ACGT"
COMP = str.maketrans("ACGT", "TGCA")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the test workers run other CPU lanes beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------
# the scan: host build against the plain version
# ------------------------------------------------------------------

def _lanes(rng, R, H, Q, k, nskip, nseq):
    """[R, H] hit keys sorted as the host-hits step sorts them: per lane
    a few diagonals (shifts) with hits at query offsets along them, some
    on neighbouring shifts and some scattered, in `nseq` sequences."""
    k1 = np.full((R, H), ec.BIG, np.int32)
    k2 = np.full((R, H), ec.BIG, np.int32)
    ks = np.full((R, H), ec.BIG, np.int32)
    tot = rng.integers(0, H + 1, R).astype(np.int32)
    tot[:4] = (0, 1, H, H)
    for r in range(R):
        n = int(tot[r])
        shifts = rng.integers(0, 5000, max(1, n // 6 + 1))
        sh = shifts[rng.integers(0, len(shifts), n)] + \
            rng.choice([0, 0, 0, 1, -1, 2, 40], n)
        q = rng.integers(0, max(1, Q - 100 + 1), n) // nskip * nskip + \
            rng.choice([0, 0, 0, 1], n)
        sq = rng.integers(0, nseq, n)
        order = np.lexsort((q, sh, sq))
        k1[r, :n] = sh[order]
        k2[r, :n] = np.minimum(q[order], Q - k)
        ks[r, :n] = sq[order]
    return k1, k2, ks, tot


@pytest.mark.parametrize("Q,H,C,nseq", [(128, 64, 16, 1), (128, 96, 4, 1),
                                        (256, 80, 32, 3), (128, 48, 96, 2)])
def test_segcand_host_equals_plain(Q, H, C, nseq):
    """segcand_scan on CPU tensors (the host build of the kernel's code)
    gives the plain scan's rows, counts, overflow and bad flags, with and
    without sequence ids, a candidate cap below and above the counts."""
    rng = np.random.default_rng(Q + H + C)
    R, k, nskip = 64, 13, 4
    k1, k2, ks, tot = _lanes(rng, R, H, Q, k, nskip, nseq)
    ivl = torch.from_numpy(ks) if nseq > 1 else None
    cfg = ec.CollateCfg(wordlen=k, nskip=nskip, maxhit=0, B=R // 2, Q=Q,
                        H=H, C=C, host_hits=True, NS=nseq)
    tot_t = torch.from_numpy(tot)
    qlen = torch.full((R,), 100, dtype=torch.int32)
    mdsh = torch.clamp_max((qlen - k) // nskip + 1, k * ec.SEG_DIFFSHIFT //
                           nskip)
    minc = torch.from_numpy(rng.integers(13, 40, R).astype(np.int32))
    rev = (torch.arange(R) % 2) == 1
    valid = torch.arange(H)[None, :] < tot_t[:, None]
    ef, er, bad = ec._segcand_scan(cfg, torch.from_numpy(k1),
                                   torch.from_numpy(k2), valid, mdsh, minc,
                                   rev, ivl=ivl)
    rows, counts, over = ec._compact_rows(cfg, ef, er)
    before = ec.launches["segcand_host"]
    got = ec.segcand_scan(cfg, torch.from_numpy(k1), torch.from_numpy(k2),
                          ivl, tot_t, mdsh, minc)
    assert ec.launches["segcand_host"] == before + 1
    for g, w, what in zip(got, (rows, counts, over, bad),
                          ("rows", "counts", "overflow", "bad")):
        assert torch.equal(g, w), what
    assert counts.sum() > R and over.any() == (counts > C).any()


def test_segcand_refuses_mixed_inputs():
    cfg = ec.CollateCfg(wordlen=13, nskip=4, maxhit=0, B=1, Q=128, H=8)
    z = torch.zeros((2, 8), dtype=torch.int32)
    v = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        ec.segcand_scan(cfg, z, z.long(), None, v, v, v)


def test_segcand_cuda_equals_plain():
    """On a card: the kernel's rows, counts and flags equal the plain
    scan's, one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(5)
    R, H, Q, k, nskip = 96, 200, 128, 13, 4
    k1, k2, ks, tot = _lanes(rng, R, H, Q, k, nskip, 2)
    cfg = ec.CollateCfg(wordlen=k, nskip=nskip, maxhit=0, B=R // 2, Q=Q,
                        H=H, C=24, host_hits=True, NS=2)
    cpu = [torch.from_numpy(x) for x in (k1, k2, ks, tot)]
    qlen = torch.full((R,), 100, dtype=torch.int32)
    mdsh = torch.clamp_max((qlen - k) // nskip + 1, 9)
    minc = torch.from_numpy(rng.integers(13, 40, R).astype(np.int32))
    want = ec.segcand_scan(cfg, cpu[0], cpu[1], cpu[2], cpu[3], mdsh, minc)
    dev = [x.cuda() for x in cpu + [mdsh, minc]]
    before = ec.launches["segcand"]
    got = ec.segcand_scan(cfg, dev[0], dev[1], dev[2], dev[3], dev[4],
                          dev[5])
    torch.cuda.synchronize()
    assert ec.launches["segcand"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


# ------------------------------------------------------------------
# the lane on corpora of planted repeats
# ------------------------------------------------------------------

QLEN = 100


def _repeat_world(d, paired: bool):
    """Two sequences of 24 kb with a 300 bp unit planted 40 times in each
    (copies 0-3% diverged, some on the reverse strand), indexed k 13,
    step 13 (the chr20 cell's index): reads from the copies pass the main
    step's 128 hits a lane, with a few hundred hits.  Single-end: 160
    reads (every other from a copy); paired: 150 pairs of inserts
    250-400 bp."""
    rng = np.random.default_rng(2203 if paired else 2202)
    unit = rng.choice(list(BASES), 300)
    seqs = []
    for _ in range(2):
        g = rng.choice(list(BASES), 24000)
        for at in rng.choice(np.arange(0, 24000 - 300, 300), 40,
                             replace=False):
            cp = unit.copy()
            mut = rng.random(300) < rng.uniform(0, 0.03)
            cp[mut] = rng.choice(list(BASES), int(mut.sum()))
            s = "".join(cp)
            g[at:at + 300] = list(s if rng.random() < 0.5 else
                                  s.translate(COMP)[::-1])
        seqs.append("".join(g))
    (d / "g.fa").write_text("".join(f">c{i}\n{g}\n"
                                    for i, g in enumerate(seqs)))

    def read(s, at, rc):
        r = list(seqs[s][at:at + QLEN])
        for _ in range(int(rng.integers(0, 3))):
            r[int(rng.integers(0, QLEN))] = BASES[int(rng.integers(0, 4))]
        r = "".join(r)
        return r.translate(COMP)[::-1] if rc else r

    def rec(name, r):
        return f"@{name}\n{r}\n+\n{'5' * len(r)}\n"

    if not paired:
        recs = []
        for i in range(160):
            s = int(rng.integers(0, 2))
            at = int(rng.integers(0, len(seqs[s]) - QLEN))
            recs.append(rec(f"r{i}", read(s, at, rng.random() < 0.5)))
        (d / "r.fq").write_text("".join(recs))
        return
    r1, r2 = [], []
    for i in range(150):
        s = int(rng.integers(0, 2))
        ins = int(rng.integers(250, 400))
        st = int(rng.integers(0, len(seqs[s]) - ins))
        r1.append(rec(f"p{i}", read(s, st, False)))
        r2.append(rec(f"p{i}", read(s, st + ins - QLEN, True)))
    (d / "r1.fq").write_text("".join(r1))
    (d / "r2.fq").write_text("".join(r2))


def _index(d, k, s, fa="g.fa"):
    with io.StringIO() as err, pytest.MonkeyPatch.context() as mp:
        mp.setattr("sys.stderr", err)
        assert tcli.main(["index", "-k", str(k), "-s", str(s),
                          str(d / "idx"), str(d / fa)]) == 0


def _map(d, reads, batch, device_exact=True):
    """`map [--device-exact --device cpu] -r 1` on the corpus in d: (SAM
    lines without @PG, the lane's `# dx(p)-batch` lines as dicts, its
    total line)."""
    sam = d / f"out{len(list(d.glob('out*.sam')))}.sam"
    flags = ["--device-exact", "--device", "cpu"] if device_exact else []
    with pytest.MonkeyPatch.context() as mp, io.StringIO() as err:
        for k in ("SMALT_DX_P2", "SMALT_FL_TIMING", "SMALT_DX_H",
                  "SMALT_DX_POOL"):
            mp.delenv(k, raising=False)
        mp.setenv("SMALT_DP1_TIMING", "1")
        mp.setenv("SMALT_DX_BATCH", str(batch))
        mp.setattr("sys.stderr", err)
        assert tcli.main(["map", *flags, "-r", "1", "-o", str(sam),
                          str(d / "idx"), *[str(d / r) for r in reads]]) == 0
        text = err.getvalue()
    body = [ln for ln in sam.read_text().splitlines()
            if not ln.startswith("@PG")]
    lines = [{k: float(v) for k, v in FIELD.findall(ln)}
             for ln in text.splitlines() if re.match(r"# dxp?-batch ", ln)]
    total = [ln for ln in text.splitlines() if re.match(r"# dxp?-total ", ln)]
    return body, lines, total


@pytest.fixture(scope="module", params=["se", "pe"])
def repeat_runs(request, tmp_path_factory):
    mode = request.param
    d = tmp_path_factory.mktemp(f"tier_{mode}")
    _repeat_world(d, mode == "pe")
    _index(d, 13, 13)
    reads = ["r.fq"] if mode == "se" else ["r1.fq", "r2.fq"]
    before = dict(ec.launches)
    dx = _map(d, reads, 64 if mode == "se" else 128)
    calls = {k: ec.launches[k] - before[k] for k in before}
    host = _map(d, reads, 64, device_exact=False)
    return mode, dx, host, calls


def test_tier_sam_equals_host_lane(repeat_runs):
    """The lane with its repeat tier writes the host lane's SAM."""
    _, (dx, _, _), (host, _, _), _ = repeat_runs
    assert len(dx) > 150 and dx == host


def test_tier_takes_every_read_past_h(repeat_runs):
    """The tier takes rows in every batch of these corpora, none is
    re-staged for its hits (rs_h = 0: every lane lies below the tier's
    ceiling), at most every tier row re-stages for another cause, the six
    causes still sum to `restaged`, and the host build scanned each batch
    twice: the main step's lanes and the tier's."""
    mode, (_, lines, _), _, calls = repeat_runs
    assert len(lines) == 3
    assert all(b["tier"] > 0 for b in lines), lines
    for b in lines:
        assert b["rs_h"] == 0, b
        assert 0 <= b["tier_rs"] <= b["tier"], b
        assert sum(b[c] for c in CAUSES) == b["restaged"], b
    assert calls == {"segcand": 0, "segcand_host": 2 * len(lines)}, calls


def test_no_tier_on_a_repeat_poor_corpus(tmp_path, data_dir):
    """The bundled corpus (reads_se over genome.fa, k 13 s 4): no read
    passes H, so the tier takes no row and builds no step (one collate
    step in all), and the scan runs once a batch, for the main step's
    lanes; the SAM is the host lane's."""
    import gzip
    with gzip.open(f"{data_dir}/reads_se.fq.gz", "rb") as f:
        (tmp_path / "r.fq").write_bytes(b"".join(f.readlines()[:800]))
    (tmp_path / "g.fa").write_bytes(open(f"{data_dir}/genome.fa",
                                         "rb").read())
    _index(tmp_path, 13, 4)
    before = dict(ec.launches)
    dx, lines, total = _map(tmp_path, ["r.fq"], 64)
    host, _, _ = _map(tmp_path, ["r.fq"], 64, device_exact=False)
    assert dx == host and len(lines) == 4
    assert all(b["tier"] == 0 and b["tier_rs"] == 0 for b in lines)
    calls = {k: ec.launches[k] - before[k] for k in before}
    assert calls == {"segcand": 0, "segcand_host": len(lines)}, calls
    assert re.search(r"steps_built=1$", total[0]), total
