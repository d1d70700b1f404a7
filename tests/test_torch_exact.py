"""`map --device-exact` through the port (smalt_tpu_torch) against
smalt_tpu on the CPU, with exact integer equality and equal dtypes: the
pass-2 fill + walk and its step, the host-hits collate step and its
sorts, the lane end to end (SAM byte-identical to the host C lane and
to the JAX lane, with equal counters) and the CLI.  Each package works
on an engine of its own over the same index arrays, and seeds its own
drand48 state before a run."""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smalt_tpu import rand
from smalt_tpu.align.core import AliBand, BandError
from smalt_tpu.index.table import build_index
from smalt_tpu.map import fastlane as jfl
from smalt_tpu.map.engine import MapEngine, MapParams
from smalt_tpu.map.fastlane import FastLane, codec_encode_bulk
from smalt_tpu.map.pipeline import run_pipeline_raw_fastq
from smalt_tpu.native import get_lib
from smalt_tpu.parallel import exact_collate as jcol
from smalt_tpu.parallel import exact_pass2 as jp2
from smalt_tpu.seq.refset import RefSet
from smalt_tpu_torch import rand as trand
from smalt_tpu_torch.map import engine as teng
from smalt_tpu_torch.map.fastlane import DeviceExact
from smalt_tpu_torch.map.pipeline import run_device_exact_fastq
from smalt_tpu_torch.ops import sw as tsw
from smalt_tpu_torch.parallel import exact_collate as tcol
from smalt_tpu_torch.parallel import exact_pass2 as tp2
from test_device_pass2 import default_matrix, gen_case
from test_torch_standalone import port_index, port_refset, run_port_cli

GI, GE = 4, 3
QLEN = 100


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(got, want, what):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


def _windows(rng, n, Qp, Sp):
    """gen_case windows (tests/test_device_pass2.py) in the oracle's par
    layout, with lead-pinned rows (q_left > l_edge) and the edges of
    mark_edge_windows: s_left > 0, dummy (valid 0 / slen -1) and best-0
    (an all-pad subject) windows."""
    matrix = default_matrix()
    qa = np.full((n, Qp), 7, np.int32)
    sj = np.full((n, Sp), 7, np.int32)
    par = np.zeros((n, 8), np.int32)
    w = 0
    while w < n:
        qlen, qalpha, subj, slen, cqs, cqe, bl, br, _ = \
            gen_case(rng, matrix, GI, GE)
        if slen > Sp or qlen > Qp:
            continue
        try:
            band = AliBand.make(bl, br, cqs, cqe, qlen, 0, slen - 1, slen)
        except BandError:
            continue
        qa[w, :qlen] = qalpha
        sj[w, :slen] = subj
        par[w] = [band.l_edge, band.r_edge, band.q_left, band.q_len,
                  band.s_len, 1, band.s_left, 0]
        w += 1
    tp2.mark_edge_windows(rng, sj, par)
    return qa, sj, par


@pytest.mark.parametrize("gen,seed,Qp,Sp", [
    ("gen_case", 1, 128, 192), ("gen_case", 2, 128, 256),
    ("gen_case", 3, 256, 96),
    # the generator chip_smoke.py holds the kernel against its plain
    # version with, at the lane's shapes
    ("synth", 6, 128, 256), ("synth", 7, 256, 512)])
def test_swq_ref_matches_jax(gen, seed, Qp, Sp):
    rng = np.random.default_rng(seed)
    if gen == "synth":
        qa, sj, par = tp2.synth_windows(rng, 96, Qp, Sp)
    else:
        qa, sj, par = _windows(rng, 96, Qp, Sp)
    matrix = default_matrix()
    want = jp2.swq_fill_walk_ref(qa, sj, par, matrix, GI, GE)
    got = tp2.swq_fill_walk_ref(torch.from_numpy(qa), torch.from_numpy(sj),
                                torch.from_numpy(par),
                                torch.from_numpy(matrix), GI, GE)
    for g, w_, what in zip(got, want, ("best", "mi", "mj", "rec")):
        _assert_same(g, w_, what)
    best = _np(want[0])
    assert (best == 0).sum() >= 12 and (best > 0).sum() >= 24
    assert (_np(want[3]) & 3 == 0).any()           # some SUSPECT / blank


def _pass2_inputs(rng, B=24, Qp=128, Sp=256, nw=160, L=6000):
    """A resident reference, a batch of mangled reads and pass-2 window
    descriptors on both strands, with wlen = 0 (dummy) windows."""
    ref_alpha = rng.integers(0, 4, L).astype(np.uint8)
    ref_alpha[rng.random(L) < 0.01] = 4
    qlens = rng.integers(60, Qp + 1, B).astype(np.int32)
    reads = np.zeros((B, Qp), np.uint8)
    starts = rng.integers(0, L - Sp, B)
    for b in range(B):
        s = np.frombuffer(b"ACGT", np.uint8)[
            ref_alpha[starts[b]: starts[b] + qlens[b]] & 3].copy()
        s[rng.random(qlens[b]) < 0.03] = ord("N")
        reads[b, :qlens[b]] = np.frombuffer(codec_encode_bulk(s), np.uint8)
    wd = np.zeros((nw, 12), np.int32)
    w = 0
    while w < nw:
        b = int(rng.integers(0, B))
        q = int(qlens[b])
        slen = int(rng.integers(q // 2, Sp + 1))
        cqs = int(rng.integers(0, q // 3))
        cqe = int(rng.integers(2 * q // 3, q))
        bl = int(rng.integers(-20, 10))
        try:
            band = AliBand.make(bl, bl + int(rng.integers(2, 40)), cqs, cqe,
                                q, 0, slen - 1, slen)
        except BandError:
            continue
        wlen = 0 if w % 9 == 4 else int(rng.integers(band.s_len, Sp + 1))
        wd[w] = [max(0, int(starts[b]) + int(rng.integers(-8, 8))),
                 band.s_len, b, w % 2, band.l_edge, band.r_edge,
                 band.q_left, band.q_len, band.s_left, wlen, 0, 0]
        w += 1
    return ref_alpha, reads, qlens, wd


def test_pass2_step_matches_jax():
    ref_alpha, reads, qlens, wd = _pass2_inputs(np.random.default_rng(4))
    m = default_matrix()
    Sp = 256
    want = np.asarray(jp2.build_pass2_step(m.tobytes(), m.shape, GI, GE,
                                           False)(
        jnp.asarray(ref_alpha), jnp.asarray(reads), jnp.asarray(qlens),
        jnp.asarray(wd), Sp))
    got = tp2.build_pass2_step(m, GI, GE, "cpu")(
        torch.from_numpy(ref_alpha), torch.from_numpy(reads),
        torch.from_numpy(qlens), torch.from_numpy(wd), Sp, 1)
    _assert_same(got, want, "packed [W, 3 + Sp/2]")
    best = want[:, 0]
    assert (best > 0).sum() >= 60 and (best[wd[:, 9] == 0] == 0).all()
    for g, w_ in zip(tp2.unpack_pass2(_np(got), 150, Sp),
                     jp2.unpack_pass2(want, 150, Sp)):
        _assert_same(g, w_, "unpack_pass2")


def test_redeclared_constants_match_jax():
    """The port re-declares what it cannot import without jax."""
    for name in ("NREPEATS", "SEG_DIFFSHIFT", "EDGE_BAND_FACTOR",
                 "MAX_BANDEDGE_2POW", "MINLEN_QUERY_STRIPED", "BWSCAL_QLEN",
                 "BIG", "MMALI_BIT"):
        assert int(getattr(tcol, name)) == int(getattr(jcol, name)), name
    assert tp2.NEG == jp2.NEG
    a = jcol.CollateCfg(wordlen=13, nskip=2, maxhit=9, B=4, Q=128)
    b = tcol.CollateCfg(wordlen=13, nskip=2, maxhit=9, B=4, Q=128)
    assert vars(a) == vars(b) and a.pool == b.pool


def test_lexsort_matches_lax_sort():
    """Equal k1 (ties broken by k2, then ks), negative k1 and the BIG
    pad sort as jax.lax.sort(num_keys=2 / 3) sorts them."""
    rng = np.random.default_rng(9)
    R, H = 16, 64
    k1 = rng.integers(-40, 40, (R, H)).astype(np.int32)
    k2 = rng.integers(0, 8, (R, H)).astype(np.int32)
    ks = rng.integers(0, 3, (R, H)).astype(np.int32)
    pad = np.arange(H)[None, :] >= rng.integers(0, H, R)[:, None]
    big = np.int32(tcol.BIG)
    k1, k2, ks = (np.where(pad, big, x) for x in (k1, k2, ks))
    k1[0, :4] = [-(1 << 30), 1 << 30, -5, -5]
    for keys in ([k1, k2], [ks, k1, k2]):
        want = jax.lax.sort([jnp.asarray(x) for x in keys],
                            num_keys=len(keys))
        got = tcol.lexsort_rows([torch.from_numpy(x) for x in keys])
        for g, w_ in zip(got, want):
            _assert_same(g, w_, f"{len(keys)} keys")


def _corpus(tmp_path, kind, nskip=2):
    """The three corpora of tests/test_device_exact.py:188-397 (two
    sequences with a heavy repeat; one sequence; many contigs), ~200
    reads each plus repeat-unit reads the device must re-stage, indexed
    at step `nskip`."""
    rng = np.random.default_rng({"two_seq": 11, "one_seq": 23,
                                 "contigs": 31}[kind])
    bases = "ACGT"
    comp = str.maketrans("ACGT", "TGCA")
    if kind == "contigs":
        unit = "".join(rng.choice(list(bases), 300))
        seqs = []
        for s in range(60):
            g = "".join(rng.choice(list(bases), 1200 + 507 * (s % 5)))
            if s % 3 == 0:
                at = int(rng.integers(0, len(g) - 300))
                g = g[:at] + unit + g[at + 300:]
            seqs.append(g)
        k = 16
    else:
        unit = "".join(rng.choice(list(bases), 400))
        seqs = []
        for _ in range(2 if kind == "two_seq" else 1):
            L = 15000 if kind == "two_seq" else 30000
            g = "".join(rng.choice(list(bases), L))
            for _ in range(25 if kind == "two_seq" else 20):
                at = int(rng.integers(0, L - 400))
                g = g[:at] + unit + g[at + 400:]
            seqs.append(g)
        k = 11
    fa = tmp_path / "g.fa"
    fa.write_text("".join(f">c{i}\n{g}\n" for i, g in enumerate(seqs)))
    refset = RefSet.from_fasta(str(fa))
    idx = build_index(refset, k, nskip)
    _ = idx.addrs
    recs = []
    for i in range(200):
        s = int(rng.integers(0, len(seqs)))
        pos = int(rng.integers(0, max(len(seqs[s]) - QLEN, 1)))
        r = list(seqs[s][pos:pos + QLEN].ljust(QLEN, "A"))
        if i % 2:
            for _ in range(3):
                r[int(rng.integers(0, QLEN))] = bases[int(rng.integers(0, 4))]
        r = "".join(r)
        if rng.random() < 0.5:
            r = r.translate(comp)[::-1]
        recs.append(f"@r{i}\n{r}\n+\n{'5' * QLEN}\n")
    for i in range(4):
        recs.append(f"@rep{i}\n{unit[:QLEN]}\n+\n{'5' * QLEN}\n")
    fq = tmp_path / "r.fq"
    fq.write_text("".join(recs))
    return refset, idx, str(fq)


def _port_engine(refset, idx):
    """The port's MapEngine on its own RefSet / KmerIndex over the arrays
    of the reference package's."""
    prs = port_refset(refset)
    return teng.MapEngine(prs, port_index(idx), teng.MapParams()), prs


def _raw_batch(fq, n):
    from smalt_tpu.map.fastmode import iter_fastq_batches
    return next(iter(iter_fastq_batches(fq, n)))


@pytest.mark.parametrize("kind", ["one_seq", "contigs"])
def test_collate_matches_jax(tmp_path, kind):
    """The host-hits collate step on inputs made by DeviceExact._pre:
    one sequence (NS = 1, no per-hit sequence ids) and 60 contigs
    (NS > 1, sort led by the sequence id)."""
    if get_lib() is None:
        pytest.skip("native lib required")
    refset, idx, fq = _corpus(tmp_path, kind)
    eng = MapEngine(refset, idx, MapParams())
    port = DeviceExact.make(_port_engine(refset, idx)[0], "sam", True, False,
                            False, False, batch=256, device="cpu")
    assert port is not None and port._host_hits
    host, dargs = port._prepare(*_raw_batch(fq, 256))
    assert (len(dargs) == 7) == (kind == "contigs")
    ref = jfl.DeviceExact.make(eng, "sam", True, False, False, False,
                               batch=256, interpret=True)
    want = ref._collate_fn()(*[jnp.asarray(x.numpy()) for x in dargs])
    got = port._collate_outputs(dargs)
    for g, w_, what in zip(got, want, ("pool", "counts2", "scores",
                                       "fallback")):
        _assert_same(g, w_, what)
    pool, counts2, scores, fb = got
    assert counts2.sum() > 204 and (scores > 0).sum() > 150
    assert fb.any() and not fb.all()      # repeat reads flag, others pass


def _device_hit_corpus(tmp_path, seed, k, nskip, nseq):
    """tests/test_device_exact.py:28's corpus (sequences with planted
    repeat units, 2% substitutions, N codes, qualities of 35-74) with
    `nseq` sequences, as (refset, index, FASTQ path) of 32 reads."""
    from test_device_exact import _corpus as dx_corpus
    refset, idx, reads = dx_corpus(tmp_path, seed, k, nskip, nreads=32,
                                   glen=12000 * nseq)
    if nseq != 3:                 # the corpus writes three sequences
        fa = tmp_path / "g.fa"
        seqs = fa.read_text().split(">")[1:]
        fa.write_text("".join(">" + x for x in seqs[:nseq]))
        refset = RefSet.from_fasta(str(fa))
        idx = build_index(refset, k, nskip)
        _ = idx.addrs
        g = "".join(x.split("\n", 1)[1].replace("\n", "") for x in seqs[:1])
        rng = np.random.default_rng(seed)
        reads = []
        for i in range(32):
            pos = int(rng.integers(0, len(g) - QLEN))
            r = g[pos:pos + QLEN]
            if i % 2:
                r = r.translate(str.maketrans("ACGT", "TGCA"))[::-1]
            reads.append((r, rng.integers(35, 74, QLEN).astype(
                np.uint8).tobytes()))
    fq = tmp_path / "r.fq"
    fq.write_text("".join(f"@r{i}\n{r}\n+\n{q.decode('latin-1')}\n"
                          for i, (r, q) in enumerate(reads)))
    return refset, idx, str(fq)


@pytest.mark.parametrize("seed,k,nskip,nseq", [
    (1, 11, 2, 3), (2, 13, 4, 3), (3, 12, 1, 3),
    (4, 11, 12, 3),       # nskip > wordlen: the regime the lane runs it in
    (5, 12, 2, 1),        # one sequence: the identity-slice shortcut
])
def test_device_hit_collate_matches_jax(tmp_path, monkeypatch, seed, k,
                                        nskip, nseq):
    """The device-hit collate step (hit info, checksum, the V interval
    slots' expansion, sort and scan, the pool over V slots) on inputs made
    by DeviceExact._prepare: its five outputs equal the JAX `_step`'s on
    tests/test_device_exact.py's corpora, and its checksum the C pre
    block's.  Where nskip <= wordlen the lane would expand the hits on the
    host; both packages are told it cannot, as for nskip > wordlen."""
    if get_lib() is None:
        pytest.skip("native lib required")
    refset, idx, fq = _device_hit_corpus(tmp_path, seed, k, nskip, nseq)
    for cls in (DeviceExact, jfl.DeviceExact):
        monkeypatch.setattr(cls, "_host_hits_ok",
                            staticmethod(lambda eng: False))
    eng = MapEngine(refset, idx, MapParams())
    port = DeviceExact.make(_port_engine(refset, idx)[0], "sam", True, False,
                            False, False, batch=32, device="cpu")
    assert port is not None and not port._host_hits
    host, dargs = port._prepare(*_raw_batch(fq, 32))
    assert len(dargs) == 5 and port._cfg.V == nseq
    ref = jfl.DeviceExact.make(eng, "sam", True, False, False, False,
                               batch=32, interpret=True)
    want = ref._collate_fn()(*[jnp.asarray(x.numpy()) for x in dargs])
    got = port._collate_outputs(dargs)
    for g, w_, what in zip(got, want, ("pool", "counts2", "scores",
                                       "cksum", "fallback")):
        _assert_same(g, w_, what)
    pool, counts2, scores, cksum, fb = got
    pre = host[8]
    np.testing.assert_array_equal(cksum[:32],
                                  pre[:, 6:10].reshape(32, 2, 2))
    assert counts2.sum() >= 32 and (scores > 0).sum() >= 16
    assert not fb.all()


@pytest.mark.parametrize("kind,p2", [("two_seq", "1"), ("one_seq", None),
                                     ("contigs", "1")])
def test_end_to_end_byte_identical(tmp_path, monkeypatch, kind, p2):
    """The port's lane on the CPU == the host C lane == the JAX lane,
    byte for byte, with the JAX lane's counters but for the reads past H
    that the port's repeat tier kept on the device (the JAX lane re-stages
    them): the port re-stages exactly those fewer, and its pass-2
    counters exceed the JAX lane's by exactly what those reads alone give
    the port."""
    if get_lib() is None:
        pytest.skip("native lib required")
    if p2 is None:
        monkeypatch.delenv("SMALT_DX_P2", raising=False)
    else:
        monkeypatch.setenv("SMALT_DX_P2", p2)
    refset, idx, fq = _corpus(tmp_path, kind)
    post = DeviceExact._post_batch

    def port(path):
        """The port's lane on the reads in path: (the lane, its SAM, the
        places in path of the reads its repeat tier kept)."""
        kept, seen = [], [0]

        def spy(self, host, outs, pair=False):
            got = post(self, host, outs, pair)
            t_rows = host[12]
            if got is not None and t_rows is not None:
                state, offs = got[0][8], got[0][9]
                took = np.nonzero(t_rows >= 0)[0]
                kept.extend(seen[0] + took[state[offs[took] + 7] != 1])
            seen[0] += host[0]
            return got

        peng, prs = _port_engine(refset, idx)
        buf = io.StringIO()
        with monkeypatch.context() as mp:
            mp.setattr(DeviceExact, "_post_batch", spy)
            dev = run_device_exact_fastq(peng, path, buf, prs, batch=64,
                                         device="cpu")
        assert dev.host_batches == 0
        assert len(kept) == dev.n_tier - dev.n_tier_rs
        return dev, buf.getvalue(), kept

    outs, counters = [], []
    for which in ("host", "jax", "port"):
        rand.ranseed(1)
        trand.ranseed(1)
        eng = MapEngine(refset, idx, MapParams())
        buf = io.StringIO()
        if which == "host":
            assert run_pipeline_raw_fastq(eng, fq, buf, refset)
        elif which == "jax":
            lane = FastLane.make(eng, "sam", True, False, False, False)
            dev = jfl.DeviceExact.make(eng, "sam", True, False, False,
                                       False, batch=64, interpret=True)
            dev.run_raw_fastq(fq, buf, lambda a, b, c:
                              lane.render_raw_block(a, b, c))
        else:
            dev, text, kept = port(fq)
            buf.write(text)
        if which != "host":
            counters.append((dev.n_restaged, dev.p2_used, dev.p2_fb,
                             dev.p2_hit))
        outs.append(buf.getvalue())
    assert len(outs[0].splitlines()) == 204
    assert outs[2] == outs[0] and outs[1] == outs[0]
    extra = (0, 0, 0)
    if kept:
        # the kept reads alone through the port: the tier takes and keeps
        # every one again, and their pass-2 counts are the difference
        lines = open(fq).read().splitlines(keepends=True)
        sub = tmp_path / "kept.fq"
        sub.write_text("".join("".join(lines[4 * i:4 * i + 4])
                               for i in sorted(kept)))
        rand.ranseed(1)
        trand.ranseed(1)
        alone, _, again = port(str(sub))
        assert alone.n_restaged == 0 and len(again) == len(kept)
        extra = (alone.p2_used, alone.p2_fb, alone.p2_hit)
    jx, pt = counters
    assert pt[0] + len(kept) == jx[0], (counters, len(kept))
    assert pt[1:] == tuple(j + e for j, e in zip(jx[1:], extra)), \
        (counters, extra)
    n_restaged, p2_used, _, p2_hit = counters[1]
    assert n_restaged > 0
    assert (p2_used >= 50 and p2_hit >= 5) if p2 else p2_used == 0


@pytest.mark.parametrize("kind,p2", [("two_seq", None), ("one_seq", "1")])
def test_end_to_end_device_hits(tmp_path, monkeypatch, kind, p2):
    """On an index with nskip > wordlen (k 11, step 12; two sequences, V =
    2, and one) the lane runs the device hit expansion: SAM == the host C
    lane == the JAX lane, byte for byte, with the JAX lane's counters,
    device pass 2 off and on, and no batch rendered on the host.  (On the
    two-sequence corpus most reads hold more candidate rows than the
    pool's 6 a read and re-stage, in both lanes alike.)"""
    if get_lib() is None:
        pytest.skip("native lib required")
    if p2 is None:
        monkeypatch.delenv("SMALT_DX_P2", raising=False)
    else:
        monkeypatch.setenv("SMALT_DX_P2", p2)
    refset, idx, fq = _corpus(tmp_path, kind, nskip=12)
    outs, counters = [], []
    for which in ("host", "jax", "port"):
        rand.ranseed(1)
        trand.ranseed(1)
        eng = MapEngine(refset, idx, MapParams())
        buf = io.StringIO()
        if which == "host":
            assert run_pipeline_raw_fastq(eng, fq, buf, refset)
        elif which == "jax":
            lane = FastLane.make(eng, "sam", True, False, False, False)
            dev = jfl.DeviceExact.make(eng, "sam", True, False, False,
                                       False, batch=64, interpret=True)
            assert not dev._host_hits
            dev.run_raw_fastq(fq, buf, lambda a, b, c:
                              lane.render_raw_block(a, b, c))
        else:
            peng, prs = _port_engine(refset, idx)
            dev = run_device_exact_fastq(peng, fq, buf, prs, batch=64,
                                         device="cpu")
            assert dev.host_batches == 0 and not dev._host_hits
        if which != "host":
            counters.append((dev.n_restaged, dev.p2_used, dev.p2_fb,
                             dev.p2_hit))
        outs.append(buf.getvalue())
    assert len(outs[0].splitlines()) == 204
    assert outs[2] == outs[0] and outs[1] == outs[0]
    assert counters[1] == counters[0], counters
    n_restaged, p2_used, _, p2_hit = counters[1]
    assert n_restaged < 204
    assert (p2_used >= 50 and p2_hit >= 5) if p2 else p2_used == 0


@pytest.mark.parametrize("p2", [None, "1"])
def test_host_rendered_batch_keeps_input_order(tmp_path, monkeypatch, p2):
    """A batch the lane does not take (here the third of 64 reads, which
    holds one read over QMAX = 255 bp) is rendered on the host in its
    place: the SAM and the repeat placements drawn from the RNG equal
    the host C lane's, byte for byte."""
    if get_lib() is None:
        pytest.skip("native lib required")
    if p2 is None:
        monkeypatch.delenv("SMALT_DX_P2", raising=False)
    else:
        monkeypatch.setenv("SMALT_DX_P2", p2)
    refset, idx, fq = _corpus(tmp_path, "two_seq")
    genome = (tmp_path / "g.fa").read_text().splitlines()[1]
    long_read = genome[5000:5300]
    recs = open(fq).read().splitlines(keepends=True)
    at = 4 * 150                                   # read 150: batch 2
    recs[at:at] = [f"@long\n{long_read}\n+\n{'5' * len(long_read)}\n"]
    with open(fq, "w") as f:
        f.write("".join(recs))
    outs = []
    for which in ("host", "port"):
        rand.ranseed(1)
        trand.ranseed(1)
        buf = io.StringIO()
        if which == "host":
            eng = MapEngine(refset, idx, MapParams())
            assert run_pipeline_raw_fastq(eng, fq, buf, refset)
        else:
            peng, prs = _port_engine(refset, idx)
            dev = run_device_exact_fastq(peng, fq, buf, prs, batch=64,
                                         device="cpu")
            assert dev.host_batches == 1 and dev.n_restaged > 0
        outs.append(buf.getvalue())
    lines = outs[1].splitlines()
    assert len(lines) == 205 and lines[150].startswith("long\t")
    assert outs[1] == outs[0]


@pytest.mark.parametrize("p2", [None, "1"])
def test_cli_matches_jax_cli(tmp_path, monkeypatch, p2):
    from smalt_tpu import cli as jcli
    if get_lib() is None:
        pytest.skip("native lib required")
    if p2 is None:
        monkeypatch.delenv("SMALT_DX_P2", raising=False)
    else:
        monkeypatch.setenv("SMALT_DX_P2", p2)
    refset, idx, fq = _corpus(tmp_path, "two_seq")
    name = str(tmp_path / "idx")
    refset.save(name)
    idx.save(name)
    got, want = str(tmp_path / "got.sam"), str(tmp_path / "want.sam")
    # the port's CLI in a process where smalt_tpu and jax cannot be imported
    r = run_port_cli(["map", "--device-exact", "--device", "cpu", "-r", "1",
                      "-o", got, name, fq])
    assert r.returncode == 0, r.stderr
    assert jcli.main(["map", "-r", "1", "-o", want, name, fq]) == 0
    body = [open(p).read().splitlines() for p in (got, want)]
    assert body[0][0].startswith("@HD")
    assert len([ln for ln in body[0] if not ln.startswith("@")]) == 204
    assert [ln for ln in body[0] if not ln.startswith("@PG")] == \
        [ln for ln in body[1] if not ln.startswith("@PG")]


def test_swq_cuda_refuses_cpu_tensors():
    """The kernel wrapper never runs the plain version: a tensor off the
    card is an error (build_pass2_step picks the plain version by the
    device instead)."""
    qa, sj, par = _windows(np.random.default_rng(5), 4, 128, 64)
    m = default_matrix()
    with pytest.raises(ValueError, match="cuda"):
        tp2.swq_cuda(*(torch.from_numpy(x) for x in (qa, sj, par)),
                     tsw.device_matrix(m, "cpu"), GI, GE, 1)


@pytest.mark.parametrize("extra,note", [
    # explicit ids: a case keeps its name when cases are added or removed
    # (-f bam and --resume map: tests/test_torch_exact_io.py).  Both runs
    # exited 2 until the port took the reference's handoff to its host
    # lane (the note on stderr names it): now each writes `map`'s SAM
    pytest.param(["-n", "2"], "apply to serial FASTQ runs (--device-pass1: "
                 "single-end only); ignored", id="extra2-Queue 1 #6e"),
    pytest.param(["-S", "gapopen=-1,gapext=-3"],    # both lanes' make refuse
                 "outside the --device-exact lane's gates; the host lane maps",
                 id="extra3-Queue 1 #6e"),
])
def test_cli_unported_exact_cases_exit_2(tmp_path, capsys, extra, note):
    from smalt_tpu_torch import cli as tcli
    refset, idx, fq = _corpus(tmp_path, "one_seq")
    name = str(tmp_path / "idx")
    refset.save(name)
    idx.save(name)
    got, want = str(tmp_path / "o.sam"), str(tmp_path / "host.sam")
    rc = tcli.main(["map", "--device-exact", "--device", "cpu", "-r", "1",
                    "-o", got] + extra + [name, fq])
    assert rc == 0
    assert note in capsys.readouterr().err
    assert tcli.main(["map", "-r", "1", "-o", want] + extra + [name, fq]) == 0
    body = [[ln for ln in open(p).read().splitlines()
             if not ln.startswith("@PG")] for p in (got, want)]
    assert len([ln for ln in body[1] if ln[:1] != "@"]) == 204
    assert body[0] == body[1]


@pytest.fixture(scope="module")
def one_seq_index(tmp_path_factory):
    """The one-sequence corpus, saved: (index name, reads path)."""
    d = tmp_path_factory.mktemp("one_seq")
    refset, idx, fq = _corpus(d, "one_seq")
    name = str(d / "idx")
    refset.save(name)
    idx.save(name)
    return name, fq


@pytest.mark.parametrize("spec,rng", [("match=128", "-130..128"),
                                      ("subst=-200", "-201..1")])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_cli_matrix_outside_int8_exits_2(one_seq_index, tmp_path, capsys,
                                         monkeypatch, device, spec, rng):
    """A -S that gives the matrix an entry outside -128..127 maps under
    --device-exact as the host C lane maps it: byte-identical SAM (the
    @PG line aside), device pass 2 off and on, no batch rendered on the
    host.  With no card visible the cuda case gets past every host check
    and stops at the device check (exit 1), as an int8 matrix does."""
    from smalt_tpu_torch import cli as tcli
    from smalt_tpu_torch.align.core import make_score_matrix
    m = make_score_matrix(*tcli._parse_penalties(spec))[0]
    assert f"{int(m.min())}..{int(m.max())}" == rng
    name, fq = one_seq_index
    want = str(tmp_path / "host.sam")
    if device == "cuda" and not torch.cuda.is_available():
        rc = tcli.main(["map", "--device-exact", "--device", device, "-S",
                        spec, "-r", "1", "-o", want, name, fq])
        assert rc == 1 and "no GPU is visible" in capsys.readouterr().err
        assert not (tmp_path / "host.sam").exists()
        return
    assert tcli.main(["map", "-S", spec, "-r", "1", "-o", want, name,
                      fq]) == 0
    body = [ln for ln in open(want).read().splitlines()
            if not ln.startswith("@PG")]
    assert len([ln for ln in body if ln[:1] != "@"]) == 204
    threads = torch.get_num_threads()   # other workers run CPU lanes too
    torch.set_num_threads(1)
    try:
        for p2 in (None, "1"):
            if p2 is None:
                monkeypatch.delenv("SMALT_DX_P2", raising=False)
            else:
                monkeypatch.setenv("SMALT_DX_P2", p2)
            got = str(tmp_path / f"dx{p2}.sam")
            assert tcli.main(["map", "--device-exact", "--device", device,
                              "-S", spec, "-r", "1", "-o", got, name,
                              fq]) == 0
            assert [ln for ln in open(got).read().splitlines()
                    if not ln.startswith("@PG")] == body, p2
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_cli_matrix_past_score_cap_exits_2(tmp_path, capsys, device):
    """What stays refused: a matrix whose window of the shortest padded
    query (128 columns) would overflow the kernels' int32 DP (2^30,
    ops/sw.py check_score_cap) exits 2 naming the limit, on every device
    and before the index is opened (none exists here).  (A subst of
    -65,536 passes since windows that score 2^23 map.)"""
    from smalt_tpu_torch import cli as tcli
    rc = tcli.main(["map", "--device-exact", "--device", device, "-S",
                    "subst=-8388608", "-o", str(tmp_path / "o.sam"),
                    str(tmp_path / "no_index"),
                    str(tmp_path / "no_reads.fq")])
    err = capsys.readouterr().err
    assert rc == 2
    assert err.count("\n") == 1 and "2^30" in err and "8388609" in err
    assert not (tmp_path / "o.sam").exists()
