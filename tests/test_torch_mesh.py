"""The port's fast mapping step (smalt_tpu_torch/parallel/mesh.py) against
smalt_tpu.parallel.mesh on the same seeded inputs, on the CPU: exact
int32 equality of every stage and of all 12 OUT_KEYS.  The JAX step
scores its windows with the Pallas kernel in interpret mode.  Each side
works on objects of its own package over the same arrays."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smalt_tpu.align import core as ali
from smalt_tpu.index.table import build_index
from smalt_tpu.ops import sw as jsw
from smalt_tpu.parallel import mesh as jm
from smalt_tpu.seq import codec
from smalt_tpu_torch.align import core as tali
from smalt_tpu_torch.parallel import mesh as tm
from test_torch_standalone import port_index, port_refset


def _fields(jdi):
    """The JAX DeviceIndex's fields as numpy arrays + meta."""
    arrays = {f: np.asarray(getattr(jdi, f)) for f in _FIELDS
              if getattr(jdi, f) is not None}
    meta = {"wordlen": jdi.wordlen, "nskip": jdi.nskip,
            "ref_len": jdi.ref_len, "lo_steps": jdi.lo_steps}
    return arrays, meta


_FIELDS = ("words", "starts", "pos", "ref_alpha", "table", "hi_table",
           "words_lo")


@pytest.fixture(scope="module")
def k13(indexed):
    """k13 s4 on the bundled genome: direct table on both sides."""
    refset, idx = indexed
    jdi = jm.DeviceIndex.build(refset, idx)
    tdi = tm.DeviceIndex.build(port_refset(refset), port_index(idx), "cpu")
    return refset, idx, jdi, tdi


@pytest.fixture(scope="module")
def k15(indexed):
    """k15 s3: the sorted-word searchsorted path (2k > DIRECT_BITS)."""
    refset, _ = indexed
    idx = build_index(refset, 15, 3)
    jdi = jm.DeviceIndex.build(refset, idx)
    assert jdi.table is None
    return refset, idx, jdi, tm.DeviceIndex.build(port_refset(refset), port_index(idx), "cpu")


def _reads(refset, seed, B, Q, qlen=None, mut=0.02, n_pad_rows=2):
    """A padded batch of reference reads: substitutions, N codes, half
    reverse-complemented, shorter reads padded with 7, and all-7 pad
    rows at the end (as the pipeline pads its last batch)."""
    rng = np.random.default_rng(seed)
    qlen = qlen or Q
    reads = np.full((B, Q), 7, np.int32)
    for i in range(B - n_pad_rows):
        n = int(rng.integers(qlen * 3 // 4, qlen + 1))
        st = int(rng.integers(0, refset.total_len - n))
        seg = codec.alpha(refset.codes[st : st + n]).astype(np.int32)
        m = rng.random(n) < mut
        seg[m] = rng.integers(0, 4, int(m.sum()))
        seg[rng.random(n) < 0.005] = 5
        if i % 2:
            seg = seg[::-1]
            seg = np.where(seg & 4, seg, seg ^ 3)
        reads[i, :n] = seg
    return reads


def test_constants_match_jax():
    for name in ("NSEED", "NSEED_COMMON", "MAXC", "WIN_PAD", "LONG_READ_Q"):
        assert getattr(tm, name) == getattr(jm, name), name
    assert tm.DeviceIndex.DIRECT_BITS == jm.DeviceIndex.DIRECT_BITS
    assert tm.DeviceIndex.HI_BASES == jm.DeviceIndex.HI_BASES
    for Q in range(16, 1025, 16):
        assert tm.window_len(Q) == jm.window_len(Q), Q
        assert tm.window_pad(Q) == jm.window_pad(Q), Q


@pytest.mark.parametrize("which", ["k13", "k15"])
def test_from_numpy_equals_build(which, request):
    refset, idx, jdi, tdi = request.getfixturevalue(which)
    arrays, meta = _fields(jdi)
    _same_index(tm.DeviceIndex.from_numpy(arrays, meta, "cpu"), tdi)


def _same_index(got, tdi):
    assert (got.wordlen, got.nskip, got.ref_len, got.lo_steps) == \
        (tdi.wordlen, tdi.nskip, tdi.ref_len, tdi.lo_steps)
    for f in _FIELDS:
        a, b = getattr(got, f), getattr(tdi, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == torch.int32 and torch.equal(a, b), f


@pytest.fixture(scope="module")
def bigk_genome():
    """tests/test_device_bigk.py's genome: 30 kb of random bases, seed 67."""
    from smalt_tpu.seq.refset import RefSet
    rng = np.random.default_rng(67)
    g = rng.choice(np.array(list(b"ACGT"), np.uint8), 30000)
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        fa = f"{d}/g.fa"
        with open(fa, "w") as f:
            f.write(">g\n" + g.tobytes().decode() + "\n")
        return RefSet.from_fasta(fa)


@pytest.fixture(scope="module", params=[(16, 2), (17, 2), (18, 3), (20, 13)],
                ids=lambda p: f"k{p[0]}s{p[1]}")
def bigk(request, bigk_genome):
    """The split-word index (k = 16..20) on both sides."""
    k, nskip = request.param
    refset = bigk_genome
    idx = build_index(refset, k, nskip)
    jdi = jm.DeviceIndex.build(refset, idx)
    tdi = tm.DeviceIndex.build(port_refset(refset), port_index(idx), "cpu")
    assert jdi.words_lo is not None and tdi.words_lo is not None
    yield refset, idx, jdi, tdi
    del jdi, tdi


def test_hilo_index_matches_jax(bigk):
    """DeviceIndex.build at k = 16..20 makes the JAX DeviceIndex's arrays
    (hi_table bucket extents, words_lo, lo_steps and the rest), and
    from_numpy of the JAX fields equals build."""
    refset, idx, jdi, tdi = bigk
    arrays, meta = _fields(jdi)
    assert tdi.table is None and tdi.hi_table.shape == (1 << 24, 2)
    assert "hi_table" in arrays and "table" not in arrays
    for f, a in arrays.items():
        np.testing.assert_array_equal(getattr(tdi, f).numpy(), a, err_msg=f)
    assert tdi.lo_steps == jdi.lo_steps >= 1
    _same_index(tm.DeviceIndex.from_numpy(arrays, meta, "cpu"), tdi)


def test_build_refuses_past_k20(indexed):
    """Past the reference's own word length (menu.c:595) build raises the
    JAX DeviceIndex's ValueError."""
    refset, idx = indexed
    fake = port_index(idx)
    fake.wordlen = 21
    with pytest.raises(ValueError, match="wordlen<=20"):
        tm.DeviceIndex.build(port_refset(refset), fake, "cpu")


@pytest.mark.parametrize("k", [16, 17, 18, 20])
def test_query_words_hilo(k):
    rng = np.random.default_rng(k)
    reads = rng.integers(0, 4, (16, 96)).astype(np.int32)
    reads[rng.random(reads.shape) < 0.02] = 5
    reads[3, 40:] = 7
    want = jm._query_words_hilo(jnp.asarray(reads), k)
    got = tm._query_words_hilo(torch.from_numpy(reads), k)
    assert len(got) == 5
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_lookup_hilo(bigk):
    """Counts, position bases and hits of both strands' split words equal
    the JAX lookup on reads of the genome (hits and misses)."""
    refset, idx, jdi, tdi = bigk
    reads = _reads(refset, idx.wordlen, 24, 100)
    parts = jm._query_words_hilo(jnp.asarray(reads), idx.wordlen)
    valid = parts[4]
    for hi, lo in ((parts[0], parts[1]), (parts[2], parts[3])):
        want = jm._lookup_hilo(jdi, hi, lo, valid)
        got = tm._lookup_hilo(tdi, *(torch.tensor(np.asarray(x))
                                     for x in (hi, lo, valid)))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert np.asarray(want[2]).any() and not np.asarray(want[2]).all()


@pytest.mark.parametrize("k", [11, 13, 15])
def test_query_words(k):
    rng = np.random.default_rng(k)
    reads = rng.integers(0, 4, (16, 96)).astype(np.int32)
    reads[rng.random(reads.shape) < 0.02] = 5
    reads[3, 40:] = 7
    want = jm._query_words(jnp.asarray(reads), k)
    got = tm._query_words(torch.from_numpy(reads), k)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("which", ["k13", "k15"])
def test_lookup_and_expand(which, request):
    refset, idx, jdi, tdi = request.getfixturevalue(which)
    reads = _reads(refset, 4, 24, 100)
    fw, rc, valid = jm._query_words(jnp.asarray(reads), idx.wordlen)
    for words in (fw, rc):
        want = jm._lookup(jdi, words, valid)
        got = tm._lookup(tdi, torch.tensor(np.asarray(words)),
                         torch.tensor(np.asarray(valid)))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    counts, base, hit = (np.asarray(x) for x in want)
    sel = np.argsort(-counts, axis=1, kind="stable")[:, : jm.NSEED]
    sb = np.take_along_axis(base, sel, 1)
    sc = np.minimum(np.take_along_axis(counts, sel, 1), jm.MAXC)
    qo = np.broadcast_to(3 * np.arange(sel.shape[1], dtype=np.int32),
                         sel.shape).copy()
    for rev in (False, True):
        want = jm._expand_hits(jdi, jnp.asarray(sb), jnp.asarray(sc),
                               jnp.asarray(qo), rev)
        got = tm._expand_hits(tdi, torch.from_numpy(sb),
                              torch.from_numpy(sc), torch.from_numpy(qo),
                              rev)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_best_diagonal_with_ties(seed):
    """Planted equal-vote clusters, duplicates and sentinels: the winner
    and runner-up must be the first maxima, as in JAX."""
    rng = np.random.default_rng(seed)
    B, N = 32, jm.NSEED * jm.MAXC
    shift = np.full((B, N), -(1 << 30), np.int32)
    for b in range(B):
        n = int(rng.integers(0, N + 1))
        centres = rng.integers(0, 50_000, int(rng.integers(1, 6)))
        vals = rng.choice(centres, n) + rng.integers(-3, 4, n)
        shift[b, :n] = vals
        rng.shuffle(shift[b])
    ok = shift > -(1 << 29)
    want = jm._best_diagonal(jnp.asarray(shift), jnp.asarray(ok), 9)
    got = tm._best_diagonal(torch.from_numpy(shift), torch.from_numpy(ok), 9)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_topk_tie_order_matches_lax_top_k():
    """Seed selection picks among equal counts by position; torch.topk
    orders ties differently from jax.lax.top_k, the port must not."""
    rng = np.random.default_rng(8)
    key = rng.integers(0, 4, (64, 40)).astype(np.int32)
    key[:, ::3] = 1 << 30
    for n in (4, 16):
        for x in (key, -key):
            _, want = jax.lax.top_k(jnp.asarray(x), n)
            got = tm._topk_first(torch.from_numpy(x), n)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def repeat_genome(tmp_path_factory):
    """Contigs with planted near-identical repeat copies and a tandem
    array: seed counts tie at 1 and at the copy number."""
    from smalt_tpu.seq.refset import RefSet
    rng = np.random.default_rng(21)
    bases = np.array(list(b"ACGT"), np.uint8)
    g = rng.choice(bases, 40_000)
    unit = rng.choice(bases, 300)
    for at in rng.integers(0, 40_000 - 300, 6):
        cp = unit.copy()
        cp[rng.integers(0, 300, 3)] = rng.choice(bases, 3)
        g[at : at + 300] = cp
    g[20_000 : 20_000 + 20 * 40] = np.tile(rng.choice(bases, 40), 20)
    fa = tmp_path_factory.mktemp("rep") / "g.fa"
    fa.write_text(">a\n" + g[:25_000].tobytes().decode() + "\n>b\n" +
                  g[25_000:].tobytes().decode() + "\n")
    refset = RefSet.from_fasta(str(fa))
    idx = build_index(refset, 13, 2)
    return (refset, jm.DeviceIndex.build(refset, idx),
            tm.DeviceIndex.build(port_refset(refset), port_index(idx), "cpu"))


def test_seed_votes_on_repeats(repeat_genome):
    refset, jdi, tdi = repeat_genome
    reads = _reads(refset, 6, 48, 100, mut=0.01)
    want_outs, wu, wt = jm.device_seed_votes(jdi, jnp.asarray(reads))
    got_outs, gu, gt = tm.device_seed_votes(tdi, torch.from_numpy(reads))
    np.testing.assert_array_equal(gu.numpy(), np.asarray(wu))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    for w5, g5 in zip(want_outs, got_outs):
        for w, g in zip(w5, g5):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _step_equal(jdi, tdi, reads):
    m, go, ge = ali.make_score_matrix()
    want = jm.device_map_step(jdi, jnp.asarray(reads), m, -go, -ge,
                              interpret=True)
    tmat, tgo, tge = tali.make_score_matrix()
    step = tm.make_device_step(tdi, tmat, -tgo, -tge, pack=True)
    got = step(torch.from_numpy(reads.astype(np.uint8)))
    assert got.dtype == torch.int32 and got.shape == (12, reads.shape[0])
    for i, key in enumerate(tm.OUT_KEYS):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    return got


@pytest.mark.parametrize("Q,qlen", [(112, 100), (80, 80)])
def test_device_map_step_all_out_keys(k13, Q, qlen):
    refset, idx, jdi, tdi = k13
    assert tm.OUT_KEYS == jm.OUT_KEYS
    reads = _reads(refset, Q, 32, Q, qlen=qlen)
    got = _step_equal(jdi, tdi, reads)
    assert (got[0, :-2] > 0).all() and (got[0, -2:] == 0).all()


def test_device_map_step_sorted_index(k15):
    refset, idx, jdi, tdi = k15
    _step_equal(jdi, tdi, _reads(refset, 15, 32, 112, qlen=100))


def test_device_map_step_repeats(repeat_genome):
    refset, jdi, tdi = repeat_genome
    _step_equal(jdi, tdi, _reads(refset, 3, 32, 112, qlen=100, mut=0.01))


@pytest.fixture(scope="module")
def long_genome():
    """tests/test_longreads.py:32-47's genome (200 kb, seed 17), k13 s4."""
    from smalt_tpu.seq.refset import RefSet
    rng = np.random.default_rng(17)
    g = rng.choice(np.array(list(b"ACGT"), np.uint8), 200_000)
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        fa = f"{d}/lg.fa"
        with open(fa, "w") as f:
            f.write(">lg\n" + g.tobytes().decode() + "\n")
        refset = RefSet.from_fasta(fa)
    idx = build_index(refset, 13, 4)
    return (refset, jm.DeviceIndex.build(refset, idx),
            tm.DeviceIndex.build(port_refset(refset), port_index(idx), "cpu"))


def _long_reads(refset, seed, B, Q):
    """Noisy kilobase reads: substitutions, indels, N codes, half
    reverse-complemented, lengths from 3Q/4 to Q, one all-7 pad row."""
    rng = np.random.default_rng(seed)
    reads = np.full((B, Q), 7, np.int32)
    for i in range(B - 1):
        n = int(rng.integers(Q * 3 // 4, Q + 1))
        st = int(rng.integers(0, refset.total_len - 2 * n))
        seg = list(codec.alpha(refset.codes[st : st + 2 * n]))
        out = []
        for c in seg:
            r = rng.random()
            if r < 0.005:
                continue
            if r < 0.01:
                out.append(int(rng.integers(0, 4)))
            out.append(int(rng.integers(0, 4)) if rng.random() < 0.03
                       else int(c))
            if len(out) >= n:
                break
        seg = np.asarray(out[:n], np.int32)
        seg[rng.random(n) < 0.005] = 5
        if i % 2:
            seg = seg[::-1]
            seg = np.where(seg & 4, seg, seg ^ 3)
        reads[i, :n] = seg
    return reads


@pytest.fixture
def jax_band_oracle(monkeypatch):
    """The JAX step scores long reads with the banded jnp oracle, as
    tests/test_longreads.py:64 does (the Pallas kernel equals it,
    tests/test_sw_band_kernel.py); W as the Pallas wrapper fixes it
    (smalt_tpu/ops/sw.py:449-451)."""

    def band_oracle(q, s, sl, mat, go, ge, pad, W=0, interpret=None,
                    track=False):
        Q = q.shape[1]
        W = min(W or jsw.band_width_for(Q, pad), -(-Q // 128) * 128 + 128)
        return jsw.sw_band_score_ref(q, s, sl, mat, go, ge, pad, W,
                                     track=track)

    monkeypatch.setattr(jm, "sw_band_score_batch", band_oracle)


@pytest.mark.parametrize("Q", [528, 1008])
def test_device_map_step_long_reads(long_genome, jax_band_oracle, Q):
    """Q > LONG_READ_Q: the banded branch, all 12 OUT_KEYS equal to the
    JAX step, which scores with the banded jnp oracle."""
    refset, jdi, tdi = long_genome
    assert Q > tm.LONG_READ_Q
    got = _step_equal(jdi, tdi, _long_reads(refset, Q, 12, Q))
    assert (got[0, :-1] > Q // 2).all() and got[0, -1] == 0


@pytest.mark.parametrize("kn", [(16, 2), (20, 13)],
                         ids=["k16s2", "k20s13"])
def test_device_map_step_bigk(bigk_genome, kn):
    """k = 16 and 20 (the split-word lookups): all 12 OUT_KEYS equal to
    the JAX step, short reads and the padded pad rows."""
    refset = bigk_genome
    idx = build_index(refset, *kn)
    jdi = jm.DeviceIndex.build(refset, idx)
    tdi = tm.DeviceIndex.build(port_refset(refset), port_index(idx), "cpu")
    got = _step_equal(jdi, tdi, _reads(refset, kn[0], 32, 112, qlen=100))
    assert (got[0, :-2] > 50).all()


def test_device_map_step_bigk_long_reads(bigk_genome, jax_band_oracle):
    """k = 16 on kilobase reads (Q > LONG_READ_Q: the banded branch), all
    12 OUT_KEYS equal to the JAX step on its banded jnp oracle."""
    refset = bigk_genome
    idx = build_index(refset, 16, 4)
    jdi = jm.DeviceIndex.build(refset, idx)
    tdi = tm.DeviceIndex.build(port_refset(refset), port_index(idx), "cpu")
    Q = 640
    got = _step_equal(jdi, tdi, _long_reads(refset, 16, 8, Q))
    assert (got[0, :-1] > Q // 2).all() and got[0, -1] == 0


@pytest.mark.parametrize("pen", [(), (200, -2)], ids=["default", "match200"])
def test_device_map_step_pad_reads_take_no_rows(long_genome, jax_band_oracle,
                                                monkeypatch, pen):
    """Q > LONG_READ_Q with pad reads (all code 7) amid the batch and at
    its end, also under -S match=200,subst=-2: the banded scoring gives
    each pad read's three windows slen 0 and every other window S, and all
    12 OUT_KEYS still equal the JAX step, which scores every window over
    its S rows (code 7 scores 0, so a pad read's window returns (0, 0,
    -prepad) over any number of rows)."""
    refset, jdi, tdi = long_genome
    Q = 528
    reads = _long_reads(refset, 21, 10, Q)
    reads[[2, 5]] = 7
    seen = []
    band = tm.sw_band_score_batch

    def spy(q, s, slens, *a, **k):
        seen.append(slens.clone())
        return band(q, s, slens, *a, **k)

    monkeypatch.setattr(tm, "sw_band_score_batch", spy)
    m, go, ge = ali.make_score_matrix(*pen)
    want = jm.device_map_step(jdi, jnp.asarray(reads), m, -go, -ge,
                              interpret=True)
    tmat, tgo, tge = tali.make_score_matrix(*pen)
    step = tm.make_device_step(tdi, tmat, -tgo, -tge, pack=True)
    got = step(torch.from_numpy(reads.astype(np.uint8)))
    for i, key in enumerate(tm.OUT_KEYS):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    pad = (reads == 7).all(axis=1)
    assert pad.tolist() == [i in (2, 5, 9) for i in range(10)]
    (slens,) = seen
    assert slens.dtype == torch.int32
    assert slens.tolist() == np.where(np.tile(pad, 3), 0,
                                      tm.window_len(Q)).tolist()
    assert (got[0][pad] == 0).all() and (got[0][~pad] > Q // 2).all()
