"""The port's SW ops (smalt_tpu_torch/ops/sw.py) against the JAX package's
Pallas kernels (interpret mode), its jnp oracles and the host C kernel:
exact int32 equality of (best, ti, tj) and of the score-only result, on
the same seeded inputs, including N (5) and pad (7) codes and varied
subject lengths; full-matrix and banded.  The CUDA kernels themselves
run only on a card (chip_smoke.py holds them against the plain versions
there)."""
import numpy as np
import pytest
import torch

from smalt_tpu.align import core as ali
from smalt_tpu.ops import sw as jsw
from smalt_tpu.seq import codec
from smalt_tpu_torch.ops import sw as tsw


@pytest.fixture(scope="module")
def scoring():
    m, go, ge = ali.make_score_matrix()
    return m, -go, -ge


def _windows(seed, B, Q, S):
    """Queries with planted similarity in their windows, N codes in the
    query, pad codes past the real query and subject ends, and subject
    lengths from 0 to S."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (B, Q)).astype(np.int32)
    q[rng.random((B, Q)) < 0.03] = 5
    qlen = rng.integers(Q // 2, Q + 1, B)
    s = rng.integers(0, 4, (B, S)).astype(np.int32)
    for b in range(B):
        q[b, qlen[b]:] = 7
        n = min(int(qlen[b]), S) * 3 // 4
        o = int(rng.integers(0, S - n + 1))
        s[b, o : o + n] = q[b, :n]
        mut = rng.random(n) < 0.05
        s[b, o : o + n][mut] = rng.integers(0, 4, int(mut.sum()))
    s[rng.random((B, S)) < 0.01] = 5
    slens = rng.integers(S // 2, S + 1, B).astype(np.int32)
    slens[0] = S
    slens[1] = 0
    s[np.arange(S)[None, :] >= slens[:, None]] = 7
    return q, s, slens


@pytest.mark.parametrize("track", [True, False])
@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("Q", [80, 112, 128, 200])
def test_sw_matches_pallas_interpret(scoring, Q, S, track):
    m, go, ge = scoring
    q, s, slens = _windows(Q * 1000 + S, 8, Q, S)
    want = jsw.sw_score_batch(q, s, slens, m, go, ge, interpret=True,
                              track=track)
    got = tsw.sw_score_batch(q, s, slens, m, go, ge, device="cpu",
                             track=track)
    if not track:
        want, got = (want,), (got,)
    for w, g in zip(want, got):
        assert g.dtype == torch.int32 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("Q,S", [(80, 128), (200, 256)])
def test_sw_ref_matches_jax_ref(scoring, Q, S):
    """The plain torch version against the JAX package's jnp oracle
    (whose track=False result is the same running best, >= 0)."""
    m, go, ge = scoring
    q, s, slens = _windows(7 + Q, 12, Q, S)
    args = [torch.from_numpy(x) for x in (q, s, slens, m)]
    got = tsw.sw_score_ref(*args, go, ge, track=True)
    want = jsw.sw_score_ref(q, s, slens, m, go, ge, track=True)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        tsw.sw_score_ref(*args, go, ge).numpy(),
        np.asarray(jsw.sw_score_ref(q, s, slens, m, go, ge)))


def _rand_seqs(rng, n, qlen, slen, mut):
    cases = []
    for _ in range(n):
        q = rng.choice(list(b"ACGT"), qlen)
        s = np.concatenate([rng.choice(list(b"ACGT"), 7), q.copy(),
                            rng.choice(list(b"ACGT"), slen - qlen - 7)])
        muts = rng.random(len(s)) < mut
        s[muts] = rng.choice(list(b"ACGT"), int(muts.sum()))
        cases.append((bytes(q.tolist()), bytes(s.tolist())))
    return cases


@pytest.mark.parametrize("qlen,slen", [(80, 128), (100, 160), (128, 256)])
def test_sw_matches_host_c(qlen, slen):
    """Scores equal the exact host C kernel (swsimd semantics)."""
    m, go, ge = ali.make_score_matrix()
    lam = ali.matrix_lambda(m)
    rng = np.random.default_rng(qlen + slen)
    cases = _rand_seqs(rng, 10, qlen, slen, mut=0.08)
    qc = np.stack([codec.alpha(codec.encode(q)) for q, _ in cases])
    sc = np.stack([codec.alpha(codec.encode(s)) for _, s in cases])
    slens = np.full(len(cases), sc.shape[1], np.int32)
    got = tsw.sw_score_batch(qc, sc, slens, m, -go, -ge, device="cpu")
    want = [ali.sw_full_score(
        ali.ScoreProfile.from_read(codec.encode(q), m, go, ge, lam),
        codec.encode(s)) for q, s in cases]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sw_gap_order_asserted(scoring):
    m, go, ge = scoring
    q, s, slens = _windows(1, 2, 32, 128)
    with pytest.raises(AssertionError):
        tsw.sw_score_batch(q, s, slens, m, 2, 3, device="cpu")


def test_sw_cpu_path_launches_no_kernel(scoring):
    """A CPU tensor runs the plain version: the launch counters stay."""
    m, go, ge = scoring
    q, s, slens = _windows(2, 4, 48, 128)
    before = dict(tsw.launches)
    tsw.sw_score_batch(q, s, slens, m, go, ge, device="cpu", track=True)
    assert tsw.launches == before


def test_sw_cuda_wrapper_rejects_cpu_tensors(scoring):
    """The kernel wrapper takes CUDA tensors only: it never runs the
    plain version in place of the kernel."""
    m, go, ge = scoring
    q, s, slens = _windows(3, 4, 48, 128)
    args = [torch.from_numpy(x) for x in (q, s, slens, m)]
    with pytest.raises(ValueError, match="cuda"):
        tsw.sw_full_cuda(*args, go, ge, track=True)


# ---- banded (long-read) kernel ------------------------------------------

def _band_windows(seed, B, Q, S, pad, W):
    """Windows around the band diagonal: each query follows its subject
    from column pad + a shift with an indel walk and substitutions; the
    shifts put some alignments inside the band and some partly outside
    it.  N codes in both, shorter queries padded with 7, partial subject
    lengths (one 0)."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 4, (B, S)).astype(np.int32)
    shifts = [0, W // 8, -(W // 6), W // 2 + 10, -(W // 2) - 20, W]
    q = rng.integers(0, 4, (B, Q)).astype(np.int32)
    for b in range(B):
        o = pad + shifts[b % len(shifts)]
        walk = np.cumsum(rng.choice([-1, 0, 1], Q, p=[0.01, 0.98, 0.01]))
        idx = o + np.arange(Q) + walk
        ok = (idx >= 0) & (idx < S)
        q[b, ok] = s[b, idx[ok]]
    mut = rng.random((B, Q)) < 0.03
    q[mut] = rng.integers(0, 4, int(mut.sum()))
    q[rng.random((B, Q)) < 0.01] = 5
    s[rng.random((B, S)) < 0.005] = 5
    qlen = rng.integers(Q * 3 // 4, Q + 1, B)
    qlen[0] = Q
    q[np.arange(Q)[None, :] >= qlen[:, None]] = 7
    slens = rng.integers(S // 2, S + 1, B).astype(np.int32)
    slens[0] = S
    slens[1] = 0
    s[np.arange(S)[None, :] >= slens[:, None]] = 7
    return q, s, slens


def _copy_windows(seed, B, Q, S, offs):
    """test_sw_band_kernel.py's fixtures: random subjects holding exact
    copies of the queries at column offs[b]."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, (B, Q)).astype(np.int32)
    s = rng.integers(0, 4, (B, S)).astype(np.int32)
    for b in range(B):
        s[b, offs[b] : offs[b] + Q] = q[b]
    return q, s, np.full(B, S, np.int32)


def _band_cases(Q, pad, S, B):
    W = jsw.band_width_for(Q, pad)
    return [_copy_windows(11, B, Q, S, [pad] * B),
            _copy_windows(13, B, Q, S, [pad, pad + 3, pad - 5, pad + 11]),
            _band_windows(Q + S, B, Q, S, pad, W)]


def _assert_equal(got, want, track):
    if not track:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("track", [True, False])
@pytest.mark.parametrize("case", [0, 1, 2])
def test_band_matches_pallas_interpret_and_jax_ref(scoring, case, track):
    """The shapes of tests/test_sw_band_kernel.py:87-141 (Q=256, pad=32,
    S=384, B=4): the port's plain version against the JAX oracle and the
    Pallas kernel in interpret mode."""
    m, go, ge = scoring
    Q, pad, S = 256, 32, 384
    W = jsw.band_width_for(Q, pad)
    q, s, slens = _band_cases(Q, pad, S, 4)[case]
    args = [torch.from_numpy(x) for x in (q, s, slens, m)]
    got = tsw.sw_band_score_ref(*args, go, ge, pad, W, track=track)
    _assert_equal(got, jsw.sw_band_score_ref(q, s, slens, m, go, ge, pad, W,
                                             track=track), track)
    _assert_equal(got, jsw.sw_band_score_batch(q, s, slens, m, go, ge, pad,
                                               W, interpret=True,
                                               track=track), track)
    _assert_equal(tsw.sw_band_score_batch(q, s, slens, m, go, ge, pad, W,
                                          device="cpu", track=track),
                  got if track else (got,)[0], track)


@pytest.mark.parametrize("track", [True, False])
def test_band_q640_matches_pallas_interpret(scoring, track):
    """Q = 640 (W = 256) at the main path's window geometry: N codes,
    partial subject lengths, alignments inside and partly outside the
    band."""
    from smalt_tpu_torch.parallel.mesh import window_len, window_pad
    m, go, ge = scoring
    Q = 640
    S, pad = window_len(Q), window_pad(Q)
    W = tsw.band_width_for(Q, pad)
    assert W == 256
    q, s, slens = _band_windows(640, 6, Q, S, pad, W)
    want = jsw.sw_band_score_batch(q, s, slens, m, go, ge, pad, W,
                                   interpret=True, track=track)
    got = tsw.sw_band_score_batch(q, s, slens, m, go, ge, pad, W,
                                  device="cpu", track=track)
    _assert_equal(got, want, track)
    best = got[0] if track else got
    assert best[0] > Q // 2 and (best > 0).sum() >= 3


def test_band_clamped_width_matches_pallas(scoring):
    """A W past the query's width is clamped to ceil(Q/128)*128 + 128 and
    the band recentred at pad + W//2, as the Pallas wrapper does."""
    m, go, ge = scoring
    Q, pad, S = 200, 16, 384
    assert tsw.clamp_band_width(Q, pad, 1024) == 384
    q, s, slens = _band_windows(5, 4, Q, S, pad, 384)
    want = jsw.sw_band_score_batch(q, s, slens, m, go, ge, pad, 1024,
                                   interpret=True, track=True)
    got = tsw.sw_band_score_batch(q, s, slens, m, go, ge, pad, 1024,
                                  device="cpu", track=True)
    _assert_equal(got, want, True)


def test_band_width_for_matches_jax():
    for Q in range(16, 20000, 16):
        for pad in (0, 14, 32, Q // 16, Q // 8):
            assert tsw.band_width_for(Q, pad) == jsw.band_width_for(Q, pad)
    for Q, W in ((640, 256), (1504, 384), (4096, 768), (16384, 3072)):
        from smalt_tpu_torch.parallel.mesh import window_pad
        assert tsw.clamp_band_width(Q, window_pad(Q)) == W, Q


def test_band_query_cut_never_binds():
    """The Pallas wrapper copies only take = min(Q, QB - prepad) query
    columns into its band buffer (sw.py:458); the port reads the whole
    query.  At every long-read shape device_map_step makes, take == Q."""
    from smalt_tpu_torch.parallel.mesh import (LONG_READ_Q, window_len,
                                               window_pad)
    for Q in range(LONG_READ_Q + 16, 16400, 16):
        S, pad = window_len(Q), window_pad(Q)
        W = tsw.clamp_band_width(Q, pad, tsw.band_width_for(Q, pad))
        prepad = pad + W // 2
        Sp = -(-S // 128) * 128
        QB = -(-(Sp + W) // 128) * 128
        assert QB - prepad >= Q, Q
        assert W <= tsw.MAX_BAND_W, Q


def test_band_cpu_path_launches_no_kernel(scoring):
    m, go, ge = scoring
    q, s, slens = _band_windows(2, 4, 128, 256, 16, 128)
    before = dict(tsw.launches)
    tsw.sw_band_score_batch(q, s, slens, m, go, ge, 16, device="cpu",
                            track=True)
    assert tsw.launches == before


def test_band_cuda_wrapper_rejects_cpu_tensors_and_wide_bands(scoring):
    """The kernel wrapper takes CUDA tensors only, and names its width
    limit: it never runs the plain version in place of the kernel."""
    m, go, ge = scoring
    q, s, slens = _band_windows(3, 4, 128, 256, 16, 128)
    args = [torch.from_numpy(x) for x in (q, s, slens, m)]
    with pytest.raises(ValueError, match="cuda"):
        tsw.sw_band_cuda(*args, go, ge, 16, 128, track=True)
    with pytest.raises(ValueError, match=str(tsw.MAX_BAND_W)):
        tsw.sw_band_cuda(*args, go, ge, 16, tsw.MAX_BAND_W + 128)
