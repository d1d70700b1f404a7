"""The port's SW op (smalt_tpu_torch/ops/sw.py) against the JAX package's
Pallas kernel (interpret mode) and the host C kernel: exact int32
equality of (best, ti, tj) and of the score-only result, on the same
seeded inputs, including N (5) and pad (7) codes and varied subject
lengths.  The CUDA kernel itself runs only on a card (chip_smoke.py
holds it against the plain version there)."""
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
