"""The port's SW ops (smalt_tpu_torch/ops/sw.py) against the JAX package's
Pallas kernels (interpret mode), its jnp oracles and the host C kernel:
exact int32 equality of (best, ti, tj) and of the score-only result, on
the same seeded inputs, including N (5) and pad (7) codes and varied
subject lengths; full-matrix and banded.  The CUDA kernels themselves
run only on a card (chip_smoke.py holds them against the plain versions
there)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from smalt_tpu.align import core as ali
from smalt_tpu.ops import sw as jsw
from smalt_tpu.seq import codec
from smalt_tpu_torch.align import core as tali
from smalt_tpu_torch.ops import bounds
from smalt_tpu_torch.ops import sw as tsw
from smalt_tpu_torch.seq import codec as tcodec


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


@pytest.mark.parametrize("qlen,slen", [(80, 128), (128, 256)])
def test_sw_matches_ports_own_host_c(qlen, slen):
    """... and the port's own copy of that host C kernel."""
    m, go, ge = tali.make_score_matrix()
    lam = tali.matrix_lambda(m)
    rng = np.random.default_rng(qlen + slen)
    cases = _rand_seqs(rng, 10, qlen, slen, mut=0.08)
    qc = np.stack([tcodec.alpha(tcodec.encode(q)) for q, _ in cases])
    sc = np.stack([tcodec.alpha(tcodec.encode(s)) for _, s in cases])
    slens = np.full(len(cases), sc.shape[1], np.int32)
    got = tsw.sw_score_batch(qc, sc, slens, m, -go, -ge, device="cpu")
    want = [tali.sw_full_score(
        tali.ScoreProfile.from_read(tcodec.encode(q), m, go, ge, lam),
        tcodec.encode(s)) for q, s in cases]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


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


def _tie_cases(Q, S):
    """Hand-made windows whose maximum of T is reached more than once,
    with the cell the reference's rule names (a row wins only if
    strictly greater, then its lowest column).  Base 0 against base 0
    scores +1, against base 1 it scores -2; 7 pads.
      0: the query longer than the subject: T = slen all along row
         slen - 1, from column slen - 1 to the query's end, in several
         lanes of any layout -> the lowest column;
      1: the subject longer than the query: T = qlen in column qlen - 1
         of every row from qlen - 1 on -> the first row;
      2: nothing in common: no T above 0 -> (0, 0, 0);
      3: an empty subject -> (0, 0, 0);
      4: two copies of a 12-base word in the subject, 40 rows apart,
         against a query that holds the word once: the same score in two
         rows, two columns -> the first copy."""
    slen0, qlen1 = min(Q, S) // 2 - 3, Q // 2 + 5
    q = np.zeros((5, Q), np.int32)
    s = np.zeros((5, S), np.int32)
    slens = np.full(5, S, np.int32)
    s[0, slen0:] = 7
    slens[0] = slen0
    q[1, qlen1:] = 7
    s[2] = 1
    slens[3] = 0
    s[3] = 7
    word = np.array([0, 1, 2, 3, 3, 2, 1, 0, 0, 2, 1, 3], np.int32)
    q[4] = 5                     # N: scores 0 against everything
    q[4, 30:42] = word
    s[4] = 5
    s[4, 10:22] = word
    s[4, 50:62] = word
    want = np.array([[slen0, slen0 - 1, slen0 - 1],
                     [qlen1, qlen1 - 1, qlen1 - 1],
                     [0, 0, 0], [0, 0, 0], [12, 21, 41]], np.int32)
    return q, s, slens, want


@pytest.mark.parametrize("S", [128, 256])
@pytest.mark.parametrize("Q", [112, 128, 160])
def test_track_ties_first_cell(scoring, Q, S):
    """Tied maxima in two lanes of one row, in two rows, and a maximum
    of 0: the plain version names the reference's cell, as the jnp
    oracle and the Pallas kernel (interpret mode) do.  Q = 112, 128, 160
    are the widths the Hopper kernel runs at 14 and 16 columns a lane on
    8 lanes a window and 10 columns on 16 lanes (chip_smoke.py holds it
    against this plain version on such input)."""
    m, go, ge = scoring
    q, s, slens, want = _tie_cases(Q, S)
    got = tsw.sw_score_batch(q, s, slens, m, go, ge, device="cpu",
                             track=True)
    got = np.stack([g.numpy() for g in got], axis=1)
    np.testing.assert_array_equal(got, want)
    for ref in (jsw.sw_score_ref(q, s, slens, m, go, ge, track=True),
                jsw.sw_score_batch(q, s, slens, m, go, ge, interpret=True,
                                   track=True)):
        np.testing.assert_array_equal(
            got, np.stack([np.asarray(r) for r in ref], axis=1))
    np.testing.assert_array_equal(
        tsw.sw_score_batch(q, s, slens, m, go, ge, device="cpu").numpy(),
        want[:, 0])


@pytest.mark.parametrize("Q,S", [(112, 128), (128, 128), (160, 256)])
def test_tie_windows_match_pallas_interpret(scoring, Q, S):
    """The tie-heavy generator chip_smoke.py feeds the tracked kernel:
    its windows do tie (the maximum of T is reached in more than one
    cell of most windows), some score nothing, and the plain version
    equals the jnp oracle and the Pallas kernel on them."""
    m, go, ge = scoring
    q, s, slens = tsw.tie_windows(np.random.default_rng(Q + S), 32, Q, S)
    got = tsw.sw_score_batch(q, s, slens, m, go, ge, device="cpu",
                             track=True)
    got = np.stack([g.numpy() for g in got], axis=1)
    for ref in (jsw.sw_score_ref(q, s, slens, m, go, ge, track=True),
                jsw.sw_score_batch(q, s, slens, m, go, ge, interpret=True,
                                   track=True)):
        np.testing.assert_array_equal(
            got, np.stack([np.asarray(r) for r in ref], axis=1))
    assert (got[:, 0] == 0).sum() >= 3 and (got[got[:, 0] == 0] == 0).all()


def _t_matrix(q, s, slen, m, go, ge):
    """T of one window by the textbook Gotoh recurrences, cell by cell
    (E: gap in the query, from the row above; F: from the left)."""
    Q = len(q)
    H = np.zeros((slen + 1, Q + 1), np.int64)
    E = np.zeros((slen + 1, Q + 1), np.int64)
    T = np.zeros((slen, Q), np.int64)
    for i in range(1, slen + 1):
        F = -(1 << 28)
        for j in range(1, Q + 1):
            T[i - 1, j - 1] = H[i - 1, j - 1] + m[s[i - 1], q[j - 1]]
            h = max(T[i - 1, j - 1], E[i - 1, j], F, 0)
            H[i, j] = h
            E[i, j] = max(E[i - 1, j] - ge, h - go)
            F = max(F - ge, h - go)
    return T


def test_tie_windows_do_tie(scoring):
    """In most windows of the generator the maximum of T is reached in
    several cells, in more than one row and in more than one column, and
    the plain version names the first of them in row-major order."""
    m, go, ge = scoring
    Q, S = 40, 48
    q, s, slens = tsw.tie_windows(np.random.default_rng(11), 24, Q, S)
    got = tsw.sw_score_batch(q, s, slens, m, go, ge, device="cpu",
                             track=True)
    got = np.stack([g.numpy() for g in got], axis=1)
    tied = rows = cols = 0
    for b in range(len(q)):
        T = _t_matrix(q[b], s[b], int(slens[b]), m, go, ge)
        M = int(T.max()) if T.size else 0
        if M <= 0:
            assert tuple(got[b]) == (0, 0, 0)
            continue
        ii, jj = np.nonzero(T == M)          # row-major order
        assert tuple(got[b]) == (M, ii[0], jj[0])
        tied += len(ii) > 1
        rows += len(set(ii)) > 1
        cols += len(set(jj)) > 1
    assert tied >= 12 and rows >= 6 and cols >= 6


def test_bounds_hand_counted():
    """Cells, bytes and bounds on shapes small enough to count by hand."""
    per_s = 132 * 64 * 1.98e9
    assert bounds.INT_OPS_PER_S == per_s and bounds.OPS_PER_CELL == 5
    # full matrix: rows below slen, clamped to S; every query column
    w = bounds.sw_full_work(112, 128, np.array([128, 0, 64, 200]), True)
    assert w["cells"] == 112 * (128 + 0 + 64 + 128)
    assert w["bytes"] == 4 * (4 * 112 + 320 + 4 + 64) + 4 * 4 * 3
    assert w["ops_ms"] == pytest.approx(w["cells"] * 5 / per_s * 1e3)
    assert w["bound_by"] == "operations" and w["bound_ms"] == w["ops_ms"]
    assert bounds.sw_full_work(112, 128, np.array([128]), False)["bytes"] == \
        4 * (112 + 128 + 1 + 64) + 4
    # the main-path shape, every window at full length
    full = bounds.sw_full_work(112, 128, np.full(12288, 128), True)
    assert full["cells"] == 176_160_768
    assert full["bound_ms"] == pytest.approx(0.05266, rel=1e-3)
    assert bounds.share(full["bound_ms"], 0.2437) == pytest.approx(0.216,
                                                                   rel=1e-2)
    # band: Q = 4, W = 3 lanes, prepad 1: row i holds columns i-1..i+1,
    # of which 2, 3, 3, 2, 1, 0 lie in the query
    assert bounds.band_cells(4, 6, 3, 1, np.array([6])) == 11
    assert bounds.band_cells(4, 6, 3, 1, np.array([3, 0, 9])) == 8 + 0 + 11
    b = bounds.sw_band_work(4, 6, 2, 0, np.array([6, 3]), False)   # prepad 1
    assert b["cells"] == bounds.band_cells(4, 6, 2, 1, np.array([6, 3])) == \
        (1 + 2 + 2 + 2 + 1 + 0) + (1 + 2 + 2)
    assert b["bound_by"] == "bytes"       # a few cells, 400 bytes
    # pass 2: l_edge -1, r_edge 1, q_left 0, q_len 5, rows 1..3 of a
    # valid window: columns [0,2) [0,3) [1,4); a dummy window adds none
    par = np.array([[-1, 1, 0, 5, 4, 1, 1, 0], [-1, 1, 0, 5, -1, 0, 0, 0]])
    w = bounds.swq_work(8, 6, par)
    assert w["cells"] == 2 + 3 + 3
    assert w["bytes"] == 4 * (1 * 8 + 3 + 8 * 2 + 64) + 12 * 2 + 2 * 2 * 6
    assert bounds.swq_work(8, 6, par[1:])["cells"] == 0


def test_bounds_take_tensors():
    sl = torch.full((16,), 128, dtype=torch.int32)
    assert bounds.sw_full_work(112, 128, sl, True) == \
        bounds.sw_full_work(112, 128, sl.numpy(), True)


def test_sw_gap_order_asserted(scoring):
    m, go, ge = scoring
    q, s, slens = _windows(1, 2, 32, 128)
    with pytest.raises(AssertionError):
        tsw.sw_score_batch(q, s, slens, m, 2, 3, device="cpu")


@pytest.mark.parametrize("entry", [-129, 128, 1 << 20])
def test_matrix_outside_int8_raises(scoring, entry):
    """A matrix entry outside -128..127 is taken at every place a matrix
    is (device_matrix records its range beside the tensor): the
    full-matrix and the banded scores equal the JAX package's oracles,
    entry 1 << 20 on 32 columns too (a window that could score 2^25, past
    the int8 instances' key).  What stays refused, on every device, is a
    window whose int32 DP could pass 2^30 (check_score_cap): entry 1 << 25
    on 32 columns."""
    from smalt_tpu_torch.parallel.mesh import make_device_step
    m, go, ge = scoring
    q, s, slens = _windows(5, 6, 32, 64)
    wide = m.copy()
    wide[2, 3] = wide[3, 2] = entry
    got = tsw.device_matrix(wide, "cpu")
    assert (got.lo, got.hi) == (int(wide.min()), int(wide.max()))
    assert got.wide and got.amax == max(-got.lo, got.hi)
    make_device_step(SimpleNamespace(device=torch.device("cpu")), wide,
                     go, ge)
    if entry == 1 << 20:
        assert tsw.key_over(got, 32, 64)
        assert tsw.dp_extent(got.amax, 32, 64, go, ge) < tsw.DP_CAP
        huge = wide.copy()
        huge[2, 3] = huge[3, 2] = 1 << 25
        for call in (lambda mat: tsw.sw_score_batch(q, s, slens, mat, go, ge,
                                                    device="cpu"),
                     lambda mat: tsw.sw_band_score_batch(
                         q, s, slens, mat, go, ge, 8, device="cpu")):
            for mat in (huge, tsw.device_matrix(huge, "cpu")):
                with pytest.raises(ValueError, match="2\\^30"):
                    call(mat)
    for track in (True, False):
        want = jsw.sw_score_ref(q, s, slens, wide, go, ge, track=track)
        for mat in (wide, got):
            _assert_equal(tsw.sw_score_batch(q, s, slens, mat, go, ge,
                                             device="cpu", track=track),
                          want, track)
        W = jsw.band_width_for(32, 8)
        want = jsw.sw_band_score_ref(q, s, slens, wide, go, ge, 8, W,
                                     track=track)
        _assert_equal(tsw.sw_band_score_batch(q, s, slens, got, go, ge, 8, W,
                                              device="cpu", track=track),
                      want, track)
    edge = m.copy()
    edge[0, 1], edge[1, 0] = -128, 127
    got = tsw.device_matrix(edge, "cpu")
    assert not got.wide
    assert got.t.dtype == torch.int32 and got.t.is_contiguous()
    np.testing.assert_array_equal(got.t.numpy(), edge)
    edge[0, 0] = 99                      # the tensor does not alias its source
    assert int(got.t[0, 0]) == int(m[0, 0])


def test_score_cap_names_its_limit(scoring):
    """The int32 DP's bound, max|entry| * min(Q, S) + (go + ge) * (Q + S)
    < 2^30: the least entry that reaches it on a 64 x 128 window is
    refused, one less passes; a CUDA-only wrapper checks it before
    anything else of the card."""
    m, go, ge = scoring
    q, s, slens = _windows(9, 2, 64, 128)
    big = m.copy()
    big[0, 0] = -(-(tsw.DP_CAP - (go + ge) * (64 + 128)) // 64)
    assert tsw.dp_extent(int(big[0, 0]), 64, 128, go, ge) >= tsw.DP_CAP > \
        tsw.dp_extent(int(big[0, 0]) - 1, 64, 128, go, ge)
    with pytest.raises(ValueError, match="2\\^30"):
        tsw.sw_score_batch(q, s, slens, big, go, ge, device="cpu")
    big[0, 0] -= 1
    assert tsw.sw_score_batch(q, s, slens, big, go, ge, device="cpu").shape \
        == (2,)
    big[0, 0] += 1
    args = [torch.from_numpy(x) for x in (q, s, slens)]
    with pytest.raises(ValueError, match="2\\^30"):
        tsw.sw_full_cuda(*args, tsw.device_matrix(big, "cpu"), go, ge)
    with pytest.raises(TypeError, match="DeviceMatrix"):
        tsw.sw_full_cuda(*args, torch.from_numpy(big), go, ge)


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
    args = [torch.from_numpy(x) for x in (q, s, slens)]
    with pytest.raises(ValueError, match="cuda"):
        tsw.sw_full_cuda(*args, tsw.device_matrix(m, "cpu"), go, ge,
                         track=True)


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
        assert not tsw.sw_band_instance(Q, S, W, tsw.device_matrix(
            np.eye(8, dtype=np.int32), "cpu"), True).endswith("_strips"), Q


def test_band_cpu_path_launches_no_kernel(scoring):
    m, go, ge = scoring
    q, s, slens = _band_windows(2, 4, 128, 256, 16, 128)
    before = dict(tsw.launches)
    tsw.sw_band_score_batch(q, s, slens, m, go, ge, 16, device="cpu",
                            track=True)
    assert tsw.launches == before


def test_band_cuda_wrapper_rejects_cpu_tensors_and_wide_bands(scoring):
    """The kernel wrapper takes CUDA tensors only: it never runs the plain
    version in place of the kernel.  A band past TILED_BAND_W is no longer
    refused for its width (it runs the cluster kernel, and past
    CLUSTER_BAND_W the strip kernel); a width below 1 is."""
    m, go, ge = scoring
    q, s, slens = _band_windows(3, 4, 128, 256, 16, 128)
    args = [torch.from_numpy(x) for x in (q, s, slens)]
    args.append(tsw.device_matrix(m, "cpu"))
    with pytest.raises(ValueError, match="cuda"):
        tsw.sw_band_cuda(*args, go, ge, 16, 128, track=True)
    with pytest.raises(ValueError, match="cuda"):
        tsw.sw_band_cuda(*args, go, ge, 16, tsw.TILED_BAND_W + 128)
    with pytest.raises(ValueError, match="cuda"):
        tsw.sw_band_cuda(*args, go, ge, 16, tsw.CLUSTER_BAND_W + 128)
    with pytest.raises(ValueError, match="band width 0"):
        tsw.sw_band_cuda(*args, go, ge, 16, 0)
    # the int32 DP's bound (check_score_cap), before anything of the
    # card: an entry of 2^24 on a 64 x 64 window reaches 2^30
    big = m.copy()
    big[0, 0] = 1 << 24
    small = torch.zeros((1, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^30"):
        tsw.sw_band_cuda(small, small, args[2][:1],
                         tsw.device_matrix(big, "cpu"), go, ge, 16, 128)


def _band_t_matrix(q, s, slen, m, go, ge, pad, W):
    """T of one window in the band frame by the textbook Gotoh
    recurrences, cell by cell: band lane t of row i is query column
    i - (pad + W//2) + t (code 7 outside the query); the diagonal stays
    in its lane, E comes from lane t + 1 of the row above, F from the
    left."""
    prepad, neg = pad + W // 2, -(1 << 28)
    H, E = np.zeros(W, np.int64), np.full(W, neg, np.int64)
    T = np.zeros((slen, W), np.int64)
    for i in range(slen):
        F, hleft = neg, neg
        Hn, En = H.copy(), E.copy()
        for t in range(W):
            j = i - prepad + t
            T[i, t] = H[t] + m[s[i], q[j] if 0 <= j < len(q) else 7]
            ein = E[t + 1] if t + 1 < W else neg
            F = max(F - ge, hleft - go)
            h = max(T[i, t], ein, F, 0)
            Hn[t], En[t], hleft = h, max(ein - ge, h - go), h
        H, E = Hn, En
    return T


def test_band_tie_windows_do_tie(scoring):
    """In most windows of the band tie generator the maximum of T is
    reached in several cells of the band, in more than one row and more
    than one band lane, and the plain version names the first of them in
    row-major order, in query coordinates; a window that scores nothing
    gives (0, 0, -prepad)."""
    m, go, ge = scoring
    Q, S, pad, W = 48, 64, 4, 24
    q, s, slens = tsw.tie_windows(np.random.default_rng(12), 24, Q, S)
    got = tsw.sw_band_score_batch(q, s, slens, m, go, ge, pad, W,
                                  device="cpu", track=True)
    got = np.stack([g.numpy() for g in got], axis=1)
    prepad = pad + W // 2
    tied = rows = lanes = zero = 0
    for b in range(len(q)):
        T = _band_t_matrix(q[b], s[b], int(slens[b]), m, go, ge, pad, W)
        M = int(T.max()) if T.size else 0
        if M <= 0:
            assert tuple(got[b]) == (0, 0, -prepad)
            zero += 1
            continue
        ii, tt = np.nonzero(T == M)          # row-major order
        assert tuple(got[b]) == (M, ii[0], ii[0] + tt[0] - prepad)
        tied += len(ii) > 1
        rows += len(set(ii)) > 1
        lanes += len(set(tt)) > 1
    assert tied >= 12 and rows >= 6 and lanes >= 6 and zero >= 3


@pytest.mark.parametrize("track", [True, False])
@pytest.mark.parametrize("Q,B", [(256, 8), (640, 6)])
def test_band_tie_windows_match_pallas_interpret(scoring, Q, B, track):
    """The tie-heavy band windows chip_smoke.py feeds the banded kernel
    (the long-read geometry: S = window_len, pad = window_pad, W as
    clamped): the plain version equals the jnp oracle and the Pallas
    kernel in interpret mode on them, and some windows score nothing."""
    m, go, ge = scoring
    q, s, slens, pad, W, S = tsw.band_tie_windows(
        np.random.default_rng(Q + 1), B, Q)
    assert (S, pad, W) == tsw.band_geometry(Q) and s.shape == (B, S)
    got = tsw.sw_band_score_batch(q, s, slens, m, go, ge, pad, W,
                                  device="cpu", track=track)
    _assert_equal(got, jsw.sw_band_score_ref(q, s, slens, m, go, ge, pad, W,
                                             track=track), track)
    _assert_equal(got, jsw.sw_band_score_batch(q, s, slens, m, go, ge, pad,
                                               W, interpret=True,
                                               track=track), track)
    best = got[0] if track else got
    assert (best == 0).sum() >= 1 and (best > Q // 4).sum() >= B // 2
    if track:
        none = best == 0
        assert (got[1][none] == 0).all()
        assert (got[2][none] == -(pad + W // 2)).all()


@pytest.mark.parametrize("track", [True, False])
@pytest.mark.parametrize("W", [200, 330])
def test_band_odd_widths_match_jax_ref(scoring, W, track):
    """Band widths that are no multiple of 32 (the Hopper kernel then
    holds padding lanes past W; chip_smoke.py runs these widths on the
    card): the plain version against the jnp oracle at Q = 640, on
    planted alignments and on tie-heavy windows."""
    m, go, ge = scoring
    Q = 640
    S, pad, _ = tsw.band_geometry(Q)
    for q, s, slens in (_band_windows(W, 4, Q, S, pad, W),
                        tsw.tie_windows(np.random.default_rng(W), 4, Q, S)):
        args = [torch.from_numpy(x) for x in (q, s, slens, m)]
        got = tsw.sw_band_score_ref(*args, go, ge, pad, W, track=track)
        _assert_equal(got, jsw.sw_band_score_ref(q, s, slens, m, go, ge, pad,
                                                 W, track=track), track)
        assert int((got[0] if track else got).max()) > Q // 4


@pytest.mark.parametrize("kernel,shapes", [("sw_full", [(48, 64, 6)]),
                                           ("sw_band", [(640, 3)])])
def test_time_sw_cases(scoring, monkeypatch, kernel, shapes):
    """The timing script's inputs (ops/time_sw.py; it needs a card to
    run): every case carries windows of its shape, a plain version that
    runs on a head of them, the band's launch arguments and a roofline
    bound; tie-heavy windows of the widest shapes are checked, not timed;
    sw_full's shapes of short reads in their bucket (FULL_QEND) carry pad
    code from qend on and a bound over the cells inside the query, and
    its STRIP_ROUTES shapes both strip kernels' routes.  Without a card
    the script exits 1."""
    from smalt_tpu_torch.ops import time_sw
    m, go, ge = scoring
    monkeypatch.setattr(time_sw, "FULL_SHAPES" if kernel == "sw_full"
                        else "BAND_SHAPES", shapes)
    monkeypatch.setattr(time_sw, "BAND_WIDE", [(640, 3, 200,
                                                ("many", "cluster"))])
    monkeypatch.setattr(time_sw, "WIDE_HEAD_ROWS", 96)
    monkeypatch.setattr(time_sw, "FULL_QEND", [(600, 64, 6, 520)])
    monkeypatch.setattr(time_sw, "STRIP_ROUTES", [(600, 64, 4)])
    mat = tsw.device_matrix(m, "cpu")
    got = list(time_sw.cases(kernel, np.random.default_rng(3), "cpu", mat,
                             go, ge))
    if kernel == "sw_full":
        # reads shorter than their bucket (the strip path): pad code from
        # qend on, and the bound over the cells inside the query
        both, qe, got = got[4:], got[2:4], got[:2]
        assert [c.kind for c in both] == ["random", "ties"]
        for c in both:
            assert c.routes == ("wave", "warp") and c.shape == "Q=600 S=64 B=4"
            assert c.tensors[0].shape == (4, 600) and c.timed == \
                (c.kind == "random")
        assert [c.kind for c in qe] == ["random", "ties"]
        for c in qe:
            assert c.shape.endswith("qend=520") and \
                bool((c.tensors[0][:, 520:] == 7).all())
            work = c.work(True)
            assert 0 < work["cells"] < work["cells_all"]
    if kernel == "sw_band":
        # past 512 lanes: the routes, the subject cut to its rows, and
        # the plain version on the first WIDE_HEAD_ROWS of them
        wide = got.pop()
        q, s, sl = wide.tensors
        S, pad, W = tsw.band_geometry(640)
        assert wide.routes == ("many", "cluster") and wide.head_rows == 96
        assert s.shape == (3, 200) and int(sl.max()) <= 200 and wide.timed
        want = tsw.sw_band_score_ref(q[:2], s[:2, :96].contiguous(),
                                     torch.clamp_max(sl[:2], 96), mat.t, go,
                                     ge, pad, W, track=True)
        assert all(torch.equal(a, b) for a, b in zip(wide.plain(2), want))
        assert all(r in time_sw.ENTRY for r in wide.routes)
    assert [c.kind for c in got] == ["random", "ties"]
    for c in got:
        q, s, sl = c.tensors
        assert q.shape[0] == s.shape[0] == sl.shape[0] == shapes[0][-1]
        best, ti, tj = c.plain(2)
        assert best.shape == (2,) and best.dtype == torch.int32
        work = c.work(True)
        assert work["cells"] > 0 and work["bound_ms"] > 0
        if kernel == "sw_band":
            S, pad, W = tsw.band_geometry(640)
            assert c.band == (W, pad + W // 2) and s.shape[1] == S
            want = tsw.sw_band_score_ref(q[:2], s[:2], sl[:2], mat.t, go,
                                         ge, pad, W, track=True)
            assert all(torch.equal(a, b) for a, b in zip((best, ti, tj), want))
        else:
            assert c.band == ()
        assert c.timed
    if not torch.cuda.is_available():
        assert time_sw.main(["--kernel", kernel]) == 1


# ------------------------------------------------------------------
# which instance a CUDA launch runs, decided on the host (pure functions,
# so the card's routing is held here)
# ------------------------------------------------------------------

@pytest.mark.parametrize("B,Q,S,entry,track,want", [
    (256, 32768, 2048, 127, False, "sw_full_strip"),   # the pass-1 lane, 20 kb
    (1535, 2048, 2304, 127, True, "sw_full_track_strip"),
    (1536, 2048, 2304, 127, True, "sw_full_track_warp"),
    (32768, 2048, 2304, 127, False, "sw_full_warp"),   # 1,500 bp, pass 1
    (384, 1504, 1792, 127, True, "sw_full_track_strip"),  # the 1x2 mesh
    # WIDE and the record: the wavefront at any batch
    (32768, 2048, 2304, 200, False, "sw_full_strip_wide"),
    (4096, 2048, 2304, 200, True, "sw_full_track_strip_wide"),
    (4096, 2048, 2304, 5000, True, "sw_full_track_strip_rec"),
    (4096, 2048, 2304, 5000, False, "sw_full_strip_wide"),
    (4096, 70_000, 70_000, 127, True, "sw_full_track_strip_rec"),  # int8
    (1, 512, 640, 127, True, "sw_full_track"),         # in registers: any B
    (100_000, 512, 640, 200, False, "sw_full_wide"),
])
def test_sw_full_instance_names_the_strip_kernel(B, Q, S, entry, track,
                                                  want):
    """Past 512 columns the name tells the strip path's two kernels apart,
    as strip_warps routes the batch: "_strip" on the wavefront, "_warp" on
    the one-warp kernel (an int8 instance keeping the key, from
    STRIP_ONE_WARP_B windows); the record and the WIDE suffix as in
    registers.  Every name is a launch count's, and its `wide` code the C
    interface's (never WIDE on the one-warp kernel)."""
    m = np.zeros((8, 8), np.int32)
    m[0, 0] = entry
    mat = tsw.device_matrix(m, "cpu")
    got = tsw.sw_full_instance(B, Q, S, mat, track)
    assert got == want
    wide = tsw._wide_code(got) > 0
    assert got.endswith("_warp") == \
        (Q > tsw.MAX_Q and tsw.strip_warps(B, Q, S, wide) == 1)
    assert not (wide and "_warp" in got)
    assert want in tsw.launches
    assert tsw._wide_code(want) == (2 if want.endswith("_rec") else
                                    1 if want.endswith("_wide") else 0)


@pytest.mark.parametrize("Q,S,entry,track,want", [
    (112, 128, 127, True, "sw_full_track"),            # int8, in registers
    (112, 128, 200, True, "sw_full_track_wide"),       # a matrix past int8
    (112, 128, 200, False, "sw_full_wide"),
    (2048, 2304, 127, True, "sw_full_track_strip"),    # past 512 columns
    (2048, 2304, 200, True, "sw_full_track_strip_wide"),
    # int8 entries on a window that could score 2^23: the key's limit
    (70_000, 70_000, 127, True, "sw_full_track_strip_rec"),
    (70_000, 70_000, 127, False, "sw_full_strip"),     # score-only: no key
    (65_000, 70_000, 127, True, "sw_full_track_strip"),  # 127 * 65,000 < 2^23
    # in registers, entries past int8: the key up to 2^23, then the record
    (512, 16_384, 16_383, True, "sw_full_track_wide"),
    (512, 16_384, 16_384, True, "sw_full_track_rec"),
    (512, 16_384, 16_384, False, "sw_full_wide"),
    (4096, 4096, 2048, True, "sw_full_track_strip_rec"),
])
def test_sw_full_instance_routing(Q, S, entry, track, want):
    """A tracked launch whose window could score 2^23 (max|entry| *
    min(Q, S)) runs the two-part record (_rec: the WIDE instance of
    sw_full.cu's _rec kernels), whatever the matrix; every other tracked
    launch keeps the key, a matrix past int8 on the WIDE instance; a
    score-only launch tracks no cell and never takes the record.  Every
    name is a launch count's, and its `wide` code the C interface's.  (A
    batch of one window: past 512 columns the wavefront.)"""
    m = np.zeros((8, 8), np.int32)
    m[0, 0] = entry
    mat = tsw.device_matrix(m, "cpu")
    assert tsw.key_over(mat, Q, S) == (entry * min(Q, S) >= 1 << 23)
    assert tsw.sw_full_instance(1, Q, S, mat, track) == want
    assert want in tsw.launches
    assert tsw._wide_code(want) == (2 if want.endswith("_rec") else
                                    1 if want.endswith("_wide") else 0)


@pytest.mark.parametrize("W,S,entry,track,want", [
    (384, 1792, 3, True, "sw_band_track"),     # 1,500 bp reads
    (768, 4864, 3, True, "sw_band_track"),     # several warps, int8
    (3072, 18432, 3, True, "sw_band_track"),   # the 6-warp kernel's widest
    (3200, 18560, 3, True, "sw_band_track_many"),   # past 3,072 lanes
    (3840, 22528, 3, False, "sw_band_many"),   # 20 kb reads
    (12288, 73472, 200, True, "sw_band_track_many"),  # wide matrix: many
    (12416, 73728, 3, False, "sw_band_many"),         # past 12,288 lanes
    (12800, 76160, 3, True, "sw_band_track_many"),    # the kernel's widest
    (12928, 76928, 3, False, "sw_band_strips"),       # past 12,800 lanes
    (16384, 97920, 200, True, "sw_band_track_strips"),  # wide matrix too
    (16512, 98048, 3, True, "sw_band_track_strips"),    # past 16,384 lanes
    (18816, 112_512, 3, False, "sw_band_strips"),       # 100 kb reads
    (18816, 112_512, 200, True, "sw_band_track_strips"),  # wide too
    (131072, 700_000, 3, True, "sw_band_track_strips"),  # the cluster's widest
    (131200, 700_000, 3, False, "sw_band_strips"),      # past 131,072
    (131200, 700_000, 200, True, "sw_band_track_strips"),
    (384, 1792, 200, True, "sw_band_track_wide"),
    (512, 70_000, 127, True, "sw_band_track_wide"),  # 2^23 on int8 entries
    (512, 70_000, 127, False, "sw_band"),
])
def test_sw_band_instance_routing(W, S, entry, track, want):
    """W > 12,800 (CLUSTER_BAND_W, = TILED_BAND_W: no band is left to
    sw_band_cluster_kernel) runs sw_band_strips_kernel, to 131,072 lanes
    and past, and W > 3,072 (MULTI_BAND_W)
    the several-warps kernel on 20 lanes a thread ("_many"), whatever the
    matrix; below it a matrix past int8, or a tracked band of up to 512
    lanes that could score 2^23, runs the several-warps kernel ("_wide":
    the `wide` code of sw_band_launch, band_wide_code)."""
    m = np.zeros((8, 8), np.int32)
    m[0, 0] = entry
    mat = tsw.device_matrix(m, "cpu")
    Q = S if S in (70_000, 700_000) else S * 8 // 9
    assert tsw.sw_band_instance(Q, S, W, mat, track) == want
    assert want in tsw.launches
    assert tsw.MULTI_BAND_W == 3072 and tsw.TILED_BAND_W == 12800
    assert tsw.CLUSTER_BAND_W == 12800 and tsw.CLUSTER_MAX_W == 131072


def test_band_width_of_long_reads_fits_the_many_kernel():
    """The band of a read padded to Q: past ~16 kb it is wider than the
    several-warps kernel's 3,072 lanes of 12 a thread, up to ~68 kb within
    TILED_BAND_W (20 lanes a thread), and past that the strip
    kernel's."""
    from smalt_tpu_torch.parallel.mesh import window_pad
    for Q, many in ((16384, False), (16400, True), (20000, True),
                    (65280, True), (65552, True), (67600, True)):
        W = tsw.clamp_band_width(Q, window_pad(Q))
        assert (W > tsw.MULTI_BAND_W) == many and W <= tsw.TILED_BAND_W, Q
    for Q in (68288, 87040, 90000):
        W = tsw.clamp_band_width(Q, window_pad(Q))
        assert W > tsw.TILED_BAND_W


@pytest.mark.parametrize("B,S,budget,want", [
    (10, 1024, 3 * 8 * 1024, [(0, 3), (3, 6), (6, 9), (9, 10)]),
    (4, 1024, 8 * 1024 - 1, [(0, 1), (1, 2), (2, 3), (3, 4)]),  # >= 1 a group
    (5, 128, 1 << 30, [(0, 5)]),
    (0, 128, 1 << 30, []),
])
def test_strip_groups_split_the_scratch(B, S, budget, want, monkeypatch):
    """The strip path's carry (8 * S bytes a window) is launched in groups
    that fit SCRATCH_BYTES (set here as chip_smoke.py lowers it); at the
    module's own budget, 40,000 windows of 32,768 rows need several
    groups."""
    groups = tsw.scratch_groups(40_000, 8 * 32_768)
    per = tsw.SCRATCH_BYTES // (8 * 32_768)
    assert len(groups) == -(-40_000 // per) > 1
    assert all(8 * 32_768 * (hi - lo) <= tsw.SCRATCH_BYTES
               for lo, hi in groups)
    assert groups[-1][1] == 40_000
    monkeypatch.setattr(tsw, "SCRATCH_BYTES", budget)
    assert tsw.scratch_groups(B, 8 * S) == want


@pytest.mark.parametrize("thresh", [16384, 512])
def test_tiled_route_follows_the_threshold(thresh, monkeypatch):
    """Past TILED_BAND_W sw_band_instance names the cluster kernel, and
    the strip kernel exactly when W passes CLUSTER_BAND_W too: with
    TILED_BAND_W at the module's own value and at a lowered one (as
    chip_smoke.py lowers it to hold these kernels at small widths), and
    CLUSTER_BAND_W at its own value and lowered to twice TILED_BAND_W,
    whatever the matrix and tracking."""
    monkeypatch.setattr(tsw, "TILED_BAND_W", thresh)
    for cap in (tsw.CLUSTER_BAND_W, 2 * thresh):
        monkeypatch.setattr(tsw, "CLUSTER_BAND_W", cap)
        for entry in (3, 200):
            m = np.zeros((8, 8), np.int32)
            m[0, 0] = entry
            mat = tsw.device_matrix(m, "cpu")
            for W in (thresh - 128, thresh - 1, thresh, thresh + 1,
                      thresh + 128, 2 * thresh, 2 * thresh + 1, 4 * thresh):
                for track in (True, False):
                    name = tsw.sw_band_instance(W * 5, W * 6, W, mat, track)
                    assert name.endswith("_strips") == (W > cap), (W, name)
                    assert name.endswith("_cluster") == \
                        (thresh < W <= cap), (W, name)
                    assert name in tsw.launches


def test_tiled_scratch_groups_fit_the_budget(monkeypatch):
    """The strip kernel's scratch (band_strip_bytes(S) a window: the carry
    column and the flags) goes in groups of windows within SCRATCH_BYTES,
    the budget sw_full's strip carry uses: one group for the 3 windows of
    a read of 700 kb at the module's budget, and as many as the budget
    holds for the default batch's 12,288 windows or once it is lowered,
    every group within it."""
    S, _, W = tsw.band_geometry(700_000)
    assert W > tsw.CLUSTER_BAND_W
    per_w = tsw.band_strip_bytes(S)
    assert per_w == 8 * S + 4 * (10 + S // 32) and \
        tsw.band_strip_flag_words(3, S) == 8 + 3 * (10 + S // 32)
    per = tsw.SCRATCH_BYTES // per_w
    assert tsw.scratch_groups(3, per_w) == [(0, 3)]
    assert len(tsw.scratch_groups(3 * 4096, per_w)) == -(-3 * 4096 // per)
    for budget in (per_w * 5, per_w * 5 + 7, per_w - 1):
        monkeypatch.setattr(tsw, "SCRATCH_BYTES", budget)
        groups = tsw.scratch_groups(12, per_w)
        assert groups[0][0] == 0 and groups[-1][1] == 12
        assert all(a[1] == b[0] for a, b in zip(groups, groups[1:]))
        assert all(per_w * (hi - lo) <= max(budget, per_w)
                   for lo, hi in groups)
        assert len(groups) == (3 if budget >= per_w else 12)


def test_band_past_16384_lanes_matches_jax(scoring):
    """The band-width refusal is gone: a CPU call at W = 16,512 (the
    plain version, a few subject rows) returns what smalt_tpu's
    sw_band_score_ref returns, tracked and score-only."""
    m, go, ge = scoring
    Q, S, B, pad, W = 16_400, 6, 3, 40, 16_512
    q, s, slens = _band_windows(12, B, Q, S, pad, W)
    slens[1] = S
    for track in (True, False):
        got = tsw.sw_band_score_batch(q, s, slens, m, go, ge, pad, W,
                                      device="cpu", track=track)
        want = jsw.sw_band_score_ref(q, s, slens, m, go, ge, pad, W,
                                     track=track)
        for g, w in zip(got if track else [got], want if track else [want]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed,W,tw", [(1, 256, 64), (2, 200, 64),
                                       (3, 330, 128), (4, 96, 96)])
def test_tiled_order_matches_plain(scoring, seed, W, tw):
    """The kernel past CLUSTER_BAND_W, the strip kernel: its order of work
    (test_torch_band_strips.band_strips_render, strips of tw columns on
    lanes of tw / 8, much narrower than the band, so that every window
    crosses many strip and group edges, and widths that end inside a
    strip) equals sw_band_score_ref exactly, tracked and score-only, on
    planted and on tie-heavy windows."""
    from test_torch_band_strips import band_strips_render
    m, go, ge = scoring
    rng = np.random.default_rng(seed)
    Q, S, pad = 320, 448, 24
    q, s, slens = _band_windows(seed, 6, Q, S, pad, W)
    tq, ts, tsl = tsw.tie_windows(rng, 8, Q, S)
    for q_, s_, sl_ in ((q, s, slens), (tq, ts, tsl)):
        (b_, i_, j_), b0 = band_strips_render(
            q_, s_, sl_, m, go, ge, pad, W, C=tw // 8, L=8, NW=2, slots=4)
        got = (b_, i_, j_, b0)
        args = [torch.from_numpy(np.ascontiguousarray(x, np.int32))
                for x in (q_, s_, sl_)]
        want = tsw.sw_band_score_ref(*args, torch.from_numpy(m), go, ge,
                                     pad, W, track=True)
        for k in range(3):
            np.testing.assert_array_equal(got[k], want[k].numpy())
        np.testing.assert_array_equal(got[3], want[0].numpy())
