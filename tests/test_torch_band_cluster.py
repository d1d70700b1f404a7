"""sw_band.cu's cluster kernel (csrc/sw_band_cluster.cuh) on the CPU: a
numpy rendering of its order of work held exactly equal to the port's and
smalt_tpu's sw_band_score_ref, tracked and score-only, and the host-side
choices that send a band to it (sw_band_instance, cluster_shape).  The
kernel itself runs only on a card (chip_smoke.py phase 3b holds it
against the plain version there)."""
import numpy as np
import pytest
import torch

from smalt_tpu.align import core as ali
from smalt_tpu.ops import sw as jsw
from smalt_tpu_torch.ops import sw as tsw

NEG = -(1 << 28)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scoring():
    m, go, ge = ali.make_score_matrix()
    return m, -go, -ge


def _cluster_model(q, s, slens, m, go, ge, pad, W, C, NW, K):
    """A numpy rendering of sw_band_cluster_kernel's order of work: K CTAs
    of NW warps of 32 threads of C lanes hold the band (padded to
    K * NW * 32 * C >= W lanes), and the cluster's G = K * NW warps are
    the units of the exchange.  A row: each warp's T, H0 (its last lane
    without Ein) and its scan; each posts its total and the E of its
    first lane from the row before; then each warp takes the totals of
    every warp to its left, each corrected by the E that warp's last lane
    takes from the warp after it (NEG past the last), and that E for its
    own last lane; the lanes at or past W keep E = NEG.  Tracking: each
    thread's record, replaced only by a row whose max of T over its real
    lanes is strictly greater (naming that row's lowest such lane), and
    after the last row the highest T, then the lowest row, then the
    lowest lane over the records.  Returns (best, ti, tj) and the
    score-only best, int64 [4, B]."""
    B, Q = q.shape
    S = s.shape[1]
    prepad = pad + W // 2
    L = 32 * C                          # lanes a warp
    G = K * NW
    WP = G * L
    assert WP >= W
    t = np.arange(WP, dtype=np.int64).reshape(G, L)
    real = t < W
    last = t[:, -1]                     # each warp's last lane
    out = np.zeros((4, B), np.int64)
    for b in range(B):
        H = np.zeros((G, L), np.int64)
        E = np.full((G, L), NEG, np.int64)
        rec = np.zeros((3, G * 32), np.int64)   # each thread's (T, row, lane)
        for i in range(min(int(slens[b]), S)):
            j = i - prepad + t
            qc = np.where((j >= 0) & (j < Q), q[b, j.clip(0, Q - 1)], 7)
            T = H + m[s[b, i], qc]
            ein = np.concatenate([E[:, 1:], np.full((G, 1), NEG)], axis=1)
            H0 = np.maximum(np.maximum(T, ein), 0)
            run = np.maximum.accumulate(H0 + t * ge, axis=1)
            tot = run[:, -1]            # posted: the last lane lacks Ein
            eb = np.append(E[:, 0], NEG)   # the row before; NEG past G
            corr = np.maximum(tot, eb[1:] + last * ge)
            pre = np.concatenate([[NEG], np.maximum.accumulate(corr)[:-1]])
            excl = np.concatenate([np.full((G, 1), NEG), run[:, :-1]], axis=1)
            F = np.maximum(excl, pre[:, None]) - go - (t - 1) * ge
            ein[:, -1] = eb[1:]
            H0[:, -1] = np.maximum(H0[:, -1], ein[:, -1])
            H = np.maximum(H0, F)
            E = np.where(real, np.maximum(ein - ge, H - go), NEG)
            Tt = np.where(real, T, NEG).reshape(G * 32, C)
            m_t = Tt.max(axis=1)
            up = m_t > rec[0]
            rec[1, up] = i
            rec[2, up] = (np.arange(G * 32) * C + np.argmax(
                Tt == m_t[:, None], axis=1))[up]
            rec[0] = np.maximum(rec[0], m_t)
        # highest T, then lowest row, then lowest lane
        k = np.lexsort((rec[2], rec[1], -rec[0]))[0]
        best, bi, blane = (int(x) for x in rec[:, k])
        out[:, b] = best, bi, bi + blane - prepad, rec[0].max()
    return out


def _windows(seed, B, Q, S, pad, W):
    """Band windows around the diagonal (shifts inside and outside the
    band, an indel walk, substitutions, N codes, shorter queries and
    subjects), one with slen 0 and one a pad read (all code 7)."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 4, (B, S)).astype(np.int32)
    q = rng.integers(0, 4, (B, Q)).astype(np.int32)
    shifts = [0, W // 8, -(W // 6), W // 2 + 10, -(W // 2) - 20]
    for b in range(B):
        walk = np.cumsum(rng.choice([-1, 0, 1], Q, p=[0.01, 0.98, 0.01]))
        idx = pad + shifts[b % len(shifts)] + np.arange(Q) + walk
        ok = (idx >= 0) & (idx < S)
        q[b, ok] = s[b, idx[ok]]
    mut = rng.random((B, Q)) < 0.03
    q[mut] = rng.integers(0, 4, int(mut.sum()))
    q[rng.random((B, Q)) < 0.01] = 5
    qlen = rng.integers(Q * 3 // 4, Q + 1, B)
    q[np.arange(Q)[None, :] >= qlen[:, None]] = 7
    slens = rng.integers(S // 2, S + 1, B).astype(np.int32)
    slens[0] = S
    slens[1] = 0
    q[2] = 7
    s[np.arange(S)[None, :] >= slens[:, None]] = 7
    return q, s, slens


# (seed, W, C, NW): CTA slices of NW * 32 * C lanes, much narrower than
# the band; widths that end inside a thread, a warp and a CTA, one whole
# CTA of padding lanes, and one CTA holding the whole band
@pytest.mark.parametrize("seed,W,C,NW", [(1, 330, 2, 2), (2, 256, 1, 2),
                                         (3, 200, 2, 1), (4, 384, 1, 3),
                                         (5, 96, 1, 1), (6, 130, 4, 2)])
def test_cluster_order_matches_plain(scoring, seed, W, C, NW):
    """The cluster kernel's order of work (_cluster_model) equals the
    port's sw_band_score_ref and smalt_tpu's exactly, tracked and
    score-only, on planted windows (a slen-0 window and a pad read among
    them) and on tie-heavy ones."""
    m, go, ge = scoring
    Q, S, pad = 320, 448, 24
    K = -(-W // (NW * 32 * C))
    if seed == 1:
        K += 1                          # a CTA wholly past W
    q, s, sl = _windows(seed, 6, Q, S, pad, W)
    tq, ts, tsl = tsw.tie_windows(np.random.default_rng(seed), 8, Q, S)
    for q_, s_, sl_ in ((q, s, sl), (tq, ts, tsl)):
        got = _cluster_model(q_, s_, sl_, m.astype(np.int64), go, ge, pad, W,
                             C, NW, K)
        args = [torch.from_numpy(np.ascontiguousarray(x, np.int32))
                for x in (q_, s_, sl_)]
        want = tsw.sw_band_score_ref(*args, torch.from_numpy(m), go, ge,
                                     pad, W, track=True)
        jwant = jsw.sw_band_score_ref(q_, s_, sl_, m, go, ge, pad, W,
                                      track=True)
        for k in range(3):
            np.testing.assert_array_equal(got[k], want[k].numpy())
            np.testing.assert_array_equal(got[k], np.asarray(jwant[k]))
        np.testing.assert_array_equal(got[3], want[0].numpy())
        assert int(want[0].max()) > 0


# the one-row-old E term: (W, C, NW, K, first lanes of warps to plant at);
# W 96 on three CTAs of one warp (its CTA edges), W 200 on CTAs of two
# warps of 64 lanes (a warp edge inside a CTA and the CTA edge)
@pytest.mark.parametrize("W,C,NW,K,edges", [(96, 1, 1, 3, (32, 64)),
                                            (200, 2, 2, 2, (128, 192))])
def test_cluster_order_eterm_binds(W, C, NW, K, edges):
    """Windows whose best path takes a vertical gap into a warp's (and a
    CTA's) last lane and a horizontal gap from there into the next warp
    (tsw.eterm_windows, gaps of 8 + 1 a base): the warp's posted total
    lacks that lane's Ein, so only the correction by the next warp's
    first E of the row before (`eb` in the model) carries the path; the
    model equals the port's and smalt_tpu's sw_band_score_ref, which
    reach at least the planted score.  (Without the term the model
    scores 3 less on 4 of the 6 windows at W 96 and on all 6 at W 200.)"""
    m, go, ge = ali.make_score_matrix(1, -6, -8, -1)
    go, ge = -go, -ge
    Q, S, pad = 448, 512, 24
    q, s, sl, planted = tsw.eterm_windows(np.random.default_rng(W), 6, Q, S,
                                          pad, W, edges, 1, go, ge)
    got = _cluster_model(q, s, sl, m.astype(np.int64), go, ge, pad, W, C,
                         NW, K)
    want = tsw.sw_band_score_ref(*(torch.from_numpy(x) for x in (q, s, sl)),
                                 torch.from_numpy(m), go, ge, pad, W,
                                 track=True)
    jwant = jsw.sw_band_score_ref(q, s, sl, m, go, ge, pad, W, track=True)
    for k in range(3):
        np.testing.assert_array_equal(got[k], want[k].numpy())
        np.testing.assert_array_equal(got[k], np.asarray(jwant[k]))
    np.testing.assert_array_equal(got[3], want[0].numpy())
    assert (got[0] >= planted).all()


def test_cluster_order_wide_matrix_and_nothing_scores(scoring):
    """A matrix outside int8 (match 200, mismatch -200, X -400) and
    windows in which nothing scores ((0, 0, -prepad), as a slen-0
    window returns): the model still equals sw_band_score_ref."""
    m, go, ge = ali.make_score_matrix(200, -200)
    go, ge = -go, -ge
    Q, S, pad, W = 256, 320, 16, 200
    q, s, sl = _windows(9, 5, Q, S, pad, W)
    s[3] = (q[3, 0] + 1) % 4            # a subject of one base, the
    q[3] = q[3, 0]                      # query of another: no T > 0
    got = _cluster_model(q, s, sl, m.astype(np.int64), go, ge, pad, W, 1, 2,
                         4)
    args = [torch.from_numpy(x) for x in (q, s, sl)]
    want = tsw.sw_band_score_ref(*args, torch.from_numpy(m), go, ge, pad, W,
                                 track=True)
    for k in range(3):
        np.testing.assert_array_equal(got[k], want[k].numpy())
    prepad = pad + W // 2
    for b in (1, 2, 3):                 # slen 0, a pad read, no match
        assert tuple(got[:, b]) == (0, 0, -prepad, 0)


@pytest.mark.parametrize("W", [1, 200, 768, 2048, 2049, 3840, 16385, 18816,
                               30720, 32768, 32769, 40000, 100_000,
                               tsw.CLUSTER_MAX_W])
def test_cluster_shape_holds_the_band(W):
    """cluster_shape gives a launch sw_band_cluster_launch takes: 1 to
    CLUSTER_MAX CTAs of whole warps, up to 512 threads, room for the band
    at CLUSTER_C lanes a thread, CTAs of about CLUSTER_CTA_LANES lanes
    while CLUSTER_MAX of them hold it, and no warp of padding alone."""
    ncta, nt = tsw.cluster_shape(W)
    C = tsw.CLUSTER_C
    assert 1 <= ncta <= tsw.CLUSTER_MAX and nt % 32 == 0 and 32 <= nt <= 512
    assert ncta * nt * C >= W > (nt - 32) * ncta * C
    if W <= tsw.CLUSTER_MAX * tsw.CLUSTER_CTA_LANES:
        assert ncta == -(-W // tsw.CLUSTER_CTA_LANES)
        assert nt * C <= tsw.CLUSTER_CTA_LANES
    else:
        assert ncta == tsw.CLUSTER_MAX


def test_cluster_shape_of_100kb_reads():
    """The 6 windows of 2 reads of 100 kb (W = 18,816) take 10 CTAs of
    128 threads, 2,048 lanes each: 60 SMs, where one block a window (an
    earlier tiled kernel) took 6."""
    from smalt_tpu_torch.parallel.mesh import window_pad
    W = tsw.clamp_band_width(100_000, window_pad(100_000))
    assert W == 18816
    assert tsw.cluster_shape(W) == (10, 128)
    assert tsw.cluster_shape(tsw.CLUSTER_MAX_W) == (16, 512)
    assert tsw.CLUSTER_MAX_W == 16 * 512 * tsw.CLUSTER_C
    for bad in (0, tsw.CLUSTER_MAX_W + 1):
        with pytest.raises(ValueError, match="band width"):
            tsw.cluster_shape(bad)


@pytest.mark.parametrize("tiled,cluster", [(12800, 12800), (12800, 131072),
                                           (512, 4096), (0, 768)])
def test_band_routes_across_both_thresholds(tiled, cluster, monkeypatch):
    """sw_band_instance names the cluster kernel for TILED_BAND_W < W <=
    CLUSTER_BAND_W and the strip kernel past CLUSTER_BAND_W, whatever the
    matrix and tracking, at the module's values (no band for the cluster
    kernel), with the cluster route raised to CLUSTER_MAX_W and at lowered
    ones (as chip_smoke.py sets them to hold both kernels at small widths);
    every name is a launch counter."""
    assert (tsw.TILED_BAND_W, tsw.CLUSTER_BAND_W, tsw.CLUSTER_MAX_W) == \
        (12800, 12800, 131072)
    monkeypatch.setattr(tsw, "TILED_BAND_W", tiled)
    monkeypatch.setattr(tsw, "CLUSTER_BAND_W", cluster)
    for entry in (3, 200):
        mat = np.zeros((8, 8), np.int32)
        mat[0, 0] = entry
        dm = tsw.device_matrix(mat, "cpu")
        for W in sorted({max(tiled - 1, 1), tiled, tiled + 1, cluster - 1,
                         cluster, cluster + 1, 4 * cluster}):
            if W < 1:
                continue
            for track in (True, False):
                name = tsw.sw_band_instance(W * 5, W * 6, W, dm, track)
                assert name.endswith("_cluster") == (tiled < W <= cluster)
                assert name.endswith("_strips") == (W > cluster), (W, name)
                assert name.startswith("sw_band_track" if track
                                       else "sw_band")
                assert name in tsw.launches


def test_cluster_wrapper_takes_cuda_tensors_only(scoring, monkeypatch):
    """The wrapper never runs the plain version in place of the cluster
    kernel: a band on the cluster route (raised to CLUSTER_MAX_W, as
    chip_smoke.py raises it: the module routes it no band) with CPU
    tensors raises before anything of the card."""
    monkeypatch.setattr(tsw, "CLUSTER_BAND_W", tsw.CLUSTER_MAX_W)
    m, go, ge = scoring
    q, s, sl = _windows(3, 4, 256, 320, 16, 200)
    args = [torch.from_numpy(x) for x in (q, s, sl)]
    W = tsw.TILED_BAND_W + 128
    assert tsw.sw_band_instance(256, 320, W, tsw.device_matrix(m, "cpu"),
                                True) == "sw_band_track_cluster"
    before = dict(tsw.launches)
    with pytest.raises(ValueError, match="cuda"):
        tsw.sw_band_cuda(*args, tsw.device_matrix(m, "cpu"), go, ge, 16, W,
                         track=True)
    assert tsw.launches == before
