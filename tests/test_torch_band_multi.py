"""sw_band.cu's several-warps kernel (csrc/sw_band_multi.cuh) on the CPU: a
numpy rendering of its order of work held exactly equal to the port's and
smalt_tpu's sw_band_score_ref, tracked and score-only, and the host-side
choices that send a band to it (sw_band_instance, band_wide_code).  The
kernel itself runs only on a card (chip_smoke.py phase 3b holds it
against the plain version there)."""
import numpy as np
import pytest
import torch

from smalt_tpu.align import core as ali
from smalt_tpu.ops import sw as jsw
from smalt_tpu_torch.ops import sw as tsw

NEG = -(1 << 28)
I32 = (-(1 << 31), (1 << 31) - 1)


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


def _in_i32(*xs):
    for x in xs:
        assert I32[0] <= int(np.min(x)) and int(np.max(x)) <= I32[1]


def _multi_model(q, s, slens, m, go, ge, pad, W, C, entry=np.int8):
    """A numpy rendering of sw_band_multi_kernel's order of work on
    NW = ceil(W / 32C) warps of 32 threads of C lanes, in int64 with every
    value the kernel holds checked to lie in int32.  The rolling profile:
    a ring of R = 32 * C * NW + 32 columns (8 rows, entries of type
    `entry`; the column each position holds is kept beside it and checked
    on every read), its first RP - R positions mirrored past R, refilled
    at rows 31 mod 32 after the row with the 32 columns from i + 32 * C *
    NW + 1 on and the subject rows i + 33 .. i + 64.  A row: T, H0 with
    Eh = E + (i + 1) * ge (a warp's last lane without Ein), the thread
    totals and each warp's scan; each warp posts its total and its first
    lane's Eh from the row before; then the totals of the warps to the
    left, each corrected by the Ein its last lane takes, the last lane's
    own Ein, F from the running prefix, H and Eh; padding lanes' Eh NEG.
    Tracking: each thread's record, replaced only by a row whose max of T
    over its real lanes is strictly greater (naming that row's lowest
    such lane); after the last row the highest T, then the lowest row,
    then the lowest lane.  Returns (best, ti, tj) and the score-only
    best, int64 [4, B]."""
    B, Q = q.shape
    S = s.shape[1]
    prepad = pad + W // 2
    NW = -(-W // (32 * C))
    NT = 32 * NW
    WP, R = NT * C, NT * C + 32
    RP = -(-(R + C - 1) // 16) * 16
    t0 = np.arange(NT, dtype=np.int64) * C
    t0ge = t0 * ge
    cidx = np.arange(C, dtype=np.int64)
    real = (t0[:, None] + cidx) < W
    partial = ~real.all(axis=1)
    cge, fk = cidx * ge, -(go + (cidx - 1) * ge)
    lcorr = ((np.arange(NW) + 1) * 32 * C - 1) * ge   # warp v's last lane
    lane = np.arange(NT) % 32
    warp = np.arange(NT) // 32
    out = np.zeros((4, B), np.int64)
    assert np.array_equal(m.astype(entry).astype(np.int64), m)
    for b in range(B):
        slen = min(int(slens[b]), S)
        if slen <= 0:
            out[:, b] = 0, 0, -prepad, 0
            continue

        def qcode(x):
            j = x - prepad
            ok = (j >= 0) & (j < Q)
            return np.where(ok, q[b, np.clip(j, 0, Q - 1)] & 7, 7)

        def scode(r):
            return np.where(r < S, s[b, np.clip(r, 0, S - 1)] & 7, 7)

        x = np.arange(RP)
        col = np.where(x < R, x, x - R)
        ring = m[:, qcode(col)].astype(entry).astype(np.int64)   # [8, RP]
        ringcol = col.copy()
        sbuf = scode(np.arange(64))
        H = np.zeros((NT, C), np.int64)
        Eh = np.full((NT, C), NEG, np.int64)
        rec = np.zeros((3, NT), np.int64)    # each thread's (T, row, lane)
        nige, ci = 0, ge - go
        pos = t0.copy()
        rcol = WP + 32 + np.arange(32)
        rpos = np.arange(32)
        qpre, spre = qcode(rcol), scode(64 + np.arange(32))
        for i in range(slen):
            p = pos[:, None] + cidx
            assert p.max() < RP
            assert np.array_equal(ringcol[p], i + t0[:, None] + cidx)
            T = H + ring[sbuf[i & 63]][p]
            # phase A
            nxt = np.append(Eh[1:, 0], NEG)
            enext = np.where(lane == 31, NEG, nxt)
            ein = np.concatenate([Eh[:, 1:], enext[:, None]], axis=1) + nige
            H0 = np.maximum(np.maximum(ein, T), 0)
            tot = (H0 + cge).max(axis=1)
            incl = np.maximum.accumulate((tot + t0ge).reshape(NW, 32), axis=1)
            X = np.concatenate([np.full((NW, 1), NEG), incl[:, :-1]],
                               axis=1).reshape(NT) - np.where(lane == 0, 0,
                                                              t0ge)
            X = np.where(lane == 0, NEG, X)
            xtot = incl[:, -1]
            xe = np.append(Eh[32 * np.arange(1, NW), 0], NEG)
            Tm = np.where(real, T, NEG)
            mt = Tm.max(axis=1)
            up = mt > rec[0]
            rec[1, up] = i
            rec[2, up] = (t0 + np.argmax(Tm == mt[:, None], axis=1))[up]
            rec[0] = np.maximum(rec[0], mt)
            # phase B
            corr = np.maximum(xtot, xe + nige + lcorr)
            pre = np.concatenate([[NEG], np.maximum.accumulate(corr)[:-1]])
            G = np.maximum(X, pre[warp] - t0ge)
            el = np.where(lane == 31, xe[warp] + nige, enext + nige)
            H0[:, -1] = np.maximum(H0[:, -1], el)
            run = np.maximum.accumulate(
                np.concatenate([G[:, None], H0[:, :-1] + cge[:-1]], axis=1),
                axis=1)
            Hn = np.maximum(run + fk, H0)
            ehin = np.concatenate([Eh[:, 1:], (el - nige)[:, None]], axis=1)
            Eh = np.maximum(Hn + ci, ehin)
            Eh[partial] = np.where(real[partial], Eh[partial], NEG)
            _in_i32(T, ein, H0, G, run + fk, Hn, Eh, corr, pre[warp] - t0ge)
            H = Hn
            nige -= ge
            ci += ge
            pos = np.where(pos + 1 == R, 0, pos + 1)
            if i % 32 == 31:               # warp 0's refill
                ring[:, rpos] = m[:, qpre]
                ringcol[rpos] = rcol
                mir = rpos < RP - R
                ring[:, R + rpos[mir]] = m[:, qpre[mir]]
                ringcol[R + rpos[mir]] = rcol[mir]
                sbuf[(i + 33 + np.arange(32)) & 63] = spre
                rcol = rcol + 32
                rpos = np.where(rpos + 32 >= R, rpos + 32 - R, rpos + 32)
                qpre, spre = qcode(rcol), scode(i + 65 + np.arange(32))
        k = np.lexsort((rec[2], rec[1], -rec[0]))[0]
        best, bi, blane = (int(v) for v in rec[:, k])
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


def _check(m, go, ge, pad, W, C, windows, entry=np.int8):
    """The model on the windows (q, s, slens), one batch, equals the
    port's and smalt_tpu's sw_band_score_ref: (best, ti, tj) and the
    score-only best.  Returns the model's result."""
    q, s, sl = windows
    got = _multi_model(q, s, sl, m.astype(np.int64), go, ge, pad, W, C,
                       entry)
    args = [torch.from_numpy(np.ascontiguousarray(x, np.int32))
            for x in (q, s, sl)]
    want = tsw.sw_band_score_ref(*args, torch.from_numpy(m), go, ge, pad, W,
                                 track=True)
    jwant = jsw.sw_band_score_ref(q, s, sl, m, go, ge, pad, W, track=True)
    for k in range(3):
        np.testing.assert_array_equal(got[k], want[k].numpy())
        np.testing.assert_array_equal(got[k], np.asarray(jwant[k]))
    np.testing.assert_array_equal(got[3], want[0].numpy())
    return got


# (seed, W, C): several warps of C lanes a thread, the ring of R = 32 * C *
# NW + 32 columns wrapped once or more over S = 480 rows where W <= 300
# (bands wider than the query beside); widths that end at a warp's end
# (96), inside a thread (130, 1000 at C 12), and inside the last warp with
# whole threads of padding (200, 700 at C 20); one warp (300 at C 12)
@pytest.mark.parametrize("seed,W,C", [(1, 96, 1), (2, 130, 4), (3, 200, 2),
                                      (6, 300, 12), (8, 1000, 12),
                                      (9, 700, 20)])
def test_multi_order_matches_plain(scoring, seed, W, C):
    """The several-warps kernel's order of work (_multi_model) equals the
    port's sw_band_score_ref and smalt_tpu's exactly, tracked and
    score-only, on planted windows (a slen-0 window and a pad read among
    them) and on tie-heavy ones (a short unit repeated: the maximum in
    many lanes, threads and rows; one with slen 0 too)."""
    m, go, ge = scoring
    Q, S, pad = 320, 480, 24
    planted = _windows(seed, 5, Q, S, pad, W)
    ties = tsw.tie_windows(np.random.default_rng(seed), 6, Q, S)
    ties[2][3] = 0
    got = _check(m, go, ge, pad, W, C, tuple(
        np.concatenate([a, b]) for a, b in zip(planted, ties)))
    assert got[0, :5].max() > Q // 4 and got[0, 5:].max() > 0


# the one-row-old E term: (W, C, first lanes of warps to plant at); W 96 on
# three warps of 32 lanes, W 200 on four warps of 64 (the last one partial)
@pytest.mark.parametrize("W,C,edges", [(96, 1, (32, 64)),
                                       (200, 2, (128, 192))])
def test_multi_order_eterm_binds(W, C, edges):
    """Windows whose best path takes a vertical gap into a warp's last
    lane and a horizontal gap from there into the next warp
    (tsw.eterm_windows, gaps of 8 + 1 a base): the warp's posted total
    lacks that lane's Ein, so only the correction by the next warp's
    first Eh of the row before (`xe` in the model) carries the path; the
    model equals the port's and smalt_tpu's sw_band_score_ref, which
    reach at least the planted score.  (Without the term the model
    scores 3 less on 4 of the 6 windows at W 96 and on all 6 at W 200.)"""
    m, go, ge = ali.make_score_matrix(1, -6, -8, -1)
    go, ge = -go, -ge
    Q, S, pad = 448, 512, 24
    q, s, sl, planted = tsw.eterm_windows(np.random.default_rng(W), 6, Q, S,
                                          pad, W, edges, 1, go, ge)
    got = _check(m, go, ge, pad, W, C, (q, s, sl))
    assert (got[0] >= planted).all()


@pytest.mark.parametrize("pen,entry", [((200, -200), np.int16),
                                       ((40000, -80000), np.int32)])
def test_multi_order_wide_matrix_and_nothing_scores(pen, entry):
    """A matrix outside int8 (int16 entries: match 200, mismatch -200, X
    -400; and past int16, the int32 lookups), and windows in which
    nothing scores ((0, 0, -prepad), as a slen-0 window returns): the
    model equals sw_band_score_ref; band_wide_code names that profile."""
    m, go, ge = ali.make_score_matrix(*pen)
    go, ge = -go, -ge
    dm = tsw.device_matrix(m, "cpu")
    assert tsw.band_wide_code(dm) == (2 if entry == np.int16 else 3)
    Q, S, pad, W = 256, 352, 16, 200
    q, s, sl = _windows(9, 5, Q, S, pad, W)
    s[3] = (q[3, 0] + 1) % 4            # a subject of one base, the
    q[3] = q[3, 0]                      # query of another: no T > 0
    got = _check(m, go, ge, pad, W, 2, (q, s, sl), entry)
    prepad = pad + W // 2
    for b in (1, 2, 3):                 # slen 0, a pad read, no match
        assert tuple(got[:, b]) == (0, 0, -prepad, 0)


def test_multi_order_gap_extension_past_2_28(scoring):
    """(S + 1) * ge >= 2^28, which the one-warp kernel refuses: the
    several-warps kernel's Eh = E + (i + 1) * ge and its NEG stand-ins
    stay in int32 (the model checks every value) and the result equals
    sw_band_score_ref, within the int32 DP's bound (check_score_cap)."""
    m, _, _ = scoring
    go, ge = 400_000, 300_000
    Q, S, pad, W = 300, 900, 16, 200
    assert (S + 1) * ge >= 1 << 28
    tsw.check_score_cap("sw_band", tsw.device_matrix(m, "cpu"), Q, S, go,
                        ge, W)
    q, s, sl = _windows(11, 4, Q, S, pad, W)
    _check(m, go, ge, pad, W, 2, (q, s, sl))


@pytest.mark.parametrize("entries,several,code", [
    ((-4, 3), False, 0), ((-4, 3), True, 1), ((-128, 127), True, 1),
    ((-400, 200), False, 2), ((-32768, 32767), True, 2),
    ((-32769, 5), False, 3), ((-2, 1 << 15), True, 3)])
def test_band_wide_code(entries, several, code):
    """sw_band_launch's `wide`: the several-warps kernel's int16 profile
    for a matrix outside int8 within int16, int32 lookups past it, else
    1 only where the one-warp kernel's key does not hold the window."""
    m = np.zeros((8, 8), np.int32)
    m[0, 0], m[1, 1] = entries
    assert tsw.band_wide_code(tsw.device_matrix(m, "cpu"), several) == code


def test_key_over_names_the_several_warps_kernel_only_to_512():
    """A tracked window that could score 2^23 (KEY_CAP) on int8 entries
    is "_wide" only where the one-warp kernel would take it (W <= 512):
    no several-warps instance keeps a key."""
    m = np.zeros((8, 8), np.int32)
    m[0, 0] = 127
    dm = tsw.device_matrix(m, "cpu")
    S = 70_000
    assert tsw.key_over(dm, S, S)
    for W, want in ((512, "sw_band_track_wide"), (640, "sw_band_track"),
                    (3072, "sw_band_track"), (3200, "sw_band_track_many")):
        assert tsw.sw_band_instance(S, S, W, dm, True) == want
        assert tsw.sw_band_instance(S, S, W, dm, False) == \
            want.replace("_track", "").replace("_wide", "")
