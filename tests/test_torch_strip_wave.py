"""sw_full.cu's strip path (queries past 512 columns) on the CPU: a numpy
rendering of its wavefront, lane for lane and step for step, held exactly
equal to the port's sw_score_ref (and, at a small shape, to smalt_tpu's
Pallas kernel in interpret mode), tracked and score-only, int8 and a
matrix outside int8; the route that picks the warps a window
(strip_warps); and the bound's cells inside the query.  The kernel itself
runs only on a card (chip_smoke.py phase 3 holds it against the plain
version there)."""
import numpy as np
import pytest
import torch

from smalt_tpu.ops import sw as jsw
from smalt_tpu_torch.align import core as tali
from smalt_tpu_torch.ops import bounds
from smalt_tpu_torch.ops import sw as tsw
from test_torch_pass1 import _planted, strip_render

NEG = -(1 << 28)
C, L = 16, 32                      # columns a lane, lanes a warp
SW_ = C * L                        # columns a strip


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def wave_render(q, s, slens, matrix, go: int, ge: int, NW: int,
                rec: bool = False):
    """What sw_full.cu's strip kernel computes on NW warps a window, in
    numpy, lane for lane.  A window runs nstrip = ceil(qend / 512) strips
    (qend: one past its last column not of code 7) of 32 lanes of 16
    columns; strip k on warp k % NW, its chunk c (subject rows [32c, 32c +
    32), the last one shorter) at step (k // NW) * M + k % NW + c, M =
    max(Cr, NW), Cr = ceil(rows / 32).  Across a strip boundary a row hands
    on {H of the last column, the running prefix max}: into the ring slot
    (warp, step parity) when the next strip is on the next warp, read one
    step later; into the device buffer when it wraps from warp NW - 1 to
    warp 0, read M - NW + 1 steps later.  Every carry is checked to come
    from strip k - 1 at an earlier step, and no slot is written again at
    the step that reads it or before it was read.  A lane keeps a record
    a strip (key T*256 + 255 - c strictly greater, or with `rec` the
    two-part record) and merges it into its running one (highest T,
    lowest row, lowest column); the warps' lanes, then the block's
    warps, reduce by the same rule.  Returns ((best, ti, tj), score-only
    best) as int64 arrays."""
    assert 2 <= NW <= tsw.STRIP_WARPS
    q, s = np.asarray(q, np.int64), np.asarray(s, np.int64)
    matrix = np.asarray(matrix, np.int64)
    B, Q = q.shape
    S = s.shape[1]
    qend = bounds.query_ends(q)
    nstrip = -(-qend // SW_)
    rows = np.minimum(np.asarray(slens, np.int64), S)
    Cr = np.where(rows > 0, -(-rows.clip(min=0) // 32), 0)
    M = np.maximum(Cr, NW)
    nsteps = np.where((nstrip == 0) | (Cr == 0), 0,
                      (nstrip - 1) // NW * M + (nstrip - 1) % NW + Cr)
    cc = np.arange(C)
    lanes = np.arange(L)
    H = np.zeros((B, NW, L, C), np.int64)
    Eh = np.zeros((B, NW, L, C), np.int64)
    qc = np.full((B, NW, L, C), 7, np.int64)
    lkey = np.full((B, NW, L), 255, np.int64)
    lthr = np.full((B, NW, L), 255, np.int64)
    lval = np.zeros((B, NW, L), np.int64)      # rec: T of the record
    lcol = np.zeros((B, NW, L), np.int64)
    li = np.zeros((B, NW, L), np.int64)
    hprev = np.zeros((B, NW), np.int64)
    bt, bi, bj, acc = (np.zeros((B, NW, L), np.int64) for _ in range(4))
    # the carry: ring [B, NW, parity, 32] and device buffer [B, S], each
    # slot with (x, y) and a tag: the strip and the step that wrote it, the
    # step that read it (-1 none yet), 1 where a later strip must read it
    ring = np.zeros((B, NW, 2, 32, 2), np.int64)
    rtag = np.full((B, NW, 2, 32, 4), -1, np.int64)
    dev = np.zeros((B, S, 2), np.int64)
    dtag = np.full((B, S, 4), -1, np.int64)
    for t in range(int(nsteps.max(initial=0))):
        for w in range(NW):
            u = t - w
            rnd = np.where(u >= 0, u // M, 0)
            c = u - rnd * M
            k = rnd * NW + w
            act = (u >= 0) & (c < Cr) & (k < nstrip) & (t < nsteps)
            if not act.any():
                continue
            A = np.nonzero(act)[0]
            kA, cA = k[A], c[A]
            j0 = kA[:, None] * SW_ + lanes * C                  # [A, L]
            new = A[cA == 0]
            if len(new):
                jj = (kA[cA == 0][:, None, None] * SW_ + lanes[:, None] * C +
                      cc)
                qc[new, w] = np.where(jj < Q, np.take_along_axis(
                    q[new], np.minimum(jj, Q - 1).reshape(len(new), -1),
                    1).reshape(jj.shape), 7) & 7
                H[new, w] = 0
                Eh[new, w] = 0
                lkey[new, w] = lthr[new, w] = 255
                lval[new, w] = lcol[new, w] = li[new, w] = 0
                hprev[new, w] = 0
            rb = cA * 32
            rr = rb[:, None] + lanes                            # [A, 32]
            inrow = rr < rows[A, None]
            cv = np.zeros((len(A), 32, 2), np.int64)
            cv[..., 1] = NEG
            take = (kA[:, None] > 0) & inrow
            for a, b in enumerate(A):
                for ln in np.nonzero(take[a])[0]:
                    if w > 0:
                        tag = rtag[b, w - 1, (t - 1) & 1, ln]
                        assert tag[0] == kA[a] - 1 and tag[1] == t - 1, \
                            (b, t, w, ln, tag)
                        cv[a, ln] = ring[b, w - 1, (t - 1) & 1, ln]
                        rtag[b, w - 1, (t - 1) & 1, ln, 2] = t
                    else:
                        tag = dtag[b, rr[a, ln]]
                        assert tag[0] == kA[a] - 1 and tag[1] < t, \
                            (b, t, ln, tag)
                        cv[a, ln] = dev[b, rr[a, ln]]
                        dtag[b, rr[a, ln], 2] = t
            scode = np.where(rr < S, np.take_along_axis(
                s[A], np.minimum(rr, S - 1), 1), 7) & 7
            nrow = np.minimum(32, rows[A] - rb)
            out = kA + 1 < nstrip[A]
            for ii in range(32):
                live = ii < nrow
                if not live.any():
                    break
                i = rb + ii                                     # [A]
                wt = matrix[scode[:, ii][:, None, None], qc[A, w]]
                Hw, Ew = H[A, w], Eh[A, w]
                hleft = np.concatenate([hprev[A, w][:, None],
                                        Hw[:, :-1, C - 1]], 1)
                hp_new = cv[:, ii, 0]
                pmc = cv[:, ii, 1]
                T = np.concatenate([hleft[..., None], Hw[..., :C - 1]], 2) + wt
                H0 = np.maximum(np.maximum(Ew - i[:, None, None] * ge, T), 0)
                run = np.maximum.accumulate(H0 + cc * ge, axis=2)
                incl = run[..., -1] + j0 * ge
                incl[:, 0] = np.maximum(incl[:, 0], pmc)
                incl = np.maximum.accumulate(incl, axis=1)
                excl = np.concatenate([pmc[:, None], incl[:, :-1]], 1) - \
                    j0 * ge
                cm = np.concatenate([excl[..., None], np.maximum(
                    excl[..., None], run[..., :-1])], 2)
                hn = np.maximum(cm - (go + (cc - 1) * ge), H0)
                Ehn = np.maximum(hn + ((i[:, None, None] + 1) * ge - go), Ew)
                lv = live[:, None, None]
                H[A, w] = np.where(lv, hn, Hw)
                Eh[A, w] = np.where(lv, Ehn, Ew)
                hprev[A, w] = np.where(live, hp_new, hprev[A, w])
                for a in np.nonzero(live & out)[0]:
                    b = A[a]
                    x = (hn[a, L - 1, C - 1], incl[a, L - 1])
                    if w + 1 < NW:
                        slot = (b, w, t & 1, ii)
                        old = rtag[slot]     # read before it is rewritten
                        assert old[3] < 0 or old[2] >= 0, (slot, old)
                        ring[slot] = x
                        rtag[slot] = (kA[a], t, -1, 1)
                    else:
                        old = dtag[b, i[a]]  # read at an earlier step
                        assert old[3] < 0 or 0 <= old[2] < t, (b, i[a], old)
                        dev[b, i[a]] = x
                        dtag[b, i[a]] = (kA[a], t, -1, 1)
                assert np.abs(hn).max(initial=0) < 1 << 31
                lw = live[:, None]
                if rec:
                    m = T.max(axis=2)
                    first = np.argmax(T == m[..., None], axis=2)
                    up = lw & (m > lval[A, w])
                    lcol[A, w] = np.where(up, first, lcol[A, w])
                    lval[A, w] = np.where(up, m, lval[A, w])
                    li[A, w] = np.where(up, i[:, None], li[A, w])
                else:
                    key = (T * 256 + 255 - cc).max(axis=2)
                    assert np.abs(key).max() < 1 << 31
                    up = lw & (key > lthr[A, w])
                    lkey[A, w] = np.where(up, key, lkey[A, w])
                    li[A, w] = np.where(up, i[:, None], li[A, w])
                    lthr[A, w] = np.where(up, key | 255, lthr[A, w])
                acc[A, w] = np.where(lw, np.maximum(acc[A, w], T.max(axis=2)),
                                     acc[A, w])
            done = cA + 1 == Cr[A]
            D = A[done]
            if len(D):
                if rec:
                    st = lval[D, w]
                    sj = j0[done] + lcol[D, w]
                else:
                    st = lkey[D, w] >> 8
                    sj = j0[done] + 255 - (lkey[D, w] & 255)
                sl_ = li[D, w]
                o = (bt[D, w], bi[D, w], bj[D, w])
                tk = (st > o[0]) | ((st == o[0]) & ((sl_ < o[1]) | (
                    (sl_ == o[1]) & (sj < o[2]))))
                bt[D, w] = np.where(tk, st, o[0])
                bi[D, w] = np.where(tk, sl_, o[1])
                bj[D, w] = np.where(tk, sj, o[2])
    # every carry written was read
    assert ((dtag[..., 3] < 0) | (dtag[..., 2] >= 0)).all()
    assert ((rtag[..., 3] < 0) | (rtag[..., 2] >= 0)).all()
    bt, bi, bj = (x.reshape(B, NW * L) for x in (bt, bi, bj))
    # highest T, then lowest row, then lowest column over the lanes of all
    # warps (the warp's shuffle tree, then warp 0 over the warps' records)
    pick = np.lexsort((bj, bi, -bt), axis=1)[:, 0]
    got = [x[np.arange(B), pick] for x in (bt, bi, bj)]
    hit = got[0] > 0
    return (tuple(np.where(hit, x, 0) for x in got),
            acc.reshape(B, -1).max(axis=1))


def _plain(q, s, sl, m, go, ge):
    return tsw.sw_score_ref(*(torch.from_numpy(np.ascontiguousarray(
        x, np.int32)) for x in (q, s, sl)),
        torch.from_numpy(np.asarray(m, np.int32)), go, ge, track=True)


def _hold(q, s, sl, m, go, ge, NW, rec=False, what=""):
    """The rendering on NW warps equals sw_score_ref exactly: (best, ti,
    tj) and the score-only best.  Returns the plain result."""
    want = _plain(q, s, sl, m, go, ge)
    (best, ti, tj), best0 = wave_render(q, s, sl, m, go, ge, NW, rec)
    for name, g, w in (("best", best, want[0]), ("ti", ti, want[1]),
                       ("tj", tj, want[2]), ("score-only", best0, want[0])):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=(what, name))
    return want


# (Q, S, NW): Cr < NW (S 96: 3 chunks on 4 warps), Cr == NW (S 128 on 4),
# Cr > NW (S 400: 13 chunks, the last of 16 rows, on 2 and 3 warps, so
# that strips wrap from the last warp to warp 0), one chunk on the route's
# 2 warps (S 30) and the route's own NW; rows no multiple of 32 throughout
# (subject lengths from S / 2)
@pytest.mark.parametrize("pen", [(1, -2), (200, -200)], ids=["int8", "wide"])
@pytest.mark.parametrize("Q,S,NW", [(1600, 96, 4), (1100, 128, 4),
                                    (1600, 400, 2), (1536, 400, 3),
                                    (1600, 30, None), (1600, 300, None)])
def test_wave_matches_plain(Q, S, NW, pen):
    """The wavefront's order of work equals sw_score_ref exactly on
    planted and tie-heavy windows (the maximum reached in many rows,
    lanes, strips and warps), tracked and score-only."""
    rng = np.random.default_rng(Q + S + (NW or 0))
    m, go, ge = tali.make_score_matrix(*pen)
    go, ge = -go, -ge
    nw = NW or tsw.strip_warps(16, Q, S)
    for kind, gen in (("planted", _planted), ("ties", tsw.tie_windows)):
        q, s, sl = gen(rng, 16, Q, S)
        want = _hold(q, s, sl, m, go, ge, nw, what=kind)
        assert int(want[0].max()) > 0, kind
        if kind == "planted":
            assert (want[2] >= SW_).any()


# (NW, the strip boundary the gap crosses): the wrap from the last warp to
# warp 0 (2 warps: column 1,024; 3 warps: 1,536) and the ring (4 warps)
@pytest.mark.parametrize("NW,edge", [(2, 1024), (3, 1536), (4, 1024)])
def test_wave_gap_across_a_strip_edge(NW, edge):
    """Windows whose best path takes a horizontal gap of 60-90 columns
    across a strip boundary (gap extension 1): the F of the columns past
    the boundary continues the prefix max y the left strip handed over,
    through the ring or, at the wrap, the device buffer; the rendering
    equals sw_score_ref and reaches the planted score."""
    rng = np.random.default_rng(NW * 10 + edge)
    m, go, ge = tali.make_score_matrix(1, -2, -4, -1)
    go, ge = -go, -ge
    B, S, run = 8, 400, 200
    Q = edge + run + 140
    q = rng.integers(0, 4, (B, Q)).astype(np.int32)
    s = rng.integers(0, 4, (B, S)).astype(np.int32)
    gaps = rng.integers(60, 91, B)
    for b, g in enumerate(gaps):
        a = edge - run + int(rng.integers(-g // 2 + 1, g // 2))
        s[b, :run] = q[b, a: a + run]
        s[b, run: 2 * run] = q[b, a + run + g: a + 2 * run + g]
    sl = np.full(B, S, np.int32)
    want = _hold(q, s, sl, m, go, ge, NW)
    assert (want[0].numpy() >= 2 * run - go - (gaps - 1) * ge).all()


def test_wave_two_part_record():
    """The _rec instance's record (value, then lowest column) on the
    wavefront equals sw_score_ref where the key could not hold the score
    (entries of +-40,000 at S 400: past 2^23)."""
    rng = np.random.default_rng(5)
    m, go, ge = tali.make_score_matrix(40000, -40000, -80000, -60000)
    Q, S = 1100, 400
    assert tsw.key_over(tsw.device_matrix(m, "cpu"), Q, S)
    q, s, sl = _planted(rng, 12, Q, S)
    want = _hold(q, s, sl, m, -go, -ge, 3, rec=True)
    assert int(want[0].max()) >= 1 << 23


def _mixed_qend(rng, Q: int, S: int):
    """Windows whose real columns end at 512 k and 512 k + 1 (k = 1, 2),
    at 511 and 513, inside strips, at Q; a window of code 7 only, one
    with slen 0 and one with its last real column a lone base past a
    run of 7s; planted so that the best cells sit near each end."""
    ends = [512, 513, 1024, 1025, 511, 700, 1400, Q, 0, 1300, 1536, 1537]
    B = len(ends)
    q = rng.integers(0, 4, (B, Q)).astype(np.int32)
    s = rng.integers(0, 4, (B, S)).astype(np.int32)
    for b, e in enumerate(ends):
        q[b, e:] = 7
        n = min(S, e) * 3 // 4
        if n:
            s[b, :n] = q[b, e - n: e]      # the query's last real columns
    q[9, 900:1299] = 7                     # a gap of pad code, then a base
    sl = np.full(B, S, np.int32)           # 200 rows: a last chunk of 8
    sl[4] = 150
    sl[10] = 0
    return q, s, sl, np.array(ends)


@pytest.mark.parametrize("NW", [2, 3])
def test_wave_mixed_query_ends(NW):
    """A batch of windows with mixed qend (512 k and 512 k + 1 among
    them, an all-pad window, a slen-0 one): each window runs only the
    strips its real columns reach (a window of pad code only none: (0, 0,
    0)), and equals sw_score_ref, int8 and wide; so does the one-warp
    kernel's rendering (test_torch_pass1.strip_render)."""
    rng = np.random.default_rng(7 + NW)
    Q, S = 1600, 200
    q, s, sl, ends = _mixed_qend(rng, Q, S)
    np.testing.assert_array_equal(bounds.query_ends(q), ends)
    np.testing.assert_array_equal(-(-bounds.query_ends(q) // SW_),
                                  [1, 2, 2, 3, 1, 2, 3, 4, 0, 3, 3, 4])
    for pen in ((1, -2), (200, -200)):
        m, go, ge = tali.make_score_matrix(*pen)
        want = _hold(q, s, sl, m, -go, -ge, NW, what=str(pen))
        (best, ti, tj), best0 = strip_render(q, s, sl, m, -go, -ge)
        for g, w in zip((best, ti, tj, best0), want + (want[0],)):
            np.testing.assert_array_equal(g, w.numpy())
        assert tuple(int(x[8]) for x in want) == (0, 0, 0)
        assert tuple(int(x[10]) for x in want) == (0, 0, 0)
        if pen == (1, -2):             # the best cell in the last strip
            assert (want[2][[1, 3, 11]].numpy() >= [512, 1024, 1536]).all()


def test_wave_matches_pallas_interpret():
    """At a small shape the rendering equals smalt_tpu's Pallas kernel in
    interpret mode too (the TPU kernel this path replaces)."""
    rng = np.random.default_rng(11)
    m, go, ge = tali.make_score_matrix()
    Q, S = 600, 64
    q, s, sl = _planted(rng, 4, Q, S)
    (best, ti, tj), best0 = wave_render(q, s, sl, m, -go, -ge, 2)
    want = jsw.sw_score_batch(q, s, sl, m, -go, -ge, interpret=True,
                              track=True)
    for g, w in zip((best, ti, tj), want):
        np.testing.assert_array_equal(g, np.asarray(w))
    np.testing.assert_array_equal(best0, np.asarray(want[0]))


@pytest.mark.parametrize("B,Q,S,want", [
    (64, 32768, 2048, 16),      # 20 kb reads in the pass-1 lane: 64 strips
    (1535, 2048, 2304, 4),      # 1,500 bp-2 kb reads: a warp a strip
    (1536, 2048, 2304, 1),      # a large batch: a warp a window
    (4096, 1024, 1152, 1),
    (1024, 4096, 4352, 8),
    (1024, 1504, 1792, 3),      # the mesh's 1,500 bp windows
    (4096, 1504, 1792, 1),
    (8, 600, 8, 2),             # a single chunk of rows: still two warps
    (8, 16384, 96, 3),          # three chunks: three warps
    (1, 513, 100_000, 2),
    (100_000, 32768, 2048, 1),
])
def test_strip_warps_route(B, Q, S, want):
    """strip_warps on an int8 matrix: a warp a window (the one-warp
    kernel, 1) from STRIP_ONE_WARP_B = 1,536 windows on, where it measured
    faster; below it the wavefront, a warp a strip up to STRIP_WARPS, never more warps
    than chunks of 32 subject rows but at least 2 (on one warp the
    wavefront would run the one-warp kernel's schedule with barriers);
    every value one sw_full_strip_launch takes (1..STRIP_WARPS)."""
    nw = tsw.strip_warps(B, Q, S)
    assert nw == want and 1 <= nw <= tsw.STRIP_WARPS == 16
    assert tsw.STRIP_ONE_WARP_B == 1536
    # the one-warp kernel has no WIDE instance: the wavefront at any batch
    assert tsw.strip_warps(B, Q, S, wide=True) == \
        (want if want > 1 else tsw.strip_warps(1, Q, S))


def test_full_work_counts_cells_inside_the_query():
    """sw_full_work with the query codes counts each window's rows times
    its qend (the columns the strip path runs); without them every
    query column, as before."""
    q = np.full((3, 1024), 7, np.int32)
    q[0, :1000] = 1
    q[1, :513] = 2
    sl = np.array([100, 50, 80])
    full = bounds.sw_full_work(1024, 128, sl, True)
    inq = bounds.sw_full_work(1024, 128, sl, True, q)
    assert full["cells"] == 230 * 1024
    assert inq["cells"] == 100 * 1000 + 50 * 513
    assert inq["cells_all"] == full["cells"]
    assert inq["bytes"] == full["bytes"]
    assert inq["bound_ms"] <= full["bound_ms"]
    np.testing.assert_array_equal(bounds.query_ends(q), [1000, 513, 0])
