"""sw_band.cu's strip kernel (csrc/sw_band_strips.cuh, bands past
ops/sw.py CLUSTER_BAND_W) on the CPU: a numpy rendering of its order of
work, lane for lane and step for step, held exactly equal to the port's
sw_band_score_ref (and, at a small shape, to smalt_tpu's Pallas kernel
in interpret mode), tracked and score-only, int8 and a matrix outside
int8; three mutations of it that must fail; and the host-side choices
that send a band to it (sw_band_instance, BAND_STRIP_WARPS, the scratch's
words and bytes).  The kernel itself runs only on a card
(chip_smoke.py phase 3b holds it against the plain version there)."""
import numpy as np
import pytest
import torch

from smalt_tpu.align import core as ali
from smalt_tpu.ops import sw as jsw
from smalt_tpu_torch.ops import bounds
from smalt_tpu_torch.ops import sw as tsw

NEG = -(1 << 28)
LOW = -(1 << 31)                   # a masked cell's T in the record


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


def band_strips_render(q, s, slens, matrix, go: int, ge: int, pad: int,
                       W: int, C: int = 4, L: int = 8, NW: int = 2,
                       slots: int = 3, mutate: str = ""):
    """What sw_band_strips_kernel computes, in numpy, lane for lane: the
    band in query coordinates (row i, column j = i - prepad + t) as
    strips of SW = L * C columns from column 0, L lanes of C columns a
    warp, chunks of L subject rows.  Strip k (j0 = k * SW) runs rows
    [a_k, b_k), a_k = max(0, j0 + prepad - W + 1), b_k = min(rows, j0 +
    SW + prepad); a window runs the strips below ceil(qend / SW) whose
    rows are not empty (none with slen 0).  Chunks start at rows = prepad
    - W mod L, so that a strip's first chunk opens with row a_k - 1, whose
    carry it needs.  The chunks in which the band's edge crosses the
    strip mask: H0 = NEG left of the band (it feeds F), Eh = NEG right of
    it (its E feeds lane W - 1), T out of the record on both sides; every
    other chunk is checked to lie inside the band.

    A group of NW consecutive strips runs on one CTA as sw_full's
    wavefront runs a window (strip g * NW + w on warp w, chunk c at step
    c - c0 + w, the carry through a ring of 2 x L slots a warp).  Group g
    + 1's first strip reads group g's last strip's carry in place, from a
    column [rows] a window, after waiting for the chunk's flag to reach g
    + 1 (set by the writer after the chunk's carry).  `slots` CTAs are
    resident; each takes the next ticket n when it starts (group n // B of
    window n % B) and keeps its slot until its group is done, and the
    resident CTAs advance one step at a time in a rotating order, a CTA
    whose warp 0 waits on a flag not moving: a pass in which none moves
    is a deadlock (asserted never to happen).  Each carry read is checked
    to come from the strip before, and no slot to be written again before
    it was read.  Records: per lane and strip (highest T strictly, its
    lowest column), reduced over the CTA's lanes (highest T, lowest row,
    lowest column), then chained: group g waits for the record flag to
    reach g, merges group g - 1's record and hands on; the last group of
    the window writes (best, ti, tj), a window without strips (0, 0,
    -prepad).  `mutate`: "ein" keeps E right of the band, "fleft" lets
    cells left of the band feed F, "merge" orders a tie by column before
    row.  Returns ((best, ti, tj), score-only best) as int64 arrays."""
    q, s = np.asarray(q, np.int64), np.asarray(s, np.int64)
    m = np.asarray(matrix, np.int64)
    B, Q = q.shape
    S = s.shape[1]
    prepad = pad + W // 2
    SW, R = L * C, L
    sh = (W - prepad) % R              # chunk c: rows [c*R - sh, +R)
    rows = np.minimum(np.asarray(slens, np.int64), S).clip(min=0)
    qend = bounds.query_ends(q)
    nrow_k = np.where(rows > 0, -(-(rows + W - 1 - prepad) // SW), 0)
    nstrip = np.minimum(-(-qend // SW), nrow_k.clip(min=0))
    kmax = min(-(-Q // SW), max(0, -(-(S + W - 1 - prepad) // SW)))
    G = max(1, -(-kmax // NW))         # groups a window (the grid's)
    assert (nstrip <= G * NW).all()
    cc = np.arange(C)
    lanes = np.arange(L)

    def a_(k):
        return max(0, k * SW + prepad - W + 1)

    def b_(k, b):
        return min(int(rows[b]), k * SW + SW + prepad)

    def chunk(r):
        return (r + sh) // R

    # device memory: the carry column (x, y) with its tag (group that
    # wrote it, read yet, must be read), the chunk flags, the record chain
    carry = np.zeros((B, S + 1, 2), np.int64)
    ctag = np.full((B, S + 1, 3), -1, np.int64)
    flags = np.zeros((B, S // R + 3), np.int64)
    recflag = np.zeros(B, np.int64)
    rec = np.zeros((B, 4), np.int64)   # (bt, bi, bj, acc)
    out = np.full((4, B), -999, np.int64)

    def better(a, b):                  # record a beats record b
        if mutate == "merge":
            return a[0] > b[0] or (a[0] == b[0] and (
                a[2] < b[2] or (a[2] == b[2] and a[1] < b[1])))
        return a[0] > b[0] or (a[0] == b[0] and (
            a[1] < b[1] or (a[1] == b[1] and a[2] < b[2])))

    class Cta:
        def __init__(self, n):
            self.g, self.b = n // B, n % B
            g, b = self.g, self.b
            self.ks = [g * NW + w for w in range(NW)]
            self.live = [k < nstrip[b] for k in self.ks]
            self.done = not any(self.live)
            self.t = 0
            self.nsteps = 0
            if self.done:
                return
            self.c0 = chunk(a_(g * NW))
            for w, k in enumerate(self.ks):
                if self.live[w] and b_(k, b) > a_(k):
                    self.nsteps = max(self.nsteps,
                                      chunk(b_(k, b) - 1) - self.c0 + w + 1)
            self.ring = np.zeros((NW, 2, R, 2), np.int64)
            self.rtag = np.full((NW, 2, R, 2), -1, np.int64)  # (chunk, read)
            self.rmust = np.zeros((NW, 2, R), bool)   # a later strip reads it
            z = (NW, L, C)
            self.H, self.Eh = np.zeros(z, np.int64), np.zeros(z, np.int64)
            self.hprev = np.zeros(NW, np.int64)
            self.lval, self.lcol, self.li, self.acc = (
                np.zeros((NW, L), np.int64) for _ in range(4))

        def step(self):
            """One step of every warp; False where warp 0 waits."""
            g, b, t = self.g, self.b, self.t
            w0 = self.plan(0)
            if w0 is not None and g > 0 and w0["need_lo"] < w0["need_hi"] \
                    and flags[b, w0["c"]] < g:
                return False           # spins on the flag
            for w in range(NW):
                p = self.plan(w)
                if p is not None:
                    self.chunk_rows(w, p)
            self.t += 1
            return True

        def plan(self, w):
            b, k = self.b, self.ks[w]
            if not self.live[w]:
                return None
            c = self.c0 + self.t - w
            ak, bk = a_(k), b_(k, b)
            if bk <= ak or not chunk(ak) <= c <= chunk(bk - 1):
                return None
            rb = c * R - sh
            first = c == chunk(ak)
            i_lo, i_hi = max(rb, ak), min(rb + R, bk)
            # the carry rows this chunk takes from strip k - 1 (x of row
            # a_k - 1 in the first chunk), and which of them it ran
            need_lo = ak - 1 if first and ak > 0 else i_lo
            if first and ak > 0:
                assert need_lo == rb   # the chunk opens with row a_k - 1
            bprev = b_(k - 1, b) if k > 0 else 0
            return dict(c=c, rb=rb, first=first, i_lo=i_lo, i_hi=i_hi,
                        need_lo=need_lo, need_hi=min(i_hi, bprev), k=k,
                        ak=ak, bk=bk)

        def chunk_rows(self, w, p):
            b, g, t, k = self.b, self.g, self.t, p["k"]
            j0 = k * SW
            jl = j0 + lanes * C                       # lanes' first columns
            cols = jl[:, None] + cc
            qc = np.where(cols < Q, q[b, np.minimum(cols, Q - 1)], 7) & 7
            if p["first"]:
                self.H[w] = 0
                self.Eh[w] = NEG                      # E = NEG above a_k
                self.lval[w] = self.lcol[w] = self.li[w] = 0
                self.hprev[w] = 0
            rb = p["rb"]
            cv = np.zeros((R, 2), np.int64)
            cv[:, 1] = NEG
            for r in range(p["need_lo"], p["need_hi"]):
                ii = r - rb
                if w > 0:              # the ring: warp w - 1, one step ago
                    slot = (w - 1, (t - 1) & 1, ii)
                    assert self.rtag[slot][0] == p["c"], (b, k, r)
                    cv[ii] = self.ring[slot]
                    self.rtag[slot + (1,)] = 1
                else:                  # device memory: group g - 1's strip
                    assert ctag[b, r, 0] == g - 1 and flags[b, p["c"]] == g, \
                        (b, k, r, ctag[b, r], flags[b, p["c"]])
                    cv[ii] = carry[b, r]
                    ctag[b, r, 1] = 1
            if p["first"] and p["ak"] > 0:
                self.hprev[w] = cv[0, 0]              # x of row a_k - 1
            out_ = k + 1 < nstrip[b]
            nxt_a = a_(k + 1)
            nxt_b = b_(k + 1, b)
            # edge chunks: the band's edge crosses the strip in some row
            edge = not (p["i_lo"] >= j0 + SW + prepad - W and
                        p["i_hi"] - 1 <= j0 + prepad)
            for i in range(p["i_lo"], p["i_hi"]):
                ii = i - rb
                sc = s[b, i] & 7
                Hw, Ew = self.H[w], self.Eh[w]
                hleft = np.concatenate([[self.hprev[w]], Hw[:-1, C - 1]])
                self.hprev[w] = cv[ii, 0]
                pmc = cv[ii, 1]
                T = np.concatenate([hleft[:, None], Hw[:, :C - 1]], 1) + \
                    m[sc, qc]
                H0 = np.maximum(np.maximum(Ew - i * ge, T), 0)
                left = cols < i - prepad
                right = cols >= i - prepad + W
                if edge:
                    if mutate != "fleft":
                        H0 = np.where(left, NEG, H0)
                else:
                    assert not (left | right).any(), (b, k, i)
                run = np.maximum.accumulate(H0 + cc * ge, axis=1)
                incl = run[:, -1] + jl * ge
                incl[0] = max(incl[0], pmc)
                incl = np.maximum.accumulate(incl)
                excl = np.concatenate([[pmc], incl[:-1]]) - jl * ge
                cm = np.concatenate([excl[:, None], np.maximum(
                    excl[:, None], run[:, :-1])], 1)
                hn = np.maximum(cm - (go + (cc - 1) * ge), H0)
                Ehn = np.maximum(hn + ((i + 1) * ge - go), Ew)
                if edge and mutate != "ein":
                    Ehn = np.where(right, NEG, Ehn)
                self.H[w], self.Eh[w] = hn, Ehn
                for x in (hn, Ehn, incl, T):
                    assert np.abs(x).max() < 1 << 31
                if out_:               # the carry to strip k + 1
                    v = (hn[L - 1, C - 1], incl[L - 1])
                    must = (i >= nxt_a - 1) and i < nxt_b
                    if w + 1 < NW:
                        slot = (w, t & 1, ii)
                        old = self.rtag[slot]
                        assert old[0] < 0 or old[1] == 1 or \
                            not self.rmust[slot], (b, k, i, old)
                        self.ring[slot] = v
                        self.rtag[slot] = (p["c"], 0)
                        self.rmust[slot] = must
                    else:
                        old = ctag[b, i]
                        assert old[0] < 0 or old[1] == 1 or old[2] == 0, \
                            (b, k, i, old)
                        carry[b, i] = v
                        ctag[b, i] = (g, 0, int(must))
                Tm = np.where(left | right, LOW, T) if edge else T
                mx = Tm.max(axis=1)
                up = mx > self.lval[w]
                first_c = np.argmax(Tm == mx[:, None], axis=1)
                self.lcol[w] = np.where(up, jl + first_c, self.lcol[w])
                self.li[w] = np.where(up, i, self.li[w])
                self.lval[w] = np.where(up, mx, self.lval[w])
                self.acc[w] = np.maximum(self.acc[w], mx)
            if out_ and w == NW - 1:   # the chunk's carry is out: its flag
                assert flags[b, p["c"]] <= g
                flags[b, p["c"]] = g + 1

        def finish(self):
            """The CTA's record into the chain; False while group g - 1's
            record is not there."""
            g, b = self.g, self.b
            if self.done:              # no strip: group 0 writes the default
                if g == 0:
                    out[:, b] = 0, 0, -prepad, 0
                return True
            if g > 0 and recflag[b] < g:
                return False
            best = (0, 0, 0)           # over the CTA's lanes
            for w in range(NW):
                for ln in range(L):
                    r_ = (int(self.lval[w, ln]), int(self.li[w, ln]),
                          int(self.lcol[w, ln]))
                    if better(r_, best):
                        best = r_
            acc = int(self.acc.max(initial=0))
            if g > 0:
                prev = tuple(int(x) for x in rec[b, :3])
                if not better(best, prev):
                    best = prev
                acc = max(acc, int(rec[b, 3]))
            last = g == (nstrip[b] - 1) // NW
            if last:
                hit = best[0] > 0
                assert (out[:, b] == -999).all()
                out[:, b] = (best[0] if hit else 0, best[1] if hit else 0,
                             best[2] if hit else -prepad, acc)
            else:
                rec[b] = best + (acc,)
                recflag[b] = g + 1
            return True

    pending = list(range(B * G))[::-1]
    resident = []
    turn = 0
    while pending or resident:
        while pending and len(resident) < slots:
            resident.append(Cta(pending.pop()))
        moved = False
        order = resident[turn % len(resident):] + \
            resident[:turn % len(resident)]
        turn += 1
        for cta in order:
            if cta.t < cta.nsteps:
                moved |= cta.step()
            elif cta.finish():
                resident.remove(cta)
                moved = True
        assert moved, "deadlock: every resident CTA waits"
    assert (out != -999).all()
    assert ((ctag[..., 2] < 1) | (ctag[..., 1] == 1)).all()   # all read
    return tuple(out[:3]), out[3]


def _plain(q, s, sl, m, go, ge, pad, W):
    return tsw.sw_band_score_ref(*(torch.from_numpy(np.ascontiguousarray(
        x, np.int32)) for x in (q, s, sl)),
        torch.from_numpy(np.asarray(m, np.int32)), go, ge, pad, W,
        track=True)


def _hold(q, s, sl, m, go, ge, pad, W, what="", **kw):
    """The rendering equals sw_band_score_ref exactly: (best, ti, tj) and
    the score-only best.  Returns the plain result."""
    want = _plain(q, s, sl, m, go, ge, pad, W)
    (best, ti, tj), best0 = band_strips_render(q, s, sl, m, go, ge, pad, W,
                                               **kw)
    for name, g, w in (("best", best, want[0]), ("ti", ti, want[1]),
                       ("tj", tj, want[2]), ("score-only", best0, want[0])):
        np.testing.assert_array_equal(g, w.numpy(), err_msg=(what, name))
    return want


def _windows(seed, B, Q, S, pad, W):
    """Band windows: each query follows its subject from column pad + a
    shift with an indel walk, substitutions and N codes; the shifts put
    the alignment inside the band, across its edges and wholly outside
    (W either way: a query that starts inside the band); shorter queries
    (pad code 7), one with slen 0 and one a pad read."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, 4, (B, S)).astype(np.int32)
    q = rng.integers(0, 4, (B, Q)).astype(np.int32)
    shifts = [0, W // 8, -(W // 6), W // 2 + 10, -(W // 2) - 20, W, -W]
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


# (seed, W, pad, C, L, NW, slots): strips of 8-32 columns and chunks of
# 4-8 rows, so that a band of 24-330 lanes crosses many strips and groups;
# a band narrower than a strip (W 24 < 32); a prepad wider than the band
# (pad 200: every strip starts below row 0, and no band cell at row 0
# lies right of column 0) and narrower ones (the first strips start at
# row 0); one CTA resident (groups strictly in turn), and as many as
# there are groups
@pytest.mark.parametrize("seed,W,pad,C,L,NW,slots", [
    (1, 200, 24, 4, 8, 2, 3), (2, 130, 24, 4, 8, 3, 1),
    (3, 96, 40, 2, 4, 2, 4), (4, 330, 24, 4, 8, 1, 2),
    (5, 24, 8, 4, 8, 2, 8), (6, 64, 200, 2, 8, 3, 64)])
def test_strips_order_matches_plain(scoring, seed, W, pad, C, L, NW, slots):
    """The strip kernel's order of work (band_strips_render) equals
    sw_band_score_ref exactly, tracked and score-only, on planted windows
    (queries inside, across and outside the band, one starting inside it;
    a slen-0 window, a pad read) and on tie-heavy ones."""
    m, go, ge = scoring
    Q, S = 224, 320
    q, s, sl = _windows(seed, 7, Q, S, pad, W)
    rng = np.random.default_rng(seed)
    tq, ts, tsl = tsw.tie_windows(rng, 6, Q, S)
    tsl[2] = 0
    kw = dict(C=C, L=L, NW=NW, slots=slots)
    prepad = pad + W // 2
    for kind, (q_, s_, sl_), z in (("planted", (q, s, sl), 1),
                                   ("ties", (tq, ts, tsl), 2)):
        want = _hold(q_, s_, sl_, m, go, ge, pad, W, kind, **kw)
        assert int(want[0].max()) > 0, kind
        assert tuple(int(x[z]) for x in want) == (0, 0, -prepad)  # slen 0


@pytest.mark.parametrize("pen", [(200, -200), (1, -2)], ids=["wide", "int8"])
def test_strips_order_wide_matrix_and_nothing_scores(pen):
    """A matrix outside int8 (match 200, mismatch -200, X -400) and
    windows in which nothing scores ((0, 0, -prepad), as a slen-0 window
    returns) or only cells left of column 0 could: the rendering equals
    sw_band_score_ref."""
    m, go, ge = ali.make_score_matrix(*pen)
    go, ge = -go, -ge
    Q, S, pad, W = 160, 256, 16, 120
    q, s, sl = _windows(9, 6, Q, S, pad, W)
    s[3] = (q[3, 0] + 1) % 4            # a subject of one base, the
    q[3] = q[3, 0]                      # query of another: no T > 0
    want = _hold(q, s, sl, m, go, ge, pad, W, str(pen), C=4, L=8, NW=2)
    prepad = pad + W // 2
    assert tuple(int(x[3]) for x in want) == (0, 0, -prepad)


def test_strips_order_gap_across_strip_and_group_edges():
    """tsw.eterm_windows (a vertical gap of k rows into band lane a - 1,
    then a horizontal gap of k columns right from it, k 13-30) planted so
    that the horizontal gap steps into query column 208 (a strip edge
    inside a group: strips of 16 columns, groups of 2) or 224 (a group
    edge), as chip_smoke.py plants them for the kernel: F continues from
    the carry y handed through the ring and through device memory; the
    rendering equals sw_band_score_ref and reaches the planted score."""
    m, go, ge = ali.make_score_matrix(1, -6, -8, -1)
    go, ge = -go, -ge
    Q, S, pad, W = 448, 512, 24, 200
    q, s, sl, planted = tsw.eterm_windows(np.random.default_rng(3), 6, Q, S,
                                          pad, W, (150, 170, 184), 1, go, ge,
                                          cross=(208, 224))
    want = _hold(q, s, sl, m, go, ge, pad, W, C=2, L=8, NW=2)
    assert (want[0].numpy() >= planted).all()


def test_strips_order_at_the_kernels_own_widths(scoring):
    """The kernel's own geometry, strips of BAND_STRIP_W = 256 columns on
    32 lanes of 8 and the routed warps a CTA (BAND_STRIP_WARPS), with one
    CTA resident and with many: the rendering equals sw_band_score_ref on
    planted windows of W 300 (the band crosses 3 strips in a row)."""
    m, go, ge = scoring
    assert tsw.BAND_STRIP_W == 256
    Q, S, pad, W = 700, 640, 40, 300
    q, s, sl = _windows(13, 4, Q, S, pad, W)
    nw = tsw.BAND_STRIP_WARPS
    for slots in (1, 16):
        _hold(q, s, sl, m, go, ge, pad, W, C=8, L=32, NW=nw, slots=slots)


@pytest.mark.parametrize("B", [1, 3, 6, 132, 12_288])
def test_band_strip_warps_and_scratch(B):
    """BAND_STRIP_WARPS is a count sw_band_strips_launch takes (1 to 4,
    sw_band_strips.cuh STRIPS_WARPS); the flag words and scratch bytes
    follow the kernel's layout: 8 words, then per window 8 and S // 32 +
    2."""
    assert 1 <= tsw.BAND_STRIP_WARPS <= 4
    for S in (0, 31, 32, 787_584):
        assert tsw.band_strip_flag_words(B, S) == 8 + B * (10 + S // 32)
        assert tsw.band_strip_bytes(S) * B + 32 == \
            8 * S * B + 4 * tsw.band_strip_flag_words(B, S)


def test_strips_wrapper_takes_cuda_tensors_only(scoring):
    """The wrapper never runs the plain version in place of the strip
    kernel: a band on its route with CPU tensors raises before anything
    of the card, and counts no launch."""
    m, go, ge = scoring
    q, s, sl = _windows(3, 4, 256, 320, 16, 200)
    args = [torch.from_numpy(x) for x in (q, s, sl)]
    W = tsw.CLUSTER_BAND_W + 128
    dm = tsw.device_matrix(m, "cpu")
    assert tsw.sw_band_instance(256, 320, W, dm, True) == \
        "sw_band_track_strips"
    before = dict(tsw.launches)
    for track in (True, False):
        with pytest.raises(ValueError, match="cuda"):
            tsw.sw_band_cuda(*args, dm, go, ge, 16, W, track=track)
    assert tsw.launches == before


def test_strips_order_at_the_main_geometry(scoring):
    """The long-read geometry (sw.band_windows at Q 640: W 256, a tenth
    of the queries shifted up to W either way, so that some start inside
    the band) with strips of 64 columns on 3 warps a group."""
    m, go, ge = scoring
    rng = np.random.default_rng(21)
    q, s, sl, pad, W, S = tsw.band_windows(rng, 6, 640)
    sl[4] = 0
    _hold(q, s, sl, m, go, ge, pad, W, C=8, L=8, NW=3, slots=5)


def test_strips_order_matches_pallas_interpret(scoring):
    """At a small shape the rendering equals smalt_tpu's Pallas kernel in
    interpret mode too (the TPU kernel this path replaces)."""
    m, go, ge = scoring
    Q, S, pad = 256, 384, 32
    W = jsw.band_width_for(Q, pad)
    q, s, sl = _windows(11, 4, Q, S, pad, W)
    (best, ti, tj), best0 = band_strips_render(q, s, sl, m, go, ge, pad, W,
                                               C=4, L=8, NW=2)
    want = jsw.sw_band_score_batch(q, s, sl, m, go, ge, pad, W,
                                   interpret=True, track=True)
    for g, w in zip((best, ti, tj), want):
        np.testing.assert_array_equal(g, np.asarray(w))
    np.testing.assert_array_equal(best0, np.asarray(want[0]))


def _edge_runs(rng, B, Q, S, pad, W, side):
    """Windows with a run of matches on the band diagonal just outside
    one edge (lane W on the right, lane -1 on the left), then a gap into
    the band (right: one row down, into lane W - 1; left: a few columns
    right, into lane 2) and a second run there.  Inside the band only the
    second run scores; a kernel that lets the outside run through (E right
    of the band, or F from left of it) scores more."""
    prepad = pad + W // 2
    q = rng.integers(0, 4, (B, Q)).astype(np.int32)
    s = rng.integers(0, 4, (B, S)).astype(np.int32)
    n = 24
    for b in range(B):
        r0 = prepad + 4 + 5 * b       # band columns >= 0 from here on
        lane = W if side == "right" else -1
        rows = np.arange(r0, r0 + n)
        s[b, rows] = q[b, rows - prepad + lane]
        if side == "right":           # down one row into lane W - 1
            rows2 = np.arange(r0 + n + 1, r0 + 2 * n + 1)
            s[b, rows2] = q[b, rows2 - prepad + W - 1]
        else:                         # right 3 columns: lane 2
            rows2 = np.arange(r0 + n, r0 + 2 * n)
            s[b, rows2] = q[b, rows2 - prepad + 2]
    return q, s, np.full(B, S, np.int32)


def _tied_runs(rng, B, Q, S, pad, W):
    """Windows whose best score is reached twice, at the ends of two
    equal runs of matches (mismatches on both sides): run A on band lane
    W - 8 ends at row i1, run B on lane 4 at row i2 = i1 + 22, so the
    first best cell, A's end, lies W - 34 columns right of B's."""
    prepad = pad + W // 2
    q = rng.integers(0, 4, (B, Q)).astype(np.int32)
    s = rng.integers(0, 4, (B, S)).astype(np.int32)
    n = 20
    for b in range(B):
        r0 = prepad + 10 + 7 * b
        for lane, ra in ((W - 8, r0), (4, r0 + 22)):
            rows = np.arange(ra - 1, ra + n + 1)
            cols = rows - prepad + lane
            run = (rows >= ra) & (rows < ra + n)
            s[b, rows] = np.where(run, q[b, cols], (q[b, cols] + 1) % 4)
    return q, s, np.full(B, S, np.int32)


@pytest.mark.parametrize("mutate", ["ein", "fleft", "merge"])
def test_strips_mutations_fail(mutate):
    """Each mutation of the rendering differs from sw_band_score_ref: E
    kept right of the band (lane W - 1 then takes a vertical gap from
    outside it), F fed by cells left of the band (a horizontal gap from
    outside), and a merge that takes the lowest column before the lowest
    row (tie-heavy windows, whose first best cell is not the leftmost).
    The unmutated rendering equals it on the same windows."""
    m, go, ge = ali.make_score_matrix(1, -6, -8, -1)
    go, ge = -go, -ge
    Q, S, pad, W = 256, 320, 16, 64
    kw = dict(C=4, L=8, NW=2, slots=3)
    if mutate == "merge":
        q, s, sl = _tied_runs(np.random.default_rng(8), 4, Q, S, pad, W)
    else:
        side = "right" if mutate == "ein" else "left"
        q, s, sl = _edge_runs(np.random.default_rng(5), 4, Q, S, pad, W,
                              side)
    want = _hold(q, s, sl, m, go, ge, pad, W, **kw)
    (best, ti, tj), best0 = band_strips_render(q, s, sl, m, go, ge, pad, W,
                                               mutate=mutate, **kw)
    same = all(np.array_equal(g, w.numpy()) for g, w in
               zip((best, ti, tj), want)) and \
        np.array_equal(best0, want[0].numpy())
    assert not same, mutate
