"""The band frame of csrc/swq.cu on the CPU: the facts its design rests
on, read off an instrumented copy of swq_fill_walk_ref's fill loop, and
a lane-for-lane numpy rendering of the kernel (tiles of 32 band columns,
the row above's values by shuffle, ballot words, the walk over them)
held exactly against swq_fill_walk_ref.  The windows: synth_windows at
the lane's shapes, gen_case windows (tests/test_device_pass2.py), and
the pass-2 windows the port's CPU exact lane makes on a test corpus."""
import numpy as np
import pytest
import torch

from smalt_tpu_torch.parallel import exact_pass2 as tp2
from test_device_pass2 import default_matrix
from test_torch_exact import GE, GI, _corpus, _port_engine, _windows

NEG = tp2.NEG


def _edges(par, i):
    """band_lo, band_hi (the reference's, uncapped) and in-band rows of
    row i, as swq_fill_walk_ref computes them."""
    le, re_, ql, qn, sn, vd, sl = (par[:, k].astype(np.int64)
                                   for k in range(7))
    t = i - sl
    lo = np.maximum(ql, le) + np.maximum(0, t - np.maximum(ql - le, 0))
    hi = np.minimum(qn, re_ + 1 + t)
    live = (i >= sl) & (i < sn) & (vd != 0)
    return lo, hi, live


def instrumented_fill(qa, sj, par, m, go, ge):
    """swq_fill_walk_ref's fill loop in numpy, keeping a written mask.
    For every in-band cell it checks where the values it reads come
    from, and returns a count of the cases it met."""
    W, Qp = qa.shape
    Sp = sj.shape[1]
    lane = np.arange(Qp)[None, :]
    H = np.zeros((W, Qp), np.int64)
    E = np.zeros((W, Qp), np.int64)
    written = np.zeros((W, Qp), bool)
    prev = None                          # (lo, hi, nonempty) of row i - 1
    seen = {"lead_zero": 0, "moved_in_band": 0, "entered": 0}
    for i in range(Sp):
        lo, hi, live = _edges(par, i)
        if prev is not None:
            # the edges never fall
            assert (lo >= prev[0]).all() and (hi >= prev[1]).all()
        inb = (lane >= lo[:, None]) & (lane < hi[:, None]) & live[:, None]
        rows = inb.any(axis=1)
        if prev is not None:
            pinb = prev[2]
            # E[i-1, j]: in row i-1's band, or never written (0)
            ok_e = pinb | (~written & (E == 0))
            assert (ok_e | ~inb).all()
            # H[i-1, j-1]: column -1, in row i-1's band, or never written
            hsrc = np.concatenate([np.ones((W, 1), bool), pinb[:, :-1]], 1)
            hnew = np.concatenate([np.ones((W, 1), bool),
                                   (~written & (H == 0))[:, :-1]], 1)
            assert (hsrc | hnew | ~inb).all()
            # the band's first column: H[i-1, band_lo - 1] is 0 while
            # band_lo stays (lead-pinned rows), else it is row i-1's H
            # at band_lo(i-1) = band_lo(i) - 1, inside row i-1's band
            w = np.flatnonzero(rows & prev[3])
            stay = lo[w] == prev[0][w]
            col = lo[w] - 1
            hval = np.where(col >= 0, H[w, np.maximum(col, 0)], 0)
            assert (hval[stay] == 0).all()
            assert pinb[w[~stay], col[~stay]].all()
            seen["lead_zero"] += int(stay.sum())
            seen["moved_in_band"] += int((~stay).sum())
            seen["entered"] += int((inb & ~pinb & ~written).sum())
        # one reference row (swq_fill_walk_ref, exact_pass2.py:68-96)
        diag = np.concatenate([np.zeros((W, 1), np.int64), H[:, :-1]], 1) + \
            m[sj[:, i][:, None] & 7, qa & 7]
        pre = inb & (diag > 0) & (diag > E)
        g = np.where(pre & (diag > go), diag - go, NEG)
        cm = np.maximum.accumulate(g + lane * ge, axis=1)
        F = np.concatenate([np.full((W, 1), NEG), cm[:, :-1]], 1) - \
            (lane - 1) * ge
        won = pre & (diag > F)
        cell = np.maximum(np.maximum(diag, E), np.maximum(F, 0))
        reseed = np.where(won & (diag > go), diag - go, NEG)
        E = np.where(inb, np.maximum(E - ge, reseed), E)
        H = np.where(inb, cell, H)
        written |= inb
        prev = (lo, hi, inb, rows)
    return seen


def emulate_swq_kernel(qa, sj, par, m, go, ge, tiles):
    """csrc/swq.cu, lane for lane, all windows in lockstep: lane k of
    tile u holds band position 32u + k.  Returns int32 best, mi, mj [W]
    and int32 rec [W, Sp], as swq_fill_walk_ref does."""
    W, Qp = qa.shape
    Sp = sj.shape[1]
    le, re_, ql, qn, sn, vd, sl = (par[:, k].astype(np.int64)
                                   for k in range(7))
    start_lo = np.maximum(ql, le)
    lead = np.maximum(0, ql - le)
    row_lo = np.maximum(sl, 0)
    row_hi = np.where(vd != 0, np.minimum(sn, Sp), 0)
    qhi = np.minimum(qn, Qp)
    i0 = np.where((re_ >= le) & (qhi > start_lo),
                  np.maximum(row_lo, sl + np.maximum(0, start_lo - re_)),
                  row_hi)
    lo_prev = start_lo + np.maximum(0, i0 - sl - lead)
    lane = np.arange(32)
    sq = np.concatenate([qa.astype(np.int64) & 7,
                         np.full((W, 32 * tiles), 7)], 1)
    H = np.zeros((W, tiles, 32), np.int64)
    E = np.zeros((W, tiles, 32), np.int64)
    b0s = np.zeros((W, Sp, tiles, 32), bool)     # the ballot words' bits
    b1s = np.zeros((W, Sp, tiles, 32), bool)
    lbest = np.zeros((W, 32), np.int64)
    li = np.zeros((W, 32), np.int64)
    lj = np.zeros((W, 32), np.int64)
    alive = np.ones(W, bool)
    for i in range(Sp):
        act = alive & (i >= i0) & (i < row_hi)
        t_rel = i - sl
        lo = start_lo + np.maximum(0, t_rel - lead)
        width = np.minimum(qhi, re_ + 1 + t_rel) - lo
        alive &= ~(act & (width <= 0))
        act &= width > 0
        if not act.any():
            continue
        moved = lo != lo_prev
        lo_prev = np.where(act, lo, lo_prev)
        mrow = m[sj[:, i] & 7]                           # [W, 8]
        carry = np.full(W, NEG, np.int64)
        hcar = np.zeros((W, 32), np.int64)
        for u in range(tiles):
            tact = act & (32 * u < width)
            if not tact.any():
                break
            pos = 32 * u + lane
            inn = pos[None, :] < width[:, None]
            hold, eold = H[:, u].copy(), E[:, u].copy()
            # unmoved: H from lane k - 1 (lane 0 from lane 31's last tile)
            hd0 = np.roll(np.where(lane == 31, hcar, hold), 1, axis=1)
            # moved: E from lane k + 1 (lane 31 from lane 0's next tile)
            enext = E[:, u + 1] if u + 1 < tiles else np.zeros_like(eold)
            ep1 = np.roll(np.where(lane == 0, enext, eold), -1, axis=1)
            hcar = hold
            hd = np.where(moved[:, None], hold, hd0)
            ep = np.where(moved[:, None], ep1, eold)
            # (an idle window's lo may lie anywhere: clipped, unused)
            q = np.take_along_axis(
                sq, np.clip(lo[:, None] + pos[None, :], 0, Qp + 32 * tiles
                            - 1), 1)
            dg = hd + np.take_along_axis(mrow, q, 1)
            pre = inn & (dg > 0) & (dg > ep)
            g = np.where(pre & (dg > go), dg - go, NEG)
            v = np.maximum(g + pos * ge, carry[:, None])
            for d in (1, 2, 4, 8, 16):
                v = np.maximum(v, np.concatenate([v[:, :d], v[:, :-d]], 1))
            excl = np.concatenate([carry[:, None], v[:, :-1]], 1)
            F = excl - (pos - 1) * ge
            won = pre & (dg > F)
            cell = np.maximum(np.maximum(dg, ep), np.maximum(F, 0))
            nz = inn & (cell > 0)
            b0s[tact, i, u] = (won | (nz & (ep >= F)))[tact]
            b1s[tact, i, u] = (won | (nz & (ep < F)))[tact]
            el = won & (dg > go)
            H[:, u] = np.where(tact[:, None], np.where(inn, cell, 0), hold)
            E[:, u] = np.where(tact[:, None], np.where(
                inn, np.maximum(ep - ge, np.where(el, dg - go, NEG)), 0),
                eold)
            upd = tact[:, None] & el & (dg > lbest)
            lbest = np.where(upd, dg, lbest)
            li = np.where(upd, i, li)
            lj = np.where(upd, lo[:, None] + pos[None, :], lj)
            carry = np.where(tact, v[:, 31], carry)
    best = lbest.max(axis=1)
    big = np.iinfo(np.int64).max
    bi = np.where(best > 0, np.where(lbest == best[:, None], li, big)
                  .min(axis=1), 0)
    bj = np.where(best > 0, np.where((lbest == best[:, None]) &
                                     (li == bi[:, None]), lj, big)
                  .min(axis=1), 0)

    rec = np.zeros((W, Sp), np.int64)
    for w in range(W):                   # the walk, one window at a time
        j = int(bj[w])
        for i in range(min(int(bi[w]), Sp - 1), int(row_lo[w]) - 1, -1):
            t_rel = i - int(sl[w])
            lo = int(start_lo[w]) + max(0, t_rel - int(lead[w]))
            hr = min(int(qn[w]), int(re_[w]) + 1 + t_rel)
            hc = min(hr, int(qhi[w]))
            filled = i < row_hi[w] and hc > lo
            # codes of this row, band position p: bit 0 | bit 1 << 1
            code = (b0s[w, i].reshape(-1).astype(np.int64) |
                    b1s[w, i].reshape(-1).astype(np.int64) << 1)
            h = j
            if filled and lo <= j < hc:
                not2 = np.flatnonzero(code[: j - lo + 1] != 2)
                h = lo + int(not2[-1]) if len(not2) else lo - 1
            h = max(h, int(ql[w]) - 1)
            nins = max(j - h, 0)
            j2 = j - nins
            code2 = int(code[j2 - lo]) if filled and lo <= j2 < hc else 0
            stop = j2 < ql[w] or code2 == 0
            suspect = stop and j2 >= ql[w] and (j2 >= hr or j2 < lo)
            typ = 0 if suspect else (2 if stop else code2)
            rec[w, i] = (nins << 2) | typ
            if stop:
                break
            j = j2 - 1 if code2 == 3 else j2
    return (best.astype(np.int32), bi.astype(np.int32),
            bj.astype(np.int32), rec.astype(np.int32))


@pytest.fixture(scope="module")
def lane_windows(tmp_path_factory):
    """The pass-2 windows of the port's CPU exact lane (SMALT_DX_P2=1) on
    the two-sequence corpus of test_torch_exact.py, as the plain version
    receives them, the lane's padding dummies cut to one in eight:
    (qalpha, subj, par) int32 numpy."""
    import io
    from smalt_tpu_torch import rand as trand
    from smalt_tpu_torch.map.pipeline import run_device_exact_fastq
    got = []
    plain = tp2.swq_fill_walk_ref

    def record(qa, sj, par, *rest):
        got.append([x.numpy().copy() for x in (qa, sj, par)])
        return plain(qa, sj, par, *rest)

    # one torch thread: the test workers run other CPU lanes beside it
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("SMALT_DX_P2", "1")
            mp.setattr(tp2, "swq_fill_walk_ref", record)
            refset, idx, fq = _corpus(tmp_path_factory.mktemp("lane"),
                                      "two_seq")
            peng, prs = _port_engine(refset, idx)
            trand.ranseed(1)
            run_device_exact_fastq(peng, fq, io.StringIO(), prs, batch=64,
                                   device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert got
    qa, sj, par = (np.concatenate(x) for x in zip(*got))
    keep = (par[:, 5] != 0) | (np.arange(len(par)) % 8 == 0)
    return qa[keep], sj[keep], par[keep]


def _cases(kind, lane_windows):
    rng = np.random.default_rng({"synth128": 6, "synth256": 7,
                                 "gen_case": 2, "wide": 9}.get(kind, 0))
    if kind == "synth128":
        return tp2.synth_windows(rng, 64, 128, 256)
    if kind == "synth256":
        return tp2.synth_windows(rng, 32, 256, 512)
    if kind == "wide":
        # bands of 70 to 250 columns: 3 to 8 tiles a row
        qa, sj, par = tp2.synth_windows(rng, 32, 256, 320)
        bw = rng.integers(70, 251, len(par))
        par[:, 1] = par[:, 0] + bw
        return qa, sj, par
    if kind == "gen_case":
        return _windows(rng, 64, 128, 192)
    return lane_windows


@pytest.mark.parametrize("kind", ["synth128", "synth256", "lane"])
def test_band_edges_rise_and_sources_are_in_band(kind, lane_windows):
    """What the band frame rests on: band_lo and band_hi never fall, and
    every in-band cell reads E and the diagonal H from row i-1's band or
    from a cell never written (0); in particular H at band_lo(i) - 1 is 0
    while band_lo stays (lead-pinned rows) and row i-1's H at
    band_lo(i-1) once it moves."""
    qa, sj, par = _cases(kind, lane_windows)
    seen = instrumented_fill(qa, sj, par, default_matrix().astype(np.int64),
                             GI, GE)
    assert min(seen.values()) > 0, seen


@pytest.mark.parametrize("kind", ["synth128", "synth256", "gen_case",
                                  "wide", "lane"])
def test_band_frame_kernel_equals_plain(kind, lane_windows):
    """The kernel's band-frame algorithm, rendered lane for lane in
    numpy, equals swq_fill_walk_ref exactly: best, mi, mj and every
    record, SUSPECT stops included; band_tiles bounds every band."""
    qa, sj, par = _cases(kind, lane_windows)
    Qp = qa.shape[1]
    m = default_matrix()
    tiles = tp2.band_tiles(*(par[:, k] for k in (0, 1, 2, 3, 5)), Qp)
    if kind == "wide":
        assert tiles >= 7
    want = tp2.swq_fill_walk_ref(*(torch.from_numpy(x) for x in
                                   (qa, sj, par, m)), GI, GE)
    got = emulate_swq_kernel(qa, sj, par, m.astype(np.int64), GI, GE, tiles)
    for g, w_, what in zip(got, want, ("best", "mi", "mj", "rec")):
        np.testing.assert_array_equal(g, w_.numpy(), err_msg=what)
    rec = want[3].numpy()
    assert (want[0].numpy() > 0).sum() >= (par[:, 5] != 0).sum() // 3
    assert ((rec & 3) == 3).any() and ((rec & 3) == 2).any()


def test_time_sw_swq_cases(monkeypatch):
    """ops/time_sw.py --kernel swq (it needs a card to run): the phase 3c
    windows and bands of 70-250 columns, all timed; each case
    carries its band tiles and a plain version over all its windows.
    Without a card the script exits 1."""
    from smalt_tpu_torch.ops import sw, time_sw
    monkeypatch.setattr(time_sw, "SWQ_SHAPES", [(64, 128, 24)])
    monkeypatch.setattr(time_sw, "SWQ_WIDE", (256, 160, 8))
    m = default_matrix()
    mat = sw.device_matrix(m, "cpu")
    got = list(time_sw.cases("swq", np.random.default_rng(3), "cpu", mat,
                             GI, GE))
    assert [(c.kind, c.timed) for c in got] == [("synth", True),
                                               ("wide", True)]
    for c in got:
        qa, sj, par = c.tensors
        tiles = tp2.band_tiles(*(par[:, k] for k in (0, 1, 2, 3, 5)),
                               qa.shape[1])
        assert c.band == (tiles,) and f"tiles={tiles}" in c.shape
        want = tp2.swq_fill_walk_ref(qa, sj, par, mat.t, GI, GE)
        assert all(torch.equal(a, b) for a, b in zip(c.plain(None), want))
        assert c.work(True)["bound_ms"] > 0
    assert got[1].band == (8,)
    if not torch.cuda.is_available():
        assert time_sw.main(["--kernel", "swq"]) == 1
