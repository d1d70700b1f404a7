// The several-warps kernel of sw_band.cu, included there once: bands of
// 513 to MANY_W = 12,800 lanes (reads of ~2.8 kb to ~68 kb), and the
// windows the one-warp kernel does not take (a score matrix outside int8,
// a tracked window that could score 2^23, a profile too large for shared
// memory, (S + 1) * ge >= 2^28).  It computes _make_swb_kernel's function
// (smalt_tpu/ops/sw.py:269), the recurrence at the top of sw_band.cu, with
// sw_band_warp_kernel's cell and tracking rule.
//
// One window a block of NW warps, thread k of the window holding the C
// consecutive band lanes [k * C, (k + 1) * C) of H and E in registers;
// lanes at or past W are padding.  Two instances, sw_band_multi_kernel<12>
// on up to MULTI_NW = 8 warps (W <= 3,072) and <20> on up to MANY_NW = 20
// (W <= 12,800); sw_band.cu's launch_multi_pt takes the one that pads the
// band less.  C = 12 and 20 make a warp's threads read profile bytes 3
// and 5 words apart: 32 different banks.
//
// The cell is sw_band_warp_kernel's: Eh = E + (i + 1) * ge, H0 one
// __viaddmax_s32_relu, E and the prefix max one __viaddmax_s32 each, the
// lane constants (LaneK) read from the constant bank, the score a
// sign-extending shared-memory load.  Eh's stand-in for NEG (lane W - 1's
// Ein, and the padding lanes' E) is NEG - i * ge, which the int32 DP's
// bound (ops/sw.py check_score_cap: ge * (Q + S + W) < 2^30) keeps above
// INT_MIN with room, and which loses every max a true NEG loses (H >= 0,
// go < 2^28): so this kernel has no (S + 1) * ge limit.
//
// A row:
//   - Phase A, in each warp: T, H0 (the warp's last lane takes Ein = NEG
//     for now), the thread's total max(H0 + c * ge) and the warp's 5-step
//     shuffle scan.  Lane 31 posts the warp's total (band coordinates) in
//     slot w and lane 0 the Eh of the warp's first lane, from the row
//     before, in slot w - 1: warp w - 1's last lane takes it as Ein now.
//     The slots alternate with the row's parity.  Then the thread's row
//     max of T (tracking, below) and one __syncthreads.
//   - Phase B: lane v < w reads slot v, the total of warp v corrected by
//     the Ein its last lane takes (max(total, Ein + tlast * ge)), and
//     __reduce_max_sync gives the prefix from the warps to the left; the
//     warp's last lane takes its Ein from slot w; then, per lane, F from
//     the running prefix (started at the left's value: no per-lane array
//     survives the barrier but H0 and Eh), H and Eh.
// One barrier a row orders every post before its reads and, with the
// parity, every read before the next post to the same slot.
//
// The score lookup: a rolling query profile in shared memory, 8 rows
// (one a subject code) of R = 32 * C * NW + 32 columns, entry (s, x) =
// matrix[s][q[x - prepad]] (code 7 outside the query) at position x mod
// R; band lane t of row i is column x = i + t, so a thread reads C
// consecutive entries from position (i + t0) mod R, one further each row.
// The first RP - R >= C - 1 positions are mirrored past R, so that those
// C entries never wrap.  At rows i = 31 mod 32, after the barrier, warp 0
// writes the 32 columns that row i + 2 first needs (x = i + 32 * C * NW +
// 1 + lane), over columns no row after i reads, and the subject rows
// i + 33 .. i + 64 into a ring of 64 offsets of profile rows; its lanes
// fetch both from global memory one refill ahead.  Row i + 1's phase A,
// which may overlap these writes, reads neither.  No other global memory
// is touched inside the loop.  The profile holds int8 entries (PT 0),
// int16 (PT 1: a matrix outside int8, ops/sw.py decides it on the host),
// or query codes whose scores are looked up in the int32 matrix (PT 2:
// entries outside int16).  8 * RP * sizeof(entry) bytes of dynamic shared
// memory: ~31 KB at W = 3,840, ~100 KB at 12,288 in int8.
//
// Tracking without anything in the row loop but the thread's own record:
// each thread keeps (value, row, lane) of its first best cell, replaced
// only by a row whose max of T over the thread's real lanes is strictly
// greater (then naming that row's lowest such lane), and after the loop
// one reduction picks the highest value, then the lowest row, then the
// lowest lane: the reference's rule, by the proof at sw_band_warp_kernel,
// without the packed key, so any int32 score.  Score-only: the thread's
// max of T, reduced after the loop.  A window with slen 0 writes (0, 0,
// -prepad) and returns before any barrier.
//
// What bounds it: the integer instruction rate, as sw_band_warp_kernel:
// 6 instructions a cell (the add of T and the five max operations: H0,
// the thread's total, F's running prefix, H, E) and half a 3-input max
// for the row max, plus ~35 a thread and row (scan, exchange, barrier,
// row bookkeeping) that C spreads.

constexpr int MULTI_C = 12;            // lanes a thread, W <= MULTI_W
constexpr int MULTI_NW = 8;
constexpr int MULTI_W = 32 * MULTI_C * MULTI_NW;      // 3,072
constexpr int MANY_C = 20;             // lanes a thread, W <= MANY_W
constexpr int MANY_NW = 20;
constexpr int MANY_W = 32 * MANY_C * MANY_NW;         // 12,800

// The gap constants of sw_band_warp_kernel's LaneConsts for C lanes.
template <int N>
struct LaneK {
  int cge[N], fk[N];
};

// A profile entry: int8, int16, or a query code (PT 2).
template <int PT> struct ProfEntry { using T = unsigned char; };
template <> struct ProfEntry<0> { using T = signed char; };
template <> struct ProfEntry<1> { using T = short; };

// The most warps a window of each instance.
template <int C>
struct MultiNW {
  static constexpr int value = C == MULTI_C ? MULTI_NW : MANY_NW;
};

// One window a block on NW = blockDim.x / 32 warps of C lanes a thread,
// 32 * C * (NW - 1) < W <= 32 * C * NW (or NW = 1); RP the profile's
// pitch, dynamic shared memory (PT 2 ? 1 : 8) * RP entries.
template <int C, int PT, bool TRACK>
__global__ void __launch_bounds__(32 * MultiNW<C>::value, 1)
sw_band_multi_kernel(const int* __restrict__ q, const int* __restrict__ subj,
                     const int* __restrict__ slens,
                     const int* __restrict__ matrix, int Q, int S, int W,
                     int prepad, int go, int ge, int RP, const LaneK<C> lc,
                     int* __restrict__ best_out, int* __restrict__ ti_out,
                     int* __restrict__ tj_out) {
  using P = typename ProfEntry<PT>::T;
  constexpr int NWMAX = MultiNW<C>::value;
  __shared__ int smat[64];
  // by row parity, slot v: .x warp v's scan total, .y the Eh of warp
  // v + 1's first lane (the row before; NEG past the last warp)
  __shared__ int2 xs[2][NWMAX];
  __shared__ int sbuf[64];             // row r's profile row, at r & 63
  __shared__ int fin[TRACK ? 3 : 1][NWMAX];   // each warp's record
  extern __shared__ __align__(16) unsigned char ring_bytes[];
  P* ring = reinterpret_cast<P*>(ring_bytes);

  const int b = blockIdx.x;
  const int slen = min(slens[b], S);
  if (slen <= 0) {                     // block-uniform: nothing scores
    if (threadIdx.x == 0) {
      best_out[b] = 0;
      if (TRACK) {
        ti_out[b] = 0;
        tj_out[b] = -prepad;
      }
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;      // this warp's place in its window
  const int NW = blockDim.x >> 5;
  const int WP = NW * 32 * C;          // band lanes with the padding
  const int R = WP + 32;               // profile columns in the ring
  const int* qrow = q + (size_t)b * Q;
  const int* srow = subj + (size_t)b * S;
  // the query code of profile column x, and the offset of subject row r's
  // profile row (PT 2: its row of the matrix)
  auto qcode = [&](int x) {
    const int j = x - prepad;
    return (j >= 0 && j < Q) ? qrow[j] & 7 : 7;
  };
  auto srow_off = [&](int r) {
    const int sc = r < S ? srow[r] & 7 : 7;
    return PT == 2 ? 8 * sc : sc * RP;
  };
  // profile column x (query code qc) at ring position pos
  auto put = [&](int pos, int qc) {
    if (PT == 2) {
      ring[pos] = static_cast<P>(qc);
    } else {
#pragma unroll
      for (int s = 0; s < 8; ++s)
        ring[s * RP + pos] = static_cast<P>(smat[8 * s + qc]);
    }
  };

  for (int v = threadIdx.x; v < 64; v += blockDim.x) smat[v] = matrix[v];
  for (int v = threadIdx.x; v < 2 * NWMAX; v += blockDim.x)
    xs[v / NWMAX][v % NWMAX] = make_int2(NEG, NEG);
  __syncthreads();
  for (int r = threadIdx.x; r < 64; r += blockDim.x) sbuf[r] = srow_off(r);
  for (int x = threadIdx.x; x < RP; x += blockDim.x)   // columns 0 .. R - 1
    put(x, qcode(x < R ? x : x - R));                  // and the mirror
  __syncthreads();

  const int t0 = (w * 32 + lane) * C;  // first band lane of this thread
  const int t0ge = t0 * ge;
  const int nreal = min(max(W - t0, 0), C);       // lanes below W
  const bool partial = nreal < C;
  // NEG where this lane takes no value from its neighbour, else no bound
  const int last_neg = lane == 31 ? NEG : INT_MAX;
  const int first_neg = lane == 0 ? NEG : INT_MAX;
  // read by lane v: warp v's last band lane times ge
  const int lcorr = ((lane + 1) * 32 * C - 1) * ge;

  int H[C], Eh[C];                     // Eh = E + (row + 1) * ge
#pragma unroll
  for (int c = 0; c < C; ++c) {
    H[c] = 0;
    Eh[c] = NEG;
  }
  // this thread's best T (which starts at 0) and, TRACK, its first cell
  int tbest = 0, trow = 0, tlane = 0;
  int nige = 0;                        // -i * ge:        Ein = Ehin + nige
  int ci = ge - go;                    // (i+1)*ge - go:  Eh' = max(Ehin, H + ci)
  // ring position of this thread's first lane in row i; opaque to the
  // compiler, which otherwise recomputes it every row
  int pos = t0;
  asm volatile("" : "+r"(pos));
  // warp 0: the column and subject row this lane writes at the next
  // refill, fetched one refill ahead, and that column's ring position
  int rcol = WP + 32 + lane, rpos = lane;
  int qpre = 7, spre = 0;
  if (w == 0) {
    qpre = qcode(rcol);
    spre = srow_off(64 + lane);
  }
  for (int i = 0; i < slen; ++i) {
    const int p = i & 1;
    const int so = sbuf[i & 63];       // this row's profile (matrix) row

    // phase A
    const int enext = min(__shfl_down_sync(FULL, Eh[0], 1), last_neg);
    int T[C], H0[C];
    int r = NEG;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int sc = PT == 2 ? smat[so + ring[pos + c]]
                             : static_cast<int>(ring[so + pos + c]);
      T[c] = H[c] + sc;
      H0[c] = addmax_relu(c < C - 1 ? Eh[c + 1] : enext, nige, T[c]);
      r = addmax(H0[c], lc.cge[c], r); // the thread's total, its coordinates
    }
    // inclusive prefix max of the thread totals over the warp, in band
    // coordinates; a lane below the shift gets its own value back
    int incl = r + t0ge;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1)
      incl = max(incl, __shfl_up_sync(FULL, incl, d));
    const int X = min(__shfl_up_sync(FULL, incl, 1) - t0ge, first_neg);
    if (lane == 31) xs[p][w].x = incl;
    if (lane == 0 && w > 0) xs[p][w - 1].y = Eh[0];

    if (partial) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (c >= nreal) T[c] = NEG;    // padding lanes: out of the max
    }
    const int m = row_max<C>(T);
    if (TRACK && m > tbest) {          // strictly above this thread's best
      int first = 0;
#pragma unroll
      for (int c = C - 1; c >= 0; --c)
        if (T[c] == m) first = c;
      tlane = t0 + first;
      trow = i;
    }
    tbest = max(tbest, m);
    __syncthreads();

    // phase B: the warps to the left, their totals corrected by the Ein
    // their last lanes take from the warp after them
    int pre = NEG;
    if (lane < w) {
      const int2 x = xs[p][lane];
      pre = addmax(x.y, nige + lcorr, x.x);
    }
    pre = __reduce_max_sync(FULL, pre);
    int G = max(X, pre - t0ge);        // the prefix entering lane t0
    // the warp's last lane: Ein from the next warp's first lane; no lane
    // of this warp reads its H0 through F
    const int el = lane == 31 ? xs[p][w].y : enext;
    H0[C - 1] = addmax(el, nige, H0[C - 1]);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int hn = addmax(G, lc.fk[c], H0[c]);       // max(F, H0)
      G = addmax(H0[c], lc.cge[c], G);
      // Eh[c + 1] still holds the row above
      Eh[c] = addmax(hn, ci, c < C - 1 ? Eh[c + 1] : el);
      H[c] = hn;
    }
    if (partial) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (c >= nreal) Eh[c] = NEG;
    }
    nige -= ge;
    ci += ge;
    if (++pos == R) pos = 0;

    if ((i & 31) == 31 && w == 0) {    // warp-uniform: the refill
      put(rpos, qpre);
      if (rpos < RP - R) put(R + rpos, qpre);
      sbuf[(i + 33 + lane) & 63] = spre;
      rcol += 32;
      rpos += 32;
      if (rpos >= R) rpos -= R;
      qpre = qcode(rcol);
      spre = srow_off(i + 65 + lane);
    }
  }

  // the records of this warp, then of the window's warps: highest T, then
  // lowest row, then lowest lane (a record of T = 0 is (0, 0, 0))
  auto reduce = [&](int& bt, int& bi, int& bl) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const int ot = __shfl_xor_sync(FULL, bt, d);
      const int oi = __shfl_xor_sync(FULL, bi, d);
      const int ol = __shfl_xor_sync(FULL, bl, d);
      if (ot > bt || (ot == bt && (oi < bi || (oi == bi && ol < bl)))) {
        bt = ot;
        bi = oi;
        bl = ol;
      }
    }
  };
  if (TRACK) {
    reduce(tbest, trow, tlane);
  } else {
    tbest = __reduce_max_sync(FULL, tbest);
  }
  if (lane == 0) {
    fin[0][w] = tbest;
    if (TRACK) {
      fin[1][w] = trow;
      fin[2][w] = tlane;
    }
  }
  __syncthreads();
  if (w != 0) return;
  int bt = 0, bi = 0, bl = 0;          // >= 0: every best starts at 0
  if (lane < NW) {
    bt = fin[0][lane];
    if (TRACK) {
      bi = fin[1][lane];
      bl = fin[2][lane];
    }
  }
  if (TRACK) {
    reduce(bt, bi, bl);
  } else {
    bt = __reduce_max_sync(FULL, bt);
  }
  if (lane == 0) {
    best_out[b] = bt;
    if (TRACK) {
      ti_out[b] = bi;
      tj_out[b] = bi + bl - prepad;    // (0, 0, -prepad) when nothing scored
    }
  }
}
