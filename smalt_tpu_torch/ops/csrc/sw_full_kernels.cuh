// The kernels of sw_full.cu, included there once for each way of
// tracking: SWF_KERNEL names the in-register kernel (Q <= 512) and
// SWF_WAVE_KERNEL the strip wavefront (Q > 512), and SWF_REC (a literal)
// says whether their tracked WIDE instances keep the two-part record
// (value, then column) in place of the packed key T * 256 + 255 - c.
// SWF_STRIP_KERNEL, defined for the key's include alone, names the
// one-warp strip kernel (int8 only).  sw_full.cu's header describes the
// kernels and both records.  (One text for all, so that the instances
// that keep the key compile to the code they had before the record was
// added.)

// The second launch bound (one block a SM at least) lets ptxas take the
// registers it asks for: without it the build spilled 8 bytes.  WIDE:
// scores from smat (int32) a cell, no int8 profile.
template <int C, int L, bool TRACK, bool WIDE>
__global__ void __launch_bounds__(WARPS * 32, 1)
SWF_KERNEL(const int* __restrict__ q, const int* __restrict__ subj,
               const int* __restrict__ slens,
               const int* __restrict__ matrix, int B, int Q, int S,
               int go, int ge, int kmul, int* __restrict__ best_out,
               int* __restrict__ ti_out, int* __restrict__ tj_out) {
  static_assert(L == 8 || L == 16 || L == 32, "lanes a window");
  static_assert(C >= 1 && C < 256, "the key keeps the column in a byte");
  constexpr bool REC = TRACK && WIDE && SWF_REC;   // the two-part record
  constexpr int G = 32 / L;            // windows a warp
  __shared__ int smat[64];
  if (threadIdx.x < 64) smat[threadIdx.x] = matrix[threadIdx.x];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int sub = lane & (L - 1);      // lane within the window's group
  const int wib = (threadIdx.x >> 5) * G + lane / L;   // window in block
  const int bw = blockIdx.x * (WARPS * G) + wib;
  if (bw - lane / L >= B) return;      // no window in this warp
  // a group past the last window repeats it: it runs the warp's rows with
  // the others (every shuffle below names the full warp) and stores nothing
  const bool live = bw < B;
  const int b = live ? bw : B - 1;

  const int j0 = sub * C;
  const int j0ge = j0 * ge;
  int H[C], Eh[C];                     // Eh = E + i*ge
  // The window's query profile, int8: entry (s, j) = matrix[s][q[j]].
  // Column c of lane l lies at byte ((c/4)*L + l)*4 + c%4 of row s, so
  // for one c the lanes of a group read consecutive 32-bit words; rows
  // and windows are a multiple of all 32 banks apart, and the g-th group
  // of a warp starts g*L words further on: no bank is hit twice.
  constexpr int CP = (C + 3) / 4 * 4;
  constexpr int PITCH = (L * CP + 127) / 128 * 128;
  constexpr int WSTRIDE = 8 * PITCH + 128;         // room for the shift
  __shared__ __align__(16) signed char prof[WIDE ? 16 : WARPS * G * WSTRIDE];
  signed char* pbase = prof + (WIDE ? 0 : wib * WSTRIDE + (lane / L) * (L * 4)
                                          + sub * 4);
  int qc[CP];
#pragma unroll
  for (int c = 0; c < CP; ++c) {
    const int j = j0 + c;
    qc[c] = c < C && j < Q ? q[(size_t)b * Q + j] & 7 : 7;
  }
  if (!WIDE) {
#pragma unroll
    for (int s = 0; s < 8; ++s)
#pragma unroll
      for (int k = 0; k < CP / 4; ++k) {
        const unsigned w = (smat[8 * s + qc[4 * k]] & 0xff) |
                           (smat[8 * s + qc[4 * k + 1]] & 0xff) << 8 |
                           (smat[8 * s + qc[4 * k + 2]] & 0xff) << 16 |
                           (unsigned)smat[8 * s + qc[4 * k + 3]] << 24;
        *reinterpret_cast<unsigned*>(pbase + s * PITCH + k * (L * 4)) = w;
      }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    H[c] = 0;
    Eh[c] = 0;
  }
  __syncwarp();                        // a group reads its own lanes' words
  const int* srow = subj + (size_t)b * S;
  const int slen = live ? min(slens[b], S) : 0;
  int rows = slen;                     // the warp's windows run together
#pragma unroll
  for (int d = L; d < 32; d <<= 1)
    rows = max(rows, __shfl_xor_sync(FULL, rows, d));

  int lthr = 255, lkey = 255, li = 0;  // TRACK: this lane's best, T = 0
  int lbest = 0, lcol = 0;             // REC: (T, column) of it
  int acc = 0;                         // !TRACK: this lane's max of T
  int scode = 7;
  for (int i = 0; i < rows; ++i) {
    if ((i & (L - 1)) == 0) {
      const int r = i + sub;
      scode = r < S ? srow[r] & 7 : 7;
    }
    const int sc = __shfl_sync(FULL, scode, i & (L - 1), L);
    const signed char* prow = pbase + sc * PITCH;
    const int* mrow = smat + 8 * sc;   // WIDE
    const int nige = -i * ge;          // E = Eh + nige
    const int ci = (i + 1) * ge - go;  // Eh' = max(Eh, H + ci)

    int hleft = __shfl_up_sync(FULL, H[C - 1], 1, L);
    if (sub == 0) hleft = 0;
    int T[C], H0[C], run[C];
    int r = NEG;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int w = WIDE ? mrow[qc[c]] : prow[(c / 4) * (L * 4) + c % 4];
      T[c] = (c == 0 ? hleft : H[c - 1]) + w;
      H0[c] = addmax_relu(Eh[c], nige, T[c]);
      r = addmax(H0[c], c * ge, r);    // prefix max within the lane
      run[c] = r;
    }
    // inclusive prefix max of the lane totals over the group, in window
    // coordinates; a lane below the shift gets its own value back
    int incl = r + j0ge;
#pragma unroll
    for (int d = 1; d < L; d <<= 1)
      incl = max(incl, __shfl_up_sync(FULL, incl, d, L));
    int excl = __shfl_up_sync(FULL, incl, 1, L);
    excl = sub == 0 ? NEG : excl - j0ge;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int cm = c == 0 ? excl : max(excl, run[c - 1]);
      const int hn = addmax(cm, -(go + (c - 1) * ge), H0[c]);  // max(F, H0)
      Eh[c] = addmax(hn, ci, Eh[c]);
      H[c] = hn;
    }

    // rows at or past the window's own slen (another window of the warp
    // is still running) compute on, but count for nothing
    if (TRACK && !REC) {
      const int m = row_key<C>(T, kmul);
      if (m > lthr && i < slen) {      // T strictly above the lane's best
        lkey = m;
        li = i;
        lthr = m | 255;
      }
    } else if (TRACK) {                // the two-part record
      const int m = row_max<C>(T);
      if (m > lbest && i < slen) {
        lcol = first_col<C>(T, m);
        lbest = m;
        li = i;
      }
    } else {
      const int m = row_max<C>(T);
      if (i < slen) acc = max(acc, m);
    }
  }
  if (TRACK) {
    // highest T, then lowest row, then lowest column, over the group
    int bt = REC ? lbest : lkey >> 8, bi = li;
    int bj = REC ? j0 + lcol : j0 + 255 - (lkey & 255);
#pragma unroll
    for (int d = L / 2; d > 0; d >>= 1) {
      const int ot = __shfl_xor_sync(FULL, bt, d, L);
      const int oi = __shfl_xor_sync(FULL, bi, d, L);
      const int oj = __shfl_xor_sync(FULL, bj, d, L);
      if (ot > bt || (ot == bt && (oi < bi || (oi == bi && oj < bj)))) {
        bt = ot;
        bi = oi;
        bj = oj;
      }
    }
    if (sub == 0 && live) {
      const bool hit = bt > 0;         // else no row beat the initial 0
      best_out[b] = hit ? bt : 0;
      ti_out[b] = hit ? bi : 0;
      tj_out[b] = hit ? bj : 0;
    }
  } else {
#pragma unroll
    for (int d = L / 2; d > 0; d >>= 1)
      acc = max(acc, __shfl_xor_sync(FULL, acc, d, L));
    if (sub == 0 && live) best_out[b] = acc;
  }
}

#ifdef SWF_STRIP_KERNEL
// One warp a window, four windows a block, the query in strips of STRIP_W
// columns one after another (header: the one-warp path), strips of pad
// code alone skipped.  int8 scores from a profile a warp, the key's record.
template <bool TRACK>
__global__ void __launch_bounds__(WARPS * 32, 1)
SWF_STRIP_KERNEL(const int* __restrict__ q, const int* __restrict__ subj,
                const int* __restrict__ slens,
                const int* __restrict__ matrix, int B, int Q, int S,
                int go, int ge, int kmul, int2* __restrict__ carry,
                int* __restrict__ best_out, int* __restrict__ ti_out,
                int* __restrict__ tj_out) {
  constexpr int C = STRIP_C, L = 32;
  __shared__ int smat[64];
  if (threadIdx.x < 64) smat[threadIdx.x] = matrix[threadIdx.x];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;    // window in block
  const int b = blockIdx.x * WARPS + wib;
  if (b >= B) return;
  // the 32-lane instance's profile layout: lane l's word k of row s at
  // byte s * PITCH + k * 128 + l * 4, read back by lane l alone
  constexpr int PITCH = L * C;
  constexpr int WSTRIDE = 8 * PITCH + 128;
  __shared__ __align__(16) signed char prof[WARPS * WSTRIDE];
  signed char* pbase = prof + wib * WSTRIDE + lane * 4;

  const int* srow = subj + (size_t)b * S;
  int2* crow = carry + (size_t)b * S;
  const int rows = min(slens[b], S);
  // qend: one past the window's last column whose code is not 7 (pad),
  // sought from the end, 32 columns at a time
  int qend = 0;
  for (int base = Q - 32;; base -= 32) {
    const int j = base + lane;
    const unsigned real =
        __ballot_sync(FULL, j >= 0 && (q[(size_t)b * Q + j] & 7) != 7);
    if (real) {
      qend = base + 32 - __clz(real);
      break;
    }
    if (base <= 0) break;
  }
  const int nstrip = (qend + STRIP_W - 1) / STRIP_W;
  int bt = 0, bi = 0, bj = 0;          // TRACK: the lane's record so far
  int acc = 0;                         // !TRACK: the lane's max of T
  for (int k = 0; k < nstrip; ++k) {
    const int j0 = k * STRIP_W + lane * C;   // the lane's first column
    const int j0ge = j0 * ge;
    const bool last = k + 1 == nstrip;
    int qc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = j0 + c;
      qc[c] = j < Q ? q[(size_t)b * Q + j] & 7 : 7;
    }
#pragma unroll
    for (int s = 0; s < 8; ++s)
#pragma unroll
      for (int w4 = 0; w4 < C / 4; ++w4) {
        const unsigned w = (smat[8 * s + qc[4 * w4]] & 0xff) |
                           (smat[8 * s + qc[4 * w4 + 1]] & 0xff) << 8 |
                           (smat[8 * s + qc[4 * w4 + 2]] & 0xff) << 16 |
                           (unsigned)smat[8 * s + qc[4 * w4 + 3]] << 24;
        *reinterpret_cast<unsigned*>(pbase + s * PITCH + w4 * (L * 4)) = w;
      }
    int H[C], Eh[C];                   // Eh = E + i*ge
#pragma unroll
    for (int c = 0; c < C; ++c) {
      H[c] = 0;
      Eh[c] = 0;
    }
    // strip k - 1's carry stores (lane 31) are seen by every lane
    __syncwarp();
    int lthr = 255, lkey = 255, li = 0;  // TRACK: this strip's record
    int scode = 7;
    int2 cv = make_int2(0, NEG);       // strip 0: H = 0 left, no prefix
    int hprev = 0;                     // x of the row above (lane 0 reads)
    for (int i = 0; i < rows; ++i) {
      if ((i & 31) == 0) {
        const int r = i + lane;
        scode = r < S ? srow[r] & 7 : 7;
        if (k > 0 && r < rows) cv = crow[r];
      }
      const int sc = __shfl_sync(FULL, scode, i & 31);
      const signed char* prow = pbase + sc * PITCH;
      const int nige = -i * ge;          // E = Eh + nige
      const int ci = (i + 1) * ge - go;  // Eh' = max(Eh, H + ci)

      int hleft = __shfl_up_sync(FULL, H[C - 1], 1);
      if (lane == 0) hleft = hprev;      // H[i-1, j0-1] of the last strip
      hprev = __shfl_sync(FULL, cv.x, i & 31);
      const int pmc = __shfl_sync(FULL, cv.y, i & 31);
      int T[C], H0[C], run[C];
      int r = NEG;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int w = prow[(c / 4) * (L * 4) + c % 4];
        T[c] = (c == 0 ? hleft : H[c - 1]) + w;
        H0[c] = addmax_relu(Eh[c], nige, T[c]);
        r = addmax(H0[c], c * ge, r);    // prefix max within the lane
        run[c] = r;
      }
      // inclusive prefix max of the lane totals, in window coordinates,
      // the strips to the left folded in at lane 0
      int incl = r + j0ge;
      if (lane == 0) incl = max(incl, pmc);
#pragma unroll
      for (int d = 1; d < L; d <<= 1)
        incl = max(incl, __shfl_up_sync(FULL, incl, d));
      int excl = __shfl_up_sync(FULL, incl, 1);
      excl = (lane == 0 ? pmc : excl) - j0ge;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int cm = c == 0 ? excl : max(excl, run[c - 1]);
        const int hn = addmax(cm, -(go + (c - 1) * ge), H0[c]);  // max(F, H0)
        Eh[c] = addmax(hn, ci, Eh[c]);
        H[c] = hn;
      }
      if (!last && lane == 31) crow[i] = make_int2(H[C - 1], incl);

      if (TRACK) {
        const int m = row_key<C>(T, kmul);
        if (m > lthr) {                  // T strictly above the strip's best
          lkey = m;
          li = i;
          lthr = m | 255;
        }
      } else {
        acc = max(acc, row_max<C>(T));
      }
    }
    if (TRACK) {
      const int st = lkey >> 8;
      const int sj = j0 + 255 - (lkey & 255);
      if (st > bt || (st == bt && (li < bi || (li == bi && sj < bj)))) {
        bt = st;
        bi = li;
        bj = sj;
      }
    }
  }
  if (TRACK) {
    // highest T, then lowest row, then lowest column, over the warp
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const int ot = __shfl_xor_sync(FULL, bt, d);
      const int oi = __shfl_xor_sync(FULL, bi, d);
      const int oj = __shfl_xor_sync(FULL, bj, d);
      if (ot > bt || (ot == bt && (oi < bi || (oi == bi && oj < bj)))) {
        bt = ot;
        bi = oi;
        bj = oj;
      }
    }
    if (lane == 0) {
      const bool hit = bt > 0;         // else no row beat the initial 0
      best_out[b] = hit ? bt : 0;
      ti_out[b] = hit ? bi : 0;
      tj_out[b] = hit ? bj : 0;
    }
  } else {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      acc = max(acc, __shfl_xor_sync(FULL, acc, d));
    if (lane == 0) best_out[b] = acc;
  }
}
#endif  // SWF_STRIP_KERNEL

// One window a block of NW = blockDim.x / 32 warps, the query in strips
// of STRIP_W columns run as a wavefront (header): strip k on warp k % NW,
// its chunk c (subject rows [32c, 32c + 32)) at step (k / NW) * M +
// k % NW + c, M = max(Cr, NW), one block barrier a step.  Dynamic shared
// memory: the carry ring, NW x 2 x 32 int2, then (int8 instances) a
// profile of STRIP_WSTRIDE bytes a warp.  Every warp runs every step, so every
// warp reaches every barrier.  Built for launches of up to MAXW warps.
template <bool TRACK, bool WIDE, int MAXW>
__global__ void __launch_bounds__(MAXW * 32, 1)
SWF_WAVE_KERNEL(const int* __restrict__ q, const int* __restrict__ subj,
                const int* __restrict__ slens,
                const int* __restrict__ matrix, int Q, int S, int go,
                int ge, int kmul, int2* carry,
                int* __restrict__ best_out, int* __restrict__ ti_out,
                int* __restrict__ tj_out) {
  // carry is written and read again in the kernel: no __restrict__, so
  // that no load of it takes the read-only (non-coherent) path
  constexpr int C = STRIP_C, L = 32;
  constexpr bool REC = TRACK && WIDE && SWF_REC;   // the two-part record
  // the 32-lane instance's profile layout: lane l's word k of row s at
  // byte s * PITCH + k * 128 + l * 4, read back by lane l alone
  constexpr int PITCH = L * C;
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ int smat[64];
  __shared__ int red[STRIP_WARPS][3];  // the warps' records (or maxima)
  __shared__ int qlast;
  const int NW = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x;
  const int* qrow = q + (size_t)b * Q;
  for (int i = threadIdx.x; i < 64; i += blockDim.x) smat[i] = matrix[i];
  if (threadIdx.x == 0) qlast = 0;
  __syncthreads();
  // qend: one past the window's last column whose code is not 7 (pad),
  // sought from the end, the block's width of columns at a time
  for (int base = Q - static_cast<int>(blockDim.x);; base -= blockDim.x) {
    const int j = base + threadIdx.x;
    const bool real = j >= 0 && (qrow[j] & 7) != 7;
    const int hit = __reduce_max_sync(FULL, real ? j + 1 : 0);
    if (lane == 0 && hit) atomicMax(&qlast, hit);
    if (__syncthreads_or(real) || base <= 0) break;
  }
  const int nstrip = (qlast + STRIP_W - 1) / STRIP_W;
  const int rows = min(slens[b], S);
  const int Cr = rows > 0 ? (rows + 31) >> 5 : 0;
  const int M = max(Cr, NW);
  const int nsteps = nstrip == 0 || Cr == 0 ? 0 :
      (nstrip - 1) / NW * M + (nstrip - 1) % NW + Cr;

  int2* ring = reinterpret_cast<int2*>(dyn);       // [NW][2][32]
  signed char* pbase = reinterpret_cast<signed char*>(dyn) +
      NW * 2 * 32 * sizeof(int2) + (WIDE ? 0 : w * STRIP_WSTRIDE + lane * 4);
  const int* srow = subj + (size_t)b * S;
  int2* crow = carry + (size_t)b * S;
  int bt = 0, bi = 0, bj = 0;          // TRACK: the lane's record so far
  int acc = 0;                         // !TRACK: the lane's max of T
  int H[C], Eh[C], qc[C];              // Eh = E + i*ge
  int lthr = 255, lkey = 255, li = 0;  // TRACK: this strip's record
  int lbest = 0, lcol = 0;             // REC: (T, column) of it
  int hprev = 0;                       // x of the row above (lane 0 reads)
  for (int t = 0; t < nsteps; ++t) {
    const int u = t - w;               // this warp's chunk at step t
    const int rnd = u >= 0 ? u / M : 0;
    const int c = u - rnd * M;
    const int k = rnd * NW + w;        // its strip
    if (u >= 0 && c < Cr && k < nstrip) {
      const int j0 = k * STRIP_W + lane * C;   // the lane's first column
      const int j0ge = j0 * ge;
      if (c == 0) {                    // a new strip
#pragma unroll
        for (int cc = 0; cc < C; ++cc) {
          const int j = j0 + cc;
          qc[cc] = j < Q ? qrow[j] & 7 : 7;
          H[cc] = 0;
          Eh[cc] = 0;
        }
        if (!WIDE) {
#pragma unroll
          for (int s = 0; s < 8; ++s)
#pragma unroll
            for (int w4 = 0; w4 < C / 4; ++w4) {
              const unsigned x = (smat[8 * s + qc[4 * w4]] & 0xff) |
                                 (smat[8 * s + qc[4 * w4 + 1]] & 0xff) << 8 |
                                 (smat[8 * s + qc[4 * w4 + 2]] & 0xff) << 16 |
                                 (unsigned)smat[8 * s + qc[4 * w4 + 3]] << 24;
              *reinterpret_cast<unsigned*>(pbase + s * PITCH +
                                           w4 * (L * 4)) = x;
            }
          __syncwarp();
        }
        lthr = 255;
        lkey = 255;
        li = 0;
        lbest = 0;
        lcol = 0;
        hprev = 0;                     // H[-1, *] = 0
      }
      // this chunk's carry from strip k - 1: warp w - 1 left it in the ring
      // one step ago, warp NW - 1 (the round before) in device memory at
      // least one barrier ago; strip 0 starts from H = 0, no prefix
      const int rb = c * 32;
      int2 cv = make_int2(0, NEG);
      if (k > 0 && rb + lane < rows)
        cv = w > 0 ? ring[((w - 1) * 2 + ((t - 1) & 1)) * 32 + lane]
                   : crow[rb + lane];
      const int scode = rb + lane < S ? srow[rb + lane] & 7 : 7;
      int2* rring = ring + (w * 2 + (t & 1)) * 32;   // to warp w + 1
      const bool out = k + 1 < nstrip && lane == 31;
      const int nrow = min(32, rows - rb);
      for (int ii = 0; ii < nrow; ++ii) {
        const int i = rb + ii;
        const int sc = __shfl_sync(FULL, scode, ii);
        const signed char* prow = pbase + sc * PITCH;
        const int* mrow = smat + 8 * sc;   // WIDE
        const int nige = -i * ge;          // E = Eh + nige
        const int ci = (i + 1) * ge - go;  // Eh' = max(Eh, H + ci)

        int hleft = __shfl_up_sync(FULL, H[C - 1], 1);
        if (lane == 0) hleft = hprev;      // H[i-1, j0-1] of the last strip
        hprev = __shfl_sync(FULL, cv.x, ii);
        const int pmc = __shfl_sync(FULL, cv.y, ii);
        int T[C], H0[C], run[C];
        int r = NEG;
#pragma unroll
        for (int cc = 0; cc < C; ++cc) {
          const int x = WIDE ? mrow[qc[cc]]
                             : prow[(cc / 4) * (L * 4) + cc % 4];
          T[cc] = (cc == 0 ? hleft : H[cc - 1]) + x;
          H0[cc] = addmax_relu(Eh[cc], nige, T[cc]);
          r = addmax(H0[cc], cc * ge, r);  // prefix max within the lane
          run[cc] = r;
        }
        // inclusive prefix max of the lane totals, in window coordinates,
        // the strips to the left folded in at lane 0
        int incl = r + j0ge;
        if (lane == 0) incl = max(incl, pmc);
#pragma unroll
        for (int d = 1; d < L; d <<= 1)
          incl = max(incl, __shfl_up_sync(FULL, incl, d));
        int excl = __shfl_up_sync(FULL, incl, 1);
        excl = (lane == 0 ? pmc : excl) - j0ge;
#pragma unroll
        for (int cc = 0; cc < C; ++cc) {
          const int cm = cc == 0 ? excl : max(excl, run[cc - 1]);
          const int hn = addmax(cm, -(go + (cc - 1) * ge), H0[cc]);
          Eh[cc] = addmax(hn, ci, Eh[cc]);
          H[cc] = hn;
        }
        if (out) {                         // the carry to strip k + 1
          const int2 v = make_int2(H[C - 1], incl);
          if (w + 1 < NW)
            rring[ii] = v;
          else
            crow[i] = v;
        }

        if (TRACK && !REC) {
          const int m = row_key<C>(T, kmul);
          if (m > lthr) {                  // T strictly above the strip's best
            lkey = m;
            li = i;
            lthr = m | 255;
          }
        } else if (TRACK) {                // the two-part record
          const int m = row_max<C>(T);
          if (m > lbest) {
            lcol = first_col<C>(T, m);
            lbest = m;
            li = i;
          }
        } else {
          acc = max(acc, row_max<C>(T));
        }
      }
      if (TRACK && c + 1 == Cr) {          // the strip's record, merged
        const int st = REC ? lbest : lkey >> 8;
        const int sj = REC ? j0 + lcol : j0 + 255 - (lkey & 255);
        if (st > bt || (st == bt && (li < bi || (li == bi && sj < bj)))) {
          bt = st;
          bi = li;
          bj = sj;
        }
      }
    }
    __syncthreads();
  }
  if (TRACK) {
    // highest T, then lowest row, then lowest column: over the warp, then
    // over the block's warps
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const int ot = __shfl_xor_sync(FULL, bt, d);
      const int oi = __shfl_xor_sync(FULL, bi, d);
      const int oj = __shfl_xor_sync(FULL, bj, d);
      if (ot > bt || (ot == bt && (oi < bi || (oi == bi && oj < bj)))) {
        bt = ot;
        bi = oi;
        bj = oj;
      }
    }
    if (lane == 0) {
      red[w][0] = bt;
      red[w][1] = bi;
      red[w][2] = bj;
    }
    __syncthreads();
    if (w == 0) {
      bt = lane < NW ? red[lane][0] : -1;
      bi = lane < NW ? red[lane][1] : 0;
      bj = lane < NW ? red[lane][2] : 0;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        const int ot = __shfl_xor_sync(FULL, bt, d);
        const int oi = __shfl_xor_sync(FULL, bi, d);
        const int oj = __shfl_xor_sync(FULL, bj, d);
        if (ot > bt || (ot == bt && (oi < bi || (oi == bi && oj < bj)))) {
          bt = ot;
          bi = oi;
          bj = oj;
        }
      }
      if (lane == 0) {
        const bool hit = bt > 0;       // else no row beat the initial 0
        best_out[b] = hit ? bt : 0;
        ti_out[b] = hit ? bi : 0;
        tj_out[b] = hit ? bj : 0;
      }
    }
  } else {
    acc = __reduce_max_sync(FULL, acc);
    if (lane == 0) red[w][0] = acc;
    __syncthreads();
    if (w == 0) {
      acc = __reduce_max_sync(FULL, lane < NW ? red[lane][0] : 0);
      if (lane == 0) best_out[b] = acc;
    }
  }
}
