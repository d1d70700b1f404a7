// The several-warps kernel of sw_band.cu, included there once for each
// instance: SWB_MULTI_KERNEL names it and SWB_MULTI_NW (a literal) is the
// most warps a window it runs, which sizes its shared arrays and its
// launch bound.  Up to 6 warps a warp reads the other warps' totals in a
// loop; above that lane v reads warp v's and a 5-step shuffle reduces
// them.  (One text for both, so that the 6-warp instance compiles to the
// code it had before the 32-warp one was added.)

// One window a block on NW = blockDim.x / 32 <= SWB_MULTI_NW warps,
// 512 < W <= 32 * C * NW.
template <int C, bool TRACK>
__global__ void __launch_bounds__(SWB_MULTI_NW * 32)
SWB_MULTI_KERNEL(const int* __restrict__ q, const int* __restrict__ subj,
                     const int* __restrict__ slens,
                     const int* __restrict__ matrix, int B, int Q, int S,
                     int W, int prepad, int go, int ge,
                     int* __restrict__ best_out, int* __restrict__ ti_out,
                     int* __restrict__ tj_out) {
  __shared__ int smat[64];
  // the exchange, by row parity: scan totals, row maxima, and E of each
  // warp's first lane (the state after the previous row)
  __shared__ int wtot[2][SWB_MULTI_NW], wmax[2][SWB_MULTI_NW],
      eb[2][SWB_MULTI_NW + 1];
  __shared__ int wacc[SWB_MULTI_NW], blane;
  if (threadIdx.x < 64) smat[threadIdx.x] = matrix[threadIdx.x];

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;      // this warp's place in its window
  const int NW = blockDim.x >> 5;
  const int b = blockIdx.x;
  if (threadIdx.x < SWB_MULTI_NW + 1) eb[0][threadIdx.x] = NEG;
  if (threadIdx.x == 0) blane = 0;
  __syncthreads();
  if (b >= B) return;                  // block-uniform

  const int t0 = (w * 32 + lane) * C;  // first band lane of this thread
  const int tlast = (w * 32 + 31) * C + C - 1;   // the warp's last lane
  const bool partial = t0 + C > W;     // holds padding lanes past W
  const int* qrow = q + (size_t)b * Q;
  const int* srow = subj + (size_t)b * S;
  const int slen = min(slens[b], S);

  int qc[C], H[C], E[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = t0 + c - prepad;
    qc[c] = (j >= 0 && j < Q) ? qrow[j] & 7 : 7;
    H[c] = 0;
    E[c] = NEG;
  }

  int best = 0, bi = 0;                // TRACK: window-uniform running best
  int acc = 0;                         // !TRACK: this thread's max of T
  int scode = 7, qin = 7;
  for (int i = 0; i < slen; ++i) {
    const int p = i & 1;
    if ((i & 31) == 0) {
      const int r = i + lane;
      scode = r < S ? srow[r] & 7 : 7;
      const int jn = r + 1 - prepad + tlast;   // enters at row r + 1
      qin = (jn >= 0 && jn < Q) ? qrow[jn] & 7 : 7;
    }
    const int* mrow = smat + 8 * __shfl_sync(FULL, scode, i & 31);

    // phase A: T, H0 and the in-warp F scan.  The warp's last lane takes
    // Ein = NEG for now (its true value arrives in phase B).
    int enext = __shfl_down_sync(FULL, E[0], 1);
    if (lane == 31) enext = NEG;
    int T[C], H0[C], run[C];
    int r = NEG;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      T[c] = H[c] + mrow[qc[c]];
      const int ein = c < C - 1 ? E[c + 1] : enext;
      H0[c] = max(max(T[c], ein), 0);
      r = max(r, H0[c] + (t0 + c) * ge);
      run[c] = r;                      // prefix max within the thread
    }
    int incl = r;                      // inclusive prefix max over lanes
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl = max(incl, v);
    }
    int excl = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl = NEG;

    if (partial) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (t0 + c >= W) T[c] = NEG;   // padding lanes: out of the max
    }
    int m = 0;                         // TRACK: the row max of T
    if (TRACK) {
      m = T[0];
#pragma unroll
      for (int c = 1; c < C; ++c) m = max(m, T[c]);
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) m = max(m, __shfl_xor_sync(FULL, m, d));
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) acc = max(acc, T[c]);
    }

    if (lane == 31) wtot[p][w] = incl;
    if (TRACK && lane == 0) wmax[p][w] = m;
    __syncthreads();
    // phase B: the other warps' totals, corrected by the E their last
    // lanes take from the next warp's first lane
    int pre = NEG;
#if SWB_MULTI_NW <= 6
    for (int v = 0; v < w; ++v)
      pre = max(pre, max(wtot[p][v],
                         eb[p][v + 1] + ((v + 1) * 32 * C - 1) * ge));
#else
    if (lane < w)                      // lane v reads warp v < w
      pre = max(wtot[p][lane],
                eb[p][lane + 1] + ((lane + 1) * 32 * C - 1) * ge);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      pre = max(pre, __shfl_xor_sync(FULL, pre, d));
#endif
    excl = max(excl, pre);
    if (lane == 31) {
      enext = w + 1 < NW ? eb[p][w + 1] : NEG;
      H0[C - 1] = max(H0[C - 1], enext);
    }
    if (TRACK) {
#if SWB_MULTI_NW <= 6
      for (int v = 0; v < NW; ++v) m = max(m, wmax[p][v]);
#else
      int x = lane < NW ? wmax[p][lane] : m;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) x = max(x, __shfl_xor_sync(FULL, x, d));
      m = max(m, x);
#endif
    }

#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int cm = c == 0 ? excl : max(excl, run[c - 1]);
      const int F = cm - go - (t0 + c - 1) * ge;
      const int hn = max(H0[c], F);
      const int ein = c < C - 1 ? E[c + 1] : enext;   // E[c+1] still old
      E[c] = max(ein - ge, hn - go);
      H[c] = hn;
    }
    if (partial) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (t0 + c >= W) E[c] = NEG;
    }
    if (lane == 0) eb[p ^ 1][w] = E[0];

    if (TRACK && m > best) {           // uniform over the window's warps
      int v = 0;                       // the first warp reaching m owns it
      while (v < NW - 1 && wmax[p][v] != m) ++v;
      if (v == w) {
        int first = 1 << 28;
#pragma unroll
        for (int c = C - 1; c >= 0; --c)
          if (T[c] == m) first = t0 + c;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1)
          first = min(first, __shfl_xor_sync(FULL, first, d));
        if (lane == 0) blane = first;
      }
      best = m;
      bi = i;
    }

    // slide the band one query column right for row i + 1
    const int qnew = __shfl_sync(FULL, qin, i & 31);
    const int qnext = __shfl_down_sync(FULL, qc[0], 1);
#pragma unroll
    for (int c = 0; c < C - 1; ++c) qc[c] = qc[c + 1];
    qc[C - 1] = lane == 31 ? qnew : qnext;
  }

  if (!TRACK) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) acc = max(acc, __shfl_xor_sync(FULL, acc, d));
    if (lane == 0) wacc[w] = acc;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  if (TRACK) {
    best_out[b] = best;                // >= 0: the running best starts at 0
    ti_out[b] = bi;
    tj_out[b] = bi + blane - prepad;
  } else {
    for (int v = 1; v < NW; ++v) acc = max(acc, wacc[v]);
    best_out[b] = acc;                 // >= 0: acc starts at 0
  }
}

