// The tiled kernel of sw_band.cu: bands wider than ops/sw.py
// CLUSTER_BAND_W = 131,072 lanes (reads past ~700 kb), which the
// register-resident kernels cannot hold.  It
// computes _make_swb_kernel's function (smalt_tpu/ops/sw.py:269), the
// recurrence at the top of sw_band.cu, with the same tracking rule.
//
// One block a window walks each subject row in tiles of TILED_TW band
// lanes, left to right; a thread holds TILED_C consecutive lanes of a
// tile in registers.  The row's H and E live in a global scratch, int2
// {H, E} for each of the window's W lanes (ops/sw.py allocates it for a
// group of windows and launches the groups in turn, scratch_groups).
// Tiles taken left to right keep the recurrence exact:
//   - Ein[i,t] = E[i-1,t+1] reads the lane to the right.  Inside a tile
//     that is a register loaded before the tile's update; the tile's last
//     lane reads the next tile's first lane from the scratch, which still
//     holds row i-1 there, because tile k+1 is updated only after tile
//     k's barriers.
//   - H's diagonal predecessor stays in its lane.
//   - F's prefix max over the lanes to the left, in band coordinates
//     (max over t' < t of H0[t'] + t'*ge), is carried from tile to tile
//     as one block-uniform value.
// TRACK keeps the row-major-first rule: the row's maximum of T and its
// lowest lane are taken over all tiles (a later tile replaces them only
// when strictly greater, so a tie keeps the earlier tile's lane), and
// the running best is compared with the whole row's maximum after the
// last tile.  No packed key: any int32 score, int32 matrix lookups.
//
// A tile row costs three barriers: one after the warp scans (the warps'
// scan totals and row maxima), one more on a tile whose maximum beats
// the row's so far (the lowest lane), and one after the scratch writes,
// which orders them before the next reads (the next row, or this row's
// next tile reusing the shared arrays).  Bound: at the ~100 kb windows
// the mapping path makes (W ~ 20,000, ~10 tiles a row) a block is
// latency-bound on those barriers and on the scratch, not on the integer
// rate that bounds the other sw_band kernels; a simple kernel that is
// right, with its times in PERF.md.

constexpr int TILED_C = 8;                     // band lanes a thread
constexpr int TILED_NT = 256;                  // threads a block
constexpr int TILED_NW = TILED_NT / 32;
constexpr int TILED_TW = TILED_C * TILED_NT;   // 2,048 band lanes a tile

template <bool TRACK>
__global__ void __launch_bounds__(TILED_NT)
sw_band_tiled_kernel(const int* __restrict__ q, const int* __restrict__ subj,
                     const int* __restrict__ slens,
                     const int* __restrict__ matrix, int B, int Q, int S,
                     int W, int prepad, int go, int ge, int2* scratch,
                     int* __restrict__ best_out, int* __restrict__ ti_out,
                     int* __restrict__ tj_out) {
  __shared__ int smat[64];
  __shared__ int wtot[TILED_NW], wmax[TILED_NW], wfirst[TILED_NW];
  const int b = blockIdx.x;
  if (b >= B) return;                  // block-uniform
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  if (threadIdx.x < 64) smat[threadIdx.x] = matrix[threadIdx.x];
  int2* st = scratch + (size_t)b * W;  // this window's row state
  for (int t = threadIdx.x; t < W; t += TILED_NT) st[t] = make_int2(0, NEG);
  __syncthreads();

  const int* qrow = q + (size_t)b * Q;
  const int* srow = subj + (size_t)b * S;
  const int slen = min(slens[b], S);
  const int ntiles = (W + TILED_TW - 1) / TILED_TW;
  int best = 0, bi = 0, blane = 0;     // TRACK: block-uniform running best
  int acc = 0;                         // !TRACK: this thread's max of T

  for (int i = 0; i < slen; ++i) {
    const int* mrow = smat + 8 * (srow[i] & 7);
    int carry = NEG;                   // prefix max of the tiles to the left
    int rmax = INT_MIN, rlane = 0;     // TRACK: the row's max so far
    for (int k = 0; k < ntiles; ++k) {
      const int t0 = k * TILED_TW + threadIdx.x * TILED_C;
      int H[TILED_C], E[TILED_C], T[TILED_C], H0[TILED_C], run[TILED_C];
#pragma unroll
      for (int c = 0; c < TILED_C; ++c) {
        if (t0 + c < W) {
          const int2 v = st[t0 + c];
          H[c] = v.x;
          E[c] = v.y;
        } else {                       // padding lanes past W
          H[c] = 0;
          E[c] = NEG;
        }
      }
      // E of the next lane in row i-1: the next thread's, or the next
      // tile's first lane (not written yet in this row)
      const int enext = t0 + TILED_C < W ? st[t0 + TILED_C].y : NEG;
      int r = NEG;
      int m = INT_MIN;                 // max of T over this thread's real lanes
#pragma unroll
      for (int c = 0; c < TILED_C; ++c) {
        const int j = i - prepad + t0 + c;
        const int qc = (j >= 0 && j < Q) ? qrow[j] & 7 : 7;
        T[c] = H[c] + mrow[qc];
        const int ein = c < TILED_C - 1 ? E[c + 1] : enext;
        H0[c] = max(max(T[c], ein), 0);
        r = max(r, H0[c] + (t0 + c) * ge);
        run[c] = r;                    // prefix max within the thread
        if (t0 + c < W) m = max(m, T[c]);
      }
      int incl = r;                    // inclusive prefix max over the warp
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl = max(incl, v);
      }
      int excl = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) excl = NEG;
      if (lane == 31) wtot[w] = incl;
      if (TRACK) {
        int wm = m;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1)
          wm = max(wm, __shfl_xor_sync(FULL, wm, d));
        if (lane == 0) wmax[w] = wm;
      } else {
        acc = max(acc, m);
      }
      __syncthreads();
      int pre = carry, tot = carry;
#pragma unroll
      for (int v = 0; v < TILED_NW; ++v) {
        if (v < w) pre = max(pre, wtot[v]);
        tot = max(tot, wtot[v]);
      }
      excl = max(excl, pre);
      carry = tot;
      if (TRACK) {
        int tm = INT_MIN;
#pragma unroll
        for (int v = 0; v < TILED_NW; ++v) tm = max(tm, wmax[v]);
        if (tm > rmax) {               // block-uniform
          int first = INT_MAX;
#pragma unroll
          for (int c = TILED_C - 1; c >= 0; --c)
            if (t0 + c < W && T[c] == tm) first = t0 + c;
#pragma unroll
          for (int d = 16; d > 0; d >>= 1)
            first = min(first, __shfl_xor_sync(FULL, first, d));
          if (lane == 0) wfirst[w] = first;
          __syncthreads();
          int f = INT_MAX;
#pragma unroll
          for (int v = 0; v < TILED_NW; ++v) f = min(f, wfirst[v]);
          rmax = tm;
          rlane = f;
        }
      }
#pragma unroll
      for (int c = 0; c < TILED_C; ++c) {
        const int cm = c == 0 ? excl : max(excl, run[c - 1]);
        const int hn = max(H0[c], cm - go - (t0 + c - 1) * ge);
        const int ein = c < TILED_C - 1 ? E[c + 1] : enext;  // E[c+1] still old
        E[c] = max(ein - ge, hn - go);
        H[c] = hn;
      }
#pragma unroll
      for (int c = 0; c < TILED_C; ++c)
        if (t0 + c < W) st[t0 + c] = make_int2(H[c], E[c]);
      __syncthreads();
    }
    if (TRACK && rmax > best) {        // block-uniform
      best = rmax;
      bi = i;
      blane = rlane;
    }
  }

  if (TRACK) {
    if (threadIdx.x == 0) {
      best_out[b] = best;              // >= 0: the running best starts at 0
      ti_out[b] = bi;
      tj_out[b] = bi + blane - prepad; // (0, 0, -prepad) when nothing scored
    }
  } else {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) acc = max(acc, __shfl_xor_sync(FULL, acc, d));
    if (lane == 0) wtot[w] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      int a = 0;                       // >= 0: acc starts at 0
      for (int v = 0; v < TILED_NW; ++v) a = max(a, wtot[v]);
      best_out[b] = a;
    }
  }
}
