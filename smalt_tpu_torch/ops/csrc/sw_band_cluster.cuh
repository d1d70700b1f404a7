// The cluster kernel of sw_band.cu: bands wider than ops/sw.py
// TILED_BAND_W = 12,800 lanes (reads past ~68 kb) up to CLUSTER_MAX CTAs x
// 512 threads x 16 lanes = 131,072 lanes (reads up to ~700 kb).  It
// computes _make_swb_kernel's function (smalt_tpu/ops/sw.py:269), the
// recurrence at the top of sw_band.cu, with the same tracking rule;
// sw_band_strips_kernel (sw_band_strips.cuh) takes the bands past it.
//
// One thread-block cluster scores one window.  Its K CTAs hold the band
// in contiguous slices, CTA r the lanes [r * NT * C, (r + 1) * NT * C), a
// thread C = 16 consecutive lanes of H and E in registers: no global
// scratch, and a few windows spread over K SMs each (the 6 windows of 2
// reads of 100 kb, W = 18,816, over 60 SMs as 10 CTAs of 128 threads and
// 2,048 lanes; ops/sw.py cluster_shape chooses K and NT).  A row is
// the several-warps kernel's (sw_band_multi.cuh) with the block barrier
// replaced by one cluster barrier and the block's shared exchange by
// distributed shared memory:
//   - Phase A, in each warp: T, H0 (the warp's last lane takes Ein = NEG
//     for now), the in-thread prefix max and the warp's shuffle scan.
//   - Each warp g of the cluster (g = rank * NW + warp) posts, into slot
//     g of every CTA's exchange, its scan total, and into slot g - 1 the
//     E of its first lane: the state after the row before, which warp
//     g - 1's last lane takes as Ein in this row.  Lane j of the warp
//     stores to CTA j (st.shared::cluster at an address mapa gave once).
//     The slots alternate with the row's parity.
//   - barrier.cluster.arrive.release; then the row's CTA-local work: F
//     from the lanes to the left inside the warp, Ein - ge for E, the
//     query's slide and the tracking; then barrier.cluster.wait.acquire.
//   - Phase B reads, from its own CTA's copy, the totals of the warps to
//     its left in every CTA (lane v reads warp v, __reduce_max_sync), each
//     corrected by the E its last lane takes from the warp after it (as
//     sw_band_multi.cuh corrects across warps), and the E of the next
//     warp's first lane for its own last lane; then H and E.
// One barrier a row orders every write before its reads and, with the
// parity, every read before the next write to the same slot: a CTA writes
// slot p of row i + 2 only after the wait of row i + 1, which every CTA
// reaches only after its reads of row i.
//
// The query slides in registers as in sw_band_multi.cuh: each row a
// thread takes the next thread's first code by a shuffle, and a warp's
// last thread the code that enters at the warp's last lane, read 32 rows
// at a time (the next 32 rows' codes are fetched 32 rows ahead, as are the
// subject codes).  No global memory is touched inside a row otherwise.
//
// TRACK without an exchange in the row loop: each thread keeps the
// first-best cell of its own lanes (a row replaces it only when its max
// of T over the thread's lanes is strictly greater, and then names its
// lowest lane), and after the loop one reduction picks the highest T,
// then the lowest row, then the lowest lane: the reference's rule, by
// the proof in sw_band.cu (sw_band_warp_kernel's tracking, here without
// the packed key).  Each warp's record goes to CTA 0, which reduces them
// after a last cluster barrier and writes the result; a window in which
// nothing scores returns (0, 0, -prepad).  Score-only: each warp's max of
// T goes the same way.  Any int32 score, int32 matrix lookups.
//
// A window with slen 0 (the pad reads of a batch) returns in every CTA
// before the first barrier and touches no other CTA; every other CTA
// waits at a last cluster barrier before it exits, so no CTA leaves while
// another may still write to its shared memory.
//
// What bounds it: a row's serial latency, not the integer rate.  Each row
// pays one cluster barrier, remote stores that the barrier's release
// waits for, and two warp-wide dependency chains (the 5-step shuffle scan
// before the post, the read and reduction after the wait), and an SM
// holds one CTA of a window (4 warps at the main shape), too few to hide
// them: measured, a row takes ~1.1 us at the 100 kb shape (PERF.md),
// against ~0.2 us of integer work a row for a CTA of 4 warps (~200
// integer instructions a thread and row at 2 clocks each).

constexpr int CLUSTER_MAX = 16;      // CTAs a cluster (non-portable past 8)
constexpr int CLUSTER_C = 16;        // band lanes a thread
constexpr int CLUSTER_NT = 512;      // most threads a CTA (128 registers)

__device__ __forceinline__ unsigned cluster_ctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_nctarank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}
// The address of `p` (this CTA's shared memory) in CTA `rank`'s shared
// memory, in the cluster's shared window.
__device__ __forceinline__ unsigned dsmem_addr(const void* p, unsigned rank) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  unsigned d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(d) : "r"(a), "r"(rank));
  return d;
}
__device__ __forceinline__ void dsmem_store(unsigned addr, int v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;" :: "r"(addr), "r"(v)
               : "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// One cluster of K = %cluster_nctarank CTAs a window (grid = windows x K),
// NT = blockDim.x <= CLUSTER_NT threads a CTA, K * NT * C >= W.
template <bool TRACK>
__global__ void __launch_bounds__(CLUSTER_NT)
sw_band_cluster_kernel(const int* __restrict__ q, const int* __restrict__ subj,
                       const int* __restrict__ slens,
                       const int* __restrict__ matrix, int Q, int S, int W,
                       int prepad, int go, int ge, const LaneConsts lc,
                       int* __restrict__ best_out, int* __restrict__ ti_out,
                       int* __restrict__ tj_out) {
  constexpr int C = CLUSTER_C;
  constexpr int MAXG = CLUSTER_MAX * CLUSTER_NT / 32;  // warps a cluster
  __shared__ int smat[64];
  // by row parity, slot g for warp g of the cluster: .x its scan total, .y
  // the E of warp g + 1's first lane (the row before; NEG past the last
  // warp); xfin (CTA 0) warp g's record after the loop: its best T (and,
  // TRACK, that cell's row and lane)
  __shared__ int2 xtot[2][MAXG];
  __shared__ int xfin[TRACK ? 3 : 1][MAXG];

  const int K = static_cast<int>(cluster_nctarank());
  const int rank = static_cast<int>(cluster_ctarank());
  const int b = blockIdx.x / K;        // the window
  const int slen = min(slens[b], S);
  if (slen <= 0) {                     // cluster-uniform: nothing scores
    if (rank == 0 && threadIdx.x == 0) {
      best_out[b] = 0;
      if (TRACK) {
        ti_out[b] = 0;
        tj_out[b] = -prepad;
      }
    }
    return;
  }

  const int lane = threadIdx.x & 31;
  const int NW = blockDim.x >> 5;
  const int G = K * NW;
  const int g = rank * NW + (threadIdx.x >> 5);   // this warp in the cluster
  for (int v = threadIdx.x; v < G; v += blockDim.x)
    xtot[0][v] = xtot[1][v] = make_int2(NEG, NEG);
  for (int v = threadIdx.x; v < 64; v += blockDim.x) smat[v] = matrix[v];
  cluster_arrive();                    // every CTA has started and set its
  cluster_wait();                      // slots before the first remote store

  const int t0 = (g * 32 + lane) * C;  // first band lane of this thread
  const int t0ge = t0 * ge;
  const int nreal = min(max(W - t0, 0), C);       // lanes below W
  const bool partial = nreal < C;
  const int tlast = (g * 32 + 31) * C + C - 1;    // the warp's last lane
  const int last_neg = lane == 31 ? NEG : INT_MAX;
  const int first_neg = lane == 0 ? NEG : INT_MAX;
  const int* qrow = q + (size_t)b * Q;
  const int* srow = subj + (size_t)b * S;
  // lane j < K stores this warp's posts to CTA j
  const unsigned xt_dst = dsmem_addr(&xtot[0][0], lane < K ? lane : 0);

  int qc[C], H[C], E[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = t0 + c - prepad;
    qc[c] = (j >= 0 && j < Q) ? qrow[j] & 7 : 7;
    H[c] = 0;
    E[c] = NEG;
  }
  // the subject code of row base + lane and the query code that enters at
  // the warp's last lane at row base + lane + 1
  auto fetch = [&](int base, int& sc, int& qi) {
    const int r = base + lane;
    sc = r < S ? srow[r] & 7 : 7;
    const int jn = r + 1 - prepad + tlast;
    qi = (jn >= 0 && jn < Q) ? qrow[jn] & 7 : 7;
  };
  int scode, qin, scode_n, qin_n;
  fetch(0, scode, qin);
  fetch(32, scode_n, qin_n);

  // this thread's best T (which starts at 0) and, TRACK, its first cell
  int tbest = 0, trow = 0, tlane = 0;
  for (int i = 0; i < slen; ++i) {
    const int p = i & 1;
    if (i != 0 && (i & 31) == 0) {
      scode = scode_n;
      qin = qin_n;
      fetch(i + 32, scode_n, qin_n);
    }
    const int* mrow = smat + 8 * __shfl_sync(FULL, scode, i & 31);

    // phase A
    const int e0 = E[0];               // the row before
    const int enext = min(__shfl_down_sync(FULL, e0, 1), last_neg);
    int T[C], H0[C], run[C];
    int r = NEG;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      T[c] = H[c] + mrow[qc[c]];
      H0[c] = addmax_relu(c < C - 1 ? E[c + 1] : enext, 0, T[c]);
      r = addmax(H0[c], lc.cge[c], r);  // prefix max in thread coordinates
      run[c] = r;
    }
    int incl = r + t0ge;               // band coordinates over the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1)
      incl = max(incl, __shfl_up_sync(FULL, incl, d));
    const int X = min(__shfl_up_sync(FULL, incl, 1) - t0ge, first_neg);
    const int wtot = __shfl_sync(FULL, incl, 31);
    const int wfirst = __shfl_sync(FULL, e0, 0);
    if (lane < K) {
      const unsigned slot = xt_dst + (p * MAXG + g) * 8;
      dsmem_store(slot, wtot);
      if (g > 0) dsmem_store(slot - 4, wfirst);   // .y of slot g - 1
    }
    cluster_arrive();

    // CTA-local: F from the lanes to the left inside the warp, Ein - ge
    int Hl[C], eg[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int cm = c == 0 ? X : max(X, run[c - 1]);
      Hl[c] = addmax(cm, lc.fk[c], H0[c]);       // max(H0, F so far)
      if (c < C - 1) eg[c] = E[c + 1] - ge;      // E[c + 1] still old
    }
    // slide the band one query column right for row i + 1
    const int qnew = __shfl_sync(FULL, qin, i & 31);
    const int qnext = __shfl_down_sync(FULL, qc[0], 1);
#pragma unroll
    for (int c = 0; c < C - 1; ++c) qc[c] = qc[c + 1];
    qc[C - 1] = lane == 31 ? qnew : qnext;
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

    cluster_wait();

    // phase B: the warps to the left, in every CTA, their totals corrected
    // by the E their last lanes take from the warp after them
    int pre = NEG;
    for (int v = lane; v < g; v += 32) {
      const int2 x = xtot[p][v];
      pre = max(pre, addmax(x.y, ((v + 1) * 32 * C - 1) * ge, x.x));
    }
    pre = __reduce_max_sync(FULL, pre) - t0ge;
    // the warp's last lane: Ein from the next warp's first lane; no lane
    // of this warp reads its H0 through F
    const int el = lane == 31 ? xtot[p][g].y : enext;
    Hl[C - 1] = max(Hl[C - 1], el);
    eg[C - 1] = el - ge;


#pragma unroll
    for (int c = 0; c < C; ++c) {
      H[c] = addmax(pre, lc.fk[c], Hl[c]);       // max(H0, F)
      E[c] = addmax(H[c], -go, eg[c]);           // max(Ein - ge, H - go)
    }
    if (partial) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (c >= nreal) E[c] = NEG;
    }
  }

  // the records of this warp, then of every warp in CTA 0: highest T,
  // then lowest row, then lowest lane (a record of T = 0 is (0, 0, 0))
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
    dsmem_store(dsmem_addr(&xfin[0][g], 0), tbest);
    if (TRACK) {
      dsmem_store(dsmem_addr(&xfin[1][g], 0), trow);
      dsmem_store(dsmem_addr(&xfin[2][g], 0), tlane);
    }
  }
  cluster_arrive();                    // no remote store after this barrier
  cluster_wait();
  if (rank != 0 || threadIdx.x >= 32) return;
  int bt = 0, bi = 0, bl = 0;          // >= 0: every best starts at 0
  for (int v = lane; v < G; v += 32) {
    const int ot = xfin[0][v];
    const int oi = TRACK ? xfin[1][v] : 0, ol = TRACK ? xfin[2][v] : 0;
    if (ot > bt || (ot == bt && (oi < bi || (oi == bi && ol < bl)))) {
      bt = ot;
      bi = oi;
      bl = ol;
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
      tj_out[b] = bi + bl - prepad;   // (0, 0, -prepad) when nothing scored
    }
  }
}
