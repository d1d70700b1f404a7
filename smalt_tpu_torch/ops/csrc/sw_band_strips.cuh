// The strip kernel of sw_band.cu: bands wider than ops/sw.py
// CLUSTER_BAND_W = 12,800 lanes (reads past ~68 kb), with no upper limit
// on W.  It computes _make_swb_kernel's function (smalt_tpu/ops/sw.py:269),
// the recurrence at the top of sw_band.cu, with the same tracking rule.
// It replaced a one-block tiled kernel past 131,072 lanes, which walked
// each row of a window's band in tiles on one SM (0.1% of its bound), and
// measured faster than the cluster kernel (sw_band_cluster.cuh) at every
// width past 12,800 (PERF.md), which it took over.
//
// The band in the query's own frame.  In the band frame lane t of row i
// needs lane t + 1 of row i - 1 (E) and every lane to its left in row i
// (F), which forces a serial walk along the row.  In query coordinates
// (row i, column j = i - prepad + t) the same cells are the full-matrix
// recurrence of sw_full.cu restricted to the diagonal band lo(i) <= j <
// hi(i), lo(i) = i - prepad, hi(i) = lo(i) + W, and every dependency
// points up or to the left:
//   T[i,j] = H[i-1,j-1] + w      (the diagonal, always inside the band)
//   Ein[i,j] = E[i-1,j]          (NEG where (i-1, j) lies right of the
//                                 band: j = hi(i) - 1, lane W - 1)
//   F[i,j] = max over lo(i) <= j' < j of H0[i,j'] + j'*ge, - go - (j-1)*ge
// So the band runs as sw_full.cu runs queries past 512 columns: column
// strips of SW = STRIPS_W columns from column 0, lane l of a warp holding
// columns j0 + C l + [0, C) of strip k (j0 = SW k, C = STRIPS_C), the
// row loop of sw_full's strip instance inside, and strip k handing strip
// k + 1, a row, the two values sw_full's strips hand on: x = H[i, j0 - 1]
// and the running prefix max y.  E stays in its column.
//
// A strip's rows.  Strip k meets the band in rows (j0 + prepad - W,
// j0 + SW + prepad) and runs [a_k, b_k), a_k = max(0, j0 + prepad - W
// + 1), b_k = min(rows, j0 + SW + prepad): W + SW - 1 rows, not S.  Its
// rows [j0 + SW + prepad - W, j0 + prepad] lie wholly inside the band
// and run sw_full's row as it is; in the first and last SW - 1 an edge
// of the band crosses the strip, and only the chunks of 32 rows that hold
// such a row pay for the masks (lanes compare their columns with lo(i)
// and hi(i)):
//   - left of the band, H0 = NEG: such a cell feeds no cell of the band
//     but through F (its H feeds (i+1, j+1), its E (i+1, j): both left
//     of the band again), and NEG keeps it out of the prefix max and of
//     the y handed on;
//   - right of the band, E = NEG: its E feeds lane W - 1 of the next row
//     at j = hi(i); its H feeds (i+1, j+1) and F only to its right, right
//     of the band again, and x, y only cells right of it in the next
//     strip.  (NEG in the kept Eh = E + i*ge reads as NEG - i*ge, which
//     like NEG stays below every H - go: the same H and E.)
//   - on both sides T leaves the record.
// A strip's cells at rows above a_k lie right of the band, so it starts
// from E = NEG (H[-1,*] = 0 and E[-1,*] = NEG at row 0 too) and from x =
// 0 for the first row's left neighbour where a_k = 0.  Where a_k > 0 its
// first row takes x of row a_k - 1 from strip k - 1 (that cell, j0 - 1 at
// row a_k - 1, is lane W - 1 of the band): chunks of 32 rows start at rows
// = prepad - W mod 32, so that a strip's first chunk opens with row a_k -
// 1 and reads it with the rest.  Rows at or past b_{k-1} take y = NEG and
// any x from strip k - 1 (its columns lie left of the band there; x of
// row b_{k-1} - 1, which row b_{k-1} needs, is in the carry).
//
// Strips that are not run.
//   - Strips wholly left of column 0 (query columns below 0 read code 7,
//     which scores 0 against every code).  There H = 0 and T = 0: by
//     induction over the rows, a cell (i, j < 0) has T = H[i-1,j-1] + 0 =
//     0, Ein <= -go (an E is at most H - go of a cell above), F <= 0 (a
//     prefix of H0 = 0 at columns j' < j, less go), so H0 = H = 0.  So the
//     first strip from column 0 starts from x = 0 and, in place of y =
//     max over j' < 0 in the band of j'*ge, from NEG: F from that y is at
//     most -go <= 0 <= H0, so H is the same, and so is every y it hands
//     on.  A T of 0 never beats the record's start (best 0, strictly), and
//     a window in which no T is positive returns (0, 0, -prepad) either
//     way.
//   - Strips at or past ceil(qend / SW), qend one past the window's last
//     column whose code is not 7 (sought from the end, as sw_full.cu's
//     strips do): as there, every H of the band is at most the maximum of
//     0 and the T of the cells above and to its left, so a cell at or
//     past qend has T = H[i-1,j-1] at most the best of the rows above it:
//     it neither raises the maximum nor is the first to reach it, and it
//     feeds no cell to its left.
//   - Strips whose rows start at or past the window's rows (min(slen, S)):
//     a window with slen 0 (the pad reads of a batch) runs no strip.
//
// Many CTAs a window.  A CTA runs a group of NW consecutive strips as
// sw_full.cu's wavefront (sw_wave_kernel) runs a window: strip g * NW + w
// on warp w, its chunk c (rows [32 c - sh, 32 c - sh + 32)) at step c -
// c0 + w, c0 the group's first chunk, the carry to the next warp through
// a ring in shared memory (two parities of 32 slots a warp, one block
// barrier a step).  Group g + 1's first strip reads group g's last strip's
// carry from device memory, in place, from one int2 column of S rows a
// window (carry[b][i]: the last warp writes row i NW - 1 >= 1 steps after
// its warp 0 read it, or, NW = 1, after reading the whole chunk).  A flag a
// chunk names the group whose input the chunk holds: the writer's lane
// 31 stores the chunk's carry, then sets the flag to g + 1 with a release
// store; warp 0 of group g + 1 waits with acquire loads (and __nanosleep
// back-off) until it reaches g + 1, then reads.  Groups are dealt out by
// an atomic ticket in the order (group, window): ticket n is group n / B
// of window n % B, so that the few windows of a batch of long reads run
// side by side and a waiter only ever waits on a group that a CTA already
// running took (ticket n - B): no co-residency and no cooperative launch
// is needed.  The ticket, the flags and the record chain's words are
// cleared on the stream before each launch (sw_band_strips_launch), so
// nothing left by an earlier launch or scratch group reads as ready.  A
// wait longer than STRIPS_WAIT_NS traps (a deadlock raises, it does not
// hang the card).
//
// Tracking: each lane keeps one record for its strip, sw_full.cu's
// two-part record (a row's max of T over the lane's in-band cells,
// strictly above the best so far, names its lowest column), so T is any
// int32 (the int32 DP's bound, ops/sw.py check_score_cap, is the only
// limit).  The CTA reduces its lanes' records (highest T, then lowest row,
// then lowest column) and chains them: group g's thread 0 waits for the
// window's record flag to reach g, merges group g - 1's record by the same
// rule and hands on; the window's last group writes (best, ti, tj), in
// query coordinates.  sw_full.cu's proof carries over, because the
// reference's order over (row, band lane) is its order over (row, column):
// tj = ti + lane - prepad is monotone in the lane.  Score-only: the max of
// T goes the same way.  A window with no strip returns (0, 0, -prepad).
//
// What bounds it.  Strip k + 1 starts SW rows below strip k and a chunk
// behind it, so a window's last strip ends ~S + 32 Q / SW row steps after
// its first strip starts: a chain of about S row steps, each a warp's row
// (latency: the in-lane prefix max, a 5-step shuffle scan, F, H and E,
// the record) more than the SM's integer rate, which the ~(W + SW) / SW
// strips of a window at work at once share.  So STRIPS_C = 8 columns a
// lane, strips of 256: a shorter row on the chain than sw_full's 16
// columns (on the 3 windows of a 700 kb read 1.5-1.9x faster than 16; 4
// columns no faster, PERF.md), at ~1 more instruction a cell.
// tests/test_torch_band_strips.py renders the kernel step by step in
// numpy (band_strips_render) and holds it against the plain version.

constexpr int STRIPS_C = 8;                       // columns a lane
constexpr int STRIPS_W = 32 * STRIPS_C;           // columns a strip
constexpr int STRIPS_WARPS = 4;                   // most warps a CTA (NW)
constexpr int STRIPS_WSTRIDE = 8 * STRIPS_W + 128;   // a warp's int8 profile
constexpr unsigned long long STRIPS_WAIT_NS = 20000000000ull;   // 20 s
// scratch words (int32) of a launch of B windows of S rows: the ticket and
// padding, then per window 8 (its record chain: flag, best, row, column,
// max) and S / 32 + 2 chunk flags; ops/sw.py band_strip_flag_words
constexpr int STRIPS_HEAD = 8;
__host__ __device__ inline long long strips_flag_words(long long B,
                                                       long long S) {
  return STRIPS_HEAD + B * (8 + S / 32 + 2);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until *p >= want (acquire); trap after STRIPS_WAIT_NS.
__device__ __noinline__ void strips_wait(const int* p, int want) {
  if (ld_acquire(p) >= want) return;
  const unsigned long long t0 = global_ns();
  unsigned ns = 32;
  for (unsigned n = 1;; ++n) {
    __nanosleep(ns);
    if (ld_acquire(p) >= want) return;
    if (ns < 1024) ns <<= 1;
    if ((n & 255) == 0 && global_ns() - t0 > STRIPS_WAIT_NS) __trap();
  }
}

// The lowest c with T[c] == m (m the max of T): the record's column.
template <int C>
__device__ __forceinline__ int strips_first(const int (&T)[C], int m) {
  int c0 = C - 1;
#pragma unroll
  for (int c = C - 2; c >= 0; --c) c0 = T[c] == m ? c : c0;
  return c0;
}

// One CTA of NW = blockDim.x / 32 warps a ticket (header); grid B * G,
// G the groups of a window the host counts.  Dynamic shared memory: the
// carry ring, NW x 2 x 32 int2, then (int8 instances) a profile of
// STRIPS_WSTRIDE bytes a warp.  Every warp runs every step, so every warp
// reaches every barrier.  Up to 255 registers a thread.
template <bool TRACK, bool WIDE>
__global__ void __launch_bounds__(STRIPS_WARPS * 32, 1)
sw_band_strips_kernel(const int* __restrict__ q, const int* __restrict__ subj,
                      const int* __restrict__ slens,
                      const int* __restrict__ matrix, int B, int Q, int S,
                      int W, int prepad, int go, int ge, int2* carry,
                      int* flags, int* __restrict__ best_out,
                      int* __restrict__ ti_out, int* __restrict__ tj_out) {
  // carry and flags are written and read again by other CTAs: no
  // __restrict__, so that no load of them takes the read-only path
  constexpr int C = STRIPS_C, L = 32, SW = STRIPS_W;
  constexpr int PITCH = L * C;         // sw_full's strip profile layout
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ int smat[64];
  __shared__ int red[STRIPS_WARPS][3];  // the warps' records (or maxima)
  __shared__ int ticket, qlast;
  const int NW = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < 64; i += blockDim.x) smat[i] = matrix[i];
  if (threadIdx.x == 0) {
    ticket = atomicAdd(flags, 1);
    qlast = 0;
  }
  __syncthreads();
  const int g = ticket / B, b = ticket % B;
  const int rows = max(0, min(slens[b], S));
  // strips whose rows are not empty: a_k < rows
  const long long num = (long long)rows + W - 1 - prepad;
  const int nrowk = rows > 0 && num > 0 ? (int)((num + SW - 1) / SW) : 0;
  const int k0 = g * NW;
  const bool none = k0 >= nrowk;       // block-uniform
  const int* qrow = q + (size_t)b * Q;
  if (!none) {
    // qend: one past the window's last column whose code is not 7 (pad),
    // sought from the end, the block's width of columns at a time
    for (int base = Q - static_cast<int>(blockDim.x);; base -= blockDim.x) {
      const int j = base + threadIdx.x;
      const bool real = j >= 0 && (qrow[j] & 7) != 7;
      const int hit = __reduce_max_sync(FULL, real ? j + 1 : 0);
      if (lane == 0 && hit) atomicMax(&qlast, hit);
      if (__syncthreads_or(real) || base <= 0) break;
    }
  }
  const int nstrip = none ? 0 : min((qlast + SW - 1) / SW, nrowk);
  if (k0 >= nstrip) {                  // this group holds no strip
    if (g == 0 && threadIdx.x == 0) {
      best_out[b] = 0;
      if (TRACK) {
        ti_out[b] = 0;
        tj_out[b] = -prepad;
      }
    }
    return;
  }
  int* wrec = flags + STRIPS_HEAD + 8 * (size_t)b;   // the record chain
  int* cflag = flags + STRIPS_HEAD + 8 * (size_t)B +
               (size_t)b * (S / 32 + 2);             // the chunk flags
  const int sh = ((W - prepad) % 32 + 32) % 32;      // chunk c: 32 c - sh
  auto a_of = [&](int k) {
    return (int)max(0ll, (long long)k * SW + prepad - W + 1);
  };
  auto b_of = [&](int k) {
    return (int)min((long long)rows, (long long)k * SW + SW + prepad);
  };
  auto chunk = [&](int r) { return (r + sh) >> 5; };
  const int wl = min(NW, nstrip - k0) - 1;           // the last live warp
  const int c0 = chunk(a_of(k0));
  const int nsteps = b_of(k0 + wl) > a_of(k0 + wl)
                         ? chunk(b_of(k0 + wl) - 1) - c0 + wl + 1 : 0;
  const int k = k0 + w;
  const bool live = w <= wl;
  const int ak = a_of(k), bk = b_of(k);
  const int clo = chunk(ak), chi = bk > ak ? chunk(bk - 1) : clo - 1;
  const int bprev = k > 0 ? b_of(k - 1) : 0;
  // rows [mid_lo, mid_hi] of this strip lie wholly inside the band
  const int mid_lo = (int)max((long long)INT_MIN / 2,
                              (long long)k * SW + SW + prepad - W);
  const int mid_hi = k * SW + prepad;
  const bool out = live && k + 1 < nstrip && lane == 31;  // carry onward

  int2* ring = reinterpret_cast<int2*>(dyn);        // [NW][2][32]
  signed char* pbase = reinterpret_cast<signed char*>(dyn) +
      NW * 2 * 32 * sizeof(int2) + (WIDE ? 0 : w * STRIPS_WSTRIDE + lane * 4);
  const int* srow = subj + (size_t)b * S;
  int2* crow = carry + (size_t)b * S;
  const int jl = k * SW + lane * C;    // the lane's first column
  const int jlge = jl * ge;
  int H[C], Eh[C], qc[C];              // Eh = E + i*ge
  if (live) {
#pragma unroll
    for (int cc = 0; cc < C; ++cc) {
      const int j = jl + cc;
      qc[cc] = j < Q ? qrow[j] & 7 : 7;
      H[cc] = 0;
      Eh[cc] = NEG;                    // E = NEG above the strip's rows
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
          *reinterpret_cast<unsigned*>(pbase + s * PITCH + w4 * (L * 4)) =
              x;
        }
      __syncwarp();
    }
  }
  int lbest = 0, lcol = 0, li = 0;     // TRACK: this lane's record
  int acc = 0;                         // !TRACK: this lane's max of T
  int hprev = 0;                       // x of the row above (lane 0 reads)
  for (int t = 0; t < nsteps; ++t) {
    const int c = c0 + t - w;          // this warp's chunk at step t
    if (live && c >= clo && c <= chi) {
      const int rb = c * 32 - sh;
      const bool first = c == clo;
      const int ilo = max(rb, ak), ihi = min(rb + 32, bk);
      // the carry rows this chunk takes from strip k - 1: x of row a_k - 1
      // (the chunk's first slot) in the strip's first chunk, then its rows
      // up to strip k - 1's last; strip 0 takes H = 0 left, no prefix
      const int need_lo = first && ak > 0 ? ak - 1 : ilo;
      const int need_hi = min(ihi, bprev);
      const int r = rb + lane;
      int2 cv = make_int2(0, NEG);
      if (k > 0 && need_lo < need_hi) {
        if (w > 0) {                   // warp w - 1, one step ago
          if (r >= need_lo && r < need_hi)
            cv = ring[((w - 1) * 2 + ((t - 1) & 1)) * 32 + lane];
        } else {                       // group g - 1's last strip
          strips_wait(cflag + c, g);
          if (r >= need_lo && r < need_hi) cv = crow[r];
        }
      }
      if (first && ak > 0) hprev = __shfl_sync(FULL, cv.x, 0);
      const int scode = r >= 0 && r < S ? srow[r] & 7 : 7;
      int2* rring = ring + (w * 2 + (t & 1)) * 32;   // to warp w + 1
      // one pass over the chunk's rows; EDGE masks the cells outside the
      // band, the chunks wholly inside it run without
      auto rows_of = [&](auto edge) {
        constexpr bool EDGE = decltype(edge)::value;
        for (int i = ilo; i < ihi; ++i) {
          const int ii = i - rb;
          const int sc = __shfl_sync(FULL, scode, ii);
          const signed char* prow = pbase + sc * PITCH;
          const int* mrow = smat + 8 * sc;   // WIDE
          const int nige = -i * ge;          // E = Eh + nige
          const int ci = (i + 1) * ge - go;  // Eh' = max(Eh, H + ci)
          // columns jl + cc left of the band: cc < dl; right: cc >= dl + W
          const int dl = i - prepad - jl;

          int hleft = __shfl_up_sync(FULL, H[C - 1], 1);
          if (lane == 0) hleft = hprev;      // H[i-1, j0-1] of strip k - 1
          hprev = __shfl_sync(FULL, cv.x, ii);
          const int pmc = __shfl_sync(FULL, cv.y, ii);
          int T[C], H0[C], run[C];
          int rr = NEG;
#pragma unroll
          for (int cc = 0; cc < C; ++cc) {
            const int x = WIDE ? mrow[qc[cc]]
                               : prow[(cc / 4) * (L * 4) + cc % 4];
            T[cc] = (cc == 0 ? hleft : H[cc - 1]) + x;
            H0[cc] = addmax_relu(Eh[cc], nige, T[cc]);
            if (EDGE && cc < dl) H0[cc] = NEG;    // left of the band
            rr = addmax(H0[cc], cc * ge, rr);     // prefix max in the lane
            run[cc] = rr;
          }
          // inclusive prefix max of the lane totals, in window columns,
          // the strips to the left folded in at lane 0
          int incl = rr + jlge;
          if (lane == 0) incl = max(incl, pmc);
#pragma unroll
          for (int d = 1; d < L; d <<= 1)
            incl = max(incl, __shfl_up_sync(FULL, incl, d));
          int excl = __shfl_up_sync(FULL, incl, 1);
          excl = (lane == 0 ? pmc : excl) - jlge;
#pragma unroll
          for (int cc = 0; cc < C; ++cc) {
            const int cm = cc == 0 ? excl : max(excl, run[cc - 1]);
            const int hn = addmax(cm, -(go + (cc - 1) * ge), H0[cc]);
            Eh[cc] = addmax(hn, ci, Eh[cc]);
            if (EDGE && cc >= dl + W) Eh[cc] = NEG;   // right of the band
            H[cc] = hn;
          }
          if (out) {                         // the carry to strip k + 1
            const int2 v = make_int2(H[C - 1], incl);
            if (w + 1 < NW)
              rring[ii] = v;
            else
              crow[i] = v;
          }
          if (EDGE) {                        // T of the band's cells only
#pragma unroll
            for (int cc = 0; cc < C; ++cc)
              if (cc < dl || cc >= dl + W) T[cc] = INT_MIN;
          }
          const int m = row_max<C>(T);
          if (TRACK) {                       // the two-part record
            if (m > lbest) {
              lcol = jl + strips_first<C>(T, m);
              lbest = m;
              li = i;
            }
          } else {
            acc = max(acc, m);
          }
        }
      };
      if (ilo < mid_lo || ihi - 1 > mid_hi)
        rows_of(std::true_type{});
      else
        rows_of(std::false_type{});
      if (out && w == NW - 1)          // the chunk's carry is out
        st_release(cflag + c, g + 1);
    }
    __syncthreads();
  }

  // the CTA's record: over the warp, then over the warps; then the chain
  int bt = lbest, bi = li, bj = lcol;
  if (TRACK) {
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
  } else {
    bt = __reduce_max_sync(FULL, acc);
  }
  if (lane == 0) {
    red[w][0] = bt;
    red[w][1] = bi;
    red[w][2] = bj;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int v = 1; v < NW; ++v) {
    const int ot = red[v][0], oi = red[v][1], oj = red[v][2];
    if (ot > bt || (TRACK && ot == bt &&
                    (oi < bi || (oi == bi && oj < bj)))) {
      bt = ot;
      bi = oi;
      bj = oj;
    }
  }
  if (g > 0) {                         // group g - 1's record
    strips_wait(wrec, g);
    const int ot = wrec[1], oi = wrec[2], oj = wrec[3];
    if (ot > bt || (TRACK && ot == bt &&
                    (oi < bi || (oi == bi && oj < bj)))) {
      bt = ot;
      bi = oi;
      bj = oj;
    }
  }
  if (g == (nstrip - 1) / NW) {        // the window's last group
    const bool hit = bt > 0;           // else no row beat the initial 0
    best_out[b] = hit ? bt : 0;
    if (TRACK) {
      ti_out[b] = hit ? bi : 0;
      tj_out[b] = hit ? bj : -prepad;
    }
  } else {
    wrec[1] = bt;
    wrec[2] = bi;
    wrec[3] = bj;
    st_release(wrec, g + 1);
  }
}
