// Batched full-matrix affine-gap local Smith-Waterman for Hopper (sm_90a).
//
// Replaces the Pallas kernel built by _make_sw_kernel in
// smalt_tpu/ops/sw.py:60 and launched by _sw_batch_call (sw.py:180):
// TRACK=true is _sw_kernel_track, the one kernel of the `map --fast`
// device step; TRACK=false is _sw_kernel, the score-only instance.
//
// What it computes, per window b (all int32, the same arithmetic as the
// TPU kernel and as sw_score_ref in sw.py):
//   T[i,j]  = H[i-1,j-1] + matrix[subj[i], q[j]]      (H[-1,*] = H[*,-1] = 0)
//   H0[i,j] = max(T, E[i-1,j], 0)
//   F[i,j]  = cummax_{j'<j}(H0[i,j'] + j'*ge) - go - (j-1)*ge
//   H[i,j]  = max(H0, F),   E[i,j] = max(E[i-1,j] - ge, H[i,j] - go)
// over subject rows i < min(slen, S) (rows at or past slen leave H and E
// frozen and count for nothing, so the loop simply stops there).  The
// score is max(0, max T).  TRACK also returns the row-major-first argmax
// cell: a row updates the running best (which starts at 0) only when its
// row max is strictly greater, and then names the lowest column that
// reaches it.
//
// What bounds it on an H100: the integer ALU's instruction rate, not memory.
// The main path scores 12,288 windows of Q = 112 against S = 128 subject
// rows per step, 176 M cells, from ~7 MB of codes.  An SM starts 64
// int32 lane-instructions a clock on its integer ALU, so every ALU
// instruction a cell costs 176 M / (132 * 64 * 1.98 GHz) = 10.5 us at
// that shape.  The recurrence itself needs 5 max operations a cell
// (ops/bounds.py counts these for the kernel's bound): H0, the running
// prefix max, its merge with the lanes to the left, H and E.  This
// kernel runs those 5 on the ALU, plus half an instruction a cell for
// the row's maximum; the add of T, the tracking key and the score lookup
// go to the multiply-add pipe and the shared-memory pipe beside it.  A
// lane and row also cost ~15 instructions that do not grow with the
// columns a lane holds (the shuffles of the scan among them).
//
// Design, and what each part is for.
//   - A window runs on L = 8 lanes up to 128 columns (four windows a
//     warp), 16 lanes up to 192, 32 lanes above, lane l of the group
//     holding the C consecutive columns [l*C, l*C + C) of H, E in
//     registers.  C is exact where it matters (14 for Q = 112, 16 for
//     128, 10 for 160, where 32 lanes padded 112 to 128 and 160 to 192
//     columns), the per-row instructions are shared by up to four times
//     the columns, and the scan of lane totals takes 3 or 4 shuffle
//     steps, not 5.  The windows of a warp run the same number of rows,
//     the longest of their subject lengths: every shuffle names the full
//     warp (a constant mask, so no check of who is present) with width L,
//     and a window's rows at or past its own length compute on but never
//     reach its result.
//   - Hopper's 3-input integer instructions carry the recurrence, each
//     exact in int32: H0 = max(E, T, 0) is one __viaddmax_s32_relu, the
//     running prefix max, H = max(H0, F) and E are one __viaddmax_s32
//     each.  To make E a single instruction the kernel keeps
//     Eh = E + i*ge instead of E (i the row): E' = max(E - ge, H - go)
//     becomes Eh' = max(Eh, H + ((i+1)*ge - go)) and the row's -i*ge is
//     folded into the H0 instruction.  The prefix max runs in lane-local
//     coordinates (column c of the lane, not l*C + c), so its constants
//     c*ge and -(go + (c-1)*ge) are the same in every lane; the lane's
//     offset l*C*ge is added to its total before the scan and taken off
//     the scan's result, twice a row instead of twice a cell.
//   - The score lookup costs the ALU nothing: at its start a window
//     writes its query profile, prof[s][j] = matrix[s][q[j]] as int8,
//     to shared memory, and a cell's score is then one sign-extending
//     byte load at (row s of the profile) + a constant.  The profile is
//     laid out so that the lanes of a warp read 32 different banks
//     (below).  That needs matrix entries in int8.  A matrix outside
//     int8 runs the WIDE instances, which build no profile and read a
//     cell's score from the 8x8 int32 matrix in shared memory,
//     smat[8 * s + q[j]], with the query codes in registers: one address
//     computation a cell more on the ALU (ops/sw.py decides on the host,
//     from the range device_matrix recorded, and passes `wide`).
//   - Tracking without a warp reduction in the row loop.  Each lane keeps
//     its own first-best cell over its own columns: key = T*256 + 255 - c
//     orders a row's cells by T and then by lowest column, the lane takes
//     the row's max key (3-input max), and updates when that key's T is
//     strictly greater than the lane's best so far.  (The 256 arrives in
//     a register, so that the key is one multiply-add and not a shift-add
//     on the ALU.)  One reduction after the loop picks the highest T,
//     then the lowest row, then the lowest column.  This equals the
//     reference's rule.  Proof: let M be the maximum of T over the
//     window.  If M <= 0 no row is ever strictly greater than the running
//     best 0, the reference returns (0, 0, 0), and so does the reduction
//     (no lane ever updates).  If M > 0 the reference's best becomes M at
//     the first row i* whose row max is M (later rows are not strictly
//     greater) and names that row's lowest column with T = M: the
//     lexicographic minimum (i, j) over the cells with T = M.  A lane's
//     record, under the same strict test on its own columns, is the
//     lexicographic minimum over ITS cells with T equal to its own
//     maximum; the lanes whose maximum is M hold between them every cell
//     with T = M, so the minimum of their records by (i, j) is the global
//     one.  (ops/sw.py admits a window only when max|entry| * min(Q, S)
//     < 2^23, so |T| < 2^23 for every cell, padding included, and with
//     C < 256 the key fits and c is recovered from its low byte.)
//   - Query columns past Q are padded with code 7, which scores 0 against
//     every subject code.  Padded columns lie to the right of every real
//     column, so they never feed a real cell, and their T = H[i-1,j-1] is
//     at most the maximum of T over the rows above: a padded cell can tie
//     M but is never the first to reach it.  So padding to L*C here, where
//     the TPU padded to 128, leaves (best, ti, tj) unchanged.
//   - Subject codes arrive L rows at a time, one per lane, and are
//     broadcast with __shfl_sync.  No global memory is touched inside the
//     row loop.
//
// Queries longer than 512 columns (sw_full_strip_launch): column strips.
// The (C, L) instances above keep a window's whole query in one warp's
// registers, 16 columns a lane at most.  Past that, one warp runs the
// window's query in strips of STRIP_W = 32 * 16 columns, lane l holding
// columns k*STRIP_W + l*16 + [0, 16) of strip k: strip 0 over all of the
// window's rows, then strip 1 over all of them, and so on, with the row
// loop of the 32-lane instance inside.  Only two values a row cross a
// strip boundary, and strip k leaves them for strip k + 1 in a scratch
// buffer carry[b][i] = {x, y} of the wrapper's:
//   x = H[i, j0 - 1], the last column's H, from which the next strip's
//       first column takes T[i + 1, j0] = H[i, j0 - 1] + w;
//   y = max over j' < j0 of (H0[i, j'] + j' * ge), the running prefix max
//       from which F continues into the next strip (its carry is H0, the
//       value before F, as the recurrence at the top says).
// E stays in its column, and so inside its strip.  The strip's global
// column offset j0 enters the lane's offset j0 * ge of the prefix max's
// lane-local coordinates; lane 0 folds y into its total before the scan
// (so lane 31's inclusive total is the next strip's y) and starts its
// exclusive value from y, where strip 0 starts from NEG.  Padded columns
// (code 7) exist only in the last strip, right of every real column.
// The carry is 8 bytes a row and strip, read 32 rows at a time (one
// coalesced load a lane, broadcast by shuffle as the subject codes are)
// and written by lane 31 a row: at Q = 2,048, S = 2,304 and B = 4,096
// that is 453 MB over three strip boundaries, 0.14 ms at the card's
// memory rate against 5.8 ms of the bound's integer work, so it lives
// in device memory at every S and not in shared memory.
// Tracking: a lane's strict-greater record is the first of its best
// cells in the order it visits them, which is row-major within a strip
// but not across strips.  So a lane keeps one record a strip (the proof
// above holds strip by strip, over the lane's columns in that strip) and
// merges it into its running record by the same rule the reduction
// after the loop applies: highest T, then lowest row, then lowest
// (global) column.  The lexicographic minimum over the lanes' records of
// the cells with T = M is then the reference's cell, as above.

#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr int WARPS = 4;               // warps per block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int addmax(int a, int b, int c) {
  return __viaddmax_s32(a, b, c);                  // max(a + b, c)
}
__device__ __forceinline__ int addmax_relu(int a, int b, int c) {
  return __viaddmax_s32_relu(a, b, c);             // max(a + b, c, 0)
}
__device__ __forceinline__ int max3(int a, int b, int c) {
  return __vimax3_s32(a, b, c);
}

// The max over c of key(c) = T[c] * kmul + 255 - c, kmul = 256.
template <int C>
__device__ __forceinline__ int row_key(const int (&T)[C], int kmul) {
  int m = T[0] * kmul + 255;
#pragma unroll
  for (int c = 1; c + 1 < C; c += 2)
    m = max3(m, T[c] * kmul + (255 - c), T[c + 1] * kmul + (254 - c));
  if (C % 2 == 0) m = max(m, T[C - 1] * kmul + (256 - C));
  return m;
}

template <int C>
__device__ __forceinline__ int row_max(const int (&T)[C]) {
  int m = T[0];
#pragma unroll
  for (int c = 1; c + 1 < C; c += 2) m = max3(m, T[c], T[c + 1]);
  if (C % 2 == 0) m = max(m, T[C - 1]);
  return m;
}

// The second launch bound (one block a SM at least) lets ptxas take the
// registers it asks for: without it the build spilled 8 bytes.  WIDE:
// scores from smat (int32) a cell, no int8 profile.
template <int C, int L, bool TRACK, bool WIDE>
__global__ void __launch_bounds__(WARPS * 32, 1)
sw_full_kernel(const int* __restrict__ q, const int* __restrict__ subj,
               const int* __restrict__ slens,
               const int* __restrict__ matrix, int B, int Q, int S,
               int go, int ge, int kmul, int* __restrict__ best_out,
               int* __restrict__ ti_out, int* __restrict__ tj_out) {
  static_assert(L == 8 || L == 16 || L == 32, "lanes a window");
  static_assert(C >= 1 && C < 256, "the key keeps the column in a byte");
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
    if (TRACK) {
      const int m = row_key<C>(T, kmul);
      if (m > lthr && i < slen) {      // T strictly above the lane's best
        lkey = m;
        li = i;
        lthr = m | 255;
      }
    } else {
      const int m = row_max<C>(T);
      if (i < slen) acc = max(acc, m);
    }
  }
  if (TRACK) {
    // highest T, then lowest row, then lowest column, over the group
    int bt = lkey >> 8, bi = li, bj = j0 + 255 - (lkey & 255);
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

template <int C, int L>
int launch(bool track, bool wide, const int* q, const int* subj,
           const int* slens, const int* matrix, int B, int Q, int S, int go,
           int ge, int* best, int* ti, int* tj, cudaStream_t stream) {
  constexpr int PER_BLOCK = WARPS * (32 / L);      // windows a block
  const dim3 grid((B + PER_BLOCK - 1) / PER_BLOCK), block(WARPS * 32);
  auto kernel = track ? (wide ? sw_full_kernel<C, L, true, true>
                              : sw_full_kernel<C, L, true, false>)
                      : (wide ? sw_full_kernel<C, L, false, true>
                              : sw_full_kernel<C, L, false, false>);
  kernel<<<grid, block, 0, stream>>>(q, subj, slens, matrix, B, Q, S, go, ge,
                                     256, best, ti, tj);
  return static_cast<int>(cudaGetLastError());
}

constexpr int STRIP_C = 16;                 // columns a lane in a strip
constexpr int STRIP_W = 32 * STRIP_C;       // columns a strip
constexpr int MAX_STRIP_Q = 16384;          // ops/sw.py MAX_STRIP_Q

// One warp a window, the query in strips of STRIP_W columns (header).
template <bool TRACK, bool WIDE>
__global__ void __launch_bounds__(WARPS * 32, 1)
sw_strip_kernel(const int* __restrict__ q, const int* __restrict__ subj,
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
  __shared__ __align__(16) signed char prof[WIDE ? 16 : WARPS * WSTRIDE];
  signed char* pbase = prof + (WIDE ? 0 : wib * WSTRIDE + lane * 4);

  const int* srow = subj + (size_t)b * S;
  int2* crow = carry + (size_t)b * S;
  const int rows = min(slens[b], S);
  const int nstrip = (Q + STRIP_W - 1) / STRIP_W;
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
    if (!WIDE) {
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
      const int* mrow = smat + 8 * sc;   // WIDE
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
        const int w = WIDE ? mrow[qc[c]] : prow[(c / 4) * (L * 4) + c % 4];
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
      const int st = lkey >> 8, sj = j0 + 255 - (lkey & 255);
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

}  // namespace

// Scores B windows on `stream`.  q [B,Q], subj [B,S], slens [B] and
// matrix [8,8] are contiguous int32 device arrays; best (and, with
// track, ti and tj) are int32 [B] outputs.  A query of length Q runs
// the first instantiated (C, L) below with L * C >= Q (Q <= 512).
// wide != 0 (a matrix entry outside -128..127) runs the WIDE instance;
// ops/sw.py admits only max|entry| * min(Q, S) < 2^23.  Returns the CUDA
// error of the launch (0 on success), or -1 when Q is out of range.
extern "C" int sw_full_launch(const void* q, const void* subj,
                              const void* slens, const void* matrix, int B,
                              int Q, int S, int go, int ge, int track,
                              void* best, void* ti, void* tj, void* stream,
                              int wide) {
  if (Q < 1 || Q > 32 * 16 || S < 0 || B < 0) return -1;
  if (B == 0) return 0;
  auto* qp = static_cast<const int*>(q);
  auto* sp = static_cast<const int*>(subj);
  auto* lp = static_cast<const int*>(slens);
  auto* mp = static_cast<const int*>(matrix);
  auto* bp = static_cast<int*>(best);
  auto* ip = static_cast<int*>(ti);
  auto* jp = static_cast<int*>(tj);
  auto st = static_cast<cudaStream_t>(stream);
  const bool tr = track != 0, wd = wide != 0;
#define SWF_TRY(C, L)                                                     \
  if (Q <= (C) * (L))                                                     \
    return launch<C, L>(tr, wd, qp, sp, lp, mp, B, Q, S, go, ge, bp, ip, jp, \
                        st)
  // 8 lanes a window to Q = 128, 16 to 192, 32 above
  SWF_TRY(4, 8); SWF_TRY(8, 8); SWF_TRY(12, 8); SWF_TRY(14, 8);
  SWF_TRY(16, 8); SWF_TRY(10, 16); SWF_TRY(12, 16);
  SWF_TRY(8, 32); SWF_TRY(10, 32); SWF_TRY(12, 32); SWF_TRY(14, 32);
  SWF_TRY(16, 32);
#undef SWF_TRY
  return -1;
}

// The same for a query of STRIP_W < Q <= MAX_STRIP_Q columns, in column
// strips (header).  carry is an int32 [B, S, 2] device scratch buffer the
// kernel writes before it reads (the caller need not clear it).  Returns
// the CUDA error of the launch, or -1 when Q is out of range.
extern "C" int sw_full_strip_launch(const void* q, const void* subj,
                                    const void* slens, const void* matrix,
                                    int B, int Q, int S, int go, int ge,
                                    int track, void* best, void* ti, void* tj,
                                    void* stream, int wide, void* carry) {
  if (Q <= STRIP_W || Q > MAX_STRIP_Q || S < 0 || B < 0) return -1;
  if (B == 0) return 0;
  const dim3 grid((B + WARPS - 1) / WARPS), block(WARPS * 32);
  auto kernel = track ? (wide ? sw_strip_kernel<true, true>
                              : sw_strip_kernel<true, false>)
                      : (wide ? sw_strip_kernel<false, true>
                              : sw_strip_kernel<false, false>);
  auto st = static_cast<cudaStream_t>(stream);
  kernel<<<grid, block, 0, st>>>(
      static_cast<const int*>(q), static_cast<const int*>(subj),
      static_cast<const int*>(slens), static_cast<const int*>(matrix), B, Q,
      S, go, ge, 256, static_cast<int2*>(carry), static_cast<int*>(best),
      static_cast<int*>(ti), static_cast<int*>(tj));
  return static_cast<int>(cudaGetLastError());
}
