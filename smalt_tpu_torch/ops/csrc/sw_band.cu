// Batched banded affine-gap local Smith-Waterman for Hopper (sm_90a).
//
// Replaces the Pallas kernel built by _make_swb_kernel in
// smalt_tpu/ops/sw.py:269 and launched by _swb_batch_call (sw.py:397):
// TRACK=true is _swb_kernel_track, the long-read kernel of the
// `map --fast` device step (reads padded past 512 bp); TRACK=false is
// _swb_kernel, the score-only instance.
//
// What it computes, per window b (all int32, the same arithmetic as the
// TPU kernel and as sw_band_score_ref in sw.py), in the skewed band frame:
// band lane t of subject row i holds query column j = i - prepad + t, and
// reads code 7 (which scores 0) where j falls outside [0, Q):
//   T[i,t]   = H[i-1,t] + matrix[subj[i], q[j]]      (H[-1,*] = 0)
//   Ein[i,t] = E[i-1,t+1], NEG at t = W-1            (E[-1,*] = NEG)
//   H0[i,t]  = max(T, Ein, 0)
//   F[i,t]   = cummax_{t'<t}(H0[i,t'] + t'*ge) - go - (t-1)*ge
//   H[i,t]   = max(H0, F),   E[i,t] = max(Ein - ge, H - go)
// over subject rows i < min(slen, S) (later rows leave H and E frozen and
// count for nothing, so the loop stops there).  The diagonal predecessor
// stays in its lane because the band slides one query column per row.
// The score is max(0, max T) over every band lane, the out-of-query lanes
// included: they stay in the max and the argmax, as on the TPU.  TRACK
// also returns the row-major-first argmax cell: a row updates the running
// best (which starts at 0) only when its row max is strictly greater, and
// then names its lowest lane; the cell is returned in query coordinates,
// (ti, tj) = (i, i + lane - prepad), and a window in which no T is
// positive returns row 0, band lane 0: (best, ti, tj) = (0, 0, -prepad).
//
// What bounds it on an H100: the rate at which a scheduler starts integer
// instructions, not memory.  The main path (1,500 bp reads, Q = 1504)
// scores 12,288 windows of W = 384 band lanes over S = 1,792 subject rows
// a step, 8.5 G band cells (6.6 G of them inside the query, which is what
// ops/bounds.py counts), from ~100 MB of int32 codes read once.  An SM
// starts 64 int32 lane-instructions a clock, so a warp's integer
// instruction holds its scheduler for two clocks, and the multiply-add
// pipe gives no second lane beside the ALU: moving the recurrence's adds
// there (a multiply-add by a register holding 1) made the kernel slower,
// and the measured time of every version of this kernel is its integer
// instructions a row times two clocks, within 10%.  The design therefore
// counts instructions.  The recurrence needs 5 max operations a cell (H0,
// the running prefix max, its merge with the lanes to the left, H and E);
// sw_band_warp_kernel spends 6.5 integer instructions a cell (those five,
// the add of T and half a 3-input max for the row's maximum; tracking adds
// one multiply-add for the key), one shared-memory load, and ~25
// instructions and 8 shuffles a thread and row that do not grow with C.
//
// Five kernels.  Bands up to 512 lanes (every band the mapping path makes
// for reads up to ~2.8 kb) run sw_band_warp_kernel: one warp a window, up
// to four windows a block.  Wider bands run the several-warps kernel,
// sw_band_multi_kernel (sw_band_multi.cuh), one window a block on up to 8
// warps of 12 lanes a thread or up to 20 warps of 20 lanes (W <= 12,800:
// reads up to ~68 kb); bands past ops/sw.py CLUSTER_BAND_W = TILED_BAND_W
// = 12,800 run sw_band_strips_kernel (sw_band_strips.cuh), the band in
// the query's own frame as column strips of 256 across many CTAs a
// window.  sw_band_cluster_kernel (sw_band_cluster.cuh), one thread-block
// cluster of up to 16 CTAs a window with the row exchanged in distributed
// shared memory (W <= 131,072), measured slower than the strip kernel at
// every width it held, so ops/sw.py routes it no band (chip_smoke.py holds
// it with the route raised).  In the first four a thread holds C
// consecutive band lanes [t0, t0 + C) of H and E in registers; lanes at or
// past W are padding that never reaches a real lane (E flows from the
// right, only through NEG, and F only to the right).  The strip kernel's
// lanes hold query columns, and its header says how the band's edges
// cross them.

// sw_band_warp_kernel, and what each part is for.
//   - Hopper's 3-input integer instructions carry the recurrence, each
//     exact in int32: H0 = max(Ein, T, 0) is one __viaddmax_s32_relu, the
//     running prefix max, H = max(H0, F) and E are one __viaddmax_s32
//     each.  To make E a single instruction the kernel keeps
//     Eh = E + (i+1)*ge instead of E (i the row that wrote it):
//     E' = max(Ein - ge, H - go) becomes Eh' = max(Ehin, H + ((i+1)*ge - go))
//     and the row's -i*ge is folded into the H0 instruction.  Ein comes
//     from lane t + 1 of the row above, the same row offset in every lane,
//     so the trick holds in the band frame as it does in sw_full.cu.  E
//     starts at NEG here (not 0), and lane W - 1 takes NEG every row: the
//     stand-in NEG - i*ge stays far below 0 and above INT_MIN because
//     sw_band_launch admits only (S + 1) * ge < 2^28, so H0, H and E come
//     out as with NEG itself (H >= 0 > NEG + go).  -i*ge and (i+1)*ge - go
//     are carried from row to row by one add each: written as products of
//     the row number, the compiler splits H0 into a multiply-add and a max.
//   - The prefix max runs in thread-local coordinates (lane c of the
//     thread, not t0 + c), so its constants c*ge and -(go + (c-1)*ge) are
//     the same in every thread; the thread's offset t0*ge is added to its
//     total before the shuffle scan and taken off the scan's result, twice
//     a row instead of twice a cell.  The constants arrive as a kernel
//     argument (LaneConsts) and are read from the constant bank as
//     operands: held in registers, or rebuilt every row as the compiler
//     chose to, they cost an instruction a cell.
//   - The score lookup costs no integer instruction: at its start a
//     window writes its query profile, prof[s][x] = matrix[s][q[x - prepad]]
//     as int8 (code 7 outside the query), to shared memory, 8 rows of
//     PW = S + 32*C bytes.  Band lane t of row i is column x = i + t, so a
//     thread's C scores are C consecutive bytes that start one byte further
//     each row: C sign-extending byte loads at (row of the subject code) +
//     a constant, from an offset that takes one add a row.  No query code
//     is held in registers or shuffled.  With C = 12 the threads of a warp
//     read 3 words apart, 32 different banks; with C = 8 and 16 two and
//     four threads share a bank, which the load pipe absorbs while the
//     integer rate is the limit.  The profile is what bounds occupancy at
//     the main shape (17 KB a window, 12 warps a SM) and what sets the
//     kernel's limit on S: a window whose profile passes 200 KB runs
//     sw_band_multi_kernel instead.  The profile needs matrix entries in
//     int8: a matrix outside int8 (`wide`, decided by ops/sw.py on the
//     host from the range device_matrix recorded) runs
//     sw_band_multi_kernel, whatever W, on its int16 profile or its int32
//     lookups.
//   - Tracking without a warp reduction in the row loop.  Each thread
//     keeps its own first-best cell over its own band lanes:
//     key = T*256 + 255 - c orders a row's cells by T and then by lowest
//     lane, the thread takes the row's max key (3-input max), and updates
//     when that key's T is strictly greater than the thread's best so far
//     (which starts at T = 0).  The 256 arrives in a register, so that the
//     key is one multiply-add and not a shift and an add.  One
//     reduction after the loop picks the highest T, then the lowest row,
//     then the lowest band lane t0 + c, and tj = ti + lane - prepad.
//     This equals the reference's rule.  Proof: let M be the maximum of T
//     over the window's band cells.  If M <= 0 no row is ever strictly
//     greater than the running best 0, the reference returns row 0 and
//     band lane 0, i.e. (0, 0, -prepad), and so does the reduction (no
//     thread ever updates).  If M > 0 the reference's best becomes M at
//     the first row i* whose row max is M (later rows are not strictly
//     greater) and names that row's lowest lane with T = M: the
//     lexicographic minimum (i, t) over the cells with T = M.  A thread's
//     record, under the same strict test on its own lanes, is the
//     lexicographic minimum over ITS cells with T equal to its own
//     maximum; the threads whose maximum is M hold between them every cell
//     with T = M, so the minimum of their records by (i, t) is the global
//     one.  The key holds |T| < 2^23 and C < 256, so c is recovered from
//     its low byte; with int8 entries that holds while 128 * min(Q, S)
//     < 2^23, and ops/sw.py (sw_band_instance) sends a tracked launch
//     past it to the several-warps kernel, whose records keep the value
//     and the lane apart.
//   - Padding lanes (band lanes at or past W, where 32 * C > W; the PAD
//     instances, so that the widths the mapping path makes, multiples of
//     128, carry none of this) are kept out of the max through H, not T:
//     after every row their H is set to HPAD = -2^22 and their E to NEG,
//     so their next T = HPAD + score has a key near -2^30, below every
//     real cell's (a real T is at least the lowest matrix entry, since
//     H >= 0, and that is at least -128 here) and far from overflow,
//     which NEG * 256 would not be.
//   - The warp's first and last lane take NEG in place of a neighbour's
//     value by a min with a per-lane bound (NEG or INT_MAX), not by a
//     select on a predicate that would be kept live through the loop.
//   - Subject codes arrive 32 rows at a time, one per lane, and are
//     broadcast with __shfl_sync.  E from lane t + 1 is a neighbouring
//     register and one __shfl_down_sync, the mirror image of sw_full.cu's
//     __shfl_up_sync of H.  No global memory is touched inside a row.
//
// The several-warps kernel (W > 512, a profile too large for shared
// memory, a matrix outside int8, a tracked window that could score 2^23,
// or (S + 1) * ge >= 2^28) has this kernel's cell, a rolling query
// profile in shared memory (int8, int16 for a matrix outside int8, or
// query codes and int32 lookups past int16), per-thread tracking records
// reduced after the loop (no packed key: any int32 score), and one
// __syncthreads a row for the exchange between its warps: its header,
// sw_band_multi.cuh, says how.  ptxas's registers and spills of every
// instance are printed by chip_smoke.py phase 2.

#include <climits>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr int HPAD = -(1 << 22);       // H of a padding lane (one warp)
constexpr int WARPS = 4;               // windows (warps) per block, W <= 512
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

// The gap constants of a thread's lanes: lane c adds c*ge to its H0 in the
// prefix max and takes -(go + (c-1)*ge) off the merged prefix for its F.
// A kernel argument, so that each is an operand from the constant bank
// and holds no register.
struct LaneConsts {
  int cge[16], fk[16];
};

// One warp a window, W <= 32 * C <= 512 (PAD: W < 32 * C); dynamic shared
// memory holds the block's query profiles, 8 * PW bytes a window,
// PW = S + 32 * C rounded up to a multiple of 4.  (The instances take 40
// to 96 registers; the minimum of three blocks a SM changes the
// compiler's schedule, not that: 2-4% on the score-only instances.)
template <int C, bool TRACK, bool PAD>
__global__ void __launch_bounds__(WARPS * 32, 3)
sw_band_warp_kernel(const int* __restrict__ q, const int* __restrict__ subj,
                    const int* __restrict__ slens,
                    const int* __restrict__ matrix, int B, int Q, int S,
                    int W, int prepad, int go, int ge, int kmul, int PW,
                    const LaneConsts lc,
                    int* __restrict__ best_out, int* __restrict__ ti_out,
                    int* __restrict__ tj_out) {
  static_assert(C >= 1 && C < 256, "the key keeps the band lane in a byte");
  __shared__ int smat[64];
  extern __shared__ __align__(16) signed char prof[];
  if (threadIdx.x < 64) smat[threadIdx.x] = matrix[threadIdx.x];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;                  // warp-uniform

  const int t0 = lane * C;             // first band lane of this thread
  const int t0ge = t0 * ge;
  // PAD: W < 32 * C, so some threads hold padding lanes
  const int nreal = PAD ? min(max(W - t0, 0), C) : C;   // lanes below W
  const bool partial = PAD && nreal < C;
  // NEG where this lane takes no value from its neighbour, else no bound
  const int last_neg = lane == 31 ? NEG : INT_MAX;
  const int first_neg = lane == 0 ? NEG : INT_MAX;
  const int* qrow = q + (size_t)b * Q;
  const int* srow = subj + (size_t)b * S;
  const int slen = min(slens[b], S);

  // The window's query profile, int8: entry (s, x) = matrix[s][q[x - prepad]]
  // (code 7 outside the query), x = i + t for band lane t of row i.
  signed char* wprof = prof + (size_t)(threadIdx.x >> 5) * 8 * PW;
  for (int x = 4 * lane; x < PW; x += 128) {
    int qc[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = x + k - prepad;
      qc[k] = (j >= 0 && j < Q) ? qrow[j] & 7 : 7;
    }
#pragma unroll
    for (int sc = 0; sc < 8; ++sc)
      *reinterpret_cast<unsigned*>(wprof + sc * PW + x) =
          (smat[8 * sc + qc[0]] & 0xff) | (smat[8 * sc + qc[1]] & 0xff) << 8 |
          (smat[8 * sc + qc[2]] & 0xff) << 16 |
          (unsigned)smat[8 * sc + qc[3]] << 24;
  }
  __syncwarp();                        // a warp reads its own window's words

  int H[C], Eh[C];                     // Eh = E + (row + 1) * ge
#pragma unroll
  for (int c = 0; c < C; ++c) {
    H[c] = c < nreal ? 0 : HPAD;
    Eh[c] = NEG;
  }

  int lthr = 255, lkey = 255, li = 0;  // TRACK: this thread's best, T = 0
  int acc = 0;                         // !TRACK: this thread's max of T
  int scode = 7;
  int nige = 0;                        // -i * ge:        Ein = Ehin + nige
  int ci = ge - go;                    // (i+1)*ge - go:  Eh' = max(Ehin, H + ci)
  // the profile entry of this thread's first lane in row i of subject code
  // 0; opaque to the compiler, which otherwise recomputes it every row
  int poff = (threadIdx.x >> 5) * 8 * PW + t0;
  asm volatile("" : "+r"(poff));
  for (int i = 0; i < slen; ++i) {
    if ((i & 31) == 0) {
      const int r = i + lane;
      scode = r < S ? srow[r] & 7 : 7;
    }
    // the profile's row of this subject code, at this thread's first lane
    const signed char* prow =
        prof + (__shfl_sync(FULL, scode, i & 31) * PW + poff);

    // (Eh never falls below NEG, so the min leaves it or makes it NEG)
    const int enext = min(__shfl_down_sync(FULL, Eh[0], 1), last_neg);
    int T[C], H0[C], run[C];
    int r = NEG;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      T[c] = H[c] + prow[c];
      H0[c] = addmax_relu(c < C - 1 ? Eh[c + 1] : enext, nige, T[c]);
      r = addmax(H0[c], lc.cge[c], r); // prefix max within the thread
      run[c] = r;
    }
    // inclusive prefix max of the thread totals over the warp, in band
    // coordinates; a lane below the shift gets its own value back
    int incl = r + t0ge;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1)
      incl = max(incl, __shfl_up_sync(FULL, incl, d));
    const int excl = min(__shfl_up_sync(FULL, incl, 1) - t0ge, first_neg);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int cm = c == 0 ? excl : max(excl, run[c - 1]);
      const int hn = addmax(cm, lc.fk[c], H0[c]);      // max(F, H0)
      // Eh[c + 1] still holds the row above
      Eh[c] = addmax(hn, ci, c < C - 1 ? Eh[c + 1] : enext);
      H[c] = hn;
    }
    if (partial) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (c >= nreal) {
          Eh[c] = NEG;
          H[c] = HPAD;
        }
    }
    nige -= ge;
    ci += ge;
    ++poff;

    if (TRACK) {
      const int m = row_key<C>(T, kmul);
      if (m > lthr) {                  // T strictly above the thread's best
        lkey = m;
        li = i;
        lthr = m | 255;
      }
    } else {
      acc = max(acc, row_max<C>(T));
    }
  }

  if (TRACK) {
    // highest T, then lowest row, then lowest band lane, over the warp
    int bt = lkey >> 8, bi = li, bl = t0 + 255 - (lkey & 255);
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
    if (lane == 0) {
      const bool hit = bt > 0;         // else no row beat the initial 0
      best_out[b] = hit ? bt : 0;
      ti_out[b] = hit ? bi : 0;
      tj_out[b] = hit ? bi + bl - prepad : -prepad;
    }
  } else {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      acc = max(acc, __shfl_xor_sync(FULL, acc, d));
    if (lane == 0) best_out[b] = acc;  // >= 0: acc starts at 0
  }
}

#include "sw_band_multi.cuh"                  // 512 < W <= 12,800
#include "sw_band_strips.cuh"                 // W > CLUSTER_BAND_W
#include "sw_band_cluster.cuh"                // 12,800 < W <= 131,072

struct Args {
  const int *q, *subj, *slens, *matrix;
  int B, Q, S, W, prepad, go, ge;
  int *best, *ti, *tj;
  cudaStream_t stream;
};

// Dynamic shared memory a block may ask for (of the SM's 227 KB), and the
// room a profile needs: a window whose profile does not fit runs
// sw_band_multi_kernel, whose rolling profile does not grow with S.
constexpr int MAX_SMEM = 200 * 1024;

inline int profile_pitch(int S, int C) { return (S + 32 * C + 3) / 4 * 4; }

template <int C>
cudaError_t launch_warp(bool track, const Args& a) {
  const int PW = profile_pitch(a.S, C);
  const int warps = min(WARPS, MAX_SMEM / (8 * PW));   // windows a block
  const int smem = warps * 8 * PW;
  const bool pad = a.W < 32 * C;
  auto kernel = track ? (pad ? sw_band_warp_kernel<C, true, true>
                             : sw_band_warp_kernel<C, true, false>)
                      : (pad ? sw_band_warp_kernel<C, false, true>
                             : sw_band_warp_kernel<C, false, false>);
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return rc;
  LaneConsts lc;
  for (int c = 0; c < 16; ++c) {
    lc.cge[c] = c * a.ge;
    lc.fk[c] = -(a.go + (c - 1) * a.ge);
  }
  kernel<<<(a.B + warps - 1) / warps, warps * 32, smem, a.stream>>>(
      a.q, a.subj, a.slens, a.matrix, a.B, a.Q, a.S, a.W, a.prepad, a.go,
      a.ge, 256, PW, lc, a.best, a.ti, a.tj);
  return cudaGetLastError();
}

// sw_band_multi_kernel<C, PT> on the warps the band needs: its rolling
// profile (PT 2: one row of query codes) of R = 32 * C * nw + 32 columns
// and a mirror of at least C - 1, in a pitch of 16 entries.
template <int C, int PT>
cudaError_t launch_multi(bool track, const Args& a) {
  using P = typename ProfEntry<PT>::T;
  const int nw = (a.W + 32 * C - 1) / (32 * C);
  const int RP = (32 * C * nw + 32 + C - 1 + 15) / 16 * 16;
  const int smem = (PT == 2 ? 1 : 8) * RP * static_cast<int>(sizeof(P));
  auto kernel = track ? sw_band_multi_kernel<C, PT, true>
                      : sw_band_multi_kernel<C, PT, false>;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return rc;
  LaneK<C> lc;
  for (int c = 0; c < C; ++c) {
    lc.cge[c] = c * a.ge;
    lc.fk[c] = -(a.go + (c - 1) * a.ge);
  }
  kernel<<<a.B, nw * 32, smem, a.stream>>>(
      a.q, a.subj, a.slens, a.matrix, a.Q, a.S, a.W, a.prepad, a.go, a.ge,
      RP, lc, a.best, a.ti, a.tj);
  return cudaGetLastError();
}

// C = 20 where its warps (640 lanes each) pad the band no wider than
// C = 12's (384 lanes, up to MULTI_W): fewer threads a row and the same
// cells, 12% faster at W = 1,920; else 12 (7% faster at W = 3,072, where
// 20 lanes a thread pad 3,200).  The profile's entries by `wide`.
template <int PT>
cudaError_t launch_multi_pt(bool track, const Args& a) {
  const int pad12 = (a.W + 383) / 384 * 384, pad20 = (a.W + 639) / 640 * 640;
  return a.W <= MULTI_W && pad12 < pad20
             ? launch_multi<MULTI_C, PT>(track, a)
             : launch_multi<MANY_C, PT>(track, a);
}

cudaError_t launch_cluster(bool track, int ncta, int nthreads,
                           const Args& a) {
  auto kernel = track ? sw_band_cluster_kernel<true>
                      : sw_band_cluster_kernel<false>;
  if (ncta > 8) {                      // past the portable cluster size
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (rc != cudaSuccess) return rc;
  }
  LaneConsts lc;
  for (int c = 0; c < 16; ++c) {
    lc.cge[c] = c * a.ge;
    lc.fk[c] = -(a.go + (c - 1) * a.ge);
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ncta;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * ncta);
  cfg.blockDim = dim3(nthreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = a.stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, a.q, a.subj, a.slens, a.matrix,
                            a.Q, a.S, a.W, a.prepad, a.go, a.ge, lc, a.best,
                            a.ti, a.tj);
}

// The strip kernel's instance: tracked or not, int32 lookups or not.
auto strips_kernel(bool track, bool wide) {
  return track ? (wide ? sw_band_strips_kernel<true, true>
                       : sw_band_strips_kernel<true, false>)
               : (wide ? sw_band_strips_kernel<false, true>
                       : sw_band_strips_kernel<false, false>);
}

}  // namespace

// Scores B windows on `stream`.  q [B,Q], subj [B,S], slens [B] and
// matrix [8,8] are contiguous int32 device arrays; best (and, with
// track, ti and tj) are int32 [B] outputs.  The band has W lanes and
// sits prepad columns left of the window start.  wide (ops/sw.py
// sw_band_instance and _band_wide_code) names the several-warps kernel's
// profile: 0 int8 entries, 1 int8 entries and the several-warps kernel at
// any width (a tracked window that could score 2^23), 2 int16 entries, 3
// entries outside int16 (int32 lookups); any wide != 0 runs the
// several-warps kernel, as does W > 512, a one-warp profile past MAX_SMEM
// and a gap extension with (S + 1) * ge >= 2^28 (the one-warp kernel's
// stand-in for NEG).  Returns the CUDA error of the launch (0 on
// success), or -1 when an argument is out of range (W outside 1..MANY_W
// included: wider bands take sw_band_cluster_launch or
// sw_band_strips_launch).
extern "C" int sw_band_launch(const void* q, const void* subj,
                              const void* slens, const void* matrix, int B,
                              int Q, int S, int W, int prepad, int go,
                              int ge, int track, void* best, void* ti,
                              void* tj, void* stream, int wide) {
  if (Q < 1 || S < 0 || B < 0 || W < 1 || W > MANY_W || ge < 0 ||
      wide < 0 || wide > 3)
    return -1;
  if (B == 0) return 0;
  const Args a = {static_cast<const int*>(q), static_cast<const int*>(subj),
                  static_cast<const int*>(slens),
                  static_cast<const int*>(matrix), B, Q, S, W, prepad, go, ge,
                  static_cast<int*>(best), static_cast<int*>(ti),
                  static_cast<int*>(tj), static_cast<cudaStream_t>(stream)};
  const bool tr = track != 0;
  const int need = (W + 31) / 32;      // band lanes a thread on one warp
  const int C1 = need <= 4 ? 4 : need <= 6 ? 6 : need <= 8 ? 8
                 : need <= 12 ? 12 : 16;
  if (W > 512 || wide != 0 || 8 * profile_pitch(S, C1) > MAX_SMEM ||
      (long long)(S + 1) * ge >= (1 << 28)) {
    switch (wide) {
      case 2: return static_cast<int>(launch_multi_pt<1>(tr, a));
      case 3: return static_cast<int>(launch_multi_pt<2>(tr, a));
      default: return static_cast<int>(launch_multi_pt<0>(tr, a));
    }
  }
  switch (C1) {
    case 4: return static_cast<int>(launch_warp<4>(tr, a));
    case 6: return static_cast<int>(launch_warp<6>(tr, a));
    case 8: return static_cast<int>(launch_warp<8>(tr, a));
    case 12: return static_cast<int>(launch_warp<12>(tr, a));
    default: return static_cast<int>(launch_warp<16>(tr, a));
  }
}

// Scores B windows with the cluster kernel (sw_band_cluster.cuh): a
// cluster of ncta CTAs a window (1..CLUSTER_MAX), nthreads threads a CTA
// (a multiple of 32, at most CLUSTER_NT), CLUSTER_C band lanes a thread,
// ncta * nthreads * CLUSTER_C >= W (ops/sw.py cluster_shape chooses them;
// it routes TILED_BAND_W < W <= CLUSTER_BAND_W here).  The other
// arguments are sw_band_launch's less `wide` (int32 lookups, no packed
// key).  Returns the CUDA error of the launch (0 on
// success), or -1 when an argument is out of range.
extern "C" int sw_band_cluster_launch(const void* q, const void* subj,
                                      const void* slens, const void* matrix,
                                      int B, int Q, int S, int W, int prepad,
                                      int go, int ge, int track, void* best,
                                      void* ti, void* tj, void* stream,
                                      int ncta, int nthreads) {
  if (Q < 1 || S < 0 || B < 0 || W < 1 || ge < 0) return -1;
  if (ncta < 1 || ncta > CLUSTER_MAX || nthreads < 32 || nthreads % 32 ||
      nthreads > CLUSTER_NT ||
      (long long)ncta * nthreads * CLUSTER_C < W ||
      (long long)B * ncta > INT_MAX)
    return -1;
  if (B == 0) return 0;
  const Args a = {static_cast<const int*>(q), static_cast<const int*>(subj),
                  static_cast<const int*>(slens),
                  static_cast<const int*>(matrix), B, Q, S, W, prepad, go, ge,
                  static_cast<int*>(best), static_cast<int*>(ti),
                  static_cast<int*>(tj), static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch_cluster(track != 0, ncta, nthreads, a));
}

// How many clusters of ncta CTAs of nthreads threads of the tracked (or
// score-only) cluster kernel the card can hold at once
// (cudaOccupancyMaxActiveClusters; 0: it cannot place one), through
// *count.  Returns the CUDA error of the query, or -1 when the shape is
// out of range.
extern "C" int sw_band_cluster_occupancy(int ncta, int nthreads, int track,
                                         void* count) {
  if (ncta < 1 || ncta > CLUSTER_MAX || nthreads < 32 || nthreads % 32 ||
      nthreads > CLUSTER_NT)
    return -1;
  auto kernel = track ? sw_band_cluster_kernel<true>
                      : sw_band_cluster_kernel<false>;
  if (ncta > 8) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ncta;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ncta);
  cfg.blockDim = dim3(nthreads);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      static_cast<int*>(count), kernel, &cfg));
}

// Scores B windows with the strip kernel (sw_band_strips.cuh), for bands
// of any width; ops/sw.py routes W past CLUSTER_BAND_W here.  The arguments
// are sw_band_launch's, then carry, an int32 [B, S, 2] device scratch the
// kernel writes before it reads, flags, int32 device words (ops/sw.py
// band_strip_flag_words: the ticket, each window's record chain and its
// chunk flags), cleared here on the stream before the launch, nw, the
// warps (strips) a CTA, 1..STRIPS_WARPS (ops/sw.py BAND_STRIP_WARPS), and
// wide: nonzero for a matrix outside int8 (int32 lookups in place of the
// int8 profile).  Returns the CUDA error of the clearing, of setting the
// shared memory or of the launch (0 on success), or -1 when an argument
// is out of range.
extern "C" int sw_band_strips_launch(const void* q, const void* subj,
                                     const void* slens, const void* matrix,
                                     int B, int Q, int S, int W, int prepad,
                                     int go, int ge, int track, void* best,
                                     void* ti, void* tj, void* stream,
                                     void* carry, void* flags, int nw,
                                     int wide) {
  if (Q < 1 || S < 0 || B < 0 || W < 1 || ge < 0 || nw < 1 ||
      nw > STRIPS_WARPS)
    return -1;
  if (B == 0) return 0;
  // the groups of a window: strips below ceil(Q / 512) whose rows start
  // below S (the kernel counts each window's own)
  const long long num = (long long)S + W - 1 - prepad;
  const long long kq = (Q + STRIPS_W - 1LL) / STRIPS_W;
  const long long ks = num > 0 ? (num + STRIPS_W - 1) / STRIPS_W : 0;
  const long long kmax = kq < ks ? kq : ks;
  const long long G = kmax > nw ? (kmax + nw - 1) / nw : 1;
  if ((long long)B * G > INT_MAX) return -1;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(
      flags, 0, strips_flag_words(B, S) * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = strips_kernel(track != 0, wide != 0);
  // the carry ring, then (int8) a profile a warp
  const int smem = nw * 2 * 32 * static_cast<int>(sizeof(int2)) +
                   (wide ? 0 : nw * STRIPS_WSTRIDE);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<int>(B * G), nw * 32, smem, st>>>(
      static_cast<const int*>(q), static_cast<const int*>(subj),
      static_cast<const int*>(slens), static_cast<const int*>(matrix), B, Q,
      S, W, prepad, go, ge, static_cast<int2*>(carry),
      static_cast<int*>(flags), static_cast<int*>(best),
      static_cast<int*>(ti), static_cast<int*>(tj));
  return static_cast<int>(cudaGetLastError());
}
