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
//     one.  (The key holds |T| < 2^23, and with C < 256 c is recovered
//     from its low byte.  A window keeps |T| < 2^23 while max|entry| *
//     min(Q, S) < 2^23: an int8 matrix below 65,536 columns.)
//   - A tracked launch past that, int8 matrix or not, runs the WIDE
//     instance of the _rec kernels (sw_full_rec_kernel,
//     sw_wave_rec_kernel: the same text, sw_full_kernels.cuh, included
//     twice), which tracks without the key.  Its record has two parts,
//     the value and its column: a lane takes the row's max of T (3-input
//     max), and only when that beats its best so far (strictly, rows
//     below its window's slen) does it look for the lowest column
//     reaching it, C compares and selects inside that branch.  The record
//     is the key's, value for value, so the proof above holds as it
//     stands, for any int32 score; scores are bounded only by the int32
//     DP itself (ops/sw.py check_score_cap).  Every other launch keeps
//     the key, whose row costs fewer instructions (ops/sw.py
//     sw_full_instance decides from the matrix's range and the shape).
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
// registers, 16 columns a lane at most.  Past that the query runs in
// strips of STRIP_W = 32 * 16 columns, lane l of a warp holding columns
// k*STRIP_W + l*16 + [0, 16) of strip k, with the row loop of the 32-lane
// instance inside.  Only two values a row cross a strip boundary, which
// strip k hands to strip k + 1:
//   x = H[i, j0 - 1], the last column's H, from which the next strip's
//       first column takes T[i + 1, j0] = H[i, j0 - 1] + w;
//   y = max over j' < j0 of (H0[i, j'] + j' * ge), the running prefix max
//       from which F continues into the next strip (its carry is H0, the
//       value before F, as the recurrence at the top says).
// E stays in its column, and so inside its strip.  The strip's global
// column offset j0 enters the lane's offset j0 * ge of the prefix max's
// lane-local coordinates; lane 0 folds y into its total before the scan
// (so lane 31's inclusive total is the next strip's y) and starts its
// exclusive value from y, where strip 0 starts from NEG.  The first row
// of a run of rows takes the x of the row before, kept in a register.
//
// The wavefront (sw_wave_kernel, NW = 2..16 warps a window, one window a
// block).  Strip k runs on warp k % NW; its chunk c (subject rows [32c,
// 32c + 32), the last one shorter) runs at step (k / NW) * M + k % NW + c,
// with Cr = ceil(rows / 32) chunks and M = max(Cr, NW), and one block
// barrier ends each step.  A warp's strips never overlap (its next one
// starts M >= Cr steps later), and every chunk's left neighbour, the same
// rows of strip k - 1, ran at least one step earlier: on warp w - 1 one
// step earlier, or, across the wrap from warp NW - 1 to warp 0 of the next
// round, M - NW + 1 >= 1 steps earlier (M >= NW).  So the carry goes:
//   - to the next warp through a ring in shared memory, 2 (the step's
//     parity) x 32 rows x 8 bytes a warp: written at step t, read at
//     t + 1, written again at t + 2, each after a barrier;
//   - across the wrap through device memory, carry[b][i] (8 * S bytes a
//     window, ops/sw.py scratch_groups bounds it): warp NW - 1 writes a
//     chunk's rows at step t, warp 0 reads them at least one barrier later
//     and before warp NW - 1 writes them again (NW - 1 >= 1 steps after
//     that read).
// Device-memory carry traffic falls NW-fold against the one-warp path.
// Each warp builds the int8 profile of its strip in its own slice of the
// block's dynamic shared memory (8 * 512 + 128 bytes a warp).  Every warp
// runs every step and every barrier; a window whose rows or strips are
// none runs no step.  The number of steps, (nstrip - 1) / NW * M +
// (nstrip - 1) % NW + Cr, is the block's own, so no warp leaves early.
// The one-warp path (sw_strip_kernel, NW = 1, int8 only): a warp a
// window, four windows a block, strip 0 over all of the window's rows,
// then strip 1, and so on, the carry through carry[b][i] (read 32 rows at
// a time, one coalesced load a lane, broadcast by shuffle; written by lane
// 31 a row).
// Route (ops/sw.py strip_warps, from (B, Q, S) and the matrix;
// sw_full_instance names the launch "_strip" on the wavefront and "_warp"
// on the one-warp path), from the two kernels timed side by side
// (PERF.md): the one-warp path for an int8 matrix from B = 1,536 windows
// on, where it runs without barriers and measured faster; the wavefront
// below that and for every WIDE launch (the one-warp kernel's WIDE and
// _rec instances measured slower at Q 2,048 and 4,096 at every batch to
// 4,096, and faster only at Q 1,024 tracked on 1,536-2,112 windows; they
// are not built): a warp a strip up to 16 and no more warps than chunks (more
// would idle), built twice, for launches of up to 4 warps (up to 255
// registers a thread, measured faster there) and of up to 16 (512
// threads: ptxas holds it to 128, and past that would cap them below what
// a lane's 16 columns take).  Never one warp: there the wavefront's
// schedule is the one-warp path's, with a barrier a chunk and a block a
// window besides.  On Q32768 /
// S2048 / B64, 64 windows of the pass-1 lane's reads over 16 kb, the
// one-warp path filled 64 warps of the card; the wavefront fills 1,024.
// Nothing bounds Q: a window of Q columns runs up to Q / 512 strips,
// every offset that can pass 2^31 in size_t.
//
// Strips of pad code alone are not run.  Each window first finds qend,
// one past its last column whose code is not 7 (from the end, a block's
// or a warp's width of columns at a time), and runs ceil(qend / 512)
// strips; a window of pad code alone runs none and returns (0, 0, 0) or
// 0.  This is exact because code 7 scores 0 against every code, the
// contract of sw_score_batch (ops/sw.py sw_score_batch; the 8 x 8 matrix
// of align/core.py make_score_matrix is 0 on rows and columns >= 6): the
// columns at or past qend lie to the right of every real column, so they
// feed no cell of a real one, and by the argument above (query columns
// past Q) none of them is the first to reach the maximum of T, nor raises
// it.  A skipped strip also hands no carry, since no strip follows it.
//
// Tracking: a lane's strict-greater record is the first of its best
// cells in the order it visits them, which is row-major within a strip
// but not across strips.  So a lane keeps one record a strip (the proof
// above holds strip by strip, over the lane's columns in that strip) and
// merges it into its running record by the rule the reductions after the
// loop apply: highest T, then lowest row, then lowest (global) column.
// A warp's lanes reduce by that rule, and (the wavefront) warp 0 then
// reduces the warps' records by it, through shared memory.  The rule is
// a total order on (T, row, column), so the order of merging does not
// matter, and the lexicographic minimum over all records of the cells
// with T = M is the reference's cell, as above.

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

// The lowest c with T[c] == m, m the max of T (the two-part record's column).
template <int C>
__device__ __forceinline__ int first_col(const int (&T)[C], int m) {
  int c0 = C - 1;
#pragma unroll
  for (int c = C - 2; c >= 0; --c) c0 = T[c] == m ? c : c0;
  return c0;
}

constexpr int STRIP_C = 16;                 // columns a lane in a strip
constexpr int STRIP_W = 32 * STRIP_C;       // columns a strip
constexpr int STRIP_WARPS = 16;             // most warps a window (NW)
constexpr int STRIP_WSTRIDE = 8 * STRIP_W + 128;   // a warp's int8 profile

// sw_full_kernel, sw_strip_kernel (int8 only) and sw_wave_kernel track
// with the key; the _rec kernels (tracked WIDE instances only) with the
// two-part record.
#define SWF_KERNEL sw_full_kernel
#define SWF_STRIP_KERNEL sw_strip_kernel
#define SWF_WAVE_KERNEL sw_wave_kernel
#define SWF_REC false
#include "sw_full_kernels.cuh"
#undef SWF_KERNEL
#undef SWF_STRIP_KERNEL
#undef SWF_WAVE_KERNEL
#undef SWF_REC
#define SWF_KERNEL sw_full_rec_kernel
#define SWF_WAVE_KERNEL sw_wave_rec_kernel
#define SWF_REC true
#include "sw_full_kernels.cuh"
#undef SWF_KERNEL
#undef SWF_WAVE_KERNEL
#undef SWF_REC

// The strip wavefront's instance for a launch of up to MAXW warps a block.
template <int MAXW>
auto wave_kernel(bool track, int wide) {
  return track ? (wide == 2 ? sw_wave_rec_kernel<true, true, MAXW>
                  : wide ? sw_wave_kernel<true, true, MAXW>
                         : sw_wave_kernel<true, false, MAXW>)
               : (wide ? sw_wave_kernel<false, true, MAXW>
                       : sw_wave_kernel<false, false, MAXW>);
}

template <int C, int L>
int launch(bool track, int wide, const int* q, const int* subj,
           const int* slens, const int* matrix, int B, int Q, int S, int go,
           int ge, int* best, int* ti, int* tj, cudaStream_t stream) {
  constexpr int PER_BLOCK = WARPS * (32 / L);      // windows a block
  const dim3 grid((B + PER_BLOCK - 1) / PER_BLOCK), block(WARPS * 32);
  auto kernel = track ? (wide == 2 ? sw_full_rec_kernel<C, L, true, true>
                         : wide ? sw_full_kernel<C, L, true, true>
                                : sw_full_kernel<C, L, true, false>)
                      : (wide ? sw_full_kernel<C, L, false, true>
                              : sw_full_kernel<C, L, false, false>);
  kernel<<<grid, block, 0, stream>>>(q, subj, slens, matrix, B, Q, S, go, ge,
                                     256, best, ti, tj);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Scores B windows on `stream`.  q [B,Q], subj [B,S], slens [B] and
// matrix [8,8] are contiguous int32 device arrays; best (and, with
// track, ti and tj) are int32 [B] outputs.  A query of length Q runs
// the first instantiated (C, L) below with L * C >= Q (Q <= 512).
// wide = 1 (a matrix entry outside -128..127) runs the WIDE instance;
// wide = 2, for a tracked window that could score 2^23, the WIDE
// instance with the two-part record (ops/sw.py sw_full_instance decides).
// Returns the CUDA error of the launch (0 on success), or -1 when Q is out
// of range.
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
  const bool tr = track != 0;
#define SWF_TRY(C, L)                                                     \
  if (Q <= (C) * (L))                                                     \
    return launch<C, L>(tr, wide, qp, sp, lp, mp, B, Q, S, go, ge, bp, ip, jp, \
                        st)
  // 8 lanes a window to Q = 128, 16 to 192, 32 above
  SWF_TRY(4, 8); SWF_TRY(8, 8); SWF_TRY(12, 8); SWF_TRY(14, 8);
  SWF_TRY(16, 8); SWF_TRY(10, 16); SWF_TRY(12, 16);
  SWF_TRY(8, 32); SWF_TRY(10, 32); SWF_TRY(12, 32); SWF_TRY(14, 32);
  SWF_TRY(16, 32);
#undef SWF_TRY
  return -1;
}

// The same for a query of more than STRIP_W columns, in column strips
// (header): nw = 1 runs the one-warp kernel (a warp a window, four
// windows a block; wide = 0 only), nw >= 2 the wavefront of nw warps a
// window, one window a block (ops/sw.py strip_warps chooses).  carry is an int32
// [B, S, 2] device scratch buffer the kernels write before they read (the
// caller need not clear it); ops/sw.py bounds it by launching groups of
// windows (their pointers offset to the group's first window).  wide as
// above.  Returns the CUDA error of setting the wavefront's shared memory
// or of the launch, or -1 when Q or nw is out of range (or nw = 1 with a
// wide matrix).
extern "C" int sw_full_strip_launch(const void* q, const void* subj,
                                    const void* slens, const void* matrix,
                                    int B, int Q, int S, int go, int ge,
                                    int track, void* best, void* ti, void* tj,
                                    void* stream, int wide, void* carry,
                                    int nw) {
  if (Q <= STRIP_W || S < 0 || B < 0 || nw < 1 || nw > STRIP_WARPS)
    return -1;
  if (B == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto* qp = static_cast<const int*>(q);
  auto* sp = static_cast<const int*>(subj);
  auto* lp = static_cast<const int*>(slens);
  auto* mp = static_cast<const int*>(matrix);
  auto* cp = static_cast<int2*>(carry);
  auto* bp = static_cast<int*>(best);
  auto* ip = static_cast<int*>(ti);
  auto* jp = static_cast<int*>(tj);
  if (nw == 1) {                       // int8 only
    if (wide) return -1;
    auto kernel = track ? sw_strip_kernel<true> : sw_strip_kernel<false>;
    kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32, 0, st>>>(
        qp, sp, lp, mp, B, Q, S, go, ge, 256, cp, bp, ip, jp);
    return static_cast<int>(cudaGetLastError());
  }
  // a launch of up to 4 warps a block lets ptxas take up to 255 registers
  // a thread; one of up to STRIP_WARPS holds it to 128 (PERF.md: the first
  // build measured faster at nw <= 4)
  auto kernel = nw <= 4 ? wave_kernel<4>(track != 0, wide)
                        : wave_kernel<STRIP_WARPS>(track != 0, wide);
  // the carry ring, then (int8) a profile a warp
  const int smem = nw * 2 * 32 * static_cast<int>(sizeof(int2)) +
                   (wide ? 0 : nw * STRIP_WSTRIDE);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, nw * 32, smem, st>>>(qp, sp, lp, mp, Q, S, go, ge, 256, cp, bp,
                                   ip, jp);
  return static_cast<int>(cudaGetLastError());
}
