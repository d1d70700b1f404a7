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
// Query columns past Q are padded with code 7, which scores 0 against
// every subject code.  Padded columns lie to the right of every real
// column, so they never feed a real cell, and their T = H[i-1,j-1] is at
// most the best of the rows above: they can tie the best but never come
// first.  So padding to 32*C here, where the TPU padded to 128, leaves
// (best, ti, tj) unchanged.
//
// What bounds it on an H100: integer ALU and warp shuffles, not memory.
// The main path scores 12,288 windows of Q = 112 against S = 128 subject
// rows per step, about 176 M cells, and reads only ~7 MB of codes.  Each
// cell costs one shared-memory matrix lookup and ~15 integer operations;
// each row adds two 5-step shuffle chains (the F prefix max and, with
// TRACK, the row max).
//
// Design: one warp per window, four windows per block.  Lane l holds the
// C consecutive columns [l*C, l*C + C) of H, E and the query codes in
// registers, so C = ceil(Q/32) rounded up to an instantiated width
// (Q <= 512 -> C <= 16).  The diagonal predecessor of a lane's first
// column comes from the lane to its left by one __shfl_up_sync.  F is
// the exact prefix-max identity above: a per-lane running max over its C
// columns, then a log-step inclusive __shfl_up_sync scan of the lane
// totals.  The row max and its first column come from __shfl_xor_sync
// reductions, taken only when the row max beats the running best (a
// warp-uniform branch).  Subject codes arrive 32 rows at a time, one per
// lane, and are broadcast with __shfl_sync; the 8x8 matrix sits in
// shared memory.  No global memory is touched inside the row loop.

#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr int WARPS = 4;               // windows (warps) per block
constexpr unsigned FULL = 0xffffffffu;

template <int C, bool TRACK>
__global__ void __launch_bounds__(WARPS * 32)
sw_full_kernel(const int* __restrict__ q, const int* __restrict__ subj,
               const int* __restrict__ slens,
               const int* __restrict__ matrix, int B, int Q, int S,
               int go, int ge, int* __restrict__ best_out,
               int* __restrict__ ti_out, int* __restrict__ tj_out) {
  __shared__ int smat[64];
  if (threadIdx.x < 64) smat[threadIdx.x] = matrix[threadIdx.x];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;                  // warp-uniform: b is per warp

  const int j0 = lane * C;
  int qc[C], H[C], E[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = j0 + c;
    qc[c] = (j < Q ? q[(size_t)b * Q + j] : 7) & 7;
    H[c] = 0;
    E[c] = 0;
  }
  const int* srow = subj + (size_t)b * S;
  const int slen = min(slens[b], S);

  int best = 0, bi = 0, bj = 0;        // TRACK: warp-uniform running best
  int acc = 0;                         // !TRACK: this lane's max of T
  int scode = 7;
  for (int i = 0; i < slen; ++i) {
    if ((i & 31) == 0) {
      const int r = i + lane;
      scode = r < S ? srow[r] & 7 : 7;
    }
    const int* mrow = smat + 8 * __shfl_sync(FULL, scode, i & 31);

    int hleft = __shfl_up_sync(FULL, H[C - 1], 1);
    if (lane == 0) hleft = 0;
    int T[C], H0[C], run[C];
    int r = NEG;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      T[c] = (c == 0 ? hleft : H[c - 1]) + mrow[qc[c]];
      H0[c] = max(max(T[c], E[c]), 0);
      r = max(r, H0[c] + (j0 + c) * ge);
      run[c] = r;                      // prefix max within the lane
    }
    int incl = r;                      // inclusive prefix max over lanes
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl = max(incl, v);
    }
    int excl = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) excl = NEG;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int cm = c == 0 ? excl : max(excl, run[c - 1]);
      const int F = cm - go - (j0 + c - 1) * ge;
      const int hn = max(H0[c], F);
      E[c] = max(E[c] - ge, hn - go);
      H[c] = hn;
    }

    if (TRACK) {
      int m = T[0];
#pragma unroll
      for (int c = 1; c < C; ++c) m = max(m, T[c]);
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) m = max(m, __shfl_xor_sync(FULL, m, d));
      if (m > best) {
        int first = 1 << 28;
#pragma unroll
        for (int c = C - 1; c >= 0; --c)
          if (T[c] == m) first = j0 + c;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1)
          first = min(first, __shfl_xor_sync(FULL, first, d));
        best = m;
        bi = i;
        bj = first;
      }
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) acc = max(acc, T[c]);
    }
  }

  if (TRACK) {
    if (lane == 0) {
      best_out[b] = best;              // >= 0: the running best starts at 0
      ti_out[b] = bi;
      tj_out[b] = bj;
    }
  } else {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) acc = max(acc, __shfl_xor_sync(FULL, acc, d));
    if (lane == 0) best_out[b] = acc;
  }
}

template <int C>
void launch(bool track, const int* q, const int* subj, const int* slens,
            const int* matrix, int B, int Q, int S, int go, int ge,
            int* best, int* ti, int* tj, cudaStream_t stream) {
  const dim3 grid((B + WARPS - 1) / WARPS), block(WARPS * 32);
  if (track)
    sw_full_kernel<C, true><<<grid, block, 0, stream>>>(
        q, subj, slens, matrix, B, Q, S, go, ge, best, ti, tj);
  else
    sw_full_kernel<C, false><<<grid, block, 0, stream>>>(
        q, subj, slens, matrix, B, Q, S, go, ge, best, ti, tj);
}

}  // namespace

// Scores B windows on `stream`.  q [B,Q], subj [B,S], slens [B] and
// matrix [8,8] are contiguous int32 device arrays; best (and, with
// track, ti and tj) are int32 [B] outputs.  A query of length Q runs
// the smallest instantiated width C with 32 * C >= Q (Q <= 512).
// Returns the CUDA error of the launch (0 on success), or -1 when Q is
// out of range.
extern "C" int sw_full_launch(const void* q, const void* subj,
                              const void* slens, const void* matrix, int B,
                              int Q, int S, int go, int ge, int track,
                              void* best, void* ti, void* tj, void* stream) {
  if (Q < 1 || Q > 32 * 16 || S < 0 || B < 0) return -1;
  if (B == 0) return 0;
  const int need = (Q + 31) / 32;
  auto* qp = static_cast<const int*>(q);
  auto* sp = static_cast<const int*>(subj);
  auto* lp = static_cast<const int*>(slens);
  auto* mp = static_cast<const int*>(matrix);
  auto* bp = static_cast<int*>(best);
  auto* ip = static_cast<int*>(ti);
  auto* jp = static_cast<int*>(tj);
  auto st = static_cast<cudaStream_t>(stream);
  const bool tr = track != 0;
  if (need <= 1) launch<1>(tr, qp, sp, lp, mp, B, Q, S, go, ge, bp, ip, jp, st);
  else if (need <= 2) launch<2>(tr, qp, sp, lp, mp, B, Q, S, go, ge, bp, ip, jp, st);
  else if (need <= 3) launch<3>(tr, qp, sp, lp, mp, B, Q, S, go, ge, bp, ip, jp, st);
  else if (need <= 4) launch<4>(tr, qp, sp, lp, mp, B, Q, S, go, ge, bp, ip, jp, st);
  else if (need <= 6) launch<6>(tr, qp, sp, lp, mp, B, Q, S, go, ge, bp, ip, jp, st);
  else if (need <= 8) launch<8>(tr, qp, sp, lp, mp, B, Q, S, go, ge, bp, ip, jp, st);
  else if (need <= 12) launch<12>(tr, qp, sp, lp, mp, B, Q, S, go, ge, bp, ip, jp, st);
  else launch<16>(tr, qp, sp, lp, mp, B, Q, S, go, ge, bp, ip, jp, st);
  return static_cast<int>(cudaGetLastError());
}
