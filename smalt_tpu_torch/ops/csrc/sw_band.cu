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
// (ti, tj) = (i, i + lane - prepad).
//
// What bounds it on an H100: integer ALU and warp shuffles, not memory.
// The main path (1,500 bp reads, Q = 1504) scores 12,288 windows of
// W = 384 band lanes over S = 1,792 subject rows a step, 8.5 G cells,
// from ~100 MB of int32 codes read once.  Each cell costs one
// shared-memory matrix lookup and ~15 integer operations; each row adds
// two 5-step shuffle chains (F and, with TRACK, the row max).
//
// Design.  A thread holds C consecutive band lanes [t0, t0 + C) of H, E
// and the query codes in registers.  Bands up to 512 lanes run one warp
// per window and four windows a block, with C = W/32 rounded up to an
// instantiated width.  Wider bands (MULTI) run one window per block on
// NW = ceil(W/512) warps with C = 12 or 16, up to W = 3,072 (6 warps;
// sw_band_launch refuses wider bands).  Lanes at or past W are padding:
// their E is held at NEG and their T is left out of the max, so they
// never reach a real lane (E flows from the right, only through NEG).
//   - Query sliding: from one row to the next each lane's query column
//     moves one to the right, so a thread shifts its codes down one
//     register, takes the next thread's first code by __shfl_down_sync,
//     and the warp's last thread takes the one new code, which the warp
//     loads 32 rows at a time (one per lane) and broadcasts.  Subject
//     codes arrive the same way.  The 8x8 matrix sits in shared memory.
//   - E from lane t + 1: an in-register shift and one __shfl_down_sync,
//     the mirror image of sw_full.cu's __shfl_up_sync of H.
//   - F: a per-thread running max over its C lanes, then a log-step
//     inclusive __shfl_up_sync scan of the thread totals.
//   - MULTI, one __syncthreads a row.  Each warp publishes its scan total
//     and its row max in shared memory before the barrier and reads the
//     other warps' after it.  A warp's last lane needs E from the next
//     warp's first lane: that is the next warp's state from the previous
//     row, published at the end of that row, so it is read after this
//     row's barrier.  Until then the last lane's H0 is max(T, 0); it
//     feeds no F inside its warp, and a reader corrects the published
//     total of warp w' as max(total, Ein_last + L*ge), which is the same
//     max.  The shared buffers alternate with the row's parity, so one
//     barrier a row orders every write before its reads and every read
//     before the next write to the same buffer.

#include <cuda_runtime.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr int WARPS = 4;               // windows (warps) per block, W <= 512
constexpr int MAX_NW = 6;              // warps per window, W <= 3072
constexpr int MAX_W = 32 * 16 * MAX_NW;
constexpr unsigned FULL = 0xffffffffu;

template <int C, bool TRACK, bool MULTI>
__global__ void __launch_bounds__(MULTI ? MAX_NW * 32 : WARPS * 32)
sw_band_kernel(const int* __restrict__ q, const int* __restrict__ subj,
               const int* __restrict__ slens,
               const int* __restrict__ matrix, int B, int Q, int S, int W,
               int prepad, int go, int ge, int* __restrict__ best_out,
               int* __restrict__ ti_out, int* __restrict__ tj_out) {
  __shared__ int smat[64];
  // MULTI exchange, by row parity: scan totals, row maxima, and E of
  // each warp's first lane (the state after the previous row)
  __shared__ int wtot[2][MAX_NW], wmax[2][MAX_NW], eb[2][MAX_NW + 1];
  __shared__ int wacc[MAX_NW], blane;
  if (threadIdx.x < 64) smat[threadIdx.x] = matrix[threadIdx.x];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int NW = MULTI ? blockDim.x >> 5 : 1;
  const int w = MULTI ? warp : 0;      // this warp's place in its window
  const int b = MULTI ? blockIdx.x : blockIdx.x * WARPS + warp;
  if (MULTI) {
    if (threadIdx.x < MAX_NW + 1) eb[0][threadIdx.x] = NEG;
    if (threadIdx.x == 0) blane = 0;
  }
  __syncthreads();
  if (b >= B) return;                  // warp-uniform (block-uniform if MULTI)

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

  int best = 0, bi = 0, bl = 0;        // TRACK: window-uniform running best
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
    // Ein = NEG for now (its true value, in MULTI, arrives in phase B).
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

    if (MULTI) {
      if (lane == 31) wtot[p][w] = incl;
      if (TRACK && lane == 0) wmax[p][w] = m;
      __syncthreads();
      // phase B: the other warps' totals, corrected by the E their last
      // lanes take from the next warp's first lane
      int pre = NEG;
      for (int v = 0; v < w; ++v)
        pre = max(pre, max(wtot[p][v],
                           eb[p][v + 1] + ((v + 1) * 32 * C - 1) * ge));
      excl = max(excl, pre);
      if (lane == 31) {
        enext = w + 1 < NW ? eb[p][w + 1] : NEG;
        H0[C - 1] = max(H0[C - 1], enext);
      }
      if (TRACK) {
        for (int v = 0; v < NW; ++v) m = max(m, wmax[p][v]);
      }
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
    if (MULTI && lane == 0) eb[p ^ 1][w] = E[0];

    if (TRACK && m > best) {           // uniform over the window's warps
      bool mine = true;
      if (MULTI) {                     // the first warp reaching m owns it
        int v = 0;
        while (v < NW - 1 && wmax[p][v] != m) ++v;
        mine = v == w;
      }
      if (mine) {
        int first = 1 << 28;
#pragma unroll
        for (int c = C - 1; c >= 0; --c)
          if (T[c] == m) first = t0 + c;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1)
          first = min(first, __shfl_xor_sync(FULL, first, d));
        bl = first;
        if (MULTI && lane == 0) blane = first;
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
  }
  if (MULTI) {
    if (!TRACK && lane == 0) wacc[w] = acc;
    __syncthreads();
    if (threadIdx.x != 0) return;
    if (TRACK) {
      bl = blane;
    } else {
      for (int v = 1; v < NW; ++v) acc = max(acc, wacc[v]);
    }
  } else if (lane != 0) {
    return;
  }
  if (TRACK) {
    best_out[b] = best;                // >= 0: the running best starts at 0
    ti_out[b] = bi;
    tj_out[b] = bi + bl - prepad;
  } else {
    best_out[b] = acc;                 // >= 0: acc starts at 0
  }
}

template <int C, bool MULTI>
void launch(bool track, dim3 grid, dim3 block, const int* q,
            const int* subj, const int* slens, const int* matrix, int B,
            int Q, int S, int W, int prepad, int go, int ge, int* best,
            int* ti, int* tj, cudaStream_t stream) {
  if (track)
    sw_band_kernel<C, true, MULTI><<<grid, block, 0, stream>>>(
        q, subj, slens, matrix, B, Q, S, W, prepad, go, ge, best, ti, tj);
  else
    sw_band_kernel<C, false, MULTI><<<grid, block, 0, stream>>>(
        q, subj, slens, matrix, B, Q, S, W, prepad, go, ge, best, ti, tj);
}

}  // namespace

// Scores B windows on `stream`.  q [B,Q], subj [B,S], slens [B] and
// matrix [8,8] are contiguous int32 device arrays; best (and, with
// track, ti and tj) are int32 [B] outputs.  The band has W lanes and
// sits prepad columns left of the window start.  Returns the CUDA error
// of the launch (0 on success), or -1 when an argument is out of range
// (W outside 1..3072 included).
extern "C" int sw_band_launch(const void* q, const void* subj,
                              const void* slens, const void* matrix, int B,
                              int Q, int S, int W, int prepad, int go,
                              int ge, int track, void* best, void* ti,
                              void* tj, void* stream) {
  if (Q < 1 || S < 0 || B < 0 || W < 1 || W > MAX_W) return -1;
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
  const int nw = (W + 511) / 512;
  if (nw > 1) {
    const dim3 grid(B), block(nw * 32);
    if ((W + 32 * nw - 1) / (32 * nw) <= 12)
      launch<12, true>(tr, grid, block, qp, sp, lp, mp, B, Q, S, W, prepad, go, ge, bp, ip, jp, st);
    else
      launch<16, true>(tr, grid, block, qp, sp, lp, mp, B, Q, S, W, prepad, go, ge, bp, ip, jp, st);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((B + WARPS - 1) / WARPS), block(WARPS * 32);
  const int need = (W + 31) / 32;
#define SWB_LAUNCH(CC) \
  launch<CC, false>(tr, grid, block, qp, sp, lp, mp, B, Q, S, W, prepad, go, ge, bp, ip, jp, st)
  if (need <= 1) SWB_LAUNCH(1);
  else if (need <= 2) SWB_LAUNCH(2);
  else if (need <= 3) SWB_LAUNCH(3);
  else if (need <= 4) SWB_LAUNCH(4);
  else if (need <= 6) SWB_LAUNCH(6);
  else if (need <= 8) SWB_LAUNCH(8);
  else if (need <= 12) SWB_LAUNCH(12);
  else SWB_LAUNCH(16);
#undef SWB_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
