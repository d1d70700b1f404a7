// Device pass 2 of the exact lane for Hopper (sm_90a): the reference's
// banded TRACK fill (alignSmiWatBand, alignment.c:788-1027) and its
// reverse traceback walk, one window per warp.
//
// Replaces the Pallas kernel built by _make_swq_kernel in
// smalt_tpu/parallel/exact_pass2.py:179 and launched by _swq_call
// (exact_pass2.py:371).  Plain version: swq_fill_walk_ref in
// smalt_tpu_torch/parallel/exact_pass2.py, which this kernel equals
// exactly (all int32; records int16).
//
// What it computes, per window w with par[w] = {l_edge, r_edge, q_left,
// q_len, slen, valid, s_left, 0}, over subject rows i in [s_left, slen)
// (none when valid == 0) and the whole query frame j in [0, Qp):
//   in_band  = band_lo(i) <= j < band_hi(i)
//   diag     = H[i-1, j-1] + matrix[subj[i], q[j]]      (H[*, -1] = 0)
//   pre      = in_band && diag > 0 && diag > E
//   F        = max_{j' < j, pre, diag' > go}(diag' - go - (j-1-j')*ge)
//   won      = pre && diag > F
//   H        = in_band ? max(diag, E, F, 0) : H          (stale outside)
//   E        = in_band ? max(E - ge, won && diag > go ? diag - go : NEG) : E
//   code     = won ? 3 : in_band && H > 0 ? (E >= F ? 1 : 2) : 0
// and the running best takes diag at won && diag > go when it strictly
// beats the best so far (row-major first).  Cells outside the band keep
// the H and E of the rows above, and those stale values reach the next
// row's diagonal; the kernel keeps the full frame, so it reproduces them.
// The walk then starts at (mi, mj) = the best cell and goes up the rows:
//   hi   = the last column <= j that is not (code == 2 && column >= q_left)
//   nins = max(j - max(hi, q_left - 1), 0),  j2 = j - nins
//   stop = j2 < q_left || code[j2] == 0, and a stop at a column in the
//   query but outside the band is SUSPECT (the host must redo it);
// it writes (nins << 2) | typ for each row it visits (typ 3 DIA, 1 COL,
// 2 stop, 0 SUSPECT) and 0 for every other row.
//
// What bounds it on an H100: integer ALU and warp shuffles.  The lane's
// main path runs ~W = 16,384 windows of Qp = 128 against Sp = 256 rows
// a batch (~0.5 G cells, ~20 integer operations each, two 5-step shuffle
// chains a row); the walk is one short dependent chain a row.  Memory:
// the direction codes, 2 bits a cell, go to a scratch buffer in device
// memory (W * Sp * 64 bytes, written once and read back by the same warp
// while it is still in L2) rather than to shared memory, so that
// occupancy is set by registers and not by Sp.
//
// Design: one warp per window, four windows per block.  Lane l holds the
// C = Qp/32 consecutive columns [l*C, l*C + C) of H, E and the query in
// registers (C <= 8).  The diagonal predecessor of a lane's first column
// comes from the lane to its left by __shfl_up_sync; F is a per-lane
// running max of g + j*ge plus a 5-step __shfl_up_sync scan of the lane
// totals, as in sw_full.cu.  Each lane packs its C codes of a row into
// one uint16 and stores it (64 bytes a row for the warp, coalesced).
// The row max is a __shfl_xor_sync reduction; its first column takes a
// second one only when the row beats the best (warp-uniform, rare).
// The walk is warp-uniform: hi is a masked warp max, code[j2] comes by
// one __shfl_sync from the lane that owns column j2, lane 0 writes the
// record.  Records are zeroed first (coalesced), so rows the walk does
// not visit read 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr int WARPS = 4;               // windows (warps) per block
constexpr unsigned FULL = 0xffffffffu;

template <int C>
__global__ void __launch_bounds__(WARPS * 32)
swq_kernel(const int* __restrict__ qalpha, const int* __restrict__ subj,
           const int* __restrict__ par, const int* __restrict__ matrix,
           int W, int Sp, int go, int ge, int* __restrict__ best_out,
           int* __restrict__ mi_out, int* __restrict__ mj_out,
           int16_t* __restrict__ rec, uint16_t* __restrict__ codes) {
  __shared__ int smat[64];
  if (threadIdx.x < 64) smat[threadIdx.x] = matrix[threadIdx.x];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (w >= W) return;                  // warp-uniform: w is per warp
  constexpr int Qp = 32 * C;

  const int* p = par + (size_t)w * 8;
  const int le = p[0], re = p[1], ql = p[2], qn = p[3], sn = p[4];
  const int vd = p[5], sl = p[6];
  const int start_lo = max(ql, le);
  const int lead = max(0, ql - le);
  const int row_lo = max(sl, 0);
  const int row_hi = vd != 0 ? min(sn, Sp) : 0;

  const int j0 = lane * C;
  int qc[C], H[C], E[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    qc[c] = qalpha[(size_t)w * Qp + j0 + c] & 7;
    H[c] = 0;
    E[c] = 0;
  }
  const int* srow = subj + (size_t)w * Sp;
  uint16_t* crow = codes + (size_t)w * Sp * 32;

  // ---------------- fill ----------------
  int best = 0, bi = 0, bj = 0;        // warp-uniform running best
  int scode = 7;
  for (int i = row_lo; i < row_hi; ++i) {
    const int k = (i - row_lo) & 31;
    if (k == 0) {
      const int r = i + lane;
      scode = r < Sp ? srow[r] & 7 : 7;
    }
    const int* mrow = smat + 8 * __shfl_sync(FULL, scode, k);
    const int t_rel = i - sl;
    const int band_lo = start_lo + max(0, t_rel - lead);
    const int band_hi = min(qn, re + 1 + t_rel);

    int hleft = __shfl_up_sync(FULL, H[C - 1], 1);
    if (lane == 0) hleft = 0;
    int diag[C], run[C];
    int r = NEG;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = j0 + c;
      diag[c] = (c == 0 ? hleft : H[c - 1]) + mrow[qc[c]];
      const bool inb = j >= band_lo && j < band_hi;
      const bool pre = inb && diag[c] > 0 && diag[c] > E[c];
      const int g = (pre && diag[c] > go) ? diag[c] - go : NEG;
      r = max(r, g + j * ge);
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

    unsigned bits = 0;
    int rmax = NEG, rfirst = 1 << 28;  // this lane's best eligible diag
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = j0 + c;
      const bool inb = j >= band_lo && j < band_hi;
      const int cm = c == 0 ? excl : max(excl, run[c - 1]);
      const int F = cm - (j - 1) * ge;
      const int dg = diag[c], e = E[c];
      const bool won = inb && dg > 0 && dg > e && dg > F;
      const int cell = max(max(dg, e), max(F, 0));
      const int code = won ? 3 : (inb && cell > 0 ? (e >= F ? 1 : 2) : 0);
      bits |= (unsigned)code << (2 * c);
      if (inb) {
        H[c] = cell;
        E[c] = max(e - ge, (won && dg > go) ? dg - go : NEG);
      }
      if (won && dg > go && dg > rmax) {
        rmax = dg;                     // columns rise: the first one wins
        rfirst = j;
      }
    }
    crow[(size_t)i * 32 + lane] = (uint16_t)bits;

    int m = rmax;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) m = max(m, __shfl_xor_sync(FULL, m, d));
    if (m > best) {                    // warp-uniform
      int f = rmax == m ? rfirst : 1 << 28;
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) f = min(f, __shfl_xor_sync(FULL, f, d));
      best = m;
      bi = i;
      bj = f;
    }
  }
  if (lane == 0) {
    best_out[w] = best;                // >= 0: the running best starts at 0
    mi_out[w] = bi;
    mj_out[w] = bj;
  }

  // ---------------- walk ----------------
  int16_t* rrow = rec + (size_t)w * Sp;
  for (int i = lane; i < Sp; i += 32) rrow[i] = 0;
  __syncwarp();
  int j = bj;
  for (int i = min(bi, Sp - 1); i >= row_lo; --i) {
    const bool filled = i < row_hi;
    const unsigned bits = filled ? crow[(size_t)i * 32 + lane] : 0u;
    const int band_lo = start_lo + max(0, i - sl - lead);
    const int band_hi = min(qn, re + 1 + i - sl);
    int h = -1;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int jj = j0 + c;
      const int code = (bits >> (2 * c)) & 3;
      if (jj <= j && !(code == 2 && jj >= ql)) h = jj;
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) h = max(h, __shfl_xor_sync(FULL, h, d));
    h = max(h, ql - 1);
    const int nins = max(j - h, 0);
    const int j2 = j - nins;
    const bool in_q = j2 >= 0 && j2 < Qp;
    const int own = in_q ? j2 / C : 0;
    const unsigned ob = __shfl_sync(FULL, bits, own);
    const int code2 = in_q ? (int)((ob >> (2 * (j2 - own * C))) & 3) : 0;
    const bool stop = j2 < ql || code2 == 0;
    const bool suspect = stop && j2 >= ql && (j2 >= band_hi || j2 < band_lo);
    const int typ = suspect ? 0 : (stop ? 2 : code2);
    if (lane == 0) rrow[i] = (int16_t)((nins << 2) | typ);
    if (stop) break;                   // warp-uniform
    j = code2 == 3 ? j2 - 1 : j2;
  }
}

template <int C>
void launch(const int* q, const int* s, const int* par, const int* m, int W,
            int Sp, int go, int ge, int* best, int* mi, int* mj,
            int16_t* rec, uint16_t* codes, cudaStream_t stream) {
  const dim3 grid((W + WARPS - 1) / WARPS), block(WARPS * 32);
  swq_kernel<C><<<grid, block, 0, stream>>>(q, s, par, m, W, Sp, go, ge,
                                            best, mi, mj, rec, codes);
}

}  // namespace

// Fills and walks W windows on `stream`.  qalpha [W,Qp], subj [W,Sp],
// par [W,8] and matrix [8,8] are contiguous int32 device arrays; best,
// mi, mj are int32 [W], rec int16 [W,Sp], and codes a uint16 scratch
// [W,Sp,32] (no need to clear it).  Qp is a multiple of 32 up to 256.
// Returns the CUDA error of the launch (0 on success), or -1 when a
// shape is out of range.
extern "C" int swq_launch(const void* qalpha, const void* subj,
                          const void* par, const void* matrix, int W, int Qp,
                          int Sp, int go, int ge, void* best, void* mi,
                          void* mj, void* rec, void* codes, void* stream) {
  if (Qp < 32 || Qp > 256 || Qp % 32 || Sp < 1 || W < 0) return -1;
  if (W == 0) return 0;
  auto* q = static_cast<const int*>(qalpha);
  auto* s = static_cast<const int*>(subj);
  auto* pr = static_cast<const int*>(par);
  auto* m = static_cast<const int*>(matrix);
  auto* b = static_cast<int*>(best);
  auto* i = static_cast<int*>(mi);
  auto* j = static_cast<int*>(mj);
  auto* r = static_cast<int16_t*>(rec);
  auto* cd = static_cast<uint16_t*>(codes);
  auto st = static_cast<cudaStream_t>(stream);
  switch (Qp / 32) {
    case 1: launch<1>(q, s, pr, m, W, Sp, go, ge, b, i, j, r, cd, st); break;
    case 2: launch<2>(q, s, pr, m, W, Sp, go, ge, b, i, j, r, cd, st); break;
    case 3: launch<3>(q, s, pr, m, W, Sp, go, ge, b, i, j, r, cd, st); break;
    case 4: launch<4>(q, s, pr, m, W, Sp, go, ge, b, i, j, r, cd, st); break;
    case 5: launch<5>(q, s, pr, m, W, Sp, go, ge, b, i, j, r, cd, st); break;
    case 6: launch<6>(q, s, pr, m, W, Sp, go, ge, b, i, j, r, cd, st); break;
    case 7: launch<7>(q, s, pr, m, W, Sp, go, ge, b, i, j, r, cd, st); break;
    default: launch<8>(q, s, pr, m, W, Sp, go, ge, b, i, j, r, cd, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
