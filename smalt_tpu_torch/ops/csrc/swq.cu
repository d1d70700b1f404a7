// Device pass 2 of the exact lane for Hopper (sm_90a): the reference's
// banded TRACK fill (alignSmiWatBand, alignment.c:788-1027) and its
// reverse traceback walk, one window per warp, computed in the band frame.
//
// Replaces the Pallas kernel built by _make_swq_kernel in
// smalt_tpu/parallel/exact_pass2.py:179 and launched by _swq_call
// (exact_pass2.py:371).  Plain version: swq_fill_walk_ref in
// smalt_tpu_torch/parallel/exact_pass2.py, which this kernel equals
// exactly (all int32; records int16).
//
// What it computes, per window w with par[w] = {l_edge, r_edge, q_left,
// q_len, slen, valid, s_left, 0}, over subject rows i in [s_left, slen)
// (none when valid == 0), in the plain version's full query frame j in
// [0, Qp) with t = i - s_left, lead = max(0, q_left - l_edge):
//   band_lo  = max(q_left, l_edge) + max(0, t - lead)
//   band_hi  = min(q_len, r_edge + 1 + t)
//   in_band  = band_lo <= j < band_hi
//   diag     = H[i-1, j-1] + matrix[subj[i], q[j]]      (H[*, -1] = 0)
//   pre      = in_band && diag > 0 && diag > E
//   F        = max_{j' < j, pre, diag' > go}(diag' - go - (j-1-j')*ge)
//   won      = pre && diag > F
//   H        = in_band ? max(diag, E, F, 0) : H          (stale outside)
//   E        = in_band ? max(E - ge, won && diag > go ? diag - go : NEG) : E
//   code     = won ? 3 : in_band && H > 0 ? (E >= F ? 1 : 2) : 0
// and the running best takes diag at won && diag > go when it strictly
// beats the best so far (row-major first).  The walk then starts at
// (mi, mj) = the best cell and goes up the rows:
//   hi   = the last column <= j that is not (code == 2 && column >= q_left)
//   nins = max(j - max(hi, q_left - 1), 0),  j2 = j - nins
//   stop = j2 < q_left || code[j2] == 0, and a stop at a column in the
//   query but outside the band is SUSPECT (the host must redo it);
// it writes (nins << 2) | typ for each row it visits (typ 3 DIA, 1 COL,
// 2 stop, 0 SUSPECT) and 0 for every other row.  A dummy window (valid 0)
// fills nothing and walks the one row its zero best names, as the plain
// version does.
//
// Why the band frame is exact (tests/test_torch_swq_band.py holds each
// step against an instrumented copy of the plain version's loop).
//   1. Both edges are nondecreasing in the row: band_lo rises by 0 (the
//      lead-pinned rows, t <= lead) or 1, band_hi by 1 until it reaches
//      q_len and then by 0.  So a column enters the band once, on the
//      right, and leaves it once, on the left; the band is non-empty on
//      one run of rows, and its width grows (lead rows), holds, and
//      shrinks only once band_hi = q_len.
//   2. A cell in the band reads E[i-1, j] and H[i-1, j-1].  E: column j
//      was in the band in row i-1 (its value), or it enters now (never
//      written: 0).  H at j-1: in the band in row i-1 (its value), or
//      right of it (never written: 0), or left of it, which needs
//      band_lo(i) = j = band_lo(i-1): a lead-pinned row, and column
//      band_lo - 1 was never in the band (0; -1 is the H[*, -1] = 0
//      column).  "The lane roll brings H[band_lo-1], which is 0 during
//      the lead-pinned rows (never written) and the last slid-out value
//      afterwards" (smalt_tpu/parallel/exact_pass2.py's docstring): once
//      band_lo moves, that value is row i-1's H at band_lo(i-1), inside
//      row i-1's band.  No stale value outside the band is ever read.
//   3. So lane k of tile u holds position p = 32u + k, column band_lo + p,
//      and every input comes from the row above: with band_lo unmoved,
//      the diagonal H from position p - 1 (lane k - 1, __shfl_sync; lane
//      0 of tile u takes lane 31 of tile u - 1 through the same shuffle,
//      lane 0 of tile 0 takes 0) and E from p; with band_lo moved by one,
//      the diagonal H from p and E from p + 1 (lane k + 1; lane 31 takes
//      lane 0 of tile u + 1).  Positions at or past the row's width are
//      set to H = E = 0 when their tile runs, and tiles past the width
//      are not touched: while band_hi < q_len the width never shrank, so
//      they were never written and hold the 0 an entering column needs;
//      once band_hi = q_len no column enters, and a position whose
//      source lies past the old width is itself outside the new band.
//   4. F is a running max over band columns to the left: a 5-step
//      __shfl_up_sync scan of g + p*ge a tile, its total carried to the
//      next tile, F = excl - (p-1)*ge (positions and columns differ by
//      band_lo, which cancels).  Columns left of the band only carried
//      NEG-based values in the full frame, which compare with E, 0 and
//      diag exactly as NEG does here.
//   5. The codes are 0 outside the band in the full frame, so the walk
//      reads 0 there and the band's codes inside it: hi = j when j is
//      outside the band, else the highest band column <= j whose code is
//      not 2 (a masked ballot word and __clz), else band_lo - 1 (outside
//      the band: code 0), before the max with q_left - 1, which also
//      covers the columns left of q_left that the full frame admits.
//
// Design.  One warp a window; a row covers ceil(width/32) tiles of one
// band column a lane, at most TILES (the launch's widest band, from the
// caller).  A tile costs ~50 issued instructions (SASS of the one-tile
// instance), 8 shuffles and 2 ballots among them: the shuffle that brings
// the row above's value, the scan (5), its exclusive value and the carry;
// a row adds ~35 of its own.  The full-frame kernel it replaces
// did all Qp/32 columns of a lane every row, ~20 instructions a column,
// plus a 5-step row-max reduction and a 64-byte store of codes to a
// (W, Sp, 32) int16 scratch in device memory.  Here the running best is
// a per-lane record (value, row, column) under the same strict test,
// reduced once after the fill by (highest value, lowest row, lowest
// column) with __reduce_*_sync: the cells of the maximum are split among
// the lanes, and each lane keeps the first of its own, so the minimum of
// their records is the reference's row-major first.  The codes are two
// __ballot_sync words a tile and row (bit 0 and bit 1 of each lane's
// code), 8 bytes in shared memory at [row][tile]; nothing is written to
// device memory but the results.  The query codes sit in shared memory
// as bytes (32 * TILES pad bytes past Qp), the matrix as int32: a cell's
// score is two loads at an offset fixed for the row.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NEG = -(1 << 28);
constexpr int WARPS = 4;               // windows (warps) per block at most
constexpr int MAX_TILES = 8;           // Qp <= 256
constexpr int MAX_SMEM = 200 * 1024;   // dynamic shared memory a block
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline int query_bytes(int Qp, int tiles) {
  return (Qp + 32 * tiles + 15) / 16 * 16;
}
__host__ __device__ inline int window_bytes(int Qp, int Sp, int tiles) {
  return Sp * tiles * 8 + query_bytes(Qp, tiles);
}

template <int TILES>
__global__ void __launch_bounds__(WARPS * 32)
swq_kernel(const int* __restrict__ qalpha, const int* __restrict__ subj,
           const int* __restrict__ par, const int* __restrict__ matrix,
           int W, int Qp, int Sp, int go, int ge, int* __restrict__ best_out,
           int* __restrict__ mi_out, int* __restrict__ mj_out,
           int16_t* __restrict__ rec) {
  __shared__ int smat[64];
  extern __shared__ __align__(16) unsigned char dyn[];
  for (int k = threadIdx.x; k < 64; k += blockDim.x) smat[k] = matrix[k];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int w = blockIdx.x * (blockDim.x >> 5) + wib;
  if (w >= W) return;                  // warp-uniform: w is per warp
  unsigned char* wbase = dyn + (size_t)wib * window_bytes(Qp, Sp, TILES);
  uint2* codes = reinterpret_cast<uint2*>(wbase);        // [Sp][TILES]
  unsigned char* sq = wbase + (size_t)Sp * TILES * 8;    // query codes

  const int* p = par + (size_t)w * 8;
  const int le = p[0], re = p[1], ql = p[2], qn = p[3], sn = p[4];
  const int vd = p[5], sl = p[6];
  const int start_lo = max(ql, le);
  const int lead = max(0, ql - le);
  const int row_lo = max(sl, 0);
  const int row_hi = vd != 0 ? min(sn, Sp) : 0;
  const int qhi = min(qn, Qp);         // no column at or past Qp

  for (int c = lane; c < query_bytes(Qp, TILES); c += 32)
    sq[c] = c < Qp ? qalpha[(size_t)w * Qp + c] & 7 : 7;
  __syncwarp();

  // ---------------- fill ----------------
  // the first row whose band is not empty (none unless re >= le)
  const int i0 = re >= le && qhi > start_lo
                     ? max(row_lo, sl + max(0, start_lo - re)) : row_hi;
  int lo_prev = start_lo + max(0, i0 - sl - lead);
  int H[TILES], E[TILES];
#pragma unroll
  for (int u = 0; u < TILES; ++u) {
    H[u] = 0;
    E[u] = 0;
  }
  int lbest = 0, li = 0, lj = 0;       // this lane's first best cell
  const int* srow = subj + (size_t)w * Sp;
  int scode = 7;
  for (int i = i0; i < row_hi; ++i) {
    const int k = (i - i0) & 31;
    if (k == 0) {
      const int r = i + lane;
      scode = r < Sp ? srow[r] & 7 : 7;
    }
    const int* mrow = smat + 8 * __shfl_sync(FULL, scode, k);
    const int t_rel = i - sl;
    const int lo = start_lo + max(0, t_rel - lead);
    const int width = min(qhi, re + 1 + t_rel) - lo;
    if (width <= 0) break;             // the band has ended (warp-uniform)
    const bool moved = lo != lo_prev;
    lo_prev = lo;
    const unsigned char* qrow = sq + lo + lane;
    uint2* crow = codes + (size_t)i * TILES;

    int carry = NEG;                   // F scan: max of g + p*ge to the left
    int hcar = 0;                      // unmoved: lane 31's H of the last tile
#pragma unroll
    for (int u = 0; u < TILES; ++u) {
      if (32 * u >= width) break;      // warp-uniform
      const int pos = 32 * u + lane;
      const bool in = pos < width;
      int hd, ep;
      if (!moved) {                    // H from position - 1, E in place
        hd = __shfl_sync(FULL, lane == 31 ? hcar : H[u], (lane + 31) & 31);
        hcar = H[u];
        ep = E[u];
      } else {                         // H in place, E from position + 1
        hd = H[u];
        const int enext = u + 1 < TILES ? E[u + 1] : 0;
        ep = __shfl_sync(FULL, lane == 0 ? enext : E[u], (lane + 1) & 31);
      }
      const int dg = hd + mrow[qrow[32 * u]];
      const bool pre = in && dg > 0 && dg > ep;
      const int g = pre && dg > go ? dg - go : NEG;
      int v = max(g + pos * ge, carry);
#pragma unroll
      for (int d = 1; d < 32; d <<= 1)
        v = max(v, __shfl_up_sync(FULL, v, d));   // lane < d: its own v
      int excl = __shfl_up_sync(FULL, v, 1);
      if (lane == 0) excl = carry;
      if (u + 1 < TILES && 32 * (u + 1) < width)
        carry = __shfl_sync(FULL, v, 31);
      const int F = excl - (pos - 1) * ge;
      const bool won = pre && dg > F;
      const int cell = __vimax3_s32_relu(dg, ep, F);   // max(dg, ep, F, 0)
      const bool nz = in && cell > 0;
      const unsigned b0 = __ballot_sync(FULL, won || (nz && ep >= F));
      const unsigned b1 = __ballot_sync(FULL, won || (nz && ep < F));
      if (lane == 0) crow[u] = make_uint2(b0, b1);
      const bool el = won && dg > go;
      H[u] = in ? cell : 0;
      E[u] = in ? max(ep - ge, el ? dg - go : NEG) : 0;
      if (el && dg > lbest) {          // rows, then columns, rise
        lbest = dg;
        li = i;
        lj = lo + pos;
      }
    }
  }
  // highest value, then lowest row, then lowest column
  const int best = __reduce_max_sync(FULL, lbest);
  int bi = 0, bj = 0;
  if (best > 0) {                      // else no cell beat the initial 0
    bi = __reduce_min_sync(FULL, lbest == best ? li : INT_MAX);
    bj = __reduce_min_sync(FULL, lbest == best && li == bi ? lj : INT_MAX);
  }
  if (lane == 0) {
    best_out[w] = best;
    mi_out[w] = bi;
    mj_out[w] = bj;
  }

  // ---------------- walk (warp-uniform; lane 0 writes) ----------------
  int16_t* rrow = rec + (size_t)w * Sp;
  for (int i = lane; i < Sp; i += 32) rrow[i] = 0;
  __syncwarp();
  int j = bj;
  for (int i = min(bi, Sp - 1); i >= row_lo; --i) {
    const int t_rel = i - sl;
    const int lo = start_lo + max(0, t_rel - lead);
    const int hr = min(qn, re + 1 + t_rel);      // the reference's band_hi
    const int hc = min(hr, qhi);
    const bool filled = i < row_hi && hc > lo;
    const uint2* crow = codes + (size_t)i * TILES;
    int h = j;                         // j outside the band: code 0 there
    if (filled && j >= lo && j < hc) {
      const int pj = j - lo;
      h = lo - 1;
      for (int u = pj >> 5; u >= 0; --u) {
        const uint2 cw = crow[u];
        unsigned x = cw.x | ~cw.y;     // columns whose code is not 2
        if (u == pj >> 5) x &= FULL >> (31 - (pj & 31));
        if (x) {
          h = lo + 32 * u + 31 - __clz(x);
          break;
        }
      }
    }
    h = max(h, ql - 1);
    const int nins = max(j - h, 0);
    const int j2 = j - nins;
    int code2 = 0;
    if (filled && j2 >= lo && j2 < hc) {
      const int p2 = j2 - lo;
      const uint2 cw = crow[p2 >> 5];
      code2 = (int)((cw.x >> (p2 & 31)) & 1) |
              (int)((cw.y >> (p2 & 31)) & 1) << 1;
    }
    const bool stop = j2 < ql || code2 == 0;
    const bool suspect = stop && j2 >= ql && (j2 >= hr || j2 < lo);
    const int typ = suspect ? 0 : (stop ? 2 : code2);
    if (lane == 0) rrow[i] = (int16_t)((nins << 2) | typ);
    if (stop) break;                   // warp-uniform
    j = code2 == 3 ? j2 - 1 : j2;
  }
}

template <int TILES>
int launch(const int* q, const int* s, const int* par, const int* m, int W,
           int Qp, int Sp, int go, int ge, int* best, int* mi, int* mj,
           int16_t* rec, cudaStream_t stream) {
  const int per = window_bytes(Qp, Sp, TILES);
  const int warps = min(WARPS, MAX_SMEM / per);         // windows a block
  const int smem = warps * per;
  const cudaError_t rc = cudaFuncSetAttribute(
      swq_kernel<TILES>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  swq_kernel<TILES><<<(W + warps - 1) / warps, warps * 32, smem, stream>>>(
      q, s, par, m, W, Qp, Sp, go, ge, best, mi, mj, rec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one window takes (the codes of Sp rows of `tiles` tiles
// and the query), or -1 when the shape is out of range: Qp a multiple of
// 32 up to 256, 1 <= tiles <= Qp / 32, and the window within 200 KB.
extern "C" int swq_window_bytes(int Qp, int Sp, int tiles) {
  if (Qp < 32 || Qp > 32 * MAX_TILES || Qp % 32 || Sp < 1 || tiles < 1 ||
      tiles > Qp / 32)
    return -1;
  const long long b = (long long)Sp * tiles * 8 + query_bytes(Qp, tiles);
  return b <= MAX_SMEM ? static_cast<int>(b) : -1;
}

// Fills and walks W windows on `stream`.  qalpha [W,Qp], subj [W,Sp],
// par [W,8] and matrix [8,8] are contiguous int32 device arrays; best,
// mi, mj are int32 [W] and rec int16 [W,Sp].  `tiles` bounds every
// band's width: no window of the launch is wider than 32 * tiles columns
// (parallel/exact_pass2.py band_tiles).  Returns the CUDA error of the
// launch (0 on success), or -1 when a shape is out of range
// (swq_window_bytes).
extern "C" int swq_launch(const void* qalpha, const void* subj,
                          const void* par, const void* matrix, int W, int Qp,
                          int Sp, int go, int ge, int tiles, void* best,
                          void* mi, void* mj, void* rec, void* stream) {
  if (swq_window_bytes(Qp, Sp, tiles) < 0 || W < 0) return -1;
  if (W == 0) return 0;
  auto* q = static_cast<const int*>(qalpha);
  auto* s = static_cast<const int*>(subj);
  auto* pr = static_cast<const int*>(par);
  auto* m = static_cast<const int*>(matrix);
  auto* b = static_cast<int*>(best);
  auto* i = static_cast<int*>(mi);
  auto* j = static_cast<int*>(mj);
  auto* r = static_cast<int16_t*>(rec);
  auto st = static_cast<cudaStream_t>(stream);
  switch (tiles) {
    case 1: return launch<1>(q, s, pr, m, W, Qp, Sp, go, ge, b, i, j, r, st);
    case 2: return launch<2>(q, s, pr, m, W, Qp, Sp, go, ge, b, i, j, r, st);
    case 3: return launch<3>(q, s, pr, m, W, Qp, Sp, go, ge, b, i, j, r, st);
    case 4: return launch<4>(q, s, pr, m, W, Qp, Sp, go, ge, b, i, j, r, st);
    case 5: return launch<5>(q, s, pr, m, W, Qp, Sp, go, ge, b, i, j, r, st);
    case 6: return launch<6>(q, s, pr, m, W, Qp, Sp, go, ge, b, i, j, r, st);
    case 7: return launch<7>(q, s, pr, m, W, Qp, Sp, go, ge, b, i, j, r, st);
    default: return launch<8>(q, s, pr, m, W, Qp, Sp, go, ge, b, i, j, r, st);
  }
}
