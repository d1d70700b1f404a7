// The exact lane's seed / segment / candidate scan for Hopper (sm_90a):
// one thread a (read, strand) lane walks its sorted hits once
// (segcand.cuh) and writes its candidate rows in emission order.
//
// Replaces no TPU kernel: the JAX package runs this scan as a lax.scan of
// H + 1 lane-parallel steps (smalt_tpu/parallel/exact_collate.py:203),
// and the port's plain version (_segcand_scan, parallel/exact_collate.py)
// as a Python loop of as many steps of some 110 torch ops each.  The
// exact lane's repeat tier (map/fastlane.py DeviceExact) scans lanes of
// thousands of hits, where that loop would launch some 10^6 kernels a
// batch; this kernel is one launch.
//
// Bound: the scan is sequential within a lane, so a lane's time is its
// hits times one step's dependent chain (~100 integer instructions and
// the masks' NW words), and the launch's time is its longest lane's.
// The bytes (8 a hit read, 28 a candidate row written) are ~10^2 MB a
// batch at most: ~0.03 ms at 3.35 TB/s.  Design: each thread reads its
// own row of the [R, H] hit arrays front to back (the sectors a thread
// brings in serve its next hits from L1), keeps the state and both masks
// in registers (NW = 4 for Q <= 128, 8 for Q <= 256), and one warp a
// block spreads the lanes over the SMs.
#include <cuda_runtime.h>

#include "segcand.cuh"

template <int NW>
__global__ void segcand_kernel(const int* __restrict__ k1,
                               const int* __restrict__ k2,
                               const int* __restrict__ ivl,
                               const int* __restrict__ tot,
                               const int* __restrict__ mdsh,
                               const int* __restrict__ mincov, int R, int H,
                               int C, int k, int nskip, int Q,
                               int* __restrict__ rows,
                               int* __restrict__ counts,
                               int* __restrict__ bad) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const size_t off = (size_t)r * H;
  const int t = tot[r] < H ? tot[r] : H;
  segcand_lane<NW>(k1 + off, k2 + off, ivl ? ivl + off : nullptr, t, mdsh[r],
                   mincov[r], (r & 1) != 0, k, nskip, Q, C,
                   rows + (size_t)r * C * SEGCAND_FIELDS, counts + r,
                   bad + r);
}

// k1, k2, ivl (or null): [R, H] int32 sorted hits, lane r = 2 read +
// strand (odd lanes reverse); tot, mdsh, mincov [R]; rows [R, C, 7]
// (rows past a lane's count are left as they are), counts, bad [R].
// Returns 0, or a CUDA error code (a Q past 256: cudaErrorInvalidValue).
extern "C" int segcand_launch(const int* k1, const int* k2, const int* ivl,
                              const int* tot, const int* mdsh,
                              const int* mincov, int R, int H, int C, int k,
                              int nskip, int Q, int* rows, int* counts,
                              int* bad, void* stream) {
  if (R <= 0) return 0;
  if (Q > 256 || Q < 1 || nskip < 1 || C < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  const int threads = 32;
  const int blocks = (R + threads - 1) / threads;
  cudaStream_t s = (cudaStream_t)stream;
  if (Q <= 128)
    segcand_kernel<4><<<blocks, threads, 0, s>>>(
        k1, k2, ivl, tot, mdsh, mincov, R, H, C, k, nskip, Q, rows, counts,
        bad);
  else
    segcand_kernel<8><<<blocks, threads, 0, s>>>(
        k1, k2, ivl, tot, mdsh, mincov, R, H, C, k, nskip, Q, rows, counts,
        bad);
  return (int)cudaGetLastError();
}
