// Grouped stochastic quantize round in two ordinary launches over a
// (D-tile, row) grid, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/stoch_quant.py::
// stoch_quantize_grouped_fused_tiled (_grouped_fused_tiled_kernel): the
// same function as grouped_fused.cu (R, Eq. (18) schedule, quantize with
// degenerate groups passed through), bit for bit, with the columns of
// each row cut into tiles of `tile` columns (REPRO_QUANT_TILE_D).
//
//   launch 1 (reduce):   block (j, n) reduces |theta - q_prev| over the
//                        pieces of tile j of row n and merges each piece's
//                        maximum into R[n, g] with an atomicMax on the
//                        float bits (range_new must be zero on entry);
//   launch 2 (quantize): block (j, n) recomputes the schedule of the groups
//                        its tile touches and quantizes the tile; the
//                        blocks of tile 0 write (b, Δ) of their row.
//
// The launch boundary is the grid-wide barrier, so no cooperative launch
// is needed. What bounds it on this card: bytes, as grouped_fused.cu
// (16 B per element at least; this design moves 24 B: theta and q_prev
// are read in both launches). Small tiles cost one block reduction and one
// atomic per piece: at tile 512 the full-width buffer is a million blocks.

#include "grouped_common.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ void tile_range(long long d, long long tile,
                                           long long* lo, long long* hi) {
  const long long row = blockIdx.y;
  const long long c0 = (long long)blockIdx.x * tile;
  const long long c1 = c0 + tile < d ? c0 + tile : d;
  *lo = row * d + c0;
  *hi = row * d + c1;
}

__global__ void __launch_bounds__(kThreads)
tiled_reduce_kernel(const float* __restrict__ theta,
                    const float* __restrict__ qprev, float* range_new,
                    long long d, int n_groups, long long tile,
                    gq::Segs segs) {
  __shared__ float sh[32];
  long long lo, hi;
  tile_range(d, tile, &lo, &hi);
  gq::for_each_piece(lo, hi, d, segs,
                     [&](long long row, int g, long long a, long long b) {
                       gq::reduce_piece(theta, qprev, range_new, row, g,
                                        n_groups, a, b, sh);
                     });
}

__global__ void __launch_bounds__(kThreads)
tiled_quantize_kernel(const float* __restrict__ theta,
                      const float* __restrict__ qprev,
                      const float* __restrict__ unif,
                      const float* __restrict__ bprev,
                      const float* __restrict__ rprev,
                      const float* __restrict__ init,
                      float* __restrict__ out,
                      const float* __restrict__ range_new,
                      float* __restrict__ bits, float* __restrict__ delta,
                      long long d, int n_groups, long long tile, float omega,
                      float b0, float bmax, gq::Segs segs) {
  long long lo, hi;
  tile_range(d, tile, &lo, &hi);
  if (blockIdx.x == 0) {
    const long long base = (long long)blockIdx.y * n_groups;
    for (int g = threadIdx.x; g < n_groups; g += blockDim.x) {
      const long long i = base + g;
      const gq::Sched s = gq::schedule(bprev[i], range_new[i], rprev[i],
                                       init[i], omega, b0, bmax);
      bits[i] = s.bits;
      delta[i] = s.delta;
    }
  }
  gq::for_each_piece(
      lo, hi, d, segs, [&](long long row, int g, long long a, long long b) {
        const long long i = row * n_groups + g;
        const float r = range_new[i];
        const gq::Sched s =
            gq::schedule(bprev[i], r, rprev[i], init[i], omega, b0, bmax);
        gq::quantize_piece(theta, qprev, unif, out, s.delta, r, true, a, b);
      });
}

}  // namespace

// As grouped_fused_f32, plus `tile` (columns per tile, >= 1). Two launches
// on `stream`; returns the first cudaError_t; no synchronisation.
extern "C" int grouped_fused_tiled_f32(
    const void* theta, const void* qprev, const void* unif,
    const void* bprev, const void* rprev, const void* init, void* out,
    void* range_new, void* bits, void* delta, long long n, long long d,
    int n_groups, const long long* seg_off, const int* seg_gid, int n_segs,
    float omega, float b0, float bmax, long long tile, void* stream) {
  if (n <= 0 || d <= 0) return (int)cudaSuccess;
  if (tile < 1 || n > 65535) return (int)cudaErrorInvalidValue;
  gq::Segs segs;
  if (!gq::make_segs(&segs, seg_off, seg_gid, n_segs))
    return (int)cudaErrorInvalidValue;
  const long long tiles = (d + tile - 1) / tile;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)n);
  cudaStream_t st = (cudaStream_t)stream;
  tiled_reduce_kernel<<<grid, kThreads, 0, st>>>(
      (const float*)theta, (const float*)qprev, (float*)range_new, d,
      n_groups, tile, segs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tiled_quantize_kernel<<<grid, kThreads, 0, st>>>(
      (const float*)theta, (const float*)qprev, (const float*)unif,
      (const float*)bprev, (const float*)rprev, (const float*)init,
      (float*)out, (const float*)range_new, (float*)bits, (float*)delta, d,
      n_groups, tile, omega, b0, bmax, segs);
  return (int)cudaGetLastError();
}
