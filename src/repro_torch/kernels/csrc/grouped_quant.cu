// Grouped stochastic quantize -> dequantize with given side information,
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/stoch_quant.py::
// stoch_quantize_grouped (_grouped_quant_kernel). Per element of a packed
// (N, D) float32 buffer, with the (Δ, R) of the element's group taken from
// (N, G) arrays:
//
//   c = (theta - q_prev + R) / D,  D = max(Δ, 1e-12)
//   q = floor(c) + [u < c - floor(c)], clipped to [0, 2R / D]
//   out = q_prev + D q - R
//
// (the chain of stoch_quant.cu; no degenerate passthrough: the two-pass
// engine path applies it after the call, as the JAX package does).
//
// What bounds it on this card: bytes, 16 per element (three reads, one
// write): 8.6 GB and 2.56 ms at 3.35 TB/s for the full-width xlstm-125m
// buffer (4, 134,277,912). A column's group is found from the packing's
// column runs (grouped_common.cuh), never from a (D,) id map, which at
// that width would add a fifth operand row of traffic. Each block owns a
// contiguous chunk of N*D elements and loads the (Δ, R) of each (row, run)
// piece once; the inner loop is float4 loads and stores.

#include "grouped_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;

__global__ void __launch_bounds__(kThreads)
grouped_quant_kernel(const float* __restrict__ theta,
                     const float* __restrict__ qprev,
                     const float* __restrict__ unif,
                     const float* __restrict__ delta,
                     const float* __restrict__ qrange,
                     float* __restrict__ out, long long n, long long d,
                     int n_groups, long long chunk, gq::Segs segs) {
  const long long total = n * d;
  const long long lo = (long long)blockIdx.x * chunk;
  const long long hi = lo + chunk < total ? lo + chunk : total;
  gq::for_each_piece(
      lo, hi, d, segs, [&](long long row, int g, long long a, long long b) {
        const long long i = row * n_groups + g;
        gq::quantize_piece(theta, qprev, unif, out, delta[i], qrange[i],
                           false, a, b);
      });
}

}  // namespace

// theta, qprev, unif, out: device float32 (n, d), 16-byte aligned; delta,
// qrange: (n, n_groups). seg_off / seg_gid are HOST arrays: the column
// runs. Launches on `stream`, returns cudaGetLastError(); no
// synchronisation.
extern "C" int grouped_quant_f32(const void* theta, const void* qprev,
                                 const void* unif, const void* delta,
                                 const void* qrange, void* out, long long n,
                                 long long d, int n_groups,
                                 const long long* seg_off, const int* seg_gid,
                                 int n_segs, void* stream) {
  if (n <= 0 || d <= 0) return (int)cudaSuccess;
  gq::Segs segs;
  if (!gq::make_segs(&segs, seg_off, seg_gid, n_segs))
    return (int)cudaErrorInvalidValue;
  const long long total = n * d;
  long long grid = (total + 4LL * kThreads - 1) / (4LL * kThreads);
  if (grid > kMaxBlocks) grid = kMaxBlocks;
  long long chunk = (total + grid - 1) / grid;
  chunk = (chunk + 3) & ~3LL;
  grid = (total + chunk - 1) / chunk;
  grouped_quant_kernel<<<(unsigned)grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)theta, (const float*)qprev, (const float*)unif,
      (const float*)delta, (const float*)qrange, (float*)out, n, d, n_groups,
      chunk, segs);
  return (int)cudaGetLastError();
}
