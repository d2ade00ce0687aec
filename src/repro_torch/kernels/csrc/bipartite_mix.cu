// Dense neighbour mix out = A @ V for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bipartite_mix.py::
// bipartite_mix (_mix_kernel). A is the (M, N) 0/1 adjacency (or a row
// block of it), V the (N, d) stacked worker vectors, out (M, d), all
// float32 with float32 accumulation.
//
// What bounds it on this card: bytes. The contraction depth is the number
// of workers (24 to 64) while d is wide, so it does 2 M N d flops on
// 4 (N d + M d + M N) bytes: at (64, 64) x (64, 2000) about 16 flops per
// byte, under the ridge point of the float32 CUDA cores (~20 flop/byte at
// 67 TFLOP/s and 3.35 TB/s) and 1.04 MB, about 0.3 us of memory time, so
// a single call is bound by the launch.
//
// What the design does about it: no tensor cores (TF32 would cut V to
// about 10 mantissa bits, and the mix feeds the exact local solve). Each
// block stages a (kRows, N) tile of A in shared memory; each thread owns
// one output column and keeps kRows float32 accumulators in registers, so
// it reads each V[k, j] once per block with coalesced 4-byte loads along d
// and multiplies it into every row of the tile. V is read ceil(M / kRows)
// times, from L2 after the first. The sum over k runs in order with FMAs:
// the mix is not the parity-critical chain (that is the quantizer), and
// its results match the plain A @ V to summation-order rounding.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 8;

__global__ void bipartite_mix_kernel(const float* __restrict__ adj,
                                     const float* __restrict__ vals,
                                     float* __restrict__ out, int m, int n,
                                     int d) {
  extern __shared__ float a_tile[];  // (kRows, n)
  const int row0 = blockIdx.y * kRows;
  for (int idx = threadIdx.x; idx < kRows * n; idx += blockDim.x) {
    const int i = idx / n;
    const int k = idx - i * n;
    a_tile[idx] = (row0 + i < m) ? adj[(size_t)(row0 + i) * n + k] : 0.0f;
  }
  __syncthreads();

  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d) return;
  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.0f;
  // unrolled so that several V loads are in flight at once: with one
  // column per thread the loop is otherwise bound by load latency
#pragma unroll 8
  for (int k = 0; k < n; ++k) {
    const float v = vals[(size_t)k * d + j];
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] = fmaf(a_tile[i * n + k], v, acc[i]);
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    if (row0 + i < m) out[(size_t)(row0 + i) * d + j] = acc[i];
}

}  // namespace

// Largest N whose (kRows, N) float32 tile fits the 48 KB of shared memory a
// block may use without opting in.
extern "C" int bipartite_mix_max_n() { return (48 * 1024) / (kRows * 4); }

// adj: device float32 (m, n); vals: (n, d); out: (m, d), all row-major.
// Launches on `stream` and returns cudaGetLastError(); no synchronisation.
extern "C" int bipartite_mix_f32(const void* adj, const void* vals, void* out,
                                 int m, int n, int d, void* stream) {
  if (m <= 0 || d <= 0) return (int)cudaSuccess;
  dim3 grid((d + kThreads - 1) / kThreads, (m + kRows - 1) / kRows);
  const size_t smem = (size_t)kRows * (size_t)n * sizeof(float);
  bipartite_mix_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)adj, (const float*)vals, (float*)out, m, n, d);
  return (int)cudaGetLastError();
}
