// Sparse neighbour sum over a degree-padded CSR table for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/edge_gather_mix.py::
// edge_gather_mix (_edge_gather_kernel): out[n] = sum_s valid[n, s] *
// V[nbr[n, s]], with V (N, d) float32, the table (N, S) int32 (S = max
// degree), the validity (N, S) float32 1/0, and out (N, d) float32. On the
// TPU the neighbour ids were scalar-prefetched so that the BlockSpec could
// DMA the gathered row block; here a block reads its row's ids itself.
//
// What bounds it on this card: bytes. Each output element takes S loads
// and 2 S flops, so it is far below the ridge point; the least it must move
// is V read once and out written once (2 x 4 N d bytes). A simple kernel
// reads every slot's row, padded ones included: (S + 1) rows of traffic
// per output row, most of it from HBM once d is wide (the LM buffer's rows
// are 537 MB each, far past the 50 MB L2).
//
// What the design does about it: one grid row (blockIdx.y) per worker n,
// blocks across d; every thread owns 16-byte float4 columns (a grid-stride
// loop) when d % 4 == 0 and the rows are 16-byte aligned, scalar columns
// otherwise, so the loads along d are coalesced and wide. The slot loop
// reads nbr[n, s] and valid[n, s], the same for the whole block (broadcast
// loads), clamps the id into [0, N) as the TPU block index is clamped (pad
// ids may point anywhere; the table is never checked on the host), and
// accumulates acc = acc + (w * v) from 0.0f with __fmul_rn/__fadd_rn (and
// -fmad=false), so the result is bit for bit the plain version's, padded
// slots multiplied by their 0.0 as on the TPU. Offsets are 64-bit: N x d
// reaches 537M floats on the LM buffer. Skipping padded loads, cp.async or
// TMA prefetch and splitting S for high-degree rows are left for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksX = 1 << 16;   // column blocks per worker row

__device__ __forceinline__ int clamp_id(int id, int n) {
  return id < 0 ? 0 : (id >= n ? n - 1 : id);
}

__global__ void edge_gather_mix_vec4_kernel(
    const float4* __restrict__ vals, const int* __restrict__ nbr,
    const float* __restrict__ valid, float4* __restrict__ out, int n, int s,
    int64_t d4) {
  const int row = blockIdx.y;
  const int* nbr_row = nbr + (int64_t)row * s;
  const float* valid_row = valid + (int64_t)row * s;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < d4;
       j += stride) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int k = 0; k < s; ++k) {
      const int src = clamp_id(__ldg(nbr_row + k), n);
      const float w = __ldg(valid_row + k);
      const float4 v = __ldg(vals + (int64_t)src * d4 + j);
      acc.x = __fadd_rn(acc.x, __fmul_rn(w, v.x));
      acc.y = __fadd_rn(acc.y, __fmul_rn(w, v.y));
      acc.z = __fadd_rn(acc.z, __fmul_rn(w, v.z));
      acc.w = __fadd_rn(acc.w, __fmul_rn(w, v.w));
    }
    out[(int64_t)row * d4 + j] = acc;
  }
}

__global__ void edge_gather_mix_scalar_kernel(
    const float* __restrict__ vals, const int* __restrict__ nbr,
    const float* __restrict__ valid, float* __restrict__ out, int n, int s,
    int64_t d) {
  const int row = blockIdx.y;
  const int* nbr_row = nbr + (int64_t)row * s;
  const float* valid_row = valid + (int64_t)row * s;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < d;
       j += stride) {
    float acc = 0.0f;
    for (int k = 0; k < s; ++k) {
      const int src = clamp_id(__ldg(nbr_row + k), n);
      const float w = __ldg(valid_row + k);
      acc = __fadd_rn(acc, __fmul_rn(w, __ldg(vals + (int64_t)src * d + j)));
    }
    out[(int64_t)row * d + j] = acc;
  }
}

}  // namespace

// Largest worker count the grid takes (gridDim.y).
extern "C" int edge_gather_mix_max_n() { return 65535; }

// vals: device float32 (n, d); nbr: int32 (n, s); valid: float32 (n, s);
// out: float32 (n, d), all row-major and contiguous. `vec4` selects the
// float4 path (the caller checks d % 4 == 0 and 16-byte alignment).
// Launches on `stream` and returns cudaGetLastError(); no synchronisation.
extern "C" int edge_gather_mix_f32(const void* vals, const void* nbr,
                                   const void* valid, void* out, int n, int s,
                                   long long d, int vec4, void* stream) {
  if (n <= 0 || d <= 0) return (int)cudaSuccess;
  const int64_t cols = vec4 ? d / 4 : d;
  int64_t bx = (cols + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  dim3 grid((unsigned)bx, (unsigned)n);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec4) {
    edge_gather_mix_vec4_kernel<<<grid, kThreads, 0, st>>>(
        (const float4*)vals, (const int*)nbr, (const float*)valid,
        (float4*)out, n, s, cols);
  } else {
    edge_gather_mix_scalar_kernel<<<grid, kThreads, 0, st>>>(
        (const float*)vals, (const int*)nbr, (const float*)valid, (float*)out,
        n, s, cols);
  }
  return (int)cudaGetLastError();
}
