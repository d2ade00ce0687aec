// Stochastic quantize -> dequantize, paper Eqs. 14-20, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/stoch_quant.py::
// stoch_quantize (_quant_kernel). Per element of an (N, d) float32 buffer:
//
//   c   = (theta - q_prev + R) / D          D = max(delta, 1e-12)
//   q   = floor(c) + [u < c - floor(c)]     clipped to [0, 2R / D]
//   out = q_prev + D * q - R
//
// What bounds it on this card: bytes. It reads three (N, d) buffers and
// writes one, 16 N d bytes, and does about ten flops per element, far
// below the card's ridge point. At the main path's (64, 2000) that is
// 2.05 MB, about 0.6 us at 3.35 TB/s, so a single call is bound by the
// launch, not by memory.
//
// What the design does about it: one pass with nothing else in it. One
// thread per element, grid-stride along d inside a row; blockIdx.y is the
// row, so a block reads its row's delta and R once. Loads and stores are
// 16 bytes per thread (float4) over the part of the row that is 16-byte
// aligned, with scalar head and tail elements.
//
// Numerics: the divide must be correctly rounded (CUDA's '/' is, unless
// --use_fast_math) and no multiply-add may contract into an FMA, or floor(c)
// and the rebuilt value stop matching the plain version bit for bit. The
// intrinsics below pin each rounding; the build also passes -fmad=false.
// The uniforms are an input, as on the TPU: there is no in-kernel RNG.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksPerRow = 64;

__device__ __forceinline__ float quant_one(float t, float qp, float u,
                                           float sd, float r, float lv) {
  float c = __fdiv_rn(__fadd_rn(__fsub_rn(t, qp), r), sd);
  float fl = floorf(c);
  float q = __fadd_rn(fl, (u < __fsub_rn(c, fl)) ? 1.0f : 0.0f);
  q = fminf(fmaxf(q, 0.0f), lv);
  return __fsub_rn(__fadd_rn(qp, __fmul_rn(sd, q)), r);
}

__global__ void stoch_quantize_kernel(const float* __restrict__ theta,
                                      const float* __restrict__ qprev,
                                      const float* __restrict__ unif,
                                      const float* __restrict__ delta,
                                      const float* __restrict__ qrange,
                                      float* __restrict__ out, int d) {
  const int row = blockIdx.y;
  const float sd = fmaxf(delta[row], 1e-12f);
  const float r = qrange[row];
  const float lv = __fdiv_rn(__fmul_rn(2.0f, r), sd);
  const size_t base = (size_t)row * (size_t)d;
  const float* t_row = theta + base;
  const float* q_row = qprev + base;
  const float* u_row = unif + base;
  float* o_row = out + base;

  // Elements before the first 16-byte boundary of this row (all four
  // buffers share the alignment: the wrapper checks that their base
  // addresses agree modulo 16).
  const int mis = (int)((reinterpret_cast<uintptr_t>(t_row) >> 2) & 3);
  const int head = min(d, (4 - mis) & 3);
  const int n_vec = (d - head) >> 2;
  const int tail0 = head + 4 * n_vec;
  const int stride = blockDim.x * gridDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;

  for (int i = tid; i < head; i += stride)
    o_row[i] = quant_one(t_row[i], q_row[i], u_row[i], sd, r, lv);

  const float4* t4 = reinterpret_cast<const float4*>(t_row + head);
  const float4* q4 = reinterpret_cast<const float4*>(q_row + head);
  const float4* u4 = reinterpret_cast<const float4*>(u_row + head);
  float4* o4 = reinterpret_cast<float4*>(o_row + head);
  for (int i = tid; i < n_vec; i += stride) {
    float4 t = t4[i], q = q4[i], u = u4[i], o;
    o.x = quant_one(t.x, q.x, u.x, sd, r, lv);
    o.y = quant_one(t.y, q.y, u.y, sd, r, lv);
    o.z = quant_one(t.z, q.z, u.z, sd, r, lv);
    o.w = quant_one(t.w, q.w, u.w, sd, r, lv);
    o4[i] = o;
  }

  for (int i = tail0 + tid; i < d; i += stride)
    o_row[i] = quant_one(t_row[i], q_row[i], u_row[i], sd, r, lv);
}

}  // namespace

// All pointers are device float32, row-major (n, d) for theta / qprev /
// unif / out and (n,) for delta / qrange. Launches on `stream` and returns
// cudaGetLastError(); it does not synchronise.
extern "C" int stoch_quantize_f32(const void* theta, const void* qprev,
                                  const void* unif, const void* delta,
                                  const void* qrange, void* out, int n, int d,
                                  void* stream) {
  if (n <= 0 || d <= 0) return (int)cudaSuccess;
  const int per_block = 4 * kThreads;
  int bx = (d + per_block - 1) / per_block;
  if (bx > kMaxBlocksPerRow) bx = kMaxBlocksPerRow;
  dim3 grid(bx, n);
  stoch_quantize_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)theta, (const float*)qprev, (const float*)unif,
      (const float*)delta, (const float*)qrange, (float*)out, d);
  return (int)cudaGetLastError();
}
