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
// launch and one round trip to memory, not by the bytes.
//
// What the design does about it: one flat pass over the N d elements,
// sized to the work. The four buffers are one run of groups of 4 elements:
// 16-byte accesses where all of them are 16-byte aligned (scalar ones
// otherwise), and the last N d % 4 elements one by one. A thread takes one
// group, and the grid has as many blocks as that needs, one wave at most (a
// grid-stride loop past it): 2 blocks at the paper's (24, 50), 125 at (64,
// 2000) (two groups a thread on half the blocks took 2.3 us against 1.9 on
// an H100). A group finds the row of its first element by exact integer
// division and carries it across d (no float reciprocal); every element
// loads its row's D and R (from L1: neighbours share them), so the data and
// row loads are in flight together, one round trip to memory; D and 2R / D
// are computed with the same rounded operations as before, once per row
// within a group. There is no worker limit beyond N d < 2^63.
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
constexpr int kMaxBlocks = 132 * (2048 / kThreads);   // one wave

__device__ __forceinline__ float quant_one(float t, float qp, float u,
                                           float sd, float r, float lv) {
  float c = __fdiv_rn(__fadd_rn(__fsub_rn(t, qp), r), sd);
  float fl = floorf(c);
  float q = __fadd_rn(fl, (u < __fsub_rn(c, fl)) ? 1.0f : 0.0f);
  q = fminf(fmaxf(q, 0.0f), lv);
  return __fsub_rn(__fadd_rn(qp, __fmul_rn(sd, q)), r);
}

__device__ __forceinline__ int64_t row_of(int64_t i, int d, bool narrow) {
  return narrow ? (int64_t)((uint32_t)i / (uint32_t)d) : i / d;
}

// One group of 4 consecutive elements: its inputs and each element's row
// parameters, all loads issued before any arithmetic.
struct Group {
  float t[4], q[4], u[4], dl[4], r[4];
};

template <bool VEC>
__device__ __forceinline__ void load_group(Group& g, const float* theta,
                                           const float* qprev,
                                           const float* unif,
                                           const float* delta,
                                           const float* qrange, int64_t gi,
                                           int d, bool narrow) {
  const int64_t i0 = 4 * gi;
  if constexpr (VEC) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(theta) + gi);
    const float4 q = __ldg(reinterpret_cast<const float4*>(qprev) + gi);
    const float4 u = __ldg(reinterpret_cast<const float4*>(unif) + gi);
    g.t[0] = t.x; g.t[1] = t.y; g.t[2] = t.z; g.t[3] = t.w;
    g.q[0] = q.x; g.q[1] = q.y; g.q[2] = q.z; g.q[3] = q.w;
    g.u[0] = u.x; g.u[1] = u.y; g.u[2] = u.z; g.u[3] = u.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      g.t[k] = __ldg(theta + i0 + k);
      g.q[k] = __ldg(qprev + i0 + k);
      g.u[k] = __ldg(unif + i0 + k);
    }
  }
  // the first element's row by division, the others' carried across d
  int64_t row = row_of(i0, d, narrow);
  int e = (int)(i0 - row * d);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (e == d) { ++row; e = 0; }
    g.dl[k] = __ldg(delta + row);
    g.r[k] = __ldg(qrange + row);
    ++e;
  }
}

template <bool VEC>
__device__ __forceinline__ void store_group(const Group& g, float* out,
                                            int64_t gi) {
  float o[4], sd = 0.0f, lv = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // D and 2R / D again only where the row's inputs differ (bitwise)
    if (k == 0 || __float_as_int(g.dl[k]) != __float_as_int(g.dl[k - 1]) ||
        __float_as_int(g.r[k]) != __float_as_int(g.r[k - 1])) {
      sd = fmaxf(g.dl[k], 1e-12f);
      lv = __fdiv_rn(__fmul_rn(2.0f, g.r[k]), sd);
    }
    o[k] = quant_one(g.t[k], g.q[k], g.u[k], sd, g.r[k], lv);
  }
  if constexpr (VEC) {
    reinterpret_cast<float4*>(out)[gi] = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) out[4 * gi + k] = o[k];
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
stoch_quantize_kernel(const float* __restrict__ theta,
                      const float* __restrict__ qprev,
                      const float* __restrict__ unif,
                      const float* __restrict__ delta,
                      const float* __restrict__ qrange,
                      float* __restrict__ out, int64_t total, int d) {
  const bool narrow = total <= (int64_t)UINT32_MAX;
  const int64_t groups = total / 4;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  for (int64_t g = tid; g < groups; g += stride) {
    Group a;
    load_group<VEC>(a, theta, qprev, unif, delta, qrange, g, d, narrow);
    store_group<VEC>(a, out, g);
  }
  const int64_t i = 4 * groups + tid;      // the last total % 4 elements
  if (i < total) {
    const int64_t row = row_of(i, d, narrow);
    const float sd = fmaxf(__ldg(delta + row), 1e-12f);
    const float r = __ldg(qrange + row);
    out[i] = quant_one(__ldg(theta + i), __ldg(qprev + i), __ldg(unif + i),
                       sd, r, __fdiv_rn(__fmul_rn(2.0f, r), sd));
  }
}

__global__ void empty_kernel() {}

}  // namespace

// All pointers are device float32, row-major (n, d) for theta / qprev /
// unif / out and (n,) for delta / qrange; total = n d. vec: the four (n, d)
// buffers are 16-byte aligned; blocks: the host's grid
// (kernels/stoch_quant.py::blocks). Launches on `stream` and returns
// cudaGetLastError(); it does not synchronise.
extern "C" int stoch_quantize_f32(const void* theta, const void* qprev,
                                  const void* unif, const void* delta,
                                  const void* qrange, void* out,
                                  long long total, int d, int vec, int blocks,
                                  void* stream) {
  if (total <= 0 || d <= 0) return (int)cudaSuccess;
  if (blocks <= 0 || blocks > kMaxBlocks) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  auto* fn = vec ? stoch_quantize_kernel<true> : stoch_quantize_kernel<false>;
  fn<<<blocks, kThreads, 0, st>>>(
      (const float*)theta, (const float*)qprev, (const float*)unif,
      (const float*)delta, (const float*)qrange, (float*)out, total, d);
  return (int)cudaGetLastError();
}

// An empty kernel on B1's grid: the floor that no launch of this geometry
// goes under (timed beside B1 by chip_smoke.py).
extern "C" int stoch_quantize_empty(int blocks, void* stream) {
  empty_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
