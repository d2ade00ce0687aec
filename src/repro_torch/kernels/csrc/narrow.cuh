// Storage types of the replicas for Hopper (sm_90a): float32, bf16 and
// f16, shared by the kernels that read or write narrowed theta_hat, alpha
// and q_hat (bipartite_mix.cu, edge_gather_mix.cu, grouped_fused.cu).
//
// A narrowed value is widened to float32 exactly; every sum and product
// stays float32, and a narrowed output is rounded once, to nearest even
// (__float2bfloat16_rn / __float2half_rn, what torch's .to(dtype) and
// XLA's convert do). Four narrowed values travel as one 8-byte uint2, so
// a thread that handled a float4 of float32 handles the same four columns
// in half the bytes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace narrow {

// The C entries' dtype codes (kernels/*.py pass them as ints).
enum Code { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float widen(__half x) { return __half2float(x); }

template <class T> __device__ __forceinline__ T round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 round_to<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half round_to<__half>(float x) {
  return __float2half_rn(x);
}

// Four consecutive values of T as one aligned access: a float4 of float32,
// a uint2 of two-byte types (Raw: the type that moves them unconverted).
template <class T> struct Quad { using Raw = uint2; };
template <> struct Quad<float> { using Raw = float4; };

template <class T>
__device__ __forceinline__ float4 load4(const T* p) {
  if constexpr (sizeof(T) == 4) {
    return *reinterpret_cast<const float4*>(p);
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* v = reinterpret_cast<const T*>(&raw);
    return make_float4(widen(v[0]), widen(v[1]), widen(v[2]), widen(v[3]));
  }
}

template <class T>
__device__ __forceinline__ void store4(T* p, float4 x) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = x;
  } else {
    uint2 raw;
    T* v = reinterpret_cast<T*>(&raw);
    v[0] = round_to<T>(x.x);
    v[1] = round_to<T>(x.y);
    v[2] = round_to<T>(x.z);
    v[3] = round_to<T>(x.w);
    *reinterpret_cast<uint2*>(p) = raw;
  }
}

}  // namespace narrow
