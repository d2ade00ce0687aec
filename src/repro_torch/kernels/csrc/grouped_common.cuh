// Shared device code of the grouped quantize kernels (grouped_quant.cu,
// grouped_fused.cu, grouped_fused_tiled.cu) for Hopper (sm_90a).
//
// The packed buffer is (N, D) float32, row-major and contiguous, so the
// whole of it is one run of N*D elements. A row's columns fall into the
// packing's column runs, each of one quantization group; a (row, run) pair
// is a "piece": N*S contiguous pieces tile the buffer, and inside a piece
// the group's side information (R, b, Δ) is one scalar. A kernel walks the
// pieces that overlap its element range, so every inner loop runs on
// per-piece constants and no (D,) column -> group map is ever read (at
// D = 134,277,912 that map would be as large as one operand row).
//
// The runs arrive by value in a kernel parameter (Segs, about 3 KB): at
// most kMaxSegs runs, whose column boundaries start at 0 and end at D.
//
// Numerics: every rounding is pinned with __f*_rn intrinsics (and the
// build passes -fmad=false), so the quantize chain and the Eq. (18)
// schedule match the plain PyTorch versions in kernels/ref.py and
// core/quantization.py bit for bit. expf/logf are the accurate library
// functions, as torch.exp/torch.log on the card; log2 divides by ln 2 (the
// plain version divides by a tensor, so the card does a true division).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gq {

constexpr int kMaxSegs = 256;
// float32(1e-12) and float32(0.693147182): the bits torch gives the
// plain versions' Python constants
constexpr float kEps = 0x1.197998p-40f;
constexpr float kLn2 = 0x1.62e43p-1f;

struct Segs {
  long long off[kMaxSegs + 1];  // column boundaries: off[0] = 0, off[n] = D
  int gid[kMaxSegs];            // group of run k
  int n;                        // number of runs
};

// Fill a Segs from host arrays; returns false if there are too many runs.
inline bool make_segs(Segs* s, const long long* off, const int* gid, int n) {
  if (n < 1 || n > kMaxSegs) return false;
  for (int k = 0; k < n; ++k) {
    s->off[k] = off[k];
    s->gid[k] = gid[k];
  }
  s->off[n] = off[n];
  s->n = n;
  return true;
}

// Stochastic quantize -> dequantize of one element (Eqs. 14, 15, 20), the
// chain of stoch_quant.cu.
__device__ __forceinline__ float quant_one(float t, float qp, float u,
                                           float sd, float r, float lv) {
  float c = __fdiv_rn(__fadd_rn(__fsub_rn(t, qp), r), sd);
  float fl = floorf(c);
  float q = __fadd_rn(fl, (u < __fsub_rn(c, fl)) ? 1.0f : 0.0f);
  q = fminf(fmaxf(q, 0.0f), lv);
  return __fsub_rn(__fadd_rn(qp, __fmul_rn(sd, q)), r);
}

struct Sched {
  float bits;
  float delta;
};

// Eq. (18) bit growth and the step Δ = 2R / (2^b - 1), step by step as
// quantization.required_bits / bit_schedule evaluate them in float32.
__device__ __forceinline__ Sched schedule(float bprev, float rnew,
                                          float rprev, float init,
                                          float omega, float b0,
                                          float bmax) {
  float levels_prev = __fsub_rn(expf(__fmul_rn(bprev, kLn2)), 1.0f);
  float ratio = __fdiv_rn(rnew, fmaxf(__fmul_rn(omega, rprev), kEps));
  float arg = __fadd_rn(1.0f, __fmul_rn(levels_prev, ratio));
  float b = ceilf(__fdiv_rn(logf(arg), kLn2));
  if (rprev <= kEps) b = bprev;
  if (!(init > 0.0f)) b = b0;
  b = fminf(fmaxf(b, 1.0f), bmax);
  float levels = __fsub_rn(expf(__fmul_rn(b, kLn2)), 1.0f);
  Sched s;
  s.bits = b;
  s.delta = __fdiv_rn(__fmul_rn(2.0f, rnew), fmaxf(levels, 1.0f));
  return s;
}

// Call f(row, group, lo, hi) for every non-empty piece of the element
// range [lo, hi) of the flat (N*D) buffer, in order. lo/hi must be the
// same for every thread of the block (f may synchronise the block).
template <class F>
__device__ __forceinline__ void for_each_piece(long long lo, long long hi,
                                               long long d, const Segs& s,
                                               F f) {
  if (lo >= hi) return;
  long long row = lo / d;
  const long long col = lo - row * d;
  int a = 0, b = s.n - 1;  // last run with off[k] <= col
  while (a < b) {
    const int mid = (a + b + 1) >> 1;
    if (s.off[mid] <= col) a = mid; else b = mid - 1;
  }
  int k = a;
  long long pos = lo;
  while (pos < hi) {
    const long long end = row * d + s.off[k + 1];
    const long long p_hi = end < hi ? end : hi;
    if (p_hi > pos) f(row, s.gid[k], pos, p_hi);
    pos = p_hi > pos ? p_hi : pos;
    if (++k == s.n) {
      k = 0;
      ++row;
    }
  }
}

// Block-strided visit of the elements [lo, hi): scalars up to the first
// multiple of 4, float4 over the aligned middle, scalars for the tail.
// Requires every (N, D) buffer to start on a 16-byte boundary (the
// wrappers check), so element e is 16-byte aligned iff e % 4 == 0.
template <class One, class Four>
__device__ __forceinline__ void visit(long long lo, long long hi, One one,
                                      Four four) {
  long long head = (lo + 3) & ~3LL;
  if (head > hi) head = hi;
  const long long vhi = head + ((hi - head) & ~3LL);
  for (long long e = lo + threadIdx.x; e < head; e += blockDim.x) one(e);
  for (long long e = head + 4LL * threadIdx.x; e < vhi;
       e += 4LL * blockDim.x)
    four(e);
  for (long long e = vhi + threadIdx.x; e < hi; e += blockDim.x) one(e);
}

// Max over the block (non-negative values); the result is valid in
// thread 0. sh holds 32 floats.
__device__ __forceinline__ float block_max(float v, float* sh) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) sh[w] = v;
  __syncthreads();
  const int nw = (blockDim.x + 31) >> 5;
  v = (threadIdx.x < nw) ? sh[threadIdx.x] : 0.0f;
  if (w == 0)
    for (int o = 16; o > 0; o >>= 1)
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  return v;
}

// Per-piece max |theta - q_prev| merged into acc[row * G + g] with an
// atomicMax on the float bits: for non-negative floats the bit patterns
// order as the values, and max does not depend on the order of merging.
__device__ __forceinline__ void reduce_piece(const float* __restrict__ theta,
                                             const float* __restrict__ qprev,
                                             float* acc, long long row,
                                             int g, int n_groups,
                                             long long lo, long long hi,
                                             float* sh) {
  float m = 0.0f;
  visit(lo, hi,
        [&](long long e) { m = fmaxf(m, fabsf(__fsub_rn(theta[e], qprev[e]))); },
        [&](long long e) {
          const float4 t = *reinterpret_cast<const float4*>(theta + e);
          const float4 q = *reinterpret_cast<const float4*>(qprev + e);
          m = fmaxf(m, fabsf(__fsub_rn(t.x, q.x)));
          m = fmaxf(m, fabsf(__fsub_rn(t.y, q.y)));
          m = fmaxf(m, fabsf(__fsub_rn(t.z, q.z)));
          m = fmaxf(m, fabsf(__fsub_rn(t.w, q.w)));
        });
  m = block_max(m, sh);
  if (threadIdx.x == 0 && m > 0.0f)
    atomicMax(reinterpret_cast<unsigned int*>(acc) + row * n_groups + g,
              __float_as_uint(m));
}

// Quantize the piece [lo, hi) with one group's Δ and R; with
// `passthrough`, a degenerate group (R <= 1e-12) keeps q_prev unchanged.
__device__ __forceinline__ void quantize_piece(
    const float* __restrict__ theta, const float* __restrict__ qprev,
    const float* __restrict__ unif, float* __restrict__ out, float delta,
    float r, bool passthrough, long long lo, long long hi) {
  if (passthrough && r <= kEps) {
    visit(lo, hi, [&](long long e) { out[e] = qprev[e]; },
          [&](long long e) {
            *reinterpret_cast<float4*>(out + e) =
                *reinterpret_cast<const float4*>(qprev + e);
          });
    return;
  }
  const float sd = fmaxf(delta, kEps);
  const float lv = __fdiv_rn(__fmul_rn(2.0f, r), sd);
  visit(lo, hi,
        [&](long long e) {
          out[e] = quant_one(theta[e], qprev[e], unif[e], sd, r, lv);
        },
        [&](long long e) {
          const float4 t = *reinterpret_cast<const float4*>(theta + e);
          const float4 q = *reinterpret_cast<const float4*>(qprev + e);
          const float4 u = *reinterpret_cast<const float4*>(unif + e);
          float4 o;
          o.x = quant_one(t.x, q.x, u.x, sd, r, lv);
          o.y = quant_one(t.y, q.y, u.y, sd, r, lv);
          o.z = quant_one(t.z, q.z, u.z, sd, r, lv);
          o.w = quant_one(t.w, q.w, u.w, sd, r, lv);
          *reinterpret_cast<float4*>(out + e) = o;
        });
}

}  // namespace gq
