// Dense neighbour mix out = A @ V for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bipartite_mix.py::
// bipartite_mix (_mix_kernel). A is the (M, N) 0/1 adjacency (or a row
// block of it), V the (N, d) stacked worker vectors, out (M, d), all
// float32 with float32 accumulation.
//
// Numerics, in both designs below: each output is one fmaf chain over k in
// ascending order from 0.0f, acc = fmaf(A[i, k], V[k, j], acc). No split
// over k, no tree reduction, no TF32 and no tensor cores: the mix feeds the
// exact local solve, and on a 0/1 graph this chain rounds as the sparse
// mix (edge_gather_mix.cu) does, bit for bit (fmaf(1, v, acc) rounds as
// acc + v, fmaf(0, v, acc) is acc). Zero-filled padding past N adds
// fmaf(0, 0, acc) = acc at the end of the chain.
//
// The launcher picks one design per regime from the shapes:
//
// * Wide, few workers (M, N <= 8: the LM trainer's (4, 4) x (4, 134M)
//   buffer). Bound by bytes: V read once, out written once (4 (N + M) d
//   bytes, 4.3 GB at the LM shape, 1.28 ms at 3.35 TB/s). One streaming
//   pass: A in shared memory, each thread takes 4 columns at a time with
//   16-byte loads of the N rows of V and 16-byte stores of the M rows of
//   out (a grid-stride loop, 64-bit offsets); one column at a time where d
//   is not a multiple of 4 or a row is not 16-byte aligned. Streaming
//   cache hints on both (__ldcs/__stcs) measured no faster.
// * General (any M, N). At (64, 64) x (64, 2000) it is bound by the
//   latency of a few loads and the launch, at (1024, 1024) x (1024, 2000) by
//   operations (2 M N d float32 flops, 63 us at 67 TFLOP/s). A
//   register-tiled product: where the grid fills the card, 128 x 128 block
//   tiles of 256 threads with an 8 x 8 register tile each; where it would
//   not (the convex shape: 16 such tiles), 32 x 64 tiles of 128 threads
//   with 4 x 4 each, 4x the blocks. A (transposed, rows padded against bank
//   conflicts) and V are staged in chunks of 16 k by cp.async into a ring
//   of 3 (5) stages, one barrier a chunk, so the whole k range of a
//   64-worker mix is in flight at once; a thread reads its A and V values
//   per k as float4s from shared memory. There is no limit on N: the first
//   design held a whole (8, N) A tile in shared memory and took at most
//   1,536 workers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int kWideMax = 8;         // M, N <= 8: the streaming design

constexpr int kThreads = 256;       // the wide design's block
constexpr int kBK = 16;             // k chunk of the tiled design
constexpr int kSMs = 132;

// A block tile of BM x BN outputs; each thread an (RM x 4) x (RN x 4)
// register tile, its row quads BM / RM apart and its column quads BN / RN
// apart, so a warp's float4 reads of a k row of the staged tiles are
// broadcasts (A) and contiguous (V).
template <int BM, int BN, int RM, int RN>
struct Tiling {
  static constexpr int kBM = BM, kBN = BN, kRM = RM, kRN = RN;
  static constexpr int kTY = BM / (4 * RM), kTX = BN / (4 * RN);
  static constexpr int kThreads = kTX * kTY;
  static constexpr int kPadM = BM + 4;          // A^T row stride (floats)
  static constexpr int kStage = kBK * kPadM + kBK * BN;   // floats
};
// 128 x 128 tiles of 8 x 8 per thread where the grid fills the card; 32 x
// 64 tiles of 4 x 4 (4x the blocks) where it would not
using Big = Tiling<128, 128, 2, 2>;
using Small = Tiling<32, 64, 1, 1>;
constexpr int kBigStages = 3, kSmallStages = 5;

template <bool VEC>
__global__ void __launch_bounds__(kThreads)
mix_wide_kernel(const float* __restrict__ adj,
                const float* __restrict__ vals, float* __restrict__ out,
                int m, int n, int64_t d) {
  __shared__ float a_s[kWideMax * kWideMax];
  if (threadIdx.x < m * n) a_s[threadIdx.x] = adj[threadIdx.x];
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t first = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (VEC) {
    const int64_t d4 = d / 4;
    const float4* v4 = reinterpret_cast<const float4*>(vals);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int64_t j = first; j < d4; j += stride) {
      float4 v[kWideMax];
#pragma unroll
      for (int k = 0; k < kWideMax; ++k)
        if (k < n) v[k] = __ldg(v4 + k * d4 + j);
#pragma unroll
      for (int i = 0; i < kWideMax; ++i) {
        if (i < m) {
          float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
          for (int k = 0; k < kWideMax; ++k) {
            if (k < n) {
              const float a = a_s[i * n + k];
              acc.x = fmaf(a, v[k].x, acc.x);
              acc.y = fmaf(a, v[k].y, acc.y);
              acc.z = fmaf(a, v[k].z, acc.z);
              acc.w = fmaf(a, v[k].w, acc.w);
            }
          }
          o4[i * d4 + j] = acc;
        }
      }
    }
  } else {
    for (int64_t j = first; j < d; j += stride) {
      float v[kWideMax];
#pragma unroll
      for (int k = 0; k < kWideMax; ++k)
        if (k < n) v[k] = __ldg(vals + k * d + j);
#pragma unroll
      for (int i = 0; i < kWideMax; ++i) {
        if (i < m) {
          float acc = 0.0f;
#pragma unroll
          for (int k = 0; k < kWideMax; ++k)
            if (k < n) acc = fmaf(a_s[i * n + k], v[k], acc);
          out[i * d + j] = acc;
        }
      }
    }
  }
}

// copy the chunk k0 .. k0 + kBK of A (transposed) and V into one stage
template <int BM, int BN, int RM, int RN, bool VEC>
__device__ __forceinline__ void issue_chunk(const float* adj,
                                            const float* vals, int m, int n,
                                            int d, int row0, int col0,
                                            int k0, float* stage) {
  using T = Tiling<BM, BN, RM, RN>;
  float* as = stage;
  float* vs = stage + kBK * T::kPadM;
  for (int e = threadIdx.x; e < BM * kBK; e += T::kThreads) {
    const int i = e / kBK, kk = e - i * kBK;      // coalesced along k
    const bool ok = row0 + i < m && k0 + kk < n;
    const float* src = ok ? adj + (size_t)(row0 + i) * n + (k0 + kk) : adj;
    async_copy::copy4_zfill(as + kk * T::kPadM + i, src, ok ? 4 : 0);
  }
  if constexpr (VEC) {
    for (int e = threadIdx.x; e < kBK * BN / 4; e += T::kThreads) {
      const int kk = e / (BN / 4), j = (e - kk * (BN / 4)) * 4;
      const bool ok = k0 + kk < n && col0 + j < d;
      const float* src = ok ? vals + (size_t)(k0 + kk) * d + (col0 + j)
                            : vals;
      async_copy::copy16_zfill(vs + kk * BN + j, src, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kBK * BN; e += T::kThreads) {
      const int kk = e / BN, j = e - kk * BN;
      const bool ok = k0 + kk < n && col0 + j < d;
      const float* src = ok ? vals + (size_t)(k0 + kk) * d + (col0 + j)
                            : vals;
      async_copy::copy4_zfill(vs + kk * BN + j, src, ok ? 4 : 0);
    }
  }
}

template <int BM, int BN, int RM, int RN, int STAGES, bool VEC>
__global__ void __launch_bounds__(Tiling<BM, BN, RM, RN>::kThreads)
mix_tiled_kernel(const float* __restrict__ adj,
                 const float* __restrict__ vals, float* __restrict__ out,
                 int m, int n, int d) {
  using T = Tiling<BM, BN, RM, RN>;
  extern __shared__ __align__(16) float tile_smem[];
  const int tx = threadIdx.x % T::kTX, ty = threadIdx.x / T::kTX;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int chunks = (n + kBK - 1) / kBK;
  float acc[4 * RM][4 * RN];
#pragma unroll
  for (int i = 0; i < 4 * RM; ++i)
#pragma unroll
    for (int j = 0; j < 4 * RN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < chunks)
      issue_chunk<BM, BN, RM, RN, VEC>(adj, vals, m, n, d, row0, col0,
                                       t * kBK, tile_smem + t * T::kStage);
    async_copy::commit();
  }
  for (int kt = 0; kt < chunks; ++kt) {
    async_copy::wait<STAGES - 2>();
    __syncthreads();                // chunk kt landed; chunk kt - 1 is done
    {
      const int tn = kt + STAGES - 1;
      if (tn < chunks)
        issue_chunk<BM, BN, RM, RN, VEC>(
            adj, vals, m, n, d, row0, col0, tn * kBK,
            tile_smem + (tn % STAGES) * T::kStage);
      async_copy::commit();
    }
    const float* as = tile_smem + (kt % STAGES) * T::kStage;
    const float* vs = as + kBK * T::kPadM;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4 * RM], b[4 * RN];
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(
            as + kk * T::kPadM + r * (BM / RM) + ty * 4);
        a[4 * r] = x.x; a[4 * r + 1] = x.y; a[4 * r + 2] = x.z;
        a[4 * r + 3] = x.w;
      }
#pragma unroll
      for (int c = 0; c < RN; ++c) {
        const float4 y = *reinterpret_cast<const float4*>(
            vs + kk * BN + c * (BN / RN) + tx * 4);
        b[4 * c] = y.x; b[4 * c + 1] = y.y; b[4 * c + 2] = y.z;
        b[4 * c + 3] = y.w;
      }
#pragma unroll
      for (int i = 0; i < 4 * RM; ++i)
#pragma unroll
        for (int j = 0; j < 4 * RN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  async_copy::wait<0>();

#pragma unroll
  for (int i = 0; i < 4 * RM; ++i) {
    const int r = row0 + (i / 4) * (BM / RM) + ty * 4 + (i % 4);
    if (r >= m) continue;
#pragma unroll
    for (int c = 0; c < RN; ++c) {
      const int c0 = col0 + c * (BN / RN) + tx * 4;
      float* dst = out + (size_t)r * d + c0;
      if (VEC && c0 + 4 <= d) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][4 * c], acc[i][4 * c + 1], acc[i][4 * c + 2],
                        acc[i][4 * c + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + j < d) dst[j] = acc[i][4 * c + j];
      }
    }
  }
}

template <class T, int STAGES, bool VEC>
cudaError_t launch_tiled(const float* a, const float* v, float* o, int m,
                         int n, int d, cudaStream_t s) {
  constexpr int BM = T::kBM, BN = T::kBN;
  auto fn = mix_tiled_kernel<BM, BN, T::kRM, T::kRN, STAGES, VEC>;
  const int smem = STAGES * T::kStage * (int)sizeof(float);
  static bool allowed = false;      // per instantiation
  if (!allowed && smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  allowed = true;
  dim3 grid((unsigned)((d + BN - 1) / BN), (unsigned)((m + BM - 1) / BM));
  fn<<<grid, T::kThreads, smem, s>>>(a, v, o, m, n, d);
  return cudaGetLastError();
}

}  // namespace

// adj: device float32 (m, n); vals: (n, d); out: (m, d), all row-major and
// contiguous. Picks the wide design for m, n <= 8 and the tiled one
// otherwise, each with 16-byte accesses where d is a multiple of 4 and vals
// and out are 16-byte aligned. Launches on `stream` and returns
// cudaGetLastError(); no synchronisation. m = 0 or d = 0 returns at once.
extern "C" int bipartite_mix_f32(const void* adj, const void* vals, void* out,
                                 int m, int n, int64_t d, void* stream) {
  if (m <= 0 || d <= 0) return (int)cudaSuccess;
  const bool vec = d % 4 == 0 && (uintptr_t)vals % 16 == 0 &&
                   (uintptr_t)out % 16 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* a = (const float*)adj;
  const float* v = (const float*)vals;
  float* o = (float*)out;
  if (m <= kWideMax && n <= kWideMax) {
    const int64_t cols = vec ? d / 4 : d;
    const int64_t blocks = (cols + kThreads - 1) / kThreads;
    const int grid = (int)(blocks < kSMs * 16 ? blocks : kSMs * 16);
    if (vec)
      mix_wide_kernel<true><<<grid, kThreads, 0, s>>>(a, v, o, m, n, d);
    else
      mix_wide_kernel<false><<<grid, kThreads, 0, s>>>(a, v, o, m, n, d);
    return (int)cudaGetLastError();
  }
  if (d > INT32_MAX - Big::kBN || (m + Small::kBM - 1) / Small::kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const int64_t big_blocks =
      (int64_t)((m + Big::kBM - 1) / Big::kBM) * ((d + Big::kBN - 1) / Big::kBN);
  const int di = (int)d;
  cudaError_t err;
  if (big_blocks >= kSMs / 2)
    err = vec ? launch_tiled<Big, kBigStages, true>(a, v, o, m, n, di, s)
              : launch_tiled<Big, kBigStages, false>(a, v, o, m, n, di, s);
  else
    err = vec ? launch_tiled<Small, kSmallStages, true>(a, v, o, m, n, di, s)
              : launch_tiled<Small, kSmallStages, false>(a, v, o, m, n, di, s);
  return (int)err;
}

