// Single-token decode attention through a paged KV cache, for Hopper
// (sm_90a). Two kernels:
//
//   paged_oneshot_kernel  replaces src/repro/kernels/paged_attention.py::
//                         paged_attention_decode (_paged_attn_kernel): one
//                         softmax over the whole logits slab;
//   paged_online_kernel   replaces paged_attention_decode_online
//                         (_paged_attn_online_kernel): flash-decoding with a
//                         running max and normalizer.
//
// Inputs: q (B, H, hd) float32; pools (num_pages, ps, KV, hd_store) as
// float32, bf16 or uint8 codes (8-bit, or 4-bit with two codes per byte
// along hd, low nibble first); k_scale / v_scale (num_pages, ps, KV)
// float32 ranges for code pools; block_tables (B, P) int32 (clamped into
// the pool here as well); ctx_lens (B,) int32. Output (B, H, hd) float32.
// Slot s of logical page p holds position p*ps + s and is attended iff
// p*ps + s < ctx.
//
// Design. One block per (sequence, KV head): it covers the G = H / KV
// query heads of that KV head (G = 8 for tinyllama), so each K/V entry is
// read from device memory once per decode step. The block reads its own
// block-table row and walks its pages in logical order in tiles of whole
// pages (64 rows at ps = 16). A tile is loaded with 16-byte vector loads,
// one (row, 16-byte chunk) per thread, and its codes are dequantized in
// registers right after the load (x = Δ·q - R with Δ = max(2R / (2^b - 1),
// 1e-12), each rounding pinned with __f*_rn, as the plain version
// evaluates it); the float32 tile sits in shared memory with rows padded
// to hd + 1 floats, so the threads of a warp read distinct banks.
//
// One-shot: the (G, P·ps) float32 logits slab sits in shared memory. Pass
// 1 writes the masked logits (-1e30 past ctx) tile by tile; one softmax per
// head runs over the slab; pass 2 reloads V tile by tile and accumulates,
// per output (g, d), each page's sum into the float32 result in logical
// page order. Pages past ctx have probability exactly 0 and are not read;
// ctx = 0 masks every slot, so the softmax is uniform over all P·ps slots
// of the (clamped) table, the JAX kernel's result. Its shared memory grows
// with P·ps; kernels/ops.py picks the online kernel once the footprint
// passes half of the 227 KB a block may use.
//
// Online: per tile, K and V are loaded together, the logits go to a (G,
// tile) buffer, and each head's running max m, normalizer l and float32
// (G, hd) accumulator are rescaled by exp(m - m_new). Probabilities past
// ctx are masked to 0 (not only their logits: with m still at -1e30 they
// would exp to 1). Pages past ctx are skipped; ctx = 0 gives zeros.
//
// What bounds it on this card: bytes (the K/V entries and ranges of the
// pages up to ctx, read once; about 2 flops per byte of bf16 K/V). With
// one block per (sequence, KV head), 32 blocks at B = 8, KV = 4, it does
// not fill the 132 SMs: a simple kernel, limited by the latency of each
// block's tile loads at long contexts. Splitting the pages of a sequence
// over several blocks is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOut = 4;          // outputs (g, d) per thread: G*hd <= 1024
constexpr float kNegInf = -1e30f;

enum Kind { kF32 = 0, kBF16 = 1, kU8 = 2, kU4 = 3 };

template <int KIND>
struct Elems {                      // elements per 16-byte vector
  static constexpr int n = KIND == kF32 ? 4 : KIND == kBF16 ? 8
                           : KIND == kU8 ? 16 : 32;
};

struct Args {
  const float* q;
  const uint8_t* k_pages;
  const uint8_t* v_pages;
  const float* k_scale;
  const float* v_scale;
  const int* block_tables;
  const int* ctx_lens;
  float* out;
  int heads, num_kv, hd, ps, pages_per_seq, num_pages, row_bytes;
  int tile_rows;
  float levels, scale;
};

__device__ __forceinline__ float dequant(uint32_t code, float rng,
                                         float delta) {
  return __fsub_rn(__fmul_rn(delta, (float)code), rng);
}

template <int KIND>
__device__ __forceinline__ void unpack(uint4 raw, float rng, float levels,
                                       float* out) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  if constexpr (KIND == kF32) {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = __uint_as_float(w[i]);
  } else if constexpr (KIND == kBF16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    const float delta =
        fmaxf(__fdiv_rn(__fmul_rn(2.0f, rng), levels), 1e-12f);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint32_t b = (w[i >> 2] >> (8 * (i & 3))) & 0xffu;
      if constexpr (KIND == kU8) {
        out[i] = dequant(b, rng, delta);
      } else {
        out[2 * i] = dequant(b & 0xfu, rng, delta);
        out[2 * i + 1] = dequant(b >> 4, rng, delta);
      }
    }
  }
}

// rows [row0, row0 + rows) of this block's logical sequence of slots,
// dequantized into tile (rows x (hd + 1) floats)
template <int KIND>
__device__ void load_tile(const Args& a, const uint8_t* pool,
                          const float* scales, const int* bt_row, int kvh,
                          int row0, int rows, float* tile) {
  constexpr int EPV = Elems<KIND>::n;
  const int vpr = a.row_bytes >> 4;
  for (int v = threadIdx.x; v < rows * vpr; v += blockDim.x) {
    const int r = v / vpr;
    const int c = v - r * vpr;
    const int i = row0 + r;
    const int lp = i / a.ps;
    const int page = min(max(bt_row[lp], 0), a.num_pages - 1);
    const size_t entry =
        ((size_t)page * a.ps + (i - lp * a.ps)) * a.num_kv + kvh;
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(
        pool + entry * a.row_bytes + (size_t)c * 16));
    const float rng = KIND >= kU8 ? __ldg(scales + entry) : 0.0f;
    float vals[EPV];
    unpack<KIND>(raw, rng, a.levels, vals);
    float* dst = tile + r * (a.hd + 1) + c * EPV;
#pragma unroll
    for (int e = 0; e < EPV; ++e) dst[e] = vals[e];
  }
}

// masked, scaled logits of a K tile: dst[g * stride + r]
__device__ void tile_logits(const Args& a, const float* qs, const float* tile,
                            int groups, int row0, int rows, int ctx,
                            float* dst, int stride) {
  const int hd = a.hd;
  for (int pr = threadIdx.x; pr < groups * rows; pr += blockDim.x) {
    const int g = pr / rows;
    const int r = pr - g * rows;
    const float* qg = qs + g * hd;
    const float* kr = tile + r * (hd + 1);
    float acc = 0.0f;
    for (int d = 0; d < hd; ++d) acc = fmaf(qg[d], kr[d], acc);
    dst[g * stride + r] = row0 + r < ctx ? __fmul_rn(acc, a.scale) : kNegInf;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ void load_q(const Args& a, int b, int kvh,
                                       int groups, float* qs) {
  const float* src = a.q + ((size_t)b * a.heads + (size_t)kvh * groups) * a.hd;
  for (int i = threadIdx.x; i < groups * a.hd; i += blockDim.x) qs[i] = src[i];
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
paged_oneshot_kernel(const Args a) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int groups = a.heads / a.num_kv, hd = a.hd;
  const int slab_len = a.pages_per_seq * a.ps;
  float* qs = smem;
  float* slab = qs + groups * hd;
  float* tile = slab + groups * slab_len;
  const int ctx = a.ctx_lens[b];
  const int* bt_row = a.block_tables + (size_t)b * a.pages_per_seq;
  const int n_rows = ctx > 0
      ? min((ctx + a.ps - 1) / a.ps * a.ps, slab_len) : slab_len;
  load_q(a, b, kvh, groups, qs);
  __syncthreads();

  // pass 1: logits
  if (ctx > 0) {
    for (int row0 = 0; row0 < n_rows; row0 += a.tile_rows) {
      const int rows = min(a.tile_rows, n_rows - row0);
      load_tile<KIND>(a, a.k_pages, a.k_scale, bt_row, kvh, row0, rows, tile);
      __syncthreads();
      tile_logits(a, qs, tile, groups, row0, rows, ctx, slab + row0,
                  slab_len);
      __syncthreads();
    }
  } else {
    for (int i = threadIdx.x; i < groups * slab_len; i += blockDim.x)
      slab[i] = kNegInf;
    __syncthreads();
  }

  // one softmax per head over the slab (slots past n_rows are -1e30 and
  // would add exactly 0 to the sum)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int g = warp; g < groups; g += blockDim.x >> 5) {
    float* row = slab + g * slab_len;
    float m = kNegInf;
    for (int i = lane; i < n_rows; i += 32) m = fmaxf(m, row[i]);
    m = warp_max(m);
    float s = 0.0f;
    for (int i = lane; i < n_rows; i += 32) {
      const float e = expf(__fsub_rn(row[i], m));
      row[i] = e;
      s = __fadd_rn(s, e);
    }
    s = warp_sum(s);
    for (int i = lane; i < n_rows; i += 32) row[i] = __fdiv_rn(row[i], s);
  }
  __syncthreads();

  // pass 2: probs x V, each page's sum added in logical page order
  float acc[kMaxOut];
#pragma unroll
  for (int k = 0; k < kMaxOut; ++k) acc[k] = 0.0f;
  for (int row0 = 0; row0 < n_rows; row0 += a.tile_rows) {
    const int rows = min(a.tile_rows, n_rows - row0);
    load_tile<KIND>(a, a.v_pages, a.v_scale, bt_row, kvh, row0, rows, tile);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxOut; ++k) {
      const int o = threadIdx.x + k * blockDim.x;
      if (o >= groups * hd) break;
      const int g = o / hd, d = o - g * hd;
      const float* p = slab + g * slab_len + row0;
      for (int r0 = 0; r0 < rows; r0 += a.ps) {
        float page_sum = 0.0f;
        for (int r = r0; r < r0 + a.ps; ++r)
          page_sum = fmaf(p[r], tile[r * (hd + 1) + d], page_sum);
        acc[k] = __fadd_rn(acc[k], page_sum);
      }
    }
    __syncthreads();
  }
  float* dst = a.out + ((size_t)b * a.heads + (size_t)kvh * groups) * hd;
#pragma unroll
  for (int k = 0; k < kMaxOut; ++k) {
    const int o = threadIdx.x + k * blockDim.x;
    if (o < groups * hd) dst[o] = acc[k];
  }
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
paged_online_kernel(const Args a) {
  extern __shared__ float smem[];
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int groups = a.heads / a.num_kv, hd = a.hd, tr = a.tile_rows;
  const int slab_len = a.pages_per_seq * a.ps;
  float* qs = smem;
  float* kt = qs + groups * hd;
  float* vt = kt + tr * (hd + 1);
  float* lt = vt + tr * (hd + 1);          // (G, tile) logits, then probs
  float* m_run = lt + groups * tr;
  float* l_run = m_run + groups;
  float* alpha = l_run + groups;
  const int ctx = a.ctx_lens[b];
  const int* bt_row = a.block_tables + (size_t)b * a.pages_per_seq;
  const int n_rows = ctx > 0
      ? min((ctx + a.ps - 1) / a.ps * a.ps, slab_len) : 0;
  load_q(a, b, kvh, groups, qs);
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    m_run[g] = kNegInf;
    l_run[g] = 0.0f;
  }
  float acc[kMaxOut];
#pragma unroll
  for (int k = 0; k < kMaxOut; ++k) acc[k] = 0.0f;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int row0 = 0; row0 < n_rows; row0 += tr) {
    const int rows = min(tr, n_rows - row0);
    load_tile<KIND>(a, a.k_pages, a.k_scale, bt_row, kvh, row0, rows, kt);
    load_tile<KIND>(a, a.v_pages, a.v_scale, bt_row, kvh, row0, rows, vt);
    __syncthreads();
    tile_logits(a, qs, kt, groups, row0, rows, ctx, lt, tr);
    __syncthreads();
    for (int g = warp; g < groups; g += blockDim.x >> 5) {
      float* row = lt + g * tr;
      float m = kNegInf;
      for (int r = lane; r < rows; r += 32) m = fmaxf(m, row[r]);
      const float m_prev = m_run[g];
      const float m_new = fmaxf(m_prev, warp_max(m));
      float s = 0.0f;
      for (int r = lane; r < rows; r += 32) {
        const float p =
            row0 + r < ctx ? expf(__fsub_rn(row[r], m_new)) : 0.0f;
        row[r] = p;
        s = __fadd_rn(s, p);
      }
      s = warp_sum(s);
      if (lane == 0) {
        const float al = expf(__fsub_rn(m_prev, m_new));
        alpha[g] = al;
        l_run[g] = __fadd_rn(__fmul_rn(al, l_run[g]), s);
        m_run[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxOut; ++k) {
      const int o = threadIdx.x + k * blockDim.x;
      if (o >= groups * hd) break;
      const int g = o / hd, d = o - g * hd;
      const float* p = lt + g * tr;
      float pv = 0.0f;
      for (int r = 0; r < rows; ++r)
        pv = fmaf(p[r], vt[r * (hd + 1) + d], pv);
      acc[k] = __fadd_rn(__fmul_rn(alpha[g], acc[k]), pv);
    }
    __syncthreads();
  }
  float* dst = a.out + ((size_t)b * a.heads + (size_t)kvh * groups) * hd;
#pragma unroll
  for (int k = 0; k < kMaxOut; ++k) {
    const int o = threadIdx.x + k * blockDim.x;
    if (o < groups * hd) {
      const float l = l_run[o / hd];
      dst[o] = __fdiv_rn(acc[k], l > 0.0f ? l : 1.0f);
    }
  }
}

template <int KIND>
void (*pick(int online))(Args) {
  return online ? paged_online_kernel<KIND> : paged_oneshot_kernel<KIND>;
}

}  // namespace

// online: 0 = one-shot, 1 = online. kind: 0 float32, 1 bf16, 2 uint8
// 8-bit codes, 3 uint8 4-bit codes. All pointers are device memory,
// contiguous, 16-byte aligned (pools); the scale pointers may be null for
// kinds 0 and 1. row_bytes = hd_store * element size (a multiple of 16);
// smem_bytes is the dynamic shared memory of the chosen kernel's layout
// (computed by the caller). Launches on `stream`, returns
// cudaGetLastError() (or the error of setting the shared-memory limit);
// does not synchronise.
extern "C" int paged_attention_decode_f32(
    int online, int kind, const void* q, const void* k_pages,
    const void* v_pages, const void* k_scale, const void* v_scale,
    const void* block_tables, const void* ctx_lens, void* out, int batch,
    int heads, int num_kv, int hd, int ps, int pages_per_seq, int num_pages,
    int row_bytes, int tile_rows, float levels, float scale, int smem_bytes,
    void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  Args a{(const float*)q, (const uint8_t*)k_pages, (const uint8_t*)v_pages,
         (const float*)k_scale, (const float*)v_scale,
         (const int*)block_tables, (const int*)ctx_lens, (float*)out,
         heads, num_kv, hd, ps, pages_per_seq, num_pages, row_bytes,
         tile_rows, levels, scale};
  void (*fn)(Args) = nullptr;
  switch (kind) {
    case kF32: fn = pick<kF32>(online); break;
    case kBF16: fn = pick<kBF16>(online); break;
    case kU8: fn = pick<kU8>(online); break;
    case kU4: fn = pick<kU4>(online); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (smem_bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(num_kv, batch);
  fn<<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
