// Single-token decode attention through a paged KV cache, for Hopper
// (sm_90a). One split-decode body, two contracts, chosen at compile time:
//
//   paged_decode_kernel<KIND, HD, true>   replaces src/repro/kernels/
//                         paged_attention.py::paged_attention_decode
//                         (_paged_attn_kernel, B7): at ctx = 0 the uniform
//                         average of V over all P·ps slots of the (clamped)
//                         table, the result of the JAX kernel's one softmax
//                         over a fully masked slab;
//   paged_decode_kernel<KIND, HD, false>  replaces paged_attention_decode_
//                         online (_paged_attn_online_kernel, B8): zeros at
//                         ctx = 0 (an inactive slot attends to nothing).
//
// Where ctx > 0 both are the softmax over the slots below ctx.
//
// Inputs: q (B, H, hd) float32; pools (num_pages, ps, KV, hd_store) as
// float32, bf16 or uint8 codes (8-bit, or 4-bit with two codes per byte
// along hd, low nibble first); k_scale / v_scale (num_pages, ps, KV)
// float32 ranges for code pools; block_tables (B, P) int32 (ids clamped
// into the pool here); ctx_lens (B,) int32. Output (B, H, hd) float32.
// Slot s of logical page p holds position p*ps + s and is attended iff
// p*ps + s < ctx. Codes dequantize as x = Δ·q - R with Δ = max(2R / (2^b
// - 1), 1e-12), each rounding pinned with __f*_rn, as the plain version
// evaluates it.
//
// What bounds it on this card: bytes (the K/V entries and ranges of the
// pages up to ctx, read once; about 2 flops per byte of bf16 K/V). The
// first designs (one block per (sequence, KV head): 32 blocks at B = 8,
// KV = 4, each walking its tiles in series; B7 with a (G, P·ps) logits slab
// in shared memory and a second pass over V) were bound by the latency of
// their loads instead: B7 84x and B8 341x their bounds. This design splits
// each sequence's slots over blocks (flash-decoding):
//
// * Grid (splits, KV·chunks, B). Chunk c of a KV head takes its query heads
//   [8c, 8c + 8): one chunk while G <= 8 (each K/V entry read once a call),
//   more where a KV head serves more query heads. A split is split_rows
//   slots (a whole number of 64-row tiles); splits = ceil(P·ps /
//   split_rows) comes from the table width alone, so the host never reads
//   ctx_lens. A split whose first slot lies at or past n_rows = ceil(ctx /
//   ps)·ps exits at once: pages past ctx are not read.
// * A block keeps its tiles' raw K/V bytes (and the code pools' ranges) in
//   a 3-stage shared-memory ring filled by 16-byte cp.async, two tiles in
//   flight while one is reduced, one barrier a tile. Codes are dequantized
//   from shared memory as they are read.
// * Each warp owns 8 rows of every tile and keeps its own online softmax:
//   the running max m and normalizer l per query head and a (G, hd)
//   accumulator in registers (m and l replicated over the lanes). q·K: a
//   row is split over hd / 8 lanes (8 elements each, q in registers), the
//   partial dots summed by shuffles; the lanes write the probabilities of
//   their rows to warp-private shared memory; P·V: each lane owns hd / 32
//   columns of every head. Probabilities past ctx are masked to 0.
// * At the end of its tiles a block merges its warps' (m, l, acc) through
//   shared memory and writes the merged partial (m, l per head, the
//   unnormalized (G, hd) accumulator) to a float32 workspace. The last
//   live split to arrive at the (sequence, KV head, chunk) — a ticket
//   counter taken after __threadfence — combines the live partials:
//   M = max m_s, out = Σ e^(m_s - M)·acc_s / Σ e^(m_s - M)·l_s (the (m, l)
//   table staged in shared memory, a warp per head for M and the
//   weights, the accumulators' loads over splits unrolled), and sets the
//   counter back to 0 for the next call. One live split writes its result
//   directly.
// * ctx = 0. Online: no split is live, and split 0 writes zeros. One-shot:
//   every slot of the table counts, each with logit 0, so every split is
//   live and reads V only (no K, no q·K); each probability is e^0 = 1, m is
//   0 in every split, and the combine divides the sum of V by Σ l = P·ps.
//   No -1e30 reaches an exponent as a maximum.
//
// The workspace and the counters are the wrapper's, kept across calls on
// one device; calls that share them must run in stream order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 64;                       // slots per tile
constexpr int kRowsPerWarp = kTile / kWarps;    // 8
constexpr int kStages = 3;                      // cp.async ring depth
constexpr int kMaxGroups = 8;                   // query heads per block

enum Kind { kF32 = 0, kBF16 = 1, kU8 = 2, kU4 = 3 };

struct Args {
  const float* q;
  const uint8_t* k_pages;
  const uint8_t* v_pages;
  const float* k_scale;
  const float* v_scale;
  const int* block_tables;
  const int* ctx_lens;
  float* out;
  float* ws;                        // (B, KV, splits, G, hd + 2) float32
  int* tickets;                     // (B, KV·chunks) int32, 0 between calls
  int heads, num_kv, ps, pages_per_seq, num_pages, split_rows, splits;
  float levels, scale;
};

__device__ __forceinline__ float dequant(uint32_t code, float rng,
                                         float delta) {
  return __fsub_rn(__fmul_rn(delta, (float)code), rng);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

template <int KIND, int HD>
struct Geo {
  static constexpr int kRowBytes = KIND == kF32 ? 4 * HD
                                   : KIND == kBF16 ? 2 * HD
                                   : KIND == kU8 ? HD : HD / 2;
  static constexpr int kVecPerRow = kRowBytes / 16;
  static constexpr int kLanesPerRow = HD / 8;     // q·K: 8 elements a lane
  static constexpr int kChunkBytes = kRowBytes / kLanesPerRow;
  static constexpr int kItems = HD / 32;          // q·K rows a lane
  static constexpr int kCols = HD / 32;           // P·V columns a lane
  // K rows, V rows, K ranges, V ranges
  static constexpr int kStageBytes = 2 * kTile * kRowBytes + 2 * kTile * 4;
};

__device__ __forceinline__ size_t slot_entry(const Args& a, const int* bt_row,
                                             int kvh, int i) {
  const int lp = i / a.ps;
  const int page = min(max(__ldg(bt_row + lp), 0), a.num_pages - 1);
  return ((size_t)page * a.ps + (i - lp * a.ps)) * a.num_kv + kvh;
}

// issue the copies of slots [row0, row0 + rows) into one ring stage: K and
// V, or V alone
template <int KIND, int HD>
__device__ __forceinline__ void issue_tile(const Args& a, const int* bt_row,
                                           int kvh, int row0, int rows,
                                           bool with_k, uint8_t* stage) {
  using G = Geo<KIND, HD>;
  const int n = rows * G::kVecPerRow;
  for (int v = threadIdx.x + (with_k ? 0 : n); v < 2 * n; v += kThreads) {
    const int which = v >= n;                     // 0: K, 1: V
    const int u = v - which * n;
    const int r = u / G::kVecPerRow;
    const int c = u - r * G::kVecPerRow;
    const size_t entry = slot_entry(a, bt_row, kvh, row0 + r);
    const uint8_t* pool = which ? a.v_pages : a.k_pages;
    async_copy::copy16(
        stage + (which * kTile + r) * G::kRowBytes + c * 16,
        pool + entry * G::kRowBytes + (size_t)c * 16);
  }
  if constexpr (KIND >= kU8) {
    float* rng = reinterpret_cast<float*>(stage + 2 * kTile * G::kRowBytes);
    for (int v = threadIdx.x + (with_k ? 0 : rows); v < 2 * rows;
         v += kThreads) {
      const int which = v >= rows;
      const int r = v - which * rows;
      const size_t entry = slot_entry(a, bt_row, kvh, row0 + r);
      async_copy::copy4_zfill(rng + which * kTile + r,
                              (which ? a.v_scale : a.k_scale) + entry, 4);
    }
  }
}

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// 8 consecutive elements of a row (q·K), dequantized
template <int KIND>
__device__ __forceinline__ void load8(const uint8_t* p, float rng,
                                      float delta, float* x) {
  if constexpr (KIND == kF32) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    const float4 w = *reinterpret_cast<const float4*>(p + 16);
    x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
    x[4] = w.x; x[5] = w.y; x[6] = w.z; x[7] = w.w;
  } else if constexpr (KIND == kBF16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = bf16_lo(w[i]);
      x[2 * i + 1] = bf16_hi(w[i]);
    }
  } else if constexpr (KIND == kU8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      x[i] = dequant(((i < 4 ? u.x : u.y) >> (8 * (i & 3))) & 0xffu, rng,
                     delta);
  } else {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = dequant((u >> (4 * i)) & 0xfu, rng, delta);
  }
}

// elements [d0, d0 + N) of a row (P·V), dequantized; N in {1, 2}
template <int KIND, int N>
__device__ __forceinline__ void load_cols(const uint8_t* row, int d0,
                                          float rng, float delta, float* x) {
  if constexpr (KIND == kF32) {
    const float* p = reinterpret_cast<const float*>(row) + d0;
    if constexpr (N == 2) {
      const float2 u = *reinterpret_cast<const float2*>(p);
      x[0] = u.x; x[1] = u.y;
    } else {
      x[0] = *p;
    }
  } else if constexpr (KIND == kBF16) {
    const uint16_t* p = reinterpret_cast<const uint16_t*>(row) + d0;
    if constexpr (N == 2) {
      const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
      x[0] = bf16_lo(u); x[1] = bf16_hi(u);
    } else {
      x[0] = __uint_as_float((uint32_t)*p << 16);
    }
  } else if constexpr (KIND == kU8) {
    const uint8_t* p = row + d0;
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = dequant(p[i], rng, delta);
  } else {
    // element e is nibble (e & 1) of byte e / 2, low nibble first
    if constexpr (N == 1) {
      x[0] = dequant((row[d0 >> 1] >> (4 * (d0 & 1))) & 0xfu, rng, delta);
    } else {
#pragma unroll
      for (int i = 0; i < N; i += 2) {
        const uint32_t b = row[(d0 + i) >> 1];
        x[i] = dequant(b & 0xfu, rng, delta);
        x[i + 1] = dequant(b >> 4, rng, delta);
      }
    }
  }
}

template <int KIND, int HD, bool ONESHOT>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const Args a) {
  using GE = Geo<KIND, HD>;
  constexpr int LPR = GE::kLanesPerRow;
  constexpr int NC = GE::kCols;
  constexpr int kCombStride = kMaxGroups * (HD + 2);
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;
  float* probs = reinterpret_cast<float*>(ring + kStages * GE::kStageBytes);
  float* deltas = probs + kWarps * kMaxGroups * kRowsPerWarp;
  float* comb = deltas + kWarps * 2 * kRowsPerWarp;
  int* last_flag = reinterpret_cast<int*>(comb + kWarps * kCombStride);
  float* table = reinterpret_cast<float*>(last_flag + 4);   // the combine's

  const int split = blockIdx.x, b = blockIdx.z;
  const int groups = a.heads / a.num_kv;
  const int chunks = (groups + kMaxGroups - 1) / kMaxGroups;
  const int kvh = blockIdx.y / chunks;
  const int g0 = (blockIdx.y - kvh * chunks) * kMaxGroups;
  const int gn = min(kMaxGroups, groups - g0);    // this block's query heads
  const int slab_len = a.pages_per_seq * a.ps;
  const int ctx = a.ctx_lens[b];
  const bool uniform = ONESHOT && ctx <= 0;       // every slot, logit 0
  const int n_rows = uniform ? slab_len
      : ctx > 0 ? min((ctx + a.ps - 1) / a.ps * a.ps, slab_len) : 0;
  const int live = (n_rows + a.split_rows - 1) / a.split_rows;
  const size_t head0 = (size_t)b * a.heads + (size_t)kvh * groups + g0;
  float* dst = a.out + head0 * HD;
  if (live == 0) {                  // online, ctx = 0: attends to nothing
    if (split == 0)
      for (int o = threadIdx.x; o < gn * HD; o += kThreads) dst[o] = 0.0f;
    return;
  }
  if (split >= live) return;
  const int* bt_row = a.block_tables + (size_t)b * a.pages_per_seq;
  const int row_begin = split * a.split_rows;
  const int row_end = min(row_begin + a.split_rows, n_rows);
  const int n_tiles = (row_end - row_begin + kTile - 1) / kTile;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) {
      const int r0 = row_begin + t * kTile;
      issue_tile<KIND, HD>(a, bt_row, kvh, r0, min(kTile, row_end - r0),
                           !uniform, ring + t * GE::kStageBytes);
    }
    async_copy::commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = lane % LPR;         // this lane's 8-element chunk of a row
  float q[kMaxGroups][8];
  const float* qsrc = a.q + head0 * HD + c * 8;
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      q[g][e] = g < gn ? __ldg(qsrc + g * HD + e) : 0.0f;
  float m_run[kMaxGroups], l_run[kMaxGroups], acc[kMaxGroups][NC];
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
    m_run[g] = kNegInf;
    l_run[g] = 0.0f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[g][j] = 0.0f;
  }
  float* wprobs = probs + warp * kMaxGroups * kRowsPerWarp;
  float* wdelta = deltas + warp * 2 * kRowsPerWarp;
  const int wr0 = warp * kRowsPerWarp;

  for (int t = 0; t < n_tiles; ++t) {
    async_copy::wait<kStages - 2>();
    __syncthreads();                // tile t landed; tile t - 1 is done
    {
      const int tn = t + kStages - 1;
      if (tn < n_tiles) {
        const int r0 = row_begin + tn * kTile;
        issue_tile<KIND, HD>(a, bt_row, kvh, r0, min(kTile, row_end - r0),
                             !uniform, ring + (tn % kStages) * GE::kStageBytes);
      }
      async_copy::commit();
    }
    const uint8_t* stage = ring + (t % kStages) * GE::kStageBytes;
    const uint8_t* kraw = stage;
    const uint8_t* vraw = stage + kTile * GE::kRowBytes;
    const float* krng =
        reinterpret_cast<const float*>(stage + 2 * kTile * GE::kRowBytes);
    const float* vrng = krng + kTile;
    const int row0 = row_begin + t * kTile;
    const int wrows = max(0, min(kRowsPerWarp, row_end - row0 - wr0));
    if (wrows == 0) continue;

    if constexpr (KIND >= kU8) {    // step sizes of this warp's rows
      if (lane < 2 * kRowsPerWarp) {
        const int r = lane % kRowsPerWarp, which = lane / kRowsPerWarp;
        if (r < wrows && (which || !uniform)) {
          const float rng = (which ? vrng : krng)[wr0 + r];
          wdelta[lane] =
              fmaxf(__fdiv_rn(__fmul_rn(2.0f, rng), a.levels), 1e-12f);
        }
      }
      __syncwarp();
    }

    // q·K of the warp's rows: partial dots over each lane's 8 elements,
    // summed over the row's lanes (all 0 for the one-shot ctx = 0 row)
    float s[GE::kItems][kMaxGroups];
    if (uniform) {
#pragma unroll
      for (int it = 0; it < GE::kItems; ++it)
#pragma unroll
        for (int g = 0; g < kMaxGroups; ++g) s[it][g] = 0.0f;
    } else {
#pragma unroll
      for (int it = 0; it < GE::kItems; ++it) {
        const int rr = (it * 32 + lane) / LPR;
        float x[8];
        if (rr < wrows) {
          const int r = wr0 + rr;
          float rng = 0.0f, delta = 0.0f;
          if constexpr (KIND >= kU8) {
            rng = krng[r];
            delta = wdelta[rr];
          }
          load8<KIND>(kraw + r * GE::kRowBytes + c * GE::kChunkBytes, rng,
                      delta, x);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) x[e] = 0.0f;
        }
#pragma unroll
        for (int g = 0; g < kMaxGroups; ++g) {
          float d = 0.0f;
#pragma unroll
          for (int e = 0; e < 8; ++e) d = fmaf(q[g][e], x[e], d);
          s[it][g] = d;
        }
      }
#pragma unroll
      for (int it = 0; it < GE::kItems; ++it)
#pragma unroll
        for (int g = 0; g < kMaxGroups; ++g)
#pragma unroll
          for (int o = LPR / 2; o > 0; o >>= 1)
            s[it][g] = __fadd_rn(s[it][g],
                                 __shfl_xor_sync(kFull, s[it][g], o));
    }

    // masked, scaled logits; the new running max of each head
    float m_new[kMaxGroups];
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) m_new[g] = kNegInf;
#pragma unroll
    for (int it = 0; it < GE::kItems; ++it) {
      const int rr = (it * 32 + lane) / LPR;
      const bool ok = rr < wrows && (uniform || row0 + wr0 + rr < ctx);
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g) {
        s[it][g] = ok ? __fmul_rn(s[it][g], a.scale) : kNegInf;
        m_new[g] = fmaxf(m_new[g], s[it][g]);
      }
    }
    float alpha[kMaxGroups];
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
#pragma unroll
      for (int o = 16; o >= LPR; o >>= 1)
        m_new[g] = fmaxf(m_new[g], __shfl_xor_sync(kFull, m_new[g], o));
      m_new[g] = fmaxf(m_run[g], m_new[g]);
      alpha[g] = expf(__fsub_rn(m_run[g], m_new[g]));
      m_run[g] = m_new[g];
    }
    // probabilities (0 past ctx): lane c of a row writes the heads g with
    // g % LPR == c
#pragma unroll
    for (int it = 0; it < GE::kItems; ++it) {
      const int rr = (it * 32 + lane) / LPR;
      const bool ok = rr < wrows && (uniform || row0 + wr0 + rr < ctx);
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g)
        if (g < gn && g % LPR == c)
          wprobs[g * kRowsPerWarp + rr] =
              ok ? expf(__fsub_rn(s[it][g], m_run[g])) : 0.0f;
    }
    __syncwarp();

    // P·V over the warp's rows in order, into the rescaled accumulators
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      l_run[g] = __fmul_rn(alpha[g], l_run[g]);
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[g][j] = __fmul_rn(alpha[g], acc[g][j]);
    }
    for (int rr = 0; rr < wrows; ++rr) {
      const int r = wr0 + rr;
      float rng = 0.0f, delta = 0.0f;
      if constexpr (KIND >= kU8) {
        rng = vrng[r];
        delta = wdelta[kRowsPerWarp + rr];
      }
      float v[NC];
      load_cols<KIND, NC>(vraw + r * GE::kRowBytes, lane * NC, rng, delta, v);
#pragma unroll
      for (int g = 0; g < kMaxGroups; ++g) {
        if (g < gn) {
          const float p = wprobs[g * kRowsPerWarp + rr];
          l_run[g] = __fadd_rn(l_run[g], p);
#pragma unroll
          for (int j = 0; j < NC; ++j) acc[g][j] = fmaf(p, v[j], acc[g][j]);
        }
      }
    }
    __syncwarp();                   // wprobs / wdelta are rewritten next tile
  }
  async_copy::wait<0>();

  // merge the warps: (acc (G, hd), m (G), l (G)) per warp
  {
    float* cw = comb + warp * kCombStride;
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      if (g < gn) {
#pragma unroll
        for (int j = 0; j < NC; ++j) cw[g * HD + lane * NC + j] = acc[g][j];
        if (lane == 0) {
          cw[kMaxGroups * HD + g] = m_run[g];
          cw[kMaxGroups * HD + kMaxGroups + g] = l_run[g];
        }
      }
    }
  }
  __syncthreads();
  const bool single = live == 1;
  // this (sequence, KV head)'s partials: (splits, G, hd + 2), this block's
  // heads from g0
  const size_t pstride = (size_t)groups * (HD + 2);
  float* parts = a.ws + ((size_t)b * a.num_kv + kvh) * a.splits * pstride
                 + (size_t)g0 * (HD + 2);
  float* part = parts + split * pstride;
  for (int o = threadIdx.x; o < gn * HD; o += kThreads) {
    const int g = o / HD, d = o - g * HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, comb[w * kCombStride + kMaxGroups * HD + g]);
    float l = 0.0f, sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* cw = comb + w * kCombStride;
      const float e = expf(__fsub_rn(cw[kMaxGroups * HD + g], mx));
      l = __fadd_rn(l, __fmul_rn(e, cw[kMaxGroups * HD + kMaxGroups + g]));
      sum = __fadd_rn(sum, __fmul_rn(e, cw[g * HD + d]));
    }
    if (single) {
      dst[o] = __fdiv_rn(sum, l > 0.0f ? l : 1.0f);
    } else {
      part[g * (HD + 2) + d] = sum;
      if (d == 0) {
        part[g * (HD + 2) + HD] = mx;
        part[g * (HD + 2) + HD + 1] = l;
      }
    }
  }
  if (single) return;

  // the last live split to arrive combines the partials
  __threadfence();
  __syncthreads();
  int* ticket = a.tickets + (size_t)b * gridDim.y + blockIdx.y;
  if (threadIdx.x == 0) {
    const int last = atomicAdd(ticket, 1) == live - 1;
    if (last) *ticket = 0;          // every live split has arrived
    *last_flag = last;
  }
  __syncthreads();
  if (!*last_flag) return;
  __threadfence();
  // stage the live splits' (m, l), turn m into weights e^(m_s - M) and
  // sum the normalizer per head (a warp per head), then each output's
  // weighted sum over the splits' accumulators
  float* wt = table;                          // (live, gn): m, then weights
  float* lt = table + a.splits * kMaxGroups;  // (live, gn): l
  float* norm = lt + a.splits * kMaxGroups;   // (gn,)
  for (int i = threadIdx.x; i < live * gn; i += kThreads) {
    const int sp = i / gn, g = i - sp * gn;
    const float* p = parts + sp * pstride + g * (HD + 2);
    wt[i] = __ldcg(p + HD);
    lt[i] = __ldcg(p + HD + 1);
  }
  __syncthreads();
  for (int g = warp; g < gn; g += kWarps) {
    float mx = kNegInf;
    for (int sp = lane; sp < live; sp += 32) mx = fmaxf(mx, wt[sp * gn + g]);
    mx = warp_max(mx);
    float l = 0.0f;
    for (int sp = lane; sp < live; sp += 32) {
      const float e = expf(__fsub_rn(wt[sp * gn + g], mx));
      wt[sp * gn + g] = e;
      l = __fadd_rn(l, __fmul_rn(e, lt[sp * gn + g]));
    }
    l = warp_sum(l);
    if (lane == 0) norm[g] = l > 0.0f ? l : 1.0f;
  }
  __syncthreads();
  for (int o = threadIdx.x; o < gn * HD; o += kThreads) {
    const int g = o / HD, d = o - g * HD;
    const float* pg = parts + g * (HD + 2) + d;
    float sum = 0.0f;
#pragma unroll 16
    for (int sp = 0; sp < live; ++sp)
      sum = __fadd_rn(sum, __fmul_rn(wt[sp * gn + g],
                                     __ldcg(pg + sp * pstride)));
    dst[o] = __fdiv_rn(sum, norm[g]);
  }
}

using Kernel = void (*)(Args);

template <bool ONESHOT, int HD>
Kernel pick_kind(int kind) {
  switch (kind) {
    case kF32: return paged_decode_kernel<kF32, HD, ONESHOT>;
    case kBF16: return paged_decode_kernel<kBF16, HD, ONESHOT>;
    case kU8: return paged_decode_kernel<kU8, HD, ONESHOT>;
    case kU4: return paged_decode_kernel<kU4, HD, ONESHOT>;
    default: return nullptr;
  }
}

template <bool ONESHOT>
Kernel pick(int kind, int hd) {
  switch (hd) {
    case 32: return pick_kind<ONESHOT, 32>(kind);
    case 64: return pick_kind<ONESHOT, 64>(kind);
    default: return nullptr;
  }
}

}  // namespace

// One decode call: the one-shot contract (B7) when `oneshot`, else the
// online one (B8). kind: 0 float32, 1 bf16, 2 uint8 8-bit codes, 3 uint8
// 4-bit codes; hd 32 or 64. All pointers are device memory, contiguous,
// pools 16-byte aligned; the scale pointers may be null for kinds 0 and 1.
// workspace: float32 (batch, num_kv, splits, heads / num_kv, hd + 2);
// tickets: int32 (batch, num_kv, ceil(heads / num_kv / 8)), 0 before the
// first call (every call leaves them at 0). split_rows is a multiple of 64
// and splits = ceil(pages_per_seq·ps / split_rows). smem_bytes: the ring,
// the warps' probabilities, step sizes and merge area, a 16-byte flag and
// the combine's 2 x splits x 8 + 8 floats (computed by the caller).
// Launches on `stream`, returns cudaGetLastError() (or the error of setting
// the shared-memory limit); does not synchronise.
extern "C" int paged_decode_f32(
    int oneshot, int kind, const void* q, const void* k_pages,
    const void* v_pages, const void* k_scale, const void* v_scale,
    const void* block_tables, const void* ctx_lens, void* out,
    void* workspace, void* tickets, int batch, int heads, int num_kv, int hd,
    int ps, int pages_per_seq, int num_pages, int split_rows, int splits,
    float levels, float scale, int smem_bytes, void* stream) {
  if (batch <= 0) return (int)cudaSuccess;
  if (split_rows % kTile || splits <= 0 || num_kv <= 0 || heads % num_kv)
    return (int)cudaErrorInvalidValue;
  const int chunks = (heads / num_kv + kMaxGroups - 1) / kMaxGroups;
  if ((long long)num_kv * chunks > 65535 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  Kernel fn = oneshot ? pick<true>(kind, hd) : pick<false>(kind, hd);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  Args a{(const float*)q, (const uint8_t*)k_pages, (const uint8_t*)v_pages,
         (const float*)k_scale, (const float*)v_scale,
         (const int*)block_tables, (const int*)ctx_lens, (float*)out,
         (float*)workspace, (int*)tickets, heads, num_kv, ps, pages_per_seq,
         num_pages, split_rows, splits, levels, scale};
  // dynamic shared memory already allowed, bytes, per kernel
  static int allowed[2][4][2] = {};
  int& have = allowed[oneshot ? 1 : 0][kind][hd == 32 ? 0 : 1];
  if (smem_bytes > have) {
    if (smem_bytes > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
      if (err != cudaSuccess) return (int)err;
    }
    have = smem_bytes;
  }
  dim3 grid(splits, num_kv * chunks, batch);
  fn<<<grid, kThreads, smem_bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
