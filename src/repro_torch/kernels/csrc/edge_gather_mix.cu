// Sparse neighbour sum over a degree-padded CSR table for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/edge_gather_mix.py::
// edge_gather_mix (_edge_gather_kernel): out[n] = sum_s valid[n, s] *
// V[nbr[n, s]], with V (N, d) float32, the table (N, S) int32 (S = max
// degree), the validity (N, S) float32 1/0, and out (N, d) float32. On the
// TPU the neighbour ids were scalar-prefetched so that the BlockSpec could
// DMA the gathered row block; here a block stages its rows' ids itself.
//
// Numerics, in both designs below: each output is summed in slot order from
// 0.0f, acc = acc + (w * v) with __fmul_rn/__fadd_rn (and -fmad=false), so
// the result is bit for bit the plain version's (fmaf where w is 0 or 1,
// which rounds the same: see below). Every slot is walked, padded ones
// included: a padded slot's value is its clamped row's, multiplied by its
// 0.0, so NaN or inf there reaches the output as on the TPU. Ids are
// clamped into [0, N) as the TPU block index is (pad ids may point
// anywhere; the table is never checked on the host).
//
// What bounds it on this card: bytes, V's referenced rows read once and out
// written once (the LM buffer: 4.3 GB, 1.28 ms at 3.35 TB/s). The first
// design (a grid row per output row, every thread reading each slot's id
// and then its V row from L2 or HBM) read (S + 1) rows per output row
// through a chain of two dependent loads a slot: 6.45 GB at the LM shape,
// 46 us for the star's 256 slots a row. Here:
//
// * Staged (V's column tile for all N rows fits 64 KB: N <= 1,024 at
//   float4 rows). A block owns a column tile of `tile` units (float4 where
//   d % 4 == 0 and V is 16-byte aligned, else float) and a group of `rows`
//   output rows. It copies its rows' ids and weights (one contiguous run of
//   the table, 16-byte cp.async) and V[0:N, tile] into shared memory, turns
//   each id into its clamped row's offset in the tile once, and every
//   output unit then walks its S slots out of shared memory in order; a
//   slot whose id repeats the one before takes the same value from
//   registers, not from shared memory again (the star's padded slots all
//   point at row 0). V crosses L2 once per row
//   group instead of (S + 1) times per output row: once from HBM at the LM
//   shape (N = 4, one row group), where blocks loop over column tiles (one
//   wave) through a ring of 4 stages. Where every weight of the block is 0
//   or 1 (every caller's table) the walk adds with one fmaf a slot, which
//   rounds as the product-then-add does for such weights.
// * Gather (N too large to stage). A block owns 8 rows, a warp each, and
//   32 units of columns; the rows' ids and weights are staged in shared
//   memory in chunks of slots, and each thread keeps its next 7 slots' V
//   units in flight in a private cp.async ring, so the walk is no longer a
//   chain of latencies. The adds stay in slot order.
//
// The host (kernels/edge_gather_mix.py::plan) picks the regime, tile, rows,
// slot chunk, grid and shared memory from the shapes; this launcher takes
// them as they are. Offsets are 64-bit: N x d reaches 537M floats on the LM
// buffer. Workers: any int count (the staged regime holds at most 16,384
// rows; the gather grid puts row groups in gridDim.x).

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

// The host's plan (kernels/edge_gather_mix.py::plan), field for field.
struct EdgePlan {
  long long cols;      // units per row: d / 4 when vec, else d
  int n, s, vec, gather, tile, rows, chunk, grid_x, grid_y, smem;
};

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 4;       // staged ring of column tiles
constexpr int kRing = 8;         // gather: slots in flight per thread
constexpr int kGatherRows = 8;   // gather: a warp per row
constexpr int kGatherTile = 32;  // gather: a lane per unit

template <bool VEC> struct Unit;
template <> struct Unit<true> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  static __device__ __forceinline__ T add(T acc, float w, T v) {
    acc.x = __fadd_rn(acc.x, __fmul_rn(w, v.x));
    acc.y = __fadd_rn(acc.y, __fmul_rn(w, v.y));
    acc.z = __fadd_rn(acc.z, __fmul_rn(w, v.z));
    acc.w = __fadd_rn(acc.w, __fmul_rn(w, v.w));
    return acc;
  }
  // w 0 or 1: the product is exact, so one fmaf rounds as the add above
  static __device__ __forceinline__ T add_exact(T acc, float w, T v) {
    acc.x = fmaf(w, v.x, acc.x);
    acc.y = fmaf(w, v.y, acc.y);
    acc.z = fmaf(w, v.z, acc.z);
    acc.w = fmaf(w, v.w, acc.w);
    return acc;
  }
  static __device__ __forceinline__ void copy(T* smem, const T* gmem) {
    async_copy::copy16(smem, gmem);
  }
  static __device__ __forceinline__ void copy_ca(T* smem, const T* gmem) {
    async_copy::copy16_ca(smem, gmem);
  }
};
template <> struct Unit<false> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.0f; }
  static __device__ __forceinline__ T add(T acc, float w, T v) {
    return __fadd_rn(acc, __fmul_rn(w, v));
  }
  static __device__ __forceinline__ T add_exact(T acc, float w, T v) {
    return fmaf(w, v, acc);
  }
  static __device__ __forceinline__ void copy(T* smem, const T* gmem) {
    async_copy::copy4_zfill(smem, gmem, 4);
  }
  static __device__ __forceinline__ void copy_ca(T* smem, const T* gmem) {
    async_copy::copy4_zfill(smem, gmem, 4);
  }
};

__device__ __forceinline__ int clamp_id(int id, int n) {
  return id < 0 ? 0 : (id >= n ? n - 1 : id);
}

__host__ __device__ constexpr int align16(int bytes) {
  return (bytes + 15) & ~15;
}

// Copies `count` consecutive slots of the table from flat offset `first`
// into ids / ws (cp.async into the caller's current commit group): 16
// bytes at a time where source and destination start on 16-byte
// boundaries, the rest 4.
__device__ __forceinline__ void stage_slots(int* ids, float* ws,
                                            const int* nbr, const float* valid,
                                            int64_t first, int count) {
  const int* t = nbr + first;
  const float* v = valid + first;
  const int body = ((reinterpret_cast<uintptr_t>(t) |
                     reinterpret_cast<uintptr_t>(v) |
                     reinterpret_cast<uintptr_t>(ids) |
                     reinterpret_cast<uintptr_t>(ws)) & 15) == 0
                       ? count & ~3 : 0;
  for (int e = 4 * threadIdx.x; e < body; e += 4 * kThreads) {
    async_copy::copy16(ids + e, t + e);
    async_copy::copy16(ws + e, v + e);
  }
  for (int e = body + threadIdx.x; e < count; e += kThreads) {
    async_copy::copy4_zfill(ids + e, t + e, 4);
    async_copy::copy4_zfill(ws + e, v + e, 4);
  }
}

// After the slots landed: each id clamped into [0, n) and multiplied by
// `scale` (a row's offset in the staged V tile), in place. Returns, to
// every thread, whether all `count` weights are 0 or 1.
__device__ __forceinline__ bool prepare_slots(int* ids, const float* ws,
                                              int count, int n, int scale) {
  bool exact = true;
  for (int e = threadIdx.x; e < count; e += kThreads) {
    ids[e] = clamp_id(ids[e], n) * scale;
    exact &= ws[e] == 0.0f || ws[e] == 1.0f;
  }
  return __syncthreads_and(exact);
}

// One output unit: its row's s slots (offsets off, weights wr) over the
// staged V tile vt, in slot order from 0. A slot whose offset repeats the
// one before reuses the value in registers (the star's padded slots all
// point at row 0). EXACT (every weight of the block 0 or 1): the add is one
// fmaf(w, v, acc), which rounds as acc + (w * v) does for such w (the
// product is exact). QUAD (s % 4 == 0): offsets and weights are read four
// at a time.
template <bool VEC, bool EXACT, bool QUAD>
__device__ __forceinline__ typename Unit<VEC>::T walk(
    const int* __restrict__ off, const float* __restrict__ wr,
    const typename Unit<VEC>::T* __restrict__ vt, int s) {
  using U = Unit<VEC>;
  using T = typename U::T;
  T acc = U::zero(), v = U::zero();
  int last = -1;
  auto step = [&](int o, float w) {
    if (o != last) v = vt[o];
    last = o;
    acc = EXACT ? U::add_exact(acc, w, v) : U::add(acc, w, v);
  };
  if constexpr (QUAD) {
    for (int j = 0; j < s; j += 4) {
      const int4 o = *reinterpret_cast<const int4*>(off + j);
      const float4 w = *reinterpret_cast<const float4*>(wr + j);
      step(o.x, w.x);
      step(o.y, w.y);
      step(o.z, w.z);
      step(o.w, w.w);
    }
  } else {
#pragma unroll 4
    for (int j = 0; j < s; ++j) step(off[j], wr[j]);
  }
  return acc;
}

template <bool VEC, bool EXACT, bool QUAD>
__device__ __forceinline__ void walk_rows(
    typename Unit<VEC>::T* __restrict__ o_u, const int* __restrict__ ids,
    const float* __restrict__ ws, const typename Unit<VEC>::T* __restrict__ vt,
    int s, int64_t row0, int rr, int nr, int pass, int64_t cols, int64_t c) {
  for (int r = rr; r < nr; r += pass)
    o_u[(row0 + r) * cols + c] =
        walk<VEC, EXACT, QUAD>(ids + r * s, ws + r * s, vt, s);
}

// Shared memory: the block's rows' slots, ids then weights, rows x s each
// (row r's slot j at r * s + j), then the ring of V tiles, each n x tile
// units (a tile's row j of V at j * tile).
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
edge_gather_staged_kernel(const float* __restrict__ vals,
                          const int* __restrict__ nbr,
                          const float* __restrict__ valid,
                          float* __restrict__ out, int n, int s,
                          int64_t cols, int tile, int rows) {
  using U = Unit<VEC>;
  using T = typename U::T;
  extern __shared__ __align__(16) unsigned char smem[];
  int* ids = reinterpret_cast<int*>(smem);
  float* ws = reinterpret_cast<float*>(smem + align16(rows * s * 4));
  T* ring = reinterpret_cast<T*>(smem + 2 * align16(rows * s * 4));
  const T* v_u = reinterpret_cast<const T*>(vals);
  T* o_u = reinterpret_cast<T*>(out);

  const int r0 = blockIdx.y * rows;
  const int nr = min(rows, n - r0);
  const int shift = __ffs(tile) - 1;           // tile is a power of two
  const int pass = kThreads >> shift;          // rows per pass
  const int cc = threadIdx.x & (tile - 1), rr = threadIdx.x >> shift;
  const int64_t col_tiles = (cols + tile - 1) >> shift;
  const int64_t first = blockIdx.x, stride = gridDim.x;
  const int tile_units = n * tile;
  const bool quad = (s & 3) == 0;

  auto issue = [&](int64_t t, int buf) {
    const int64_t c0 = t << shift;
    const int w = cols - c0 < tile ? (int)(cols - c0) : tile;
    T* dst = ring + (size_t)buf * tile_units;
    for (int e = threadIdx.x; e < tile_units; e += kThreads) {
      const int j = e & (tile - 1);
      if (j < w)
        U::copy(dst + e, v_u + (int64_t)(e >> shift) * cols + c0 + j);
    }
  };

  stage_slots(ids, ws, nbr, valid, (int64_t)r0 * s, nr * s);
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {      // the slots go with tile 0
    const int64_t t = first + k * stride;
    if (t < col_tiles) issue(t, k);
    async_copy::commit();
  }

  bool exact = false;
  for (int k = 0; first + k * stride < col_tiles; ++k) {
    async_copy::wait<kStages - 2>();
    __syncthreads();      // tile k (and the slots) landed; tile k - 1 is done
    if (k == 0) exact = prepare_slots(ids, ws, nr * s, n, tile);
    {
      const int64_t tn = first + (k + kStages - 1) * stride;
      if (tn < col_tiles) issue(tn, (k + kStages - 1) % kStages);
      async_copy::commit();
    }
    const T* vt = ring + (size_t)(k % kStages) * tile_units + cc;
    const int64_t c = ((first + k * stride) << shift) + cc;
    if (c >= cols) continue;
    if (exact) {
      if (quad)
        walk_rows<VEC, true, true>(o_u, ids, ws, vt, s, r0, rr, nr, pass,
                                   cols, c);
      else
        walk_rows<VEC, true, false>(o_u, ids, ws, vt, s, r0, rr, nr, pass,
                                    cols, c);
    } else {
      if (quad)
        walk_rows<VEC, false, true>(o_u, ids, ws, vt, s, r0, rr, nr, pass,
                                    cols, c);
      else
        walk_rows<VEC, false, false>(o_u, ids, ws, vt, s, r0, rr, nr, pass,
                                     cols, c);
    }
  }
  async_copy::wait<0>();
}

// Shared memory: ids then weights, kGatherRows x chunk each, then the
// per-thread V rings, kRing x kThreads units (thread t's entry k at
// k * kThreads + t).
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
edge_gather_gather_kernel(const float* __restrict__ vals,
                          const int* __restrict__ nbr,
                          const float* __restrict__ valid,
                          float* __restrict__ out, int n, int s,
                          int64_t cols, int chunk) {
  using U = Unit<VEC>;
  using T = typename U::T;
  extern __shared__ __align__(16) unsigned char smem[];
  int* ids = reinterpret_cast<int*>(smem);
  float* ws = reinterpret_cast<float*>(ids + kGatherRows * chunk);
  T* ring = reinterpret_cast<T*>(
                smem + align16(2 * kGatherRows * chunk * 4)) + threadIdx.x;
  const T* v_u = reinterpret_cast<const T*>(vals);
  T* o_u = reinterpret_cast<T*>(out);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kGatherRows;
  const int nr = min(kGatherRows, n - r0);
  const int64_t col_tiles = (cols + kGatherTile - 1) / kGatherTile;
  const int* iw = ids + warp * chunk;
  const float* ww = ws + warp * chunk;

  for (int64_t ct = blockIdx.y; ct < col_tiles; ct += gridDim.y) {
    const int64_t c = ct * kGatherTile + lane;
    const bool live = warp < nr && c < cols;
    const T* v_c = v_u + c;
    T acc = U::zero();
    for (int s0 = 0; s0 < s; s0 += chunk) {
      const int len = min(chunk, s - s0);
      __syncthreads();                 // the previous chunk is consumed
      for (int r = 0; r < nr; ++r)
        stage_slots(ids + r * chunk, ws + r * chunk, nbr, valid,
                    (int64_t)(r0 + r) * s + s0, len);
      async_copy::commit();
      async_copy::wait<0>();
      __syncthreads();
      prepare_slots(ids, ws, kGatherRows * chunk, n, 1);
      if (!live) continue;
#pragma unroll
      for (int k = 0; k < kRing - 1; ++k) {
        if (k < len) U::copy_ca(ring + k * kThreads, v_c + iw[k] * cols);
        async_copy::commit();
      }
      for (int j = 0; j < len; ++j) {
        const int jn = j + kRing - 1;
        if (jn < len)
          U::copy_ca(ring + (jn % kRing) * kThreads, v_c + iw[jn] * cols);
        async_copy::commit();
        async_copy::wait<kRing - 1>();   // this thread's slot j landed
        acc = U::add(acc, ww[j], ring[(j % kRing) * kThreads]);
      }
    }
    if (live) o_u[(int64_t)(r0 + warp) * cols + c] = acc;
  }
  async_copy::wait<0>();
}

template <class Kernel>
cudaError_t allow_smem(Kernel fn, int smem, int* allowed) {
  if (smem <= 48 * 1024 || smem <= *allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) *allowed = smem;
  return err;
}

template <bool VEC>
cudaError_t launch(const float* v, const int* t, const float* w, float* o,
                   const EdgePlan& p, cudaStream_t st) {
  static int allowed_staged = 0, allowed_gather = 0;   // per instantiation
  const dim3 grid((unsigned)p.grid_x, (unsigned)p.grid_y);
  cudaError_t err;
  if (p.gather) {
    auto fn = edge_gather_gather_kernel<VEC>;
    if ((err = allow_smem(fn, p.smem, &allowed_gather)) != cudaSuccess)
      return err;
    fn<<<grid, kThreads, p.smem, st>>>(v, t, w, o, p.n, p.s, p.cols,
                                       p.chunk);
  } else {
    auto fn = edge_gather_staged_kernel<VEC>;
    if ((err = allow_smem(fn, p.smem, &allowed_staged)) != cudaSuccess)
      return err;
    fn<<<grid, kThreads, p.smem, st>>>(v, t, w, o, p.n, p.s, p.cols, p.tile,
                                       p.rows);
  }
  return cudaGetLastError();
}

}  // namespace

// vals: device float32 (n, d); nbr: int32 (n, s); valid: float32 (n, s);
// out: float32 (n, d), all row-major and contiguous; vals 16-byte aligned
// with d % 4 == 0 where plan->vec. The plan is the host's, taken as given.
// Launches on `stream` and returns cudaGetLastError(); no synchronisation.
extern "C" int edge_gather_mix_f32(const void* vals, const void* nbr,
                                   const void* valid, void* out,
                                   const EdgePlan* plan, void* stream) {
  const EdgePlan& p = *plan;
  if (p.n <= 0 || p.cols <= 0) return (int)cudaSuccess;
  if (p.tile <= 0 || (p.tile & (p.tile - 1)) || p.tile > kThreads ||
      p.grid_x <= 0 || p.grid_y <= 0 || p.grid_y > 65535 || p.smem > 232448)
    return (int)cudaErrorInvalidValue;
  const float* v = (const float*)vals;
  const int* t = (const int*)nbr;
  const float* w = (const float*)valid;
  float* o = (float*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(p.vec ? launch<true>(v, t, w, o, p, st)
                     : launch<false>(v, t, w, o, p, st));
}
