// Fused sLSTM recurrence over a whole sequence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/slstm_cell.py::slstm_cell
// (_cell_kernel): given the input projections wx (B, S, H, 4dh) (bf16 or
// float32, gates in the order i, f, z, o), the recurrent weights R
// (H, dh, 4dh) float32, the forget-gate bias (H, dh) float32 and the state
// c, n, m, h (B, H, dh) float32, it runs every time step
//
//   pre   = wx_t + h R                      (per head, float32)
//   log_f = logsigmoid(f + fbias)
//   m'    = max(log_f + m, i)
//   c'    = exp(log_f + m - m') c + exp(i - m') tanh(z)
//   n'    = max(exp(log_f + m - m') n + exp(i - m'), 1e-6)
//   h'    = sigmoid(o) c' / n'
//
// and writes hs (B, S, H, dh) float32 and the final state. The TPU kept one
// head's R (dh x 4dh float32: 576 KB at xlstm-125m's dh = 192) in VMEM for
// the whole sequence and carried the state across sequence chunks of its
// sequential grid.
//
// What bounds it on this card: neither bytes nor operations. Each of the S
// steps depends on the last, so a launch is a chain of S steps, and a step
// costs the latency of h R (its operands moved into the FMA units), of the
// gates and of passing the new h to every owner of a column. The first
// design (one block per (batch row, head), R left in device memory) read
// the head's whole R from L2 through one SM every step: 5.2-6.6 us a step
// (PERF.md, row 9).
//
// What this design does about it: R stays on chip for the whole launch, as
// the TPU kept it in VMEM. One R does not fit one block (227 KB), so a
// thread-block cluster of C CTAs on C SMs shares a (head, tile of up to 8
// batch rows): C = 1 up to dh 64, 2 up to 128, 4 up to 192, 8 up to 256
// (the wrapper picks C and the rows). CTA r owns the hidden units
// [r·U, (r+1)·U), U = ceil(dh / C), and the four gate columns (i, f, z, o)
// of each: R's dh x 4U slice (144 KB at dh 192, C 4), held in the
// registers of its threads for the whole sequence (faster on the card than
// the same slice in shared memory, PERF.md).
// * 16 lanes serve two units: lane s holds their eight gate columns over
//   the k slice k = 64 j + 4 s + e (j < ceil(dh / 64), e < 4), so one
//   float4 of h feeds 32 FMAs and the 16 lanes' loads cover 256
//   contiguous bytes of h (no bank conflict; one unit a lane read h twice
//   as often and was slower). The 16 slices' sums are reduced and
//   scattered by eight shuffles: lanes s and s ^ 8 add the low unit's
//   columns in the low lane and the high unit's in the high, s ^ 4 two
//   gates each, s ^ 2 one, then s ^ 1.
// * The sums go to shared memory, and behind one named barrier the first
//   warps compute the gates, thread i of them owning (row, unit) i: its
//   c, n, m in shared memory (the registers hold R), its wx loaded a step
//   ahead. Gates computed by the lanes that reduced them (two lanes of each
//   warp) cost the issue slots of every warp for the libm code: 1.3x the
//   step's time on the card.
// * The new h of a (row, unit) is stored into every CTA's copy of h with
//   st.async, which also counts its 4 bytes on that CTA's mbarrier; a CTA
//   waits on its own mbarrier for the rows x dh floats of the step, so no
//   barrier spans the cluster within the sequence (a cluster barrier a
//   step measured slower: it waits for every thread of C CTAs and its
//   release for the step's global stores). h is double-buffered, one
//   mbarrier a buffer: step t reads buf[t % 2] and writes buf[(t + 1) % 2].
//   That buffer was read at step t - 1, and a CTA writes it only after it
//   has received all of step t - 1's h, which every CTA stores only after
//   the named barrier that follows its reads. The cluster barrier at the
//   start orders the copies' and
//   barriers' initialisation before any remote store; the one at the end
//   keeps every CTA alive until all stores have landed.
// expf, tanhf and log1pf keep their accurate forms (no fast math), and the
// file is built with -fmad=false, so the gate arithmetic rounds as the
// plain version's separate operations do; only the matrix product uses
// explicit fmaf.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDh = 256;
constexpr int kMaxRows = 8;        // batch rows per cluster
constexpr unsigned kFull = 0xffffffffu;

// A k share of KJ float4s per column (k = 64 j + 4 s + e) of two units'
// eight columns: 32 KJ floats of R a thread, held in registers; threads a
// block may have at that share: 16 ceil(U / 2) with U <= 64 units up to
// dh 128, 48 at 192, 32 at 256
template <int KJ>
struct Shape {
  static constexpr int kThreads = KJ <= 2 ? 512 : KJ == 3 ? 384 : 256;
  static constexpr int kHp = 64 * KJ;           // a row of h, padded
};

struct Params {
  const void* wx;
  const float* r;
  const float* fbias;
  const float* c0;
  const float* n0;
  const float* m0;
  const float* h0;
  float* hs;
  float* c_out;
  float* n_out;
  float* m_out;
  float* h_out;
  int batch, seq, heads, dh, cluster, units, rows;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

// shared-memory barriers (mbarrier) that count the bytes of h stored into
// this CTA's copy
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// one arrival that also expects `bytes` more to be stored before the phase
// completes
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n"
      ::"r"(bar), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// store x into CTA `rank`'s shared memory at this CTA's address `local`,
// counted on that CTA's barrier at this CTA's address `bar`
__device__ __forceinline__ void store_remote(uint32_t local, uint32_t bar,
                                             uint32_t rank, float x) {
  uint32_t dst, dbar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(dst)
               : "r"(local), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(dbar)
               : "r"(bar), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.f32"
      " [%0], %1, [%2];" ::"r"(dst), "f"(x), "r"(dbar) : "memory");
}

template <typename T, int KJ>
__global__ void __launch_bounds__(Shape<KJ>::kThreads, 1)
slstm_cluster_kernel(const Params p) {
  using SH = Shape<KJ>;
  constexpr int HP = SH::kHp;
  __shared__ __align__(16) float h_s[2][kMaxRows][HP];
  __shared__ float pre_s[kMaxRows][4][64];          // the step's h R
  __shared__ __align__(8) uint64_t full[2];          // h_s[b] is complete
  // c, n, m of (row, unit) and the forget bias of each unit: in shared
  // memory, not in the registers that hold R
  __shared__ float cnm_s[3][kMaxRows][64];
  __shared__ float fb_s[64];
  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = p.cluster;
  const int rank = (int)cluster.block_rank();
  const int head = blockIdx.y;
  const int row0 = (blockIdx.x / n_cta) * p.rows;
  const int rows = min(p.rows, p.batch - row0);
  const int dh = p.dh, dh4 = 4 * dh;
  const int units = min(p.units, dh - rank * p.units);   // this CTA's
  const int unit0 = rank * p.units;
  const int sl = threadIdx.x & 15;              // k slice
  const int u0 = 2 * (threadIdx.x >> 4);        // this thread's two units

  // the four gate columns of units u0 and u0 + 1, k in this thread's slice
  float rr[2][4][KJ][4];
  {
    const float* col = p.r + (size_t)head * dh * dh4 + unit0 + u0;
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int g = 0; g < 4; ++g)
#pragma unroll
        for (int j = 0; j < KJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = 64 * j + 4 * sl + e;
            rr[u][g][j][e] = u0 + u < units && k < dh
                ? __ldg(col + (size_t)k * dh4 + (size_t)g * dh + u) : 0.0f;
          }
  }
  // both copies of h: h0 in buf 0, zeros elsewhere (padding stays 0)
  for (int i = threadIdx.x; i < 2 * kMaxRows * HP; i += blockDim.x) {
    const int buf = i / (kMaxRows * HP);
    const int r = (i / HP) % kMaxRows, k = i % HP;
    (&h_s[0][0][0])[i] =
        buf == 0 && r < rows && k < dh
            ? p.h0[((size_t)(row0 + r) * p.heads + head) * dh + k] : 0.0f;
  }

  // thread i < rows x units computes the gates of (row gr, unit gu): its
  // c, n, m in shared memory, its wx at step t (row0 + gr, t, head,
  // . + unit0 + gu) loaded a step ahead
  const bool gate = threadIdx.x < rows * units;
  const int gr = threadIdx.x / units, gu = threadIdx.x - gr * units;
  const T* wx = reinterpret_cast<const T*>(p.wx);
  const size_t at0 = (size_t)(row0 + gr) * p.seq * p.heads + head;
  // wx as loaded (widened only where used, so that the load is not waited
  // for at the step that issues it)
  T x[4] = {T(0.0f), T(0.0f), T(0.0f), T(0.0f)};
  if (gate) {
    const size_t st = ((size_t)(row0 + gr) * p.heads + head) * dh + unit0 + gu;
    cnm_s[0][gr][gu] = p.c0[st];
    cnm_s[1][gr][gu] = p.n0[st];
    cnm_s[2][gr][gu] = p.m0[st];
    if (gr == 0) fb_s[gu] = p.fbias[(size_t)head * dh + unit0 + gu];
    if (p.seq > 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) x[q] = wx[at0 * dh4 + q * dh + unit0 + gu];
    }
  }
  // h_s[b] takes rows x dh floats a step, one from each (row, unit)
  const uint32_t bytes = 4u * rows * dh;
  const uint32_t bar0 = smem_addr(&full[0]), bar1 = smem_addr(&full[1]);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0)
                 : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar1)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    bar_expect(bar0, bytes);        // steps 1 and 0's h
    bar_expect(bar1, bytes);
  }
  cluster.sync();                   // copies and barriers set, every CTA up

  // the warps with a unit; the first of them also compute the gates
  const int busy = 32 * ((units + 3) / 4);
  const bool gate_warp = threadIdx.x < 32 * ((rows * units + 31) / 32);
  for (int t = 0; threadIdx.x < busy && t <= p.seq; ++t) {
    const uint32_t bar_in = t & 1 ? bar1 : bar0, bar_out = t & 1 ? bar0 : bar1;
    if (t > 0) {                    // step t - 1's h, from every CTA
      bar_wait(bar_in, ((t - 1) >> 1) & 1);
      if (threadIdx.x == 0 && t + 1 < p.seq)
        bar_expect(bar_in, bytes);  // step t + 1's
    }
    if (t == p.seq) break;
    // h R: eight column sums (two units x four gates) over this thread's k
    // slice, per row, reduced and scattered over the 16 slices so that
    // lanes 2i and 2i + 1 end with column i (unit i / 4, gate i % 4)
    const float* hb = &h_s[t & 1][0][0] + 4 * sl;
    for (int r = 0; r < rows; ++r) {
      float a[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float4 hv =
            *reinterpret_cast<const float4*>(hb + r * HP + 64 * j);
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            a[u][g] = fmaf(hv.x, rr[u][g][j][0], a[u][g]);
            a[u][g] = fmaf(hv.y, rr[u][g][j][1], a[u][g]);
            a[u][g] = fmaf(hv.z, rr[u][g][j][2], a[u][g]);
            a[u][g] = fmaf(hv.w, rr[u][g][j][3], a[u][g]);
          }
      }
      // slices s and s ^ 8: the low one keeps unit u0, the high u0 + 1
      const bool hi8 = sl & 8, hi4 = sl & 4, hi2 = sl & 2;
      float k[4];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        k[g] = __fadd_rn(hi8 ? a[1][g] : a[0][g],
                         __shfl_xor_sync(kFull, hi8 ? a[0][g] : a[1][g], 8));
      // s ^ 4: gates (i, f) low, (z, o) high; s ^ 2: one gate; s ^ 1
      const float m0 = __fadd_rn(hi4 ? k[2] : k[0],
                                 __shfl_xor_sync(kFull, hi4 ? k[0] : k[2], 4));
      const float m1 = __fadd_rn(hi4 ? k[3] : k[1],
                                 __shfl_xor_sync(kFull, hi4 ? k[1] : k[3], 4));
      float sum = __fadd_rn(hi2 ? m1 : m0,
                            __shfl_xor_sync(kFull, hi2 ? m0 : m1, 2));
      sum = __fadd_rn(sum, __shfl_xor_sync(kFull, sum, 1));
      const int su = u0 + (sl >> 3);            // this lane's unit and gate
      if (!(sl & 1) && su < units) pre_s[r][(sl >> 1) & 3][su] = sum;
    }
    // every warp's sums before the gate warps read them (named barrier 1;
    // the others go on to wait for the next step's h)
    if (gate_warp)
      asm volatile("bar.sync 1, %0;" ::"r"(busy) : "memory");
    else
      asm volatile("bar.arrive 1, %0;" ::"r"(busy) : "memory");
    if (gate) {                     // the gates of (row gr, unit gu)
      float xf[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) xf[q] = to_f32(x[q]);
      const size_t at = at0 + (size_t)t * p.heads;
      if (t + 1 < p.seq) {          // the next step's wx, in flight now
#pragma unroll
        for (int q = 0; q < 4; ++q)
          x[q] = wx[(at + p.heads) * dh4 + q * dh + unit0 + gu];
      }
      const float c = cnm_s[0][gr][gu], n = cnm_s[1][gr][gu];
      const float m = cnm_s[2][gr][gu];
      const float i_pre = xf[0] + pre_s[gr][0][gu];
      const float log_f = log_sigmoid(xf[1] + pre_s[gr][1][gu] + fb_s[gu]);
      const float z_pre = xf[2] + pre_s[gr][2][gu];
      const float o_pre = xf[3] + pre_s[gr][3][gu];
      const float m_new = fmaxf(log_f + m, i_pre);
      const float i_sc = expf(i_pre - m_new);
      const float f_sc = expf(log_f + m - m_new);
      const float c_new = f_sc * c + i_sc * tanhf(z_pre);
      const float n_new = fmaxf(f_sc * n + i_sc, 1e-6f);
      const float h = (1.0f / (1.0f + expf(-o_pre))) * c_new / n_new;
      const uint32_t dst = smem_addr(&h_s[(t + 1) & 1][gr][unit0 + gu]);
      for (int cr = 0; cr < n_cta; ++cr)
        store_remote(dst, bar_out, cr, h);
      cnm_s[0][gr][gu] = c_new;
      cnm_s[1][gr][gu] = n_new;
      cnm_s[2][gr][gu] = m_new;
      p.hs[at * dh + unit0 + gu] = h;
    }
  }
  cluster.sync();                   // no store into another CTA in flight
  if (gate) {                       // the final state; h from the last copy
    const size_t st = ((size_t)(row0 + gr) * p.heads + head) * dh + unit0 + gu;
    p.c_out[st] = cnm_s[0][gr][gu];
    p.n_out[st] = cnm_s[1][gr][gu];
    p.m_out[st] = cnm_s[2][gr][gu];
    p.h_out[st] = h_s[p.seq & 1][gr][unit0 + gu];
  }
}

using Kernel = void (*)(const Params);

// the instantiation for dh: the smallest k share that covers it
Kernel pick(int dh, bool bf16, int* threads) {
#define SLSTM_PICK(KJ)                                                    \
  if (dh <= 64 * KJ) {                                                    \
    *threads = Shape<KJ>::kThreads;                                       \
    return bf16 ? slstm_cluster_kernel<__nv_bfloat16, KJ>                 \
                : slstm_cluster_kernel<float, KJ>;                        \
  }
  SLSTM_PICK(1) SLSTM_PICK(2) SLSTM_PICK(3) SLSTM_PICK(4)
#undef SLSTM_PICK
  return nullptr;
}

// the launch configuration of one call; returns the kernel, or null where
// the shape is not taken
Kernel configure(int batch, int heads, int dh, int cluster, int rows,
                 int wx_bf16, cudaLaunchConfig_t* cfg,
                 cudaLaunchAttribute* attr, int* units) {
  if (dh <= 0 || dh > kMaxDh || rows <= 0 || rows > kMaxRows ||
      heads <= 0 || heads > 65535 ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8))
    return nullptr;
  int limit = 0;
  Kernel fn = pick(dh, wx_bf16, &limit);
  *units = (dh + cluster - 1) / cluster;
  const int threads = 32 * ((*units + 3) / 4);
  // every CTA owns at least one unit
  if (fn == nullptr || threads > limit || (cluster - 1) * *units >= dh)
    return nullptr;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster * ((batch + rows - 1) / rows), heads);
  cfg->blockDim = dim3(threads);
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return fn;
}

}  // namespace

// Clusters of this configuration that can run at once on the current
// device (cudaOccupancyMaxActiveClusters), or -1 where the shape is not
// taken.
extern "C" int slstm_cell_max_clusters(int heads, int dh, int cluster,
                                       int rows, int wx_bf16) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int units = 0;
  Kernel fn = configure(rows, heads, dh, cluster, rows, wx_bf16, &cfg,
                        &attr, &units);
  if (fn == nullptr) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, fn, &cfg) != cudaSuccess) return -1;
  return n;
}

// wx: device (batch, seq, heads, 4 dh), bfloat16 when wx_bf16 else float32;
// r: float32 (heads, dh, 4 dh); fbias: float32 (heads, dh); c0, n0, m0, h0
// and the four state outputs: float32 (batch, heads, dh); hs: float32
// (batch, seq, heads, dh). All row-major and contiguous; the outputs must
// not overlap the inputs. cluster: CTAs per (head, row tile), 1, 2, 4 or
// 8, with ceil(dh / cluster) units a CTA within its thread limit; rows:
// batch rows per cluster, 1 to 8. Launches on `stream` and returns the
// launch's error; no synchronisation.
extern "C" int slstm_cell_launch(const void* wx, int wx_bf16, const void* r,
                                 const void* fbias, const void* c0,
                                 const void* n0, const void* m0,
                                 const void* h0, void* hs, void* c_out,
                                 void* n_out, void* m_out, void* h_out,
                                 int batch, int seq, int heads, int dh,
                                 int cluster, int rows, void* stream) {
  if (batch <= 0 || heads <= 0) return (int)cudaSuccess;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int units = 0;
  Kernel fn = configure(batch, heads, dh, cluster, rows, wx_bf16, &cfg,
                        &attr, &units);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cfg.stream = (cudaStream_t)stream;
  Params p{wx, (const float*)r, (const float*)fbias, (const float*)c0,
           (const float*)n0, (const float*)m0, (const float*)h0, (float*)hs,
           (float*)c_out, (float*)n_out, (float*)m_out, (float*)h_out,
           batch, seq, heads, dh, cluster, units, rows};
  return (int)cudaLaunchKernelEx(&cfg, fn, p);
}
