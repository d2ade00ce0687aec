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
// steps depends on the last, so a launch is a chain of S steps, and each
// step of a block reads its head's whole R (576 KB) through its SM: one R
// does not fit a block's 227 KB of shared memory, so it stays in device
// memory and is served from the 50 MB L2 (all heads' R together are
// 2.36 MB). A step therefore costs about R's bytes over one SM's L2 rate
// and latency, whatever the batch; the bytes and operations of the whole
// call are far smaller (PERF.md, row 9).
//
// What the design does about it: one block per (batch row, head), so B x H
// blocks stream R side by side on as many SMs; rows past B do not exist,
// so no padding with -1e30 is needed. The time loop runs inside the block.
// Each step has two phases, each closed by a barrier:
//   A. thread `col` (one per column of the 4dh gate pre-activations) reads
//      column `col` of R (coalesced across the warp, kUnroll rows of R in
//      flight before their FMAs) and accumulates sum_k h[k] R[k, col] with
//      fmaf, h broadcast from shared memory; it adds wx (converted to
//      float32 in the load, as the Pallas body does) and stores pre to
//      shared memory;
//   B. thread `j < dh` owns unit j for the whole sequence (c, n, m live in
//      its registers): it reads its four gates from shared memory, updates
//      the state, writes h to hs and to shared memory.
// The TPU's 8-row tile would make each R load serve more rows, but costs
// the block that many FMAs and shared loads per R element: on the H100 it
// took 25 us a step against 5.5-6.6 us for one row (PERF.md, row 9). A
// step then streams R's 576 KB through one SM at about 100 GB/s.
// expf, tanhf and log1pf keep their accurate forms (no fast math), and the
// file is built with -fmad=false, so the gate arithmetic rounds as the
// plain version's separate operations do; only the matrix product uses
// explicit fmaf. A thread-block cluster that keeps R in distributed shared
// memory is the later, faster design (ROADMAP B9 speed).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 16;  // R loads in flight per thread
constexpr int kMaxDh = 256;  // 4 dh columns, one thread each, <= 1024

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

// At least one block per SM: with the thread count alone ptxas aims at two
// blocks of 4 kMaxDh threads (32 registers) and spills some of the R
// loads in flight, which made a step about 1.5x slower on the H100.
template <typename T>
__global__ void __launch_bounds__(4 * kMaxDh, 1) slstm_cell_kernel(
    const T* __restrict__ wx, const float* __restrict__ r,
    const float* __restrict__ fbias, const float* __restrict__ c0,
    const float* __restrict__ n0, const float* __restrict__ m0,
    const float* __restrict__ h0, float* __restrict__ hs,
    float* __restrict__ c_out, float* __restrict__ n_out,
    float* __restrict__ m_out, float* __restrict__ h_out, int seq, int heads,
    int dh) {
  __shared__ float h_s[kMaxDh];
  __shared__ float pre_s[4 * kMaxDh];
  const int head = blockIdx.y;
  const int64_t row = blockIdx.x;
  const int dh4 = 4 * dh;
  const int j = threadIdx.x;
  const bool own = j < dh;     // the hidden unit of this thread
  const bool col_ok = j < dh4;  // the gate column of this thread

  const int64_t st = (row * heads + head) * dh + j;
  float c = 0.0f, n = 0.0f, m = 0.0f, fb = 0.0f;
  if (own) {
    c = c0[st];
    n = n0[st];
    m = m0[st];
    fb = fbias[(int64_t)head * dh + j];
    h_s[j] = h0[st];
  }
  __syncthreads();

  const float* r_col = r + (int64_t)head * dh * dh4 + j;
  const T* wx_t = wx + (row * seq * heads + head) * dh4 + j;
  float* hs_t = hs + (row * seq * heads + head) * dh + j;
  for (int t = 0; t < seq; ++t, wx_t += heads * dh4, hs_t += heads * dh) {
    // A. pre[col] = wx[row, t, head, col] + sum_k h[k] R[head, k, col]
    if (col_ok) {
      const float x = to_f32(*wx_t);
      float acc = 0.0f;
      // kUnroll loads of R issued together, then their FMAs: the loads
      // come from L2, so their latency is hidden only by having many in
      // flight
      int k = 0;
      for (; k + kUnroll <= dh; k += kUnroll) {
        float rv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          rv[u] = __ldg(r_col + (int64_t)(k + u) * dh4);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc = fmaf(h_s[k + u], rv[u], acc);
      }
      for (; k < dh; ++k)
        acc = fmaf(h_s[k], __ldg(r_col + (int64_t)k * dh4), acc);
      pre_s[j] = x + acc;
    }
    __syncthreads();
    // B. the gates of unit j
    if (own) {
      const float i_pre = pre_s[j];
      const float log_f = log_sigmoid(pre_s[dh + j] + fb);
      const float z_pre = pre_s[2 * dh + j];
      const float o_pre = pre_s[3 * dh + j];
      const float m_new = fmaxf(log_f + m, i_pre);
      const float i_sc = expf(i_pre - m_new);
      const float f_sc = expf(log_f + m - m_new);
      c = f_sc * c + i_sc * tanhf(z_pre);
      n = fmaxf(f_sc * n + i_sc, 1e-6f);
      const float h_new = (1.0f / (1.0f + expf(-o_pre))) * c / n;
      m = m_new;
      *hs_t = h_new;
      h_s[j] = h_new;
    }
    __syncthreads();
  }
  if (own) {
    c_out[st] = c;
    n_out[st] = n;
    m_out[st] = m;
    h_out[st] = h_s[j];
  }
}

}  // namespace

// Largest head width the kernel takes (one thread per gate column).
extern "C" int slstm_cell_max_head_dim() { return kMaxDh; }

// wx: device (batch, seq, heads, 4 dh), bfloat16 when wx_bf16 else float32;
// r: float32 (heads, dh, 4 dh); fbias: float32 (heads, dh); c0, n0, m0, h0
// and the four state outputs: float32 (batch, heads, dh); hs: float32
// (batch, seq, heads, dh). All row-major and contiguous; the outputs must
// not overlap the inputs. Launches on `stream` and returns
// cudaGetLastError(); no synchronisation.
extern "C" int slstm_cell_launch(const void* wx, int wx_bf16, const void* r,
                                 const void* fbias, const void* c0,
                                 const void* n0, const void* m0,
                                 const void* h0, void* hs, void* c_out,
                                 void* n_out, void* m_out, void* h_out,
                                 int batch, int seq, int heads, int dh,
                                 void* stream) {
  if (batch <= 0 || heads <= 0) return (int)cudaSuccess;
  if (dh <= 0 || dh > kMaxDh) return (int)cudaErrorInvalidValue;
  const int threads = ((4 * dh + 31) / 32) * 32;
  dim3 grid((unsigned)batch, (unsigned)heads);
  cudaStream_t st = (cudaStream_t)stream;
  const float* rf = (const float*)r;
  const float* fb = (const float*)fbias;
  const float* s0[4] = {(const float*)c0, (const float*)n0, (const float*)m0,
                        (const float*)h0};
  if (wx_bf16) {
    slstm_cell_kernel<__nv_bfloat16><<<grid, threads, 0, st>>>(
        (const __nv_bfloat16*)wx, rf, fb, s0[0], s0[1], s0[2], s0[3],
        (float*)hs, (float*)c_out, (float*)n_out, (float*)m_out,
        (float*)h_out, seq, heads, dh);
  } else {
    slstm_cell_kernel<float><<<grid, threads, 0, st>>>(
        (const float*)wx, rf, fb, s0[0], s0[1], s0[2], s0[3], (float*)hs,
        (float*)c_out, (float*)n_out, (float*)m_out, (float*)h_out, seq,
        heads, dh);
  }
  return (int)cudaGetLastError();
}
