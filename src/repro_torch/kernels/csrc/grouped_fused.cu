// Grouped stochastic quantize round in one launch, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/stoch_quant.py::
// stoch_quantize_grouped_fused (_grouped_fused_kernel). Over a packed
// (N, D) float32 buffer whose columns fall into G groups (given as column
// runs, see grouped_common.cuh), it computes
//
//   R[n, g]      = max |theta - q_prev| over row n's columns of group g
//   (b, Δ)[n, g] = Eq. (18) bit schedule from (b_prev, R, R_prev, init)
//   out          = q_prev + Δ q - R per column (Eqs. 14-20), with the
//                  group's (Δ, R); a degenerate group (R <= 1e-12) keeps
//                  q_prev
//
// and writes out (N, D) and R, b, Δ (N, G). `range_new` must be zero on
// entry: it is the accumulator of the reduction. q_prev and out share one
// storage type: float32, or bf16 / f16 for the engine's narrowed q_hat
// (hat_dtype). A narrowed q_prev is widened exactly in both sweeps, the
// same way, so the range and the quantize see the same values, and out is
// the float32 chain rounded once to nearest even: the result equals this
// kernel on q_prev.float(), out rounded to the storage type, with the
// (N, G) outputs bit for bit. No float32 copy of q_hat is packed.
//
// What bounds it on this card: bytes. Each element is read from three
// inputs and written once (16 B; 12 B with a narrowed q_hat); the
// arithmetic is a dozen flops. At the LM path's (4, 134,277,912) that is
// 8.6 GB, 2.56 ms at 3.35 TB/s (6.4 GB, 1.92 ms narrowed). The
// per-group maxima must be complete before any element is quantized, and
// at 2 GB per operand nothing stays in the 50 MB L2 between the two
// sweeps, so this design reads theta and q_prev twice: 24 B per element,
// 1.5x the bound at best.
//
// What the design does about it: one cooperative launch of a persistent
// grid (as many 256-thread blocks as fit on the card at once, from the
// occupancy API), each block owning one contiguous chunk of N*D elements.
//   1. Each block reduces |theta - q_prev| over each (row, run) piece of
//      its chunk and merges the block's maximum into R with one atomicMax
//      on the float bits (exact for non-negative floats, order-free).
//   2. grid.sync().
//   3. The first N*G threads write (b, Δ); every block recomputes the
//      schedule of the few (n, g) its pieces touch (two expf, one logf)
//      and quantizes its chunk with float4 loads and stores.
// All 132 SMs take part whatever N is: one block per row would leave 128
// of them idle at N = 4.

#include <cooperative_groups.h>

#include "grouped_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

template <class Q>
__global__ void __launch_bounds__(kThreads)
grouped_fused_kernel(const float* __restrict__ theta,
                     const Q* __restrict__ qprev,
                     const float* __restrict__ unif,
                     const float* __restrict__ bprev,
                     const float* __restrict__ rprev,
                     const float* __restrict__ init, Q* __restrict__ out,
                     float* range_new, float* __restrict__ bits,
                     float* __restrict__ delta, long long n, long long d,
                     int n_groups, long long chunk, float omega, float b0,
                     float bmax, gq::Segs segs) {
  __shared__ float sh[32];
  const long long total = n * d;
  const long long lo = (long long)blockIdx.x * chunk;
  const long long hi = lo + chunk < total ? lo + chunk : total;

  gq::for_each_piece(lo, hi, d, segs,
                     [&](long long row, int g, long long a, long long b) {
                       gq::reduce_piece(theta, qprev, range_new, row, g,
                                        n_groups, a, b, sh);
                     });
  cg::this_grid().sync();

  const long long side = n * n_groups;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < side; i += (long long)gridDim.x * blockDim.x) {
    const gq::Sched s = gq::schedule(bprev[i], __ldcg(range_new + i),
                                     rprev[i], init[i], omega, b0, bmax);
    bits[i] = s.bits;
    delta[i] = s.delta;
  }
  gq::for_each_piece(
      lo, hi, d, segs, [&](long long row, int g, long long a, long long b) {
        const long long i = row * n_groups + g;
        const float r = __ldcg(range_new + i);
        const gq::Sched s =
            gq::schedule(bprev[i], r, rprev[i], init[i], omega, b0, bmax);
        gq::quantize_piece(theta, qprev, unif, out, s.delta, r, true, a, b);
      });
}

template <class Q>
int launch(const void* theta, const void* qprev, const void* unif,
           const void* bprev, const void* rprev, const void* init, void* out,
           void* range_new, void* bits, void* delta, long long n,
           long long d, int n_groups, const long long* seg_off,
           const int* seg_gid, int n_segs, float omega, float b0, float bmax,
           void* stream) {
  if (n <= 0 || d <= 0) return (int)cudaSuccess;
  gq::Segs segs;
  if (!gq::make_segs(&segs, seg_off, seg_gid, n_segs))
    return (int)cudaErrorInvalidValue;
  const void* kernel = (const void*)grouped_fused_kernel<Q>;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const long long total = n * d;
  long long grid = (total + 4LL * kThreads - 1) / (4LL * kThreads);
  if (grid > (long long)per_sm * sms) grid = (long long)per_sm * sms;
  long long chunk = (total + grid - 1) / grid;
  chunk = (chunk + 3) & ~3LL;
  grid = (total + chunk - 1) / chunk;
  void* args[] = {(void*)&theta, (void*)&qprev,     (void*)&unif,
                  (void*)&bprev, (void*)&rprev,     (void*)&init,
                  (void*)&out,   (void*)&range_new, (void*)&bits,
                  (void*)&delta, (void*)&n,         (void*)&d,
                  (void*)&n_groups, (void*)&chunk,  (void*)&omega,
                  (void*)&b0,    (void*)&bmax,      (void*)&segs};
  err = cudaLaunchCooperativeKernel(kernel, dim3((unsigned)grid),
                                    dim3(kThreads), args, 0,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// theta, qprev, unif, out: device (n, d), 16-byte aligned; theta and unif
// float32, qprev and out of the entry's storage type (float32, bf16, f16);
// bprev, rprev, init, range_new (zeroed), bits, delta: float32 (n,
// n_groups). seg_off (n_segs + 1) and seg_gid (n_segs) are HOST arrays: the
// column runs. Launches on `stream` and returns a cudaError_t; no
// synchronisation.
#define GROUPED_FUSED_ENTRY(NAME, Q)                                         \
  extern "C" int NAME(const void* theta, const void* qprev,                  \
                      const void* unif, const void* bprev,                   \
                      const void* rprev, const void* init, void* out,        \
                      void* range_new, void* bits, void* delta, long long n, \
                      long long d, int n_groups, const long long* seg_off,   \
                      const int* seg_gid, int n_segs, float omega, float b0, \
                      float bmax, void* stream) {                            \
    return launch<Q>(theta, qprev, unif, bprev, rprev, init, out,            \
                     range_new, bits, delta, n, d, n_groups, seg_off,        \
                     seg_gid, n_segs, omega, b0, bmax, stream);              \
  }

GROUPED_FUSED_ENTRY(grouped_fused_f32, float)
GROUPED_FUSED_ENTRY(grouped_fused_bf16, __nv_bfloat16)
GROUPED_FUSED_ENTRY(grouped_fused_f16, __half)
