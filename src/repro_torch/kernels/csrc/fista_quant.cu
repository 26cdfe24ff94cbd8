// Batched FISTA for the paper's eq.-6 l1 least squares, for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// repro_torch/kernels/fista_quant.py.
//
// Replaces the TPU kernel repro/kernels/fista_quant.py:fista_quant (Pallas
// body `_kernel`, where both scans are blocked triangular matmuls on the
// MXU, `_blocked_cumsum`).
//
// What it computes, per row b of B independent problems on the cumulative
// design matrix V (columns scaled by d, rows weighted by n), starting from
// x = y = 1, for n_iters steps:
//
//   recon  = prefix(y * d)                      (V y)
//   r      = n * (w - recon)
//   suffix = total - prefix(r) + r              (total = prefix(r)[Mp-1])
//   grad   = -d * suffix                        (V^T diag(n) r, negated)
//   x      = shrink(y - eta * grad, eta * lam)  (soft threshold)
//   y      = x + ((t - 1) / t') * (x - x_prev)  (momentum)
//
// and writes alpha = x. w, d, n, lam are (B, Mp) f32 rows, eta (B,) f32;
// t follows t' = (1 + sqrt(1 + 4 t^2)) / 2 from t = 1, in f32 with
// round-to-nearest intrinsics, so it is the sequence the reference
// computes. Padding columns (d = n = lam = 0) keep x = 1, as in the
// reference kernel; the wrappers mask them.
//
// Design: one block per row; nothing crosses rows, so a row's result is
// bitwise the same whatever B is and wherever the row sits in the batch.
// The row is loaded once into registers: thread t holds K = ceil(Mp/512)
// contiguous columns of w, d, n, eta*lam, x_prev and y, which stay on chip
// for all n_iters. Each prefix sum is a thread-serial scan over the
// thread's K columns, a warp-shuffle scan of the thread totals, then each
// thread adds the warp totals before its own from shared memory in a fixed
// serial order. Three barriers a step (one per scan, one to share the
// residual's total); two shared buffers alternate so that no scan
// overwrites totals another thread may still read.
//
// Bound on this card: operations. Each step does about 18 f32 operations
// per column (two scans, the residual, the gradient, the shrink and the
// momentum step), 18 * B * Mp * n_iters in all against 67 TFLOP/s; the
// bytes are 20 per column once (w, d, n, lam read, alpha written) against
// 3.35 TB/s, n_iters times less than the operations' time. What limits
// this simple design is latency, not either rate: each step waits on three
// block-wide barriers and a chain of shuffles, with little work between
// them. The page freeze calls it with B = 224 rows of Mp = 128 (one block
// of 4 warps per row on 132 SMs) for 100 steps, 14 times per freeze; the
// batched PTQ with B = 7 rows of Mp = 4096 (7 of 132 SMs busy) for 1000
// steps. Measured times are in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxK = 8;                       // columns a thread holds
constexpr int MP_MAX = kMaxThreads * kMaxK;    // 4096 (fista_quant.MP_MAX)
constexpr unsigned kFull = 0xffffffffu;

// Exclusive block prefix of each thread's total `tot`: the sum of the
// totals of every thread before it. One barrier; `buf` holds the warp
// totals and must not be rewritten before every thread has passed the
// next barrier.
__device__ __forceinline__ float block_exclusive(float tot, float* buf,
                                                 int lane, int warp) {
  float incl = tot;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  float excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.f;
  if (lane == 31) buf[warp] = incl;
  __syncthreads();
  float woff = 0.f;
  for (int k = 0; k < warp; ++k) woff += buf[k];
  return woff + excl;
}

template <int KMAX>
__global__ void __launch_bounds__(kMaxThreads)
fista_quant_kernel(const float* __restrict__ w, const float* __restrict__ d,
                   const float* __restrict__ n, const float* __restrict__ lam,
                   const float* __restrict__ eta_rows,
                   float* __restrict__ alpha, int Mp, int K, int n_iters) {
  __shared__ float sh_warp[2][kMaxThreads / 32];
  __shared__ float sh_total;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t base = (size_t)blockIdx.x * Mp;
  const int i0 = tid * K;
  const float eta = eta_rows[blockIdx.x];

  float rw[KMAX], rd[KMAX], rn[KMAX], thr[KMAX], xp[KMAX], y[KMAX];
  float r[KMAX], p[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    const int i = i0 + j;
    const bool in = j < K && i < Mp;     // columns past Mp add exact zeros
    rw[j] = in ? w[base + i] : 0.f;
    rd[j] = in ? d[base + i] : 0.f;
    rn[j] = in ? n[base + i] : 0.f;
    thr[j] = in ? __fmul_rn(eta, lam[base + i]) : 0.f;
    xp[j] = 1.f;
    y[j] = 1.f;
  }
  const int last = Mp - 1 - i0;          // this thread's index of column
  const bool owns_last = last >= 0 && last < K;   // Mp - 1, if it has it

  float t = 1.f;
  for (int it = 0; it < n_iters; ++it) {
    // recon = prefix(y * d)
    float run = 0.f;
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < K) {
        run += __fmul_rn(y[j], rd[j]);
        p[j] = run;
      }
    const float off1 = block_exclusive(run, sh_warp[0], lane, warp);
    // r = n * (w - recon), and its prefix
    run = 0.f;
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < K) {
        r[j] = __fmul_rn(rn[j], rw[j] - (off1 + p[j]));
        run += r[j];
        p[j] = run;
      }
    const float off2 = block_exclusive(run, sh_warp[1], lane, warp);
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j == last && owns_last) sh_total = off2 + p[j];
    __syncthreads();
    const float total = sh_total;
    const float tn = __fmul_rn(
        0.5f, __fadd_rn(1.f, __fsqrt_rn(__fadd_rn(
                  1.f, __fmul_rn(__fmul_rn(4.f, t), t)))));
    const float coef = __fdiv_rn(t - 1.f, tn);
    t = tn;
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < K) {
        const float suffix = (total - (off2 + p[j])) + r[j];
        const float grad = __fmul_rn(-rd[j], suffix);
        const float v = y[j] - __fmul_rn(eta, grad);
        const float m = fmaxf(fabsf(v) - thr[j], 0.f);
        const float x = v != v ? v : copysignf(m, v);   // sign(v) * m
        y[j] = x + __fmul_rn(coef, x - xp[j]);
        xp[j] = x;
      }
  }
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    const int i = i0 + j;
    if (j < K && i < Mp) alpha[base + i] = xp[j];
  }
}

template <int KMAX>
int launch(const float* w, const float* d, const float* n, const float* lam,
           const float* eta, float* alpha, int B, int Mp, int K, int threads,
           int n_iters, cudaStream_t s) {
  fista_quant_kernel<KMAX><<<B, threads, 0, s>>>(w, d, n, lam, eta, alpha,
                                                 Mp, K, n_iters);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 or the CUDA error code of a refused launch (cudaGetLastError).
extern "C" int fista_quant_launch(const void* w, const void* d, const void* n,
                                  const void* lam, const void* eta,
                                  void* alpha, int B, int Mp, int n_iters,
                                  void* stream) {
  if (B <= 0 || Mp <= 0 || Mp > MP_MAX || n_iters < 0)
    return (int)cudaErrorInvalidValue;
  const int K = (Mp + kMaxThreads - 1) / kMaxThreads;
  const int threads = ((Mp + K - 1) / K + 31) / 32 * 32;
  const float* f[5] = {static_cast<const float*>(w),
                       static_cast<const float*>(d),
                       static_cast<const float*>(n),
                       static_cast<const float*>(lam),
                       static_cast<const float*>(eta)};
  float* out = static_cast<float*>(alpha);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K == 1)
    return launch<1>(f[0], f[1], f[2], f[3], f[4], out, B, Mp, K, threads,
                     n_iters, s);
  return launch<kMaxK>(f[0], f[1], f[2], f[3], f[4], out, B, Mp, K, threads,
                       n_iters, s);
}
