// Batched FISTA for the paper's eq.-6 l1 least squares, and the iter_l1
// page freeze's whole lambda bisection around it, for Hopper (sm_90a).
// Plain C interface, loaded with ctypes by repro_torch/kernels/fista_quant.py.
//
// Replaces the TPU kernel repro/kernels/fista_quant.py:fista_quant (Pallas
// body `_kernel`, where both scans are blocked triangular matmuls on the
// MXU, `_blocked_cumsum`), and for page freezing the jitted program around
// it, repro/kernels/page_quant.py:_fista_pages (power iteration and
// bisection as device loops).
//
// fista_quant_launch: per row b of B independent problems on the
// cumulative design matrix V (columns scaled by d, rows weighted by n),
// starting from x = y = 1, for n_iters steps:
//
//   recon  = prefix(y * d)                      (V y)
//   r      = n * (w - recon)
//   grad   = -d * suffix(r)                     (V^T diag(n) r, negated)
//   x      = shrink(y - eta * grad, eta * lam)  (soft threshold)
//   y      = x + ((t - 1) / t') * (x - x_prev)  (momentum)
//
// and writes alpha = x. w, d, n, lam are (B, Mp) f32 rows, eta (B,) f32;
// t follows t' = (1 + sqrt(1 + 4 t^2)) / 2 from t = 1. Padding columns
// (d = n = lam = 0) keep x = 1, as in the reference kernel.
//
// fista_freeze_launch: for R page rows of 128 sketch columns (w, d, n),
// what repro_torch/kernels/fista_quant.py:freeze_plain computes with
// torch ops and 14 launches of the kernel above: the column scales
// (nsuf, scale, dt), power_iters power iterations from the start vector x0
// (eta),
// lam_hi, and the lambda bisection (each step FISTA from x = y = 1 at
// lam = mid / scale on live columns; the support count |alpha| > 1e-12,
// +1 when column 0 is off it; lo / hi / best per row). Writes best, eta
// and lam_hi. Bitwise the torch composition on the card: every add,
// multiply, divide and square root is an IEEE round-to-nearest intrinsic
// (none can contract into an FMA), the prefix sums take torch's
// Hillis-Steele order (offsets 1, 2, ..., 64; ref.scan) and the row sums
// its pairwise halving (ref.fsum), and the FISTA steps are the same device
// code as fista_quant's.
//
// Design. Lane l of a warp holds columns 4l..4l+3 of a 128-column chunk of
// a row, in registers for every step. A step needs one round of scans: by
// linearity the residual's suffix sum is
//   suffix(n (w - P))_i = c_i - N_i P_i - sum_{k > i} (y d N)_k
// with P = prefix(y d) and the constant suffix sums N (of n) and c (of
// n w), so the prefix of y d and the suffix of y d N run in the same
// shuffle rounds (one dependent scan a step, where recon, then the
// residual's prefix, took two). A scan over a chunk is each lane's 4
// columns in order, then shuffle scans of the lane totals: no shared
// memory and no barrier. A row of Mp <= 128 is one warp, and a block
// holds PAGE_ROWS rows, so the page freeze's 224 rows are 224 warps. A
// wider row (up to MP_MAX) is one block of a warp per chunk. Each step the
// warps post their chunk's two totals in shared memory, wait at one block
// barrier, and every warp reads all of the row's chunk totals and scans
// them by shuffles in chunk order. Two buffers alternate, so a step's
// totals are never overwritten before every warp has read them. The
// summation order depends on Mp alone, never on B: a row's bits are the
// same whatever rows are beside it. (Spreading a wide row over a
// thread-block cluster, the chunk totals read through distributed shared
// memory, was slower at every cluster size measured: PERF.md.)
//
// Bound on this card: operations. Each step does about 18 f32 operations
// per column, 18 * B * Mp * n_iters in all against 67 TFLOP/s; the bytes
// are 20 per column once, n_iters times less. What limits this design is
// latency: a step is a dependent chain of one warp scan (five shuffle
// rounds, most of a step), the elementwise work and, on wide rows, one
// barrier. Measured times are in PERF.md.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 4;                     // columns a lane holds
constexpr int kChunk = 32 * kCols;           // columns a warp holds
constexpr int MAX_CHUNKS = 32;               // one lane each in the chunk scan
constexpr int MP_MAX = MAX_CHUNKS * kChunk;  // 4096 (fista_quant.MP_MAX)
// one-warp rows a block (fista_quant.PAGE_ROWS): a warp per scheduler of
// an SM; 1, 2 and 4 timed the same at the page shape, 8 slower (PERF.md)
constexpr int PAGE_ROWS = 4;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

// Two scans over a warp's 128 columns in the same shuffle rounds: the
// inclusive prefix P of a, and the exclusive suffix S of b (the sum of the
// columns after each). Each lane takes its 4 columns in order (P from the
// left, S from the right), then its totals by shuffle scans (up for P,
// down for S), adding the totals of the lanes before (after) it. `plast`
// is P at the chunk's last column and `sfirst` the chunk's sum of b, each
// computed beside the lanes' offsets rather than after them.
__device__ __forceinline__ void warp_scans(const float (&a)[kCols],
                                           const float (&b)[kCols],
                                           float (&P)[kCols],
                                           float (&S)[kCols], float& plast,
                                           float& sfirst, int lane) {
  float p[kCols], e[kCols];
  p[0] = a[0];
  e[kCols - 1] = 0.f;
#pragma unroll
  for (int j = 1; j < kCols; ++j) {
    p[j] = add(p[j - 1], a[j]);
    e[kCols - 1 - j] = add(e[kCols - j], b[kCols - j]);
  }
  const float sb = add(e[0], b[0]);
  float ip = p[kCols - 1], is = sb;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(kFull, ip, o);
    const float v = __shfl_down_sync(kFull, is, o);
    if (lane >= o) ip = add(ip, u);
    if (lane + o < 32) is = add(is, v);
  }
  float xp = __shfl_up_sync(kFull, ip, 1);
  float xs = __shfl_down_sync(kFull, is, 1);
  if (lane == 0) xp = 0.f;
  if (lane == 31) xs = 0.f;
  plast = add(__shfl_sync(kFull, ip, 30),
              __shfl_sync(kFull, p[kCols - 1], 31));
  sfirst = add(__shfl_sync(kFull, is, 1), __shfl_sync(kFull, sb, 0));
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    P[j] = add(xp, p[j]);
    S[j] = add(xs, e[j]);
  }
}

// A row that is one warp: the chunk's scans are the row's.
struct OneChunk {
  __device__ __forceinline__ void combine(float (&)[kCols], float (&)[kCols],
                                          float, float) {}
};

// A row of several chunks, one warp each: each chunk's two totals through
// shared memory after one block barrier, scanned by shuffles in chunk
// order, up for P and down for S; each chunk adds the totals of the chunks
// before (P) and after (S) it.
struct ManyChunks {
  float* buf;        // 2 slots x (P, S) x MAX_CHUNKS totals
  int slot, chunk, chunks, lane;

  __device__ __forceinline__ void combine(float (&P)[kCols],
                                          float (&S)[kCols], float plast,
                                          float sfirst) {
    float* mine = buf + slot * 2 * MAX_CHUNKS;
    if (lane == 0) {
      mine[chunk] = plast;
      mine[MAX_CHUNKS + chunk] = sfirst;
    }
    __syncthreads();
    float tp = 0.f, ts = 0.f;
    if (lane < chunks) {
      tp = mine[lane];
      ts = mine[MAX_CHUNKS + lane];
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(kFull, tp, o);
      const float v = __shfl_down_sync(kFull, ts, o);
      if (lane >= o) tp = add(tp, u);
      if (lane + o < 32) ts = add(ts, v);
    }
    float xp = __shfl_up_sync(kFull, tp, 1);
    float xs = __shfl_down_sync(kFull, ts, 1);
    if (lane == 0) xp = 0.f;
    if (lane == 31) xs = 0.f;
    const float op = __shfl_sync(kFull, xp, chunk);
    const float os = __shfl_sync(kFull, xs, chunk);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      P[j] = add(op, P[j]);
      S[j] = add(os, S[j]);
    }
    slot ^= 1;
  }
};

// Row scans: inclusive prefix P of a and exclusive suffix S of b.
template <class Rows>
__device__ __forceinline__ void row_scans(const float (&a)[kCols],
                                          const float (&b)[kCols],
                                          float (&P)[kCols],
                                          float (&S)[kCols], Rows& rows,
                                          int lane) {
  float plast, sfirst;
  warp_scans(a, b, P, S, plast, sfirst, lane);
  rows.combine(P, S, plast, sfirst);
}

// n_iters FISTA steps from x = y = 1 on one row's columns held by this
// lane (thr = eta * lam); the result in x. One scan round a step: with
// P = prefix(y d), N = suffix(n) and c = suffix(n w) (inclusive), the
// residual's suffix sum is
//   suffix(n (w - P))_i = c_i - N_i P_i - sum_{k > i} (y d N)_k,
// so P and the last sum come from one pair of scans (row_scans).
template <class Rows>
__device__ __forceinline__ void fista_steps(
    const float (&w)[kCols], const float (&d)[kCols], const float (&n)[kCols],
    const float (&thr)[kCols], float eta, int n_iters, float (&x)[kCols],
    Rows& rows, int lane) {
  float N[kCols], c[kCols], zero[kCols], nw[kCols], tmp[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    zero[j] = 0.f;
    nw[j] = mul(n[j], w[j]);
  }
  row_scans(zero, n, tmp, N, rows, lane);
  row_scans(zero, nw, tmp, c, rows, lane);
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    N[j] = add(N[j], n[j]);
    c[j] = add(c[j], nw[j]);
  }
  float xp[kCols], y[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) xp[j] = y[j] = 1.f;
  float t = 1.f;
  // unrolled by 8, the page step, the PTQ shape and the freeze time faster
  // than rolled, with the same bits (PERF.md)
#pragma unroll 8
  for (int it = 0; it < n_iters; ++it) {
    float a[kCols], aN[kCols], P[kCols], S[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      a[j] = mul(y[j], d[j]);
      aN[j] = mul(a[j], N[j]);
    }
    row_scans(a, aN, P, S, rows, lane);
    const float tn = mul(0.5f, add(1.f, __fsqrt_rn(add(1.f, mul(mul(4.f, t),
                                                                t)))));
    const float coef = __fdiv_rn(sub(t, 1.f), tn);
    t = tn;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float suffix = sub(sub(c[j], mul(N[j], P[j])), S[j]);
      const float grad = mul(-d[j], suffix);
      const float v = sub(y[j], mul(eta, grad));
      const float m = fmaxf(sub(fabsf(v), thr[j]), 0.f);
      const float xj = v != v ? v : copysignf(m, v);   // sign(v) * m
      y[j] = add(xj, mul(coef, sub(xj, xp[j])));
      xp[j] = xj;
    }
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) x[j] = xp[j];
}

struct Problem {
  const float *w, *d, *n, *lam, *eta;
  float* alpha;
  int B, Mp, n_iters;
};

// Loads this lane's columns of row `row`, chunk `chunk` (zeros past Mp),
// runs the steps and stores alpha.
template <class Rows>
__device__ __forceinline__ void solve_row(const Problem& p, int row,
                                          int chunk, Rows& rows, int lane) {
  const size_t base = (size_t)row * p.Mp;
  const int c0 = chunk * kChunk + lane * kCols;
  const float eta = p.eta[row];
  float w[kCols], d[kCols], n[kCols], thr[kCols], x[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const bool in = c0 + j < p.Mp;
    w[j] = in ? p.w[base + c0 + j] : 0.f;
    d[j] = in ? p.d[base + c0 + j] : 0.f;
    n[j] = in ? p.n[base + c0 + j] : 0.f;
    thr[j] = in ? mul(eta, p.lam[base + c0 + j]) : 0.f;
  }
  fista_steps(w, d, n, thr, eta, p.n_iters, x, rows, lane);
#pragma unroll
  for (int j = 0; j < kCols; ++j)
    if (c0 + j < p.Mp) p.alpha[base + c0 + j] = x[j];
}

// Mp <= 128: one warp a row, PAGE_ROWS rows a block.
__global__ void __launch_bounds__(PAGE_ROWS * 32)
fista_rows_kernel(Problem p) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * PAGE_ROWS + (threadIdx.x >> 5);
  if (row >= p.B) return;
  OneChunk rows;
  solve_row(p, row, 0, rows, lane);
}

// Mp > 128: one row a block, one warp a chunk.
__global__ void __launch_bounds__(MAX_CHUNKS * 32)
fista_chunks_kernel(Problem p) {
  __shared__ float buf[2 * 2 * MAX_CHUNKS];
  const int lane = threadIdx.x & 31;
  ManyChunks rows{buf, 0, (int)(threadIdx.x >> 5), (int)(blockDim.x >> 5),
                  lane};
  solve_row(p, blockIdx.x, rows.chunk, rows, lane);
}

// ---------------------------------------------------------------- freeze

// Inclusive prefix over the row's 128 columns in Hillis-Steele order
// (offsets 1, 2, 4, ..., 64; ref.scan): new[i] = old[i] + old[i - k],
// + 0 where i < k. With REV the same over the reversed row (new[i] =
// old[i] + old[i + k]): the suffix sums of ref.scan(x.flip(1)).flip(1).
template <bool REV>
__device__ __forceinline__ void hs_scan(float (&v)[kCols], int lane) {
#pragma unroll
  for (int k = 1; k < kChunk; k <<= 1) {
    float o[kCols];
    if (k < kCols) {
      // this lane's columns and the neighbour's (zeros past the row's
      // end) in column order; the addend of column j is k columns away
      const bool has = REV ? lane < 31 : lane > 0;
      float ext[2 * kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float nb = REV ? __shfl_down_sync(kFull, v[j], 1)
                             : __shfl_up_sync(kFull, v[j], 1);
        ext[REV ? kCols + j : j] = has ? nb : 0.f;
        ext[REV ? j : kCols + j] = v[j];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) o[j] = ext[REV ? j + k : kCols + j - k];
    } else {
      const int m = k / kCols;              // lanes apart
      const bool in = REV ? lane + m < 32 : lane >= m;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float u = REV ? __shfl_down_sync(kFull, v[j], m)
                            : __shfl_up_sync(kFull, v[j], m);
        o[j] = in ? u : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) v[j] = add(v[j], o[j]);
  }
}

// Sum of the row's 128 columns by pairwise halving (ref.fsum: x[i] +
// x[i + h] for h = 64, 32, ..., 1), broadcast to every lane.
__device__ __forceinline__ float hs_sum(const float (&a)[kCols]) {
  float v[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) v[j] = a[j];
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1)          // h = 4m: lanes m apart
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      v[j] = add(v[j], __shfl_down_sync(kFull, v[j], m));
  const float s = add(add(v[0], v[2]), add(v[1], v[3]));   // h = 2, then 1
  return __shfl_sync(kFull, s, 0);
}

// torch's clamp_min / amax semantics: NaN propagates
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

struct Freeze {
  const float *w, *d, *n, *x0;
  float *best, *eta, *lam_hi;
  int R, L, n_iters, bisect_steps, power_iters;
};

__global__ void __launch_bounds__(PAGE_ROWS * 32)
fista_freeze_kernel(Freeze p) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * PAGE_ROWS + (threadIdx.x >> 5);
  if (row >= p.R) return;
  const size_t base = (size_t)row * kChunk;
  const int c0 = lane * kCols;
  float w[kCols], d[kCols], n[kCols], dt[kCols], scale[kCols], live[kCols];
  float x[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    w[j] = p.w[base + c0 + j];
    d[j] = p.d[base + c0 + j];
    n[j] = p.n[base + c0 + j];
    x[j] = p.x0[c0 + j];
    live[j] = n[j] > 0.f ? 1.f : 0.f;
  }
  // unit column norms: nsuf = suffix sums of n, scale = sqrt(d^2 nsuf)
  float nsuf[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) nsuf[j] = n[j];
  hs_scan<true>(nsuf, lane);
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const float z = mul(mul(d[j], d[j]), nsuf[j]);
    scale[j] = __fsqrt_rn(z <= 0.f ? 1.f : z);
    dt[j] = __fdiv_rn(d[j], scale[j]);
  }
  // power iterations of x -> V^T diag(n) V x (cumsum form)
  float lip = 1.f;
#pragma unroll 8
  for (int it = 0; it < p.power_iters; ++it) {
    float c[kCols], y[kCols], xy[kCols], yy[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) c[j] = mul(x[j], dt[j]);
    hs_scan<false>(c, lane);
#pragma unroll
    for (int j = 0; j < kCols; ++j) c[j] = mul(n[j], c[j]);
    float cu[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) cu[j] = c[j];
    hs_scan<false>(cu, lane);
    const float last = __shfl_sync(kFull, cu[kCols - 1], 31);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      y[j] = mul(dt[j], add(sub(last, cu[j]), c[j]));
      xy[j] = mul(x[j], y[j]);
      yy[j] = mul(y[j], y[j]);
    }
    const float sxy = hs_sum(xy), syy = hs_sum(yy);
    lip = sxy != sxy ? sxy : fmaxf(sxy, 1e-30f);
    const float den = add(__fsqrt_rn(syy), 1e-30f);
#pragma unroll
    for (int j = 0; j < kCols; ++j) x[j] = __fdiv_rn(y[j], den);
  }
  const float eta = __fdiv_rn(1.f, mul(lip, 1.01f));
  // lam_hi: above max |gradient at 0| (original coordinates) alpha = 0
  float g[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) g[j] = mul(n[j], w[j]);
  float gs[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) gs[j] = g[j];
  hs_scan<false>(gs, lane);
  const float glast = __shfl_sync(kFull, gs[kCols - 1], 31);
  float gmax = 0.f;
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const float a = fabsf(mul(d[j], add(sub(glast, gs[j]), g[j])));
    gmax = j == 0 ? a : max_nan(gmax, a);
  }
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1)
    gmax = max_nan(gmax, __shfl_xor_sync(kFull, gmax, m));
  const float lam_hi = add(mul(gmax, 1.001f), 1e-12f);
  // bisection: the smallest lambda whose support fits L levels
  float lo = 0.f, hi = lam_hi, best[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) best[j] = 0.f;
  OneChunk rows;
  for (int s = 0; s < p.bisect_steps; ++s) {
    const float mid = mul(0.5f, add(lo, hi));
    float thr[kCols], alpha[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      thr[j] = mul(eta, mul(__fdiv_rn(mid, scale[j]), live[j]));
    fista_steps(w, dt, n, thr, eta, p.n_iters, alpha, rows, lane);
    int nnz = 0;
    unsigned first = 0;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const unsigned sup = __ballot_sync(kFull, fabsf(alpha[j]) > 1e-12f);
      nnz += __popc(sup);
      if (j == 0) first = sup & 1u;
    }
    nnz += 1 - (int)first;
    const bool feas = nnz <= p.L;
    lo = feas ? lo : mid;
    hi = feas ? mid : hi;
    if (feas)
#pragma unroll
      for (int j = 0; j < kCols; ++j) best[j] = alpha[j];
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) p.best[base + c0 + j] = best[j];
  if (lane == 0) {
    p.eta[row] = eta;
    p.lam_hi[row] = lam_hi;
  }
}

}  // namespace

// Returns 0 or the CUDA error of a refused launch (cudaGetLastError);
// cudaErrorInvalidValue for sizes the kernel does not take.
extern "C" int fista_quant_launch(const void* w, const void* d, const void* n,
                                  const void* lam, const void* eta,
                                  void* alpha, int B, int Mp, int n_iters,
                                  void* stream) {
  if (B <= 0 || Mp <= 0 || Mp > MP_MAX || n_iters < 0)
    return (int)cudaErrorInvalidValue;
  Problem p{static_cast<const float*>(w), static_cast<const float*>(d),
            static_cast<const float*>(n), static_cast<const float*>(lam),
            static_cast<const float*>(eta), static_cast<float*>(alpha),
            B, Mp, n_iters};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Mp <= kChunk)
    fista_rows_kernel<<<(B + PAGE_ROWS - 1) / PAGE_ROWS, PAGE_ROWS * 32, 0,
                        s>>>(p);
  else
    fista_chunks_kernel<<<B, (Mp + kChunk - 1) / kChunk * 32, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// The page freeze's solve: R rows of 128 columns (w, d, n), the start
// vector x0 (128,); writes best (R, 128), eta (R,) and lam_hi (R,).
extern "C" int fista_freeze_launch(const void* w, const void* d,
                                   const void* n, const void* x0, void* best,
                                   void* eta, void* lam_hi, int R, int L,
                                   int n_iters, int bisect_steps,
                                   int power_iters, void* stream) {
  if (R <= 0 || L <= 0 || n_iters < 0 || bisect_steps < 0 || power_iters < 0)
    return (int)cudaErrorInvalidValue;
  Freeze p{static_cast<const float*>(w), static_cast<const float*>(d),
           static_cast<const float*>(n), static_cast<const float*>(x0),
           static_cast<float*>(best), static_cast<float*>(eta),
           static_cast<float*>(lam_hi), R, L, n_iters, bisect_steps,
           power_iters};
  fista_freeze_kernel<<<(R + PAGE_ROWS - 1) / PAGE_ROWS, PAGE_ROWS * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
