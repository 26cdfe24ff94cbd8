// Codebook-dequant matrix product y = x @ codebook[idx], for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// repro_torch/kernels/quant_matmul.py.
//
// Replaces the TPU kernels repro/kernels/quant_matmul.py: quant_matmul
// (Pallas body `_kernel`) and quant_matmul_stacked (body `_stacked_kernel`,
// the same tile with an outer group axis). One kernel serves both: the
// flat form is G = 1.
//
// What it computes, per group g: y[g] = x[g] @ W[g] with W[g][k][n] =
// codebook[g][idx[g][k][n]] rounded to x's dtype (the reference's
// `w_tile.astype(x.dtype)`), products accumulated in f32 and rounded once
// to x's dtype. x is (G, M, K) bf16 or f32; idx is (G, K, N) row-major
// uint8 or int32 codes; codebook is (G, L) f32. A code outside [0, L)
// reads as NaN (jnp.take's fill mode), never as another entry.
//
// Grid: (ceil(N / BN), ceil(M / BM), G), 256 threads a block. A block
// stages its group's codebook in shared memory, rounded to x's dtype once,
// then walks K in steps of BK: it loads the x tile (BM x BK) and the code
// tile (BK x BN) into registers, gathers the codes against the staged
// codebook into an f32 weight tile in shared memory, and each thread
// accumulates 4 rows of one column with fmaf in f32 registers. The next
// step's loads are issued (into registers) before the current step is
// computed on. Ragged edges are masked in the kernel (no padded copies):
// rows and columns past M, N are neither read nor written, and terms past
// K add exactly zero. f32 runs on the CUDA cores in full f32 (no TF32).
//
// Row independence: the result of row m is one fmaf chain over k = 0..K-1
// in a fixed order, in one thread, whatever M is and wherever the row sits
// in its tile: no split over K, no path chosen by M, no special case for
// one row. Chunked prefill and single-row decode thus see bitwise the same
// projections as a whole-prompt call.
//
// Bound on this card: at decode shapes (M = 4 slots) HBM bytes, about one
// byte a parameter of uint8 codes (M*K*2 + K*N + 4L + M*N*2 bytes against
// 2*M*K*N flops, far below the ~295 flops a byte at which the tensor cores
// would bind). The design reads each code once per row tile, 16 bytes a
// thread per step. This first version is simple otherwise: FMA rather
// than tensor-core products, no cp.async/TMA ring (one step of loads in
// flight per block), one block per 64 columns (16-48 blocks at the main
// path's N on 132 SMs), and at M = 4 a 16-row tile is three quarters
// padding. On the H100 each 64-deep step costs ~2.4 us whatever M is
// (PERF.md): the kernel waits on memory latency, not on bytes or flops.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int BM = 16;           // rows of x a block computes
constexpr int BN = 64;           // columns a block computes
constexpr int BK = 64;           // depth of one step
constexpr int WS_LD = BN + 4;    // padded weight-tile row (fewer conflicts)
constexpr int L_MAX = 32768;     // codebook entries (128 KB of shared memory)
constexpr int kStaticSmem = (BM * BK + BK * WS_LD) * 4;

struct Params {
  const void* x;
  const void* idx;
  const float* cb;
  void* out;
  int M, K, N, L;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// a codebook value rounded to x's dtype, kept as the f32 it converts to
template <typename XT> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(
    float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// four consecutive x values (16- or 8-byte aligned)
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  o[0] = __low2float(a); o[1] = __high2float(a);
  o[2] = __low2float(b); o[3] = __high2float(b);
}

// sixteen consecutive codes (16-byte aligned)
__device__ __forceinline__ void load16(const uint8_t* p, int* o) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint8_t* b = reinterpret_cast<const uint8_t*>(&v);
#pragma unroll
  for (int j = 0; j < 16; ++j) o[j] = b[j];
}
__device__ __forceinline__ void load16(const int32_t* p, int* o) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int4 v = reinterpret_cast<const int4*>(p)[q];
    o[4 * q] = v.x; o[4 * q + 1] = v.y; o[4 * q + 2] = v.z;
    o[4 * q + 3] = v.w;
  }
}

// VEC: N % 16 == 0, K % 4 == 0 and 16-byte aligned bases, so a thread's
// 4 x values and 16 codes are each wholly inside or outside the matrix and
// load as vectors; otherwise element by element with per-element masks.
template <typename XT, typename IT, bool VEC>
__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(Params p) {
  extern __shared__ float cb_s[];                  // L entries
  __shared__ float xs[BM][BK];
  __shared__ float ws[BK][WS_LD];

  const int M = p.M, K = p.K, N = p.N, L = p.L;
  const int g = blockIdx.z;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const XT* x = static_cast<const XT*>(p.x) + (size_t)g * M * K;
  const IT* idx = static_cast<const IT*>(p.idx) + (size_t)g * K * N;
  const float* cb = p.cb + (size_t)g * L;
  XT* out = static_cast<XT*>(p.out) + (size_t)g * M * N;
  const int tid = threadIdx.x;

  for (int j = tid; j < L; j += kThreads) cb_s[j] = round_to<XT>(cb[j]);

  // load mapping: x tile 16 x 64 as 4 values a thread; code tile 64 x 64
  // as 16 codes a thread
  const int xr = tid / 16, xc = (tid % 16) * 4;
  const int ir = tid / 4, ic = (tid % 4) * 16;
  // compute mapping: column tx, rows 4*ty .. 4*ty + 3
  const int tx = tid % BN, ty = tid / BN;

  float xv[4];
  int cv[16];
  auto load = [&](int k0) {
    const int m = m0 + xr, k = k0 + xc;
    const XT* xp = x + (size_t)m * K + k;
    if (VEC) {
      if (m < M && k < K) {
        load4(xp, xv);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) xv[j] = 0.f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        xv[j] = (m < M && k + j < K) ? to_f(xp[j]) : 0.f;
    }
    const int kk = k0 + ir, n = n0 + ic;
    const IT* ip = idx + (size_t)kk * N + n;
    if (VEC) {
      if (kk < K && n < N) {
        load16(ip, cv);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) cv[j] = 0;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        cv[j] = (kk < K && n + j < N) ? (int)ip[j] : 0;
    }
  };

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  load(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();          // the last step's reads are done; cb_s staged
#pragma unroll
    for (int j = 0; j < 4; ++j) xs[xr][xc + j] = xv[j];
    const bool live = k0 + ir < K;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = cv[j];
      const float w = ((unsigned)c < (unsigned)L) ? cb_s[c]
                                                  : __int_as_float(0x7fc00000);
      ws[ir][ic + j] = live ? w : 0.f;
    }
    __syncthreads();
    if (k0 + BK < K) load(k0 + BK);
#pragma unroll 16
    for (int kk = 0; kk < BK; ++kk) {
      const float w = ws[kk][tx];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[i] = fmaf(xs[4 * ty + i][kk], w, acc[i]);
    }
  }
  const int n = n0 + tx;
  if (n < N) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + 4 * ty + i;
      if (m < M) store_out(out + (size_t)m * N + n, acc[i]);
    }
  }
}

template <typename XT, typename IT, bool VEC>
int launch(const Params& p, dim3 grid, cudaStream_t s) {
  const size_t smem = (size_t)p.L * sizeof(float);
  if (smem + kStaticSmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        quant_matmul_kernel<XT, IT, VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  quant_matmul_kernel<XT, IT, VEC><<<grid, kThreads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename XT, typename IT>
int launch_vec(const Params& p, dim3 grid, cudaStream_t s, bool vec) {
  return vec ? launch<XT, IT, true>(p, grid, s)
             : launch<XT, IT, false>(p, grid, s);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// Returns 0 or the CUDA error code of a refused launch (cudaGetLastError).
extern "C" int quant_matmul_launch(const void* x, const void* idx,
                                   const void* codebook, void* out, int G,
                                   int M, int K, int N, int L, int x_bf16,
                                   int idx_int32, void* stream) {
  const int gx = (N + BN - 1) / BN, gy = (M + BM - 1) / BM;
  if (G <= 0 || M <= 0 || K <= 0 || N <= 0 || L <= 0 || L > L_MAX ||
      gy > 65535 || G > 65535)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.idx = idx;
  p.cb = static_cast<const float*>(codebook);
  p.out = out;
  p.M = M; p.K = K; p.N = N; p.L = L;
  const bool vec = N % 16 == 0 && K % 4 == 0 && aligned16(x) &&
                   aligned16(idx);
  const dim3 grid(gx, gy, G);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return idx_int32 ? launch_vec<__nv_bfloat16, int32_t>(p, grid, s, vec)
                     : launch_vec<__nv_bfloat16, uint8_t>(p, grid, s, vec);
  return idx_int32 ? launch_vec<float, int32_t>(p, grid, s, vec)
                   : launch_vec<float, uint8_t>(p, grid, s, vec);
}
