// Codebook-dequant matrix product y = x @ codebook[idx], for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// repro_torch/kernels/quant_matmul.py.
//
// Replaces the TPU kernels repro/kernels/quant_matmul.py: quant_matmul
// (:50, Pallas body `_kernel`) and quant_matmul_stacked (:105, body
// `_stacked_kernel`, the same tile with an outer group axis). One kernel
// serves both: the flat form is G = 1, the groups sit on grid z.
//
// What it computes, per group g: y[g] = x[g] @ W[g] with W[g][k][n] =
// codebook[g][idx[g][k][n]] rounded to x's dtype (the reference's
// `w_tile.astype(x.dtype)`), products accumulated in f32 and rounded once
// to x's dtype. x is (G, M, K) bf16 or f32; idx is (G, K, N) row-major
// uint8 or int32 codes; codebook is (G, L) f32, L <= 32768. A code outside
// [0, L) reads as NaN (jnp.take's fill mode), never as another entry.
// Ragged M, K, N are handled here, with no padded copies: rows and columns
// past M, N are never stored, and terms past K add exactly zero (x and the
// weight are both zero there, whatever the code).
//
// Bound on this card: HBM bytes at every shape of the main path. A
// qwen3-0.6B projection reads K*N code bytes (1-3 MB), M*K*2 bytes of x
// and writes M*N*2; at M = 4 that is ~2 flops a byte and at M = 64 ~30,
// far below the ~295 flops a byte at which the bf16 tensor cores would
// bind. One layer's seven projections: 4.75 us at M = 4, 5.56 us at
// M = 64 (3.35 TB/s). At these sizes a call is a few microseconds of work
// that has to fill 132 SMs; what holds the kernel above the bound is the
// latency of each block's chain (load, dequantize, multiply, reduce) and
// the shared-memory instructions of the dequantization (PERF.md).
//
// The split of K (repro_torch/kernels/quant_matmul.py:plan, checked
// here) is chosen from (K, N, L, x dtype, code dtype) alone, never from M
// or G; the shared-memory layout below is this file's own:
//   - a block computes a BM x BN = 64 x 64 output tile over one split of
//     K; K is cut into `splits` (1-8) ranges of `split_steps` whole BK =
//     64 steps each (the last range may be shorter, only the last step of
//     the last range is ragged);
//   - the `splits` blocks of a column tile form one thread-block cluster,
//     (splits, 1, 1), so that each projection launches 128-192 blocks
//     where a tile per block gave 16-48;
//   - each block keeps min(2, split_steps) steps of loads in flight in a
//     ring in shared memory: one tensor copy (TMA) per 16 rows of x and
//     one per code tile, issued by one thread, completing on the slot's
//     mbarrier. Elements past M, K and N arrive as zeros, so ragged shapes
//     need no masks on the loads. Two slots, not all of a split's steps:
//     shared memory, not loads in flight, limits the blocks an SM holds
//     (four at the main path's 43 KB);
//   - the codebook is staged in shared memory rounded to x's dtype once,
//     L + 1 entries, entry L a NaN (bf16 64 KB or f32 128 KB at L = 32768;
//     with the ring and the shares at most 211 KB of the 227 KB).
// Grid: (N tiles * splits, ceil(M / BM), G), 256 threads.
//
// Products. bf16 x: the tensor cores, mma.sync.m16n8k16 (bf16 in, f32
// accumulate). Each of the 8 warps owns 8 columns; its B fragments are
// built in registers straight from the staged code tile and codebook (a
// lane needs exactly the 16 weights its fragment holds, so the
// dequantized tile never goes through shared memory), its A fragments come
// from the x ring by ldmatrix. Rows are padded to 16 with zeros for every
// M: decode (M = 4) and prefill chunks (M = 64) run the same instruction
// sequence, one to four 16-row m-tiles. wgmma is not needed: a 64-row
// warpgroup tile would be 15/16 padding at M = 4, and the kernel is bound
// by bytes, not by the rate of the products. f32 x: full f32 fmaf on the
// CUDA cores (no TF32), one thread a column and up to 16 rows, in the same
// plan, grid and reduction.
//
// Split-K reduction in distributed shared memory: rank r of a cluster owns
// rows r * rpr .. of the tile. Every block writes its f32 partial of each
// row into the owner's shared memory (cluster.map_shared_rank), slice
// `rank`; after cluster.sync() each owner adds its rows' `splits` slices
// in rank order 0..splits-1, rounds once and stores. No workspace, no
// counter, no atomics, one launch.
//
// Row independence: the result of row m is, per split, one chain over its
// k steps in a fixed order (the MMA's k16 steps, or one fmaf chain), and
// the splits are added in rank order. The split is fixed by (K, N, L,
// dtype) and no path is chosen by M or G, nor by a row's place in its
// tile. Chunked prefill and single-row decode thus see bitwise the same
// projections as a whole-prompt call, and each stacked group equals the
// flat kernel on its codes.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;    // 8 warps
constexpr int BM = 64;           // rows of x a block computes (4 m-tiles)
constexpr int BN = 64;           // columns a block computes
constexpr int BK = 64;           // depth of one step
constexpr int MAX_SPLITS = 8;    // the portable cluster size
constexpr int RING = 2;          // ring slots: steps of loads in flight
constexpr int L_MAX = 32768;
constexpr int SMEM_MAX = 232448; // 227 KB, what a block may use
constexpr int BAR_BYTES = 8 * RING;                   // one mbarrier a slot
constexpr int ALIGN_BYTES = 1024;                     // ring alignment slack
// the split-K shares: S slices of ceil(BM / S) rows, at most 70 rows
constexpr int RED_BYTES = (BM + MAX_SPLITS - 1) * BN * 4;

// A ring slot: x (BM x BK) then codes (BK x BN), both dense, as the tensor
// copies write them. bf16 x rows are 128 bytes in the 128-byte swizzle
// (16-byte piece c of row r at piece c ^ (r % 8)), uint8 code rows 64 bytes
// in the 64-byte swizzle (piece c of row k at c ^ (k / 2 % 4)), so that the
// fragment reads below hit 32 banks; f32 x is read by broadcast and int32
// codes are left unswizzled.
template <typename XT>
__host__ __device__ constexpr int x_tile_bytes() {
  return BM * BK * (int)sizeof(XT);
}
template <typename XT, typename IT>
__host__ __device__ constexpr int stage_bytes() {
  return x_tile_bytes<XT>() + BK * BN * (int)sizeof(IT);
}
template <typename XT>
__device__ __forceinline__ int x_off(int r, int k) {  // element offset
  if constexpr (sizeof(XT) == 2)
    return r * BK + ((((k >> 3) ^ r) & 7) << 3) + (k & 7);
  else
    return r * BK + k;
}
template <typename IT>
__device__ __forceinline__ int c_off(int k, int n) {
  if constexpr (sizeof(IT) == 1)
    return k * BN + ((((n >> 4) ^ (k >> 1)) & 3) << 4) + (n & 15);
  else
    return k * BN + n;
}

struct Params {
  CUtensorMap tx;                // x as (K, M, G), boxes of BK x 16 x 1
  CUtensorMap tc;                // codes as (N, K, G), boxes of BN x BK x 1
  const void* x;
  const void* idx;
  const float* cb;
  void* out;
  int M, K, N, L;
  int splits, split_steps;
  int stages;                    // ring slots in use, min(RING, split_steps)
  int cb_bytes;                  // the staged codebook, 16-byte rounded
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// the slot's one arrival, announcing the bytes its copies will bring
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\n"
      "bra.uni WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// one box of a 3-d tensor map into shared memory by the copy engine,
// completing on `bar`; elements outside the tensor arrive as zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, int c2,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* a, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// The staged codebook holds L + 1 entries in x's dtype, entry L a NaN: a
// code outside [0, L) (as unsigned, past L) reads entry L, with no branch.
__device__ __forceinline__ uint32_t lookup(const uint16_t* cb, int c,
                                           int L) {
  return cb[min((unsigned)c, (unsigned)L)];
}
__device__ __forceinline__ float lookup(const float* cb, int c, int L) {
  return cb[min((unsigned)c, (unsigned)L)];
}

// One step's x tile (rows m0.. of the m-tiles in use, BK deep from k0) and
// code tile (BK x BN from (k0, n0)) into a ring slot.
//
// VEC (checked in quant_matmul_launch: 16-byte bases, rows of whole
// 16-byte pieces): one thread issues one tensor copy per live m-tile of x
// and one for the codes, after announcing their bytes on the slot's
// mbarrier. Elements past M, K and N arrive as zeros.
//
// Otherwise element by element by every thread, zero past M, K and N.
template <typename XT, typename IT, bool VEC>
__device__ __forceinline__ void load_stage(
    XT* xs, IT* cs, uint64_t* bar, const Params& p, const XT* x,
    const IT* idx, int rows, int mt_live, int m0, int n0, int k0, int g,
    int tid) {
  if constexpr (VEC) {
    mbar_expect(bar, (uint32_t)(mt_live * 16 * BK * sizeof(XT) +
                                BK * BN * sizeof(IT)));
    tma_load(cs, &p.tc, n0, k0, g, bar);
    for (int mt = 0; mt < mt_live; ++mt)
      tma_load(xs + mt * 16 * BK, &p.tx, k0, m0 + mt * 16, g, bar);
  } else {
    const int K = p.K, N = p.N;
    for (int t = tid; t < mt_live * 16 * BK; t += kThreads) {
      const int r = t / BK, k = t % BK;
      xs[x_off<XT>(r, k)] = (r < rows && k0 + k < K)
                                ? x[(size_t)r * K + k0 + k]
                                : XT(0.f);
    }
    for (int t = tid; t < BK * BN; t += kThreads) {
      const int r = t / BN, n = t % BN;
      cs[c_off<IT>(r, n)] = (k0 + r < K && n0 + n < N)
                                ? idx[(size_t)(k0 + r) * N + n0 + n]
                                : IT(0);
    }
  }
}

// One step on the tensor cores: warp w's 8 columns for every live m-tile.
// Lane (g, q) = (lane / 4, lane % 4) builds the B fragments of column
// w * 8 + g at k = 2q, 2q + 1, 2q + 8, 2q + 9 of each 16-deep slice: all
// 16 codes of the step first, then their lookups, with no branch, then the
// A fragments and the products. Weights at k >= kmax (past K) are zero, as
// x is there, whatever code the slot holds.
template <typename IT>
__device__ __forceinline__ void step_bf16(float* acc,
                                          const __nv_bfloat16* xs,
                                          const IT* cs, const uint16_t* cbs,
                                          int L, int kmax, int mt_live,
                                          int warp, int lane) {
  constexpr int KS = BK / 16;                     // k16 slices a step
  const int g = lane >> 2, q = lane & 3, col = warp * 8 + g;
  int code[KS * 4];
#pragma unroll
  for (int j = 0; j < KS * 4; ++j) {
    const int k = (j / 4) * 16 + 2 * q + (j & 1) + (j & 2) * 4;
    code[j] = (int)cs[c_off<IT>(k, col)];
  }
  uint32_t b[KS * 2];
#pragma unroll
  for (int j = 0; j < KS * 2; ++j)
    b[j] = lookup(cbs, code[2 * j], L) | (lookup(cbs, code[2 * j + 1], L)
                                          << 16);
  if (kmax < BK) {                                // the ragged last step
#pragma unroll
    for (int j = 0; j < KS * 2; ++j) {
      const int k = (j / 2) * 16 + 2 * q + (j & 1) * 8;
      b[j] &= (k < kmax ? 0xffffu : 0u) | (k + 1 < kmax ? 0xffff0000u : 0u);
    }
  }
  const int ar = lane & 15, ac = lane >> 4;       // ldmatrix row, half
#pragma unroll
  for (int mt = 0; mt < BM / 16; ++mt) {
    if (mt < mt_live) {
      uint32_t a[KS][4];
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4(a[kk], xs + x_off<__nv_bfloat16>(mt * 16 + ar,
                                                      kk * 16 + ac * 8));
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        mma_bf16(acc + 4 * mt, a[kk], b[2 * kk], b[2 * kk + 1]);
    }
  }
}

// One step in f32 on the CUDA cores: column tid % 64, rows tid / 64 + 4i,
// each row one fmaf chain in k order, over the step's k < kmax.
template <typename IT>
__device__ __forceinline__ void step_f32(float* acc, const float* xs,
                                         const IT* cs, const float* cbs,
                                         int L, int kmax, int n_rows,
                                         int tid) {
  const int c = tid & (BN - 1), r0 = tid / BN, kend = min(BK, kmax);
#pragma unroll 8
  for (int k = 0; k < kend; ++k) {
    const float wv = lookup(cbs, (int)cs[c_off<IT>(k, c)], L);
#pragma unroll
    for (int i = 0; i < BM / 4; ++i)
      if (i < n_rows)
        acc[i] = fmaf(xs[x_off<float>(r0 + 4 * i, k)], wv, acc[i]);
  }
}

// Block (rank r of its cluster) computes split r of the output tile
// (blockIdx.x / S, blockIdx.y) of group blockIdx.z.
template <typename XT, typename IT, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
quant_matmul_kernel(const __grid_constant__ Params p) {
  constexpr bool BF16 = sizeof(XT) == 2;
  using CBT = typename std::conditional<BF16, uint16_t, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  // every block of the cluster must have started before any writes into
  // its shared memory (the split-K shares, below): arrive now, wait there
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  const int M = p.M, K = p.K, N = p.N, L = p.L, S = p.splits;
  const int rank = (int)cluster.block_rank();      // == blockIdx.x % S
  const int n0 = (blockIdx.x / S) * BN, m0 = blockIdx.y * BM;
  const int g = blockIdx.z;
  const int rows = min(BM, M - m0);                // live rows of the tile
  const int mt_live = (rows + 15) / 16;
  const XT* x = static_cast<const XT*>(p.x) + ((size_t)g * M + m0) * K;
  const IT* idx = static_cast<const IT*>(p.idx) + (size_t)g * K * N;
  const float* cb = p.cb + (size_t)g * L;
  XT* out = static_cast<XT*>(p.out) + ((size_t)g * M + m0) * N;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // shared memory: slot barriers | codebook (L + 1 entries in x's dtype) |
  // ring (1024-aligned) | split-K shares
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  CBT* cbs = reinterpret_cast<CBT*>(smem + BAR_BYTES);
  const uint32_t base = smem_addr(smem);
  unsigned char* ring =
      smem + (((base + BAR_BYTES + p.cb_bytes + ALIGN_BYTES - 1) &
               ~(uint32_t)(ALIGN_BYTES - 1)) - base);
  const int nst = p.stages;
  float* red = reinterpret_cast<float*>(ring + nst * stage_bytes<XT, IT>());

  // this block's K range: steps [s0, s0 + n_steps)
  const int total_steps = (K + BK - 1) / BK;
  const int s0 = rank * p.split_steps;
  const int n_steps = min(p.split_steps, total_steps - s0);
  auto slot_x = [&](int s) {
    return reinterpret_cast<XT*>(ring + s * stage_bytes<XT, IT>());
  };
  auto slot_c = [&](int s) {
    return reinterpret_cast<IT*>(ring + s * stage_bytes<XT, IT>() +
                                 x_tile_bytes<XT>());
  };
  // step i into slot s: with tensor copies by lane 0 of warp `by`
  auto issue = [&](int i, int s, int by) {
    if (!VEC || tid == by * 32)
      load_stage<XT, IT, VEC>(slot_x(s), slot_c(s), bars + s, p, x, idx,
                              rows, mt_live, m0, n0, (s0 + i) * BK, g, tid);
  };

  if (VEC && tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&p.tc))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&p.tx))
                 : "memory");
    for (int s = 0; s < nst; ++s) mbar_init(bars + s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();                 // the barriers are initialized

  // every load of the first `nst` steps in flight at once, step s issued
  // by warp s % 8
  int issued = 0;
  for (; issued < min(nst, n_steps); ++issued)
    issue(issued, issued, issued % (kThreads / 32));
  for (int j = tid; j <= L; j += kThreads) {
    const float v = j < L ? cb[j] : __int_as_float(0x7fc00000);
    if constexpr (BF16)
      cbs[j] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
    else
      cbs[j] = v;
  }
  __syncthreads();                 // the codebook is staged

  // bf16: m-tile mt's fragment at acc[4 mt ..]; f32: row tid / 64 + 4i
  float acc[16] = {};
  const int f32_rows = (rows - tid / BN + 3) / 4;  // f32: rows of a thread
  for (int i = 0, s = 0; i < n_steps; ++i) {
    if constexpr (VEC) mbar_wait(bars + s, (i / nst) & 1);
    const int kmax = K - (s0 + i) * BK;
    if constexpr (BF16) {
      step_bf16<IT>(acc, slot_x(s), slot_c(s), cbs, L, kmax, mt_live, warp,
                    lane);
    } else {
      step_f32<IT>(acc, slot_x(s), slot_c(s), cbs, L, kmax, f32_rows, tid);
    }
    if (issued < n_steps) {
      __syncthreads();                             // slot s is free
      issue(issued++, s, 0);
      if (!VEC) __syncthreads();                   // the step has landed
    }
    s = s + 1 == nst ? 0 : s + 1;
  }

  // Split-K: rank r owns rows [r * rpr, (r + 1) * rpr) of the tile. Every
  // block sends its partial of each live row to the row's owner, into
  // slice `rank` of the owner's `red`; then each rank adds the S slices of
  // its rows in rank order and rounds once.
  const int rpr = (rows + S - 1) / S;              // rows a rank owns
  // r / rpr as a product, exact for r < 64 and rpr <= 64 (the error
  // r * (inv * rpr - 2^16) / (2^16 * rpr) stays below 1 / rpr)
  const unsigned inv = (65536u + rpr - 1) / rpr;
  auto dst = [&](int r, int c) {                   // r < rows
    const int owner = (int)(((unsigned)r * inv) >> 16);
    return cluster.map_shared_rank(
        red + ((rank * rpr + r - owner * rpr) * BN + c), owner);
  };
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if constexpr (BF16) {
    const int gr = lane >> 2, c = warp * 8 + 2 * (lane & 3);
#pragma unroll
    for (int mt = 0; mt < BM / 16; ++mt) {
      if (mt < mt_live) {
        const int r = mt * 16 + gr;
        if (r < rows)
          *reinterpret_cast<float2*>(dst(r, c)) =
              make_float2(acc[4 * mt], acc[4 * mt + 1]);
        if (r + 8 < rows)
          *reinterpret_cast<float2*>(dst(r + 8, c)) =
              make_float2(acc[4 * mt + 2], acc[4 * mt + 3]);
      }
    }
  } else {
    const int c = tid & (BN - 1), r0 = tid / BN;
#pragma unroll
    for (int i = 0; i < BM / 4; ++i)
      if (i < f32_rows) *dst(r0 + 4 * i, c) = acc[i];
  }
  cluster.sync();                  // every share delivered; none read later

  const int r0 = rank * rpr, n_el = max(0, min(rpr, rows - r0)) * BN;
  for (int e = tid; e < n_el; e += kThreads) {
    const int c = e % BN;
    if (n0 + c >= N) continue;
    float sum = red[e];
    for (int j = 1; j < S; ++j) sum += red[j * rpr * BN + e];
    store_out(out + (size_t)(r0 + e / BN) * N + n0 + c, sum);
  }
}

template <typename XT, typename IT, bool VEC>
int launch(const Params& p, dim3 grid, int smem, cudaStream_t s) {
  auto kern = quant_matmul_kernel<XT, IT, VEC>;
  if (smem > 48 * 1024) {          // the opt-in is per device: every call
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// shared memory of a block: slot barriers, the codebook (L + 1 entries in
// x's dtype), the ring (1024-byte aligned), the split-K shares; fills in
// p.stages and p.cb_bytes
template <typename XT, typename IT>
int smem_layout(Params& p) {
  p.stages = p.split_steps < RING ? p.split_steps : RING;
  p.cb_bytes = ((p.L + 1) * (int)sizeof(XT) + 15) / 16 * 16;
  return BAR_BYTES + p.cb_bytes + ALIGN_BYTES +
         p.stages * stage_bytes<XT, IT>() + RED_BYTES;
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// a (d0, d1, d2) row-major tensor of `bytes`-wide elements, boxes of
// (b0, b1, 1)
bool encode(CUtensorMap* map, CUtensorMapDataType type, int bytes,
            const void* ptr, int d0, int d1, int d2, int b0, int b1,
            CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1,
                              (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)d0 * bytes,
                                 (cuuint64_t)d0 * d1 * bytes};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename XT, typename IT>
int dispatch(Params& p, int G, dim3 grid, cudaStream_t s, bool vec) {
  const int smem = smem_layout<XT, IT>(p);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (!vec) return launch<XT, IT, false>(p, grid, smem, s);
  constexpr bool BF16 = sizeof(XT) == 2, U8 = sizeof(IT) == 1;
  if (!encode(&p.tx, BF16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                          : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
              sizeof(XT), p.x, p.K, p.M, G, BK, 16,
              BF16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode(&p.tc, U8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                        : CU_TENSOR_MAP_DATA_TYPE_INT32,
              sizeof(IT), p.idx, p.N, p.K, G, BN, BK,
              U8 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  return launch<XT, IT, true>(p, grid, smem, s);
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

}  // namespace

// Returns 0 or the CUDA error code of a refused launch (cudaGetLastError);
// cudaErrorInvalidValue for shapes or a plan the kernel does not take.
extern "C" int quant_matmul_launch(const void* x, const void* idx,
                                   const void* codebook, void* out, int G,
                                   int M, int K, int N, int L, int x_bf16,
                                   int idx_int32, int splits,
                                   int split_steps, void* stream) {
  const int tiles = (N + BN - 1) / BN, gy = (M + BM - 1) / BM;
  const int steps = (K + BK - 1) / BK;
  if (G <= 0 || M <= 0 || K <= 0 || N <= 0 || L <= 0 || L > L_MAX ||
      gy > 65535 || G > 65535 || splits < 1 || splits > MAX_SPLITS ||
      split_steps < 1 || (splits - 1) * split_steps >= steps ||
      splits * split_steps < steps)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.x = x;
  p.idx = idx;
  p.cb = static_cast<const float*>(codebook);
  p.out = out;
  p.M = M; p.K = K; p.N = N; p.L = L;
  p.splits = splits; p.split_steps = split_steps;
  // tensor copies: 16-byte bases, rows of whole 16-byte pieces
  const int xe = x_bf16 ? 8 : 4, ce = idx_int32 ? 4 : 16;
  const bool vec = K % xe == 0 && N % ce == 0 && aligned16(x) &&
                   aligned16(idx);
  const dim3 grid(tiles * splits, gy, G);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return idx_int32 ? dispatch<__nv_bfloat16, int32_t>(p, G, grid, s, vec)
                     : dispatch<__nv_bfloat16, uint8_t>(p, G, grid, s, vec);
  return idx_int32 ? dispatch<float, int32_t>(p, G, grid, s, vec)
                   : dispatch<float, uint8_t>(p, G, grid, s, vec);
}

// The ring slots and shared-memory bytes of a block for a split of
// `split_steps` steps and an L-entry codebook (what a launch uses).
// -1 for a codebook or split the kernel does not take.
extern "C" int quant_matmul_smem(int L, int x_bf16, int idx_int32,
                                 int split_steps, int* stages) {
  if (L <= 0 || L > L_MAX || split_steps < 1) return -1;
  Params p = {};
  p.L = L;
  p.split_steps = split_steps;
  const int smem =
      x_bf16 ? (idx_int32 ? smem_layout<__nv_bfloat16, int32_t>(p)
                          : smem_layout<__nv_bfloat16, uint8_t>(p))
             : (idx_int32 ? smem_layout<float, int32_t>(p)
                          : smem_layout<float, uint8_t>(p));
  *stages = p.stages;
  return smem;
}
