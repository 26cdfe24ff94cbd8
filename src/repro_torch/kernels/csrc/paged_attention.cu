// Fused paged attention over a partly codebook-frozen KV pool, for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// repro_torch/kernels/paged_attention.py.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py:
// paged_decode_attention (Pallas body `_kernel`), which also serves chunked
// prefill through paged_prefill_attention (W = C queries, valid = q_offset
// + C).
//
// What it computes, per sequence b and kv head h: walk the block table row
// b over pages j < ceil(valid / bs); a frozen page (blk_q[page] != 0) is
// read as packed 4-bit codes (byte i holds code[i] in its low nibble and
// code[i + Dh/2] in its high nibble) plus the page's two L-entry f32
// codebooks and dequantized on chip as cb[code], rounded to the pool's
// dtype exactly as the install step materializes it; a hot page is read
// as its fp tile. Scores are f32, scaled by 1/sqrt(Dh), optionally
// softcapped, masked per query row to pos < valid - (W-1-w), and folded
// into an online softmax (m, l, acc) in f32. Output acc / max(l, 1e-20)
// in q's dtype.
//
// Grid: one block per (tile of BM query rows, kv head, sequence). The
// rows of a kv head are its W*G queries, ordered (w, g): G = Hq/Hkv query
// heads share the kv head (native GQA, K/V never repeated). A prefill
// chunk of C tokens at G = 2 gives 2C rows, cut into tiles of BM.
//
// Row independence: every row's arithmetic depends only on its own query
// and the pages it walks, never on the tile it sits in or how many rows
// share the launch. Padding rows are skipped without touching a live
// row's arithmetic; there is no special path for one row. Reductions over
// a row's keys (shuffles) stay inside that row's lanes. Pages masked out
// for a row add exactly zero
// (p = 0, corr = 1), so a chunk or a single-row call gives bitwise the
// result of the whole window. Pages past a tile's valid length are never
// read; keys past it inside the last page are zeroed in shared memory, so
// stale or non-finite pool rows cannot reach the products (0 * NaN).
//
// Bound on this card: HBM bytes. Per decode step and layer the kernel must
// read each sequence's live pages once (codes + codebooks for a frozen
// page, the fp tile for a hot one: repro_torch.kernels.
// modeled_hbm_bytes_per_token) plus q and the output, at 3.35 TB/s on an
// H100 SXM. The arithmetic (2 * rows * keys * Dh * 2 flops) is far below
// the FMA rate. The design reads each page once per (tile, kv head) and
// keeps the dequantized tile in shared memory; frozen pages cross HBM at
// ~4 bits/value, in 16-byte vector loads, and the next page's loads are
// in flight (in registers) while the current page is computed on. This
// first version is simple otherwise: no cp.async/TMA ring, FMA rather than
// tensor-core products, one block walks its pages alone (no split over
// pages), and a prefill chunk's tiles each re-read the prefix (from L2).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int BM = 16;        // query rows per block
constexpr int DH_MAX = 128;   // head_dim limit (Dh % 32 == 0: 16-byte rows
                              // of packed codes)
constexpr int BS_MAX = 32;    // block (page) size limit (a power of two)
constexpr int L_MAX = 256;    // codebook width limit (uint8 codes)
constexpr int PT_CHUNK = 128; // block-table entries staged at a time
constexpr float BIG_NEG = -2.3819763e38f;

struct Params {
  const void* q;             // (B, W, Hq, Dh) T
  const void* k_fp;          // (nb, bs, Hkv, Dh) T
  const void* v_fp;
  const uint8_t* k_codes;    // (nb, bs, Hkv, Dc) uint8
  const uint8_t* v_codes;
  const float* k_cb;         // (nb, L) f32
  const float* v_cb;
  const uint8_t* blk_q;      // (nb,) page is served from codes
  const int* block_table;    // (B, mb)
  const int* kv_valid_len;   // (B,)
  void* out;                 // (B, W, Hq, Dh) T
  int B, W, Hq, Hkv, Dh, nb, bs, mb, Dc, L;
  float scale, softcap;
  int quantized, packed;
};

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(
    __nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// a dequantized value as the pool's dtype holds it (the install step
// writes cb[code] into the fp pool in that dtype)
template <typename T> __device__ __forceinline__ float round_pool(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// ------------------------------------------------------------ page tiles
//
// A page's K and V tiles for one kv head are loaded through the read-only
// path into registers (all of a thread's loads issued together): fp rows
// in 16-byte vectors, code rows in 8-byte ones so every thread of the
// block shares the dequantization. Then they are converted or dequantized
// into f32 shared-memory tiles. The loop issues page j+1's
// loads right after staging page j, so they are in flight while page j is
// computed on.

constexpr int VPT = BS_MAX * DH_MAX * 4 / 16 / kThreads;  // fp vectors
constexpr int CPT = BS_MAX * DH_MAX / 8 / kThreads;       // code vectors

struct PageRegs {
  uint4 k[VPT], v[VPT];   // fp rows (16 B each), or code bytes (8 B each)
  float cbk[2], cbv[2];   // codebook entries tid and tid + kThreads
  bool frozen;
};

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// element e of a 16-byte vector of T, as f32 (bf16 is the top half of f32)
template <typename T> __device__ __forceinline__ float elem(const uint4& v,
                                                           int e);
template <> __device__ __forceinline__ float elem<float>(const uint4& v,
                                                         int e) {
  return __uint_as_float(word(v, e));
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(
    const uint4& v, int e) {
  return __uint_as_float(((word(v, e >> 1) >> (16 * (e & 1))) & 0xFFFFu)
                         << 16);
}

// the block-table row's page ids and frozen flags, PT_CHUNK at a time, in
// shared memory: one parallel round of scalar loads instead of two
// dependent loads per page
__device__ __forceinline__ void load_page_ids(const Params& p, int b, int j0,
                                              int n_pages, int* sPage,
                                              bool* sFrozen) {
  const int t = threadIdx.x;
  if (t < PT_CHUNK && j0 + t < n_pages) {
    const int page = p.block_table[b * p.mb + j0 + t];
    sPage[t] = page;
    sFrozen[t] = p.quantized && p.blk_q[page] != 0;
  }
}

template <typename T>
__device__ __forceinline__ void issue_page(const Params& p, int kvh,
                                           int page, bool frozen,
                                           PageRegs& r) {
  const int tid = threadIdx.x;
  r.frozen = frozen;
  if (r.frozen) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = tid + i * kThreads;
      if (t < p.L) {
        r.cbk[i] = __ldg(p.k_cb + (size_t)page * p.L + t);
        r.cbv[i] = __ldg(p.v_cb + (size_t)page * p.L + t);
      }
    }
    const int rowv = p.Dc / 8, nvec = p.bs * rowv;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int vi = tid + i * kThreads;
      if (vi < nvec) {
        const int n = vi / rowv, cv = vi % rowv;
        const size_t off =
            ((size_t)(page * p.bs + n) * p.Hkv + kvh) * p.Dc + cv * 8;
        const uint2 kc = __ldg(reinterpret_cast<const uint2*>(p.k_codes + off));
        const uint2 vc = __ldg(reinterpret_cast<const uint2*>(p.v_codes + off));
        r.k[i] = make_uint4(kc.x, kc.y, 0u, 0u);
        r.v[i] = make_uint4(vc.x, vc.y, 0u, 0u);
      }
    }
    return;
  }
  const uint8_t* kb = static_cast<const uint8_t*>(p.k_fp);
  const uint8_t* vb = static_cast<const uint8_t*>(p.v_fp);
  const int row_bytes = p.Dh * (int)sizeof(T);
  const int rowv = row_bytes / 16, nvec = p.bs * rowv;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int vi = tid + i * kThreads;
    if (vi < nvec) {
      const int n = vi / rowv, cv = vi % rowv;
      const size_t off =
          ((size_t)(page * p.bs + n) * p.Hkv + kvh) * row_bytes + cv * 16;
      r.k[i] = __ldg(reinterpret_cast<const uint4*>(kb + off));
      r.v[i] = __ldg(reinterpret_cast<const uint4*>(vb + off));
    }
  }
}

// registers -> f32 tiles; keys at or past n_live are written as zero
template <typename T>
__device__ __forceinline__ void stage_page(
    const Params& p, const PageRegs& r, int n_live,
    float (*sK)[DH_MAX + 1], float (*sV)[DH_MAX], float (*sCb)[L_MAX]) {
  const int tid = threadIdx.x;
  if (r.frozen) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = tid + i * kThreads;
      if (t < p.L) {   // stored as the pool's dtype rounds them
        sCb[0][t] = round_pool<T>(r.cbk[i]);
        sCb[1][t] = round_pool<T>(r.cbv[i]);
      }
    }
    __syncthreads();   // the page is frozen for the whole block
    const int rowv = p.Dc / 8, nvec = p.bs * rowv, half = p.Dh / 2;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int vi = tid + i * kThreads;
      if (vi < nvec) {
        const int n = vi / rowv, c0 = (vi % rowv) * 8;
        const bool live = n < n_live;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const uint32_t kc = (word(r.k[i], e >> 2) >> (8 * (e & 3))) & 0xFF;
          const uint32_t vc = (word(r.v[i], e >> 2) >> (8 * (e & 3))) & 0xFF;
          if (p.packed) {
            sK[n][c0 + e] = live ? sCb[0][kc & 0xF] : 0.f;
            sK[n][c0 + e + half] = live ? sCb[0][kc >> 4] : 0.f;
            sV[n][c0 + e] = live ? sCb[1][vc & 0xF] : 0.f;
            sV[n][c0 + e + half] = live ? sCb[1][vc >> 4] : 0.f;
          } else {
            sK[n][c0 + e] = live ? sCb[0][kc] : 0.f;
            sV[n][c0 + e] = live ? sCb[1][vc] : 0.f;
          }
        }
      }
    }
  } else {
    constexpr int EPV = 16 / sizeof(T);   // elements per vector
    const int rowv = p.Dh / EPV, nvec = p.bs * rowv;
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int vi = tid + i * kThreads;
      if (vi < nvec) {
        const int n = vi / rowv, d0 = (vi % rowv) * EPV;
        const bool live = n < n_live;
#pragma unroll
        for (int e = 0; e < EPV; ++e) {
          sK[n][d0 + e] = live ? elem<T>(r.k[i], e) : 0.f;
          sV[n][d0 + e] = live ? elem<T>(r.v[i], e) : 0.f;
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Params p) {
  __shared__ float sQ[BM][DH_MAX + 1];
  __shared__ float sK[BS_MAX][DH_MAX + 1];
  __shared__ float sV[BS_MAX][DH_MAX];
  __shared__ float sS[BM][BS_MAX];
  __shared__ float sCb[2][L_MAX];
  __shared__ float sM[BM], sL[BM], sCorr[BM];
  __shared__ int sPage[PT_CHUNK];
  __shared__ bool sFrozen[PT_CHUNK];

  const int tid = threadIdx.x;
  const int tile = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.Hq / p.Hkv;
  const int WG = p.W * G;
  const int Dh = p.Dh, bs = p.bs;
  const int row0 = tile * BM;
  // padding rows (past the kv head's W*G) are never computed: a live
  // row's arithmetic does not depend on them
  const int rows_here = min(BM, WG - row0);
  const int valid = p.kv_valid_len[b];
  const T* q = static_cast<const T*>(p.q);
  T* out = static_cast<T*>(p.out);

  // query rows of this tile, f32 in shared memory
  for (int i = tid; i < rows_here * Dh; i += kThreads) {
    const int m = i / Dh, d = i % Dh, r = row0 + m;
    const int w = r / G, g = r % G;
    sQ[m][d] =
        to_f32<T>(q[((size_t)(b * p.W + w) * p.Hq + kvh * G + g) * Dh + d]);
  }
  if (tid < BM) {
    sM[tid] = BIG_NEG;
    sL[tid] = 0.f;
  }
  // the tile's longest row sees keys < tile_valid; pages past it are
  // fully masked for every row of the tile and are never read
  const int last = row0 + rows_here - 1;
  const int tile_valid = valid - (p.W - 1 - last / G);
  int n_pages = tile_valid > 0 ? (tile_valid + bs - 1) / bs : 0;
  n_pages = min(n_pages, p.mb);

  float acc[BM];
#pragma unroll
  for (int m = 0; m < BM; ++m) acc[m] = 0.f;

  PageRegs regs;
  if (n_pages > 0) {
    load_page_ids(p, b, 0, n_pages, sPage, sFrozen);
    __syncthreads();
    issue_page<T>(p, kvh, sPage[0], sFrozen[0], regs);
  }
  for (int j = 0; j < n_pages; ++j) {
    __syncthreads();  // previous page's readers are done with the tiles
    const int key0 = j * bs;
    stage_page<T>(p, regs, min(bs, tile_valid - key0), sK, sV, sCb);
    const int nxt = j + 1;
    if (nxt < n_pages) {
      if (nxt % PT_CHUNK == 0) {   // next chunk of the block-table row
        __syncthreads();
        load_page_ids(p, b, nxt, n_pages, sPage, sFrozen);
        __syncthreads();
      }
      issue_page<T>(p, kvh, sPage[nxt % PT_CHUNK], sFrozen[nxt % PT_CHUNK],
                    regs);
    }
    __syncthreads();

    // scores: each (row, key) dot product is split over 4 adjacent lanes,
    // lane j summing dims j, j+4, ...; the four partial sums combine as
    // ((s0 + s1) + (s2 + s3)) through two butterfly shuffles
    const int ndots = rows_here * bs;
    for (int base = 0; base < 4 * ndots; base += kThreads) {
      const int i = base + tid, dot = i >> 2;
      const int m = dot / bs, n = dot % bs;
      float s = 0.f;
      if (dot < ndots)
        for (int d = i & 3; d < Dh; d += 4) s += sQ[m][d] * sK[n][d];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (dot < ndots && (i & 3) == 0) {
        s *= p.scale;
        if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
        sS[m][n] = s;
      }
    }
    __syncthreads();

    // online softmax: one lane per (row, key), a row's bs lanes inside one
    // warp; row max and sum by butterfly shuffles over those lanes
    for (int base = 0; base < ndots; base += kThreads) {
      const int i = base + tid;
      const bool act = i < ndots;
      const int m = act ? i / bs : 0, n = i % bs;
      const int row_valid = valid - (p.W - 1 - (row0 + m) / G);
      const bool live = act && key0 + n < row_valid;
      const float m_old = sM[m];
      float mx = live ? sS[m][n] : BIG_NEG;
      for (int off = bs >> 1; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      mx = fmaxf(m_old, mx);
      const float e = live ? expf(sS[m][n] - mx) : 0.f;
      float lsum = e;
      for (int off = bs >> 1; off > 0; off >>= 1)
        lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
      __syncwarp();   // every lane of the row has read sM[m]
      if (act) {
        sS[m][n] = e;
        if (n == 0) {
          const float corr = expf(m_old - mx);
          sL[m] = sL[m] * corr + lsum;
          sM[m] = mx;
          sCorr[m] = corr;
        }
      }
    }
    __syncthreads();

    // acc = acc * corr + P @ V; thread tid owns column d = tid, keys
    // summed in order, rows as independent chains
    if (tid < Dh) {
      float pv[BM];
#pragma unroll
      for (int m = 0; m < BM; ++m) pv[m] = 0.f;
      for (int n = 0; n < bs; ++n) {
        const float vv = sV[n][tid];
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          if (m >= rows_here) break;
          pv[m] += sS[m][n] * vv;
        }
      }
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        if (m >= rows_here) break;
        acc[m] = acc[m] * sCorr[m] + pv[m];
      }
    }
  }
  __syncthreads();

  if (tid < Dh) {
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      const int r = row0 + m;
      if (m < rows_here) {
        const int w = r / G, g = r % G;
        out[((size_t)(b * p.W + w) * p.Hq + kvh * G + g) * Dh + tid] =
            from_f32<T>(acc[m] / fmaxf(sL[m], 1e-20f));
      }
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = launched); shapes are validated by the Python wrapper.
extern "C" int paged_attention_launch(
    const void* q, const void* k_fp, const void* v_fp, const void* k_codes,
    const void* v_codes, const void* k_cb, const void* v_cb,
    const void* blk_q, const void* block_table, const void* kv_valid_len,
    void* out, int B, int W, int Hq, int Hkv, int Dh, int nb, int bs, int mb,
    int Dc, int L, float scale, float softcap, int quantized, int packed,
    int dtype, void* stream) {
  if (Dh > DH_MAX || Dh % 32 != 0 || bs > BS_MAX || (bs & (bs - 1)) != 0 ||
      L > L_MAX || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k_fp = k_fp;
  p.v_fp = v_fp;
  p.k_codes = static_cast<const uint8_t*>(k_codes);
  p.v_codes = static_cast<const uint8_t*>(v_codes);
  p.k_cb = static_cast<const float*>(k_cb);
  p.v_cb = static_cast<const float*>(v_cb);
  p.blk_q = static_cast<const uint8_t*>(blk_q);
  p.block_table = static_cast<const int*>(block_table);
  p.kv_valid_len = static_cast<const int*>(kv_valid_len);
  p.out = out;
  p.B = B; p.W = W; p.Hq = Hq; p.Hkv = Hkv; p.Dh = Dh; p.nb = nb; p.bs = bs;
  p.mb = mb; p.Dc = Dc; p.L = L;
  p.scale = scale;
  p.softcap = softcap;
  p.quantized = quantized;
  p.packed = packed;
  const int rows = W * (Hq / Hkv);
  dim3 grid((rows + BM - 1) / BM, Hkv, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    paged_attention_kernel<float><<<grid, kThreads, 0, s>>>(p);
  else if (dtype == 1)
    paged_attention_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
