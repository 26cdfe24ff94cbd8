// Fused paged attention over a partly codebook-frozen KV pool, for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// repro_torch/kernels/paged_attention.py.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py:
// paged_decode_attention (Pallas body `_kernel`), which also serves chunked
// prefill through paged_prefill_attention (W = C queries, valid = q_offset
// + C).
//
// What it computes, per sequence b and kv head h: the W*G query rows of
// the kv head (ordered (w, g): G = Hq/Hkv query heads share it, native
// GQA) attend over the block-table row b, pages j < ceil(valid / bs). A
// frozen page (blk_q[page] != 0) is read as packed 4-bit codes (byte i
// holds code[i] in its low nibble and code[i + Dh/2] in its high nibble)
// plus the page's two L-entry f32 codebooks and dequantized on chip as
// cb[code], rounded to the pool's dtype exactly as the install step
// materializes it; a hot page is read as its fp tile. Scores are f32,
// scaled by 1/sqrt(Dh), optionally softcapped, masked per query row to
// pos < valid - (W-1-w); softmax in f32; output acc / max(l, 1e-20) in
// q's dtype.
//
// Bound on this card: HBM bytes for a decode step (each live page once,
// as codes + codebooks when frozen), and bytes too for a 64-token prefill
// chunk once its products run on the tensor cores. At these sizes a call
// is a few microseconds of work, so what holds a kernel above its bound is
// the latency of each block's chain (page ids, loads, dequantization,
// products, merge) and how many blocks share it. The design:
//
//   - Launch plan (repro_torch/kernels/paged_attention.py:plan, checked
//     here): a kv head's keys are cut into splits of SPLIT_KEYS = 64 keys,
//     split s covering pages [sP, sP + P), P = 64 / bs, fixed by page index
//     alone. The query rows are cut into tiles of BM = 16 (one m16 tile).
//     The `cluster` (1-8) blocks of a (tile, kv head, sequence) form one
//     thread-block cluster; rank r computes splits r, r + cluster, ... .
//     A decode step of 4 x 272 tokens thus runs 160 working blocks, where
//     one block per (tile, kv head, sequence) gave 32.
//   - A block has 4 warps; warp w computes keys [16w, 16w + 16) of its
//     split for the tile's 16 rows: its own page ids (block table, then
//     the frozen flag), its own loads (one bulk async copy per key row,
//     the fp row of a hot page or the code row of a frozen one, and the
//     pages' codebooks, all completing on the warp's mbarrier: 16-byte
//     cp.async requests spent most of a warp's chain being issued), its
//     own dequantization, in place in its slot of shared memory (codes to
//     registers, then values over them; a warp whose pages are all hot
//     skips it). All of a split's loads are in flight at once; for a
//     sequence longer than cluster x 64 keys the next split's loads are
//     issued before the cluster merge of the current one.
//   - Products. bf16 pools: the tensor cores, mma.sync.m16n8k16 bf16 x
//     bf16 -> f32. QK^T from ldmatrix fragments of the Q and K tiles
//     (exact products, f32 sums). P@V from the score registers reused as
//     A fragments (the FlashAttention-2 layout) with P split as hi + lo,
//     two bf16 products (|p - hi - lo| <= 2^-18 p), V by ldmatrix.trans.
//     f32 pools (the f32 replays): full f32 fmaf on the CUDA cores, never
//     TF32, in the same register layout, plan, grid and merge.
//   - Merge: a warp's partial (m, l, acc) covers its 16 keys; the block
//     folds its 4 warps' partials in key order, then pushes the split's
//     partial rows to the rank that owns them (distributed shared memory,
//     cluster.map_shared_rank), and each owner folds the splits in split
//     order: one left fold over splits 0, 1, 2, ..., whatever the cluster
//     size or the round. No workspace, no atomics, one launch. The rows
//     are owned by the ranks that have a split; a rank with none exits at
//     once (the cluster barriers wait only for blocks that have not
//     exited), so a 64-token prefill chunk's idle ranks hold no slot. A
//     tile whose rows see one split at most skips the exchange (rank 0
//     alone). The merge coefficients are computed once per row.
//
// Row independence: a row's result is, bit for bit, a function of its
// own query and its live keys. Decode rows and prefill chunks run the
// same tiles and instructions (a 2-row decode tile is a 16-row mma tile
// with zero padding rows; a row of mma output depends on its own A row
// alone). A key past a row's valid length gets p = 0 by selection, not by
// arithmetic. A partial with no live key of a row has l = 0 and is
// skipped by the fold, and the fold's first live partial is copied, so
// splits (or warps) that are fully masked for a row - computed, or never
// read because they lie past the tile's longest row - leave the row's
// bits unchanged. Chunked prefill thus equals the whole prompt bitwise,
// and a W-row window equals W single rows.
//
// Pages past the tile's longest row are never read; keys past it inside
// the last page are zeroed in shared memory, so stale or non-finite pool
// rows cannot reach the products (0 * NaN).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int KG = 4;                    // warps a block
constexpr int kThreads = KG * 32;
constexpr int BM = 16;                   // query rows a tile (one m16 tile)
constexpr int CHUNK = 16;                // keys a warp computes per split
constexpr int SPLIT_KEYS = KG * CHUNK;   // keys a split
constexpr int MAX_CLUSTER = 8;           // the portable cluster size
constexpr int DH_MAX = 128;              // head_dim limit (Dh % 32 == 0)
constexpr int BS_MAX = 32;               // block (page) size limit
constexpr int L_MAX = 256;               // codebook width limit (uint8)
constexpr int SMEM_MAX = 232448;         // 227 KB, what a block may use
constexpr int MAX_DEVICES = 64;
constexpr float BIG_NEG = -2.3819763e38f;

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// Byte offsets into the block's dynamic shared memory:
//   q      the tile's 16 query rows in the pool's dtype;
//   bars   one mbarrier a warp, on which its slot's copies complete;
//   ring   one slot a warp: its K tile, V tile (16 rows each; a frozen
//          key's code row lands at the start of its tile row and is
//          dequantized over itself) and the codebooks of its pages; after
//          the products the slot holds the warp's staged partial (16 rows
//          of acc, then (m, l) per row);
//   ids    the page id and frozen flag of each warp's pages;
//   rows   each tile row's element offset in q and out;
//   red    the split partials pushed to this rank: slice r = rank r's, rpr
//          rows of Dh floats; red_ml their (m, l) per row;
//   coef   a fold's per-row steps (c0, c1), row_ml its rows' (M, L);
//   run    the running fold of the owned rows between rounds (several
//          rounds: ceil(BM / cluster) rows), and run_ml (M, L) per owned
//          row (up to BM rows when fewer ranks own them).
// Tile rows are padded by 16 bytes, so the 8 rows of an ldmatrix hit 32
// banks; staged rows by 8 floats. The kernel is compiled per head_dim
// (32, 64, 96, 128): its index arithmetic divides by constants only.
struct Layout {
  int slot;         // bytes a warp's slot
  int q, bars, ring, ids, rows, red, red_ml, coef, row_ml, run, run_ml,
      total;
  int rpr;          // rows an owner folds across rounds: ceil(BM / cluster)
};

template <typename T>
__host__ __device__ constexpr int tile_pitch(int Dh) {  // bytes a tile row
  return Dh * (int)sizeof(T) + 16;
}

template <typename T>
Layout make_layout(int Dh, int bs, int L, int cluster) {
  Layout s;
  const int ppw = bs >= CHUNK ? 1 : CHUNK / bs;   // pages a warp's keys
  // K and V tiles, then the codebooks; or the staged partial
  const int ring_need =
      2 * CHUNK * tile_pitch<T>(Dh) + align16(2 * ppw * L * 4);
  const int stage_need = BM * (Dh + 8) * 4 + BM * 2 * 4;
  s.slot = align16(ring_need > stage_need ? ring_need : stage_need);
  s.rpr = (BM + cluster - 1) / cluster;
  // the slices pushed to an owner: o owners of ceil(BM / o) rows each hold
  // at most BM + o - 1, for any o <= cluster
  const int slices = BM + cluster - 1;
  const int steps = BM * KG > slices ? BM * KG : slices;
  s.q = 0;
  s.bars = align16(BM * tile_pitch<T>(Dh));
  s.ring = s.bars + align16(KG * 8);
  s.ids = s.ring + KG * s.slot;
  s.rows = s.ids + KG * CHUNK * 2 * 4;
  s.red = s.rows + BM * 8;
  s.red_ml = s.red + slices * Dh * 4;
  s.coef = align16(s.red_ml + slices * 2 * 4);
  s.row_ml = s.coef + steps * 2 * 4;
  s.run = align16(s.row_ml + BM * 2 * 4);
  s.run_ml = s.run + s.rpr * Dh * 4;       // (M, L) of any owner's rows
  s.total = align16(s.run_ml + BM * 2 * 4);
  return s;
}

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
  int bs_shift;              // log2(bs)
  float scale, softcap;
  int quantized, packed, cluster;
  Layout lay;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// the barrier's one arrival, announcing the bytes its copies will bring
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
// `bytes` (a multiple of 16) from global to shared memory by the copy
// engine, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// this thread's generic-proxy writes to shared memory, ordered before the
// copy engine's later writes there
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// cluster barrier halves: every thread of every block of the cluster
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* a, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* a,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
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

// two f32 values as bf16 hi (rounded) and lo (the rounded remainder), each
// pair packed low element first
__device__ __forceinline__ void split_hi_lo(float x0, float x1, uint32_t& hi,
                                            uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(x0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(x1);
  const __nv_bfloat16 l0 = __float2bfloat16_rn(x0 - __bfloat162float(h0));
  const __nv_bfloat16 l1 = __float2bfloat16_rn(x1 - __bfloat162float(h1));
  hi = (uint32_t)__bfloat16_as_ushort(h0) |
       ((uint32_t)__bfloat16_as_ushort(h1) << 16);
  lo = (uint32_t)__bfloat16_as_ushort(l0) |
       ((uint32_t)__bfloat16_as_ushort(l1) << 16);
}

// One step of the merge rule of softmax partials of a row, on the row's
// running (M, L) and a partial's (m, l): a partial with l = 0 has no live
// key and is the identity (returned as c0 < 0); into an empty state the
// partial is copied (c0 = 0, c1 = 1); otherwise both are rescaled to the
// larger max. The row's acc follows as A = A * c0 + a * c1 (`apply`).
// (tests/test_torch_pa_plan.py holds the same rule in plain torch.)
__device__ __forceinline__ float2 merge_step(float& M, float& L, float m,
                                             float l) {
  if (l == 0.f) return make_float2(-1.f, 0.f);
  if (L == 0.f) {
    M = m;
    L = l;
    return make_float2(0.f, 1.f);
  }
  const float mn = fmaxf(M, m);
  const float c0 = expf(M - mn), c1 = expf(m - mn);
  M = mn;
  L = L * c0 + l * c1;
  return make_float2(c0, c1);
}

__device__ __forceinline__ void apply(float4& A, float2 c, float4 a) {
  if (c.x < 0.f) return;
  A.x = A.x * c.x + a.x * c.y;
  A.y = A.y * c.x + a.y * c.y;
  A.z = A.z * c.x + a.z * c.y;
  A.w = A.w * c.x + a.w * c.y;
}

// ------------------------------------------------------------ loads

// pages a warp's 16 keys lie on: 16 / bs, or 1
__device__ __forceinline__ int pages_a_warp(const Params& p) {
  return CHUNK >> min(p.bs_shift, 4);
}

// The page id and frozen flag of each page warp `warp` reads in `split`
// (lanes < pages a warp), into `ids`. Entries past the table row read as
// page 0.
__device__ __forceinline__ void load_ids(const Params& p, int* ids, int b,
                                         int split, int warp, int lane) {
  const int j = ((split * SPLIT_KEYS + warp * CHUNK) >> p.bs_shift) + lane;
  if (lane < pages_a_warp(p)) {
    int page = 0, frozen = 0;
    if (j < p.mb) {
      page = __ldg(p.block_table + (size_t)b * p.mb + j);
      if (p.quantized)
        frozen = __ldg(p.blk_q + min(max(page, 0), p.nb - 1)) != 0;
    }
    ids[warp * CHUNK + lane] = page;
    ids[(KG + warp) * CHUNK + lane] = frozen;
  }
  __syncwarp();
}

// The tile's query rows (zero past the kv head's W*G rows), by all
// threads.
template <typename T, int DH>
__device__ __forceinline__ void issue_q(const Params& p, unsigned char* sq,
                                       int b, int kvh, int row0,
                                       int rows_here, int tid) {
  constexpr int NCH = DH * (int)sizeof(T) / 16;   // 16-byte pieces a row
  const int G = p.Hq / p.Hkv;
  const unsigned char* q = static_cast<const unsigned char*>(p.q);
  for (int i = tid; i < BM * NCH; i += kThreads) {
    const int r = i / NCH, c = i - r * NCH;
    unsigned char* dst = sq + r * tile_pitch<T>(DH) + c * 16;
    if (r < rows_here) {
      const int w = (row0 + r) / G, g = (row0 + r) - w * G;
      cp_async16(dst, q + (((size_t)(b * p.W + w) * p.Hq + kvh * G + g) *
                           DH) * sizeof(T) + c * 16);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// Warp `warp`'s keys kbase .. kbase + 15 into its slot, as bulk async
// copies completing on the warp's mbarrier `bar`: lane l copies key l % 16
// of K (l < 16) or V, a whole fp row of a hot page or code row of a frozen
// one (at the start of the tile row); the lanes below 2 x pages a warp copy
// the frozen pages' codebooks. Keys at or past n_keys are zeroed (never
// read). Codebooks of L % 4 != 0 entries go by 4-byte cp.async.
template <typename T, int DH>
__device__ __forceinline__ void issue_chunk(const Params& p,
                                            unsigned char* slot,
                                            uint64_t* bar, const int* ids,
                                            int warp, int kvh, int kbase,
                                            int n_keys, int lane) {
  constexpr int PITCH = tile_pitch<T>(DH), TILE = CHUNK * PITCH;
  constexpr int ROW = DH * (int)sizeof(T);        // bytes of an fp row
  const int* page_of = ids + warp * CHUNK;
  const int* frozen_of = ids + (KG + warp) * CHUNK;
  const int kv = lane >> 4, kk = lane & 15, key = kbase + kk;
  const int pl = kk >> p.bs_shift;                // 0 when bs >= 16
  const bool live = key < n_keys, frozen = live && frozen_of[pl];
  const int bytes = live ? (frozen ? p.Dc : ROW) : 0;
  // the warp's pages' codebooks: lane j < 2 ppw copies page j % ppw's K
  // (j < ppw) or V codebook
  const int ppw = pages_a_warp(p), cpl = lane % ppw;
  const bool cb_bulk = (p.L & 3) == 0;
  const bool cb_live = lane < 2 * ppw && frozen_of[cpl] &&
                       kbase + cpl * p.bs < n_keys;
  int total = bytes + (cb_live && cb_bulk ? p.L * 4 : 0);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    total += __shfl_xor_sync(0xffffffffu, total, o);
  if (lane == 0) mbar_expect(bar, (uint32_t)total);
  __syncwarp();
  unsigned char* dst = slot + kv * TILE + kk * PITCH;
  if (bytes) {
    const size_t row =
        (((size_t)page_of[pl] << p.bs_shift) + (key & (p.bs - 1))) * p.Hkv +
        kvh;
    const void* src =
        frozen ? static_cast<const void*>((kv ? p.v_codes : p.k_codes) +
                                          row * p.Dc)
               : static_cast<const void*>(
                     static_cast<const unsigned char*>(kv ? p.v_fp
                                                          : p.k_fp) +
                     row * ROW);
    bulk_copy(dst, src, (uint32_t)bytes, bar);
  } else {
#pragma unroll
    for (int c = 0; c < ROW / 16; ++c)
      *reinterpret_cast<uint4*>(dst + c * 16) = make_uint4(0u, 0u, 0u, 0u);
  }
  if (cb_live) {
    const int ckv = lane / ppw;
    float* cb = reinterpret_cast<float*>(slot + 2 * TILE) +
                (ckv * ppw + cpl) * p.L;
    const float* src = (ckv ? p.v_cb : p.k_cb) + (size_t)page_of[cpl] * p.L;
    if (cb_bulk) {
      bulk_copy(cb, src, (uint32_t)(p.L * 4), bar);
    } else {
      for (int e = 0; e < p.L; ++e) cp_async4(cb + e, src + e);
    }
  }
}

// eight f32 values into a tile row as T
__device__ __forceinline__ void store8(unsigned char* dst, const float* v,
                                       float) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(dst + 16) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(unsigned char* dst, const float* v,
                                       __nv_bfloat16) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * i + 1]))
            << 16);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// The frozen, live keys of the warp's slot: code groups (8 bytes) into
// registers, then cb[code] rounded to T over them. Packed: byte i of a row
// gives dims i (low nibble) and i + Dh/2 (high). A warp whose pages are
// all hot has nothing to do.
template <typename T, int DH, bool PACKED>
__device__ __forceinline__ void dequant_chunk(const Params& p,
                                              unsigned char* slot,
                                              const int* ids, int warp,
                                              int kbase, int n_keys,
                                              int lane) {
  constexpr int PITCH = tile_pitch<T>(DH), TILE = CHUNK * PITCH;
  constexpr int NG = (PACKED ? DH / 2 : DH) / 8;  // 8-byte groups a row
  constexpr int ITEMS = 2 * CHUNK * NG, PER = (ITEMS + 31) / 32;
  const int* frozen_of = ids + (KG + warp) * CHUNK;
  const int ppw = pages_a_warp(p);
  bool any = false;
  for (int pl = 0; pl < ppw; ++pl) any |= frozen_of[pl] != 0;
  if (!any) return;
  const int L = p.L;
  const float* cb = reinterpret_cast<const float*>(slot + 2 * TILE);
  uint2 code[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int it = lane + 32 * i;
    const int kv = it / (CHUNK * NG), kk = (it / NG) % CHUNK;
    const int j = it % NG;
    if (it < ITEMS && frozen_of[kk >> p.bs_shift] && kbase + kk < n_keys)
      code[i] = *reinterpret_cast<const uint2*>(slot + kv * TILE +
                                                kk * PITCH + j * 8);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int it = lane + 32 * i;
    const int kv = it / (CHUNK * NG), kk = (it / NG) % CHUNK;
    const int j = it % NG, pl = kk >> p.bs_shift;
    if (it < ITEMS && frozen_of[pl] && kbase + kk < n_keys) {
      const float* t = cb + (kv * ppw + pl) * L;
      unsigned char* row = slot + kv * TILE + kk * PITCH;
      float lo[8], hi[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const uint32_t byte =
            ((e < 4 ? code[i].x : code[i].y) >> (8 * (e & 3))) & 0xFFu;
        lo[e] = t[PACKED ? (byte & 0xFu) : byte];
        hi[e] = t[byte >> 4];
      }
      store8(row + j * 8 * (int)sizeof(T), lo, T());
      if (PACKED) store8(row + (DH / 2 + j * 8) * (int)sizeof(T), hi, T());
    }
  }
}

// ------------------------------------------------------------ products
//
// A warp's scores for the tile's 16 rows and its 16 keys, in the mma
// accumulator layout: lane (g, q) = (lane / 4, lane % 4) holds s[nt][0..1]
// = rows g, keys nt*8 + 2q + {0, 1}, and s[nt][2..3] = row g + 8, the same
// keys. The output rows acc[nt] hold dims nt*8 + 2q + {0, 1} the same way.

template <int DH>
__device__ __forceinline__ void scores(const unsigned char* sq,
                                       const unsigned char* sk,
                                       float (&s)[2][4], int lane,
                                       __nv_bfloat16) {
  constexpr int PITCH = tile_pitch<__nv_bfloat16>(DH);
  const int ar = lane & 15, ac = (lane >> 4) * 8;            // Q rows
  const int bk = (lane >> 4) * 8 + (lane & 7), bc = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t a[4], b[4];
    ldmatrix_x4(a, sq + ar * PITCH + (kk * 16 + ac) * 2);
    ldmatrix_x4(b, sk + bk * PITCH + (kk * 16 + bc) * 2);
    mma_bf16(s[0], a, b[0], b[1]);
    mma_bf16(s[1], a, b[2], b[3]);
  }
}

template <int DH>
__device__ __forceinline__ void scores(const unsigned char* sq,
                                       const unsigned char* sk,
                                       float (&s)[2][4], int lane, float) {
  constexpr int PITCH = tile_pitch<float>(DH);
  const int g = lane >> 2, q4 = lane & 3;
  const float* q0 = reinterpret_cast<const float*>(sq + g * PITCH);
  const float* q1 = reinterpret_cast<const float*>(sq + (g + 8) * PITCH);
  const float* k[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)       // keys (j / 2) * 8 + 2q + j % 2
    k[j] = reinterpret_cast<const float*>(
        sk + ((j >> 1) * 8 + 2 * q4 + (j & 1)) * PITCH);
#pragma unroll 4
  for (int d = 0; d < DH; d += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(q0 + d);
    const float4 a1 = *reinterpret_cast<const float4*>(q1 + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 kv = *reinterpret_cast<const float4*>(k[j] + d);
      float& x0 = s[j >> 1][j & 1];
      float& x1 = s[j >> 1][2 + (j & 1)];
      x0 = fmaf(a0.x, kv.x, x0); x0 = fmaf(a0.y, kv.y, x0);
      x0 = fmaf(a0.z, kv.z, x0); x0 = fmaf(a0.w, kv.w, x0);
      x1 = fmaf(a1.x, kv.x, x1); x1 = fmaf(a1.y, kv.y, x1);
      x1 = fmaf(a1.z, kv.z, x1); x1 = fmaf(a1.w, kv.w, x1);
    }
  }
}

// acc += P @ V over the warp's 16 keys (P in the score registers)
template <int DH>
__device__ __forceinline__ void pv(const unsigned char* sv,
                                   const float (&s)[2][4],
                                   float (&acc)[DH / 8][4], int lane,
                                   __nv_bfloat16) {
  constexpr int PITCH = tile_pitch<__nv_bfloat16>(DH);
  uint32_t ah[4], al[4];
  split_hi_lo(s[0][0], s[0][1], ah[0], al[0]);
  split_hi_lo(s[0][2], s[0][3], ah[1], al[1]);
  split_hi_lo(s[1][0], s[1][1], ah[2], al[2]);
  split_hi_lo(s[1][2], s[1][3], ah[3], al[3]);
  const int vk = (lane & 7) + ((lane >> 3) & 1) * 8, vc = (lane >> 4) * 8;
  const unsigned char* base = sv + vk * PITCH + vc * 2;
#pragma unroll
  for (int np = 0; np < DH / 16; ++np) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, base + np * 32);
    mma_bf16(acc[2 * np], ah, b[0], b[1]);
    mma_bf16(acc[2 * np], al, b[0], b[1]);
    mma_bf16(acc[2 * np + 1], ah, b[2], b[3]);
    mma_bf16(acc[2 * np + 1], al, b[2], b[3]);
  }
}

template <int DH>
__device__ __forceinline__ void pv(const unsigned char* sv,
                                   const float (&s)[2][4],
                                   float (&acc)[DH / 8][4], int lane,
                                   float) {
  constexpr int PITCH = tile_pitch<float>(DH);
  const int q4 = lane & 3;
#pragma unroll
  for (int k = 0; k < CHUNK; ++k) {   // keys in order, one fmaf chain each
    const int src = (lane & ~3) | ((k & 7) >> 1);
    const float p0 = __shfl_sync(0xffffffffu, s[k >> 3][k & 1], src);
    const float p1 = __shfl_sync(0xffffffffu, s[k >> 3][2 + (k & 1)], src);
    const float* v = reinterpret_cast<const float*>(sv + k * PITCH);
#pragma unroll
    for (int nt = 0; nt < DH / 8; ++nt) {
      const float2 vv = *reinterpret_cast<const float2*>(v + nt * 8 + 2 * q4);
      acc[nt][0] = fmaf(p0, vv.x, acc[nt][0]);
      acc[nt][1] = fmaf(p0, vv.y, acc[nt][1]);
      acc[nt][2] = fmaf(p1, vv.x, acc[nt][2]);
      acc[nt][3] = fmaf(p1, vv.y, acc[nt][3]);
    }
  }
}

// One warp's partial over its 16 keys, staged in its slot: rows of acc,
// then (m, l) per row. lim[rr] = live keys of row g + 8 rr from kbase.
template <typename T, int DH>
__device__ __forceinline__ void chunk_partial(const Params& p,
                                              const unsigned char* sq,
                                              unsigned char* slot,
                                              const int (&lim)[2],
                                              int rows_here, int lane) {
  constexpr int SP = DH + 8;                      // floats a staged row
  float s[2][4] = {};
  scores<DH>(sq, slot, s, lane, T());
  const int g = lane >> 2, q4 = lane & 3;
  float m[2], l[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float mx = BIG_NEG;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = (j >> 1) * 8 + 2 * q4 + (j & 1);
      float& x = s[j >> 1][2 * rr + (j & 1)];
      x *= p.scale;
      if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
      if (key < lim[rr]) mx = fmaxf(mx, x);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = (j >> 1) * 8 + 2 * q4 + (j & 1);
      float& x = s[j >> 1][2 * rr + (j & 1)];
      x = key < lim[rr] ? expf(x - mx) : 0.f;
      sum += x;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    m[rr] = mx;
    l[rr] = sum;
  }
  float acc[DH / 8][4] = {};
  pv<DH>(slot + CHUNK * tile_pitch<T>(DH), s, acc, lane, T());
  __syncwarp();                  // the warp's tiles are read: stage over them
  float* st = reinterpret_cast<float*>(slot);
  float* ml = st + BM * SP;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = g + 8 * rr;
    if (r < rows_here) {
#pragma unroll
      for (int nt = 0; nt < DH / 8; ++nt)
        *reinterpret_cast<float2*>(st + r * SP + nt * 8 + 2 * q4) =
            make_float2(acc[nt][2 * rr], acc[nt][2 * rr + 1]);
      if (q4 == 0) *reinterpret_cast<float2*>(ml + 2 * r) =
          make_float2(m[rr], l[rr]);
    }
  }
}

// four output values of a tile row (element offset `off` in out, dims d
// .. d + 3): acc / max(l, 1e-20) in T
__device__ __forceinline__ void store4(float* o, float4 v) {
  *reinterpret_cast<float4*>(o) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* o, float4 v) {
  const uint32_t lo =
      (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v.x)) |
      ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v.y)) << 16);
  const uint32_t hi =
      (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v.z)) |
      ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v.w)) << 16);
  *reinterpret_cast<uint2*>(o) = make_uint2(lo, hi);
}

template <typename T>
__device__ __forceinline__ void store_out(const Params& p, long long off,
                                          float4 A, float L) {
  const float inv = fmaxf(L, 1e-20f);
  store4(static_cast<T*>(p.out) + off,
         make_float4(A.x / inv, A.y / inv, A.z / inv, A.w / inv));
}

// Block (rank r of its cluster) computes splits r, r + cluster, ... of
// tile blockIdx.x / cluster of kv head blockIdx.y of sequence blockIdx.z.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 4)
paged_attention_kernel(const __grid_constant__ Params p) {
  constexpr int N4 = DH / 4, SP = DH + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout& ly = p.lay;
  const int CL = p.cluster;
  const int rank = blockIdx.x % CL, tile = blockIdx.x / CL;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = p.Hq / p.Hkv;
  const int row0 = tile * BM, rows_here = min(BM, p.W * G - row0);
  unsigned char* sq = smem + ly.q;
  unsigned char* slot = smem + ly.ring + warp * ly.slot;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + ly.bars) + warp;
  int* ids = reinterpret_cast<int*>(smem + ly.ids);
  long long* row_off = reinterpret_cast<long long*>(smem + ly.rows);
  float4* red = reinterpret_cast<float4*>(smem + ly.red);
  float2* red_ml = reinterpret_cast<float2*>(smem + ly.red_ml);
  float2* coef = reinterpret_cast<float2*>(smem + ly.coef);
  float2* row_ml = reinterpret_cast<float2*>(smem + ly.row_ml);
  float4* run = reinterpret_cast<float4*>(smem + ly.run);
  float2* run_ml = reinterpret_cast<float2*>(smem + ly.run_ml);
  auto staged = [&](int w) {
    return reinterpret_cast<const float*>(smem + ly.ring + w * ly.slot);
  };

  // this rank's first page ids go out before the valid length is known;
  // then the tile's longest row sees keys < n_keys
  const int valid = __ldg(p.kv_valid_len + b);
  load_ids(p, ids, b, rank, warp, lane);
  const int last_w = (row0 + rows_here - 1) / G;
  const int n_keys = max(0, min(valid - (p.W - 1 - last_w), p.mb * p.bs));
  // splits with live keys (at least one: a fully masked tile writes 0)
  const int ns = max(1, (n_keys + SPLIT_KEYS - 1) / SPLIT_KEYS);
  const bool exchange = ns > 1;
  // a rank with no split exits at once: the cluster barriers wait for the
  // blocks that have not exited, and no rank writes into its memory (the
  // rows are owned by the working ranks)
  if (rank >= ns) return;
  if (exchange) cluster_arrive_relaxed();   // this block has started
  const int R = (ns + CL - 1) / CL;         // rounds
  const int owners = min(CL, ns);
  const int rpr = (rows_here + owners - 1) / owners;
  // live keys of rows g and g + 8, counted from key 0
  int row_lim[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = (lane >> 2) + 8 * rr;
    row_lim[rr] = r < rows_here
                      ? min(valid - (p.W - 1 - (row0 + r) / G), n_keys)
                      : 0;
  }
  if (tid < rows_here) {                    // read after several barriers
    const int w = (row0 + tid) / G, g = row0 + tid - w * G;
    row_off[tid] = ((long long)(b * p.W + w) * p.Hq + kvh * G + g) * DH;
  }
  issue_q<T, DH>(p, sq, b, kvh, row0, rows_here, tid);
  if (lane == 0) {
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  issue_chunk<T, DH>(p, slot, bar, ids, warp, kvh,
                     rank * SPLIT_KEYS + warp * CHUNK, n_keys, lane);

  for (int t = 0; t < R; ++t) {
    const int split = t * CL + rank;
    const bool has = split < ns;            // uniform over the block
    if (has) {
      const int kbase = split * SPLIT_KEYS + warp * CHUNK;
      cp_async_wait_all();
      mbar_wait(bar, t & 1);
      __syncthreads();                      // Q and the slots have landed
      if (p.packed)
        dequant_chunk<T, DH, true>(p, slot, ids, warp, kbase, n_keys, lane);
      else
        dequant_chunk<T, DH, false>(p, slot, ids, warp, kbase, n_keys, lane);
      __syncwarp();
      const int lim[2] = {row_lim[0] - kbase, row_lim[1] - kbase};
      chunk_partial<T, DH>(p, sq, slot, lim, rows_here, lane);
      __syncthreads();                      // every warp's partial staged
      if (tid < rows_here) {                // the 4 warps' fold, a row each
        float M = BIG_NEG, L = 0.f;
#pragma unroll
        for (int w = 0; w < KG; ++w) {
          const float2 ml =
              reinterpret_cast<const float2*>(staged(w) + BM * SP)[tid];
          coef[tid * KG + w] = merge_step(M, L, ml.x, ml.y);
        }
        row_ml[tid] = make_float2(M, L);
      }
      __syncthreads();
    }
    if (exchange) cluster_wait();           // the owners' red is free
    if (has) {
      // the split's partial: its 4 warps folded in key order
      for (int e = tid; e < rows_here * N4; e += kThreads) {
        const int r = e / N4, d = (e - r * N4) * 4;
        float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int w = 0; w < KG; ++w)
          apply(A, coef[r * KG + w],
                *reinterpret_cast<const float4*>(staged(w) + r * SP + d));
        if (!exchange) {
          store_out<T>(p, row_off[r] + d, A, row_ml[r].y);
        } else {                            // to the row's owner, slice rank
          cg::cluster_group cluster = cg::this_cluster();
          const int owner = r / rpr, slice = rank * rpr + r - owner * rpr;
          *cluster.map_shared_rank(red + slice * N4 + d / 4, owner) = A;
          if (d == 0)
            *cluster.map_shared_rank(red_ml + slice, owner) = row_ml[r];
        }
      }
    }
    if (!exchange) return;
    __syncthreads();                        // the staged partials are read
    const int next = split + CL;
    if (next < ns) {                        // the next round's loads fly
      load_ids(p, ids, b, next, warp, lane);  // during the merge
      fence_proxy_async();                  // the slot's last generic writes
      issue_chunk<T, DH>(p, slot, bar, ids, warp, kvh,
                         next * SPLIT_KEYS + warp * CHUNK, n_keys, lane);
    }
    cluster_arrive();
    cluster_wait();                         // every partial delivered
    // the owner folds round t's splits, in split order, into its rows
    if (tid < rpr && rank * rpr + tid < rows_here) {
      float2 ml = t > 0 ? run_ml[tid] : make_float2(BIG_NEG, 0.f);
      for (int s = 0; s < CL && t * CL + s < ns; ++s) {
        const float2 pm = red_ml[s * rpr + tid];
        coef[tid * CL + s] = merge_step(ml.x, ml.y, pm.x, pm.y);
      }
      run_ml[tid] = ml;
    }
    __syncthreads();
    for (int e = tid; e < rpr * N4; e += kThreads) {
      const int lr = e / N4, d = (e - lr * N4) * 4, r = rank * rpr + lr;
      if (r >= rows_here) continue;
      float4 A = t > 0 ? run[e] : make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s = 0; s < CL && t * CL + s < ns; ++s)
        apply(A, coef[lr * CL + s], red[(s * rpr + lr) * N4 + d / 4]);
      if (t + 1 == R)
        store_out<T>(p, row_off[r] + d, A, run_ml[lr].y);
      else
        run[e] = A;
    }
    if (t + 1 < R) cluster_arrive();        // this rank's red is read
  }
}

template <typename T, int DH>
int launch(Params& p, int tiles, cudaStream_t s) {
  p.lay = make_layout<T>(DH, p.bs, p.L, p.cluster);
  if (p.lay.total > SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kern = paged_attention_kernel<T, DH>;
  // the opt-in to more than 48 KB, once per device at the most a block may
  // use: not on a call's path
  static bool opted_in[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    opted_in[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * p.cluster, p.Hkv, p.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)p.lay.total;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(Params& p, int tiles, cudaStream_t s) {
  switch (p.Dh) {
    case 32: return launch<T, 32>(p, tiles, s);
    case 64: return launch<T, 64>(p, tiles, s);
    case 96: return launch<T, 96>(p, tiles, s);
    case 128: return launch<T, 128>(p, tiles, s);
  }
  return (int)cudaErrorInvalidValue;
}

bool takes(int Dh, int bs, int L, int split_pages, int tile_rows,
           int cluster) {
  return Dh > 0 && Dh <= DH_MAX && Dh % 32 == 0 && bs > 0 && bs <= BS_MAX &&
         (bs & (bs - 1)) == 0 && L > 0 && L <= L_MAX &&
         split_pages * bs == SPLIT_KEYS && tile_rows == BM && cluster >= 1 &&
         cluster <= MAX_CLUSTER;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. split_pages, tile_rows and cluster are
// the launch plan (repro_torch/kernels/paged_attention.py:plan): the
// kernel takes split_pages * bs == 64, tile_rows == 16, cluster 1-8.
// Returns cudaGetLastError() after the launch (0 = launched);
// cudaErrorInvalidValue for shapes or a plan the kernel does not take.
extern "C" int paged_attention_launch(
    const void* q, const void* k_fp, const void* v_fp, const void* k_codes,
    const void* v_codes, const void* k_cb, const void* v_cb,
    const void* blk_q, const void* block_table, const void* kv_valid_len,
    void* out, int B, int W, int Hq, int Hkv, int Dh, int nb, int bs, int mb,
    int Dc, int L, float scale, float softcap, int quantized, int packed,
    int split_pages, int tile_rows, int cluster, int dtype, void* stream) {
  if (!takes(Dh, bs, L, split_pages, tile_rows, cluster) || B <= 0 ||
      W <= 0 || Hkv <= 0 || Hq % Hkv != 0 || nb <= 0 || mb <= 0 ||
      B > 65535 || Hkv > 65535 ||
      (quantized && Dc != (packed ? Dh / 2 : Dh)))
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
  p.mb = mb; p.Dc = quantized ? Dc : Dh; p.L = quantized ? L : 1;
  p.bs_shift = __builtin_ctz((unsigned)bs);
  p.scale = scale;
  p.softcap = softcap;
  p.quantized = quantized;
  p.packed = packed;
  p.cluster = cluster;
  const int tiles = (W * (Hq / Hkv) + BM - 1) / BM;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dh<float>(p, tiles, s);
  if (dtype == 1) return launch_dh<__nv_bfloat16>(p, tiles, s);
  return (int)cudaErrorInvalidValue;
}

// Shared-memory bytes of a block under the plan (what a launch uses), or
// -1 for shapes or a plan the kernel does not take.
extern "C" int paged_attention_smem(int Dh, int bs, int L, int split_pages,
                                    int tile_rows, int cluster, int dtype) {
  if (!takes(Dh, bs, L, split_pages, tile_rows, cluster)) return -1;
  if (dtype == 0) return make_layout<float>(Dh, bs, L, cluster).total;
  if (dtype == 1) return make_layout<__nv_bfloat16>(Dh, bs, L, cluster).total;
  return -1;
}
