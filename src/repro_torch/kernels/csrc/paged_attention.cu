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
// holds code[i] in its low nibble and code[i + Dh/2] in its high nibble,
// split at the true Dh) or one code a byte, plus the page's two L-entry
// f32 codebooks and dequantized on chip as
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
//     split s covering keys [64s, 64s + 64), fixed by key index alone,
//     whatever the block size (1-128): each key maps to (page, slot) =
//     (key / bs, key % bs), so a page may straddle two warps or two
//     splits. The query rows are cut into tiles of BM = 16 (one m16 tile).
//     The `cluster` (1-8) blocks of a (tile, kv head, sequence) form one
//     thread-block cluster; rank r computes splits r, r + cluster, ... .
//     A decode step of 4 x 272 tokens thus runs 160 working blocks, where
//     one block per (tile, kv head, sequence) gave 32.
//   - A block has 4 warps; warp w computes keys [16w, 16w + 16) of its
//     split for the tile's 16 rows: its own page ids (block table, then
//     the frozen flag of each page its keys lie on), its own loads (one
//     bulk async copy per key row, the fp row of a hot page or the code
//     row of a frozen one, and the pages' codebooks, all completing on
//     the warp's mbarrier: 16-byte cp.async requests spent most of a
//     warp's chain being issued; a row whose bytes are not a multiple of
//     16, as at Dh 24 packed, is copied by the warp's lanes instead), its
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
//
// Head dims: the kernel is compiled for padded widths DH (multiples of 16
// up to 128, of 32 up to 256), each serving every true Dh in (DH - 16 or
// 32, DH]. Dh is a runtime argument: loads and stores cover Dh columns,
// the columns [Dh, DH) of the Q and K/V tiles are zeroed in shared memory
// (they add exactly 0 to every logit and to no output column), and the
// scale is 1/sqrt(Dh). Rows and code rows whose bytes are not whole
// 16-byte pieces, and codebooks that do not fit in shared memory beside
// the tiles (256 entries over many small pages at a wide head_dim), take
// general paths; at Dh 32, 64, 96 and 128 an exact kernel without them
// serves the pools that need none (they cost qwen3-0.6B's decode step ~8%
// when compiled in: PERF.md).

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
constexpr int DH_MAX = 256;              // head_dim limit
constexpr int BS_MAX = 128;              // block (page) size limit
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
//   ids    the page id and frozen flag of each warp's pages, then each
//          warp key's page (from the chunk's first) if it is a live key
//          of a frozen page, else -1;
//   rows   each tile row's element offset in q and out;
//   red    the split partials pushed to this rank: slice r = rank r's, rpr
//          rows of Dh floats; red_ml their (m, l) per row;
//   coef   a fold's per-row steps (c0, c1), row_ml its rows' (M, L);
//   run    the running fold of the owned rows between rounds (several
//          rounds: ceil(BM / cluster) rows), and run_ml (M, L) per owned
//          row (up to BM rows when fewer ranks own them).
// Tile rows are padded by 16 bytes, so the 8 rows of an ldmatrix hit 32
// banks; staged rows by 8 floats. The kernel is compiled per padded
// head_dim DH: its tile arithmetic divides by constants only.
struct Layout {
  int slot;         // bytes a warp's slot
  int q, bars, ring, ids, rows, red, red_ml, coef, row_ml, run, run_ml,
      total;
  int rpr;          // rows an owner folds across rounds: ceil(BM / cluster)
  int ppw;          // most pages a warp's 16 keys lie on
  int cb_smem;      // the codebooks are staged in the slots
};

// the padded width a head_dim is served at
__host__ __device__ constexpr int pad_dh(int Dh) {
  return Dh <= 128 ? (Dh + 15) & ~15 : (Dh + 31) & ~31;
}

// The most pages 16 consecutive keys starting at a multiple of 16 lie on,
// for pages of bs keys (the starts repeat with period bs).
inline int pages_a_chunk(int bs) {
  int most = 1;
  for (int m = 0; m < bs; ++m) {
    const int o = (CHUNK * m) % bs;
    const int n = (o + CHUNK - 1) / bs + 1;
    most = n > most ? n : most;
  }
  return most;
}

template <typename T>
__host__ __device__ constexpr int tile_pitch(int Dh) {  // bytes a tile row
  return Dh * (int)sizeof(T) + 16;
}

template <typename T>
Layout make_layout(int Dh, int bs, int L, int cluster, bool cb_smem) {
  Layout s;
  s.ppw = pages_a_chunk(bs);
  s.cb_smem = cb_smem;
  // K and V tiles, then the codebooks; or the staged partial
  const int ring_need = 2 * CHUNK * tile_pitch<T>(Dh) +
                        (s.cb_smem ? align16(2 * s.ppw * L * 4) : 0);
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
  s.rows = s.ids + KG * CHUNK * 3 * 4;
  s.red = s.rows + BM * 8;
  s.red_ml = s.red + slices * Dh * 4;
  s.coef = align16(s.red_ml + slices * 2 * 4);
  s.row_ml = s.coef + steps * 2 * 4;
  s.run = align16(s.row_ml + BM * 2 * 4);
  s.run_ml = s.run + s.rpr * Dh * 4;       // (M, L) of any owner's rows
  s.total = align16(s.run_ml + BM * 2 * 4);
  return s;
}

// the layout at padded width DH; without the staged codebooks if they do
// not fit beside the tiles
template <typename T>
Layout make_layout(int DH, int bs, int L, int cluster) {
  const Layout s = make_layout<T>(DH, bs, L, cluster, true);
  return s.total <= SMEM_MAX ? s : make_layout<T>(DH, bs, L, cluster, false);
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

// The first page warp-chunk keys kbase .. kbase + 15 lie on, and how many.
__device__ __forceinline__ int first_page(const Params& p, int kbase) {
  return kbase / p.bs;
}
__device__ __forceinline__ int chunk_pages(const Params& p, int kbase) {
  return (kbase + CHUNK - 1) / p.bs - kbase / p.bs + 1;
}

// The page id and frozen flag of each page warp `warp` reads in `split`
// (lanes < the chunk's pages), into `ids`. Entries past the table row
// read as page 0.
__device__ __forceinline__ void load_ids(const Params& p, int* ids, int b,
                                         int split, int warp, int lane) {
  const int kbase = split * SPLIT_KEYS + warp * CHUNK;
  const int j = first_page(p, kbase) + lane;
  if (lane < chunk_pages(p, kbase)) {
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

// `bytes` bytes from global `src` to shared `dst` by plain loads, in the
// widest unit the size allows (a row of a tensor whose rows hold `bytes`
// bytes starts at a multiple of that unit); units i0, i0 + step, ...
__device__ __forceinline__ void copy_units(unsigned char* dst,
                                           const unsigned char* src,
                                           int bytes, int i0, int step) {
  const int unit = min(16, bytes & -bytes);
  const int n = bytes / unit;
  switch (unit) {
    case 16:
      for (int i = i0; i < n; i += step)
        reinterpret_cast<uint4*>(dst)[i] =
            __ldg(reinterpret_cast<const uint4*>(src) + i);
      break;
    case 8:
      for (int i = i0; i < n; i += step)
        reinterpret_cast<uint2*>(dst)[i] =
            __ldg(reinterpret_cast<const uint2*>(src) + i);
      break;
    case 4:
      for (int i = i0; i < n; i += step)
        reinterpret_cast<unsigned int*>(dst)[i] =
            __ldg(reinterpret_cast<const unsigned int*>(src) + i);
      break;
    case 2:
      for (int i = i0; i < n; i += step)
        reinterpret_cast<unsigned short*>(dst)[i] =
            __ldg(reinterpret_cast<const unsigned short*>(src) + i);
      break;
    default:
      for (int i = i0; i < n; i += step) dst[i] = __ldg(src + i);
  }
}

__device__ __forceinline__ void zero1(unsigned char* row, int e, float) {
  reinterpret_cast<float*>(row)[e] = 0.f;
}
__device__ __forceinline__ void zero1(unsigned char* row, int e,
                                      __nv_bfloat16) {
  reinterpret_cast<unsigned short*>(row)[e] = 0;
}

// The tile's query rows (zero past the kv head's W*G rows, and in the
// columns [Dh, DH)), by all threads: 16-byte async copies when a row's
// bytes allow them, else plain loads (GEN: the kernel serves any Dh; else
// Dh == DH and every row is whole 16-byte pieces).
template <typename T, int DH, bool GEN>
__device__ __forceinline__ void issue_q(const Params& p, unsigned char* sq,
                                       int b, int kvh, int row0,
                                       int rows_here, int tid) {
  constexpr int PITCH = tile_pitch<T>(DH);
  constexpr int PER = DH * (int)sizeof(T) / 16;   // 16-byte pieces a row
  const int G = p.Hq / p.Hkv, RB = p.Dh * (int)sizeof(T);
  const unsigned char* q = static_cast<const unsigned char*>(p.q);
  auto src_row = [&](int r) {
    const int w = (row0 + r) / G, g = (row0 + r) - w * G;
    return q + ((size_t)(b * p.W + w) * p.Hq + kvh * G + g) * RB;
  };
  if (!GEN || RB % 16 == 0) {
    const int nch = GEN ? RB / 16 : PER;
    for (int i = tid; i < rows_here * nch; i += kThreads) {
      const int r = i / nch, c = i - r * nch;
      cp_async16(sq + r * PITCH + c * 16, src_row(r) + c * 16);
    }
  } else {
    for (int r = tid >> 5; r < rows_here; r += KG)
      copy_units(sq + r * PITCH, src_row(r), RB, tid & 31, 32);
  }
  for (int i = tid; i < (BM - rows_here) * PER; i += kThreads) {
    const int r = rows_here + i / PER, c = i % PER;
    *reinterpret_cast<uint4*>(sq + r * PITCH + c * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  if (!GEN) return;
  const int padw = DH - p.Dh;
  for (int i = tid; i < rows_here * padw; i += kThreads)
    zero1(sq + (i / padw) * PITCH, p.Dh + i % padw, T());
}

// Warp `warp`'s keys kbase .. kbase + 15 into its slot: lane l takes key
// l % 16 of K (l < 16) or V, a whole fp row of a hot page or code row of
// a frozen one (at the start of the tile row). Rows whose bytes are a
// multiple of 16 go as bulk async copies completing on the warp's
// mbarrier `bar`; the others are copied by the warp's lanes, one row at a
// time (only GEN kernels have such rows). With staged codebooks, the lanes
// below 2 x the chunk's pages copy the frozen pages' codebooks (by 4-byte
// cp.async when L % 4 != 0). Keys at or past n_keys are zeroed (never
// read).
template <typename T, int DH, bool GEN>
__device__ __forceinline__ void issue_chunk(const Params& p,
                                            unsigned char* slot,
                                            uint64_t* bar, int* ids,
                                            int warp, int kvh, int kbase,
                                            int n_keys, int lane) {
  constexpr int PITCH = tile_pitch<T>(DH), TILE = CHUNK * PITCH;
  const int ROW = p.Dh * (int)sizeof(T);          // bytes of an fp row
  const int* page_of = ids + warp * CHUNK;
  const int* frozen_of = ids + (KG + warp) * CHUNK;
  const int j0 = first_page(p, kbase), np = chunk_pages(p, kbase);
  const int kv = lane >> 4, kk = lane & 15, key = kbase + kk;
  const int jk = key / p.bs, pl = jk - j0;
  const bool live = key < n_keys, frozen = live && frozen_of[pl];
  const int bytes = live ? (frozen ? p.Dc : ROW) : 0;
  const bool bulk = bytes > 0 && (!GEN || bytes % 16 == 0);
  if (lane < CHUNK) ids[(2 * KG + warp) * CHUNK + kk] = frozen ? pl : -1;
  // the chunk's pages' codebooks: lane c < 2 np copies page c % np's K
  // (c < np) or V codebook, if a key of that page in the chunk is live
  const int cpl = lane % np;
  const bool cb_bulk = (p.L & 3) == 0;
  const bool cb_live = p.lay.cb_smem && lane < 2 * np && frozen_of[cpl] &&
                       max(kbase, (j0 + cpl) * p.bs) < n_keys;
  int total = (bulk ? bytes : 0) + (cb_live && cb_bulk ? p.L * 4 : 0);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    total += __shfl_xor_sync(0xffffffffu, total, o);
  if (lane == 0) mbar_expect(bar, (uint32_t)total);
  __syncwarp();
  unsigned char* dst = slot + kv * TILE + kk * PITCH;
  const unsigned char* src = nullptr;
  if (bytes) {
    const size_t row = ((size_t)page_of[pl] * p.bs + (key - jk * p.bs)) *
                           p.Hkv + kvh;
    src = frozen ? (kv ? p.v_codes : p.k_codes) + row * p.Dc
                 : static_cast<const unsigned char*>(kv ? p.v_fp : p.k_fp) +
                       row * ROW;
    if (bulk) bulk_copy(dst, src, (uint32_t)bytes, bar);
  } else {
#pragma unroll
    for (int c = 0; c < DH * (int)sizeof(T) / 16; ++c)
      *reinterpret_cast<uint4*>(dst + c * 16) = make_uint4(0u, 0u, 0u, 0u);
  }
  if (cb_live) {
    const int ckv = lane / np;
    float* cb = reinterpret_cast<float*>(slot + 2 * TILE) +
                (ckv * p.lay.ppw + cpl) * p.L;
    const float* csrc = (ckv ? p.v_cb : p.k_cb) + (size_t)page_of[cpl] * p.L;
    if (cb_bulk) {
      bulk_copy(cb, csrc, (uint32_t)(p.L * 4), bar);
    } else {
      for (int e = 0; e < p.L; ++e) cp_async4(cb + e, csrc + e);
    }
  }
  if (!GEN) return;
  // the rows no bulk copy can take, by the warp's lanes
  unsigned slow = __ballot_sync(0xffffffffu, bytes > 0 && !bulk);
  const unsigned long long sp = reinterpret_cast<unsigned long long>(src);
  while (slow) {
    const int r = __ffs(slow) - 1;
    slow &= slow - 1;
    const unsigned char* s = reinterpret_cast<const unsigned char*>(
        __shfl_sync(0xffffffffu, sp, r));
    const int n = __shfl_sync(0xffffffffu, bytes, r);
    copy_units(slot + (r >> 4) * TILE + (r & 15) * PITCH, s, n, lane, 32);
  }
}

// the columns [Dh, DH) of the warp's 32 tile rows, zeroed
template <typename T, int DH>
__device__ __forceinline__ void zero_pad(const Params& p,
                                         unsigned char* slot, int lane) {
  constexpr int PITCH = tile_pitch<T>(DH);
  const int padw = DH - p.Dh;
  for (int i = lane; i < 2 * CHUNK * padw; i += 32)
    zero1(slot + (i / padw) * PITCH, p.Dh + i % padw, T());
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
// one f32 value into element e of a tile row as T
__device__ __forceinline__ void store1(unsigned char* row, int e, float v,
                                       float) {
  reinterpret_cast<float*>(row)[e] = v;
}
__device__ __forceinline__ void store1(unsigned char* row, int e, float v,
                                       __nv_bfloat16) {
  reinterpret_cast<__nv_bfloat16*>(row)[e] = __float2bfloat16_rn(v);
}

// The frozen, live keys of the warp's slot: code groups (8 bytes) into
// registers, then cb[code] rounded to T over them. Packed: byte i of a row
// gives dims i (low nibble) and i + Dh/2 (high), Dh the true head_dim.
// The codebooks are read from the slot when staged there (CB_SMEM), else
// through L1. A key's page comes from the chunk's key table in `ids`.
template <typename T, int DH, bool PACKED, bool CB_SMEM, bool GEN>
__device__ __forceinline__ void dequant_keys(const Params& p,
                                             unsigned char* slot,
                                             const int* ids, int warp,
                                             int lane) {
  constexpr int PITCH = tile_pitch<T>(DH), TILE = CHUNK * PITCH;
  constexpr int NGM = ((PACKED ? DH / 2 : DH) + 7) / 8;  // groups a row
  constexpr int ITEMS = 2 * CHUNK * NGM, PER = (ITEMS + 31) / 32;
  const int* page_of = ids + warp * CHUNK;
  const int* key_page = ids + (2 * KG + warp) * CHUNK;
  const int L = p.L, Dc = p.Dc, NG = (Dc + 7) / 8;
  const bool whole = !GEN || Dc % 8 == 0;   // every group full, aligned
  const float* cbs = reinterpret_cast<const float*>(slot + 2 * TILE);
  uint2 code[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int it = lane + 32 * i;
    const int kv = it / (CHUNK * NGM), kk = (it / NGM) % CHUNK;
    const int j = it % NGM;
    if (it < ITEMS && j < NG && key_page[kk] >= 0)
      code[i] = *reinterpret_cast<const uint2*>(slot + kv * TILE +
                                                kk * PITCH + j * 8);
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int it = lane + 32 * i;
    const int kv = it / (CHUNK * NGM), kk = (it / NGM) % CHUNK;
    const int j = it % NGM, pl = key_page[kk];
    if (!(it < ITEMS && j < NG && pl >= 0)) continue;
    const float* t = CB_SMEM
        ? cbs + (kv * p.lay.ppw + pl) * L
        : (kv ? p.v_cb : p.k_cb) + (size_t)page_of[pl] * L;
    unsigned char* row = slot + kv * TILE + kk * PITCH;
    float lo[8], hi[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      lo[e] = hi[e] = 0.f;
      if (!whole && j * 8 + e >= Dc) continue;
      const uint32_t byte =
          ((e < 4 ? code[i].x : code[i].y) >> (8 * (e & 3))) & 0xFFu;
      const uint32_t c0 = PACKED ? (byte & 0xFu) : byte;
      lo[e] = CB_SMEM ? t[c0] : __ldg(t + c0);
      if (PACKED) hi[e] = CB_SMEM ? t[byte >> 4] : __ldg(t + (byte >> 4));
    }
    if (whole) {
      store8(row + j * 8 * (int)sizeof(T), lo, T());
      if (PACKED) store8(row + (Dc + j * 8) * (int)sizeof(T), hi, T());
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (j * 8 + e >= Dc) break;
        store1(row, j * 8 + e, lo[e], T());
        if (PACKED) store1(row, Dc + j * 8 + e, hi[e], T());
      }
    }
  }
}

// The warp's frozen keys dequantized in place; a warp whose pages are all
// hot has nothing to do.
template <typename T, int DH, bool PACKED, bool GEN>
__device__ __forceinline__ void dequant_chunk(const Params& p,
                                              unsigned char* slot,
                                              const int* ids, int warp,
                                              int kbase, int lane) {
  const int* frozen_of = ids + (KG + warp) * CHUNK;
  const int np = chunk_pages(p, kbase);
  bool any = false;
  for (int pl = 0; pl < np; ++pl) any |= frozen_of[pl] != 0;
  if (!any) return;
  if (!GEN || p.lay.cb_smem)
    dequant_keys<T, DH, PACKED, true, GEN>(p, slot, ids, warp, lane);
  else
    dequant_keys<T, DH, PACKED, false, GEN>(p, slot, ids, warp, lane);
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

// four output values of a tile row (element offset `off` in out of dim
// 0, dims d .. d + 3): acc / max(l, 1e-20) in T, the dims below the true
// Dh only (one vector store when Dh % 4 == 0)
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

__device__ __forceinline__ void store1(float* o, float v) { *o = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* o, float v) {
  *o = __float2bfloat16_rn(v);
}

template <typename T, bool GEN>
__device__ __forceinline__ void store_out(const Params& p, long long off,
                                          int d, float4 A, float L) {
  if (GEN && d >= p.Dh) return;
  const float inv = fmaxf(L, 1e-20f);
  const float4 v = make_float4(A.x / inv, A.y / inv, A.z / inv, A.w / inv);
  T* o = static_cast<T*>(p.out) + off + d;
  if (!GEN || (p.Dh & 3) == 0) {
    store4(o, v);
  } else {
    const float e[4] = {v.x, v.y, v.z, v.w};
    for (int i = 0; i < 4 && d + i < p.Dh; ++i) store1(o + i, e[i]);
  }
}

// Block (rank r of its cluster) computes splits r, r + cluster, ... of
// tile blockIdx.x / cluster of kv head blockIdx.y of sequence blockIdx.z.
// Widths above 128 hold twice the accumulators; they take up to 255
// registers (two blocks an SM). GEN kernels serve any head_dim up to DH
// and any row and code widths; the others (the widths 32, 64, 96, 128)
// only Dh == DH with whole 16-byte rows and codes and staged codebooks,
// without the general paths' code and registers (launch_dh picks).
template <typename T, int DH, bool GEN>
__global__ void __launch_bounds__(kThreads, DH > 128 ? 2 : 4)
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
    row_off[tid] = ((long long)(b * p.W + w) * p.Hq + kvh * G + g) * p.Dh;
  }
  issue_q<T, DH, GEN>(p, sq, b, kvh, row0, rows_here, tid);
  if (lane == 0) {
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  issue_chunk<T, DH, GEN>(p, slot, bar, ids, warp, kvh,
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
        dequant_chunk<T, DH, true, GEN>(p, slot, ids, warp, kbase, lane);
      else
        dequant_chunk<T, DH, false, GEN>(p, slot, ids, warp, kbase, lane);
      if (GEN && DH != p.Dh) zero_pad<T, DH>(p, slot, lane);
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
          store_out<T, GEN>(p, row_off[r], d, A, row_ml[r].y);
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
      issue_chunk<T, DH, GEN>(p, slot, bar, ids, warp, kvh,
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
        store_out<T, GEN>(p, row_off[r], d, A, run_ml[lr].y);
      else
        run[e] = A;
    }
    if (t + 1 < R) cluster_arrive();        // this rank's red is read
  }
}

template <typename T, int DH, bool GEN>
int launch(Params& p, int tiles, cudaStream_t s) {
  auto kern = paged_attention_kernel<T, DH, GEN>;
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
  p.lay = make_layout<T>(pad_dh(p.Dh), p.bs, p.L, p.cluster);
  if (p.lay.total > SMEM_MAX) return (int)cudaErrorInvalidValue;
  // the exact kernels take the shapes that need nothing general: whole
  // 16-byte rows and codes, staged codebooks
  const bool exact = p.Dh % 32 == 0 && p.Dh <= 128 &&
                     (!p.quantized || (p.Dc % 16 == 0 && p.lay.cb_smem));
  if (exact) {
    switch (p.Dh) {
      case 32: return launch<T, 32, false>(p, tiles, s);
      case 64: return launch<T, 64, false>(p, tiles, s);
      case 96: return launch<T, 96, false>(p, tiles, s);
      case 128: return launch<T, 128, false>(p, tiles, s);
    }
  }
  switch (pad_dh(p.Dh)) {
    case 16: return launch<T, 16, true>(p, tiles, s);
    case 32: return launch<T, 32, true>(p, tiles, s);
    case 48: return launch<T, 48, true>(p, tiles, s);
    case 64: return launch<T, 64, true>(p, tiles, s);
    case 80: return launch<T, 80, true>(p, tiles, s);
    case 96: return launch<T, 96, true>(p, tiles, s);
    case 112: return launch<T, 112, true>(p, tiles, s);
    case 128: return launch<T, 128, true>(p, tiles, s);
    case 160: return launch<T, 160, true>(p, tiles, s);
    case 192: return launch<T, 192, true>(p, tiles, s);
    case 224: return launch<T, 224, true>(p, tiles, s);
    case 256: return launch<T, 256, true>(p, tiles, s);
  }
  return (int)cudaErrorInvalidValue;
}

bool takes(int Dh, int bs, int L, int split_keys, int tile_rows,
           int cluster) {
  return Dh > 0 && Dh <= DH_MAX && bs > 0 && bs <= BS_MAX && L > 0 &&
         L <= L_MAX && split_keys == SPLIT_KEYS && tile_rows == BM &&
         cluster >= 1 && cluster <= MAX_CLUSTER;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. split_keys, tile_rows and cluster are
// the launch plan (repro_torch/kernels/paged_attention.py:plan): the
// kernel takes split_keys == 64, tile_rows == 16, cluster 1-8; head_dim
// 1-256 (even when packed), blocks of 1-128 keys, codebooks of 1-256.
// Returns cudaGetLastError() after the launch (0 = launched);
// cudaErrorInvalidValue for shapes or a plan the kernel does not take.
extern "C" int paged_attention_launch(
    const void* q, const void* k_fp, const void* v_fp, const void* k_codes,
    const void* v_codes, const void* k_cb, const void* v_cb,
    const void* blk_q, const void* block_table, const void* kv_valid_len,
    void* out, int B, int W, int Hq, int Hkv, int Dh, int nb, int bs, int mb,
    int Dc, int L, float scale, float softcap, int quantized, int packed,
    int split_keys, int tile_rows, int cluster, int dtype, void* stream) {
  if (!takes(Dh, bs, L, split_keys, tile_rows, cluster) || B <= 0 ||
      W <= 0 || Hkv <= 0 || Hq % Hkv != 0 || nb <= 0 || mb <= 0 ||
      B > 65535 || Hkv > 65535 ||
      (quantized && packed && Dh % 2 != 0) ||
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
extern "C" int paged_attention_smem(int Dh, int bs, int L, int split_keys,
                                    int tile_rows, int cluster, int dtype) {
  if (!takes(Dh, bs, L, split_keys, tile_rows, cluster)) return -1;
  const int DH = pad_dh(Dh);
  if (dtype == 0) return make_layout<float>(DH, bs, L, cluster).total;
  if (dtype == 1) return make_layout<__nv_bfloat16>(DH, bs, L, cluster).total;
  return -1;
}
