// GQA flash decode for Hopper (sm_90a): one query position per sequence
// against its KV cache, dense rows or pages through a block table, at world
// = 1 and, with the cache's positions split over W ranks on the one card, at
// world W.
//
// Replaces, in triton_dist_tpu/ops/flash_decode.py:
//  * _tiled_decode_kernel (:280), reached from gqa_fwd_batch_decode (:500,
//    dense rows) and gqa_fwd_batch_decode_paged (:600, pages read through
//    pool[block_table[b, i]]): at world = 1 `flash_decode_kernel`, a
//    split-KV partial kernel whose last block of each (row, KV head) merges
//    that row's splits in the same launch (`merge_splits`, the log-sum-exp
//    merge of _exchange_and_merge (:218) / _merge (:194), which at world = 1
//    merges the splits of one row instead of the ranks of a mesh); the
//    partial alone and `flash_decode_combine`, the same merge as a launch of
//    its own, stay as entries for checks;
//  * _decode_kernel (:262), the variant FlashDecodeContext.resolve_variant
//    (:105) picks for shards of at most 4 MiB: at world = 1 the same kernel
//    with one split, which writes the output itself;
//  * both at world W, with _exchange_and_merge (:218) between ranks:
//    `tdt_flash_decode_world`, one cooperative launch over every rank's
//    work (below).
//
// Layouts (all contiguous): q and out (B, Hq, D); the dense cache
// (B, T, Hkv, D); the paged pool (P, page, Hkv, D) with a (B, n_pages) int32
// table, T = n_pages * page. kv_len is a (B,) int32 vector. Query head
// hq = h * G + g belongs to KV head h, G = Hq / Hkv (Qwen3-8B: G = 4,
// D = 128).
//
// Numerics are the JAX package's (_local_partials :149, the tiled loop
// :348-386): scores = (q . k) * D^-0.5 summed in f32 (a product of two bf16
// values is exact in f32, so this equals the cache-dtype dot with f32
// accumulation); positions >= kv_len[b] are dead; an online softmax carries
// (m, l, acc) in f32 over tiles of positions, p = exp(s - m) is rounded to
// bf16 before the PV product when q and the cache are both bf16 (l sums
// the unrounded p), and out = acc / max(l, 1e-20) in q's dtype, so a row
// with kv_len 0 gives 0. Each warp runs its own online softmax over its
// rows of every tile; the block merges its four warps' states, then the
// splits are merged, both by the log-sum-exp rule in a fixed order.
//
// What bounds it: bytes. Each live K and V element is read once and used for
// 2 * G = 8 operations, far below the ~295 FLOP/byte where the card's compute
// would matter, so the least time is the live K/V bytes over 3.35 TB/s. At
// short lengths it is latency: one launch, the first tile's round trip to
// HBM and the merge.
//
// What the design does about it. A block of four warps takes one KV head of
// one row and its G query heads, so K and V are read once for all G heads.
//  * A pipeline of tiles: a block tile is 64 positions, warp w owning rows
//    [16 w, 16 w + 16) of each. Each warp streams its own rows of K and V
//    into a ring of stages in dynamic shared memory with 16-byte
//    cp.async.cg copies, 2-4 stages deep (`mma_stages`, `fma_geom`), so the
//    next tiles are in flight while the current one is computed, and waits
//    on its own copies only (__syncwarp, no block barrier in the loop). The
//    cache row of each position comes through the block table one position
//    at a time (`cache_row`, clamped into the pool), so pages smaller than
//    a tile and dense rows take one code path.
//  * bf16 q and cache: tensor cores through mma.sync m16n8k16 (`mma_attend`).
//    Scores: the warp's 16 positions are the A operand (K rows by ldmatrix),
//    the G <= 8 query heads the n = 8 operand (Q^T in registers), so no row
//    is wasted at G = 4. PV: O^T (D x 8) += V^T (ldmatrix.trans) times P^T,
//    the probabilities rounded to bf16 and moved from the score
//    accumulators' layout into the B operand's by movmatrix.trans. wgmma
//    would waste most of its 64-row minimum at G <= 8.
//  * f32 and mixed pairs (products in f32, as JAX computes them): the same
//    ring and pipeline, with 8 positions a warp stage, on CUDA cores
//    (`fma_attend`).
//  * The split-KV grid (splits, Hkv, B) fills the card in one wave of one
//    block an SM (tdt_flash_decode_plan, from the shape only); a split past
//    a row's kv_len reads nothing and writes an empty partial (m = -1e30,
//    l = 0).
//  * The world-1 tiled call is one launch: each block writes its partial to
//    the workspace, then takes an arrival ticket (the one atomic; its
//    `tickets` word of the row); the block that arrives last merges the
//    row's splits in the order 0, 1, ..., S-1 and resets the ticket for the
//    next call. Only the order of arrival uses an atomic: every sum has a
//    fixed order, so repeated runs are bit-identical, and the output equals
//    the standalone combine of the same partials bit for bit.
//
// World W (tdt_flash_decode_world). Rank r holds positions [r t_loc,
// (r + 1) t_loc) of every row: the dense cache's columns there, or its own
// pool rows [r P, (r + 1) P) read through its table (W, B, n_pages), page
// ids local to the rank. One cooperative launch (every block resident: the
// grid is at most the occupancy with the body's real shared memory) deals
// its work items to persistent blocks in phase order, so every wait's
// producer comes earlier in every block's order:
//  A. (rank, row, KV head, split): the partial of the rank's positions in
//     the split, by the same body as the world-1 kernels; a split past a
//     row's kv_len gives m = -1e30, l = 0 (whole ranks are empty at small
//     offsets). With one split (the single-pass variant) it is the rank's
//     partial and goes straight to step B's publish; else it lands in the
//     workspace and a barrier over the launch ends the phase.
//  B. (rank, row, KV head): `merge_splits` of its splits into one
//     (acc, l, m), written into slot `me` of the rank's own combine buffer
//     (its self signal released), then pushed into slot `me` of every
//     peer's combine buffer in combine_peer order (me + 1, me + 2, ...),
//     each push ending with the epoch-stamped release of its signal
//     (tdt_putmem_signal_block).
//  C. (rank, row, KV head): wait for the self signal and then the W - 1
//     peers' in combine_src order (me - 1, me - 2, ...); merge the W slots
//     of the rank's OWN combine buffer, which only the pushes fill, in rank
//     order 0..W-1 into the rank's output out[r]. Every rank merges the
//     same W partials in the same order: the W outputs are bit-equal.
// Combine buffers and signals live in the op's context (NaN-filled and
// zeroed once, never reset: a signal holds the call's epoch).

// Plain C entry points, loaded with ctypes. Each launch runs on the stream
// it is given, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "gemm_common.cuh"
#include "shmem.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;               // positions of a block tile; splits
                                         // are whole tiles
constexpr int kMaxG = 8;                 // query heads per KV head
constexpr int kMaxD = 256;               // head dim
constexpr int kMmaRows = kChunk / kWarps;  // a warp's rows of a bf16 tile
constexpr int kFmaRows = 8;              // a warp's rows of an f32 stage
constexpr int kFmaBudget = 104 * 1024;   // ring bytes the f32 body aims at
constexpr int kMergeBatch = 8;           // splits of a merge's loads in flight
constexpr int kMergeMaxSG = 4096;        // splits x G a merge stages
constexpr float kNeg = -1e30f;
static_assert(kMmaRows == 16, "a warp's bf16 rows are one m16 tile");

// -- geometry ---------------------------------------------------------------
// The bf16 body's ring, for head dims up to kD (64, 128 or 256; columns D..kD
// are zero-filled): rows of kD + 8 bf16 (conflict-free ldmatrix), a warp
// stage K rows then V rows; three stages (four at kD = 64), so two are in
// flight a warp while the third is computed (104,448 bytes a block at
// kD = 128).
__host__ __device__ constexpr int mma_stages(int kD) {
  return kD == 64 ? 4 : 3;
}
__host__ __device__ constexpr int mma_ld(int kD) { return kD + 8; }
__host__ __device__ constexpr int mma_smem(int kD) {
  return kWarps * mma_stages(kD) * 2 * kMmaRows * mma_ld(kD) *
         static_cast<int>(sizeof(__nv_bfloat16));
}

// The f32 body's ring for head dim D of `szc`-byte cache elements: rows of
// ldb bytes (ldb = 64 mod 128: a quarter warp's 16-byte reads of two rows
// hit 32 different banks), 2-4 stages of kWarps x kFmaRows positions, then
// q in f32 (kMaxG x D) and each warp's probabilities (kFmaRows x kMaxG).
struct FmaGeom {
  int ldb, stages, ring, bytes;
};
__host__ __device__ inline FmaGeom fma_geom(int D, int szc) {
  FmaGeom f;
  f.ldb = (D * szc + 127) / 128 * 128 + 64;
  const int stage = kWarps * 2 * kFmaRows * f.ldb;
  const int fit = kFmaBudget / stage;
  f.stages = fit < 2 ? 2 : fit > 4 ? 4 : fit;
  f.ring = f.stages * stage;
  f.bytes = f.ring + (kMaxG * D + kWarps * kFmaRows * kMaxG) * 4;
  return f;
}

// The block's merge scratch lies at the start of the ring once it is
// drained: each warp's m and l (kMaxG each), then its acc (kMaxG x D);
// 32.9 KB at D = 256, within every ring.

// Floats `merge_splits` stages for S splits of G heads: m*, the sums of l,
// every split's m (then scale factor) and l. At most kMergeMaxSG splits x
// heads: 32.9 KB, within every body's ring (49,152 bytes at the least) and
// within a launch's 48 KB of shared memory without the attribute.
__host__ __device__ constexpr int merge_floats(int S, int G) {
  return 2 * kMaxG + 2 * S * G;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// The transpose of an 8 x 8 matrix of 16-bit values held one 32-bit
// fragment a lane (row lane / 4, columns 2 (lane % 4), +1).
__device__ __forceinline__ unsigned movmatrix_trans(unsigned x) {
  unsigned y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

struct Params {
  const void* q;        // (B, Hq, D)
  const void* k;        // (B, T, Hkv, D) dense, or the (P, page, Hkv, D) pool
  const void* v;
  const int* kv_len;    // (B,)
  const int* table;     // (B, n_pages) for the pool (world W: (W, B,
                        // n_pages)), null for dense rows
  void* out;            // (B, Hq, D), q's dtype (world W: (W, B, Hq, D))
  float* ws_a;          // (B, Hkv, splits, G, D) (world W: (W, B, ...))
  float* ws_l;          // (B, Hkv, splits, G)
  float* ws_m;          // (B, Hkv, splits, G)
  int* tickets;         // (B, Hkv) arrival tickets of the fused merge, 0
                        // between calls; null: the partial alone
  int drop_split;       // the split the fused merge leaves out (a planted
                        // fault), -1: none
  int B, Hkv, G, D;
  int T;                // positions of one row (world W: of all ranks)
  int page;             // positions per page (paged)
  int n_pages;          // table columns (paged; world W: per rank)
  int pool_pages;       // pages in the pool (paged; world W: per rank)
  int split_len;        // positions per split, a multiple of kChunk
  int splits;
  float scale;          // D^-0.5 rounded to f32, as JAX rounds it
  int ldb, stages;      // the f32 body's ring (fma_geom)
  // World W only.
  int world, t_loc;     // ranks; positions per rank
  const long long* comb_tab;  // (W,) combine buffers: W slots of (B, Hkv)
                              // entries of G * (D + 2) f32 (acc, l, m)
  const long long* sig_tab;   // (W,) signals: W sources x (B, Hkv) u64
  unsigned long long* flags;  // >= gridDim.x barrier words
  unsigned long long epoch;
  int fault;            // skip rank 0's first push of entry (0, 0)
};

// The positions one call of `attend` covers: [first, end) of row b, whose
// cache rows are dense (b * T + t) or pages of `table` (the rank's
// (B, n_pages) table) offset by `slot0` pool pages.
struct View {
  int first, end;
  const int* table;
  long long slot0;
};

// The row of the cache (dense) or pool (paged) that holds position t of
// sequence b. A table entry outside the pool is clamped into it, so a
// corrupt or stale table can never make the kernel read past the pool.
__device__ __forceinline__ long long cache_row(const Params& p, const View& w,
                                               int b, int t) {
  if (w.table == nullptr) return static_cast<long long>(b) * p.T + t;
  const int lt = t - w.first;
  int slot = w.table[static_cast<long long>(b) * p.n_pages + lt / p.page];
  slot = min(max(slot, 0), p.pool_pages - 1);
  return (w.slot0 + slot) * p.page + lt % p.page;
}

// One warp's copies of rows [pos0, pos0 + kRows) of K and V (KV head h of
// row b) into ks / vs: rows of ldb bytes, `chunks` 16-byte pieces each, the
// first `live` of them from the cache and the rest zero; rows at or past
// `end` all zero. Lane r finds row r's place in the cache (the table read
// once a position) and hands it to the lanes that copy the row.
template <typename TC, int kRows>
__device__ __forceinline__ void issue_rows(const Params& p, const View& w,
                                           int b, int h, int pos0, int end,
                                           unsigned char* ks,
                                           unsigned char* vs, int ldb,
                                           int chunks, int live) {
  constexpr int E = 16 / static_cast<int>(sizeof(TC));
  const int lane = threadIdx.x & 31;
  long long off = -1;                      // the row's first element; -1 dead
  if (lane < kRows && pos0 + lane < end)
    off = cache_row(p, w, b, pos0 + lane) * (static_cast<long long>(p.Hkv) *
                                             p.D) +
          static_cast<long long>(h) * p.D;
  const TC* kc = static_cast<const TC*>(p.k);
  const TC* vc = static_cast<const TC*>(p.v);
  const int total = kRows * chunks;
  for (int c0 = 0; c0 < total; c0 += 32) {
    const int c = c0 + lane;
    const int r = c < total ? c / chunks : 0;
    const long long row = __shfl_sync(0xffffffffu, off, r);
    if (c < total) {
      const int cc = c - r * chunks;
      const bool ok = row >= 0 && cc < live;
      const long long at = ok ? row + static_cast<long long>(cc) * E : 0;
      cp_async16(ks + r * ldb + cc * 16, kc + at, ok);
      cp_async16(vs + r * ldb + cc * 16, vc + at, ok);
    }
  }
}

// cp.async.wait_group for a stage count known only at run time (2-4).
__device__ __forceinline__ void wait_stages(int stages) {
  if (stages == 2)
    cp_async_wait<1>();
  else if (stages == 3)
    cp_async_wait<2>();
  else
    cp_async_wait<3>();
}

// The bf16 body: each warp folds its rows of positions [t0, t1) into its own
// online-softmax state, then writes (m, l, acc) of its G heads into the
// block's merge scratch.
template <int kD>
__device__ __forceinline__ void mma_attend(const Params& p, const View& w,
                                           int h, int b, int t0, int t1,
                                           unsigned char* smem,
                                           float* scratch) {
  using T = __nv_bfloat16;
  constexpr int LD = mma_ld(kD);
  constexpr int S = mma_stages(kD);
  constexpr int KS = kD / 16;             // k-steps of a score, d-tiles of PV
  constexpr int STAGE = 2 * kMmaRows * LD;  // elements of a warp stage
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int G = p.G, D = p.D;
  T* ring = reinterpret_cast<T*>(smem) + warp * S * STAGE;

  // Q^T, the n = 8 operand: query head g, dims 2t, 2t + 1 (and + 8) of each
  // k-step; heads past G and dims past D are zero.
  const T* q = static_cast<const T*>(p.q) +
               (static_cast<long long>(b) * p.Hkv + h) * G * D +
               static_cast<long long>(g) * D;
  unsigned qb[KS][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int d = ks * 16 + 2 * t;
    qb[ks][0] = g < G && d < D ? *reinterpret_cast<const unsigned*>(q + d)
                               : 0u;
    qb[ks][1] = g < G && d + 8 < D
                    ? *reinterpret_cast<const unsigned*>(q + d + 8)
                    : 0u;
  }
  // O^T fragments: o[i] holds dims 16 i + g (e < 2) and + 8, heads 2t and
  // 2t + 1 (e & 1). m and l of heads 2t, 2t + 1; l is this lane's share
  // (its positions g and g + 8), summed over the warp at the end.
  float o[KS][4];
#pragma unroll
  for (int i = 0; i < KS; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;

  const int n_st = t1 > t0 ? (t1 - t0 + kChunk - 1) / kChunk : 0;
  auto issue = [&](int j) {
    T* ks = ring + (j % S) * STAGE;
    issue_rows<T, kMmaRows>(p, w, b, h, t0 + j * kChunk + warp * kMmaRows,
                            t1, reinterpret_cast<unsigned char*>(ks),
                            reinterpret_cast<unsigned char*>(
                                ks + kMmaRows * LD),
                            LD * 2, kD / 8, D / 8);
  };
#pragma unroll
  for (int j = 0; j < S - 1; ++j) {
    if (j < n_st) issue(j);
    cp_async_commit();
  }
  for (int j = 0; j < n_st; ++j) {
    if (j + S - 1 < n_st) issue(j + S - 1);
    cp_async_commit();
    cp_async_wait<S - 1>();                // stage j of this warp landed
    __syncwarp();
    const int pos0 = t0 + j * kChunk + warp * kMmaRows;
    if (pos0 < t1) {
      const T* ks_ = ring + (j % S) * STAGE;
      const T* vs_ = ks_ + kMmaRows * LD;
      // S^T (16 positions x 8 heads) = K Q^T, two accumulators in turn.
      float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        unsigned a[4];
        ldmatrix_x4(a, ks_ + (lane & 15) * LD + ks * 16 + (lane >> 4) * 8);
        if (ks & 1)
          mma_bf16(c1, a, qb[ks][0], qb[ks][1]);
        else
          mma_bf16(c0, a, qb[ks][0], qb[ks][1]);
      }
      // s[e]: position g (e < 2) or g + 8, head 2t + (e & 1).
      const bool live0 = pos0 + g < t1, live1 = pos0 + g + 8 < t1;
      float s[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[e] = (e < 2 ? live0 : live1) ? (c0[e] + c1[e]) * p.scale : kNeg;
      float mx0 = fmaxf(s[0], s[2]), mx1 = fmaxf(s[1], s[3]);
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
      float pr[4];
      pr[0] = live0 ? expf(s[0] - mn0) : 0.f;
      pr[1] = live0 ? expf(s[1] - mn1) : 0.f;
      pr[2] = live1 ? expf(s[2] - mn0) : 0.f;
      pr[3] = live1 ? expf(s[3] - mn1) : 0.f;
      l0 = l0 * al0 + (pr[0] + pr[2]);
      l1 = l1 * al1 + (pr[1] + pr[3]);
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int i = 0; i < KS; ++i) {
        o[i][0] *= al0;
        o[i][1] *= al1;
        o[i][2] *= al0;
        o[i][3] *= al1;
      }
      // P^T, the B operand of PV: the bf16-rounded probabilities of
      // positions 0-7 and 8-15 transposed into (position, head) fragments.
      const unsigned b0 = movmatrix_trans(pack_bf16(pr[0], pr[1]));
      const unsigned b1 = movmatrix_trans(pack_bf16(pr[2], pr[3]));
      // O^T += V^T P^T: V rows through ldmatrix.trans are the A operand.
#pragma unroll
      for (int dp = 0; dp < KS; ++dp) {
        unsigned a[4];
        ldmatrix_x4_trans(a, vs_ + (((lane >> 4) << 3) + (lane & 7)) * LD +
                                 dp * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(o[dp], a, b0, b1);
      }
    }
    __syncwarp();                          // the next issue reuses stage j
  }
  cp_async_wait<0>();
  __syncthreads();                         // every warp is off the ring

#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  float* sm = scratch + warp * kMaxG;
  float* sl = scratch + kWarps * kMaxG + warp * kMaxG;
  float* sa = scratch + 2 * kWarps * kMaxG +
              static_cast<long long>(warp) * kMaxG * D;
  if (g == 0) {
    if (2 * t < G) {
      sm[2 * t] = m0;
      sl[2 * t] = l0;
    }
    if (2 * t + 1 < G) {
      sm[2 * t + 1] = m1;
      sl[2 * t + 1] = l1;
    }
  }
#pragma unroll
  for (int i = 0; i < KS; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = i * 16 + g + (e >> 1) * 8, hd = 2 * t + (e & 1);
      if (hd < G && d < D) sa[hd * D + d] = o[i][e];
    }
}

// The f32 body (f32 or mixed q and cache; products in f32, p unrounded):
// the same pipeline with kFmaRows positions a warp stage and four lanes a
// position, on CUDA cores.
template <typename TQ, typename TC>
__device__ __forceinline__ void fma_attend(const Params& p, const View& w,
                                           int h, int b, int t0, int t1,
                                           unsigned char* smem,
                                           float* scratch) {
  static_assert(!(std::is_same<TQ, __nv_bfloat16>::value &&
                  std::is_same<TC, __nv_bfloat16>::value),
                "bf16 q and cache take the tensor-core body");
  constexpr int E = 16 / static_cast<int>(sizeof(TC));
  constexpr int NC = kMaxD / 32;           // a lane's output columns
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = lane >> 2, sub = lane & 3;
  const int G = p.G, D = p.D, S = p.stages, ldb = p.ldb;
  const int chunks = D * static_cast<int>(sizeof(TC)) / 16;
  const int stage = 2 * kFmaRows * ldb;    // bytes of a warp stage
  unsigned char* ring = smem + warp * S * stage;
  float* q_s = reinterpret_cast<float*>(smem + kWarps * S * stage);
  float* p_s = q_s + kMaxG * D + warp * kFmaRows * kMaxG;

  const TQ* q = static_cast<const TQ*>(p.q) +
                (static_cast<long long>(b) * p.Hkv + h) * G * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads) q_s[i] = to_f32(q[i]);
  __syncthreads();

  float acc[kMaxG][NC], m[kMaxG], l[kMaxG], alpha[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[g][j] = 0.f;
  }

  constexpr int BLOCK_ROWS = kWarps * kFmaRows;
  const int n_st = t1 > t0 ? (t1 - t0 + BLOCK_ROWS - 1) / BLOCK_ROWS : 0;
  auto issue = [&](int j) {
    unsigned char* ks = ring + (j % S) * stage;
    issue_rows<TC, kFmaRows>(p, w, b, h, t0 + j * BLOCK_ROWS +
                                             warp * kFmaRows,
                             t1, ks, ks + kFmaRows * ldb, ldb, chunks,
                             chunks);
  };
  for (int j = 0; j < S - 1; ++j) {
    if (j < n_st) issue(j);
    cp_async_commit();
  }
  for (int j = 0; j < n_st; ++j) {
    if (j + S - 1 < n_st) issue(j + S - 1);
    cp_async_commit();
    wait_stages(S);                        // stage j of this warp landed
    __syncwarp();
    const int pos0 = t0 + j * BLOCK_ROWS + warp * kFmaRows;
    if (pos0 < t1) {
      const unsigned char* ks_ = ring + (j % S) * stage;
      const unsigned char* vs_ = ks_ + kFmaRows * ldb;
      // Scores: lane (r, sub) sums the chunks sub, sub + 4, ... of row r.
      float dot[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) dot[g] = 0.f;
      for (int c = sub; c < chunks; c += 4) {
        const uint4 raw = *reinterpret_cast<const uint4*>(ks_ + r * ldb +
                                                          c * 16);
        const TC* kv = reinterpret_cast<const TC*>(&raw);
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
          if (g < G) {
            const float* qg = q_s + g * D + c * E;
#pragma unroll
            for (int e = 0; e < E; ++e)
              dot[g] = fmaf(qg[e], to_f32(kv[e]), dot[g]);
          }
        }
      }
      const bool live = pos0 + r < t1;
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          float d = dot[g];
          d += __shfl_xor_sync(0xffffffffu, d, 1);
          d += __shfl_xor_sync(0xffffffffu, d, 2);
          const float s = live ? d * p.scale : kNeg;
          float mx = s;
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float mn = fmaxf(m[g], mx);
          const float pg = live ? expf(s - mn) : 0.f;
          alpha[g] = expf(m[g] - mn);
          l[g] = l[g] * alpha[g] + pg;     // this position's share
          m[g] = mn;
          if (sub == 0) p_s[r * kMaxG + g] = pg;
        }
      }
      __syncwarp();
      // PV: lane owns columns lane + 32 j of every head. The row loop
      // stays rolled (unrolled, the three type pairs' bodies tripled the
      // build time); a row's probabilities are two float4 loads.
#pragma unroll
      for (int j2 = 0; j2 < NC; ++j2)
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g][j2] *= alpha[g];
#pragma unroll 1
      for (int rr = 0; rr < kFmaRows; ++rr) {
        const float4 p0 = *reinterpret_cast<const float4*>(p_s + rr * kMaxG);
        const float4 p1 =
            *reinterpret_cast<const float4*>(p_s + rr * kMaxG + 4);
        const float pg[kMaxG] = {p0.x, p0.y, p0.z, p0.w,
                                 p1.x, p1.y, p1.z, p1.w};
        const TC* vrow = reinterpret_cast<const TC*>(vs_ + rr * ldb);
#pragma unroll
        for (int j2 = 0; j2 < NC; ++j2) {
          const int d = lane + 32 * j2;
          if (d < D) {
            const float vv = to_f32(vrow[d]);
#pragma unroll
            for (int g = 0; g < kMaxG; ++g)
              if (g < G) acc[g][j2] = fmaf(pg[g], vv, acc[g][j2]);
          }
        }
      }
    }
    __syncwarp();                          // the next issue reuses stage j
  }
  cp_async_wait<0>();
  __syncthreads();                         // every warp is off the ring

  float* sm = scratch + warp * kMaxG;
  float* sl = scratch + kWarps * kMaxG + warp * kMaxG;
  float* sa = scratch + 2 * kWarps * kMaxG +
              static_cast<long long>(warp) * kMaxG * D;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
      float s = l[g];
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) {
        sm[g] = m[g];
        sl[g] = s;
      }
#pragma unroll
      for (int j2 = 0; j2 < NC; ++j2) {
        const int d = lane + 32 * j2;
        if (d < D) sa[g * D + d] = acc[g][j2];
      }
    }
  }
}

// The calling block folds positions [t0, t1) of row b (t1 already clamped
// to kv_len[b]) into the online-softmax state of the G query heads of KV
// head h, through the bf16 body (kD > 0) or the f32 one (kD == 0), then
// merges its four warps' states in warp order. kFinal writes out =
// acc / max(l, 1e-20) at `out` (the G heads' rows, q's dtype); otherwise
// the unnormalized partial goes to a_dst (G x D), l_dst and m_dst (G each).
template <typename TQ, typename TC, int kD, bool kFinal>
__device__ __forceinline__ void attend(const Params& p, const View& w, int h,
                                       int b, int t0, int t1,
                                       unsigned char* smem, TQ* out,
                                       float* a_dst, float* l_dst,
                                       float* m_dst) {
  __syncthreads();  // a previous item of this block is done with smem
  float* scratch = reinterpret_cast<float*>(smem);
  if constexpr (kD > 0)
    mma_attend<kD>(p, w, h, b, t0, t1, smem, scratch);
  else
    fma_attend<TQ, TC>(p, w, h, b, t0, t1, smem, scratch);
  __syncthreads();  // every warp's state is in the scratch

  const int G = p.G, D = p.D;
  const float* sm = scratch;
  const float* sl = scratch + kWarps * kMaxG;
  const float* sa = scratch + 2 * kWarps * kMaxG;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i - g * D;
    float m_star = kNeg;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp)
      m_star = fmaxf(m_star, sm[wp * kMaxG + g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) {
      const float sc = expf(sm[wp * kMaxG + g] - m_star);
      num = fmaf(sa[(wp * kMaxG + g) * D + d], sc, num);
      den = fmaf(sl[wp * kMaxG + g], sc, den);
    }
    if constexpr (kFinal) {
      out[i] = from_f32<TQ>(num / fmaxf(den, 1e-20f));
    } else {
      a_dst[i] = num;
      if (d == 0) {
        l_dst[g] = den;
        m_dst[g] = m_star;
      }
    }
  }
}

// The merge of S split partials of one (row, KV head), stored from float
// `base` of ws_l / ws_m (base * D of ws_a) as the partial kernel lays them
// out: m* = max_s m_s, num = sum_s a_s e^(m_s - m*), den = sum_s l_s
// e^(m_s - m*), each sum in the order s = 0, 1, ..., S-1 (JAX's _merge).
// kNorm writes out = num / max(den, 1e-20) in q's dtype (G x D at `out`);
// otherwise the unnormalized (num, den, m*) go to an (acc, l, m) entry at
// `e`. Split `skip` is left out (a planted fault; -1: none). The partials
// come through L2 (__ldcg): other blocks of the launch wrote them. Every
// split's m and l are staged in `sh` (merge_floats(S, G) floats) in one
// round trip, the first batch of a in flight beside it; each thread streams
// its float4s of a in batches of kMergeBatch splits, all of a batch's loads
// in flight at once. Every
// route's merge is this function, so the fused launch and the standalone
// combine give the same bits.
template <typename TQ, bool kNorm>
__device__ void merge_splits(const Params& p, long long base, int S,
                             int skip, float* sh, TQ* out, float* e) {
  constexpr int kVecs = kMaxG * kMaxD / 4 / kThreads;  // float4s a thread
  const int G = p.G, D = p.D, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int vecs = G * D / 4;              // float4s of one split
  float* m_star = sh;
  float* den = sh + kMaxG;
  float* sc = sh + 2 * kMaxG;              // m_s, then e^(m_s - m*)
  float* ls = sc + S * G;
  // The first batch of the thread's first float4 of a, in flight while m
  // and l are staged: the two round trips overlap.
  const float4* a4 = reinterpret_cast<const float4*>(p.ws_a + base * D);
  float4 x0[kMergeBatch];
#pragma unroll
  for (int j = 0; j < kMergeBatch; ++j)
    x0[j] = tid < vecs ? __ldcg(a4 + static_cast<long long>(min(j, S - 1)) *
                                         vecs + tid)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();                         // sh is free
  for (int i = tid; i < S * G; i += kThreads) {
    sc[i] = __ldcg(p.ws_m + base + i);
    ls[i] = __ldcg(p.ws_l + base + i);
  }
  __syncthreads();
  for (int g = warp; g < G; g += kWarps) {  // a max: any order is exact
    float mx = kNeg;
    for (int s = lane; s < S; s += 32)
      if (s != skip) mx = fmaxf(mx, sc[s * G + g]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) m_star[g] = mx;
  }
  __syncthreads();
  for (int i = tid; i < S * G; i += kThreads) {
    const int s = i / G;
    sc[i] = s == skip ? 0.f : expf(sc[i] - m_star[i - s * G]);
  }
  __syncthreads();
  if (tid < G) {
    float dn = 0.f;
    for (int s = 0; s < S; ++s)
      if (s != skip) dn = fmaf(ls[s * G + tid], sc[s * G + tid], dn);
    den[tid] = dn;
  }
  float4 num[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int v = tid + k * kThreads;
    num[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (v < vecs) {
      const int g = v * 4 / D;
      for (int s0 = 0; s0 < S; s0 += kMergeBatch) {
        float4 x[kMergeBatch];
        if (k == 0 && s0 == 0) {
#pragma unroll
          for (int j = 0; j < kMergeBatch; ++j) x[j] = x0[j];
        } else {
#pragma unroll
          for (int j = 0; j < kMergeBatch; ++j)
            x[j] = __ldcg(a4 + static_cast<long long>(min(s0 + j, S - 1)) *
                                   vecs + v);
        }
#pragma unroll
        for (int j = 0; j < kMergeBatch; ++j) {
          const int s = s0 + j;
          if (s < S && s != skip) {
            const float f = sc[s * G + g];
            num[k].x = fmaf(x[j].x, f, num[k].x);
            num[k].y = fmaf(x[j].y, f, num[k].y);
            num[k].z = fmaf(x[j].z, f, num[k].z);
            num[k].w = fmaf(x[j].w, f, num[k].w);
          }
        }
      }
    }
  }
  __syncthreads();                         // den is in
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int v = tid + k * kThreads;
    if (v < vecs) {
      const int g = v * 4 / D;
      const float vals[4] = {num[k].x, num[k].y, num[k].z, num[k].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (kNorm)
          out[v * 4 + j] = from_f32<TQ>(vals[j] / fmaxf(den[g], 1e-20f));
        else
          e[v * 4 + j] = vals[j];
      }
    }
  }
  if constexpr (!kNorm) {
    if (tid < G) {
      e[G * D + tid] = den[tid];
      e[G * D + G + tid] = m_star[tid];
    }
  }
}

// grid = (splits, Hkv, B), dynamic shared memory for the body's ring. Block
// (s, h, b) folds positions [s * split_len, (s + 1) * split_len) of row b,
// below kv_len[b]. kFinal (the single-pass kernel, one split) writes out;
// otherwise the block writes its unnormalized partial (acc, l, m) to the
// workspace and, with `tickets`, the last block of (b, h) to arrive merges
// the row's splits into out.
template <typename TQ, typename TC, int kD, bool kFinal>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = max(0, min(p.kv_len[b], p.T));
  const int t0 = split * p.split_len;
  const int t1 = min(t0 + p.split_len, len);
  const View w = {0, p.T, p.table, 0};
  const long long bh = static_cast<long long>(b) * p.Hkv + h;
  if constexpr (kFinal) {
    attend<TQ, TC, kD, true>(p, w, h, b, t0, t1, smem,
                             static_cast<TQ*>(p.out) + bh * p.G * p.D,
                             nullptr, nullptr, nullptr);
  } else {
    const long long base = (bh * p.splits + split) * p.G;
    attend<TQ, TC, kD, false>(p, w, h, b, t0, t1, smem, nullptr,
                              p.ws_a + base * p.D, p.ws_l + base,
                              p.ws_m + base);
    if (p.tickets != nullptr) {
      __shared__ int last;
      __threadfence();                     // the partial, seen by the launch
      __syncthreads();
      if (threadIdx.x == 0)
        last = atomicAdd(p.tickets + bh, 1) == p.splits - 1;
      __syncthreads();
      if (last) {
        __threadfence();
        merge_splits<TQ, true>(p, bh * p.splits * p.G, p.splits,
                               p.drop_split, reinterpret_cast<float*>(smem),
                               static_cast<TQ*>(p.out) + bh * p.G * p.D,
                               nullptr);
        if (threadIdx.x == 0) p.tickets[bh] = 0;  // ready for the next call
      }
    }
  }
}

// grid = (1, Hkv, B). The merge of (b, h)'s splits as a launch of its own.
template <typename TQ>
__global__ void __launch_bounds__(kThreads)
flash_decode_combine(Params p) {
  extern __shared__ __align__(16) float sh[];
  const long long bh = static_cast<long long>(blockIdx.z) * p.Hkv +
                       blockIdx.y;
  merge_splits<TQ, true>(p, bh * p.splits * p.G, p.splits, -1, sh,
                         static_cast<TQ*>(p.out) + bh * p.G * p.D, nullptr);
}

// -- world W ------------------------------------------------------------------
// Floats of one combine entry: acc (G x D), then l (G), then m (G).
__device__ __forceinline__ int entry_floats(const Params& p) {
  return p.G * (p.D + 2);
}

// Rank `owner`'s combine entry of source slot `src`, row b, KV head h.
__device__ __forceinline__ float* comb_entry(const Params& p, int owner,
                                             int src, int b, int h) {
  float* base = reinterpret_cast<float*>(tdt_peer_ptr(p.comb_tab, owner));
  const long long e =
      (static_cast<long long>(src) * p.B + b) * p.Hkv + h;
  return base + e * entry_floats(p);
}

// Rank `owner`'s signal for source `src`, row b, KV head h.
__device__ __forceinline__ unsigned long long* comb_signal(const Params& p,
                                                           int owner, int src,
                                                           int b, int h) {
  unsigned long long* base = reinterpret_cast<unsigned long long*>(
      tdt_peer_ptr(p.sig_tab, owner));
  return base + (static_cast<long long>(src) * p.B + b) * p.Hkv + h;
}

// Step B's publish, after the block has written rank me's partial of (b, h)
// into its own slot: release the self signal, then push the entry into slot
// `me` of each peer in combine_peer order, each push with its signal.
__device__ __forceinline__ void publish(const Params& p, int me, int b,
                                        int h) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    tdt_signal_release(comb_signal(p, me, me, b, h), p.epoch);
  }
  const unsigned char* src =
      reinterpret_cast<const unsigned char*>(comb_entry(p, me, me, b, h));
  const long long bytes = static_cast<long long>(entry_floats(p)) * 4;
  for (int i = 1; i < p.world; ++i) {
    const int peer = (me + i) % p.world;           // combine_peer(me, i)
    unsigned char* dst =
        reinterpret_cast<unsigned char*>(comb_entry(p, peer, me, b, h));
    if (p.fault && me == 0 && i == 1 && b == 0 && h == 0) {
      // The planted fault: the push is skipped, its signal still set.
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence();
        tdt_signal_release(comb_signal(p, peer, me, b, h), p.epoch);
      }
      continue;
    }
    tdt_putmem_signal_block(dst, src, bytes, comb_signal(p, peer, me, b, h),
                            p.epoch);
  }
}

template <typename TQ, typename TC, int kD>
__global__ void __launch_bounds__(kThreads)
flash_decode_world(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = p.world, G = p.G, D = p.D;
  const int rows = W * p.B * p.Hkv;         // (rank, row, KV head) items
  const int nblk = gridDim.x;

  // A. partials over each rank's splits.
  const long long n_a = static_cast<long long>(rows) * p.splits;
  for (long long it = blockIdx.x; it < n_a; it += nblk) {
    const int split = static_cast<int>(it % p.splits);
    const int item = static_cast<int>(it / p.splits);
    const int h = item % p.Hkv;
    const int b = (item / p.Hkv) % p.B;
    const int me = item / (p.Hkv * p.B);
    const int first = me * p.t_loc;
    const int len = max(0, min(p.kv_len[b], p.T));
    const int t0 = first + split * p.split_len;
    const int t1 = min(min(t0 + p.split_len, first + p.t_loc), len);
    const View w = {first, first + p.t_loc,
                    p.table == nullptr ? nullptr
                        : p.table + static_cast<long long>(me) * p.B *
                                        p.n_pages,
                    static_cast<long long>(me) * p.pool_pages};
    if (p.splits == 1) {
      float* e = comb_entry(p, me, me, b, h);
      attend<TQ, TC, kD, false>(p, w, h, b, t0, t1, smem, nullptr, e,
                                e + G * D, e + G * D + G);
      publish(p, me, b, h);
    } else {
      const long long base = it * G;         // (me, b, h, split) * G
      attend<TQ, TC, kD, false>(p, w, h, b, t0, t1, smem, nullptr,
                                p.ws_a + base * D, p.ws_l + base,
                                p.ws_m + base);
    }
  }

  // B. each (rank, row, head)'s splits merged into its own slot, pushed.
  if (p.splits > 1) {
    tdt_barrier_all(p.flags, p.epoch);
    for (int item = blockIdx.x; item < rows; item += nblk) {
      const int h = item % p.Hkv;
      const int b = (item / p.Hkv) % p.B;
      const int me = item / (p.Hkv * p.B);
      merge_splits<TQ, false>(p, static_cast<long long>(item) * p.splits * G,
                              p.splits, -1, reinterpret_cast<float*>(smem),
                              nullptr, comb_entry(p, me, me, b, h));
      publish(p, me, b, h);
    }
  }

  // C. wait for every slot of the rank's own buffer, merge in rank order.
  for (int item = blockIdx.x; item < rows; item += nblk) {
    const int h = item % p.Hkv;
    const int b = (item / p.Hkv) % p.B;
    const int me = item / (p.Hkv * p.B);
    tdt_signal_wait_until(comb_signal(p, me, me, b, h), p.epoch);
    for (int i = 1; i < W; ++i) {
      const int src = (me - i + W) % W;            // combine_src(me, i)
      tdt_signal_wait_until(comb_signal(p, me, src, b, h), p.epoch);
    }
    TQ* out = static_cast<TQ*>(p.out) +
              ((static_cast<long long>(me) * p.B + b) * p.Hkv + h) * G * D;
    for (int i = threadIdx.x; i < G * D; i += kThreads) {
      const int g = i / D;
      float m_star = kNeg;
      for (int s = 0; s < W; ++s)
        m_star = fmaxf(m_star, __ldcg(comb_entry(p, me, s, b, h) + G * D +
                                      G + g));
      float num = 0.f, den = 0.f;
      for (int s = 0; s < W; ++s) {
        const float* e = comb_entry(p, me, s, b, h);
        const float sc = expf(__ldcg(e + G * D + G + g) - m_star);
        num += __ldcg(e + i) * sc;
        den += __ldcg(e + G * D + g) * sc;
      }
      out[i] = from_f32<TQ>(num / fmaxf(den, 1e-20f));
    }
  }
}

// -- launches -----------------------------------------------------------------
// Dynamic shared memory of a launch of the body (TC, kD) at p.D; sets the
// f32 body's ring (p.ldb, p.stages).
template <typename TC, int kD>
int smem_bytes(Params* p) {
  if constexpr (kD > 0) {
    return mma_smem(kD);
  } else {
    const FmaGeom f = fma_geom(p->D, static_cast<int>(sizeof(TC)));
    p->ldb = f.ldb;
    p->stages = f.stages;
    return f.bytes;
  }
}

// Lets `fn` take `bytes` of dynamic shared memory (above 48 KB only after
// cudaFuncSetAttribute); `allowed` is the kernel's own record of it.
template <typename K>
cudaError_t allow_smem(K* fn, int bytes, int* allowed) {
  if (bytes <= *allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      reinterpret_cast<const void*>(fn),
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

template <typename TQ, typename TC, int kD, bool kFinal>
cudaError_t launch_attend(Params p, cudaStream_t stream) {
  static int allowed = 0;
  const int bytes = smem_bytes<TC, kD>(&p);
  const cudaError_t err =
      allow_smem(flash_decode_kernel<TQ, TC, kD, kFinal>, bytes, &allowed);
  if (err != cudaSuccess) return err;
  flash_decode_kernel<TQ, TC, kD, kFinal>
      <<<dim3(p.splits, p.Hkv, p.B), kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// Blocks of the world-W kernel the card keeps resident at once with the
// body's shared memory at p.D (its occupancy on every SM); the kernel's
// shared-memory limit raised to match.
template <typename TQ, typename TC, int kD>
cudaError_t world_resident(Params* p, int* out, int* bytes) {
  static int allowed = 0, cached_bytes = -1, cached = 0;
  *bytes = smem_bytes<TC, kD>(p);
  cudaError_t err = allow_smem(flash_decode_world<TQ, TC, kD>, *bytes,
                               &allowed);
  if (err != cudaSuccess) return err;
  if (*bytes != cached_bytes) {
    int dev = 0, sms = 0, per_sm = 0, coop = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, flash_decode_world<TQ, TC, kD>, kThreads, *bytes);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    cached = sms * per_sm;
    cached_bytes = *bytes;
  }
  *out = cached;
  return cudaSuccess;
}

template <typename TQ, typename TC, int kD>
cudaError_t launch_world(Params p, cudaStream_t stream) {
  int resident = 0, bytes = 0;
  cudaError_t err = world_resident<TQ, TC, kD>(&p, &resident, &bytes);
  if (err != cudaSuccess) return err;
  const long long items = static_cast<long long>(p.world) * p.B * p.Hkv *
                          p.splits;
  const long long grid = items < resident ? items : resident;
  if (grid < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(flash_decode_world<TQ, TC, kD>),
      dim3(static_cast<unsigned>(grid)), dim3(kThreads), args, bytes, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

struct Partial {
  template <typename TQ, typename TC, int kD>
  static cudaError_t run(const Params& p, cudaStream_t s) {
    return launch_attend<TQ, TC, kD, false>(p, s);
  }
};
struct Single {
  template <typename TQ, typename TC, int kD>
  static cudaError_t run(const Params& p, cudaStream_t s) {
    return launch_attend<TQ, TC, kD, true>(p, s);
  }
};
struct World {
  template <typename TQ, typename TC, int kD>
  static cudaError_t run(const Params& p, cudaStream_t s) {
    return launch_world<TQ, TC, kD>(p, s);
  }
};
struct WorldGrid {
  template <typename TQ, typename TC, int kD>
  static cudaError_t run(Params p, int* blocks) {
    int bytes = 0;
    return world_resident<TQ, TC, kD>(&p, blocks, &bytes);
  }
};

// F::run<TQ, TC, kD>(args...) for the type pair (0 bf16, 1 f32) and head
// dim: bf16 q and cache take the tensor-core body sized for D, every other
// pair the f32 body.
template <class F, class... A>
cudaError_t dispatch(int q_dtype, int kv_dtype, int D, A... a) {
  using bf = __nv_bfloat16;
  if (q_dtype == 0 && kv_dtype == 0) {
    if (D <= 64) return F::template run<bf, bf, 64>(a...);
    if (D <= 128) return F::template run<bf, bf, 128>(a...);
    return F::template run<bf, bf, 256>(a...);
  }
  if (q_dtype == 1 && kv_dtype == 1)
    return F::template run<float, float, 0>(a...);
  if (q_dtype == 1 && kv_dtype == 0)
    return F::template run<float, bf, 0>(a...);
  if (q_dtype == 0 && kv_dtype == 1)
    return F::template run<bf, float, 0>(a...);
  return cudaErrorInvalidValue;
}

int dtype_bytes(int dtype) { return dtype == 0 ? 2 : dtype == 1 ? 4 : 0; }

bool valid(const Params& p, bool paged, int kv_dtype) {
  if (p.B <= 0 || p.Hkv <= 0 || p.G <= 0 || p.G > kMaxG || p.D <= 0 ||
      p.D > kMaxD || p.T <= 0 || p.B > 65535 || p.Hkv > 65535)
    return false;
  // 16-byte rows and bases for cp.async; 4-byte q pairs for the mma body.
  const int szc = dtype_bytes(kv_dtype);
  if (szc == 0 || (p.D * szc) % 16 != 0 || !aligned16(p.k) ||
      !aligned16(p.v) || reinterpret_cast<uintptr_t>(p.q) % 4 != 0)
    return false;
  if (paged && (p.page <= 0 || p.n_pages <= 0 || p.pool_pages <= 0 ||
                static_cast<long long>(p.page) * p.n_pages !=
                    (p.world > 1 ? p.t_loc : p.T)))
    return false;
  return true;
}

// The splits cover `span` positions (T at world 1, t_loc at world W).
bool valid_split(const Params& p, int span) {
  return p.splits > 0 && p.split_len > 0 && p.split_len % kChunk == 0 &&
         static_cast<long long>(p.splits) * p.split_len >= span &&
         static_cast<long long>(p.splits - 1) * p.split_len < span;
}

// The workspace the merge reads: float4 rows of G x D, at most
// kMergeMaxSG splits x heads.
bool valid_ws(const Params& p) {
  return p.ws_a != nullptr && p.ws_l != nullptr && p.ws_m != nullptr &&
         aligned16(p.ws_a) && p.D % 4 == 0 &&
         static_cast<long long>(p.splits) * p.G <= kMergeMaxSG;
}

Params make_params(const void* q, const void* k, const void* v,
                   const int* kv_len, const int* table, void* out,
                   float* ws_a, float* ws_l, float* ws_m, int B, int Hq,
                   int Hkv, int D, int T, int page, int pool_pages,
                   int split_len, int splits, float scale) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.kv_len = kv_len;
  p.table = table;
  p.out = out;
  p.ws_a = ws_a;
  p.ws_l = ws_l;
  p.ws_m = ws_m;
  p.tickets = nullptr;
  p.drop_split = -1;
  p.B = B;
  p.Hkv = Hkv;
  p.G = (Hkv > 0 && Hq % Hkv == 0) ? Hq / Hkv : 0;
  p.D = D;
  p.T = T;
  p.page = table ? page : T;
  p.n_pages = (table && page > 0) ? T / page : 1;
  p.pool_pages = table ? pool_pages : B;
  p.split_len = split_len;
  p.splits = splits;
  p.scale = scale;
  p.world = 1;
  p.t_loc = T;
  return p;
}

}  // namespace

extern "C" {

// The split plan of one decode call: B rows of Hkv KV heads over T
// positions, on a card with `sms` SMs. The most splits, each a whole number
// of 64-position tiles, that keep rows x splits blocks within one block an
// SM: a block of the bf16 body keeps 4 warps x 2 stages x 8 KB of K/V in
// flight at D = 128, above the ~25 KB an SM needs at 3.35 TB/s and ~1 us,
// so a second block an SM adds nothing but splits to merge. It depends on
// the shape only, so equal inputs always sum in the same order. (World W
// asks for it with W * B rows over t_loc positions.)
int tdt_flash_decode_plan(int B, int Hkv, int T, int sms, int* splits,
                          int* split_len) {
  if (B <= 0 || Hkv <= 0 || T <= 0 || sms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(B) * Hkv;
  long long want = sms / rows;
  if (want < 1) want = 1;
  long long len = (T + want - 1) / want;
  len = (len + kChunk - 1) / kChunk * kChunk;
  *split_len = static_cast<int>(len);
  *splits = static_cast<int>((T + len - 1) / len);
  return 0;
}

// The split-KV partial kernel: per (row, KV head, split) the unnormalized
// (acc, l, m) into the workspace. `table` null means dense rows. With `out`
// and `tickets` (B * Hkv int32, zero before the call and zero again after
// it; launches that share them must run in stream order) the world-1 tiled
// call in one launch: the last block of each (row, KV head) merges the
// row's splits into out (B, Hq, D) of q's dtype; `drop_split` >= 0 plants
// the test fault there, the merge leaving that split out.
int tdt_flash_decode_partial(const void* q, const void* k, const void* v,
                             const int* kv_len, const int* table,
                             float* ws_a, float* ws_l, float* ws_m,
                             void* out, int* tickets, int B, int Hq,
                             int Hkv, int D, int T, int page,
                             int pool_pages, int split_len, int splits,
                             float scale, int q_dtype, int kv_dtype,
                             int drop_split, void* stream) {
  Params p = make_params(q, k, v, kv_len, table, out, ws_a, ws_l, ws_m, B,
                         Hq, Hkv, D, T, page, pool_pages, split_len, splits,
                         scale);
  p.tickets = tickets;
  p.drop_split = drop_split;
  if (!valid(p, table != nullptr, kv_dtype) || !valid_split(p, p.T) ||
      !valid_ws(p) || (out == nullptr) != (tickets == nullptr) ||
      drop_split >= splits)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch<Partial>(
      q_dtype, kv_dtype, D, p, static_cast<cudaStream_t>(stream)));
}

// The fixed-order merge of the partials into out (B, Hq, D) of q's dtype,
// as a launch of its own (the fused launch's merge, for checks).
int tdt_flash_decode_combine(const float* ws_a, const float* ws_l,
                             const float* ws_m, void* out, int B, int Hq,
                             int Hkv, int D, int splits, int out_dtype,
                             void* stream) {
  Params p = make_params(nullptr, nullptr, nullptr, nullptr, nullptr, out,
                         const_cast<float*>(ws_a), const_cast<float*>(ws_l),
                         const_cast<float*>(ws_m), B, Hq, Hkv, D, 1, 0, 0, 1,
                         splits, 0.f);
  if (B <= 0 || Hkv <= 0 || p.G <= 0 || p.G > kMaxG || D <= 0 ||
      D > kMaxD || B > 65535 || Hkv > 65535 || splits <= 0 || !valid_ws(p))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(1, p.Hkv, p.B);
  const int bytes = merge_floats(splits, p.G) * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    flash_decode_combine<__nv_bfloat16><<<grid, kThreads, bytes, s>>>(p);
  else if (out_dtype == 1)
    flash_decode_combine<float><<<grid, kThreads, bytes, s>>>(p);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The single-pass kernel: one block per (row, KV head) over all T
// positions, writing out (B, Hq, D) of q's dtype.
int tdt_flash_decode_single(const void* q, const void* k, const void* v,
                            const int* kv_len, void* out, int B, int Hq,
                            int Hkv, int D, int T, float scale, int q_dtype,
                            int kv_dtype, void* stream) {
  const int len = (T + kChunk - 1) / kChunk * kChunk;
  const Params p = make_params(q, k, v, kv_len, nullptr, out, nullptr,
                               nullptr, nullptr, B, Hq, Hkv, D, T, 0, 0, len,
                               1, scale);
  if (!valid(p, false, kv_dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch<Single>(
      q_dtype, kv_dtype, D, p, static_cast<cudaStream_t>(stream)));
}

// Blocks the world-W kernel keeps resident for this type pair and head dim
// (its shared memory depends on both): the grid of its cooperative launch
// is at most this, and `flags` needs this many barrier words.
int tdt_flash_decode_world_grid(int q_dtype, int kv_dtype, int D,
                                int* blocks) {
  if (D <= 0 || D > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.D = D;
  return static_cast<int>(
      dispatch<WorldGrid>(q_dtype, kv_dtype, D, p, blocks));
}

// The world-W decode: `world` ranks, rank r holding positions [r t_loc,
// (r + 1) t_loc) of the (B, T = world t_loc, Hkv, D) dense cache, or (with
// `table` (world, B, n_pages) of rank-local page ids) its pool rows
// [r pool_pages, (r + 1) pool_pages) of the (world pool_pages, page, Hkv,
// D) pool. splits of split_len cover t_loc (one split: the single-pass
// variant, and ws_* may be null). out: (world, B, Hq, D) of q's dtype, one
// output per rank. comb_tab / sig_tab: the ranks' combine buffers and
// signals (see Params); flags: at least tdt_flash_decode_world_grid words.
// `epoch` must differ from every earlier call's on these buffers; `fault`
// plants the test fault (rank 0's first push of entry (0, 0) skipped, its
// signal still set).
int tdt_flash_decode_world(const void* q, const void* k, const void* v,
                           const int* kv_len, const int* table, void* out,
                           float* ws_a, float* ws_l, float* ws_m,
                           const long long* comb_tab,
                           const long long* sig_tab,
                           unsigned long long* flags, int world, int B,
                           int Hq, int Hkv, int D, int t_loc, int page,
                           int pool_pages, int split_len, int splits,
                           float scale, int q_dtype, int kv_dtype,
                           unsigned long long epoch, int fault,
                           void* stream) {
  if (world < 2 || t_loc <= 0 || comb_tab == nullptr || sig_tab == nullptr ||
      flags == nullptr || epoch == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long T = static_cast<long long>(world) * t_loc;
  if (T > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(q, k, v, kv_len, table, out, ws_a, ws_l, ws_m, B,
                         Hq, Hkv, D, static_cast<int>(T), page, pool_pages,
                         split_len, splits, scale);
  p.world = world;
  p.t_loc = t_loc;
  p.n_pages = (table && page > 0) ? t_loc / page : 1;
  p.pool_pages = table ? pool_pages : B;
  p.comb_tab = comb_tab;
  p.sig_tab = sig_tab;
  p.flags = flags;
  p.epoch = epoch;
  p.fault = fault;
  if (!valid(p, table != nullptr, kv_dtype) || !valid_split(p, t_loc) ||
      (splits > 1 && !valid_ws(p)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch<World>(
      q_dtype, kv_dtype, D, p, static_cast<cudaStream_t>(stream)));
}

const char* tdt_flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
