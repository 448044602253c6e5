// The grouped (per-expert) GEMM shared by group_gemm.cu (the expert products
// of Qwen3-MoE: gate|up, the SwiGLU FFN, the down projection of mode "sp"),
// moe_rs.cu (the down projection feeding the top-k reduce) and the world-W
// rings ag_group_gemm.cu and moe_rs_ring.cu.
//
// The function: out[p] = A[p / a_div] @ W[ids[p]] for every pair p, with f32
// accumulation. `ids` may hold E (JAX's sentinel for an invalid pair): such
// pairs run through the last expert, as JAX's `grouped_matmul` folds them
// into its last group (group_gemm.py:56-60); callers mask them. `a_div` is
// the number of consecutive pairs that share one row of A (top-k for the
// MoE's gate|up, whose pairs are each token repeated k times), so the
// (P, K) expansion `jnp.repeat` makes in JAX is never written: a block
// gathers its rows through the pair -> row index.
//
// Two launches per call, on the caller's stream:
//  1. `group_schedule`, one block per list of pairs: the expert schedule of
//     JAX's `align_tokens_for_tiles` (group_gemm.py:90-136) with static
//     shapes and no host round trip. A world-1 call has one list; the
//     world-W ring (ag_group_gemm.cu) one per rank's chunk, each in its own
//     slice of the buffer. A stable counting sort of the pairs by expert
//     (warp-level __match_any_sync ranks, per-warp counts in shared memory,
//     a prefix over warps and experts), then one row tile of up to m_blk
//     pairs per (expert, m_blk chunk): its expert, first sorted row and row
//     count. The live tile count goes to sched[0]; the layout is
//     [n_live | sorted pairs (P) | tile expert | tile row0 | tile rows]
//     (each max_tiles long), max_tiles = ceil(P / m_blk) + min(E, P), the
//     worst case. Integer counts only, in a fixed order.
//  2. The product.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16): the bytes of the
// live experts' weights. At decode (P = 32 pairs over ~29 live experts of
// 128) they are all the work; at prefill (P = 4096, all 128 experts live)
// Qwen3-30B-A3B's gate|up weights are 805 MB and its down weights 403 MB,
// against 26 GFLOP of products (0.026 ms at 989 TFLOP/s). So the design
// keeps the weight stream running at the card's memory rate and moves
// every other byte as few times as it can:
//  * One persistent block an SM (grid: the blocks the card keeps resident,
//    no more than the worst-case items), 384 threads: warpgroup 0 produces
//    (setmaxnreg down to 40 registers), warpgroups 1 and 2 consume. Blocks
//    read the live tile count sched[0] and walk the live items (row tile,
//    column item), row tile first (`gg_item`: a tile's gathered rows of A
//    are still in L2 when its next column item runs), so no block exists
//    for a dead tile. The stage ring's stage and parity carry from item to
//    item (tiles.cuh's WgRing), so one item's epilogue overlaps the next
//    item's loads.
//  * B by TMA: a 4-D view (N, K, experts, ranks) of the weights, N
//    contiguous, K at stride ldb, experts at stride b_estride, so a rank's
//    shard W[:, :, cols] or W[:, rows, :] is read in place; 64 x 64 boxes
//    in the 128-byte swizzle that tiles.cuh's wgmma descriptors read. The
//    view's extents zero-fill K past its end and columns past N.
//  * A gathered by the producer's 128 threads (TMA cannot gather rows):
//    two threads a row, each four 16-byte cp.async of the row's 128-byte
//    K slice, through the pair -> row index, written straight into the
//    128-byte-swizzled layout (16-byte chunk c of row r at chunk c ^ (r &
//    7)). Rows past the tile's live rows and K past its end are zero-filled
//    and read nothing. Each thread signals the stage's `full` mbarrier with
//    cp.async.mbarrier.arrive.noinc, beside thread 0's TMA byte count (129
//    arrivals a stage); the consumers order those generic-proxy writes
//    before their wgmma reads with fence.proxy.async.
//  * The tile: a row tile is 64 rows (wgmma's M) at every P. An item is 64
//    rows x 256 columns: each consumer warpgroup runs tiles.cuh's `wg_mma`
//    (wgmma m64n128k16) on its own 128 columns, both on one shared A
//    stage; SwiGLU: each holds 64 columns of gate and 64 of up in one
//    m64n128 accumulator, 128 output columns an item. A is staged once per
//    item: 6 times for Qwen3-30B-A3B's gate|up (2 x 768 columns) and 8 for
//    its down projection (2048), where a 64-column tile stages it 24 and 32
//    times. A stage is 8 KB of A and 32 KB of B, 5 stages (205 KB).
//  * The sum (tiles.cuh's fold): wgmma accumulates each kPfFold stages (128
//    K terms) into `part` in f32, which is then added to `acc` in f32. The K
//    order is fixed by K alone, so a row has the same bits at every P and
//    item width, at world 1 and in the rings, and from run to run: no
//    atomics, no split K.
// This one body serves every bf16 call whose K, N and strides are
// multiples of 8, at every P: a body chosen by P would give the same row
// other bits in the ring (whose chunks are 1 / W of the pairs) than at
// world 1.
//
// Epilogues:
//  * plain: each product rounded to the output type (bf16, or f32 for the
//    MoE-reduce's unrounded numerics). Gate and up may share a launch
//    (n_b = 2): the column items of the second product follow the first's.
//  * SwiGLU: gate and up accumulate side by side (sharing each A stage),
//    then silu(g) * u in f32 and one rounding.
// Each output row is stored at its pair's own index (row stride ldc): the
// store address does the unsort.
//
// The bodies are device functions (`gg_wg_load` / `gg_wg_mma` for the
// producer and the consumers, `gg_fma_tile`): the world-1 kernels run
// them over a launch's items, the ring kernels over each rank's, so both
// give a row the same bits.
//
// Strides: A's rows and W's rows and experts are read through the strides
// the caller gives (elements; the last dimension is contiguous). The
// experts of Qwen3-30B-A3B take ~57 GB of the card's 80 GB: a copy per
// rank would not fit. Strides change addresses only, never the order of a
// sum, so a contiguous call and a strided call of equal values give equal
// bits.
//
// f32 and bf16 with K, N or a stride not a multiple of 8 take `group_fma`,
// a tile of m_blk = 16, 32 or 64 rows (twice the mean pairs per expert) by
// 64 columns of f32 FMAs over the same schedule, one tile a block (test
// configurations only).

#pragma once

#include "tiles.cuh"

namespace {

constexpr int kGgMaxExperts = 1024;
constexpr int kGgSchedThreads = 1024;
constexpr int kGgSchedWarps = kGgSchedThreads / 32;
constexpr int kGgMaxRows = 64;           // largest m_blk of the FMA tile
constexpr int kGgWgRows = 64;            // rows of a tensor-core row tile
constexpr int kGgWgCols = 256;           // columns of a plain item
constexpr int kGgWgColsSwiglu = 128;     // output columns of a SwiGLU item
constexpr int kGgStages = 5;
constexpr int kGgProducers = 128;        // the producer warpgroup's threads
constexpr int kGgABytes = kGgWgRows * kPfBK * 2;
constexpr int kGgStageBytes = kGgABytes + 4 * kPfBox;
// The stages, their 2 x kGgStages mbarriers, and 1 KB to align the stages
// to the swizzle pattern's 1024 bytes.
constexpr int kGgSmemBytes = kGgStages * kGgStageBytes + 2 * kGgStages * 8 +
                             1024;

// ---------------------------------------------------------------------------
// Sizes of a call's plan.
int gg_max_tiles(int P, int E, int m_blk) {
  return (P + m_blk - 1) / m_blk + (E < P ? E : P);
}
__host__ __device__ inline int gg_sched_ints(int P, int max_tiles) {
  return 1 + P + 3 * max_tiles;
}

// Rows per FMA tile: twice the mean pairs per expert, a power of two in
// [16, 64]. A function of the shape only.
int gg_tile_rows(int P, int E) {
  const long long want = (2LL * P + E - 1) / E;
  int m = 16;
  while (m < kGgMaxRows && m < want) m *= 2;
  return m;
}

int gg_sched_smem(int E) {
  return (kGgSchedWarps * E + 3 * E + 1) * static_cast<int>(sizeof(int));
}

// ---------------------------------------------------------------------------
// 1. The expert schedule (blocks of 1024 threads; E <= 1024). Block b sorts
// pairs [b * P, (b + 1) * P) of `ids` into slice b of `sched` (each
// gg_sched_ints(P, max_tiles) long), its pairs numbered from 0.
__global__ void __launch_bounds__(kGgSchedThreads)
group_schedule(const int* __restrict__ ids, int P, int E, int m_blk,
               int max_tiles, int* __restrict__ sched) {
  extern __shared__ int sh[];
  ids += static_cast<size_t>(blockIdx.x) * P;
  sched += static_cast<size_t>(blockIdx.x) * gg_sched_ints(P, max_tiles);
  int* wcnt = sh;                               // [warp][expert]
  int* cnt = wcnt + kGgSchedWarps * E;          // pairs per expert
  int* offs = cnt + E;                          // first sorted row
  int* toff = offs + E;                         // first tile, E + 1 entries
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < kGgSchedWarps * E; i += kGgSchedThreads) wcnt[i] = 0;
  __syncthreads();

  // Warp w owns pairs [w * seg, (w + 1) * seg), 32 at a time; lanes past
  // the end carry expert -1 and match only each other.
  const int seg = (P + kGgSchedWarps - 1) / kGgSchedWarps;
  const int p_begin = warp * seg;
  const int p_end = min(P, p_begin + seg);
  int* mine = wcnt + warp * E;
  const unsigned below = (1u << lane) - 1u;
  for (int base = p_begin; base < p_end; base += 32) {
    const int p = base + lane;
    const int e = p < p_end ? min(max(ids[p], 0), E - 1) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, e);
    if (e >= 0 && (peers & below) == 0) mine[e] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // Per expert: each warp's count becomes the count of the warps before it.
  for (int e = tid; e < E; e += kGgSchedThreads) {
    int run = 0;
    for (int w = 0; w < kGgSchedWarps; ++w) {
      const int c = wcnt[w * E + e];
      wcnt[w * E + e] = run;
      run += c;
    }
    cnt[e] = run;
  }
  __syncthreads();
  if (tid == 0) {
    int o = 0, t = 0;
    for (int e = 0; e < E; ++e) {
      offs[e] = o;
      toff[e] = t;
      o += cnt[e];
      t += (cnt[e] + m_blk - 1) / m_blk;
    }
    toff[E] = t;
    sched[0] = t;
  }
  __syncthreads();

  // Stable placement: expert offset + earlier warps + earlier lanes and
  // steps of this warp.
  int* sorted = sched + 1;
  for (int base = p_begin; base < p_end; base += 32) {
    const int p = base + lane;
    const int e = p < p_end ? min(max(ids[p], 0), E - 1) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, e);
    if (e >= 0) sorted[offs[e] + mine[e] + __popc(peers & below)] = p;
    __syncwarp();
    if (e >= 0 && (peers & below) == 0) mine[e] += __popc(peers);
    __syncwarp();
  }

  int* t_exp = sched + 1 + P;
  int* t_row0 = t_exp + max_tiles;
  int* t_rows = t_row0 + max_tiles;
  for (int e = tid; e < E; e += kGgSchedThreads) {
    for (int ti = toff[e], j = 0; ti < toff[e + 1]; ++ti, ++j) {
      t_exp[ti] = e;
      t_row0[ti] = offs[e] + j * m_blk;
      t_rows[ti] = min(m_blk, cnt[e] - j * m_blk);
    }
  }
}

// The schedules of `lists` consecutive lists of P pairs, one block each.
cudaError_t launch_schedule(const int* ids, int P, int E, int m_blk,
                            int max_tiles, int* sched, cudaStream_t stream,
                            int lists = 1) {
  const int smem = gg_sched_smem(E);
  const cudaError_t err = cudaFuncSetAttribute(
      group_schedule, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  group_schedule<<<lists, kGgSchedThreads, smem, stream>>>(ids, P, E, m_blk,
                                                           max_tiles, sched);
  return cudaSuccess;
}

// A tile's entry of the schedule.
struct GgTile {
  int expert, row0, rows;
};

__device__ __forceinline__ bool gg_tile(const int* __restrict__ sched, int P,
                                        int max_tiles, int tile, GgTile& t) {
  if (tile >= sched[0]) return false;
  const int* t_exp = sched + 1 + P;
  t.expert = t_exp[tile];
  t.row0 = t_exp[max_tiles + tile];
  t.rows = t_exp[2 * max_tiles + tile];
  return true;
}

// The operands of one launch. With n_b = 2 and the plain epilogue, column
// tiles [0, col_tiles) are product 0's and [col_tiles, 2 col_tiles)
// product 1's; with SWIGLU both products feed one output (c0). col_tiles
// counts the tiles (FMA) or items (tensor cores) of one product's N.
template <typename T, typename OutT>
struct GgArgs {
  const T* a;          // (P / a_div, K), row stride lda
  int a_div;
  const T* b0;         // (E, K, N), row stride ldb, expert stride b_estride
  const T* b1;
  OutT* c0;            // (P, N), row stride ldc
  OutT* c1;
  const int* sched;
  int P, max_tiles, K, N, col_tiles;
  long long lda, ldb, b_estride, ldc;
  int n_b;             // products of the plain epilogue (1 or 2)
};

// ---------------------------------------------------------------------------
// 2a. The tensor-core body (bf16; K, N and the strides multiples of 8,
// operands 16-byte aligned): the design note above. A launcher's kernel
// takes kPfThreads threads and kGgSmemBytes of dynamic shared memory
// (`gg_smem`), calls tiles.cuh's `wg_init` and syncs the block, then
// splits for good: threads 0-127 call `wg_producer_regs` and run
// `gg_wg_load` for each of the block's items, then `gg_producer_done`;
// threads 128-383 call `wg_consumer_regs` and run `gg_wg_mma` for the same
// items in the same order.

// The stage ring: A's 64 x 64 slice, then B's four 64 x 64 boxes (box 2 wg
// and 2 wg + 1 are consumer warpgroup wg's: its two 64-column halves, or
// its gate and up columns).
struct GgSmem {
  static constexpr int kStages = kGgStages;
  static constexpr int kFullArrivals = kGgProducers + 1;
  static constexpr bool kSharedA = true;
  unsigned char* base;
  __device__ unsigned char* a(int s) const { return base + s * kGgStageBytes; }
  __device__ unsigned char* b(int s) const { return a(s) + kGgABytes; }
  __device__ uint64_t* full(int s) const {
    return reinterpret_cast<uint64_t*>(base + kStages * kGgStageBytes) + s;
  }
  __device__ uint64_t* empty(int s) const { return full(kStages + s); }
};
using GgRing = WgRing<kGgStages>;

__device__ __forceinline__ GgSmem gg_smem(unsigned char* raw) {
  return GgSmem{wg_smem(raw).base};
}

// The TMA views of a launch's weights: product 0's (gate's) and product
// 1's (up's), each (N, K, E, ranks) with boxes of 64 x 64 of dims 0 and 1.
struct GgViews {
  CUtensorMap b[2];
};

// One view of (E, K, N) weights with row stride ldb and expert stride
// b_estride, and `ranks` shards `rank_step` elements apart (1, 0 at world
// 1; the extents are a shard's, so TMA never reads a neighbour's).
inline cudaError_t gg_view(CUtensorMap* map, const void* b, int E, int K,
                           int N, long long ldb, long long b_estride,
                           int ranks, long long rank_step) {
  if (ranks == 1) rank_step = b_estride * E;
  return make_view(map, b, {N, K, E, ranks}, {ldb, b_estride, rank_step},
                   64);
}

// An item: row tile `tile`'s schedule entry, product `prod` and its first
// column n0.
struct GgItem {
  int expert, row0, rows, prod, n0;
};

template <bool SWIGLU>
__host__ __device__ constexpr int gg_item_cols() {
  return SWIGLU ? kGgWgColsSwiglu : kGgWgCols;
}

// Items a row tile has: column items of every product.
template <bool SWIGLU, typename OutT>
__device__ __forceinline__ int gg_items_per_tile(
    const GgArgs<bf16, OutT>& g) {
  return SWIGLU ? g.col_tiles : g.col_tiles * g.n_b;
}

// Item i of the live ones, row tile first.
template <bool SWIGLU, typename OutT>
__device__ __forceinline__ GgItem gg_item(const GgArgs<bf16, OutT>& g,
                                          int i) {
  const int per = gg_items_per_tile<SWIGLU>(g);
  const int tile = i / per;
  const int col = i % per;
  const int* t_exp = g.sched + 1 + g.P;
  GgItem it;
  it.expert = t_exp[tile];
  it.row0 = t_exp[g.max_tiles + tile];
  it.rows = t_exp[2 * g.max_tiles + tile];
  it.prod = col / g.col_tiles;
  it.n0 = (col % g.col_tiles) * gg_item_cols<SWIGLU>();
  return it;
}

__device__ __forceinline__ void cp_async_mbar_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar)) : "memory");
}

// The producer warpgroup's part of one item (every one of its threads
// calls it): for each 64-deep K slice, once the stage is free, thread 0
// counts B's bytes on the stage's `full` and starts its four boxes (at
// `rank` of the views), and thread t gathers half of row t / 2 of A.
template <bool SWIGLU, typename OutT>
__device__ __forceinline__ void gg_wg_load(const GgSmem& s, GgRing& p,
                                           const GgArgs<bf16, OutT>& g,
                                           const GgViews& v, int rank,
                                           const GgItem& it) {
  const int t = threadIdx.x;                  // 0..127
  const int r = t >> 1;
  const int c0 = (t & 1) * 4;                 // first of four 16-byte chunks
  const bf16* src = nullptr;
  if (r < it.rows)
    src = g.a + static_cast<long long>(g.sched[1 + it.row0 + r] / g.a_div) *
                    g.lda;
  const CUtensorMap* b0 = &v.b[SWIGLU ? 0 : it.prod];
  const CUtensorMap* b1 = SWIGLU ? &v.b[1] : b0;
  const int nk = (g.K + kPfBK - 1) / kPfBK;
  for (int kc = 0; kc < nk; ++kc) {
    mbar_wait(s.empty(p.stage), p.phase ^ 1);
    uint64_t* full = s.full(p.stage);
    const int k0 = kc * kPfBK;
    if (t == 0) {
      mbar_expect(full, 4 * kPfBox);
      unsigned char* b = s.b(p.stage);
#pragma unroll
      for (int box = 0; box < 4; ++box) {
        // SwiGLU: gate, up, gate, up of columns n0, n0, n0 + 64, n0 + 64;
        // plain: columns n0 + 64 box.
        const CUtensorMap* m = SWIGLU && (box & 1) ? b1 : b0;
        const int n = it.n0 + 64 * (SWIGLU ? box >> 1 : box);
        tma_load(b + box * kPfBox, m, full, n, k0, it.expert, rank);
      }
    }
    unsigned char* row = s.a(p.stage) + r * 128;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + q;
      const bool ok = src != nullptr && k0 + c * 8 < g.K;
      cp_async16(row + ((c ^ (r & 7)) << 4), ok ? src + k0 + c * 8 : g.a, ok);
    }
    cp_async_mbar_arrive_noinc(full);
    p.next();
  }
}

// The producer warpgroup's 128 threads wait for each other (named barrier
// 2; tiles.cuh's consumers use 1).
__device__ __forceinline__ void gg_producers_sync() {
  asm volatile("bar.sync 2, 128;" ::: "memory");
}

// A producer thread's last act: its copies are done before it exits.
__device__ __forceinline__ void gg_producer_done() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Stores two neighbouring columns of a row, rounded to OutT, at the pair's
// own row.
template <typename OutT>
struct GgEpi {
  OutT* c;             // the item's first column of row 0
  long long ldc;
  const int* pairs;    // the row tile's sorted pairs
  __device__ __forceinline__ void pair(int r, int col, float v0,
                                       float v1) const {
    OutT* dst = c + static_cast<long long>(pairs[r]) * ldc + col;
    if constexpr (sizeof(OutT) == 4) {
      *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
    } else {
      __nv_bfloat162 q;
      q.x = from_f32<bf16>(v0);
      q.y = from_f32<bf16>(v1);
      *reinterpret_cast<__nv_bfloat162*>(dst) = q;
    }
  }
};

// The consumers' part of the same item: tiles.cuh's wg_mma over GgSmem,
// then `ready()`, then the epilogue into the pairs' rows.
template <bool SWIGLU, typename OutT, class Ready>
__device__ __forceinline__ void gg_wg_mma(const GgSmem& s, GgRing& p,
                                          const GgArgs<bf16, OutT>& g,
                                          const GgItem& it, Ready&& ready) {
  OutT* c = (!SWIGLU && it.prod ? g.c1 : g.c0) + it.n0;
  const int cols = min(gg_item_cols<SWIGLU>(), g.N - it.n0);
  wg_mma<SWIGLU>(s, p, (g.K + kPfBK - 1) / kPfBK, it.rows, cols, nullptr,
                 nullptr, GgEpi<OutT>{c, g.ldc, g.sched + 1 + it.row0},
                 ready);
}

// The world-1 kernel: a persistent grid, block b taking live items b, b +
// gridDim.x, ...
template <bool SWIGLU, typename OutT>
__global__ void __launch_bounds__(kPfThreads, 1)
group_wg(GgArgs<bf16, OutT> g, const __grid_constant__ GgViews v) {
  extern __shared__ unsigned char smem_raw[];
  const GgSmem s = gg_smem(smem_raw);
  wg_init(s);
  __syncthreads();
  const int items = g.sched[0] * gg_items_per_tile<SWIGLU>(g);
  if (threadIdx.x < 128) {
    wg_producer_regs();
    GgRing p;
    for (int i = blockIdx.x; i < items; i += gridDim.x)
      gg_wg_load<SWIGLU>(s, p, g, v, 0, gg_item<SWIGLU>(g, i));
    gg_producer_done();
    return;
  }
  wg_consumer_regs();
  GgRing p;
  for (int i = blockIdx.x; i < items; i += gridDim.x)
    gg_wg_mma<SWIGLU>(s, p, g, gg_item<SWIGLU>(g, i), [] {});
}

// ---------------------------------------------------------------------------
// 2b. FMA tile (f32, odd shapes): row tile `tile` by 64-column tile `col`,
// 256 threads; thread (ty, tx) owns rows ty*4..+3 and columns tx*4..+3 of a
// 64 x 64 tile and sums K in order. Static shared memory; the block's
// must be free when it starts (one tile a block, or a barrier between
// tiles).
constexpr int kGgFmBN = 64;
constexpr int kGgFmBK = 16;
constexpr int kGgFmThreads = 256;

template <typename T, bool SWIGLU, typename OutT>
__device__ __forceinline__ void gg_fma_tile(const GgArgs<T, OutT>& g,
                                            int tile_idx, int col) {
  constexpr int NB = SWIGLU ? 2 : 1;
  __shared__ float As[kGgFmBK][kGgMaxRows + 4];    // A tile, transposed
  __shared__ float Bs[NB][kGgFmBK][kGgFmBN + 4];
  __shared__ int pair_of[kGgMaxRows];
  __shared__ int arow_of[kGgMaxRows];

  GgTile tile;
  if (!gg_tile(g.sched, g.P, g.max_tiles, tile_idx, tile)) return;
  const int K = g.K, N = g.N;
  int prod = 0;
  int n0 = col * kGgFmBN;
  if (!SWIGLU && col >= g.col_tiles) {
    prod = 1;
    n0 = (col - g.col_tiles) * kGgFmBN;
  }
  const size_t w_off = static_cast<size_t>(tile.expert) * g.b_estride;
  const T* __restrict__ B0 = (prod ? g.b1 : g.b0) + w_off;
  const T* __restrict__ B1 = SWIGLU ? g.b1 + w_off : B0;
  OutT* __restrict__ C = prod ? g.c1 : g.c0;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  for (int r = tid; r < kGgMaxRows; r += kGgFmThreads) {
    const int p = r < tile.rows ? g.sched[1 + tile.row0 + r] : -1;
    pair_of[r] = p;
    arow_of[r] = p >= 0 ? p / g.a_div : -1;
  }
  __syncthreads();

  float acc[NB][4][4];
#pragma unroll
  for (int h = 0; h < NB; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[h][i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kGgFmBK) {
    for (int e = tid; e < kGgMaxRows * kGgFmBK; e += kGgFmThreads) {
      const int r = e / kGgFmBK;
      const int kk = e % kGgFmBK;
      const int ar = arow_of[r];
      As[kk][r] = (ar >= 0 && k0 + kk < K)
                      ? to_f32(g.a[static_cast<size_t>(ar) * g.lda + k0 + kk])
                      : 0.f;
    }
#pragma unroll
    for (int h = 0; h < NB; ++h) {
      const T* B = h == 0 ? B0 : B1;
      for (int e = tid; e < kGgFmBK * kGgFmBN; e += kGgFmThreads) {
        const int r = e / kGgFmBN;
        const int c = e % kGgFmBN;
        Bs[h][r][c] = (k0 + r < K && n0 + c < N)
                          ? to_f32(B[static_cast<size_t>(k0 + r) * g.ldb + n0 + c])
                          : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGgFmBK; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int h = 0; h < NB; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float b = Bs[h][kk][tx * 4 + j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[h][i][j] = fmaf(a[i], b, acc[h][i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= tile.rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      float v = acc[0][i][j];
      if constexpr (SWIGLU) v = swiglu(v, acc[NB - 1][i][j]);
      C[static_cast<size_t>(pair_of[r]) * g.ldc + n] = from_f32<OutT>(v);
    }
  }
}

// The world-1 kernel: grid = (max_tiles, 64-column tiles), one tile a block.
template <typename T, bool SWIGLU, typename OutT>
__global__ void __launch_bounds__(kGgFmThreads)
group_fma(GgArgs<T, OutT> g) {
  gg_fma_tile<T, SWIGLU, OutT>(g, blockIdx.x, blockIdx.y);
}

// ---------------------------------------------------------------------------
// How one call runs. The path and the tile rows depend on the dtype, the
// shape and the strides only, so equal inputs give equal bits.
struct GgPlan {
  int path;       // 0: group_fma, 1: group_wg
  int m_blk;      // rows per tile: kGgWgRows on tensor cores
  int max_tiles;  // the worst case of live row tiles
};

// The strides (elements) of A's rows, W's rows and W's experts; the
// tensor-core path reads 16-byte chunks of A and TMA boxes of W, so each
// must be a multiple of 8.
GgPlan gg_make_plan(int P, int E, int K, int N, int dtype, long long lda,
                    long long ldb, long long b_estride) {
  GgPlan p;
  p.path = (dtype == 0 && K % 8 == 0 && N % 8 == 0 && lda % 8 == 0 &&
            ldb % 8 == 0 && b_estride % 8 == 0) ? 1 : 0;
  p.m_blk = p.path == 1 ? kGgWgRows : gg_tile_rows(P, E);
  p.max_tiles = gg_max_tiles(P, E, p.m_blk);
  return p;
}

// Column tiles (FMA) or items (tensor cores) of one product's N.
template <bool SWIGLU>
int gg_col_tiles(const GgPlan& p, int N) {
  const int w = p.path == 1 ? gg_item_cols<SWIGLU>() : kGgFmBN;
  return (N + w - 1) / w;
}

bool gg_args_ok(int P, int E, int K, int N, int dtype) {
  return P > 0 && E > 0 && E <= kGgMaxExperts && K > 0 && N > 0 &&
         (dtype == 0 || dtype == 1);
}

// Strides no smaller than the rows and experts they step over.
bool gg_strides_ok(int K, int N, long long lda, long long ldb,
                   long long b_estride) {
  return lda >= K && ldb >= N && b_estride >= static_cast<long long>(K) * ldb;
}

// Blocks of a kernel of `threads` threads and `smem` bytes of dynamic
// shared memory that the current device keeps resident at once.
template <class Kernel>
cudaError_t gg_resident(Kernel kernel, int threads, int smem, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err == cudaSuccess) *out = sms * per_sm;
  return err;
}

template <bool SWIGLU, typename OutT>
cudaError_t launch_group_wg(const GgArgs<bf16, OutT>& g, int E,
                            cudaStream_t stream) {
  GgViews v = {};
  cudaError_t err = gg_view(&v.b[0], g.b0, E, g.K, g.N, g.ldb, g.b_estride,
                            1, 0);
  if (err == cudaSuccess && (SWIGLU || g.n_b == 2))
    err = gg_view(&v.b[1], g.b1, E, g.K, g.N, g.ldb, g.b_estride, 1, 0);
  int resident = 0;
  if (err == cudaSuccess)
    err = gg_resident(group_wg<SWIGLU, OutT>, kPfThreads, kGgSmemBytes,
                      &resident);
  if (err != cudaSuccess) return err;
  const int worst = g.max_tiles * (SWIGLU ? g.col_tiles : g.col_tiles * g.n_b);
  group_wg<SWIGLU, OutT><<<min(worst, resident), kPfThreads, kGgSmemBytes,
                           stream>>>(g, v);
  return cudaSuccess;
}

// The product of a planned call over E experts, after its schedule (the
// operands are typed by the caller; OutT is T or float; outputs
// contiguous).
template <typename T, typename OutT, bool SWIGLU>
cudaError_t run_group_product(const GgPlan& p, GgArgs<T, OutT> g, int n_b,
                              int E, cudaStream_t stream) {
  g.max_tiles = p.max_tiles;
  g.ldc = g.N;
  g.n_b = n_b;
  g.col_tiles = gg_col_tiles<SWIGLU>(p, g.N);
  if constexpr (sizeof(T) == 2) {
    if (p.path == 1) return launch_group_wg<SWIGLU, OutT>(g, E, stream);
  }
  dim3 grid(p.max_tiles, g.col_tiles * (SWIGLU ? 1 : n_b));
  group_fma<T, SWIGLU, OutT><<<grid, kGgFmThreads, 0, stream>>>(g);
  return cudaSuccess;
}

}  // namespace
