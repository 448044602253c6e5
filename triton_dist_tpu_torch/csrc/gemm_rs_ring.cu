// GEMM fused with the ring reduce-scatter (GEMM-RS) and, with the ring
// all-gather epilogue, the all-reduce (GEMM-AR) for Hopper (sm_90a), every
// rank of one card in one cooperative launch.
//
// Replaces, at world W > 1, the ring halves of
// triton_dist_tpu/ops/gemm_reduce_scatter.py::_gemm_rs_kernel (:249, the
// "vmem" variant), ::_gemm_rs_hbm_nb_kernel (:353, "hbm") and
// ::_gemm_rs_hbm_kernel (:533, "hbm_kt", unidirectional, no epilogue), the
// kernels `gemm_rs` (:884) and `gemm_ar` (:898) launch. The variants differ
// in tiling and in where the two ring directions split the columns; the
// port's plan (ops/gemm_reduce_scatter.py::ring_plan) copies JAX's choice
// and hands the kernel the split column, so all three are this one kernel.
//
// What it computes, for every rank r at once: A (M, K) is column-sharded
// (rank r's columns [r * kl, (r + 1) * kl)), B (K, N) row-sharded; p_r =
// A_r @ B_r is rank r's partial. Row chunk c ([c * rows, (c + 1) * rows)) of
// the output is the ring's sum of the partials' chunk c, in the ring's
// order and roundings (the reference gemm_rs_ring_reference):
//   columns [0, split): p_{c+1}, then + p_{c+2}, ..., + p_{c-1}, then + p_c;
//   columns [split, N) (the mirrored ring): p_{c-1}, p_{c-2}, ..., p_c;
// every partial rounded to the output dtype, and every running sum too
// (JAX: `send_buf[s] = part + recv_buf[s - 1]`, :301-318).
//
// The design, the Pallas kernel's protocol on one card (the tile body; the
// decode body below keeps its grid, signals, order and fault hook):
//  * Grid: `bpr` blocks for each rank, launched cooperatively (all blocks
//    resident), `bpr` from this kernel's occupancy (tdt_rs_ring_grid); a
//    launch that does not fit fails.
//  * Step s < W - 1 (forward half): rank r computes its partial of chunk
//    (r - s - 1) tile by tile; for s > 0 it first waits for that tile's
//    running sum in its own slab s - 1 (pushed by its left neighbour) and
//    adds it; the rounded sum goes straight into the right neighbour's slab
//    s, then the (s, tile) signal there is released. The mirrored half
//    computes chunk (r + s + 1) and pushes left. One slab per step (W - 1
//    per rank), so a fast neighbour never overwrites a slab being read.
//  * Step W - 1: the rank's own chunk, its partial added last, into the
//    output (GEMM-RS: the row-sharded global output; GEMM-AR: the rank's
//    own (M, N) buffer).
//  * GEMM-AR's epilogue: the ring all-gather of the reduced chunks, tile by
//    tile, each rank forwarding to its right neighbour's buffer (JAX's
//    ag_step, unidirectional), so all W buffers end equal.
//  * Items are dealt round robin to a rank's blocks in step order, so a
//    wait only needs items earlier in every block's order: no deadlock.
//  * Signals hold the call's epoch, waits compare for equality; stream
//    order separates calls (the slabs are reused).
//  * `fault` (a test hook): the step-0 pushes of chunk 0 (rank 1's
//    forward, rank W - 1's mirrored one) skip their stores and still
//    release their signals; the output must then be wrong. Chunk 0 holds
//    row 0, which is live at any M (GEMM-AR pads M at the end).
//
// Two bodies, picked by the padded M (the port's ring_path; the rule of
// gemm_ar.cu's and ag_gemm.cu's world-1 plans):
//
// * Decode, M <= 64 (`rs_stream_ring_kernel`, every dtype). What bounds it (H100
//   SXM: 3.35 TB/s): the bytes of B, 32 MB for Qwen3-8B's o_proj and 96 MB
//   for its down projection, so 0.010 / 0.030 ms, plus the exchange's fixed
//   cost on one card (the launch and W - 1 dependent hops of signals, about
//   0.01-0.02 ms whatever the bytes). The tile body below read each rank's
//   shard of B once per ring step (W times) through a 128-row tile with
//   one live row. This body reads it once, and runs the ring on the
//   results, in three phases of one launch:
//   - phase 0, the products: rank r's partial of all M rows, P_r = A_r @
//     B_r, with gemm_common.cuh's small-M bodies (`stream_mma_block` on the
//     tensor cores for bf16 with kl and N multiples of 8, else
//     `fma_stream_block`), planned by `stream_plan` on the rank's own
//     shape: the K splits of the world-1 kernel on that shard. Items are
//     (column tile, row tile, split); each writes its f32 partial into the
//     rank's workspace and releases its own signal. The products do not
//     depend on the ring, so computing them first loses nothing.
//   - phase 1, the ring, in pieces of 64 columns of a chunk (a chunk is one
//     row at Qwen3-8B's decode, so a step has 64 pieces): step s's item
//     waits for its product tiles, sums their splits in split order and
//     rounds once (gemm_ar.cu's split reduce: JAX's `partial_chunk`, so
//     rank r's partial is the world-1 kernel's bits on its shard), then
//     (s > 0) waits for the travelling sum in its slab s - 1, adds it in
//     f32, rounds and pushes into the neighbour's slab s, as above.
//   - GEMM-AR: the last step stores the reduced piece into every rank's
//     buffer at once. The copies are exact, so this is the ring
//     all-gather's result without its W - 1 dependent hops.
// * Prefill, M > 64: the partial products, 2 * M * K * N operations, bound
//   it by operations at Qwen3-8B's prefill (M = 512); the ring moves (W -
//   1) * M * N partial sums through HBM (the ranks share the card's memory:
//   no interconnect is measured). The tiles are computed chunk by chunk in
//   the ring's order as above, with the all-gather epilogue's hops. For
//   bf16 with kl, N and the split multiples of 8 (and W <= 24),
//   `rs_ring_wg_kernel` runs tiles.cuh's wgmma tile (the world-1 kernel's):
//   a block of 384 threads, one an SM, thread 0 feeding each item's K
//   slices by TMA through per-rank views of A's column shard and B's row
//   shard, two warpgroups multiplying, then waiting for the travelling sum
//   only before the epilogue that adds it. Otherwise `rs_ring_kernel` runs
//   the FMA tile. At Qwen3-8B's o_proj and down a rank has 4 x 32 tiles
//   over 33 blocks (W = 4); at W = 8 a chunk is 64 rows, half a tile.
//
// Plain C entry points, loaded with ctypes. A launch runs on the stream it
// is given, allocates nothing and returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shmem.cuh"
#include "tiles.cuh"

namespace {

// Body of a launch: the tiles (0: FMA, 1: tensor cores) or the decode body.
constexpr int kPathFma = 0;
constexpr int kPathMma = 1;
constexpr int kPathStream = 2;
constexpr int kStreamMaxM = 64;            // padded M of the decode body
constexpr int kStreamMaxRows = kStreamMaxM / 2;  // rows of a chunk, W >= 2
constexpr int kPieceCols = 64;             // columns of a decode ring piece
static_assert(kTcBN == kPieceCols && kFaBN == kPieceCols,
              "a decode piece's columns lie in the products' 64-wide tiles");

template <typename T>
struct RsArgs {
  const T* a;                 // (M, K) global, column-sharded
  const T* b;                 // (K, N) global, row-sharded
  T* out;                     // GEMM-RS: (M, N) global, row-sharded;
                              // GEMM-AR: (W, M, N), rank r's buffer row r
  const long long* slab_tab;  // (W,) rank slabs, (W - 1, rows, N) each
  const long long* sig_tab;   // (W,) rank signals (tdt_rs_ring_tiles)
  const long long* ws_tab;    // decode: (W,) rank f32 products, (splits, M, N)
  const long long* ag_tab;    // GEMM-AR tiles: (W,) rank signals, (W, tiles)
  int world, rows, K, kl, N, split, ag, bpr, fault;
  int splits, k_per_split;    // decode: the products' stream_plan
  unsigned long long epoch;
};

// Rounds v to T and, with `recv`, adds the travelling sum in f32 and rounds
// again (JAX's `part + recv`); stores at dst.
template <typename T>
struct RsEpi {
  const T* recv;
  T* dst;
  long long ld;
  __device__ __forceinline__ float add(int r, int col, float v) const {
    float out = to_f32(from_f32<T>(v));
    if (recv != nullptr) out = out + to_f32(recv[r * ld + col]);
    return out;
  }
  __device__ __forceinline__ void pair(int r, int col, float v0,
                                       float v1) const {
    __nv_bfloat162 p;
    p.x = from_f32<bf16>(add(r, col, v0));
    p.y = from_f32<bf16>(add(r, col + 1, v1));
    *reinterpret_cast<__nv_bfloat162*>(dst + r * ld + col) = p;
  }
  __device__ __forceinline__ void one(int r, int col, float v) const {
    dst[r * ld + col] = from_f32<T>(add(r, col, v));
  }
};

// Threads tid of nt copy a rows x cols tile of row stride ld from src to
// dst.
template <typename T>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, int rows,
                                          int cols, long long ld, int tid,
                                          int nt) {
  constexpr int V = 16 / sizeof(T);
  if (cols % V == 0 && ld % V == 0 &&
      ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) &
       15) == 0) {
    const int vc = cols / V;
    for (int e = tid; e < rows * vc; e += nt) {
      const long long o = (e / vc) * ld + (e % vc) * V;
      *reinterpret_cast<uint4*>(dst + o) =
          *reinterpret_cast<const uint4*>(src + o);
    }
  } else {
    for (int e = tid; e < rows * cols; e += nt) {
      const long long o = (e / cols) * ld + e % cols;
      dst[o] = src[o];
    }
  }
}

// Thread 0 releases `sig` once every thread's stores are done.
__device__ __forceinline__ void release_after_block(unsigned long long* sig,
                                                    unsigned long long epoch) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    tdt_signal_release(sig, epoch);
  }
}

// Step s of tile t (row tile, column tile) of the tile bodies' ring over
// tiles of BM x BN: its chunk c, rows from row0, columns [col0, col0 +
// cols) and direction d (+1 or -1, mod world); `last`: the rank's own
// chunk, into the output. The ring deals item i = s * tiles + t, step by
// step, so a wait (step s - 1 of the same tile, on the neighbour) is on an
// item of an earlier step, which every block reaches first. Each step
// reads the rank's whole shard of B again (Qwen3-8B's down: 25 MB a rank,
// 100 MB a step over W = 4, twice the L2). Dealt tile by tile, the steps
// of a tile share B's tiles through L2, but each waits on the one before
// it in the same wave: the W = 4 o_proj and down rings took 0.135 and
// 0.190 ms on an H100 against 0.072 and 0.180 dealt step by step (odd
// steps walked backwards: 0.076 and 0.178).
struct RsItem {
  int s, t, c, row0, col0, cols, d;
  bool last;
};
template <typename T, int BM, int BN>
__device__ __forceinline__ RsItem rs_item(const RsArgs<T>& a, int me, int s,
                                          int t) {
  const int ct0 = (a.split + BN - 1) / BN;
  const int col_tiles = ct0 + (a.N - a.split + BN - 1) / BN;
  RsItem it;
  it.s = s;
  it.t = t;
  const int ctj = t % col_tiles;
  const bool fwd = ctj < ct0;
  it.col0 = fwd ? ctj * BN : a.split + (ctj - ct0) * BN;
  it.cols = min(BN, (fwd ? a.split : a.N) - it.col0);
  it.row0 = t / col_tiles * BM;
  it.last = s == a.world - 1;
  it.d = fwd ? 1 : a.world - 1;
  it.c = it.last ? me : (me + (a.world - it.d) * (s + 1)) % a.world;
  return it;
}

// Tiles a chunk has (a ring step's items).
template <int BM, int BN>
__device__ __forceinline__ int rs_tiles(int rows, int N, int split) {
  return (rows + BM - 1) / BM *
         ((split + BN - 1) / BN + (N - split + BN - 1) / BN);
}

// The FMA tile body (f32 and odd bf16 shapes). Signals of a rank: (W - 1,
// tiles) ring steps.
template <typename T>
__global__ void __launch_bounds__(kFmThreads, 1) rs_ring_kernel(RsArgs<T> a) {
  const int world = a.world;
  const int me = tdt_rank(a.bpr);
  const int j = static_cast<int>(blockIdx.x) % a.bpr;
  const int N = a.N;
  const int tiles = rs_tiles<kFmBM, kFmBN>(a.rows, N, a.split);
  const long long slab = static_cast<long long>(a.rows) * N;
  unsigned long long* sig_me =
      reinterpret_cast<unsigned long long*>(tdt_peer_ptr(a.sig_tab, me));
  T* slab_me = reinterpret_cast<T*>(tdt_peer_ptr(a.slab_tab, me));

  // The ring reduce-scatter; item (step, row tile, column tile).
  for (int i = j; i < world * tiles; i += a.bpr) {
    const RsItem it = rs_item<T, kFmBM, kFmBN>(a, me, i / tiles, i % tiles);
    const T* recv = nullptr;
    if (it.s > 0) {
      tdt_signal_wait_until(sig_me + (it.s - 1) * tiles + it.t, a.epoch);
      recv = slab_me + (it.s - 1) * slab +
             static_cast<long long>(it.row0) * N + it.col0;
    }
    Tile<T> tile;
    tile.a = a.a + static_cast<long long>(it.c * a.rows + it.row0) * a.K +
             static_cast<long long>(me) * a.kl;
    tile.lda = a.K;
    tile.b = a.b + static_cast<long long>(me) * a.kl * N + it.col0;
    tile.bu = nullptr;
    tile.ldb = N;
    tile.bias_g = nullptr;
    tile.bias_u = nullptr;
    tile.rows = min(kFmBM, a.rows - it.row0);
    tile.cols = it.cols;
    tile.K = a.kl;
    const long long at =
        static_cast<long long>(it.c * a.rows + it.row0) * N + it.col0;
    if (!it.last) {
      const int peer = (me + it.d) % world;
      T* dst = reinterpret_cast<T*>(tdt_peer_ptr(a.slab_tab, peer)) +
               it.s * slab + static_cast<long long>(it.row0) * N + it.col0;
      unsigned long long* sig = reinterpret_cast<unsigned long long*>(
          tdt_peer_ptr(a.sig_tab, peer)) + it.s * tiles + it.t;
      if (a.fault && it.s == 0 && it.c == 0) {
        release_after_block(sig, a.epoch);
        continue;
      }
      fma_tile<T, false>(tile, RsEpi<T>{recv, dst, N});
      release_after_block(sig, a.epoch);
    } else if (!a.ag) {
      fma_tile<T, false>(tile, RsEpi<T>{recv, a.out + at, N});
    } else {
      T* own = a.out + static_cast<long long>(me) * world * slab;
      fma_tile<T, false>(tile, RsEpi<T>{recv, own + at, N});
      unsigned long long* ag_me = reinterpret_cast<unsigned long long*>(
          tdt_peer_ptr(a.ag_tab, me));
      release_after_block(ag_me + me * tiles + it.t, a.epoch);
    }
  }
  if (!a.ag) return;

  // GEMM-AR: the ring all-gather; item (hop, row tile, column tile). Hop h
  // forwards chunk (me - h) from my buffer to my right neighbour's.
  T* own = a.out + static_cast<long long>(me) * world * slab;
  const unsigned long long* ag_me =
      reinterpret_cast<unsigned long long*>(tdt_peer_ptr(a.ag_tab, me));
  const int right = (me + 1) % world;
  T* right_out = a.out + static_cast<long long>(right) * world * slab;
  unsigned long long* ag_right =
      reinterpret_cast<unsigned long long*>(tdt_peer_ptr(a.ag_tab, right));
  for (int i = j; i < (world - 1) * tiles; i += a.bpr) {
    const RsItem it = rs_item<T, kFmBM, kFmBN>(a, me, 0, i % tiles);
    const int c = (me - i / tiles + world) % world;
    tdt_signal_wait_until(ag_me + c * tiles + it.t, a.epoch);
    const long long at =
        static_cast<long long>(c * a.rows + it.row0) * N + it.col0;
    copy_tile(right_out + at, own + at, min(kFmBM, a.rows - it.row0),
              it.cols, N, threadIdx.x, blockDim.x);
    release_after_block(ag_right + c * tiles + it.t, a.epoch);
  }
}

// The tensor-core tile's views: rank r's column shard of A as (kl, rows,
// chunk), so TMA fills K past kl and rows past a chunk with zeros, and B's
// row shards as (N, kl, rank). A kernel parameter of at most 4 KB holds
// the views of kRsMaxWorld ranks.
constexpr int kRsMaxWorld = 24;
struct RsViews {
  CUtensorMap a[kRsMaxWorld];
  CUtensorMap b;
};

// The consumer threads' counterparts of tdt_signal_wait_until and
// release_after_block (the producer warpgroup never reaches them).
__device__ __forceinline__ void consumers_wait(const unsigned long long* sig,
                                               unsigned long long epoch) {
  if (threadIdx.x == 128) {
    while (tdt_signal_acquire(sig) != epoch) __nanosleep(64);
    __threadfence();
  }
  consumers_sync();
}
__device__ __forceinline__ void consumers_release(unsigned long long* sig,
                                                  unsigned long long epoch) {
  consumers_sync();
  if (threadIdx.x == 128) {
    __threadfence();
    tdt_signal_release(sig, epoch);
  }
}

// The tensor-core tile body (bf16): tiles.cuh's wgmma tile on the ring
// above. Thread 0 loads each item's K slices by TMA (A and B are inputs:
// no signal orders them); the two consumer warpgroups run the products,
// then (s > 0) wait for the travelling sum in my slab s - 1, which the
// epilogue adds, so the wait overlaps the products; they release the
// item's signal, and in GEMM-AR run the all-gather.
__global__ void __launch_bounds__(kPfThreads, 1)
rs_ring_wg_kernel(RsArgs<bf16> a, const __grid_constant__ RsViews views) {
  extern __shared__ unsigned char smem_raw[];
  const WgSmem sm = wg_smem(smem_raw);
  wg_init(sm);
  __syncthreads();
  const int world = a.world;
  const int me = tdt_rank(a.bpr);
  const int j = static_cast<int>(blockIdx.x) % a.bpr;
  const int N = a.N;
  const int tiles = rs_tiles<kPfBM, kPfBN>(a.rows, N, a.split);
  const int nk = (a.kl + kPfBK - 1) / kPfBK;
  if (threadIdx.x < 128) {
    wg_producer_regs();
    if (threadIdx.x != 0) return;
    WgPipe p;
    const CUtensorMap* av = &views.a[me];
    for (int i = j; i < world * tiles; i += a.bpr) {
      const RsItem it = rs_item<bf16, kPfBM, kPfBN>(a, me, i / tiles,
                                                     i % tiles);
      if (a.fault && it.s == 0 && it.c == 0) continue;
      wg_load(sm, p, {av, 0, it.row0, it.c, 0},
              {&views.b, it.col0, 0, me, 0},
              {&views.b, it.col0 + 64, 0, me, 0}, nk);
    }
    return;
  }
  wg_consumer_regs();
  const long long slab = static_cast<long long>(a.rows) * N;
  const unsigned long long* sig_me =
      reinterpret_cast<unsigned long long*>(tdt_peer_ptr(a.sig_tab, me));
  const bf16* slab_me =
      reinterpret_cast<const bf16*>(tdt_peer_ptr(a.slab_tab, me));
  bf16* own = a.out + static_cast<long long>(me) * world * slab;
  unsigned long long* ag_me =
      a.ag ? reinterpret_cast<unsigned long long*>(tdt_peer_ptr(a.ag_tab, me))
           : nullptr;
  WgPipe p;
  for (int i = j; i < world * tiles; i += a.bpr) {
    const RsItem it = rs_item<bf16, kPfBM, kPfBN>(a, me, i / tiles,
                                                     i % tiles);
    const bf16* recv =
        it.s > 0 ? slab_me + (it.s - 1) * slab +
                       static_cast<long long>(it.row0) * N + it.col0
                 : nullptr;
    auto ready = [&] {
      if (it.s > 0)
        consumers_wait(sig_me + (it.s - 1) * tiles + it.t, a.epoch);
    };
    const long long at =
        static_cast<long long>(it.c * a.rows + it.row0) * N + it.col0;
    // Where the item's sum goes and the signal it then releases: the right
    // (left) neighbour's slab s, or the output (GEMM-AR: my own buffer,
    // then my all-gather signal).
    bf16* dst = it.last ? (a.ag ? own : a.out) + at
                        : reinterpret_cast<bf16*>(tdt_peer_ptr(
                              a.slab_tab, (me + it.d) % world)) +
                              it.s * slab +
                              static_cast<long long>(it.row0) * N + it.col0;
    unsigned long long* sig =
        !it.last ? reinterpret_cast<unsigned long long*>(tdt_peer_ptr(
                       a.sig_tab, (me + it.d) % world)) +
                       it.s * tiles + it.t
        : a.ag   ? ag_me + me * tiles + it.t
                 : nullptr;
    if (!(a.fault && it.s == 0 && it.c == 0))
      wg_mma<false>(sm, p, nk, min(kPfBM, a.rows - it.row0), it.cols,
                    nullptr, nullptr, RsEpi<bf16>{recv, dst, N}, ready);
    if (sig != nullptr) consumers_release(sig, a.epoch);
  }
  if (!a.ag) return;

  // GEMM-AR: the ring all-gather, as in rs_ring_kernel, by the consumers.
  const int right = (me + 1) % world;
  bf16* right_out = a.out + static_cast<long long>(right) * world * slab;
  unsigned long long* ag_right =
      reinterpret_cast<unsigned long long*>(tdt_peer_ptr(a.ag_tab, right));
  for (int i = j; i < (world - 1) * tiles; i += a.bpr) {
    const RsItem it = rs_item<bf16, kPfBM, kPfBN>(a, me, 0, i % tiles);
    const int c = (me - i / tiles + world) % world;
    consumers_wait(ag_me + c * tiles + it.t, a.epoch);
    const long long at =
        static_cast<long long>(c * a.rows + it.row0) * N + it.col0;
    copy_tile(right_out + at, own + at, min(kPfBM, a.rows - it.row0),
              it.cols, N, static_cast<int>(threadIdx.x) - 128, 256);
    consumers_release(ag_right + c * tiles + it.t, a.epoch);
  }
}

// The decode body (M = W * rows <= kStreamMaxM). R: the m16 fragments of
// stream_mma_block (MMA) or the rows of fma_stream_block. Signals of a
// rank: its product items (column tile, row tile, split), then (W - 1,
// pieces) ring steps.
template <typename T, bool MMA, int R>
__global__ void __launch_bounds__(MMA ? kTcThreads : kFaThreads)
rs_stream_ring_kernel(RsArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kThreads = MMA ? kTcThreads : kFaThreads;
  constexpr int kBM = MMA ? kTcBM : R;
  constexpr int kPer = kStreamMaxRows * kPieceCols / kThreads;
  const int world = a.world;
  const int me = tdt_rank(a.bpr);
  const int j = static_cast<int>(blockIdx.x) % a.bpr;
  const int N = a.N;
  const int M = world * a.rows;
  const int col_tiles = (N + kPieceCols - 1) / kPieceCols;
  const int per_col = (M + kBM - 1) / kBM * a.splits;
  const int prods = col_tiles * per_col;
  unsigned long long* sig_me =
      reinterpret_cast<unsigned long long*>(tdt_peer_ptr(a.sig_tab, me));
  float* ws = reinterpret_cast<float*>(tdt_peer_ptr(a.ws_tab, me));
  const T* A = a.a + static_cast<long long>(me) * a.kl;
  const T* B = a.b + static_cast<long long>(me) * a.kl * N;

  // Phase 0: my f32 partial of all M rows; item (column tile, row tile,
  // split), into ws[split, m, n].
  for (int i = j; i < prods; i += a.bpr) {
    const int t = i / per_col;
    const int mt = i % per_col / a.splits;
    const int z = i % a.splits;
    __syncthreads();                       // the last item's smem is free
    if constexpr (MMA) {
      Segs<bf16> segs = {};
      segs.b[0] = B;
      segs.n[0] = N;
      segs.ld[0] = N;
      segs.col0[1] = N;
      segs.tile0[1] = col_tiles;
      segs.count = 1;
      stream_mma_block<R>(A, a.K, segs, ws, M, a.kl, a.k_per_split, false, t,
                          mt, z, smem_raw);
    } else {
      const bool vec = N % kFaCPT == 0 &&
                       (reinterpret_cast<uintptr_t>(B) & 15) == 0;
      fma_stream_block<T, R>(A, a.K, B, nullptr, ws, M, N, a.kl,
                             a.k_per_split, false, vec, t, mt, z);
    }
    release_after_block(sig_me + i, a.epoch);
  }

  // Phase 1: the ring, step by step; item (step, piece of the chunk).
  const int ct0 = (a.split + kPieceCols - 1) / kPieceCols;
  const int pieces = ct0 + (N - a.split + kPieceCols - 1) / kPieceCols;
  const long long slab = static_cast<long long>(a.rows) * N;
  const long long mn = static_cast<long long>(M) * N;
  const T* slab_me = reinterpret_cast<const T*>(tdt_peer_ptr(a.slab_tab, me));
  for (int i = j; i < world * pieces; i += a.bpr) {
    const int s = i / pieces;
    const int p = i % pieces;
    const bool fwd = p < ct0;
    const int col0 = fwd ? p * kPieceCols : a.split + (p - ct0) * kPieceCols;
    const int cols = min(kPieceCols, (fwd ? a.split : N) - col0);
    const bool last = s == world - 1;
    const int d = fwd ? 1 : world - 1;          // +1 or -1, mod world
    const int c = last ? me : (me + (world - d) * (s + 1)) % world;
    const int n_el = a.rows * cols;
    // My partial of the piece, before any wait on the neighbour: the splits
    // of its product tiles summed in split order, rounded once.
    const int t0 = col0 / kPieceCols;
    const int t1 = (col0 + cols - 1) / kPieceCols;
    tdt_signal_wait_all(sig_me + t0 * per_col, (t1 - t0 + 1) * per_col,
                        a.epoch);
    float part[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int e = threadIdx.x + q * kThreads;
      if (e < n_el) {
        const float* w = ws + static_cast<long long>(c * a.rows + e / cols) *
                                  N + col0 + e % cols;
        float v = w[0];
        if (a.splits > 1) {
          v = 0.f;
          for (int z = 0; z < a.splits; ++z) v += w[z * mn];
        }
        part[q] = to_f32(from_f32<T>(v));
      }
    }
    const T* recv = nullptr;
    if (s > 0) {
      tdt_signal_wait_until(sig_me + prods + (s - 1) * pieces + p, a.epoch);
      recv = slab_me + (s - 1) * slab;
    }
    const int peer = (me + d) % world;
    if (!(a.fault && s == 0 && c == 0)) {
      T* dst = last ? (a.ag ? nullptr : a.out + c * slab)
                    : reinterpret_cast<T*>(tdt_peer_ptr(a.slab_tab, peer)) +
                          s * slab;
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int e = threadIdx.x + q * kThreads;
        if (e < n_el) {
          const long long at =
              static_cast<long long>(e / cols) * N + col0 + e % cols;
          float v = part[q];
          if (recv != nullptr) v = v + to_f32(recv[at]);
          const T x = from_f32<T>(v);
          if (dst != nullptr) {
            dst[at] = x;
          } else {                         // GEMM-AR: every rank's buffer
            for (int r = 0; r < world; ++r)
              a.out[(static_cast<long long>(r) * world + c) * slab + at] = x;
          }
        }
      }
    }
    if (!last)
      release_after_block(reinterpret_cast<unsigned long long*>(
                              tdt_peer_ptr(a.sig_tab, peer)) +
                              prods + s * pieces + p,
                          a.epoch);
  }
}

// A kernel of this file with its block size, dynamic shared memory and
// whether it takes the TMA views.
struct WgKernel {
  using T = bf16;
  static constexpr int threads = kPfThreads;
  static constexpr int smem = kPfSmemBytes;
  static constexpr bool views = true;
  static const void* fn() {
    return reinterpret_cast<const void*>(rs_ring_wg_kernel);
  }
};

template <typename T_>
struct TileKernel {
  using T = T_;
  static constexpr int threads = kFmThreads;
  static constexpr int smem = 0;
  static constexpr bool views = false;
  static const void* fn() {
    return reinterpret_cast<const void*>(rs_ring_kernel<T>);
  }
};

template <typename T_, bool MMA, int R>
struct StreamKernel {
  using T = T_;
  static constexpr int threads = MMA ? kTcThreads : kFaThreads;
  static constexpr int smem = MMA ? stream_smem_bytes<R>() : 0;
  static constexpr bool views = false;
  static const void* fn() {
    return reinterpret_cast<const void*>(rs_stream_ring_kernel<T, MMA, R>);
  }
};

// Blocks of kernel K resident at once on the current device.
template <typename K>
cudaError_t resident(int* out) {
  static int cached = -1;
  if (cached < 0) {
    int dev = 0, sms = 0, per_sm = 0, coop = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(K::fn(),
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 K::smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, K::fn(), K::threads, K::smem);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    cached = sms * per_sm;
  }
  *out = cached;
  return cudaSuccess;
}

// One cooperative launch of kernel K over `blocks` blocks with the given
// kernel parameters.
template <typename K, typename... P>
cudaError_t launch(int blocks, cudaStream_t stream, const P&... params) {
  cudaError_t err = cudaFuncSetAttribute(
      K::fn(), cudaFuncAttributeMaxDynamicSharedMemorySize, K::smem);
  if (err != cudaSuccess) return err;
  void* args[] = {const_cast<void*>(static_cast<const void*>(&params))...};
  err = cudaLaunchCooperativeKernel(K::fn(), dim3(blocks), dim3(K::threads),
                                    args, K::smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Calls f with the kernel (a WgKernel, TileKernel or StreamKernel value)
// that runs a launch of `path` in dtype (0: bf16, 1: f32) over M = world *
// rows rows,
// kl columns of A per rank and n of B; the decode body's variant is the
// one gemm_ar.cu's world-1 plan runs on a rank's shard.
template <typename F>
cudaError_t with_kernel(int dtype, int path, int M, int kl, int n, F&& f) {
  if (path != kPathStream) {
    if (dtype == 0)
      return path == kPathMma ? f(WgKernel{}) : f(TileKernel<bf16>{});
    return f(TileKernel<float>{});
  }
  if (stream_mma_ok(dtype, n, kl)) {
    switch (stream_frags(M)) {
      case 1: return f(StreamKernel<bf16, true, 1>{});
      case 2: return f(StreamKernel<bf16, true, 2>{});
      default: return f(StreamKernel<bf16, true, 4>{});
    }
  }
  switch (fma_rows(M)) {
    case 1: return dtype == 0 ? f(StreamKernel<bf16, false, 1>{})
                              : f(StreamKernel<float, false, 1>{});
    case 2: return dtype == 0 ? f(StreamKernel<bf16, false, 2>{})
                              : f(StreamKernel<float, false, 2>{});
    case 4: return dtype == 0 ? f(StreamKernel<bf16, false, 4>{})
                              : f(StreamKernel<float, false, 4>{});
    default: return dtype == 0 ? f(StreamKernel<bf16, false, 8>{})
                               : f(StreamKernel<float, false, 8>{});
  }
}

bool path_ok(int dtype, int path, int world, int rows, int kl, int n,
             int split) {
  if (world < 2 || rows < 1 || kl < 1 || n < 1 || split < 0 || split > n ||
      (dtype != 0 && dtype != 1))
    return false;
  if (path == kPathStream) return world * rows <= kStreamMaxM;
  if (path == kPathMma)
    return dtype == 0 && kl % 8 == 0 && n % 8 == 0 && split % 8 == 0 &&
           world <= kRsMaxWorld;
  return path == kPathFma;
}

}  // namespace

extern "C" {

// Blocks per rank of a `world`-rank launch of `path` (0: FMA tile, 1:
// tensor-core tile, 2: decode body) in dtype (0: bf16, 1: f32) over rows
// rows a chunk, kl columns of A a rank and n of B. Returns a cudaError_t.
int tdt_rs_ring_grid(int dtype, int path, int world, int rows, int kl, int n,
                     int* bpr) {
  if (bpr == nullptr || !path_ok(dtype, path, world, rows, kl, n, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  int res = 0;
  const cudaError_t err =
      with_kernel(dtype, path, world * rows, kl, n,
                  [&](auto k) { return resident<decltype(k)>(&res); });
  if (err != cudaSuccess) return static_cast<int>(err);
  if (res / world < 1)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  *bpr = res / world;
  return static_cast<int>(cudaSuccess);
}

// The sizes of one launch on a card with `sms` SMs: *pieces, the signals
// of one ring step (the tiles of a chunk; decode: its 64-column pieces);
// *prods, the product signals of a rank (decode: column tiles x row tiles
// x K splits; tiles: 0); *ws, the f32 workspace of a rank (decode: splits
// x M x n; tiles: 0). A rank needs prods + (world - 1) * pieces signals,
// and the tile body's GEMM-AR world * pieces more. Returns a cudaError_t.
int tdt_rs_ring_tiles(int dtype, int path, int world, int rows, int kl,
                      int n, int split, int sms, int* pieces, int* prods,
                      long long* ws) {
  if (pieces == nullptr || prods == nullptr || ws == nullptr || sms < 1 ||
      !path_ok(dtype, path, world, rows, kl, n, split))
    return static_cast<int>(cudaErrorInvalidValue);
  if (path == kPathStream) {
    const int M = world * rows;
    const StreamPlan sp = stream_plan(M, n, kl, sms, dtype);
    *pieces = (split + kPieceCols - 1) / kPieceCols +
              (n - split + kPieceCols - 1) / kPieceCols;
    *prods = sp.col_tiles * sp.row_tiles * sp.splits;
    *ws = static_cast<long long>(sp.splits) * M * n;
  } else {
    const int bm = path == kPathMma ? kPfBM : kFmBM;
    const int bn = path == kPathMma ? kPfBN : kFmBN;
    *pieces = ((rows + bm - 1) / bm) *
              ((split + bn - 1) / bn + (n - split + bn - 1) / bn);
    *prods = 0;
    *ws = 0;
  }
  return static_cast<int>(cudaSuccess);
}

// One launch of `path` over every rank: a (M, world * kl) column-sharded,
// b (world * kl, n) row-sharded, M = world * rows; columns [0, split) ride
// the forward ring, [split, n) the mirrored one. slab_tab / sig_tab: each
// rank's (world - 1, rows, n) slabs and its signals (tdt_rs_ring_tiles);
// ws_tab (decode body): each rank's f32 workspace. ag = 0: the row-sharded
// result goes to out (M, n). ag = 1 (GEMM-AR): out (world, M, n) holds
// each rank's output, and every one ends holding the whole reduced result;
// ag_tab (tile body only) each rank's (world, tiles) signals. `sms`: the
// card's SMs, as tdt_rs_ring_tiles was given. Returns a cudaError_t.
int tdt_rs_ring(int dtype, int path, const void* a, const void* b, void* out,
                const void* slab_tab, const void* sig_tab, const void* ws_tab,
                const void* ag_tab, int ag, int world,
                int rows, int kl, int n, int split, int sms,
                unsigned long long epoch, int fault, void* stream) {
  const bool stream_path = path == kPathStream;
  if (a == nullptr || b == nullptr || out == nullptr || slab_tab == nullptr ||
      sig_tab == nullptr || epoch == 0 || sms < 1 ||
      !path_ok(dtype, path, world, rows, kl, n, split) ||
      (stream_path && ws_tab == nullptr) ||
      (ag && !stream_path && ag_tab == nullptr) ||
      (path == kPathMma && !(aligned16(a) && aligned16(b))))
    return static_cast<int>(cudaErrorInvalidValue);
  int bpr = 0;
  const int err = tdt_rs_ring_grid(dtype, path, world, rows, kl, n, &bpr);
  if (err != 0) return err;
  const int M = world * rows;
  const StreamPlan sp = stream_plan(M, n, kl, sms, dtype);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = with_kernel(dtype, path, M, kl, n, [&](auto k) {
    using K = decltype(k);
    using T = typename K::T;
    RsArgs<T> args = {};
    args.a = static_cast<const T*>(a);
    args.b = static_cast<const T*>(b);
    args.out = static_cast<T*>(out);
    args.slab_tab = static_cast<const long long*>(slab_tab);
    args.sig_tab = static_cast<const long long*>(sig_tab);
    args.ws_tab = static_cast<const long long*>(ws_tab);
    args.ag_tab = static_cast<const long long*>(ag_tab);
    args.world = world;
    args.rows = rows;
    args.K = world * kl;
    args.kl = kl;
    args.N = n;
    args.split = split;
    args.ag = ag;
    args.bpr = bpr;
    args.fault = fault;
    args.splits = sp.splits;
    args.k_per_split = sp.k_per_split;
    args.epoch = epoch;
    if constexpr (K::views) {
      RsViews v = {};
      cudaError_t err = cudaSuccess;
      const long long ld = static_cast<long long>(world) * kl;
      for (int r = 0; err == cudaSuccess && r < world; ++r)
        err = make_view(&v.a[r], static_cast<const bf16*>(a) + r * kl,
                        {kl, rows, world, 1},
                        {ld, ld * rows, ld * rows * world}, kPfBM);
      if (err == cudaSuccess)
        err = make_view(&v.b, b, {n, kl, world, 1},
                        {n, static_cast<long long>(n) * kl, ld * n}, 64);
      if (err != cudaSuccess) return err;
      return launch<K>(world * bpr, s, args, v);
    } else {
      return launch<K>(world * bpr, s, args);
    }
  });
  return static_cast<int>(e);
}

// The runtime's message for an error code returned above.
const char* tdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
