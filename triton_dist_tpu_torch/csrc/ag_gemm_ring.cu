// The ring all-gather fused with GEMM (AG-GEMM, AG-SwiGLU) for Hopper
// (sm_90a), every rank of one card in one cooperative launch.
//
// Replaces, at world W > 1, the ring halves of
//  * triton_dist_tpu/ops/allgather_gemm.py::_ag_gemm_kernel (:211),
//    ::_ag_gemm_hbm_nb_kernel (:265) and ::_ag_gemm_hbm_kernel (:379), the
//    variants `ag_gemm_multi` (:643) picks; the products of each output row
//    block are one chunk's full-K product in every variant, so they compute
//    one function;
//  * ::_ag_swiglu_hbm_kernel (:954), the gate and up products of the
//    gathered A with the bias + SwiGLU epilogue.
//
// What it computes, for every rank r at once: A (M, K) is row-sharded, rank
// r's rows [r * rows, (r + 1) * rows) are chunk r; each B_i (K, N_i) and
// C_i (M, N_i) are column-sharded, rank r's columns [r * n_i, (r + 1) * n_i).
// Afterwards C_i[:, rank r's columns] = gathered A @ B_i[:, rank r's
// columns] (f32 sum, one rounding), or act = silu(A @ Wg + bg) * (A @ Wu +
// bu) for the SwiGLU. Shards are read and written in place.
//
// The protocol, the Pallas kernel's on one card, shared by both bodies:
//  * Grid: `bpr` blocks for each of the W ranks, launched cooperatively, so
//    every block is resident (a block that spins on a peer's signal never
//    starves the peer of an SM); `bpr` comes from the body's occupancy on
//    this card (tdt_ag_ring_grid) and a launch that does not fit fails.
//  * Workspace: each rank has its own (M, K) buffer (JAX's ag_hbm), found
//    through a table of addresses. Phase 0: rank r copies its shard into
//    slot r of its own workspace (JAX :293-297).
//  * Phase 1, the ring: rank r pushes chunks to its right neighbour hop by
//    hop (and, with two directions, to its left one: ring_hop_counts), in
//    pieces of about 32 KiB. A push waits until the piece has arrived in
//    r's own workspace, copies it into the neighbour's workspace, then
//    releases the (chunk, piece) signal in the neighbour's signal buffer.
//  * The products read A only from their own rank's workspace, after
//    waiting on its piece signals, so the data reaches a rank only through
//    the pushes.
//  * Items are dealt round robin to a rank's blocks, phase by phase and
//    hop by hop, so a wait only ever needs items that come earlier in every
//    block's order: the launch cannot deadlock.
//  * Signals hold the call's epoch and waits compare for equality, so no
//    earlier call's signal satisfies a wait and nothing is reset; stream
//    order separates two calls (their workspaces are reused).
//  * `fault` (a test hook): rank 0's first push to the right skips its
//    copy and still releases its signal; the output must then be wrong.
//
// Two bodies for the products, picked by op, dtype and shape only (the
// port's ring_path):
//
// * Decode (`ag_stream_ring_kernel`): op "gemm", bf16, K and every shard
//   width multiples of 8 and M <= 64, where the world-1 kernel (ag_gemm.cu)
//   runs its decode plan. What bounds it (H100 SXM: 3.35 TB/s): the bytes
//   of B, 50 MB for Qwen3-8B's QKV and 201 MB for its gate|up, so 0.015 /
//   0.060 ms, plus the exchange's fixed cost on one card (the launch and
//   the ring's dependent hops of signals). The tile body below streamed
//   each rank's shard of B once per chunk (W times) through a 128-row
//   tile with one live row. This body gathers all W chunks first, then
//   streams each rank's shard once:
//   - phase 2, the products: items (column tile over all the rank's
//     products, K split), each over all M rows, run gemm_common.cuh's
//     `stream_mma_block` (the world-1 kernel's decode body) with the split
//     count of the world-1 plan of the rank's shard on this card
//     (ag_plan.cuh's make_plan, which also decides the body); each
//     rank deals them from its own block offset, so the blocks that take a
//     second item differ by rank. An item's m16 fragment holds every row,
//     so it waits for all W chunks; it issues its first pipeline stages'
//     copies of B before that wait and its A copies after (the `kBFirst`
//     prologue; the B stream does not depend on the ring). With one split
//     it stores C
//     rounded; otherwise it writes its f32 partial into the rank's
//     products workspace and releases its own signal.
//   - phase 3, the split reduce (more than one split): item (column tile)
//     waits for its splits, sums them in split order and rounds once into
//     C's column shard, as splitk_reduce does, so each rank's columns are
//     bit-equal to the world-1 kernel on (gathered A, its column shard).
// * Tile (every other call: prefill, f32, odd shapes and the SwiGLU):
//   phase 2 deals items (column tile, chunk in ring_chunk_schedule order,
//   row tile), so each B tile streams from HBM about once for all W chunks
//   (dealt chunk first, each rank's 50 MB shard of Qwen3-8B's gate|up was
//   read W times: the W = 4 SwiGLU ring took 0.336 ms on an H100 against
//   0.205 dealt column first). What bounds it: the products, 2 * M * K *
//   sum(N_i) operations, at Qwen3-8B's prefill (M = 512) bound by
//   operations; the ring's W - 1 chunk copies per rank move (W - 1) * M * K
//   bytes of bf16 through HBM (every rank shares the card's memory, so no
//   interconnect is measured). For bf16 with K and every shard width a
//   multiple of 8, `ag_ring_wg_kernel` runs tiles.cuh's wgmma tile, the
//   world-1 kernel's, so each rank's columns are bit-equal to the world-1
//   kernel on the gathered A and its column shard: a block of 384 threads,
//   one an SM, all of them pushing in the gather, then warp 0 feeding the
//   tiles' K slices by TMA and two warpgroups multiplying. A reads through
//   one 4-D view of every rank's workspace (K, rows, chunk, rank), so a
//   tile's rows past its chunk read as zeros; warp 0 acquires a chunk's
//   piece signals before the first TMA read of it, behind a
//   fence.proxy.async. At Qwen3-8B's QKV a rank has 48 tiles on 33 blocks
//   (W = 4: 1.45 waves); at W = 8 a chunk is 64 rows, half a 128-row tile.
//   Otherwise `ag_ring_kernel` runs the FMA tile; a block waits on every
//   piece signal of a chunk before it reads the chunk.
//
// Plain C entry points, loaded with ctypes. A launch runs on the stream it
// is given, allocates nothing and returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ag_plan.cuh"
#include "shmem.cuh"
#include "tiles.cuh"

namespace {

// Body of a launch: the tiles (0: FMA, 1: tensor cores) or the decode body.
constexpr int kPathFma = 0;
constexpr int kPathMma = 1;
constexpr int kPathStream = 2;

template <typename T>
struct AgArgs {
  const T* x;                 // (M, K) global A, row-sharded
  const long long* ws_tab;    // (W,) rank workspaces, (M, K) each
  const long long* sig_tab;   // (W,) rank signals: (W chunks, pieces), then
                              // the decode body's (column tiles, splits)
  const long long* prod_tab;  // decode, splits > 1: (W,) rank f32 products,
                              // (splits, M, sum n_i) each
  Segs<T> segs;               // b, c: the global (K, N_i) and (M, N_i); n:
                              // the shard widths; ld: N_i; tile0: the body's
                              // column tiles
  const T* bu;                // SwiGLU: Wu, like b[0]
  const T* bias_g;            // SwiGLU: (N,) biases or null
  const T* bias_u;
  long long piece_bytes;
  int world, rows, K, pieces, n_fwd, n_bwd, dirs, bpr, fault;
  int splits, k_per_split;    // decode: the world-1 plan of a rank's shard
  unsigned long long epoch;
};

// ring_chunk_schedule (ops/common.py) on ints: the chunk rank `me`
// consumes at position s.
__device__ __forceinline__ int schedule_chunk(int me, int s, int world,
                                              int dirs) {
  if (dirs == 1 || world <= 2) return (me - s + world) % world;
  const int n_bwd = (world - 1) / 2;
  const bool in_alt = s <= 2 * n_bwd;
  const bool is_bwd = in_alt && s % 2 == 0 && s > 0;
  const int off = in_alt ? (is_bwd ? s / 2 : (s + 1) / 2) : s - n_bwd;
  return ((is_bwd ? me + off : me - off) % world + world) % world;
}

// Phases 0 and 1 of both bodies, block j of rank `me`: my shard into slot
// `me` of my workspace, then the ring, hop by hop; item (hop, direction,
// piece).
template <typename T>
__device__ __forceinline__ void gather(const AgArgs<T>& a, int me, int j) {
  const int world = a.world;
  const long long chunk_bytes =
      static_cast<long long>(a.rows) * a.K * static_cast<long long>(sizeof(T));
  const int P = a.pieces;
  unsigned char* ws_me = tdt_peer_ptr(a.ws_tab, me);
  unsigned long long* sig_me =
      reinterpret_cast<unsigned long long*>(tdt_peer_ptr(a.sig_tab, me));

  auto piece = [&](int p, long long* off, long long* len) {
    *off = p * a.piece_bytes;
    const long long end = *off + a.piece_bytes;
    *len = (end < chunk_bytes ? end : chunk_bytes) - *off;
  };

  const unsigned char* x = reinterpret_cast<const unsigned char*>(a.x);
  for (int p = j; p < P; p += a.bpr) {
    long long off, len;
    piece(p, &off, &len);
    tdt_putmem_signal_block(ws_me + me * chunk_bytes + off,
                            x + me * chunk_bytes + off, len,
                            sig_me + me * P + p, a.epoch);
  }

  const int hops = a.n_fwd > a.n_bwd ? a.n_fwd : a.n_bwd;
  for (int i = j; i < hops * 2 * P; i += a.bpr) {
    const int hop = i / (2 * P);
    const int d = (i / P) % 2;
    const int p = i % P;
    if (hop >= (d == 0 ? a.n_fwd : a.n_bwd)) continue;
    const int c = ((d == 0 ? me - hop : me + hop) % world + world) % world;
    const int peer = (d == 0 ? me + 1 : me - 1 + world) % world;
    tdt_signal_wait_until(sig_me + c * P + p, a.epoch);
    long long off, len;
    piece(p, &off, &len);
    unsigned long long* sig_peer = reinterpret_cast<unsigned long long*>(
        tdt_peer_ptr(a.sig_tab, peer)) + c * P + p;
    if (a.fault && me == 0 && hop == 0 && d == 0) {
      __syncthreads();
      if (threadIdx.x == 0) tdt_signal_release(sig_peer, a.epoch);
      continue;
    }
    tdt_putmem_signal_block(tdt_peer_ptr(a.ws_tab, peer) + c * chunk_bytes +
                                off,
                            ws_me + c * chunk_bytes + off, len, sig_peer,
                            a.epoch);
  }
}

// Phase 2 of the tile bodies: my tiles; item i = (column tile, position in
// the chunk schedule, row tile), chunk and row tile fastest, so the blocks
// at work share B's column tiles through L2 (a column tile's every chunk
// reads the same columns of B). Item i's chunk, row tile and column tile.
struct AgItem {
  int c, rt, ct;
};
template <typename T>
__device__ __forceinline__ AgItem ag_item(const AgArgs<T>& a, int me, int i,
                                          int row_tiles) {
  const int per_col = a.world * row_tiles;
  return {schedule_chunk(me, i % per_col / row_tiles, a.world, a.dirs),
          i % row_tiles, i / per_col};
}

// The FMA tile body (f32 and odd bf16 shapes).
template <typename T, bool SWIGLU>
__global__ void __launch_bounds__(kFmThreads, 1) ag_ring_kernel(AgArgs<T> a) {
  const int world = a.world;
  const int me = tdt_rank(a.bpr);
  const int j = static_cast<int>(blockIdx.x) % a.bpr;
  gather(a, me, j);

  const int P = a.pieces;
  const unsigned long long* sig_me =
      reinterpret_cast<unsigned long long*>(tdt_peer_ptr(a.sig_tab, me));
  const int row_tiles = (a.rows + kFmBM - 1) / kFmBM;
  const int col_tiles = seg_field(a.segs.tile0, a.segs.count);
  const int per_chunk = row_tiles * col_tiles;
  const T* ws = reinterpret_cast<const T*>(tdt_peer_ptr(a.ws_tab, me));
  for (int i = j; i < world * per_chunk; i += a.bpr) {
    const AgItem it = ag_item(a, me, i, row_tiles);
    tdt_signal_wait_all(sig_me + it.c * P, P, a.epoch);
    const int seg = seg_of_tile(a.segs, it.ct);
    const int n_loc = seg_field(a.segs.n, seg);
    const long long ld = seg_field(a.segs.ld, seg);
    const int n0 = (it.ct - seg_field(a.segs.tile0, seg)) * kFmBN;
    const int m0 = it.c * a.rows + it.rt * kFmBM;
    const long long col = static_cast<long long>(me) * n_loc + n0;
    Tile<T> t;
    t.a = ws + static_cast<long long>(m0) * a.K;
    t.lda = a.K;
    t.b = seg_field(a.segs.b, seg) + col;
    t.bu = SWIGLU ? a.bu + col : nullptr;
    t.ldb = ld;
    t.bias_g = a.bias_g != nullptr ? a.bias_g + col : nullptr;
    t.bias_u = a.bias_u != nullptr ? a.bias_u + col : nullptr;
    t.rows = min(kFmBM, a.rows - it.rt * kFmBM);
    t.cols = min(kFmBN, n_loc - n0);
    t.K = a.K;
    const StoreEpi<T> epi{seg_field(a.segs.c, seg) + m0 * ld + col, ld};
    fma_tile<T, SWIGLU>(t, epi);
  }
}

// The tensor-core tile body (bf16): tiles.cuh's wgmma tile. views.a is the
// 4-D view (K, rows, chunk, rank) of every rank's workspace, so TMA fills a
// tile's rows past its chunk with zeros; views.b / bu the global weights.
// After the gather, warp 0 waits for a chunk's piece signals (spread over
// its lanes) before its first tile of that chunk, and its lane 0 orders
// those acquires before the TMA reads (fence.proxy.async: the pieces were
// written by generic stores) and issues the loads; the consumer
// warpgroups never wait on a signal.
template <bool SWIGLU>
__global__ void __launch_bounds__(kPfThreads, 1)
ag_ring_wg_kernel(AgArgs<bf16> a, const __grid_constant__ TileViews views) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int BN = SWIGLU ? kPfBNSwiglu : kPfBN;
  const WgSmem s = wg_smem(smem_raw);
  wg_init(s);
  const int world = a.world;
  const int me = tdt_rank(a.bpr);
  const int j = static_cast<int>(blockIdx.x) % a.bpr;
  gather(a, me, j);
  __syncthreads();

  const int P = a.pieces;
  const int row_tiles = (a.rows + kPfBM - 1) / kPfBM;
  const int col_tiles = seg_field(a.segs.tile0, a.segs.count);
  const int per_chunk = row_tiles * col_tiles;
  const int nk = (a.K + kPfBK - 1) / kPfBK;
  if (threadIdx.x < 128) {
    wg_producer_regs();
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x;
    const unsigned long long* sig_me =
        reinterpret_cast<unsigned long long*>(tdt_peer_ptr(a.sig_tab, me));
    WgPipe p;
    int ready = -1;                          // the chunk last waited for
    for (int i = j; i < world * per_chunk; i += a.bpr) {
      const AgItem it = ag_item(a, me, i, row_tiles);
      if (it.c != ready) {
        for (int q = lane; q < P; q += 32)
          while (tdt_signal_acquire(sig_me + it.c * P + q) != a.epoch)
            __nanosleep(64);
        __threadfence();
        __syncwarp();
        ready = it.c;
      }
      if (lane == 0) {
        fence_proxy_async();
        const int seg = seg_of_tile(a.segs, it.ct);
        const int col = me * seg_field(a.segs.n, seg) +
                        (it.ct - seg_field(a.segs.tile0, seg)) * BN;
        const CUtensorMap* b = seg_view(views, seg);
        const WgBox b1 = SWIGLU ? WgBox{&views.bu, col, 0, 0, 0}
                                : WgBox{b, col + 64, 0, 0, 0};
        wg_load(s, p, {&views.a, 0, it.rt * kPfBM, it.c, me},
                {b, col, 0, 0, 0}, b1, nk);
      }
      __syncwarp();
    }
    return;
  }
  wg_consumer_regs();
  WgPipe p;
  for (int i = j; i < world * per_chunk; i += a.bpr) {
    const AgItem it = ag_item(a, me, i, row_tiles);
    const int seg = seg_of_tile(a.segs, it.ct);
    const int n_loc = seg_field(a.segs.n, seg);
    const long long ld = seg_field(a.segs.ld, seg);
    const int n0 = (it.ct - seg_field(a.segs.tile0, seg)) * BN;
    const int m0 = it.c * a.rows + it.rt * kPfBM;
    const long long col = static_cast<long long>(me) * n_loc + n0;
    const StoreEpi<bf16> epi{seg_field(a.segs.c, seg) + m0 * ld + col, ld};
    wg_mma<SWIGLU>(s, p, nk, min(kPfBM, a.rows - it.rt * kPfBM),
                   min(BN, n_loc - n0),
                   a.bias_g != nullptr ? a.bias_g + col : nullptr,
                   a.bias_u != nullptr ? a.bias_u + col : nullptr, epi,
                   [] {});
  }
}

// The decode body (M = W * rows <= kTcBM, bf16): MF m16 fragments of
// stream_mma_block, B's first stages issued before the chunk waits.
template <int MF>
__global__ void __launch_bounds__(kTcThreads)
ag_stream_ring_kernel(AgArgs<bf16> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int world = a.world;
  const int me = tdt_rank(a.bpr);
  const int j = static_cast<int>(blockIdx.x) % a.bpr;
  gather(a, me, j);

  const int M = world * a.rows;
  const int tiles = seg_field(a.segs.tile0, a.segs.count);
  const bool direct = a.splits == 1;
  unsigned long long* sig_me =
      reinterpret_cast<unsigned long long*>(tdt_peer_ptr(a.sig_tab, me));
  unsigned long long* prod_sig = sig_me + world * a.pieces;
  float* prods = direct ? nullptr
                        : reinterpret_cast<float*>(tdt_peer_ptr(a.prod_tab,
                                                                me));
  const bf16* A = reinterpret_cast<const bf16*>(tdt_peer_ptr(a.ws_tab, me));
  // My column shard of every product.
  Segs<bf16> segs = a.segs;
#pragma unroll
  for (int i = 0; i < kMaxSegs; ++i) {
    const long long col = static_cast<long long>(me) * segs.n[i];
    segs.b[i] += col;
    segs.c[i] += col;
  }
  auto rows_ready = [&] {
    tdt_signal_wait_all(sig_me, world * a.pieces, a.epoch);
  };
  // Phases 2 and 3 deal item i to block (i + me * bpr / W) % bpr: every
  // rank starts at its own block, so the blocks that take a second item,
  // and the SMs they share with the other ranks' blocks, differ by rank.
  const int first = (j + a.bpr - me * a.bpr / world) % a.bpr;

  // Phase 2: item (column tile, split) over all M rows; item i releases
  // product signal i.
  for (int i = first; i < tiles * a.splits; i += a.bpr) {
    const int t = i / a.splits;
    const int z = i % a.splits;
    __syncthreads();                       // the last item's smem is free
    stream_mma_block<MF, true>(A, a.K, segs, prods, M, a.K, a.k_per_split,
                               direct, t, 0, z, smem_raw, rows_ready);
    if (!direct) {
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence();
        tdt_signal_release(prod_sig + i, a.epoch);
      }
    }
  }
  if (direct) return;

  // Phase 3: item (column tile): its splits summed in split order from
  // 0.f and rounded once (splitk_reduce's order).
  const int ncat = seg_width(segs);
  const long long mn = static_cast<long long>(M) * ncat;
  for (int t = first; t < tiles; t += a.bpr) {
    tdt_signal_wait_all(prod_sig + t * a.splits, a.splits, a.epoch);
    const int seg = seg_of_tile(segs, t);
    const int n0 = (t - seg_field(segs.tile0, seg)) * kTcBN;
    const int cols = min(kTcBN, seg_field(segs.n, seg) - n0);
    const long long ld = seg_field(segs.ld, seg);
    const float* w = prods + seg_field(segs.col0, seg) + n0;
    bf16* C = seg_field(segs.c, seg) + n0;
    for (int e = threadIdx.x; e < M * cols; e += kTcThreads) {
      const int m = e / cols;
      const int n = e % cols;
      const float* v = w + static_cast<long long>(m) * ncat + n;
      float s = 0.f;
      for (int z = 0; z < a.splits; ++z) s += v[z * mn];
      C[m * ld + n] = from_f32<bf16>(s);
    }
  }
}

// A kernel of this file with its block size, dynamic shared memory, tile
// width and whether it takes the TMA views.
template <bool SWIGLU>
struct WgKernel {
  using T = bf16;
  static constexpr int threads = kPfThreads;
  static constexpr int smem = kPfSmemBytes;
  static constexpr int bn = SWIGLU ? kPfBNSwiglu : kPfBN;
  static constexpr bool views = true;
  static const void* fn() {
    return reinterpret_cast<const void*>(ag_ring_wg_kernel<SWIGLU>);
  }
};

template <typename T_, bool SWIGLU>
struct TileKernel {
  using T = T_;
  static constexpr int threads = kFmThreads;
  static constexpr int smem = 0;
  static constexpr int bn = kFmBN;
  static constexpr bool views = false;
  static const void* fn() {
    return reinterpret_cast<const void*>(ag_ring_kernel<T, SWIGLU>);
  }
};

template <int MF>
struct StreamKernel {
  using T = bf16;
  static constexpr int threads = kTcThreads;
  static constexpr int smem = stream_smem_bytes<MF>();
  static constexpr int bn = kTcBN;
  static constexpr bool views = false;
  static const void* fn() {
    return reinterpret_cast<const void*>(ag_stream_ring_kernel<MF>);
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
// that runs a launch of `path` for op in dtype (0: bf16, 1: f32) over M
// rows; the decode body's fragments are the world-1 decode plan's for M
// rows.
template <typename F>
cudaError_t with_kernel(int op, int dtype, int path, int M, F&& f) {
  const bool sw = op == kOpSwiglu;
  if (path == kPathStream) {
    switch (stream_frags(M)) {
      case 1: return f(StreamKernel<1>{});
      case 2: return f(StreamKernel<2>{});
      default: return f(StreamKernel<4>{});
    }
  }
  if (dtype == 0 && path == kPathMma)
    return sw ? f(WgKernel<true>{}) : f(WgKernel<false>{});
  if (dtype == 0)
    return sw ? f(TileKernel<bf16, true>{}) : f(TileKernel<bf16, false>{});
  return sw ? f(TileKernel<float, true>{}) : f(TileKernel<float, false>{});
}

// Whether `path` takes op in dtype over M = world * rows rows, depth K and
// shard widths n[0..n_b), from the world-1 plan of one rank's shard
// (make_plan, whose path does not depend on the SM count): the decode body
// exactly where that plan is the decode plan; the tensor-core tile where it
// runs on tensor cores (bf16 with K and every width multiples of 8); the
// FMA tile for any.
bool path_ok(int op, int dtype, int path, int world, int rows, int K,
             int n_b, const int* n) {
  if (world < 2 || rows < 1 || K < 1 ||
      !plan_args_ok(op, world * rows, n_b, n, K, 1, dtype))
    return false;
  const int plan = make_plan(op, world * rows, n_b, n, K, 1, dtype).path;
  if (path == kPathStream) return plan == kPlanDecode;
  if (path == kPathMma) return plan != kPlanFma;
  return path == kPathFma;
}

}  // namespace

extern "C" {

// Blocks per rank of a `world`-rank launch of op (0: products, 1: SwiGLU)
// in dtype (0: bf16, 1: f32) on `path` (0: FMA tile, 1: tensor-core tile,
// 2: decode body over m rows): what is resident at once on this card,
// split evenly over the ranks. Returns a cudaError_t.
int tdt_ag_ring_grid(int op, int dtype, int path, int world, int m,
                     int* bpr) {
  const int n8 = 8;
  if (bpr == nullptr || m < world || m % world != 0 ||
      !path_ok(op, dtype, path, world, m / world, 8, 1, &n8))
    return static_cast<int>(cudaErrorInvalidValue);
  int res = 0;
  const cudaError_t err = with_kernel(
      op, dtype, path, m,
      [&](auto k) { return resident<decltype(k)>(&res); });
  if (err != cudaSuccess) return static_cast<int>(err);
  if (res / world < 1)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  *bpr = res / world;
  return static_cast<int>(cudaSuccess);
}

// The state one launch of `path` needs beyond its (W, pieces) chunk
// signals, on a card with `sms` SMs: *prods, the product signals of a rank
// (decode body with more than one split: column tiles x splits; else 0);
// *ws, the elements of a rank's f32 products workspace (then splits x M x
// (n0 + n1 + n2); else 0). Returns a cudaError_t.
int tdt_ag_ring_sizes(int op, int dtype, int path, int world, int rows,
                      int K, int n_b, int n0, int n1, int n2, int sms,
                      int* prods, long long* ws) {
  const int n[kMaxSegs] = {n0, n1, n2};
  if (prods == nullptr || ws == nullptr || sms < 1 ||
      !path_ok(op, dtype, path, world, rows, K, n_b, n))
    return static_cast<int>(cudaErrorInvalidValue);
  *prods = 0;
  *ws = 0;
  if (path == kPathStream) {
    const Plan p = make_plan(op, world * rows, n_b, n, K, sms, dtype);
    if (p.splits > 1) {
      long long width = 0;
      for (int i = 0; i < n_b; ++i) width += n[i];
      *prods = p.tiles * p.splits;
      *ws = p.splits * world * rows * width;
    }
  }
  return static_cast<int>(cudaSuccess);
}

// One launch of `path` over every rank: x (M, K) row-sharded with rows =
// M / world; b_i (K, world * n_loc_i) and c_i (M, world * n_loc_i)
// column-sharded (op 1: n_b = 1, b0 = Wg, bu = Wu, bg / bias_u the (N,)
// biases or null). ws_tab / sig_tab: device tables of each rank's (M, K)
// workspace and its signals ((world, pieces), then tdt_ag_ring_sizes'
// *prods); ws_base / ws_step: rank 0's workspace and the elements from one
// rank's to the next (the tensor-core tile reads them through a TMA view;
// ws_step a multiple of 8); prod_tab (decode body with *ws > 0) each rank's
// f32 products workspace. Chunks move in `pieces` pieces of piece_bytes (the last may be
// shorter). `sms`: the card's SMs, as tdt_ag_ring_sizes was given.
// `epoch` is greater than every earlier call's on these signals.
// Returns a cudaError_t.
int tdt_ag_ring(int op, int dtype, int path, const void* x,
                const void* ws_tab, const void* sig_tab, const void* ws_base,
                long long ws_step, const void* prod_tab, int n_b, const void* b0,
                const void* b1, const void* b2, void* c0, void* c1, void* c2,
                int n0, int n1, int n2, const void* bu, const void* bg,
                const void* bias_u, int world, int rows, int K, int pieces,
                long long piece_bytes, int dirs, int sms,
                unsigned long long epoch, int fault, void* stream) {
  const void* b[kMaxSegs] = {b0, b1, b2};
  void* c[kMaxSegs] = {c0, c1, c2};
  const int n[kMaxSegs] = {n0, n1, n2};
  const long long elem = dtype == 0 ? 2 : 4;
  bool ok = x != nullptr && ws_tab != nullptr && sig_tab != nullptr &&
            sms >= 1 && path_ok(op, dtype, path, world, rows, K, n_b, n) &&
            pieces >= 1 && piece_bytes >= 16 && piece_bytes % 16 == 0 &&
            static_cast<long long>(pieces) * piece_bytes >=
                static_cast<long long>(rows) * K * elem &&
            (dirs == 1 || dirs == 2) && epoch != 0 &&
            (op != kOpSwiglu ||
             (bu != nullptr && (bg == nullptr) == (bias_u == nullptr))) &&
            (path != kPathMma ||
             (aligned16(ws_base) && aligned16(bu) && ws_step % 8 == 0 &&
              ws_step >= static_cast<long long>(world) * rows * K));
  for (int i = 0; ok && i < n_b; ++i)
    ok = b[i] != nullptr && c[i] != nullptr &&
         (path != kPathMma || aligned16(b[i]));
  // The decode body's K splits: the world-1 decode plan's of a rank's shard.
  const int splits =
      ok && path == kPathStream
          ? make_plan(op, world * rows, n_b, n, K, sms, dtype).splits
          : 1;
  if (!ok || (splits > 1 && prod_tab == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int bpr = 0;
  const int err =
      tdt_ag_ring_grid(op, dtype, path, world, world * rows, &bpr);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = with_kernel(
      op, dtype, path, world * rows, [&](auto k) {
        using Kern = decltype(k);
        using T = typename Kern::T;
        const T* bs[kMaxSegs] = {};
        T* cs[kMaxSegs] = {};
        for (int i = 0; i < n_b; ++i) {
          bs[i] = static_cast<const T*>(b[i]);
          cs[i] = static_cast<T*>(c[i]);
        }
        AgArgs<T> a = {};
        a.x = static_cast<const T*>(x);
        a.ws_tab = static_cast<const long long*>(ws_tab);
        a.sig_tab = static_cast<const long long*>(sig_tab);
        a.prod_tab = static_cast<const long long*>(prod_tab);
        a.segs = make_segs<T>(n_b, bs, cs, n, Kern::bn);
        for (int i = 0; i < n_b; ++i) a.segs.ld[i] = world * n[i];
        a.bu = static_cast<const T*>(bu);
        a.bias_g = static_cast<const T*>(bg);
        a.bias_u = static_cast<const T*>(bias_u);
        a.piece_bytes = piece_bytes;
        a.world = world;
        a.rows = rows;
        a.K = K;
        a.pieces = pieces;
        // ring_hop_counts (ops/common.py).
        a.n_fwd = world - 1;
        a.n_bwd = 0;
        if (dirs == 2 && world > 2) {
          a.n_bwd = (world - 1) / 2;
          a.n_fwd = world - 1 - a.n_bwd;
        }
        a.dirs = dirs;
        a.bpr = bpr;
        a.fault = fault;
        a.splits = splits;
        a.k_per_split = stream_k_per_split(K, splits, 1);
        a.epoch = epoch;
        if constexpr (Kern::views) {
          // Every rank's workspace as one (K, rows, chunk, rank) view; the
          // global weights.
          TileViews v = {};
          cudaError_t err = make_view(
              &v.a, ws_base, {K, rows, world, world},
              {K, static_cast<long long>(rows) * K, ws_step}, kPfBM);
          for (int i = 0; err == cudaSuccess && i < n_b; ++i)
            err = b_view(&v.b[i], b[i], K, a.segs.ld[i], a.segs.ld[i]);
          if (err == cudaSuccess && op == kOpSwiglu)
            err = b_view(&v.bu, bu, K, a.segs.ld[0], a.segs.ld[0]);
          if (err != cudaSuccess) return err;
          return launch<Kern>(world * bpr, s, a, v);
        } else {
          return launch<Kern>(world * bpr, s, a);
        }
      });
  return static_cast<int>(e);
}

// The runtime's message for an error code returned above.
const char* tdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
