// The ring all-gather fused with the grouped (per-expert) GEMM for Hopper
// (sm_90a), every rank of one card in one cooperative launch.
//
// Replaces, at world W > 1, triton_dist_tpu/ops/group_gemm.py::
// _ag_group_gemm_kernel (:139, entry `_ag_group_gemm_fused` :405): the ring
// all-gather of the ranks' token chunks inside the kernel that runs the
// grouped products over them. group_gemm.cu replaces its world-1 half.
//
// What it computes, for every rank r at once: x (M, K) is row-sharded, rank
// r's rows [r * rows, (r + 1) * rows) are chunk r, one expert id per row
// (ids, E the sentinel, run through expert E - 1 as the grouped GEMM runs
// it); w (E, K, N) and c (M, N) are column-sharded, rank r's columns
// [r * n_loc, (r + 1) * n_loc). Afterwards c[:, rank r's columns] =
// grouped(allgather(x), w[:, :, rank r's columns], ids): each row against
// its expert's shard, an f32 sum rounded once. Shards are read and written
// in place: the experts of Qwen3-30B-A3B take ~57 GB of the card's 80 GB.
//
// Two launches a call, on the caller's stream:
//  1. group_gemm.cuh's `group_schedule`, one block per chunk: the expert
//     schedule of each chunk's rows, which the W ranks share. JAX aligns
//     each chunk once, on its owner, and all-gathers the tile experts
//     outside its kernel (:433-436); here one launch reads the global ids.
//     The rows themselves travel only through the ring.
//  2. The cooperative kernel, `bpr` blocks for each of the W ranks (what is
//     resident at once, from this kernel's occupancy on this card,
//     tdt_ag_group_gemm_grid; a launch that does not fit fails), so a block
//     that spins on a peer's signal never starves the peer of an SM. Each
//     rank has its own (M, K) workspace (JAX's ag_hbm) and (W, pieces)
//     signals, found through device tables of addresses. A block walks its
//     rank's items in phase order:
//     * phase 0: rank r copies chunk r of x into slot r of its workspace,
//       in pieces of about 32 KiB, and releases each piece's signal in its
//       own buffer. JAX meets at a barrier here (:161-166) so that no peer
//       receives before it is ready; here a push waits on the piece's own
//       arrival signal instead, as ag_gemm_ring.cu's do;
//     * phase 1, the ring: one direction, to the right, W - 1 hops (JAX's
//       `chunk_copy` :177, `ring_advance` :208): at hop h rank r pushes
//       chunk r - h. A push waits until the piece has arrived in r's own
//       workspace, copies it into the neighbour's, then releases the
//       (chunk, piece) signal in the neighbour's buffer: one signal per
//       chunk and piece, as JAX has one semaphore per chunk
//       (`send_sem.at[idx]`);
//     * phase 2, the products: rank r's items, each (row tile, column
//       item) of a chunk's schedule. The f32 kernel takes chunk r - s at
//       step s, in JAX's order (`chunk_idx` :168), waiting on a chunk's
//       piece signals before it reads the chunk; the bf16 kernel's
//       producer waits on every chunk's before its first item and
//       interleaves the chunks' items (`agg_walk`). Rows are read only
//       from the rank's own workspace, so the data reaches a rank only
//       through the pushes.
//     Items are dealt round robin to a rank's blocks phase by phase (hop by
//     hop within phase 1), so every wait's producer comes earlier in every
//     block's order: the launch cannot deadlock. Signals hold the call's
//     epoch and waits compare for equality, so no earlier call's signal
//     satisfies a wait and nothing is reset; stream order separates two
//     calls, which share the workspaces.
//  * `fault` (a test hook): rank 0's first push skips its copy and still
//    releases its signal; the output must then be wrong.
//
// The products are group_gemm.cuh's bodies over each chunk's schedule: bf16
// with K and the shard width multiples of 8 runs the world-1 kernel's
// wgmma body (`gg_wg_load` / `gg_wg_mma`) in the same 384-thread
// persistent blocks that copy: phases 0 and 1 take the whole block, then
// warpgroup 0 produces (B by TMA through one 4-D view (n_loc, K, E, W) of
// every rank's shard, A gathered from the rank's workspace) and
// warpgroups 1-2 consume; the live items of all W chunks are dealt round
// robin, interleaved (no block holds a dead tile). f32 and odd shapes run `gg_fma_tile`
// in 256-thread blocks. A row's sum depends on K alone, not on the tile it
// lands in or the pairs of a call, so each row has the bits of the
// world-1 kernel on the same shard (ag_group_gemm's impls "xla" and
// "ring").
//
// The chunks travel as their `rows` live rows; JAX ships each in its
// padded tile layout of round_up(rows + E (m_blk - 1), m_blk) + m_blk rows
// (:416, ~17k rows of 2048 for 1024 live ones at Qwen3-30B-A3B's prefill),
// and the schedule's sorted row list does the alignment here.
//
// What bounds it (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16), at
// Qwen3-30B-A3B's expert widths (E = 128, K = 2048, N = 768) over W = 4:
//  * decode, 4 tokens x top-8 = 32 rows (8 a rank): the bytes of the live
//    experts' weights, ~29 of 128 x 2048 x 768 x 2 B = 91 MB over the four
//    shards, 0.027 ms; the ring moves under 1 MB.
//  * prefill, 512 x 8 = 4096 rows (1024 a rank): all the weights, 403 MB,
//    0.120 ms; the ring's three chunk copies a rank, 4 MB each written and
//    read, 0.029 ms; 12.9 GFLOP of products, 0.013 ms. So bytes bound it.
// The f32 kernel streams each rank's weight shard once per chunk (the
// ring's order: a chunk's products start when it arrives), W times in
// all, where the bound reads it once. The bf16 kernel runs the W items
// that read one expert's shard columns side by side (`agg_walk`), so the
// W - 1 later reads of a shard slab find it in L2.
//
// Plain C entry points, loaded with ctypes. A call runs on the stream it is
// given, allocates nothing and returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "group_gemm.cuh"
#include "shmem.cuh"

namespace {

template <typename T>
struct AggArgs {
  const T* x;                 // (M, K) global tokens, row-sharded
  const int* sched;           // (W, sched_ints): chunk c's schedule in row c
  const long long* ws_tab;    // (W,) rank workspaces, (M, K) each
  const long long* sig_tab;   // (W,) rank signals, (W chunks, pieces) each
  const T* w;                 // (E, K, N) global, column-sharded
  T* c;                       // (M, N) global, column-sharded
  long long piece_bytes;
  int world, rows, K, N, n_loc, pieces, max_tiles, sched_ints, col_tiles;
  int bpr, fault;
  unsigned long long epoch;
};

// Phases 0 and 1, the whole block: my chunk into slot `me` of my workspace,
// then the ring to the right, hop by hop; item (hop, piece).
template <typename T>
__device__ __forceinline__ void agg_copies(const AggArgs<T>& a, int me,
                                           int j) {
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
  // A piece's copy with four 16-byte loads in flight a thread (the serial
  // hops set the ring's pace), then its signal.
  auto put_piece = [&](unsigned char* dst, const unsigned char* src,
                       long long len, unsigned long long* sig) {
    tdt_putmem_block_x4(dst, src, len);
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      tdt_signal_release(sig, a.epoch);
    }
  };

  const unsigned char* x = reinterpret_cast<const unsigned char*>(a.x);
  for (int p = j; p < P; p += a.bpr) {
    long long off, len;
    piece(p, &off, &len);
    put_piece(ws_me + me * chunk_bytes + off, x + me * chunk_bytes + off,
              len, sig_me + me * P + p);
  }

  const int peer = (me + 1) % world;
  unsigned char* ws_peer = tdt_peer_ptr(a.ws_tab, peer);
  unsigned long long* sig_peer =
      reinterpret_cast<unsigned long long*>(tdt_peer_ptr(a.sig_tab, peer));
  for (int i = j; i < (world - 1) * P; i += a.bpr) {
    const int hop = i / P;
    const int p = i % P;
    const int c = (me - hop + world) % world;
    tdt_signal_wait_until(sig_me + c * P + p, a.epoch);
    if (a.fault && me == 0 && hop == 0) {
      __syncthreads();
      if (threadIdx.x == 0) tdt_signal_release(sig_peer + c * P + p, a.epoch);
      continue;
    }
    long long off, len;
    piece(p, &off, &len);
    put_piece(ws_peer + c * chunk_bytes + off, ws_me + c * chunk_bytes + off,
              len, sig_peer + c * P + p);
  }
}

// The grouped product of chunk c on rank me's shard, reading the chunk's
// rows from my workspace.
template <typename T>
__device__ __forceinline__ GgArgs<T, T> agg_chunk(const AggArgs<T>& a,
                                                  int me, int c) {
  GgArgs<T, T> g = {};
  g.a = reinterpret_cast<const T*>(tdt_peer_ptr(a.ws_tab, me)) +
        static_cast<size_t>(c) * a.rows * a.K;
  g.a_div = 1;
  g.b0 = a.w + static_cast<size_t>(me) * a.n_loc;
  g.c0 = a.c + static_cast<size_t>(c) * a.rows * a.N +
         static_cast<size_t>(me) * a.n_loc;
  g.sched = a.sched + static_cast<size_t>(c) * a.sched_ints;
  g.P = a.rows;
  g.max_tiles = a.max_tiles;
  g.K = a.K;
  g.N = a.n_loc;
  g.col_tiles = a.col_tiles;
  g.lda = a.K;
  g.ldb = a.N;
  g.b_estride = static_cast<long long>(a.K) * a.N;
  g.ldc = a.N;
  g.n_b = 1;
  return g;
}

// f32 and odd shapes: phase 2 on gg_fma_tile, chunk me - s at step s; item
// (step, row tile of the chunk's schedule, column tile of my shard).
template <typename T>
__global__ void __launch_bounds__(kGgFmThreads, 1)
ag_group_gemm_kernel(AggArgs<T> a) {
  const int world = a.world;
  const int me = tdt_rank(a.bpr);
  const int j = static_cast<int>(blockIdx.x) % a.bpr;
  agg_copies(a, me, j);
  const unsigned long long* sig_me =
      reinterpret_cast<unsigned long long*>(tdt_peer_ptr(a.sig_tab, me));
  const int per_chunk = a.max_tiles * a.col_tiles;
  int ready = -1;                            // the last step waited for
  for (int i = j; i < world * per_chunk; i += a.bpr) {
    const int s = i / per_chunk;
    const int c = (me - s + world) % world;
    const int tile = (i % per_chunk) / a.col_tiles;
    const int col = i % a.col_tiles;
    const GgArgs<T, T> g = agg_chunk(a, me, c);
    if (tile >= g.sched[0]) continue;        // past the chunk's live tiles
    if (s != ready) {
      tdt_signal_wait_all(sig_me + c * a.pieces, a.pieces, a.epoch);
      ready = s;
    }
    __syncthreads();                         // the last tile's smem is free
    gg_fma_tile<T, false, T>(g, tile, col);
  }
}

// Calls f(c, i) for each of block j's items of rank me: item i of chunk c.
// The live items of every chunk are interleaved (item i of chunk me, of
// me - 1, ..., then item i + 1) and dealt round robin to the rank's
// blocks, so the items that read one expert's shard (its row tile of each
// chunk) run side by side and all but the first find the shard in L2.
template <class F>
__device__ __forceinline__ void agg_walk(const AggArgs<bf16>& a, int me,
                                         int j, F&& f) {
  auto live = [&](int c) {
    return a.sched[static_cast<size_t>(c) * a.sched_ints] * a.col_tiles;
  };
  int most = 0;
  for (int c = 0; c < a.world; ++c) most = max(most, live(c));
  int g = 0;                                 // the rank's item sequence
  for (int i = 0; i < most; ++i)
    for (int s = 0; s < a.world; ++s) {
      const int c = (me - s + a.world) % a.world;
      if (i < live(c) && g++ % a.bpr == j) f(c, i);
    }
}

// bf16: phase 2 on the wgmma body. The producer warpgroup waits for every
// chunk's piece signals (spread over its threads) before its first item:
// a block leaves phase 1 only after its last hop, so little of the ring is
// left by then. The consumers never wait on a signal.
__global__ void __launch_bounds__(kPfThreads, 1)
ag_group_gemm_wg_kernel(AggArgs<bf16> a,
                        const __grid_constant__ GgViews v) {
  extern __shared__ unsigned char smem_raw[];
  const GgSmem s = gg_smem(smem_raw);
  wg_init(s);
  const int me = tdt_rank(a.bpr);
  const int j = static_cast<int>(blockIdx.x) % a.bpr;
  agg_copies(a, me, j);
  __syncthreads();
  if (threadIdx.x < 128) {
    wg_producer_regs();
    const unsigned long long* sig_me =
        reinterpret_cast<unsigned long long*>(tdt_peer_ptr(a.sig_tab, me));
    for (int q = threadIdx.x; q < a.world * a.pieces; q += 128)
      while (tdt_signal_acquire(sig_me + q) != a.epoch) __nanosleep(64);
    __threadfence();
    gg_producers_sync();
    GgRing p;
    agg_walk(a, me, j, [&](int c, int i) {
      const GgArgs<bf16, bf16> g = agg_chunk(a, me, c);
      gg_wg_load<false>(s, p, g, v, me, gg_item<false>(g, i));
    });
    gg_producer_done();
    return;
  }
  wg_consumer_regs();
  GgRing p;
  agg_walk(a, me, j, [&](int c, int i) {
    const GgArgs<bf16, bf16> g = agg_chunk(a, me, c);
    gg_wg_mma<false>(s, p, g, gg_item<false>(g, i), [] {});
  });
}

// Blocks resident at once on the current device of the kernel a plan runs
// (path 1: the wgmma body, bf16 only).
template <typename T, bool WG>
cudaError_t resident(int* out) {
  static int cached = -1;
  if (cached < 0) {
    int dev = 0, coop = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess)
      err = WG ? gg_resident(ag_group_gemm_wg_kernel, kPfThreads,
                             kGgSmemBytes, &cached)
               : gg_resident(ag_group_gemm_kernel<T>, kGgFmThreads, 0,
                             &cached);
    if (err != cudaSuccess) {
      cached = -1;
      return err;
    }
    if (!coop) {
      cached = -1;
      return cudaErrorNotSupported;
    }
  }
  *out = cached;
  return cudaSuccess;
}

cudaError_t resident_of(int dtype, int path, int* out) {
  if (dtype == 0 && path == 1) return resident<bf16, true>(out);
  if (dtype == 0) return resident<bf16, false>(out);
  return resident<float, false>(out);
}

template <typename T>
cudaError_t run(const GgPlan& p, AggArgs<T> a, int E, cudaStream_t stream) {
  a.col_tiles = gg_col_tiles<false>(p, a.n_loc);
  void* params[2] = {&a, nullptr};
  const void* kernel = reinterpret_cast<const void*>(ag_group_gemm_kernel<T>);
  int threads = kGgFmThreads, smem = 0;
  GgViews v = {};
  if constexpr (sizeof(T) == 2) {
    if (p.path == 1) {
      const cudaError_t err =
          gg_view(&v.b[0], a.w, E, a.K, a.n_loc, a.N,
                  static_cast<long long>(a.K) * a.N, a.world, a.n_loc);
      if (err != cudaSuccess) return err;
      params[1] = &v;
      kernel = reinterpret_cast<const void*>(ag_group_gemm_wg_kernel);
      threads = kPfThreads;
      smem = kGgSmemBytes;
    }
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaLaunchCooperativeKernel(kernel, dim3(a.world * a.bpr),
                                    dim3(threads), params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The plan of one chunk's grouped product: `rows` pairs, (K -> n_loc) on
// the strided shard of (E, K, N) weights.
GgPlan chunk_plan(int rows, int E, int K, int N, int n_loc, int dtype) {
  return gg_make_plan(rows, E, K, n_loc, dtype, K, N,
                      static_cast<long long>(K) * N);
}

}  // namespace

extern "C" {

// Blocks per rank of a `world`-rank launch whose chunks hold `rows` rows of
// K, over E experts of (K, N) split into `world` shards, in dtype (0:
// bf16, 1: f32): what is resident at once on this card, split evenly over
// the ranks. Returns a cudaError_t.
int tdt_ag_group_gemm_grid(int world, int rows, int E, int K, int N,
                           int dtype, int* bpr) {
  if (world < 2 || bpr == nullptr || N % world != 0 ||
      !gg_args_ok(rows, E, K, N / world, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const GgPlan p = chunk_plan(rows, E, K, N, N / world, dtype);
  int res = 0;
  const cudaError_t err = resident_of(dtype, p.path, &res);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (res / world < 1)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  *bpr = res / world;
  return static_cast<int>(cudaSuccess);
}

// One call over every rank: x (world * rows, K) row-sharded, ids (world *
// rows,) int32 (E the sentinel), w (E, K, N) and c (world * rows, N)
// column-sharded, N = world * n_loc; all contiguous, x and w 16-byte
// aligned. sched: world * (1 + rows + 3 * max_tiles) int32, max_tiles of
// tdt_group_gemm_plan(rows, E, K, n_loc, dtype, K, N, K * N). ws_tab /
// sig_tab: device tables of each rank's (world * rows, K) workspace and
// (world, pieces) 64-bit signals; chunks move in `pieces` pieces of
// piece_bytes (the last may be shorter). `epoch` is greater than every
// earlier call's on these signals. Returns a cudaError_t.
int tdt_ag_group_gemm(const void* x, const int* ids, const void* w, void* c,
                      const void* ws_tab, const void* sig_tab, int* sched,
                      int world, int rows, int E, int K, int N, int pieces,
                      long long piece_bytes, int dtype,
                      unsigned long long epoch, int fault, void* stream) {
  const long long elem = dtype == 0 ? 2 : 4;
  if (x == nullptr || ids == nullptr || w == nullptr || c == nullptr ||
      ws_tab == nullptr || sig_tab == nullptr || sched == nullptr ||
      world < 2 || N % world != 0 ||
      !gg_args_ok(rows, E, K, N / world, dtype) ||
      pieces < 1 || piece_bytes < 16 || piece_bytes % 16 != 0 ||
      static_cast<long long>(pieces) * piece_bytes <
          static_cast<long long>(rows) * K * elem ||
      epoch == 0 || !aligned16(x) || !aligned16(w))
    return static_cast<int>(cudaErrorInvalidValue);
  int bpr = 0;
  const int err = tdt_ag_group_gemm_grid(world, rows, E, K, N, dtype, &bpr);
  if (err != 0) return err;
  const int n_loc = N / world;
  const GgPlan p = chunk_plan(rows, E, K, N, n_loc, dtype);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      launch_schedule(ids, rows, E, p.m_blk, p.max_tiles, sched, s, world);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  auto fill = [&](auto* args) {
    args->sched = sched;
    args->ws_tab = static_cast<const long long*>(ws_tab);
    args->sig_tab = static_cast<const long long*>(sig_tab);
    args->piece_bytes = piece_bytes;
    args->world = world;
    args->rows = rows;
    args->K = K;
    args->N = N;
    args->n_loc = n_loc;
    args->pieces = pieces;
    args->max_tiles = p.max_tiles;
    args->sched_ints = gg_sched_ints(rows, p.max_tiles);
    args->bpr = bpr;
    args->fault = fault;
    args->epoch = epoch;
  };
  if (dtype == 0) {
    AggArgs<bf16> a = {};
    fill(&a);
    a.x = static_cast<const bf16*>(x);
    a.w = static_cast<const bf16*>(w);
    a.c = static_cast<bf16*>(c);
    e = run(p, a, E, s);
  } else {
    AggArgs<float> a = {};
    fill(&a);
    a.x = static_cast<const float*>(x);
    a.w = static_cast<const float*>(w);
    a.c = static_cast<float*>(c);
    e = run(p, a, E, s);
  }
  return static_cast<int>(e);
}

// The runtime's message for an error code returned above.
const char* tdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
