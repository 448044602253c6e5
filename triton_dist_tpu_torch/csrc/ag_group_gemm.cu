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
//     * phase 2, the products: rank r's tiles of chunk r - s at step s, in
//       JAX's order (`chunk_idx` :168), each (row tile, 64-column tile) of
//       the chunk's schedule. A block waits on every piece signal of a
//       chunk before it reads the chunk, and reads rows only from its own
//       rank's workspace, so the data reaches a rank only through the
//       pushes.
//     Items are dealt round robin to a rank's blocks phase by phase (hop by
//     hop within phase 1), so every wait's producer comes earlier in every
//     block's order: the launch cannot deadlock. Signals hold the call's
//     epoch and waits compare for equality, so no earlier call's signal
//     satisfies a wait and nothing is reset; stream order separates two
//     calls, which share the workspaces.
//  * `fault` (a test hook): rank 0's first push skips its copy and still
//    releases its signal; the output must then be wrong.
//
// The products are group_gemm.cuh's tile bodies (`gg_mma_tile`: B streamed
// through a 4-stage cp.async pipeline into mma.sync m16n8k16; `gg_fma_tile`
// for f32 and odd shapes) over each chunk's schedule, with the rows per
// tile of a grouped call of `rows` pairs. A row's sum does not depend on
// the tile it lands in, so each row has the bits of the world-1 kernel on
// the same shard (ag_group_gemm's impls "xla" and "ring").
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
// This first design streams each rank's weight shard once per chunk (the
// ring's order: a chunk's products start when it arrives), W times in all,
// where the bound reads it once; the next design keeps the arrived chunks'
// rows of one expert together.
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

template <bool MMA>
constexpr int agg_threads() { return MMA ? kTcThreads : kGgFmThreads; }

template <typename T, bool MMA, int MF>
__global__ void __launch_bounds__(MMA ? kTcThreads : kGgFmThreads, 1)
ag_group_gemm_kernel(AggArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int world = a.world;
  const int me = tdt_rank(a.bpr);
  const int j = static_cast<int>(blockIdx.x) % a.bpr;
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

  // Phase 0: my chunk into slot `me` of my workspace.
  const unsigned char* x = reinterpret_cast<const unsigned char*>(a.x);
  for (int p = j; p < P; p += a.bpr) {
    long long off, len;
    piece(p, &off, &len);
    tdt_putmem_signal_block(ws_me + me * chunk_bytes + off,
                            x + me * chunk_bytes + off, len,
                            sig_me + me * P + p, a.epoch);
  }

  // Phase 1: the ring to the right, hop by hop; item (hop, piece).
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
    tdt_putmem_signal_block(ws_peer + c * chunk_bytes + off,
                            ws_me + c * chunk_bytes + off, len,
                            sig_peer + c * P + p, a.epoch);
  }

  // Phase 2: my tiles, chunk me - s at step s; item (step, row tile of the
  // chunk's schedule, column tile of my shard).
  const int per_chunk = a.max_tiles * a.col_tiles;
  const T* ws = reinterpret_cast<const T*>(ws_me);
  int ready = -1;                            // the last step waited for
  for (int i = j; i < world * per_chunk; i += a.bpr) {
    const int s = i / per_chunk;
    const int c = (me - s + world) % world;
    const int tile = (i % per_chunk) / a.col_tiles;
    const int col = i % a.col_tiles;
    const int* sched = a.sched + static_cast<size_t>(c) * a.sched_ints;
    if (tile >= sched[0]) continue;          // past the chunk's live tiles
    if (s != ready) {
      tdt_signal_wait_all(sig_me + c * P, P, a.epoch);
      ready = s;
    }
    __syncthreads();                         // the last tile's smem is free
    GgArgs<T, T> g = {};
    g.a = ws + static_cast<size_t>(c) * a.rows * a.K;
    g.a_div = 1;
    g.b0 = a.w + static_cast<size_t>(me) * a.n_loc;
    g.c0 = a.c + static_cast<size_t>(c) * a.rows * a.N +
           static_cast<size_t>(me) * a.n_loc;
    g.sched = sched;
    g.P = a.rows;
    g.max_tiles = a.max_tiles;
    g.K = a.K;
    g.N = a.n_loc;
    g.col_tiles = a.col_tiles;
    g.lda = a.K;
    g.ldb = a.N;
    g.b_estride = static_cast<long long>(a.K) * a.N;
    g.ldc = a.N;
    if constexpr (MMA) {
      gg_mma_tile<MF, false, T>(g, tile, col, smem_raw);
    } else {
      gg_fma_tile<T, false, T>(g, tile, col);
    }
  }
}

template <typename T, bool MMA, int MF>
constexpr int agg_smem() {
  if constexpr (MMA) return gg_mma_smem<MF, false>();
  return 0;
}

// Blocks of one instantiation resident at once on the current device.
template <typename T, bool MMA, int MF>
cudaError_t resident(int* out) {
  static int cached = -1;
  if (cached < 0) {
    constexpr int smem = agg_smem<T, MMA, MF>();
    int dev = 0, sms = 0, per_sm = 0, coop = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ag_group_gemm_kernel<T, MMA, MF>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ag_group_gemm_kernel<T, MMA, MF>, agg_threads<MMA>(),
          smem);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    cached = sms * per_sm;
  }
  *out = cached;
  return cudaSuccess;
}

// Resident blocks of the instantiation a plan runs (path 1: tensor cores,
// bf16 only; m_blk 16, 32 or 64 rows a tile).
cudaError_t resident_of(int dtype, int path, int m_blk, int* out) {
  if (dtype == 0 && path == 1) {
    if (m_blk == 16) return resident<gg_bf16, true, 1>(out);
    if (m_blk == 32) return resident<gg_bf16, true, 2>(out);
    return resident<gg_bf16, true, 4>(out);
  }
  if (dtype == 0) return resident<gg_bf16, false, 1>(out);
  return resident<float, false, 1>(out);
}

template <typename T, bool MMA, int MF>
cudaError_t launch(const AggArgs<T>& a, cudaStream_t stream) {
  constexpr int smem = agg_smem<T, MMA, MF>();
  cudaError_t err = cudaFuncSetAttribute(
      ag_group_gemm_kernel<T, MMA, MF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  void* params[] = {const_cast<AggArgs<T>*>(&a)};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(ag_group_gemm_kernel<T, MMA, MF>),
      dim3(a.world * a.bpr), dim3(agg_threads<MMA>()), params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const GgPlan& p, AggArgs<T> a, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    if (p.path == 1) {
      a.col_tiles = (a.n_loc + kTcBN - 1) / kTcBN;
      if (p.m_blk == 16) return launch<T, true, 1>(a, stream);
      if (p.m_blk == 32) return launch<T, true, 2>(a, stream);
      return launch<T, true, 4>(a, stream);
    }
  }
  a.col_tiles = (a.n_loc + kGgFmBN - 1) / kGgFmBN;
  return launch<T, false, 1>(a, stream);
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
  const cudaError_t err = resident_of(dtype, p.path, p.m_blk, &res);
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
    AggArgs<gg_bf16> a = {};
    fill(&a);
    a.x = static_cast<const gg_bf16*>(x);
    a.w = static_cast<const gg_bf16*>(w);
    a.c = static_cast<gg_bf16*>(c);
    e = run(p, a, s);
  } else {
    AggArgs<float> a = {};
    fill(&a);
    a.x = static_cast<const float*>(x);
    a.w = static_cast<const float*>(w);
    a.c = static_cast<float*>(c);
    e = run(p, a, s);
  }
  return static_cast<int>(e);
}

// The runtime's message for an error code returned above.
const char* tdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
