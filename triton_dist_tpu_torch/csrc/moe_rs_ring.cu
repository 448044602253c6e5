// MoE down projection + top-k reduce + ring reduce-scatter for Hopper
// (sm_90a), every rank of one card in one cooperative launch.
//
// Replaces, at world W > 1, triton_dist_tpu/ops/moe_reduce_rs.py::
// _moe_rs_fused_kernel (:72, entry `_moe_rs_fused` :396; its ring
// `rs_step` :207-222). moe_rs.cu replaces its world-1 half.
//
// What it computes, for every rank r at once: act (T k, I) and w_down (E,
// I, H) are sharded on I, rank r's columns of act and rows of w_down
// [r * I_loc, (r + 1) * I_loc) (strided views, never copied: the experts
// of Qwen3-30B-A3B take ~57 GB of the card's 80 GB); ids (T k) and the
// routing weights (T, k) are replicated. Rank r's partial of token row m
// is sum_j w[m, j] * (act_r[m k + j] @ w_down_r[ids[m k + j]]), kept in
// f32 as the Pallas kernel keeps `pair_out` and its selection matmul
// (:169-182). The T rows split into W chunks of T / W; out (T, H) gets
// chunk c from rank c. The rounding points are JAX's: chunk c's partial
// starts on rank c + 1 (step s = 0, `send_idx = me - s - 1`), rounded to
// the activation dtype, and travels right in that dtype (`send_hbm` /
// `recv_hbm` :447-453); at each step a rank adds its own f32 partial to
// the received one in f32 and rounds (:185-196); at step W - 1 rank c
// writes chunk c into out. So chunk c rounds W times. The top-k sum runs
// over slots 0..k-1 in that order (moe_rs.cu's `topk_reduce_rows`), where
// JAX's selection matmul sums in its own order: f32 differences only.
//
// Two launches a call, on the caller's stream:
//  1. group_gemm.cuh's `group_schedule` over all T k pairs: one expert
//     schedule, which the W ranks share (the ids are replicated; only the
//     I-shards differ). JAX aligns each chunk's pairs on each rank.
//  2. The cooperative kernel, `bpr` blocks for each of the W ranks (what is
//     resident at once, from this kernel's occupancy on this card,
//     tdt_moe_rs_ring_grid; a launch that does not fit fails), so a block
//     that spins on a signal never starves its producer of an SM. A block
//     walks its rank's items in phase order:
//     * phase 0, the products: rank r's grouped items (row tile of the
//       schedule, column item of H) of every pair on its shard, with
//       group_gemm.cuh's bodies (bf16: the wgmma body, `gg_wg_load` /
//       `gg_wg_mma`, in 384-thread persistent blocks whose warpgroup 0
//       produces, B by TMA through one 4-D view (H, I_loc, E, W) of every
//       rank's row shard; f32 and odd shapes: `gg_fma_tile` in 256-thread
//       blocks), as the world-1 kernels run them, in f32 into rank r's
//       (T k, H) product workspace, each pair at its own slot. Each item
//       releases its own epoch-stamped signal. This reads each rank's
//       weight shard once; JAX computes one chunk's products per ring step
//       instead, which on this card would stream the shard W times
//       (ag_group_gemm.cu's design does, at 4.6x its bound). The products
//       do not depend on the ring, so computing them first loses nothing.
//     * phase 1, the ring: at step s rank r reduces chunk c = r - s - 1
//       (mod W) in pieces of `piece_elems` elements of the chunk's (T / W,
//       H) rows (any T / W: one row at decode; the pieces are small, one
//       row of Qwen3-30B-A3B's, so every block of a rank has one at
//       prefill: a block's loads in flight, not its arithmetic, set the
//       pace of this reduction), each element the f32 top-k
//       sum of its pairs' products, plus (s > 0) the f32 value of the
//       partial its left neighbour pushed into receive slot s - 1,
//       rounded to the activation dtype. For s < W - 1 the piece goes into
//       the right neighbour's receive slot s, and the (slot, piece) signal
//       in the neighbour's buffer is released; at s = W - 1 (c = r) it
//       goes into out. A step-s item first waits for every live tile
//       signal of its rank (once a block) and, for s > 0, for the left
//       neighbour's (s - 1, piece) signal. In the bf16 kernel the
//       consumer warpgroups run this phase; the producer warpgroup is done
//       after its last item.
//     Items are dealt round robin to a rank's blocks phase by phase (step
//     by step within phase 1), so every wait's producer comes earlier in
//     every block's order: the launch cannot deadlock. Signals hold the
//     call's epoch and waits compare for equality, so no earlier call's
//     signal satisfies a wait and nothing is reset; stream order separates
//     two calls, which share the workspaces.
//  * `fault` (a test hook): rank 0's first push (step 0) skips its stores
//    and still releases its signals; the output must then be wrong.
//
// Sentinel ids (== E) run through expert E - 1, as in moe_rs.cu; JAX's
// fused kernel drops such pairs into a trash tile.
//
// What bounds it (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16), at
// Qwen3-30B-A3B's down projection (E = 128, I = 768, H = 2048) over W = 4
// (I_loc = 192):
//  * decode, 4 tokens x top-8 = 32 pairs (1 row a chunk): the bytes of the
//    live experts' weights, ~29 x 768 x 2048 x 2 B = 91 MB over the four
//    shards, ~0.027 ms; the ring moves 12 rows of 4 KiB.
//  * prefill, 512 x 8 = 4096 pairs (128 rows a chunk): all the weights,
//    403 MB, 0.120 ms; the ring's 12 chunk partials of 512 KiB written and
//    read, 0.004 ms; 12.9 GFLOP of products, 0.013 ms. So bytes bound it.
// The f32 product workspace (4096 x 2048 x 4 B = 33.5 MB a rank) is
// written once and read once, ~0.08 ms at W = 4: the price of keeping the
// pairs unrounded outside the tile, which the bound does not count.
//
// Plain C entry points, loaded with ctypes. A call runs on the stream it is
// given, allocates nothing and returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "group_gemm.cuh"
#include "shmem.cuh"

namespace {

template <typename T>
struct RingArgs {
  const T* act;               // (T k, I) global, column-sharded
  const float* wts;           // (T, k) routing weights
  const T* w;                 // (E, I, H) global, row-sharded
  T* out;                     // (T, H), row-sharded
  const int* sched;           // the pairs' expert schedule
  const long long* prod_tab;  // (W,) rank f32 products, (T k, H) each
  const long long* recv_tab;  // (W,) rank receive slots, (W - 1, rows, H)
  const long long* sig_tab;   // (W,) rank signals: tiles, then (W - 1, P)
  long long piece_elems;
  int world, tokens, k, I, I_loc, H, rows, pieces, max_tiles, col_tiles;
  int bpr, fault;
  unsigned long long epoch;
};

// Rank me's f32 products of every pair on its shard.
template <typename T>
__device__ __forceinline__ GgArgs<T, float> ring_products(
    const RingArgs<T>& a, int me) {
  GgArgs<T, float> g = {};
  g.a = a.act + static_cast<size_t>(me) * a.I_loc;
  g.a_div = 1;
  g.b0 = a.w + static_cast<size_t>(me) * a.I_loc * a.H;
  g.c0 = reinterpret_cast<float*>(tdt_peer_ptr(a.prod_tab, me));
  g.sched = a.sched;
  g.P = a.tokens * a.k;
  g.max_tiles = a.max_tiles;
  g.K = a.I_loc;
  g.N = a.H;
  g.col_tiles = a.col_tiles;
  g.lda = a.I;
  g.ldb = a.H;
  g.b_estride = static_cast<long long>(a.I) * a.H;
  g.ldc = a.H;
  g.n_b = 1;
  return g;
}

// Phase 1, the ring, step by step; item (step, piece of the chunk). Run by
// nt threads of the block (t = 0 .. nt - 1 the caller's), which `sync`
// brings together.
template <typename T, class Sync>
__device__ __forceinline__ void ring_steps(const RingArgs<T>& a, int me,
                                           int j, int t, int nt,
                                           Sync&& sync) {
  const int world = a.world;
  const int tile_sigs = a.max_tiles * a.col_tiles;
  const float* prod =
      reinterpret_cast<const float*>(tdt_peer_ptr(a.prod_tab, me));
  const unsigned long long* sig_me =
      reinterpret_cast<unsigned long long*>(tdt_peer_ptr(a.sig_tab, me));
  const int peer = (me + 1) % world;
  const long long chunk = static_cast<long long>(a.rows) * a.H;
  const T* recv_me = reinterpret_cast<const T*>(tdt_peer_ptr(a.recv_tab, me));
  T* recv_peer = reinterpret_cast<T*>(tdt_peer_ptr(a.recv_tab, peer));
  const unsigned long long* ring_me = sig_me + tile_sigs;
  unsigned long long* ring_peer =
      reinterpret_cast<unsigned long long*>(tdt_peer_ptr(a.sig_tab, peer)) +
      tile_sigs;
  bool products = false;                     // my items waited for
  for (int i = j; i < world * a.pieces; i += a.bpr) {
    const int s = i / a.pieces;
    const int p = i % a.pieces;
    const int c = ((me - s - 1) % world + world) % world;
    if (!products) {
      const int n = a.sched[0] * a.col_tiles;
      for (int q = t; q < n; q += nt)
        while (tdt_signal_acquire(sig_me + q) != a.epoch) __nanosleep(64);
      __threadfence();
      sync();
      products = true;
    }
    if (s > 0) {
      if (t == 0) {
        while (tdt_signal_acquire(ring_me + (s - 1) * a.pieces + p) !=
               a.epoch)
          __nanosleep(64);
        __threadfence();
      }
      sync();
    }
    const bool last = s == world - 1;
    const long long e0 = p * a.piece_elems;
    const long long e1 =
        e0 + a.piece_elems < chunk ? e0 + a.piece_elems : chunk;
    if (!(a.fault && me == 0 && s == 0)) {
      T* dst = last ? a.out + static_cast<size_t>(c) * chunk
                    : recv_peer + static_cast<size_t>(s) * chunk;
      const T* got = recv_me + static_cast<size_t>(s > 0 ? s - 1 : 0) * chunk;
      // V consecutive elements a thread (V = 4 when H and the pieces split
      // into 16-byte vectors of the f32 products): the loads in flight,
      // not the arithmetic, set this loop's pace.
      auto reduce = [&](auto vec) {
        constexpr int V = decltype(vec)::value;
        for (long long e = e0 + V * t; e < e1; e += V * nt) {
          const long long row = static_cast<long long>(c) * a.rows + e / a.H;
          const long long h = e % a.H;
          float acc[V];
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = 0.f;
          for (int q = 0; q < a.k; ++q) {
            const long long pair = row * a.k + q;
            const float w = a.wts[pair];
            float x[V];
            if constexpr (V == 4) {
              const float4 p4 =
                  *reinterpret_cast<const float4*>(prod + pair * a.H + h);
              x[0] = p4.x, x[1] = p4.y, x[2] = p4.z, x[3] = p4.w;
            } else {
              x[0] = prod[pair * a.H + h];
            }
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[v] = __fadd_rn(acc[v], __fmul_rn(x[v], w));
          }
#pragma unroll
          for (int v = 0; v < V; ++v) {
            if (s > 0) acc[v] = __fadd_rn(acc[v], to_f32(got[e + v]));
            dst[e + v] = from_f32<T>(acc[v]);
          }
        }
      };
      if (a.H % 4 == 0 && a.piece_elems % 4 == 0) {
        reduce(std::integral_constant<int, 4>{});
      } else {
        reduce(std::integral_constant<int, 1>{});
      }
    }
    sync();
    if (!last && t == 0) {
      __threadfence();
      tdt_signal_release(ring_peer + s * a.pieces + p, a.epoch);
    }
  }
}

// f32 and odd shapes: phase 0 on gg_fma_tile, item (row tile, column tile),
// then phase 1 by the whole block.
template <typename T>
__global__ void __launch_bounds__(kGgFmThreads, 1)
moe_rs_ring_kernel(RingArgs<T> a) {
  const int me = tdt_rank(a.bpr);
  const int j = static_cast<int>(blockIdx.x) % a.bpr;
  unsigned long long* sig_me =
      reinterpret_cast<unsigned long long*>(tdt_peer_ptr(a.sig_tab, me));
  const GgArgs<T, float> g = ring_products(a, me);
  const int live = a.sched[0] * a.col_tiles;
  for (int i = j; i < live; i += a.bpr) {
    __syncthreads();                         // the last item's smem is free
    gg_fma_tile<T, false, float>(g, i / a.col_tiles, i % a.col_tiles);
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      tdt_signal_release(sig_me + i, a.epoch);
    }
  }
  ring_steps(a, me, j, static_cast<int>(threadIdx.x),
             static_cast<int>(blockDim.x), [] { __syncthreads(); });
}

// bf16: phase 0 on the wgmma body, each item's signal released by the
// consumers once both warpgroups have stored it; then phase 1 by the
// consumers.
__global__ void __launch_bounds__(kPfThreads, 1)
moe_rs_ring_wg_kernel(RingArgs<bf16> a,
                      const __grid_constant__ GgViews v) {
  extern __shared__ unsigned char smem_raw[];
  const GgSmem s = gg_smem(smem_raw);
  wg_init(s);
  __syncthreads();
  const int me = tdt_rank(a.bpr);
  const int j = static_cast<int>(blockIdx.x) % a.bpr;
  const GgArgs<bf16, float> g = ring_products(a, me);
  const int live = a.sched[0] * a.col_tiles;
  if (threadIdx.x < 128) {
    wg_producer_regs();
    GgRing p;
    for (int i = j; i < live; i += a.bpr)
      gg_wg_load<false>(s, p, g, v, me, gg_item<false>(g, i));
    gg_producer_done();
    return;
  }
  wg_consumer_regs();
  unsigned long long* sig_me =
      reinterpret_cast<unsigned long long*>(tdt_peer_ptr(a.sig_tab, me));
  GgRing p;
  for (int i = j; i < live; i += a.bpr) {
    gg_wg_mma<false>(s, p, g, gg_item<false>(g, i), [] {});
    consumers_release(sig_me + i, a.epoch);
  }
  ring_steps(a, me, j, static_cast<int>(threadIdx.x) - 128, 256,
             [] { consumers_sync(); });
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
      err = WG ? gg_resident(moe_rs_ring_wg_kernel, kPfThreads, kGgSmemBytes,
                             &cached)
               : gg_resident(moe_rs_ring_kernel<T>, kGgFmThreads, 0, &cached);
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
cudaError_t run(const GgPlan& p, RingArgs<T> a, int E, cudaStream_t stream) {
  void* params[2] = {&a, nullptr};
  const void* kernel = reinterpret_cast<const void*>(moe_rs_ring_kernel<T>);
  int threads = kGgFmThreads, smem = 0;
  GgViews v = {};
  if constexpr (sizeof(T) == 2) {
    if (p.path == 1) {
      const cudaError_t err =
          gg_view(&v.b[0], a.w, E, a.I_loc, a.H, a.H,
                  static_cast<long long>(a.I) * a.H, a.world,
                  static_cast<long long>(a.I_loc) * a.H);
      if (err != cudaSuccess) return err;
      params[1] = &v;
      kernel = reinterpret_cast<const void*>(moe_rs_ring_wg_kernel);
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

bool ring_args_ok(int P, int E, int I_loc, int H, int dtype, long long lda,
                  long long ldb, long long w_estride) {
  return gg_args_ok(P, E, I_loc, H, dtype) &&
         gg_strides_ok(I_loc, H, lda, ldb, w_estride);
}

}  // namespace

extern "C" {

// Tile signals a rank needs for P pairs of (I_loc -> H) products on a shard
// with strides lda, ldb, w_estride (elements) in dtype (0: bf16, 1: f32):
// the plan's worst-case row tiles times its column tiles. Returns a
// cudaError_t.
int tdt_moe_rs_ring_tile_signals(int P, int E, int I_loc, int H, int dtype,
                                 long long lda, long long ldb,
                                 long long w_estride, int* n) {
  if (n == nullptr || !ring_args_ok(P, E, I_loc, H, dtype, lda, ldb,
                                    w_estride))
    return static_cast<int>(cudaErrorInvalidValue);
  const GgPlan p = gg_make_plan(P, E, I_loc, H, dtype, lda, ldb, w_estride);
  *n = p.max_tiles * gg_col_tiles<false>(p, H);
  return static_cast<int>(cudaSuccess);
}

// Blocks per rank of a `world`-rank launch over P pairs of (I_loc -> H)
// products (strides as above): what is resident at once on this card,
// split evenly over the ranks. Returns a cudaError_t.
int tdt_moe_rs_ring_grid(int world, int P, int E, int I_loc, int H,
                         int dtype, long long lda, long long ldb,
                         long long w_estride, int* bpr) {
  if (world < 2 || bpr == nullptr ||
      !ring_args_ok(P, E, I_loc, H, dtype, lda, ldb, w_estride))
    return static_cast<int>(cudaErrorInvalidValue);
  const GgPlan p = gg_make_plan(P, E, I_loc, H, dtype, lda, ldb, w_estride);
  int res = 0;
  const cudaError_t err = resident_of(dtype, p.path, &res);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (res / world < 1)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  *bpr = res / world;
  return static_cast<int>(cudaSuccess);
}

// One call over every rank: act (T k, I) and w_down (E, I, H) contiguous
// and 16-byte aligned, I = world * I_loc; ids (T k) int32 (E the
// sentinel); weights (T, k) f32; out (T, H), T = world * rows. sched:
// 1 + T k + 3 * max_tiles int32 (tdt_group_gemm_plan of T k pairs, I_loc
// -> H, strides I, H, I H). prod_tab / recv_tab / sig_tab: device tables
// of each rank's f32 (T k, H) products, its (world - 1, rows, H) receive
// slots in the activation dtype and its 64-bit signals
// (tdt_moe_rs_ring_tile_signals of them, then (world - 1) * pieces);
// chunks move in `pieces` pieces of piece_elems elements (the last may be
// shorter). `epoch` is greater than every earlier call's on these signals.
// Returns a cudaError_t.
int tdt_moe_rs_ring(const void* act, const int* ids, const float* weights,
                    const void* w_down, void* out, const void* prod_tab,
                    const void* recv_tab, const void* sig_tab, int* sched,
                    int world, int T, int k, int E, int I, int H, int pieces,
                    long long piece_elems, int dtype,
                    unsigned long long epoch, int fault, void* stream) {
  if (act == nullptr || ids == nullptr || weights == nullptr ||
      w_down == nullptr || out == nullptr || prod_tab == nullptr ||
      recv_tab == nullptr || sig_tab == nullptr || sched == nullptr ||
      world < 2 || T <= 0 || k <= 0 || T % world != 0 || I % world != 0 ||
      pieces < 1 || piece_elems < 1 ||
      static_cast<long long>(pieces) * piece_elems <
          static_cast<long long>(T / world) * H ||
      epoch == 0 || !aligned16(act) || !aligned16(w_down))
    return static_cast<int>(cudaErrorInvalidValue);
  const int P = T * k;
  const int I_loc = I / world;
  const long long w_estride = static_cast<long long>(I) * H;
  int bpr = 0;
  const int err =
      tdt_moe_rs_ring_grid(world, P, E, I_loc, H, dtype, I, H, w_estride, &bpr);
  if (err != 0) return err;
  const GgPlan p = gg_make_plan(P, E, I_loc, H, dtype, I, H, w_estride);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = launch_schedule(ids, P, E, p.m_blk, p.max_tiles, sched, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  auto fill = [&](auto* args) {
    args->wts = weights;
    args->sched = sched;
    args->prod_tab = static_cast<const long long*>(prod_tab);
    args->recv_tab = static_cast<const long long*>(recv_tab);
    args->sig_tab = static_cast<const long long*>(sig_tab);
    args->piece_elems = piece_elems;
    args->world = world;
    args->tokens = T;
    args->k = k;
    args->I = I;
    args->I_loc = I_loc;
    args->H = H;
    args->rows = T / world;
    args->pieces = pieces;
    args->max_tiles = p.max_tiles;
    args->col_tiles = gg_col_tiles<false>(p, H);
    args->bpr = bpr;
    args->fault = fault;
    args->epoch = epoch;
  };
  if (dtype == 0) {
    RingArgs<bf16> a = {};
    fill(&a);
    a.act = static_cast<const bf16*>(act);
    a.w = static_cast<const bf16*>(w_down);
    a.out = static_cast<bf16*>(out);
    e = run(p, a, E, s);
  } else {
    RingArgs<float> a = {};
    fill(&a);
    a.act = static_cast<const float*>(act);
    a.w = static_cast<const float*>(w_down);
    a.out = static_cast<float*>(out);
    e = run(p, a, E, s);
  }
  return static_cast<int>(e);
}

// The runtime's message for an error code returned above.
const char* tdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
