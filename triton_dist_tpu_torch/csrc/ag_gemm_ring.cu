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
// The design, the Pallas kernel's protocol on one card:
//  * Grid: `bpr` blocks for each of the W ranks, launched cooperatively, so
//    every block is resident (a block that spins on a peer's signal never
//    starves the peer of an SM); `bpr` comes from this kernel's occupancy
//    on this card (tdt_ag_ring_grid) and a launch that does not fit fails.
//  * Workspace: each rank has its own (M, K) buffer (JAX's ag_hbm), found
//    through a table of addresses. Phase 0: rank r copies its shard into
//    slot r of its own workspace (JAX :293-297).
//  * Phase 1, the ring: rank r pushes chunks to its right neighbour hop by
//    hop (and, with two directions, to its left one: ring_hop_counts), in
//    pieces of about 32 KiB. A push waits until the piece has arrived in
//    r's own workspace, copies it into the neighbour's workspace, then
//    releases the (chunk, piece) signal in the neighbour's signal buffer.
//  * Phase 2, the products: rank r's tiles of each chunk, chunks in
//    ring_chunk_schedule order; a block waits on every piece signal of a
//    chunk before it reads the chunk, and reads only its own rank's
//    workspace, so the data reaches a rank only through the pushes.
//  * Items are dealt round robin to a rank's blocks, phase by phase and
//    hop by hop, so a wait only ever needs items that come earlier in every
//    block's order: the launch cannot deadlock.
//  * Signals hold the call's epoch and waits compare for equality, so no
//    earlier call's signal satisfies a wait and nothing is reset; stream
//    order separates two calls (their workspaces are reused).
//  * `fault` (a test hook): rank 0's first push to the right skips its
//    copy and still releases its signal; the output must then be wrong.
//
// What bounds it (H100 SXM: 989 TFLOP/s bf16, 3.35 TB/s): the products,
// 2 * M * K * sum(N_i) operations, at Qwen3-8B's prefill (M = 512) bound by
// operations; the ring's W - 1 chunk copies per rank move (W - 1) * M * K
// bytes of bf16 through HBM (every rank shares the card's memory, so no
// interconnect is measured). At decode (M = 4) it is bound by the bytes of
// B. The tiles are tiles.cuh's: the tensor-core tile for bf16 with K and
// every shard width a multiple of 8, the FMA tile otherwise. Decode shapes
// run the 128-row tile with most rows masked, a speed debt.
//
// Plain C entry points, loaded with ctypes. A launch runs on the stream it
// is given, allocates nothing and returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shmem.cuh"
#include "tiles.cuh"

namespace {

constexpr int kOpGemm = 0;
constexpr int kOpSwiglu = 1;

template <typename T>
struct AgArgs {
  const T* x;                 // (M, K) global A, row-sharded
  const long long* ws_tab;    // (W,) rank workspaces, (M, K) each
  const long long* sig_tab;   // (W,) rank signals, (W chunks, pieces) each
  const T* b[kMaxSegs];       // (K, N_i) global, column-sharded
  T* c[kMaxSegs];             // (M, N_i) global, column-sharded
  int n_loc[kMaxSegs];        // shard widths
  int tiles0[kMaxSegs + 1];   // first column tile of each product
  const T* bu;                // SwiGLU: Wu, like b[0]
  const T* bias_g;            // SwiGLU: (N,) biases or null
  const T* bias_u;
  long long piece_bytes;
  int count, world, rows, K, pieces, n_fwd, n_bwd, dirs, bpr, fault;
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

template <typename T, bool MMA, bool SWIGLU>
__global__ void __launch_bounds__(kPfThreads, 1) ag_ring_kernel(AgArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int BM = MMA ? kPfBM : kFmBM;
  constexpr int BN = MMA ? (SWIGLU ? kPfBNSwiglu : kPfBN) : kFmBN;
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

  // Phase 0: my shard into slot `me` of my workspace.
  const unsigned char* x = reinterpret_cast<const unsigned char*>(a.x);
  for (int p = j; p < P; p += a.bpr) {
    long long off, len;
    piece(p, &off, &len);
    tdt_putmem_signal_block(ws_me + me * chunk_bytes + off,
                            x + me * chunk_bytes + off, len,
                            sig_me + me * P + p, a.epoch);
  }

  // Phase 1: the ring, hop by hop; item (hop, direction, piece).
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

  // Phase 2: my tiles, chunks in schedule order; item (position, row tile,
  // column tile over all products).
  const int row_tiles = (a.rows + BM - 1) / BM;
  const int col_tiles = a.tiles0[a.count];
  const int per_chunk = row_tiles * col_tiles;
  const T* ws = reinterpret_cast<const T*>(ws_me);
  for (int i = j; i < world * per_chunk; i += a.bpr) {
    const int c = schedule_chunk(me, i / per_chunk, world, a.dirs);
    const int rt = (i % per_chunk) / col_tiles;
    const int ct = i % col_tiles;
    tdt_signal_wait_all(sig_me + c * P, P, a.epoch);
    int seg = 0;
#pragma unroll
    for (int s = 1; s < kMaxSegs; ++s)
      if (s < a.count && ct >= a.tiles0[s]) seg = s;
    const int n_loc = seg_field(a.n_loc, seg);
    const long long ld = static_cast<long long>(n_loc) * world;
    const int n0 = (ct - seg_field(a.tiles0, seg)) * BN;
    const int m0 = c * a.rows + rt * BM;
    const long long col = static_cast<long long>(me) * n_loc + n0;
    Tile<T> t;
    t.a = ws + static_cast<long long>(m0) * a.K;
    t.lda = a.K;
    t.b = seg_field(a.b, seg) + col;
    t.bu = SWIGLU ? a.bu + col : nullptr;
    t.ldb = ld;
    t.bias_g = a.bias_g != nullptr ? a.bias_g + col : nullptr;
    t.bias_u = a.bias_u != nullptr ? a.bias_u + col : nullptr;
    t.rows = min(BM, a.rows - rt * BM);
    t.cols = min(BN, n_loc - n0);
    t.K = a.K;
    const StoreEpi<T> epi{seg_field(a.c, seg) + m0 * ld + col, ld};
    run_tile<T, MMA, BN, SWIGLU>(t, smem_raw, epi);
  }
}

template <typename T, bool MMA, bool SWIGLU>
int smem_of() {
  if constexpr (MMA)
    return tile_smem_bytes<SWIGLU ? kPfBNSwiglu : kPfBN, SWIGLU>();
  return 0;
}

// Blocks of one instantiation resident at once on the current device.
template <typename T, bool MMA, bool SWIGLU>
cudaError_t resident(int* out) {
  static int cached = -1;
  if (cached < 0) {
    const int smem = smem_of<T, MMA, SWIGLU>();
    int dev = 0, sms = 0, per_sm = 0, coop = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ag_ring_kernel<T, MMA, SWIGLU>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, ag_ring_kernel<T, MMA, SWIGLU>, kPfThreads, smem);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    cached = sms * per_sm;
  }
  *out = cached;
  return cudaSuccess;
}

cudaError_t resident_of(int dtype, int mma, int op, int* out) {
  const bool sw = op == kOpSwiglu;
  if (dtype == 0 && mma)
    return sw ? resident<bf16, true, true>(out)
              : resident<bf16, true, false>(out);
  if (dtype == 0)
    return sw ? resident<bf16, false, true>(out)
              : resident<bf16, false, false>(out);
  return sw ? resident<float, false, true>(out)
            : resident<float, false, false>(out);
}

template <typename T, bool MMA, bool SWIGLU>
cudaError_t launch(const AgArgs<T>& a, cudaStream_t stream) {
  const int smem = smem_of<T, MMA, SWIGLU>();
  cudaError_t err = cudaFuncSetAttribute(
      ag_ring_kernel<T, MMA, SWIGLU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  void* params[] = {const_cast<AgArgs<T>*>(&a)};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(ag_ring_kernel<T, MMA, SWIGLU>),
      dim3(a.world * a.bpr), dim3(kPfThreads), params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(int op, int mma, const void* x, const void* ws_tab,
                const void* sig_tab, int n_b, const void* const* b,
                void* const* c, const int* n_loc, const void* bu,
                const void* bg, const void* bias_u, int world, int rows,
                int K, int pieces, long long piece_bytes, int dirs, int bpr,
                unsigned long long epoch, int fault, cudaStream_t stream) {
  AgArgs<T> a = {};
  a.x = static_cast<const T*>(x);
  a.ws_tab = static_cast<const long long*>(ws_tab);
  a.sig_tab = static_cast<const long long*>(sig_tab);
  const int bn = mma ? (op == kOpSwiglu ? kPfBNSwiglu : kPfBN) : kFmBN;
  for (int i = 0; i < n_b; ++i) {
    a.b[i] = static_cast<const T*>(b[i]);
    a.c[i] = static_cast<T*>(c[i]);
    a.n_loc[i] = n_loc[i];
    a.tiles0[i + 1] = a.tiles0[i] + (n_loc[i] + bn - 1) / bn;
  }
  for (int i = n_b; i < kMaxSegs; ++i) a.tiles0[i + 1] = a.tiles0[i];
  a.bu = static_cast<const T*>(bu);
  a.bias_g = static_cast<const T*>(bg);
  a.bias_u = static_cast<const T*>(bias_u);
  a.piece_bytes = piece_bytes;
  a.count = n_b;
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
  a.epoch = epoch;
  const bool sw = op == kOpSwiglu;
  if constexpr (sizeof(T) == 2) {
    if (mma)
      return sw ? launch<T, true, true>(a, stream)
                : launch<T, true, false>(a, stream);
  }
  return sw ? launch<T, false, true>(a, stream)
            : launch<T, false, false>(a, stream);
}

}  // namespace

extern "C" {

// Blocks per rank of a `world`-rank launch of op (0: products, 1: SwiGLU)
// in dtype (0: bf16, 1: f32) on the tensor-core path (`mma`, bf16 only) or
// the FMA path: what is resident at once on this card, split evenly over
// the ranks. Returns a cudaError_t.
int tdt_ag_ring_grid(int op, int dtype, int mma, int world, int* bpr) {
  if (world < 2 || bpr == nullptr || (dtype != 0 && dtype != 1) ||
      (mma && dtype != 0) || (op != kOpGemm && op != kOpSwiglu))
    return static_cast<int>(cudaErrorInvalidValue);
  int res = 0;
  const cudaError_t err = resident_of(dtype, mma, op, &res);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (res / world < 1)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  *bpr = res / world;
  return static_cast<int>(cudaSuccess);
}

// One launch over every rank: x (M, K) row-sharded with rows = M / world;
// b_i (K, world * n_loc_i) and c_i (M, world * n_loc_i) column-sharded
// (op 1: n_b = 1, b0 = Wg, bu = Wu, bg / bias_u the (N,) biases or null).
// ws_tab / sig_tab: device tables of each rank's (M, K) workspace and
// (world, pieces) 64-bit signals; chunks move in `pieces` pieces of
// piece_bytes (the last may be shorter). `epoch` is greater than every
// earlier call's on these signals. Returns a cudaError_t.
int tdt_ag_ring(int op, int dtype, int mma, const void* x, const void* ws_tab,
                const void* sig_tab, int n_b, const void* b0, const void* b1,
                const void* b2, void* c0, void* c1, void* c2, int n0, int n1,
                int n2, const void* bu, const void* bg, const void* bias_u,
                int world, int rows, int K, int pieces,
                long long piece_bytes, int dirs, unsigned long long epoch,
                int fault, void* stream) {
  const void* b[kMaxSegs] = {b0, b1, b2};
  void* c[kMaxSegs] = {c0, c1, c2};
  const int n[kMaxSegs] = {n0, n1, n2};
  const long long elem = dtype == 0 ? 2 : 4;
  bool ok = x != nullptr && ws_tab != nullptr && sig_tab != nullptr &&
            rows >= 1 && K >= 1 && pieces >= 1 && piece_bytes >= 16 &&
            piece_bytes % 16 == 0 &&
            static_cast<long long>(pieces) * piece_bytes >=
                static_cast<long long>(rows) * K * elem &&
            (dirs == 1 || dirs == 2) && epoch != 0 &&
            (op == kOpSwiglu ? n_b == 1 && bu != nullptr &&
                                   (bg == nullptr) == (bias_u == nullptr)
                             : n_b >= 1 && n_b <= kMaxSegs);
  for (int i = 0; ok && i < n_b; ++i)
    ok = b[i] != nullptr && c[i] != nullptr && n[i] >= 1 &&
         (!mma || n[i] % 8 == 0);
  if (!ok || (mma && K % 8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  int bpr = 0;
  const int err = tdt_ag_ring_grid(op, dtype, mma, world, &bpr);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      dtype == 0
          ? run<bf16>(op, mma, x, ws_tab, sig_tab, n_b, b, c, n, bu, bg,
                      bias_u, world, rows, K, pieces, piece_bytes, dirs, bpr,
                      epoch, fault, s)
          : run<float>(op, mma, x, ws_tab, sig_tab, n_b, b, c, n, bu, bg,
                       bias_u, world, rows, K, pieces, piece_bytes, dirs, bpr,
                       epoch, fault, s);
  return static_cast<int>(e);
}

// The runtime's message for an error code returned above.
const char* tdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
