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
// The design, the Pallas kernel's protocol on one card:
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
//  * `fault` (a test hook): rank 0's step-0 pushes skip their stores and
//    still release their signals; the output must then be wrong.
//
// What bounds it (H100 SXM: 989 TFLOP/s bf16, 3.35 TB/s): the partial
// products, 2 * M * K * N operations over all ranks, bound by operations at
// Qwen3-8B's prefill (M = 512) and by the bytes of B at decode (M = 4);
// the ring moves (W - 1) * M * N partial sums through HBM (the ranks share
// the card's memory: no interconnect is measured). Tiles are tiles.cuh's:
// tensor cores for bf16 with kl, N and the split multiples of 8, FMAs
// otherwise; decode shapes run the 128-row tile with most rows masked.
//
// Plain C entry points, loaded with ctypes. A launch runs on the stream it
// is given, allocates nothing and returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shmem.cuh"
#include "tiles.cuh"

namespace {

template <typename T>
struct RsArgs {
  const T* a;                 // (M, K) global, column-sharded
  const T* b;                 // (K, N) global, row-sharded
  T* out;                     // GEMM-RS: (M, N) global, row-sharded
  const long long* slab_tab;  // (W,) rank slabs, (W - 1, rows, N) each
  const long long* sig_tab;   // (W,) rank signals, (W - 1, tiles) each
  const long long* out_tab;   // GEMM-AR: (W,) rank outputs, (M, N) each
  const long long* ag_tab;    // GEMM-AR: (W,) rank signals, (W, tiles) each
  int world, rows, K, kl, N, split, ag, bpr, fault;
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

// The block copies a rows x cols tile of row stride ld from src to dst.
template <typename T>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, int rows,
                                          int cols, long long ld) {
  constexpr int V = 16 / sizeof(T);
  if (cols % V == 0 && ld % V == 0 &&
      ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) &
       15) == 0) {
    const int vc = cols / V;
    for (int e = threadIdx.x; e < rows * vc; e += blockDim.x) {
      const long long o = (e / vc) * ld + (e % vc) * V;
      *reinterpret_cast<uint4*>(dst + o) =
          *reinterpret_cast<const uint4*>(src + o);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
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

template <typename T, bool MMA>
__global__ void __launch_bounds__(kPfThreads, 1) rs_ring_kernel(RsArgs<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int BM = MMA ? kPfBM : kFmBM;
  constexpr int BN = MMA ? kPfBN : kFmBN;
  const int world = a.world;
  const int me = tdt_rank(a.bpr);
  const int j = static_cast<int>(blockIdx.x) % a.bpr;
  const int N = a.N;
  const int row_tiles = (a.rows + BM - 1) / BM;
  const int ct0 = (a.split + BN - 1) / BN;
  const int ct1 = (N - a.split + BN - 1) / BN;
  const int col_tiles = ct0 + ct1;
  const int tiles = row_tiles * col_tiles;
  const long long slab = static_cast<long long>(a.rows) * N;
  unsigned long long* sig_me =
      reinterpret_cast<unsigned long long*>(tdt_peer_ptr(a.sig_tab, me));
  T* slab_me = reinterpret_cast<T*>(tdt_peer_ptr(a.slab_tab, me));

  // The ring reduce-scatter; item (step, row tile, column tile).
  for (int i = j; i < world * tiles; i += a.bpr) {
    const int s = i / tiles;
    const int t = i % tiles;
    const int rt = t / col_tiles;
    const int ctj = t % col_tiles;
    const bool fwd = ctj < ct0;
    const int col0 = fwd ? ctj * BN : a.split + (ctj - ct0) * BN;
    const int cols = min(BN, (fwd ? a.split : N) - col0);
    const int row0 = rt * BM;
    const int last = s == world - 1;
    const int d = fwd ? 1 : world - 1;          // +1 or -1, mod world
    const int c = last ? me : (me + (world - d) * (s + 1)) % world;
    const T* recv = nullptr;
    if (s > 0) {
      tdt_signal_wait_until(sig_me + (s - 1) * tiles + t, a.epoch);
      recv = slab_me + (s - 1) * slab + static_cast<long long>(row0) * N +
             col0;
    }
    Tile<T> tile;
    tile.a = a.a + static_cast<long long>(c * a.rows + row0) * a.K +
             static_cast<long long>(me) * a.kl;
    tile.lda = a.K;
    tile.b = a.b + static_cast<long long>(me) * a.kl * N + col0;
    tile.bu = nullptr;
    tile.ldb = N;
    tile.bias_g = nullptr;
    tile.bias_u = nullptr;
    tile.rows = min(BM, a.rows - row0);
    tile.cols = cols;
    tile.K = a.kl;
    const long long at = static_cast<long long>(c * a.rows + row0) * N + col0;
    if (!last) {
      const int peer = (me + d) % world;
      T* dst = reinterpret_cast<T*>(tdt_peer_ptr(a.slab_tab, peer)) +
               s * slab + static_cast<long long>(row0) * N + col0;
      unsigned long long* sig = reinterpret_cast<unsigned long long*>(
          tdt_peer_ptr(a.sig_tab, peer)) + s * tiles + t;
      if (a.fault && me == 0 && s == 0) {
        release_after_block(sig, a.epoch);
        continue;
      }
      run_tile<T, MMA, BN, false>(tile, smem_raw, RsEpi<T>{recv, dst, N});
      release_after_block(sig, a.epoch);
    } else if (!a.ag) {
      run_tile<T, MMA, BN, false>(tile, smem_raw,
                                  RsEpi<T>{recv, a.out + at, N});
    } else {
      T* own = reinterpret_cast<T*>(tdt_peer_ptr(a.out_tab, me));
      run_tile<T, MMA, BN, false>(tile, smem_raw, RsEpi<T>{recv, own + at, N});
      unsigned long long* ag_me = reinterpret_cast<unsigned long long*>(
          tdt_peer_ptr(a.ag_tab, me));
      release_after_block(ag_me + me * tiles + t, a.epoch);
    }
  }
  if (!a.ag) return;

  // GEMM-AR: the ring all-gather; item (hop, row tile, column tile). Hop h
  // forwards chunk (me - h) from my buffer to my right neighbour's.
  T* own = reinterpret_cast<T*>(tdt_peer_ptr(a.out_tab, me));
  const unsigned long long* ag_me =
      reinterpret_cast<unsigned long long*>(tdt_peer_ptr(a.ag_tab, me));
  const int right = (me + 1) % world;
  T* right_out = reinterpret_cast<T*>(tdt_peer_ptr(a.out_tab, right));
  unsigned long long* ag_right =
      reinterpret_cast<unsigned long long*>(tdt_peer_ptr(a.ag_tab, right));
  for (int i = j; i < (world - 1) * tiles; i += a.bpr) {
    const int h = i / tiles;
    const int t = i % tiles;
    const int rt = t / col_tiles;
    const int ctj = t % col_tiles;
    const bool fwd = ctj < ct0;
    const int col0 = fwd ? ctj * BN : a.split + (ctj - ct0) * BN;
    const int cols = min(BN, (fwd ? a.split : N) - col0);
    const int row0 = rt * BM;
    const int c = (me - h + world) % world;
    tdt_signal_wait_until(ag_me + c * tiles + t, a.epoch);
    const long long at = static_cast<long long>(c * a.rows + row0) * N + col0;
    copy_tile(right_out + at, own + at, min(BM, a.rows - row0), cols, N);
    release_after_block(ag_right + c * tiles + t, a.epoch);
  }
}

template <typename T, bool MMA>
int smem_of() {
  if constexpr (MMA) return tile_smem_bytes<kPfBN, false>();
  return 0;
}

template <typename T, bool MMA>
cudaError_t resident(int* out) {
  static int cached = -1;
  if (cached < 0) {
    const int smem = smem_of<T, MMA>();
    int dev = 0, sms = 0, per_sm = 0, coop = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(rs_ring_kernel<T, MMA>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, rs_ring_kernel<T, MMA>, kPfThreads, smem);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    cached = sms * per_sm;
  }
  *out = cached;
  return cudaSuccess;
}

cudaError_t resident_of(int dtype, int mma, int* out) {
  if (dtype == 0)
    return mma ? resident<bf16, true>(out) : resident<bf16, false>(out);
  return resident<float, false>(out);
}

template <typename T, bool MMA>
cudaError_t launch(const RsArgs<T>& a, cudaStream_t stream) {
  const int smem = smem_of<T, MMA>();
  cudaError_t err = cudaFuncSetAttribute(
      rs_ring_kernel<T, MMA>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  void* params[] = {const_cast<RsArgs<T>*>(&a)};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(rs_ring_kernel<T, MMA>),
      dim3(a.world * a.bpr), dim3(kPfThreads), params, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(int mma, RsArgs<T> a, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    if (mma) return launch<T, true>(a, stream);
  }
  return launch<T, false>(a, stream);
}

}  // namespace

extern "C" {

// Blocks per rank of a `world`-rank launch in dtype (0: bf16, 1: f32) on
// the tensor-core path (`mma`, bf16 only) or the FMA path. Returns a
// cudaError_t.
int tdt_rs_ring_grid(int dtype, int mma, int world, int* bpr) {
  if (world < 2 || bpr == nullptr || (dtype != 0 && dtype != 1) ||
      (mma && dtype != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  int res = 0;
  const cudaError_t err = resident_of(dtype, mma, &res);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (res / world < 1)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  *bpr = res / world;
  return static_cast<int>(cudaSuccess);
}

// The number of (row tile, column tile) pairs of one chunk: the signal
// count of one step. Returns a cudaError_t.
int tdt_rs_ring_tiles(int mma, int rows, int n, int split, int* tiles) {
  if (rows < 1 || n < 1 || split < 0 || split > n || tiles == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bm = mma ? kPfBM : kFmBM;
  const int bn = mma ? kPfBN : kFmBN;
  *tiles = ((rows + bm - 1) / bm) *
           ((split + bn - 1) / bn + (n - split + bn - 1) / bn);
  return static_cast<int>(cudaSuccess);
}

// One launch over every rank: a (M, world * kl) column-sharded, b
// (world * kl, n) row-sharded, M = world * rows; columns [0, split) ride
// the forward ring, [split, n) the mirrored one. slab_tab / sig_tab: each
// rank's (world - 1, rows, n) slabs and (world - 1, tiles) signals. ag = 0:
// the row-sharded result goes to out (M, n). ag = 1 (GEMM-AR): out_tab /
// ag_tab are each rank's (M, n) output and (world, tiles) signals, and
// every rank's output ends holding the whole reduced result. Returns a
// cudaError_t.
int tdt_rs_ring(int dtype, int mma, const void* a, const void* b, void* out,
                const void* slab_tab, const void* sig_tab,
                const void* out_tab, const void* ag_tab, int ag, int world,
                int rows, int kl, int n, int split, unsigned long long epoch,
                int fault, void* stream) {
  if (a == nullptr || b == nullptr || slab_tab == nullptr ||
      sig_tab == nullptr || rows < 1 || kl < 1 || n < 1 || split < 0 ||
      split > n || epoch == 0 ||
      (ag ? out_tab == nullptr || ag_tab == nullptr : out == nullptr) ||
      (mma && (kl % 8 != 0 || n % 8 != 0 || split % 8 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  int bpr = 0;
  const int err = tdt_rs_ring_grid(dtype, mma, world, &bpr);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0) {
    RsArgs<bf16> args = {static_cast<const bf16*>(a),
                         static_cast<const bf16*>(b), static_cast<bf16*>(out),
                         static_cast<const long long*>(slab_tab),
                         static_cast<const long long*>(sig_tab),
                         static_cast<const long long*>(out_tab),
                         static_cast<const long long*>(ag_tab),
                         world, rows, world * kl, kl, n, split, ag, bpr,
                         fault, epoch};
    e = run<bf16>(mma, args, s);
  } else {
    RsArgs<float> args = {static_cast<const float*>(a),
                          static_cast<const float*>(b),
                          static_cast<float*>(out),
                          static_cast<const long long*>(slab_tab),
                          static_cast<const long long*>(sig_tab),
                          static_cast<const long long*>(out_tab),
                          static_cast<const long long*>(ag_tab),
                          world, rows, world * kl, kl, n, split, ag, bpr,
                          fault, epoch};
    e = run<float>(mma, args, s);
  }
  return static_cast<int>(e);
}

// The runtime's message for an error code returned above.
const char* tdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
