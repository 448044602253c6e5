// GEMM-AR at world = 1 for Hopper (sm_90a): C = A @ B with f32 accumulation.
//
// Computes the function of triton_dist_tpu/ops/gemm_reduce_scatter.py::
// `gemm_ar` (:898) at world = 1, where its ring ReduceScatter and AllGather
// halves vanish and o = x @ w (:280-282) remains. Which TPU kernel JAX runs
// depends on the VMEM footprint (`_entry`, :712-741): at the Qwen3-8B decode
// o_proj (M = 4, K = 4096) `_gemm_rs_hbm_nb_kernel` (:353, m_blk 4, n_blk
// 512); `_gemm_rs_kernel` (:249, all in VMEM) only at small shapes such as
// the tests'; the down projection (K = 12288) has no in-budget `hbm` tiling
// and falls to `run_xla()`, a plain XLA dot (:735-741). The ring halves come
// with the multi-GPU slice.
//
// Shapes on the path: the decode o_proj (B, 4096) @ (4096, 4096) and down
// projection (B, 12288) @ (12288, 4096) of Qwen3-8B, with M = B the decode
// batch (1..64, ragged). A is (M, K), B is (K, N) in the JAX (in, out) layout,
// both row-major; C is (M, N) in A's dtype.
//
// What bounds it: the bytes of B. At M <= 64 the product does 2*M FLOPs per
// element of B, far below the ~295 FLOP/byte the card needs before its tensor
// cores matter, so the least time is sizeof(B) / 3.35 TB/s: 32 MiB (~10 us)
// for o_proj and 96 MiB (~30 us) for down.
//
// What the design does about it. Two kernels, picked by dtype and shape
// (make_plan, exported as tdt_gemm_ar_plan):
//  * bf16 with N and K multiples of 8 (every Qwen3 shape) takes the
//    tensor-core kernel `stream_tc` (stream.cuh): a warpgroup streams one
//    64-column tile of B through a deep ring of TMA stages (54-108 KB in
//    flight a block, two blocks an SM) and multiplies each stage on wgmma
//    with the weight tile as the 64-row side and the M <= 64 tokens as the
//    narrow one. B is read from HBM once for all rows. The K splits of a
//    column tile are one cluster; its rank 0 sums their f32 partials
//    through distributed shared memory in split order and rounds once, so
//    a call is one launch with no workspace. The split count
//    (stream_splits) fills the card in whole waves: Qwen3-8B's o_proj and
//    down take 2 splits (128 blocks on 132 SMs).
//  * f32, and bf16 at other shapes, take the FMA kernel `gemm_ar_partial`
//    (body `fma_stream_block`): eight neighbouring threads read one 16-byte
//    row segment of a 64-column tile of B, four rows in flight per thread,
//    and multiply it into all the rows of a small M tile (BM = 1, 2, 4 or
//    8) held in registers. It splits K too (splitk_count, about two blocks
//    per SM); the splits' f32 partials go to a workspace that the wrapper
//    allocates at the size the plan asks for, and `splitk_reduce` sums
//    them in a fixed order (0, 1, ...).
//  * Within a split every sum has a fixed order too. There are no atomics,
//    and the path depends on dtype and shape only, so the result is
//    bit-identical from run to run.
//
// The plan (stream_plan), the split counts and the FMA body live in
// gemm_common.cuh, the tensor-core body in stream.cuh, shared with
// ag_gemm.cu (whose decode plan runs the same kernel over up to three
// products) and gemm_rs_ring.cu (whose decode body runs both bodies on
// each rank's shard, so its partials are this kernel's bits).
//
// Plain C entry points `tdt_gemm_ar_plan` and `tdt_gemm_ar`, loaded with
// ctypes. The launch runs on the stream it is given, allocates nothing and
// returns cudaGetLastError().

#include "stream.cuh"

namespace {

// grid = (ceil(N / 64), ceil(M / BM), splits): one block per item of
// gemm_common.cuh's FMA body. With one split it writes C directly,
// otherwise the partial goes to ws[z, m, n].
template <typename T, int BM>
__global__ void __launch_bounds__(kFaThreads)
gemm_ar_partial(const T* __restrict__ A, const T* __restrict__ B,
                T* __restrict__ C, float* __restrict__ ws, int M, int N,
                int K, int k_per_split, int splits, int vec) {
  fma_stream_block<T, BM>(A, K, B, C, ws, M, N, K, k_per_split, splits == 1,
                          vec != 0, blockIdx.x, blockIdx.y, blockIdx.z);
}

template <typename T, int BM>
void launch_partial(const T* a, const T* b, T* c, float* ws, int M, int N,
                    int K, int splits, int vec, cudaStream_t stream) {
  const int k_per_split = stream_k_per_split(K, splits, 0);
  dim3 grid((N + kFaBN - 1) / kFaBN, (M + BM - 1) / BM, splits);
  gemm_ar_partial<T, BM><<<grid, kFaThreads, 0, stream>>>(
      a, b, c, ws, M, N, K, k_per_split, splits, vec);
}

template <typename T>
void run_fma(const T* A, const T* B, T* C, float* W, int M, int N, int K,
             int splits, cudaStream_t stream) {
  const int vec = (N % kFaCPT == 0) &&
                  (reinterpret_cast<uintptr_t>(B) % 16 == 0);
  switch (fma_rows(M)) {
    case 1: launch_partial<T, 1>(A, B, C, W, M, N, K, splits, vec, stream);
      break;
    case 2: launch_partial<T, 2>(A, B, C, W, M, N, K, splits, vec, stream);
      break;
    case 4: launch_partial<T, 4>(A, B, C, W, M, N, K, splits, vec, stream);
      break;
    default: launch_partial<T, 8>(A, B, C, W, M, N, K, splits, vec, stream);
  }
}

}  // namespace

extern "C" {

// The launch plan of C = A @ B (M, K) x (K, N) on a card with `sms` SMs
// (gemm_common.cuh's stream_plan). dtype: 0 = bfloat16, 1 = float32. Fills
// *path (0: the FMA kernel, 1: the tensor-core kernel, taken by bf16 with N
// and K multiples of 8), *tiles (output tiles), *splits (K splits; the
// tensor-core kernel's are one cluster), *k_per_split (K rows of a split)
// and *ws (the f32 workspace a launch needs: the FMA kernel's splits x M x
// N when it splits, else 0). Returns a cudaError_t.
int tdt_gemm_ar_plan(int M, int N, int K, int sms, int dtype, int* path,
                     int* tiles, int* splits, int* k_per_split,
                     long long* ws) {
  if (M <= 0 || N <= 0 || K <= 0 || sms <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const StreamPlan p = stream_plan(M, N, K, sms, dtype);
  *path = p.mma;
  *tiles = p.col_tiles * p.row_tiles;
  *splits = p.splits;
  *k_per_split = p.k_per_split;
  *ws = p.workspace;
  return static_cast<int>(cudaSuccess);
}

// C = A @ B as tdt_gemm_ar_plan plans it for the same arguments; ws holds
// the workspace that plan asks for (may be null when it asks for none). A
// and B must be 16-byte aligned. Returns a cudaError_t.
int tdt_gemm_ar(const void* a, const void* b, void* c, void* ws, int M, int N,
                int K, int sms, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || sms <= 0 || !aligned16(a) ||
      !aligned16(b) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const StreamPlan p = stream_plan(M, N, K, sms, dtype);
  if (p.splits > 65535 || (p.workspace > 0 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* W = static_cast<float*>(ws);
  if (dtype == 0) {
    using T = __nv_bfloat16;
    const T* A = static_cast<const T*>(a);
    const T* B = static_cast<const T*>(b);
    T* C = static_cast<T*>(c);
    if (p.mma) {
      const cudaError_t err =
          run_stream(A, make_segs<T>(1, &B, &C, &N, kTcBN), M, K, p.splits, s);
      if (err != cudaSuccess) return static_cast<int>(err);
    } else {
      run_fma<T>(A, B, C, W, M, N, K, p.splits, s);
      if (p.splits > 1)
        reduce_splits<T>(W, make_segs<T>(1, &B, &C, &N, kFaBN), M, p.splits,
                         s);
    }
  } else {
    using T = float;
    const T* A = static_cast<const T*>(a);
    const T* B = static_cast<const T*>(b);
    T* C = static_cast<T*>(c);
    run_fma<T>(A, B, C, W, M, N, K, p.splits, s);
    if (p.splits > 1)
      reduce_splits<T>(W, make_segs<T>(1, &B, &C, &N, kFaBN), M, p.splits,
                       s);
  }
  return static_cast<int>(cudaGetLastError());
}

// The runtime's message for an error code returned above.
const char* tdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
