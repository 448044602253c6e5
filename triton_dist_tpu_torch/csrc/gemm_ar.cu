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
//    tensor-core kernel `stream_mma`: a block holds up to 64 rows of A and a
//    64-column tile of B, and a 4-stage cp.async pipeline streams B through
//    shared memory, 16 bytes per copy, three 64-row chunks in flight while
//    mma.sync multiplies the fourth. B is read from HBM once for all rows.
//    Each 64-term stage accumulates in the tensor core and is then added to
//    an f32 register sum, so long K sums stay within one bf16 ulp of the
//    f32 reference.
//  * f32, and bf16 at other shapes, take the FMA kernel `gemm_ar_partial`:
//    eight neighbouring threads read one 16-byte row segment of a 64-column
//    tile of B, four rows in flight per thread, and multiply it into all the
//    rows of a small M tile (BM = 1, 2, 4 or 8) held in registers.
//  * One block per 64-column tile would fill only N / 64 = 64 of the 132 SMs
//    at N = 4096, so both kernels split K across blocks too (grid.z), about
//    two blocks per SM. Each split writes f32 partials to a workspace that
//    the wrapper allocates at the size the plan asks for, and
//    `splitk_reduce` sums the splits in a fixed order (0, 1, ...). Within a
//    split every sum has a fixed order too. There are no atomics, and the
//    path depends on dtype and shape only, so the result is bit-identical
//    from run to run.
//  * No wgmma / TMA / persistent blocks yet: at these shapes the tensor cores
//    are not what bounds the kernel. Prefill-sized products of mode "ag_rs"
//    go to ag_gemm.cu's tiled kernel instead.
//
// The tensor-core kernel, the split count and the split reduce live in
// gemm_common.cuh, shared with ag_gemm.cu (whose decode plan runs the same
// kernel over up to three products).
//
// Plain C entry points `tdt_gemm_ar_plan` and `tdt_gemm_ar`, loaded with
// ctypes. The launch runs on the stream it is given, allocates nothing and
// returns cudaGetLastError().

#include "gemm_common.cuh"

namespace {

constexpr int kBN = 64;                 // columns per block
constexpr int kCPT = 8;                 // columns per thread (16 B of bf16)
constexpr int kCG = kBN / kCPT;         // column groups per block row
constexpr int kThreads = 256;
constexpr int kKL = kThreads / kCG;     // K lanes per block (32)
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;              // rows of B in flight per thread

// Loads kCPT consecutive elements of one row of B as f32; elements past
// `valid` read as 0. `vec` says the row segment is 16-byte aligned.
template <typename T>
__device__ __forceinline__ void load_cols(const T* __restrict__ p, int valid,
                                          bool vec, float (&v)[kCPT]) {
  if (vec && valid == kCPT) {
    if constexpr (sizeof(T) == 2) {
      uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < kCPT / 2; ++j) {
        float2 f = __bfloat1622float2(h[j]);
        v[2 * j] = f.x;
        v[2 * j + 1] = f.y;
      }
    } else {
      const float4* q = reinterpret_cast<const float4*>(p);
      float4 lo = __ldg(q);
      float4 hi = __ldg(q + 1);
      v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
      v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kCPT; ++j) v[j] = j < valid ? to_f32(p[j]) : 0.f;
  }
}

// grid = (ceil(N / kBN), ceil(M / BM), splits). Block (x, y, z) computes the
// f32 partial of rows [y*BM, y*BM+BM) and columns [x*kBN, x*kBN+kBN) over
// K rows [z*k_per_split, (z+1)*k_per_split). With one split it writes C
// directly, otherwise the partial goes to ws[z, m, n].
template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
gemm_ar_partial(const T* __restrict__ A, const T* __restrict__ B,
                T* __restrict__ C, float* __restrict__ ws, int M, int N,
                int K, int k_per_split, int splits, int vec) {
  __shared__ float red[kWarps][BM][kBN];

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int cg = threadIdx.x % kCG;
  const int kl = threadIdx.x / kCG;
  const int col = n0 + cg * kCPT;
  const int valid = max(0, min(kCPT, N - col));
  const int rows = min(BM, M - m0);
  const T* a_rows = A + static_cast<size_t>(m0) * K;

  float acc[BM][kCPT];
#pragma unroll
  for (int i = 0; i < BM; ++i)
#pragma unroll
    for (int j = 0; j < kCPT; ++j) acc[i][j] = 0.f;

  if (valid > 0) {
    int k = k_begin + kl;
    for (; k + (kUnroll - 1) * kKL < k_end; k += kUnroll * kKL) {
      float bv[kUnroll][kCPT];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        load_cols(B + static_cast<size_t>(k + u * kKL) * N + col, valid,
                  vec != 0, bv[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int i = 0; i < BM; ++i) {
          const float a = i < rows
              ? to_f32(a_rows[static_cast<size_t>(i) * K + k + u * kKL])
              : 0.f;
#pragma unroll
          for (int j = 0; j < kCPT; ++j)
            acc[i][j] = fmaf(a, bv[u][j], acc[i][j]);
        }
      }
    }
    for (; k < k_end; k += kKL) {
      float bv[kCPT];
      load_cols(B + static_cast<size_t>(k) * N + col, valid, vec != 0, bv);
#pragma unroll
      for (int i = 0; i < BM; ++i) {
        const float a =
            i < rows ? to_f32(a_rows[static_cast<size_t>(i) * K + k]) : 0.f;
#pragma unroll
        for (int j = 0; j < kCPT; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
      }
    }
  }

  // A warp holds 4 K lanes of all 8 column groups (lane = 8 * klane + cg):
  // fold them with a fixed shuffle pattern, then lanes 0..7 publish.
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int i = 0; i < BM; ++i) {
#pragma unroll
    for (int j = 0; j < kCPT; ++j) {
      float v = acc[i][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[i][j] = v;
    }
  }
  if (lane < kCG) {
#pragma unroll
    for (int i = 0; i < BM; ++i)
#pragma unroll
      for (int j = 0; j < kCPT; ++j) red[warp][i][lane * kCPT + j] = acc[i][j];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < BM * kBN; idx += kThreads) {
    const int i = idx / kBN;
    const int c = idx % kBN;
    const int m = m0 + i;
    const int n = n0 + c;
    if (m >= M || n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][i][c];
    if (splits == 1) {
      C[static_cast<size_t>(m) * N + n] = from_f32<T>(s);
    } else {
      ws[(static_cast<size_t>(blockIdx.z) * M + m) * N + n] = s;
    }
  }
}

template <typename T, int BM>
void launch_partial(const T* a, const T* b, T* c, float* ws, int M, int N,
                    int K, int splits, int vec, cudaStream_t stream) {
  const int k_per_split = (K + splits - 1) / splits;
  dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, splits);
  gemm_ar_partial<T, BM><<<grid, kThreads, 0, stream>>>(
      a, b, c, ws, M, N, K, k_per_split, splits, vec);
}

// Rows of A one FMA block holds for M rows (the BM of gemm_ar_partial).
int fma_rows(int M) { return M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : 8; }

template <typename T>
void run_fma(const T* A, const T* B, T* C, float* W, int M, int N, int K,
             int splits, cudaStream_t stream) {
  const int vec = (N % kCPT == 0) &&
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

// How one call is launched. The path depends on the dtype and the shape
// only, never on where the operands lie, so equal inputs give equal bits.
struct Plan {
  int path;    // 0: FMA kernel, 1: tensor-core kernel
  int tiles;   // output tiles (blocks of one split)
  int splits;  // K splits (grid.z)
};

// The split count (splitk_count) is a function of the shape, the path and
// the card, so repeated calls sum in the same order.
Plan make_plan(int M, int N, int K, int sms, int dtype) {
  Plan p;
  p.path = (dtype == 0 && N % 8 == 0 && K % 8 == 0) ? 1 : 0;
  const int bn = p.path ? kTcBN : kBN;
  const int bm = p.path ? kTcBM : fma_rows(M);
  p.tiles = ((N + bn - 1) / bn) * ((M + bm - 1) / bm);
  p.splits = splitk_count(p.tiles, K, sms);
  return p;
}

}  // namespace

extern "C" {

// The launch plan of C = A @ B (M, K) x (K, N) on a card with `sms` SMs.
// dtype: 0 = bfloat16, 1 = float32. Fills *path (0: the FMA kernel, 1: the
// tensor-core kernel, taken by bf16 with N and K multiples of 8), *tiles
// (output tiles) and *splits (K splits). A launch with splits > 1 needs a
// workspace of splits * M * N floats. Returns a cudaError_t.
int tdt_gemm_ar_plan(int M, int N, int K, int sms, int dtype, int* path,
                     int* tiles, int* splits) {
  if (M <= 0 || N <= 0 || K <= 0 || sms <= 0 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(M, N, K, sms, dtype);
  *path = p.path;
  *tiles = p.tiles;
  *splits = p.splits;
  return static_cast<int>(cudaSuccess);
}

// C = A @ B as tdt_gemm_ar_plan plans it for the same arguments; ws holds
// the workspace that plan asks for (may be null with one split). A and B
// must be 16-byte aligned. Returns a cudaError_t.
int tdt_gemm_ar(const void* a, const void* b, void* c, void* ws, int M, int N,
                int K, int sms, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || sms <= 0 || !aligned16(a) ||
      !aligned16(b))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(M, N, K, sms, dtype);
  if (p.splits > 65535 || (p.splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* W = static_cast<float*>(ws);
  if (dtype == 0) {
    using T = __nv_bfloat16;
    const T* A = static_cast<const T*>(a);
    const T* B = static_cast<const T*>(b);
    T* C = static_cast<T*>(c);
    const Segs<T> segs = make_segs<T>(1, &B, &C, &N, kTcBN);
    if (p.path == 1) {
      const cudaError_t err = run_stream(A, segs, W, M, K, p.splits, s);
      if (err != cudaSuccess) return static_cast<int>(err);
    } else {
      run_fma<T>(A, B, C, W, M, N, K, p.splits, s);
      if (p.splits > 1) reduce_splits<T>(W, segs, M, p.splits, s);
    }
  } else if (dtype == 1) {
    using T = float;
    const T* A = static_cast<const T*>(a);
    const T* B = static_cast<const T*>(b);
    T* C = static_cast<T*>(c);
    run_fma<T>(A, B, C, W, M, N, K, p.splits, s);
    if (p.splits > 1)
      reduce_splits<T>(W, make_segs<T>(1, &B, &C, &N, kBN), M, p.splits, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The runtime's message for an error code returned above.
const char* tdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
