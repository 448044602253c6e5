// GEMM-AR at world = 1 for Hopper (sm_90a): C = A @ B with f32 accumulation.
//
// Replaces triton_dist_tpu/ops/gemm_reduce_scatter.py::_gemm_rs_kernel (:249)
// and ::_gemm_rs_hbm_nb_kernel (:353), the two TPU kernels `gemm_ar` (:898)
// picks between by VMEM footprint. At world = 1 their ring ReduceScatter and
// AllGather halves vanish and both reduce to o = x @ w (:280-282); the ring
// halves come with the multi-GPU slice.
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
//    tensor-core kernel `gemm_ar_mma`: a block holds up to 64 rows of A and a
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
//    are not what bounds the kernel. Prefill-sized products stay plain
//    products, as in the JAX package.
//
// Plain C entry points `tdt_gemm_ar_plan` and `tdt_gemm_ar`, loaded with
// ctypes. The launch runs on the stream it is given, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBN = 64;                 // columns per block
constexpr int kCPT = 8;                 // columns per thread (16 B of bf16)
constexpr int kCG = kBN / kCPT;         // column groups per block row
constexpr int kThreads = 256;
constexpr int kKL = kThreads / kCG;     // K lanes per block (32)
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;              // rows of B in flight per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as XLA's convert
}

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

// Sums the split-K partials in split order and casts: C = sum_z ws[z].
template <typename T>
__global__ void splitk_reduce(const float* __restrict__ ws,
                              T* __restrict__ C, int64_t mn, int splits) {
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += ws[z * mn + idx];
  C[idx] = from_f32<T>(s);
}

// ---------------------------------------------------------------------------
// Tensor-core path (bf16, N % 8 == 0, K % 8 == 0; operands 16-byte aligned).
//
// grid = (ceil(N / 64), ceil(M / 64), splits), 128 threads. A block holds up
// to 64 rows of A (MF m16 fragments) and one 64-column tile of B; each of its
// four warps owns 16 columns and runs mma.sync m16n8k16 (bf16 in, f32
// accumulate) over the block's K slice. A 4-stage cp.async pipeline keeps
// three 64-row chunks of B (and A) in flight while the fourth is multiplied,
// so B streams from HBM once for every row of the tile. Each output element
// has exactly one owner thread, summing its K slice in a fixed order.
constexpr int kTcBN = 64;                 // columns per block
constexpr int kTcBM = 64;                 // rows of A per block (4 x m16)
constexpr int kTcBK = 64;                 // K per pipeline stage
constexpr int kTcStages = 4;
constexpr int kTcThreads = 128;
constexpr int kTcLdA = kTcBK + 8;         // padded rows: conflict-free ldmatrix
constexpr int kTcLdB = kTcBN + 8;

template <int MF>
constexpr int tc_smem_bytes() {
  return kTcStages * (MF * 16 * kTcLdA + kTcBK * kTcLdB) *
         static_cast<int>(sizeof(__nv_bfloat16));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int bytes = valid ? 16 : 0;       // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int MF>
__global__ void __launch_bounds__(kTcThreads)
gemm_ar_mma(const __nv_bfloat16* __restrict__ A,
            const __nv_bfloat16* __restrict__ B, __nv_bfloat16* __restrict__ C,
            float* __restrict__ ws, int M, int N, int K, int k_per_split,
            int splits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + kTcStages * MF * 16 * kTcLdA;

  const int n0 = blockIdx.x * kTcBN;
  const int m0 = blockIdx.y * kTcBM;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int nk = k_end > k_begin ? (k_end - k_begin + kTcBK - 1) / kTcBK : 0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // Stage `kc` of this block's K slice into pipeline slot `slot`. Chunks of
  // 8 elements past M, N or the slice end are zero-filled (N and K are
  // multiples of 8 and the slice starts on a multiple of 64).
  auto load_stage = [&](int slot, int kc) {
    const int k0 = k_begin + kc * kTcBK;
    __nv_bfloat16* as = As + slot * MF * 16 * kTcLdA;
    __nv_bfloat16* bs = Bs + slot * kTcBK * kTcLdB;
    for (int c = tid; c < MF * 16 * (kTcBK / 8); c += kTcThreads) {
      const int r = c / (kTcBK / 8);
      const int kk = (c % (kTcBK / 8)) * 8;
      const bool ok = m0 + r < M && k0 + kk < k_end;
      const __nv_bfloat16* src =
          ok ? A + static_cast<size_t>(m0 + r) * K + k0 + kk : A;
      cp_async16(as + r * kTcLdA + kk, src, ok);
    }
    for (int c = tid; c < kTcBK * (kTcBN / 8); c += kTcThreads) {
      const int r = c / (kTcBN / 8);
      const int nn = (c % (kTcBN / 8)) * 8;
      const bool ok = k0 + r < k_end && n0 + nn < N;
      const __nv_bfloat16* src =
          ok ? B + static_cast<size_t>(k0 + r) * N + n0 + nn : B;
      cp_async16(bs + r * kTcLdB + nn, src, ok);
    }
  };

  float acc[MF][2][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();  // stage kc landed; slot (kc - 1) % stages is free
    const int next = kc + kTcStages - 1;
    if (next < nk) load_stage(next % kTcStages, next);
    cp_async_commit();

    const int slot = kc % kTcStages;
    const __nv_bfloat16* as = As + slot * MF * 16 * kTcLdA;
    const __nv_bfloat16* bs = Bs + slot * kTcBK * kTcLdB;
    // The tensor core's own accumulation is not a full IEEE f32 sum over
    // thousands of terms: each stage's 64-term products accumulate in
    // `part`, which is then added to `acc` in f32.
    float part[MF][2][4];
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kTcBK; ks += 16) {
      // B: rows ks..ks+15 of this warp's 16 columns, transposed into the
      // "col" operand: regs 0-1 feed columns +0..7, regs 2-3 columns +8..15.
      unsigned bfr[4];
      ldmatrix_x4_trans(
          bfr, bs + (ks + (lane & 15)) * kTcLdB + warp * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int mf = 0; mf < MF; ++mf) {
        unsigned afr[4];
        ldmatrix_x4(afr,
                    as + (mf * 16 + (lane & 15)) * kTcLdA + ks + (lane >> 4) * 8);
        mma_bf16(part[mf][0], afr, bfr[0], bfr[1]);
        mma_bf16(part[mf][1], afr, bfr[2], bfr[3]);
      }
    }
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  cp_async_wait<0>();

  // Accumulator layout of m16n8: c0,c1 at (row g, cols 2t, 2t+1), c2,c3 at
  // row g + 8, with g = lane / 4 and t = lane % 4.
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mf = 0; mf < MF; ++mf) {
#pragma unroll
    for (int nf = 0; nf < 2; ++nf) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + mf * 16 + g + (e >> 1) * 8;
        const int n = n0 + warp * 16 + nf * 8 + 2 * t + (e & 1);
        if (m >= M || n >= N) continue;
        if (splits == 1) {
          C[static_cast<size_t>(m) * N + n] = from_f32<__nv_bfloat16>(acc[mf][nf][e]);
        } else {
          ws[(static_cast<size_t>(blockIdx.z) * M + m) * N + n] = acc[mf][nf][e];
        }
      }
    }
  }
}

template <int MF>
cudaError_t launch_mma(const __nv_bfloat16* a, const __nv_bfloat16* b,
                       __nv_bfloat16* c, float* ws, int M, int N, int K,
                       int splits, cudaStream_t stream) {
  constexpr int smem = tc_smem_bytes<MF>();
  // The attribute belongs to the current device: set it on every launch
  // (it is cheap) so a second card is configured too.
  const cudaError_t err = cudaFuncSetAttribute(
      gemm_ar_mma<MF>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // Each split starts on a multiple of kTcBK, so chunks never straddle it.
  int k_per_split = (K + splits - 1) / splits;
  k_per_split = (k_per_split + kTcBK - 1) / kTcBK * kTcBK;
  dim3 grid((N + kTcBN - 1) / kTcBN, (M + kTcBM - 1) / kTcBM, splits);
  gemm_ar_mma<MF><<<grid, kTcThreads, smem, stream>>>(a, b, c, ws, M, N, K,
                                                      k_per_split, splits);
  return cudaSuccess;
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

cudaError_t run_mma(const __nv_bfloat16* A, const __nv_bfloat16* B,
                    __nv_bfloat16* C, float* W, int M, int N, int K,
                    int splits, cudaStream_t stream) {
  if (M <= 16) return launch_mma<1>(A, B, C, W, M, N, K, splits, stream);
  if (M <= 32) return launch_mma<2>(A, B, C, W, M, N, K, splits, stream);
  return launch_mma<4>(A, B, C, W, M, N, K, splits, stream);
}

template <typename T>
void reduce_splits(float* W, T* C, int M, int N, int splits,
                   cudaStream_t stream) {
  const int64_t mn = static_cast<int64_t>(M) * N;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((mn + threads - 1) / threads);
  splitk_reduce<T><<<blocks, threads, 0, stream>>>(W, C, mn, splits);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

constexpr int kMinKPerSplit = 256;  // do not split K finer than this

// How one call is launched. The path depends on the dtype and the shape
// only, never on where the operands lie, so equal inputs give equal bits.
struct Plan {
  int path;    // 0: FMA kernel, 1: tensor-core kernel
  int tiles;   // output tiles (blocks of one split)
  int splits;  // K splits (grid.z)
};

// The split count doubles while the grid stays within about two blocks
// per SM and each split keeps at least kMinKPerSplit rows of B. It is a
// function of the shape, the path and the card, so repeated calls sum in
// the same order.
Plan make_plan(int M, int N, int K, int sms, int dtype) {
  Plan p;
  p.path = (dtype == 0 && N % 8 == 0 && K % 8 == 0) ? 1 : 0;
  const int bn = p.path ? kTcBN : kBN;
  const int bm = p.path ? kTcBM : fma_rows(M);
  p.tiles = ((N + bn - 1) / bn) * ((M + bm - 1) / bm);
  p.splits = 1;
  while (static_cast<int64_t>(p.tiles) * p.splits * 2 <= 2 * sms &&
         K / (p.splits * 2) >= kMinKPerSplit)
    p.splits *= 2;
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
    if (p.path == 1) {
      const cudaError_t err = run_mma(A, B, C, W, M, N, K, p.splits, s);
      if (err != cudaSuccess) return static_cast<int>(err);
    } else {
      run_fma<T>(A, B, C, W, M, N, K, p.splits, s);
    }
    if (p.splits > 1) reduce_splits<T>(W, C, M, N, p.splits, s);
  } else if (dtype == 1) {
    run_fma<float>(static_cast<const float*>(a), static_cast<const float*>(b),
                   static_cast<float*>(c), W, M, N, K, p.splits, s);
    if (p.splits > 1) reduce_splits<float>(W, static_cast<float*>(c), M, N,
                                           p.splits, s);
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
