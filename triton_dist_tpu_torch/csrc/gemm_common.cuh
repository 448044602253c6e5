// Pieces shared by the port's GEMM kernels for Hopper (sm_90a):
// gemm_ar.cu (GEMM-AR at world = 1) and ag_gemm.cu (AG-GEMM, AG-SwiGLU and
// the GEMM of GEMM-RS at world = 1).
//
//  * conversions, cp.async, ldmatrix and mma.sync m16n8k16 (bf16 in, f32
//    accumulate) wrappers;
//  * `Segs`: up to three products C_i = A @ B_i that share A, each with its
//    own B pointer, output pointer and width, laid side by side as one
//    concatenated width (a block finds its product from its column tile);
//  * `stream_mma`: the B-streaming tensor-core kernel of small-M (decode)
//    products, with the split-K count `splitk_count` and the fixed-order
//    split reduce `splitk_reduce`. gemm_ar runs it with one product,
//    ag_gemm's decode plan with up to three.
//
// Every sum has a fixed order and there are no atomics: equal inputs give
// equal bits from run to run.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ---------------------------------------------------------------------------
// Products that share A: C_i (M, n[i]) = A (M, K) @ B_i (K, n[i]), all
// row-major. Product i owns columns [col0[i], col0[i+1]) of the
// concatenated width and column tiles [tile0[i], tile0[i+1]) of a kernel
// whose tiles are `bn` wide.
constexpr int kMaxSegs = 3;

template <typename T>
struct Segs {
  const T* b[kMaxSegs];
  T* c[kMaxSegs];
  int n[kMaxSegs];
  int col0[kMaxSegs + 1];
  int tile0[kMaxSegs + 1];
  int count;
};

template <typename T>
Segs<T> make_segs(int count, const T* const* b, T* const* c, const int* n,
                  int bn) {
  Segs<T> s = {};
  s.count = count;
  for (int i = 0; i < count; ++i) {
    s.b[i] = b[i];
    s.c[i] = c[i];
    s.n[i] = n[i];
    s.col0[i + 1] = s.col0[i] + n[i];
    s.tile0[i + 1] = s.tile0[i] + (n[i] + bn - 1) / bn;
  }
  return s;
}

// The product a column tile belongs to.
template <typename T>
__device__ __forceinline__ int seg_of_tile(const Segs<T>& s, int tile) {
  int i = 0;
#pragma unroll
  for (int j = 1; j < kMaxSegs; ++j)
    if (j < s.count && tile >= s.tile0[j]) i = j;
  return i;
}

// The product a column of the concatenated width belongs to.
template <typename T>
__device__ __forceinline__ int seg_of_col(const Segs<T>& s, int col) {
  int i = 0;
#pragma unroll
  for (int j = 1; j < kMaxSegs; ++j)
    if (j < s.count && col >= s.col0[j]) i = j;
  return i;
}

// Field `i` of a Segs array, read with constant indices only: a runtime
// index into a kernel parameter copies the whole parameter to local memory.
template <typename V>
__device__ __forceinline__ V seg_field(const V (&f)[kMaxSegs], int i) {
  static_assert(kMaxSegs == 3, "seg_field selects among three products");
  return i == 0 ? f[0] : i == 1 ? f[1] : f[2];
}
template <typename V>
__device__ __forceinline__ V seg_field(const V (&f)[kMaxSegs + 1], int i) {
  return i == 0 ? f[0] : i == 1 ? f[1] : i == 2 ? f[2] : f[3];
}

// The concatenated width of all products.
template <typename T>
__device__ __forceinline__ int seg_width(const Segs<T>& s) {
  return seg_field(s.col0, s.count);
}

// ---------------------------------------------------------------------------
// The split-K count of a small-M product: it doubles while the grid stays
// within about two blocks per SM and each split keeps at least
// kMinKPerSplit rows of B. A function of the shape and the card only, so
// repeated calls sum in the same order.
constexpr int kMinKPerSplit = 256;

int splitk_count(int tiles, int K, int sms) {
  int splits = 1;
  while (static_cast<int64_t>(tiles) * splits * 2 <= 2 * sms &&
         K / (splits * 2) >= kMinKPerSplit)
    splits *= 2;
  return splits;
}

// Sums the split-K partials in split order and casts. ws is
// (splits, M, ncat) f32 over the concatenated width; column c of row m
// goes to its product's output.
template <typename T>
__global__ void splitk_reduce(const float* __restrict__ ws, Segs<T> segs,
                              int M, int splits) {
  const int ncat = seg_width(segs);
  const int64_t mn = static_cast<int64_t>(M) * ncat;
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += ws[z * mn + idx];
  const int m = static_cast<int>(idx / ncat);
  const int col = static_cast<int>(idx % ncat);
  const int i = seg_of_col(segs, col);
  seg_field(segs.c, i)[static_cast<size_t>(m) * seg_field(segs.n, i) +
                       (col - seg_field(segs.col0, i))] = from_f32<T>(s);
}

template <typename T>
void reduce_splits(const float* W, const Segs<T>& segs, int M, int splits,
                   cudaStream_t stream) {
  const int64_t mn = static_cast<int64_t>(M) * segs.col0[segs.count];
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((mn + threads - 1) / threads);
  splitk_reduce<T><<<blocks, threads, 0, stream>>>(W, segs, M, splits);
}

// ---------------------------------------------------------------------------
// B-streaming tensor-core kernel (bf16, every n[i] % 8 == 0, K % 8 == 0;
// operands 16-byte aligned), for M <= 64.
//
// grid = (column tiles of all products, ceil(M / 64), splits), 128 threads.
// A block holds up to 64 rows of A (MF m16 fragments) and one 64-column
// tile of one product's B; each of its four warps owns 16 columns and runs
// mma.sync m16n8k16 (bf16 in, f32 accumulate) over the block's K slice. A
// 4-stage cp.async pipeline keeps three 64-row chunks of B (and A) in
// flight while the fourth is multiplied, so B streams from HBM once for
// every row of the tile. Each output element has exactly one owner thread,
// summing its K slice in a fixed order. With one split it writes C
// directly, otherwise its f32 partial goes to ws[z, m, col] over the
// concatenated width.
constexpr int kTcBN = 64;                 // columns per block
constexpr int kTcBM = 64;                 // rows of A per block (4 x m16)
constexpr int kTcBK = 64;                 // K per pipeline stage
constexpr int kTcStages = 4;
constexpr int kTcThreads = 128;
constexpr int kTcLdA = kTcBK + 8;         // padded rows: conflict-free ldmatrix
constexpr int kTcLdB = kTcBN + 8;

template <int MF>
constexpr int stream_smem_bytes() {
  return kTcStages * (MF * 16 * kTcLdA + kTcBK * kTcLdB) *
         static_cast<int>(sizeof(__nv_bfloat16));
}

template <int MF>
__global__ void __launch_bounds__(kTcThreads)
stream_mma(const __nv_bfloat16* __restrict__ A, Segs<__nv_bfloat16> segs,
           float* __restrict__ ws, int M, int K, int k_per_split,
           int splits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + kTcStages * MF * 16 * kTcLdA;

  const int seg = seg_of_tile(segs, blockIdx.x);
  const __nv_bfloat16* __restrict__ B = seg_field(segs.b, seg);
  const int N = seg_field(segs.n, seg);
  const int n0 = (blockIdx.x - seg_field(segs.tile0, seg)) * kTcBN;
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
  const int ncat = seg_width(segs);
  const int col0 = seg_field(segs.col0, seg);
  __nv_bfloat16* __restrict__ C = seg_field(segs.c, seg);
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
          C[static_cast<size_t>(m) * N + n] =
              from_f32<__nv_bfloat16>(acc[mf][nf][e]);
        } else {
          ws[(static_cast<size_t>(blockIdx.z) * M + m) * ncat + col0 + n] =
              acc[mf][nf][e];
        }
      }
    }
  }
}

template <int MF>
cudaError_t launch_stream(const __nv_bfloat16* a,
                          const Segs<__nv_bfloat16>& segs, float* ws, int M,
                          int K, int splits, cudaStream_t stream) {
  constexpr int smem = stream_smem_bytes<MF>();
  // The attribute belongs to the current device: set it on every launch
  // (it is cheap) so a second card is configured too.
  const cudaError_t err = cudaFuncSetAttribute(
      stream_mma<MF>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // Each split starts on a multiple of kTcBK, so chunks never straddle it.
  int k_per_split = (K + splits - 1) / splits;
  k_per_split = (k_per_split + kTcBK - 1) / kTcBK * kTcBK;
  dim3 grid(segs.tile0[segs.count], (M + kTcBM - 1) / kTcBM, splits);
  stream_mma<MF><<<grid, kTcThreads, smem, stream>>>(a, segs, ws, M, K,
                                                     k_per_split, splits);
  return cudaSuccess;
}

// The streaming products of `segs` (tiles kTcBN wide), then the split
// reduce when there is more than one split.
cudaError_t run_stream(const __nv_bfloat16* A, const Segs<__nv_bfloat16>& segs,
                       float* W, int M, int K, int splits,
                       cudaStream_t stream) {
  cudaError_t err;
  if (M <= 16) err = launch_stream<1>(A, segs, W, M, K, splits, stream);
  else if (M <= 32) err = launch_stream<2>(A, segs, W, M, K, splits, stream);
  else err = launch_stream<4>(A, segs, W, M, K, splits, stream);
  if (err != cudaSuccess) return err;
  if (splits > 1) reduce_splits<__nv_bfloat16>(W, segs, M, splits, stream);
  return cudaSuccess;
}

}  // namespace
