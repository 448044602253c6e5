// Pieces shared by the port's GEMM kernels for Hopper (sm_90a):
// gemm_ar.cu (GEMM-AR at world = 1), ag_gemm.cu (AG-GEMM, AG-SwiGLU and
// the GEMM of GEMM-RS at world = 1), gemm_rs_ring.cu (GEMM-RS / GEMM-AR
// at world W, whose decode body runs the two small-M bodies below) and
// ag_gemm_ring.cu (AG-GEMM at world W, whose decode body runs the
// tensor-core one on each rank's column shard).
//
//  * conversions, cp.async, ldmatrix and mma.sync m16n8k16 (bf16 in, f32
//    accumulate) wrappers;
//  * `Segs`: up to three products C_i = A @ B_i that share A, each with its
//    own B pointer, output pointer and width, laid side by side as one
//    concatenated width (a block finds its product from its column tile);
//  * the small-M (decode) products and their plan (`stream_plan`: body,
//    tiles, the split-K count `splitk_count`): `stream_mma_block`, the
//    B-streaming tensor-core body, and `fma_stream_block`, its FMA
//    counterpart (f32 and odd bf16 shapes), each one block's work;
//    `stream_mma`, the kernel of the tensor-core body, and the fixed-order
//    split reduce `splitk_reduce`. gemm_ar runs them with one product,
//    ag_gemm's decode plan `stream_mma` with up to three, and the AG ring
//    `stream_mma_block` with B-first prologue (`kBFirst`).
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
// row-major, B_i and C_i with row stride ld[i] (n[i], or a wider tensor's
// when they are a column shard of it). Product i owns columns [col0[i],
// col0[i+1]) of the concatenated width and column tiles [tile0[i],
// tile0[i+1]) of a kernel whose tiles are `bn` wide.
constexpr int kMaxSegs = 3;

template <typename T>
struct Segs {
  const T* b[kMaxSegs];
  T* c[kMaxSegs];
  int n[kMaxSegs];
  int ld[kMaxSegs];
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
    s.ld[i] = n[i];
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
// B-streaming tensor-core body (bf16, every n[i] % 8 == 0, K % 8 == 0;
// operands 16-byte aligned), for M <= 64: one block's work, 128 threads.
//
// The block computes column tile `tile` of the concatenated width, rows
// [mt * 64, mt * 64 + 64) and K rows [z * k_per_split, (z + 1) *
// k_per_split) of A (row stride lda) times B. It holds up to 64 rows of A
// (MF m16 fragments) and one 64-column tile of one product's B; each of
// its four warps owns 16 columns and runs mma.sync m16n8k16 (bf16 in, f32
// accumulate) over the block's K slice. A 4-stage cp.async pipeline keeps
// three 64-row chunks of B (and A) in flight while the fourth is
// multiplied, so B streams from HBM once for every row of the tile. Each
// output element has exactly one owner thread, summing its K slice in a
// fixed order. `direct` (one split): it writes C rounded; otherwise its
// f32 partial goes to ws[z, m, col] over the concatenated width. A caller
// that runs the body for more than one item syncs the block between
// them (the stages' shared memory is reused).
//
// kBFirst (a compile-time variant of the prologue, for an A that other
// blocks are still writing): the first stages' copies of B are issued,
// then `ready()` (every thread of the block calls it; it returns once A
// may be read), then A's. The sums do not change.
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

// The `ready` of a block whose A is in place before it starts.
struct NoWait {
  __device__ __forceinline__ void operator()() const {}
};

template <int MF, bool kBFirst = false, class Ready = NoWait>
__device__ __forceinline__ void stream_mma_block(
    const __nv_bfloat16* __restrict__ A, long long lda,
    const Segs<__nv_bfloat16>& segs, float* __restrict__ ws, int M, int K,
    int k_per_split, bool direct, int tile, int mt, int z,
    unsigned char* smem_raw, const Ready& ready = Ready{}) {
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + kTcStages * MF * 16 * kTcLdA;

  const int seg = seg_of_tile(segs, tile);
  const __nv_bfloat16* __restrict__ B = seg_field(segs.b, seg);
  const int N = seg_field(segs.n, seg);
  const long long ldn = seg_field(segs.ld, seg);
  const int n0 = (tile - seg_field(segs.tile0, seg)) * kTcBN;
  const int m0 = mt * kTcBM;
  const int k_begin = z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int nk = k_end > k_begin ? (k_end - k_begin + kTcBK - 1) / kTcBK : 0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // Stage `kc` of this block's K slice into pipeline slot `slot`. Chunks of
  // 8 elements past M, N or the slice end are zero-filled (N and K are
  // multiples of 8 and the slice starts on a multiple of 64).
  auto load_a = [&](int slot, int kc) {
    const int k0 = k_begin + kc * kTcBK;
    __nv_bfloat16* as = As + slot * MF * 16 * kTcLdA;
    for (int c = tid; c < MF * 16 * (kTcBK / 8); c += kTcThreads) {
      const int r = c / (kTcBK / 8);
      const int kk = (c % (kTcBK / 8)) * 8;
      const bool ok = m0 + r < M && k0 + kk < k_end;
      const __nv_bfloat16* src =
          ok ? A + static_cast<size_t>(m0 + r) * lda + k0 + kk : A;
      cp_async16(as + r * kTcLdA + kk, src, ok);
    }
  };
  auto load_b = [&](int slot, int kc) {
    const int k0 = k_begin + kc * kTcBK;
    __nv_bfloat16* bs = Bs + slot * kTcBK * kTcLdB;
    for (int c = tid; c < kTcBK * (kTcBN / 8); c += kTcThreads) {
      const int r = c / (kTcBN / 8);
      const int nn = (c % (kTcBN / 8)) * 8;
      const bool ok = k0 + r < k_end && n0 + nn < N;
      const __nv_bfloat16* src =
          ok ? B + static_cast<size_t>(k0 + r) * ldn + n0 + nn : B;
      cp_async16(bs + r * kTcLdB + nn, src, ok);
    }
  };
  auto load_stage = [&](int slot, int kc) {
    load_a(slot, kc);
    load_b(slot, kc);
  };

  float acc[MF][2][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if constexpr (kBFirst) {
    // B's stages join the first commit group, so stage s's group still
    // holds all of stage s and the waits below count the same.
#pragma unroll
    for (int s = 0; s < kTcStages - 1; ++s)
      if (s < nk) load_b(s, s);
    ready();
#pragma unroll
    for (int s = 0; s < kTcStages - 1; ++s) {
      if (s < nk) load_a(s, s);
      cp_async_commit();
    }
  } else {
#pragma unroll
    for (int s = 0; s < kTcStages - 1; ++s) {
      if (s < nk) load_stage(s, s);
      cp_async_commit();
    }
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
        if (direct) {
          C[static_cast<size_t>(m) * ldn + n] =
              from_f32<__nv_bfloat16>(acc[mf][nf][e]);
        } else {
          ws[(static_cast<size_t>(z) * M + m) * ncat + col0 + n] =
              acc[mf][nf][e];
        }
      }
    }
  }
}

// grid = (column tiles of all products, ceil(M / 64), splits): one block
// per item of the body above.
template <int MF>
__global__ void __launch_bounds__(kTcThreads)
stream_mma(const __nv_bfloat16* __restrict__ A, Segs<__nv_bfloat16> segs,
           float* __restrict__ ws, int M, int K, int k_per_split,
           int splits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  stream_mma_block<MF>(A, K, segs, ws, M, K, k_per_split, splits == 1,
                       blockIdx.x, blockIdx.y, blockIdx.z, smem_raw);
}

// ---------------------------------------------------------------------------
// The FMA body (f32, and bf16 at shapes the tensor-core body does not
// take): one block of 256 threads computes rows [mt * BM, mt * BM + BM)
// (BM = 1, 2, 4 or 8, all held in registers) and columns [tile * 64,
// tile * 64 + 64) over K rows [z * k_per_split, (z + 1) * k_per_split).
// Eight neighbouring threads read one 16-byte row segment of the 64-column
// tile of B, four rows in flight per thread, and multiply it into every
// row of the tile; the K lanes are then folded in a fixed order (shuffles,
// then the warps in order). `direct` (one split): C rounded; otherwise
// the f32 partial goes to ws[z, m, n]. `vec`: B's row segments are
// 16-byte aligned (N % 8 == 0 and B aligned).
constexpr int kFaBN = 64;                 // columns per block
constexpr int kFaCPT = 8;                 // columns per thread (16 B of bf16)
constexpr int kFaCG = kFaBN / kFaCPT;     // column groups per block row
constexpr int kFaThreads = 256;
constexpr int kFaKL = kFaThreads / kFaCG; // K lanes per block (32)
constexpr int kFaWarps = kFaThreads / 32;
constexpr int kFaUnroll = 4;              // rows of B in flight per thread

// Loads kFaCPT consecutive elements of one row of B as f32; elements past
// `valid` read as 0. `vec` says the row segment is 16-byte aligned.
template <typename T>
__device__ __forceinline__ void fa_load_cols(const T* __restrict__ p,
                                             int valid, bool vec,
                                             float (&v)[kFaCPT]) {
  if (vec && valid == kFaCPT) {
    if constexpr (sizeof(T) == 2) {
      uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int j = 0; j < kFaCPT / 2; ++j) {
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
    for (int j = 0; j < kFaCPT; ++j) v[j] = j < valid ? to_f32(p[j]) : 0.f;
  }
}

template <typename T, int BM>
__device__ __forceinline__ void fma_stream_block(
    const T* __restrict__ A, long long lda, const T* __restrict__ B,
    T* __restrict__ C, float* __restrict__ ws, int M, int N, int K,
    int k_per_split, bool direct, bool vec, int tile, int mt, int z) {
  __shared__ float red[kFaWarps][BM][kFaBN];

  const int n0 = tile * kFaBN;
  const int m0 = mt * BM;
  const int k_begin = z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int cg = threadIdx.x % kFaCG;
  const int kl = threadIdx.x / kFaCG;
  const int col = n0 + cg * kFaCPT;
  const int valid = max(0, min(kFaCPT, N - col));
  const int rows = min(BM, M - m0);
  const T* a_rows = A + static_cast<size_t>(m0) * lda;

  float acc[BM][kFaCPT];
#pragma unroll
  for (int i = 0; i < BM; ++i)
#pragma unroll
    for (int j = 0; j < kFaCPT; ++j) acc[i][j] = 0.f;

  if (valid > 0) {
    int k = k_begin + kl;
    for (; k + (kFaUnroll - 1) * kFaKL < k_end; k += kFaUnroll * kFaKL) {
      float bv[kFaUnroll][kFaCPT];
#pragma unroll
      for (int u = 0; u < kFaUnroll; ++u)
        fa_load_cols(B + static_cast<size_t>(k + u * kFaKL) * N + col, valid,
                     vec, bv[u]);
#pragma unroll
      for (int u = 0; u < kFaUnroll; ++u) {
#pragma unroll
        for (int i = 0; i < BM; ++i) {
          const float a = i < rows
              ? to_f32(a_rows[static_cast<size_t>(i) * lda + k + u * kFaKL])
              : 0.f;
#pragma unroll
          for (int j = 0; j < kFaCPT; ++j)
            acc[i][j] = fmaf(a, bv[u][j], acc[i][j]);
        }
      }
    }
    for (; k < k_end; k += kFaKL) {
      float bv[kFaCPT];
      fa_load_cols(B + static_cast<size_t>(k) * N + col, valid, vec, bv);
#pragma unroll
      for (int i = 0; i < BM; ++i) {
        const float a =
            i < rows ? to_f32(a_rows[static_cast<size_t>(i) * lda + k]) : 0.f;
#pragma unroll
        for (int j = 0; j < kFaCPT; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
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
    for (int j = 0; j < kFaCPT; ++j) {
      float v = acc[i][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[i][j] = v;
    }
  }
  if (lane < kFaCG) {
#pragma unroll
    for (int i = 0; i < BM; ++i)
#pragma unroll
      for (int j = 0; j < kFaCPT; ++j)
        red[warp][i][lane * kFaCPT + j] = acc[i][j];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < BM * kFaBN; idx += kFaThreads) {
    const int i = idx / kFaBN;
    const int c = idx % kFaBN;
    const int m = m0 + i;
    const int n = n0 + c;
    if (m >= M || n >= N) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kFaWarps; ++w) s += red[w][i][c];
    if (direct) {
      C[static_cast<size_t>(m) * N + n] = from_f32<T>(s);
    } else {
      ws[(static_cast<size_t>(z) * M + m) * N + n] = s;
    }
  }
}

// ---------------------------------------------------------------------------
// The plan of one small-M product C = A @ B, (M, K) x (K, N), on a card
// with `sms` SMs: the tensor-core body for bf16 with N and K multiples of
// 8, else the FMA body; its rows per tile (64, or BM = 1, 2, 4 or 8), the
// output tiles, the K splits (splitk_count) and each split's K rows (a
// multiple of the pipeline's 64 on the tensor-core body). A function of
// the dtype (0: bf16, 1: f32), the shape and the card only, so equal
// inputs sum in the same order; gemm_ar.cu plans its world-1 launches with
// it and gemm_rs_ring.cu each rank's product of its decode body.
struct StreamPlan {
  int mma;          // 1: stream_mma_block, 0: fma_stream_block
  int bm;           // rows per tile
  int col_tiles;
  int row_tiles;
  int splits;
  int k_per_split;
};

// Whether the tensor-core body takes the product: bf16 (dtype 0) with N and
// K multiples of 8.
inline bool stream_mma_ok(int dtype, int N, int K) {
  return dtype == 0 && N % 8 == 0 && K % 8 == 0;
}

// Rows of A one FMA block holds for M rows.
inline int fma_rows(int M) { return M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : 8; }

// m16 fragments of A one tensor-core block holds for M rows.
inline int stream_frags(int M) { return M <= 16 ? 1 : M <= 32 ? 2 : 4; }

// K rows of one split. Each tensor-core split starts on a multiple of
// kTcBK, so the pipeline's chunks never straddle two splits.
inline int stream_k_per_split(int K, int splits, int mma) {
  const int k = (K + splits - 1) / splits;
  return mma ? (k + kTcBK - 1) / kTcBK * kTcBK : k;
}

inline StreamPlan stream_plan(int M, int N, int K, int sms, int dtype) {
  StreamPlan p;
  p.mma = stream_mma_ok(dtype, N, K) ? 1 : 0;
  p.bm = p.mma ? kTcBM : fma_rows(M);
  p.col_tiles = (N + (p.mma ? kTcBN : kFaBN) - 1) / (p.mma ? kTcBN : kFaBN);
  p.row_tiles = (M + p.bm - 1) / p.bm;
  p.splits = splitk_count(p.col_tiles * p.row_tiles, K, sms);
  p.k_per_split = stream_k_per_split(K, p.splits, p.mma);
  return p;
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
  const int k_per_split = stream_k_per_split(K, splits, 1);
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
  switch (stream_frags(M)) {
    case 1: err = launch_stream<1>(A, segs, W, M, K, splits, stream); break;
    case 2: err = launch_stream<2>(A, segs, W, M, K, splits, stream); break;
    default: err = launch_stream<4>(A, segs, W, M, K, splits, stream);
  }
  if (err != cudaSuccess) return err;
  if (splits > 1) reduce_splits<__nv_bfloat16>(W, segs, M, splits, stream);
  return cudaSuccess;
}

}  // namespace
