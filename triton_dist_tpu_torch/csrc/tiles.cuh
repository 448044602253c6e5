// One output tile of C = A @ B (or of the fused SwiGLU), shared by the
// world-1 kernels of ag_gemm.cu and the ring kernels of ag_gemm_ring.cu and
// gemm_rs_ring.cu, so a tile sums in the same order whichever kernel runs it.
//
//  * `mma_tile`: bf16 on the tensor cores (mma.sync m16n8k16, f32
//    accumulate), a 128 x BN tile, 256 threads (8 warps, 2 along M x 4
//    along N), a 4-stage cp.async pipeline of 64-deep K slices through
//    padded shared memory; every 128 K terms the tensor core's sum is added
//    to an f32 register sum.
//  * `fma_tile`: f32 (and odd bf16 shapes) on FMAs, a 64 x 64 tile, 256
//    threads of 4 x 4 outputs, K in slices of 16.
//
// A tile reads A from row 0 of `a` (stride lda) and B from column 0 of `b`
// (stride ldb): callers point them at the tile's first row and column, so
// a rank's shard of a global tensor is read in place. Rows past `rows` and
// columns past `cols` are zero-filled on load and never stored. The f32
// results go to an epilogue functor (`pair` for two neighbouring columns
// on the tensor-core path, `one` on the FMA path) that rounds and stores.

#pragma once

#include "gemm_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kPfBM = 128;                 // rows per tile
constexpr int kPfBK = 64;                  // K per pipeline stage
constexpr int kPfStages = 4;
constexpr int kPfFold = 2;                 // stages summed in the tensor core
constexpr int kPfThreads = 256;            // 8 warps: 2 along M x 4 along N
constexpr int kPfLdA = kPfBK + 8;          // padded rows: conflict-free ldmatrix
constexpr int kPfBN = 128;                 // columns per tile (plain)
constexpr int kPfBNSwiglu = 64;            // columns per tile (gate and up)

constexpr int kFmBM = 64;
constexpr int kFmBN = 64;
constexpr int kFmBK = 16;
constexpr int kFmThreads = 256;
static_assert(kFmThreads == kPfThreads, "one block shape for both paths");

template <int BN, bool SWIGLU>
constexpr int tile_smem_bytes() {
  return kPfStages * (kPfBM * kPfLdA + (SWIGLU ? 2 : 1) * kPfBK * (BN + 8)) *
         static_cast<int>(sizeof(bf16));
}

// SiLU(g) * u in f32, as the TPU kernel's epilogue (gate * sigmoid(gate) *
// up) computes it; expf, not the fast __expf.
__device__ __forceinline__ float swiglu(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

// The operands of one tile. `bu`, `bias_g` and `bias_u` are read only by
// the SwiGLU tile (the biases may be null); `bu` shares `ldb` with `b`.
template <typename T>
struct Tile {
  const T* a;
  long long lda;
  const T* b;
  const T* bu;
  long long ldb;
  const T* bias_g;
  const T* bias_u;
  int rows, cols, K;
};

// Rounds to T and stores at c[r * ldc + col].
template <typename T>
struct StoreEpi {
  T* c;
  long long ldc;
  __device__ __forceinline__ void pair(int r, int col, float v0,
                                       float v1) const {
    __nv_bfloat162 p;
    p.x = from_f32<bf16>(v0);
    p.y = from_f32<bf16>(v1);
    *reinterpret_cast<__nv_bfloat162*>(c + r * ldc + col) = p;
  }
  __device__ __forceinline__ void one(int r, int col, float v) const {
    c[r * ldc + col] = from_f32<T>(v);
  }
};

template <int BN, bool SWIGLU, class Epi>
__device__ __forceinline__ void mma_tile(const Tile<bf16>& t,
                                         unsigned char* smem_raw,
                                         const Epi& epi) {
  constexpr int NB = SWIGLU ? 2 : 1;       // B operands per stage
  constexpr int LDB = BN + 8;
  constexpr int WN = BN / 4;               // columns per warp
  constexpr int NP = WN / 16;              // 16-column ldmatrix groups
  constexpr int NF = 2 * NP;               // n8 fragments per warp
  constexpr int MF = kPfBM / 2 / 16;       // m16 fragments per warp
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Bs = As + kPfStages * kPfBM * kPfLdA;    // [stage][NB][BK][LDB]

  const int K = t.K;
  const int nk = (K + kPfBK - 1) / kPfBK;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp >> 2) * (kPfBM / 2);     // warp's first row
  const int wn = (warp & 3) * WN;               // warp's first column

  // A persistent block's previous tile may still read shared memory.
  __syncthreads();

  // Stage `kc` into pipeline slot `slot`: every thread copies the same
  // number of 16-byte chunks (constant trip counts, so the index math
  // folds). Chunks of 8 elements past the tile's rows, columns or K are
  // zero-filled (cols and K are multiples of 8).
  constexpr int kChunksA = kPfBM * (kPfBK / 8) / kPfThreads;
  constexpr int kChunksB = kPfBK * (BN / 8) / kPfThreads;
  static_assert(kChunksA * kPfThreads == kPfBM * (kPfBK / 8) &&
                kChunksB * kPfThreads == kPfBK * (BN / 8),
                "stage copies must split evenly over the threads");
  auto load_stage = [&](int slot, int kc) {
    const int k0 = kc * kPfBK;
    bf16* as = As + slot * kPfBM * kPfLdA;
#pragma unroll
    for (int i = 0; i < kChunksA; ++i) {
      const int c = tid + i * kPfThreads;
      const int r = c / (kPfBK / 8);
      const int kk = (c % (kPfBK / 8)) * 8;
      const bool ok = r < t.rows && k0 + kk < K;
      const bf16* src = ok ? t.a + r * t.lda + k0 + kk : t.a;
      cp_async16(as + r * kPfLdA + kk, src, ok);
    }
#pragma unroll
    for (int h = 0; h < NB; ++h) {
      const bf16* B = h == 0 ? t.b : t.bu;
      bf16* bs = Bs + (slot * NB + h) * kPfBK * LDB;
#pragma unroll
      for (int i = 0; i < kChunksB; ++i) {
        const int c = tid + i * kPfThreads;
        const int r = c / (BN / 8);
        const int nn = (c % (BN / 8)) * 8;
        const bool ok = k0 + r < K && nn < t.cols;
        const bf16* src = ok ? B + (k0 + r) * t.ldb + nn : B;
        cp_async16(bs + r * LDB + nn, src, ok);
      }
    }
  };

  // The tensor core's own accumulation is not a full IEEE f32 sum over
  // thousands of terms: the products of kPfFold stages (128 K terms)
  // accumulate in `part`, which is then added to `acc` in f32.
  float acc[NB][MF][NF][4];
  float part[NB][MF][NF][4];
#pragma unroll
  for (int h = 0; h < NB; ++h)
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kPfStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kPfStages - 2>();
    __syncthreads();  // stage kc landed; slot (kc - 1) % stages is free
    const int next = kc + kPfStages - 1;
    if (next < nk) load_stage(next % kPfStages, next);
    cp_async_commit();

    const int slot = kc % kPfStages;
    const bf16* as = As + slot * kPfBM * kPfLdA;
    if (kc % kPfFold == 0) {
#pragma unroll
      for (int h = 0; h < NB; ++h)
#pragma unroll
        for (int i = 0; i < MF; ++i)
#pragma unroll
          for (int j = 0; j < NF; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[h][i][j][e] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < kPfBK; ks += 16) {
      unsigned afr[MF][4];
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
        ldmatrix_x4(afr[mf], as + (wm + mf * 16 + (lane & 15)) * kPfLdA + ks +
                                 (lane >> 4) * 8);
#pragma unroll
      for (int h = 0; h < NB; ++h) {
        const bf16* bs = Bs + (slot * NB + h) * kPfBK * LDB;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          // Rows ks..ks+15 of 16 columns, transposed into the "col" operand:
          // regs 0-1 feed columns +0..7, regs 2-3 columns +8..15.
          unsigned bfr[4];
          ldmatrix_x4_trans(bfr, bs + (ks + (lane & 15)) * LDB + wn + p * 16 +
                                     (lane >> 4) * 8);
#pragma unroll
          for (int mf = 0; mf < MF; ++mf) {
            mma_bf16(part[h][mf][2 * p], afr[mf], bfr[0], bfr[1]);
            mma_bf16(part[h][mf][2 * p + 1], afr[mf], bfr[2], bfr[3]);
          }
        }
      }
    }
    if (kc % kPfFold == kPfFold - 1 || kc == nk - 1) {
#pragma unroll
      for (int h = 0; h < NB; ++h)
#pragma unroll
        for (int i = 0; i < MF; ++i)
#pragma unroll
          for (int j = 0; j < NF; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[h][i][j][e] += part[h][i][j][e];
    }
  }
  cp_async_wait<0>();

  // Accumulator layout of m16n8: c0,c1 at (row g, cols 2t, 2t+1), c2,c3 at
  // row g + 8, with g = lane / 4 and t = lane % 4. cols is a multiple of 8,
  // so both columns of a pair are in range together.
  const int g = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int mf = 0; mf < MF; ++mf) {
#pragma unroll
    for (int nf = 0; nf < NF; ++nf) {
      const int n = wn + nf * 8 + 2 * tq;
      if (n >= t.cols) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = wm + mf * 16 + g + half * 8;
        if (m >= t.rows) continue;
        float v0 = acc[0][mf][nf][2 * half];
        float v1 = acc[0][mf][nf][2 * half + 1];
        if constexpr (SWIGLU) {
          float u0 = acc[NB - 1][mf][nf][2 * half];
          float u1 = acc[NB - 1][mf][nf][2 * half + 1];
          if (t.bias_g != nullptr) {
            v0 += to_f32(t.bias_g[n]);
            v1 += to_f32(t.bias_g[n + 1]);
            u0 += to_f32(t.bias_u[n]);
            u1 += to_f32(t.bias_u[n + 1]);
          }
          v0 = swiglu(v0, u0);
          v1 = swiglu(v1, u1);
        }
        epi.pair(m, n, v0, v1);
      }
    }
  }
}

template <typename T, bool SWIGLU, class Epi>
__device__ __forceinline__ void fma_tile(const Tile<T>& t, const Epi& epi) {
  constexpr int NB = SWIGLU ? 2 : 1;
  __shared__ float As[kFmBK][kFmBM + 4];          // A tile, transposed
  __shared__ float Bs[NB][kFmBK][kFmBN + 4];

  const int K = t.K;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[NB][4][4];
#pragma unroll
  for (int h = 0; h < NB; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[h][i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kFmBK) {
    for (int e = tid; e < kFmBM * kFmBK; e += kFmThreads) {
      const int r = e / kFmBK;
      const int kk = e % kFmBK;
      As[kk][r] = (r < t.rows && k0 + kk < K)
                      ? to_f32(t.a[r * t.lda + k0 + kk])
                      : 0.f;
    }
#pragma unroll
    for (int h = 0; h < NB; ++h) {
      const T* B = h == 0 ? t.b : t.bu;
      for (int e = tid; e < kFmBK * kFmBN; e += kFmThreads) {
        const int r = e / kFmBN;
        const int c = e % kFmBN;
        Bs[h][r][c] = (k0 + r < K && c < t.cols)
                          ? to_f32(B[(k0 + r) * t.ldb + c])
                          : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFmBK; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int h = 0; h < NB; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float b = Bs[h][kk][tx * 4 + j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[h][i][j] = fmaf(a[i], b, acc[h][i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = ty * 4 + i;
    if (m >= t.rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = tx * 4 + j;
      if (n >= t.cols) continue;
      float v = acc[0][i][j];
      if constexpr (SWIGLU) {
        float u = acc[NB - 1][i][j];
        if (t.bias_g != nullptr) {
          v += to_f32(t.bias_g[n]);
          u += to_f32(t.bias_u[n]);
        }
        v = swiglu(v, u);
      }
      epi.one(m, n, v);
    }
  }
}

// The tile of path `mma` (tensor cores, bf16) or the FMA path: one call
// site for kernels templated on both.
template <typename T, bool MMA, int BN, bool SWIGLU, class Epi>
__device__ __forceinline__ void run_tile(const Tile<T>& t,
                                         unsigned char* smem, const Epi& epi) {
  if constexpr (MMA) {
    static_assert(sizeof(T) == 2, "the tensor-core tile takes bf16");
    mma_tile<BN, SWIGLU>(t, smem, epi);
  } else {
    fma_tile<T, SWIGLU>(t, epi);
  }
}

}  // namespace
