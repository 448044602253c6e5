// AG-GEMM, AG-SwiGLU and the GEMM of GEMM-RS at world = 1 for Hopper
// (sm_90a): C_i = A @ B_i with f32 accumulation and one rounding to A's
// dtype, and act = silu(A @ Wg + bg) * (A @ Wu + bu) in f32, rounded once.
//
// Replaces, at world = 1, where their ring all-gather / reduce-scatter
// halves vanish (the `world == 1` branches of allgather_gemm.py:170, 193,
// 246, 331, 443, 1029 and gemm_reduce_scatter.py:635):
//  * triton_dist_tpu/ops/allgather_gemm.py::_ag_gemm_hbm_nb_kernel (:265),
//    the kernel `ag_gemm_multi` (:643) runs for Qwen3-8B's QKV (n_b = 3) and,
//    when `ag_swiglu` does not fuse, its gate|up (n_b = 2);
//  * triton_dist_tpu/ops/allgather_gemm.py::_ag_swiglu_hbm_kernel (:954):
//    the gate and up products and the bias + SwiGLU epilogue in one kernel,
//    so the (M, 2 I) intermediate never reaches device memory;
//  * triton_dist_tpu/ops/gemm_reduce_scatter.py::_gemm_rs_hbm_kernel (:533),
//    the k-tiled kernel `gemm_rs` (:884) runs for the down projection, and
//    the prefill (M > 64) products of ::_gemm_rs_hbm_nb_kernel (:353), the
//    o_proj. (At M <= 64 gemm_rs runs gemm_ar.cu's kernel.)
// The ring halves come with the multi-GPU slice.
//
// Shapes on the path (Qwen3-8B, bf16, batch 4 x 128-token prompts), with the
// least time on an H100 SXM (989 TFLOP/s bf16, 3.35 TB/s):
//   prefill M = 512: QKV 4096 -> 4096|1024|1024 26.1 us, o_proj 4096 -> 4096
//   17.4 us, gate/up 4096 -> 2 x 12288 104.2 us, down 12288 -> 4096 52.1 us,
//   all bound by operations;
//   decode M = 4: QKV 15.0 us, gate|up 60.1 us (bytes of B).
//
// What the design does about it. Three kernels, picked by dtype and shape
// only (make_plan, exported as tdt_ag_gemm_plan):
//  * Prefill plan, bf16 with K and every width a multiple of 8 and M > 64
//    (or any M for SwiGLU): `tile_mma`, the tensor cores through mma.sync
//    m16n8k16 (bf16 in, f32 accumulate) fed by ldmatrix. A block computes a
//    128 x 128 output tile (128 x 64 of gate and of up for SwiGLU, whose two
//    accumulators share each A tile), 8 warps of 64 x 32 (64 x 16); a
//    4-stage cp.async pipeline of 16-byte copies streams 64-deep slices of A
//    and B through padded (conflict-free) shared memory. No split-K: at
//    M = 512 QKV has 4 x 48 = 192 tiles, down 128, gate/up 768, which fill
//    the 132 SMs. Every 128 K terms (two stages) the tensor core's sum is
//    added to an f32 register sum, so long K sums stay within one bf16 ulp
//    of the f32 reference.
//  * Decode plan, bf16 aligned as above and M <= 64 (AG-GEMM only):
//    gemm_common.cuh's `stream_mma`, the B-streaming kernel of gemm_ar, run
//    over up to three products at once, split-K to about two blocks per SM
//    and a fixed-order split reduce. B is read from HBM once.
//  * f32, and bf16 at other shapes: `tile_fma`, a 64 x 64 tile of f32 FMAs,
//    4 x 4 outputs per thread, K in slices of 16 through shared memory, every
//    edge masked. Only the f32 test configurations and odd shapes use it.
//  * Several products in one launch: a block finds its product from its
//    column tile (`Segs`), so QKV is one launch and writes three outputs.
//  * Every sum has a fixed order and there are no atomics, so equal inputs
//    give equal bits from run to run.
//  * No wgmma / TMA / persistent blocks yet: that is later work.
//
// Plain C entry points `tdt_ag_gemm_plan`, `tdt_ag_gemm` and `tdt_ag_swiglu`,
// loaded with ctypes. A launch runs on the stream it is given, allocates
// nothing and returns cudaGetLastError().

#include "gemm_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kOpGemm = 0;
constexpr int kOpSwiglu = 1;

// ---------------------------------------------------------------------------
// Prefill: tiled tensor-core kernel.
constexpr int kPfBM = 128;                 // rows per block
constexpr int kPfBK = 64;                  // K per pipeline stage
constexpr int kPfStages = 4;
constexpr int kPfFold = 2;                 // stages summed in the tensor core
constexpr int kPfThreads = 256;            // 8 warps: 2 along M x 4 along N
constexpr int kPfLdA = kPfBK + 8;          // padded rows: conflict-free ldmatrix
constexpr int kPfBN = 128;                 // columns per block (plain)
constexpr int kPfBNSwiglu = 64;            // columns per block (gate and up)

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

// grid = (column tiles of all products, ceil(M / 128)), 256 threads.
// SWIGLU: one product (segs.b[0] = Wg, segs.c[0] = act) and Bu = Wu; the
// optional biases have one entry per column.
template <int BN, bool SWIGLU>
__global__ void __launch_bounds__(kPfThreads, 1)
tile_mma(const bf16* __restrict__ A, Segs<bf16> segs,
         const bf16* __restrict__ Bu, const bf16* __restrict__ bias_g,
         const bf16* __restrict__ bias_u, int M, int K) {
  constexpr int NB = SWIGLU ? 2 : 1;       // B operands per stage
  constexpr int LDB = BN + 8;
  constexpr int WN = BN / 4;               // columns per warp
  constexpr int NP = WN / 16;              // 16-column ldmatrix groups
  constexpr int NF = 2 * NP;               // n8 fragments per warp
  constexpr int MF = kPfBM / 2 / 16;       // m16 fragments per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);
  bf16* Bs = As + kPfStages * kPfBM * kPfLdA;    // [stage][NB][BK][LDB]

  const int seg = seg_of_tile(segs, blockIdx.x);
  const bf16* __restrict__ B0 = seg_field(segs.b, seg);
  const int N = seg_field(segs.n, seg);
  const int n0 = (blockIdx.x - seg_field(segs.tile0, seg)) * BN;
  const int m0 = blockIdx.y * kPfBM;
  const int nk = (K + kPfBK - 1) / kPfBK;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp >> 2) * (kPfBM / 2);     // warp's first row
  const int wn = (warp & 3) * WN;               // warp's first column

  // Stage `kc` into pipeline slot `slot`: every thread copies the same
  // number of 16-byte chunks (constant trip counts, so the index math
  // folds). Chunks of 8 elements past M, N or K are zero-filled (N and K
  // are multiples of 8).
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
      const bool ok = m0 + r < M && k0 + kk < K;
      const bf16* src = ok ? A + static_cast<size_t>(m0 + r) * K + k0 + kk : A;
      cp_async16(as + r * kPfLdA + kk, src, ok);
    }
#pragma unroll
    for (int h = 0; h < NB; ++h) {
      const bf16* B = h == 0 ? B0 : Bu;
      bf16* bs = Bs + (slot * NB + h) * kPfBK * LDB;
#pragma unroll
      for (int i = 0; i < kChunksB; ++i) {
        const int c = tid + i * kPfThreads;
        const int r = c / (BN / 8);
        const int nn = (c % (BN / 8)) * 8;
        const bool ok = k0 + r < K && n0 + nn < N;
        const bf16* src =
            ok ? B + static_cast<size_t>(k0 + r) * N + n0 + nn : B;
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
  // row g + 8, with g = lane / 4 and t = lane % 4. N is a multiple of 8, so
  // both columns of a pair are in range together.
  const int g = lane >> 2;
  const int t = lane & 3;
  bf16* __restrict__ C = seg_field(segs.c, seg);
#pragma unroll
  for (int mf = 0; mf < MF; ++mf) {
#pragma unroll
    for (int nf = 0; nf < NF; ++nf) {
      const int n = n0 + wn + nf * 8 + 2 * t;
      if (n >= N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm + mf * 16 + g + half * 8;
        if (m >= M) continue;
        float v0 = acc[0][mf][nf][2 * half];
        float v1 = acc[0][mf][nf][2 * half + 1];
        if constexpr (SWIGLU) {
          float u0 = acc[NB - 1][mf][nf][2 * half];
          float u1 = acc[NB - 1][mf][nf][2 * half + 1];
          if (bias_g != nullptr) {
            v0 += to_f32(bias_g[n]);
            v1 += to_f32(bias_g[n + 1]);
            u0 += to_f32(bias_u[n]);
            u1 += to_f32(bias_u[n + 1]);
          }
          v0 = swiglu(v0, u0);
          v1 = swiglu(v1, u1);
        }
        __nv_bfloat162 pair;
        pair.x = from_f32<bf16>(v0);
        pair.y = from_f32<bf16>(v1);
        *reinterpret_cast<__nv_bfloat162*>(C + static_cast<size_t>(m) * N +
                                           n) = pair;
      }
    }
  }
}

template <int BN, bool SWIGLU>
cudaError_t launch_tile_mma(const bf16* a, const Segs<bf16>& segs,
                            const bf16* bu, const bf16* bias_g,
                            const bf16* bias_u, int M, int K,
                            cudaStream_t stream) {
  constexpr int smem = tile_smem_bytes<BN, SWIGLU>();
  // The attribute belongs to the current device: set it on every launch.
  const cudaError_t err = cudaFuncSetAttribute(
      tile_mma<BN, SWIGLU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid(segs.tile0[segs.count], (M + kPfBM - 1) / kPfBM);
  tile_mma<BN, SWIGLU><<<grid, kPfThreads, smem, stream>>>(
      a, segs, bu, bias_g, bias_u, M, K);
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// f32 and odd shapes: tiled FMA kernel. A block computes a 64 x 64 output
// tile (of gate and of up for SwiGLU); thread (ty, tx) owns rows ty*4..+3
// and columns tx*4..+3 and sums K in order.
constexpr int kFmBM = 64;
constexpr int kFmBN = 64;
constexpr int kFmBK = 16;
constexpr int kFmThreads = 256;

template <typename T, bool SWIGLU>
__global__ void __launch_bounds__(kFmThreads)
tile_fma(const T* __restrict__ A, Segs<T> segs, const T* __restrict__ Bu,
         const T* __restrict__ bias_g, const T* __restrict__ bias_u, int M,
         int K) {
  constexpr int NB = SWIGLU ? 2 : 1;
  __shared__ float As[kFmBK][kFmBM + 4];          // A tile, transposed
  __shared__ float Bs[NB][kFmBK][kFmBN + 4];

  const int seg = seg_of_tile(segs, blockIdx.x);
  const T* __restrict__ B0 = seg_field(segs.b, seg);
  const int N = seg_field(segs.n, seg);
  const int n0 = (blockIdx.x - seg_field(segs.tile0, seg)) * kFmBN;
  const int m0 = blockIdx.y * kFmBM;
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
      As[kk][r] = (m0 + r < M && k0 + kk < K)
                      ? to_f32(A[static_cast<size_t>(m0 + r) * K + k0 + kk])
                      : 0.f;
    }
#pragma unroll
    for (int h = 0; h < NB; ++h) {
      const T* B = h == 0 ? B0 : Bu;
      for (int e = tid; e < kFmBK * kFmBN; e += kFmThreads) {
        const int r = e / kFmBN;
        const int c = e % kFmBN;
        Bs[h][r][c] = (k0 + r < K && n0 + c < N)
                          ? to_f32(B[static_cast<size_t>(k0 + r) * N + n0 + c])
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

  T* __restrict__ C = seg_field(segs.c, seg);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      float v = acc[0][i][j];
      if constexpr (SWIGLU) {
        float u = acc[NB - 1][i][j];
        if (bias_g != nullptr) {
          v += to_f32(bias_g[n]);
          u += to_f32(bias_u[n]);
        }
        v = swiglu(v, u);
      }
      C[static_cast<size_t>(m) * N + n] = from_f32<T>(v);
    }
  }
}

template <typename T, bool SWIGLU>
void launch_tile_fma(const T* a, const Segs<T>& segs, const T* bu,
                     const T* bias_g, const T* bias_u, int M, int K,
                     cudaStream_t stream) {
  dim3 grid(segs.tile0[segs.count], (M + kFmBM - 1) / kFmBM);
  tile_fma<T, SWIGLU><<<grid, kFmThreads, 0, stream>>>(a, segs, bu, bias_g,
                                                        bias_u, M, K);
}

// ---------------------------------------------------------------------------
// How one call is launched. The path depends on the op, the dtype and the
// shape only, never on where the operands lie, so equal inputs give equal
// bits.
struct Plan {
  int path;    // 0: tile_fma, 1: stream_mma (decode), 2: tile_mma (prefill)
  int tiles;   // output tiles (blocks of one split)
  int splits;  // K splits (stream_mma only)
};

// Column tile width and row tile height of a path.
int tile_cols(int path, int op) {
  return path == 0 ? kFmBN
         : path == 1 ? kTcBN
         : op == kOpSwiglu ? kPfBNSwiglu : kPfBN;
}
int tile_rows(int path) {
  return path == 0 ? kFmBM : path == 1 ? kTcBM : kPfBM;
}

bool plan_args_ok(int op, int M, int count, const int* n, int K, int sms,
                  int dtype) {
  // K = 0 is a product of zeros (plus the SwiGLU biases).
  if (M <= 0 || K < 0 || sms <= 0 || (dtype != 0 && dtype != 1))
    return false;
  if (op == kOpSwiglu ? count != 1 : (op != kOpGemm || count < 1 ||
                                      count > kMaxSegs))
    return false;
  for (int i = 0; i < count; ++i)
    if (n[i] <= 0) return false;
  return true;
}

Plan make_plan(int op, int M, int count, const int* n, int K, int sms,
               int dtype) {
  bool tc = dtype == 0 && K % 8 == 0;
  for (int i = 0; i < count; ++i) tc = tc && n[i] % 8 == 0;
  Plan p;
  p.path = !tc ? 0 : (op == kOpGemm && M <= kTcBM) ? 1 : 2;
  const int bn = tile_cols(p.path, op);
  int col_tiles = 0;
  for (int i = 0; i < count; ++i) col_tiles += (n[i] + bn - 1) / bn;
  p.tiles = col_tiles * ((M + tile_rows(p.path) - 1) / tile_rows(p.path));
  p.splits = p.path == 1 ? splitk_count(p.tiles, K, sms) : 1;
  return p;
}

template <typename T>
cudaError_t run_gemm(const Plan& p, const void* a, const void* const* b,
                     void* const* c, const int* n, int count, void* ws, int M,
                     int K, cudaStream_t s) {
  const T* A = static_cast<const T*>(a);
  const T* bs[kMaxSegs] = {};
  T* cs[kMaxSegs] = {};
  for (int i = 0; i < count; ++i) {
    bs[i] = static_cast<const T*>(b[i]);
    cs[i] = static_cast<T*>(c[i]);
  }
  const Segs<T> segs = make_segs<T>(count, bs, cs, n, tile_cols(p.path, 0));
  if constexpr (sizeof(T) == 2) {
    if (p.path == 1)
      return run_stream(A, segs, static_cast<float*>(ws), M, K, p.splits, s);
    if (p.path == 2)
      return launch_tile_mma<kPfBN, false>(A, segs, nullptr, nullptr, nullptr,
                                           M, K, s);
  }
  launch_tile_fma<T, false>(A, segs, nullptr, nullptr, nullptr, M, K, s);
  return cudaSuccess;
}

template <typename T>
cudaError_t run_swiglu(const Plan& p, const void* a, const void* wg,
                       const void* wu, const void* bg, const void* bu,
                       void* out, int M, int N, int K, cudaStream_t s) {
  const T* A = static_cast<const T*>(a);
  const T* g = static_cast<const T*>(wg);
  T* o = static_cast<T*>(out);
  const Segs<T> segs = make_segs<T>(1, &g, &o, &N,
                                    tile_cols(p.path, kOpSwiglu));
  const T* u = static_cast<const T*>(wu);
  const T* bias_g = static_cast<const T*>(bg);
  const T* bias_u = static_cast<const T*>(bu);
  if constexpr (sizeof(T) == 2) {
    if (p.path == 2)
      return launch_tile_mma<kPfBNSwiglu, true>(A, segs, u, bias_g, bias_u, M,
                                                K, s);
  }
  launch_tile_fma<T, true>(A, segs, u, bias_g, bias_u, M, K, s);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The launch plan of `op` (0: C_i = A @ B_i for n_b = 1..3 products of
// widths n0, n1, n2; 1: the fused SwiGLU, n_b = 1 and n0 = its width) with A
// (M, K) on a card with `sms` SMs. dtype: 0 = bfloat16, 1 = float32. Fills
// *path (0: tile_fma, 1: stream_mma, 2: tile_mma), *tiles (output tiles)
// and *splits (K splits; with more than one a launch needs a workspace of
// splits * M * (n0 + n1 + n2) floats). Returns a cudaError_t.
int tdt_ag_gemm_plan(int op, int M, int n_b, int n0, int n1, int n2, int K,
                     int sms, int dtype, int* path, int* tiles, int* splits) {
  const int n[kMaxSegs] = {n0, n1, n2};
  if (!plan_args_ok(op, M, n_b, n, K, sms, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(op, M, n_b, n, K, sms, dtype);
  *path = p.path;
  *tiles = p.tiles;
  *splits = p.splits;
  return static_cast<int>(cudaSuccess);
}

// C_i = A @ B_i (i < n_b) as tdt_ag_gemm_plan(0, ...) plans it; B_i is
// (K, n_i) and C_i (M, n_i), row-major. ws holds the workspace the plan asks
// for (may be null with one split). Every operand must be 16-byte aligned.
// Returns a cudaError_t.
int tdt_ag_gemm(const void* a, int n_b, const void* b0, const void* b1,
                const void* b2, void* c0, void* c1, void* c2, int n0, int n1,
                int n2, void* ws, int M, int K, int sms, int dtype,
                void* stream) {
  const int n[kMaxSegs] = {n0, n1, n2};
  const void* b[kMaxSegs] = {b0, b1, b2};
  void* c[kMaxSegs] = {c0, c1, c2};
  if (!plan_args_ok(kOpGemm, M, n_b, n, K, sms, dtype) || !aligned16(a))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < n_b; ++i)
    if (!aligned16(b[i]) || c[i] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(kOpGemm, M, n_b, n, K, sms, dtype);
  if (p.splits > 65535 || (p.splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? run_gemm<bf16>(p, a, b, c, n, n_b, ws, M, K, s)
                 : run_gemm<float>(p, a, b, c, n, n_b, ws, M, K, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// act (M, N) = silu(A @ Wg + bg) * (A @ Wu + bu) as tdt_ag_gemm_plan(1, ...)
// plans it; Wg and Wu are (K, N), the biases (N,) or both null. Every
// operand must be 16-byte aligned. Returns a cudaError_t.
int tdt_ag_swiglu(const void* a, const void* wg, const void* wu,
                  const void* bg, const void* bu, void* out, int M, int N,
                  int K, int sms, int dtype, void* stream) {
  if (!plan_args_ok(kOpSwiglu, M, 1, &N, K, sms, dtype) || !aligned16(a) ||
      !aligned16(wg) || !aligned16(wu) || out == nullptr ||
      (bg == nullptr) != (bu == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan p = make_plan(kOpSwiglu, M, 1, &N, K, sms, dtype);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? run_swiglu<bf16>(p, a, wg, wu, bg, bu, out, M, N, K, s)
                 : run_swiglu<float>(p, a, wg, wu, bg, bu, out, M, N, K, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The runtime's message for an error code returned above.
const char* tdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
