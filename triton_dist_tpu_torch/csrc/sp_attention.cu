// Causal (or full) flash-attention prefill at world = 1 for Hopper (sm_90a):
// the tiled online-softmax pass of the sequence-parallel prefill attention,
// with the G query heads of one KV head folded into the rows.
//
// Replaces triton_dist_tpu/ops/sp_attention.py::_sp_fused_kernel (:147),
// reached from sp_ag_attention_fused (:373, pallas_call :420) and
// sp_ag_attention(impl="pallas") (:617). At world = 1 its KV ring is one
// step whose causal test `cur <= me` (:328) always holds, so what remains
// is the flash loop: q-tiles whose row r is query r // G of the tile
// (:244), KV subtiles, f32 scores scaled after the product (:269-272),
// masked entries -1e30 (:273-277), an online softmax whose p is rounded to
// v's dtype for the PV product while l sums the unrounded p (:278-287), and
// out = acc / max(l, 1e-20) rounded once (:363). The ring all-gather of KV
// at world > 1 comes with the multi-GPU slice.
//
// Layouts (all contiguous): q and out (B, S, Hq, D); k and v (B, S, Hkv, D).
// Query head hq = h * G + g belongs to KV head h, G = Hq / Hkv (Qwen3-8B:
// 32 / 8, G = 4; Qwen3-30B-A3B: 32 / 4, G = 8; D = 128). Folded row R of
// (b, h) is query position R / G, head h * G + R % G: the G rows of one
// position are contiguous in q and out.
//
// What bounds it: operations. A causal prefill does 4 * B * Hq * D *
// S (S + 1) / 2 operations on 2 * B * S * (Hq + Hkv) * D elements read or
// written; at S = 32768 that is ~8.8e12 operations against ~0.6 GB, far
// above the ~295 operations per byte where the tensor cores, not HBM, are
// the limit (8.9 ms at 989 TFLOP/s).
//
// What the design does about it (an FA2-style forward, mma.sync first;
// wgmma and TMA are later work):
//  * one block of four warps per (batch, KV head, tile of 64 folded rows),
//    so each K/V tile read from HBM serves all G query heads of its KV head;
//  * K/V tiles of 64 positions, double-buffered in shared memory with
//    cp.async, the next tile in flight while the current one is used;
//  * bf16: Q fragments held in registers, S = Q K^T and O += P V on
//    mma.sync m16n8k16 (bf16 in, f32 accumulate) fed by ldmatrix, the
//    online-softmax state (m, l) and O in registers, P passed from the S
//    accumulators to the PV operand without shared memory;
//  * f32: the same tiles on FMA (p through shared memory), so f32 inputs
//    keep f32 products as in the JAX package;
//  * causal: KV tiles wholly in the future of every row of a q-tile are
//    skipped (exact: they give p = 0 and a correction factor of 1), only
//    the tiles on the diagonal (or past S) are masked, and the q-tiles
//    with the most KV tiles are launched first so the last wave is short.
//
// Numerics against JAX: the scale multiplies the f32 scores; masked
// entries are -1e30, never -inf, so nothing gives NaN; p is rounded to
// v's dtype (bf16: round to nearest even) for the PV product, l sums the
// unrounded f32 p; out = acc / max(l, 1e-20) in q's dtype. The bf16 path
// takes p = exp(s - m) as exp2f(s log2 e - m log2 e), within a few f32
// ulps of exp; the f32 path calls expf. KV tiles here
// are 64 wide where JAX's t_sub is 128: the running max at which each p is
// rounded may differ, which moves a bf16 p by at most one ulp.
//
// Every sum has a fixed order and there are no atomics: equal inputs give
// equal bits from run to run. All offsets are 64-bit (B * S * Hq * D
// passes 2^31 at B = 4, S = 32768).
//
// Plain C entry point `tdt_sp_attention`, loaded with ctypes. It runs on
// the stream it is given, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_common.cuh"

namespace {

constexpr int kBM = 64;                  // folded rows per block
constexpr int kBN = 64;                  // KV positions per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;        // (B, S, Hq, D)
  const void* k;        // (B, S, Hkv, D)
  const void* v;
  void* out;            // (B, S, Hq, D), q's dtype
  int B, S, Hq, Hkv, G;
  int n_qt;             // q-tiles of one (b, h): ceil(S * G / kBM)
  int causal;
  float scale;          // D^-0.5 rounded to f32, as JAX rounds it
};

// The (b, h, q-tile) of this block. Tiles are launched in falling order
// of their index, all (b, h) of one tile together, so under a causal mask
// the longest tiles start first.
struct Tile {
  int b, h;
  long long r0;         // first folded row
  long long rows;       // S * G
  int n_kv;             // KV tiles this q-tile reads
};

__device__ __forceinline__ Tile tile_of_block(const Params& p) {
  const long long bh_count = static_cast<long long>(p.B) * p.Hkv;
  const long long id = blockIdx.x;
  const int bh = static_cast<int>(id % bh_count);
  const long long qt = p.n_qt - 1 - id / bh_count;
  Tile t;
  t.b = bh / p.Hkv;
  t.h = bh % p.Hkv;
  t.rows = static_cast<long long>(p.S) * p.G;
  t.r0 = qt * kBM;
  long long kv_end = p.S;
  if (p.causal) {
    const long long last = min(t.r0 + kBM, t.rows) - 1;
    kv_end = min(kv_end, last / p.G + 1);
  }
  t.n_kv = static_cast<int>((kv_end + kBN - 1) / kBN);
  return t;
}

// Element offset of folded row R of (b, h) in q or out.
__device__ __forceinline__ long long q_offset(const Params& p, const Tile& t,
                                              long long R, int D) {
  return ((static_cast<long long>(t.b) * p.S + R / p.G) * p.Hq +
          static_cast<long long>(t.h) * p.G + R % p.G) *
         D;
}

// Element offset of position `pos` of (b, h) in k or v.
__device__ __forceinline__ long long kv_offset(const Params& p, const Tile& t,
                                               long long pos, int D) {
  return ((static_cast<long long>(t.b) * p.S + pos) * p.Hkv + t.h) *
         static_cast<long long>(D);
}

// Stages the block's 64 folded q rows into `dst` (row stride `ld`
// elements); rows past S * G are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_q(const Params& p, const Tile& t, T* dst,
                                       int ld) {
  constexpr int kChunks = D * static_cast<int>(sizeof(T)) / 16;
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  const T* q = static_cast<const T*>(p.q);
  for (int c = threadIdx.x; c < kBM * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int cc = (c % kChunks) * kPer;
    const long long R = t.r0 + r;
    const bool ok = R < t.rows;
    cp_async16(dst + r * ld + cc, ok ? q + q_offset(p, t, R, D) + cc : q, ok);
  }
}

// Stages KV tile `j` (64 positions of k and v) into `ks` and `vs`;
// positions past S are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_kv(const Params& p, const Tile& t, int j,
                                        T* ks, T* vs, int ld) {
  constexpr int kChunks = D * static_cast<int>(sizeof(T)) / 16;
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  for (int c = threadIdx.x; c < kBN * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int cc = (c % kChunks) * kPer;
    const long long pos = static_cast<long long>(j) * kBN + r;
    const bool ok = pos < p.S;
    const long long off = ok ? kv_offset(p, t, pos, D) + cc : 0;
    cp_async16(ks + r * ld + cc, k + off, ok);
    cp_async16(vs + r * ld + cc, v + off, ok);
  }
}

// Is score (query position qpos, key position kpos) live?
__device__ __forceinline__ bool live(const Params& p, long long qpos,
                                     long long kpos) {
  return kpos < p.S && (!p.causal || kpos <= qpos);
}

// ---------------------------------------------------------------------------
// bf16: mma.sync. Warp w owns folded rows 16w..16w+15 of the tile; in the
// m16n8 accumulator layout a lane holds rows g and g + 8 (g = lane / 4) at
// columns 2t, 2t + 1 (t = lane % 4) of each 8-column fragment.
template <int D>
__host__ __device__ constexpr int mma_ld() { return D + 8; }  // padded rows: conflict-free ldmatrix

template <int D>
constexpr int mma_smem_bytes() {
  // Q, then K and V double-buffered.
  return (kBM + 4 * kBN) * mma_ld<D>() *
         static_cast<int>(sizeof(__nv_bfloat16));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
sp_attention_mma(const Params p) {
  constexpr int LD = mma_ld<D>();
  constexpr int KS = D / 16;              // k-steps of the score product
  constexpr int NF = kBN / 8;             // score fragments per row block
  constexpr int DF = D / 8;               // output fragments per row block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBM * LD;      // [2][kBN][LD]
  __nv_bfloat16* Vs = Ks + 2 * kBN * LD;  // [2][kBN][LD]

  const Tile t = tile_of_block(p);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;

  load_q<__nv_bfloat16, D>(p, t, Qs, LD);
  cp_async_commit();
  if (t.n_kv > 0) load_kv<__nv_bfloat16, D>(p, t, 0, Ks, Vs, LD);
  cp_async_commit();

  // Query positions of this lane's two rows and of the block's first row
  // (positions fit in 32 bits: S < 2^31 - kBM).
  const int qpos0 = static_cast<int>((t.r0 + warp * 16 + g) / p.G);
  const int qpos1 = static_cast<int>((t.r0 + warp * 16 + g + 8) / p.G);
  const int qmin = static_cast<int>(t.r0 / p.G);

  unsigned qf[KS][4];
  float o[DF][4];
#pragma unroll
  for (int i = 0; i < DF; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < t.n_kv; ++j) {
    if (j + 1 < t.n_kv) {
      const int nb = (j + 1) & 1;
      load_kv<__nv_bfloat16, D>(p, t, j + 1, Ks + nb * kBN * LD,
                                Vs + nb * kBN * LD, LD);
    }
    cp_async_commit();
    cp_async_wait<1>();                   // Q and tile j landed
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        ldmatrix_x4(qf[ks], Qs + (warp * 16 + (lane & 15)) * LD + ks * 16 +
                                (lane >> 4) * 8);
    }
    const __nv_bfloat16* ks_ = Ks + (j & 1) * kBN * LD;
    const __nv_bfloat16* vs_ = Vs + (j & 1) * kBN * LD;

    // S = Q K^T (f32). K rows are the "col" operand as they lie: lanes
    // 0-7 / 8-15 / 16-23 / 24-31 address positions +0..7 dims +0, +0..7
    // dims +8, +8..15 dims +0, +8..15 dims +8.
    float s[NF][4];
#pragma unroll
    for (int i = 0; i < NF; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < NF / 2; ++np) {
        unsigned kb[4];
        ldmatrix_x4(kb, ks_ + (np * 16 + ((lane >> 4) << 3) + (lane & 7)) * LD +
                            ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[ks], kb[0], kb[1]);
        mma_bf16(s[2 * np + 1], qf[ks], kb[2], kb[3]);
      }
    }

    // Scale, mask, and the tile's row maxima (a row's 64 columns lie in
    // the four lanes of one quad). Only a tile that reaches past S or
    // past the block's first query position can hold a masked entry.
    const int k0 = j * kBN;
    const bool edge = k0 + kBN > p.S || (p.causal && k0 + kBN - 1 > qmin);
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int nf = 0; nf < NF; ++nf) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + nf * 8 + 2 * tq + (e & 1);
        const bool ok = !edge || (kpos < p.S &&
                                  (!p.causal || kpos <= (e < 2 ? qpos0
                                                               : qpos1)));
        s[nf][e] = ok ? s[nf][e] * p.scale : kNeg;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nf][0], s[nf][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nf][2], s[nf][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float c0 = expf(m0 - mn0);
    const float c1 = expf(m1 - mn1);
    // p = exp(s - m) as 2^(s log2 e - m log2 e): one FMA and one exp2f.
    const float ml0 = mn0 * kLog2e;
    const float ml1 = mn1 * kLog2e;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nf = 0; nf < NF; ++nf) {
      s[nf][0] = exp2f(fmaf(s[nf][0], kLog2e, -ml0));
      s[nf][1] = exp2f(fmaf(s[nf][1], kLog2e, -ml0));
      s[nf][2] = exp2f(fmaf(s[nf][2], kLog2e, -ml1));
      s[nf][3] = exp2f(fmaf(s[nf][3], kLog2e, -ml1));
      sum0 += s[nf][0] + s[nf][1];
      sum1 += s[nf][2] + s[nf][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    m0 = mn0;
    m1 = mn1;
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int i = 0; i < DF; ++i) {
      o[i][0] *= c0;
      o[i][1] *= c0;
      o[i][2] *= c1;
      o[i][3] *= c1;
    }

    // O += round_bf16(P) V. The S accumulators of fragments 2kk, 2kk + 1
    // are the A operand of k-step kk; V rows go through ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      unsigned a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        unsigned vb[4];
        ldmatrix_x4_trans(vb, vs_ + (kk * 16 + (lane & 15)) * LD + dp * 16 +
                                  (lane >> 4) * 8);
        mma_bf16(o[2 * dp], a, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], a, vb[2], vb[3]);
      }
    }
    __syncthreads();                      // tile j's buffers are free
  }
  cp_async_wait<0>();

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
  const float d0 = fmaxf(l0, 1e-20f);
  const float d1 = fmaxf(l1, 1e-20f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long R = t.r0 + warp * 16 + g + half * 8;
    if (R >= t.rows) continue;
    __nv_bfloat16* row = out + q_offset(p, t, R, D);
    const float d = half ? d1 : d0;
#pragma unroll
    for (int i = 0; i < DF; ++i) {
      const __nv_bfloat162 v2 = __floats2bfloat162_rn(o[i][2 * half] / d,
                                                      o[i][2 * half + 1] / d);
      *reinterpret_cast<__nv_bfloat162*>(row + i * 8 + 2 * tq) = v2;
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMA. Thread t owns folded row t / 2 of the tile; for the scores it
// takes the tile's columns 2i + t % 2, for the output the dims 2i + t % 2
// (neighbouring lanes read neighbouring words: no bank conflicts).
template <int D>
__host__ __device__ constexpr int fma_ld() { return D + 4; }  // 16-byte rows for cp.async

constexpr int kPLd = kBN + 1;             // P rows: 16 rows, 16 banks

template <int D>
constexpr int fma_smem_bytes() {
  return ((kBM + 2 * kBN) * fma_ld<D>() + kBM * kPLd) *
         static_cast<int>(sizeof(float));
}

template <int D>
__global__ void __launch_bounds__(kThreads)
sp_attention_fma(const Params p) {
  constexpr int LD = fma_ld<D>();
  constexpr int NC = kBN / 2;             // score columns per thread
  constexpr int ND = D / 2;               // output dims per thread
  constexpr int CH = 8;                   // output dims per PV pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + kBM * LD;
  float* Vs = Ks + kBN * LD;
  float* Ps = Vs + kBN * LD;              // [kBM][kPLd]

  const Tile t = tile_of_block(p);
  const int r = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  const long long R = t.r0 + r;
  const long long qpos = R / p.G;

  load_q<float, D>(p, t, Qs, LD);
  cp_async_commit();

  float o[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i] = 0.f;
  float m = kNeg, l = 0.f;

  for (int j = 0; j < t.n_kv; ++j) {
    load_kv<float, D>(p, t, j, Ks, Vs, LD);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    float s[NC];
#pragma unroll
    for (int i = 0; i < NC; ++i) s[i] = 0.f;
    const float* qrow = Qs + r * LD;
    for (int d = 0; d < D; ++d) {
      const float qv = qrow[d];
#pragma unroll
      for (int i = 0; i < NC; ++i)
        s[i] = fmaf(qv, Ks[(2 * i + half) * LD + d], s[i]);
    }
    float mx = kNeg;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const long long kpos = static_cast<long long>(j) * kBN + 2 * i + half;
      s[i] = live(p, qpos, kpos) ? s[i] * p.scale : kNeg;
      mx = fmaxf(mx, s[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float mn = fmaxf(m, mx);
    const float c = expf(m - mn);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      s[i] = expf(s[i] - mn);
      sum += s[i];
      Ps[r * kPLd + 2 * i + half] = s[i];
    }
    // Both lanes of a row add the same two partial sums: equal l.
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    m = mn;
    l = l * c + sum;
    __syncthreads();                      // P of every row is written

    // acc = acc * c + P V, the tile's products summed first as in JAX.
    const float* prow = Ps + r * kPLd;
#pragma unroll
    for (int c0 = 0; c0 < ND; c0 += CH) {
      float pv[CH];
#pragma unroll
      for (int u = 0; u < CH; ++u) pv[u] = 0.f;
      for (int jj = 0; jj < kBN; ++jj) {
        const float pj = prow[jj];
        const float* vrow = Vs + jj * LD + half;
#pragma unroll
        for (int u = 0; u < CH; ++u)
          pv[u] = fmaf(pj, vrow[2 * (c0 + u)], pv[u]);
      }
#pragma unroll
      for (int u = 0; u < CH; ++u) o[c0 + u] = o[c0 + u] * c + pv[u];
    }
    __syncthreads();                      // K, V and P are free
  }
  cp_async_wait<0>();

  if (R < t.rows) {
    float* row = static_cast<float*>(p.out) + q_offset(p, t, R, D);
    const float d = fmaxf(l, 1e-20f);
#pragma unroll
    for (int i = 0; i < ND; ++i) row[2 * i + half] = o[i] / d;
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, const Params& p,
                   long long blocks, cudaStream_t stream) {
  // The attribute belongs to the current device: set it on every launch
  // (it is cheap) so a second card is configured too.
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out = attention(q, k, v) as described above. dtype: 0 bf16, 1 f32 (q,
// k, v and out alike); D: 64 or 128; causal: 0 or 1. Pointers must be
// 16-byte aligned. Returns a cudaError_t.
int tdt_sp_attention(const void* q, const void* k, const void* v, void* out,
                     int B, int S, int Hq, int Hkv, int D, int causal,
                     int dtype, float scale, void* stream) {
  if (q == nullptr || k == nullptr || v == nullptr || out == nullptr ||
      B <= 0 || S <= 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 ||
      (D != 64 && D != 128) || (dtype != 0 && dtype != 1) ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.B = B;
  p.S = S;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.G = Hq / Hkv;
  const long long rows = static_cast<long long>(S) * p.G;
  const long long n_qt = (rows + kBM - 1) / kBM;
  const long long blocks = n_qt * B * Hkv;
  if (n_qt > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  p.n_qt = static_cast<int>(n_qt);
  p.causal = causal != 0;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = D == 64 ? launch(sp_attention_mma<64>, mma_smem_bytes<64>(), p,
                           blocks, s)
                  : launch(sp_attention_mma<128>, mma_smem_bytes<128>(), p,
                           blocks, s);
  else
    err = D == 64 ? launch(sp_attention_fma<64>, fma_smem_bytes<64>(), p,
                           blocks, s)
                  : launch(sp_attention_fma<128>, fma_smem_bytes<128>(), p,
                           blocks, s);
  return static_cast<int>(err);
}

// The runtime's message for an error code returned above.
const char* tdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
