// The grouped (per-expert) GEMM shared by group_gemm.cu (the expert products
// of Qwen3-MoE: gate|up, the SwiGLU FFN, the down projection of mode "sp")
// and moe_rs.cu (the down projection feeding the top-k reduce).
//
// The function: out[p] = A[p / a_div] @ W[ids[p]] for every pair p, with f32
// accumulation. `ids` may hold E (JAX's sentinel for an invalid pair): such
// pairs run through the last expert, as JAX's `grouped_matmul` folds them
// into its last group (group_gemm.py:56-60); callers mask them. `a_div` is
// the number of consecutive pairs that share one row of A (top-k for the
// MoE's gate|up, whose pairs are each token repeated k times), so the
// (P, K) expansion `jnp.repeat` makes in JAX is never written: a block
// gathers its rows through the pair -> row index.
//
// Two launches per call, on the caller's stream:
//  1. `group_schedule`, one block per list of pairs: the expert schedule of
//     JAX's `align_tokens_for_tiles` (group_gemm.py:90-136) with static
//     shapes and no host round trip. A world-1 call has one list; the
//     world-W ring (ag_group_gemm.cu) one per rank's chunk, each in its own
//     slice of the buffer. A stable counting sort of the pairs by expert
//     (warp-level __match_any_sync ranks, per-warp counts in shared memory,
//     a prefix over warps and experts), then one row tile of up to m_blk
//     pairs per (expert, m_blk chunk): its expert, first sorted row and row
//     count. The live tile count goes to sched[0]; the layout is
//     [n_live | sorted pairs (P) | tile expert | tile row0 | tile rows]
//     (each max_tiles long). Integer counts only, in a fixed order.
//  2. The product over the worst-case grid of ceil(P / m_blk) + min(E, P)
//     row tiles (JAX's static m_pad, (P + E (m_blk - 1)) / m_blk tiles, would
//     be ~16k rows at decode). A block reads its tile's entry and returns at
//     once when the tile lies past the live end.
//
// What bounds it on an H100 (3.35 TB/s, 989 TFLOP/s bf16): at decode (P = 32
// pairs over ~29 live experts of 128) the bytes of the live experts'
// weights; at prefill (P = 4096, all 128 experts live) the bytes of all the
// weights, and operations only a little below them. So the tensor-core
// kernel is gemm_common.cuh's B-streaming design (`stream_mma`) with a
// per-row-tile expert in place of `Segs`: a block holds one tile's rows of A
// (m_blk = 16, 32 or 64, from the mean rows per expert) and streams a
// 64-column tile of its expert's weights once through a 4-stage cp.async
// pipeline into mma.sync m16n8k16. One-row experts are not padded to a
// 128-row tile. Every sum has a fixed order and there are no atomics, so
// equal inputs give equal bits from run to run.
//
// Epilogues:
//  * plain: each product rounded to the output type (bf16, or f32 for the
//    MoE-reduce's unrounded numerics). Gate and up may share a launch
//    (n_b = 2): the column tiles of the second product follow the first's.
//  * SwiGLU: gate and up accumulate side by side in one block (sharing each
//    A tile), then silu(g) * u in f32 and one rounding.
// Each output row is stored at its pair's own index (row stride ldc): the
// store address does the unsort.
//
// The tile bodies (`gg_mma_tile`, `gg_fma_tile`) are device functions: the
// world-1 kernels run one tile a block, the world-W ring kernel of
// ag_group_gemm.cu runs many from its persistent blocks, so both give a row
// the same bits.
//
// Strides: A's rows and W's rows and experts are read through the strides
// the caller gives (elements; the last dimension is contiguous), so a
// rank's shard of the experts under tensor parallelism, W[:, :, cols] of
// (E, K, N_all) or W[:, rows, :] of (E, K_all, N), is read as the view it
// is. The experts of Qwen3-30B-A3B take ~57 GB of the card's 80 GB: a copy
// per rank would not fit. Strides change addresses only, never the order
// of a sum, so a contiguous call and a strided call of equal values give
// equal bits.
//
// f32 and bf16 with K or N not a multiple of 8 take `group_fma`, a 64 x 64
// tile of f32 FMAs over the same schedule (test configurations only).

#pragma once

#include "gemm_common.cuh"

namespace {

using gg_bf16 = __nv_bfloat16;

constexpr int kGgMaxExperts = 1024;
constexpr int kGgSchedThreads = 1024;
constexpr int kGgSchedWarps = kGgSchedThreads / 32;
constexpr int kGgMaxRows = 64;           // largest m_blk

// ---------------------------------------------------------------------------
// Sizes of a call's plan.
int gg_max_tiles(int P, int E, int m_blk) {
  return (P + m_blk - 1) / m_blk + (E < P ? E : P);
}
__host__ __device__ inline int gg_sched_ints(int P, int max_tiles) {
  return 1 + P + 3 * max_tiles;
}

// Rows per tile: twice the mean pairs per expert, a power of two in
// [16, 64]. A function of the shape only.
int gg_tile_rows(int P, int E) {
  const long long want = (2LL * P + E - 1) / E;
  int m = 16;
  while (m < kGgMaxRows && m < want) m *= 2;
  return m;
}

int gg_sched_smem(int E) {
  return (kGgSchedWarps * E + 3 * E + 1) * static_cast<int>(sizeof(int));
}

// ---------------------------------------------------------------------------
// 1. The expert schedule (blocks of 1024 threads; E <= 1024). Block b sorts
// pairs [b * P, (b + 1) * P) of `ids` into slice b of `sched` (each
// gg_sched_ints(P, max_tiles) long), its pairs numbered from 0.
__global__ void __launch_bounds__(kGgSchedThreads)
group_schedule(const int* __restrict__ ids, int P, int E, int m_blk,
               int max_tiles, int* __restrict__ sched) {
  extern __shared__ int sh[];
  ids += static_cast<size_t>(blockIdx.x) * P;
  sched += static_cast<size_t>(blockIdx.x) * gg_sched_ints(P, max_tiles);
  int* wcnt = sh;                               // [warp][expert]
  int* cnt = wcnt + kGgSchedWarps * E;          // pairs per expert
  int* offs = cnt + E;                          // first sorted row
  int* toff = offs + E;                         // first tile, E + 1 entries
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < kGgSchedWarps * E; i += kGgSchedThreads) wcnt[i] = 0;
  __syncthreads();

  // Warp w owns pairs [w * seg, (w + 1) * seg), 32 at a time; lanes past
  // the end carry expert -1 and match only each other.
  const int seg = (P + kGgSchedWarps - 1) / kGgSchedWarps;
  const int p_begin = warp * seg;
  const int p_end = min(P, p_begin + seg);
  int* mine = wcnt + warp * E;
  const unsigned below = (1u << lane) - 1u;
  for (int base = p_begin; base < p_end; base += 32) {
    const int p = base + lane;
    const int e = p < p_end ? min(max(ids[p], 0), E - 1) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, e);
    if (e >= 0 && (peers & below) == 0) mine[e] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // Per expert: each warp's count becomes the count of the warps before it.
  for (int e = tid; e < E; e += kGgSchedThreads) {
    int run = 0;
    for (int w = 0; w < kGgSchedWarps; ++w) {
      const int c = wcnt[w * E + e];
      wcnt[w * E + e] = run;
      run += c;
    }
    cnt[e] = run;
  }
  __syncthreads();
  if (tid == 0) {
    int o = 0, t = 0;
    for (int e = 0; e < E; ++e) {
      offs[e] = o;
      toff[e] = t;
      o += cnt[e];
      t += (cnt[e] + m_blk - 1) / m_blk;
    }
    toff[E] = t;
    sched[0] = t;
  }
  __syncthreads();

  // Stable placement: expert offset + earlier warps + earlier lanes and
  // steps of this warp.
  int* sorted = sched + 1;
  for (int base = p_begin; base < p_end; base += 32) {
    const int p = base + lane;
    const int e = p < p_end ? min(max(ids[p], 0), E - 1) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, e);
    if (e >= 0) sorted[offs[e] + mine[e] + __popc(peers & below)] = p;
    __syncwarp();
    if (e >= 0 && (peers & below) == 0) mine[e] += __popc(peers);
    __syncwarp();
  }

  int* t_exp = sched + 1 + P;
  int* t_row0 = t_exp + max_tiles;
  int* t_rows = t_row0 + max_tiles;
  for (int e = tid; e < E; e += kGgSchedThreads) {
    for (int ti = toff[e], j = 0; ti < toff[e + 1]; ++ti, ++j) {
      t_exp[ti] = e;
      t_row0[ti] = offs[e] + j * m_blk;
      t_rows[ti] = min(m_blk, cnt[e] - j * m_blk);
    }
  }
}

// The schedules of `lists` consecutive lists of P pairs, one block each.
cudaError_t launch_schedule(const int* ids, int P, int E, int m_blk,
                            int max_tiles, int* sched, cudaStream_t stream,
                            int lists = 1) {
  const int smem = gg_sched_smem(E);
  const cudaError_t err = cudaFuncSetAttribute(
      group_schedule, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  group_schedule<<<lists, kGgSchedThreads, smem, stream>>>(ids, P, E, m_blk,
                                                           max_tiles, sched);
  return cudaSuccess;
}

// A tile's entry of the schedule.
struct GgTile {
  int expert, row0, rows;
};

__device__ __forceinline__ bool gg_tile(const int* __restrict__ sched, int P,
                                        int max_tiles, int tile, GgTile& t) {
  if (tile >= sched[0]) return false;
  const int* t_exp = sched + 1 + P;
  t.expert = t_exp[tile];
  t.row0 = t_exp[max_tiles + tile];
  t.rows = t_exp[2 * max_tiles + tile];
  return true;
}

// SiLU(g) * u in f32 (gate * sigmoid(gate) * up); expf, not __expf.
__device__ __forceinline__ float gg_swiglu(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

// The operands of one launch. With n_b = 2 and the plain epilogue, column
// tiles [0, col_tiles) are product 0's and [col_tiles, 2 col_tiles)
// product 1's; with SWIGLU both products feed one output (c0).
template <typename T, typename OutT>
struct GgArgs {
  const T* a;          // (P / a_div, K), row stride lda
  int a_div;
  const T* b0;         // (E, K, N), row stride ldb, expert stride b_estride
  const T* b1;
  OutT* c0;            // (P, N), row stride ldc
  OutT* c1;
  const int* sched;
  int P, max_tiles, K, N, col_tiles;
  long long lda, ldb, b_estride, ldc;
};

// ---------------------------------------------------------------------------
// 2a. Tensor-core tile (bf16, K and N multiples of 8, operands 16-byte
// aligned): row tile `tile` of the schedule by column tile `col` (of every
// product), 128 threads: four warps of 16 columns each over MF m16
// fragments of rows. `smem_raw`: the block's gg_mma_smem<MF, SWIGLU>() bytes
// of dynamic shared memory. The block's shared memory must be free when it
// starts (one tile a block, or a barrier between tiles).
template <int MF, bool SWIGLU>
constexpr int gg_mma_smem() {
  return kTcStages * (MF * 16 * kTcLdA + (SWIGLU ? 2 : 1) * kTcBK * kTcLdB) *
         static_cast<int>(sizeof(gg_bf16));
}

template <int MF, bool SWIGLU, typename OutT>
__device__ __forceinline__ void gg_mma_tile(const GgArgs<gg_bf16, OutT>& g,
                                            int tile_idx, int col,
                                            unsigned char* smem_raw) {
  constexpr int NB = SWIGLU ? 2 : 1;
  gg_bf16* As = reinterpret_cast<gg_bf16*>(smem_raw);
  gg_bf16* Bs = As + kTcStages * MF * 16 * kTcLdA;  // [stage][NB][BK][LdB]
  __shared__ int pair_of[MF * 16];
  __shared__ int arow_of[MF * 16];

  GgTile tile;
  if (!gg_tile(g.sched, g.P, g.max_tiles, tile_idx, tile)) return;
  const int K = g.K, N = g.N;
  int prod = 0;
  int n0 = col * kTcBN;
  if (!SWIGLU && col >= g.col_tiles) {
    prod = 1;
    n0 = (col - g.col_tiles) * kTcBN;
  }
  const size_t w_off = static_cast<size_t>(tile.expert) * g.b_estride;
  const gg_bf16* __restrict__ B0 = (prod ? g.b1 : g.b0) + w_off;
  const gg_bf16* __restrict__ B1 = SWIGLU ? g.b1 + w_off : B0;
  OutT* __restrict__ C = prod ? g.c1 : g.c0;
  const gg_bf16* __restrict__ A = g.a;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int r = tid; r < MF * 16; r += kTcThreads) {
    const int p = r < tile.rows ? g.sched[1 + tile.row0 + r] : -1;
    pair_of[r] = p;
    arow_of[r] = p >= 0 ? p / g.a_div : -1;
  }
  __syncthreads();
  const int nk = (K + kTcBK - 1) / kTcBK;

  // Stage `kc` into slot `slot`; chunks of 8 past the tile's rows, N or K
  // are zero-filled.
  auto load_stage = [&](int slot, int kc) {
    const int k0 = kc * kTcBK;
    gg_bf16* as = As + slot * MF * 16 * kTcLdA;
    for (int c = tid; c < MF * 16 * (kTcBK / 8); c += kTcThreads) {
      const int r = c / (kTcBK / 8);
      const int kk = (c % (kTcBK / 8)) * 8;
      const int ar = arow_of[r];
      const bool ok = ar >= 0 && k0 + kk < K;
      const gg_bf16* src =
          ok ? A + static_cast<size_t>(ar) * g.lda + k0 + kk : A;
      cp_async16(as + r * kTcLdA + kk, src, ok);
    }
#pragma unroll
    for (int h = 0; h < NB; ++h) {
      const gg_bf16* B = h == 0 ? B0 : B1;
      gg_bf16* bs = Bs + (slot * NB + h) * kTcBK * kTcLdB;
      for (int c = tid; c < kTcBK * (kTcBN / 8); c += kTcThreads) {
        const int r = c / (kTcBN / 8);
        const int nn = (c % (kTcBN / 8)) * 8;
        const bool ok = k0 + r < K && n0 + nn < N;
        const gg_bf16* src =
            ok ? B + static_cast<size_t>(k0 + r) * g.ldb + n0 + nn : B;
        cp_async16(bs + r * kTcLdB + nn, src, ok);
      }
    }
  };

  float acc[NB][MF][2][4];
#pragma unroll
  for (int h = 0; h < NB; ++h)
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][i][j][e] = 0.f;

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
    const gg_bf16* as = As + slot * MF * 16 * kTcLdA;
    // Each stage's 64-term products accumulate in the tensor core (`part`),
    // then add to `acc` in f32, as in stream_mma.
    float part[NB][MF][2][4];
#pragma unroll
    for (int h = 0; h < NB; ++h)
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[h][i][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kTcBK; ks += 16) {
      unsigned afr[MF][4];
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
        ldmatrix_x4(afr[mf], as + (mf * 16 + (lane & 15)) * kTcLdA + ks +
                                 (lane >> 4) * 8);
#pragma unroll
      for (int h = 0; h < NB; ++h) {
        const gg_bf16* bs = Bs + (slot * NB + h) * kTcBK * kTcLdB;
        unsigned bfr[4];
        ldmatrix_x4_trans(bfr, bs + (ks + (lane & 15)) * kTcLdB + warp * 16 +
                                   (lane >> 4) * 8);
#pragma unroll
        for (int mf = 0; mf < MF; ++mf) {
          mma_bf16(part[h][mf][0], afr[mf], bfr[0], bfr[1]);
          mma_bf16(part[h][mf][1], afr[mf], bfr[2], bfr[3]);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < NB; ++h)
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[h][i][j][e] += part[h][i][j][e];
  }
  cp_async_wait<0>();

  // m16n8 accumulator layout: c0,c1 at (row g, cols 2t, 2t+1), c2,c3 at
  // row g + 8, with g = lane / 4 and t = lane % 4.
  const int gq = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int mf = 0; mf < MF; ++mf) {
#pragma unroll
    for (int nf = 0; nf < 2; ++nf) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = mf * 16 + gq + (e >> 1) * 8;
        const int n = n0 + warp * 16 + nf * 8 + 2 * t + (e & 1);
        if (r >= tile.rows || n >= N) continue;
        float v = acc[0][mf][nf][e];
        if constexpr (SWIGLU) v = gg_swiglu(v, acc[NB - 1][mf][nf][e]);
        C[static_cast<size_t>(pair_of[r]) * g.ldc + n] = from_f32<OutT>(v);
      }
    }
  }
}

// The world-1 kernel: grid = (max_tiles, column tiles), one tile a block.
template <int MF, bool SWIGLU, typename OutT>
__global__ void __launch_bounds__(kTcThreads)
group_mma(GgArgs<gg_bf16, OutT> g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  gg_mma_tile<MF, SWIGLU, OutT>(g, blockIdx.x, blockIdx.y, smem_raw);
}

// ---------------------------------------------------------------------------
// 2b. FMA tile (f32, odd shapes): row tile `tile` by 64-column tile `col`,
// 256 threads; thread (ty, tx) owns rows ty*4..+3 and columns tx*4..+3 of a
// 64 x 64 tile and sums K in order. Shared memory as for gg_mma_tile.
constexpr int kGgFmBN = 64;
constexpr int kGgFmBK = 16;
constexpr int kGgFmThreads = 256;

template <typename T, bool SWIGLU, typename OutT>
__device__ __forceinline__ void gg_fma_tile(const GgArgs<T, OutT>& g,
                                            int tile_idx, int col) {
  constexpr int NB = SWIGLU ? 2 : 1;
  __shared__ float As[kGgFmBK][kGgMaxRows + 4];    // A tile, transposed
  __shared__ float Bs[NB][kGgFmBK][kGgFmBN + 4];
  __shared__ int pair_of[kGgMaxRows];
  __shared__ int arow_of[kGgMaxRows];

  GgTile tile;
  if (!gg_tile(g.sched, g.P, g.max_tiles, tile_idx, tile)) return;
  const int K = g.K, N = g.N;
  int prod = 0;
  int n0 = col * kGgFmBN;
  if (!SWIGLU && col >= g.col_tiles) {
    prod = 1;
    n0 = (col - g.col_tiles) * kGgFmBN;
  }
  const size_t w_off = static_cast<size_t>(tile.expert) * g.b_estride;
  const T* __restrict__ B0 = (prod ? g.b1 : g.b0) + w_off;
  const T* __restrict__ B1 = SWIGLU ? g.b1 + w_off : B0;
  OutT* __restrict__ C = prod ? g.c1 : g.c0;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  for (int r = tid; r < kGgMaxRows; r += kGgFmThreads) {
    const int p = r < tile.rows ? g.sched[1 + tile.row0 + r] : -1;
    pair_of[r] = p;
    arow_of[r] = p >= 0 ? p / g.a_div : -1;
  }
  __syncthreads();

  float acc[NB][4][4];
#pragma unroll
  for (int h = 0; h < NB; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[h][i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kGgFmBK) {
    for (int e = tid; e < kGgMaxRows * kGgFmBK; e += kGgFmThreads) {
      const int r = e / kGgFmBK;
      const int kk = e % kGgFmBK;
      const int ar = arow_of[r];
      As[kk][r] = (ar >= 0 && k0 + kk < K)
                      ? to_f32(g.a[static_cast<size_t>(ar) * g.lda + k0 + kk])
                      : 0.f;
    }
#pragma unroll
    for (int h = 0; h < NB; ++h) {
      const T* B = h == 0 ? B0 : B1;
      for (int e = tid; e < kGgFmBK * kGgFmBN; e += kGgFmThreads) {
        const int r = e / kGgFmBN;
        const int c = e % kGgFmBN;
        Bs[h][r][c] = (k0 + r < K && n0 + c < N)
                          ? to_f32(B[static_cast<size_t>(k0 + r) * g.ldb + n0 + c])
                          : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGgFmBK; ++kk) {
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
    const int r = ty * 4 + i;
    if (r >= tile.rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n >= N) continue;
      float v = acc[0][i][j];
      if constexpr (SWIGLU) v = gg_swiglu(v, acc[NB - 1][i][j]);
      C[static_cast<size_t>(pair_of[r]) * g.ldc + n] = from_f32<OutT>(v);
    }
  }
}

// The world-1 kernel: grid = (max_tiles, 64-column tiles), one tile a block.
template <typename T, bool SWIGLU, typename OutT>
__global__ void __launch_bounds__(kGgFmThreads)
group_fma(GgArgs<T, OutT> g) {
  gg_fma_tile<T, SWIGLU, OutT>(g, blockIdx.x, blockIdx.y);
}

// ---------------------------------------------------------------------------
// How one call runs. The path and the tile rows depend on the dtype and the
// shape only, so equal inputs give equal bits.
struct GgPlan {
  int path;       // 0: group_fma, 1: group_mma
  int m_blk;      // rows per tile
  int max_tiles;  // grid.x, the worst case of live tiles
};

// The strides (elements) of A's rows, W's rows and W's experts; the
// tensor-core path reads 16-byte chunks, so each must be a multiple of 8.
GgPlan gg_make_plan(int P, int E, int K, int N, int dtype, long long lda,
                    long long ldb, long long b_estride) {
  GgPlan p;
  p.path = (dtype == 0 && K % 8 == 0 && N % 8 == 0 && lda % 8 == 0 &&
            ldb % 8 == 0 && b_estride % 8 == 0) ? 1 : 0;
  p.m_blk = gg_tile_rows(P, E);
  p.max_tiles = gg_max_tiles(P, E, p.m_blk);
  return p;
}

bool gg_args_ok(int P, int E, int K, int N, int dtype) {
  return P > 0 && E > 0 && E <= kGgMaxExperts && K > 0 && N > 0 &&
         (dtype == 0 || dtype == 1);
}

// Strides no smaller than the rows and experts they step over.
bool gg_strides_ok(int K, int N, long long lda, long long ldb,
                   long long b_estride) {
  return lda >= K && ldb >= N && b_estride >= static_cast<long long>(K) * ldb;
}

template <int MF, bool SWIGLU, typename OutT>
cudaError_t launch_group_mma(const GgArgs<gg_bf16, OutT>& g, int n_b,
                             cudaStream_t stream) {
  constexpr int smem = gg_mma_smem<MF, SWIGLU>();
  const cudaError_t err = cudaFuncSetAttribute(
      group_mma<MF, SWIGLU, OutT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(g.max_tiles, g.col_tiles * (SWIGLU ? 1 : n_b));
  group_mma<MF, SWIGLU, OutT><<<grid, kTcThreads, smem, stream>>>(g);
  return cudaSuccess;
}

// The product of a planned call, after its schedule (the operands are
// typed by the caller; OutT is T or float; outputs contiguous).
template <typename T, typename OutT, bool SWIGLU>
cudaError_t run_group_product(const GgPlan& p, GgArgs<T, OutT> g, int n_b,
                              cudaStream_t stream) {
  g.max_tiles = p.max_tiles;
  g.ldc = g.N;
  if constexpr (sizeof(T) == 2) {
    if (p.path == 1) {
      g.col_tiles = (g.N + kTcBN - 1) / kTcBN;
      if (p.m_blk == 16) return launch_group_mma<1, SWIGLU, OutT>(g, n_b, stream);
      if (p.m_blk == 32) return launch_group_mma<2, SWIGLU, OutT>(g, n_b, stream);
      return launch_group_mma<4, SWIGLU, OutT>(g, n_b, stream);
    }
  }
  g.col_tiles = (g.N + kGgFmBN - 1) / kGgFmBN;
  dim3 grid(p.max_tiles, g.col_tiles * (SWIGLU ? 1 : n_b));
  group_fma<T, SWIGLU, OutT><<<grid, kGgFmThreads, 0, stream>>>(g);
  return cudaSuccess;
}

}  // namespace
