// Causal (or full) flash-attention prefill for Hopper (sm_90a): the tiled
// online-softmax pass of the sequence-parallel prefill attention, with the
// G query heads of one KV head folded into the rows, at world = 1
// (tdt_sp_attention) and with the sequence split over W ranks on the one
// card (tdt_sp_ring_attention).
//
// Replaces triton_dist_tpu/ops/sp_attention.py::_sp_fused_kernel (:147),
// reached from sp_ag_attention_fused (:373, pallas_call :420) and
// sp_ag_attention(impl="pallas") (:617). At world = 1 its KV ring is one
// step whose causal test `cur <= me` (:328) always holds, so what remains
// is the flash loop: q-tiles whose row r is query r // G of the tile
// (:244), KV subtiles, f32 scores scaled after the product (:269-272),
// masked entries -1e30 (:273-277), an online softmax whose p is rounded to
// v's dtype for the PV product while l sums the unrounded p (:278-287), and
// out = acc / max(l, 1e-20) rounded once (:363).
//
// World W (tdt_sp_ring_attention): rank r holds positions [r S_loc,
// (r + 1) S_loc) of q, k and v (S_loc = S / W). One cooperative launch
// (every block resident) deals three phases of work items to persistent
// blocks in phase order, so every wait's producer comes earlier in every
// block's order:
//  0. (rank, row, piece of 64 positions): the rank copies its K/V chunk
//     into slot `me` of its own workspace and releases that piece's signal
//     (the local copy at :183-189);
//  1. (ring step s < W - 1, rank, row, piece): the rank waits for piece of
//     chunk cur = me - s in its workspace, then forwards it into slot cur of
//     its right neighbour's workspace with a signal stamped with the call's
//     epoch (chunk_copy(cur) at :325, wait_recv of `nxt` at :336);
//  2. (rank, row, KV head, q-tile): the flash loop over the chunks JAX's
//     ring consumes, in its order me, me - 1, ..., 0 under a causal mask
//     (`cur <= me`, :328; all W chunks otherwise), each read from the
//     rank's OWN workspace, which only the copies fill, once the signals of
//     the pieces it reads hold the epoch (the wait for `nxt` at :336).
//     Chunk me is masked on the diagonal, earlier chunks not at all. The
//     bf16 item walks the tiles of all its chunks in one flat loop, so the
//     double-buffered loads run on across chunk boundaries (a tile loop
//     nested in a chunk loop compiled to markedly slower code).
// Rank W - 1 consumes W chunks and rank 0 one: the compute items go out
// longest first (rank W - 1's first, and within a rank the q-tiles nearest
// the diagonal's end), over every block of the launch (on one card a rank
// owns no SMs; blocks of its own would idle rank 0's under the mask). Workspaces (NaN-
// filled once) and signals (zeroed once, never reset) live in the op's
// context. The bodies of the tiles are the world-1 kernel's.
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
#include "shmem.cuh"

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
  int n_qt;             // q-tiles of one (b, h): ceil(S_loc * G / kBM)
  int causal;
  float scale;          // D^-0.5 rounded to f32, as JAX rounds it
  // World W only (world = 1: S_loc = S).
  int world, s_loc;
  int n_pieces;         // 64-position pieces of one row's chunk
  const long long* ws_tab;   // (W,) workspaces: K slots then V slots, each
                             // W x (B, S_loc, Hkv, D)
  const long long* sig_tab;  // (W,) signals: (W slots, B, n_pieces) u64
  unsigned long long epoch;
  int fault;            // skip rank 0's first forward of (row 0, piece 0)
};

// The (b, h, q-tile) of a block's work.
struct Tile {
  int b, h;
  long long r0;         // first folded row
  long long rows;       // S_loc * G
  long long pos0;       // global position of the rank's first query
};

// World 1: tiles are launched in falling order of their index, all (b, h)
// of one tile together, so under a causal mask the longest tiles start
// first.
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
  t.pos0 = 0;
  return t;
}

// KV tiles of positions [0, n_keys) that the q-tile reads: all of them, or
// under the diagonal's causal mask those up to its last query.
__device__ __forceinline__ int kv_tiles(const Tile& t, int G, long long n_keys,
                                        bool diag) {
  long long kv_end = n_keys;
  if (diag) {
    const long long last = min(t.r0 + kBM, t.rows) - 1;
    kv_end = min(kv_end, last / G + 1);
  }
  return static_cast<int>((kv_end + kBN - 1) / kBN);
}

// Element offset of folded row R of (b, h) in q or out.
__device__ __forceinline__ long long q_offset(const Params& p, const Tile& t,
                                              long long R, int D) {
  return ((static_cast<long long>(t.b) * p.S + t.pos0 + R / p.G) * p.Hq +
          static_cast<long long>(t.h) * p.G + R % p.G) *
         D;
}

// Stages the block's 64 folded q rows into `dst` (row stride `ld`
// elements); rows past the tile's rows are zero-filled.
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

// Stages KV tile `j` (64 positions of k and v, position i at kb + i *
// stride) into `ks` and `vs`; positions past n_keys are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_kv(const T* kb, const T* vb,
                                        long long stride, long long n_keys,
                                        int j, T* ks, T* vs, int ld) {
  constexpr int kChunks = D * static_cast<int>(sizeof(T)) / 16;
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  for (int c = threadIdx.x; c < kBN * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int cc = (c % kChunks) * kPer;
    const long long pos = static_cast<long long>(j) * kBN + r;
    const bool ok = pos < n_keys;
    const long long off = ok ? pos * stride + cc : 0;
    cp_async16(ks + r * ld + cc, kb + off, ok);
    cp_async16(vs + r * ld + cc, vb + off, ok);
  }
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

// The online-softmax state of a warp's 16 rows.
template <int D>
struct MmaState {
  unsigned qf[D / 16][4];
  float o[D / 8][4];
  float m0, m1, l0, l1;
};

// Folds one KV tile (keys k0 + [0, kBN) of n_keys, in `ks_` / `vs_`) into
// the state. `diag`: the causal mask applies, the lane's rows at query
// positions qpos0 / qpos1 of the same origin as the keys, qmin the block's
// first; otherwise only keys past n_keys are masked.
template <int D>
__device__ __forceinline__ void mma_tile(MmaState<D>& st,
                                         const __nv_bfloat16* ks_,
                                         const __nv_bfloat16* vs_, int k0,
                                         long long n_keys, bool diag,
                                         int qpos0, int qpos1, int qmin,
                                         float scale) {
  constexpr int LD = mma_ld<D>();
  constexpr int KS = D / 16;              // k-steps of the score product
  constexpr int NF = kBN / 8;             // score fragments per row block
  constexpr int DF = D / 8;               // output fragments per row block
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;

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
      mma_bf16(s[2 * np], st.qf[ks], kb[0], kb[1]);
      mma_bf16(s[2 * np + 1], st.qf[ks], kb[2], kb[3]);
    }
  }

  // Scale, mask, and the tile's row maxima (a row's 64 columns lie in
  // the four lanes of one quad). Only a tile that reaches past n_keys or
  // past the block's first query position can hold a masked entry.
  const bool edge = k0 + kBN > n_keys || (diag && k0 + kBN - 1 > qmin);
  float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
  for (int nf = 0; nf < NF; ++nf) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kpos = k0 + nf * 8 + 2 * tq + (e & 1);
      const bool ok = !edge || (kpos < n_keys &&
                                (!diag || kpos <= (e < 2 ? qpos0 : qpos1)));
      s[nf][e] = ok ? s[nf][e] * scale : kNeg;
    }
    mx0 = fmaxf(mx0, fmaxf(s[nf][0], s[nf][1]));
    mx1 = fmaxf(mx1, fmaxf(s[nf][2], s[nf][3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(st.m0, mx0);
  const float mn1 = fmaxf(st.m1, mx1);
  const float c0 = expf(st.m0 - mn0);
  const float c1 = expf(st.m1 - mn1);
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
  st.m0 = mn0;
  st.m1 = mn1;
  st.l0 = st.l0 * c0 + sum0;
  st.l1 = st.l1 * c1 + sum1;
#pragma unroll
  for (int i = 0; i < DF; ++i) {
    st.o[i][0] *= c0;
    st.o[i][1] *= c0;
    st.o[i][2] *= c1;
    st.o[i][3] *= c1;
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
      mma_bf16(st.o[2 * dp], a, vb[0], vb[1]);
      mma_bf16(st.o[2 * dp + 1], a, vb[2], vb[3]);
    }
  }
}

template <int D>
__device__ __forceinline__ void mma_init(MmaState<D>& st) {
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[i][e] = 0.f;
  st.m0 = st.m1 = kNeg;
  st.l0 = st.l1 = 0.f;
}

// Q fragments of the warp's 16 rows from the staged q tile.
template <int D>
__device__ __forceinline__ void mma_load_q(MmaState<D>& st,
                                           const __nv_bfloat16* Qs) {
  constexpr int LD = mma_ld<D>();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    ldmatrix_x4(st.qf[ks], Qs + (warp * 16 + (lane & 15)) * LD + ks * 16 +
                               (lane >> 4) * 8);
}

// out = O / max(l, 1e-20) for the warp's rows below the tile's rows.
template <int D>
__device__ __forceinline__ void mma_store(const Params& p, const Tile& t,
                                          const MmaState<D>& st) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
  const float d0 = fmaxf(st.l0, 1e-20f);
  const float d1 = fmaxf(st.l1, 1e-20f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long R = t.r0 + warp * 16 + g + half * 8;
    if (R >= t.rows) continue;
    __nv_bfloat16* row = out + q_offset(p, t, R, D);
    const float d = half ? d1 : d0;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const __nv_bfloat162 v2 = __floats2bfloat162_rn(
          st.o[i][2 * half] / d, st.o[i][2 * half + 1] / d);
      *reinterpret_cast<__nv_bfloat162*>(row + i * 8 + 2 * tq) = v2;
    }
  }
}

// The query positions (from the rank's first) of a lane's two rows and of
// the block's first row (positions fit in 32 bits: S < 2^31 - kBM).
struct QPos {
  int q0, q1, qmin;
};

__device__ __forceinline__ QPos mma_qpos(const Tile& t, int G) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  return {static_cast<int>((t.r0 + warp * 16 + g) / G),
          static_cast<int>((t.r0 + warp * 16 + g + 8) / G),
          static_cast<int>(t.r0 / G)};
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
sp_attention_mma(const Params p) {
  constexpr int LD = mma_ld<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBM * LD;      // [2][kBN][LD]
  __nv_bfloat16* Vs = Ks + 2 * kBN * LD;  // [2][kBN][LD]

  const Tile t = tile_of_block(p);
  const int n_kv = kv_tiles(t, p.G, p.S, p.causal);
  const long long stride = static_cast<long long>(p.Hkv) * D;
  const long long head = (static_cast<long long>(t.b) * p.S * p.Hkv + t.h) *
                         static_cast<long long>(D);
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) + head;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) + head;

  load_q<__nv_bfloat16, D>(p, t, Qs, LD);
  cp_async_commit();
  if (n_kv > 0) load_kv<__nv_bfloat16, D>(kb, vb, stride, p.S, 0, Ks, Vs, LD);
  cp_async_commit();

  const QPos qp = mma_qpos(t, p.G);
  MmaState<D> st;
  mma_init(st);

  for (int j = 0; j < n_kv; ++j) {
    if (j + 1 < n_kv) {
      const int nb = (j + 1) & 1;
      load_kv<__nv_bfloat16, D>(kb, vb, stride, p.S, j + 1,
                                Ks + nb * kBN * LD, Vs + nb * kBN * LD, LD);
    }
    cp_async_commit();
    cp_async_wait<1>();                   // Q and tile j landed
    __syncthreads();
    if (j == 0) mma_load_q(st, Qs);
    mma_tile(st, Ks + (j & 1) * kBN * LD, Vs + (j & 1) * kBN * LD, j * kBN,
             p.S, p.causal != 0, qp.q0, qp.q1, qp.qmin, p.scale);
    __syncthreads();                      // tile j's buffers are free
  }
  cp_async_wait<0>();
  mma_store(p, t, st);
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
struct FmaState {
  float o[D / 2];
  float m, l;
};

// Folds the staged KV tile (keys k0 + [0, kBN) of n_keys) into the
// thread's row, at query position qpos (of the keys' origin) when `diag`.
template <int D>
__device__ __forceinline__ void fma_tile(FmaState<D>& st, const float* Qs,
                                         const float* Ks, const float* Vs,
                                         float* Ps, long long k0,
                                         long long n_keys, bool diag,
                                         long long qpos, float scale) {
  constexpr int LD = fma_ld<D>();
  constexpr int NC = kBN / 2;             // score columns per thread
  constexpr int ND = D / 2;               // output dims per thread
  constexpr int CH = 8;                   // output dims per PV pass
  const int r = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;

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
    const long long kpos = k0 + 2 * i + half;
    const bool ok = kpos < n_keys && (!diag || kpos <= qpos);
    s[i] = ok ? s[i] * scale : kNeg;
    mx = fmaxf(mx, s[i]);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  const float mn = fmaxf(st.m, mx);
  const float c = expf(st.m - mn);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    s[i] = expf(s[i] - mn);
    sum += s[i];
    Ps[r * kPLd + 2 * i + half] = s[i];
  }
  // Both lanes of a row add the same two partial sums: equal l.
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  st.m = mn;
  st.l = st.l * c + sum;
  __syncthreads();                        // P of every row is written

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
    for (int u = 0; u < CH; ++u) st.o[c0 + u] = st.o[c0 + u] * c + pv[u];
  }
}

template <int D>
__device__ __forceinline__ void fma_init(FmaState<D>& st) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) st.o[i] = 0.f;
  st.m = kNeg;
  st.l = 0.f;
}

template <int D>
__device__ __forceinline__ void fma_store(const Params& p, const Tile& t,
                                          const FmaState<D>& st) {
  const long long R = t.r0 + (threadIdx.x >> 1);
  const int half = threadIdx.x & 1;
  if (R < t.rows) {
    float* row = static_cast<float*>(p.out) + q_offset(p, t, R, D);
    const float d = fmaxf(st.l, 1e-20f);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) row[2 * i + half] = st.o[i] / d;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
sp_attention_fma(const Params p) {
  constexpr int LD = fma_ld<D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + kBM * LD;
  float* Vs = Ks + kBN * LD;
  float* Ps = Vs + kBN * LD;              // [kBM][kPLd]

  const Tile t = tile_of_block(p);
  const int n_kv = kv_tiles(t, p.G, p.S, p.causal);
  const long long qpos = (t.r0 + (threadIdx.x >> 1)) / p.G;
  const long long stride = static_cast<long long>(p.Hkv) * D;
  const long long head = (static_cast<long long>(t.b) * p.S * p.Hkv + t.h) *
                         static_cast<long long>(D);
  const float* kb = static_cast<const float*>(p.k) + head;
  const float* vb = static_cast<const float*>(p.v) + head;

  load_q<float, D>(p, t, Qs, LD);
  cp_async_commit();

  FmaState<D> st;
  fma_init(st);
  for (int j = 0; j < n_kv; ++j) {
    load_kv<float, D>(kb, vb, stride, p.S, j, Ks, Vs, LD);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    fma_tile(st, Qs, Ks, Vs, Ps, static_cast<long long>(j) * kBN, p.S,
             p.causal != 0, qpos, p.scale);
    __syncthreads();                      // K, V and P are free
  }
  cp_async_wait<0>();
  fma_store(p, t, st);
}

// ---------------------------------------------------------------------------
// World W: the ring kernel.
// Rank `rank`'s workspace slot `slot` of K (kv = 0) or V (kv = 1): one
// (B, S_loc, Hkv, D) chunk.
template <typename T, int D>
__device__ __forceinline__ T* ws_slot(const Params& p, int rank, int kv,
                                      int slot) {
  const long long chunk = static_cast<long long>(p.B) * p.s_loc * p.Hkv * D;
  T* base = reinterpret_cast<T*>(tdt_peer_ptr(p.ws_tab, rank));
  return base + (static_cast<long long>(kv) * p.world + slot) * chunk;
}

__device__ __forceinline__ unsigned long long* piece_signal(const Params& p,
                                                            int rank,
                                                            int slot, int b,
                                                            int piece) {
  unsigned long long* base = reinterpret_cast<unsigned long long*>(
      tdt_peer_ptr(p.sig_tab, rank));
  return base + (static_cast<long long>(slot) * p.B + b) * p.n_pieces +
         piece;
}

// Piece `piece` (positions [64 piece, 64 (piece + 1)) of row b, K then V)
// from `src_k` / `src_v` (element offsets of the row's first position) into
// rank `dst_rank`'s slot `slot`, then its signal there (epoch). With `skip`
// only the signal is released (the planted fault).
template <typename T, int D>
__device__ __forceinline__ void copy_piece(const Params& p, const T* src_k,
                                           const T* src_v, int dst_rank,
                                           int slot, int b, int piece,
                                           bool skip) {
  const long long row = static_cast<long long>(p.Hkv) * D;
  const long long pos = static_cast<long long>(piece) * kBN;
  const long long n = min(static_cast<long long>(kBN), p.s_loc - pos);
  const long long at = (static_cast<long long>(b) * p.s_loc + pos) * row;
  unsigned long long* sig = piece_signal(p, dst_rank, slot, b, piece);
  if (skip) {
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      tdt_signal_release(sig, p.epoch);
    }
    return;
  }
  const long long bytes = n * row * static_cast<long long>(sizeof(T));
  T* dst_k = ws_slot<T, D>(p, dst_rank, 0, slot) + at;
  T* dst_v = ws_slot<T, D>(p, dst_rank, 1, slot) + at;
  tdt_putmem_block(reinterpret_cast<unsigned char*>(dst_k),
                   reinterpret_cast<const unsigned char*>(src_k + pos * row),
                   bytes);
  tdt_putmem_signal_block(
      reinterpret_cast<unsigned char*>(dst_v),
      reinterpret_cast<const unsigned char*>(src_v + pos * row), bytes, sig,
      p.epoch);
}

// Phases 0 and 1 of the ring (see the note at the top): item `it` of
// W B n_pieces own copies followed by (W - 1) W B n_pieces forwards.
template <typename T, int D>
__device__ __forceinline__ void ring_copy_item(const Params& p,
                                               long long it) {
  const int W = p.world;
  const long long per_step = static_cast<long long>(W) * p.B * p.n_pieces;
  const int step = static_cast<int>(it / per_step);  // 0: own, s + 1: fwd s
  const long long rem = it % per_step;
  const int me = static_cast<int>(rem / (static_cast<long long>(p.B) *
                                         p.n_pieces));
  const int b = static_cast<int>(rem / p.n_pieces % p.B);
  const int piece = static_cast<int>(rem % p.n_pieces);
  const long long row = static_cast<long long>(p.Hkv) * D;
  const long long at = static_cast<long long>(b) * p.s_loc * row;
  if (step == 0) {
    const long long off =
        (static_cast<long long>(b) * p.S + static_cast<long long>(me) *
         p.s_loc) * row;
    copy_piece<T, D>(p, static_cast<const T*>(p.k) + off,
                     static_cast<const T*>(p.v) + off, me, me, b, piece,
                     false);
    return;
  }
  const int s = step - 1;
  const int cur = (me - s + W) % W;
  tdt_signal_wait_until(piece_signal(p, me, cur, b, piece), p.epoch);
  copy_piece<T, D>(p, ws_slot<T, D>(p, me, 0, cur) + at,
                   ws_slot<T, D>(p, me, 1, cur) + at, (me + 1) % W, cur, b,
                   piece, p.fault && s == 0 && me == 0 && b == 0 &&
                              piece == 0);
}

// Phase 2 item `it`: the (rank, row, KV head, q-tile) it names, longest
// first.
__device__ __forceinline__ Tile ring_tile(const Params& p, long long it,
                                          int* me) {
  const long long bh_count = static_cast<long long>(p.B) * p.Hkv;
  const long long per_rank = bh_count * p.n_qt;
  *me = p.world - 1 - static_cast<int>(it / per_rank);
  const long long rem = it % per_rank;
  const long long qt = p.n_qt - 1 - rem / bh_count;
  const int bh = static_cast<int>(rem % bh_count);
  Tile t;
  t.b = bh / p.Hkv;
  t.h = bh % p.Hkv;
  t.rows = static_cast<long long>(p.s_loc) * p.G;
  t.r0 = qt * kBM;
  t.pos0 = static_cast<long long>(*me) * p.s_loc;
  return t;
}

// The calling block waits until the first n pieces of row b's chunk in
// rank `rank`'s slot `slot` have landed (their signals hold the epoch):
// one acquire load per piece, spread over the block's threads, before the
// chunk's first tile.
__device__ __forceinline__ void wait_pieces(const Params& p, int rank,
                                            int slot, int b, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const unsigned long long* sig = piece_signal(p, rank, slot, b, i);
    while (tdt_signal_acquire(sig) != p.epoch) __nanosleep(64);
  }
  __threadfence();
  __syncthreads();
}

// Rank me's consumed ring steps are a prefix: 0..me under a causal mask
// (the test cur <= me on chunk cur = me - s), all W otherwise; step s
// carries chunk (me - s) mod W, and only step 0 the diagonal.
__device__ __forceinline__ int ring_steps(const Params& p, int me) {
  return p.causal ? me + 1 : p.world;
}

template <int D>
__device__ __forceinline__ void ring_compute_mma(const Params& p,
                                                 long long it,
                                                 unsigned char* smem_raw) {
  constexpr int LD = mma_ld<D>();
  using T = __nv_bfloat16;
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* Ks = Qs + kBM * LD;
  T* Vs = Ks + 2 * kBN * LD;
  int me = 0;
  const Tile t = ring_tile(p, it, &me);
  const int W = p.world;
  const int n_steps = ring_steps(p, me);
  const long long stride = static_cast<long long>(p.Hkv) * D;
  const long long head =
      (static_cast<long long>(t.b) * p.s_loc * p.Hkv + t.h) * D;
  const QPos qp = mma_qpos(t, p.G);

  __syncthreads();                        // the previous item's smem is free
  load_q<T, D>(p, t, Qs, LD);
  cp_async_commit();
  MmaState<D> st;
  mma_init(st);
  // One flat loop over the tiles of every consumed chunk, so the
  // double-buffered loads run on across chunk boundaries: a load cursor
  // (step ls, tile lj of ln) one tile ahead of the compute cursor (step
  // cs, tile cj of cn). Entering a chunk, the load cursor first waits for
  // the chunk's pieces.
  int ls = 0, lj = 0;
  int ln = kv_tiles(t, p.G, p.s_loc, p.causal);
  const T* lkb = ws_slot<T, D>(p, me, 0, me) + head;
  const T* lvb = ws_slot<T, D>(p, me, 1, me) + head;
  wait_pieces(p, me, me, t.b, ln);
  load_kv<T, D>(lkb, lvb, stride, p.s_loc, 0, Ks, Vs, LD);
  cp_async_commit();
  int cs = 0, cj = 0, cn = ln;
  bool cdiag = p.causal;                  // step 0 carries chunk me
  for (int g = 0;; ++g) {
    if (++lj == ln && ++ls < n_steps) {
      const int cur = (me - ls + W) % W;
      lj = 0;
      ln = kv_tiles(t, p.G, p.s_loc, false);
      lkb = ws_slot<T, D>(p, me, 0, cur) + head;
      lvb = ws_slot<T, D>(p, me, 1, cur) + head;
      wait_pieces(p, me, cur, t.b, ln);
    }
    if (ls < n_steps) {
      const int nb = (g + 1) & 1;
      load_kv<T, D>(lkb, lvb, stride, p.s_loc, lj, Ks + nb * kBN * LD,
                    Vs + nb * kBN * LD, LD);
    }
    cp_async_commit();
    cp_async_wait<1>();                   // Q and tile g landed
    __syncthreads();
    if (g == 0) mma_load_q(st, Qs);
    mma_tile(st, Ks + (g & 1) * kBN * LD, Vs + (g & 1) * kBN * LD,
             cj * kBN, p.s_loc, cdiag, qp.q0, qp.q1, qp.qmin, p.scale);
    __syncthreads();                      // tile g's buffers are free
    if (++cj == cn) {
      if (++cs == n_steps) break;
      cj = 0;
      cn = kv_tiles(t, p.G, p.s_loc, false);
      cdiag = false;                      // only step 0 carries chunk me
    }
  }
  cp_async_wait<0>();
  mma_store(p, t, st);
}

template <int D>
__device__ __forceinline__ void ring_compute_fma(const Params& p,
                                                 long long it,
                                                 unsigned char* smem_raw) {
  constexpr int LD = fma_ld<D>();
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + kBM * LD;
  float* Vs = Ks + kBN * LD;
  float* Ps = Vs + kBN * LD;
  int me = 0;
  const Tile t = ring_tile(p, it, &me);
  const long long stride = static_cast<long long>(p.Hkv) * D;
  const long long head =
      (static_cast<long long>(t.b) * p.s_loc * p.Hkv + t.h) * D;
  const long long qpos = (t.r0 + (threadIdx.x >> 1)) / p.G;

  __syncthreads();                        // the previous item's smem is free
  load_q<float, D>(p, t, Qs, LD);
  cp_async_commit();
  FmaState<D> st;
  fma_init(st);
  for (int s = 0; s < ring_steps(p, me); ++s) {
    const int cur = (me - s + p.world) % p.world;
    const bool diag = p.causal && s == 0;
    const int n_kv = kv_tiles(t, p.G, p.s_loc, diag);
    const float* kb = ws_slot<float, D>(p, me, 0, cur) + head;
    const float* vb = ws_slot<float, D>(p, me, 1, cur) + head;
    wait_pieces(p, me, cur, t.b, n_kv);
    for (int j = 0; j < n_kv; ++j) {
      load_kv<float, D>(kb, vb, stride, p.s_loc, j, Ks, Vs, LD);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      fma_tile(st, Qs, Ks, Vs, Ps, static_cast<long long>(j) * kBN, p.s_loc,
               diag, qpos, p.scale);
      __syncthreads();                    // K, V and P are free
    }
  }
  cp_async_wait<0>();
  fma_store(p, t, st);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1)
sp_ring_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long copies = static_cast<long long>(p.world) * p.world * p.B *
                           p.n_pieces;
  const long long tiles = static_cast<long long>(p.world) * p.B * p.Hkv *
                          p.n_qt;
  for (long long it = blockIdx.x; it < copies + tiles; it += gridDim.x) {
    if (it < copies) {
      ring_copy_item<T, D>(p, it);
    } else if constexpr (sizeof(T) == 2) {
      ring_compute_mma<D>(p, it - copies, smem_raw);
    } else {
      ring_compute_fma<D>(p, it - copies, smem_raw);
    }
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

// One cooperative launch of the ring kernel: as many blocks as the card
// keeps resident (its occupancy on every SM), at most one per item.
template <typename T, int D>
cudaError_t launch_ring(int smem, Params p, cudaStream_t stream) {
  auto kernel = sp_ring_kernel<T, D>;
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  const long long items =
      static_cast<long long>(p.world) * p.world * p.B * p.n_pieces +
      static_cast<long long>(p.world) * p.B * p.Hkv * p.n_qt;
  long long grid = static_cast<long long>(sms) * per_sm;
  if (items < grid) grid = items;
  if (grid < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(static_cast<unsigned>(grid)),
                                    dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool valid_common(const void* q, const void* k, const void* v,
                  const void* out, int B, int S, int Hq, int Hkv, int D,
                  int dtype) {
  return q != nullptr && k != nullptr && v != nullptr && out != nullptr &&
         B > 0 && S > 0 && Hkv > 0 && Hq > 0 && Hq % Hkv == 0 &&
         (D == 64 || D == 128) && (dtype == 0 || dtype == 1) &&
         aligned16(q) && aligned16(k) && aligned16(v) && aligned16(out);
}

Params make_params(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int Hq, int Hkv, int causal, float scale) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.B = B;
  p.S = S;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.G = Hq / Hkv;
  p.causal = causal != 0;
  p.scale = scale;
  p.world = 1;
  p.s_loc = S;
  return p;
}

}  // namespace

extern "C" {

// out = attention(q, k, v) as described above. dtype: 0 bf16, 1 f32 (q,
// k, v and out alike); D: 64 or 128; causal: 0 or 1. Pointers must be
// 16-byte aligned. Returns a cudaError_t.
int tdt_sp_attention(const void* q, const void* k, const void* v, void* out,
                     int B, int S, int Hq, int Hkv, int D, int causal,
                     int dtype, float scale, void* stream) {
  if (!valid_common(q, k, v, out, B, S, Hq, Hkv, D, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(q, k, v, out, B, S, Hq, Hkv, causal, scale);
  const long long rows = static_cast<long long>(S) * p.G;
  const long long n_qt = (rows + kBM - 1) / kBM;
  const long long blocks = n_qt * B * Hkv;
  if (n_qt > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  p.n_qt = static_cast<int>(n_qt);
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

// The world-W prefill: q, k, v and out (B, S, Hq / Hkv, D) global, S split
// over `world` ranks; ws_tab / sig_tab: the ranks' workspaces (2 W B
// (S / W) Hkv D elements each, K slots then V slots) and signals (W B
// ceil(S / W / 64) words each). `epoch` must differ from every earlier
// call's on these buffers; `fault` plants the test fault (rank 0's first
// forward of row 0's first piece skipped, its signal still set). Returns a
// cudaError_t.
int tdt_sp_ring_attention(const void* q, const void* k, const void* v,
                          void* out, const long long* ws_tab,
                          const long long* sig_tab, int world, int B, int S,
                          int Hq, int Hkv, int D, int causal, int dtype,
                          float scale, unsigned long long epoch, int fault,
                          void* stream) {
  if (!valid_common(q, k, v, out, B, S, Hq, Hkv, D, dtype) || world < 2 ||
      S % world != 0 || ws_tab == nullptr || sig_tab == nullptr ||
      epoch == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(q, k, v, out, B, S, Hq, Hkv, causal, scale);
  p.world = world;
  p.s_loc = S / world;
  p.n_pieces = (p.s_loc + kBN - 1) / kBN;
  const long long n_qt = (static_cast<long long>(p.s_loc) * p.G + kBM - 1) /
                         kBM;
  if (n_qt > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.n_qt = static_cast<int>(n_qt);
  p.ws_tab = ws_tab;
  p.sig_tab = sig_tab;
  p.epoch = epoch;
  p.fault = fault;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = D == 64
              ? launch_ring<__nv_bfloat16, 64>(mma_smem_bytes<64>(), p, s)
              : launch_ring<__nv_bfloat16, 128>(mma_smem_bytes<128>(), p, s);
  else
    err = D == 64 ? launch_ring<float, 64>(fma_smem_bytes<64>(), p, s)
                  : launch_ring<float, 128>(fma_smem_bytes<128>(), p, s);
  return static_cast<int>(err);
}

// The runtime's message for an error code returned above.
const char* tdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
