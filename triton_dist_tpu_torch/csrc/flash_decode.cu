// GQA flash decode for Hopper (sm_90a): one query position per sequence
// against its KV cache, dense rows or pages through a block table, at world
// = 1 and, with the cache's positions split over W ranks on the one card, at
// world W.
//
// Replaces, in triton_dist_tpu/ops/flash_decode.py:
//  * _tiled_decode_kernel (:280), reached from gqa_fwd_batch_decode (:500,
//    dense rows) and gqa_fwd_batch_decode_paged (:600, pages read through
//    pool[block_table[b, i]]): at world = 1 `flash_decode_partial`, a
//    split-KV partial kernel, and `flash_decode_combine`, the log-sum-exp
//    merge of _exchange_and_merge (:218) / _merge (:194), which at world = 1
//    merges the splits of one row instead of the ranks of a mesh;
//  * _decode_kernel (:262), the variant FlashDecodeContext.resolve_variant
//    (:105) picks for shards of at most 4 MiB: at world = 1
//    `flash_decode_single`, one block per (row, KV head) over the whole
//    cache, no split and no combine launch;
//  * both at world W, with _exchange_and_merge (:218) between ranks:
//    `tdt_flash_decode_world`, one cooperative launch over every rank's
//    work (below).
//
// Layouts (all contiguous): q and out (B, Hq, D); the dense cache
// (B, T, Hkv, D); the paged pool (P, page, Hkv, D) with a (B, n_pages) int32
// table, T = n_pages * page. kv_len is a (B,) int32 vector. Query head
// hq = h * G + g belongs to KV head h, G = Hq / Hkv (Qwen3-8B: G = 4,
// D = 128).
//
// Numerics are the JAX package's (_local_partials :149, the tiled loop
// :348-386): scores = (q . k) * D^-0.5 summed in f32 (a product of two bf16
// values is exact in f32, so this equals the cache-dtype dot with f32
// accumulation); positions >= kv_len[b] are dead; an online softmax carries
// (m, l, acc) in f32 over chunks of 64 positions, p = exp(s - m) is rounded
// to bf16 before the PV product when q and the cache are both bf16 (l sums
// the unrounded p), and out = acc / max(l, 1e-20) in q's dtype, so a row with
// kv_len 0 gives 0.
//
// What bounds it: bytes. Each live K and V element is read once and used for
// 2 * G = 8 operations, far below the ~295 FLOP/byte where the card's compute
// would matter, so the least time is the live K/V bytes over 3.35 TB/s.
//
// What the design does about it. A block of 128 threads takes one KV head
// of one row and its G query heads, so K and V are read once for all G
// heads. The split-KV grid (splits, Hkv, B) puts about two blocks on each of
// the 132 SMs (tdt_flash_decode_plan, from the shape only); a split past a
// row's kv_len reads nothing and writes an empty partial (m = -1e30, l = 0).
// The combine pass sums the splits in a fixed order and nothing uses
// atomics, so repeated runs are bit-identical. Reads are plain coalesced
// loads (8 lanes share one position's 256-byte row of K); cp.async / TMA
// pipelining is later work.
//
// World W (tdt_flash_decode_world). Rank r holds positions [r t_loc,
// (r + 1) t_loc) of every row: the dense cache's columns there, or its own
// pool rows [r P, (r + 1) P) read through its table (W, B, n_pages), page
// ids local to the rank. One cooperative launch (every block resident)
// deals its work items to persistent blocks in phase order, so every wait's
// producer comes earlier in every block's order:
//  A. (rank, row, KV head, split): the partial of the rank's positions in
//     the split, by the same body as the world-1 kernels; a split past a
//     row's kv_len gives m = -1e30, l = 0 (whole ranks are empty at small
//     offsets). With one split (the single-pass variant) it is the rank's
//     partial and goes straight to step B's publish; else it lands in the
//     workspace and a barrier over the launch ends the phase.
//  B. (rank, row, KV head): the fixed-order reduction of its splits into one
//     (acc, l, m), written into slot `me` of the rank's own combine buffer
//     (its self signal released), then pushed into slot `me` of every
//     peer's combine buffer in combine_peer order (me + 1, me + 2, ...),
//     each push ending with the epoch-stamped release of its signal
//     (tdt_putmem_signal_block).
//  C. (rank, row, KV head): wait for the self signal and then the W - 1
//     peers' in combine_src order (me - 1, me - 2, ...); merge the W slots
//     of the rank's OWN combine buffer, which only the pushes fill, in rank
//     order 0..W-1 into the rank's output out[r]. Every rank merges the
//     same W partials in the same order: the W outputs are bit-equal.
// Combine buffers and signals live in the op's context (NaN-filled and
// zeroed once, never reset: a signal holds the call's epoch).

// Plain C entry points, loaded with ctypes. Each launch runs on the stream
// it is given, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "shmem.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;               // positions per online-softmax step
constexpr int kMaxG = 8;                 // query heads per KV head
constexpr int kMaxD = 256;               // head dim
constexpr int kColsPerThread = kMaxD / kThreads;
constexpr int kLanesPerPos = 8;          // lanes sharing one position's dot
constexpr int kPosPerWarp = 32 / kLanesPerPos;
constexpr float kNeg = -1e30f;
static_assert(kChunk == 64, "the softmax step gives each lane two positions");
static_assert(kChunk % (kWarps * kPosPerWarp) == 0,
              "every warp runs the same number of score rounds");

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

struct Params {
  const void* q;        // (B, Hq, D)
  const void* k;        // (B, T, Hkv, D) dense, or the (P, page, Hkv, D) pool
  const void* v;
  const int* kv_len;    // (B,)
  const int* table;     // (B, n_pages) for the pool (world W: (W, B,
                        // n_pages)), null for dense rows
  void* out;            // (B, Hq, D), q's dtype (world W: (W, B, Hq, D))
  float* ws_a;          // (B, Hkv, splits, G, D) (world W: (W, B, ...))
  float* ws_l;          // (B, Hkv, splits, G)
  float* ws_m;          // (B, Hkv, splits, G)
  int B, Hkv, G, D;
  int T;                // positions of one row (world W: of all ranks)
  int page;             // positions per page (paged)
  int n_pages;          // table columns (paged; world W: per rank)
  int pool_pages;       // pages in the pool (paged; world W: per rank)
  int split_len;        // positions per split, a multiple of kChunk
  int splits;
  float scale;          // D^-0.5 rounded to f32, as JAX rounds it
  // World W only.
  int world, t_loc;     // ranks; positions per rank
  const long long* comb_tab;  // (W,) combine buffers: W slots of (B, Hkv)
                              // entries of G * (D + 2) f32 (acc, l, m)
  const long long* sig_tab;   // (W,) signals: W sources x (B, Hkv) u64
  unsigned long long* flags;  // >= gridDim.x barrier words
  unsigned long long epoch;
  int fault;            // skip rank 0's first push of entry (0, 0)
};

// The positions one call of `attend` covers: [first, end) of row b, whose
// cache rows are dense (b * T + t) or pages of `table` (the rank's
// (B, n_pages) table) offset by `slot0` pool pages.
struct View {
  int first, end;
  const int* table;
  long long slot0;
};

// The row of the cache (dense) or pool (paged) that holds position t of
// sequence b. A table entry outside the pool is clamped into it, so a
// corrupt or stale table can never make the kernel read past the pool.
__device__ __forceinline__ long long cache_row(const Params& p, const View& w,
                                               int b, int t) {
  if (w.table == nullptr) return static_cast<long long>(b) * p.T + t;
  const int lt = t - w.first;
  int slot = w.table[static_cast<long long>(b) * p.n_pages + lt / p.page];
  slot = min(max(slot, 0), p.pool_pages - 1);
  return (w.slot0 + slot) * p.page + lt % p.page;
}

// The calling block folds positions [t0, t1) of row b (t1 already clamped
// to kv_len[b]) into the online-softmax state of the G query heads of KV
// head h. kFinal writes out = acc / max(l, 1e-20) at `out` (the G heads'
// rows, q's dtype); otherwise the unnormalized partial goes to a_dst (G x
// D), l_dst and m_dst (G each), row stride `ld` floats for a_dst.
template <typename TQ, typename TC, bool kFinal>
__device__ __forceinline__ void attend(const Params& p, const View& w, int h,
                                       int b, int t0, int t1, TQ* out,
                                       float* a_dst, float* l_dst,
                                       float* m_dst) {
  __shared__ float q_s[kMaxG][kMaxD];
  __shared__ float s_s[kMaxG][kChunk];     // scores, then probabilities
  __shared__ long long row_s[kChunk];
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];
  // p rounds to the cache dtype before PV only where JAX's compute dtype is
  // bf16: q and the cache both bf16.
  constexpr bool kRoundP = std::is_same<TQ, __nv_bfloat16>::value &&
                           std::is_same<TC, __nv_bfloat16>::value;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = p.G, D = p.D;
  const TQ* q = static_cast<const TQ*>(p.q);
  const TC* kc = static_cast<const TC*>(p.k);
  const TC* vc = static_cast<const TC*>(p.v);
  const long long pos_stride = static_cast<long long>(p.Hkv) * D;
  const long long head_off = static_cast<long long>(h) * D;

  __syncthreads();  // a previous item of this block is done with the state
  const long long q_base = (static_cast<long long>(b) * p.Hkv + h) * G * D;
  for (int i = tid; i < G * D; i += kThreads)
    q_s[i / D][i % D] = to_f32(q[q_base + i]);
  if (tid < kMaxG) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  float acc[kMaxG][kColsPerThread];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[g][j] = 0.f;
  __syncthreads();

  for (int c0 = t0; c0 < t1; c0 += kChunk) {
    const int n = min(kChunk, t1 - c0);
    for (int c = tid; c < n; c += kThreads)
      row_s[c] = cache_row(p, w, b, c0 + c);
    __syncthreads();

    // Scores: 8 lanes per position, 4 positions per warp at a time.
    const int sub = lane % kLanesPerPos;
    for (int c = warp * kPosPerWarp + lane / kLanesPerPos; c < kChunk;
         c += kWarps * kPosPerWarp) {
      float dot[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) dot[g] = 0.f;
      if (c < n) {
        const TC* kr = kc + row_s[c] * pos_stride + head_off;
#pragma unroll 4
        for (int d = sub; d < D; d += kLanesPerPos) {
          const float kv = to_f32(kr[d]);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) dot[g] += q_s[g][d] * kv;
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
#pragma unroll
        for (int off = kLanesPerPos / 2; off > 0; off >>= 1)
          dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
      if (sub == 0 && c < n) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) s_s[g][c] = dot[g] * p.scale;
      }
    }
    __syncthreads();

    // Online-softmax step, one warp per query head.
    for (int g = warp; g < G; g += kWarps) {
      const float m_old = m_s[g];
      const float s0 = lane < n ? s_s[g][lane] : kNeg;
      const float s1 = lane + 32 < n ? s_s[g][lane + 32] : kNeg;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_old, mx);
      const float p0 = lane < n ? expf(s0 - m_new) : 0.f;
      const float p1 = lane + 32 < n ? expf(s1 - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      float r0 = p0, r1 = p1;
      if constexpr (kRoundP) {
        r0 = __bfloat162float(__float2bfloat16_rn(p0));
        r1 = __bfloat162float(__float2bfloat16_rn(p1));
      }
      if (lane < n) s_s[g][lane] = r0;
      if (lane + 32 < n) s_s[g][lane + 32] = r1;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // PV: thread tid owns columns tid and tid + 128 of every query head.
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int d = tid + j * kThreads;
      if (d < D) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g][j] *= alpha_s[g];
        // Unrolled so that several V loads are in flight per thread.
#pragma unroll 8
        for (int c = 0; c < n; ++c) {
          const float vv = to_f32(vc[row_s[c] * pos_stride + head_off + d]);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) acc[g][j] += s_s[g][c] * vv;
        }
      }
    }
    __syncthreads();  // the next chunk overwrites row_s and s_s
  }

#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) {
    const int d = tid + j * kThreads;
    if (d < D) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          if constexpr (kFinal)
            out[static_cast<long long>(g) * D + d] =
                from_f32<TQ>(acc[g][j] / fmaxf(l_s[g], 1e-20f));
          else
            a_dst[g * D + d] = acc[g][j];
        }
      }
    }
  }
  if constexpr (!kFinal) {
    if (tid < G) {
      l_dst[tid] = l_s[tid];
      m_dst[tid] = m_s[tid];
    }
  }
}

// grid = (splits, Hkv, B). Block (s, h, b) folds positions
// [s * split_len, (s + 1) * split_len) of row b, below kv_len[b]. kFinal
// (the single-pass kernel, one split) writes out; otherwise the block
// writes its unnormalized partial (acc, l, m) to the workspace.
template <typename TQ, typename TC, bool kFinal>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(Params p) {
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = max(0, min(p.kv_len[b], p.T));
  const int t0 = split * p.split_len;
  const int t1 = min(t0 + p.split_len, len);
  const View w = {0, p.T, p.table, 0};
  const long long bh = static_cast<long long>(b) * p.Hkv + h;
  if constexpr (kFinal) {
    attend<TQ, TC, true>(p, w, h, b, t0, t1,
                         static_cast<TQ*>(p.out) + bh * p.G * p.D, nullptr,
                         nullptr, nullptr);
  } else {
    const long long base = (bh * p.splits + split) * p.G;
    attend<TQ, TC, false>(p, w, h, b, t0, t1, nullptr, p.ws_a + base * p.D,
                          p.ws_l + base, p.ws_m + base);
  }
}

// grid = (1, Hkv, B). Merges the splits of (b, h) in the order 0, 1, ...:
// m* = max_s m_s, out = sum_s a_s e^(m_s - m*) / max(sum_s l_s e^(m_s - m*),
// 1e-20), the _merge of the JAX package.
template <typename TQ>
__global__ void __launch_bounds__(kThreads)
flash_decode_combine(Params p) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int G = p.G, D = p.D, S = p.splits;
  const long long row = static_cast<long long>(b) * p.Hkv + h;
  const long long base = row * S * G;
  TQ* out = static_cast<TQ*>(p.out) + row * G * D;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float m_star = kNeg;
    for (int s = 0; s < S; ++s)
      m_star = fmaxf(m_star, p.ws_m[base + static_cast<long long>(s) * G + g]);
    float num = 0.f, den = 0.f;
    for (int s = 0; s < S; ++s) {
      const long long at = base + static_cast<long long>(s) * G + g;
      const float sc = expf(p.ws_m[at] - m_star);
      num += p.ws_a[at * D + d] * sc;
      den += p.ws_l[at] * sc;
    }
    out[i] = from_f32<TQ>(num / fmaxf(den, 1e-20f));
  }
}

// -- world W ------------------------------------------------------------------
// Floats of one combine entry: acc (G x D), then l (G), then m (G).
__device__ __forceinline__ int entry_floats(const Params& p) {
  return p.G * (p.D + 2);
}

// Rank `owner`'s combine entry of source slot `src`, row b, KV head h.
__device__ __forceinline__ float* comb_entry(const Params& p, int owner,
                                             int src, int b, int h) {
  float* base = reinterpret_cast<float*>(tdt_peer_ptr(p.comb_tab, owner));
  const long long e =
      (static_cast<long long>(src) * p.B + b) * p.Hkv + h;
  return base + e * entry_floats(p);
}

// Rank `owner`'s signal for source `src`, row b, KV head h.
__device__ __forceinline__ unsigned long long* comb_signal(const Params& p,
                                                           int owner, int src,
                                                           int b, int h) {
  unsigned long long* base = reinterpret_cast<unsigned long long*>(
      tdt_peer_ptr(p.sig_tab, owner));
  return base + (static_cast<long long>(src) * p.B + b) * p.Hkv + h;
}

// Step B's publish, after the block has written rank me's partial of (b, h)
// into its own slot: release the self signal, then push the entry into slot
// `me` of each peer in combine_peer order, each push with its signal.
__device__ __forceinline__ void publish(const Params& p, int me, int b,
                                        int h) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    tdt_signal_release(comb_signal(p, me, me, b, h), p.epoch);
  }
  const unsigned char* src =
      reinterpret_cast<const unsigned char*>(comb_entry(p, me, me, b, h));
  const long long bytes = static_cast<long long>(entry_floats(p)) * 4;
  for (int i = 1; i < p.world; ++i) {
    const int peer = (me + i) % p.world;           // combine_peer(me, i)
    unsigned char* dst =
        reinterpret_cast<unsigned char*>(comb_entry(p, peer, me, b, h));
    if (p.fault && me == 0 && i == 1 && b == 0 && h == 0) {
      // The planted fault: the push is skipped, its signal still set.
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence();
        tdt_signal_release(comb_signal(p, peer, me, b, h), p.epoch);
      }
      continue;
    }
    tdt_putmem_signal_block(dst, src, bytes, comb_signal(p, peer, me, b, h),
                            p.epoch);
  }
}

template <typename TQ, typename TC>
__global__ void __launch_bounds__(kThreads)
flash_decode_world(Params p) {
  const int W = p.world, G = p.G, D = p.D;
  const int rows = W * p.B * p.Hkv;         // (rank, row, KV head) items
  const int nblk = gridDim.x;

  // A. partials over each rank's splits.
  const long long n_a = static_cast<long long>(rows) * p.splits;
  for (long long it = blockIdx.x; it < n_a; it += nblk) {
    const int split = static_cast<int>(it % p.splits);
    const int item = static_cast<int>(it / p.splits);
    const int h = item % p.Hkv;
    const int b = (item / p.Hkv) % p.B;
    const int me = item / (p.Hkv * p.B);
    const int first = me * p.t_loc;
    const int len = max(0, min(p.kv_len[b], p.T));
    const int t0 = first + split * p.split_len;
    const int t1 = min(min(t0 + p.split_len, first + p.t_loc), len);
    const View w = {first, first + p.t_loc,
                    p.table == nullptr ? nullptr
                        : p.table + static_cast<long long>(me) * p.B *
                                        p.n_pages,
                    static_cast<long long>(me) * p.pool_pages};
    if (p.splits == 1) {
      float* e = comb_entry(p, me, me, b, h);
      attend<TQ, TC, false>(p, w, h, b, t0, t1, nullptr, e, e + G * D,
                            e + G * D + G);
      publish(p, me, b, h);
    } else {
      const long long base = it * G;         // (me, b, h, split) * G
      attend<TQ, TC, false>(p, w, h, b, t0, t1, nullptr,
                            p.ws_a + base * D, p.ws_l + base, p.ws_m + base);
    }
  }

  // B. each (rank, row, head)'s splits reduced into its own slot, pushed.
  if (p.splits > 1) {
    tdt_barrier_all(p.flags, p.epoch);
    for (int item = blockIdx.x; item < rows; item += nblk) {
      const int h = item % p.Hkv;
      const int b = (item / p.Hkv) % p.B;
      const int me = item / (p.Hkv * p.B);
      const long long base = static_cast<long long>(item) * p.splits * G;
      float* e = comb_entry(p, me, me, b, h);
      for (int i = threadIdx.x; i < G * (D + 1); i += kThreads) {
        const int g = i < G * D ? i / D : i - G * D;
        float m_star = kNeg;
        for (int s = 0; s < p.splits; ++s)
          m_star = fmaxf(m_star,
                         __ldcg(p.ws_m + base + static_cast<long long>(s) * G +
                                g));
        float sum = 0.f;
        for (int s = 0; s < p.splits; ++s) {
          const long long at = base + static_cast<long long>(s) * G + g;
          const float sc = expf(__ldcg(p.ws_m + at) - m_star);
          sum += (i < G * D ? __ldcg(p.ws_a + at * D + i % D)
                            : __ldcg(p.ws_l + at)) * sc;
        }
        if (i < G * D) {
          e[i] = sum;
        } else {
          e[G * D + g] = sum;
          e[G * D + G + g] = m_star;
        }
      }
      publish(p, me, b, h);
    }
  }

  // C. wait for every slot of the rank's own buffer, merge in rank order.
  for (int item = blockIdx.x; item < rows; item += nblk) {
    const int h = item % p.Hkv;
    const int b = (item / p.Hkv) % p.B;
    const int me = item / (p.Hkv * p.B);
    tdt_signal_wait_until(comb_signal(p, me, me, b, h), p.epoch);
    for (int i = 1; i < W; ++i) {
      const int src = (me - i + W) % W;            // combine_src(me, i)
      tdt_signal_wait_until(comb_signal(p, me, src, b, h), p.epoch);
    }
    TQ* out = static_cast<TQ*>(p.out) +
              ((static_cast<long long>(me) * p.B + b) * p.Hkv + h) * G * D;
    for (int i = threadIdx.x; i < G * D; i += kThreads) {
      const int g = i / D;
      float m_star = kNeg;
      for (int s = 0; s < W; ++s)
        m_star = fmaxf(m_star, __ldcg(comb_entry(p, me, s, b, h) + G * D +
                                      G + g));
      float num = 0.f, den = 0.f;
      for (int s = 0; s < W; ++s) {
        const float* e = comb_entry(p, me, s, b, h);
        const float sc = expf(__ldcg(e + G * D + G + g) - m_star);
        num += __ldcg(e + i) * sc;
        den += __ldcg(e + G * D + g) * sc;
      }
      out[i] = from_f32<TQ>(num / fmaxf(den, 1e-20f));
    }
  }
}

bool valid(const Params& p, bool paged) {
  if (p.B <= 0 || p.Hkv <= 0 || p.G <= 0 || p.G > kMaxG || p.D <= 0 ||
      p.D > kMaxD || p.T <= 0 || p.B > 65535 || p.Hkv > 65535)
    return false;
  if (paged && (p.page <= 0 || p.n_pages <= 0 || p.pool_pages <= 0 ||
                static_cast<long long>(p.page) * p.n_pages !=
                    (p.world > 1 ? p.t_loc : p.T)))
    return false;
  return true;
}

// The splits cover `span` positions (T at world 1, t_loc at world W).
bool valid_split(const Params& p, int span) {
  return p.splits > 0 && p.split_len > 0 && p.split_len % kChunk == 0 &&
         static_cast<long long>(p.splits) * p.split_len >= span &&
         static_cast<long long>(p.splits - 1) * p.split_len < span;
}

template <bool kFinal>
int launch_attend(const Params& p, int q_dtype, int kv_dtype,
                  cudaStream_t stream) {
  const dim3 grid(p.splits, p.Hkv, p.B);
  if (q_dtype == 0 && kv_dtype == 0)
    flash_decode_kernel<__nv_bfloat16, __nv_bfloat16, kFinal>
        <<<grid, kThreads, 0, stream>>>(p);
  else if (q_dtype == 1 && kv_dtype == 1)
    flash_decode_kernel<float, float, kFinal><<<grid, kThreads, 0, stream>>>(p);
  else if (q_dtype == 1 && kv_dtype == 0)
    flash_decode_kernel<float, __nv_bfloat16, kFinal>
        <<<grid, kThreads, 0, stream>>>(p);
  else if (q_dtype == 0 && kv_dtype == 1)
    flash_decode_kernel<__nv_bfloat16, float, kFinal>
        <<<grid, kThreads, 0, stream>>>(p);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the world-W kernel the card keeps resident at once (its
// occupancy on every SM), computed once per type pair.
template <typename TQ, typename TC>
cudaError_t world_resident(int* out) {
  static int cached = -1;
  if (cached < 0) {
    int dev = 0, sms = 0, per_sm = 0, coop = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, flash_decode_world<TQ, TC>, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    cached = sms * per_sm;
  }
  *out = cached;
  return cudaSuccess;
}

template <typename TQ, typename TC>
cudaError_t launch_world(Params p, cudaStream_t stream) {
  int resident = 0;
  cudaError_t err = world_resident<TQ, TC>(&resident);
  if (err != cudaSuccess) return err;
  const long long items = static_cast<long long>(p.world) * p.B * p.Hkv *
                          p.splits;
  const long long grid = items < resident ? items : resident;
  if (grid < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(flash_decode_world<TQ, TC>),
      dim3(static_cast<unsigned>(grid)),
      dim3(kThreads), args, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v,
                   const int* kv_len, const int* table, void* out,
                   float* ws_a, float* ws_l, float* ws_m, int B, int Hq,
                   int Hkv, int D, int T, int page, int pool_pages,
                   int split_len, int splits, float scale) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.kv_len = kv_len;
  p.table = table;
  p.out = out;
  p.ws_a = ws_a;
  p.ws_l = ws_l;
  p.ws_m = ws_m;
  p.B = B;
  p.Hkv = Hkv;
  p.G = (Hkv > 0 && Hq % Hkv == 0) ? Hq / Hkv : 0;
  p.D = D;
  p.T = T;
  p.page = table ? page : T;
  p.n_pages = (table && page > 0) ? T / page : 1;
  p.pool_pages = table ? pool_pages : B;
  p.split_len = split_len;
  p.splits = splits;
  p.scale = scale;
  p.world = 1;
  p.t_loc = T;
  return p;
}

}  // namespace

extern "C" {

// The split plan of one decode call: B rows of Hkv KV heads over T
// positions, on a card with `sms` SMs. About two blocks per SM, each split a
// whole number of 64-position chunks. It depends on the shape only, so equal
// inputs always sum in the same order. (World W asks for it with W * B rows
// over t_loc positions.)
int tdt_flash_decode_plan(int B, int Hkv, int T, int sms, int* splits,
                          int* split_len) {
  if (B <= 0 || Hkv <= 0 || T <= 0 || sms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = static_cast<long long>(B) * Hkv;
  const long long want = (2LL * sms + rows - 1) / rows;
  long long len = (T + want - 1) / want;
  len = (len + kChunk - 1) / kChunk * kChunk;
  *split_len = static_cast<int>(len);
  *splits = static_cast<int>((T + len - 1) / len);
  return 0;
}

// The split-KV partial kernel: per (row, KV head, split) the unnormalized
// (acc, l, m) into the workspace. `table` null means dense rows.
int tdt_flash_decode_partial(const void* q, const void* k, const void* v,
                             const int* kv_len, const int* table,
                             float* ws_a, float* ws_l, float* ws_m, int B,
                             int Hq, int Hkv, int D, int T, int page,
                             int pool_pages, int split_len, int splits,
                             float scale, int q_dtype, int kv_dtype,
                             void* stream) {
  const Params p = make_params(q, k, v, kv_len, table, nullptr, ws_a, ws_l,
                               ws_m, B, Hq, Hkv, D, T, page, pool_pages,
                               split_len, splits, scale);
  if (!valid(p, table != nullptr) || !valid_split(p, p.T))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_attend<false>(p, q_dtype, kv_dtype,
                              static_cast<cudaStream_t>(stream));
}

// The fixed-order merge of the partials into out (B, Hq, D) of q's dtype.
int tdt_flash_decode_combine(const float* ws_a, const float* ws_l,
                             const float* ws_m, void* out, int B, int Hq,
                             int Hkv, int D, int splits, int out_dtype,
                             void* stream) {
  Params p = make_params(nullptr, nullptr, nullptr, nullptr, nullptr, out,
                         const_cast<float*>(ws_a), const_cast<float*>(ws_l),
                         const_cast<float*>(ws_m), B, Hq, Hkv, D, 1, 0, 0, 1,
                         splits, 0.f);
  if (!valid(p, false) || splits <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(1, p.Hkv, p.B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0)
    flash_decode_combine<__nv_bfloat16><<<grid, kThreads, 0, s>>>(p);
  else if (out_dtype == 1)
    flash_decode_combine<float><<<grid, kThreads, 0, s>>>(p);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The single-pass kernel: one block per (row, KV head) over all T
// positions, writing out (B, Hq, D) of q's dtype.
int tdt_flash_decode_single(const void* q, const void* k, const void* v,
                            const int* kv_len, void* out, int B, int Hq,
                            int Hkv, int D, int T, float scale, int q_dtype,
                            int kv_dtype, void* stream) {
  const int len = (T + kChunk - 1) / kChunk * kChunk;
  const Params p = make_params(q, k, v, kv_len, nullptr, out, nullptr,
                               nullptr, nullptr, B, Hq, Hkv, D, T, 0, 0, len,
                               1, scale);
  if (!valid(p, false)) return static_cast<int>(cudaErrorInvalidValue);
  return launch_attend<true>(p, q_dtype, kv_dtype,
                             static_cast<cudaStream_t>(stream));
}

// Blocks the world-W kernel keeps resident for this type pair: the grid
// of its cooperative launch is at most this, and `flags` needs this many
// barrier words.
int tdt_flash_decode_world_grid(int q_dtype, int kv_dtype, int* blocks) {
  cudaError_t err;
  if (q_dtype == 0 && kv_dtype == 0)
    err = world_resident<__nv_bfloat16, __nv_bfloat16>(blocks);
  else if (q_dtype == 1 && kv_dtype == 1)
    err = world_resident<float, float>(blocks);
  else if (q_dtype == 1 && kv_dtype == 0)
    err = world_resident<float, __nv_bfloat16>(blocks);
  else if (q_dtype == 0 && kv_dtype == 1)
    err = world_resident<__nv_bfloat16, float>(blocks);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The world-W decode: `world` ranks, rank r holding positions [r t_loc,
// (r + 1) t_loc) of the (B, T = world t_loc, Hkv, D) dense cache, or (with
// `table` (world, B, n_pages) of rank-local page ids) its pool rows
// [r pool_pages, (r + 1) pool_pages) of the (world pool_pages, page, Hkv,
// D) pool. splits of split_len cover t_loc (one split: the single-pass
// variant, and ws_* may be null). out: (world, B, Hq, D) of q's dtype, one
// output per rank. comb_tab / sig_tab: the ranks' combine buffers and
// signals (see Params); flags: at least tdt_flash_decode_world_grid words.
// `epoch` must differ from every earlier call's on these buffers; `fault`
// plants the test fault (rank 0's first push of entry (0, 0) skipped, its
// signal still set).
int tdt_flash_decode_world(const void* q, const void* k, const void* v,
                           const int* kv_len, const int* table, void* out,
                           float* ws_a, float* ws_l, float* ws_m,
                           const long long* comb_tab,
                           const long long* sig_tab,
                           unsigned long long* flags, int world, int B,
                           int Hq, int Hkv, int D, int t_loc, int page,
                           int pool_pages, int split_len, int splits,
                           float scale, int q_dtype, int kv_dtype,
                           unsigned long long epoch, int fault,
                           void* stream) {
  if (world < 2 || t_loc <= 0 || comb_tab == nullptr || sig_tab == nullptr ||
      flags == nullptr || epoch == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long T = static_cast<long long>(world) * t_loc;
  if (T > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  Params p = make_params(q, k, v, kv_len, table, out, ws_a, ws_l, ws_m, B,
                         Hq, Hkv, D, static_cast<int>(T), page, pool_pages,
                         split_len, splits, scale);
  p.world = world;
  p.t_loc = t_loc;
  p.n_pages = (table && page > 0) ? t_loc / page : 1;
  p.pool_pages = table ? pool_pages : B;
  p.comb_tab = comb_tab;
  p.sig_tab = sig_tab;
  p.flags = flags;
  p.epoch = epoch;
  p.fault = fault;
  if (!valid(p, table != nullptr) || !valid_split(p, t_loc) ||
      (splits > 1 && (ws_a == nullptr || ws_l == nullptr || ws_m == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (q_dtype == 0 && kv_dtype == 0)
    err = launch_world<__nv_bfloat16, __nv_bfloat16>(p, s);
  else if (q_dtype == 1 && kv_dtype == 1)
    err = launch_world<float, float>(p, s);
  else if (q_dtype == 1 && kv_dtype == 0)
    err = launch_world<float, __nv_bfloat16>(p, s);
  else if (q_dtype == 0 && kv_dtype == 1)
    err = launch_world<__nv_bfloat16, float>(p, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

const char* tdt_flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
