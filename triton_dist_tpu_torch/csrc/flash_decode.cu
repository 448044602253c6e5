// GQA flash decode at world = 1 for Hopper (sm_90a): one query position per
// sequence against its KV cache, dense rows or pages through a block table.
//
// Replaces, in triton_dist_tpu/ops/flash_decode.py:
//  * _tiled_decode_kernel (:280), reached from gqa_fwd_batch_decode (:500,
//    dense rows) and gqa_fwd_batch_decode_paged (:600, pages read through
//    pool[block_table[b, i]]): here `flash_decode_partial`, a split-KV
//    partial kernel, and `flash_decode_combine`, the log-sum-exp merge of
//    _exchange_and_merge (:218) / _merge (:194), which at world = 1 merges
//    the splits of one row instead of the ranks of a mesh;
//  * _decode_kernel (:262), the variant FlashDecodeContext.resolve_variant
//    (:105) picks for shards of at most 4 MiB: here `flash_decode_single`,
//    one block per (row, KV head) over the whole cache, no split and no
//    combine launch.
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
// Plain C entry points, loaded with ctypes. Each launch runs on the stream
// it is given, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
  const int* table;     // (B, n_pages) for the pool, null for dense rows
  void* out;            // (B, Hq, D), q's dtype
  float* ws_a;          // (B, Hkv, splits, G, D)
  float* ws_l;          // (B, Hkv, splits, G)
  float* ws_m;          // (B, Hkv, splits, G)
  int B, Hkv, G, D;
  int T;                // positions of one row
  int page;             // positions per page (paged)
  int n_pages;          // table columns (paged)
  int pool_pages;       // pages in the pool (paged)
  int split_len;        // positions per split, a multiple of kChunk
  int splits;
  float scale;          // D^-0.5 rounded to f32, as JAX rounds it
};

// The row of the cache (dense) or pool (paged) that holds position t of
// sequence b. A table entry outside the pool is clamped into it, so a
// corrupt or stale table can never make the kernel read past the pool.
__device__ __forceinline__ long long cache_row(const Params& p, int b,
                                               int t) {
  if (p.table == nullptr) return static_cast<long long>(b) * p.T + t;
  int slot = p.table[static_cast<long long>(b) * p.n_pages + t / p.page];
  slot = min(max(slot, 0), p.pool_pages - 1);
  return static_cast<long long>(slot) * p.page + t % p.page;
}

// grid = (splits, Hkv, B). Block (s, h, b) folds positions
// [s * split_len, (s + 1) * split_len) of row b, below kv_len[b], into the
// online-softmax state of the G query heads of KV head h. kFinal (the
// single-pass kernel, one split) writes out = acc / max(l, 1e-20); otherwise
// the block writes its unnormalized partial (acc, l, m) to the workspace.
template <typename TQ, typename TC, bool kFinal>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(Params p) {
  __shared__ float q_s[kMaxG][kMaxD];
  __shared__ float s_s[kMaxG][kChunk];     // scores, then probabilities
  __shared__ long long row_s[kChunk];
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];
  // p rounds to the cache dtype before PV only where JAX's compute dtype is
  // bf16: q and the cache both bf16.
  constexpr bool kRoundP = std::is_same<TQ, __nv_bfloat16>::value &&
                           std::is_same<TC, __nv_bfloat16>::value;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = p.G, D = p.D;
  const TQ* q = static_cast<const TQ*>(p.q);
  const TC* kc = static_cast<const TC*>(p.k);
  const TC* vc = static_cast<const TC*>(p.v);
  const long long pos_stride = static_cast<long long>(p.Hkv) * D;
  const long long head_off = static_cast<long long>(h) * D;

  const int len = max(0, min(p.kv_len[b], p.T));
  const int t0 = split * p.split_len;
  const int t1 = min(t0 + p.split_len, len);

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
    for (int c = tid; c < n; c += kThreads) row_s[c] = cache_row(p, b, c0 + c);
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

  if constexpr (kFinal) {
    TQ* out = static_cast<TQ*>(p.out);
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int d = tid + j * kThreads;
      if (d < D) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G)
            out[q_base + static_cast<long long>(g) * D + d] =
                from_f32<TQ>(acc[g][j] / fmaxf(l_s[g], 1e-20f));
      }
    }
  } else {
    const long long base =
        ((static_cast<long long>(b) * p.Hkv + h) * p.splits + split) * G;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int d = tid + j * kThreads;
      if (d < D) {
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) p.ws_a[(base + g) * D + d] = acc[g][j];
      }
    }
    if (tid < G) {
      p.ws_l[base + tid] = l_s[tid];
      p.ws_m[base + tid] = m_s[tid];
    }
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

bool valid(const Params& p, bool paged) {
  if (p.B <= 0 || p.Hkv <= 0 || p.G <= 0 || p.G > kMaxG || p.D <= 0 ||
      p.D > kMaxD || p.T <= 0 || p.B > 65535 || p.Hkv > 65535)
    return false;
  if (paged && (p.page <= 0 || p.n_pages <= 0 || p.pool_pages <= 0 ||
                static_cast<long long>(p.page) * p.n_pages != p.T))
    return false;
  return true;
}

bool valid_split(const Params& p) {
  return p.splits > 0 && p.split_len > 0 && p.split_len % kChunk == 0 &&
         static_cast<long long>(p.splits) * p.split_len >= p.T &&
         static_cast<long long>(p.splits - 1) * p.split_len < p.T;
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

Params make_params(const void* q, const void* k, const void* v,
                   const int* kv_len, const int* table, void* out,
                   float* ws_a, float* ws_l, float* ws_m, int B, int Hq,
                   int Hkv, int D, int T, int page, int pool_pages,
                   int split_len, int splits, float scale) {
  Params p;
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
  return p;
}

}  // namespace

extern "C" {

// The split plan of one decode call: B rows of Hkv KV heads over T
// positions, on a card with `sms` SMs. About two blocks per SM, each split a
// whole number of 64-position chunks. It depends on the shape only, so equal
// inputs always sum in the same order.
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
  if (!valid(p, table != nullptr) || !valid_split(p))
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

const char* tdt_flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
