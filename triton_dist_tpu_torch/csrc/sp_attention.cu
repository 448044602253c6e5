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
//     item walks the tiles of all its chunks in one flat loop, so the
//     pipeline runs on across chunk boundaries.
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
// What the design does about it (bf16, an FA3-style forward):
//  * wgmma, the only way to the tensor cores' full rate: S = Q K^T as
//    m64n128k16 with Q and the K tile both read from shared memory
//    (K-major), O += P V as m64nDk16 with P in registers (the S
//    accumulator packs into wgmma's A fragments) and the V tile read
//    N-major through the transpose bit;
//  * a q tile of 128 folded rows, floor(128 / G) whole positions x G heads
//    of one KV head (G = 4: 32 positions; a G that does not divide 128
//    leaves the last rows dead; G > 128 splits a position's heads into
//    groups of 128), so each K/V tile brought in serves 128 rows; two
//    consumer warpgroups own 64 rows each;
//  * one producer warp keeps the K and V tiles (128 positions each) in
//    flight by TMA (cp.async.bulk.tensor) into a ring of kWgStages stages
//    under full / empty mbarriers, and brings each item's q tile once; the
//    views (tiles.cuh's make_box_view) are built on the host and passed as
//    __grid_constant__; TMA's zero fill past the extents is no mask, so
//    keys past n_keys and the causal diagonal are still masked explicitly;
//  * a persistent grid of one block per SM walks the items (b, h, q tile)
//    in a static deal, longest first (most KV tiles under the causal mask
//    first) and snaking (each round of grid items reversed after the
//    last), so the blocks' loads even out and the bits never depend on
//    timing; the stage and mbarrier parities carry from item to item;
//  * the block is three warpgroups: the producer's gives its registers up
//    (setmaxnreg) to the two consumers', 232 a thread, so a consumer holds
//    S (64 f32), O (D / 2 f32) and P (32 bf16 pairs) without spilling. A
//    288-thread block (one producer warp) did not help: ptxas budgeted it
//    as 384 threads, 168 registers, and the consumers spilled;
//  * the softmax runs under the products: each consumer issues tile g's
//    S = Q K^T together with tile g - 1's P V, then takes tile g's
//    softmax while P V runs (FA3's intra-warpgroup overlap), and keeps
//    the softmax short, since it and not the tensor cores bounds the
//    kernel: unmasked tiles take the row max of the raw scores and fold
//    the scale into the exponent's FMA, 2^x runs on ex2.approx.ftz, and
//    a warp whose rows all kept their max skips O's rescale;
//  * causal: KV tiles wholly in the future of every row of a q-tile are
//    skipped (exact: they give p = 0 and a correction factor of 1), only
//    the tiles on the diagonal (or past S) are masked;
//  * f32: the FMA body (p through shared memory, 64-wide tiles, one block
//    of four warps per 64 folded rows), so f32 inputs keep f32 products as
//    in the JAX package.
//
// Numerics against JAX: the scale multiplies the f32 scores; masked
// entries are -1e30, never -inf, so nothing gives NaN; p is rounded to
// v's dtype (bf16: round to nearest even) for the PV product, l sums the
// unrounded f32 p; out = acc / max(l, 1e-20) in q's dtype. The bf16 path
// takes p = exp(s - m) as 2^(s log2 e - m log2 e) (on an unmasked tile
// 2^(s_raw (scale log2 e) - m log2 e), the scale in the same FMA), within
// a few f32 ulps of exp, p below 2^-126 flushed to zero; the f32 path
// calls expf. bf16 KV tiles are 128 wide, JAX's default t_sub, so each p
// is rounded at JAX's running max; the f32 tiles are 64 wide (p is not
// rounded there).
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
#include "tiles.cuh"

namespace {

constexpr int kBM = 64;                  // f32: folded rows per block
constexpr int kBN = 64;                  // f32: KV positions per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPiece = 64;               // ring: positions per signal
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;        // (B, S, Hq, D)
  const void* k;        // (B, S, Hkv, D)
  const void* v;
  void* out;            // (B, S, Hq, D), q's dtype
  int B, S, Hq, Hkv, G;
  int n_qt;             // q-tiles of one (b, h)
  int causal;
  float scale;          // D^-0.5 rounded to f32, as JAX rounds it
  // bf16: a q tile is qp positions x qh heads (qh = min(G, 128), qp =
  // 128 / qh), n_hg = ceil(G / qh) head groups; n_qt = n_pt n_hg.
  int qp, qh, n_hg, n_pt;
  // World W only (world = 1: S_loc = S).
  int world, s_loc;
  int n_pieces;         // kPiece-position pieces of one row's chunk
  // Rank r's workspace (K slots then V slots, each W x (B, S_loc, Hkv,
  // D)) at ws_base + r ws_step elements; its signals ((W slots, B,
  // n_pieces) u64) at sig_base + r sig_step words.
  void* ws_base;
  long long ws_step;
  unsigned long long* sig_base;
  long long sig_step;
  unsigned long long epoch;
  int fault;            // skip rank 0's first forward of (row 0, piece 0)
};

// f32: the (b, h, q-tile) of a block's work.
struct QTile {
  int b, h;
  long long r0;         // first folded row
  long long rows;       // S_loc * G
  long long pos0;       // global position of the rank's first query
};

// World 1: tiles are launched in falling order of their index, all (b, h)
// of one tile together, so under a causal mask the longest tiles start
// first.
__device__ __forceinline__ QTile tile_of_block(const Params& p) {
  const long long bh_count = static_cast<long long>(p.B) * p.Hkv;
  const long long id = blockIdx.x;
  const int bh = static_cast<int>(id % bh_count);
  const long long qt = p.n_qt - 1 - id / bh_count;
  QTile t;
  t.b = bh / p.Hkv;
  t.h = bh % p.Hkv;
  t.rows = static_cast<long long>(p.S) * p.G;
  t.r0 = qt * kBM;
  t.pos0 = 0;
  return t;
}

// KV tiles of positions [0, n_keys) that the q-tile reads: all of them, or
// under the diagonal's causal mask those up to its last query.
__device__ __forceinline__ int kv_tiles(const QTile& t, int G,
                                        long long n_keys, bool diag) {
  long long kv_end = n_keys;
  if (diag) {
    const long long last = min(t.r0 + kBM, t.rows) - 1;
    kv_end = min(kv_end, last / G + 1);
  }
  return static_cast<int>((kv_end + kBN - 1) / kBN);
}

// Element offset of folded row R of (b, h) in q or out.
__device__ __forceinline__ long long q_offset(const Params& p, const QTile& t,
                                              long long R, int D) {
  return ((static_cast<long long>(t.b) * p.S + t.pos0 + R / p.G) * p.Hq +
          static_cast<long long>(t.h) * p.G + R % p.G) *
         D;
}

// Stages the block's 64 folded q rows into `dst` (row stride `ld`
// elements); rows past the tile's rows are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_q(const Params& p, const QTile& t, T* dst,
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
// bf16: wgmma on K/V tiles brought by TMA (see the note at the top).
constexpr int kWgRows = 128;             // folded rows per q tile
constexpr int kWgBN = 128;               // KV positions per tile
constexpr int kWgStages = 2;             // K and V tiles in flight
constexpr int kWgThreads = 384;          // the producer + two consumers

// Shared memory of a D-wide block, from a 1024-byte aligned base: the q
// tile (D / 64 boxes of 128 rows x 128 bytes), kWgStages K tiles, as many
// V tiles (D / 64 boxes of 128 positions x 128 bytes each), then the
// mbarriers.
template <int D>
struct WgShape {
  static constexpr int kBoxes = D / 64;
  static constexpr int kQBox = kWgRows * 128;
  static constexpr int kKvBox = kWgBN * 128;
  static constexpr int kQ = kBoxes * kQBox;
  static constexpr int kKv = kBoxes * kKvBox;        // one K or V tile
  static constexpr int kBars = 2 + 4 * kWgStages;
  static constexpr int kSmem = kQ + 2 * kWgStages * kKv + kBars * 8 + 1024;
};

template <int D>
struct SpSmem {
  using L = WgShape<D>;
  unsigned char* base;
  __device__ unsigned char* q() const { return base; }
  __device__ unsigned char* k(int s) const { return base + L::kQ + s * L::kKv; }
  __device__ unsigned char* v(int s) const { return k(kWgStages + s); }
  __device__ uint64_t* bar(int i) const {
    return reinterpret_cast<uint64_t*>(base + L::kQ +
                                       2 * kWgStages * L::kKv) + i;
  }
  // full: the producer's one arrival and the bytes; empty: the 8 consumer
  // warps' arrivals.
  __device__ uint64_t* q_full() const { return bar(0); }
  __device__ uint64_t* q_empty() const { return bar(1); }
  __device__ uint64_t* k_full(int s) const { return bar(2 + s); }
  __device__ uint64_t* k_empty(int s) const { return bar(2 + kWgStages + s); }
  __device__ uint64_t* v_full(int s) const {
    return bar(2 + 2 * kWgStages + s);
  }
  __device__ uint64_t* v_empty(int s) const {
    return bar(2 + 3 * kWgStages + s);
  }
};

template <int D>
__device__ __forceinline__ SpSmem<D> sp_smem(unsigned char* raw) {
  const uintptr_t p = (reinterpret_cast<uintptr_t>(raw) + 1023) &
                      ~static_cast<uintptr_t>(1023);
  return SpSmem<D>{reinterpret_cast<unsigned char*>(p)};
}

// Thread 0 initialises the mbarriers; the caller syncs the block.
template <int D>
__device__ __forceinline__ void sp_init(const SpSmem<D>& s) {
  if (threadIdx.x == 0) {
    mbar_init(s.q_full(), 1);
    mbar_init(s.q_empty(), 8);
    for (int i = 0; i < kWgStages; ++i) {
      mbar_init(s.k_full(i), 1);
      mbar_init(s.k_empty(i), 8);
      mbar_init(s.v_full(i), 1);
      mbar_init(s.v_empty(i), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

// Where the K/V stage ring stands; producer and consumers keep their own,
// and both advance once per KV tile of every item.
struct SpPipe {
  int stage = 0;
  uint32_t phase = 0;
  __device__ void next() {
    if (++stage == kWgStages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// The TMA views of one launch. q: (D, Hq, S, B), boxes (64, qh, qp, 1), so
// a tile's rows land in folded order. k, v: (D, Hkv, positions, rows,
// ranks), boxes (64, 1, kWgBN, 1, 1): at world 1 k and v themselves
// (rows = B, one rank); at world W both are the (D, Hkv, S_loc, 2 W B, W)
// view of every rank's workspace, K slot c of row b at row c B + b, V
// slot c at (W + c) B + b.
struct SpViews {
  CUtensorMap q, k, v;
};

// A bf16 item: (rank, b, h, head group, position tile).
struct WgItem {
  int me, b, h;
  int g0;               // first head of the tile within the KV head's G
  int p0;               // first query position, from the rank's first
};

// Item `it` of the static deal, longest first: rank W - 1's items first,
// within a rank the position tiles from the last, within a tile the head
// groups, then every (b, h). The world-1 deal is the same with W = 1.
// Item counts fit in 31 bits (make_params), so the deal's arithmetic is
// 32-bit: the producer warp runs it within its 40 registers.
__device__ __forceinline__ WgItem wg_item(const Params& p, int it) {
  const int bh_count = p.B * p.Hkv;
  const int per_rank = bh_count * p.n_qt;
  WgItem t;
  t.me = p.world - 1 - it / per_rank;
  int rem = it % per_rank;
  const int bh = rem % bh_count;
  rem /= bh_count;
  t.b = bh / p.Hkv;
  t.h = bh % p.Hkv;
  t.g0 = rem % p.n_hg * p.qh;
  t.p0 = (p.n_pt - 1 - rem / p.n_hg) * p.qp;
  return t;
}

// The static deal: a block takes turns c = first, first + grid, ... of
// [0, dealt_end) and at turn c the item snake(c). Round c / grid of the
// items (longest first) goes out in block order when even, reversed when
// odd, so a block that took one of the longer items of a round takes one
// of the shorter of the next. (On an H100 the W = 4 ring at 32k took 15.4
// ms so and 21.5 ms dealt in block order every round, though the blocks'
// tile counts differ by under 2 % either way; world 1 was unchanged.)
__device__ __forceinline__ int snake(int c) {
  const int g = gridDim.x;
  const int rd = c / g;
  return rd & 1 ? rd * g + g - 1 - c % g : c;
}

__device__ __forceinline__ int dealt_end(int items) {
  const int g = gridDim.x;
  return (items + g - 1) / g * g;
}

// Rank me's consumed ring steps are a prefix: 0..me under a causal mask
// (the test cur <= me on chunk cur = me - s), all W otherwise; step s
// carries chunk (me - s) mod W, and only step 0 the diagonal.
__device__ __forceinline__ int ring_steps(const Params& p, int me) {
  return p.causal ? me + 1 : p.world;
}

// KV tiles of a chunk that the item reads: all of them, or on the causal
// diagonal those up to its last query.
__device__ __forceinline__ int wg_kv_tiles(const Params& p, const WgItem& t,
                                           bool diag) {
  int end = p.s_loc;
  if (diag) end = min(end, t.p0 + p.qp);
  return (end + kWgBN - 1) / kWgBN;
}

__device__ __forceinline__ unsigned long long* piece_signal(const Params& p,
                                                            int rank,
                                                            int slot, int b,
                                                            int piece) {
  return tdt_rank_ptr(p.sig_base, p.sig_step * 8, rank) +
         (static_cast<long long>(slot) * p.B + b) * p.n_pieces + piece;
}

// The producer warp: for each of the block's items (its turns of the
// snake deal from `first`), the q tile once, then every K and V tile in
// the consumers' order.
// At world W its lanes first acquire the signals of the pieces a tile
// covers, and lane 0 orders those acquires before the TMA reads
// (fence.proxy.async: the pieces were written by generic stores).
template <int D>
__device__ __forceinline__ void sp_produce(const Params& p,
                                           const SpViews& v,
                                           const SpSmem<D>& sm,
                                           int first, int items) {
  using L = WgShape<D>;
  const int lane = threadIdx.x & 31;
  const int W = p.world;
  SpPipe pipe;
  uint32_t qphase = 0;
  for (int c = first; c < dealt_end(items); c += gridDim.x) {
    const int it = snake(c);
    if (it >= items) continue;
    const WgItem t = wg_item(p, it);
    if (lane == 0) {
      mbar_wait(sm.q_empty(), qphase ^ 1);
      mbar_expect(sm.q_full(), L::kBoxes * 128 * p.qh * p.qp);
      for (int x = 0; x < L::kBoxes; ++x)
        tma_load(sm.q() + x * L::kQBox, &v.q, sm.q_full(), x * 64,
                 t.h * p.G + t.g0, t.me * p.s_loc + t.p0, t.b);
    }
    qphase ^= 1;
    for (int s = 0; s < ring_steps(p, t.me); ++s) {
      const int cur = (t.me - s + W) % W;
      const int krow = W > 1 ? cur * p.B + t.b : t.b;
      const int vrow = W > 1 ? (W + cur) * p.B + t.b : t.b;
      const int n = wg_kv_tiles(p, t, p.causal && s == 0);
      for (int j = 0; j < n; ++j) {
        if (W > 1) {
          const int pc = j * (kWgBN / kPiece) + lane;
          if (lane < kWgBN / kPiece && pc < p.n_pieces) {
            const unsigned long long* sig =
                piece_signal(p, t.me, cur, t.b, pc);
            while (tdt_signal_acquire(sig) != p.epoch) __nanosleep(64);
          }
          __threadfence();
          __syncwarp();
        }
        if (lane == 0) {
          if (W > 1) fence_proxy_async();
          mbar_wait(sm.k_empty(pipe.stage), pipe.phase ^ 1);
          mbar_expect(sm.k_full(pipe.stage), L::kKv);
          for (int x = 0; x < L::kBoxes; ++x)
            tma_load5(sm.k(pipe.stage) + x * L::kKvBox, &v.k,
                      sm.k_full(pipe.stage), x * 64, t.h, j * kWgBN, krow,
                      t.me);
          mbar_wait(sm.v_empty(pipe.stage), pipe.phase ^ 1);
          mbar_expect(sm.v_full(pipe.stage), L::kKv);
          for (int x = 0; x < L::kBoxes; ++x)
            tma_load5(sm.v(pipe.stage) + x * L::kKvBox, &v.v,
                      sm.v_full(pipe.stage), x * 64, t.h, j * kWgBN, vrow,
                      t.me);
        }
        __syncwarp();
        pipe.next();
      }
    }
  }
}

#define SP_F8(d, i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),             \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// O (+)= P V for one 16-position step: P (64 x 16) from registers in
// wgmma's A fragments (mma.sync's A layout, a warp's 16 rows), V (16 x N)
// from shared memory read N-major (the transpose bit); N = D.
__device__ __forceinline__ void wgmma_pv(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : SP_F8(d, 0), SP_F8(d, 8), SP_F8(d, 16), SP_F8(d, 24), SP_F8(d, 32),
        SP_F8(d, 40), SP_F8(d, 48), SP_F8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : SP_F8(d, 0), SP_F8(d, 8), SP_F8(d, 16), SP_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

#undef SP_F8

// Keeps the registers of P live and in place until the wgmmas that read
// them have completed (the compiler does not see their asynchronous reads).
template <int N>
__device__ __forceinline__ void reg_fence_u(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The online-softmax state of a consumer thread's two rows r and r + 8 of
// its warp: O in wgmma's accumulator layout (for each 8-column group j,
// o[4j], o[4j + 1] at row r, columns 8j + 2 (lane % 4) and + 1; o[4j + 2],
// o[4j + 3] at row r + 8), the running max and sum of each row.
template <int D>
struct WgState {
  float o[D / 2];
  float m0, m1, l0, l1;
  float c0, c1;         // the last tile's correction of each row
};

// 2^x on the special-function unit, denormal results flushed to zero.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Folds the scores s (this tile's m64n128 accumulator, keys k0 + [0,
// kWgBN) of n_keys) into the state and leaves p = exp(s - m) in s. `diag`:
// the causal mask applies, the thread's rows at query positions qpos0 /
// qpos1 of the same origin as the keys, qmin the tile's first; otherwise
// only keys past n_keys are masked. O's correction is kept for
// wg_rescale_pack.
template <int D>
__device__ __forceinline__ void wg_softmax(WgState<D>& st, float (&s)[64],
                                           int k0, int n_keys, bool diag,
                                           int qpos0, int qpos1, int qmin,
                                           float scale) {
  constexpr int NF = kWgBN / 8;           // 8-column groups of a row
  const int tq = threadIdx.x & 3;
  // Only a tile that reaches past n_keys or past the tile's first query
  // position can hold a masked entry.
  const bool edge = k0 + kWgBN > n_keys || (diag && k0 + kWgBN - 1 > qmin);
  float mx0 = kNeg, mx1 = kNeg;
  if (edge) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + j * 8 + 2 * tq + (e & 1);
        const bool ok = kpos < n_keys &&
                        (!diag || kpos <= (e < 2 ? qpos0 : qpos1));
        s[4 * j + e] = ok ? s[4 * j + e] * scale : kNeg;
      }
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
  } else {
    // No mask: the row max of the raw scores, times the scale, is the max
    // of the scaled scores (rounding is monotonic, the scale positive).
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx0 *= scale;
    mx1 *= scale;
  }
  // A row's 128 columns lie in the four lanes of one quad.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(st.m0, mx0);
  const float mn1 = fmaxf(st.m1, mx1);
  const float c0 = expf(st.m0 - mn0);
  const float c1 = expf(st.m1 - mn1);
  // p = exp(s - m) as 2^(s log2 e - m log2 e): one FMA and one exp2.
  const float ml0 = mn0 * kLog2e;
  const float ml1 = mn1 * kLog2e;
  float sum0 = 0.f, sum1 = 0.f;
  // Unmasked scores take the scale in the same FMA: s scale log2 e.
  const float f = edge ? kLog2e : scale * kLog2e;
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    s[4 * j] = ex2(fmaf(s[4 * j], f, -ml0));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], f, -ml0));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], f, -ml1));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], f, -ml1));
    sum0 += s[4 * j] + s[4 * j + 1];
    sum1 += s[4 * j + 2] + s[4 * j + 3];
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
  st.c0 = c0;
  st.c1 = c1;
}

// O *= the last tile's correction, then p rounded to bf16 into wgmma's A
// fragments: the S accumulator's 8-column groups 2kk, 2kk + 1 are the
// fragments of 16-position step kk.
template <int D>
__device__ __forceinline__ void wg_rescale_pack(WgState<D>& st,
                                                const float (&s)[64],
                                                uint32_t (&pa)[kWgBN / 16][4]) {
  // Multiplying by 1 changes no bit: a warp whose rows all kept their max
  // skips it.
  if (!__all_sync(0xffffffffu, st.c0 == 1.f && st.c1 == 1.f))
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    st.o[4 * i] *= st.c0;
    st.o[4 * i + 1] *= st.c0;
    st.o[4 * i + 2] *= st.c1;
    st.o[4 * i + 3] *= st.c1;
  }
#pragma unroll
  for (int kk = 0; kk < kWgBN / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// out = O / max(l, 1e-20) for the thread's live rows: row r of the tile is
// position p0 + r / qh, head g0 + r % qh; rows past qp qh, past the rank's
// positions or past G are not stored.
template <int D>
__device__ __forceinline__ void wg_store(const Params& p, const WgItem& t,
                                         const WgState<D>& st, int r) {
  const int tq = threadIdx.x & 3;
  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int ri = r + half * 8;
    const int pos = t.p0 + ri / p.qh;
    const int g = t.g0 + ri % p.qh;
    if (ri >= p.qp * p.qh || pos >= p.s_loc || g >= p.G) continue;
    bf16* row = out + ((static_cast<long long>(t.b) * p.S +
                        static_cast<long long>(t.me) * p.s_loc + pos) *
                           p.Hq +
                       static_cast<long long>(t.h) * p.G + g) *
                          D;
    const float d = fmaxf(half ? st.l1 : st.l0, 1e-20f);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<__nv_bfloat162*>(row + i * 8 + 2 * tq) =
          __floats2bfloat162_rn(st.o[4 * i + 2 * half] / d,
                                st.o[4 * i + 2 * half + 1] / d);
  }
}

// S = Q K^T of one tile, issued as one wgmma group. Q and K K-major:
// 8-row groups 1024 bytes apart, a 16-deep step 32 bytes within the
// swizzled 128-byte row, the next 64 dims a box on.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t qa,
                                         uint32_t ka) {
  using L = WgShape<D>;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_m64n128k16<0>(
        s, wg_desc(qa + ks / 4 * L::kQBox + ks % 4 * 32, 16, 1024),
        wg_desc(ka + ks / 4 * L::kKvBox + ks % 4 * 32, 16, 1024), ks > 0);
  wg_commit();
}

// O += P V of one tile, issued as one wgmma group. V N-major: a
// 16-position step 2048 bytes on, the two 64-dim boxes (the N direction) a
// box apart, 8-position groups 1024 bytes apart.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[kWgBN / 16][4],
                                         uint32_t va) {
  using L = WgShape<D>;
#pragma unroll
  for (int kk = 0; kk < kWgBN / 16; ++kk)
    wgmma_pv(o, pa[kk], wg_desc(va + kk * 2048, L::kKvBox, 1024));
  wg_commit();
}

// Returns once at most one wgmma group of this warpgroup is in flight.
__device__ __forceinline__ void wg_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// Where an item's flat tile loop stands in its chunks: tile j of the n of
// the current chunk, on the causal diagonal or not.
struct KvWalk {
  int j, n;
  bool diag;
};

// S of the item's tile g (of `total`, in K stage `stage`) landed: free the
// K stage (and after the item's last tile the q tile), then the softmax.
template <int D>
__device__ __forceinline__ void scores_done(const Params& p, const WgItem& t,
                                            const SpSmem<D>& sm,
                                            WgState<D>& st, float (&s)[64],
                                            int stage, bool last, KvWalk& w,
                                            int qpos0, int qpos1) {
  reg_fence(s);
  if ((threadIdx.x & 31) == 0) {
    mbar_arrive(sm.k_empty(stage));
    if (last) mbar_arrive(sm.q_empty());
  }
  wg_softmax(st, s, w.j * kWgBN, p.s_loc, w.diag, qpos0, qpos1, t.p0,
             p.scale);
  if (++w.j == w.n) {                     // the next chunk: no diagonal
    w.j = 0;
    w.n = wg_kv_tiles(p, t, false);
    w.diag = false;
  }
}

// P V of the tile in V stage `stage` completed: free the stage.
template <int D>
__device__ __forceinline__ void pv_done(const SpSmem<D>& sm, WgState<D>& st,
                                        uint32_t (&pa)[kWgBN / 16][4],
                                        int stage) {
  reg_fence(st.o);
  reg_fence_u(pa);
  if ((threadIdx.x & 31) == 0) mbar_arrive(sm.v_empty(stage));
}

// The consumer warpgroups: for each of the block's items, in the
// producer's order, S = Q K^T on each tile (warpgroup wg: rows 64 wg ..),
// the softmax, O += P V, then the store. One flat loop walks the tiles of
// every consumed chunk (step 0's on the diagonal under a causal mask).
// Tile g's S = Q K^T is issued with tile g - 1's P V, before tile g's
// softmax, so the tensor cores run P V while the softmax runs (FA3's
// intra-warpgroup overlap; the bits are those of S, softmax, P V in turn).
template <int D>
__device__ __forceinline__ void sp_consume(const Params& p,
                                           const SpSmem<D>& sm,
                                           int first, int items) {
  const int tid = threadIdx.x - 128;      // consumer thread 0..255
  const int wg = tid >> 7;
  // This thread's rows r and r + 8 of the q tile.
  const int r = wg * 64 + ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2);
  const uint32_t qa = smem_addr(sm.q()) + wg * 64 * 128;
  SpPipe pipe;
  uint32_t qphase = 0;
  for (int c = first; c < dealt_end(items); c += gridDim.x) {
    const int it = snake(c);
    if (it >= items) continue;
    const WgItem t = wg_item(p, it);
    const int qpos0 = t.p0 + r / p.qh;
    const int qpos1 = t.p0 + (r + 8) / p.qh;
    WgState<D> st;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) st.o[i] = 0.f;
    st.m0 = st.m1 = kNeg;
    st.l0 = st.l1 = 0.f;
    KvWalk w{0, wg_kv_tiles(p, t, p.causal), p.causal != 0};
    const int total = w.n + (ring_steps(p, t.me) - 1) *
                                wg_kv_tiles(p, t, false);
    float s[64];
    uint32_t pa[kWgBN / 16][4];
    mbar_wait(sm.q_full(), qphase);
    qphase ^= 1;
    mbar_wait(sm.k_full(pipe.stage), pipe.phase);
    wg_fence();
    issue_qk<D>(s, qa, smem_addr(sm.k(pipe.stage)));
    wg_wait_all();
    scores_done(p, t, sm, st, s, pipe.stage, total == 1, w, qpos0, qpos1);
    wg_rescale_pack(st, s, pa);
    for (int g = 1; g < total; ++g) {
      const int prev = pipe.stage;
      const uint32_t prev_phase = pipe.phase;
      pipe.next();
      mbar_wait(sm.k_full(pipe.stage), pipe.phase);
      mbar_wait(sm.v_full(prev), prev_phase);
      reg_fence(st.o);
      wg_fence();
      issue_qk<D>(s, qa, smem_addr(sm.k(pipe.stage)));
      issue_pv<D>(st.o, pa, smem_addr(sm.v(prev)));
      wg_wait_one();                    // S of tile g
      scores_done(p, t, sm, st, s, pipe.stage, g == total - 1, w, qpos0,
                  qpos1);
      wg_wait_all();                    // P V of tile g - 1
      pv_done(sm, st, pa, prev);
      wg_rescale_pack(st, s, pa);
    }
    mbar_wait(sm.v_full(pipe.stage), pipe.phase);
    reg_fence(st.o);
    wg_fence();
    issue_pv<D>(st.o, pa, smem_addr(sm.v(pipe.stage)));
    wg_wait_all();
    pv_done(sm, st, pa, pipe.stage);
    pipe.next();
    wg_store(p, t, st, r);
  }
}

// The block's roles over its turns of the deal from `first`: warpgroup 0
// gives up registers (tiles.cuh's wg_producer_regs) and its warp 0
// produces; warpgroups 1 and 2 take them (wg_consumer_regs) and consume.
// The two branches never meet again.
template <int D>
__device__ __forceinline__ void sp_roles(const Params& p, const SpViews& v,
                                         const SpSmem<D>& sm, int first,
                                         int items) {
  if (threadIdx.x < 128) {
    wg_producer_regs();
    if (threadIdx.x < 32) sp_produce<D>(p, v, sm, first, items);
    return;
  }
  wg_consumer_regs();
  sp_consume<D>(p, sm, first, items);
}

// The world-1 kernel: a persistent grid over the items.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
sp_attention_wg(const Params p, const __grid_constant__ SpViews views) {
  extern __shared__ unsigned char smem_raw[];
  const SpSmem<D> sm = sp_smem<D>(smem_raw);
  sp_init(sm);
  __syncthreads();
  sp_roles<D>(p, views, sm, blockIdx.x, p.B * p.Hkv * p.n_qt);
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
__device__ __forceinline__ void fma_store(const Params& p, const QTile& t,
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

  const QTile t = tile_of_block(p);
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
  T* base = tdt_rank_ptr(static_cast<T*>(p.ws_base),
                         p.ws_step * static_cast<long long>(sizeof(T)), rank);
  return base + (static_cast<long long>(kv) * p.world + slot) * chunk;
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
  const long long pos = static_cast<long long>(piece) * kPiece;
  const long long n = min(static_cast<long long>(kPiece), p.s_loc - pos);
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

// f32: phase 2 item `it`, the (rank, row, KV head, q-tile) it names,
// longest first.
__device__ __forceinline__ QTile ring_tile(const Params& p, long long it,
                                          int* me) {
  const long long bh_count = static_cast<long long>(p.B) * p.Hkv;
  const long long per_rank = bh_count * p.n_qt;
  *me = p.world - 1 - static_cast<int>(it / per_rank);
  const long long rem = it % per_rank;
  const long long qt = p.n_qt - 1 - rem / bh_count;
  const int bh = static_cast<int>(rem % bh_count);
  QTile t;
  t.b = bh / p.Hkv;
  t.h = bh % p.Hkv;
  t.rows = static_cast<long long>(p.s_loc) * p.G;
  t.r0 = qt * kBM;
  t.pos0 = static_cast<long long>(*me) * p.s_loc;
  return t;
}

// f32: the calling block waits until the first n pieces (one a 64-wide
// tile: kPiece == kBN) of row b's chunk in
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
  const QTile t = ring_tile(p, it, &me);
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

// f32: the ring kernel, a block of four warps an item.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
sp_ring_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long copies = static_cast<long long>(p.world) * p.world * p.B *
                           p.n_pieces;
  const long long tiles = static_cast<long long>(p.world) * p.B * p.Hkv *
                          p.n_qt;
  for (long long it = blockIdx.x; it < copies + tiles; it += gridDim.x) {
    if (it < copies)
      ring_copy_item<float, D>(p, it);
    else
      ring_compute_fma<D>(p, it - copies, smem_raw);
  }
}

// bf16: the ring kernel. Every thread of the block runs its copy items
// (phases 0 and 1, which come first in its order); then the block's roles
// take its compute items, as in the world-1 kernel.
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
sp_ring_wg_kernel(const Params p, const __grid_constant__ SpViews views) {
  extern __shared__ unsigned char smem_raw[];
  const SpSmem<D> sm = sp_smem<D>(smem_raw);
  sp_init(sm);
  __syncthreads();
  const int copies = p.world * p.world * p.B * p.n_pieces;
  int it = blockIdx.x;
  for (; it < copies; it += gridDim.x) ring_copy_item<bf16, D>(p, it);
  sp_roles<D>(p, views, sm, it - copies, p.world * p.B * p.Hkv * p.n_qt);
}

// As many blocks of `kernel` as the card keeps resident (its occupancy on
// every SM with `threads` threads and `smem` bytes), at most `items`.
template <typename Kernel>
cudaError_t resident_grid(Kernel kernel, int threads, int smem,
                          long long items, long long* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // The attribute belongs to the current device: set it on every launch
  // (it is cheap) so a second card is configured too.
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  *grid = static_cast<long long>(sms) * per_sm;
  if (items < *grid) *grid = items;
  return *grid < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// f32, world 1: one block an item.
template <int D>
cudaError_t launch_fma(const Params& p, long long blocks,
                       cudaStream_t stream) {
  auto kernel = sp_attention_fma<D>;
  const int smem = fma_smem_bytes<D>();
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The TMA views of a bf16 launch (SpViews): q always; k and v themselves
// at world 1, else every rank's workspace.
cudaError_t make_views(SpViews* v, const Params& p, int D) {
  const long long hq = p.Hq, hkv = p.Hkv, S = p.S, B = p.B;
  cudaError_t err = make_box_view<4>(&v->q, p.q, {D, hq, S, B},
                                     {D, hq * D, S * hq * D},
                                     {64, p.qh, p.qp, 1});
  if (err != cudaSuccess) return err;
  const int box[5] = {64, 1, kWgBN, 1, 1};
  if (p.world == 1) {
    const long long dim[5] = {D, hkv, S, B, 1};
    const long long step[4] = {D, hkv * D, S * hkv * D, B * S * hkv * D};
    err = make_box_view<5>(&v->k, p.k, dim, step, box);
    if (err == cudaSuccess) err = make_box_view<5>(&v->v, p.v, dim, step, box);
    return err;
  }
  const long long sl = p.s_loc;
  const long long dim[5] = {D, hkv, sl, 2LL * p.world * B, p.world};
  const long long step[4] = {D, hkv * D, sl * hkv * D, p.ws_step};
  err = make_box_view<5>(&v->k, p.ws_base, dim, step, box);
  v->v = v->k;
  return err;
}

// bf16: the kernel (world 1 or the ring) on a grid of resident blocks.
template <int D>
cudaError_t launch_wg(Params p, cudaStream_t stream) {
  SpViews v;
  cudaError_t err = make_views(&v, p, D);
  if (err != cudaSuccess) return err;
  const int smem = WgShape<D>::kSmem;
  const long long tiles = static_cast<long long>(p.world) * p.B * p.Hkv *
                          p.n_qt;
  long long grid = 0;
  if (p.world == 1) {
    auto kernel = sp_attention_wg<D>;
    err = resident_grid(kernel, kWgThreads, smem, tiles, &grid);
    if (err != cudaSuccess) return err;
    kernel<<<static_cast<unsigned>(grid), kWgThreads, smem, stream>>>(p, v);
    return cudaGetLastError();
  }
  auto kernel = sp_ring_wg_kernel<D>;
  const long long copies = static_cast<long long>(p.world) * p.world * p.B *
                           p.n_pieces;
  err = resident_grid(kernel, kWgThreads, smem, copies + tiles, &grid);
  if (err != cudaSuccess) return err;
  void* args[] = {&p, &v};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(static_cast<unsigned>(grid)),
                                    dim3(kWgThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// f32: one cooperative launch of the ring kernel on resident blocks.
template <int D>
cudaError_t launch_ring_fma(Params p, cudaStream_t stream) {
  auto kernel = sp_ring_kernel<D>;
  const long long items =
      static_cast<long long>(p.world) * p.world * p.B * p.n_pieces +
      static_cast<long long>(p.world) * p.B * p.Hkv * p.n_qt;
  long long grid = 0;
  cudaError_t err = resident_grid(kernel, kThreads, fma_smem_bytes<D>(),
                                  items, &grid);
  if (err != cudaSuccess) return err;
  void* args[] = {&p};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(static_cast<unsigned>(grid)),
                                    dim3(kThreads), args,
                                    fma_smem_bytes<D>(), stream);
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

// The parameters of a launch over `world` ranks of S / world positions;
// false when a count passes 32 bits.
bool make_params(Params* p, const void* q, const void* k, const void* v,
                 void* out, int B, int S, int Hq, int Hkv, int causal,
                 int dtype, float scale, int world) {
  *p = Params{};
  p->q = q;
  p->k = k;
  p->v = v;
  p->out = out;
  p->B = B;
  p->S = S;
  p->Hq = Hq;
  p->Hkv = Hkv;
  p->G = Hq / Hkv;
  p->causal = causal != 0;
  p->scale = scale;
  p->world = world;
  p->s_loc = S / world;
  p->n_pieces = (p->s_loc + kPiece - 1) / kPiece;
  long long n_qt;
  if (dtype == 0) {
    p->qh = p->G < kWgRows ? p->G : kWgRows;
    p->qp = kWgRows / p->qh;
    p->n_hg = (p->G + p->qh - 1) / p->qh;
    p->n_pt = (p->s_loc + p->qp - 1) / p->qp;
    n_qt = static_cast<long long>(p->n_pt) * p->n_hg;
  } else {
    n_qt = (static_cast<long long>(p->s_loc) * p->G + kBM - 1) / kBM;
  }
  p->n_qt = static_cast<int>(n_qt);
  // Every count of items, and a deal's turns past them, fits in 31 bits.
  constexpr long long kMax = 1LL << 30;
  return n_qt <= kMax && n_qt * B * Hkv * world <= kMax &&
         static_cast<long long>(world) * world * B * p->n_pieces <= kMax;
}

}  // namespace

extern "C" {

// out = attention(q, k, v) as described above. dtype: 0 bf16, 1 f32 (q,
// k, v and out alike); D: 64 or 128; causal: 0 or 1. Pointers must be
// 16-byte aligned. Returns a cudaError_t.
int tdt_sp_attention(const void* q, const void* k, const void* v, void* out,
                     int B, int S, int Hq, int Hkv, int D, int causal,
                     int dtype, float scale, void* stream) {
  Params p;
  if (!valid_common(q, k, v, out, B, S, Hq, Hkv, D, dtype) ||
      !make_params(&p, q, k, v, out, B, S, Hq, Hkv, causal, dtype, scale,
                   1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = D == 64 ? launch_wg<64>(p, s) : launch_wg<128>(p, s);
  } else {
    const long long blocks = static_cast<long long>(p.n_qt) * B * Hkv;
    err = D == 64 ? launch_fma<64>(p, blocks, s)
                  : launch_fma<128>(p, blocks, s);
  }
  return static_cast<int>(err);
}

// The world-W prefill: q, k, v and out (B, S, Hq / Hkv, D) global, S split
// over `world` ranks; ws_base / ws_step: rank 0's workspace and the
// elements from one rank's to the next (2 W B (S / W) Hkv D elements
// each, K slots then V slots; 16-byte aligned, ws_step a multiple of 8:
// bf16 reads them all through one TMA view); sig_base / sig_step: the
// same for the signals (W B ceil(S / W / 64) words each). `epoch` must
// differ from every earlier call's on these buffers; `fault` plants the
// test fault (rank 0's first forward of row 0's first piece skipped, its
// signal still set). Returns a cudaError_t.
int tdt_sp_ring_attention(const void* q, const void* k, const void* v,
                          void* out, void* ws_base, long long ws_step,
                          unsigned long long* sig_base, long long sig_step,
                          int world, int B, int S, int Hq, int Hkv, int D,
                          int causal, int dtype, float scale,
                          unsigned long long epoch, int fault,
                          void* stream) {
  Params p;
  if (!valid_common(q, k, v, out, B, S, Hq, Hkv, D, dtype) || world < 2 ||
      S % world != 0 || epoch == 0 ||
      !make_params(&p, q, k, v, out, B, S, Hq, Hkv, causal, dtype, scale,
                   world) ||
      ws_base == nullptr || !aligned16(ws_base) || ws_step % 8 != 0 ||
      ws_step < 2LL * world * B * p.s_loc * Hkv * D || sig_base == nullptr ||
      sig_step < static_cast<long long>(world) * B * p.n_pieces)
    return static_cast<int>(cudaErrorInvalidValue);
  p.ws_base = ws_base;
  p.ws_step = ws_step;
  p.sig_base = sig_base;
  p.sig_step = sig_step;
  p.epoch = epoch;
  p.fault = fault;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = D == 64 ? launch_wg<64>(p, s) : launch_wg<128>(p, s);
  else
    err = D == 64 ? launch_ring_fma<64>(p, s) : launch_ring_fma<128>(p, s);
  return static_cast<int>(err);
}

// The runtime's message for an error code returned above.
const char* tdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
