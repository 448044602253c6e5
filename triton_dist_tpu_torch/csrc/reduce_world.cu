// The world-W reduce-scatter and all-reduce for Hopper (sm_90a): every rank
// of one card in one cooperative launch.
//
// Replaces, at world W > 1 (allgather.cu's copy runs their world = 1
// bodies):
//  * triton_dist_tpu/ops/reduce_scatter.py::_one_shot_rs_kernel (:150) and
//    triton_dist_tpu/ops/allreduce.py::_one_shot_ar_kernel (:114), one
//    body: push-then-sum. Rank r writes its contribution for peer p into
//    p's stage slot [r] in JAX's order p = r + q, q = 1..W-1 (the peer's
//    row chunk for the reduce-scatter, the whole (M, N) partial for the
//    all-reduce), then waits for its W - 1 sources and sums the W slots in
//    rank order 0..W-1 (:143-146, :182-185), reading its own contribution
//    from its input (JAX's stage_ref[me] holds the same bytes), so stage
//    slot [r] of rank r stays as the workspace was made: NaN;
//  * reduce_scatter.py::_ring_rs_kernel (:92), and the first half of
//    allreduce.py::_two_shot_ar_kernel (:193, :209-232): the ring. At step
//    s = 0..W-2 rank r forwards chunk c = r - s - 1 (mod W), its own rows
//    at s = 0, else rnd(recv[s - 1] + x_r[c]), into its right neighbour's
//    receive slot s; its final chunk r is rnd(recv[W - 2] + x_r[r]).
//    Receive slots and signals are per step, never reused within a call
//    (JAX's docstring :101-105 says why);
//  * the second half of _two_shot_ar_kernel (:234-247): a ring all-gather
//    of the reduced chunks, the order of allgather.cu's ring body (B8): at
//    step s rank r forwards chunk r - s of its output into the same slot of
//    its right neighbour's, step 0 by the block that reduced the chunk;
//  * allreduce.py::_recursive_doubling_ar_kernel (:158): log2 W rounds;
//    round j exchanges the running partial with partner r ^ 2^j through
//    receive slot j, then o = rnd(o + recv) (:187). Both partners add the
//    same two values, so their copies agree bit for bit.
//
// Rounding: JAX adds in the input's dtype and rounds after every add. Here
// every add is an f32 add of the two values rounded to the dtype
// (`add_rn`): for bf16 that is the bf16 add XLA computes on the CPU, so the
// kernel is bit-equal to ops/allreduce.py's and ops/reduce_scatter.py's
// plain versions, which round at the same points in the same order.
//
// Ranks are W slices of one card (runtime/dist.py): rank r's partial is
// x[r] of one global (W, M, N) tensor. Its output, its workspace row and
// its signal row are rank r's shards of three tensors, each reached from
// rank 0's address and the bytes between two ranks' shards (shmem.cuh's
// tdt_rank_ptr), as a Pallas kernel reaches a peer by device id: a call
// takes them by value and queues this one kernel and nothing else. A
// reduce-scatter's output shard r is chunk r of one (M, N) tensor; an
// all-reduce's is rank r's (M, N) copy.
//
// What bounds it (H100 SXM: 3.35 TB/s): bytes. An all-reduce reads the W
// partials once and writes W copies, 2 W M N itemsize bytes (W = 4, bf16:
// 0.00008 ms at decode (4, 4096), 0.0100 ms at prefill (512, 4096)); a
// reduce-scatter reads the partials and writes the (M, N) result, (W + 1)
// M N itemsize (0.0063 ms at prefill). The pushes move (W - 1) M N more
// bytes (one-shot all-reduce: (W - 1) W M N), written once and read once,
// which the bound does not count. At decode a call is latency: the launch
// and its dependent hops (one for the one-shots, log2 W for the doubling,
// W - 1 for the ring, 2 W - 2 for the two-shot), each a release store
// seen by an acquire load and one round of loads.
//
// The design:
//  * the unit of a call (the chunk, M N / W elements, or the whole
//    partial) is cut into pieces of at most 4 KiB (kPieceBytes), fewer
//    and larger when the call's blocks would not all be resident at once
//    (the plan, `plan_of`: tdt_reduce_world_grid returns it); a piece has
//    one 64-bit signal a hop, stamped with the call's epoch (never reset:
//    a wait compares for equality);
//  * one block for every piece of every rank, all resident together (the
//    cooperative launch: a grid the card cannot hold is never launched).
//    The block owns its (rank, piece) for the whole call and walks its
//    dependent steps, wait → add → push (the one-shots: its W - 1 pushes,
//    then its sum), so a hop never waits for a block to be dealt, and
//    every block of the grid takes part in every phase;
//  * a block moves its piece in 16-byte vectors, neighbouring threads on
//    neighbouring addresses, with the loads of kGroup sources of kBatch
//    vectors each in flight a thread before their adds and stores, when
//    every end is 16-byte aligned, else element by element;
//  * a push ends in __syncthreads, then thread 0's release store of the
//    piece's signal (st.release.gpu): the barrier orders the block's
//    stores before it, and the release is cumulative over them; a wait is
//    thread 0's acquire load loop (ld.acquire.gpu, no sleep for its first
//    kSpins polls), then __syncthreads, which orders the block's later
//    loads after the acquire. No __threadfence beside either: without
//    them the planted fault, the canaries and a 300-call repeat loop of
//    every W = 4 case stayed clean, and every row got faster (PERF.md);
//  * no atomics: every sum has one fixed order.
// `straggler` (JAX's straggler_option): every first push of that rank
// spins about `straggle_cycles` clock cycles before it stores; no value
// changes. `fault` (a test hook): rank 0's first push of piece 0 skips its
// stores and still releases its signal, so a NaN-filled workspace shows in
// the output.
//
// Plain C entry points, loaded with ctypes. A call runs on the stream it is
// given, allocates nothing and returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "shmem.cuh"

namespace {

constexpr int kThreads = 256;
// 16-byte loads of each source, and sources, a thread has in flight before
// their adds: 2 and 4 ran faster than one source at a time (PERF.md).
constexpr int kBatch = 2;
constexpr int kGroup = 4;
// Blocks an SM holds at least: 4 caps a thread at 64 registers (without a
// bound ptxas gave the body 125, two blocks an SM).
constexpr int kMinBlocks = 4;
// Bytes of the largest piece the plan prefers: 16 KiB pieces ran slower
// (PERF.md).
constexpr long long kPieceBytes = 4096;
// Polls of a wait before each further one sleeps.
constexpr int kSpins = 64;

// Kinds of a call: the op and its method.
constexpr int kRsOneShot = 0;
constexpr int kRsRing = 1;
constexpr int kArOneShot = 2;
constexpr int kArTwoShot = 3;
constexpr int kArDoubling = 4;

typedef unsigned long long u64;

struct Args {
  const unsigned char* x;    // (W, elems) partials
  unsigned char* out;        // rank 0's output (its chunk, or its copy)
  unsigned char* ws;         // rank 0's stage / receive slots
  unsigned char* sig;        // rank 0's signal row
  long long out_step, ws_step, sig_step;  // bytes from rank r's to r + 1's
  long long elems;           // elements of one partial, M N
  long long unit;            // elements a piece cuts: a chunk or a partial
  long long piece;           // elements of one piece (the last may be short)
  long long pieces;          // pieces of one unit
  long long straggle_cycles;
  u64 epoch;
  int world, kind, rounds, straggler, fault;
};

__host__ __device__ inline int rounds_of(int world) {
  int l = 0;
  while ((1 << l) < world) ++l;
  return l;
}

__device__ inline bool one_shot(int kind) {
  return kind == kRsOneShot || kind == kArOneShot;
}

inline long long unit_of(int kind, int world, long long elems) {
  return (kind == kArOneShot || kind == kArDoubling) ? elems : elems / world;
}

// 64-bit signals in each rank's row.
long long signal_count(int kind, int world, long long pieces) {
  const long long w = world;
  if (kind == kRsRing) return (w - 1) * pieces;
  if (kind == kArTwoShot) return (2 * w - 1) * pieces;
  if (kind == kArDoubling) return rounds_of(world) * pieces;
  return w * pieces;                    // one-shot: a stage slot a source
}

// Workspace elements in each rank's row.
long long workspace_count(int kind, int world, long long unit) {
  const long long w = world;
  if (kind == kRsRing || kind == kArTwoShot) return (w - 1) * unit;
  if (kind == kArDoubling) return rounds_of(world) * unit;
  return w * unit;                      // one-shot
}

// bf16 travels as its bits (unsigned short); every add is in f32, rounded.
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(unsigned short v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ unsigned short from_f<unsigned short>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
template <typename T>
__device__ __forceinline__ T add_rn(T a, T b) {
  return from_f<T>(__fadd_rn(to_f(a), to_f(b)));
}

// The element-wise add_rn of two 16-byte vectors of T.
template <typename T>
__device__ __forceinline__ uint4 add_vec(uint4 a, uint4 b) {
  constexpr int V = 16 / sizeof(T);
  T* pa = reinterpret_cast<T*>(&a);
  const T* pb = reinterpret_cast<const T*>(&b);
#pragma unroll
  for (int e = 0; e < V; ++e) pa[e] = add_rn(pa[e], pb[e]);
  return a;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The calling block moves n elements. kSum: every destination d < n_dst
// gets dst(d)[i] = src(0)[i] + src(1)[i] + ... + src(n_src - 1)[i], added
// left to right, each add rounded; else (n_dst == n_src) dst(k)[i] =
// src(k)[i]. A null destination (a skipped push) is not written. Each
// thread has the loads of kGroup sources of kBatch vectors each in flight
// before their adds or stores.
template <typename T, bool kSum, typename Dst, typename Src>
__device__ __forceinline__ void move(Dst dst, int n_dst, Src src, int n_src,
                                     long long n) {
  constexpr int V = 16 / sizeof(T);
  bool vec = true;
  for (int d = 0; d < n_dst; ++d) vec = vec && aligned16(dst(d));
  for (int q = 0; q < n_src; ++q) vec = vec && aligned16(src(q));
  long long done = 0;
  if (vec) {
    const long long nv = n / V;
    const long long nt = blockDim.x;
    for (long long i0 = threadIdx.x; i0 < nv; i0 += kBatch * nt) {
      uint4 acc[kBatch];
      for (int q0 = 0; q0 < n_src; q0 += kGroup) {
        uint4 v[kGroup][kBatch];
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          if (q0 + g >= n_src) break;
          const uint4* s = reinterpret_cast<const uint4*>(src(q0 + g));
#pragma unroll
          for (int b = 0; b < kBatch; ++b)
            if (i0 + b * nt < nv) v[g][b] = s[i0 + b * nt];
        }
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          if (q0 + g >= n_src) break;
          if (kSum) {
#pragma unroll
            for (int b = 0; b < kBatch; ++b)
              if (i0 + b * nt < nv)
                acc[b] = q0 + g == 0 ? v[g][b] : add_vec<T>(acc[b], v[g][b]);
          } else if (uint4* o = reinterpret_cast<uint4*>(dst(q0 + g))) {
#pragma unroll
            for (int b = 0; b < kBatch; ++b)
              if (i0 + b * nt < nv) o[i0 + b * nt] = v[g][b];
          }
        }
      }
      if (!kSum) continue;
      for (int d = 0; d < n_dst; ++d) {
        uint4* o = reinterpret_cast<uint4*>(dst(d));
        if (o == nullptr) continue;
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
          if (i0 + b * nt < nv) o[i0 + b * nt] = acc[b];
      }
    }
    done = nv * V;
  }
  for (long long i = done + threadIdx.x; i < n; i += blockDim.x) {
    if (!kSum) {
      for (int k = 0; k < n_src; ++k)
        if (T* o = dst(k)) o[i] = src(k)[i];
      continue;
    }
    T acc = src(0)[i];
    for (int q = 1; q < n_src; ++q) acc = add_rn(acc, src(q)[i]);
    for (int d = 0; d < n_dst; ++d)
      if (T* o = dst(d)) o[i] = acc;
  }
}

// The sum (or copy) of n_src sources into one destination.
template <typename T, typename Src>
__device__ __forceinline__ void sum_into(T* dst, Src src, int n_src,
                                         long long n) {
  move<T, true>([=](int) { return dst; }, 1, src, n_src, n);
}

template <typename T>
__device__ __forceinline__ T* out_of(const Args& a, int r) {
  return tdt_rank_ptr(reinterpret_cast<T*>(a.out), a.out_step, r);
}
template <typename T>
__device__ __forceinline__ T* ws_of(const Args& a, int r) {
  return tdt_rank_ptr(reinterpret_cast<T*>(a.ws), a.ws_step, r);
}
__device__ __forceinline__ u64* sig_of(const Args& a, int r) {
  return tdt_rank_ptr(reinterpret_cast<u64*>(a.sig), a.sig_step, r);
}
template <typename T>
__device__ __forceinline__ const T* x_of(const Args& a, int r) {
  return reinterpret_cast<const T*>(a.x) + r * a.elems;
}

// The calling thread's release store of `epoch` into `sig`, after a
// __syncthreads that follows the block's stores.
__device__ __forceinline__ void signal(u64* sig, u64 epoch) {
  tdt_signal_release(sig, epoch);
}

// The block's stores are done; thread 0 releases `sig`.
__device__ __forceinline__ void release(u64* sig, u64 epoch) {
  __syncthreads();
  if (threadIdx.x == 0) signal(sig, epoch);
}

// The calling thread polls `sig` until it holds `epoch` (acquire loads),
// sleeping between polls only after kSpins of them.
__device__ __forceinline__ void spin(const u64* sig, u64 epoch) {
  for (int k = 0; tdt_signal_acquire(sig) != epoch; ++k)
    if (k >= kSpins) __nanosleep(64);
}

// Thread 0 waits for `sig`; the block goes on only then.
__device__ __forceinline__ void wait(const u64* sig, u64 epoch) {
  if (threadIdx.x == 0) spin(sig, epoch);
  __syncthreads();
}

// A first push of the straggling rank spins before it stores.
__device__ __forceinline__ void straggle(const Args& a, int me) {
  if (me != a.straggler || a.straggle_cycles <= 0) return;
  if (threadIdx.x == 0) {
    const long long t0 = clock64();
    while (clock64() - t0 < a.straggle_cycles) {
    }
  }
  __syncthreads();
}

__device__ __forceinline__ long long piece_len(const Args& a, long long p) {
  const long long left = a.unit - p * a.piece;
  return left < a.piece ? left : a.piece;
}

// -- push-then-sum (both one-shots) -----------------------------------------
// Offset of rank `peer`'s contribution in a partial: its row chunk for the
// reduce-scatter, the whole partial for the all-reduce.
__device__ __forceinline__ long long contribution(const Args& a, int peer) {
  return a.kind == kRsOneShot ? peer * a.unit : 0;
}

// The owner of rank me's piece p: its contributions for its peers me + q,
// q = 1..W-1 (JAX's order), into their stage slots [me], one release
// each; then its W - 1 sources' signals, and the W slots summed in rank
// order.
template <typename T>
__device__ void one_shot_owner(const Args& a, int me, long long p) {
  const int W = a.world;
  const long long e0 = p * a.piece;
  const long long n = piece_len(a, p);
  const bool skip = a.fault && me == 0 && p == 0;    // the push to me + 1
  straggle(a, me);
  auto stage = [=](int k) -> T* {
    return skip && k == 0 ? nullptr
                          : ws_of<T>(a, (me + 1 + k) % W) + me * a.unit + e0;
  };
  const T* x = x_of<T>(a, me) + e0;
  if (a.kind == kArOneShot) {            // one partial, W - 1 destinations
    move<T, true>(stage, W - 1, [=](int) { return x; }, 1, n);
  } else {                               // the peer's row chunk to each
    move<T, false>(stage, W - 1, [=](int k) {
      return x + ((me + 1 + k) % W) * a.unit;
    }, W - 1, n);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < W - 1; k += blockDim.x)
    signal(sig_of(a, (me + 1 + k) % W) + me * a.pieces + p, a.epoch);
  const u64* sig = sig_of(a, me);
  for (int q = 1 + threadIdx.x; q < W; q += blockDim.x)
    spin(sig + static_cast<long long>((me - q + W) % W) * a.pieces + p,
         a.epoch);
  __syncthreads();
  const T* own = x + contribution(a, me);
  const T* slots = ws_of<T>(a, me) + e0;
  sum_into<T>(out_of<T>(a, me) + e0,
              [=](int r) { return r == me ? own : slots + r * a.unit; }, W,
              n);
}

// -- the ring reduce-scatter, and the two-shot ------------------------------
// The owner of rank me's piece p: W - 1 ring steps, its final chunk, and
// for the two-shot the W - 2 forwards of the all-gather.
template <typename T>
__device__ void ring_owner(const Args& a, int me, long long p) {
  const int W = a.world;
  const int right = (me + 1) % W;
  const long long e0 = p * a.piece;
  const long long n = piece_len(a, p);
  const u64* mine = sig_of(a, me);
  u64* theirs = sig_of(a, right);
  straggle(a, me);
  // Step s: chunk me - s - 1, rnd(recv[s - 1] + x_me[c]) (own rows at s =
  // 0), into the right neighbour's receive slot s.
  for (int s = 0; s < W - 1; ++s) {
    const int c = ((me - s - 1) % W + W) % W;
    const T* xs = x_of<T>(a, me) + c * a.unit + e0;
    const T* got = s > 0 ? ws_of<T>(a, me) + (s - 1) * a.unit + e0 : xs;
    if (s > 0) wait(mine + (s - 1) * a.pieces + p, a.epoch);
    const bool skip = a.fault && me == 0 && s == 0 && p == 0;
    sum_into<T>(skip ? nullptr : ws_of<T>(a, right) + s * a.unit + e0,
                [=](int q) { return q == 0 ? got : xs; }, s > 0 ? 2 : 1, n);
    release(theirs + s * a.pieces + p, a.epoch);
  }
  // Chunk me: rnd(recv[W - 2] + x_me[me]).
  wait(mine + (W - 2) * a.pieces + p, a.epoch);
  const T* xs = x_of<T>(a, me) + me * a.unit + e0;
  const T* got = ws_of<T>(a, me) + (W - 2) * a.unit + e0;
  auto src = [=](int q) { return q == 0 ? got : xs; };
  if (a.kind == kRsRing) {
    sum_into<T>(out_of<T>(a, me) + e0, src, 2, n);
    return;
  }
  // The two-shot: into its own output and, all-gather step 0, into its
  // right neighbour's.
  T* own = out_of<T>(a, me) + me * a.unit + e0;
  T* next = out_of<T>(a, right) + me * a.unit + e0;
  move<T, true>([=](int d) { return d == 0 ? own : next; }, 2, src, 2, n);
  release(theirs + (W - 1 + me) * a.pieces + p, a.epoch);
  // All-gather step s >= 1: chunk me - s, once it has arrived, into the
  // right neighbour's output.
  for (int s = 1; s < W - 1; ++s) {
    const int c = ((me - s) % W + W) % W;
    const long long slot = (W - 1 + c) * a.pieces + p;
    wait(mine + slot, a.epoch);
    const long long at = c * a.unit + e0;
    const T* from = out_of<T>(a, me) + at;
    sum_into<T>(out_of<T>(a, right) + at, [=](int) { return from; }, 1, n);
    release(theirs + slot, a.epoch);
  }
}

// -- recursive doubling -----------------------------------------------------
// The owner of rank me's piece p: round j pushes its running partial (its
// input at j = 0, then its output) into partner me ^ 2^j's receive slot j,
// waits for the partner's push into its own, then o = rnd(o + recv).
template <typename T>
__device__ void doubling_owner(const Args& a, int me, long long p) {
  const long long e0 = p * a.piece;
  const long long n = piece_len(a, p);
  straggle(a, me);
  for (int j = 0; j < a.rounds; ++j) {
    const int partner = me ^ (1 << j);
    const T* cur = (j == 0 ? x_of<T>(a, me) : out_of<T>(a, me)) + e0;
    // Round j - 1's add is every thread's: a push that takes the other
    // path (vectors or elements) reads what other threads wrote.
    if (j > 0) __syncthreads();
    const bool skip = a.fault && me == 0 && j == 0 && p == 0;
    sum_into<T>(skip ? nullptr : ws_of<T>(a, partner) + j * a.unit + e0,
                [=](int) { return cur; }, 1, n);
    release(sig_of(a, partner) + j * a.pieces + p, a.epoch);
    wait(sig_of(a, me) + j * a.pieces + p, a.epoch);
    const T* got = ws_of<T>(a, me) + j * a.unit + e0;
    sum_into<T>(out_of<T>(a, me) + e0,
                [=](int q) { return q == 0 ? cur : got; }, 2, n);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks) reduce_world(Args a) {
  const int me = static_cast<int>(blockIdx.x / a.pieces);
  const long long p = blockIdx.x % a.pieces;
  if (a.kind == kArDoubling) {
    doubling_owner<T>(a, me, p);
  } else if (one_shot(a.kind)) {
    one_shot_owner<T>(a, me, p);
  } else {
    ring_owner<T>(a, me, p);
  }
}

// Blocks of one instantiation the card keeps resident at once.
template <typename T>
cudaError_t resident(int* out) {
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
          &per_sm, reduce_world<T>, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    cached = sms * per_sm;
  }
  *out = cached;
  return cudaSuccess;
}

bool kind_ok(int kind, int world, long long elems) {
  if (world < 2 || elems < 1 || kind < kRsOneShot || kind > kArDoubling)
    return false;
  if ((kind == kRsOneShot || kind == kRsRing || kind == kArTwoShot) &&
      elems % world != 0)
    return false;
  return kind != kArDoubling || (world & (world - 1)) == 0;
}

// The launch plan of a call: pieces of at most kPieceBytes, fewer and
// larger while the blocks they need exceed what is resident.
struct Plan {
  long long piece, pieces;
  int grid, resident;
};

cudaError_t plan_of(int kind, int world, long long elems, int dtype,
                    Plan* plan) {
  int res = 0;
  const cudaError_t err =
      dtype == 0 ? resident<unsigned short>(&res) : resident<float>(&res);
  if (err != cudaSuccess) return err;
  const long long budget = res / world;   // pieces a rank can own
  if (budget < 1) return cudaErrorCooperativeLaunchTooLarge;
  const long long itemsize = dtype == 0 ? 2 : 4;
  const long long v = 16 / itemsize;
  const long long unit = unit_of(kind, world, elems);
  const long long grain = kPieceBytes / itemsize;
  long long pieces = (unit + grain - 1) / grain;
  if (pieces > budget) pieces = budget;
  long long piece = (unit + pieces - 1) / pieces;
  piece = (piece + v - 1) / v * v;        // 16-byte piece offsets
  plan->piece = piece;
  plan->pieces = (unit + piece - 1) / piece;
  plan->grid = static_cast<int>(world * plan->pieces);
  plan->resident = res;
  return cudaSuccess;
}

int launch(const void* x, void* out, long long out_step, void* ws,
           long long ws_step, void* sig, long long sig_step, long long elems,
           int world, int kind, int dtype, int straggler,
           long long straggle_cycles, unsigned long long epoch, int fault,
           void* stream) {
  if (x == nullptr || out == nullptr || ws == nullptr || sig == nullptr ||
      !kind_ok(kind, world, elems) || dtype < 0 || dtype > 1 ||
      straggler < -1 || straggler >= world || straggle_cycles < 0 ||
      epoch == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan;
  cudaError_t err = plan_of(kind, world, elems, dtype, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.x = static_cast<const unsigned char*>(x);
  a.out = static_cast<unsigned char*>(out);
  a.ws = static_cast<unsigned char*>(ws);
  a.sig = static_cast<unsigned char*>(sig);
  a.out_step = out_step;
  a.ws_step = ws_step;
  a.sig_step = sig_step;
  a.elems = elems;
  a.unit = unit_of(kind, world, elems);
  a.piece = plan.piece;
  a.pieces = plan.pieces;
  a.straggle_cycles = straggle_cycles;
  a.epoch = epoch;
  a.world = world;
  a.kind = kind;
  a.rounds = rounds_of(world);
  a.straggler = straggler;
  a.fault = fault;
  void* params[] = {&a};
  const void* fn = dtype == 0
                       ? reinterpret_cast<const void*>(
                             reduce_world<unsigned short>)
                       : reinterpret_cast<const void*>(reduce_world<float>);
  err = cudaLaunchCooperativeKernel(fn, dim3(static_cast<unsigned>(plan.grid)),
                                    dim3(kThreads), params, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Kinds: 0 one-shot reduce-scatter, 1 ring reduce-scatter, 2 one-shot
// all-reduce, 3 two-shot all-reduce, 4 recursive-doubling all-reduce; W
// ranks, partials of `elems` elements, dtype 0 bf16, 1 f32. A kind that
// cannot run (W < 2, a chunk that does not split, a recursive doubling
// over a world that is not a power of two) has workspace 0 and no plan;
// the plan is an error too when the card cannot run it (no cooperative
// launch, or more ranks than blocks it holds).

// Workspace elements (stage or receive slots) a call needs in each rank's
// row.
long long tdt_reduce_world_workspace(int kind, int world, long long elems) {
  if (!kind_ok(kind, world, elems)) return 0;
  return workspace_count(kind, world, unit_of(kind, world, elems));
}

// The plan of a call on this card: *grid blocks of the cooperative launch
// (every one resident), *resident_blocks the card holds at once, *piece
// elements of a piece, *pieces of them a unit (a chunk or a partial) and
// *signals, the 64-bit signals a call needs in each rank's row (one a hop
// of each piece). Returns a cudaError_t.
int tdt_reduce_world_grid(int kind, int world, long long elems, int dtype,
                          int* grid, int* resident_blocks, long long* piece,
                          long long* pieces, long long* signals) {
  if (grid == nullptr || resident_blocks == nullptr || piece == nullptr ||
      pieces == nullptr || signals == nullptr ||
      !kind_ok(kind, world, elems) || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan;
  const cudaError_t err = plan_of(kind, world, elems, dtype, &plan);
  if (err != cudaSuccess) return static_cast<int>(err);
  *grid = plan.grid;
  *resident_blocks = plan.resident;
  *piece = plan.piece;
  *pieces = plan.pieces;
  *signals = signal_count(kind, world, plan.pieces);
  return static_cast<int>(cudaSuccess);
}

// The reduce-scatter over `world` ranks of one card: x (W, M, N)
// contiguous, rank r's partial x[r] (elems = M N elements, M % W == 0);
// rank r's output, chunk r (M / W rows) of the (M, N) output, at out + r *
// out_step. method 0: one-shot; 1: ring. Rank r's workspace row and signal
// row at ws + r * ws_step and sig + r * sig_step
// (tdt_reduce_world_workspace, and tdt_reduce_world_grid's signals, of
// kind `method`). `epoch` differs from every earlier call's on these
// signals (a counter, never 0); `straggler` is a rank or -1; `fault`
// plants the test fault. dtype 0: bf16, 1: f32. Returns a cudaError_t.
int tdt_reduce_scatter_world(const void* x, void* out, long long out_step,
                             void* ws, long long ws_step, void* sig,
                             long long sig_step, long long elems, int world,
                             int method, int dtype, int straggler,
                             long long straggle_cycles,
                             unsigned long long epoch, int fault,
                             void* stream) {
  if (method < 0 || method > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(x, out, out_step, ws, ws_step, sig, sig_step, elems, world,
                kRsOneShot + method, dtype, straggler, straggle_cycles, epoch,
                fault, stream);
}

// The all-reduce over `world` ranks of one card: as above, rank r's output
// its (M, N) copy. method 0: one-shot; 1: two-shot (M % W == 0); 2:
// recursive doubling (W a power of two). Workspace and signals of kind
// 2 + method. Returns a cudaError_t.
int tdt_all_reduce_world(const void* x, void* out, long long out_step,
                         void* ws, long long ws_step, void* sig,
                         long long sig_step, long long elems, int world,
                         int method, int dtype, int straggler,
                         long long straggle_cycles, unsigned long long epoch,
                         int fault, void* stream) {
  if (method < 0 || method > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(x, out, out_step, ws, ws_step, sig, sig_step, elems, world,
                kArOneShot + method, dtype, straggler, straggle_cycles, epoch,
                fault, stream);
}

// The runtime's message for an error code returned above.
const char* tdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
