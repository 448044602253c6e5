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
//    its right neighbour's, step 0 by the item that reduced the chunk;
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
// x[r] of one global (W, M, N) tensor; its output, its workspace and its
// signal row are rank r's entries of device tables of base addresses
// (shmem.cuh's tdt_peer_ptr), as a Pallas kernel reaches a peer by device
// id. A reduce-scatter's output entry r is chunk r of one (M, N) tensor;
// an all-reduce's is rank r's (M, N) copy.
//
// The design, a simple kernel that is right first:
//  * the unit of a call (the chunk, M N / W elements, or the whole
//    partial) is cut into pieces of kPieceElems elements, so a decode
//    chunk of one row still spreads over several blocks; a piece moves in
//    16-byte vectors, neighbouring threads on neighbouring addresses, when
//    its ends allow, else element by element;
//  * every push of a piece is followed by __syncthreads, a fence and one
//    release store of its 64-bit signal, stamped with the call's epoch
//    (never reset: a wait compares for equality); a wait is an acquire
//    load loop (shmem.cuh);
//  * items (a push, a sum, a forward, of one piece of one rank) are dealt
//    round robin to every block of the launch in phase order: pushes
//    before the sums that wait for them, ring step s after step s - 1,
//    round j after round j - 1. Every wait's producer has a smaller index,
//    so with every block resident (the cooperative launch; a grid that the
//    card cannot hold fails) the smallest unfinished item can always run:
//    no deadlock. No atomics: every sum has one fixed order;
//  * the recursive doubling keeps its running partial in the rank's output.
//    A round's add waits for the partner's push into its slot and for its
//    own push out of the output, and releases a per-round "done" signal
//    that the next round's push waits for.
// `straggler` (JAX's straggler_option): every first-phase item of that
// rank spins about `straggle_cycles` clock cycles before it pushes; no
// value changes. `fault` (a test hook): rank 0's first push of piece 0
// skips its stores and still releases its signal, so a NaN-filled
// workspace shows in the output.
//
// What bounds it (H100 SXM: 3.35 TB/s): bytes. An all-reduce reads the W
// partials once and writes W copies, 2 W M N itemsize bytes (W = 4, bf16:
// 0.00008 ms at decode (4, 4096), 0.0100 ms at prefill (512, 4096)); a
// reduce-scatter reads the partials and writes the (M, N) result, (W + 1)
// M N itemsize (0.0063 ms at prefill). The pushes move (W - 1) M N more
// bytes (one-shot all-reduce: (W - 1) W M N), written once and read once,
// which the bound does not count.
//
// Plain C entry points, loaded with ctypes. A call runs on the stream it is
// given, allocates nothing and returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "shmem.cuh"

namespace {

constexpr int kThreads = 256;
// Elements of one piece: one item, one signal.
constexpr long long kPieceElems = 2048;

// Kinds of a call: the op and its method.
constexpr int kRsOneShot = 0;
constexpr int kRsRing = 1;
constexpr int kArOneShot = 2;
constexpr int kArTwoShot = 3;
constexpr int kArDoubling = 4;

typedef unsigned long long u64;

struct Args {
  const unsigned char* x;    // (W, elems) partials
  const long long* out_tab;  // rank r's output (its chunk, or its copy)
  const long long* ws_tab;   // rank r's stage / receive slots
  const long long* sig_tab;  // rank r's signal row
  long long elems;           // elements of one partial, M N
  long long unit;            // elements a piece cuts: a chunk or a partial
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

__host__ __device__ inline long long unit_of(int kind, int world,
                                             long long elems) {
  return (kind == kArOneShot || kind == kArDoubling) ? elems : elems / world;
}

__host__ __device__ inline long long pieces_of(long long unit) {
  return (unit + kPieceElems - 1) / kPieceElems;
}

// Items of a call, in phase order.
__host__ __device__ inline long long item_count(int kind, int world,
                                                long long pieces) {
  const long long w = world;
  if (kind == kArTwoShot) return (2 * w - 2) * w * pieces;
  if (kind == kArDoubling) return 2LL * rounds_of(world) * w * pieces;
  return w * w * pieces;                // one-shot, ring
}

// 64-bit signals in each rank's row.
long long signal_count(int kind, int world, long long pieces) {
  const long long w = world;
  if (kind == kRsRing) return (w - 1) * pieces;
  if (kind == kArTwoShot) return (2 * w - 1) * pieces;
  if (kind == kArDoubling) return 2LL * rounds_of(world) * pieces;
  return w * pieces;                    // one-shot
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

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The calling block writes dst[i] = src(0)[i] + src(1)[i] + ... +
// src(n - 1)[i] for i < n, adding left to right, each add rounded.
template <typename T, typename Src>
__device__ __forceinline__ void sum_piece(T* dst, Src src, int n_src,
                                          long long n) {
  constexpr int V = 16 / sizeof(T);
  bool vec = aligned16(dst);
  for (int q = 0; q < n_src; ++q) vec = vec && aligned16(src(q));
  long long done = 0;
  if (vec) {
    const long long nv = n / V;
    for (long long i = threadIdx.x; i < nv; i += blockDim.x) {
      alignas(16) T acc[V];
      *reinterpret_cast<uint4*>(acc) =
          *reinterpret_cast<const uint4*>(src(0) + i * V);
      for (int q = 1; q < n_src; ++q) {
        alignas(16) T v[V];
        *reinterpret_cast<uint4*>(v) =
            *reinterpret_cast<const uint4*>(src(q) + i * V);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = add_rn(acc[e], v[e]);
      }
      *reinterpret_cast<uint4*>(dst + i * V) =
          *reinterpret_cast<const uint4*>(acc);
    }
    done = nv * V;
  }
  for (long long i = done + threadIdx.x; i < n; i += blockDim.x) {
    T acc = src(0)[i];
    for (int q = 1; q < n_src; ++q) acc = add_rn(acc, src(q)[i]);
    dst[i] = acc;
  }
}

template <typename T>
__device__ __forceinline__ T* out_of(const Args& a, int r) {
  return reinterpret_cast<T*>(tdt_peer_ptr(a.out_tab, r));
}
template <typename T>
__device__ __forceinline__ T* ws_of(const Args& a, int r) {
  return reinterpret_cast<T*>(tdt_peer_ptr(a.ws_tab, r));
}
__device__ __forceinline__ u64* sig_of(const Args& a, int r) {
  return reinterpret_cast<u64*>(tdt_peer_ptr(a.sig_tab, r));
}
template <typename T>
__device__ __forceinline__ const T* x_of(const Args& a, int r) {
  return reinterpret_cast<const T*>(a.x) + r * a.elems;
}

// The block's stores are done; thread 0 releases `sig`.
__device__ __forceinline__ void release(u64* sig, u64 epoch) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    tdt_signal_release(sig, epoch);
  }
}

// A first-phase item of the straggling rank spins before it communicates.
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
  const long long left = a.unit - p * kPieceElems;
  return left < kPieceElems ? left : kPieceElems;
}

// -- push-then-sum (both one-shots) -----------------------------------------
// Offset of rank `peer`'s contribution in a partial: its row chunk for the
// reduce-scatter, the whole partial for the all-reduce.
__device__ __forceinline__ long long contribution(const Args& a, int peer) {
  return a.kind == kRsOneShot ? peer * a.unit : 0;
}

template <typename T>
__device__ void one_shot_push(const Args& a, int me, int q, long long p) {
  straggle(a, me);
  const int peer = (me + q) % a.world;
  const long long e0 = p * kPieceElems;
  const T* src = x_of<T>(a, me) + contribution(a, peer) + e0;
  if (!(a.fault && me == 0 && q == 1 && p == 0))
    sum_piece(ws_of<T>(a, peer) + me * a.unit + e0,
              [&](int) { return src; }, 1, piece_len(a, p));
  release(sig_of(a, peer) + me * a.pieces + p, a.epoch);
}

template <typename T>
__device__ void one_shot_sum(const Args& a, int me, long long p) {
  const int W = a.world;
  const u64* sig = sig_of(a, me);
  for (int q = 1 + threadIdx.x; q < W; q += blockDim.x) {
    const u64* s = sig + static_cast<long long>((me - q + W) % W) * a.pieces
                   + p;
    while (tdt_signal_acquire(s) != a.epoch) __nanosleep(64);
  }
  __threadfence();
  __syncthreads();
  const long long e0 = p * kPieceElems;
  const T* own = x_of<T>(a, me) + contribution(a, me) + e0;
  const T* stage = ws_of<T>(a, me) + e0;
  sum_piece(out_of<T>(a, me) + e0,
            [&](int r) { return r == me ? own : stage + r * a.unit; }, W,
            piece_len(a, p));
}

// -- the ring reduce-scatter, and the two-shot ------------------------------
// Rank me's step-s push of piece p of chunk me - s - 1 into its right
// neighbour's receive slot s.
template <typename T>
__device__ void ring_push(const Args& a, int me, int s, long long p) {
  const int W = a.world;
  const int right = (me + 1) % W;
  const int c = ((me - s - 1) % W + W) % W;
  const long long e0 = p * kPieceElems;
  const T* xs = x_of<T>(a, me) + c * a.unit + e0;
  const T* got = s > 0 ? ws_of<T>(a, me) + (s - 1) * a.unit + e0 : xs;
  if (s == 0) {
    straggle(a, me);
  } else {
    tdt_signal_wait_until(sig_of(a, me) + (s - 1) * a.pieces + p, a.epoch);
  }
  if (!(a.fault && me == 0 && s == 0 && p == 0))
    sum_piece(ws_of<T>(a, right) + s * a.unit + e0,
              [&](int q) { return q == 0 ? got : xs; },
              s > 0 ? 2 : 1, piece_len(a, p));
  release(sig_of(a, right) + s * a.pieces + p, a.epoch);
}

// Rank me's chunk me, piece p: rnd(recv[W - 2] + x_me[me]). The two-shot
// also pushes it into its right neighbour's output (all-gather step 0).
template <typename T>
__device__ void ring_final(const Args& a, int me, long long p) {
  const int W = a.world;
  tdt_signal_wait_until(sig_of(a, me) + (W - 2) * a.pieces + p, a.epoch);
  const long long e0 = p * kPieceElems;
  const T* xs = x_of<T>(a, me) + me * a.unit + e0;
  const T* got = ws_of<T>(a, me) + (W - 2) * a.unit + e0;
  auto src = [&](int q) { return q == 0 ? got : xs; };
  const long long n = piece_len(a, p);
  if (a.kind == kRsRing) {
    sum_piece(out_of<T>(a, me) + e0, src, 2, n);
    return;
  }
  const long long at = me * a.unit + e0;
  sum_piece(out_of<T>(a, me) + at, src, 2, n);
  const int right = (me + 1) % W;
  sum_piece(out_of<T>(a, right) + at, src, 2, n);
  release(sig_of(a, right) + (W - 1 + me) * a.pieces + p, a.epoch);
}

// The two-shot's all-gather step s >= 1: rank me forwards piece p of chunk
// me - s, once it has arrived, into its right neighbour's output.
template <typename T>
__device__ void ring_forward(const Args& a, int me, int s, long long p) {
  const int W = a.world;
  const int right = (me + 1) % W;
  const int c = ((me - s) % W + W) % W;
  const long long slot = (W - 1 + c) * a.pieces + p;
  tdt_signal_wait_until(sig_of(a, me) + slot, a.epoch);
  const long long at = c * a.unit + p * kPieceElems;
  const T* src = out_of<T>(a, me) + at;
  sum_piece(out_of<T>(a, right) + at, [&](int) { return src; }, 1,
            piece_len(a, p));
  release(sig_of(a, right) + slot, a.epoch);
}

// -- recursive doubling -----------------------------------------------------
// Signals of a rank: receive (round, piece) at j P + p, then its own "round
// j done" at (L + j) P + p.
template <typename T>
__device__ void doubling_push(const Args& a, int me, int j, long long p) {
  const int partner = me ^ (1 << j);
  const long long e0 = p * kPieceElems;
  if (j == 0) {
    straggle(a, me);
  } else {
    tdt_signal_wait_until(sig_of(a, me) + (a.rounds + j - 1) * a.pieces + p,
                          a.epoch);
  }
  const T* src = (j == 0 ? x_of<T>(a, me) : out_of<T>(a, me)) + e0;
  if (!(a.fault && me == 0 && j == 0 && p == 0))
    sum_piece(ws_of<T>(a, partner) + j * a.unit + e0,
              [&](int) { return src; }, 1, piece_len(a, p));
  release(sig_of(a, partner) + j * a.pieces + p, a.epoch);
}

template <typename T>
__device__ void doubling_add(const Args& a, int me, int j, long long p) {
  const int partner = me ^ (1 << j);
  // The partner's push into my slot j, and mine out of my output.
  if (threadIdx.x < 2) {
    const u64* s = sig_of(a, threadIdx.x == 0 ? me : partner) +
                   j * a.pieces + p;
    while (tdt_signal_acquire(s) != a.epoch) __nanosleep(64);
  }
  __threadfence();
  __syncthreads();
  const long long e0 = p * kPieceElems;
  const T* mine = (j == 0 ? x_of<T>(a, me) : out_of<T>(a, me)) + e0;
  const T* got = ws_of<T>(a, me) + j * a.unit + e0;
  sum_piece(out_of<T>(a, me) + e0,
            [&](int q) { return q == 0 ? mine : got; }, 2, piece_len(a, p));
  if (j < a.rounds - 1)
    release(sig_of(a, me) + (a.rounds + j) * a.pieces + p, a.epoch);
}

template <typename T>
__device__ void run_item(const Args& a, long long it) {
  const int W = a.world;
  const long long p = it % a.pieces;
  long long rest = it / a.pieces;
  if (a.kind == kArDoubling) {
    const int me = static_cast<int>(rest % W);
    const int phase = static_cast<int>((rest / W) % 2);
    const int j = static_cast<int>(rest / (2LL * W));
    if (phase == 0) {
      doubling_push<T>(a, me, j, p);
    } else {
      doubling_add<T>(a, me, j, p);
    }
    return;
  }
  const long long pushes = static_cast<long long>(W) * (W - 1);
  if (rest < pushes) {
    const int me = static_cast<int>(rest % W);
    const int step = static_cast<int>(rest / W);
    if (a.kind == kRsOneShot || a.kind == kArOneShot) {
      one_shot_push<T>(a, me, step + 1, p);
    } else {
      ring_push<T>(a, me, step, p);
    }
    return;
  }
  rest -= pushes;
  if (rest < W) {
    const int me = static_cast<int>(rest);
    if (a.kind == kRsOneShot || a.kind == kArOneShot) {
      one_shot_sum<T>(a, me, p);
    } else {
      ring_final<T>(a, me, p);
    }
    return;
  }
  rest -= W;
  ring_forward<T>(a, static_cast<int>(rest % W),
                  1 + static_cast<int>(rest / W), p);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) reduce_world(Args a) {
  const long long total = item_count(a.kind, a.world, a.pieces);
  for (long long it = blockIdx.x; it < total; it += gridDim.x) {
    run_item<T>(a, it);
    __syncthreads();  // the block's threads leave an item together
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

// The launch's grid: one block for each item, at most what is resident.
cudaError_t grid_of(int kind, int world, long long elems, int dtype,
                    int* grid) {
  int res = 0;
  const cudaError_t err =
      dtype == 0 ? resident<unsigned short>(&res) : resident<float>(&res);
  if (err != cudaSuccess) return err;
  if (res < 1) return cudaErrorCooperativeLaunchTooLarge;
  const long long items =
      item_count(kind, world, pieces_of(unit_of(kind, world, elems)));
  *grid = static_cast<int>(items < res ? items : res);
  return cudaSuccess;
}

int launch(const void* x, const void* out_tab, const void* ws_tab,
           const void* sig_tab, long long elems, int world, int kind,
           int dtype, int straggler, long long straggle_cycles,
           unsigned long long epoch, int fault, void* stream) {
  if (x == nullptr || out_tab == nullptr || ws_tab == nullptr ||
      sig_tab == nullptr || !kind_ok(kind, world, elems) || dtype < 0 ||
      dtype > 1 || straggler < -1 || straggler >= world ||
      straggle_cycles < 0 || epoch == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const unsigned char*>(x);
  a.out_tab = static_cast<const long long*>(out_tab);
  a.ws_tab = static_cast<const long long*>(ws_tab);
  a.sig_tab = static_cast<const long long*>(sig_tab);
  a.elems = elems;
  a.unit = unit_of(kind, world, elems);
  a.pieces = pieces_of(a.unit);
  a.straggle_cycles = straggle_cycles;
  a.epoch = epoch;
  a.world = world;
  a.kind = kind;
  a.rounds = rounds_of(world);
  a.straggler = straggler;
  a.fault = fault;
  int grid = 0;
  cudaError_t err = grid_of(kind, world, elems, dtype, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* params[] = {&a};
  const void* fn = dtype == 0
                       ? reinterpret_cast<const void*>(
                             reduce_world<unsigned short>)
                       : reinterpret_cast<const void*>(reduce_world<float>);
  err = cudaLaunchCooperativeKernel(fn, dim3(static_cast<unsigned>(grid)),
                                    dim3(kThreads), params, 0,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Kinds: 0 one-shot reduce-scatter, 1 ring reduce-scatter, 2 one-shot
// all-reduce, 3 two-shot all-reduce, 4 recursive-doubling all-reduce; W
// ranks, partials of `elems` elements. Each returns 0 for a kind that
// cannot run (W < 2, a chunk that does not split, a recursive doubling
// over a world that is not a power of two).

// 64-bit signals a call needs in each rank's row.
long long tdt_reduce_world_signals(int kind, int world, long long elems) {
  if (!kind_ok(kind, world, elems)) return 0;
  return signal_count(kind, world, pieces_of(unit_of(kind, world, elems)));
}

// Workspace elements (stage or receive slots) a call needs in each rank's
// row.
long long tdt_reduce_world_workspace(int kind, int world, long long elems) {
  if (!kind_ok(kind, world, elems)) return 0;
  return workspace_count(kind, world, unit_of(kind, world, elems));
}

// Blocks of a call's cooperative launch in dtype (0: bf16, 1: f32) on this
// card, and the blocks the card holds at once. Returns a cudaError_t.
int tdt_reduce_world_grid(int kind, int world, long long elems, int dtype,
                          int* grid, int* resident_blocks) {
  if (grid == nullptr || resident_blocks == nullptr ||
      !kind_ok(kind, world, elems) || dtype < 0 || dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = grid_of(kind, world, elems, dtype, grid);
  if (err == cudaSuccess)
    err = dtype == 0 ? resident<unsigned short>(resident_blocks)
                     : resident<float>(resident_blocks);
  return static_cast<int>(err);
}

// The reduce-scatter over `world` ranks of one card: x (W, M, N)
// contiguous, rank r's partial x[r] (elems = M N elements, M % W == 0);
// out_tab[r] is chunk r (M / W rows) of the (M, N) output. method 0:
// one-shot; 1: ring. ws_tab[r] / sig_tab[r]: rank r's workspace row and
// signal row (tdt_reduce_world_workspace / _signals of kind `method`).
// `epoch` differs from every earlier call's on these signals (a counter,
// never 0); `straggler` is a rank or -1; `fault` plants the test fault.
// dtype 0: bf16, 1: f32. Returns a cudaError_t.
int tdt_reduce_scatter_world(const void* x, const void* out_tab,
                             const void* ws_tab, const void* sig_tab,
                             long long elems, int world, int method,
                             int dtype, int straggler,
                             long long straggle_cycles,
                             unsigned long long epoch, int fault,
                             void* stream) {
  if (method < 0 || method > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(x, out_tab, ws_tab, sig_tab, elems, world,
                kRsOneShot + method, dtype, straggler, straggle_cycles,
                epoch, fault, stream);
}

// The all-reduce over `world` ranks of one card: as above, out_tab[r] rank
// r's (M, N) copy. method 0: one-shot; 1: two-shot (M % W == 0); 2:
// recursive doubling (W a power of two). Workspace and signals of kind
// 2 + method. Returns a cudaError_t.
int tdt_all_reduce_world(const void* x, const void* out_tab,
                         const void* ws_tab, const void* sig_tab,
                         long long elems, int world, int method, int dtype,
                         int straggler, long long straggle_cycles,
                         unsigned long long epoch, int fault, void* stream) {
  if (method < 0 || method > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(x, out_tab, ws_tab, sig_tab, elems, world,
                kArOneShot + method, dtype, straggler, straggle_cycles,
                epoch, fault, stream);
}

// The runtime's message for an error code returned above.
const char* tdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
