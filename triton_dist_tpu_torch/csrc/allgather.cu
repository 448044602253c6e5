// The all-gather and broadcast kernels for Hopper (sm_90a): the world = 1
// copy that every collective's world = 1 body is, and the world-W
// all-gather (full-mesh push, ring, bidirectional ring) and broadcast over
// W ranks that share one card.
//
// World = 1: one copy kernel (`tdt_copy`). At world = 1 each of these
// Pallas kernels copies a buffer and nothing else:
//  * all-gather: this rank's row chunk into its slot of the gathered
//    buffer, a copy at rank 0. Replaces
//    triton_dist_tpu/ops/allgather.py::_full_mesh_push_kernel (:254;
//    `o_ref[pl.ds(me * rows, rows)] = x_ref`, :260-262) and
//    `_ring_ag_kernel` (:133), whose world = 1 body is the same copy;
//  * the world = 1 bodies of the other collectives, all dst = src:
//    - ops/allreduce.py::_one_shot_ar_kernel (:114, body :120-122),
//      _recursive_doubling_ar_kernel (:158, :172-174) and
//      _two_shot_ar_kernel (:193, :203-205): `o = x`;
//    - ops/reduce_scatter.py::_ring_rs_kernel (:92, :110-112) and
//      _one_shot_rs_kernel (:150, :157-159): `o = x[0 : M]`;
//    - ops/allgather.py::_broadcast_kernel (:218, :225-229): the root's
//      buffer.
//
// What bounds the copy: bytes, 2 x n (each byte read once and written
// once) at 3.35 TB/s: 0.0025 ms for the 4 MiB of (1, 512, 4096) bf16,
// 0.0013 for TP-MoE's (512, 2048) prefill chunk and 0.00001 for its
// (4, 2048) decode chunk. Below a few hundred KiB no copy comes near that:
// a launch and one round trip to memory (1.3-2 us on an H100 queued behind
// other kernels) are the floor, and no kernel design removes them.
//
// The design (`copy_body`), by bytes:
//  * one trip: a thread issues all its kCopyUnroll loads (16 bytes each,
//    neighbouring threads on neighbouring addresses) before its first
//    store, so a block moves blockDim x kCopyUnroll units in one round
//    trip; there is no grid-stride loop;
//  * a block owns one contiguous piece of the copy for the whole call.
//    Small copies (the decode chunk, 16 KiB) take the narrowest blocks
//    (32 threads) so their trips spread over as many SMs as there are
//    trips; larger ones widen the block up to 256 threads while the grid
//    would exceed one block an SM, so a 4 MiB copy is one wave of 256
//    one-trip blocks, all resident at once. Past kCopyBlocksPerSm x SMs
//    trips a block walks several trips of its piece;
//  * misaligned ends: when src and dst share their offset mod 16, block 0
//    copies the head bytes up to the first 16-byte boundary and the last
//    block the tail bytes after the last whole vector, so the body stays
//    in 16-byte vectors. Only a true mismatch takes narrower units (8, 4,
//    2 or 1 bytes: the widest on which src and dst agree), in the same
//    kernel;
//  * the launch allows programmatic stream serialization: its blocks may
//    be placed while the stream's previous kernel finishes, and wait for
//    it (griddepcontrol.wait) before their first load. That hides part
//    of the launch, not the round trip. On an H100 most of the gain over
//    the grid-stride loop is this: launched without it, the same body
//    timed as the old kernel at 16 KiB, 2 MiB and 4 MiB, back to back
//    (`step_times.py collectives` times the copy rows).
// src and dst must not overlap.
//
// World W (`tdt_all_gather_world`, `tdt_broadcast_world`): the ranks are W
// slices of one card (runtime/dist.py). Rank r's input chunk is chunk r of
// one global (W rows, ...) tensor; its output is row r of one (W, ...)
// tensor, reached from row 0's address and the bytes between two rows
// (shmem.cuh's tdt_rank_ptr), as a Pallas kernel reaches a peer's buffer
// by device id; the signal rows through the state's device table, made
// once (tdt_peer_ptr). So a call queues this one kernel and nothing else.
// Replaces, each in one cooperative launch over every rank:
//  * _full_mesh_push_kernel (:254): each rank copies its chunk into its
//    own slot, then pushes it into slot `me` of every peer in JAX's order
//    peer = me + p, p = 1..W-1 (:271-279), each push followed by its
//    signal; then it waits for its W - 1 sources in JAX's order
//    src = me - p (:281-292);
//  * _ring_ag_kernel (:133): the own chunk into the own slot, then W - 1
//    hops to the right (`bidir`: ceil((W - 1) / 2) to the right and the
//    rest to the left, :151-152). At step s rank me forwards chunk me - s
//    to the right (me + s to the left) once it has arrived. Signals are
//    per chunk, as JAX's per-chunk semaphores are (:154-160): a signal of
//    another chunk never satisfies a wait;
//  * _broadcast_kernel (:218): the root copies its chunk into its own
//    buffer and pushes it to root + p, p = 1..W-1 (:236-241); the peers
//    wait (:248-250).
// A push copies from the input chunk, which holds the bytes of the
// pusher's own slot that JAX pushes from.
//
// What bounds it: bytes. A call reads each input chunk and writes W
// copies of the gathered tensor: (W + W^2) C bytes for chunks of C bytes
// at 3.35 TB/s. On the TP-MoE path of Qwen3-30B-A3B at W = 4 (x of
// (4, 2048) at decode, (512, 2048) at prefill, bf16) that is 0.02 us and
// 3.1 us; at decode the launch and the signal round trips cost more.
//
// The design, a simple kernel that is right first:
//  * every copy is cut into pieces of kPiece bytes; each piece of each
//    chunk has its own 64-bit signal in the owner's signal row, stamped
//    with the call's epoch (never reset: a wait compares for equality);
//  * items are dealt round-robin to all blocks of the launch, every rank's
//    items to every block (on one card a rank owns no SMs), in one order:
//    every copy item before any wait item, and a ring hop of step s after
//    every item of step s - 1. A wait's producer has a smaller index, so
//    with every block resident (the cooperative launch) the smallest
//    unfinished item can always run: no deadlock;
//  * a copy is 16-byte vectors, neighbouring threads on neighbouring
//    addresses (tdt_putmem_block), then __syncthreads, a fence and one
//    release store of the piece's signal; a wait is an acquire load loop.
// `fault` plants the test fault: the first push (or first forward) of
// rank 0 (the root for a broadcast) skips piece 0 and still sets its
// signal, so a NaN-filled output keeps NaN there.
//
// Plain C entry points, loaded with ctypes. A call runs on the stream it is
// given, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "shmem.cuh"

namespace {

constexpr int kThreads = 256;
// Bytes of one piece of a chunk: one copy item, one signal.
constexpr long long kPiece = 16 * 1024;

// -- world 1: the copy ----------------------------------------------------
// Loads a thread issues before its first store.
constexpr int kCopyUnroll = 4;
// The narrowest and widest block.
constexpr int kCopyMinThreads = 32;
constexpr int kCopyMaxThreads = 256;
// One-trip blocks of copy_body the grid takes on each SM before a block
// walks more than one trip (8 x 256 threads: the SM's 2048).
constexpr int kCopyBlocksPerSm = 8;

// dst[0, n) <- src[0, n), src and dst at the same offset mod sizeof(T):
// `head` bytes up to the first T-aligned address (block 0), `units` whole
// units of T, then the tail bytes (the last block). Block b owns units
// [b per_block, (b + 1) per_block), walked in trips of blockDim x
// kCopyUnroll units.
template <typename T>
__global__ void __launch_bounds__(kCopyMaxThreads)
copy_body(const unsigned char* __restrict__ src,
          unsigned char* __restrict__ dst, long long n, int head,
          long long units, long long per_block) {
  // The stream's previous kernel has finished and its writes are
  // visible (the launch allows programmatic stream serialization).
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int t = threadIdx.x;
  const long long nt = blockDim.x;
  if (blockIdx.x == 0 && t < head) dst[t] = src[t];
  const long long tail0 = head + units * static_cast<long long>(sizeof(T));
  if (blockIdx.x == gridDim.x - 1 && t < n - tail0)
    dst[tail0 + t] = src[tail0 + t];
  const T* s = reinterpret_cast<const T*>(src + head);
  T* d = reinterpret_cast<T*>(dst + head);
  const long long begin = static_cast<long long>(blockIdx.x) * per_block;
  const long long end = begin + per_block < units ? begin + per_block
                                                  : units;
  for (long long base = begin + t; base < end; base += nt * kCopyUnroll) {
    T v[kCopyUnroll];
#pragma unroll
    for (int j = 0; j < kCopyUnroll; ++j)
      if (base + j * nt < end) v[j] = s[base + j * nt];
#pragma unroll
    for (int j = 0; j < kCopyUnroll; ++j)
      if (base + j * nt < end) d[base + j * nt] = v[j];
  }
}

// A copy's launch: the unit width (bytes), head bytes, units, block width,
// units a block owns, blocks.
struct CopyPlan {
  int width, head;
  long long units;
  int threads;
  long long per_block, grid;
};

CopyPlan copy_plan(uintptr_t src, uintptr_t dst, long long n, int sms) {
  CopyPlan p;
  p.width = 16;
  while (p.width > 1 && src % p.width != dst % p.width) p.width /= 2;
  const long long head = (p.width - static_cast<long long>(src % p.width)) %
                         p.width;
  p.head = static_cast<int>(head < n ? head : n);
  p.units = (n - p.head) / p.width;
  p.threads = kCopyMinThreads;
  while (p.threads < kCopyMaxThreads &&
         p.units > static_cast<long long>(p.threads) * kCopyUnroll * sms)
    p.threads *= 2;
  const long long trip = static_cast<long long>(p.threads) * kCopyUnroll;
  const long long trips = p.units > 0 ? (p.units + trip - 1) / trip : 1;
  const long long cap = static_cast<long long>(sms) * kCopyBlocksPerSm;
  const long long spread = trips < cap ? trips : cap;
  p.per_block = (trips + spread - 1) / spread * trip;
  p.grid = p.units > 0 ? (p.units + p.per_block - 1) / p.per_block : 1;
  return p;
}

template <typename T>
cudaError_t launch_copy_body(const CopyPlan& p, const unsigned char* src,
                             unsigned char* dst, long long n,
                             cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.grid));
  cfg.blockDim = dim3(p.threads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, copy_body<T>, src, dst, n, p.head, p.units,
                            p.per_block);
}

// -- world W --------------------------------------------------------------
constexpr int kFullMesh = 0;
constexpr int kRing = 1;
constexpr int kRingBidir = 2;
constexpr int kBroadcast = 3;

struct Args {
  const unsigned char* x;    // W chunks of `chunk` bytes, rank r's at r C
  unsigned char* out;        // rank 0's output buffer
  long long out_step;        // bytes from rank r's output buffer to r + 1's
  const long long* sig_tab;  // rank r's signal row
  long long chunk;           // bytes of one rank's chunk
  long long pieces;          // pieces of one chunk
  unsigned long long epoch;
  int world;
  int method;
  int root;                  // broadcast only
  int n_fwd, n_bwd;          // ring hops each way
  int fault;
};

__device__ __forceinline__ long long piece_bytes(const Args& a, long long pc) {
  const long long left = a.chunk - pc * kPiece;
  return left < kPiece ? left : kPiece;
}

// Rank `owner`'s signal of piece `pc` of slot `slot`.
__device__ __forceinline__ unsigned long long* signal_of(const Args& a,
                                                         int owner, int slot,
                                                         long long pc) {
  return reinterpret_cast<unsigned long long*>(
             tdt_peer_ptr(a.sig_tab, owner)) +
         static_cast<long long>(slot) * a.pieces + pc;
}

// Slot `slot` of rank `owner`'s output, at piece `pc`.
__device__ __forceinline__ unsigned char* slot_of(const Args& a, int owner,
                                                  int slot, long long pc) {
  return tdt_rank_ptr(a.out, a.out_step, owner) + slot * a.chunk +
         pc * kPiece;
}

__device__ __forceinline__ const unsigned char* input_of(const Args& a,
                                                         int rank,
                                                         long long pc) {
  return a.x + rank * a.chunk + pc * kPiece;
}

// Piece `pc` from src into slot `slot` of rank `owner`, then its signal;
// `skip` leaves the copy out and still sets the signal (the test fault).
__device__ __forceinline__ void push(const Args& a, int owner, int slot,
                                     long long pc, const unsigned char* src,
                                     bool skip) {
  unsigned long long* sig = signal_of(a, owner, slot, pc);
  if (skip) {
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      tdt_signal_release(sig, a.epoch);
    }
    return;
  }
  tdt_putmem_signal_block(slot_of(a, owner, slot, pc), src,
                          piece_bytes(a, pc), sig, a.epoch);
}

// Items of a call: copies (counted first), then waits.
struct Counts {
  long long copies, waits;
};

__host__ __device__ inline Counts item_counts(int method, int world,
                                              long long pieces, int n_fwd,
                                              int n_bwd) {
  const long long w = world;
  if (method == kFullMesh) return {w * w * pieces, w * (w - 1) * pieces};
  if (method == kBroadcast) return {w * pieces, (w - 1) * pieces};
  const long long steps = n_fwd > n_bwd ? n_fwd : n_bwd;
  return {w * pieces + steps * 2 * w * pieces, w * (w - 1) * pieces};
}

// Copy item `it` of the full-mesh push: (p, me, piece), p = 0 the own slot.
__device__ void full_mesh_copy(const Args& a, long long it) {
  const int W = a.world;
  const long long pc = it % a.pieces;
  const int me = static_cast<int>((it / a.pieces) % W);
  const int p = static_cast<int>(it / (a.pieces * W));
  const unsigned char* src = input_of(a, me, pc);
  if (p == 0) {
    tdt_putmem_block(slot_of(a, me, me, pc), src, piece_bytes(a, pc));
    return;
  }
  const int peer = (me + p) % W;
  push(a, peer, me, pc, src, a.fault && me == 0 && p == 1 && pc == 0);
}

// Copy item `it` of the ring: the own slots first, then (step, direction,
// me, piece) with the step outermost.
__device__ void ring_copy(const Args& a, long long it) {
  const int W = a.world;
  const long long own = static_cast<long long>(W) * a.pieces;
  if (it < own) {
    const long long pc = it % a.pieces;
    const int me = static_cast<int>(it / a.pieces);
    tdt_putmem_block(slot_of(a, me, me, pc), input_of(a, me, pc),
                     piece_bytes(a, pc));
    return;
  }
  it -= own;
  const long long pc = it % a.pieces;
  const int me = static_cast<int>((it / a.pieces) % W);
  const int dir = static_cast<int>((it / (a.pieces * W)) % 2);
  const int s = static_cast<int>(it / (a.pieces * W * 2));
  if (s >= (dir == 0 ? a.n_fwd : a.n_bwd)) return;
  const int c = dir == 0 ? ((me - s) % W + W) % W : (me + s) % W;
  const int dst = dir == 0 ? (me + 1) % W : (me - 1 + W) % W;
  const unsigned char* src;
  if (s == 0) {
    src = input_of(a, me, pc);
  } else {
    // Chunk c reached rank me at the previous step: forward it only then.
    tdt_signal_wait_until(signal_of(a, me, c, pc), a.epoch);
    src = slot_of(a, me, c, pc);
  }
  push(a, dst, c, pc, src,
       a.fault && me == 0 && s == 0 && dir == 0 && pc == 0);
}

// Copy item `it` of the broadcast: (p, piece), p = 0 the root's own buffer.
__device__ void broadcast_copy(const Args& a, long long it) {
  const long long pc = it % a.pieces;
  const int p = static_cast<int>(it / a.pieces);
  const unsigned char* src = input_of(a, a.root, pc);
  if (p == 0) {
    tdt_putmem_block(slot_of(a, a.root, 0, pc), src, piece_bytes(a, pc));
    return;
  }
  push(a, (a.root + p) % a.world, 0, pc, src,
       a.fault && p == 1 && pc == 0);
}

// Wait item `it`: rank me's wait for piece pc of one source, in JAX's
// order (src = me - p; the broadcast's peers wait for the root).
__device__ void wait_item(const Args& a, long long it) {
  const int W = a.world;
  const long long pc = it % a.pieces;
  if (a.method == kBroadcast) {
    const int me = (a.root + 1 + static_cast<int>(it / a.pieces)) % W;
    tdt_signal_wait_until(signal_of(a, me, 0, pc), a.epoch);
    return;
  }
  const int p = 1 + static_cast<int>((it / a.pieces) % (W - 1));
  const int me = static_cast<int>(it / (a.pieces * (W - 1)));
  tdt_signal_wait_until(signal_of(a, me, (me - p + W) % W, pc), a.epoch);
}

__global__ void __launch_bounds__(kThreads) gather_world(Args a) {
  const Counts n = item_counts(a.method, a.world, a.pieces, a.n_fwd,
                               a.n_bwd);
  const long long total = n.copies + n.waits;
  for (long long it = blockIdx.x; it < total; it += gridDim.x) {
    if (it >= n.copies) {
      wait_item(a, it - n.copies);
    } else if (a.method == kFullMesh) {
      full_mesh_copy(a, it);
    } else if (a.method == kBroadcast) {
      broadcast_copy(a, it);
    } else {
      ring_copy(a, it);
    }
    __syncthreads();  // the block's threads leave an item together
  }
}

// Blocks of gather_world the card keeps resident at once.
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
          &per_sm, gather_world, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    cached = sms * per_sm;
  }
  *out = cached;
  return cudaSuccess;
}

int launch_world(Args a, void* stream) {
  int resident = 0;
  cudaError_t err = world_resident(&resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Counts n = item_counts(a.method, a.world, a.pieces, a.n_fwd,
                               a.n_bwd);
  const long long items = n.copies + n.waits;
  const long long grid = items < resident ? items : resident;
  if (grid < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* params[] = {&a};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(gather_world),
      dim3(static_cast<unsigned>(grid)), dim3(kThreads), params, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* x, void* out, long long out_step,
               const void* sig_tab, long long chunk, int world, int method,
               unsigned long long epoch, int fault) {
  Args a;
  a.x = static_cast<const unsigned char*>(x);
  a.out = static_cast<unsigned char*>(out);
  a.out_step = out_step;
  a.sig_tab = static_cast<const long long*>(sig_tab);
  a.chunk = chunk;
  a.pieces = (chunk + kPiece - 1) / kPiece;
  a.epoch = epoch;
  a.world = world;
  a.method = method;
  a.root = 0;
  a.n_fwd = 0;
  a.n_bwd = 0;
  a.fault = fault;
  return a;
}

}  // namespace

extern "C" {

// dst <- src (nbytes bytes, not overlapping), on a card with `sms` SMs,
// in one launch of copy_body. Returns a cudaError_t.
int tdt_copy(const void* src, void* dst, long long nbytes, int sms,
             void* stream) {
  if (nbytes == 0) return static_cast<int>(cudaSuccess);  // empty: nullptr
  if (src == nullptr || dst == nullptr || nbytes < 0 || sms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned char* s = static_cast<const unsigned char*>(src);
  unsigned char* d = static_cast<unsigned char*>(dst);
  const CopyPlan p = copy_plan(reinterpret_cast<uintptr_t>(s),
                               reinterpret_cast<uintptr_t>(d), nbytes, sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (p.width) {
    case 16: err = launch_copy_body<uint4>(p, s, d, nbytes, st); break;
    case 8: err = launch_copy_body<uint2>(p, s, d, nbytes, st); break;
    case 4: err = launch_copy_body<unsigned>(p, s, d, nbytes, st); break;
    case 2: err = launch_copy_body<unsigned short>(p, s, d, nbytes, st);
      break;
    default: err = launch_copy_body<unsigned char>(p, s, d, nbytes, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Signals a world-W call of `chunk_bytes` chunks needs in each rank's row:
// W slots of one signal per piece (a broadcast uses the first slot).
long long tdt_gather_signals(long long chunk_bytes, int world) {
  return static_cast<long long>(world) * ((chunk_bytes + kPiece - 1) / kPiece);
}

// The all-gather over `world` ranks of one card: rank r's chunk x[r C,
// (r + 1) C) into slot r of every rank's output buffer (W C bytes each,
// rank r's at out + r * out_step). method 0: full-mesh push; 1: ring; 2:
// bidirectional ring. sig_tab[r]: rank r's row of tdt_gather_signals(...)
// uint64 signals. `epoch` must differ from every earlier call's on these
// signals (a counter, never 0); `fault` plants the test fault. Returns a
// cudaError_t.
int tdt_all_gather_world(const void* x, void* out, long long out_step,
                         const void* sig_tab, long long chunk_bytes,
                         int world, int method, unsigned long long epoch,
                         int fault, void* stream) {
  if (x == nullptr || out == nullptr || sig_tab == nullptr ||
      chunk_bytes < 1 || world < 2 || method < kFullMesh ||
      method > kRingBidir || epoch == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(x, out, out_step, sig_tab, chunk_bytes, world, method,
                     epoch, fault);
  if (method == kRing) {
    a.n_fwd = world - 1;
  } else if (method == kRingBidir) {
    a.n_fwd = world / 2;                     // ceil((W - 1) / 2)
    a.n_bwd = world - 1 - a.n_fwd;
  }
  return launch_world(a, stream);
}

// The broadcast over `world` ranks of one card: rank root's chunk
// x[root C, (root + 1) C) into every rank's output buffer (C bytes each,
// rank r's at out + r * out_step). Signals, epoch and fault as above.
// Returns a cudaError_t.
int tdt_broadcast_world(const void* x, void* out, long long out_step,
                        const void* sig_tab, long long chunk_bytes, int world,
                        int root, unsigned long long epoch, int fault,
                        void* stream) {
  if (x == nullptr || out == nullptr || sig_tab == nullptr ||
      chunk_bytes < 1 || world < 2 || root < 0 || root >= world ||
      epoch == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = make_args(x, out, out_step, sig_tab, chunk_bytes, world,
                     kBroadcast, epoch, fault);
  a.root = root;
  return launch_world(a, stream);
}

// The runtime's message for an error code returned above.
const char* tdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
