// The expert-parallel low-latency all-to-all for Hopper (sm_90a), every
// rank of one card in one launch. Replaces
// triton_dist_tpu/ops/all_to_all.py::_a2a_kernel (:155), which
// fast_all_to_all (:237) launches at world > 1.
//
// What it computes, for every rank at once: `send` is (W, W, cap, H)
// rank-major, rank s's slab d carrying n = counts[s * W + d] live rows for
// rank d; `recv` is the same shape, and afterwards recv[d, s, :n] =
// send[s, d, :n] and recv_counts[d * W + s] = counts[s * W + d] (JAX
// returns the counts through an XLA all-to-all of the side band). Only the
// cdiv(n, chunk) live chunks of `chunk` rows move (a2a_live_chunks); rows
// of the other chunks are left untouched (JAX leaves them undefined). The
// self slab is a local copy of its live chunks (JAX copies the whole slab;
// its rows past n are undefined all the same). The kernel moves bytes:
// bf16, f32 and the fp8 path's int8 wire differ only in the row's bytes
// and the chunk rows the wrapper picks.
//
// The design, a copy rather than the Pallas kernel block by block:
//
//  * Addresses: the ranks' send (and receive) buffers are the rank shards
//    of one tensor, so rank r's lies r * step bytes after rank 0's
//    (tdt_rank_ptr); the wrapper passes (rank 0's address, step) and
//    builds no table. The signals keep their symmetric table, made once.
//  * Pieces: each live (peer, chunk) copy is cut into pieces of at most
//    kPiece bytes, never across a chunk boundary; each piece has its own
//    64-bit signal in the receiver's row, sig[d][s][chunk][piece].
//  * Items, dealt round robin to every block of one cooperative launch (on
//    one card a rank owns no SMs): first every copy item (send position
//    i, rank me, chunk, piece), i outermost so each rank pushes in
//    a2a_send_peer order (i = 0, the self slab, a local copy with no
//    signal). Then one wait item per (rank me, wait position i), sources
//    in a2a_wait_src order: the block acquires every signal of the slab's
//    live pieces, spread over its threads. Every wait's producers are copy
//    items, which come first and never wait, and every block is resident,
//    so the launch cannot deadlock.
//  * Two bodies of the same order. When the launch has a block for every
//    item (decode), the copy items are every (i, me, chunk, piece) and a
//    block whose piece lies in a dead chunk skips it. When blocks take
//    several items (prefill), the dead pieces are left out of the count
//    first (`kCompact`): warp 0 of each block scans the slabs' live piece
//    counts into shared memory, and item t is the t-th live piece, so the
//    live bytes spread evenly over the blocks (at W = 4 prefill the dealt
//    dead items left some blocks four live pieces against a mean of 1.6).
//    The scan costs a launch of single items more than it saves, so the
//    body is picked by the item count (PERF.md, section 6, has both
//    bodies' times at both shapes).
//  * Copy: 16-byte vectors, neighbouring threads on neighbouring
//    addresses, four loads in flight a thread before their stores
//    (tdt_putmem_block_x4), then __syncthreads, a fence and one release
//    store of the piece's signal. Unaligned rows fall back to bytes.
//  * No barrier before the pushes, where the Pallas kernel runs
//    barrier_all (:176) so that every peer's receive buffer exists: here
//    the receive buffer is made before the launch, stream order separates
//    two calls, and the epoch keeps a stale signal from satisfying a wait.
//
// Signals live in a symmetric 64-bit buffer that the context keeps across
// calls, and `epoch` is the call's sequence number, so no reset pass is
// needed and no earlier call's signal satisfies a wait. This replaces the
// reference's call-parity double buffering: on one card stream order
// separates two calls, so receive buffers need no parity. Launches per
// card (ranks on several cards) will need the parity and the barrier back.
//
// What bounds it: the live bytes, read once and written once over HBM
// (every rank shares the card's one memory), 2 * live_rows * H * itemsize
// at 3.35 TB/s. Qwen3-30B-A3B at W = 4: decode (batch 4, cap 8) moves 32
// rows of 4 KiB (~0.08 us at the bound: the launch costs more); prefill
// (4 x 128 tokens, cap 1024, chunks of 128) about 4096 live rows plus the
// dead rows of the last live chunks, ~10 us.
//
// Plain C entry points, loaded with ctypes. The launch runs on the stream
// it is given, allocates nothing and returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shmem.cuh"

namespace {

constexpr int kThreads = 256;
// Bytes of one piece: one copy item, one signal; 16 B x 4 x kThreads, one
// round of tdt_putmem_block_x4.
constexpr long long kPiece = 16 * 1024;
// Most ranks a launch takes: the compact body's slab scan lives in shared
// memory, one entry a (send position, rank) slab.
constexpr int kMaxWorld = 32;

struct Args {
  const unsigned char* send;  // rank 0's (W, cap, row) send slabs
  unsigned char* recv;        // rank 0's (W, cap, row) receive slabs
  long long send_step;        // bytes from rank r's send buffer to r + 1's
  long long recv_step;
  const long long* sig_tab;   // (W,) rank d's (W, n_chunks, pieces) signals
  const int* counts;          // (W * W,) counts[s * W + d]
  int* recv_counts;           // (W * W,) recv_counts[d * W + s]
  long long chunk_bytes;      // chunk rows' bytes
  unsigned long long epoch;
  int world, chunk, n_chunks;
  int pieces;                 // pieces of one chunk
  long long copies;           // copy items; wait items follow
};

__host__ __device__ inline long long pieces_of(long long chunk_bytes) {
  return (chunk_bytes + kPiece - 1) / kPiece;
}

__host__ __device__ inline long long copy_items(int world, int n_chunks,
                                                long long pieces) {
  return static_cast<long long>(world) * world * n_chunks * pieces;
}

__device__ __forceinline__ int live_chunks(int count, int chunk,
                                           int n_chunks) {
  const int live = (max(count, 0) + chunk - 1) / chunk;  // a2a_live_chunks
  return min(live, n_chunks);
}

// Live pieces of slab k = i * W + me: rank me's slab for its i-th peer.
__device__ __forceinline__ long long slab_pieces(const Args& a, int k) {
  const int me = k % a.world;
  const int peer = (me + k / a.world) % a.world;        // a2a_send_peer
  return static_cast<long long>(live_chunks(
      a.counts[me * a.world + peer], a.chunk, a.n_chunks)) * a.pieces;
}

// Piece p of chunk c of rank me's slab for its i-th peer, then (not for
// the self slab) the piece's signal in the peer's row.
__device__ void copy_piece(const Args& a, int i, int me, int c, int p) {
  const int world = a.world;
  const int peer = (me + i) % world;                    // a2a_send_peer
  const long long slab = static_cast<long long>(a.n_chunks) * a.chunk_bytes;
  const long long at = c * a.chunk_bytes + p * kPiece;
  const long long left = a.chunk_bytes - p * kPiece;
  const long long nbytes = left < kPiece ? left : kPiece;
  const unsigned char* src =
      tdt_rank_ptr(a.send, a.send_step, me) + peer * slab + at;
  unsigned char* dst =
      tdt_rank_ptr(a.recv, a.recv_step, peer) + me * slab + at;
  tdt_putmem_block_x4(dst, src, nbytes);
  if (i == 0) return;                                   // the self slab
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long* sig = reinterpret_cast<unsigned long long*>(
        tdt_peer_ptr(a.sig_tab, peer)) +
        (static_cast<long long>(me) * a.n_chunks + c) * a.pieces + p;
    __threadfence();
    tdt_signal_release(sig, a.epoch);
  }
}

// Wait item `t`: (me, wait position i = 1 + t % (W - 1)).
__device__ void wait_item(const Args& a, long long t) {
  const int world = a.world;
  const int me = static_cast<int>(t / (world - 1));
  const int i = 1 + static_cast<int>(t % (world - 1));
  const int src = (me - i + world) % world;             // a2a_wait_src
  const int live =
      live_chunks(a.counts[src * world + me], a.chunk, a.n_chunks);
  const unsigned long long* mine = reinterpret_cast<unsigned long long*>(
      tdt_peer_ptr(a.sig_tab, me)) +
      static_cast<long long>(src) * a.n_chunks * a.pieces;
  tdt_signal_wait_all(mine, live * a.pieces, a.epoch);
}

// kCompact: item t < live pieces is the t-th live piece in slab order,
// found in the block's scan `pre` (pre[k] live pieces before slab k).
// Otherwise item t < a.copies is (i, me, chunk, piece), i outermost, and
// a piece of a dead chunk is skipped.
template <bool kCompact>
__global__ void __launch_bounds__(kThreads) a2a_kernel(Args a) {
  __shared__ long long pre[kCompact ? kMaxWorld * kMaxWorld + 1 : 1];
  const int world = a.world;
  const int slabs = world * world;
  if (blockIdx.x == 0) {
    for (int t = threadIdx.x; t < slabs; t += blockDim.x) {
      const int d = t / world, s = t % world;
      a.recv_counts[t] = a.counts[s * world + d];
    }
  }
  long long copies = a.copies;
  if (kCompact) {
    if (threadIdx.x < 32) {                  // warp 0: an inclusive scan
      const int lane = threadIdx.x;
      long long carry = 0;
      for (int base = 0; base < slabs; base += 32) {
        long long v = base + lane < slabs ? slab_pieces(a, base + lane) : 0;
        for (int o = 1; o < 32; o <<= 1) {
          const long long u = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v += u;
        }
        if (base + lane < slabs) pre[base + lane + 1] = carry + v;
        carry += __shfl_sync(0xffffffffu, v, 31);
      }
      if (lane == 0) pre[0] = 0;
    }
    __syncthreads();
    copies = pre[slabs];
  }
  const long long total = copies + static_cast<long long>(world) * (world - 1);
  for (long long t = blockIdx.x; t < total; t += gridDim.x) {
    if (t >= copies) {
      wait_item(a, t - copies);
    } else if (kCompact) {
      int lo = 0, hi = slabs;                // pre[lo] <= t < pre[hi]
      while (hi - lo > 1) {
        const int mid = (lo + hi) / 2;
        if (pre[mid] <= t) lo = mid; else hi = mid;
      }
      const long long q = t - pre[lo];
      copy_piece(a, lo / world, lo % world, static_cast<int>(q / a.pieces),
                 static_cast<int>(q % a.pieces));
    } else {
      const int p = static_cast<int>(t % a.pieces);
      const int c = static_cast<int>((t / a.pieces) % a.n_chunks);
      const int k = static_cast<int>(
          t / (static_cast<long long>(a.pieces) * a.n_chunks));
      if (c * static_cast<long long>(a.pieces) < slab_pieces(a, k))
        copy_piece(a, k / world, k % world, c, p);
    }
    __syncthreads();  // the block's threads leave an item together
  }
}

// Blocks of a2a_kernel<kCompact> resident at once on the current device.
template <bool kCompact>
cudaError_t resident_blocks(int* out) {
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
          &per_sm, a2a_kernel<kCompact>, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    cached = sms * per_sm;
  }
  *out = cached;
  return cudaSuccess;
}

bool shape_ok(int world, int capacity, int chunk, long long row_bytes) {
  return world >= 1 && world <= kMaxWorld && chunk >= 1 &&
         capacity >= chunk && capacity % chunk == 0 && row_bytes >= 1;
}

}  // namespace

extern "C" {

// Signals each rank's row holds for a call: one per (source, chunk,
// piece), or -1 for a shape the kernel refuses.
long long tdt_all_to_all_signals(int world, int capacity, int chunk,
                                 long long row_bytes) {
  if (!shape_ok(world, capacity, chunk, row_bytes)) return -1;
  return static_cast<long long>(world) * (capacity / chunk) *
         pieces_of(chunk * row_bytes);
}

// The launch of one call: its items (W * W * n_chunks * pieces copies,
// then W * (W - 1) waits) and the body: a block an item when that many
// are resident, else the compact body on as many blocks as are resident
// (`compact` 1). Returns a cudaError_t.
int tdt_all_to_all_grid(int world, int capacity, int chunk,
                        long long row_bytes, int* grid, int* compact) {
  if (!shape_ok(world, capacity, chunk, row_bytes) || grid == nullptr ||
      compact == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long items =
      copy_items(world, capacity / chunk, pieces_of(chunk * row_bytes)) +
      static_cast<long long>(world) * (world - 1);
  int resident = 0;
  cudaError_t err = resident_blocks<false>(&resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  *compact = items > resident;
  if (*compact) {
    err = resident_blocks<true>(&resident);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  *grid = static_cast<int>(items < resident ? items : resident);
  if (*grid < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  return static_cast<int>(cudaSuccess);
}

// recv[d, s, live chunks] <- send[s, d, live chunks] and recv_counts[d * W
// + s] <- counts[s * W + d] for every rank pair. Rank r's send buffer is at
// send + r * send_step (bytes), its receive buffer at recv + r * recv_step;
// `sig_tab` is the device table of each rank's row of
// tdt_all_to_all_signals(...) signals; `counts` and `recv_counts` are
// (world * world) int32. `epoch` is this call's sequence number, greater
// than every earlier call's on these signals.
int tdt_all_to_all(const void* send, long long send_step, void* recv,
                   long long recv_step, const void* sig_tab,
                   const void* counts, void* recv_counts, int world,
                   int capacity, int chunk, long long row_bytes,
                   unsigned long long epoch, void* stream) {
  if (send == nullptr || recv == nullptr || sig_tab == nullptr ||
      counts == nullptr || recv_counts == nullptr || epoch == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0, compact = 0;
  const int err = tdt_all_to_all_grid(world, capacity, chunk, row_bytes,
                                      &grid, &compact);
  if (err != 0) return err;
  Args a;
  a.send = static_cast<const unsigned char*>(send);
  a.recv = static_cast<unsigned char*>(recv);
  a.send_step = send_step;
  a.recv_step = recv_step;
  a.sig_tab = static_cast<const long long*>(sig_tab);
  a.counts = static_cast<const int*>(counts);
  a.recv_counts = static_cast<int*>(recv_counts);
  a.chunk_bytes = chunk * row_bytes;
  a.epoch = epoch;
  a.world = world;
  a.chunk = chunk;
  a.n_chunks = capacity / chunk;
  a.pieces = static_cast<int>(pieces_of(a.chunk_bytes));
  a.copies = copy_items(world, a.n_chunks, a.pieces);
  void* params[] = {&a};
  const void* kernel = compact
      ? reinterpret_cast<const void*>(a2a_kernel<true>)
      : reinterpret_cast<const void*>(a2a_kernel<false>);
  const cudaError_t launch = cudaLaunchCooperativeKernel(
      kernel, dim3(grid), dim3(kThreads), params, 0,
      static_cast<cudaStream_t>(stream));
  if (launch != cudaSuccess) return static_cast<int>(launch);
  return static_cast<int>(cudaGetLastError());
}

// The runtime's message for an error code returned above.
const char* tdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
