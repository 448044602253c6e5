// The expert-parallel low-latency all-to-all for Hopper (sm_90a), every
// rank of one card in one launch. Replaces
// triton_dist_tpu/ops/all_to_all.py::_a2a_kernel (:155), which
// fast_all_to_all (:237) launches at world > 1.
//
// What it computes, for every rank at once: `send` is (W, W, cap, H)
// rank-major, rank s's slab d carrying n = counts[s * W + d] live rows for
// rank d; `recv` is the same shape, and afterwards recv[d, s, :n] =
// send[s, d, :n]. Only the cdiv(n, chunk) live chunks of `chunk` rows move
// (a2a_live_chunks); rows of the other chunks are left untouched (JAX
// leaves them undefined). The self slab is a local copy of its live chunks
// (JAX copies the whole slab; its rows past n are undefined all the same).
// The kernel moves bytes: bf16, f32 and the fp8 path's int8 wire differ
// only in the row's bytes and the chunk rows the wrapper picks.
//
// The design, a copy rather than the Pallas kernel block by block:
//
//  * Grid: `blocks_per_rank` blocks for each of the W ranks, launched
//    cooperatively, so every block is resident at once (a block that spins
//    on a peer's signal never starves the peer of an SM). The grid comes
//    from the occupancy of this kernel on this card; a launch that does not
//    fit fails (cudaErrorCooperativeLaunchTooLarge) and is not retried
//    smaller.
//  * Barrier: every block first passes barrier_all, as the Pallas kernel
//    does before its pushes.
//  * Push: a rank's work items are (peer, chunk) pairs in a2a_send_peer
//    order (the self slab first), dealt round robin to its blocks. Each
//    live item is one block-wide 16-byte vectorised copy from its send slab
//    into the peer's recv slot, found through the recv pointer table, then
//    one release store of sig[peer][me][chunk] = epoch.
//  * Wait: each rank's blocks then acquire sig[me][src][chunk] == epoch
//    for every live chunk they expect, sources in a2a_wait_src order.
//
// Signals live in a symmetric 64-bit buffer that the context keeps across
// calls, and `epoch` is the call's sequence number, so no reset pass is
// needed and no earlier call's signal satisfies a wait. This replaces the
// reference's call-parity double buffering: on one card stream order
// separates two calls, so receive buffers need no parity. Launches per
// card (ranks on several cards) will need the parity back.
//
// What bounds it: the live bytes, read once and written once over HBM
// (every rank shares the card's one memory), 2 * live_rows * H * itemsize
// at 3.35 TB/s. Qwen3-30B-A3B at W = 4: decode (batch 4, cap 8) moves 32
// rows of 4 KiB (~0.08 us at the bound: the launch and the barrier cost
// more); prefill (4 x 128 tokens, cap 1024, chunks of 128) about 4096
// live rows plus the dead rows of the last live chunks, ~10 us.
//
// Plain C entry points, loaded with ctypes. The launch runs on the stream
// it is given, allocates nothing and returns a cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shmem.cuh"

namespace {

constexpr int kThreads = 512;

struct Args {
  const long long* send_tab;  // (W,) rank s's (W, cap, row) send slabs
  const long long* recv_tab;  // (W,) rank d's (W, cap, row) recv slabs
  const long long* sig_tab;   // (W,) rank d's (W, n_chunks) signals
  unsigned long long* bar;    // one flag per block of the grid
  const int* counts;          // (W * W,) counts[s * W + d]
  long long row_bytes;
  unsigned long long epoch;
  int world, capacity, chunk, n_chunks, blocks_per_rank;
};

__device__ __forceinline__ int live_chunks(int count, int chunk,
                                           int n_chunks) {
  const int live = (max(count, 0) + chunk - 1) / chunk;  // a2a_live_chunks
  return min(live, n_chunks);
}

__global__ void __launch_bounds__(kThreads) a2a_kernel(Args a) {
  const int world = a.world;
  const int me = tdt_rank(a.blocks_per_rank);
  const int j = static_cast<int>(blockIdx.x) % a.blocks_per_rank;
  const long long slab = static_cast<long long>(a.capacity) * a.row_bytes;
  const long long cbytes = static_cast<long long>(a.chunk) * a.row_bytes;

  tdt_barrier_all(a.bar, a.epoch);

  const unsigned char* send = tdt_peer_ptr(a.send_tab, me);
  for (int t = j; t < world * a.n_chunks; t += a.blocks_per_rank) {
    const int i = t / a.n_chunks;
    const int c = t % a.n_chunks;
    const int peer = (me + i) % world;                  // a2a_send_peer
    if (c >= live_chunks(a.counts[me * world + peer], a.chunk, a.n_chunks))
      continue;
    unsigned char* dst =
        tdt_peer_ptr(a.recv_tab, peer) + me * slab + c * cbytes;
    const unsigned char* src = send + peer * slab + c * cbytes;
    if (peer == me) {
      tdt_putmem_block(dst, src, cbytes);
    } else {
      unsigned long long* sig = reinterpret_cast<unsigned long long*>(
          tdt_peer_ptr(a.sig_tab, peer)) + me * a.n_chunks + c;
      tdt_putmem_signal_block(dst, src, cbytes, sig, a.epoch);
    }
  }

  const unsigned long long* mine = reinterpret_cast<unsigned long long*>(
      tdt_peer_ptr(a.sig_tab, me));
  for (int t = j; t < (world - 1) * a.n_chunks; t += a.blocks_per_rank) {
    const int i = 1 + t / a.n_chunks;
    const int c = t % a.n_chunks;
    const int src = (me - i + world) % world;           // a2a_wait_src
    if (c < live_chunks(a.counts[src * world + me], a.chunk, a.n_chunks))
      tdt_signal_wait_until(mine + src * a.n_chunks + c, a.epoch);
  }
}

// Blocks of this kernel resident at once on the current device.
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
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, a2a_kernel,
                                                          kThreads, 0);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    cached = sms * per_sm;
  }
  *out = cached;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The grid of one call: `blocks_per_rank` blocks for each of `world`
// ranks, one per (peer, chunk) item of a rank, at most what is resident
// at once. Returns a cudaError_t.
int tdt_all_to_all_grid(int world, int n_chunks, int* blocks_per_rank) {
  if (world < 1 || n_chunks < 1 || blocks_per_rank == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  int resident = 0;
  const cudaError_t err = resident_blocks(&resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = static_cast<long long>(world) * n_chunks;
  const int most = resident / world;
  if (most < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  *blocks_per_rank = static_cast<int>(items < most ? items : most);
  return static_cast<int>(cudaSuccess);
}

// recv[d, s, live chunks] <- send[s, d, live chunks] for every rank pair,
// with `send_tab`, `recv_tab` and `sig_tab` the device tables of each
// rank's buffers, `bar` `bar_len` barrier flags and `counts` (world *
// world) int32 live rows. `epoch` is this call's sequence number, greater
// than every earlier call's on these signals and flags.
int tdt_all_to_all(const void* send_tab, const void* recv_tab,
                   const void* sig_tab, void* bar, int bar_len,
                   const void* counts, int world, int capacity, int chunk,
                   long long row_bytes, unsigned long long epoch,
                   void* stream) {
  if (send_tab == nullptr || recv_tab == nullptr || sig_tab == nullptr ||
      bar == nullptr || counts == nullptr || world < 1 || chunk < 1 ||
      capacity < chunk || capacity % chunk != 0 || row_bytes < 1 ||
      epoch == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = capacity / chunk;
  int bpr = 0;
  const int err = tdt_all_to_all_grid(world, n_chunks, &bpr);
  if (err != 0) return err;
  const int grid = world * bpr;
  if (grid > bar_len) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.send_tab = static_cast<const long long*>(send_tab);
  a.recv_tab = static_cast<const long long*>(recv_tab);
  a.sig_tab = static_cast<const long long*>(sig_tab);
  a.bar = static_cast<unsigned long long*>(bar);
  a.counts = static_cast<const int*>(counts);
  a.row_bytes = row_bytes;
  a.epoch = epoch;
  a.world = world;
  a.capacity = capacity;
  a.chunk = chunk;
  a.n_chunks = n_chunks;
  a.blocks_per_rank = bpr;
  void* params[] = {&a};
  const cudaError_t launch = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(a2a_kernel), dim3(grid), dim3(kThreads),
      params, 0, static_cast<cudaStream_t>(stream));
  if (launch != cudaSuccess) return static_cast<int>(launch);
  return static_cast<int>(cudaGetLastError());
}

// The runtime's message for an error code returned above.
const char* tdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
