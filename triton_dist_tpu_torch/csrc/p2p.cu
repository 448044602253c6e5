// The pipeline shift and the KV ship hop for Hopper (sm_90a): W ranks that
// share one card each push their block one hop of delta along the ring,
// in one cooperative launch.
//
// Replaces, with one kernel:
//  * triton_dist_tpu/ops/p2p.py::_shift_kernel (:70), reached from
//    pp_shift (:86): barrier_all, one remote copy of the whole local
//    block to dst = shift_partners(me, delta)[0], wait_recv, wait_send;
//  * triton_dist_tpu/serving/kv_stream.py::_ship_kernel (:151), reached
//    from symm_ship (:172): the same steps on a uint8 staging buffer
//    (another collective id, the same function).
// Both entries shard their input's leading dimension over the axis, so
// the function is one: the W blocks of the input roll by delta, and rank
// i's output is the block of rank i - delta.
//
// Ranks are W slices of one card (runtime/dist.py): rank r's input block
// is bytes [r C, (r + 1) C) of one global tensor; its output is rank r's
// block of the output tensor, reached through a device table of base
// addresses (shmem.cuh's tdt_peer_ptr), as a Pallas kernel reaches a
// peer's buffer by device id. dst and src follow JAX's shift_partners
// (:58): span = (|delta| / W + 1) W keeps the remainder's argument
// non-negative, so any delta, of either sign and |delta| >= W, gives
// ranks in [0, W) (a C `%` of a negative number is negative).
//
// What bounds it: bytes. Every block is read once and written once: 2 W C
// bytes at 3.35 TB/s. Qwen3-8B's decode hop at W = 4 (4 rows of 4096
// bf16 a rank, 32 KiB) is 0.08 us of bytes, far below a launch; the
// prefill hop (512 rows, 4 MiB a rank) 10 us; one KV block (36 layers x
// 2 x (16, 8, 128) f32, 4.7 MB in all) 2.8 us.
//
// The design, a simple kernel that is right first:
//  * each block is cut into pieces of `piece` bytes (piece_bytes: the
//    whole payload over the resident blocks, rounded up to 16 bytes,
//    between kMinPiece and kMaxPiece), so every resident block gets a
//    piece at decode size; each piece has one 64-bit signal in the
//    receiver's signal row, stamped with the call's epoch (never reset: a
//    wait compares for equality);
//  * items are dealt round-robin to all blocks of the launch, every rank's
//    items to every block (on one card a rank owns no SMs): first every
//    push item (rank, piece), then every wait item (rank, piece). A wait's
//    producer is a push, which has a smaller index, so with every block
//    resident (the cooperative launch) the smallest unfinished item can
//    always run: no deadlock. A grid larger than the card holds is never
//    launched: the grid is min(items, resident blocks), and blocks walk
//    the items;
//  * a push copies 16-byte vectors, neighbouring threads on neighbouring
//    addresses, when both ends are 16-byte aligned, then the tail bytes
//    (tdt_putmem_block: byte copies for an unaligned uint8 payload; it
//    never reads past a rank's bytes), then __syncthreads, a fence and one
//    release store of the piece's signal; a wait is an acquire load loop
//    (JAX's wait_recv). JAX's wait_send has no counterpart: a push is done
//    when its block's stores are;
//  * no barrier_all before the pushes: every call writes into a new output
//    tensor (or a caller's `out`) and stream order separates calls, so no
//    peer's output can be overwritten before that peer is ready (a
//    deliberate divergence, ROADMAP.md).
// `fault` plants the test fault: rank 0's push of its first piece skips
// the copy and still sets the signal, so a NaN-filled output keeps NaN
// there.
//
// Plain C entry points, loaded with ctypes. A call runs on the stream it is
// given, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "shmem.cuh"

namespace {

constexpr int kThreads = 256;
// Bounds of one piece's bytes: one push item, one signal.
constexpr long long kMinPiece = 1024;
constexpr long long kMaxPiece = 64 * 1024;

struct Args {
  const unsigned char* x;    // W blocks of `chunk` bytes, rank r's at r C
  const long long* out_tab;  // rank r's output block
  const long long* sig_tab;  // rank r's signal row
  long long chunk;           // bytes of one rank's block
  long long piece;           // bytes of one piece (the last may be short)
  long long pieces;          // pieces of one block
  long long delta;
  unsigned long long epoch;
  int world;
  int fault;
};

// JAX's shift_partners (p2p.py:58-67) on one side: the rank `delta` hops
// from `me`, with the span that keeps the remainder's argument >= 0.
__device__ __forceinline__ int partner(int me, long long delta, int world) {
  const long long mag = delta < 0 ? -delta : delta;
  const long long span = (mag / world + 1) * world;
  return static_cast<int>((me + delta + span) % world);
}

__device__ __forceinline__ unsigned long long* signal_of(const Args& a,
                                                         int owner,
                                                         long long pc) {
  return reinterpret_cast<unsigned long long*>(
             tdt_peer_ptr(a.sig_tab, owner)) + pc;
}

// Push item `it` = (me, piece): piece pc of rank me's block into rank
// dst's output, then its signal in dst's row.
__device__ void push_item(const Args& a, long long it) {
  const long long pc = it % a.pieces;
  const int me = static_cast<int>(it / a.pieces);
  const int dst = partner(me, a.delta, a.world);
  const long long off = pc * a.piece;
  const long long left = a.chunk - off;
  const long long n = left < a.piece ? left : a.piece;
  unsigned long long* sig = signal_of(a, dst, pc);
  if (a.fault && me == 0 && pc == 0) {
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      tdt_signal_release(sig, a.epoch);
    }
    return;
  }
  tdt_putmem_signal_block(tdt_peer_ptr(a.out_tab, dst) + off,
                          a.x + me * a.chunk + off, n, sig, a.epoch);
}

// Wait item `it` = (me, piece): rank me waits for piece pc of the block
// arriving from src = partner(me, -delta).
__device__ void wait_item(const Args& a, long long it) {
  const long long pc = it % a.pieces;
  const int me = static_cast<int>(it / a.pieces);
  tdt_signal_wait_until(signal_of(a, me, pc), a.epoch);
}

__global__ void __launch_bounds__(kThreads) shift_world(Args a) {
  const long long pushes = static_cast<long long>(a.world) * a.pieces;
  for (long long it = blockIdx.x; it < 2 * pushes; it += gridDim.x) {
    if (it < pushes) {
      push_item(a, it);
    } else {
      wait_item(a, it - pushes);
    }
    __syncthreads();  // the block's threads leave an item together
  }
}

// Blocks of shift_world the card keeps resident at once.
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
          &per_sm, shift_world, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    cached = sms * per_sm;
  }
  *out = cached;
  return cudaSuccess;
}

// Bytes of one piece for blocks of `chunk` bytes over `world` ranks when
// `resident` blocks fit on the card.
long long piece_bytes(long long chunk, int world, int resident) {
  const long long total = chunk * world;
  long long p = (total + resident - 1) / resident;
  p = (p + 15) / 16 * 16;
  if (p < kMinPiece) p = kMinPiece;
  if (p > kMaxPiece) p = kMaxPiece;
  return p;
}

bool valid(long long chunk, int world) { return chunk >= 1 && world >= 2; }

}  // namespace

extern "C" {

// Signals a call with `chunk_bytes` a rank over `world` ranks needs in each
// rank's row on the current card: one per piece of the block that arrives
// into it; -1 for bad arguments or a card without cooperative launches.
long long tdt_shift_signals(long long chunk_bytes, int world) {
  int resident = 0;
  if (!valid(chunk_bytes, world) || resident_blocks(&resident) != cudaSuccess)
    return -1;
  const long long p = piece_bytes(chunk_bytes, world, resident);
  return (chunk_bytes + p - 1) / p;
}

// The launch's blocks (*grid: one an item, at most what fits) and the
// blocks the card holds at once (*resident). Returns a cudaError_t.
int tdt_shift_grid(long long chunk_bytes, int world, int* grid,
                   int* resident) {
  if (!valid(chunk_bytes, world) || grid == nullptr || resident == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = resident_blocks(resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long p = piece_bytes(chunk_bytes, world, *resident);
  const long long items = 2LL * world * ((chunk_bytes + p - 1) / p);
  *grid = static_cast<int>(items < *resident ? items : *resident);
  return static_cast<int>(cudaSuccess);
}

// The shift over `world` ranks of one card: rank r's block x[r C,
// (r + 1) C) into rank dst(r)'s output block (out_tab[dst(r)], C bytes),
// dst(r) = (r + delta) mod W by JAX's rule. sig_tab[r]: rank r's row of
// tdt_shift_signals(C, W) uint64 signals. `epoch` must differ from every
// earlier call's on these signals (a counter, never 0); `fault` plants the
// test fault. Returns a cudaError_t.
int tdt_shift_world(const void* x, const void* out_tab, const void* sig_tab,
                    long long chunk_bytes, int world, long long delta,
                    unsigned long long epoch, int fault, void* stream) {
  if (x == nullptr || out_tab == nullptr || sig_tab == nullptr ||
      !valid(chunk_bytes, world) || epoch == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int grid = 0, resident = 0;
  int err = tdt_shift_grid(chunk_bytes, world, &grid, &resident);
  if (err != 0) return err;
  if (grid < 1 || grid > resident)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  Args a;
  a.x = static_cast<const unsigned char*>(x);
  a.out_tab = static_cast<const long long*>(out_tab);
  a.sig_tab = static_cast<const long long*>(sig_tab);
  a.chunk = chunk_bytes;
  a.piece = piece_bytes(chunk_bytes, world, resident);
  a.pieces = (chunk_bytes + a.piece - 1) / a.piece;
  a.delta = delta;
  a.epoch = epoch;
  a.world = world;
  a.fault = fault;
  void* params[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(shift_world),
      dim3(static_cast<unsigned>(grid)), dim3(kThreads), params, 0,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The runtime's message for an error code returned above.
const char* tdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
