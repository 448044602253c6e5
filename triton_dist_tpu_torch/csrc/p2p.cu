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
// is bytes [r C, (r + 1) C) of one global tensor; its output block and its
// signal row are rank r's shards of the output tensor and of the signal
// buffer, reached from rank 0's address and the bytes between two ranks'
// shards (shmem.cuh's tdt_rank_ptr), as a Pallas kernel reaches a peer's
// buffer by device id: a call takes them by value and queues this one
// kernel and nothing else. dst and src follow JAX's shift_partners (:58):
// span = (|delta| / W + 1) W keeps the remainder's argument non-negative,
// so any delta, of either sign and |delta| >= W, gives ranks in [0, W) (a
// C `%` of a negative number is negative).
//
// What bounds it: bytes. Every block is read once and written once: 2 W C
// bytes at 3.35 TB/s. Qwen3-8B's decode hop at W = 4 (4 rows of 4096
// bf16 a rank, 32 KiB) is 0.08 us of bytes, far below a launch; the
// prefill hop (512 rows, 4 MiB a rank) 10 us; one KV block (36 layers x
// 2 x (16, 8, 128) f32, 4.7 MB in all) 2.8 us.
//
// The design:
//  * each block is cut into pieces of 16 KiB (kPiece), larger when the
//    launch's blocks would not all be resident at once (piece_bytes); each
//    piece has one 64-bit signal in the receiver's signal row, stamped
//    with the call's epoch (never reset: a wait compares for equality);
//  * one push block for every piece of every rank, then one wait block
//    for every rank, all resident together (the cooperative launch: a
//    grid the card cannot hold is never launched), so no block waits for
//    another to be dealt;
//  * a push copies 16-byte vectors, neighbouring threads on neighbouring
//    addresses, four loads in flight a thread before their stores, when
//    both ends are 16-byte aligned, then the tail bytes
//    (tdt_putmem_block_x4: byte copies for an unaligned uint8 payload; it
//    never reads past a rank's bytes), then __syncthreads and thread 0's
//    release store of the piece's signal, no __threadfence before it
//    (reduce_world.cu says why);
//  * a rank's wait block polls the signals of all of its pieces, spread
//    over its threads (tdt_signal_wait_all: JAX's wait_recv). JAX's
//    wait_send has no counterpart: a push is done when its block's stores
//    are;
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
// Bytes of one piece while the blocks fit: one x4 round of the block.
constexpr long long kPiece = 4LL * 16 * kThreads;

struct Args {
  const unsigned char* x;    // W blocks of `chunk` bytes, rank r's at r C
  unsigned char* out;        // rank 0's output block
  unsigned long long* sig;   // rank 0's signal row
  long long out_step, sig_step;  // bytes from rank r's to r + 1's
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

__device__ __forceinline__ unsigned long long* signals_of(const Args& a,
                                                          int owner) {
  return tdt_rank_ptr(a.sig, a.sig_step, owner);
}

// Push block (me, piece): piece pc of rank me's block into rank dst's
// output, then its signal in dst's row.
__device__ void push_piece(const Args& a, int me, long long pc) {
  const int dst = partner(me, a.delta, a.world);
  const long long off = pc * a.piece;
  const long long left = a.chunk - off;
  const long long n = left < a.piece ? left : a.piece;
  if (!(a.fault && me == 0 && pc == 0))
    tdt_putmem_block_x4(tdt_rank_ptr(a.out, a.out_step, dst) + off,
                        a.x + me * a.chunk + off, n);
  __syncthreads();
  if (threadIdx.x == 0) tdt_signal_release(signals_of(a, dst) + pc, a.epoch);
}

__global__ void __launch_bounds__(kThreads) shift_world(Args a) {
  const long long pushes = static_cast<long long>(a.world) * a.pieces;
  const long long b = blockIdx.x;
  if (b < pushes) {
    push_piece(a, static_cast<int>(b / a.pieces), b % a.pieces);
  } else {
    // Rank b - pushes waits for every piece arriving from src =
    // partner(me, -delta).
    tdt_signal_wait_all(signals_of(a, static_cast<int>(b - pushes)),
                        static_cast<int>(a.pieces), a.epoch);
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
// `resident` blocks fit on the card: kPiece, or more while the W pieces'
// push blocks and the W wait blocks would not all be resident; 0 when the
// card cannot hold W + W blocks.
long long piece_bytes(long long chunk, int world, int resident) {
  const long long per_rank = (resident - world) / world;
  if (per_rank < 1) return 0;
  long long pieces = (chunk + kPiece - 1) / kPiece;
  if (pieces > per_rank) pieces = per_rank;
  const long long p = (chunk + pieces - 1) / pieces;
  return (p + 15) / 16 * 16;
}

bool valid(long long chunk, int world) { return chunk >= 1 && world >= 2; }

// The plan of a call: *piece bytes, *pieces a rank, *grid blocks.
cudaError_t plan_of(long long chunk, int world, long long* piece,
                    long long* pieces, int* grid, int* resident) {
  cudaError_t err = resident_blocks(resident);
  if (err != cudaSuccess) return err;
  *piece = piece_bytes(chunk, world, *resident);
  if (*piece < 1) return cudaErrorCooperativeLaunchTooLarge;
  *pieces = (chunk + *piece - 1) / *piece;
  *grid = static_cast<int>(world * (*pieces + 1));
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The plan of a call on this card: *grid blocks of the launch (W x pieces
// pushes, then W waits, every one resident), *resident blocks the card
// holds at once, *piece bytes of a piece, *pieces of them a rank (and the
// signals a call needs in each rank's row: one per piece of the block that
// arrives into it). Returns a cudaError_t.
int tdt_shift_grid(long long chunk_bytes, int world, int* grid,
                   int* resident, long long* piece, long long* pieces) {
  if (!valid(chunk_bytes, world) || grid == nullptr || resident == nullptr ||
      piece == nullptr || pieces == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      plan_of(chunk_bytes, world, piece, pieces, grid, resident));
}

// The shift over `world` ranks of one card: rank r's block x[r C,
// (r + 1) C) into rank dst(r)'s output block (at out + dst(r) * out_step,
// C bytes), dst(r) = (r + delta) mod W by JAX's rule. Rank r's row of
// `pieces` (tdt_shift_grid) uint64 signals at sig + r * sig_step. `epoch`
// must differ from every earlier call's on these signals (a counter,
// never 0); `fault` plants the test fault. Returns a cudaError_t.
int tdt_shift_world(const void* x, void* out, long long out_step, void* sig,
                    long long sig_step, long long chunk_bytes, int world,
                    long long delta, unsigned long long epoch, int fault,
                    void* stream) {
  if (x == nullptr || out == nullptr || sig == nullptr ||
      !valid(chunk_bytes, world) || epoch == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  int grid = 0, resident = 0;
  cudaError_t e = plan_of(chunk_bytes, world, &a.piece, &a.pieces, &grid,
                          &resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  a.x = static_cast<const unsigned char*>(x);
  a.out = static_cast<unsigned char*>(out);
  a.sig = static_cast<unsigned long long*>(sig);
  a.out_step = out_step;
  a.sig_step = sig_step;
  a.chunk = chunk_bytes;
  a.delta = delta;
  a.epoch = epoch;
  a.world = world;
  a.fault = fault;
  void* params[] = {&a};
  e = cudaLaunchCooperativeKernel(
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
