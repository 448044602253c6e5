// All-gather at world = 1 for Hopper (sm_90a): this rank's row chunk into
// its slot of the gathered buffer, out[rank * rows : (rank + 1) * rows] = x.
//
// Replaces the world = 1 body of triton_dist_tpu/ops/allgather.py::
// _full_mesh_push_kernel (:254; `o_ref[pl.ds(me * rows, rows)] = x_ref`,
// :260-262), the kernel `all_gather(impl="pallas")` runs at world <= 2
// (:84-85), and of `_ring_ag_kernel` (:133), whose world = 1 body is the
// same copy. The pushes to peers and the ring hops come with the multi-GPU
// slice.
//
// Shape on the path (Qwen3-30B-A3B's TPMoE, bf16): x (M, 2048), M = 4 at
// decode (16 KiB) and 512 at prefill (2 MiB). What bounds it: the bytes,
// read once and written once at 3.35 TB/s (0.01 us and 1.25 us); at these
// sizes the launch itself costs more.
//
// The design: a grid-stride copy in 16-byte vectors when both ends are
// 16-byte aligned, then the tail bytes; byte copies otherwise. About eight
// blocks per SM at most.
//
// Plain C entry point `tdt_all_gather`, loaded with ctypes. It runs on the
// stream it is given, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
chunk_copy(const unsigned char* __restrict__ src,
           unsigned char* __restrict__ dst, long long n, int vec) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n16 = n / 16;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (long long j = i; j < n16; j += stride) d[j] = s[j];
    done = n16 * 16;
  }
  for (long long j = done + i; j < n; j += stride) dst[j] = src[j];
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// out + rank * chunk_bytes <- x (chunk_bytes bytes), on a card with `sms`
// SMs. Returns a cudaError_t.
int tdt_all_gather(const void* x, void* out, long long chunk_bytes, int rank,
                   int sms, void* stream) {
  if (x == nullptr || out == nullptr || chunk_bytes < 0 || rank < 0 ||
      sms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (chunk_bytes == 0) return static_cast<int>(cudaSuccess);
  unsigned char* dst = static_cast<unsigned char*>(out) + rank * chunk_bytes;
  const unsigned char* src = static_cast<const unsigned char*>(x);
  const int vec = aligned16(src) && aligned16(dst);
  const long long units = vec ? (chunk_bytes + 15) / 16 : chunk_bytes;
  long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > 8LL * sms) blocks = 8LL * sms;
  chunk_copy<<<static_cast<unsigned>(blocks), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(src, dst, chunk_bytes, vec);
  return static_cast<int>(cudaGetLastError());
}

// The runtime's message for an error code returned above.
const char* tdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
