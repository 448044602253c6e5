// The world = 1 bodies of the collectives for Hopper (sm_90a): one copy
// kernel. At world = 1 each of these Pallas kernels copies a buffer and
// nothing else, so one grid-stride copy serves them all:
//
//  * all-gather: this rank's row chunk into its slot of the gathered
//    buffer, out[rank * rows : (rank + 1) * rows] = x, at rank 0 a copy.
//    Replaces triton_dist_tpu/ops/allgather.py::_full_mesh_push_kernel
//    (:254; `o_ref[pl.ds(me * rows, rows)] = x_ref`, :260-262), the kernel
//    `all_gather(impl="pallas")` runs at world <= 2 (:84-85), and
//    `_ring_ag_kernel` (:133), whose world = 1 body is the same copy;
//  * the world = 1 bodies of the other collectives, all dst = src:
//    - ops/allreduce.py::_one_shot_ar_kernel (:114, body :120-122),
//      _recursive_doubling_ar_kernel (:158, :172-174) and
//      _two_shot_ar_kernel (:193, :203-205): `o = x`;
//    - ops/reduce_scatter.py::_ring_rs_kernel (:92, :110-112) and
//      _one_shot_rs_kernel (:150, :157-159): `o = x[0 : M]`;
//    - ops/allgather.py::_broadcast_kernel (:218, :225-229): the root's
//      buffer.
// The pushes to peers and the ring hops come with the multi-GPU slice.
//
// Shapes on the paths: Qwen3-30B-A3B's TPMoE all-gather (bf16) x (M, 2048),
// M = 4 at decode (16 KiB) and 512 at prefill (2 MiB); the collectives at
// (1, 4, 4096) and (1, 512, 4096) bf16 (32 KiB and 4 MiB). What bounds it:
// the bytes, read once and written once at 3.35 TB/s (0.01 to 2.5 us); at
// these sizes the launch itself costs more.
//
// The design: a grid-stride copy in 16-byte vectors when both ends are
// 16-byte aligned, then the tail bytes; byte copies otherwise. About eight
// blocks per SM at most.
//
// Plain C entry point `tdt_copy`, loaded with ctypes. It runs on the stream
// it is given, allocates nothing and returns cudaGetLastError().

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

// dst <- src (nbytes bytes), on a card with `sms` SMs. Returns a
// cudaError_t.
int tdt_copy(const void* src, void* dst, long long nbytes, int sms,
             void* stream) {
  if (src == nullptr || dst == nullptr || nbytes < 0 || sms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nbytes == 0) return static_cast<int>(cudaSuccess);
  const unsigned char* s = static_cast<const unsigned char*>(src);
  unsigned char* d = static_cast<unsigned char*>(dst);
  const int vec = aligned16(s) && aligned16(d);
  const long long units = vec ? (nbytes + 15) / 16 : nbytes;
  long long blocks = (units + kThreads - 1) / kThreads;
  if (blocks > 8LL * sms) blocks = 8LL * sms;
  chunk_copy<<<static_cast<unsigned>(blocks), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(s, d, nbytes, vec);
  return static_cast<int>(cudaGetLastError());
}

// The runtime's message for an error code returned above.
const char* tdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
