// Device functions for ranks that share one card and one launch: the
// counterparts of the JAX package's device language, named after
// triton_dist_tpu/language/shmem.py so a reader finds each one there.
//
//  * tdt_rank                 <- language/__init__.py::rank (my_pe): the
//                                rank of the calling block, from its
//                                index and the blocks each rank has;
//  * tdt_peer_ptr             <- the device id of a remote copy (Pallas
//                                addresses a peer's shard by device id):
//                                rank `peer`'s buffer from a symmetric
//                                table of base addresses
//                                (runtime/symm_mem.py);
//  * tdt_rank_ptr             <- the same, for the rank shards of one
//                                tensor: rank `peer`'s buffer from rank
//                                0's address and the bytes between two
//                                ranks' buffers (symm_mem.py's
//                                rank_span), with no table to read;
//  * tdt_putmem_block         <- shmem.putmem_nbi_block / putmem_block
//                                and remote_copy: a block-wide copy of
//                                one chunk into a peer's buffer;
//  * tdt_putmem_block_x4      <- the same copy with four 16-byte loads
//                                in flight a thread before their stores;
//  * tdt_signal_release       <- shmem.signal_op / notify: a signal store
//                                with release semantics (st.release.gpu);
//  * tdt_putmem_signal_block  <- shmem.putmem_signal_nbi_block: the copy,
//                                then the release store of its signal;
//  * tdt_signal_wait_until    <- shmem.signal_wait_until / wait: spin
//                                until a signal equals a value, with
//                                acquire semantics (ld.acquire.gpu);
//  * tdt_signal_wait_all      <- the same over n signals at once (the
//                                pieces of one chunk), spread over the
//                                block's threads;
//  * tdt_barrier_all          <- barrier_all: a barrier over every block,
//                                so every rank, of one launch.
//
// Not needed here: logical_device_id (multi-axis device ids of a TPU
// mesh), consume_token and semaphore_read (ordering and reading Pallas
// DMA semaphores), fence / quiet (a copy here is done when its block's
// stores are; the release store orders them before the signal).
//
// Signals are 64-bit words that hold a call's sequence number (its
// epoch), never a count: a wait compares for equality, so a signal left
// by an earlier call never satisfies a later one and nothing resets them.
//
// Every function here is for blocks that are resident together (one
// cooperative launch): a block that spins on a signal whose writer is
// not resident never finishes.

#pragma once

#include <stdint.h>

// The rank of the calling block when each rank has `blocks_per_rank`
// consecutive blocks of the grid.
__device__ __forceinline__ int tdt_rank(int blocks_per_rank) {
  return static_cast<int>(blockIdx.x) / blocks_per_rank;
}

// Rank `peer`'s buffer from a symmetric table of base addresses.
__device__ __forceinline__ unsigned char* tdt_peer_ptr(
    const long long* table, int peer) {
  return reinterpret_cast<unsigned char*>(
      static_cast<uintptr_t>(table[peer]));
}

// Rank `peer`'s buffer when rank r's lies `step` bytes after rank r - 1's
// and rank 0's at `base`.
template <typename T>
__device__ __forceinline__ T* tdt_rank_ptr(T* base, long long step,
                                           int peer) {
  return reinterpret_cast<T*>(reinterpret_cast<uintptr_t>(base) +
                              static_cast<long long>(peer) * step);
}

// The calling block copies `nbytes` bytes from src to dst: 16-byte
// vectors, neighbouring threads on neighbouring addresses, when both ends
// are 16-byte aligned; the tail (or everything, unaligned) byte by byte.
__device__ __forceinline__ void tdt_putmem_block(
    unsigned char* __restrict__ dst, const unsigned char* __restrict__ src,
    long long nbytes) {
  const long long tid = threadIdx.x;
  const long long nt = blockDim.x;
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) |
        reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const long long n16 = nbytes >> 4;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (long long i = tid; i < n16; i += nt) d[i] = s[i];
    done = n16 << 4;
  }
  for (long long i = done + tid; i < nbytes; i += nt) dst[i] = src[i];
}

// tdt_putmem_block with four 16-byte loads issued by each thread before
// any of their stores, so a block keeps 4 x 16 x blockDim bytes in flight
// (a 16 KiB piece at 256 threads in one round).
__device__ __forceinline__ void tdt_putmem_block_x4(
    unsigned char* __restrict__ dst, const unsigned char* __restrict__ src,
    long long nbytes) {
  const long long tid = threadIdx.x;
  const long long nt = blockDim.x;
  long long done = 0;
  if (((reinterpret_cast<uintptr_t>(dst) |
        reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const long long n16 = nbytes >> 4;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    long long i = tid;
    for (; i + 3 * nt < n16; i += 4 * nt) {
      const uint4 v0 = s[i];
      const uint4 v1 = s[i + nt];
      const uint4 v2 = s[i + 2 * nt];
      const uint4 v3 = s[i + 3 * nt];
      d[i] = v0;
      d[i + nt] = v1;
      d[i + 2 * nt] = v2;
      d[i + 3 * nt] = v3;
    }
    for (; i < n16; i += nt) d[i] = s[i];
    done = n16 << 4;
  }
  for (long long i = done + tid; i < nbytes; i += nt) dst[i] = src[i];
}

// One store of `value` to `sig`, ordered after every earlier store of the
// calling thread (and, through a preceding __syncthreads, of its block)
// for any thread of the card that acquires it.
__device__ __forceinline__ void tdt_signal_release(unsigned long long* sig,
                                                   unsigned long long value) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(sig), "l"(value) : "memory");
}

__device__ __forceinline__ unsigned long long tdt_signal_acquire(
    const unsigned long long* sig) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(sig) : "memory");
  return v;
}

// The block copies one chunk, then thread 0 releases its signal once every
// thread's stores are done.
__device__ __forceinline__ void tdt_putmem_signal_block(
    unsigned char* __restrict__ dst, const unsigned char* __restrict__ src,
    long long nbytes, unsigned long long* sig, unsigned long long value) {
  tdt_putmem_block(dst, src, nbytes);
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    tdt_signal_release(sig, value);
  }
}

// Thread 0 spins until `*sig == value` with acquire loads; the block goes
// on only then, so its later reads see what the signal's writer stored.
__device__ __forceinline__ void tdt_signal_wait_until(
    const unsigned long long* sig, unsigned long long value) {
  if (threadIdx.x == 0) {
    while (tdt_signal_acquire(sig) != value) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

// Every thread of the block spins on some of `n` signals; the block goes
// on once all of them equal `value`, with acquire semantics.
__device__ __forceinline__ void tdt_signal_wait_all(
    const unsigned long long* sig, int n, unsigned long long value) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    while (tdt_signal_acquire(sig + i) != value) __nanosleep(64);
  __threadfence();
  __syncthreads();
}

// Every block of the launch arrives (one release store of `epoch` into its
// own flag), then waits until every block's flag holds `epoch`. `flags`
// holds at least gridDim.x words; `epoch` differs between calls.
__device__ __forceinline__ void tdt_barrier_all(unsigned long long* flags,
                                                unsigned long long epoch) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    tdt_signal_release(flags + blockIdx.x, epoch);
  }
  for (unsigned b = threadIdx.x; b < gridDim.x; b += blockDim.x) {
    while (tdt_signal_acquire(flags + b) != epoch) __nanosleep(64);
  }
  __threadfence();
  __syncthreads();
}
